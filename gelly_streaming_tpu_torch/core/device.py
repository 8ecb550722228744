"""Device resolution for the port's entry points.

Entry points take a ``device`` argument whose default is ``"cuda"``. A
CUDA device asked for on a machine without one raises here: nothing in
the package moves quietly to the CPU (the error,
``DeviceUnavailable`` of ``resilience/errors.py``, is a ``RuntimeError`` the
``Supervisor`` never retries). The CPU runs only when the caller says
``device="cpu"``, as the tests do.
"""

from __future__ import annotations

import torch

from ..resilience.errors import DeviceUnavailable

DEFAULT_DEVICE = "cuda"


def resolve_device(device=DEFAULT_DEVICE) -> torch.device:
    """``device`` as a :class:`torch.device`, a CUDA device with its index
    (``"cuda"`` becomes the current card, so that it compares equal to the
    device of the tensors made on it); raises RuntimeError for a CUDA
    device when ``torch.cuda.is_available()`` is false
    (``DeviceUnavailable``)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise DeviceUnavailable(
                f"device {str(dev)!r} was asked for but "
                "torch.cuda.is_available() is false; pass device='cpu' to "
                "run on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
