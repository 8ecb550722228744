"""Parameters of the JAX package, as the port's tensors.

``params_from_numpy`` takes a parameter stack in the JAX package's
layout — a list of dicts of numpy arrays, whatever their keys (GraphSAGE's
``{"w_self", "w_nbr", "b"}``, GCN's ``{"w", "b"}``) — and returns the same stack as tensors of ``dtype`` on
``device``. ``np.asarray`` of a bf16 JAX array is an ``ml_dtypes``
bfloat16 array, which ``torch.from_numpy`` rejects: pass float32 arrays
(``np.asarray(x, np.float32)``, exact for bf16 values) and let this
function cast.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from ..core.device import DEFAULT_DEVICE, resolve_device


def params_from_numpy(
    params, dtype: torch.dtype = torch.bfloat16, device=DEFAULT_DEVICE
) -> List[Dict[str, torch.Tensor]]:
    """A list of dicts of float32/float64 numpy arrays -> the same list of
    dicts of tensors of ``dtype`` on ``device``."""
    device = resolve_device(device)
    out = []
    for layer in params:
        conv = {}
        for name, value in layer.items():
            a = np.asarray(value)
            if a.dtype not in (np.float32, np.float64):
                raise TypeError(
                    f"params_from_numpy: {name} is {a.dtype}; pass float32 "
                    "arrays (np.asarray(x, np.float32))"
                )
            conv[name] = torch.from_numpy(np.ascontiguousarray(a)).to(
                device=device, dtype=dtype
            )
        out.append(conv)
    return out
