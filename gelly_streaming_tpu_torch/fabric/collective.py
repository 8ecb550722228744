"""Collective-backed transport: the group primitives over a live
multi-device runtime (the counterpart of
``gelly_streaming_tpu/fabric/collective.py``).

In the reference the runtime's own allgather (ICI within a slice, DCN
across slices) is the exchange layer, with no tag store. The port's
runtime for that is ``torch.distributed``, which comes with the mesh:
constructing :class:`CollectiveTransport` raises ``NotImplementedError``
until ROADMAP Queue 1, slice 6 (multiple devices). The store-backed
backends (:class:`~gelly_streaming_tpu_torch.fabric.SharedDirTransport`,
:class:`~gelly_streaming_tpu_torch.fabric.SocketTransport`) carry every
exchange of this slice.
"""

from __future__ import annotations

from .base import Transport

_SLICE6 = "ROADMAP Queue 1, slice 6 (multiple devices)"


class CollectiveTransport(Transport):
    """Group primitives over a multi-device runtime; not ported yet."""

    backend = "collective"
    persistent = False

    def __init__(self, *, timeout_s: float = 60.0):
        raise NotImplementedError(
            "CollectiveTransport rides the multi-device runtime, which is "
            f"ported in {_SLICE6}; use SharedDirTransport or SocketTransport")

    # the abstract byte layer: unreachable (construction raises)
    def put(self, tag, payload, *, overwrite=False):  # pragma: no cover
        raise NotImplementedError(_SLICE6)

    def _get_once(self, tag):  # pragma: no cover
        raise NotImplementedError(_SLICE6)

    def stat(self, tag):  # pragma: no cover
        raise NotImplementedError(_SLICE6)

    def list(self, prefix=""):  # pragma: no cover
        raise NotImplementedError(_SLICE6)

    def delete(self, tag):  # pragma: no cover
        raise NotImplementedError(_SLICE6)
