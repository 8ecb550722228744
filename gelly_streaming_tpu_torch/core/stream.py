"""SimpleEdgeStream: the user-facing streaming-graph API (PyTorch port).

The counterpart of ``gelly_streaming_tpu/core/stream.py``, as far as the
streaming GraphSAGE slice needs it: the constructor, :meth:`get_context`,
:attr:`vertex_dict` and :meth:`blocks`. The host discretizes the edge
stream into padded :class:`EdgeBlock` windows on the context's device
(``core/window.py``). Every other method of the reference's surface
raises ``NotImplementedError`` naming the ROADMAP slice that ports it.
"""

from __future__ import annotations

from typing import Callable, Iterable, Iterator, Optional, Tuple

from .device import DEFAULT_DEVICE, resolve_device
from .edgeblock import EdgeBlock
from .vertexdict import VertexDict
from .window import CountWindow, WindowPolicy, Windower, is_column_input


class StreamContext:
    """Execution context: the device and default knobs (the ``env`` analog).

    ``device`` defaults to ``"cuda"`` and raises when no card is present;
    the CPU runs only when asked for with ``device="cpu"``. The mesh of
    the reference's context comes with the multi-device slice (ROADMAP
    Queue 1, slice 6).
    """

    def __init__(
        self,
        device=DEFAULT_DEVICE,
        default_window: Optional[WindowPolicy] = None,
    ):
        self.device = resolve_device(device)
        self.default_window = default_window or CountWindow(1 << 16)


class SimpleEdgeStream:
    """The concrete edge-addition stream (``SimpleEdgeStream.java``).

    Parameters
    ----------
    edges:
        Iterable of host edge records ``(src, dst[, val])`` with raw ids, or
        numpy columns ``(src, dst[, val])`` / an ``[N, 2|3]`` array.
    window:
        Window policy (``CountWindow`` in this slice); the context's default
        when omitted.
    context:
        Shared :class:`StreamContext`; one on ``device`` when omitted.
    vertex_dict:
        The raw -> compact id mapping (``VertexDict`` or ``IdentityDict``).
    device:
        Shorthand for ``context=StreamContext(device)``; default ``"cuda"``.
    """

    def __init__(
        self,
        edges: Iterable[Tuple],
        window: Optional[WindowPolicy] = None,
        context: Optional[StreamContext] = None,
        vertex_dict: Optional[VertexDict] = None,
        *,
        device=None,
    ):
        if edges is None:
            raise ValueError("edges must be given")
        if context is None:
            context = StreamContext(
                DEFAULT_DEVICE if device is None else device
            )
        elif device is not None and resolve_device(device) != context.device:
            raise ValueError(
                f"device {device!r} contradicts the context's {context.device}"
            )
        self.context = context
        policy = window or context.default_window
        windower = Windower(policy, vertex_dict, device=context.device)
        self._vdict = windower.vertex_dict
        if is_column_input(edges):
            # numpy fast path: hand the columns straight to the Windower
            # (iter() would hide them and fall back to per-record parsing)
            self._block_source: Callable[[], Iterator[EdgeBlock]] = (
                lambda: windower.blocks(edges)
            )
        else:
            self._block_source = lambda: windower.blocks(iter(edges))
        self._windower = windower

    def get_context(self) -> StreamContext:
        return self.context

    @property
    def device(self):
        return self.context.device

    @property
    def vertex_dict(self) -> VertexDict:
        return self._vdict

    def blocks(self) -> Iterator[EdgeBlock]:
        """The stream's window-block iterator (single use, like a DataStream)."""
        return self._block_source()


_LATER = {
    "ROADMAP Queue 1, slice 2 (streaming Connected Components)": (
        "aggregate", "prefetched", "superbatches", "superbatches_dynamic",
    ),
    "ROADMAP Queue 1, slice 4 (the window and neighborhood layer)": (
        "get_edges", "get_vertices", "map_edges", "filter_edges",
        "filter_vertices", "distinct", "reverse", "undirected", "union",
        "get_degrees", "get_in_degrees", "get_out_degrees",
        "number_of_edges", "number_of_vertices", "global_aggregate",
        "vertex_aggregate", "build_neighborhood", "slice",
    ),
}


def _not_ported(name: str, where: str):
    def method(self, *args, **kwargs):
        raise NotImplementedError(
            f"SimpleEdgeStream.{name} is ported in {where}"
        )

    method.__name__ = name
    method.__doc__ = f"Not ported yet: raises NotImplementedError ({where})."
    return method


for _where, _names in _LATER.items():
    for _name in _names:
        setattr(SimpleEdgeStream, _name, _not_ported(_name, _where))
