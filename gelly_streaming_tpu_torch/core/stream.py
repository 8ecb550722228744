"""SimpleEdgeStream: the user-facing streaming-graph API (PyTorch port).

The counterpart of ``gelly_streaming_tpu/core/stream.py``, as far as the
ported slices need it: the constructor, :meth:`get_context`,
:attr:`vertex_dict`, :meth:`blocks`, :meth:`prefetched`,
:meth:`superbatches` and :meth:`aggregate`. The host discretizes the edge
stream into padded :class:`EdgeBlock` windows on the context's device
(``core/window.py``). Every other method of the reference's surface
raises ``NotImplementedError`` naming the ROADMAP slice that ports it.
"""

from __future__ import annotations

from typing import Any, Callable, Iterable, Iterator, Optional, Tuple

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

    ``_blocks``/``_vdict`` build a stream from a block-source thunk and its
    vertex dict instead of from edges (``datasets.stream_file``,
    :meth:`prefetched`).
    """

    def __init__(
        self,
        edges: Optional[Iterable[Tuple]] = None,
        window: Optional[WindowPolicy] = None,
        context: Optional[StreamContext] = None,
        vertex_dict: Optional[VertexDict] = None,
        *,
        device=None,
        _blocks: Optional[Callable[[], Iterator[EdgeBlock]]] = None,
        _vdict: Optional[VertexDict] = None,
    ):
        if context is None:
            context = StreamContext(
                DEFAULT_DEVICE if device is None else device
            )
        elif device is not None and resolve_device(device) != context.device:
            raise ValueError(
                f"device {device!r} contradicts the context's {context.device}"
            )
        self.context = context
        self._windower = None  # the superbatch ingest fast path
        self._edges = None
        if _blocks is not None:
            if _vdict is None:
                raise ValueError("a block source needs its vertex dict")
            self._vdict = _vdict
            self._block_source = _blocks
            return
        if edges is None:
            raise ValueError("edges must be given")
        policy = window or context.default_window
        windower = Windower(policy, vertex_dict, device=context.device)
        self._vdict = windower.vertex_dict
        if is_column_input(edges) or callable(getattr(edges, "iter_chunks", None)):
            # numpy columns and chunk-capable sources go to the Windower
            # as they are (iter() would flatten them to per-record tuples)
            self._block_source: Callable[[], Iterator[EdgeBlock]] = (
                lambda: windower.blocks(edges)
            )
        else:
            self._block_source = lambda: windower.blocks(iter(edges))
        self._windower = windower
        self._edges = edges

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

    def prefetched(self, depth: int = 2) -> "SimpleEdgeStream":
        """The same stream with host windowing overlapped against device
        compute: a background thread on the stream's device keeps
        ``depth`` blocks ready. The shared vertex dict may run up to
        ``depth`` windows ahead of the consumer; blocks carry their own
        ``n_vertices``, so only code reading ``len(vertex_dict)`` mid-stream
        sees the lead."""
        from .pipeline import prefetch

        source = self._block_source
        device = self.device
        return SimpleEdgeStream(
            context=self.context,
            _blocks=lambda: prefetch(source(), depth, device=device),
            _vdict=self._vdict,
        )

    def superbatches(self, k: int):
        """K consecutive windows per
        :class:`~gelly_streaming_tpu_torch.core.window.SuperbatchGroup`:
        streams built from edges go to the Windower's packer (no
        per-window device work on count windows); block-backed streams pack
        their block iterator. Single use, like :meth:`blocks`."""
        from .window import superbatches_from_blocks

        if self._windower is not None:
            return self._windower.superbatches(self._edges, k)
        return superbatches_from_blocks(self.blocks(), k)

    def aggregate(self, summary_aggregation) -> Iterator[Any]:
        """Run a summary aggregation over this stream
        (``SimpleEdgeStream.java:100-102`` -> ``SummaryAggregation.run``)."""
        return summary_aggregation.run(self)


_LATER = {
    "ROADMAP Queue 1, slice 7 (durability, control and ingest)": (
        "superbatches_dynamic",
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
