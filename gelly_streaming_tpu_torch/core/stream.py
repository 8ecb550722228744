"""GraphStream / SimpleEdgeStream: the user-facing streaming-graph API
(PyTorch port).

The counterpart of ``gelly_streaming_tpu/core/stream.py``
(``GraphStream.java:38-141``, ``SimpleEdgeStream.java``). The host
discretizes the edge stream into padded :class:`EdgeBlock` windows on the
context's device (``core/window.py``), and every operation is a batched
step over a block:

- properties (``get_edges``/``get_vertices``/the degree streams/the
  running counts) emit one lazy batch per window: a producer loop makes no
  device-to-host read per window, and the degree streams synchronize once,
  at the end of the stream;
- transforms (``map_edges``/``filter_*``/``reverse``/``undirected``) take
  user functions written with torch operations over whole blocks:
  ``pred(src, dst, val) -> bool[N]`` replaces a ``FilterFunction`` called
  per edge. A transformed block has no host columns any more (its
  ``_host_cache`` is dropped) and is read back from the device when a
  consumer needs its rows;
- ``distinct``/``union`` run on the host columns;
- ``slice`` re-windows on the host and returns a
  :class:`~gelly_streaming_tpu_torch.core.snapshot.SnapshotStream`.

Emission is per block and change-only; with ``CountWindow(1)`` it is the
reference's per-record emission, record for record.

``superbatches_dynamic`` raises ``NotImplementedError`` naming the ROADMAP
slice that ports it.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterable, Iterator, Optional, Tuple

import numpy as np
import torch
from torch.func import vmap
from torch.utils import _pytree as pytree

from ..obs import trace as _trace
from .device import DEFAULT_DEVICE, resolve_device
from .edgeblock import EdgeBlock, from_arrays_tree, to_device
from .emission import (
    DeviceColumnBatch,
    EmissionStream,
    LazyCountRange,
    LazyRecordBatch,
    RecordColumnBatch,
    host_array,
)
from .types import Edge, EdgeDirection, Vertex
from .vertexdict import VertexDict
from .window import (
    CountWindow,
    EventTimeWindow,
    WindowPolicy,
    Windower,
    is_column_input,
)


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


class GraphStream:
    """Abstract supertype declaring the public API (``GraphStream.java:38-141``)."""

    def get_context(self) -> StreamContext:
        raise NotImplementedError


class SimpleEdgeStream(GraphStream):
    """The concrete edge-addition stream (``SimpleEdgeStream.java``).

    Parameters
    ----------
    edges:
        Iterable of host edge records ``(src, dst[, val])`` with raw ids, or
        numpy columns ``(src, dst[, val])`` / an ``[N, 2|3]`` array.
    window:
        Window policy (``CountWindow``, ``ProcessingTimeWindow`` or
        ``EventTimeWindow``); the context's default when omitted.
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

    def superbatches_dynamic(self, k_fn, skip: int = 0):
        raise NotImplementedError(
            "SimpleEdgeStream.superbatches_dynamic is ported in ROADMAP "
            "Queue 1, slice 7b (control and ingest)"
        )

    def _derive(self, block_fn: Callable[[Iterator[EdgeBlock]], Iterator[EdgeBlock]]) -> "SimpleEdgeStream":
        parent_source = self._block_source
        return SimpleEdgeStream(
            context=self.context,
            _blocks=lambda: block_fn(parent_source()),
            _vdict=self._vdict,
        )

    # ------------------------------------------------------------------ #
    # Transforms (each a batched per-block step on the device)
    # ------------------------------------------------------------------ #
    def map_edges(self, fn: Callable) -> "SimpleEdgeStream":
        """Map edge values: ``fn(src, dst, val) -> new_val`` on whole
        blocks (raw-id tensors, value tensor), written with torch
        operations; the result may be a tuple of tensors
        (``SimpleEdgeStream.java:217-247``)."""
        vdict = self._vdict

        def gen(blocks):
            for b in blocks:
                raw = vdict.raw_table(b.src.device)
                yield dataclasses.replace(b, val=fn(raw[b.src], raw[b.dst], b.val))

        return self._derive(gen)

    def filter_edges(self, pred: Callable) -> "SimpleEdgeStream":
        """Keep edges where ``pred(src, dst, val) -> bool[N]`` holds
        (``SimpleEdgeStream.java:290-293``)."""
        vdict = self._vdict

        def gen(blocks):
            for b in blocks:
                raw = vdict.raw_table(b.src.device)
                keep = pred(raw[b.src], raw[b.dst], b.val)
                yield dataclasses.replace(b, mask=b.mask & keep)

        return self._derive(gen)

    def filter_vertices(self, pred: Callable) -> "SimpleEdgeStream":
        """Keep edges whose *both* endpoints satisfy ``pred(vertex_ids) ->
        bool[N]``, as the reference applies the vertex filter to src and
        trg (``SimpleEdgeStream.java:257-281``)."""
        vdict = self._vdict

        def gen(blocks):
            for b in blocks:
                raw = vdict.raw_table(b.src.device)
                keep = pred(raw[b.src]) & pred(raw[b.dst])
                yield dataclasses.replace(b, mask=b.mask & keep)

        return self._derive(gen)

    def reverse(self) -> "SimpleEdgeStream":
        """Swap src/dst (``SimpleEdgeStream.java:328-337``)."""
        return self._derive(lambda blocks: (
            dataclasses.replace(b, src=b.dst, dst=b.src) for b in blocks
        ))

    def undirected(self) -> "SimpleEdgeStream":
        """Emit both directions of every edge
        (``SimpleEdgeStream.java:350-361``). Block capacity doubles."""

        def undir(b: EdgeBlock) -> EdgeBlock:
            return EdgeBlock(
                src=torch.cat([b.src, b.dst]),
                dst=torch.cat([b.dst, b.src]),
                val=pytree.tree_map(lambda v: torch.cat([v, v]), b.val),
                mask=torch.cat([b.mask, b.mask]),
                n_vertices=b.n_vertices,
            )

        return self._derive(lambda blocks: (undir(b) for b in blocks))

    def distinct(self) -> "SimpleEdgeStream":
        """Drop duplicate (src, dst) pairs across the whole stream
        (``SimpleEdgeStream.java:301-323``), on the host columns: the
        carried set is the native first-seen hash map over packed
        ``src << 32 | dst`` keys (O(new keys) a window); without the native
        library, a :class:`~gelly_streaming_tpu_torch.utils.keyruns.SortedRunSet`
        stands in. Surviving rows keep their device slots, so the output
        mask has holes and its host columns record their positions."""

        def gen(blocks):
            from ..native import NativeEncoder
            from ..utils.keyruns import SortedRunSet

            try:
                keyset = NativeEncoder()
            except RuntimeError:  # no native library here
                keyset = None
            seen = SortedRunSet()
            for b in blocks:
                cache = getattr(b, "_host_cache", None)
                if cache is not None:
                    # windower-built block: stripped columns, prefix mask
                    s_h, d_h, v_h = cache
                    n = len(s_h)
                    mask = np.zeros(b.capacity, dtype=bool)
                    mask[:n] = True
                    src = np.zeros(b.capacity, np.int64)
                    dst = np.zeros(b.capacity, np.int64)
                    src[:n] = s_h
                    dst[:n] = d_h
                else:
                    mask = b.mask.cpu().numpy()
                    src = b.src.cpu().numpy().astype(np.int64)
                    dst = b.dst.cpu().numpy().astype(np.int64)
                key = np.where(mask, (src << 32) | dst, np.int64(-1))
                if keyset is not None:
                    before = len(keyset)
                    idx, _ = keyset.encode(key)
                    novel = idx >= before
                    # first in-window occurrence of each novel key
                    _, first_pos = np.unique(idx, return_index=True)
                    is_first = np.zeros(idx.shape[0], dtype=bool)
                    is_first[first_pos] = True
                    fresh = mask & novel & is_first
                else:
                    _, first_idx = np.unique(key, return_index=True)
                    is_first = np.zeros(key.shape[0], dtype=bool)
                    is_first[first_idx] = True
                    dup = seen.contains(key) if len(seen) else np.zeros(len(key), bool)
                    fresh = mask & is_first & ~dup
                    new_keys = key[fresh]
                    if new_keys.size:
                        seen.add(np.sort(new_keys))
                out = dataclasses.replace(b, mask=to_device(fresh, b.src.device))
                if cache is not None:
                    keep = fresh[: len(s_h)]
                    out = out.with_host_cache(
                        s_h[keep], d_h[keep],
                        pytree.tree_map(lambda a: np.asarray(a)[keep], v_h),
                        positions=np.nonzero(keep)[0].astype(np.int32),
                    )
                yield out

        return self._derive(gen)

    def union(self, other: "SimpleEdgeStream") -> "SimpleEdgeStream":
        """Merge two edge streams (``SimpleEdgeStream.java:343-345``).

        Blocks of a stream with another vertex dict are re-encoded through
        this stream's dict so compact ids stay coherent. Blocks are pulled
        round-robin from both sources (draining one side first would
        starve an unbounded other)."""
        vdict = self._vdict
        self_source = self._block_source
        device = self.device

        def reencode(b: EdgeBlock) -> EdgeBlock:
            if other._vdict is vdict:
                return b
            s, d, v = b.to_host()
            raw_s = other._vdict.decode(s)
            raw_d = other._vdict.decode(d)
            enc = vdict.encode(np.stack([raw_s, raw_d], axis=1).ravel())
            return EdgeBlock.from_arrays(
                enc[0::2], enc[1::2], v, n_vertices=vdict.capacity,
                device=device, capacity=b.capacity,
            )

        def gen():
            yield from _interleave(self_source(), map(reencode, other._block_source()))

        return SimpleEdgeStream(context=self.context, _blocks=gen, _vdict=vdict)

    # ------------------------------------------------------------------ #
    # Property streams (continuously improving, per-block change-only)
    # ------------------------------------------------------------------ #
    def get_edges(self) -> EmissionStream:
        """Edge property stream. Lazy batches: the decode (and, for
        device-transformed blocks, the download) runs when a consumer
        first reads a window."""
        vdict = self._vdict

        def batches():
            for b in self.blocks():
                def thunk(b=b):
                    src, dst, val = b.to_host()
                    return vdict.decode(src), vdict.decode(dst), _host_vals(val)

                yield LazyRecordBatch(lambda s, d, v: Edge(int(s), int(d), v), thunk)

        return EmissionStream(batches)

    def get_vertices(self) -> EmissionStream:
        """Distinct vertices, emitted on first appearance
        (``SimpleEdgeStream.java:116-121,181-202``).

        Blocks with host columns take a numpy first-occurrence pass;
        device-transformed blocks keep the seen mask on the device (one
        step a window, the emission packed and downloaded only when read),
        so neither path reads the device in the producer loop."""
        vdict = self._vdict

        def batches():
            seen = np.zeros(0, bool)
            seen_dev = None
            for b in self.blocks():
                cache = getattr(b, "_host_cache", None)
                if cache is not None and seen_dev is None:
                    src, dst = cache[0], cache[1]
                    if len(src) == 0:
                        yield []
                        continue
                    if seen.size < b.n_vertices:
                        seen = np.concatenate([seen, np.zeros(b.n_vertices - seen.size, bool)])
                    both = np.stack([src, dst], axis=1).ravel()
                    uniq, first = np.unique(both, return_index=True)
                    fresh = ~seen[uniq]
                    new_ids = uniq[fresh]
                    seen[new_ids] = True
                    # first-appearance (arrival) order, as the reference
                    order = np.argsort(first[fresh], kind="stable")
                    raw = vdict.decode(new_ids[order])
                    yield RecordColumnBatch(lambda r: Vertex(int(r), None), raw)
                    continue
                # device path: the seen mask moves to the device once and
                # stays there; it grows on the device
                if seen_dev is None:
                    base = np.zeros(b.n_vertices, bool)
                    base[: seen.size] = seen
                    seen_dev = to_device(base, b.src.device)
                elif seen_dev.shape[0] < b.n_vertices:
                    seen_dev = torch.cat([
                        seen_dev,
                        torch.zeros(b.n_vertices - seen_dev.shape[0], dtype=torch.bool,
                                    device=seen_dev.device),
                    ])
                seen_dev, packed = _first_seen_update(seen_dev, b.src, b.dst, b.mask)

                def thunk(packed=packed):
                    h = packed.cpu().numpy()
                    k = int(np.count_nonzero(h >= 0))
                    return (vdict.decode(h[:k]),)

                yield LazyRecordBatch(lambda r: Vertex(int(r), None), thunk)

        return EmissionStream(batches)

    def _degree_stream(self, in_: bool, out: bool) -> EmissionStream:
        """Shared core of the degree streams (``SimpleEdgeStream.java:413-478``).

        Carried device state: an int32 degree vector over compact ids. Per
        block: a masked scatter-add of endpoint increments, and the changed
        vertices with their new degrees packed on the device
        (:func:`_degree_update`); each window's batch reads them only when
        a consumer does. The stream synchronizes once, at its end."""
        vdict = self._vdict

        def materialize(packed):
            h = packed.cpu().numpy()
            k = int(np.count_nonzero(h[0] >= 0))
            return vdict.decode(h[0, :k]), h[1, :k]

        def batches():
            deg = torch.zeros(0, dtype=torch.int32, device=self.device)
            for b in self.blocks():
                if b.n_vertices > deg.shape[0]:
                    deg = torch.cat([deg, torch.zeros(b.n_vertices - deg.shape[0],
                                                      dtype=torch.int32, device=deg.device)])
                deg, packed = _degree_update(deg, b, in_=in_, out=out)
                yield DeviceColumnBatch(lambda packed=packed: materialize(packed))
            # one wait for the whole stream: the windows' steps above are
            # queued; this puts their device time inside the producer's
            # wall time without a read per window
            if deg.is_cuda:
                torch.cuda.synchronize(deg.device)

        return EmissionStream(batches)

    def get_degrees(self) -> EmissionStream:
        return self._degree_stream(in_=True, out=True)

    def get_in_degrees(self) -> EmissionStream:
        return self._degree_stream(in_=True, out=False)

    def get_out_degrees(self) -> EmissionStream:
        return self._degree_stream(in_=False, out=True)

    def number_of_vertices(self) -> EmissionStream:
        """Running distinct-vertex count, one emission per new vertex
        (``SimpleEdgeStream.java:366-383``)."""
        vertices = self.get_vertices()

        def batches():
            count = 0
            for batch in vertices.batches():
                k = len(batch)
                yield range(count + 1, count + k + 1)
                count += k

        return EmissionStream(batches)

    def number_of_edges(self) -> EmissionStream:
        """Running edge count, one emission per edge
        (``SimpleEdgeStream.java:388-404``). Blocks with host columns count
        from them; after the first device-transformed block the running
        total is a device scalar and each window emits a
        :class:`~gelly_streaming_tpu_torch.core.emission.LazyCountRange`."""

        def batches():
            total = 0  # an int while the counts are host-known
            device_mode = False
            for b in self.blocks():
                cache = getattr(b, "_host_cache", None)
                if cache is not None and not device_mode:
                    n = len(cache[0])
                    yield range(total + 1, total + n + 1)
                    total += n
                    continue
                if not device_mode:
                    total = torch.tensor(total, dtype=torch.int32, device=b.mask.device)
                    device_mode = True
                n = b.mask.sum(dtype=torch.int32)
                yield LazyCountRange(total, n)
                total = total + n

        return EmissionStream(batches)

    def global_aggregate(
        self,
        update: Callable[[Any, EdgeBlock], Tuple[Any, Any]],
        initial_state: Any,
        emit_change_only: bool = True,
    ) -> Iterator[Any]:
        """Generic carried global aggregate (``SimpleEdgeStream.java:505-519``):
        ``update(state, block) -> (state, emission)``; ``emission`` is
        yielded when it differs from the previous one (change-only)."""
        state = initial_state
        prev = object()
        for b in self.blocks():
            state, emission = update(state, b)
            if not emit_change_only or not _emission_eq(emission, prev):
                yield emission
                prev = emission

    def vertex_aggregate(
        self, edge_mapper: Callable, vertex_mapper: Callable, max_out: int = 1,
    ) -> EmissionStream:
        """Per-vertex aggregate of the edge stream, the reference's second
        ``aggregate`` overload (``SimpleEdgeStream.java:489-494``:
        ``edges.flatMap(edgeMapper).keyBy(0).map(vertexMapper)``).

        Per window, ``edge_mapper(src_raw, dst_raw, val) -> ((key, value),
        emit)`` is lifted with :func:`torch.func.vmap` over the block's
        edges: ``emit`` is a bool[max_out] mask and key/value carry a
        leading ``max_out`` dim (scalars count as ``max_out=1``). Then
        ``vertex_mapper(key, value) -> record`` is lifted over the emitted
        records. Both are written with torch operations for ONE edge or
        record and may not branch on data or call ``.item()`` under vmap.
        Lazy per-window batches in edge-arrival order."""
        vdict = self._vdict

        def one_1d(x):
            x = torch.as_tensor(x)
            return x.unsqueeze(1) if x.dim() == 1 else x

        def window(b: EdgeBlock):
            raw = vdict.raw_table(b.src.device)
            (key, val), emit = vmap(edge_mapper)(raw[b.src], raw[b.dst], b.val)
            key, val, emit = one_1d(key), one_1d(val), one_1d(emit)
            rec = vmap(vmap(vertex_mapper))(key, val)
            return rec, emit & b.mask[:, None]

        def validate(rec, emit):
            if emit.dim() != 2 or emit.shape[1] != max_out:
                raise ValueError(
                    f"edge_mapper emitted {tuple(emit.shape[1:])} slots per "
                    f"edge but max_out={max_out}; the emit mask and every "
                    "record leaf must carry a leading [max_out] dim (scalars "
                    "count as max_out=1)"
                )
            for leaf in pytree.tree_leaves(rec):
                got = leaf.shape[1] if leaf.dim() >= 2 else None
                if got != max_out:
                    raise ValueError(
                        f"record leaf has slot dim {got} but max_out={max_out}; "
                        "key/value slots must match the emit mask width"
                    )

        def batches():
            for b in self.blocks():
                rec, emit = window(b)
                validate(rec, emit)
                leaves, treedef = pytree.tree_flatten(rec)

                def thunk(leaves=leaves, emit=emit):
                    rows, ks = np.nonzero(emit.cpu().numpy())
                    return tuple(host_array(a)[rows, ks] for a in leaves)

                yield LazyRecordBatch(
                    lambda *vals, treedef=treedef: pytree.tree_unflatten(list(vals), treedef),
                    thunk,
                )

        return EmissionStream(batches)

    # ------------------------------------------------------------------ #
    # Aggregation and windowing entry points
    # ------------------------------------------------------------------ #
    def aggregate(self, summary_aggregation) -> Iterator[Any]:
        """Run a summary aggregation over this stream
        (``SimpleEdgeStream.java:100-102`` -> ``SummaryAggregation.run``)."""
        return summary_aggregation.run(self)

    def build_neighborhood(self, directed: bool = False) -> Iterator[Tuple]:
        """Per-edge neighborhood snapshots (``SimpleEdgeStream.java:531-560``):
        ``(src, trg, neighbors)`` per processed edge, both directions when
        ``directed=False``, where ``neighbors`` is the sorted tuple of
        ``src``'s raw-id adjacency as of that edge's arrival (inclusive).
        A host path for API parity."""
        adj: dict = {}

        def emit(a, b):
            adj.setdefault(a, set()).add(b)
            return (a, b, tuple(sorted(adj[a])))

        for block in self.blocks():
            s, d, _ = block.to_host()
            raw_s = self._vdict.decode(s)
            raw_d = self._vdict.decode(d)
            for a, b in zip(raw_s.tolist(), raw_d.tolist()):
                yield emit(a, b)
                if not directed:
                    yield emit(b, a)

    def slice(
        self,
        window: Optional[WindowPolicy] = None,
        direction: EdgeDirection = EdgeDirection.OUT,
    ):
        """Discretize into a stream of graph snapshots
        (``SimpleEdgeStream.java:135-167``).

        ``window=None`` keeps the stream's own block windows; otherwise the
        blocks are re-windowed on their host columns, by edge count
        (``CountWindow``) or by event time (``EventTimeWindow``, the
        ``slice(Time, dir)`` analog). Event-time re-windowing applies
        ``timestamp_fn`` to the host column tuple ``(raw_src, raw_dst,
        val)`` and assumes ascending timestamps; windows may span block
        boundaries."""
        from .snapshot import SnapshotStream

        source = self._block_source
        device = self.device
        if window is None:
            block_iter_fn = source
        elif isinstance(window, CountWindow):
            def block_iter_fn():
                return _rewindow_count(source(), window.size, device)
        elif isinstance(window, EventTimeWindow):
            def block_iter_fn():
                return _rewindow_time(source(), window, self._vdict, device)
        else:
            raise TypeError(f"unknown window policy {window!r}")
        return SnapshotStream(block_iter_fn, direction, self._vdict, self.context)


# --------------------------------------------------------------------------- #
# Helpers
# --------------------------------------------------------------------------- #
def _degree_update(deg: torch.Tensor, block: EdgeBlock, *, in_: bool, out: bool):
    """One window's degree fold and on-device changed-vertex compaction.

    Returns ``(new_deg, packed[2, K])`` with ``K = (in_ + out) *
    block.capacity``: row 0 the changed compact ids (ascending, ``-1``
    past the changed count), row 1 their new degrees, int32. The changed
    vertices of a window are its masked endpoints, deduplicated by a sort
    and a first-occurrence compaction on the device, so a consumer reads
    O(window) bytes, in one transfer. ``new_deg`` and ``packed`` are new
    tensors: the batches emitted earlier keep theirs."""
    with _trace.span("degree.update"):
        from ..ops.segment import segment_count

        V = deg.shape[0]
        delta = torch.zeros_like(deg)
        cands = []
        if out:
            delta += segment_count(block.src, block.mask, V)
            cands.append(torch.where(block.mask, block.src, V))
        if in_:
            delta += segment_count(block.dst, block.mask, V)
            cands.append(torch.where(block.mask, block.dst, V))
        new_deg = deg + delta
        cand = torch.cat(cands) if len(cands) > 1 else cands[0]
        sorted_c = torch.sort(cand).values
        K = sorted_c.shape[0]
        is_first = sorted_c < V
        is_first[1:] &= sorted_c[1:] != sorted_c[:-1]
        pos = torch.cumsum(is_first, 0, dtype=torch.int64) - 1
        # non-first entries land in the dropped slot K (the reference's
        # mode="drop")
        ids = torch.full((K + 1,), -1, dtype=torch.int32, device=deg.device)
        ids.scatter_(0, torch.where(is_first, pos, K), sorted_c)
        ids = ids[:K]
        if V:
            degs = new_deg[torch.clamp(ids, 0, V - 1).long()]
        else:
            degs = torch.zeros(K, dtype=torch.int32, device=deg.device)
        return new_deg, torch.stack([ids, degs])


def _first_seen_update(seen, src, dst, mask):
    """One window's first-appearance pass on the device: scatter-min the
    arrival position of every masked endpoint, mark the vertices not in
    ``seen``, and pack their ids in ARRIVAL order (-1 past the new-vertex
    count)."""
    V = seen.shape[0]
    E = src.shape[0]
    big = 2 * E
    # interleaved endpoints, the host path's arrival order: s0, d0, s1, ...
    both = torch.stack([src, dst], dim=1).reshape(-1)
    bm = torch.stack([mask, mask], dim=1).reshape(-1)
    posv = torch.full((V + 1,), big, dtype=torch.int32, device=seen.device)
    posv.scatter_reduce_(
        0, torch.where(bm, both.long(), V),
        torch.arange(2 * E, dtype=torch.int32, device=seen.device), reduce="amin",
    )
    posv = posv[:V]
    occurred = posv < big
    new = occurred & ~seen
    sortkey = torch.where(new, posv, big)
    K = min(2 * E, V)
    order = torch.sort(sortkey, stable=True).indices[:K]
    ids = torch.where(sortkey[order] < big, order.to(torch.int32), -1)
    return seen | occurred, ids


def _host_vals(val) -> list:
    """A (possibly pytree) host value batch as a list of Python records."""
    leaves = pytree.tree_leaves(val)
    if not leaves:
        return []
    if isinstance(val, np.ndarray):
        return [v.item() if np.ndim(v) == 0 else v for v in val]
    n = leaves[0].shape[0]
    return [
        pytree.tree_map(lambda a: a[i].item() if np.ndim(a[i]) == 0 else np.asarray(a[i]), val)
        for i in range(n)
    ]


def _interleave(*iters: Iterator) -> Iterator:
    """Round-robin over iterators until all are exhausted."""
    active = list(iters)
    while active:
        nxt = []
        for it in active:
            try:
                yield next(it)
                nxt.append(it)
            except StopIteration:
                pass
        active = nxt


def _emission_eq(a, b) -> bool:
    if a is b:
        return True
    try:
        la, lb = pytree.tree_leaves(a), pytree.tree_leaves(b)
        if len(la) != len(lb):
            return False
        return all(np.array_equal(host_array(x), host_array(y)) for x, y in zip(la, lb))
    except (TypeError, ValueError):
        return False


def _rewindow_count(blocks: Iterator[EdgeBlock], size: int, device) -> Iterator[EdgeBlock]:
    """Re-discretize a block stream into count windows of ``size`` edges,
    on the host columns (a pytree ``val`` is sliced leaf-wise): windower
    blocks carry them, so nothing is read from the device."""
    pend: list = []  # (src, dst, val) host column tuples
    buffered = 0
    n_vertices = 0

    def merged_cols():
        if len(pend) == 1:
            return pend[0]
        s = np.concatenate([p[0] for p in pend])
        d = np.concatenate([p[1] for p in pend])
        v = pytree.tree_map(lambda *ls: np.concatenate(ls), *[p[2] for p in pend])
        return s, d, v

    for b in blocks:
        s, d, v = b.to_host()
        if len(s) == 0:
            continue
        n_vertices = max(n_vertices, b.n_vertices)
        pend.append((s, d, v))
        buffered += len(s)
        while buffered >= size:
            s, d, v = merged_cols()
            with _trace.span("window.rewindow"):
                block = from_arrays_tree(
                    s[:size], d[:size], pytree.tree_map(lambda a: a[:size], v),
                    n_vertices=n_vertices, device=device,
                )
            yield block
            pend = (
                [(s[size:], d[size:], pytree.tree_map(lambda a: a[size:], v))]
                if len(s) > size else []
            )
            buffered -= size
    if buffered:
        s, d, v = merged_cols()
        yield from_arrays_tree(s, d, v, n_vertices=n_vertices, device=device)


def _rewindow_time(
    blocks: Iterator[EdgeBlock], policy: EventTimeWindow, vdict, device
) -> Iterator[EdgeBlock]:
    """Re-discretize a block stream into tumbling event-time windows.

    ``policy.timestamp_fn`` is applied to the host column tuple
    ``(raw_src, raw_dst, val)``; ascending timestamps assumed; a window
    flushes when a later slot appears, so one window may assemble from
    several upstream blocks."""
    from .window import _require_timestamp_fn, _slot_runs

    _require_timestamp_fn(policy)
    pend: list = []  # (src, dst, val) column slices of the open window
    slot: Optional[int] = None
    n_vertices = 0

    def flush() -> EdgeBlock:
        s = np.concatenate([p[0] for p in pend])
        d = np.concatenate([p[1] for p in pend])
        v = pytree.tree_map(lambda *leaves: np.concatenate(leaves), *[p[2] for p in pend])
        pend.clear()
        return from_arrays_tree(s, d, v, n_vertices=n_vertices, device=device)

    for b in blocks:
        s, d, v = b.to_host()
        n = len(s)
        if n == 0:
            continue
        n_vertices = max(n_vertices, b.n_vertices)
        ts = np.asarray(policy.timestamp_fn((vdict.decode(s), vdict.decode(d), v)), np.float64)
        if ts.shape != (n,):
            raise ValueError(
                "EventTimeWindow.timestamp_fn returned shape "
                f"{ts.shape} re-windowing a block of {n} edges"
            )
        slots = (ts // policy.size).astype(np.int64)
        for a, e in _slot_runs(slots):
            run_slot = int(slots[a])
            if slot is not None and run_slot != slot and pend:
                yield flush()
            slot = run_slot
            pend.append((s[a:e], d[a:e], pytree.tree_map(lambda x: x[a:e], v)))
    if pend:
        yield flush()


