"""Host-side window discretization: unbounded edge stream -> EdgeBlocks.

The counterpart of ``gelly_streaming_tpu/core/window.py``. A ``Windower``
consumes host edge records or numpy columns, runs them through the
:class:`~gelly_streaming_tpu_torch.core.vertexdict.VertexDict` (the keyBy
analog), and emits padded, capacity-bucketed
:class:`~gelly_streaming_tpu_torch.core.edgeblock.EdgeBlock` batches on the
stream's device — one per tumbling window.

Three policies: ``CountWindow(n)`` (every ``n`` edges is a window) on the
record path, the numpy column path and the chunked column path of file
ingest (:meth:`Windower.blocks_from_chunks`); ``ProcessingTimeWindow``
(wall clock, record path); and ``EventTimeWindow`` (tumbling slots of an
ascending event time) on the record, column and chunked paths.

Superbatches pack K consecutive windows into one
:class:`SuperbatchGroup`: one group encode and per-window host column
views, with the ``[K, cap]`` device stack built only for consumers that
fold on it. The adaptive-K packers (``*_dynamic``) come with
``superbatch="auto"`` in ROADMAP Queue 1, slice 7.

Blocks carry *compact* int32 ids; raw ids stay host-side in the dict.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Iterable, Iterator, Optional, Sequence, Tuple

import numpy as np

from ..obs import trace as _trace
from .edgeblock import (
    VAL_DTYPE,
    EdgeBlock,
    StackedEdgeBlock,
    prefix_host_cols,
    stack_blocks,
    stack_host_cols,
)
from .device import DEFAULT_DEVICE, resolve_device
from .vertexdict import VertexDict

_AUTO_K = ("ROADMAP Queue 1, slice 7 (durability, control and ingest: "
           'superbatch="auto")')


def is_column_input(edges) -> bool:
    """True when ``edges`` is vectorized column input: an ``[N, k]``
    ndarray or a ``(src, dst[, val][, ts])`` tuple/list of 1-D arrays.
    THE shared fast-path predicate of the windower and the stream."""
    if isinstance(edges, np.ndarray):
        return True
    return (
        isinstance(edges, (tuple, list))
        and len(edges) >= 2
        and all(isinstance(c, np.ndarray) and c.ndim == 1 for c in edges)
    )


@dataclasses.dataclass
class WindowPolicy:
    """Base class for window assignment policies."""


@dataclasses.dataclass(frozen=True)
class WindowInfo:
    """Host-side metadata for one emitted window (the ``TimeWindow`` analog).

    ``start``/``end`` are event-time bounds (end exclusive) for event-time
    windows, None for count windows; ``index`` counts emitted windows from 0.
    """

    index: int
    start: Optional[float]
    end: Optional[float]

    @property
    def max_timestamp(self) -> Optional[float]:
        """Inclusive end, matching Flink's ``TimeWindow.maxTimestamp()``."""
        return None if self.end is None else self.end - 1


@dataclasses.dataclass
class CountWindow(WindowPolicy):
    """Tumbling window of a fixed number of edges."""

    size: int


@dataclasses.dataclass
class ProcessingTimeWindow(WindowPolicy):
    """Tumbling wall-clock window: closes when ``seconds`` have passed
    since the window's first record, or at ``max_count`` records (which
    bounds block capacity under bursts). Live sources that can go idle
    yield ``None`` ticks, which close an open window on schedule."""

    seconds: float
    max_count: int = 1 << 20


@dataclasses.dataclass
class EventTimeWindow(WindowPolicy):
    """Tumbling event-time window of ``size`` time units.

    ``timestamp_fn(edge) -> number`` extracts the (ascending) event time,
    the analog of the reference's ``AscendingTimestampExtractor``. On the
    column paths it is applied to the column tuple itself, so an
    index-based extractor like ``lambda e: e[2]`` selects the same column
    it would per record; a non-indexing fn must be numpy-broadcastable or
    the windower raises."""

    size: float
    timestamp_fn: Callable[[Tuple], float] = None  # type: ignore[assignment]


class Windower:
    """Discretize host edge records into EdgeBlocks on ``device``.

    Edge records are ``(src, dst)`` or ``(src, dst, val)`` tuples (raw ids).
    The windower owns the stream's VertexDict so compact ids are stable
    across windows — carried device state indexed by compact id stays valid
    as new vertices appear (vertex capacity only grows, in power-of-two
    buckets).
    """

    def __init__(
        self,
        policy: WindowPolicy,
        vertex_dict: Optional[VertexDict] = None,
        *,
        device,
        val_dtype=VAL_DTYPE,
    ):
        self.policy = policy
        self.vertex_dict = vertex_dict if vertex_dict is not None else VertexDict()
        self.device = device
        self.val_dtype = val_dtype

    def _rows_to_cols(self, rows: Sequence[Tuple]) -> Tuple:
        """One window's record tuples -> raw ``(src, dst, val|None)``
        columns (val presence decided by the window's first record)."""
        n = len(rows)
        raw_src = np.fromiter((r[0] for r in rows), dtype=np.int64, count=n)
        raw_dst = np.fromiter((r[1] for r in rows), dtype=np.int64, count=n)
        if n and len(rows[0]) > 2 and rows[0][2] is not None:
            val = np.asarray([r[2] for r in rows], dtype=self.val_dtype)
        else:
            val = None
        return raw_src, raw_dst, val

    def _make_block(self, rows: Sequence[Tuple]) -> EdgeBlock:
        return self._block_from_arrays(*self._rows_to_cols(rows))

    def _block_from_arrays(
        self, raw_src: np.ndarray, raw_dst: np.ndarray, val: Optional[np.ndarray]
    ) -> EdgeBlock:
        """Encode one window's raw columns and upload the padded block to
        the stream's device."""
        n = raw_src.shape[0]
        # the span covers the whole host pack: encode + pad + upload
        with _trace.span(
            "window.pack",
            {"edges": int(n)} if _trace.on() else None,
        ):
            # Paired encode keeps first-seen order by edge arrival (src
            # before dst per edge), matching the reference's per-record
            # processing.
            src, dst = self.vertex_dict.encode_pair(raw_src, raw_dst)
            return self._encoded_block(src, dst, val)

    def _block_from_encoded(
        self, src: np.ndarray, dst: np.ndarray, val: Optional[np.ndarray]
    ) -> EdgeBlock:
        """Build a block from already-compact int32 columns (the fused
        native parse + encode path: the vertex dict was updated
        upstream)."""
        n = src.shape[0]
        with _trace.span(
            "window.pack",
            {"edges": int(n), "encoded": True} if _trace.on() else None,
        ):
            src = np.ascontiguousarray(src, np.int32)
            dst = np.ascontiguousarray(dst, np.int32)
            return self._encoded_block(src, dst, val)

    def _encoded_block(self, src, dst, val) -> EdgeBlock:
        """Upload one window of compact ids and attach its host columns."""
        block = EdgeBlock.from_arrays(
            src, dst, val, n_vertices=self.vertex_dict.capacity,
            device=self.device, val_dtype=self.val_dtype,
        )
        n = len(src)
        host_val = (
            np.zeros(n, dtype=self.val_dtype)
            if val is None
            else np.asarray(val, self.val_dtype)
        )
        return block.with_host_cache(src, dst, host_val)

    def blocks(self, edges: Iterable[Tuple]) -> Iterator[EdgeBlock]:
        """Yield one EdgeBlock per tumbling window."""
        for _, block in self.blocks_with_info(edges):
            yield block

    def blocks_with_info(
        self, edges: Iterable[Tuple]
    ) -> Iterator[Tuple[WindowInfo, EdgeBlock]]:
        """Like :meth:`blocks` but paired with host-side window metadata
        (the ``TimeWindow`` a reference window function receives,
        ``SnapshotStream.java:146``)."""
        policy = self.policy
        if is_column_input(edges):
            yield from self._array_windows(edges)
            return
        if callable(getattr(edges, "iter_chunks", None)) and isinstance(
            policy, CountWindow
        ):
            # chunk-capable source: consume its column chunks directly.
            # Count windows only: time policies read per-record ticks and
            # timestamps that chunks do not carry
            yield from self.blocks_from_chunks(edges.iter_chunks())
            return
        if isinstance(policy, CountWindow):
            yield from self._record_count_windows(edges, policy)
        elif isinstance(policy, ProcessingTimeWindow):
            yield from self._record_processing_windows(edges, policy)
        elif isinstance(policy, EventTimeWindow):
            yield from self._record_event_windows(edges, policy)
        else:
            raise TypeError(f"unknown window policy {policy!r}")

    def _record_count_windows(self, edges, policy: CountWindow):
        index = 0
        buf: list[Tuple] = []
        for e in edges:
            if e is None:  # live-source time tick; count windows ignore
                continue
            buf.append(e)
            if len(buf) >= policy.size:
                yield WindowInfo(index, None, None), self._make_block(buf)
                index += 1
                buf = []
        if buf:
            yield WindowInfo(index, None, None), self._make_block(buf)

    def _record_processing_windows(self, edges, policy: ProcessingTimeWindow):
        index = 0
        buf: list[Tuple] = []
        t0: Optional[float] = None
        for e in edges:
            now = time.perf_counter()
            if e is not None:
                if t0 is None:
                    t0 = now
                buf.append(e)
            if buf and (now - t0 >= policy.seconds or len(buf) >= policy.max_count):
                yield WindowInfo(index, None, None), self._make_block(buf)
                index += 1
                buf = []
                t0 = None
        if buf:
            yield WindowInfo(index, None, None), self._make_block(buf)

    def _record_event_windows(self, edges, policy: EventTimeWindow):
        _require_timestamp_fn(policy)
        ts_fn = policy.timestamp_fn
        index = 0
        buf: list[Tuple] = []
        current: Optional[int] = None
        for e in edges:
            if e is None:
                # idle tick: event-time windows close on event time only
                continue
            w = int(ts_fn(e) // policy.size)
            if current is None:
                current = w
            if w != current:
                if buf:
                    yield self._info(index, current), self._make_block(buf)
                    index += 1
                buf = []
                current = w
            buf.append(e)
        if buf:
            yield self._info(index, current), self._make_block(buf)

    def _info(self, index: int, time_slot: int) -> WindowInfo:
        size = self.policy.size
        return WindowInfo(index, time_slot * size, (time_slot + 1) * size)

    def _array_windows(self, edges) -> Iterator[Tuple[WindowInfo, EdgeBlock]]:
        """Array fast path: ``edges`` is an [N,2|3] ndarray or a
        (src, dst[, val][, ts]) tuple/list of 1-D arrays. Window boundaries
        are computed with numpy (no per-record Python)."""
        if isinstance(edges, np.ndarray):
            if edges.ndim != 2 or not 2 <= edges.shape[1] <= 3:
                raise ValueError("edge array must be [N, 2] or [N, 3]")
            cols = [edges[:, i] for i in range(edges.shape[1])]
        else:
            cols = [np.asarray(c) for c in edges]
        src = cols[0].astype(np.int64)
        dst = cols[1].astype(np.int64)
        val = cols[2].astype(self.val_dtype) if len(cols) > 2 else None
        n = src.shape[0]
        policy = self.policy
        if isinstance(policy, CountWindow):
            for index, start in enumerate(range(0, n, policy.size)):
                end = start + policy.size
                yield WindowInfo(index, None, None), self._block_from_arrays(
                    src[start:end], dst[start:end],
                    None if val is None else val[start:end],
                )
        elif isinstance(policy, EventTimeWindow):
            _require_timestamp_fn(policy)
            # the extractor applied to the column tuple: an index-based fn
            # (lambda e: e[k]) picks the column it picks per record
            try:
                ts = np.asarray(policy.timestamp_fn(tuple(cols)), np.float64)
            except Exception as e:
                raise ValueError(
                    "EventTimeWindow.timestamp_fn could not be applied to "
                    "the column tuple on the array ingest path; use an "
                    "index-based extractor (lambda e: e[k]) or a numpy-"
                    f"broadcastable fn ({e})"
                ) from e
            if ts.shape != (n,):
                raise ValueError(
                    "EventTimeWindow.timestamp_fn returned shape "
                    f"{ts.shape} on the array path; expected ({n},)"
                )
            slots = (ts // policy.size).astype(np.int64)
            for index, (a, b) in enumerate(_slot_runs(slots)):
                yield self._info(index, int(slots[a])), self._block_from_arrays(
                    src[a:b], dst[a:b], None if val is None else val[a:b]
                )
        else:
            raise TypeError(f"unknown window policy {policy!r}")

    # ------------------------------------------------------------------ #
    # Superbatch packing: K windows -> one ingest group
    # ------------------------------------------------------------------ #
    def superbatches(
        self, edges: Iterable[Tuple], k: int
    ) -> Iterator["SuperbatchGroup"]:
        """Pack K consecutive windows into one :class:`SuperbatchGroup`
        (the final group may be shorter). On count windows over column or
        record input the whole group is encoded once and no per-window
        block is built; window boundaries are unchanged."""
        if k < 1:
            raise ValueError(f"superbatch k must be >= 1, got {k}")
        if not isinstance(self.policy, CountWindow):
            # time windows: pack the per-window blocks
            yield from superbatches_from_blocks(
                self.blocks_with_info(edges), k, with_info=True
            )
            return
        if is_column_input(edges):
            yield from self._array_superbatches(edges, k)
            return
        if not callable(getattr(edges, "iter_chunks", None)):
            yield from self._record_superbatches(iter(edges), k)
            return
        yield from superbatches_from_blocks(
            self.blocks_with_info(edges), k, with_info=True
        )

    def _array_superbatches(self, edges, k: int) -> Iterator["SuperbatchGroup"]:
        """Count-window column fast path: slice the raw columns into
        per-window triples and pack each group through
        :meth:`pack_window_cols`."""
        if isinstance(edges, np.ndarray):
            if edges.ndim != 2 or not 2 <= edges.shape[1] <= 3:
                raise ValueError("edge array must be [N, 2] or [N, 3]")
            cols = [edges[:, i] for i in range(edges.shape[1])]
        else:
            cols = [np.asarray(c) for c in edges]
        src = cols[0].astype(np.int64)
        dst = cols[1].astype(np.int64)
        val = cols[2].astype(self.val_dtype) if len(cols) > 2 else None
        n = src.shape[0]
        size = self.policy.size
        index = 0
        for g0 in range(0, n, size * k):
            g1 = min(g0 + size * k, n)
            win_cols = [
                (src[w0:min(w0 + size, g1)], dst[w0:min(w0 + size, g1)],
                 None if val is None else val[w0:min(w0 + size, g1)])
                for w0 in range(g0, g1, size)
            ]
            yield self.pack_window_cols(win_cols, first_index=index)
            index += len(win_cols)

    def _record_superbatches(
        self, edges: Iterator[Tuple], k: int
    ) -> Iterator["SuperbatchGroup"]:
        """Count-window record path: buffer K windows of raw records,
        convert each window to raw columns once, pack the group. Live-source
        ``None`` ticks are ignored, as in :meth:`blocks`."""
        size = self.policy.size
        index = 0
        win_rows: list = []
        rows: list = []

        def flush():
            nonlocal win_rows, index
            cols = [self._rows_to_cols(rws) for rws in win_rows]
            group = self.pack_window_cols(cols, first_index=index)
            index += len(cols)
            win_rows = []
            return group

        for e in edges:
            if e is None:
                continue
            rows.append(e)
            if len(rows) >= size:
                win_rows.append(rows)
                rows = []
                if len(win_rows) >= k:
                    yield flush()
        if rows:
            win_rows.append(rows)
        if win_rows:
            yield flush()

    def superbatches_dynamic(self, edges, k_fn, skip: int = 0):
        raise NotImplementedError(f"adaptive superbatches are ported in {_AUTO_K}")

    def pack_window_cols(
        self, win_cols: Sequence[Tuple], first_index: int = 0
    ) -> "SuperbatchGroup":
        """Pack already-closed windows (raw-id column triples ``(src, dst,
        val|None)``) into one :class:`SuperbatchGroup` with a single group
        encode and no per-window device work."""
        k = len(win_cols)
        lens = [len(c[0]) for c in win_cols]
        with _trace.span(
            "window.superbatch_pack",
            {"k": k, "edges": int(sum(lens)), "window_index": first_index}
            if _trace.on() else None,
        ):
            # seen-vertex watermark before the group encode (see
            # SuperbatchGroup.n_seen_per_window)
            n_seen_before = len(self.vertex_dict)
            src = np.concatenate([np.asarray(c[0], np.int64) for c in win_cols])
            dst = np.concatenate([np.asarray(c[1], np.int64) for c in win_cols])
            s_g, d_g = self.vertex_dict.encode_pair(src, dst)
            s_g = np.asarray(s_g, np.int32)
            d_g = np.asarray(d_g, np.int32)
            cols = []
            infos = []
            a = 0
            for j, c in enumerate(win_cols):
                b = a + lens[j]
                v = c[2]
                cols.append((
                    s_g[a:b], d_g[a:b],
                    None if v is None else np.asarray(v, self.val_dtype),
                ))
                infos.append(WindowInfo(first_index + j, None, None))
                a = b
            return SuperbatchGroup(
                infos, cols, self.vertex_dict.capacity, device=self.device,
                n_seen_before=n_seen_before,
            )

    # ------------------------------------------------------------------ #
    # Chunked-column ingest: file-scale streams (datasets.stream_file)
    # ------------------------------------------------------------------ #
    def blocks_from_chunks(
        self, chunks: Iterable[Tuple], encoded: bool = False
    ) -> Iterator[Tuple[WindowInfo, EdgeBlock]]:
        """Discretize an iterator of column chunks ``(src, dst[, val])``
        into windows, re-slicing across chunk boundaries: the
        bounded-memory ingest path of file-backed streams (the native
        parser yields chunks of about a fixed size; the window policy
        decides the block boundaries).

        ``encoded=True`` marks chunks whose endpoint columns are already
        compact int32 ids of this windower's vertex dict (the fused native
        ingest, ``VertexDict.iter_encode_file``)."""
        policy = self.policy
        if isinstance(policy, CountWindow):
            yield from self._chunk_count_windows(chunks, policy.size, encoded)
        elif isinstance(policy, EventTimeWindow):
            build = self._block_from_encoded if encoded else self._block_from_arrays
            runs = iter_time_slot_runs(chunks, policy, val_dtype=self.val_dtype)
            for index, (slot, src, dst, val) in enumerate(runs):
                yield self._info(index, slot), build(src, dst, val)
        else:
            raise TypeError(f"unknown window policy {policy!r}")

    def _chunk_count_windows(self, chunks, size: int, encoded: bool = False):
        pending: list[Tuple] = []  # (src, dst, val|None) column triples
        have = 0
        index = 0
        build = self._block_from_encoded if encoded else self._block_from_arrays
        for cols in chunks:
            src, dst = np.asarray(cols[0]), np.asarray(cols[1])
            val = cols[2] if len(cols) > 2 else None
            if len(src) == 0:
                continue
            pending.append((src, dst, val))
            have += len(src)
            while have >= size:
                have -= size
                yield WindowInfo(index, None, None), build(
                    *take_cols(pending, size, self.val_dtype)
                )
                index += 1
        if have:
            yield WindowInfo(index, None, None), build(
                *take_cols(pending, have, self.val_dtype)
            )


def _require_timestamp_fn(policy: EventTimeWindow) -> None:
    if policy.timestamp_fn is None:
        raise ValueError(
            "EventTimeWindow requires timestamp_fn — without it the edge "
            "value would silently be read as the event time"
        )


def _slot_runs(slots: np.ndarray):
    """``(start, end)`` of each run of equal slots (ascending timestamps:
    each run is one window)."""
    bounds = np.nonzero(np.diff(slots))[0] + 1
    starts = np.concatenate([[0], bounds])
    ends = np.concatenate([bounds, [len(slots)]])
    return zip(starts.tolist(), ends.tolist())


def iter_time_slot_runs(chunks, policy: EventTimeWindow, val_dtype=VAL_DTYPE):
    """The chunked event-time splitter: consume ``(src, dst[, val])``
    column chunks and yield ``(slot, src, dst, val|None)`` per completed
    tumbling window (ascending timestamps; boundaries are runs of equal
    ``ts // size``; the final partial window included). A window spanning
    many chunks is concatenated once, at its flush."""
    _require_timestamp_fn(policy)
    slot: Optional[int] = None
    pend: list = []

    def flush():
        src = np.concatenate([p[0] for p in pend])
        dst = np.concatenate([p[1] for p in pend])
        if any(p[2] is not None for p in pend):
            val = np.concatenate([
                np.zeros(len(p[0]), val_dtype) if p[2] is None
                else np.asarray(p[2], val_dtype)
                for p in pend
            ])
        else:
            val = None
        pend.clear()
        return slot, src, dst, val

    for cols in chunks:
        src, dst = np.asarray(cols[0]), np.asarray(cols[1])
        val = cols[2] if len(cols) > 2 else None
        n = len(src)
        if n == 0:
            continue
        ts = np.asarray(
            policy.timestamp_fn(tuple(
                np.asarray(c) if c is not None else None for c in cols
            )),
            np.float64,
        )
        if ts.shape != (n,):
            raise ValueError(
                "EventTimeWindow.timestamp_fn returned shape "
                f"{ts.shape} on the chunked path; expected ({n},)"
            )
        slots = (ts // policy.size).astype(np.int64)
        for a, b in _slot_runs(slots):
            run_slot = int(slots[a])
            if slot is not None and run_slot != slot and pend:
                yield flush()
            slot = run_slot
            pend.append((src[a:b], dst[a:b], None if val is None else val[a:b]))
    if pend:
        yield flush()


def take_cols(pend: list, take: int, val_dtype=VAL_DTYPE):
    """Slice ``take`` edges off a pending list of ``(src, dst, val|None)``
    column chunks, mutating ``pend`` in place. A take from one chunk hands
    out slice views; a take across chunks concatenates once, filling
    ``None`` value chunks with zeros when any chunk carries values. (The
    event-time ``ts`` column of the reference's wire frames comes with
    ROADMAP Queue 1, slice 8.)"""
    s_parts, d_parts, v_parts = [], [], []
    got = 0
    while got < take:
        s, d, v = pend[0][:3]
        need = take - got
        if len(s) <= need:
            s_parts.append(s)
            d_parts.append(d)
            v_parts.append(v)
            pend.pop(0)
            got += len(s)
        else:
            s_parts.append(s[:need])
            d_parts.append(d[:need])
            v_parts.append(None if v is None else v[:need])
            pend[0] = (s[need:], d[need:], None if v is None else v[need:])
            got = take
    if len(s_parts) == 1:
        return s_parts[0], d_parts[0], v_parts[0]
    src = np.concatenate(s_parts)
    dst = np.concatenate(d_parts)
    if any(v is not None for v in v_parts):
        val = np.concatenate([
            np.zeros(len(s), val_dtype) if v is None else np.asarray(v, val_dtype)
            for s, v in zip(s_parts, v_parts)
        ])
    else:
        val = None
    return src, dst, val


class SuperbatchGroup:
    """K consecutive windows as ONE ingest unit (the superbatch).

    ``cols`` holds per-window host column triples ``(src, dst,
    val|None)`` of compact int32 ids (the view the windowed CC carries
    fold), or None when the member windows have no host columns.
    :meth:`stacked` builds (and keeps) the ``[K, cap]``
    :class:`~gelly_streaming_tpu_torch.core.edgeblock.StackedEdgeBlock` on
    ``device`` for consumers that fold on the device stack.

    ``n_seen_before`` is ``len(vertex_dict)`` when the packer started the
    group encode (None when the group was packed from pre-built blocks).
    """

    __slots__ = ("infos", "cols", "n_vertices", "device", "_blocks",
                 "_stacked", "n_seen_before")

    def __init__(self, infos, cols, n_vertices: int, *, device,
                 blocks=None, n_seen_before: Optional[int] = None):
        self.infos = infos
        self.cols = cols
        self.n_vertices = n_vertices
        self.device = device
        self._blocks = blocks
        self._stacked = None
        self.n_seen_before = n_seen_before

    def __len__(self) -> int:
        return len(self.infos)

    def n_seen_per_window(self) -> Optional[list]:
        """The ``len(vertex_dict)`` a per-window consumer would have read
        after each member window's encode, rebuilt from the encoded
        columns (ids are assigned in first-seen order); None without the
        pre-encode watermark."""
        if self.cols is None or self.n_seen_before is None:
            return None
        out = []
        n = int(self.n_seen_before)
        for s, d, _ in self.cols:
            if len(s):
                n = max(n, 1 + int(max(s.max(), d.max())))
            out.append(n)
        return out

    def blocks(self) -> Iterator[EdgeBlock]:
        """The member windows as per-window :class:`EdgeBlock`\\ s (the
        per-window fallback view)."""
        if self._blocks is not None:
            yield from self._blocks
            return
        for s, d, v in self.cols:
            s = np.ascontiguousarray(s, np.int32)
            d = np.ascontiguousarray(d, np.int32)
            block = EdgeBlock.from_arrays(
                s, d, v, n_vertices=self.n_vertices, device=self.device,
            )
            host_val = (
                np.zeros(len(s), dtype=VAL_DTYPE) if v is None
                else np.asarray(v, VAL_DTYPE)
            )
            yield block.with_host_cache(s, d, host_val)

    def stacked(self) -> StackedEdgeBlock:
        if self._stacked is None:
            with _trace.span(
                "window.stack",
                {"k": len(self), "from_cols": self.cols is not None}
                if _trace.on() else None,
            ):
                if self.cols is not None:
                    self._stacked = stack_host_cols(
                        self.cols, self.n_vertices, device=self.device
                    )
                else:
                    self._stacked = stack_blocks(self._blocks)
        return self._stacked


def _group_from_blocks(group: list, infos: list) -> SuperbatchGroup:
    """One group of pre-built blocks as a :class:`SuperbatchGroup`; host
    column views when every member carries its host cache."""
    cols = None
    if all(prefix_host_cols(b) is not None for b in group):
        cols = [b._host_cache for b in group]
    return SuperbatchGroup(
        infos, cols, max(b.n_vertices for b in group),
        device=group[0].src.device, blocks=group,
    )


def superbatches_from_blocks(
    blocks: Iterable, k: int, with_info: bool = False,
) -> Iterator[SuperbatchGroup]:
    """Pack an EdgeBlock iterator into :class:`SuperbatchGroup`\\ s of K
    (the generic path: the per-window blocks already exist, so this
    recovers the fused fold, not the fused ingest)."""
    group: list = []
    infos: list = []
    for item in blocks:
        info, block = item if with_info else (None, item)
        group.append(block)
        infos.append(info)
        if len(group) >= k:
            yield _group_from_blocks(group, infos)
            group, infos = [], []
    if group:
        yield _group_from_blocks(group, infos)


def superbatches_from_blocks_dynamic(blocks, k_fn, with_info: bool = False):
    raise NotImplementedError(f"adaptive superbatches are ported in {_AUTO_K}")


def iter_superbatches(stream, k: int) -> Iterator[SuperbatchGroup]:
    """Superbatch groups for any stream: the stream's own packer when it
    offers one (``SimpleEdgeStream.superbatches``), else generic packing
    of its block iterator, prefetched
    :func:`~gelly_streaming_tpu_torch.core.pipeline.superbatch_prefetch_depth`
    windows deep on the stream's device."""
    fast = getattr(stream, "superbatches", None)
    if callable(fast):
        yield from fast(k)
        return
    from .pipeline import prefetch, superbatch_prefetch_depth

    yield from superbatches_from_blocks(
        prefetch(stream.blocks(), superbatch_prefetch_depth(k),
                 device=getattr(stream, "device", None)),
        k,
    )


def iter_superbatches_dynamic(stream, k_fn):
    raise NotImplementedError(f"adaptive superbatches are ported in {_AUTO_K}")


def blocks_from_edges(
    edges: Iterable[Tuple],
    window_size: int,
    vertex_dict: Optional[VertexDict] = None,
    *,
    device=DEFAULT_DEVICE,
    **kw: Any,
) -> Iterator[EdgeBlock]:
    """Convenience: count-window discretization of an edge iterable into
    blocks on ``device``."""
    w = Windower(CountWindow(window_size), vertex_dict, device=resolve_device(device), **kw)
    return w.blocks(edges)
