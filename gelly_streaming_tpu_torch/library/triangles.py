"""Triangle counting workloads, per window and streaming exact (PyTorch
port of ``gelly_streaming_tpu/library/triangles.py``).

:class:`WindowTriangles`:

The reference (``example/WindowTriangles.java:60-139``) generates
O(Σdeg²) wedge candidates per vertex and joins them against the real edges
across two more shuffles; here each window is one sorted-adjacency
intersection (``ops/triangles.py``), emitting ``(count,
window_max_timestamp)`` pairs like the reference's final
``timeWindowAll().sum(0)`` stream. The dense-row width is planned on the
host from the window's host columns (:func:`_oriented_degree_bucket`), so
:meth:`WindowTriangles.run_stream` reads nothing from the device per
window.


:class:`ExactTriangleCount`: single-pass exact local and global counts
over the whole stream (``example/ExactTriangleCount.java:41-207``). The
reference pairs per-edge neighborhood snapshots so a triangle counts once,
when its last edge arrives; here every accumulated edge carries an arrival
RANK in the packed sorted adjacency (``ops/triangles.py``), and per window
each new edge counts the common neighbors whose two closing edges both
rank earlier. Duplicate edges are dropped. Emission is change-only per
window: ``(vertex, running_count)`` for each changed vertex and ``(-1,
running_total)``, downloaded lazily on first read (:class:`TriangleBatch`).
The window loop reads nothing from the device: the packed capacity grows
from an exact host shadow of the distinct canonical keys, and the
min-degree classes from a duplicate-inflated host degree bound.
"""

from __future__ import annotations

from typing import Iterable, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..core.device import DEFAULT_DEVICE, resolve_device
from ..core.edgeblock import bucket_capacity, to_device
from ..core.emission import LazyListBatch
from ..core.window import WindowPolicy, Windower
from ..obs import trace as _trace
from ..ops.triangles import (
    build_sorted_directed,
    chunked_class_scan,
    degree_class_plan,
    grow_packed_columns,
    packed_key,
    packed_triangle_update,
    prepare_packed_window,
    sticky_search_steps,
    window_triangle_count,
)
from ..utils.keyruns import SortedRunSet

GLOBAL_KEY = -1  # the reference's "total" counter vertex id


def _window_step(block, max_degree: int):
    return window_triangle_count(block.src, block.dst, block.mask, block.n_vertices, max_degree)


class WindowTriangles:
    """Exact triangles per tumbling window.

    ``run(edges)`` yields ``(count, max_timestamp)`` per window on
    ``device`` (default ``"cuda"``; ``device="cpu"`` runs on the CPU):
    ``max_timestamp`` is the inclusive window end for event-time windows
    (Flink's ``TimeWindow.maxTimestamp()``), the window index for count
    windows. :meth:`run_stream` runs on the stream's own device.
    """

    def __init__(self, window: WindowPolicy, *, device=DEFAULT_DEVICE):
        self.window = window
        self.device = resolve_device(device)

    def run(self, edges: Iterable[Tuple]) -> Iterator[Tuple[int, Optional[float]]]:
        windower = Windower(self.window, device=self.device)
        for info, block in windower.blocks_with_info(edges):
            total, _ = _window_step(block, _plan_width(block))
            ts = info.max_timestamp if info.max_timestamp is not None else info.index
            yield int(total), ts

    def run_stream(self, stream) -> Iterator[Tuple[torch.Tensor, int]]:
        """The system path: consume a ``SimpleEdgeStream`` through
        ``stream.slice(self.window)`` (re-windowing on the host columns) and
        count per slice. Yields ``(count, window_index)`` with ``count``
        still an int32 DEVICE scalar: ``int(count)`` waits for it, and a
        consumer that does not read it makes no device read per window."""
        snaps = stream.slice(self.window)
        for i, block in enumerate(snaps._block_iter_fn()):
            total, _ = _window_step(block, _plan_width(block))
            yield total, i


def _plan_width(block) -> int:
    """The dense-row width of one window, from its host columns."""
    with _trace.span("tri.plan"):
        s, d, _ = block.to_host()
        return _oriented_degree_bucket(s, d, block.n_vertices)


def _oriented_degree_bucket(
    s: np.ndarray, d: np.ndarray, num_vertices: int,
    dense_budget_bytes: int = 2 << 30,
) -> int:
    """Power-of-two bucket covering the window's max ORIENTED out-degree,
    the dense-row width of the kernel, from the host columns.

    With degree-ordered orientation every out-neighbor of ``a`` has degree
    >= deg(a) >= outdeg(a), so outdeg(a)^2 <= 2E': the width is bounded by
    ``min(max degree, sqrt(2E))``, both from one bincount (duplicate edges
    only loosen the bound). If that bound would blow the dense ``[V,
    width]`` rows past ``dense_budget_bytes``, the exact width comes from a
    host dedup and orientation instead."""
    E = len(s)
    if E == 0:
        return bucket_capacity(0)
    deg = np.bincount(s, minlength=num_vertices)
    deg = deg + np.bincount(d, minlength=num_vertices)
    w = int(min(int(deg.max()), int(np.ceil(np.sqrt(2.0 * E))) + 1))
    cap = bucket_capacity(max(w, 8))
    if num_vertices * cap * 4 <= dense_budget_bytes:
        return cap
    u = np.minimum(s, d).astype(np.int64)
    v = np.maximum(s, d).astype(np.int64)
    ok = u != v
    u, v = u[ok], v[ok]
    if u.size == 0:
        return bucket_capacity(0)
    key = np.unique(u * num_vertices + v)
    u = key // num_vertices
    v = key % num_vertices
    deg = np.bincount(u, minlength=num_vertices) + np.bincount(v, minlength=num_vertices)
    du, dv = deg[u], deg[v]
    swap = (dv < du) | ((dv == du) & (v < u))
    a = np.where(swap, v, u)
    return bucket_capacity(int(np.bincount(a, minlength=num_vertices).max()))


def _pad_fill(a: np.ndarray, cap: int, fill) -> np.ndarray:
    out = np.full(cap, fill, a.dtype)
    out[: len(a)] = a
    return out


def _prep_step(pv, pn, pr, src, dst, mask, rank0, num_vertices: int, search_steps: int):
    """The window's device prep (:func:`prepare_packed_window`)."""
    with _trace.span("tri.packed_prep"):
        return prepare_packed_window(
            pv, pn, pr, src, dst, mask, rank0, num_vertices, search_steps=search_steps,
        )


def _packed_count_step(
    pn, pr, row_ptr, qu, qv, qrank, qmask, sel, counts_and_delta,
    enum_width: int, search_steps: int, chunk: int, *, key=None,
):
    """One min-degree class of the window's queries: ``sel`` (padded with
    -1) selects them on the device, and the class runs in ``chunk``
    slices. Every slice's counts are a new tensor, so an emission read
    after later windows keeps its window's counts."""
    with _trace.span("tri.packed_count"):
        last = qu.shape[0] - 1

        def body(carry, s_i):
            counts, delta = carry
            selc = torch.clamp(s_i, 0, last).long()
            mask_s = (s_i >= 0) & qmask[selc]
            counts, d = packed_triangle_update(
                pn, pr, row_ptr, qu[selc], qv[selc], qrank[selc], mask_s,
                counts, enum_width, search_steps=search_steps, key=key,
            )
            return counts, delta + d

        return chunked_class_scan(body, counts_and_delta, sel, chunk)


class TriangleBatch(LazyListBatch):
    """One window's change-only emission, LAZY: the device counts are held
    and downloaded on first read, so unread windows cost no device read.

    Changes are reported against the counts of the PREVIOUS materialized
    batch: reading batches in stream order gives per-window change-only
    emission exactly; skipping windows folds their changes into the next
    one read, and reading an old batch after a newer one diffs against the
    newer state without moving the workload's diff base back."""

    __slots__ = ("_workload", "_counts", "_total", "_vdict", "_seq", "_items")

    def __init__(self, workload, counts, total, vdict, seq):
        self._workload = workload
        self._counts = counts
        self._total = total
        self._vdict = vdict
        self._seq = seq
        self._items = None

    def _compute(self) -> list:
        w = self._workload
        counts = self._counts.cpu().numpy()
        total = int(self._total)
        prev = w._emit_prev
        if prev is None or len(prev) < len(counts):
            grown = np.zeros(len(counts), counts.dtype)
            if prev is not None:
                grown[: len(prev)] = prev
            prev = grown
        changed = np.nonzero(counts != prev[: len(counts)])[0]
        raw = self._vdict.decode(changed) if len(changed) else []
        out = [(int(r), int(counts[c])) for r, c in zip(raw, changed)]
        if total != w._emit_prev_total:
            out.append((GLOBAL_KEY, total))
        if self._seq >= w._emit_seq_base:
            # the newest materialization wins; an older batch read later
            # must not clobber the diff base
            w._emit_prev = counts
            w._emit_prev_total = total
            w._emit_seq_base = self._seq
        return out


class ExactTriangleCount:
    """Single-pass exact local and global triangle counting.

    ``run(stream)`` consumes a ``SimpleEdgeStream`` on the stream's device
    and yields, per window, a list-like :class:`TriangleBatch` of
    ``(raw_vertex_id, running_count)`` for the changed vertices plus
    ``(GLOBAL_KEY, running_total)`` when it changed (read lazily)."""

    def __init__(self):
        # host carry: the RAW edge columns in arrival order, as per-window
        # chunks (the checkpoint's source of truth, concatenated only
        # there), and a duplicate-inflated degree bound (bincounts only)
        # that covers every true row length for the class plan
        self._u_chunks: List[np.ndarray] = []
        self._v_chunks: List[np.ndarray] = []
        self._deg = np.zeros(0, np.int64)
        self._have = SortedRunSet()  # distinct canonical keys seen
        self._n_raw = 0  # cumulative rank offset (padded block widths)
        self._emit_prev = None  # host counts at the last materialized batch
        self._emit_prev_total = 0
        self._emit_seq = 0
        self._emit_seq_base = 0
        self._search_steps = 8
        # device carry: counts [vcap] and the packed sorted adjacency
        # (vertex, nbr, rank), both directions of every canonical edge
        self._device = torch.device("cpu")
        self._counts = None
        self._pv = None
        self._pn = None
        self._pr = None
        self._n_packed = 0
        self._total = None  # device int32 scalar, made on the stream's device

    def run(self, stream) -> Iterator[TriangleBatch]:
        self._adopt_device(stream.device)
        if self._total is None:
            self._total = torch.zeros((), dtype=torch.int32, device=self._device)
        vdict = stream.vertex_dict
        for block in stream.blocks():
            yield self._process(block, vdict)

    def _adopt_device(self, device) -> None:
        """Take the stream's device; a restored carry moves there."""
        self._device = torch.device(device)
        for name in ("_counts", "_pv", "_pn", "_pr", "_total"):
            t = getattr(self, name)
            if t is not None:
                setattr(self, name, t.to(self._device))

    def sync(self) -> None:
        """Wait for the carried counts: the end-of-stream barrier."""
        if self._device.type == "cuda":
            torch.cuda.synchronize(self._device)

    def _raw_columns(self) -> Tuple[np.ndarray, np.ndarray]:
        """Flatten (and collapse) the per-window raw-column chunks: the
        checkpoint's sync point; the window loop never concatenates."""
        if len(self._u_chunks) > 1:
            self._u_chunks = [np.concatenate(self._u_chunks)]
            self._v_chunks = [np.concatenate(self._v_chunks)]
        if not self._u_chunks:
            return np.zeros(0, np.int32), np.zeros(0, np.int32)
        return self._u_chunks[0], self._v_chunks[0]

    def state_dict(self) -> dict:
        """Checkpoint surface, the reference's format. The packed adjacency
        is not saved: :meth:`load_state_dict` rebuilds it from the raw
        columns (rank ORDER, all the counting rule reads, survives)."""
        u, v = self._raw_columns()
        return {
            "u": u, "v": v,
            "deg": self._deg,
            "n_raw": self._n_raw,
            "counts": None if self._counts is None else self._counts.cpu().numpy(),
            "total": 0 if self._total is None else int(self._total),
        }

    def load_state_dict(self, d: dict) -> None:
        u, v = np.asarray(d["u"]), np.asarray(d["v"])
        dev = self._device
        self._u_chunks = [u] if len(u) else []
        self._v_chunks = [v] if len(v) else []
        self._deg = np.asarray(d["deg"], np.int64)
        self._n_raw = int(d.get("n_raw", len(u)))
        counts = d["counts"]
        self._counts = None if counts is None else torch.as_tensor(
            np.array(counts, np.int32), device=dev)
        self._total = torch.full((), int(d["total"]), dtype=torch.int32, device=dev)
        self._emit_prev = None if counts is None else np.array(counts, np.int32)
        self._emit_prev_total = int(d["total"])
        self._emit_seq = 0
        self._emit_seq_base = 0
        self._pv = self._pn = self._pr = None
        self._n_packed = 0
        self._have = SortedRunSet()
        if len(u):
            # rebuild the packed adjacency from the raw columns: canonical
            # first occurrences, ranked by raw arrival position
            cu = np.minimum(u, v).astype(np.int64)
            cv = np.maximum(u, v).astype(np.int64)
            ok = cu != cv
            pos_all = np.nonzero(ok)[0]
            cu, cv = cu[ok], cv[ok]
            key = (cu << 32) | cv
            _, first = np.unique(key, return_index=True)
            self._have = SortedRunSet(key)
            ranks = pos_all[first].astype(np.int32)
            pvp, pnp, prp, n_new = build_sorted_directed(
                cu[first].astype(np.int32), cv[first].astype(np.int32), ranks)
            self._n_packed = n_new
            self._pv, self._pn, self._pr = (
                torch.as_tensor(a, device=dev) for a in (pvp, pnp, prp))
            # future ranks must exceed every rebuilt rank
            self._n_raw = max(self._n_raw, len(u))

    # ------------------------------------------------------------------ #
    def _process(self, block, vdict) -> TriangleBatch:
        vcap = block.n_vertices
        dev = self._device
        # the host columns drive the CLASS plan only (free through the
        # block's host cache on the ingest path); dedup, merge and count
        # run on the device
        cache = getattr(block, "_host_cache", None)
        if cache is not None:
            s, d = cache[0], cache[1]
            # None = prefix alignment (host row i is device slot i);
            # distinct() records the real slots
            pos = getattr(block, "_host_cache_pos", None)
        else:
            mask_h = block.mask.cpu().numpy()
            s = block.src.cpu().numpy()[mask_h]
            d = block.dst.cpu().numpy()[mask_h]
            pos = np.nonzero(mask_h)[0].astype(np.int32)
        if self._counts is None:
            self._counts = torch.zeros(vcap, dtype=torch.int32, device=dev)
        elif vcap > self._counts.shape[0]:
            self._counts = torch.cat([
                self._counts,
                torch.zeros(vcap - self._counts.shape[0], dtype=torch.int32, device=dev),
            ])
        if len(s) == 0:
            return []
        with _trace.span("tri.host_shadow"):
            self._u_chunks.append(np.asarray(s, np.int32))
            self._v_chunks.append(np.asarray(d, np.int32))
            if vcap > len(self._deg):
                self._deg = np.concatenate(
                    [self._deg, np.zeros(vcap - len(self._deg), np.int64)])
            np.add.at(self._deg, s, 1)
            np.add.at(self._deg, d, 1)
            # the EXACT host shadow of the packed count: the distinct
            # first-seen canonical keys, by the rule the device applies, so
            # the packed capacity grows by exactly the entries the merge adds
            cu = np.minimum(s, d).astype(np.int64)
            cvv = np.maximum(s, d).astype(np.int64)
            okc = cu != cvv
            new_key = self._have.filter_new(np.unique((cu[okc] << 32) | cvv[okc]))
            self._have.add(new_key)

        # 1. the device prep: canonicalize, dedup, reject known edges,
        # merge into the packed adjacency, rebuild row_ptr
        rank0 = self._n_raw
        self._n_raw += block.capacity  # ranks are slot-indexed; only ORDER matters
        self._pv, self._pn, self._pr = grow_packed_columns(
            self._pv, self._pn, self._pr, self._n_packed + 2 * len(new_key), device=dev)
        search_steps = max(4, int(self._pv.shape[0]).bit_length())
        (self._pv, self._pn, self._pr, row_ptr, qu, qv, qrank, qmask) = _prep_step(
            self._pv, self._pn, self._pr, block.src, block.dst, block.mask,
            rank0, vcap, search_steps,
        )
        self._n_packed += 2 * len(new_key)
        key = packed_key(self._pv, self._pn)

        # 2. count closures per min-degree class; the duplicate-inflated
        # degree bound only ever widens a class
        with _trace.span("tri.plan_classes"):
            mindeg = np.minimum(self._deg[s], self._deg[d])
            self._search_steps = sticky_search_steps(self._search_steps, int(self._deg.max()))
            plan = list(degree_class_plan(mindeg))
        acc = (self._counts, torch.zeros((), dtype=torch.int32, device=dev))
        for width, sel, tcap, chunk in plan:
            if pos is not None:
                sel = pos[sel]
            acc = _packed_count_step(
                self._pn, self._pr, row_ptr, qu, qv, qrank, qmask,
                to_device(_pad_fill(sel, tcap, np.int32(-1)), dev), acc,
                width, self._search_steps, chunk, key=key,
            )
        self._counts, delta = acc
        self._total = self._total + delta
        self._emit_seq += 1
        return TriangleBatch(self, self._counts, self._total, vdict, self._emit_seq)
