"""Streaming k-spanner: the host-exact fold and the device-batched variant
(PyTorch port of ``gelly_streaming_tpu/library/spanner.py``).

:class:`Spanner` keeps the reference's behavior (``library/Spanner.java:40-118``):
per edge, if the spanner already joins the endpoints within k hops the edge
is dropped, else added (``UpdateLocal``); partial spanners merge smaller
into larger under the same bounded BFS (``CombineSpanners``). The decision
is sequential in arrival order and irregular, so it stays on the host, a
host-state summary under the engine (``host_state = True``).

:class:`DeviceSpanner`: per window, ALL new edges test k-bounded
reachability in the spanner as of the window's start at once. Edges of one
window cannot reject each other, so it may keep MORE edges than the
sequential fold, but every dropped edge has a path of at most k spanner
hops for any windowing, and it equals the host result at window 1.

- ``k == 2``: 2-hop reachability between FIRST-SEEN candidates is exactly
  "the endpoint rows share a neighbor", so the spanner carries the packed
  sorted adjacency of ``ops/triangles.py`` and each window is a few
  class-bounded common-neighbor passes and one masked merge.
- ``k >= 3``: a batched breadth-first search, as in the reference: 32
  queries share each frontier word (``[B/32, V]`` words), and each hop ORs
  every target's incoming words. The window-start spanner becomes a CSR by
  target once a window (:func:`~gelly_streaming_tpu_torch.ops.reach_kernels.target_csr`); every
  query batch searches it through :func:`~gelly_streaming_tpu_torch.ops.reach_kernels.k_reach`,
  whose hop is a hand-written kernel on the card and the reference's
  segmented OR in torch on the CPU. The batch ``B`` is the reference's,
  sized to the memory budget. The accepted edges append at
  device-computed positions.

Nothing is read from the device in the window loop: the host keeps exact
shadows it can compute beside the stream (first-seen candidate keys, and
candidate degrees, a sound upper bound on spanner degrees for the class
plan). Emissions are lazy :class:`SpannerEdges` snapshots, and every
tensor a snapshot holds is its own (the merge and the append write new
tensors).
"""

from __future__ import annotations

from typing import Iterator, Set, Tuple

import numpy as np
import torch

from ..aggregate.summary import SummaryBulkAggregation
from ..core.edgeblock import bucket_capacity, to_device
from ..obs import trace as _trace
from ..ops.reach_kernels import k_reach, k_reach_plain, target_csr
from ..ops.segment import INT_MAX
from ..ops.triangles import (
    _sort_entries,
    build_sorted_directed,
    chunked_class_scan,
    degree_class_plan,
    grow_packed_columns,
    merge_packed_adjacency,
    packed_common_neighbor_exists,
    packed_key,
    row_pointers,
    sticky_search_steps,
)
from ..summaries.adjacency import AdjacencyListGraph
from ..utils.keyruns import SortedRunSet


def _k2_exists_step(pn, row_ptr, qu, qv, sel, acc, enum_width: int,
                    search_steps: int, chunk: int, *, key=None):
    """One min-degree class of common-neighbor queries, in ``chunk``
    slices (bounding the ``[chunk, enum_width]`` enumeration); the results
    land in the window's accumulator (a new tensor). Pad lanes write into
    a sentinel slot (the reference's ``mode="drop"``)."""
    with _trace.span("spanner.k2"):
        n = acc.shape[0]
        out = torch.cat([acc, acc.new_zeros(1)])
        last = qu.shape[0] - 1

        def body(out, s_i):
            selc = torch.clamp(s_i, 0, last).long()
            mask = s_i >= 0
            ex = packed_common_neighbor_exists(
                pn, row_ptr, qu[selc], qv[selc], mask, enum_width,
                search_steps=search_steps, key=key,
            )
            out[torch.where(mask, selc, n)] = ex
            return out

        return chunked_class_scan(body, out, sel, chunk)[:n]


def _k2_accept_merge(pv, pn, pr, qu, qv, qmask, reached):
    """Merge the window's ACCEPTED queries (``qmask & ~reached``) into the
    packed adjacency, on the device, into new columns."""
    with _trace.span("spanner.k2_merge"):
        keep = qmask & ~reached
        big = torch.full_like(qu, INT_MAX)
        zero = torch.zeros_like(qu)
        pv_new = torch.cat([torch.where(keep, qu, big), torch.where(keep, qv, big)])
        pn_new = torch.cat([torch.where(keep, qv, zero), torch.where(keep, qu, zero)])
        spv, spn, spr = _sort_entries(pv_new, pn_new, torch.zeros_like(pv_new))
        n_new = 2 * keep.sum(dtype=torch.int32)
        return merge_packed_adjacency(pv, pn, pr, spv, spn, spr, n_new)


def _k_reach_cnt(sp, sq, cnt, u, v, m, num_vertices: int, k: int):
    """For each query edge i: is ``v[i]`` within k hops of ``u[i]`` over the
    first ``cnt`` spanner edges ``(sp, sq)``? The reference's function and
    signature (B a multiple of 32), in plain torch: the entries sorted by
    target (dead ones to the sentinel V), then
    :func:`~gelly_streaming_tpu_torch.ops.reach_kernels.k_reach_plain` over a ``[B/32, V]`` int32
    frontier. The window loop builds the CSR once a window and calls the
    kernel's wrapper instead."""
    return k_reach_plain(target_csr(sp, sq, cnt, num_vertices), u, v, m, num_vertices, k)


def _upload_queries(u: np.ndarray, v: np.ndarray, device):
    """One batch's query operands on ``device`` in one upload: a pinned
    ``[3, B]`` int32 buffer (B the batch padded to a power of two, at least
    32) whose rows are ``u``, ``v`` and the mask, the mask as B bools in the
    first B bytes of its row. Returns the views (u, v int32 [B], m bool
    [B]); the padding is masked."""
    n = len(u)
    qcap = bucket_capacity(n, minimum=32)
    buf = np.zeros((3, qcap), np.int32)
    buf[0, :n], buf[1, :n] = u, v
    buf[2].view(bool)[:n] = True
    d = to_device(buf, device)
    return d[0], d[1], d[2].view(torch.bool)[:qcap]


def _gen_append(sp, sq, cnt, qu, qv, keep):
    """Append the ACCEPTED queries to the spanner edge columns at positions
    from a prefix sum over ``keep``, into new columns (past-capacity
    positions drop into a sentinel slot)."""
    with _trace.span("spanner.append"):
        cap = sp.shape[0]
        off = torch.cumsum(keep.to(torch.int32), 0) - 1
        pos = torch.where(keep, cnt + off, cap).clamp_(max=cap).long()
        out = []
        for col, q in ((sp, qu), (sq, qv)):
            buf = torch.cat([col, col.new_zeros(1)])
            buf[pos] = q
            out.append(buf[:cap])
        return out[0], out[1], cnt + keep.sum(dtype=torch.int32)


def _grow_cols(sp, sq, need: int, device=None):
    """Grow (or create) the general-k edge columns to a power-of-two
    capacity covering ``need`` entries."""
    cap = bucket_capacity(max(need, 16))
    if sp is None:
        return (torch.zeros(cap, dtype=torch.int32, device=device),
                torch.zeros(cap, dtype=torch.int32, device=device))
    if cap <= sp.shape[0]:
        return sp, sq
    pad = torch.zeros(cap - sp.shape[0], dtype=torch.int32, device=sp.device)
    return torch.cat([sp, pad]), torch.cat([sq, pad])


class Spanner(SummaryBulkAggregation):
    """k-spanner over the edge stream (``library/Spanner.java``), a host
    fold under the engine."""

    host_state = True
    config_fields = ("k",)

    def __init__(self, k: int, transient_state: bool = False):
        super().__init__(transient_state=transient_state)
        self.k = k

    def initial_state(self, vcap: int) -> AdjacencyListGraph:
        return AdjacencyListGraph()

    def grow_state(self, state, old_vcap, new_vcap):
        return state

    def update(self, g: AdjacencyListGraph, src, dst, val, mask) -> AdjacencyListGraph:
        """Arrival-order fold (``Spanner.UpdateLocal.foldEdges``)."""
        for u, v in zip(src.tolist(), dst.tolist()):
            if not g.bounded_bfs(u, v, self.k):
                g.add_edge(u, v)
        return g

    def combine(self, g1: AdjacencyListGraph, g2: AdjacencyListGraph) -> AdjacencyListGraph:
        """Merge smaller into larger (``Spanner.CombineSpanners.reduce``)."""
        if len(g1.adj) < len(g2.adj):
            g1, g2 = g2, g1
        for u, v in g2.edges():
            if not g1.bounded_bfs(u, v, self.k):
                g1.add_edge(u, v)
        return g1

    def transform(self, g: AdjacencyListGraph, vdict) -> AdjacencyListGraph:
        # a snapshot copy: the running summary keeps changing
        return g.copy()


class SpannerEdges:
    """One window's spanner edge set, LAZY: the device tensors are held and
    downloaded on first read (iteration, membership, len, equality).

    Reading one also feeds the revealed TRUE accepted count back into the
    workload's capacity bound (true count at the snapshot plus the entries
    offered since, on the workload's monotone offer counter), so the
    carried columns grow with the spanner, not with the stream's distinct
    edges, under any read order."""

    __slots__ = ("_kind", "_arrays", "_vdict", "_set", "_workload", "_add", "_lin")

    def __init__(self, kind, arrays, vdict, workload=None):
        self._kind = kind
        self._arrays = arrays
        self._vdict = vdict
        self._set = None
        self._workload = workload
        self._add = 0 if workload is None else workload._add_total
        self._lin = 0 if workload is None else workload._lineage

    def _materialize(self) -> Set[Tuple[int, int]]:
        if self._set is not None:
            return self._set
        if self._arrays is None or self._vdict is None:
            self._set = set()
            self._workload = None
            return self._set
        if self._kind == "k2":
            pv, pn = (a.cpu().numpy() for a in self._arrays)
            sel = (pv != INT_MAX) & (pv < pn)
            cu, cv = pv[sel], pn[sel]
        else:
            sp, sq, cnt = self._arrays
            n = int(cnt)
            cu, cv = sp[:n].cpu().numpy(), sq[:n].cpu().numpy()
        w = self._workload
        if w is not None and self._lin == w._lineage:
            true_entries = 2 * len(cu) if self._kind == "k2" else len(cu)
            w._cnt_ub = min(w._cnt_ub, true_entries + (w._add_total - self._add))
        self._workload = None
        ru = self._vdict.decode(cu)
        rv = self._vdict.decode(cv)
        self._set = {(min(int(a), int(b)), max(int(a), int(b))) for a, b in zip(ru, rv)}
        self._arrays = None  # release the device tensors once read
        return self._set

    def __iter__(self):
        return iter(self._materialize())

    def __len__(self) -> int:
        return len(self._materialize())

    def __contains__(self, e) -> bool:
        return e in self._materialize()

    def __eq__(self, other) -> bool:
        if isinstance(other, SpannerEdges):
            return self._materialize() == other._materialize()
        return self._materialize() == other

    def __repr__(self) -> str:
        return repr(self._materialize())


class DeviceSpanner:
    """Batched device k-spanner on the stream's device. ``run(stream)``
    yields a lazy :class:`SpannerEdges` per window; :meth:`edges` returns
    the current set (raw ids; an explicit read)."""

    def __init__(
        self,
        k: int,
        query_chunk: int = 1024,
        mem_budget_entries: int = 1 << 28,
        expected_edges: int = 0,
    ):
        """``expected_edges`` pre-sizes the carried columns for this many
        spanner edges (fewer growth copies). ``mem_budget_entries`` bounds
        the k >= 3 search's frontier, in bytes: ``[B/32, V]`` int32 words
        hold 32 queries per 4 bytes a vertex, which sets the query batch
        ``B`` (at most ``query_chunk``; see :meth:`_batch_cap`)."""
        self.k = k
        self.query_chunk = query_chunk
        self.expected_edges = int(expected_edges)
        self.mem_budget_entries = mem_budget_entries
        self._vdict = None
        self._device = torch.device("cpu")
        # host shadows: first-seen candidate keys, candidate degrees
        self._seen = SortedRunSet()
        self._deg = np.zeros(0, np.int64)
        self._cnt_ub = 0     # upper bound on the carried device entries
        self._add_total = 0  # monotone count of entries ever offered
        self._lineage = 0    # bumped on restore; older snapshots do not feed back
        self._steps = 8
        # k = 2 packed-adjacency carry
        self._pv = None
        self._pn = None
        self._pr = None
        # general-k edge-column carry
        self._sp = None
        self._sq = None
        self._cnt = None  # device int32 count of the general-k columns
        self._restore = None  # a checkpoint's host columns, rebuilt lazily

    def _batch_cap(self, vcap: int) -> int:
        """Queries per k >= 3 batch, the reference's value: the frontier's
        ``4 * V`` bytes a word of 32 queries within the memory budget, at
        most ``query_chunk``, a multiple of 32 rounded down to a power of
        two."""
        words = max(1, self.mem_budget_entries // (4 * max(vcap, 1)))
        b = max(32, min(self.query_chunk, words * 32))
        b = (b // 32) * 32
        return bucket_capacity(b) // 2 if bucket_capacity(b) > b else b

    def run(self, stream) -> Iterator[SpannerEdges]:
        self._vdict = stream.vertex_dict
        self._device = stream.device
        for name in ("_pv", "_pn", "_pr", "_sp", "_sq", "_cnt"):
            t = getattr(self, name)
            if t is not None:
                setattr(self, name, t.to(self._device))
        if self._cnt is None:
            self._cnt = torch.zeros((), dtype=torch.int32, device=self._device)
        for block in stream.blocks():
            s, d, _ = block.to_host()
            vcap = block.n_vertices
            self._ensure_restored(vcap)
            u, v = self._first_seen(s, d, vcap)
            if u.size == 0:
                yield self._snapshot()
                continue
            if self.k == 2:
                self._window_k2(u, v, vcap)
            else:
                self._window_gen(u, v, vcap)
            yield self._snapshot()

    def _first_seen(self, s, d, vcap: int):
        """The host prep beside the stream: canonicalize, drop self-loops,
        deduplicate in the window, keep the FIRST-SEEN keys (an edge can be
        accepted only at its first appearance: the spanner only grows), and
        add them to the candidate degrees."""
        with _trace.span("spanner.host_shadow"):
            u = np.minimum(s, d).astype(np.int64)
            v = np.maximum(s, d).astype(np.int64)
            ok = u != v
            u, v = u[ok], v[ok]
            if u.size:
                key = self._seen.filter_new(np.unique((u << 32) | v))
                self._seen.add(key)
                u = (key >> 32).astype(np.int32)
                v = (key & 0xFFFFFFFF).astype(np.int32)
            if u.size:
                if vcap > len(self._deg):
                    self._deg = np.concatenate(
                        [self._deg, np.zeros(vcap - len(self._deg), np.int64)])
                np.add.at(self._deg, u, 1)
                np.add.at(self._deg, v, 1)
            return u, v

    # ------------------------------------------------------------------ #
    def _window_k2(self, u: np.ndarray, v: np.ndarray, vcap: int) -> None:
        """2-hop reachability of the window's first-seen queries by
        class-bounded common-neighbor tests on the packed spanner
        adjacency, then a masked merge, all on the device."""
        dev = self._device
        self._cnt_ub += 2 * len(u)
        self._add_total += 2 * len(u)
        self._grow_packed(max(self._cnt_ub, 2 * self.expected_edges, 1))
        row_ptr = row_pointers(self._pv, vcap)
        key = packed_key(self._pv, self._pn)
        n_q = len(u)
        qcap = bucket_capacity(n_q, minimum=32)
        qu = np.zeros(qcap, np.int32)
        qv = np.zeros(qcap, np.int32)
        qm = np.zeros(qcap, bool)
        qu[:n_q], qv[:n_q], qm[:n_q] = u, v, True
        qu_d, qv_d, qm_d = (to_device(a, dev) for a in (qu, qv, qm))
        acc = torch.zeros(qcap, dtype=torch.bool, device=dev)
        # the class plan from the candidate-degree shadow (>= the true
        # spanner degrees, so every class's width covers its rows)
        mindeg = np.minimum(self._deg[u], self._deg[v])
        self._steps = sticky_search_steps(self._steps, int(max(self._deg.max(), 1)))
        for width, sel, tcap, chunk in degree_class_plan(mindeg):
            selp = np.full(tcap, -1, np.int32)
            selp[: len(sel)] = sel
            acc = _k2_exists_step(self._pn, row_ptr, qu_d, qv_d, to_device(selp, dev), acc,
                                  width, self._steps, chunk, key=key)
        self._pv, self._pn, self._pr = _k2_accept_merge(
            self._pv, self._pn, self._pr, qu_d, qv_d, qm_d, acc)

    def _window_gen(self, u: np.ndarray, v: np.ndarray, vcap: int) -> None:
        """General k: the frontier search per query batch against the
        window-start spanner (batches cannot reject each other, the same
        relaxation as k = 2), then the appends. The window-start spanner's
        CSR by target is built once and read by every batch; it covers
        the first ``ub0`` columns, the host's bound on the window-start
        count (entries past the device ``cnt`` go to the sentinel target).
        Nothing is read from the device."""
        dev = self._device
        ub0 = self._cnt_ub
        self._cnt_ub += len(u)
        self._add_total += len(u)
        self._sp, self._sq = _grow_cols(
            self._sp, self._sq, max(self._cnt_ub, self.expected_edges), device=dev)
        # an empty window-start spanner reaches nothing: one batch, all kept
        batch = self._batch_cap(vcap) if ub0 else len(u)
        csr = None
        if ub0:
            with _trace.span("spanner.csr"):
                csr = target_csr(self._sp[:ub0], self._sq[:ub0], self._cnt, vcap)
        decisions = []
        for a in range(0, len(u), batch):
            b = min(a + batch, len(u))
            uj, vj, mj = _upload_queries(u[a:b], v[a:b], dev)
            if csr is None:
                reached = torch.zeros_like(mj)
            else:
                with _trace.span("spanner.k_reach"):
                    reached = k_reach(csr, uj, vj, mj, vcap, self.k)
            decisions.append((uj, vj, mj, reached))
        for uj, vj, mj, reached in decisions:
            self._sp, self._sq, self._cnt = _gen_append(
                self._sp, self._sq, self._cnt, uj, vj, mj & ~reached)

    # ------------------------------------------------------------------ #
    def _snapshot(self) -> SpannerEdges:
        if self.k == 2:
            arrays = None if self._pv is None else (self._pv, self._pn)
            return SpannerEdges("k2", arrays, self._vdict, self)
        arrays = None if self._sp is None else (self._sp, self._sq, self._cnt)
        return SpannerEdges("gen", arrays, self._vdict, self)

    def _grow_packed(self, need: int) -> None:
        self._pv, self._pn, self._pr = grow_packed_columns(
            self._pv, self._pn, self._pr, need, minimum=16, device=self._device)

    def _host_columns(self) -> Tuple[np.ndarray, np.ndarray]:
        """The current spanner edges as COMPACT canonical id columns (one
        download, the checkpoint and emission read). The download reveals
        the TRUE accepted count, so the capacity bound reconciles here."""
        if self._restore is not None:
            return self._restore
        if self.k == 2:
            if self._pv is None:
                return np.zeros(0, np.int32), np.zeros(0, np.int32)
            pv, pn = self._pv.cpu().numpy(), self._pn.cpu().numpy()
            sel = (pv != INT_MAX) & (pv < pn)
            su, sv = pv[sel], pn[sel]
        else:
            if self._sp is None:
                return np.zeros(0, np.int32), np.zeros(0, np.int32)
            n = int(self._cnt)
            su, sv = self._sp[:n].cpu().numpy(), self._sq[:n].cpu().numpy()
        self._reconcile(su, sv)
        return su, sv

    def _reconcile(self, su: np.ndarray, sv: np.ndarray) -> None:
        """Snap the capacity bound to the true accepted count and re-compact
        the device columns when they are 4x oversized or more."""
        dev = self._device
        true_entries = 2 * len(su) if self.k == 2 else len(su)
        self._cnt_ub = true_entries
        floor = max(true_entries,
                    2 * self.expected_edges if self.k == 2 else self.expected_edges, 1)
        cap = bucket_capacity(max(floor, 16))
        if self.k == 2:
            if self._pv is not None and self._pv.shape[0] >= 4 * cap:
                pvp, pnp, prp, _ = build_sorted_directed(su, sv)
                self._pv, self._pn, self._pr = (to_device(a, dev) for a in (pvp, pnp, prp))
        elif self._sp is not None and self._sp.shape[0] >= 4 * cap:
            spn = np.zeros(cap, np.int32)
            sqn = np.zeros(cap, np.int32)
            spn[: len(su)], sqn[: len(sv)] = su, sv
            self._sp, self._sq = to_device(spn, dev), to_device(sqn, dev)
            self._cnt = torch.full((), len(su), dtype=torch.int32, device=dev)

    def _ensure_restored(self, vcap: int) -> None:
        """Rebuild the device state from a checkpoint's host columns, once
        the first window reveals the capacity."""
        if self._restore is None:
            return
        su, sv = self._restore
        self._restore = None
        dev = self._device
        self._seen = SortedRunSet(
            (su.astype(np.int64) << 32) | sv.astype(np.int64) if len(su) else None)
        self._deg = np.zeros(vcap, np.int64)
        if len(su):
            np.add.at(self._deg, su, 1)
            np.add.at(self._deg, sv, 1)
        if self.k == 2:
            self._cnt_ub = 2 * len(su)
            self._add_total = 2 * len(su)
            if len(su):
                pvp, pnp, prp, _ = build_sorted_directed(su, sv)
                self._pv, self._pn, self._pr = (to_device(a, dev) for a in (pvp, pnp, prp))
        else:
            self._cnt_ub = len(su)
            self._add_total = len(su)
            if len(su):
                self._sp, self._sq = _grow_cols(None, None, len(su), device=dev)
                self._sp[: len(su)] = to_device(su, dev)
                self._sq[: len(sv)] = to_device(sv, dev)
                self._cnt = torch.full((), len(su), dtype=torch.int32, device=dev)

    def sync(self) -> None:
        """Wait for the carried spanner state: the end-of-stream barrier."""
        if self._device.type == "cuda":
            torch.cuda.synchronize(self._device)

    def state_dict(self) -> dict:
        """Checkpoint surface, the reference's format (one download)."""
        su, sv = self._host_columns()
        return {"su": np.ascontiguousarray(su), "sv": np.ascontiguousarray(sv)}

    def load_state_dict(self, d: dict) -> None:
        self._restore = (np.asarray(d["su"], np.int32), np.asarray(d["sv"], np.int32))
        self._seen = SortedRunSet()
        self._deg = np.zeros(0, np.int64)
        self._cnt_ub = 0
        self._add_total = 0
        self._lineage += 1  # snapshots made before the restore must not feed back
        self._pv = self._pn = self._pr = None
        self._sp = self._sq = None
        self._cnt = None

    def edges(self) -> Set[Tuple[int, int]]:
        """Current spanner edges as raw-id pairs (an explicit read)."""
        if self._vdict is None:
            return set()
        su, sv = self._host_columns()
        if len(su) == 0:
            return set()
        ru = self._vdict.decode(su)
        rv = self._vdict.decode(sv)
        return {(min(int(a), int(b)), max(int(a), int(b))) for a, b in zip(ru, rv)}
