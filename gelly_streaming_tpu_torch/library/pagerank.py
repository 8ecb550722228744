"""Incremental PageRank over the streaming graph, BASELINE config #4
(PyTorch port of ``gelly_streaming_tpu/library/pagerank.py``).

Not in the Java reference; BASELINE.json adds it as message passing in the
``applyOnNeighbors`` style:

- The accumulated graph is carried as device edge columns (compact ids,
  power-of-two capacity) with the rank vector.
- Per window, power iteration runs **warm-started from the previous
  window's ranks**: after a small batch of new edges the previous ranks
  are near the new fixpoint, so few iterations are needed.
- One iteration is an ``index_add_`` of ``d * rank[src] / outdeg[src]``
  over the edge list plus the teleport and dangling-mass terms; the
  convergence test is the L1 change.

Ranks are over the directed edge set as given; vertices without
out-edges spread their mass uniformly, so ranks sum to 1.

What differs from the XLA reference, and why:

- The reference runs a window (append, warm start, fixpoint) as one
  jitted dispatch; its early exit is a ``lax.while_loop`` over
  ``chunk``-long ``lax.scan`` bodies with a freeze flag. On one device the
  port runs the warm start and the whole fixpoint as one launch of a
  hand-written kernel (``ops/pagerank_kernels.py:fixpoint``,
  ``csrc/pagerank.cu``), which stops at the converged iteration (the
  reference's frozen iterations change nothing) and reads nothing back:
  a window is the two in-place appends and that launch. On CPU tensors,
  and on the mesh path, the torch form
  (``pagerank_kernels.fixpoint_plain``) runs each chunk's ``chunk``
  iterations (each ``torch.where(done, r, new)``), then reads ``done`` on
  the host once: at most ``max_chunks`` host reads a window, counted in
  ``pagerank_kernels.HOST_READS`` (zero on the kernel path).
  ``iterations`` and ``l1_delta`` mean what they mean in the reference.
- The reference writes the window's padded block into the donated carry
  with ``dynamic_update_slice`` and masks everything past the edge count.
  Here the block goes into the carry in place at the host-known offset
  (``src[n0:n0 + cap].copy_(bsrc)``), the capacity rule asserted, and the
  iteration reads only the first ``n_edges`` entries (the masked rest
  contributes nothing in the reference either).
- The kernel sums each vertex's in-edges over a CSR whose rows its
  integer atomics fill in an order that changes from run to run (as
  ``index_add_`` of floats on a card does): compare ranks within a
  tolerance, never bitwise.
- The K-window ``lax.scan`` of the group fold is a loop over the same
  one-window function (:func:`_window_step`), which both paths share.

``superbatch="auto"`` drives the group path under an ``AutoK`` controller
like CC's; this carry's per-window cost is the fixpoint, which grouping
cannot remove, so the controller's job here is to hold K = 1.

With ``mesh`` (a >1-wide ``"edges"`` axis), the fixpoint runs inside
``shard_map``: each rank scatters the messages of its contiguous slice of
the edge columns into a replicated vertex table, the out-degrees
all-reduce once and each iteration's partial ranks all-reduce before the
teleport terms. Every decision reads post-reduce (replicated) values, and
the chunk's early-exit flag itself is all-reduced before its host read, so
every rank leaves the loop at the same chunk. That path keeps the torch
iteration: it needs an all-reduce between each scatter and the teleport
terms, which one kernel launch cannot make.
"""

from __future__ import annotations

from typing import Iterator, NamedTuple

import numpy as np
import torch

from ..core.edgeblock import bucket_capacity, to_device
from ..obs import trace as _trace
from ..ops import pagerank_kernels
from ..parallel import comm
from ..parallel.mesh import EDGE_AXIS, P, mesh_shape
from ..summaries.groupfold import GroupFoldable

class PageRankEmission(NamedTuple):
    """Per-window emission. ``iterations``/``l1_delta`` are device scalars
    (read on first use; on the card the fixpoint kernel writes them and the
    window reads nothing back), so successive windows queue on the device
    instead of waiting per emission; ``int()``/``float()`` them to read."""

    window: int
    num_vertices: int
    iterations: torch.Tensor
    l1_delta: torch.Tensor


def _window_step(carry, bsrc, bdst, n_edges0: int, n_new: int, n_seen: int,
                 damping: float, tol: float, chunk: int, max_chunks: int,
                 mesh=None):
    """One window: append, then the warm start and the fixpoint (one kernel
    launch on the card). ``carry`` is ``(src, dst, ranks)`` at their
    capacities; ``bsrc``/``bdst`` the window's padded
    block, of which the first ``n_new`` entries are real. The block is
    written in place at ``n_edges0`` (the host keeps the edge capacity at
    ``n_edges0`` + the block's capacity or more); the padding past the real
    entries is overwritten by the next window. Returns ``(carry, delta,
    iters)``; the rank vector is a new tensor, so a held carry is not
    changed. With ``mesh`` each rank iterates over the real edges of its
    contiguous slice of the carried columns."""
    with _trace.span("pagerank.window"):
        src, dst, ranks = carry
        cap = bsrc.shape[0]
        if n_edges0 + cap > src.shape[0]:
            raise AssertionError(
                f"edge capacity {src.shape[0]} cannot hold the block of {cap} at {n_edges0}")
        src[n_edges0:n_edges0 + cap].copy_(bsrc)
        dst[n_edges0:n_edges0 + cap].copy_(bdst)
        n_edges = n_edges0 + n_new
        with _trace.span("pagerank.fixpoint", device=ranks.device):
            if mesh is None:
                ranks, delta, iters = pagerank_kernels.fixpoint(
                    src[:n_edges], dst[:n_edges], ranks, n_seen, damping, tol, chunk,
                    max_chunks,
                )
            else:
                def shard_fn(src_s, dst_s, ranks):
                    # the rank's slice holds real edges up to n_edges only
                    c = src_s.shape[0]
                    k = max(0, min(c, n_edges - comm.axis_index(EDGE_AXIS) * c))
                    return pagerank_kernels.fixpoint_plain(
                        src_s[:k], dst_s[:k], ranks, n_seen, damping, tol, chunk,
                        max_chunks, axis_name=EDGE_AXIS)

                ranks, delta, iters = comm.shard_map(
                    shard_fn, mesh, (P(EDGE_AXIS), P(EDGE_AXIS), P()), (P(), P(), P()),
                )(src, dst, ranks)
        return (src, dst, ranks), delta, iters


class IncrementalPageRank(GroupFoldable):
    """``run(stream)`` folds each window's edges into the carried graph and
    re-converges the ranks from the previous fixpoint, on the stream's
    device.

    ``max_iter`` bounds the power iterations per window (rounded up to a
    multiple of ``chunk``, the early-exit granularity). ``superbatch=K``
    folds K consecutive windows as one group (the
    :class:`~gelly_streaming_tpu_torch.summaries.groupfold.GroupFoldable`
    declaration): the same one-window step runs over the group's columns,
    and the K emissions carry the same values as the per-window path's."""

    def __init__(
        self,
        damping: float = 0.85,
        tol: float = 1e-6,
        max_iter: int = 100,
        chunk: int = 10,
        mesh=None,
        superbatch: int = 1,
    ):
        self._set_superbatch(superbatch)
        #: optional device mesh: the per-window fixpoint shards the edge
        #: columns over the ``"edges"`` axis with per-iteration all-reduces
        self.mesh = mesh
        self.damping = damping
        self.tol = tol
        self.chunk = chunk
        self.max_chunks = max(1, -(-max_iter // chunk))
        self._device = torch.device("cpu")
        self._carry = None  # (src, dst, ranks) tensors
        self._n_edges = 0   # host mirror of the append position
        self._vdict = None
        self._w = 0  # next emission's window index (run-scoped)
        #: carried seen-vertex watermark: max(restored, 1 + max compact id
        #: streamed so far), from the STREAM's ids (the live dict can run
        #: ahead of consumption under prefetch and group packing)
        self._n_seen = 0

    # ------------------------------------------------------------------ #
    def _ensure_capacity(self, block_cap: int, vcap: int) -> None:
        """Grow the carry (log-many times over the stream): the edge
        capacity holds n_edges + the whole padded block, so the in-place
        append never reaches past it."""
        ecap = bucket_capacity(self._n_edges + block_cap, minimum=self._edge_min())
        dev = self._device
        if self._carry is None:
            self._carry = (
                torch.zeros(ecap, dtype=torch.int32, device=dev),
                torch.zeros(ecap, dtype=torch.int32, device=dev),
                torch.zeros(vcap, dtype=torch.float32, device=dev),
            )
            return
        src, dst, ranks = self._carry
        if ecap > src.shape[0]:
            grow = torch.zeros(ecap - src.shape[0], dtype=torch.int32, device=dev)
            src = torch.cat([src, grow])
            dst = torch.cat([dst, grow])
        if vcap > ranks.shape[0]:
            ranks = torch.cat([
                ranks, torch.zeros(vcap - ranks.shape[0], dtype=ranks.dtype, device=dev)])
        self._carry = (src, dst, ranks)

    def _edge_min(self) -> int:
        """The smallest edge bucket: the sharded step splits the edge
        columns over the mesh's edge axis, so capacities divide by it."""
        if self.mesh is None:
            return 8
        return max(8, mesh_shape(self.mesh).get(EDGE_AXIS, 1))

    def _live_mesh(self):
        """The mesh when its edge axis is wider than 1 (a width-1 mesh is
        the single-device path)."""
        if self.mesh is None or mesh_shape(self.mesh).get(EDGE_AXIS, 1) == 1:
            return None
        return self.mesh

    def run(self, stream) -> Iterator[PageRankEmission]:
        self._device = stream.device
        if self._carry is not None:
            self._carry = tuple(t.to(self._device) for t in self._carry)
        self._vdict = stream.vertex_dict
        self._w = 0
        if self.superbatch > 1 or self.superbatch_auto:
            from ..summaries.groupfold import drive_group_folded

            yield from drive_group_folded(
                self, stream, self.superbatch,
                controller=self._attach_control(self.superbatch),
            )
            return
        for block in stream.blocks():
            yield self._one_window(block)


    def _step(self, bsrc, bdst, n_new: int, n_seen: int, vcap: int):
        self._ensure_capacity(bsrc.shape[0], vcap)
        self._carry, delta, iters = _window_step(
            self._carry, bsrc, bdst, self._n_edges, n_new, n_seen,
            self.damping, self.tol, self.chunk, self.max_chunks,
            self._live_mesh(),
        )
        self._n_edges += n_new
        w = self._w
        self._w += 1
        return PageRankEmission(w, n_seen, iters, delta)

    def _one_window(self, block) -> PageRankEmission:
        """The per-window fold (the run loop and the group fallback)."""
        cache = getattr(block, "_host_cache", None)
        n_new = int(np.asarray(block.to_host()[0]).shape[0])
        if cache is not None and len(cache[0]):
            self._n_seen = max(self._n_seen, 1 + int(max(cache[0].max(), cache[1].max())))
        elif cache is None:
            # a device-transformed block: no host ids to advance the
            # watermark from; the live dict is the only source
            self._n_seen = max(self._n_seen, len(self._vdict))
        out = self._step(block.src, block.dst, n_new, self._n_seen, block.n_vertices)
        _trace.window_done(block.cut_ns, self._device)
        return out

    # ---- GroupFoldable declaration (summaries/groupfold.py) ---------- #
    def group_supported(self, group) -> bool:
        """The group path needs the packer's host columns (the per-window
        seen-vertex watermark comes from their compact ids)."""
        return group.cols is not None

    def fold_group(self, group) -> Iterator[PageRankEmission]:
        """K windows through the shared one-window step: one upload of the
        group's columns, padded to one ``[K, wcap]`` stack; the watermark
        advances per member window exactly as the per-window path's does."""
        cols = group.cols
        lens = [len(c[0]) for c in cols]
        wcap = bucket_capacity(max(lens), minimum=self._edge_min())
        bsrc = np.zeros((len(cols), wcap), np.int32)
        bdst = np.zeros((len(cols), wcap), np.int32)
        for i, (s, d, _v) in enumerate(cols):
            bsrc[i, : lens[i]] = s
            bdst[i, : lens[i]] = d
        with _trace.span(
            "pagerank.group",
            {"k": len(cols), "edges": int(sum(lens)), "n_vertices": int(group.n_vertices)}
            if _trace.on() else None,
        ):
            bsrc_d = to_device(bsrc, self._device)
            bdst_d = to_device(bdst, self._device)
            out = []
            for i, (s, d, _v) in enumerate(cols):
                if len(s):
                    self._n_seen = max(self._n_seen, 1 + int(max(s.max(), d.max())))
                out.append(self._step(bsrc_d[i], bdst_d[i], lens[i], self._n_seen,
                                      group.n_vertices))
        yield from out

    def fold_group_fallback(self, group) -> Iterator[PageRankEmission]:
        """Per-window fold of a group without host columns."""
        for block in group.blocks():
            yield self._one_window(block)

    def sync(self) -> None:
        """Wait until the carried (edges, ranks) are complete: the
        end-of-stream barrier for throughput timing."""
        if self._device.type == "cuda":
            torch.cuda.synchronize(self._device)

    # ------------------------------------------------------------------ #
    def state_dict(self) -> dict:
        """Checkpoint surface, the reference's numpy format."""
        if self._carry is None:
            return {"edges": {"src": np.zeros(0, np.int32), "dst": np.zeros(0, np.int32)},
                    "ranks": None}
        src, dst, ranks = self._carry
        n = self._n_edges
        return {
            "edges": {"src": src[:n].cpu().numpy(), "dst": dst[:n].cpu().numpy()},
            "ranks": ranks.cpu().numpy(),
            "n_seen": int(self._n_seen),
        }

    def load_state_dict(self, d: dict) -> None:
        if d["ranks"] is None:
            self._carry = None
            self._n_edges = 0
            self._n_seen = 0
            return
        s = np.asarray(d["edges"]["src"], np.int32)
        t = np.asarray(d["edges"]["dst"], np.int32)
        self._n_edges = len(s)
        ecap = bucket_capacity(self._n_edges)
        ranks = np.asarray(d["ranks"], np.float32)
        # a checkpoint without the watermark: every seen vertex holds
        # positive mass after a fixpoint, padding slots exactly 0
        self._n_seen = int(d.get("n_seen", np.count_nonzero(ranks)))
        dev = self._device
        self._carry = (
            torch.as_tensor(np.pad(s, (0, ecap - len(s))), device=dev),
            torch.as_tensor(np.pad(t, (0, ecap - len(t))), device=dev),
            torch.as_tensor(ranks.copy(), device=dev),
        )

    # ---- serving surface (serving/server.py Servable contract) ------- #
    def servable(self, vdict=None) -> "RankServable":
        """Adapter publishing the rank vector per window for ``RankQuery``
        point lookups. The window step writes its edge columns in place,
        but its rank vector is a new tensor every window, so a published
        one is never written again."""
        return RankServable(self, vdict)

    def ranks(self) -> dict:
        """Current (raw vertex id -> rank), seen vertices only."""
        if self._carry is None:
            return {}
        n = len(self._vdict)
        r = self._carry[2][:n].cpu().numpy()
        raw = self._vdict.decode(np.arange(n))
        return {int(v): float(x) for v, x in zip(raw, r)}


class RankServable:
    """:class:`~gelly_streaming_tpu_torch.serving.server.Servable` adapter
    for :class:`IncrementalPageRank`: each published snapshot is the
    window's rank vector (a tensor the step allocated, never written
    again; the reference copies its DONATED buffer instead). With
    ``superbatch=K`` a group's K emissions surface together, so all K
    publishes carry the END-of-group ranks and snapshots advance at group
    granularity (the ``CCServable`` caveat; run ``superbatch=1`` for
    per-window snapshot pinning)."""

    def __init__(self, workload: IncrementalPageRank, vdict=None):
        from ..serving import RankQuery

        self.query_classes = (RankQuery,)
        self._workload = workload
        self._vdict = vdict

    def payloads(self, stream):
        pr = self._workload
        vdict = stream.vertex_dict
        self._vdict = vdict
        for _ in pr.run(stream):
            yield {"ranks": pr._carry[2], "vdict": vdict}, pr._n_edges

    def boot_payload(self):
        pr = self._workload
        if pr._carry is None or self._vdict is None:
            return None
        return {"ranks": pr._carry[2], "vdict": self._vdict}, pr._n_edges
