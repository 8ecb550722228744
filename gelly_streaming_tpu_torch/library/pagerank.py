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

- The early exit is a ``lax.while_loop`` over ``chunk``-long
  ``lax.scan`` bodies with a freeze flag. Eager torch has no device-side
  while, so each chunk runs ``chunk`` iterations (each ``torch.where(done,
  r, new)``), then ``done`` is read on the host once: at most
  ``max_chunks`` host reads a window, counted in :data:`HOST_READS`.
  ``iterations`` and ``l1_delta`` mean what they mean in the reference.
- The reference writes the window's padded block into the donated carry
  with ``dynamic_update_slice`` and masks everything past the edge count.
  Here the block goes into the carry in place at the host-known offset
  (``src[n0:n0 + cap].copy_(bsrc)``), the capacity rule asserted, and the
  iteration reads only the first ``n_edges`` entries (the masked rest
  contributes nothing in the reference either).
- ``index_add_`` of floats on a card sums in an order that changes from
  run to run: compare ranks within a tolerance, never bitwise.
- The K-window ``lax.scan`` of the group fold is a loop over the same
  one-window function (:func:`_window_step`), which both paths share.

``superbatch="auto"`` drives the group path under an ``AutoK`` controller
like CC's; this carry's per-window cost is the fixpoint, which grouping
cannot remove, so the controller's job here is to hold K = 1. The mesh
and ``servable()`` come with ROADMAP Queue 1, slices 6 and 9.
"""

from __future__ import annotations

from typing import Iterator, NamedTuple

import numpy as np
import torch

from ..core.edgeblock import bucket_capacity, to_device
from ..obs import trace as _trace
from ..summaries.groupfold import GroupFoldable

#: device -> host reads of the fixpoints (one per chunk); callers zero it
HOST_READS = 0


class PageRankEmission(NamedTuple):
    """Per-window emission. ``iterations``/``l1_delta`` are device scalars
    (read on first use), so successive windows queue on the device instead
    of waiting per emission; ``int()``/``float()`` them to read."""

    window: int
    num_vertices: int
    iterations: torch.Tensor
    l1_delta: torch.Tensor


def _fixpoint(src, dst, ranks, active, n, damping: float, tol: float,
              chunk: int, max_chunks: int):
    """Power iteration from ``ranks`` over the edges ``src -> dst`` until
    the L1 change is at most ``tol``, checked on the host once per
    ``chunk`` iterations, at most ``max_chunks`` chunks. Returns ``(ranks,
    delta, iters)``; iterations after convergence inside a chunk are
    computed and discarded, as in the reference."""
    global HOST_READS
    with _trace.span("pagerank.fixpoint"):
        nv = ranks.shape[0]
        dev = ranks.device
        src_l = src.long()
        dst_l = dst.long()
        ones = torch.zeros(nv, dtype=ranks.dtype, device=dev)
        ones.index_add_(0, src_l, torch.ones(src.shape[0], dtype=ranks.dtype, device=dev))
        deg_src = torch.clamp(ones, min=1.0)[src_l]
        dangling = active & (ones == 0.0)
        zero = torch.zeros((), dtype=ranks.dtype, device=dev)
        # damping as a float32 scalar, so 1 - d rounds as the reference's
        d = torch.full((), damping, dtype=ranks.dtype, device=dev)
        teleport = (1.0 - d) / n
        r = ranks
        delta = torch.full((), float("inf"), dtype=ranks.dtype, device=dev)
        iters = torch.zeros((), dtype=torch.int32, device=dev)
        done = torch.zeros((), dtype=torch.bool, device=dev)
        for _ in range(max_chunks):
            for _ in range(chunk):
                new = torch.zeros(nv, dtype=ranks.dtype, device=dev)
                new.index_add_(0, dst_l, r[src_l] / deg_src)
                dangling_mass = torch.where(dangling, r, zero).sum()
                new = teleport + d * (new + dangling_mass / n)
                new = torch.where(active, new, zero)
                dl = (new - r).abs().sum()
                r = torch.where(done, r, new)
                delta = torch.where(done, delta, dl)
                iters = iters + (~done).to(torch.int32)
                done = done | (dl <= tol)
            HOST_READS += 1
            if bool(done):
                break
        return r, delta, iters


def _window_step(carry, bsrc, bdst, n_edges0: int, n_new: int, n_seen: int,
                 damping: float, tol: float, chunk: int, max_chunks: int):
    """One window: append, warm start, fixpoint. ``carry`` is ``(src, dst,
    ranks)`` at their capacities; ``bsrc``/``bdst`` the window's padded
    block, of which the first ``n_new`` entries are real. The block is
    written in place at ``n_edges0`` (the host keeps the edge capacity at
    ``n_edges0`` + the block's capacity or more); the padding past the real
    entries is overwritten by the next window. Returns ``(carry, delta,
    iters)``; the rank vector is a new tensor, so a held carry is not
    changed."""
    with _trace.span("pagerank.window"):
        src, dst, ranks = carry
        cap = bsrc.shape[0]
        if n_edges0 + cap > src.shape[0]:
            raise AssertionError(
                f"edge capacity {src.shape[0]} cannot hold the block of {cap} at {n_edges0}")
        src[n_edges0:n_edges0 + cap].copy_(bsrc)
        dst[n_edges0:n_edges0 + cap].copy_(bdst)
        n_edges = n_edges0 + n_new
        nv = ranks.shape[0]
        # warm start: never-ranked active vertices enter at uniform mass,
        # then the seen ranks renormalize to sum 1 (padding slots stay 0:
        # the active mask keeps them out of the teleport and dangling terms)
        active = torch.arange(nv, device=ranks.device) < n_seen
        # a float32 scalar, so every term rounds as the reference's does
        n = torch.full((), float(max(n_seen, 1)), dtype=ranks.dtype, device=ranks.device)
        ranks = torch.where(active & (ranks == 0.0), 1.0 / n, ranks)
        ranks = ranks / torch.clamp(ranks.sum(), min=1e-30)
        ranks, delta, iters = _fixpoint(
            src[:n_edges], dst[:n_edges], ranks, active, n, damping, tol, chunk, max_chunks,
        )
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
        if mesh is not None:
            raise NotImplementedError(
                "the sharded PageRank fixpoint is ported in ROADMAP Queue 1, "
                "slice 6 (multiple devices)")
        self._set_superbatch(superbatch)
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
        ecap = bucket_capacity(self._n_edges + block_cap, minimum=8)
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
        return self._step(block.src, block.dst, n_new, self._n_seen, block.n_vertices)

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
        wcap = bucket_capacity(max(lens), minimum=8)
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

    def servable(self, vdict=None):
        raise NotImplementedError(
            "the serving adapter is ported in ROADMAP Queue 1, slice 9")

    def ranks(self) -> dict:
        """Current (raw vertex id -> rank), seen vertices only."""
        if self._carry is None:
            return {}
        n = len(self._vdict)
        r = self._carry[2][:n].cpu().numpy()
        raw = self._vdict.decode(np.arange(n))
        return {int(v): float(x) for v, x in zip(raw, r)}
