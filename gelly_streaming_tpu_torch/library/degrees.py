"""Fully-dynamic degree distribution over ±edge events (PyTorch port).

The counterpart of ``gelly_streaming_tpu/library/degrees.py``
(``example/DegreeDistribution.java:42-131``, the reference's only
fully-dynamic workload). Each window of events is one batched step:

- Per-vertex ordered degree folds run as a segmented associative scan: the
  reference's clamped update ``deg' = max(0, deg + d)`` (degree <= 0
  removes the vertex, ``DegreeDistribution.java:93-100``) composes as
  ``g(x) = max(m, x + s)``; two updates fuse to ``(s1+s2, max(m2,
  m1+s2))``, so in-window event order per vertex is kept exactly while
  all vertices fold at once.
- The histogram is derived state: subtract the old-degree counts of
  touched vertices, add the new-degree counts (degree 0 never tracked).

Emission is per window and change-only; final histograms are identical
for any windowing. The degree and histogram tensors are new every window
(no in-place update), so a lazy :class:`HistogramBatch` read after later
windows still sees its own window.
"""

from __future__ import annotations

from typing import Iterable, Iterator, Optional, Tuple

import numpy as np
import torch

from ..core.device import DEFAULT_DEVICE, resolve_device
from ..core.edgeblock import bucket_capacity, to_device
from ..core.emission import LazyListBatch, host_array
from ..core.types import EventType
from ..core.window import CountWindow, WindowPolicy, Windower
from ..ops.segment import segmented_reduce_generic


def _combine(a, b):
    """Compose clamped degree updates g(x) = max(m, x+s): b AFTER a."""
    s1, m1 = a
    s2, m2 = b
    return s1 + s2, torch.maximum(m2, m1 + s2)


def _degree_step(deg, hist, verts, deltas, mask, vcap: int):
    s0 = deltas.to(torch.int32)
    m0 = torch.zeros_like(s0)
    (s, m), nonempty = segmented_reduce_generic((s0, m0), verts, mask, vcap, _combine)
    old = deg
    new = torch.where(nonempty, torch.maximum(m, old + s), old)
    hcap = hist.shape[0]
    dec = (nonempty & (old > 0)).to(torch.int32)
    inc = (nonempty & (new > 0)).to(torch.int32)
    hist = hist.index_add(0, torch.clamp(old, 0, hcap - 1).long(), -dec)
    hist = hist.index_add(0, torch.clamp(new, 0, hcap - 1).long(), inc)
    return new, hist


class DegreeDistribution:
    """Streaming (degree -> vertex count) histogram over ±edge events, on
    ``device`` (default ``"cuda"``; raises without a card unless given
    ``device="cpu"``).

    ``run(events)`` consumes ``(src, dst, change)`` records — ``change`` an
    :class:`EventType`, ``"+"``/``"-"``, or ±1 — and yields, per window,
    the change-only list of ``(degree, count)`` histogram entries.
    """

    def __init__(self, window: Optional[WindowPolicy] = None, vertex_dict=None,
                 *, device=DEFAULT_DEVICE):
        self.window = window or CountWindow(1 << 16)
        self.device = resolve_device(device)
        # the windower (and its vertex dict) persists across run() calls so
        # a resumed stream keeps the compact-id space of the degree vector
        self._windower = Windower(self.window, vertex_dict, device=self.device,
                                  val_dtype=np.int32)
        self._deg = None  # int32[vcap] on the device
        self._hist = None  # int32[hcap]; index = degree, [0] unused
        # host shadow for histogram-capacity growth (no device read in the
        # producer loop): no degree rises by more than a window's max
        # per-vertex event count (a host bincount of the cached columns),
        # so the running sum bounds the max degree from above; a
        # materialized emission tightens it to the downloaded truth
        self._max_deg_ub = 0
        # monotone sum of every shadow increment (never tightened): a lazy
        # batch records it, so a stale read knows the increments since
        self._inc_total = 0
        self._lineage = 0  # bumped on restore; stale-lineage batches skip
        self._events_total = 0
        self._emit_base = 0  # event watermark of the last materialized batch
        self._emit_prev = None  # host hist at the last materialized batch

    @classmethod
    def sliding(cls, size: int, slide: Optional[int] = None, **kwargs):
        """The event-time shape of this workload (a sliding window that
        retracts expired panes) is ported with event time."""
        raise NotImplementedError(
            "DegreeDistribution.sliding is ported in ROADMAP Queue 1, "
            "slice 8 (event time)"
        )

    def run(self, events: Iterable[Tuple]) -> Iterator["HistogramBatch"]:
        """Yields one lazy :class:`HistogramBatch` per window, list-like
        ``(degree, count)`` change-only entries read on first access.
        Reading the batches in stream order gives per-window change-only
        emission exactly; skipping windows folds their changes into the
        next batch read."""
        windower = self._windower
        rows = ((s, d, _delta(c), *rest) for s, d, c, *rest in events)
        for block in windower.blocks(rows):
            vcap = block.n_vertices
            s_h, d_h = block.to_host()[:2]
            n_events = len(s_h)
            if n_events:
                both = np.concatenate([s_h, d_h])
                inc = int(np.unique(both, return_counts=True)[1].max())
                self._max_deg_ub += inc
                self._inc_total += inc
            if self._deg is None:
                self._deg = torch.zeros(vcap, dtype=torch.int32, device=self.device)
            elif vcap > self._deg.shape[0]:
                self._deg = torch.cat([self._deg, torch.zeros(
                    vcap - self._deg.shape[0], dtype=torch.int32, device=self.device)])
            hcap = bucket_capacity(self._max_deg_ub + 1)
            if self._hist is None:
                self._hist = torch.zeros(hcap, dtype=torch.int32, device=self.device)
            elif hcap > self._hist.shape[0]:
                self._hist = torch.cat([self._hist, torch.zeros(
                    hcap - self._hist.shape[0], dtype=torch.int32, device=self.device)])
            # interleave [s0, d0, s1, d1, ...]: the reference emits (src,
            # ±1) then (dst, ±1) PER EVENT (DegreeDistribution.java:73-77),
            # and per-vertex clamp order matters when a degree crosses zero
            verts = torch.stack([block.src, block.dst], dim=1).reshape(-1)
            deltas = torch.stack([block.val, block.val], dim=1).reshape(-1)
            mask = torch.stack([block.mask, block.mask], dim=1).reshape(-1)
            self._deg, self._hist = _degree_step(
                self._deg, self._hist, verts, deltas, mask, vcap
            )
            self._events_total += n_events
            yield HistogramBatch(self, self._hist, self._events_total, self._inc_total)

    def state_dict(self) -> dict:
        """Checkpoint surface, with the vertex dictionary so the compact-id
        space survives a resume (the JAX package's layout)."""
        hist = None if self._hist is None else host_array(self._hist)
        max_deg = 0 if hist is None or not hist.any() else int(np.nonzero(hist)[0][-1])
        # a checkpoint is a sync point: snap the shadow exactly
        self._max_deg_ub = min(self._max_deg_ub, max_deg)
        return {
            "deg": None if self._deg is None else host_array(self._deg),
            "hist": hist,
            "max_deg": max_deg,
            "vdict_raw": self._windower.vertex_dict.raw_ids(),
        }

    def load_state_dict(self, d: dict) -> None:
        self._deg = None if d["deg"] is None else to_device(np.asarray(d["deg"], np.int32), self.device)
        self._hist = None if d["hist"] is None else to_device(np.asarray(d["hist"], np.int32), self.device)
        self._max_deg_ub = int(d["max_deg"])
        # fresh lineage: batches minted before the restore hold a counter
        # from the old lineage and must not pass the _compute guard
        self._inc_total = 0
        self._lineage += 1
        self._events_total = 0
        self._emit_base = 0
        self._emit_prev = None if d["hist"] is None else np.asarray(d["hist"]).copy()
        vd = self._windower.vertex_dict
        if len(vd) == 0:
            vd.encode(d["vdict_raw"])
        elif vd.raw_ids().tolist() != d["vdict_raw"].tolist():
            raise ValueError(
                "restoring into a DegreeDistribution whose vertex dictionary "
                "already diverged from the checkpoint"
            )

    def servable(self, vdict=None):
        raise NotImplementedError(
            "DegreeDistribution.servable is ported in ROADMAP Queue 1, "
            "slice 9 (serving)"
        )

    def histogram(self) -> dict:
        """Current (degree -> count) map, degree >= 1 entries only. A sync
        point: snaps the capacity shadow to the truth."""
        if self._hist is None:
            return {}
        h = host_array(self._hist)
        nz = np.nonzero(h)[0]
        self._max_deg_ub = min(self._max_deg_ub, int(nz[-1]) if len(nz) else 0)
        return {int(d): int(h[d]) for d in nz if d > 0}

    def degrees(self) -> np.ndarray:
        return np.zeros(0, np.int32) if self._deg is None else host_array(self._deg)


class HistogramBatch(LazyListBatch):
    """One window's change-only histogram emission, LAZY: the device
    histogram downloads on first read, changes are reported against the
    histogram at the previous materialized batch, and the workload's
    capacity shadow tightens from what the download reveals. An
    out-of-order read diffs against whatever was materialized last
    WITHOUT regressing the workload's watermarks."""

    __slots__ = ("_workload", "_hist", "_ev", "_inc", "_lin", "_items")

    def __init__(self, workload, hist, ev, inc):
        self._workload = workload
        self._hist = hist
        self._ev = ev
        self._inc = inc  # workload._inc_total at batch creation
        self._lin = workload._lineage
        self._items = None

    def _compute(self) -> list:
        w = self._workload
        h = host_array(self._hist)
        prev = w._emit_prev
        if prev is None or len(prev) < len(h):
            grown = np.zeros(len(h), h.dtype)
            if prev is not None:
                grown[: len(prev)] = prev
            prev = grown
        changed = np.nonzero(h != prev[: len(h)])[0]
        items = [(int(d), int(h[d])) for d in changed]
        if self._ev >= w._emit_base:
            # the newest materialization wins; an older batch read later
            # must not clobber the diff base or the watermark
            w._emit_prev = h
            w._emit_base = self._ev
        # capacity shadow: the true max NOW <= the true max AT THIS BATCH
        # plus the increments applied since, measured on the monotone
        # counter (sound under any read order); batches of a pre-restore
        # lineage have an incomparable counter and skip
        if self._lin == w._lineage and self._inc <= w._inc_total:
            nz = np.nonzero(h)[0]
            true_max = int(nz[-1]) if len(nz) else 0
            w._max_deg_ub = min(w._max_deg_ub, true_max + (w._inc_total - self._inc))
        return items


def _delta(change) -> int:
    if isinstance(change, EventType):
        return 1 if change is EventType.EDGE_ADDITION else -1
    if change in ("+", 1, True):
        return 1
    if change in ("-", -1, False):
        return -1
    raise ValueError(f"bad event change {change!r}")
