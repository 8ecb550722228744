"""Window-local CC fold over a lazily canonicalized forest carry (PyTorch
port of ``gelly_streaming_tpu/summaries/forest.py``).

The carried summary is a **pointer forest** ``canon[vcap]`` (int32,
``canon[v] <= v``, acyclic by the strictly decreasing min-root invariant)
that is only *canonicalized* (chains collapsed to flat labels) at
emission or checkpoint time. Per window, every step is sized by the
window, not by the vertex space:

1. The HOST computes the window's touched set beside the stream (unique
   endpoints of the cached pre-padding columns) and renumbers the
   window's edges into local indices ``[0, T)`` (:class:`WindowPrep`).
2. The DEVICE chases the touched vertices' pointers to their current
   roots (:func:`chase_and_group`).
3. A min-label fixpoint over the **local** T-sized table joins the
   window's edges with "same current root" constraints
   (``labels._propagate``).
4. Masked scatters re-root the old roots, and the touched vertices for
   path compression, to the merged component's min root
   (:func:`commit_roots`).

The steps are PyTorch operations on the forest's device. What differs
from the XLA reference, and why:

- A ``lax.while_loop`` on ``jnp.any(...)`` is a Python loop that reads its
  condition to the host every turn (``labels.any_on_host`` counts them).
  The loops stay fixpoints: a fixed number of turns would give other
  answers on adversarial chains.
- ``.at[i].min(x)`` is ``scatter_reduce_(0, i, x, "amin")``, with int64
  index operands; the forest itself stays int32 (the checkpoint format).
- ``.at[i].set(x, mode="drop")`` with pad index ``vcap`` writes into a
  buffer of ``vcap + 1`` slots whose last slot is a sentinel, and the
  forest is the view of the first ``vcap``: padding lanes land in the
  sentinel instead of raising a device-side assert.
- A JAX scatter returns a new buffer. Here the commit copies the forest
  first (the one vcap-sized copy per window the reference also pays, once
  per group for a superbatch), so every past emission keeps the forest of
  its own window; an update in place would make every emission read the
  latest state.
- Where several lanes scatter to one index (``canon[r] = nr`` for the
  lanes of one root group), they carry equal values: lanes that share an
  old root are one group of the local fixpoint, so they get one new root.
  Nothing else relies on the order of a scatter's writes.

The host-side ``*_host`` fold, repair, merge and delta functions of the
reference come with ROADMAP Queue 1, slices 8 and 9.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..core.edgeblock import bucket_capacity, to_device
from ..obs import trace as _trace
from .labels import I32_MAX, _propagate, any_on_host, to_numpy


def chase_and_group(canon, tid, tmask, tcap: int, vcap: int):
    """Shared forest-step front half (CC and, later, the signed-cover
    carry).

    1. Chase touched pointers to their current roots. Read-only on canon;
       roots satisfy ``canon[r] == r`` and chains strictly decrease, so the
       loop ends. Padding lanes chase from 0, which is always self-rooted.
    2. "Same current root" constraints without a sort: each lane's local
       index is scatter-minned into a vcap-wide scratch keyed by root (pads
       into the sentinel slot), so every lane learns its group's
       representative lane; edge ``(i, rep_i)`` unifies the group and pads
       self-loop.

    Returns ``(r, v2, key_, iota)``: current roots per lane, the group-edge
    targets, the root-value keys (+inf on pads) and the lane iota."""
    with _trace.span("cc.chase_and_group"):
        device = canon.device
        r = torch.where(tmask, canon[tid.long()], 0)
        while True:
            nxt = canon[r.long()]
            if not any_on_host(nxt != r):
                break
            r = nxt
        iota = torch.arange(tcap, dtype=torch.int32, device=device)
        sid_r = torch.where(tmask, r, vcap).long()
        scratch = torch.full((vcap + 1,), I32_MAX, dtype=torch.int32, device=device)
        scratch.scatter_reduce_(0, sid_r, torch.where(tmask, iota, I32_MAX), "amin")
        rep = scratch[torch.where(tmask, r, 0).long()]
        v2 = torch.where(tmask, rep, iota)
        key_ = torch.where(tmask, r, I32_MAX)
        return r, v2, key_, iota


def _commit(canon, r, tid, tmask, nr, vcap: int) -> torch.Tensor:
    """A new forest: a copy of ``canon`` with the old roots and the touched
    lanes set to ``nr`` (pads dropped into the sentinel slot)."""
    with _trace.span("cc.commit"):
        buf = torch.empty(vcap + 1, dtype=canon.dtype, device=canon.device)
        buf[:vcap].copy_(canon)
        buf.scatter_(0, torch.where(tmask, r, vcap).long(), nr)
        buf.scatter_(0, torch.where(tmask, tid, vcap).long(), nr)
        return buf[:vcap]


def commit_roots(canon, local, key_, r, tid, tmask, tcap: int, vcap: int):
    """Shared forest-step back half: the merged component's new root is the
    min of its members' old roots (each old root is the min id of its old
    component); re-root the old roots and path-compress the touched lanes.
    Returns ``(canon, nr)``, with ``nr`` each lane's final root value."""
    with _trace.span("cc.commit_roots"):
        local_l = local.long()
        minr = torch.full((tcap,), I32_MAX, dtype=torch.int32, device=canon.device)
        minr.scatter_reduce_(0, local_l, key_, "amin")
        nr = minr[local_l]
        return _commit(canon, r, tid, tmask, nr, vcap), nr


def _make_local_fixpoint(tcap: int, device):
    """The T-sized local min-label fixpoint shared by the per-window step
    and the superbatch body: ``fixpoint(seed, lu, lv, targets)`` folds the
    window's edge columns PLUS the pointer edges ``(i, targets[i])`` (the
    pointer edges ride along as edges because ``_propagate`` hooks only
    edge endpoints; lu/lv pads are (0, 0) self-loops). The mesh form of
    the reference (per-shard folds merged by collectives) comes with
    ROADMAP Queue 1, slice 6."""
    iota = torch.arange(tcap, dtype=torch.int32, device=device)

    def fixpoint(seed, lu, lv, targets):
        u = torch.cat([lu, iota])
        w = torch.cat([lv, targets])
        return _propagate(seed, u, w, None)

    return fixpoint


def forest_step(canon, tid, tmask, lu, lv, tcap: int, vcap: int):
    """One window folded into the forest: chase, local fixpoint, commit.
    Returns the new forest; ``canon`` is not written."""
    r, v2, key_, iota = chase_and_group(canon, tid, tmask, tcap, vcap)
    local = _make_local_fixpoint(tcap, canon.device)(iota, lu, lv, v2)
    new, _nr = commit_roots(canon, local, key_, r, tid, tmask, tcap, vcap)
    return new


def forest_superbatch_step(canon, tid, tmask, lu, lv, tcap: int, vcap: int):
    """K forest window steps, GROUP-LOCAL (the reference's
    ``_forest_superbatch_fn``; its ``lax.scan`` is a loop over the K rows
    of ``lu``/``lv``):

    1. ONE root chase and same-root grouping over the group's union
       touched set (one vcap scratch per GROUP);
    2. per window, the window's edges fold into the carried T-sized label
       table, and ``nr_k[lane]`` (the min pre-group root of the lane's
       merged group) is recorded, ``[k, tcap]``;
    3. ONE commit re-roots the old roots and path-compresses the touched
       set with the last window's assignment.

    Window k sees every merge of the windows before it. Per-window forests
    are rebuilt lazily from ``(r, nr_k)`` by :class:`ForestReplay`; they
    resolve to the same labels as the per-window path's (the pointer SHAPE
    may differ). Returns ``(new_canon, r, nr_s)``; ``canon`` is not
    written and backs the group's lazy emissions."""
    with _trace.span("cc.forest_superbatch"):
        r, v2, key_, _iota = chase_and_group(canon, tid, tmask, tcap, vcap)
        fixpoint = _make_local_fixpoint(tcap, canon.device)
        # v2 maps each lane to the MIN lane of its pre-group root group: a
        # depth-1 min-rooted forest, already a valid label table
        lab = v2
        nrs = []
        for lu_k, lv_k in zip(lu, lv):
            lab = fixpoint(lab, lu_k, lv_k, lab)
            lab_l = lab.long()
            minr = torch.full((tcap,), I32_MAX, dtype=torch.int32,
                              device=canon.device)
            minr.scatter_reduce_(0, lab_l, key_, "amin")
            nrs.append(minr[lab_l])
        nr_s = torch.stack(nrs)
        return _commit(canon, r, tid, tmask, nr_s[-1], vcap), r, nr_s


def init_forest(vcap: int, device) -> torch.Tensor:
    """Fresh forest: every vertex self-rooted."""
    return torch.arange(vcap, dtype=torch.int32, device=device)


def grow_forest(canon: torch.Tensor, new_vcap: int) -> torch.Tensor:
    old = canon.shape[0]
    if new_vcap <= old:
        return canon
    return torch.cat([
        canon,
        torch.arange(old, new_vcap, dtype=torch.int32, device=canon.device),
    ])


class WindowPrep:
    """Reusable host scratch for the per-window touched set and local
    renumbering: native single pass when the library builds
    (``native.NativeWindowPrep``, epoch-stamped), numpy bitmap + LUT
    otherwise. Touched-id ORDER differs between the two (arrival vs
    sorted); the device steps index by position, so both are valid."""

    __slots__ = ("bm", "lut", "_native")

    def __init__(self):
        from .. import native

        self.bm = np.zeros(0, bool)
        self.lut = np.zeros(0, np.int32)
        try:
            self._native = native.NativeWindowPrep()
        except RuntimeError:  # no native library: the numpy scratch
            self._native = None

    def prep(self, src_h, dst_h, vcap: int):
        """-> (tids unique endpoints, lu, lv local indices)."""
        if self._native is not None:
            with _trace.span("cc.window_prep"):
                return self._native.run(src_h, dst_h, vcap)
        if len(self.bm) < vcap:
            self.bm = np.zeros(vcap, bool)
            self.lut = np.zeros(vcap, np.int32)
        bm = self.bm
        bm[src_h] = True
        bm[dst_h] = True
        tids = np.nonzero(bm[:vcap])[0].astype(np.int32)
        bm[tids] = False  # restore the scratch without an O(V) clear
        self.lut[tids] = np.arange(len(tids), dtype=np.int32)
        return tids, self.lut[src_h], self.lut[dst_h]


def pad_window(prep, src_h, dst_h, vcap: int, wmin: int = 8):
    """Host prep plus pow2 bucket padding for the window-local steps:
    returns ``(tids, tcap, wcap, tid, tmask, lu, lv)`` with the touched
    bucket masked and the edge columns zero-padded (pad rows are (0, 0)
    self-loops)."""
    n = len(src_h)
    tids, lu_r, lv_r = prep.prep(src_h, dst_h, vcap)
    t = len(tids)
    tcap = bucket_capacity(t, minimum=8)
    wcap = bucket_capacity(n, minimum=wmin)
    tid = np.zeros(tcap, np.int32)
    tid[:t] = tids
    tmask = np.zeros(tcap, bool)
    tmask[:t] = True
    lu = np.zeros(wcap, np.int32)
    lv = np.zeros(wcap, np.int32)
    lu[:n] = lu_r
    lv[:n] = lv_r
    return tids, tcap, wcap, tid, tmask, lu, lv


def forest_window(
    canon: torch.Tensor,
    src_h: np.ndarray,
    dst_h: np.ndarray,
    vcap: int,
    prep: WindowPrep,
) -> Tuple[torch.Tensor, np.ndarray]:
    """Fold one window (host compact-id columns) into the forest.

    ``prep`` is the stream's reusable :class:`WindowPrep` (required).
    Returns ``(new_canon, touched_ids)``; ``touched_ids`` are the window's
    unique endpoints, order unspecified, for the caller's first-seen log.
    """
    if prep is None:
        raise ValueError(
            "forest_window requires a per-stream WindowPrep (its scratch is "
            "reusable by design)"
        )
    if len(src_h) == 0:
        return canon, np.zeros(0, np.int32)
    tids, tcap, _wcap, tid, tmask, lu, lv = pad_window(prep, src_h, dst_h, vcap)
    dev = canon.device
    with _trace.span("cc.window_upload"):
        dev_cols = [to_device(a, dev) for a in (tid, tmask, lu, lv)]
    return forest_step(canon, *dev_cols, tcap, vcap), tids


class ForestReplay:
    """Lazy mid-group forest for superbatch emissions: a window-k emission
    that is read rebuilds that window's forest on the host from the
    pre-group base and window k's assignment (the same scatter pair the
    group's commit ran with the last window's). The download happens once
    per group, on first read."""

    __slots__ = ("_base", "_tid", "_tmask", "_r_dev", "_nr_dev",
                 "_base_np", "_r", "_nr")

    def __init__(self, base_canon, tid: np.ndarray, tmask: np.ndarray,
                 r_dev, nr_stack):
        self._base = base_canon  # device tensor, pre-group
        self._tid = tid          # host [tcap]
        self._tmask = tmask      # host [tcap]
        self._r_dev = r_dev      # device [tcap]
        self._nr_dev = nr_stack  # device [k, tcap]
        self._base_np = None
        self._r = None
        self._nr = None

    def canon_np(self, k: int) -> np.ndarray:
        """Host forest after window ``k`` of the group (a private copy)."""
        if self._r is None:
            self._r = to_numpy(self._r_dev)
            self._nr = to_numpy(self._nr_dev)
            self._base_np = to_numpy(self._base)
        canon = self._base_np.copy()
        m = self._tmask
        canon[self._r[m]] = self._nr[k][m]
        canon[self._tid[m]] = self._nr[k][m]
        return canon


def forest_superbatch(
    canon: torch.Tensor,
    windows,
    vcap: int,
    prep: WindowPrep,
) -> Tuple[torch.Tensor, list, ForestReplay]:
    """Fold K windows (a list of host ``(src_h, dst_h)`` column pairs) into
    the forest as ONE group-local fold.

    Two host prep passes through the same :class:`WindowPrep`: one per
    window for the per-window touched ids (the first-seen log advances in
    window order), and one over the group's concatenated columns for the
    group's touched set and the group-local renumbering. All K windows pad
    to the group's bucketed caps.

    Returns ``(new_canon, [touched_ids per window], replay)``."""
    if prep is None:
        raise ValueError(
            "forest_superbatch requires a per-stream WindowPrep (see "
            "forest_window)"
        )
    k = len(windows)
    _e = np.zeros(0, np.int32)
    win_tids = [prep.prep(s, d, vcap)[0] if len(s) else _e for s, d in windows]
    src_g = np.concatenate([s for s, _ in windows]) if k else _e
    dst_g = np.concatenate([d for _, d in windows]) if k else _e
    if len(src_g):
        tids_g, lu_all, lv_all = prep.prep(src_g, dst_g, vcap)
    else:
        tids_g, lu_all, lv_all = _e, _e, _e
    n_max = max((len(s) for s, _ in windows), default=0)
    tcap = bucket_capacity(len(tids_g), minimum=8)
    wcap = bucket_capacity(n_max, minimum=8)
    t = len(tids_g)
    tid = np.zeros(tcap, np.int32)
    tid[:t] = tids_g
    tmask = np.zeros(tcap, bool)
    tmask[:t] = True
    lu = np.zeros((k, wcap), np.int32)
    lv = np.zeros((k, wcap), np.int32)
    off = 0
    for i, (s, _) in enumerate(windows):
        n = len(s)
        lu[i, :n] = lu_all[off:off + n]
        lv[i, :n] = lv_all[off:off + n]
        off += n
    dev = canon.device
    with _trace.span("cc.window_upload"):
        dev_cols = [to_device(a, dev) for a in (tid, tmask, lu, lv)]
    new_canon, r_dev, nr_s = forest_superbatch_step(canon, *dev_cols, tcap, vcap)
    return new_canon, win_tids, ForestReplay(canon, tid, tmask, r_dev, nr_s)


class MirrorReplay:
    """Lazy mid-group forest for HOST-carry superbatches: the host
    union-find's per-window re-rooting deltas ``(touched, roots, changed,
    changed_roots)`` apply cumulatively, in window order, to the pre-group
    base (a host array). A backward read restarts from the base."""

    __slots__ = ("_base", "_deltas", "_canon", "_upto")

    def __init__(self, base_canon: np.ndarray, deltas):
        self._base = base_canon
        self._deltas = deltas
        self._canon = None
        self._upto = -1

    def canon_np(self, k: int) -> np.ndarray:
        """Host forest after window ``k`` of the group (a private copy)."""
        if self._canon is None or k < self._upto:
            self._canon = np.asarray(self._base).copy()
            self._upto = -1
        for j in range(self._upto + 1, k + 1):
            t, r, c, cr = self._deltas[j]
            self._canon[t] = r
            self._canon[c] = cr
        self._upto = k
        return self._canon.copy()


def mirror_update(
    canon: torch.Tensor, idx_np: np.ndarray, val_np: np.ndarray, vcap: int
) -> torch.Tensor:
    """Apply a host-computed re-rooting to the device forest mirror: a new
    forest, ``canon`` with ``canon[idx] = val``. The host union-find hands
    over exact columns (no pads), and an index that appears twice (a
    touched vertex that is also a demoted root) carries its one post-window
    root both times."""
    if len(idx_np) == 0:
        return canon
    if int(np.max(idx_np)) >= vcap:
        raise ValueError("mirror index outside the forest")
    with _trace.span("cc.mirror_update"):
        dev = canon.device
        new = canon.clone()
        new[to_device(np.asarray(idx_np, np.int64), dev)] = to_device(
            np.asarray(val_np, np.int32), dev
        )
        return new


def resolve_flat(canon: torch.Tensor) -> torch.Tensor:
    """Canonicalize the forest to flat labels ON THE DEVICE (checkpoint /
    mode-switch point): pointer jumping doubles chain shortcuts per turn,
    so the depth is log2 of the longest chain."""
    with _trace.span("cc.resolve_flat"):
        lab = canon
        while True:
            nxt = lab[lab.long()]
            if not any_on_host(nxt != lab):
                return lab
            lab = nxt


def resolve_flat_host(canon_np: np.ndarray) -> np.ndarray:
    """Host-side canonicalization (emission materialization path)."""
    lab = canon_np
    while True:
        nxt = lab[lab]
        if np.array_equal(nxt, lab):
            return lab
        lab = nxt


class TouchLog:
    """Append-only first-seen log of touched compact ids.

    The host computes the touched set per window anyway (it builds the
    local renumbering), so first-seen tracking costs one vectorized bitmap
    lookup. Emissions snapshot the log by COUNT only: the first ``count``
    entries of an append-only log never change."""

    __slots__ = ("seen", "ids", "count")

    def __init__(self, vcap: int = 0):
        self.seen = np.zeros(vcap, bool)
        self.ids = np.zeros(256, np.int32)
        self.count = 0

    def grow(self, vcap: int) -> None:
        if vcap > len(self.seen):
            self.seen = np.concatenate(
                [self.seen, np.zeros(vcap - len(self.seen), bool)]
            )

    def add(self, tids: np.ndarray) -> None:
        fresh = tids[~self.seen[tids]]
        if len(fresh) == 0:
            return
        self.seen[fresh] = True
        self._append(fresh)

    def _append(self, fresh: np.ndarray) -> None:
        need = self.count + len(fresh)
        if need > len(self.ids):
            cap = len(self.ids)
            while cap < need:
                cap *= 2
            grown = np.zeros(cap, np.int32)
            grown[: self.count] = self.ids[: self.count]
            self.ids = grown
        self.ids[self.count : need] = fresh
        self.count = need

    def add_grouped(self, ids: np.ndarray, counts: np.ndarray) -> list:
        """Batch K windows' touched sets in ONE vectorized pass. ``ids`` is
        a GROUP-unique concatenation in window first-seen order with
        per-window lengths ``counts`` (what ``CompactUnionFind.fold_group``
        emits). Returns the per-window log counts."""
        fresh_mask = ~self.seen[ids]
        fresh = ids[fresh_mask]
        self.seen[fresh] = True
        before = self.count
        self._append(fresh)
        ends = np.cumsum(np.asarray(counts, np.int64))
        fresh_cum = np.concatenate([[0], np.cumsum(fresh_mask.astype(np.int64))])
        return (before + fresh_cum[ends]).tolist()

    def touched_bool(self, vcap: int) -> np.ndarray:
        out = np.zeros(vcap, bool)
        out[: len(self.seen)] = self.seen[:vcap]
        return out

    @staticmethod
    def from_touched_bool(tb: np.ndarray) -> "TouchLog":
        log = TouchLog(len(tb))
        log.add(np.nonzero(tb)[0].astype(np.int32))
        return log
