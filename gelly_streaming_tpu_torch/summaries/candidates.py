"""Bipartiteness state: connected components of the signed double cover
(PyTorch port of ``gelly_streaming_tpu/summaries/candidates.py``).

The reference tracks 2-colored candidate components in nested maps with
sign-flipping merges and a failure latch (``summaries/Candidates.java:27-197``).
Here every vertex v becomes two cover nodes (v,+) and (v,-), and every edge
(u,v) the cover edges (u,+)~(v,-) and (u,-)~(v,+): the graph is bipartite
iff no vertex's two cover nodes share a component, so the CC steps
(``summaries/labels.py``, ``summaries/forest.py``) do all the work.

Layout: cover node (v,+) is index v, (v,-) is v + vcap, in a table of 2*vcap.

What differs from the XLA reference, and why (the CC rules of
``summaries/forest.py`` apply as they are):

- Pad rows need a real mask: a pad ``(0, 0)`` is a harmless self-loop in
  base space but maps to ``(0,+)~(0,-)`` in the cover, a fabricated odd
  cycle. Every cover step masks its pad rows.
- The odd-cycle latch is a device bool (``failed | conflict``); the window
  loop reads nothing beyond the fixpoints' own turns.
- Every tensor an emission holds is its own: the forest commit copies the
  cover forest, and the latch is a new tensor each window.

:class:`Candidates` is the host emission object, the reference's output
format byte for byte: ``(true,{1={1=(1,true), ...}})`` / ``(false,{})``.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..core.edgeblock import bucket_capacity, to_device
from ..obs import trace as _trace
from .forest import ForestReplay, _commit, chase_and_group, commit_roots, pad_window
from .labels import I32_MAX, _propagate, init_labels, to_numpy


def init_cover(vcap: int, device) -> Dict[str, torch.Tensor]:
    """Fresh signed-double-cover label state (2*vcap cover nodes)."""
    return init_labels(2 * vcap, device)


def cover_fold(state, src, dst, mask, vcap: int) -> Dict[str, torch.Tensor]:
    """Fold a window's edges into the dense cover labels: edge (u,v) adds
    (u,+)~(v,-) and (u,-)~(v,+) (``Candidates.add``/``merge``,
    ``Candidates.java:52-139``). New tensors; ``state`` is not written."""
    u = torch.cat([src, src + vcap])
    w = torch.cat([dst + vcap, dst])
    m = torch.cat([mask, mask])
    labels = _propagate(state["labels"], u, w, m)
    n = state["touched"].shape[0]
    touched = torch.cat([state["touched"], state["touched"].new_zeros(1)])
    sentinel = torch.full_like(src, n)
    touched[torch.where(mask, src, sentinel).long()] = True
    touched[torch.where(mask, dst, sentinel).long()] = True
    return {"labels": labels, "touched": touched[:n]}


def _shift_cover_labels(lab: np.ndarray, old_vcap: int, new_vcap: int) -> np.ndarray:
    """The cover re-index rule, shared by EVERY carry (their checkpoints
    stay cross-restorable): cover node (v,-) moves from v+old to v+new, and
    label or pointer VALUES into the negative half shift by the same."""
    new_lab = np.arange(2 * new_vcap, dtype=np.int32)
    shifted = np.where(lab >= old_vcap, lab - old_vcap + new_vcap, lab)
    new_lab[:old_vcap] = shifted[:old_vcap]
    new_lab[new_vcap: new_vcap + old_vcap] = shifted[old_vcap:]
    return new_lab


def cover_grow(state, old_vcap: int, new_vcap: int) -> Dict[str, torch.Tensor]:
    """Re-index the dense cover when the vertex capacity grows (one host
    rebuild per growth, see :func:`_shift_cover_labels`)."""
    if new_vcap <= old_vcap:
        return state
    dev = state["labels"].device
    tch = to_numpy(state["touched"])
    new_lab = _shift_cover_labels(to_numpy(state["labels"]), old_vcap, new_vcap)
    new_tch = np.zeros(2 * new_vcap, dtype=bool)
    new_tch[:old_vcap] = tch[:old_vcap]
    new_tch[new_vcap: new_vcap + old_vcap] = tch[old_vcap:]
    return {"labels": to_device(new_lab, dev), "touched": to_device(new_tch, dev)}


def cover_grow_forest(canon: torch.Tensor, old_vcap: int, new_vcap: int) -> torch.Tensor:
    """Re-index the cover forest on growth: the same rule as
    :func:`cover_grow` (a pointer forest re-indexes like flat labels)."""
    if new_vcap <= old_vcap:
        return canon
    return to_device(_shift_cover_labels(to_numpy(canon), old_vcap, new_vcap), canon.device)


def _cover_lanes(tid, tmask, lu, lv, emask, tcap: int, vcap: int, dim: int = 0):
    """The cover touched bucket and cover edges from the base prep: lane i
    is (t_i,+), lane i + tcap is (t_i,-), so a lane's sibling is a fixed
    offset away; edges (u,+)~(v,-) and (u,-)~(v,+) with the pad rows'
    real mask."""
    tid2 = torch.cat([tid, tid + vcap])
    tmask2 = torch.cat([tmask, tmask])
    lu2 = torch.cat([lu, lu + tcap], dim=dim)
    lv2 = torch.cat([lv + tcap, lv], dim=dim)
    emask2 = torch.cat([emask, emask], dim=dim)
    return tid2, tmask2, lu2, lv2, emask2


def cover_step(canon, failed, tid, tmask, lu, lv, emask, tcap: int, vcap: int):
    """Window-local signed-cover step: the forest CC step over the 2*vcap
    cover ids, plus the odd-cycle latch. A new odd cycle joins some
    vertex's two cover nodes this window; that cover component is then
    sign-symmetric, so every touched member's sibling is in it too, and
    ``new_root[i] == new_root[i + tcap]`` over the touched lanes alone
    misses nothing. Returns ``(canon, failed)``, both new tensors."""
    with _trace.span("bip.cover_step"):
        tcap2, vcap2 = 2 * tcap, 2 * vcap
        tid2, tmask2, lu2, lv2, emask2 = _cover_lanes(tid, tmask, lu, lv, emask, tcap, vcap)
        r, v2, key_, iota = chase_and_group(canon, tid2, tmask2, tcap2, vcap2)
        u = torch.cat([lu2, iota])
        w = torch.cat([lv2, v2])
        m = torch.cat([emask2, torch.ones(tcap2, dtype=torch.bool, device=canon.device)])
        local = _propagate(iota, u, w, m)
        canon, nr = commit_roots(canon, local, key_, r, tid2, tmask2, tcap2, vcap2)
        conflict = (tmask & (nr[:tcap] == nr[tcap:])).any()
        return canon, failed | conflict


def cover_forest_window(canon, failed, src_h, dst_h, vcap: int, prep):
    """Fold one window (host base columns) into the cover forest. Returns
    ``(canon, failed, base_touched_ids)``."""
    n = len(src_h)
    if n == 0:
        return canon, failed, np.zeros(0, np.int32)
    tids, tcap, wcap, tid, tmask, lu, lv = pad_window(prep, src_h, dst_h, vcap)
    emask = np.zeros(wcap, bool)
    emask[:n] = True
    dev = canon.device
    with _trace.span("cc.window_upload"):
        cols = [to_device(a, dev) for a in (tid, tmask, lu, lv, emask)]
    canon, failed = cover_step(canon, failed, *cols, tcap, vcap)
    return canon, failed, tids


def cover_superbatch_step(canon, failed, tid, tmask, lu, lv, emask, tcap: int, vcap: int):
    """K cover window steps, GROUP-LOCAL (the reference's
    ``_cover_superbatch_fn``; its ``lax.scan`` is a loop over the K rows of
    ``lu``/``lv``/``emask``):

    1. ONE root chase and same-root grouping over the group's touched set,
       both cover halves;
    2. per window, its cover edges fold into the carried 2*tcap label
       table; ``nr_k`` (each lane's min pre-group root) and the latch after
       the window are recorded;
    3. ONE commit with the last window's assignment.

    Returns ``(canon, failed, r, nr_s [k, 2*tcap], fail_s [k])``; ``canon``
    is not written and backs the group's lazy emissions."""
    with _trace.span("bip.cover_superbatch"):
        tcap2, vcap2 = 2 * tcap, 2 * vcap
        tid2, tmask2, lu2, lv2, emask2 = _cover_lanes(
            tid, tmask, lu, lv, emask, tcap, vcap, dim=1)
        r, v2, key_, iota = chase_and_group(canon, tid2, tmask2, tcap2, vcap2)
        ones = torch.ones(tcap2, dtype=torch.bool, device=canon.device)
        # v2 is a depth-1 min-rooted forest of the pre-group same-root
        # constraints: already a valid label table
        lab = v2
        nrs, fails = [], []
        for lu_k, lv_k, em_k in zip(lu2, lv2, emask2):
            u = torch.cat([lu_k, iota])
            w = torch.cat([lv_k, lab])
            m = torch.cat([em_k, ones])
            lab = _propagate(lab, u, w, m)
            lab_l = lab.long()
            minr = torch.full((tcap2,), I32_MAX, dtype=torch.int32, device=canon.device)
            minr.scatter_reduce_(0, lab_l, key_, "amin")
            nr = minr[lab_l]
            failed = failed | (tmask & (nr[:tcap] == nr[tcap:])).any()
            nrs.append(nr)
            fails.append(failed)
        nr_s = torch.stack(nrs)
        new = _commit(canon, r, tid2, tmask2, nr_s[-1], vcap2)
        return new, failed, r, nr_s, torch.stack(fails)


def cover_forest_superbatch(canon, failed, windows, vcap: int, prep):
    """Fold K windows (host base ``(src_h, dst_h)`` pairs) into the cover
    forest as ONE group-local fold, with the host prep of
    ``forest.forest_superbatch``: one prep per window (the first-seen log
    advances in window order) and one over the group's columns (the group
    touched set and its local renumbering).

    Returns ``(canon, failed, [touched ids per window], replay, fail_s)``:
    ``replay`` a cover-space :class:`~gelly_streaming_tpu_torch.summaries.forest.ForestReplay`,
    ``fail_s`` the device ``[k]`` per-window latches."""
    if prep is None:
        raise ValueError(
            "cover_forest_superbatch requires a per-stream WindowPrep (see forest_window)")
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
    emask = np.zeros((k, wcap), bool)
    off = 0
    for i, (s, _) in enumerate(windows):
        n = len(s)
        lu[i, :n] = lu_all[off:off + n]
        lv[i, :n] = lv_all[off:off + n]
        emask[i, :n] = True
        off += n
    dev = canon.device
    with _trace.span("cc.window_upload"):
        cols = [to_device(a, dev) for a in (tid, tmask, lu, lv, emask)]
    new_canon, new_failed, r_dev, nr_s, fail_s = cover_superbatch_step(
        canon, failed, *cols, tcap, vcap)
    # the replay works in the 2*vcap cover id space: both halves of the
    # touched bucket, the chased roots, the per-window assignments
    replay = ForestReplay(canon, np.concatenate([tid, tid + vcap]),
                          np.concatenate([tmask, tmask]), r_dev, nr_s)
    return new_canon, new_failed, win_tids, replay, fail_s


class Candidates:
    """Host emission object with the reference's string format.

    ``success`` False means an odd cycle was found; the map is then empty
    (``Candidates.fail``, ``Candidates.java:194-196``). On success the map
    is component -> {vertex: sign}, the component keyed by its smallest
    raw vertex id, that root colored ``true``, and every other vertex's
    sign = (on the same cover side as the root)."""

    def __init__(self, success=None, components=None, *, _lazy=None):
        self._success = success
        self._components = components
        # (canon | (replay, window_k, fail_stack) | dense state, failed,
        # touch_log, count, vcap, vdict): a carry emission, read and
        # canonicalized on the host on first access, so unread windows cost
        # nothing
        self._lazy = _lazy

    def _cover_state(self):
        """Resolve a carry emission on the host: the verdict, and on success
        the cover arrays of :meth:`_cover_arrays`."""
        from .forest import resolve_flat_host

        canon, failed, log, count, vcap, vdict = self._lazy
        if isinstance(canon, dict):
            # a dense cover state (flat labels + touched)
            return self._cover_arrays(canon, vcap, vdict)
        if isinstance(canon, tuple):
            # a superbatch member: its cover canon rebuilds from the
            # group's delta stack, its verdict from the stacked latch
            replay, kk, fail_s = canon
            if isinstance(fail_s, torch.Tensor):
                fail_s = to_numpy(fail_s)
            if bool(fail_s[kk]):
                return None
            lab = resolve_flat_host(replay.canon_np(kk))
        else:
            if bool(failed if isinstance(failed, bool) else to_numpy(failed)):
                return None
            lab = resolve_flat_host(to_numpy(canon))
        # the log holds BASE ids only (< vcap at snapshot time); the
        # negative half is base + vcap, so a dict that grew past this
        # vcap cannot push ids into the negative half
        touched = np.zeros(2 * vcap, bool)
        touched[np.asarray(log.ids[:count])] = True
        return self._cover_arrays({"labels": lab, "touched": touched}, vcap, vdict)

    def _mat(self) -> None:
        if self._success is None:
            self._success, self._components = self._from_arrays(self._cover_state())

    @property
    def success(self) -> bool:
        self._mat()
        return self._success

    @property
    def components(self) -> Dict[int, Dict[int, bool]]:
        self._mat()
        return self._components

    @staticmethod
    def from_forest(canon, failed, log, count, vcap, vdict) -> "Candidates":
        return Candidates(_lazy=(canon, failed, log, count, vcap, vdict))

    @staticmethod
    def from_dense(state, vcap, vdict) -> "Candidates":
        """Lazy view over a dense cover state (flat labels + touched, the
        engine's per-window tensors): read on first access, as
        :meth:`from_cover` reads it at once."""
        return Candidates(_lazy=(state, None, None, None, vcap, vdict))

    @staticmethod
    def from_forest_replay(replay, k, fail_stack, log, count, vcap, vdict) -> "Candidates":
        """Lazy mid-group emission of the superbatched cover carry: window
        ``k``'s canon rebuilds from the group ``replay`` on first read, its
        verdict from ``fail_stack[k]``."""
        return Candidates(_lazy=((replay, k, fail_stack), None, log, count, vcap, vdict))

    def __bool__(self) -> bool:
        """Truthiness is the verdict: ``(false,{})`` must not read as true."""
        return self.success

    @staticmethod
    def _cover_arrays(state, vcap: int, vdict):
        """``(seen, base, sign, raws)`` of a flat cover state: the seen
        compact ids, each one's base component (the smaller label of its
        two cover nodes) and whether it sits on its component root's side;
        None when some vertex's two cover nodes share a component."""
        labels = state["labels"]
        touched = state["touched"]
        labels = to_numpy(labels) if isinstance(labels, torch.Tensor) else np.asarray(labels)
        touched = to_numpy(touched) if isinstance(touched, torch.Tensor) else np.asarray(touched)
        n = len(vdict)
        seen = np.nonzero(touched[:n])[0]
        pos = labels[seen]
        neg = labels[seen + vcap]
        if np.any(pos == neg):
            return None
        # each base component owns exactly 2 cover components; the smaller
        # label of the pair names it. Its root is its least RAW id.
        base = np.minimum(pos, neg)
        raws = np.asarray(vdict.decode(seen), np.int64)
        order = np.lexsort((raws, base))
        _, starts, inverse = np.unique(base[order], return_index=True, return_inverse=True)
        root_side = labels[seen[order][starts]][inverse]
        sign = np.empty(len(seen), bool)
        sign[order] = labels[seen[order]] == root_side
        return seen, base, sign, raws

    def coloring(self):
        """``(ids, component, sign)`` arrays over the seen compact ids (the
        2-coloring, without building the nested map), or None when the
        graph is not bipartite. For the lazy emissions (``from_forest``,
        ``from_forest_replay``, ``from_dense``)."""
        arrays = self._cover_state()
        return None if arrays is None else arrays[:3]

    @staticmethod
    def _from_arrays(arrays):
        """``(success, components)`` from :meth:`_cover_arrays`' output."""
        if arrays is None:
            return False, {}
        seen, base, sign, raws = arrays
        if not len(seen):
            return True, {}
        order = np.lexsort((raws, base))
        b_s, r_s, g_s = base[order], raws[order].tolist(), sign[order].tolist()
        cuts = (np.nonzero(b_s[1:] != b_s[:-1])[0] + 1).tolist()
        comps: Dict[int, Dict[int, bool]] = {}
        for lo, hi in zip([0, *cuts], [*cuts, len(b_s)]):
            comps[int(r_s[lo])] = dict(zip(r_s[lo:hi], g_s[lo:hi]))
        return True, comps

    @staticmethod
    def from_cover(state, vcap: int, vdict) -> "Candidates":
        return Candidates(*Candidates._from_arrays(Candidates._cover_arrays(state, vcap, vdict)))

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, Candidates)
            and self.success == other.success
            and self.components == other.components
        )

    def __str__(self) -> str:
        if not self.success:
            return "(false,{})"
        outer = ", ".join(
            "%d={%s}" % (
                comp,
                ", ".join("%d=(%d,%s)" % (v, v, "true" if s else "false")
                          for v, s in sorted(vs.items())),
            )
            for comp, vs in sorted(self.components.items())
        )
        return "(true,{%s})" % outer

    __repr__ = __str__
