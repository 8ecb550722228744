"""Streaming bipartiteness check over the signed double cover (PyTorch port
of ``gelly_streaming_tpu/library/bipartiteness.py``).

Replaces ``library/BipartitenessCheck.java:39-133`` and its ``Candidates``
merges with CC over the signed double cover (``summaries/candidates.py``):
the graph is bipartite iff no vertex's (+) and (-) cover nodes share a
component. Three carries (``carry=``, default ``"auto"``, the CC rule:
``"forest"`` on a CUDA device, ``"host"`` on the CPU when the native
library builds):

- **Cover forest**: a pointer forest over the 2*vcap cover ids updated by
  window-sized device steps, the odd-cycle latch computed in the step from
  the touched lanes' sibling roots and kept on the device (no read in the
  window loop beyond the fixpoints' own turns).
- **Host cover union-find**: every window's edges expand to cover edges
  and fold through the native ``CompactUnionFind`` over 2*vcap cover ids,
  with a device pointer-forest mirror and the latch checked on the host
  from each window's touched delta.
- **Dense cover labels**: the full-table fixpoint under the engine, for
  streams whose blocks carry no host columns and on ``carry="dense"``.

``superbatch=K`` folds K windows as one group on every carry; the
checkpoint format (flat cover labels + touched) is one across carries and
across the two packages. Emission reproduces the reference's
``(true,{...})`` / ``(false,{})`` format.

``superbatch="auto"`` re-tiles the groups under an ``AutoK`` controller;
``sliding()`` is the event-time shape (``eventtime/``) and ``servable()``
the serving adapter; the mesh comes with ROADMAP Queue 1, slice 6.
"""

from __future__ import annotations

from typing import Any, Iterator, Optional

import numpy as np
import torch

from ..aggregate.summary import SummaryBulkAggregation
from ..core.edgeblock import to_device
from ..obs import trace as _trace
from ..summaries.candidates import (
    Candidates,
    _shift_cover_labels,
    cover_fold,
    cover_forest_superbatch,
    cover_forest_window,
    cover_grow,
    cover_grow_forest,
    init_cover,
)
from ..summaries.forest import (
    MirrorReplay,
    TouchLog,
    WindowPrep,
    mirror_update,
    resolve_flat,
    resolve_flat_host,
)
from ..summaries.groupfold import drive_group_folded
from ..summaries.labels import label_combine, to_numpy
from .connected_components import _auto_carry


def _cover_cols(src: np.ndarray, dst: np.ndarray, vcap: int):
    """One window's base edge columns as signed-cover edge columns
    ((u,+)~(v,-) and (u,-)~(v,+)) for the host union-find."""
    s = np.asarray(src, np.int32)
    d = np.asarray(dst, np.int32)
    return np.concatenate([s, s + vcap]), np.concatenate([d + vcap, d])


def _delta_conflict(t: np.ndarray, r: np.ndarray, vcap: int) -> bool:
    """Odd-cycle check over ONE window's union-find touched delta ``(ids,
    roots)``: does any base endpoint's sibling share its root? Complete
    for NEW conflicts: both cover nodes of every window endpoint are
    touched, and a conflict's merged component is sign-symmetric."""
    base = t[t < vcap]
    if not len(base):
        return False
    order = np.argsort(t)
    ts, rs = t[order], r[order]
    rb = rs[np.searchsorted(ts, base)]
    rn = rs[np.searchsorted(ts, base + vcap)]
    return bool(np.any(rb == rn))


class BipartitenessCheck(SummaryBulkAggregation):
    """Single-pass bipartiteness (``library/BipartitenessCheck.java``)."""

    def __init__(self, *args, carry: str = "auto", **kwargs):
        super().__init__(*args, **kwargs)
        if carry not in ("auto", "forest", "host", "dense"):
            raise ValueError(f"carry must be auto/forest/host/dense, got {carry!r}")
        self.carry = carry
        self._bp_mode = None  # None | "forest" | "host" | "dense"
        self._canon = None    # cover forest int32[2*vcap] (device)
        self._failed = None   # odd-cycle latch: device bool (forest), host bool (host)
        self._log = None      # host TouchLog over BASE ids
        self._prep = None     # WindowPrep scratch (forest carry)
        self._uf = None       # native CompactUnionFind over cover ids

    @classmethod
    def sliding(cls, size: int, slide=None, **kwargs):
        """The EVENT-TIME shape of this workload: bipartiteness over a
        sliding window, the odd-cycle latch RE-RESOLVED when panes expire,
        a :class:`~gelly_streaming_tpu_torch.eventtime.SlidingGraphAggregator`
        restricted to the cover summary. ``size``/``slide`` are event-time
        units; other keywords pass through."""
        from ..eventtime import SlidingGraphAggregator

        return SlidingGraphAggregator(size, slide, summaries=("bipartite",), **kwargs)

    # ---- serving surface (serving/server.py Servable contract) ------- #
    def servable(self, vdict=None) -> "BipartitenessServable":
        """Adapter publishing the live cover table per window for
        :class:`~gelly_streaming_tpu_torch.serving.query.BipartiteQuery`
        (typed yes/no + odd-cycle conflict witness). ``vdict`` seeds the
        boot payload when restoring from a checkpoint before any stream is
        attached."""
        return BipartitenessServable(self, vdict)

    # ---- dense-engine hooks ---- #
    def initial_state(self, vcap: int):
        return init_cover(max(1, vcap), self._device)

    def grow_state(self, state, old_vcap: int, new_vcap: int):
        return cover_grow(state, old_vcap, new_vcap)

    def update(self, state, src, dst, val, mask):
        return cover_fold(state, src, dst, mask, state["labels"].shape[0] // 2)

    def combine(self, a, b):
        return label_combine(a, b)

    def infer_vcap(self, state) -> int:
        # the cover table has 2*vcap rows
        return int(state["labels"].shape[0]) // 2

    def transform(self, state, vdict) -> Candidates:
        # lazy: the window's own tensors, read on first access
        return Candidates.from_dense(state, self.infer_vcap(state), vdict)

    # ---- the windowed carries' run loop ---- #
    def _adopt_device(self, stream) -> None:
        super()._adopt_device(stream)
        if self._canon is not None:
            self._canon = self._canon.to(self._device)
        if isinstance(self._failed, torch.Tensor):
            self._failed = self._failed.to(self._device)

    def _pick_mode(self) -> str:
        return self.carry if self.carry != "auto" else _auto_carry(self._device)

    def run(self, stream) -> Iterator[Candidates]:
        self._adopt_device(stream)
        vdict = stream.vertex_dict
        if (self.superbatch > 1 or self.superbatch_auto) and not self.transient_state:
            # transient_state keeps the per-window loop: its carry reset
            # is window-granular
            self._gf_vdict = vdict
            yield from drive_group_folded(
                self, stream, self.superbatch,
                controller=self._attach_control(self.superbatch),
            )
            return
        for block in stream.blocks():
            cache = getattr(block, "_host_cache", None)
            if cache is None or self.carry == "dense" or self._bp_mode == "dense":
                if self._bp_mode in ("forest", "host"):
                    self._to_dense()
                self._bp_mode = "dense"
                self._device_block(block)
                self._sync_ref = self._summary
                yield self.transform(self._summary, vdict)
            else:
                if self._bp_mode is None:
                    self._bp_mode = self._pick_mode()
                self._ensure_forest(block.n_vertices)
                if self._bp_mode == "host":
                    yield self._host_window(cache[0], cache[1], vdict)
                else:
                    self._canon, self._failed, tids = cover_forest_window(
                        self._canon, self._failed, cache[0], cache[1], self._vcap, self._prep,
                    )
                    # the log tracks BASE ids only; the negative half is
                    # base + vcap at emission and checkpoint time, so growth
                    # never rebuilds the log
                    self._log.add(tids)
                    self._summary = {"labels": self._canon}
                    self._sync_ref = (self._canon, self._failed)
                    yield Candidates.from_forest(
                        self._canon, self._failed, self._log, self._log.count,
                        self._vcap, vdict,
                    )
            if self.transient_state:
                self._reset_transient()

    def _host_window(self, src_h, dst_h, vdict) -> Candidates:
        """One window through the host cover union-find: fold both cover
        edges of every base edge, mirror the delta to the device forest,
        advance the latch from the window's touched delta."""
        vcap = self._vcap
        s2, d2 = _cover_cols(src_h, dst_h, vcap)
        t, r, c, cr = self._uf.fold(s2, d2, 2 * vcap)
        self._canon = mirror_update(
            self._canon, np.concatenate([t, c]), np.concatenate([r, cr]), 2 * vcap)
        if not self._failed:
            self._failed = _delta_conflict(t, r, vcap)
        self._log.add(t[t < vcap])
        self._summary = {"labels": self._canon}
        self._sync_ref = self._canon
        return Candidates.from_forest(
            self._canon, self._failed, self._log, self._log.count, vcap, vdict)

    # ---- GroupFoldable declaration (summaries/groupfold.py) ---------- #
    def fold_group(self, group) -> Iterator[Candidates]:
        """The cover carries' group fold: ONE native union-find call with
        one mirror commit (host), ONE group-local cover fold (forest), or
        the engine's loop over the stacked block (dense). Groups without
        host columns downgrade to dense, as the per-window loop does."""
        vdict = self._gf_vdict
        windowed = (
            group.cols is not None and self.carry != "dense" and self._bp_mode != "dense"
        )
        if not windowed:
            if self._bp_mode in ("forest", "host"):
                self._to_dense()
            self._bp_mode = "dense"
            for state in self._fold_group_states(group):
                yield self.transform(state, vdict)
            return
        if self._bp_mode is None:
            self._bp_mode = self._pick_mode()
        if self._bp_mode == "host":
            yield from self._host_group(group, vdict)
            return
        with _trace.span(
            "bip.cover_group",
            {"k": len(group), "n_vertices": int(group.n_vertices)} if _trace.on() else None,
        ):
            self._ensure_forest(group.n_vertices)
            windows = [(c[0], c[1]) for c in group.cols]
            (self._canon, self._failed, tids_list, replay, fail_s) = cover_forest_superbatch(
                self._canon, self._failed, windows, self._vcap, self._prep,
            )
            counts = []
            for tids in tids_list:
                self._log.add(tids)
                counts.append(self._log.count)
            self._summary = {"labels": self._canon}
            self._sync_ref = (self._canon, self._failed)
        for i, count in enumerate(counts):
            yield Candidates.from_forest_replay(
                replay, i, fail_s, self._log, count, self._vcap, vdict)

    def _host_group(self, group, vdict) -> Iterator[Candidates]:
        """Host-carry superbatch: the K windows' cover edges in ONE native
        ``cuf_fold_group`` call, one commit of the group's delta into a new
        mirror, the per-window latches resolved from the deltas only when
        the verdict flips inside the group."""
        with _trace.span(
            "bip.cover_host_group",
            {"k": len(group), "n_vertices": int(group.n_vertices)} if _trace.on() else None,
        ):
            self._ensure_forest(group.n_vertices)
            vcap = self._vcap
            cover_cols = [_cover_cols(c[0], c[1], vcap) for c in group.cols]
            wins, gids, groots, gtcnt = self._uf.fold_group(cover_cols, 2 * vcap)
            ngt = int(np.sum(gtcnt))
            # the base-only log advance: the group-unique touched prefix
            # filtered to the base half, window order kept
            gt = gids[:ngt]
            base_mask = gt < vcap
            ends = np.cumsum(np.asarray(gtcnt, np.int64))
            starts = np.concatenate([[0], ends[:-1]])
            counts_base = [int(base_mask[a:b].sum()) for a, b in zip(starts, ends)]
            counts = self._log.add_grouped(gt[base_mask], np.asarray(counts_base, np.int64))
            base_np = to_numpy(self._canon)
            new_np = base_np.copy()
            new_np[gids] = groots
            self._canon = to_device(new_np, self._device)
            replay = MirrorReplay(base_np, wins)
            fails = self._host_group_fails(wins, new_np, gt, vcap)
            self._summary = {"labels": self._canon}
            self._sync_ref = self._canon
        for i, count in enumerate(counts):
            yield Candidates.from_forest_replay(replay, i, fails, self._log, count, vcap, vdict)

    def _host_group_fails(self, wins, end_np, gt, vcap: int) -> np.ndarray:
        """Per-window latch values of one host group. The latch is monotone,
        so only a group that contains the flip resolves per window; every
        other group answers from the carried latch or the end-of-group
        roots."""
        k = len(wins)
        if self._failed:
            return np.ones(k, bool)
        base_g = gt[gt < vcap]
        end_conflict = bool(len(base_g) and np.any(end_np[base_g] == end_np[base_g + vcap]))
        if not end_conflict:
            return np.zeros(k, bool)
        fails = []
        failed = False
        for t, r, _c, _cr in wins:
            if not failed:
                failed = _delta_conflict(t, r, vcap)
            fails.append(failed)
        self._failed = failed
        return np.asarray(fails, bool)

    def checkpoint_granularity(self) -> int:
        """1 under ``transient_state`` (which keeps the per-window loop)."""
        return 1 if self.transient_state else super().checkpoint_granularity()

    def _ensure_forest(self, vcap: int) -> None:
        host = self._bp_mode == "host"
        dev = self._device
        if self._canon is None:
            if self._summary is not None and "touched" in self._summary:
                # restored (or converted) dense state: flat cover labels
                # ARE a valid forest; the latch recomputes from them
                lab = to_numpy(self._summary["labels"]).astype(np.int32)
                tch = to_numpy(self._summary["touched"])
                self._vcap = len(lab) // 2
                self._canon = to_device(lab, dev)
                self._log = TouchLog(self._vcap)
                base = np.nonzero(tch[: self._vcap])[0].astype(np.int32)
                self._log.add(base)
                flat = resolve_flat_host(lab)
                failed = bool(np.any(flat[base] == flat[base + self._vcap])) if len(base) else False
            else:
                self._vcap = vcap
                self._canon = torch.arange(2 * vcap, dtype=torch.int32, device=dev)
                self._log = TouchLog(vcap)
                failed = False
            self._failed = failed if host else torch.full((), failed, dtype=torch.bool, device=dev)
            if host:
                from .. import native

                self._uf = native.CompactUnionFind()
                self._uf.load(to_numpy(self._canon))
            else:
                self._prep = WindowPrep()
        if vcap > self._vcap:
            if host:
                # the cover re-index rule applies to the union-find's table
                # too: flatten, shift the negative half, reload
                shifted = _shift_cover_labels(self._uf.flatten(2 * self._vcap), self._vcap, vcap)
                self._uf.load(shifted)
                self._canon = to_device(shifted, dev)
            else:
                self._canon = cover_grow_forest(self._canon, self._vcap, vcap)
            # base-only log: base ids never shift on growth
            self._vcap = vcap
        self._log.grow(self._vcap)

    def _touched_cover(self) -> np.ndarray:
        touched2 = np.zeros(2 * self._vcap, bool)
        touched2[: self._vcap] = self._log.touched_bool(self._vcap)
        return touched2

    def _to_dense(self) -> None:
        if self._bp_mode == "host":
            flat = to_device(self._uf.flatten(2 * self._vcap), self._device)
        else:
            flat = resolve_flat(self._canon)
        self._summary = {"labels": flat, "touched": to_device(self._touched_cover(), self._device)}
        self._canon = None
        self._failed = None
        self._log = None
        self._prep = None
        self._uf = None

    def _reset_transient(self) -> None:
        if self._bp_mode in ("forest", "host"):
            self._canon = torch.arange(2 * self._vcap, dtype=torch.int32, device=self._device)
            self._log = TouchLog(self._vcap)
            self._summary = {"labels": self._canon}
            if self._bp_mode == "host":
                self._failed = False
                self._uf.load(np.arange(2 * self._vcap, dtype=np.int32))
            else:
                self._failed = torch.full((), False, dtype=torch.bool, device=self._device)
        else:
            self._summary = self.initial_state(self._vcap)

    # ---- checkpoint surface: one format for all carries ---- #
    def snapshot_state(self) -> Any:
        if self._bp_mode in ("forest", "host"):
            if self._bp_mode == "host":
                lab = self._uf.flatten(2 * self._vcap)
            else:
                lab = resolve_flat_host(to_numpy(self._canon))
            return {"labels": lab, "touched": self._touched_cover()}
        return super().snapshot_state()

    def restore_state(self, state: Any, vcap: Optional[int] = None) -> None:
        super().restore_state(state, vcap)
        self._bp_mode = None
        self._canon = None
        self._failed = None
        self._log = None
        self._prep = None
        self._uf = None


class BipartitenessServable:
    """:class:`~gelly_streaming_tpu_torch.serving.server.Servable` adapter
    for :class:`BipartitenessCheck`. Every carry publishes the 2*vcap
    cover table per window — the live cover pointer forest (forest/host
    carries: each window's commit allocates a fresh tensor, so the
    published one is never written again) or the dense flat cover labels
    — plus touch evidence for the seen set: the windowed carries ship
    their append-only log by reference and COUNT (the first ``tcount``
    entries never change), the dense carry its ``touched`` table too. The
    :class:`~gelly_streaming_tpu_torch.serving.query.QueryEngine`
    recomputes the verdict + witness from the cover structure, so a query
    never trusts a carried latch.

    SUPERBATCH GRANULARITY: with ``superbatch=K`` the published cover is
    the END-of-group state for all K publishes — safe (the cover merge is
    monotone: bipartite->non-bipartite only ever flips forward), with the
    same group-granular snapshot caveat as ``CCServable``."""

    def __init__(self, agg, vdict=None):
        from ..serving import BipartiteQuery

        self.query_classes = (BipartiteQuery,)
        self._agg = agg
        self._vdict = vdict

    def _payload(self, vdict) -> Optional[dict]:
        agg = self._agg
        if agg._bp_mode in ("forest", "host") and agg._canon is not None:
            return {
                "cover": agg._canon,
                "tids": agg._log.ids,
                "tcount": agg._log.count,
                "vdict": vdict,
            }
        if (
            agg._summary is not None
            and "labels" in agg._summary
            and "touched" in agg._summary
        ):
            # count-snapshotted novelty shadow, same interface as the
            # windowed carries (and CCServable)
            log = TouchLog.from_touched_bool(
                to_numpy(agg._summary["touched"]))
            return {
                "cover": agg._summary["labels"],
                "touched": agg._summary["touched"],
                "tids": log.ids,
                "tcount": log.count,
                "vdict": vdict,
            }
        return None

    def payloads(self, stream):
        vdict = stream.vertex_dict
        self._vdict = vdict
        window = 0
        for _ in self._agg.run(stream):
            window += 1
            payload = self._payload(vdict)
            if payload is None:  # carry not inspectable this window
                continue
            yield payload, window

    def boot_payload(self):
        """The restored cover as a servable payload (None when nothing was
        restored yet, or no vdict is known)."""
        if self._vdict is None:
            return None
        payload = self._payload(self._vdict)
        if payload is None:
            return None
        return payload, 0
