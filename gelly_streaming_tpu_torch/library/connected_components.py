"""Streaming Connected Components (PyTorch port of
``gelly_streaming_tpu/library/connected_components.py``).

The reference (``library/ConnectedComponents.java:41-126``) folds each
edge into a per-partition ``DisjointSet`` (``UpdateCC``) and merges
partials smaller-into-larger (``CombineCC``). Three carries implement
that contract here (``carry=``, default ``"auto"``):

- **Forest carry** (``auto`` on a CUDA device): a pointer forest
  ``canon[vcap]`` on the device, updated by window-local steps:
  host-computed touched set, root chase, T-sized local fixpoint, masked
  scatters (``summaries/forest.py``). Per-window cost scales with the
  WINDOW, not with the vertex capacity; chains canonicalize lazily at
  emission or checkpoint.
- **Host carry** (``auto`` on the CPU when the native library builds):
  the native incremental union-find (``native/ingest.cpp: cuf_*``) folds
  each window beside the parser, and the device keeps a pointer-forest
  MIRROR updated by one O(touched) scatter. On a card its group commit
  downloads the mirror and uploads the new one: correct, and slow, so
  ``auto`` never picks it there.
- **Dense labels** (``summaries/labels.py``): full-table min-label
  fixpoint + pointer-graph combine. Used for streams whose blocks carry
  no host columns (the windowed carries' touched set is host-computed)
  and on ``carry="dense"``. A stream can downgrade to dense mid-run
  (either windowed carry canonicalizes to flat labels); it never needs to
  upgrade back.

Emission gives a lazy
:class:`~gelly_streaming_tpu_torch.summaries.labels.Components` view per
window; checkpoints always store canonical flat labels + touched, so the
carries (and the two packages) share one checkpoint format.

``superbatch=K`` folds K consecutive windows as one group on every carry:
one chase and one commit per GROUP for the forest, one native call for
the host carry, a loop over the stacked block for dense. Emission VALUES
are identical per window; a group's K records surface together, and
mid-group views rebuild lazily on first read. ``transient_state`` keeps
the per-window loop.

The reference's mesh, ``superbatch="auto"``, ``sliding()`` (event time)
and ``servable()`` come with ROADMAP Queue 1, slices 6, 7, 8 and 9.

Usage parity with the reference::

    for comps in stream.aggregate(ConnectedComponents()):
        print(comps)   # {1=[1, 2, 3, 5], 6=[6, 7], 8=[8, 9]}
"""

from __future__ import annotations

from typing import Any, Iterator, Optional

import numpy as np
import torch

from ..aggregate.summary import SummaryBulkAggregation, SummaryTreeReduce
from ..core.edgeblock import to_device
from ..obs import trace as _trace
from ..summaries.forest import (
    MirrorReplay,
    TouchLog,
    WindowPrep,
    forest_superbatch,
    forest_window,
    grow_forest,
    init_forest,
    mirror_update,
    resolve_flat,
    resolve_flat_host,
)
from ..summaries.labels import (
    Components,
    cc_fold,
    grow_labels,
    init_labels,
    label_combine,
    to_numpy,
)


def _validate_min_rooted(lab: np.ndarray) -> None:
    """Reject labels violating the min-rooted invariant (as ``cuf_load``
    does): a table with ``label[v] > v`` would spin the resolve loops
    forever instead of failing."""
    iota = np.arange(len(lab), dtype=lab.dtype)
    if np.any(lab > iota) or np.any(lab < 0):
        raise ValueError(
            "restored labels are not a min-rooted forest "
            "(label[v] must be in [0, v])"
        )


def _auto_carry(device: torch.device) -> str:
    """The windowed carry for a stream on ``device``: ``"forest"`` on a
    CUDA device (the window-local device steps); on the CPU ``"host"``
    (the native union-find beside the parser: union-find is control flow,
    not math) when the native library builds, else ``"forest"``."""
    if torch.device(device).type != "cpu":
        return "forest"
    from .. import native

    return "host" if native.native_available() else "forest"


class _CCMixin:
    def __init__(self, *args, carry: str = "auto", **kwargs):
        super().__init__(*args, **kwargs)
        if carry not in ("auto", "forest", "host", "dense"):
            raise ValueError(f"carry must be auto/forest/host/dense, got {carry!r}")
        self.carry = carry
        self._cc_mode = None  # None | "forest" | "host" | "dense"
        self._canon = None    # device pointer forest (forest/host carries)
        self._log = None      # host TouchLog
        self._uf = None       # native CompactUnionFind (host carry)
        self._prep = None     # WindowPrep scratch (forest carry)

    # ---- dense-engine hooks ---- #
    def initial_state(self, vcap: int):
        return init_labels(max(1, vcap), self._device)

    def grow_state(self, state, old_vcap: int, new_vcap: int):
        return grow_labels(state, new_vcap)

    def update(self, state, src, dst, val, mask):
        return cc_fold(state, src, dst, mask)

    def combine(self, a, b):
        return label_combine(a, b)

    def transform(self, state, vdict) -> Components:
        return Components.from_labels(state, vdict)

    # ---- windowed-carry run loop ---- #
    def _adopt_device(self, stream) -> None:
        super()._adopt_device(stream)
        if self._canon is not None:
            self._canon = self._canon.to(self._device)

    def _pick_mode(self) -> str:
        return self.carry if self.carry != "auto" else _auto_carry(self._device)

    def run(self, stream) -> Iterator[Components]:
        self._adopt_device(stream)
        vdict = stream.vertex_dict
        if self.superbatch > 1 and not self.transient_state:
            # transient_state keeps the per-window loop: its carry reset
            # is window-granular
            self._gf_vdict = vdict
            from ..summaries.groupfold import drive_group_folded

            yield from drive_group_folded(self, stream, self.superbatch)
            return
        for block in stream.blocks():
            yield from self._one_window(block, vdict)

    def fold_group(self, group) -> Iterator[Components]:
        """The CC carries' group fold: one native call (host), one
        group-local fold (forest) or the engine's loop over the stacked
        block (dense), by the live carry mode. A group without host
        columns downgrades to dense, as the per-window path does."""
        vdict = self._gf_vdict
        windowed = (
            group.cols is not None
            and self.carry != "dense"
            and self._cc_mode != "dense"
        )
        if windowed and self._cc_mode is None:
            self._cc_mode = self._pick_mode()
        if windowed and self._cc_mode == "host":
            yield from self._host_group(group, vdict)
        elif windowed and self._cc_mode == "forest":
            yield from self._forest_group(group, vdict)
        else:
            if self._cc_mode in ("forest", "host"):
                self._to_dense()
            self._cc_mode = "dense"
            yield from self._dense_group(group, vdict)

    def _one_window(self, block, vdict):
        """The per-window path (every carry)."""
        cache = getattr(block, "_host_cache", None)
        if cache is None or self.carry == "dense" or self._cc_mode == "dense":
            if self._cc_mode in ("forest", "host"):
                self._to_dense()
            self._cc_mode = "dense"
            self._device_block(block)
            self._sync_ref = self._summary
            yield self.transform(self._summary, vdict)
        else:
            if self._cc_mode is None:
                self._cc_mode = self._pick_mode()
            self._ensure_windowed(block.n_vertices)
            src_h, dst_h = cache[0], cache[1]
            if self._cc_mode == "host":
                tids, roots, changed, chroots = self._uf.fold(
                    src_h, dst_h, self._vcap
                )
                self._canon = mirror_update(
                    self._canon,
                    np.concatenate([tids, changed]),
                    np.concatenate([roots, chroots]),
                    self._vcap,
                )
            else:
                self._canon, tids = forest_window(
                    self._canon, src_h, dst_h, self._vcap, self._prep,
                )
            self._log.add(tids)
            # sync() waits on _summary; keep it aimed at the live carry
            self._summary = {"labels": self._canon}
            self._sync_ref = self._canon
            yield Components.from_forest(self._canon, self._log, vdict)
        if self.transient_state:
            self._reset_transient()

    def _forest_group(self, group, vdict):
        """A K-window group as ONE group-local fold
        (:func:`~gelly_streaming_tpu_torch.summaries.forest.forest_superbatch`);
        the K emissions rebuild their forests lazily on first read, and the
        group pays one vcap-sized copy where the per-window path paid K."""
        with _trace.span(
            "cc.forest_group",
            {"k": len(group), "n_vertices": int(group.n_vertices)}
            if _trace.on() else None,
        ):
            self._ensure_windowed(group.n_vertices)
            windows = [(c[0], c[1]) for c in group.cols]
            self._canon, tids_list, replay = forest_superbatch(
                self._canon, windows, self._vcap, self._prep,
            )
            # the first-seen log advances in window order before the
            # emissions surface; each emission snapshots a count
            counts = []
            for tids in tids_list:
                self._log.add(tids)
                counts.append(self._log.count)
            self._summary = {"labels": self._canon}
            self._sync_ref = self._canon
        for i, count in enumerate(counts):
            yield Components.from_forest_replay(replay, i, self._log, count, vdict)

    def _host_group(self, group, vdict):
        """Host-carry superbatch: K union-find window folds in ONE native
        call, one commit of the group's deduplicated delta into a new
        mirror. The commit runs on the host (the union-find's truth is
        there): on a card that is a download of the mirror and an upload
        of the new one."""
        with _trace.span(
            "cc.host_group",
            {"k": len(group), "n_vertices": int(group.n_vertices)}
            if _trace.on() else None,
        ):
            self._ensure_windowed(group.n_vertices)
            wins, gids, groots, gtcnt = self._uf.fold_group(group.cols, self._vcap)
            ngt = int(np.sum(gtcnt))
            counts = self._log.add_grouped(gids[:ngt], gtcnt)
            base = to_numpy(self._canon)
            new_np = base.copy()
            new_np[gids] = groots
            self._canon = to_device(new_np, self._device)
            replay = MirrorReplay(base, wins)
            self._summary = {"labels": self._canon}
            self._sync_ref = self._canon
        for i, count in enumerate(counts):
            yield Components.from_forest_replay(replay, i, self._log, count, vdict)

    def _dense_group(self, group, vdict):
        """Dense-mode superbatch: the engine's loop over the group's stacked
        block, one lazy ``Components`` per stacked row."""
        for state in self._fold_group_states(group):
            yield self.transform(state, vdict)

    def checkpoint_granularity(self) -> int:
        """1 under ``transient_state`` (which keeps the per-window loop)."""
        return 1 if self.transient_state else super().checkpoint_granularity()

    def _ensure_windowed(self, vcap: int) -> None:
        if self._canon is None:
            if self._summary is not None and "touched" in self._summary:
                # restored (or converted) dense state: flat labels ARE a
                # valid forest; rebuild the touched log from the mask
                labels = self._summary["labels"]
                _validate_min_rooted(to_numpy(labels))
                self._canon = labels
                self._log = TouchLog.from_touched_bool(
                    to_numpy(self._summary["touched"])
                )
                self._vcap = self._canon.shape[0]
            else:
                self._vcap = vcap
                self._canon = init_forest(vcap, self._device)
                self._log = TouchLog(vcap)
            if self._cc_mode == "host":
                from .. import native

                self._uf = native.CompactUnionFind()
                self._uf.load(to_numpy(self._canon))
            else:
                self._prep = WindowPrep()
        if vcap > self._vcap:
            self._canon = grow_forest(self._canon, vcap)
            self._vcap = vcap
        self._log.grow(self._vcap)

    def _to_dense(self) -> None:
        """Downgrade to the dense engine: the host carry flattens exactly on
        the host, the forest carry canonicalizes in one device fixpoint."""
        if self._cc_mode == "host":
            flat = to_device(self._uf.flatten(self._vcap), self._device)
        else:
            flat = resolve_flat(self._canon)
        touched = to_device(self._log.touched_bool(self._vcap), self._device)
        self._summary = {"labels": flat, "touched": touched}
        self._canon = None
        self._log = None
        self._uf = None
        self._prep = None

    def _reset_transient(self) -> None:
        if self._cc_mode in ("forest", "host"):
            self._canon = init_forest(self._vcap, self._device)
            self._log = TouchLog(self._vcap)
            self._summary = {"labels": self._canon}
            if self._cc_mode == "host":
                self._uf.load(np.arange(self._vcap, dtype=np.int32))
        else:
            self._summary = self.initial_state(self._vcap)

    # ---- checkpoint surface: one canonical format for all carries ---- #
    def snapshot_state(self) -> Any:
        if self._cc_mode == "host":
            return {
                "labels": self._uf.flatten(self._vcap),
                "touched": self._log.touched_bool(self._vcap),
            }
        if self._cc_mode == "forest":
            return {
                "labels": resolve_flat_host(to_numpy(self._canon)),
                "touched": self._log.touched_bool(self._vcap),
            }
        return super().snapshot_state()

    def restore_state(self, state: Any, vcap: Optional[int] = None) -> None:
        super().restore_state(state, vcap)
        # undecided until the first block; restored flat labels work as
        # any carry
        self._cc_mode = None
        self._canon = None
        self._log = None
        self._uf = None
        self._prep = None


    def servable(self, vdict=None):
        raise NotImplementedError(
            "the serving adapter is ported in ROADMAP Queue 1, slice 9"
        )


class ConnectedComponents(_CCMixin, SummaryBulkAggregation):
    """Flat-combine streaming CC (``library/ConnectedComponents.java``)."""

    @classmethod
    def sliding(cls, size: int, slide=None, **kwargs):
        raise NotImplementedError(
            "event-time sliding CC is ported in ROADMAP Queue 1, slice 8"
        )


class ConnectedComponentsTree(_CCMixin, SummaryTreeReduce):
    """Tree-combine variant (``library/ConnectedComponentsTree.java:26-36``):
    the same UDFs on the tree engine. The tree/flat split matters only
    under a sharded mesh; on one device the carries are shared."""
