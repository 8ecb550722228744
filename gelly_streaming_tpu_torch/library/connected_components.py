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
- **Dense labels** (``summaries/labels.py``): a flat label table over
  the whole vertex capacity. Used for streams whose blocks carry no host
  columns (the windowed carries' touched set is host-computed: a
  device-encoded stream) and on ``carry="dense"``. On one card a window
  folds into the table in ONE launch of a union-find kernel
  (``cc_kernels.fold_window``, ``csrc/cc_fold.cu``) that reads nothing to the
  host; under a mesh and on the CPU it is the engine's per-shard fold
  (a full-table min-label fixpoint) and pointer-graph combine, each
  fixpoint reading its loop condition to the host every turn. A stream
  can downgrade to dense mid-run (either windowed carry canonicalizes to
  flat labels); it never needs to upgrade back.

Emission gives a lazy
:class:`~gelly_streaming_tpu_torch.summaries.labels.Components` view per
window; checkpoints always store canonical flat labels + touched, so the
carries (and the two packages) share one checkpoint format.

``superbatch=K`` folds K consecutive windows as one group on every carry:
one chase and one commit per GROUP for the forest, one native call for
the host carry, a loop over the stacked block for dense. Emission VALUES
are identical per window; a group's K records surface together, and
mid-group views rebuild lazily on first read. ``transient_state`` keeps
the per-window loop. ``superbatch="auto"`` re-tiles the groups at their
boundaries under an ``AutoK`` controller; any K folds on the stream's
device. :meth:`ConnectedComponents.sliding` is the event-time shape
(``eventtime/``, host numpy, as in the reference).

:meth:`servable` maps the carry to serving snapshots
(:class:`CCServable`, ``serving/``).

Under a mesh with a >1-wide ``"edges"`` axis (``parallel/``), the dense
carry folds per shard through the engine, and the forest carry runs its
window-sized local fixpoint per shard with the tables merged across ranks
(the vcap-sized forest never crosses the mesh); the host union-find
computes the merge exactly on every rank and ignores the mesh. The tree
variant's degree resolves against the mesh when the run starts, with its
one warning.

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
from ..ops import cc_kernels
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
        self._gf_degree = 2   # resolved tree degree for the group fold

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

    def _fold_window(self, summary, block, vcap, mesh):
        """The dense window step: on one card the fused fold, one launch
        (:func:`~gelly_streaming_tpu_torch.ops.cc_kernels.fold_window`);
        under a mesh (the per-shard ``update`` and the cross-shard
        ``combine``) and on the CPU, the engine's ``update`` + ``combine``."""
        if mesh is None and block.src.device.type == "cuda":
            labels, touched = cc_kernels.fold_window(
                summary["labels"], summary["touched"], block.src, block.dst, block.mask)
            return {"labels": labels, "touched": touched}
        return super()._fold_window(summary, block, vcap, mesh)

    # ---- windowed-carry run loop ---- #
    def _adopt_device(self, stream) -> None:
        super()._adopt_device(stream)
        if self._canon is not None:
            self._canon = self._canon.to(self._device)

    def _pick_mode(self) -> str:
        return self.carry if self.carry != "auto" else _auto_carry(self._device)

    def run(self, stream) -> Iterator[Components]:
        self._adopt_device(stream)
        mesh = self._resolve_mesh(stream)
        eff_degree = getattr(self, "degree", 2)
        if mesh is not None and self._is_tree():
            # resolve the tree degree against the mesh EAGERLY: the host
            # carry never runs the butterfly, so a misconfigured degree
            # would otherwise pass silently. A degree the mesh cannot
            # honor degrades to 2 with ONE warning here.
            from ..parallel import comm
            from ..parallel.mesh import EDGE_AXIS, mesh_shape

            eff_degree = comm.resolve_tree_degree(
                mesh_shape(mesh)[EDGE_AXIS], eff_degree)
        vdict = stream.vertex_dict
        if (self.superbatch > 1 or self.superbatch_auto) and not self.transient_state:
            # transient_state keeps the per-window loop: its carry reset
            # is window-granular
            self._gf_mesh = mesh
            self._gf_vdict = vdict
            self._gf_degree = eff_degree
            from ..summaries.groupfold import drive_group_folded

            yield from drive_group_folded(
                self, stream, self.superbatch,
                controller=self._attach_control(self.superbatch),
            )
            return
        for block in stream.blocks():
            yield from self._one_window(block, mesh, eff_degree, vdict)

    def fold_group(self, group) -> Iterator[Components]:
        """The CC carries' group fold: one native call (host), one
        group-local fold (forest) or the engine's loop over the stacked
        block (dense), by the live carry mode. A group without host
        columns downgrades to dense, as the per-window path does."""
        mesh, vdict = self._gf_mesh, self._gf_vdict
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
            yield from self._forest_group(group, mesh, self._gf_degree, vdict)
        else:
            if self._cc_mode in ("forest", "host"):
                self._to_dense()
            self._cc_mode = "dense"
            yield from self._dense_group(group, mesh, vdict)

    def _one_window(self, block, mesh, eff_degree, vdict):
        """The per-window path (every carry)."""
        cache = getattr(block, "_host_cache", None)
        if cache is None or self.carry == "dense" or self._cc_mode == "dense":
            if self._cc_mode in ("forest", "host"):
                self._to_dense()
            self._cc_mode = "dense"
            self._device_block(block, mesh)
            self._sync_ref = self._summary
            yield self.transform(self._summary, vdict)
        else:
            if self._cc_mode is None:
                self._cc_mode = self._pick_mode()
            self._ensure_windowed(block.n_vertices)
            src_h, dst_h = cache[0], cache[1]
            if self._cc_mode == "host":
                # the host union-find computes the merge exactly; a
                # mesh adds nothing (the mirror is one scatter)
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
                    mesh=mesh, tree=self._is_tree(), degree=eff_degree,
                )
            self._log.add(tids)
            # sync() waits on _summary; keep it aimed at the live carry
            self._summary = {"labels": self._canon}
            self._sync_ref = self._canon
            _trace.window_done(block.cut_ns, self._device)
            yield Components.from_forest(self._canon, self._log, vdict)
        if self.transient_state:
            self._reset_transient()

    def _forest_group(self, group, mesh, eff_degree, vdict):
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
                mesh=mesh, tree=self._is_tree(), degree=eff_degree,
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

    def _dense_group(self, group, mesh, vdict):
        """Dense-mode superbatch: the engine's loop over the group's stacked
        block, one lazy ``Components`` per stacked row."""
        for state in self._fold_group_states(group, mesh):
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

    # ---- serving surface (serving/server.py Servable contract) ------- #
    def servable(self, vdict=None) -> "CCServable":
        """Adapter mapping this aggregation's carry to per-window serving
        snapshots: ``labels`` is the live pointer forest (forest/host
        carries: each window's commit allocates a fresh tensor, so the
        published one is never written again) or the dense flat-label
        table (the dense step is functional too); the
        :class:`~gelly_streaming_tpu_torch.serving.query.QueryEngine`
        chases either. Serves ``ConnectedQuery``, ``ComponentSizeQuery``
        and ``SummaryPullQuery``. ``vdict`` seeds the boot payload when
        restoring from a checkpoint before any stream is attached."""
        return CCServable(self, vdict)


def _counted_blocks(blocks, total):
    """Pass blocks through, accumulating the edge watermark into
    ``total[0]``: exact from host caches, the padded capacity (an upper
    bound) for device-transformed blocks — never a mid-stream D2H."""
    for b in blocks:
        cache = getattr(b, "_host_cache", None)
        total[0] += len(cache[0]) if cache is not None else int(b.capacity)
        yield b


class CCServable:
    """:class:`~gelly_streaming_tpu_torch.serving.server.Servable` adapter
    for the CC aggregation. Every carry publishes one ``labels`` tensor
    per window — the live pointer forest for the forest/host carries or
    the dense flat table, each a buffer no later window writes (torch
    tensors can be written in place, so this is the carries' rule, pinned
    by the serving tests for every carry) — plus the stream's vertex dict
    for raw-id resolution and the TouchLog's append-only ``tids`` prefix.

    SUPERBATCH GRANULARITY: with ``superbatch=K`` the aggregation yields a
    group's K emissions after its fused fold, so the live carry read here
    is the END-of-group state for all K publishes. That is safe — the CC
    carry is monotone, so a query sees a FRESHER snapshot, never a wrong
    one — but snapshots and their watermark advance at group granularity:
    deployments that need per-window snapshot pinning run
    ``superbatch=1``."""

    def __init__(self, agg, vdict=None):
        from ..serving import (
            ComponentSizeQuery,
            ConnectedQuery,
            SummaryPullQuery,
        )

        # SummaryPullQuery makes the servable ROUTABLE: a shard router
        # pulls the forest as a raw-id mergeable summary through the same
        # query wire
        self.query_classes = (
            ConnectedQuery, ComponentSizeQuery, SummaryPullQuery,
        )
        self._agg = agg
        self._vdict = vdict

    def _payload(self, vdict) -> Optional[dict]:
        agg = self._agg
        if agg._cc_mode in ("forest", "host") and agg._canon is not None:
            labels = agg._canon
        elif agg._summary is not None and "labels" in agg._summary:
            labels = agg._summary["labels"]
        else:
            return None
        payload = {"labels": labels, "vdict": vdict}
        log = getattr(agg, "_log", None)
        if log is not None:
            # the TouchLog novelty shadow rides every snapshot
            # (count-snapshotted: the first tcount entries of an
            # append-only log never change) — the delta-pull diff's
            # candidate bound
            payload["tids"] = log.ids
            payload["tcount"] = log.count
        return payload

    def payloads(self, stream):
        vdict = stream.vertex_dict
        self._vdict = vdict
        total = [0]
        derive = getattr(stream, "_derive", None)
        counted = (
            stream if derive is None
            else derive(lambda blocks: _counted_blocks(blocks, total))
        )
        window = 0
        for _ in self._agg.run(counted):
            window += 1
            payload = self._payload(vdict)
            if payload is None:  # carry not inspectable this window
                continue
            yield payload, (total[0] or window)

    def boot_payload(self):
        """The restored summary as a servable payload (None when nothing
        was restored yet, or no vdict is known). Validates the min-rooted
        invariant: a corrupt checkpoint served as a boot snapshot would
        otherwise spin the query worker's root chase forever on the first
        query, long before the first live window could raise."""
        if self._vdict is None:
            return None
        payload = self._payload(self._vdict)
        if payload is None:
            return None
        _validate_min_rooted(to_numpy(payload["labels"]))
        return payload, 0


class ConnectedComponents(_CCMixin, SummaryBulkAggregation):
    """Flat-combine streaming CC (``library/ConnectedComponents.java``)."""

    @classmethod
    def sliding(cls, size: int, slide=None, **kwargs):
        """The EVENT-TIME shape of this workload: CC over a sliding window
        that retracts expired panes by bounded forest repair, a
        :class:`~gelly_streaming_tpu_torch.eventtime.SlidingGraphAggregator`
        restricted to the CC summary. ``size``/``slide`` are event-time
        units; other keywords pass through (``allowed_lateness``,
        ``nshards``, ``commit_dir``, ...)."""
        from ..eventtime import SlidingGraphAggregator

        return SlidingGraphAggregator(size, slide, summaries=("cc",), **kwargs)


class ConnectedComponentsTree(_CCMixin, SummaryTreeReduce):
    """Tree-combine variant (``library/ConnectedComponentsTree.java:26-36``):
    the same UDFs on the tree engine. The tree/flat split matters only
    under a sharded mesh, where the shard partials merge through the
    butterfly; on one device the carries are shared."""
