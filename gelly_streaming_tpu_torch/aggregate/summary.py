"""The summary-aggregation engine: per-window fold + combine into a carried
global summary (PyTorch port of ``gelly_streaming_tpu/aggregate/summary.py``).

The reference's dataflow per window (``SummaryAggregation.java``,
``SummaryBulkAggregation.java``, ``SummaryTreeReduce.java``):

    keyBy -> per-partition window fold(updateFun) -> reduce(combineFun)
    -> Merger (running summary) -> optional transform

maps here to ``update`` from ``initial_state`` over the window's
EdgeBlock, ``combine`` into the carried summary, and ``transform`` for
emission. The state lives on the stream's device; the engine runs
eagerly, so a window step is a sequence of PyTorch operations rather than
one compiled dispatch, and the reference's ``lax.scan`` over a superbatch
is a loop over its K rows.

Under a mesh with a >1-wide ``"edges"`` axis (``parallel/``), every rank
runs the same window stream and folds ITS slice of each block's columns
(:func:`~gelly_streaming_tpu_torch.parallel.comm.shard_map`); the
per-shard partials then merge across ranks: the bulk engine all-gathers
them in rank order and folds the stack the same way on every rank
(``comm.stacked_reduce``, the reference's stacked order bit for bit), the
tree engine runs the degree-d butterfly (``comm.tree_all_reduce``). Every
rank ends the window with the same summary.

Host-state aggregations (``host_state = True``, the reference's
``device=False``: the spanner) run ``update``/``combine`` on host records
of RAW ids, one window at a time.

``superbatch="auto"`` runs the group path under an
:class:`~gelly_streaming_tpu_torch.control.AutoK` controller: K starts at 1
and is re-tuned at group boundaries from measured group throughput
(``GroupFoldable._attach_control`` is the one attach rule).

Checkpoint surface (``SummaryAggregation.java:127-135``):
:meth:`snapshot_state` / :meth:`restore_state` move the running summary
as numpy arrays.
"""

from __future__ import annotations

import abc
from typing import Any, Iterator, Optional

import numpy as np
import torch

from ..core.edgeblock import EdgeBlock, StackedEdgeBlock
from ..obs import trace as _trace
from ..parallel import comm
from ..parallel.mesh import EDGE_AXIS, P, mesh_shape
from ..summaries.groupfold import GroupFoldable, drive_group_folded
from ..summaries.labels import to_numpy


def tree_map(fn, state):
    """``fn`` over the leaves of a state made of dicts, lists and tuples."""
    if isinstance(state, dict):
        return {k: tree_map(fn, v) for k, v in state.items()}
    if isinstance(state, (list, tuple)):
        return type(state)(tree_map(fn, v) for v in state)
    return fn(state)


def tree_leaves(state) -> list:
    out: list = []
    tree_map(out.append, state)
    return out


class SummaryAggregation(GroupFoldable, abc.ABC):
    """Abstract engine config (``SummaryAggregation.java:22-137``).

    Parameters
    ----------
    transient_state:
        When True the running summary resets after each emission
        (``SummaryAggregation.java:113-115``).
    mesh:
        Optional ``DeviceMesh`` with an ``"edges"`` axis
        (:func:`~gelly_streaming_tpu_torch.parallel.make_mesh`); falls back
        to the stream context's mesh, else single-device execution.
    superbatch:
        Fold this many consecutive windows as one group, still yielding
        one record per window with the same values; a group's K records
        surface together after its fold. ``1`` (default) keeps the
        per-window path. ``"auto"``: the group path under an
        :class:`~gelly_streaming_tpu_torch.control.AutoK` controller, K
        starting at 1; ``superbatch`` then tracks the LIVE operating point
        and ``control`` holds the run's plane (a plane set before the run
        is used as it is: ``AutoK(k0=K, k_max=K)`` pins the knob).

    The state lives on the device of the stream the aggregation runs on
    (``stream.device``), read when :meth:`run` starts. A subclass with
    ``host_state = True`` keeps a host object instead and folds each
    window's raw host columns (``superbatch`` does not apply to it).
    """

    #: the reference's ``device=False``: update/combine on host records
    host_state: bool = False

    #: names of instance attributes whose values change the behavior of
    #: initial_state/update/combine/transform (hashable values), part of
    #: :meth:`step_cache_key`
    config_fields: tuple = ()

    def __init__(self, transient_state: bool = False, mesh=None,
                 superbatch=1):
        self.transient_state = transient_state
        self.mesh = mesh
        self._set_superbatch(superbatch)
        self._summary = None
        self._vcap = 0
        self._sync_ref = None  # last state folded (the sync target)
        self._device: Optional[torch.device] = None
        # run-loop context for the declared group fold
        self._gf_mesh = None
        self._gf_vdict = None
        self._partial_fns = {}  # (vcap, mesh) -> one-window fold

    def step_cache_key(self):
        """Hashable identity of the configured window step: the class and
        the values of its ``config_fields``. Two instances with equal keys
        fold alike; differently configured ones never share a key."""
        return (type(self),) + tuple(getattr(self, f) for f in self.config_fields)

    # ------------------------------------------------------------------ #
    # State protocol (the updateFun / combineFun / transform slots)
    # ------------------------------------------------------------------ #
    @abc.abstractmethod
    def initial_state(self, vcap: int) -> Any:
        """Fresh per-window fold state on the aggregation's device."""

    def grow_state(self, state: Any, old_vcap: int, new_vcap: int) -> Any:
        """Re-size carried state when the vertex capacity bucket grows."""
        raise NotImplementedError(
            f"{type(self).__name__} must implement grow_state to stream "
            "beyond its initial vertex capacity"
        )

    @abc.abstractmethod
    def update(self, state: Any, src, dst, val, mask) -> Any:
        """Fold one window's padded device columns into the state
        (``EdgesFold`` role)."""

    @abc.abstractmethod
    def combine(self, a: Any, b: Any) -> Any:
        """Associative merge of two states (``combineFun`` role)."""

    def transform(self, state: Any, vdict) -> Any:
        """Map the running summary to the emitted record (optional)."""
        return state

    # ------------------------------------------------------------------ #
    # Engine
    # ------------------------------------------------------------------ #
    def _adopt_device(self, stream) -> None:
        """Take the stream's device; a summary restored before the run (on
        the CPU) moves there."""
        self._device = stream.device
        if self._summary is not None:
            self._summary = tree_map(
                lambda t: t.to(self._device) if isinstance(t, torch.Tensor) else t,
                self._summary,
            )

    def _resolve_mesh(self, stream):
        """The aggregation's mesh, else the stream context's; None when
        neither has a >1-wide edge axis (the single-device path)."""
        mesh = self.mesh if self.mesh is not None else stream.get_context().mesh
        if mesh is None or mesh_shape(mesh).get(EDGE_AXIS, 1) == 1:
            return None
        return mesh

    def _make_partial_fn(self, vcap: int, mesh):
        """The one-window fold: per-shard ``update`` from ``initial_state``
        plus the cross-shard combine. Shared by the per-window step and the
        superbatch loop so the two paths cannot drift; built once per
        (vcap, mesh), so a tree degree the mesh cannot honor warns once."""
        key = (vcap, mesh)
        fn = self._partial_fns.get(key)
        if fn is not None:
            return fn
        p = mesh_shape(mesh)[EDGE_AXIS] if mesh is not None else 1
        tree = self._is_tree()
        # a fan-in the mesh cannot honor degrades to 2 with a warning;
        # only the tree engine runs the butterfly
        degree = (
            comm.resolve_tree_degree(p, getattr(self, "degree", 2))
            if tree and mesh is not None else 2
        )

        def partial_fn(src, dst, val, mask):
            init = self.initial_state(vcap)
            if mesh is None:
                return self.update(init, src, dst, val, mask)

            def shard_fn(src, dst, val, mask):
                part = self.update(init, src, dst, val, mask)
                if tree:
                    return comm.tree_all_reduce(
                        part, EDGE_AXIS, self.combine, p, degree=degree,
                    )
                return tree_map(lambda x: x[None], part)

            spec = P() if tree else P(EDGE_AXIS)
            out = comm.shard_map(
                shard_fn, mesh, (P(EDGE_AXIS),) * 4, spec,
            )(src, dst, val, mask)
            # bulk: the stacked shard partials fold in log depth (the
            # timeWindowAll gather analog), the same fold on every rank
            return out if tree else comm.stacked_reduce(out, p, self.combine)

        self._partial_fns[key] = partial_fn
        return partial_fn

    def _is_tree(self) -> bool:
        return False

    def _window_step(self, summary: Any, block: EdgeBlock, vcap: int,
                     mesh=None) -> Any:
        """One window: the one-window fold (per shard under a mesh), then
        ``combine`` into the carried summary."""
        with _trace.span(
            "engine.dispatch",
            {"vcap": vcap, "edges_capacity": int(block.capacity)}
            if _trace.on() else None,
            device=block.src.device,
        ):
            return self._fold_window(summary, block, vcap, mesh)

    def _fold_window(self, summary: Any, block: EdgeBlock, vcap: int, mesh) -> Any:
        """The body of a window step: the one-window fold, then ``combine``
        into the carried summary. An aggregation with a fused form of the
        two overrides this."""
        part = self._make_partial_fn(vcap, mesh)(
            block.src, block.dst, block.val, block.mask)
        return self.combine(summary, part)

    def _superbatch_step(
        self, summary: Any, sblock: StackedEdgeBlock, vcap: int, mesh=None
    ) -> tuple:
        """K window steps over the rows of the stacked block. Returns
        ``(carry, ys)``: the carried summary after all K windows, and the
        per-window summaries stacked ``[K, ...]`` that back the group's
        lazy emissions. ``transient_state`` resets the carry after every
        row, as the per-window path does after every yield."""
        sp = (
            _trace.span("engine.superbatch_dispatch",
                        {"k": int(sblock.k), "capacity": int(sblock.capacity),
                         "vcap": vcap})
            if _trace.on() else _trace.NOOP_SPAN
        )
        with sp:
            carry = summary
            ys = []
            for i in range(sblock.k):
                new = self._window_step(carry, sblock.window(i), vcap, mesh)
                ys.append(new)
                carry = self.initial_state(vcap) if self.transient_state else new
            stacked = {key: torch.stack([y[key] for y in ys]) for key in ys[0]}
            return carry, stacked

    def checkpoint_granularity(self) -> int:
        """Window stride at which the carried summary is observable: 1 on
        the per-window path, ``superbatch`` on the group path."""
        return 1 if self.host_state else self.superbatch

    def _device_block(self, block: EdgeBlock, mesh=None) -> None:
        """Grow + fold one block into the carried summary."""
        vcap = block.n_vertices
        if self._summary is None:
            self._vcap = vcap
            self._summary = self.initial_state(vcap)
        elif vcap > self._vcap:
            self._summary = self.grow_state(self._summary, self._vcap, vcap)
            self._vcap = vcap
        self._summary = self._window_step(self._summary, block, vcap, mesh)
        _trace.window_done(block.cut_ns, self._device)

    def run(self, stream) -> Iterator[Any]:
        """Drive the aggregation over the stream's windows
        (``SummaryBulkAggregation.java:68-90``), one record per window.
        With ``superbatch=K > 1``, K windows fold as one group and the
        carried summary is observable only on group boundaries."""
        self._adopt_device(stream)
        vdict = stream.vertex_dict
        if self.host_state:
            yield from self._run_host(stream, vdict)
            return
        mesh = self._resolve_mesh(stream)
        if self.superbatch > 1 or self.superbatch_auto:
            yield from self._run_superbatched(stream, mesh, vdict)
            return
        for block in stream.blocks():
            self._device_block(block, mesh)
            self._sync_ref = self._summary
            yield self.transform(self._summary, vdict)
            if self.transient_state:
                self._summary = self.initial_state(self._vcap)

    def _run_host(self, stream, vdict) -> Iterator[Any]:
        """The host-state loop: each window's host columns, decoded to raw
        ids, fold into a fresh state that combines into the summary."""
        for block in stream.blocks():
            src, dst, val = block.to_host()
            if self._summary is None:
                self._summary = self.initial_state(0)
            partial = self.update(
                self.initial_state(0), vdict.decode(src), vdict.decode(dst), val, None)
            self._summary = self.combine(self._summary, partial)
            yield self.transform(self._summary, vdict)
            if self.transient_state:
                self._summary = self.initial_state(0)

    def _run_superbatched(self, stream, mesh, vdict) -> Iterator[Any]:
        """The group drive loop (:func:`drive_group_folded`), adaptive
        under ``superbatch="auto"``."""
        self._gf_mesh = mesh
        self._gf_vdict = vdict
        yield from drive_group_folded(
            self, stream, self.superbatch,
            controller=self._attach_control(self.superbatch),
        )

    def fold_group(self, group) -> Iterator[Any]:
        """The engine's declared group fold: the K rows of the group's
        stacked block, per-window summaries unstacked lazily."""
        for state in self._fold_group_states(group, self._gf_mesh):
            yield self.transform(state, self._gf_vdict)

    def _fold_group_states(self, group, mesh=None) -> Iterator[Any]:
        """Grow + fold one group, yielding the K per-window states. Vertex
        capacity growth happens at GROUP boundaries: every window of a
        group folds at the group's final capacity."""
        from ..core.emission import iter_unstacked

        vmax = max(1, group.n_vertices)
        if self._summary is None:
            self._vcap = vmax
            self._summary = self.initial_state(self._vcap)
        elif vmax > self._vcap:
            self._summary = self.grow_state(self._summary, self._vcap, vmax)
            self._vcap = vmax
        carry, ys = self._superbatch_step(
            self._summary, group.stacked(), self._vcap, mesh)
        self._summary = carry
        self._sync_ref = carry
        yield from iter_unstacked(ys, len(group))

    def sync(self) -> None:
        """Wait until the device work on the carried summary is done: the
        end-of-stream barrier. The run loop only enqueues device work, so
        anyone timing throughput calls this inside the timed region.
        Also covers the last folded state (``transient_state`` resets the
        summary after each yield)."""
        devices = {
            t.device for t in tree_leaves((self._summary, self._sync_ref))
            if isinstance(t, torch.Tensor) and t.device.type == "cuda"
        }
        with _trace.span("engine.sync"):
            for dev in devices:
                torch.cuda.synchronize(dev)

    # ------------------------------------------------------------------ #
    # Checkpoint surface (ListCheckpointed analog)
    # ------------------------------------------------------------------ #
    def snapshot_state(self) -> Any:
        """The running summary as numpy arrays
        (``SummaryAggregation.java:127-130``); a host state as it is."""
        if self.host_state:
            return self._summary
        return tree_map(
            lambda t: to_numpy(t) if isinstance(t, torch.Tensor) else t,
            self._summary,
        )

    def infer_vcap(self, state: Any) -> int:
        """Vertex capacity implied by a state (its first leaf's length)."""
        leaves = tree_leaves(state)
        return int(leaves[0].shape[0]) if leaves else 0

    def restore_state(self, state: Any, vcap: Optional[int] = None) -> None:
        """Restore a summary captured by :meth:`snapshot_state`
        (``SummaryAggregation.java:132-135``): tensors on the aggregation's
        device once a run has set it, on the CPU until then (moved to the
        stream's device when the next run starts)."""
        if self.host_state:
            self._summary = state
            return
        dev = self._device if self._device is not None else torch.device("cpu")
        self._summary = tree_map(
            lambda a: torch.as_tensor(np.array(a), device=dev), state
        )
        self._vcap = vcap if vcap is not None else self.infer_vcap(self._summary)


class SummaryBulkAggregation(SummaryAggregation):
    """Flat-combine engine (``SummaryBulkAggregation.java:51-131``):
    per-shard fold, then a stack-and-fold global combine."""


class SummaryTreeReduce(SummaryAggregation):
    """Tree-combine engine (``SummaryTreeReduce.java:47-160``): the shard
    partials merge through a ``log_degree(p)``-round butterfly
    (:func:`~gelly_streaming_tpu_torch.parallel.comm.tree_all_reduce`).
    ``degree`` is its fan-in; a degree the edge axis cannot honor (the
    axis size must be a power of it) degrades to 2 with a warning. On one
    device the tree and the flat combine are the same fold."""

    #: the fan-in changes the combine's collective program
    config_fields: tuple = ("degree",)

    def __init__(self, transient_state: bool = False, mesh=None,
                 degree: int = 2, superbatch: int = 1):
        super().__init__(transient_state=transient_state, mesh=mesh,
                         superbatch=superbatch)
        if degree < 2:
            raise ValueError(f"degree must be >= 2, got {degree}")
        self.degree = degree

    def _is_tree(self) -> bool:
        return True
