"""The summary-aggregation engine: per-window fold + combine into a carried
global summary (PyTorch port of ``gelly_streaming_tpu/aggregate/summary.py``).

The reference's dataflow per window (``SummaryAggregation.java``,
``SummaryBulkAggregation.java``, ``SummaryTreeReduce.java``):

    keyBy -> per-partition window fold(updateFun) -> reduce(combineFun)
    -> Merger (running summary) -> optional transform

maps here, on one device, to ``update`` from ``initial_state`` over the
window's EdgeBlock, ``combine`` into the carried summary, and
``transform`` for emission. The state lives on the stream's device; the
engine runs eagerly, so a window step is a sequence of PyTorch operations
rather than one compiled dispatch, and the reference's ``lax.scan`` over
a superbatch is a loop over its K rows.

Host-state aggregations (``host_state = True``, the reference's
``device=False``: the spanner) run ``update``/``combine`` on host records
of RAW ids, one window at a time. What comes later: the sharded mesh
(per-shard folds merged by collectives) with ROADMAP Queue 1, slice 6;
``superbatch="auto"`` with slice 7b (control and ingest).

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
from ..summaries.groupfold import GroupFoldable, drive_group_folded
from ..summaries.labels import to_numpy

_MESH = "ROADMAP Queue 1, slice 6 (multiple devices)"
_AUTO_K = ('ROADMAP Queue 1, slice 7b (control and ingest: '
           'superbatch="auto")')


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
        Must be None in this port so far (the sharded mesh is ROADMAP
        Queue 1, slice 6).
    superbatch:
        Fold this many consecutive windows as one group, still yielding
        one record per window with the same values; a group's K records
        surface together after its fold. ``1`` (default) keeps the
        per-window path.

    The state lives on the device of the stream the aggregation runs on
    (``stream.device``), read when :meth:`run` starts. A subclass with
    ``host_state = True`` keeps a host object instead and folds each
    window's raw host columns (``superbatch`` does not apply to it).
    """

    #: the reference's ``device=False``: update/combine on host records
    host_state: bool = False

    def __init__(self, transient_state: bool = False, mesh=None,
                 superbatch=1):
        if mesh is not None:
            raise NotImplementedError(f"a sharded mesh is ported in {_MESH}")
        self.transient_state = transient_state
        if superbatch == "auto":
            raise NotImplementedError(f'superbatch="auto" is ported in {_AUTO_K}')
        if isinstance(superbatch, str):
            raise ValueError(
                f'superbatch must be an int >= 1 or "auto", got {superbatch!r}'
            )
        if superbatch < 1:
            raise ValueError(f"superbatch must be >= 1, got {superbatch}")
        self.superbatch = int(superbatch)
        self._summary = None
        self._vcap = 0
        self._sync_ref = None  # last state folded (the sync target)
        self._device: Optional[torch.device] = None
        # run-loop context for the declared group fold
        self._gf_vdict = None

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

    def _window_step(self, summary: Any, block: EdgeBlock, vcap: int) -> Any:
        """One window: ``update`` from a fresh state, then ``combine`` into
        the carried summary."""
        with _trace.span(
            "engine.dispatch",
            {"vcap": vcap, "edges_capacity": int(block.capacity)}
            if _trace.on() else None,
        ):
            part = self.update(
                self.initial_state(vcap), block.src, block.dst, block.val,
                block.mask,
            )
            return self.combine(summary, part)

    def _superbatch_step(
        self, summary: Any, sblock: StackedEdgeBlock, vcap: int
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
                new = self._window_step(carry, sblock.window(i), vcap)
                ys.append(new)
                carry = self.initial_state(vcap) if self.transient_state else new
            stacked = {key: torch.stack([y[key] for y in ys]) for key in ys[0]}
            return carry, stacked

    def checkpoint_granularity(self) -> int:
        """Window stride at which the carried summary is observable: 1 on
        the per-window path, ``superbatch`` on the group path."""
        return 1 if self.host_state else self.superbatch

    def _device_block(self, block: EdgeBlock) -> None:
        """Grow + fold one block into the carried summary."""
        vcap = block.n_vertices
        if self._summary is None:
            self._vcap = vcap
            self._summary = self.initial_state(vcap)
        elif vcap > self._vcap:
            self._summary = self.grow_state(self._summary, self._vcap, vcap)
            self._vcap = vcap
        self._summary = self._window_step(self._summary, block, vcap)

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
        if self.superbatch > 1:
            yield from self._run_superbatched(stream, vdict)
            return
        for block in stream.blocks():
            self._device_block(block)
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

    def _run_superbatched(self, stream, vdict) -> Iterator[Any]:
        """The group drive loop (:func:`drive_group_folded`)."""
        self._gf_vdict = vdict
        yield from drive_group_folded(self, stream, self.superbatch)

    def fold_group(self, group) -> Iterator[Any]:
        """The engine's declared group fold: the K rows of the group's
        stacked block, per-window summaries unstacked lazily."""
        for state in self._fold_group_states(group):
            yield self.transform(state, self._gf_vdict)

    def _fold_group_states(self, group) -> Iterator[Any]:
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
        carry, ys = self._superbatch_step(self._summary, group.stacked(), self._vcap)
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
    """Flat-combine engine (``SummaryBulkAggregation.java:51-131``)."""


class SummaryTreeReduce(SummaryAggregation):
    """Tree-combine engine (``SummaryTreeReduce.java:47-160``). On one
    device the tree and the flat combine are the same fold; ``degree`` is
    the fan-in of the butterfly the sharded mesh runs (ROADMAP Queue 1,
    slice 6), validated here as in the reference."""

    def __init__(self, transient_state: bool = False, mesh=None,
                 degree: int = 2, superbatch: int = 1):
        super().__init__(transient_state=transient_state, mesh=mesh,
                         superbatch=superbatch)
        if degree < 2:
            raise ValueError(f"degree must be >= 2, got {degree}")
        self.degree = degree
