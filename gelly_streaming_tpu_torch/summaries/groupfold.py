"""The group-fold contract: a carry that declares a fused K-window path
(PyTorch port of ``gelly_streaming_tpu/summaries/groupfold.py``).

1. **Pack once.** A :class:`~gelly_streaming_tpu_torch.core.window.SuperbatchGroup`
   arrives with K windows' host column views from one group encode.
2. **Fold fused.** :meth:`GroupFoldable.fold_group` folds the whole group
   at once and yields exactly ``len(group)`` per-window emissions whose
   VALUES equal the per-window path's.
3. **Rebuild lazily.** Mid-group carry states exist only as the group's
   delta stack; an emission that is read rebuilds its window's view on
   first access.
4. **Checkpoint on boundaries.** The carried summary is observable only
   between groups (:meth:`GroupFoldable.checkpoint_granularity`).

:func:`drive_group_folded` is THE superbatch drive loop; groups come from
the stream's packer, prefetched one group ahead on the stream's device so
the host assembles group N+1 while the device folds N.
:func:`verify_group_fold` is the reusable conformance check. The
adaptive-K controller (``controller=``) comes with ROADMAP Queue 1,
slice 7b (control and ingest).
"""

from __future__ import annotations

import abc
from typing import Any, Callable, Iterator, Optional

#: groups prefetched ahead of the fold
GROUP_PREFETCH_DEPTH = 2


class GroupFoldable(abc.ABC):
    """A workload whose carry declares a fused K-window group path."""

    @abc.abstractmethod
    def fold_group(self, group) -> Iterator[Any]:
        """Fold one group at once; yield its ``len(group)`` per-window
        emissions."""

    def group_supported(self, group) -> bool:
        """Whether THIS group can take the fused path (an unsupported group
        runs through :meth:`fold_group_fallback`)."""
        return True

    def fold_group_fallback(self, group) -> Iterator[Any]:
        """Per-window fold of an unsupported group."""
        raise NotImplementedError(
            f"{type(self).__name__}.group_supported rejected a group "
            "but no fold_group_fallback is implemented"
        )

    def checkpoint_granularity(self) -> int:
        """Window stride at which the carried state is observable."""
        return int(getattr(self, "superbatch", 1) or 1)

    #: cumulative windows of every group whose fold has STARTED in the
    #: current drive_group_folded run (None outside one)
    _gf_folded: Optional[int] = None

    def checkpoint_aligned(self, done_windows: int) -> bool:
        """Whether a checkpoint barrier may land after ``done_windows``
        emissions of the current run: exactly on a group boundary inside a
        group-folded run, by the static granularity outside one."""
        folded = self._gf_folded
        if folded is not None:
            return done_windows == folded
        return done_windows % max(1, self.checkpoint_granularity()) == 0


def drive_group_folded(workload: GroupFoldable, stream, k: int,
                       prefetch_groups: int = GROUP_PREFETCH_DEPTH,
                       controller=None) -> Iterator[Any]:
    """THE superbatch drive loop: pack K windows per group through the
    stream's packer, prefetch ahead, and hand each group to the
    workload's declared fold."""
    if controller is not None:
        raise NotImplementedError(
            "an adaptive-K controller is ported in ROADMAP Queue 1, slice 7b "
            "(control and ingest)"
        )
    from ..core.pipeline import prefetch
    from ..core.window import iter_superbatches

    groups = prefetch(iter_superbatches(stream, k), prefetch_groups,
                      device=getattr(stream, "device", None))
    workload._gf_folded = 0
    try:
        for group in groups:
            workload._gf_folded += len(group)
            if workload.group_supported(group):
                yield from workload.fold_group(group)
            else:
                yield from workload.fold_group_fallback(group)
    finally:
        workload._gf_folded = None


def group_edge_count(group) -> int:
    """Total edges of a packed group: exact from the host column views, the
    padded block capacities (an upper bound) for device-only members."""
    if group.cols is not None:
        return int(sum(len(c[0]) for c in group.cols))
    blocks = getattr(group, "_blocks", None)
    if blocks:
        return int(sum(int(b.capacity) for b in blocks))
    return 0


def verify_group_fold(
    make_workload: Callable[[int], Any],
    make_stream: Callable[[], Any],
    k: int,
    *,
    normalize: Callable[[Any], Any] = str,
    run: Optional[Callable[[Any, Any], Iterator[Any]]] = None,
) -> list:
    """Conformance check: the grouped run must be emission for emission
    value-identical to the per-window run. ``make_workload(superbatch)``
    builds a fresh workload, ``make_stream()`` a fresh stream;
    ``normalize`` maps an emission to a comparable value. Raises
    AssertionError naming the first diverging window; returns the
    normalized per-window sequence."""
    drive = run if run is not None else (lambda w, s: w.run(s))
    base = [normalize(e) for e in drive(make_workload(1), make_stream())]
    got = [normalize(e) for e in drive(make_workload(k), make_stream())]
    if len(got) != len(base):
        raise AssertionError(
            f"group fold (k={k}) yielded {len(got)} emissions, "
            f"per-window yielded {len(base)}"
        )
    for i, (a, b) in enumerate(zip(base, got)):
        if not _values_equal(a, b):
            raise AssertionError(
                f"group fold (k={k}) diverges at window {i}: "
                f"per-window {a!r} != grouped {b!r}"
            )
    return base


def _values_equal(a, b) -> bool:
    import numpy as np

    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return bool(np.array_equal(np.asarray(a), np.asarray(b)))
    return a == b
