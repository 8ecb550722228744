"""Watermarks: event-time progress, tracked per shard, merged by min (the
port's copy of ``gelly_streaming_tpu/eventtime/watermark.py``).

A watermark is a PROMISE about the past: "no record with ``ts`` below this
value will arrive on this stream again" (modulo the lateness allowance,
which the pane assembler enforces as a counted drop, never a silent
absorb). Each shard's watermark advances to the maximum timestamp it has
observed; the per-shard arrival order is preserved, so within one shard
the max IS the promise. Across shards nothing orders arrivals, so the
merged watermark is the MINIMUM over shards: one slow shard holds the
whole stream's clock back, which makes pane closes safe (Flink's
``StatusWatermarkValve`` rule).

A shard that has observed no timestamped record yet reports
:data:`NO_WATERMARK` (i64 min), which the min-merge propagates. Sources
that END leave the merge (a closed shard can hold nothing back).
"""

from __future__ import annotations

from typing import Iterable, List

import numpy as np

from ..obs.registry import get_registry

#: "no event-time progress yet": below every real i64 timestamp
NO_WATERMARK = int(np.iinfo(np.int64).min)


def merge_watermarks(marks: Iterable[int]) -> int:
    """THE cross-shard merge rule: the minimum over per-shard watermarks
    (an empty collection, every shard ended, merges to i64 max: nothing
    can be held back). One shard at :data:`NO_WATERMARK` pins the merge
    there."""
    marks = list(marks)
    if not marks:
        return int(np.iinfo(np.int64).max)
    return min(int(m) for m in marks)


class WatermarkTracker:
    """Per-shard watermark registry + the merged min (the one clock the
    pane assembler trusts).

    ``observe(shard, ts)`` advances that shard's watermark to the max
    timestamp in the column (monotone: a late record never moves one
    backwards); ``finish(shard)`` removes an ENDED shard from the merge;
    ``current()`` is the min-merge over live shards. Every merged advance
    is counted (``eventtime.watermark_advance``) and the merged value is
    published as the ``eventtime.watermark`` gauge.
    """

    def __init__(self, nshards: int = 1):
        if nshards < 1:
            raise ValueError(f"nshards must be >= 1, got {nshards}")
        self._marks: List[int] = [NO_WATERMARK] * int(nshards)
        self._live = [True] * int(nshards)
        self._merged = NO_WATERMARK
        self._advance = None  # lazy counter (the registry may be swapped)
        self._gauge = None

    @property
    def nshards(self) -> int:
        return len(self._marks)

    def shard_watermarks(self) -> List[int]:
        return list(self._marks)

    def observe(self, shard: int, ts) -> int:
        """Advance ``shard``'s watermark to the max of ``ts`` (a column or
        a scalar); returns the merged watermark after the advance."""
        ts = np.asarray(ts, np.int64)
        if ts.size:
            hi = int(ts.max())
            if hi > self._marks[shard]:
                self._marks[shard] = hi
        return self._remerge()

    def finish(self, shard: int) -> int:
        """An ENDED shard stops holding the clock back."""
        self._live[shard] = False
        return self._remerge()

    def current(self) -> int:
        return self._merged

    def _remerge(self) -> int:
        merged = merge_watermarks(
            m for m, live in zip(self._marks, self._live) if live
        )
        if merged > self._merged:
            self._merged = merged
            if self._advance is None:
                self._advance = get_registry().counter(
                    "eventtime.watermark_advance"
                )
                self._gauge = get_registry().gauge("eventtime.watermark")
            self._advance.inc()
            self._gauge.set(float(merged))
        return self._merged

    # ------------------------------------------------------------------ #
    # Checkpoint surface (the aggregator commits between panes)
    # ------------------------------------------------------------------ #
    def state_dict(self) -> dict:
        return {
            "marks": list(self._marks),
            "live": list(self._live),
            "merged": int(self._merged),
        }

    def load_state_dict(self, state: dict) -> None:
        self._marks = [int(m) for m in state["marks"]]
        self._live = [bool(x) for x in state["live"]]
        self._merged = int(state["merged"])

    def __repr__(self) -> str:
        return (
            f"WatermarkTracker(merged={self._merged}, "
            f"marks={self._marks})"
        )
