"""Event-time windowing + retraction: graphs that forget (the port's copy
of ``gelly_streaming_tpu/eventtime/``).

Records carry their OWN clock (an i64 ``ts`` column), progress is a
WATERMARK merged across shards by the min rule, and a SLIDING window
retracts the pane that ages out: results stay correct on the surviving
edge multiset, not on the union of everything ever seen.

- :mod:`.watermark`: per-shard watermarks and the min-merge rule.
- :mod:`.panes`: the pane decomposition; the assembler closes panes as
  the watermark passes them and drops records later than the lateness
  bound as counted ``eventtime.late_dropped``. Closed panes are raw-id
  column tuples, so they pack like count windows through
  :meth:`~gelly_streaming_tpu_torch.core.window.Windower.pack_window_cols`
  and the superbatch/group-fold path on the card consumes them unchanged.
- :mod:`.retract`: the decremental summaries (degrees and heavy hitters,
  CC by forest repair, bipartiteness with the latch re-resolved on
  expiry), each with its from-scratch oracle. Host numpy, as in the
  reference.
- :mod:`.stream`: :class:`SlidingGraphAggregator`, close -> retract ->
  fold -> commit -> emit, with atomic checksummed commits between panes.
"""

from .panes import EventTimeSlidingWindow, Pane, PaneAssembler
from .retract import (
    DecBipartite,
    DecDegree,
    DecForest,
    oracle_bipartite,
    oracle_degrees,
    oracle_labels,
)
from .stream import SlidingGraphAggregator, WindowResult, drive_sliding
from .watermark import NO_WATERMARK, WatermarkTracker, merge_watermarks

__all__ = [
    "EventTimeSlidingWindow",
    "Pane",
    "PaneAssembler",
    "DecBipartite",
    "DecDegree",
    "DecForest",
    "oracle_bipartite",
    "oracle_degrees",
    "oracle_labels",
    "SlidingGraphAggregator",
    "WindowResult",
    "drive_sliding",
    "NO_WATERMARK",
    "WatermarkTracker",
    "merge_watermarks",
]
