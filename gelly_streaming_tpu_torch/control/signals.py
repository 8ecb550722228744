"""SignalReader: THE retune-signal implementation (the port's copy of
``gelly_streaming_tpu/control/signals.py``).

Every loop the package closes (checkpoint cadence, ``AutoCheckpoint(
every="auto")``; superbatch sizing, ``superbatch="auto"``; prefetch depth)
tunes from the same two kinds of evidence:

1. **Direct taps**: stopwatch samples the tuned code path measures itself
   (one clock subtraction per barrier or group, never per edge). They work
   with observability DISABLED: a loop must keep tuning in runs that pay
   nothing for obs, so its primary signals cannot live behind the obs gate.
2. **Windowed registry deltas**: counters and the
   ``trace.span_seconds{span=...}`` histograms of the
   :class:`~gelly_streaming_tpu_torch.obs.registry.MetricRegistry`.
   Instruments are lifetime-cumulative; a retune decision needs "since my
   last decision", so the reader keeps per-name marks and hands back
   deltas. These reads gate on the trace flag: with obs off they return
   zeros without touching the registry. (The port's spans are not
   mirrored into ``trace.span_seconds`` until the serving slice brings the
   mirror, ROADMAP Queue 1, slice 9; until then only what a caller records
   there directly is read.)
"""

from __future__ import annotations

import threading
from typing import Dict, Optional, Tuple

from ..obs import trace as _trace
from ..obs.registry import get_registry

#: shared empty delta: the disabled-obs path hands this back
_ZERO: Tuple[float, float] = (0.0, 0.0)

#: per-thread seconds a throughput measurement should NOT charge to the
#: measured pipeline (see add_excluded_s)
_EXCLUDED = threading.local()


def add_excluded_s(dt: float) -> None:
    """Credit ``dt`` seconds of FOREIGN work to this thread's running
    exclusion budget. A throughput tap that wraps consumer-side processing
    would otherwise charge a rare out-of-band stall (a checkpoint barrier's
    state capture + serialize) to the group it landed in. The code that
    KNOWS the stall is foreign (``AutoCheckpoint._snapshot``) credits it
    here; the tap subtracts it via :func:`take_excluded_s`. Thread-local
    because the barrier and the drive loop run on the same consumer
    thread."""
    _EXCLUDED.s = getattr(_EXCLUDED, "s", 0.0) + float(dt)


def take_excluded_s() -> float:
    """Drain this thread's exclusion budget (0.0 when none accrued)."""
    s = getattr(_EXCLUDED, "s", 0.0)
    if s:
        _EXCLUDED.s = 0.0
    return s


class SignalReader:
    """Windowed retune signals: direct taps + registry deltas.

    Direct taps (:meth:`observe`) are always live; registry reads
    (:meth:`counter_delta` / :meth:`span_delta`) return zeros with obs
    disabled. Not thread-safe by design: each closed loop owns one and
    reads it from its own decision point."""

    def __init__(self, registry=None):
        # None = resolve the process registry at read time (tests swap it
        # via set_registry; a cached handle would pin the old one)
        self._registry = registry
        #: name -> [count, total, last] direct samples (lifetime)
        self._direct: Dict[str, list] = {}
        #: registry key -> (count, sum) at the previous delta read
        self._marks: Dict[str, Tuple[float, float]] = {}

    # -- direct taps (obs-independent) --------------------------------- #
    def observe(self, name: str, value: float) -> None:
        """Record one direct sample (seconds, edges, ...): a dict probe and
        two adds, cheap enough for cadence-rate call sites."""
        cell = self._direct.get(name)
        if cell is None:
            cell = self._direct[name] = [0, 0.0, 0.0]
        cell[0] += 1
        cell[1] += value
        cell[2] = value

    def last(self, name: str) -> Optional[float]:
        """The most recent direct sample (None before the first)."""
        cell = self._direct.get(name)
        return None if cell is None else cell[2]

    def total(self, name: str) -> Tuple[int, float]:
        """Lifetime ``(count, sum)`` of a direct tap."""
        cell = self._direct.get(name)
        return (0, 0.0) if cell is None else (cell[0], cell[1])

    # -- registry deltas (gated on obs) -------------------------------- #
    def _reg(self):
        return self._registry if self._registry is not None else get_registry()

    def counter_delta(self, name: str) -> float:
        """Sum of ``name`` counters (all label sets) accrued since the
        previous call for this name; 0.0 with obs disabled."""
        if not _trace.on():
            return 0.0
        total = 0.0
        for _labels, inst in self._reg().find(name):
            total += inst.value
        prev = self._marks.get(name, _ZERO)[1]
        self._marks[name] = (0.0, total)
        return total - prev

    def span_delta(self, span_name: str) -> Tuple[float, float]:
        """``(count, seconds)`` accrued in the
        ``trace.span_seconds{span=span_name}`` histogram since the previous
        call; ``(0, 0)`` with obs disabled."""
        if not _trace.on():
            return _ZERO
        key = "span:" + span_name
        count = 0.0
        total = 0.0
        for labels, inst in self._reg().find("trace.span_seconds"):
            if labels.get("span") == span_name:
                count += inst.count
                total += inst.sum
        prev = self._marks.get(key, _ZERO)
        self._marks[key] = (count, total)
        return count - prev[0], total - prev[1]
