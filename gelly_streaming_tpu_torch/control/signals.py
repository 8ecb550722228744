"""SignalReader: the retune-signal taps (the port's copy of the part of
``gelly_streaming_tpu/control/signals.py`` that the checkpoint cadence
uses; the registry-delta reads and the controllers that consume them come
with ROADMAP Queue 1, slice 7b).

A closed loop (``AutoCheckpoint(every="auto")`` here) tunes from **direct
taps**: stopwatch samples the tuned code path measures itself, one
``perf_counter`` subtraction per barrier — cadence-rate, never per-edge.
They work with observability DISABLED: a loop must keep tuning in runs
that pay nothing for obs, so its signals cannot live behind the obs gate.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional, Tuple

#: per-thread seconds a throughput measurement should NOT charge to the
#: measured pipeline (see add_excluded_s)
_EXCLUDED = threading.local()


def add_excluded_s(dt: float) -> None:
    """Credit ``dt`` seconds of FOREIGN work to this thread's running
    exclusion budget. A throughput tap that wraps consumer-side processing
    would otherwise charge a rare out-of-band stall — a checkpoint
    barrier's state capture + serialize — to the group it landed in. The
    code that KNOWS the stall is foreign (``AutoCheckpoint._snapshot``)
    credits it here; the tap subtracts it via :func:`take_excluded_s`.
    Thread-local because the barrier and the drive loop run on the same
    consumer thread."""
    _EXCLUDED.s = getattr(_EXCLUDED, "s", 0.0) + float(dt)


def take_excluded_s() -> float:
    """Drain this thread's exclusion budget (0.0 when none accrued)."""
    s = getattr(_EXCLUDED, "s", 0.0)
    if s:
        _EXCLUDED.s = 0.0
    return s


class SignalReader:
    """Direct retune taps by name. Not thread-safe by design: each closed
    loop owns one and reads it from its own decision point."""

    def __init__(self):
        #: name -> [count, total, last] direct samples (lifetime)
        self._direct: Dict[str, list] = {}

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
