"""Process-wide metric registry: counters, gauges, bounded histograms.

The port's copy of ``gelly_streaming_tpu/obs/registry.py`` (host-only).

The reference's design stance is that metrics are ordinary output
streams (``README.md:26-32``; ``utils/profiling.py`` docstring); this
registry keeps it. Instruments are plain mutable cells — there is no
metrics server, no pull endpoint, no wire protocol. Everything an
instrument does is observable two ways, both streams:

- :meth:`MetricRegistry.snapshot` returns a plain dict (compose it with
  any emission iterator via ``obs/export.py:snapshot_stream``);
- every mutation can be mirrored to attached sinks as one event dict
  (:meth:`MetricRegistry.add_sink`), which makes the registry itself
  REPLAYABLE: feeding the event log back through
  ``obs/export.py:replay`` reconstructs an
  identical registry — the property the serving bench's honesty check
  relies on (a reported p99 must be reproducible from its own log).

Thread-safety: instrument creation is serialized by the registry lock;
each instrument carries its own lock so hot-path mutations on different
instruments never contend. Event emission happens INSIDE the instrument
lock, so the event log's order equals the mutation order per instrument
and replay is deterministic (the histogram's bounded-sample eviction is
a pure function of the observation sequence).

:func:`nearest_rank` is THE percentile rule for the repo — the one
previously duplicated between ``StreamProfiler.latency_percentile`` and
``serving/stats._pct``; both now call here.
"""

from __future__ import annotations

import threading
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

#: default bounded-histogram sample cap (drop-oldest-half on overflow),
#: matching the serving tier's historical ``ServingStats.MAX_SAMPLES``
DEFAULT_MAX_SAMPLES = 1 << 16

#: percentiles rendered into snapshots / Prometheus summaries
SNAPSHOT_QUANTILES = (50.0, 90.0, 95.0, 99.0)


def nearest_rank(sorted_xs: Sequence[float], q: float) -> float:
    """Nearest-rank percentile over an ALREADY-SORTED sample sequence.

    ``q`` in [0, 100]; empty input returns 0.0. This is the single
    shared implementation of the rule both the window profiler and the
    serving stats used to carry privately: index ``round(q/100*(n-1))``,
    clamped to the valid range.
    """
    n = len(sorted_xs)
    if not n:
        return 0.0
    k = min(n - 1, max(0, int(round(q / 100 * (n - 1)))))
    return sorted_xs[k]


def _label_key(labels: dict) -> tuple:
    return tuple(sorted(labels.items()))


def format_key(name: str, labels: dict) -> str:
    """Stable string form for snapshot keys: ``name`` or
    ``name{k=v,...}`` with labels sorted."""
    if not labels:
        return name
    inner = ",".join(f"{k}={v}" for k, v in sorted(labels.items()))
    return f"{name}{{{inner}}}"


class _Instrument:
    """Shared shape: name + labels + own lock + emitting registry."""

    __slots__ = ("name", "labels", "_lock", "_registry")
    kind = "instrument"

    def __init__(self, name: str, labels: dict, registry: "MetricRegistry"):
        self.name = name
        self.labels = labels
        self._lock = threading.Lock()
        self._registry = registry

    def key(self) -> str:
        return format_key(self.name, self.labels)


class Counter(_Instrument):
    """Monotonically-increasing value (float increments allowed, so a
    counter can accumulate seconds as naturally as event counts)."""

    __slots__ = ("value",)
    kind = "counter"

    def __init__(self, name, labels, registry):
        super().__init__(name, labels, registry)
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self.value += n
            self._registry._emit(self, n)


class Gauge(_Instrument):
    """Last-write-wins value (queue depth, pending admissions, ...)."""

    __slots__ = ("value",)
    kind = "gauge"

    def __init__(self, name, labels, registry):
        super().__init__(name, labels, registry)
        self.value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self.value = float(v)
            self._registry._emit(self, self.value)

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self.value += n
            self._registry._emit(self, self.value)


class Histogram(_Instrument):
    """Bounded-sample histogram with exact lifetime count/sum/min/max.

    Samples are capped at ``max_samples``; on overflow the OLDEST HALF
    drops (the historical ``ServingStats`` policy), so percentiles
    describe the recent window while count/sum/min/max stay exact over
    the full lifetime. Eviction is deterministic in the observation
    sequence — replaying the same observations reconstructs the same
    sample list, hence identical percentiles.

    EXEMPLARS: ``observe(v, exemplar=trace_id)`` attaches a
    trace id to the observation; the histogram keeps the
    :data:`MAX_EXEMPLARS` LARGEST exemplar-carrying observations, so a
    p99 bucket in a latency histogram links to a concrete trace a human
    can pull up with ``obs.timeline --trace <id>``. Selection is
    deterministic in the observation sequence (stable sort, first-seen
    wins ties), so replay reconstructs identical exemplars.
    """

    #: how many largest exemplar-carrying observations are retained
    MAX_EXEMPLARS = 4

    __slots__ = ("max_samples", "count", "sum", "min", "max", "_samples",
                 "_exemplars")
    kind = "hist"

    def __init__(self, name, labels, registry,
                 max_samples: int = DEFAULT_MAX_SAMPLES):
        super().__init__(name, labels, registry)
        self.max_samples = int(max_samples)
        self.count = 0
        self.sum = 0.0
        self.min = 0.0
        self.max = 0.0
        self._samples: List[float] = []
        self._exemplars: List[Tuple[float, str]] = []

    def observe(self, v: float, exemplar: Optional[str] = None) -> None:
        v = float(v)
        with self._lock:
            if len(self._samples) >= self.max_samples:
                del self._samples[: self.max_samples // 2]
            self._samples.append(v)
            if self.count == 0:
                self.min = self.max = v
            else:
                if v < self.min:
                    self.min = v
                if v > self.max:
                    self.max = v
            self.count += 1
            self.sum += v
            if exemplar is not None:
                ex = self._exemplars
                ex.append((v, str(exemplar)))
                # stable sort, largest first: equal values keep their
                # arrival order, so eviction is a pure function of the
                # observation sequence (the replay-identity contract)
                ex.sort(key=lambda p: -p[0])
                del ex[self.MAX_EXEMPLARS:]
            self._registry._emit(self, v, ex=exemplar)

    def exemplars(self) -> List[Tuple[float, str]]:
        """``(value, trace_id)`` pairs for the largest exemplar-carrying
        observations, largest first (copy, taken under the lock)."""
        with self._lock:
            return list(self._exemplars)

    def samples(self) -> List[float]:
        """Copy of the bounded sample window (taken under the lock)."""
        with self._lock:
            return list(self._samples)

    def percentile(self, q: float) -> float:
        """Nearest-rank percentile over the bounded sample window. The
        sort happens OUTSIDE the lock on a copy — percentile reads must
        never stall a hot-path ``observe`` (the serving tier's tail
        latency must not be injected by the act of measuring it)."""
        xs = self.samples()
        xs.sort()
        return nearest_rank(xs, q)

    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0


class MetricRegistry:
    """Get-or-create instrument store. One process-wide default lives in
    this module (:func:`get_registry`); private registries are cheap and
    used where isolation matters (each ``ServingStats`` owns one so two
    servers never blend their counts)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[Tuple[str, tuple], _Instrument] = {}
        self._sinks: list = []

    # -- instrument access --------------------------------------------- #
    def _get(self, cls, name: str, labels: dict, **kw) -> _Instrument:
        key = (name, _label_key(labels))
        m = self._metrics.get(key)
        if m is not None:
            if not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as {m.kind}, "
                    f"requested {cls.kind}"
                )
            return m
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                m = self._metrics[key] = cls(name, labels, self, **kw)
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as {m.kind}, "
                    f"requested {cls.kind}"
                )
            return m

    def counter(self, name: str, **labels) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(self, name: str,
                  max_samples: int = DEFAULT_MAX_SAMPLES,
                  **labels) -> Histogram:
        return self._get(Histogram, name, labels, max_samples=max_samples)

    def find(self, name: str) -> List[Tuple[dict, _Instrument]]:
        """All ``(labels, instrument)`` pairs registered under ``name``,
        label-sorted (stable iteration for snapshot/export)."""
        with self._lock:
            hits = [
                (dict(lk), m)
                for (n, lk), m in self._metrics.items()
                if n == name
            ]
        hits.sort(key=lambda p: _label_key(p[0]))
        return hits

    def instruments(self) -> List[_Instrument]:
        with self._lock:
            ms = list(self._metrics.values())
        ms.sort(key=lambda m: (m.name, _label_key(m.labels)))
        return ms

    # -- event mirroring ----------------------------------------------- #
    def add_sink(self, sink) -> None:
        """Mirror every mutation to ``sink.emit(event_dict)``. With no
        sinks attached (the default) mutation cost is the instrument
        lock + one arithmetic op — nothing is allocated per event."""
        with self._lock:
            if sink not in self._sinks:
                self._sinks.append(sink)

    def remove_sink(self, sink) -> None:
        with self._lock:
            if sink in self._sinks:
                self._sinks.remove(sink)

    def _emit(self, instrument: _Instrument, value: float,
              ex: Optional[str] = None) -> None:
        if not self._sinks:
            return
        event = {
            "kind": instrument.kind,
            "name": instrument.name,
            "v": value,
        }
        if instrument.labels:
            event["labels"] = instrument.labels
        if (instrument.kind == "hist"
                and instrument.max_samples != DEFAULT_MAX_SAMPLES):
            event["max_samples"] = instrument.max_samples
        if ex is not None:
            # the exemplar trace id rides the event, so replay()
            # reconstructs identical exemplar state from the log
            event["ex"] = ex
        for s in self._sinks:
            s.emit(event)

    # -- read side ------------------------------------------------------ #
    def snapshot(self) -> dict:
        """Plain-dict export of every instrument::

            {"counters": {...}, "gauges": {...},
             "histograms": {key: {"count", "sum", "min", "max", "mean",
                                  "p50", "p90", "p95", "p99"}}}
        """
        out = {"counters": {}, "gauges": {}, "histograms": {}}
        for m in self.instruments():
            if isinstance(m, Counter):
                out["counters"][m.key()] = m.value
            elif isinstance(m, Gauge):
                out["gauges"][m.key()] = m.value
            else:
                xs = m.samples()
                xs.sort()
                doc = {
                    "count": m.count,
                    "sum": m.sum,
                    "min": m.min,
                    "max": m.max,
                    "mean": m.mean(),
                    **{
                        f"p{q:g}": nearest_rank(xs, q)
                        for q in SNAPSHOT_QUANTILES
                    },
                }
                exemplars = m.exemplars()
                if exemplars:
                    doc["exemplars"] = [
                        {"v": v, "trace": t} for v, t in exemplars
                    ]
                out["histograms"][m.key()] = doc
        return out

    def stream(self) -> Iterator[dict]:
        """Unbounded snapshot stream (pull-based, like every emission
        iterator in this repo): each ``next()`` yields :meth:`snapshot`."""
        while True:
            yield self.snapshot()


_GLOBAL = MetricRegistry()
_GLOBAL_LOCK = threading.Lock()


def get_registry() -> MetricRegistry:
    """The process-wide registry framework instrumentation writes to."""
    return _GLOBAL


def set_registry(registry: Optional[MetricRegistry]) -> MetricRegistry:
    """Swap the process-wide registry (None installs a fresh one);
    returns the registry now installed. Tests use this to isolate."""
    global _GLOBAL
    with _GLOBAL_LOCK:
        _GLOBAL = registry if registry is not None else MetricRegistry()
        return _GLOBAL
