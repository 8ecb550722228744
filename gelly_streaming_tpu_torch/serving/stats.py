"""Serving metrics: per-query-class latency + staleness, as plain dicts
(the port's copy of ``gelly_streaming_tpu/serving/stats.py``).

The reference's design stance is that metrics are ordinary output
streams (``utils/profiling.py`` docstring); the serving tier keeps it:
no metrics server — :meth:`ServingStats.snapshot` returns a plain dict
and :meth:`ServingStats.stream` yields those dicts like any other
emission iterator. The class is a VIEW over a
:class:`~gelly_streaming_tpu_torch.obs.registry.MetricRegistry` :
the same counters/histograms surface through the
obs exporters (Prometheus text, JSONL event log), and a recorded event
log replays to an identical snapshot
(:func:`~gelly_streaming_tpu_torch.obs.export.replay` +
:meth:`ServingStats.from_events` — the serving bench's honesty check).

Each ``ServingStats`` owns a PRIVATE registry by default so two servers
in one process never blend their counts; pass ``registry=`` to share or
to wrap a replayed one. Percentiles are the repo-wide nearest-rank rule
(:func:`~gelly_streaming_tpu_torch.obs.registry.nearest_rank`) over a bounded
recent sample window (``MAX_SAMPLES``, drop-oldest-half — a long-lived
server must not grow a list per query forever); counts and staleness
sum/max stay exact over the full lifetime.
"""

from __future__ import annotations

from typing import Iterable, Iterator, Optional

from ..obs.registry import MetricRegistry


class ServingStats:
    """Per-query-class latency histograms + staleness gauges, backed by
    a metric registry. Thread-safe: the query worker records, any
    thread reads (instrument-level locks; snapshot sorts copies outside
    them, so reading percentiles never stalls ``record``)."""

    #: per-class latency sample cap (drop-oldest-half on overflow)
    MAX_SAMPLES = 1 << 16

    def __init__(self, registry: Optional[MetricRegistry] = None):
        self.registry = registry if registry is not None else MetricRegistry()
        self._rejected = self.registry.counter("serving.rejected")
        self._batches = self.registry.counter("serving.batches")

    # -- write side (query worker / server) ----------------------------- #
    def record(self, qclass: str, seconds: float, staleness: int,
               exemplar: Optional[str] = None) -> None:
        """One answered query: wall seconds from submit to answer, and
        the answer's windows-behind-head staleness. ``exemplar`` (a
        trace id, passed only when tracing is on) links the latency
        histogram's tail to a concrete trace — see
        :meth:`~gelly_streaming_tpu_torch.obs.registry.Histogram.observe`."""
        self.registry.histogram(
            "serving.query_seconds", max_samples=self.MAX_SAMPLES,
            cls=qclass,
        ).observe(seconds, exemplar=exemplar)
        self.registry.histogram(
            "serving.staleness_windows", max_samples=self.MAX_SAMPLES,
            cls=qclass,
        ).observe(staleness)

    def record_batch(self) -> None:
        self._batches.inc()

    def record_rejected(self) -> None:
        self._rejected.inc()

    def set_pending(self, n: int) -> None:
        """Admission gauge: queries admitted but not yet answered."""
        self.registry.gauge("serving.pending").set(n)

    def record_drain(self, batch_size: int) -> None:
        """One worker sweep: how many pending queries coalesced into a
        single vectorized answer batch."""
        self.registry.histogram(
            "serving.batch_size", max_samples=self.MAX_SAMPLES
        ).observe(batch_size)

    # -- event-log plumbing --------------------------------------------- #
    def attach_sink(self, sink) -> None:
        """Mirror every stat mutation to ``sink.emit(event)`` (a
        :class:`~gelly_streaming_tpu_torch.obs.export.JsonlSink` makes the
        stats replayable from their own log)."""
        self.registry.add_sink(sink)

    def detach_sink(self, sink) -> None:
        self.registry.remove_sink(sink)

    @classmethod
    def from_events(cls, events: Iterable[dict]) -> "ServingStats":
        """Rebuild stats from a recorded event log (see
        :func:`~gelly_streaming_tpu_torch.obs.export.replay`); the returned
        view's :meth:`snapshot` equals the live run's."""
        from ..obs.export import replay

        return cls(registry=replay(events))

    # -- read side ------------------------------------------------------ #
    def snapshot(self) -> dict:
        """Plain-dict gauge/histogram export::

            {"rejected": 0, "batches": 12,
             "queries": {"ConnectedQuery": {
                 "count": 10000, "p50_ms": 0.8, "p99_ms": 3.1,
                 "staleness_mean": 0.2, "staleness_max": 2}}}
        """
        out = {
            "rejected": int(self._rejected.value),
            "batches": int(self._batches.value),
            "queries": {},
        }
        for labels, lat in self.registry.find("serving.query_seconds"):
            qclass = labels["cls"]
            stal = self.registry.histogram(
                "serving.staleness_windows", max_samples=self.MAX_SAMPLES,
                cls=qclass,
            )
            n = lat.count
            out["queries"][qclass] = {
                "count": n,
                "p50_ms": lat.percentile(50) * 1e3,
                "p99_ms": lat.percentile(99) * 1e3,
                "staleness_mean": stal.sum / n if n else 0.0,
                "staleness_max": int(stal.max),
            }
        return out

    def stream(self) -> Iterator[dict]:
        """Unbounded metrics stream: each ``next()`` yields the current
        snapshot dict (pull-based, like any other emission iterator)."""
        while True:
            yield self.snapshot()
