"""Observability of the PyTorch port: the metric registry, the host-side
pipeline spans, the exporters (the JSONL event log, ``replay``, the
Prometheus text), the cluster plane (per-shard event shipping merged into
one registry), the crash flight recorder and the causal timeline
(``python -m gelly_streaming_tpu_torch.obs.timeline <dir>``).

The cross-process ``TraceContext``, the registry mirror of spans and the
scrape endpoint come with ROADMAP Queue 1, slice 9 (serving)."""

from .registry import (
    Counter,
    Gauge,
    Histogram,
    MetricRegistry,
    format_key,
    get_registry,
    nearest_rank,
    set_registry,
)
from .trace import NOOP_SPAN, Span, disable, enable, on, span
from . import trace as _trace
from .export import (
    JsonlSink,
    prometheus_text,
    read_jsonl,
    replay,
    snapshot_stream,
    write_jsonl,
)
from .cluster import (
    ClusterAggregator,
    ShardSink,
    iter_shard_events,
    iter_trace_events,
    shard_events_path,
)
from .flight import FlightRecorder, read_dump
from . import flight as _flight


def attach_sink(sink) -> None:
    """Attach one sink to BOTH event sources: finished spans (tracer) and
    metric mutations (the global registry)."""
    _trace.add_sink(sink)
    get_registry().add_sink(sink)


def detach_sink(sink) -> None:
    _trace.remove_sink(sink)
    get_registry().remove_sink(sink)


def reset() -> None:
    """Test and run hygiene: disable tracing, drop all tracer sinks,
    uninstall any flight recorder, and install a fresh global registry."""
    disable()
    _flight.uninstall()
    for s in list(_trace._SINKS):
        _trace.remove_sink(s)
    set_registry(None)


__all__ = [
    "NOOP_SPAN",
    "ClusterAggregator",
    "Counter",
    "FlightRecorder",
    "Gauge",
    "Histogram",
    "JsonlSink",
    "MetricRegistry",
    "ShardSink",
    "Span",
    "attach_sink",
    "detach_sink",
    "disable",
    "enable",
    "format_key",
    "get_registry",
    "iter_shard_events",
    "iter_trace_events",
    "nearest_rank",
    "on",
    "prometheus_text",
    "read_dump",
    "read_jsonl",
    "replay",
    "reset",
    "set_registry",
    "shard_events_path",
    "snapshot_stream",
    "span",
    "write_jsonl",
]
