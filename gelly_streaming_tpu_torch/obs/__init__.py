"""Observability of the PyTorch port: the metric registry, the host-side
pipeline spans, the exporters (the JSONL event log, ``replay``, the
Prometheus text), the cluster plane (per-shard event shipping merged into
one registry), the crash flight recorder and the causal timeline
(``python -m gelly_streaming_tpu_torch.obs.timeline <dir>``), the
cross-process ``TraceContext`` and the scrape endpoint
(:class:`MetricsEndpoint`: ``/metrics``, ``/healthz``, ``/events``)."""

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
from .trace import (
    NOOP_SPAN,
    Span,
    TraceContext,
    activate,
    current_context,
    current_span,
    disable,
    enable,
    enabled,
    new_trace_id,
    next_sid,
    on,
    record_span,
    span,
)
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


def __getattr__(name: str):
    # MetricsEndpoint is lazy: hot-path modules import this package for
    # get_registry/trace, and the endpoint's http.server chain is startup
    # cost no run pays for a scrape surface it never starts
    if name == "MetricsEndpoint":
        from .endpoint import MetricsEndpoint

        return MetricsEndpoint
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


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
    "MetricsEndpoint",
    "ShardSink",
    "Span",
    "TraceContext",
    "activate",
    "attach_sink",
    "current_context",
    "current_span",
    "detach_sink",
    "disable",
    "enable",
    "enabled",
    "format_key",
    "get_registry",
    "iter_shard_events",
    "iter_trace_events",
    "nearest_rank",
    "new_trace_id",
    "next_sid",
    "on",
    "prometheus_text",
    "read_dump",
    "read_jsonl",
    "record_span",
    "replay",
    "reset",
    "set_registry",
    "shard_events_path",
    "snapshot_stream",
    "span",
    "write_jsonl",
]
