"""Observability of the PyTorch port: the metric registry, the
host-side pipeline spans and the crash flight recorder."""

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
from .flight import FlightRecorder, read_dump

__all__ = [
    "NOOP_SPAN",
    "Counter",
    "FlightRecorder",
    "Gauge",
    "Histogram",
    "MetricRegistry",
    "Span",
    "disable",
    "enable",
    "format_key",
    "get_registry",
    "nearest_rank",
    "on",
    "read_dump",
    "set_registry",
    "span",
]
