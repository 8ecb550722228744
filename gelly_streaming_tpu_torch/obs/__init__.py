"""Observability of the PyTorch port: the metric registry and the
host-side pipeline spans."""

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

__all__ = [
    "NOOP_SPAN",
    "Counter",
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
    "set_registry",
    "span",
]
