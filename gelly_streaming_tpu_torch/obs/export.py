"""Exporters that keep metrics as streams (the port's copy of
``gelly_streaming_tpu/obs/export.py``; the event logs of both packages
replay in either).

Three surfaces, all derived from the same event/registry state:

- :class:`JsonlSink` + :func:`read_jsonl` — an append-only JSONL event
  log. Attached to a registry (and/or the tracer) it records every
  metric mutation and finished span; :func:`replay` feeds the metric
  events back through a fresh :class:`~gelly_streaming_tpu_torch.obs.registry.MetricRegistry`
  and reconstructs IDENTICAL state (bounded-histogram eviction is
  deterministic in the observation sequence), which is how run
  artifacts prove their reported stats match their own logs.
- :func:`prometheus_text` — the standard text exposition format
  (counters, gauges, histogram summaries with nearest-rank quantiles),
  for anyone pointing a scraper at a file or a debug endpoint. It is a
  RENDERER only; no server ships here.
- :func:`snapshot_stream` — composes a periodic registry snapshot onto
  any emission iterator: yields ``(item, snapshot_or_None)`` pairs with
  a snapshot every ``every`` items, so a metrics stream rides along any
  per-window result stream exactly like the profiler's ``profiled()``.
"""

from __future__ import annotations

import json
import threading
from typing import Any, Iterable, Iterator, List, Optional, Tuple

from .registry import (
    DEFAULT_MAX_SAMPLES,
    MetricRegistry,
    SNAPSHOT_QUANTILES,
)


class JsonlSink:
    """In-memory event buffer with a JSONL writer.

    ``emit`` is what registries/tracers call per event: one lock + one
    list append — cheap enough to leave attached during measured runs
    (the overhead guard in ``tests/test_obs.py`` covers it). ``write``
    flushes the buffer to ``path`` (one JSON object per line).
    """

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self._lock = threading.Lock()
        self._events: List[dict] = []

    def emit(self, event: dict) -> None:
        with self._lock:
            self._events.append(event)

    @property
    def events(self) -> List[dict]:
        with self._lock:
            return list(self._events)

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)

    def clear(self) -> None:
        with self._lock:
            self._events.clear()

    def write(self, path: Optional[str] = None) -> str:
        """Flush buffered events to ``path`` (or the constructor path)."""
        out = path or self.path
        if out is None:
            raise ValueError("JsonlSink has no path; pass one to write()")
        events = self.events
        with open(out, "w") as f:
            for e in events:
                f.write(json.dumps(e) + "\n")
        return out


def write_jsonl(events: Iterable[dict], path: str) -> str:
    with open(path, "w") as f:
        for e in events:
            f.write(json.dumps(e) + "\n")
    return path


def read_jsonl(path: str) -> List[dict]:
    events = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                events.append(json.loads(line))
    return events


def replay(events: Iterable[dict],
           registry: Optional[MetricRegistry] = None) -> MetricRegistry:
    """Apply a metric event log to a (fresh by default) registry.

    Counter events re-increment, gauge events re-set, histogram events
    re-observe — in log order, so the bounded sample window (and hence
    every percentile) comes out identical to the live registry the log
    was recorded from. Span events and unknown kinds are skipped (they
    are evidence, not state).
    """
    reg = registry if registry is not None else MetricRegistry()
    for e in events:
        kind = e.get("kind")
        labels = e.get("labels") or {}
        if kind == "counter":
            reg.counter(e["name"], **labels).inc(e["v"])
        elif kind == "gauge":
            reg.gauge(e["name"], **labels).set(e["v"])
        elif kind == "hist":
            reg.histogram(
                e["name"],
                max_samples=e.get("max_samples", DEFAULT_MAX_SAMPLES),
                **labels,
            ).observe(e["v"], exemplar=e.get("ex"))
        # spans / meta: evidence only, not registry state
    return reg


# --------------------------------------------------------------------- #
# Prometheus text exposition
# --------------------------------------------------------------------- #
def _prom_name(name: str) -> str:
    out = []
    for ch in name:
        out.append(ch if ch.isalnum() or ch == "_" else "_")
    s = "".join(out)
    if s and s[0].isdigit():
        s = "_" + s
    return s


def _prom_labels(labels: dict, extra: Optional[dict] = None) -> str:
    items = dict(labels)
    if extra:
        items.update(extra)
    if not items:
        return ""
    inner = ",".join(
        f'{_prom_name(str(k))}="{v}"' for k, v in sorted(items.items())
    )
    return "{" + inner + "}"


def prometheus_text(registry: Optional[MetricRegistry] = None) -> str:
    """Render a registry in the Prometheus text exposition format.

    Counters/gauges map directly; histograms render as summaries —
    nearest-rank quantiles over the bounded sample window plus exact
    lifetime ``_sum``/``_count`` — because the bounded-sample design
    has true quantiles, not pre-binned buckets.
    """
    from .registry import get_registry, nearest_rank

    reg = registry if registry is not None else get_registry()
    lines: List[str] = []
    typed: set = set()
    for m in reg.instruments():
        pname = _prom_name(m.name)
        if m.kind == "counter":
            if pname not in typed:
                lines.append(f"# TYPE {pname} counter")
                typed.add(pname)
            lines.append(f"{pname}{_prom_labels(m.labels)} {m.value:g}")
        elif m.kind == "gauge":
            if pname not in typed:
                lines.append(f"# TYPE {pname} gauge")
                typed.add(pname)
            lines.append(f"{pname}{_prom_labels(m.labels)} {m.value:g}")
        else:
            if pname not in typed:
                lines.append(f"# TYPE {pname} summary")
                typed.add(pname)
            xs = m.samples()
            xs.sort()
            for q in SNAPSHOT_QUANTILES:
                ql = _prom_labels(m.labels, {"quantile": f"{q / 100:g}"})
                lines.append(f"{pname}{ql} {nearest_rank(xs, q):g}")
            lines.append(f"{pname}_sum{_prom_labels(m.labels)} {m.sum:g}")
            lines.append(
                f"{pname}_count{_prom_labels(m.labels)} {m.count}"
            )
    return "\n".join(lines) + ("\n" if lines else "")


# --------------------------------------------------------------------- #
# Periodic snapshots as a stream
# --------------------------------------------------------------------- #
def snapshot_stream(
    iterator: Iterable[Any],
    every: int = 1,
    registry: Optional[MetricRegistry] = None,
) -> Iterator[Tuple[Any, Optional[dict]]]:
    """Yield ``(item, snapshot|None)`` per upstream item, with a registry
    snapshot attached to every ``every``-th item. Each item is forwarded
    the moment it arrives (no buffering — a live stream stays live);
    callers that need end-of-stream metrics take one more
    ``registry.snapshot()`` after the loop. Composable with any emission
    iterator — the metrics ride the stream they measure::

        for comps, metrics in snapshot_stream(agg.run(stream), every=8):
            ...
    """
    from .registry import get_registry

    if every < 1:
        raise ValueError(f"every must be >= 1, got {every}")
    reg = registry if registry is not None else get_registry()
    for i, item in enumerate(iter(iterator), 1):
        yield item, (reg.snapshot() if i % every == 0 else None)
