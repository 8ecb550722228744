"""Stdlib HTTP scrape endpoint: /metrics, /healthz, /events (the port's
copy of ``gelly_streaming_tpu/obs/endpoint.py``).

Metrics are streams (the reference's stance); this module exposes the
Prometheus renderer as a scrape endpoint, kept as thin as the stance
allows: a ``ThreadingHTTPServer`` on a
daemon thread that renders EXISTING state on demand. Nothing is pushed,
buffered, or aggregated here; a scrape is a read.

Routes:

- ``GET /metrics`` — :func:`~gelly_streaming_tpu_torch.obs.export.prometheus_text`
  over the endpoint's registry. With an attached
  :class:`~gelly_streaming_tpu_torch.obs.cluster.ClusterAggregator` the
  aggregator is polled first, so a scrape of a cluster's coordinator always
  renders the freshest merged, shard-labeled view.
- ``GET /healthz`` — JSON liveness: ``{"ok": true, "uptime_s": ...}``
  plus whatever the ``health`` callable reports (the serving tier wires
  worker liveness, pending depth, and promotion state in).
- ``GET /events`` — the newest N merged events as JSON lines (aggregator
  or flight-recorder tail), ``?n=`` bounded; the quick look a human
  takes before reaching for the timeline tool.
- ``GET /trace/<id>`` — the newest events of ONE trace as ndjson (the
  merged tail filtered to ``trace == id``): paste a latency exemplar's
  trace id and read that query's causal path live, without waiting for
  the committed logs.

Attachment points: :meth:`MetricsEndpoint.for_server` wires a
``StreamServer`` or ``FailoverServer`` (their ``metrics_endpoint()``
methods call it); the chaos sweep passes an aggregator. ``port=0``
binds an ephemeral port (tests; the bound port is ``endpoint.port``).

``python -m gelly_streaming_tpu_torch.obs.endpoint --smoke`` is the CI gate:
it populates a registry, scrapes ``/metrics`` + ``/healthz`` over real
HTTP, and diffs the scrape against the registry's own render.
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional

from .export import prometheus_text
from .registry import MetricRegistry, get_registry


def _query_n(query: str) -> Optional[int]:
    """The ``?n=`` tail bound shared by /events and /trace/<id>;
    None (the endpoint default) when absent or non-numeric."""
    n = None
    for part in query.split("&"):
        if part.startswith("n="):
            try:
                n = int(part[2:])
            except ValueError:
                n = None
    return n


class MetricsEndpoint:
    """One scrape endpoint over a registry (default: the process-wide
    one), an optional cluster aggregator, and an optional health
    callable. Start with :meth:`start`, stop with :meth:`close`;
    usable as a context manager."""

    def __init__(
        self,
        registry: Optional[MetricRegistry] = None,
        *,
        aggregator=None,
        health: Optional[Callable[[], dict]] = None,
        events: Optional[Callable[[int], list]] = None,
        host: str = "127.0.0.1",
        port: int = 0,
        events_tail: int = 128,
    ):
        self._registry = registry
        self.aggregator = aggregator
        self._health = health
        self._events = events
        self.host = host
        self._port = int(port)
        self.events_tail = int(events_tail)
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self._t0 = time.monotonic()

    # ------------------------------------------------------------------ #
    @property
    def registry(self) -> MetricRegistry:
        if self.aggregator is not None:
            return self.aggregator.registry
        return self._registry if self._registry is not None \
            else get_registry()

    @property
    def port(self) -> int:
        return self._port

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self._port}"

    # ------------------------------------------------------------------ #
    # Route payloads (also the testable non-HTTP surface)
    # ------------------------------------------------------------------ #
    def render_metrics(self) -> str:
        if self.aggregator is not None:
            self.aggregator.poll()
        return prometheus_text(self.registry)

    def render_healthz(self) -> dict:
        doc = {"ok": True, "uptime_s": round(time.monotonic() - self._t0, 3)}
        if self.aggregator is not None:
            doc["shards_consumed_events"] = self.aggregator.consumed
        if self._health is not None:
            try:
                extra = self._health() or {}
            except Exception:
                get_registry().counter(
                    "obs.swallowed", site="endpoint_health"
                ).inc()
                extra = {"ok": False, "error": "health callable raised"}
            doc.update(extra)
        return doc

    def render_events(self, n: Optional[int] = None) -> list:
        n = self.events_tail if n is None else max(0, int(n))
        if self._events is not None:
            return list(self._events(n))
        if self.aggregator is not None:
            self.aggregator.poll()
            return self.aggregator.events(last=n)
        return []

    def render_trace(self, trace_id: str,
                     n: Optional[int] = None) -> list:
        """The newest events of ONE trace (``/trace/<id>``): the
        merged event tail filtered to ``trace == trace_id``. Served
        from the aggregator's bounded event window (or the ``events``
        callable's tail), so it is the LIVE tail of a trace, not an
        archival lookup — the full story belongs to
        ``obs.timeline --trace`` over the committed logs."""
        n = self.events_tail if n is None else max(0, int(n))
        if self._events is not None:
            # ask the callable for its whole available tail; the trace
            # filter below does the narrowing
            evs = list(self._events(1 << 20))
        elif self.aggregator is not None:
            self.aggregator.poll()
            evs = self.aggregator.events()
        else:
            return []
        hits = [e for e in evs if e.get("trace") == trace_id]
        return hits[-n:] if n > 0 else []

    # ------------------------------------------------------------------ #
    def start(self) -> "MetricsEndpoint":
        endpoint = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # scrapes are not operator news
                pass

            def _send(self, code: int, body: bytes, ctype: str) -> None:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):  # noqa: N802 (http.server API name)
                path, _, query = self.path.partition("?")
                try:
                    if path == "/metrics":
                        self._send(
                            200,
                            endpoint.render_metrics().encode(),
                            "text/plain; version=0.0.4",
                        )
                    elif path == "/healthz":
                        doc = endpoint.render_healthz()
                        self._send(
                            200 if doc.get("ok") else 503,
                            (json.dumps(doc) + "\n").encode(),
                            "application/json",
                        )
                    elif path == "/events":
                        body = "".join(
                            json.dumps(e) + "\n"
                            for e in endpoint.render_events(
                                _query_n(query))
                        ).encode()
                        self._send(200, body, "application/x-ndjson")
                    elif path.startswith("/trace/"):
                        trace_id = path[len("/trace/"):]
                        body = "".join(
                            json.dumps(e) + "\n"
                            for e in endpoint.render_trace(
                                trace_id, _query_n(query))
                        ).encode()
                        self._send(200, body, "application/x-ndjson")
                    else:
                        self._send(404, b"not found\n", "text/plain")
                except BrokenPipeError:
                    pass  # client hung up mid-scrape; its loss
                except Exception:
                    # a scrape must never take the server thread down;
                    # count it and report the failure to the client
                    get_registry().counter(
                        "obs.swallowed", site="endpoint_request"
                    ).inc()
                    try:
                        self._send(
                            500, b"internal error\n", "text/plain"
                        )
                    except OSError:
                        pass  # the connection is already gone

        self._httpd = ThreadingHTTPServer((self.host, self._port), Handler)
        self._httpd.daemon_threads = True
        self._port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            name="obs-metrics-endpoint",
            daemon=True,
        )
        self._thread.start()
        return self

    def __enter__(self) -> "MetricsEndpoint":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(5.0)
            self._thread = None

    # ------------------------------------------------------------------ #
    @classmethod
    def for_server(cls, server, **kw) -> "MetricsEndpoint":
        """An endpoint wired to a serving replica set: ``/healthz``
        reports worker liveness, pending depth, ingest state, and (for
        a :class:`~gelly_streaming_tpu_torch.serving.failover.FailoverServer`)
        the replica ROLE (``primary``/``standby``), promotion state,
        and heartbeat age — the fields an external probe needs to tell
        a healthy standby takeover from a wedged primary (alive thread,
        stale beat); ``ok`` is False once no replica can answer.
        Accepts a ``StreamServer`` or ``FailoverServer``."""

        def health() -> dict:
            # active_nowait, not active: the locked property waits out
            # an in-flight promote() (up to its in-flight grace), and a
            # health probe stalling mid-failover reads as an outage
            active = getattr(server, "active_nowait", server)
            doc = {
                "worker_alive": bool(active.worker_alive()),
                "ingest_finished": bool(active.ingest_finished()),
                "pending": len(getattr(active, "_pending", ())),
            }
            role = getattr(server, "role", None)
            if role is not None:
                doc["role"] = str(role)
            promoted = getattr(server, "promoted", None)
            if promoted is not None:
                doc["promoted"] = bool(promoted)
            beat = getattr(server, "heartbeat_age_s", None)
            if beat is not None:
                age = beat()
                if age is not None:
                    doc["heartbeat_age_s"] = round(age, 4)
            started = active._worker_thread is not None
            doc["ok"] = bool(active.worker_alive() or not started)
            return doc

        return cls(health=health, **kw)


# --------------------------------------------------------------------- #
# CI smoke: scrape a live endpoint and diff it against the registry
# --------------------------------------------------------------------- #
def smoke(verbose: bool = True) -> bool:
    """Start an endpoint over a seeded registry, scrape ``/metrics`` +
    ``/healthz`` + ``/events`` over real HTTP, and verify the scrape
    equals the registry's own render. Returns True on success (the CI
    step exits nonzero otherwise)."""
    from urllib.request import urlopen

    reg = MetricRegistry()
    reg.counter("smoke.requests", route="a").inc(3)
    reg.counter("smoke.requests", route="b").inc(2)
    reg.gauge("smoke.depth").set(7)
    h = reg.histogram("smoke.latency_seconds")
    for v in (0.01, 0.02, 0.03, 0.5):
        h.observe(v)

    say = print if verbose else (lambda *a, **k: None)
    with MetricsEndpoint(reg) as ep:
        body = urlopen(f"{ep.url}/metrics", timeout=10).read().decode()
        want = prometheus_text(reg)
        if body != want:
            say("SMOKE FAIL: /metrics scrape differs from "
                "prometheus_text(registry):")
            say(f"--- scraped ---\n{body}\n--- rendered ---\n{want}")
            return False
        if "smoke_latency_seconds_count" not in body:
            say("SMOKE FAIL: summary series missing from /metrics")
            return False
        hz = json.loads(
            urlopen(f"{ep.url}/healthz", timeout=10).read().decode()
        )
        if hz.get("ok") is not True or "uptime_s" not in hz:
            say(f"SMOKE FAIL: /healthz unhealthy: {hz}")
            return False
        ev = urlopen(f"{ep.url}/events?n=5", timeout=10).read().decode()
        if ev.strip():
            for line in ev.strip().splitlines():
                json.loads(line)
    say(f"SMOKE OK: /metrics ({len(body.splitlines())} lines) == "
        f"registry render; /healthz ok (uptime {hz['uptime_s']}s)")
    return True


if __name__ == "__main__":
    import sys

    if "--smoke" in sys.argv:
        sys.exit(0 if smoke() else 1)
    # default: serve the process-wide registry until interrupted
    ep = MetricsEndpoint(port=int(sys.argv[1]) if len(sys.argv) > 1 else 0)
    ep.start()
    print(f"serving {ep.url}/metrics (/healthz, /events); Ctrl-C stops")
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        ep.close()
