"""The port's cross-process tracing, its span mirror and its scrape endpoint
(``gelly_streaming_tpu_torch/obs/trace.py``, ``obs/endpoint.py``,
``serving/stats.py``), against the JAX package's.

- ``TraceContext`` round-trips its wire form, tolerates garbage, and a
  context minted by either package decodes in the other;
- ``activate`` stamps spans and hands off across threads only explicitly;
  ``record_span`` emits one event and mirrors into
  ``trace.span_seconds``, as every finished span now does — so, with obs
  on, ``AutoK._span_hint`` reads what the reference's reads;
- ``ServingStats`` event logs replay to equal snapshots in either package;
- ``MetricsEndpoint`` serves ``/metrics`` (equal to ``prometheus_text``),
  ``/healthz``, ``/events`` and ``/trace/<id>``.

Mirrors ``tests/test_obs.py:212-309`` and ``:444-505`` and the endpoint
cases of ``tests/test_obs_cluster.py`` (``:358-484`` and the promotion
latency case after them).
"""

import json
import re
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from gelly_streaming_tpu import obs as jobs
from gelly_streaming_tpu.control import AutoK as JaxAutoK
from gelly_streaming_tpu.serving.stats import ServingStats as JaxStats
from gelly_streaming_tpu_torch import obs
from gelly_streaming_tpu_torch.control import AutoK
from gelly_streaming_tpu_torch.obs import endpoint
from gelly_streaming_tpu_torch.obs.cluster import (
    ClusterAggregator,
    ShardSink,
    iter_trace_events,
    shard_events_path,
)
from gelly_streaming_tpu_torch.obs.export import JsonlSink, prometheus_text
from gelly_streaming_tpu_torch.obs.registry import MetricRegistry
from gelly_streaming_tpu_torch.serving.stats import ServingStats


@pytest.fixture(autouse=True)
def _obs_hygiene():
    obs.reset()
    jobs.reset()
    yield
    obs.reset()
    jobs.reset()


def _get(url, timeout=10):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.status, r.read().decode()


# --------------------------------------------------------------------- #
# Trace context
# --------------------------------------------------------------------- #
def test_trace_context_wire_round_trip_and_tolerance():
    ctx = obs.TraceContext(parent_sid=obs.next_sid())
    wire = ctx.to_wire()
    back = obs.TraceContext.from_wire(wire)
    assert back.trace_id == ctx.trace_id
    assert back.parent_sid == ctx.parent_sid
    assert "s" not in obs.TraceContext().to_wire()
    for garbage in (None, 17, "x", [], {}, {"s": 3}, {"t": 9}, {"t": ""}):
        assert obs.TraceContext.from_wire(garbage) is None
        assert jobs.TraceContext.from_wire(garbage) is None
    assert obs.TraceContext().trace_id != obs.TraceContext().trace_id
    # the wire form crosses the packages both ways
    jctx = jobs.TraceContext(parent_sid=12)
    assert obs.TraceContext.from_wire(jctx.to_wire()).trace_id == jctx.trace_id
    assert jobs.TraceContext.from_wire(wire).parent_sid == ctx.parent_sid
    assert json.dumps(jobs.TraceContext("ab12", 3).to_wire()) == \
        json.dumps(obs.TraceContext("ab12", 3).to_wire())


def test_activate_stamps_spans_and_hands_off_across_threads():
    obs.enable()
    sink = JsonlSink()
    obs.attach_sink(sink)
    ctx = obs.TraceContext(parent_sid=obs.next_sid())
    with obs.activate(ctx):
        assert obs.current_context() is ctx
        with obs.span("stage"):
            assert obs.current_span().name == "stage"
    assert obs.current_context() is None and obs.current_span() is None
    seen = {}

    def worker():
        seen["before"] = obs.current_context()
        with obs.activate(ctx):
            with obs.span("worker.stage"):
                pass

    t = threading.Thread(target=worker)
    t.start()
    t.join(10)
    assert not t.is_alive() and seen["before"] is None
    spans = {e["name"]: e for e in sink.events if e["kind"] == "span"}
    for name in ("stage", "worker.stage"):
        assert spans[name]["trace"] == ctx.trace_id
        assert spans[name]["parent"] == ctx.parent_sid


def test_nested_span_under_context_parents_to_its_local_root():
    obs.enable()
    sink = JsonlSink()
    obs.attach_sink(sink)
    ctx = obs.TraceContext(parent_sid=obs.next_sid())
    with obs.activate(ctx):
        with obs.span("outer"):
            with obs.span("inner"):
                pass
    spans = {e["name"]: e for e in sink.events if e["kind"] == "span"}
    assert spans["outer"]["parent"] == ctx.parent_sid
    assert spans["inner"]["parent"] == spans["outer"]["sid"]
    assert spans["inner"]["trace"] == ctx.trace_id


def test_record_span_emits_event_and_registry_mirror():
    obs.enable()
    sink = JsonlSink()
    obs.attach_sink(sink)
    ctx = obs.TraceContext(parent_sid=obs.next_sid())
    sid = obs.record_span("async.stage", 0.25, trace_id=ctx.trace_id,
                          parent=ctx.parent_sid, attrs={"n": 3})
    assert isinstance(sid, int)
    (e,) = [e for e in sink.events if e["kind"] == "span"]
    assert e["name"] == "async.stage" and e["dur_s"] == 0.25
    assert e["trace"] == ctx.trace_id
    assert e["parent"] == ctx.parent_sid and e["attrs"] == {"n": 3}
    h = obs.get_registry().histogram("trace.span_seconds", span="async.stage")
    assert h.count == 1 and h.sum == 0.25
    sid2 = obs.next_sid()
    assert obs.record_span("root", 0.1, sid=sid2) == sid2
    # with-block spans land in the same histogram; registry_spans=False
    # keeps the events and drops the mirror
    with obs.span("block"):
        pass
    assert obs.get_registry().histogram("trace.span_seconds", span="block").count == 1
    obs.enable(registry_spans=False)
    with obs.span("block"):
        pass
    assert obs.get_registry().histogram("trace.span_seconds", span="block").count == 1
    assert sum(1 for e in sink.events if e.get("name") == "block") == 2


def test_record_span_disabled_is_a_noop():
    assert not obs.enabled()
    sink = JsonlSink()
    obs.attach_sink(sink)
    assert obs.record_span("x", 0.1) is None
    assert len(sink.events) == 0


def test_span_mirror_records_the_reference_instruments():
    """The same spans, opened and recorded in each package with obs on,
    leave the same ``trace.span_seconds`` instruments with the same
    counts (the durations are wall time; the recorded ones are equal)."""
    def drive(o):
        o.enable()
        for name in ("window.pack", "engine.dispatch", "window.pack"):
            with o.span(name):
                pass
        o.record_span("engine.superbatch_dispatch", 0.125)
        reg = o.get_registry()
        return {lab["span"]: (h.count, h.sum if lab["span"] == "engine.superbatch_dispatch"
                              else None)
                for lab, h in reg.find("trace.span_seconds")}

    assert drive(obs) == drive(jobs)


def test_autok_span_hint_reads_what_the_reference_reads():
    """With obs on, ``AutoK._span_hint`` reads the mirrored span
    histograms: equal hints from the same recorded spans, in both the
    dispatch-dominated and the pack-dominated case."""
    def hints(o, autok_cls):
        o.enable()
        out = []
        ak = autok_cls(decide_groups=1)
        for disp, pack in ((0.5, 0.001), (0.001, 0.5), (0.0, 0.0)):
            if disp:
                o.record_span("engine.dispatch", disp)
                o.record_span("engine.superbatch_dispatch", disp)
            if pack:
                o.record_span("window.pack", pack)
                o.record_span("window.superbatch_pack", pack)
            out.append(ak._span_hint())
        o.disable()
        return out

    got, want = hints(obs, AutoK), hints(jobs, JaxAutoK)
    assert got == want == [True, False, False]


# --------------------------------------------------------------------- #
# ServingStats replay
# --------------------------------------------------------------------- #
def _drive_stats(st):
    rng = np.random.default_rng(3)
    for i in range(200):
        st.record("ConnectedQuery", float(rng.random()) * 1e-3, i % 3)
    for _ in range(5):
        st.record_batch()
    st.record_rejected()
    st.set_pending(4)
    st.record_drain(40)


def test_serving_stats_event_log_replay_unit():
    st = ServingStats()
    sink = JsonlSink()
    st.attach_sink(sink)
    _drive_stats(st)
    live = st.snapshot()
    assert live["queries"]["ConnectedQuery"]["count"] == 200
    assert ServingStats.from_events(sink.events).snapshot() == live


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_serving_stats_logs_replay_alike_across_the_packages(writer):
    """Either package's ServingStats event log replays, in either
    package, to the snapshot the writer reported."""
    st = ServingStats() if writer == "port" else JaxStats()
    sink = JsonlSink()
    st.attach_sink(sink)
    _drive_stats(st)
    events = json.loads(json.dumps(sink.events))
    live = st.snapshot()
    assert ServingStats.from_events(events).snapshot() == live
    assert JaxStats.from_events(events).snapshot() == live


def test_live_server_event_log_replays_to_reported_snapshot():
    import gelly_streaming_tpu_torch as gt
    from gelly_streaming_tpu_torch.library import ConnectedComponents
    from gelly_streaming_tpu_torch.serving import ConnectedQuery, StreamServer

    rng = np.random.default_rng(9)
    n_vertices = 64
    src = rng.integers(0, n_vertices, 800)
    dst = rng.integers(0, n_vertices, 800)
    edges = [(int(a), int(b), 0.0) for a, b in zip(src, dst)]
    stream = gt.SimpleEdgeStream(edges, window=gt.CountWindow(100), device="cpu")
    server = StreamServer(ConnectedComponents().servable(), stream, max_pending=4096)
    sink = JsonlSink()
    server.stats.attach_sink(sink)
    server.start()
    futures = [server.submit(ConnectedQuery(int(a), int(b)))
               for a, b in zip(rng.integers(0, n_vertices, 300),
                               rng.integers(0, n_vertices, 300))]
    for f in futures:
        f.result(60)
    server.join(60)
    server.close()
    live = server.stats.snapshot()
    assert live["queries"]["ConnectedQuery"]["count"] == 300
    assert ServingStats.from_events(sink.events).snapshot() == live
    assert JaxStats.from_events(json.loads(json.dumps(sink.events))).snapshot() == live


# --------------------------------------------------------------------- #
# Scrape endpoint
# --------------------------------------------------------------------- #
def _run_worker(directory, pid, n=6):
    reg = MetricRegistry()
    sink = ShardSink(shard_events_path(directory, pid), shard=pid)
    reg.add_sink(sink)
    for i in range(n):
        reg.counter("w.windows").inc()
        reg.gauge("w.depth").set(i % 5)
    sink.close()


def test_endpoint_metrics_parse_under_concurrent_mutation():
    reg = MetricRegistry()
    stop = threading.Event()

    def mutate(seed):
        rng = np.random.default_rng(seed)
        while not stop.is_set():
            reg.counter("q.count", lane=str(seed % 3)).inc()
            reg.histogram("q.lat").observe(float(rng.random()))
            reg.gauge("q.depth").set(int(rng.integers(0, 9)))

    threads = [threading.Thread(target=mutate, args=(s,), daemon=True) for s in range(4)]
    line_re = re.compile(r"^(# TYPE \w+ (counter|gauge|summary))$"
                         r"|^\w+(\{[^{}]*\})? [0-9.eE+-]+$")
    with endpoint.MetricsEndpoint(reg) as ep:
        for t in threads:
            t.start()
        try:
            for _ in range(10):
                status, body = _get(f"{ep.url}/metrics")
                assert status == 200
                for line in body.strip().splitlines():
                    assert line_re.match(line), f"unparseable: {line!r}"
        finally:
            stop.set()
            for t in threads:
                t.join(5)
        assert not any(t.is_alive() for t in threads)
        status, body = _get(f"{ep.url}/metrics")
        assert body == prometheus_text(reg)
        status, hz = _get(f"{ep.url}/healthz")
        hz = json.loads(hz)
        assert status == 200 and hz["ok"] is True and "uptime_s" in hz
        with pytest.raises(urllib.error.HTTPError) as ei:
            _get(f"{ep.url}/unknown")
        assert ei.value.code == 404


def test_endpoint_over_aggregator_serves_merged_cluster_view(tmp_path):
    d = str(tmp_path)
    for pid in range(2):
        _run_worker(d, pid)
    agg = ClusterAggregator(d)
    with endpoint.MetricsEndpoint(aggregator=agg) as ep:
        _, body = _get(f"{ep.url}/metrics")
        assert 'w_windows{shard="p0"} 6' in body
        assert 'w_windows{shard="p1"} 6' in body
        _, ev = _get(f"{ep.url}/events?n=4")
        lines = [json.loads(x) for x in ev.strip().splitlines()]
        assert len(lines) == 4 and all("shard" in e for e in lines)
        _, hz = _get(f"{ep.url}/healthz")
        assert json.loads(hz)["shards_consumed_events"] > 0


def test_trace_events_merge_across_shards_and_serve_over_http(tmp_path):
    d = str(tmp_path)
    shard_events = {
        0: [{"kind": "span", "name": "rpc.client.batch", "ts": 10.2,
             "dur_s": 0.2, "sid": 1, "depth": 0, "trace": "tX"}],
        1: [{"kind": "span", "name": "serving.query", "ts": 10.1,
             "dur_s": 0.01, "sid": 7, "depth": 0, "trace": "tX", "parent": 1},
            {"kind": "span", "name": "serving.query", "ts": 10.15,
             "dur_s": 0.01, "sid": 8, "depth": 0, "trace": "tOther"}],
    }
    for shard, events in shard_events.items():
        with open(shard_events_path(d, shard), "w") as f:
            for e in events:
                f.write(json.dumps(e) + "\n")
    merged = list(iter_trace_events(d, "tX"))
    assert [(e["shard"], e["name"]) for e in merged] == [
        ("p1", "serving.query"), ("p0", "rpc.client.batch")]
    with endpoint.MetricsEndpoint(aggregator=ClusterAggregator(d)) as ep:
        _, body = _get(f"{ep.url}/trace/tX")
        lines = [json.loads(x) for x in body.strip().splitlines()]
        assert len(lines) == 2 and all(e["trace"] == "tX" for e in lines)
        _, body = _get(f"{ep.url}/trace/tX?n=1")
        assert len(body.strip().splitlines()) == 1
        status, body = _get(f"{ep.url}/trace/absent")
        assert status == 200 and body.strip() == ""


def test_endpoint_attaches_to_stream_server():
    from gelly_streaming_tpu_torch.serving.server import StreamServer

    srv = StreamServer(iter(()), None).start()
    try:
        ep = srv.metrics_endpoint()
        try:
            _, hz = _get(f"{ep.url}/healthz")
            hz = json.loads(hz)
            assert hz["ok"] is True and hz["worker_alive"] is True
            assert "pending" in hz and "ingest_finished" in hz
            status, _body = _get(f"{ep.url}/metrics")
            assert status == 200
        finally:
            ep.close()
    finally:
        srv.close()


def test_endpoint_smoke_matches_ci_gate_and_the_lazy_export():
    assert endpoint.smoke(verbose=False)
    assert obs.MetricsEndpoint is endpoint.MetricsEndpoint
    with pytest.raises(AttributeError):
        obs.NoSuchName  # noqa: B018


def test_promotion_records_latency_histogram_and_span():
    from gelly_streaming_tpu_torch.datasets import IdentityDict
    from gelly_streaming_tpu_torch.serving import FailoverServer

    obs.enable()
    sink = obs.JsonlSink()
    obs.attach_sink(sink)
    vd = IdentityDict(8)
    vd.observe(7)
    labels = torch.zeros(8, dtype=torch.int32)
    fs = FailoverServer(iter([({"labels": labels, "vdict": vd}, 1)]), None,
                        monitor_s=None, max_pending=8).start()
    try:
        fs.store.wait_for(1, timeout=30)
        fs.promote(reason="manual")
        assert fs.promoted
        h = obs.get_registry().histogram("serving.promotion_seconds")
        assert h.count == 1 and h.sum > 0
        spans = [e for e in sink.events
                 if e.get("kind") == "span" and e.get("name") == "serving.promotion"]
        assert len(spans) == 1 and spans[0]["attrs"] == {"reason": "manual"}
        fs.promote(reason="manual")
        assert h.count == 1
    finally:
        obs.detach_sink(sink)
        fs.close()
