"""The port's cluster observability plane (``obs/export.py``,
``obs/cluster.py``, ``obs/flight.py``'s collection half, ``obs/timeline.py``)
against the JAX package.

The load-bearing identities:

- the :class:`ClusterAggregator`'s merged snapshot EQUALS the union of
  per-worker ``replay()`` results, and equals the JAX package's aggregator
  over the same shard files;
- an event log written by the JAX package replays to an equal registry in
  the port (and the reverse), and the Prometheus text of the two is equal;
- a ``FaultPlan`` kill and a supervisor restart commit the flight ring
  atomically, and a :class:`ClusterSupervisor`'s failure report carries its
  workers' dumps; dumps of either package read in the other;
- the timeline merges shard logs and flight dumps into the one ordered
  story the JAX package's renders.

Mirrors ``tests/test_obs_cluster.py:61-357`` (the scrape endpoint comes
with slice 9) and ``:536-599``. The cluster supervisor's workers here are
in-process stand-ins for ``Popen`` (real worker processes run in
``tests/test_torch_coordinated.py``), so no case starts an interpreter.
"""

import json
import os
import threading
import time

import numpy as np
import pytest

from gelly_streaming_tpu.obs import cluster as jcluster
from gelly_streaming_tpu.obs import export as jexport
from gelly_streaming_tpu.obs import registry as jregistry
from gelly_streaming_tpu.obs import timeline as jtimeline
from gelly_streaming_tpu_torch import obs
from gelly_streaming_tpu_torch.obs import flight, timeline
from gelly_streaming_tpu_torch.obs.cluster import (
    ClusterAggregator,
    ShardSink,
    iter_shard_events,
    label_shard,
    shard_events_path,
)
from gelly_streaming_tpu_torch.obs.export import (
    JsonlSink,
    prometheus_text,
    read_jsonl,
    replay,
    snapshot_stream,
    write_jsonl,
)
from gelly_streaming_tpu_torch.obs.registry import MetricRegistry
from gelly_streaming_tpu_torch.resilience.errors import CheckpointCorrupt


@pytest.fixture(autouse=True)
def _obs_hygiene():
    obs.reset()
    yield
    obs.reset()


# --------------------------------------------------------------------- #
# ShardSink
# --------------------------------------------------------------------- #
def test_shard_sink_streams_events_to_disk_immediately(tmp_path):
    reg = MetricRegistry()
    sink = ShardSink(shard_events_path(str(tmp_path), 3), shard=3)
    reg.add_sink(sink)
    reg.counter("w.edges").inc(5)
    lines = open(sink.path).read().splitlines()
    assert len(lines) == 1
    e = json.loads(lines[0])
    assert e["name"] == "w.edges" and e["v"] == 5
    assert e["shard"] == "p3" and isinstance(e["ts"], float)
    reg.gauge("w.depth").set(2)
    assert len(open(sink.path).read().splitlines()) == 2
    sink.close()
    sink2 = ShardSink(sink.path, shard=3)
    reg2 = MetricRegistry()
    reg2.add_sink(sink2)
    reg2.counter("w.edges").inc(1)
    assert len(open(sink.path).read().splitlines()) == 3
    sink2.close()
    assert len(sink2) == 1 and sink2.write() == sink.path


# --------------------------------------------------------------------- #
# ClusterAggregator
# --------------------------------------------------------------------- #
def _run_worker(directory, pid, n=40):
    reg = MetricRegistry()
    sink = ShardSink(shard_events_path(directory, pid), shard=pid)
    reg.add_sink(sink)
    rng = np.random.default_rng(100 + pid)
    for i in range(n):
        reg.counter("w.windows").inc()
        reg.counter("w.edges", kind="raw").inc(int(rng.integers(1, 9)))
        reg.gauge("w.depth").set(i % 5)
        reg.histogram("w.pack_s").observe(float(rng.random()))
    sink.close()
    return reg


def test_merged_registry_equals_union_of_worker_replays(tmp_path):
    d = str(tmp_path)
    live = {pid: _run_worker(d, pid) for pid in range(3)}
    agg = ClusterAggregator(d)
    n = agg.poll()
    assert n == sum(len(open(shard_events_path(d, p)).read().splitlines()) for p in range(3))
    union = MetricRegistry()
    for pid in range(3):
        events = [json.loads(line) for line in open(shard_events_path(d, pid))]
        replay([label_shard(e, f"p{pid}") for e in events], union)
    assert agg.registry.snapshot() == union.snapshot()
    merged = agg.registry.snapshot()
    for pid, reg in live.items():
        for key, val in reg.snapshot()["counters"].items():
            name, _, labels = key.partition("{")
            want = labels.rstrip("}").split(",") if labels else []
            want = ",".join(sorted(want + [f"shard=p{pid}"]))
            assert merged["counters"][f"{name}{{{want}}}"] == val
    # the JAX package's aggregator over the same shard files agrees
    jagg = jcluster.ClusterAggregator(d)
    jagg.poll()
    assert jagg.registry.snapshot() == merged
    assert prometheus_text(agg.registry) == jexport.prometheus_text(jagg.registry)


def test_aggregator_tails_incrementally_and_handles_partial_lines(tmp_path):
    d = str(tmp_path)
    _run_worker(d, 0, n=5)
    agg = ClusterAggregator(d)
    first = agg.poll()
    assert first > 0 and agg.poll() == 0
    path = shard_events_path(d, 0)
    with open(path, "a") as f:
        f.write('{"kind":"counter","name":"w.windows","v":1')
    assert agg.poll() == 0
    with open(path, "a") as f:
        f.write("}\n")
    assert agg.poll() == 1
    _run_worker(d, 1, n=3)
    assert agg.poll() > 0
    snap = agg.registry.snapshot()
    assert any("shard=p1" in k for k in snap["counters"])
    assert agg.consumed == sum(len(open(shard_events_path(d, p)).read().splitlines())
                               for p in range(2))


def test_aggregator_snapshot_and_events_surface(tmp_path):
    d = str(tmp_path)
    _run_worker(d, 0, n=4)
    agg = ClusterAggregator(d)
    snap = agg.snapshot()
    assert snap["counters"]["w.windows{shard=p0}"] == 4
    evs = agg.events(last=3)
    assert len(evs) == 3 and all(e["shard"] == "p0" for e in evs)
    assert agg.events(last=0) == []


# --------------------------------------------------------------------- #
# Event logs across the packages
# --------------------------------------------------------------------- #
def _drive(reg, seed=3):
    rng = np.random.default_rng(seed)
    for i in range(300):  # past the histogram window: eviction is replayed too
        reg.counter("c.edges", kind="raw").inc(int(rng.integers(1, 9)))
        reg.gauge("g.depth", shard=str(i % 3)).set(float(i % 7))
        reg.histogram("h.lat", max_samples=64).observe(float(rng.random()),
                                                       exemplar=f"t{i}" if i % 50 == 0 else None)


def test_a_jax_event_log_replays_to_an_equal_registry_in_the_port(tmp_path):
    jreg = jregistry.MetricRegistry()
    jsink = jexport.JsonlSink(str(tmp_path / "jax.jsonl"))
    jreg.add_sink(jsink)
    _drive(jreg)
    jsink.write()
    mine = replay(read_jsonl(str(tmp_path / "jax.jsonl")))
    assert mine.snapshot() == jreg.snapshot()
    assert prometheus_text(mine) == jexport.prometheus_text(jreg)
    # and the reverse: a port log replays in the JAX package
    reg = MetricRegistry()
    sink = JsonlSink(str(tmp_path / "port.jsonl"))
    reg.add_sink(sink)
    _drive(reg, seed=4)
    sink.write()
    theirs = jexport.replay(jexport.read_jsonl(str(tmp_path / "port.jsonl")))
    assert theirs.snapshot() == reg.snapshot()
    assert replay(read_jsonl(sink.path)).snapshot() == reg.snapshot()


def test_jsonl_sink_write_and_snapshot_stream(tmp_path):
    sink = JsonlSink()
    sink.emit({"kind": "counter", "name": "a", "v": 1})
    assert len(sink) == 1 and sink.events[0]["name"] == "a"
    with pytest.raises(ValueError, match="no path"):
        sink.write()
    p = sink.write(str(tmp_path / "a.jsonl"))
    assert read_jsonl(p) == sink.events
    sink.clear()
    assert len(sink) == 0
    write_jsonl([{"kind": "gauge", "name": "g", "v": 2.0}], str(tmp_path / "b.jsonl"))
    assert replay(read_jsonl(str(tmp_path / "b.jsonl"))).gauge("g").value == 2.0
    reg = MetricRegistry()
    pairs = []
    for item, snap in snapshot_stream(iter(range(5)), every=2, registry=reg):
        reg.counter("n").inc()
        pairs.append((item, snap is not None))
    assert pairs == [(0, False), (1, True), (2, False), (3, True), (4, False)]
    with pytest.raises(ValueError):
        list(snapshot_stream(iter(()), every=0))


def test_prometheus_text_equals_the_jax_packages():
    reg, jreg = MetricRegistry(), jregistry.MetricRegistry()
    for r in (reg, jreg):
        r.counter("serve.requests", cls="a-b").inc(3)
        r.gauge("1depth").set(2.5)
        for v in (0.1, 0.5, 0.9, 0.3):
            r.histogram("lat.s", route="/x").observe(v)
    assert prometheus_text(reg) == jexport.prometheus_text(jreg)
    assert prometheus_text(MetricRegistry()) == ""


# --------------------------------------------------------------------- #
# Flight recorder
# --------------------------------------------------------------------- #
def test_flight_ring_gates_on_enable_and_bounds_capacity(tmp_path):
    rec = flight.FlightRecorder(str(tmp_path / "flight.json"), capacity=4, shard=1)
    flight.install(rec)
    reg = obs.get_registry()
    reg.counter("a").inc()
    rec.note("marker", k=1)
    assert len(rec) == 0
    obs.enable()
    for _ in range(10):
        reg.counter("a").inc()
    rec.note("marker", k=2)
    assert len(rec) == 4
    assert rec.snapshot()[-1]["kind"] == "note" and rec.snapshot()[-1]["attrs"] == {"k": 2}


def test_flight_dump_atomic_checksummed_roundtrip(tmp_path):
    from gelly_streaming_tpu.obs import flight as jflight
    from gelly_streaming_tpu_torch.resilience.faults import corrupt_file

    obs.enable()
    rec = flight.FlightRecorder(str(tmp_path / "flight.json"), shard=2)
    flight.install(rec)
    reg = obs.get_registry()
    reg.counter("w.windows").inc(3)
    reg.histogram("w.lat").observe(0.5)
    p = rec.dump("test_reason", ordinal=7)
    doc = flight.read_dump(p)
    assert doc["reason"] == "test_reason" and doc["shard"] == 2
    assert doc["attrs"] == {"ordinal": 7}
    assert doc["n_events"] == 2 == len(doc["events"])
    assert doc["events"][0]["name"] == "w.windows"
    assert jflight.read_dump(p) == doc  # the JAX package reads the port's dump
    p2 = rec.dump("again")
    assert p2 != p and os.path.exists(p) and os.path.exists(p2)
    os.utime(p2, (os.path.getmtime(p) + 1, os.path.getmtime(p) + 1))
    assert flight.find_dumps(str(tmp_path)) == [p, p2] == jflight.find_dumps(str(tmp_path))
    corrupt_file(p, "flip", seed=9)
    with pytest.raises(CheckpointCorrupt):
        flight.read_dump(p)


def test_a_jax_flight_dump_reads_in_the_port(tmp_path):
    from gelly_streaming_tpu import obs as jobs
    from gelly_streaming_tpu.obs import flight as jflight

    jobs.reset()
    try:
        jobs.enable()
        rec = jflight.FlightRecorder(str(tmp_path / "flight.p1.json"), shard=1)
        jflight.install(rec)
        jobs.get_registry().counter("w.windows").inc(2)
        p = rec.dump("jax_kill", ordinal=3)
    finally:
        jobs.reset()
    doc = flight.read_dump(p)
    assert (doc["reason"], doc["shard"], doc["attrs"]) == ("jax_kill", 1, {"ordinal": 3})
    assert flight.find_dumps(str(tmp_path)) == [p]


def test_flight_dump_on_injected_faultplan_kill(tmp_path):
    from gelly_streaming_tpu_torch.resilience import faults
    from gelly_streaming_tpu_torch.resilience.errors import SimulatedCrash

    obs.enable()
    rec = flight.FlightRecorder(str(tmp_path / "flight.json"), capacity=8)
    flight.install(rec)
    obs.get_registry().counter("w.windows").inc()
    with faults.injected(faults.FaultPlan(kill_at_window=0)):
        with pytest.raises(SimulatedCrash):
            faults.fire("chaos.window", index=0)
    dumps = flight.find_dumps(str(tmp_path))
    assert len(dumps) == 1
    doc = flight.read_dump(dumps[0])
    assert doc["reason"] == "fault_kill:chaos.window"
    assert doc["events"][-1]["name"] == "resilience.fault_injected"


def test_supervisor_restart_commits_black_box(tmp_path):
    from gelly_streaming_tpu_torch.aggregate.autockpt import AutoCheckpoint
    from gelly_streaming_tpu_torch.core.stream import SimpleEdgeStream
    from gelly_streaming_tpu_torch.core.window import CountWindow
    from gelly_streaming_tpu_torch.library import ConnectedComponents
    from gelly_streaming_tpu_torch.resilience import FaultPlan, Supervisor, faults

    obs.enable()
    flight.install(flight.FlightRecorder(str(tmp_path / "flight.json"), capacity=64))
    rng = np.random.default_rng(7)
    raw = [(int(a) * 3 + 5, int(b) * 3 + 5, 0.0) for a, b in rng.integers(0, 50, size=(128, 2))]

    def make_stream(vd):
        s = SimpleEdgeStream(raw, window=CountWindow(16), vertex_dict=vd, device="cpu")
        orig = s._block_source

        def wrapped():
            for i, b in enumerate(orig()):
                yield b
                if faults.active():
                    faults.fire("chaos.window", index=i)

        s._block_source = wrapped
        return s

    sup = Supervisor(AutoCheckpoint(str(tmp_path / "c.ckpt"), every=2, keep=3),
                     backoff_base_s=0.0, jitter=0.0)
    with faults.injected(FaultPlan(kill_at_window=4)):
        outs = list(sup.run(make_stream, ConnectedComponents))
    assert len(outs) == 8 and sup.restarts == 1
    dumps = flight.find_dumps(str(tmp_path))
    assert len(dumps) == 2
    reasons = {flight.read_dump(p)["reason"] for p in dumps}
    assert "fault_kill:chaos.window" in reasons
    assert "supervisor:transient" in reasons
    assert obs.get_registry().counter("resilience.flight_dumps").value == 1


class _ThreadWorker:
    """A ``Popen`` stand-in: ``fn()`` runs on a thread and its return value
    is the exit code (what ``ClusterSupervisor`` reads through ``poll``)."""

    stderr = None

    def __init__(self, fn):
        self.rc = None
        self._t = threading.Thread(target=self._run, args=(fn,), daemon=True)
        self._t.start()

    def _run(self, fn):
        self.rc = fn()

    def poll(self):
        return None if self._t.is_alive() else self.rc

    def terminate(self):
        pass

    def kill(self):
        pass

    def wait(self):
        self._t.join()
        return self.rc


def test_cluster_supervisor_report_carries_worker_dumps(tmp_path):
    """A worker of 2 dies (rc in restart_codes) having committed its flight
    dump; the relaunched cluster finishes and ``run()``'s report lists the
    dump. A non-restartable death raises ClusterError CARRYING the dump's
    description."""
    from gelly_streaming_tpu_torch.resilience.coordinated import (
        ClusterError,
        ClusterSupervisor,
    )

    d = str(tmp_path)

    def spawner(fail_rc):
        def spawn(pid, attempt):
            rc = fail_rc if (pid == 1 and attempt == 0) else 0

            def work():
                if rc:
                    rec = flight.FlightRecorder(os.path.join(d, f"flight.p{pid}.a{attempt}.json"),
                                                shard=pid)
                    rec.dump("test_kill")
                return rc

            return _ThreadWorker(work)

        return spawn

    cs = ClusterSupervisor(spawner(17), 2, restart_codes=(17,), backoff_base_s=0.0,
                           flight_dir=d, poll_s=0.001)
    res = cs.run()
    assert res["restarts"] == 1
    assert len(res["flight_dumps"]) == 1
    doc = flight.read_dump(res["flight_dumps"][0])
    assert doc["reason"] == "test_kill" and doc["shard"] == 1
    for f in flight.find_dumps(d):
        os.remove(f)
    cs2 = ClusterSupervisor(spawner(9), 2, restart_codes=(17,), backoff_base_s=0.0,
                            flight_dir=d, poll_s=0.001)
    with pytest.raises(ClusterError, match="flight dumps.*test_kill"):
        cs2.run()


# --------------------------------------------------------------------- #
# Timeline
# --------------------------------------------------------------------- #
def _write_events(path, events):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        for e in events:
            f.write(json.dumps(e) + "\n")


def test_timeline_merges_shards_into_one_ordered_story(tmp_path, capsys):
    d = str(tmp_path)
    t0 = time.time()
    _write_events(os.path.join(d, "events.p0.jsonl"), [
        {"kind": "counter", "name": "resilience.coord_commits", "v": 1, "ts": t0 + 0.1},
        {"kind": "counter", "name": "w.edges", "v": 64, "ts": t0 + 0.2},
        {"kind": "counter", "name": "resilience.epoch_torn", "v": 1, "ts": t0 + 2.0},
    ])
    _write_events(os.path.join(d, "events.p1.jsonl"), [
        {"kind": "counter", "name": "resilience.fault_injected", "v": 1,
         "labels": {"site": "chaos.window"}, "ts": t0 + 0.5},
        {"kind": "counter", "name": "resilience.cluster_restarts", "v": 1,
         "labels": {"reason": "kill"}, "ts": t0 + 1.0},
    ])
    events = timeline.load_run(d)
    assert [e["ts"] for e in events] == sorted(e["ts"] for e in events)
    lines = timeline.render(events)
    assert lines == jtimeline.render(jtimeline.load_run(d))
    assert len(lines) == 4
    assert "KILL" in lines[1] and "[p1]" in lines[1].replace(" ", "")
    assert lines.index(next(x for x in lines if "KILL" in x)) < \
        lines.index(next(x for x in lines if "RESTART*" in x))
    assert not any("w.edges" in x for x in lines)
    assert any("TORN" in x for x in lines)
    assert len(timeline.render(events, all_events=True)) == 5
    assert timeline.main([d]) == 0
    out = capsys.readouterr().out
    assert "KILL" in out and "RESTART*" in out
    assert timeline.main([]) == 2
    # the window flags: relative seconds against the run's start
    assert timeline.main([d, "--since", "+0.4", "--until", "+1.5"]) == 0
    out = capsys.readouterr().out
    assert "KILL" in out and "COMMIT" not in out and "TORN" not in out


def test_timeline_folds_flight_dumps_in(tmp_path):
    d = str(tmp_path)
    _write_events(os.path.join(d, "events.p0.jsonl"), [
        {"kind": "counter", "name": "resilience.coord_commits", "v": 1, "ts": time.time()},
    ])
    obs.enable()
    rec = flight.FlightRecorder(os.path.join(d, "flight.p0.json"), shard=0)
    flight.install(rec)
    obs.get_registry().counter("w.windows").inc()
    rec.dump("kill")
    lines = timeline.render(timeline.load_run(d))
    assert any("BLACKBOX" in x and "reason=kill" in x for x in lines)


def test_timeline_orders_ts_less_metric_events_by_carry_forward(tmp_path):
    d = str(tmp_path)
    t0 = time.time()
    _write_events(os.path.join(d, "events.p0.jsonl"), [
        {"kind": "span", "name": "s", "ts": t0 + 1.0, "dur_s": 0.1, "sid": 1, "depth": 0},
        {"kind": "counter", "name": "resilience.ckpt_rejected", "v": 1},
    ])
    events = list(iter_shard_events(d))
    assert events[1]["ts"] == t0 + 1.0
    assert events == list(jcluster.iter_shard_events(d))


def test_timeline_story_vocabulary_equals_the_jax_packages():
    assert timeline.STORY == jtimeline.STORY
    for name in ("source.backpressure_stalls", "source.backpressure_resumes",
                 "fabric.exchange", "fabric.elect", "fabric.agree", "control.retune",
                 "eventtime.pane_close"):
        assert name in timeline.STORY
