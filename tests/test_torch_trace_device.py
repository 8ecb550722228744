"""The tracer's device spans, shared clock and window latency
(``gelly_streaming_tpu_torch/obs/trace.py``), on the CPU.

- every span event carries ``t0_ns`` on the shared clock, ordered for nested
  spans, and ``record_span`` derives it from ``ts`` and ``dur_s``;
- the device-record FIFO, driven by stand-in events with ``query`` and
  ``elapsed_time``: it resolves oldest first, once a window and never at a
  span exit, never blocks on the hot path, drains on ``disable()``, keeps
  nothing of a span that ``disable()`` overtook, and counts what it drops;
- ``window.upload`` fires once per ``to_device`` call with its ``bytes``;
- ``cc.host_read`` spans count exactly what ``labels.HOST_READS`` counts;
- one ``window.latency`` event a window through CC (every carry) and
  PageRank, from an in-memory stream and from a ``.gbin`` file (the
  device-encode path too);
- with tracing off no new site builds a span, reads the clock or makes a
  CUDA event;
- ``obs.timeline`` places events by ``t0_ns`` and renders ``.device``
  events as lines of their own.

The card's side (the anchor against ``torch.profiler``'s records) is in
``tests/test_torch_cuda.py``.
"""

import collections
import itertools
import sys
import threading

import numpy as np
import pytest
import torch

import gelly_streaming_tpu_torch as gt
from gelly_streaming_tpu_torch import datasets
from gelly_streaming_tpu_torch.core import edgeblock
from gelly_streaming_tpu_torch.library import ConnectedComponents, IncrementalPageRank
from gelly_streaming_tpu_torch.obs import timeline, trace
from gelly_streaming_tpu_torch.obs.registry import get_registry
from gelly_streaming_tpu_torch.summaries import labels

CARD = torch.device("cuda", 0)
ANCHOR_NS = 1_800_000_000_000_000_000


class Sink:
    def __init__(self):
        self.events = []

    def emit(self, event):
        self.events.append(event)

    def named(self, name):
        return [e for e in self.events if e["name"] == name]


@pytest.fixture
def sink():
    s = Sink()
    trace.add_sink(s)
    try:
        yield s
    finally:
        if trace.on():
            trace.disable()
        trace.remove_sink(s)


class FakeEvent:
    """A stand-in CUDA timing event at ``t_ms`` on the card's clock."""

    def __init__(self, t_ms, done=False):
        self.t_ms = t_ms
        self.done = done
        self.waits = 0
        self.queries = 0

    def query(self):
        self.queries += 1
        return self.done

    def synchronize(self):
        self.waits += 1
        self.done = True

    def elapsed_time(self, other):
        return other.t_ms - self.t_ms


@pytest.fixture
def fake_card(monkeypatch, sink):
    """Tracing on with card 0 anchored at ``ANCHOR_NS`` (its event at 0 ms)
    and ``_record_event`` handing out the stand-ins queued in ``events``."""
    queue = collections.deque()
    made = []

    def record(index):
        assert index == 0
        ev = queue.popleft()
        made.append(ev)
        return ev

    monkeypatch.setattr(trace, "_record_event", record)
    trace.enable()
    trace._ANCHORS[0] = (FakeEvent(0.0, True), ANCHOR_NS)
    return queue, made


def _dropped():
    found = get_registry().find("trace.device_spans_dropped")
    return sum(inst.value for _, inst in found)


# --------------------------------------------------------------------- #
# t0_ns
# --------------------------------------------------------------------- #
def test_span_events_carry_t0_ns_ordered_for_nested_spans(sink):
    trace.enable()
    with trace.span("outer"):
        with trace.span("inner"):
            pass
        with trace.span("second"):
            pass
    trace.disable()
    outer, inner, second = (sink.named(n)[0] for n in ("outer", "inner", "second"))
    for e in (outer, inner, second):
        assert isinstance(e["t0_ns"], int)
    assert outer["t0_ns"] <= inner["t0_ns"] <= second["t0_ns"]
    assert inner["t0_ns"] + inner["dur_s"] * 1e9 <= second["t0_ns"]
    assert second["t0_ns"] + second["dur_s"] * 1e9 <= outer["t0_ns"] + outer["dur_s"] * 1e9 + 1e3
    assert abs(outer["t0_ns"] / 1e9 + outer["dur_s"] - outer["ts"]) < 0.05


def test_record_span_start_is_its_end_less_its_duration(sink):
    trace.enable()
    trace.record_span("late", 0.25, ts=100.0)
    trace.record_span("placed", 0.5, ts=100.0, t0_ns=7)
    trace.disable()
    assert sink.named("late")[0]["t0_ns"] == 99_750_000_000
    assert sink.named("placed")[0]["t0_ns"] == 7


# --------------------------------------------------------------------- #
# The device-record FIFO
# --------------------------------------------------------------------- #
def test_device_spans_resolve_oldest_first_without_blocking(fake_card, sink):
    queue, made = fake_card
    queue.extend([FakeEvent(1.0), FakeEvent(3.0), FakeEvent(4.0), FakeEvent(10.0)])
    with trace.span("a", {"k": 1}, device=CARD):
        pass
    with trace.span("b", device=CARD):
        pass
    assert sink.named("a.device") == [] and sink.named("b.device") == []
    made[1].done = True  # a's end
    made[3].done = True  # b's end, but b waits behind nothing now
    trace.window_done(None, CARD)
    a_dev, b_dev = sink.named("a.device"), sink.named("b.device")
    assert len(a_dev) == 1 and len(b_dev) == 1
    assert [e["name"] for e in sink.events if e["name"].endswith(".device")] == [
        "a.device", "b.device"]
    a = a_dev[0]
    assert a["t0_ns"] == ANCHOR_NS + 1_000_000
    assert a["dur_s"] == pytest.approx(2e-3)
    assert a["ts"] == pytest.approx((ANCHOR_NS + 3_000_000) / 1e9)
    assert a["parent"] == sink.named("a")[0]["sid"] and a["attrs"] == {"k": 1}
    assert b_dev[0]["t0_ns"] == ANCHOR_NS + 4_000_000
    assert b_dev[0]["dur_s"] == pytest.approx(6e-3)
    assert all(ev.waits == 0 for ev in made)
    assert not trace._PENDING


def test_an_incomplete_oldest_record_holds_the_later_ones(fake_card, sink):
    queue, made = fake_card
    queue.extend([FakeEvent(0.0), FakeEvent(5.0), FakeEvent(5.0), FakeEvent(6.0, True)])
    with trace.span("slow", device=CARD):
        pass
    with trace.span("quick", device=CARD):
        pass
    for _ in range(3):
        trace.window_done(None, CARD)
    assert sink.named("slow.device") == [] and sink.named("quick.device") == []
    assert len(trace._PENDING) == 2 and all(ev.waits == 0 for ev in made)


def test_span_exits_inside_a_window_poll_nothing(fake_card, sink):
    """The FIFO is read once a window: host spans and device spans that
    exit while records are pending (a carry's host reads) query no event."""
    queue, made = fake_card
    queue.extend([FakeEvent(1.0, True), FakeEvent(2.0, True)])
    with trace.span("engine.dispatch", device=CARD):
        for _ in range(10):
            with trace.span("cc.host_read"):
                pass
    for _ in range(10):
        with trace.span("cc.host_read"):
            pass
    assert len(trace._PENDING) == 1 and sink.named("engine.dispatch.device") == []
    assert all(ev.queries == 0 for ev in made)
    trace.window_done(None, CARD)
    assert len(sink.named("engine.dispatch.device")) == 1 and not trace._PENDING


def test_a_device_span_open_across_disable_keeps_nothing(fake_card, sink):
    """A device span entered while tracing is on and exited after
    ``disable()`` (another thread's encode, say) pushes no record and
    raises nothing; a record pushed against the anchor ``disable()``
    cleared is dropped after the next ``enable()``, not timed against it."""
    queue, made = fake_card
    queue.extend([FakeEvent(1.0, True), FakeEvent(2.0, True)])
    span = trace.span("late", device=CARD)
    span.__enter__()
    trace.disable()
    span.__exit__(None, None, None)
    assert not trace._PENDING and sink.named("late.device") == []
    assert len(made) == 1 and len(queue) == 1  # no end event was recorded
    queue.clear()

    # a record made just before disable(), pushed just after it
    trace.enable()
    trace._ANCHORS[0] = (FakeEvent(0.0, True), ANCHOR_NS)
    stale = trace._DeviceRecord("stale.device", FakeEvent(1.0, True), FakeEvent(2.0, True),
                                0, None, None, None, None)
    trace.disable()
    trace._push(stale)
    trace.enable()
    trace._ANCHORS[0] = (FakeEvent(0.0, True), ANCHOR_NS + 7)
    queue.extend([FakeEvent(3.0, True), FakeEvent(4.0, True)])
    with trace.span("fresh", device=CARD):
        pass
    trace.window_done(None, CARD)
    assert sink.named("stale.device") == [] and not trace._PENDING
    (e,) = sink.named("fresh.device")
    assert e["t0_ns"] == ANCHOR_NS + 7 + 3_000_000


def test_disable_drains_the_fifo(fake_card, sink):
    queue, made = fake_card
    queue.extend([FakeEvent(2.0), FakeEvent(2.5)])
    with trace.span("last", device=CARD):
        pass
    trace.disable()
    assert made[1].waits == 1
    (e,) = sink.named("last.device")
    assert e["dur_s"] == pytest.approx(0.5e-3)
    assert not trace._PENDING and not trace._ANCHORS and not trace.on()


def test_a_full_fifo_emits_what_is_complete_before_it_drops(fake_card, sink, monkeypatch):
    queue, _ = fake_card
    monkeypatch.setattr(trace, "DEVICE_PENDING_MAX", 2)
    before = _dropped()
    for i in range(5):
        queue.extend([FakeEvent(float(i)), FakeEvent(i + 0.5, True)])
        with trace.span(f"s{i}", device=CARD):
            pass
    assert _dropped() == before and len(trace._PENDING) <= 2
    trace.disable()
    assert [e["name"] for e in sink.events if e["name"].endswith(".device")] == [
        f"s{i}.device" for i in range(5)]


def test_a_full_fifo_drops_its_oldest_and_counts_it(fake_card, sink, monkeypatch):
    queue, _ = fake_card
    monkeypatch.setattr(trace, "DEVICE_PENDING_MAX", 2)
    before = _dropped()
    for i in range(3):
        queue.extend([FakeEvent(float(i)), FakeEvent(i + 0.5)])
        with trace.span(f"s{i}", device=CARD):
            pass
    assert _dropped() == before + 1
    trace.disable()
    assert [e["name"] for e in sink.events if e["name"].endswith(".device")] == [
        "s1.device", "s2.device"]


def test_window_done_on_a_card_reads_completion_on_the_shared_clock(fake_card, sink):
    queue, _ = fake_card
    queue.append(FakeEvent(20.0, True))
    cut = ANCHOR_NS + 5_000_000
    trace.window_done(cut, CARD)
    (e,) = sink.named("window.latency")
    assert e["t0_ns"] == cut
    assert e["dur_s"] == pytest.approx(15e-3)
    assert "parent" not in e


def test_device_spans_from_many_threads_all_resolve(monkeypatch, sink):
    """16 threads open device spans at once, with a short switch interval:
    every pair becomes exactly one ``.device`` event, timed by its own two
    events, and nothing is left pending or dropped."""
    clock = itertools.count(1)
    lock = threading.Lock()

    def record(index):
        with lock:
            return FakeEvent(float(next(clock)), True)

    monkeypatch.setattr(trace, "_record_event", record)
    trace.enable()
    trace._ANCHORS[0] = (FakeEvent(0.0, True), ANCHOR_NS)
    before = _dropped()

    def work(k):
        for i in range(100):
            with trace.span(f"t{k}", {"i": i}, device=CARD):
                pass

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=work, args=(k,)) for k in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    trace.disable()
    hosts = {e["sid"]: e for e in sink.events if not e["name"].endswith(".device")}
    devs = [e for e in sink.events if e["name"].endswith(".device")]
    assert len(devs) == len(hosts) == 1600 and _dropped() == before
    assert {e["parent"] for e in devs} == set(hosts)
    for e in devs:
        host = hosts[e["parent"]]
        assert e["name"] == host["name"] + ".device" and e["attrs"] == host["attrs"]
        assert e["dur_s"] > 0 and e["t0_ns"] > ANCHOR_NS
    assert not trace._PENDING


def test_a_cpu_device_span_is_a_host_span(sink):
    trace.enable()
    with trace.span("cpu_work", device=torch.device("cpu")):
        pass
    trace.disable()
    assert len(sink.named("cpu_work")) == 1
    assert sink.named("cpu_work.device") == []


# --------------------------------------------------------------------- #
# The new host spans
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("dtype, n", [(np.int32, 1000), (np.float32, 7), (np.bool_, 0)])
def test_window_upload_fires_once_per_to_device_with_its_bytes(sink, dtype, n):
    a = np.zeros(n, dtype)
    trace.enable()
    out = edgeblock.to_device(a, torch.device("cpu"))
    trace.disable()
    (e,) = sink.named("window.upload")
    assert e["attrs"] == {"bytes": a.nbytes}
    assert out.shape == (n,)


@pytest.mark.parametrize("form", ["fold", "combine"])
def test_cc_host_read_spans_count_what_host_reads_counts(sink, form):
    rng = np.random.default_rng(3)
    vcap = 64
    state = labels.init_labels(vcap, "cpu")
    src = torch.from_numpy(rng.integers(0, vcap, 40).astype(np.int32))
    dst = torch.from_numpy(rng.integers(0, vcap, 40).astype(np.int32))
    mask = torch.ones(40, dtype=torch.bool)
    before = labels.HOST_READS
    trace.enable()
    a = labels.cc_fold(state, src, dst, mask)
    if form == "combine":
        b = labels.cc_fold(state, dst, torch.roll(src, 1), mask)
        labels.label_combine(a, b)
    trace.disable()
    reads = labels.HOST_READS - before
    assert reads > 0
    assert len(sink.named("cc.host_read")) == reads


# --------------------------------------------------------------------- #
# Window latency
# --------------------------------------------------------------------- #
def _edges(n=1200, ids=300, seed=11):
    rng = np.random.default_rng(seed)
    return rng.integers(0, ids, (n, 2)).astype(np.int32)


def _gbin(tmp_path, cols):
    path = str(tmp_path / "edges.gbin")
    datasets.write_binary(path, cols[:, 0], cols[:, 1])
    return path


def _run_cc(stream, carry):
    return sum(1 for _ in stream.aggregate(ConnectedComponents(carry=carry)))


def _run_pr(stream):
    return sum(1 for _ in IncrementalPageRank(max_iter=20).run(stream))


# the device-encode path takes no vertex dict: it is CC's cell path only
@pytest.mark.parametrize("job, source", [
    (job, source)
    for job in ("cc-dense", "cc-host", "cc-forest", "pagerank")
    for source in ("memory", "gbin", "gbin-device-encode")
    if not (job == "pagerank" and source == "gbin-device-encode")
])
def test_one_window_latency_event_a_window(sink, tmp_path, job, source):
    cols = _edges()
    if source == "memory":
        stream = gt.SimpleEdgeStream([tuple(map(int, r)) for r in cols],
                                     window=gt.CountWindow(256), device="cpu")
    else:
        kw = {}
        if source == "gbin-device-encode":
            kw = dict(device_encode=True, min_vertex_capacity=512)
        elif job == "pagerank":
            kw = dict(vertex_dict=datasets.IdentityDict(512))
        stream = datasets.stream_file(_gbin(tmp_path, cols), window=gt.CountWindow(256),
                                      device="cpu", **kw)
    trace.enable()
    n = _run_pr(stream) if job == "pagerank" else _run_cc(stream, job[3:])
    trace.disable()
    lat = sink.named("window.latency")
    assert n == 5 and len(lat) == n
    for e in lat:
        assert e["dur_s"] > 0
        assert e["t0_ns"] + e["dur_s"] * 1e9 <= e["ts"] * 1e9 + 1e6


def test_blocks_made_with_tracing_off_have_no_cut():
    block = edgeblock.EdgeBlock.from_arrays(
        np.arange(4, dtype=np.int32), np.arange(4, dtype=np.int32), n_vertices=4, device="cpu")
    assert block.cut_ns is None


# --------------------------------------------------------------------- #
# Tracing off costs nothing new
# --------------------------------------------------------------------- #
def test_tracing_off_builds_no_span_reads_no_clock_makes_no_event(monkeypatch, tmp_path):
    calls = collections.Counter()
    real_span, real_time = trace.Span, trace.time

    def counting_span(*a, **k):
        calls["span"] += 1
        return real_span(*a, **k)

    class CountingTime:
        """The tracer's ``time`` module, every clock read counted."""

        def __getattr__(self, name):
            attr = getattr(real_time, name)
            if not callable(attr):
                return attr

            def counted(*a, **k):
                calls["clock"] += 1
                return attr(*a, **k)

            return counted

    class CountingEvent:
        def __init__(self, *a, **k):
            calls["event"] += 1

    monkeypatch.setattr(trace, "Span", counting_span)
    monkeypatch.setattr(trace, "time", CountingTime())
    monkeypatch.setattr(trace, "_record_event", lambda index: calls.update(["event"]))
    monkeypatch.setattr(torch.cuda, "Event", CountingEvent)
    assert not trace.on()
    cols = _edges()
    path = _gbin(tmp_path, cols)
    stream = datasets.stream_file(path, window=gt.CountWindow(256), device="cpu",
                                  device_encode=True, min_vertex_capacity=512)
    assert _run_cc(stream, "auto") == 5
    stream = datasets.stream_file(path, window=gt.CountWindow(256), device="cpu",
                                  vertex_dict=datasets.IdentityDict(512))
    assert _run_pr(stream) == 5
    edgeblock.to_device(np.zeros(8, np.int32), torch.device("cpu"))
    labels.cc_fold(labels.init_labels(8, "cpu"), torch.arange(4, dtype=torch.int32),
                   torch.arange(1, 5, dtype=torch.int32), torch.ones(4, dtype=torch.bool))
    trace.window_done(123, torch.device("cpu"))
    assert calls == collections.Counter()


# --------------------------------------------------------------------- #
# obs.timeline on the shared clock
# --------------------------------------------------------------------- #
def _span(name, ts, t0_ns=None, dur_s=0.01):
    e = {"kind": "span", "name": name, "ts": ts, "dur_s": dur_s, "sid": 1, "depth": 0}
    if t0_ns is not None:
        e["t0_ns"] = t0_ns
    return e


@pytest.mark.parametrize("e, placed", [
    (_span("a", 10.5, 10_000_000_000), 10.0),
    (_span("b", 10.5), 10.5),
    ({"kind": "counter", "name": "c", "ts": 3.0, "v": 1}, 3.0),
    ({"kind": "counter", "name": "c"}, 0.0),
])
def test_timeline_places_an_event_at_its_start_else_its_ts(e, placed):
    assert timeline.when(e) == pytest.approx(placed)


def test_timeline_orders_by_start_and_renders_device_lines_of_their_own():
    host = _span("engine.dispatch", ts=12.0, t0_ns=10_000_000_000, dur_s=2.0)
    dev = _span("engine.dispatch.device", ts=11.5, t0_ns=10_200_000_000, dur_s=1.3)
    later = _span("cc.host_read", ts=10.6, t0_ns=10_500_000_000, dur_s=0.1)
    plain = {"kind": "counter", "name": "resilience.restarts", "ts": 10.3, "v": 1}
    events = sorted([later, dev, plain, host], key=timeline.when)
    assert [e["name"] for e in events] == [
        "engine.dispatch", "engine.dispatch.device", "resilience.restarts", "cc.host_read"]
    lines = timeline.render(events, all_events=True)
    assert len(lines) == 4
    assert lines[0].startswith("+   0.000s") and "SPAN" in lines[0]
    assert lines[1].startswith("+   0.200s") and "DEVICE" in lines[1]
    assert "engine.dispatch.device" in lines[1] and "dur=1.3s" in lines[1]
    assert lines[3].startswith("+   0.500s")
    window = timeline.filter_events(events, since=10.1, until=10.4)
    assert [e["name"] for e in window] == ["engine.dispatch.device", "resilience.restarts"]


def test_timeline_load_run_orders_a_jsonl_log_by_start(tmp_path):
    from gelly_streaming_tpu_torch.obs.export import JsonlSink

    path = tmp_path / "events.jsonl"
    jsink = JsonlSink(str(path))
    trace.add_sink(jsink)
    trace.enable()
    try:
        with trace.span("outer"):
            with trace.span("inner"):
                pass
    finally:
        trace.disable()
        trace.remove_sink(jsink)
    jsink.write()
    names = [e["name"] for e in timeline.load_run(str(path)) if e.get("kind") == "span"]
    assert names == ["outer", "inner"]
