"""Event-time windowing + retraction in the port (``eventtime/``) against
the JAX package: watermarks, panes and lateness, the sliding aggregator at
every pane boundary, the kill before commit, the commit artifact across
the two packages, the fault plan's ts skew, and skewed panes under
``superbatch="auto"``.

The sliding answers are held twice: against the from-scratch oracles on
the surviving multiset computed EXTERNALLY from the raw stream, and
against the JAX package's ``SlidingGraphAggregator`` fed the same chunks
(every ``WindowResult`` equal, labels, degrees, top-k and verdicts
exact).

Mirrors ``tests/test_eventtime.py:177-311``, ``:335`` and ``:390-513``
(the wire frames, the sharded socket path and serving come with later
slices). The auto-K case never reads the wall clock: the drive loop's
stopwatch (``summaries/groupfold.py:_clock``) is a stub.
"""

import itertools

import numpy as np
import pytest

from gelly_streaming_tpu import eventtime as jet
from gelly_streaming_tpu_torch import obs
from gelly_streaming_tpu_torch.eventtime import (
    NO_WATERMARK,
    EventTimeSlidingWindow,
    PaneAssembler,
    SlidingGraphAggregator,
    WatermarkTracker,
    drive_sliding,
    merge_watermarks,
    oracle_bipartite,
    oracle_degrees,
    oracle_labels,
)
from gelly_streaming_tpu_torch.resilience import faults
from gelly_streaming_tpu_torch.resilience.errors import SimulatedCrash
from gelly_streaming_tpu_torch.resilience.faults import FaultPlan

I64_MAX = int(np.iinfo(np.int64).max)


@pytest.fixture(autouse=True)
def _hygiene():
    obs.set_registry(None)
    faults.clear()
    yield
    faults.clear()
    obs.set_registry(None)


def counter_value(name, **labels):
    for lab, inst in obs.get_registry().find(name):
        if all(lab.get(k) == v for k, v in labels.items()):
            return inst.value
    return 0.0


def make_ts_stream(n, vmax, tmax, seed):
    """An in-order timestamped edge stream (sorted ts, as one shard's
    arrival order delivers it)."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, vmax, n).astype(np.int64)
    dst = rng.integers(0, vmax, n).astype(np.int64)
    ts = np.sort(rng.integers(0, tmax, n)).astype(np.int64)
    return src, dst, ts


def expected_top(deg, k=8):
    nz = np.nonzero(deg)[0]
    order = np.lexsort((nz, -deg[nz]))[:k]
    return [(int(v), int(deg[v])) for v in nz[order]]


def assert_window_matches_oracles(res, src, dst, ts):
    """The emitted window equals a from-scratch rebuild on the surviving
    multiset, computed from the RAW input stream."""
    m = (ts >= res.start) & (ts < res.end)
    s, d = src[m], dst[m]
    assert res.n_edges == int(m.sum())
    np.testing.assert_array_equal(res.labels, oracle_labels(len(res.labels), s, d))
    want_deg = oracle_degrees(len(res.degrees), s, d)
    np.testing.assert_array_equal(res.degrees, want_deg)
    assert res.top == expected_top(want_deg)
    assert res.bipartite == oracle_bipartite(len(res.degrees), s, d)


def assert_results_equal(got, want):
    """Port and JAX ``WindowResult`` lists, field by field, exactly."""
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert (a.index, a.start, a.end, a.event_ts, a.n_edges) == \
            (b.index, b.start, b.end, b.event_ts, b.n_edges)
        for f in ("labels", "degrees"):
            x, y = getattr(a, f), getattr(b, f)
            assert (x is None) == (y is None)
            if x is not None:
                np.testing.assert_array_equal(x, y)
        assert (a.top, a.bipartite, a.witness, a.repair) == \
            (b.top, b.bipartite, b.witness, b.repair)


# --------------------------------------------------------------------- #
# Watermarks: per shard, merged by min
# --------------------------------------------------------------------- #
def test_merge_is_min_and_one_silent_shard_pins_it():
    tr = WatermarkTracker(3)
    assert tr.current() == NO_WATERMARK == jet.NO_WATERMARK
    tr.observe(0, np.array([50], np.int64))
    tr.observe(1, np.array([80], np.int64))
    assert tr.current() == NO_WATERMARK  # shard 2 has not spoken
    tr.observe(2, np.array([30], np.int64))
    assert tr.current() == 30
    for marks in ([50, 80, 30], [], [NO_WATERMARK, 4]):
        assert merge_watermarks(marks) == jet.merge_watermarks(marks)
    assert merge_watermarks([]) == I64_MAX


def test_finished_shards_stop_holding_the_clock_back():
    tr = WatermarkTracker(2)
    tr.observe(0, np.array([100], np.int64))
    assert tr.current() == NO_WATERMARK
    tr.finish(1)
    assert tr.current() == 100
    tr.finish(0)
    assert tr.current() == I64_MAX
    state = tr.state_dict()
    back = WatermarkTracker(2)
    back.load_state_dict(state)
    assert back.state_dict() == state


def test_per_shard_watermarks_are_monotone():
    tr = WatermarkTracker(1)
    tr.observe(0, np.array([10, 40, 20], np.int64))
    assert tr.current() == 40
    tr.observe(0, np.array([5], np.int64))
    assert tr.current() == 40
    assert counter_value("eventtime.watermark_advance") >= 1
    with pytest.raises(ValueError, match="nshards"):
        WatermarkTracker(0)


# --------------------------------------------------------------------- #
# Lateness + pane cadence
# --------------------------------------------------------------------- #
def test_late_records_drop_counted_never_absorbed():
    agg = SlidingGraphAggregator(20, 10, summaries=("degree",))
    agg.push(np.array([1]), np.array([2]), np.array([35], np.int64))
    assert counter_value("eventtime.late_dropped") == 0
    results = agg.push(np.array([8]), np.array([9]), np.array([3], np.int64))
    assert counter_value("eventtime.late_dropped") == 1
    results += agg.finish()
    for r in results:
        assert len(r.degrees) <= 3
        assert all(v in (1, 2) for v, _ in r.top)


def test_lateness_allowance_keeps_panes_open_longer():
    strict = SlidingGraphAggregator(20, 10, summaries=("degree",))
    strict.push(np.array([1]), np.array([2]), np.array([2], np.int64))
    strict.push(np.array([1]), np.array([2]), np.array([12], np.int64))
    assert strict.assembler._next_pane == 1
    lax = SlidingGraphAggregator(20, 10, allowed_lateness=5, summaries=("degree",))
    lax.push(np.array([1]), np.array([2]), np.array([2], np.int64))
    lax.push(np.array([1]), np.array([2]), np.array([12], np.int64))
    assert lax.assembler._next_pane == 0
    lax.push(np.array([3]), np.array([4]), np.array([8], np.int64))
    assert counter_value("eventtime.late_dropped") == 0
    results = lax.advance_watermark(15)
    assert lax.assembler._next_pane == 1
    assert results[0].n_edges == 2
    assert results[0].degrees[3] == 1 and results[0].degrees[4] == 1


def test_empty_pane_slots_still_slide_the_window():
    agg = SlidingGraphAggregator(20, 10, summaries=("degree", "cc"))
    agg.push(np.array([1]), np.array([2]), np.array([0], np.int64))
    results = agg.advance_watermark(45)
    assert [r.index for r in results] == [0, 1, 2, 3]
    assert results[-1].n_edges == 0
    assert int(results[-1].degrees.sum()) == 0
    labels = results[-1].labels
    np.testing.assert_array_equal(labels, np.arange(len(labels)))


def test_policy_and_assembler_validate_and_round_trip():
    with pytest.raises(ValueError, match="multiple"):
        EventTimeSlidingWindow(10, 3)
    with pytest.raises(ValueError, match="slide"):
        EventTimeSlidingWindow(10, 20)
    with pytest.raises(ValueError, match="summary"):
        SlidingGraphAggregator(10, summaries=("cc", "pagerank"))
    asm = PaneAssembler(EventTimeSlidingWindow(10, 5), allowed_lateness=2)
    asm.add(np.array([1, 2]), np.array([3, 4]), np.array([1, 7], np.int64))
    state = asm.state_dict()
    ref = jet.PaneAssembler(jet.EventTimeSlidingWindow(10, 5), allowed_lateness=2)
    ref.load_state_dict(state)  # the reference reads the port's state
    back = PaneAssembler(EventTimeSlidingWindow(10, 5), allowed_lateness=2)
    back.load_state_dict(ref.state_dict())
    got, want = back.flush(), asm.flush()
    assert [(p.index, p.src.tolist(), p.ts.tolist()) for p in got] == \
        [(p.index, p.src.tolist(), p.ts.tolist()) for p in want]


# --------------------------------------------------------------------- #
# THE acceptance criterion: every pane boundary, against the oracles and
# against the JAX package
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sliding_answers_match_from_scratch_rebuild_every_boundary(seed):
    rng = np.random.default_rng(100 + seed)
    src, dst, ts = make_ts_stream(n=1500, vmax=48, tmax=160, seed=200 + seed)
    agg = SlidingGraphAggregator(40, 10, verify=True)
    ref = jet.SlidingGraphAggregator(40, 10)
    nw = agg.policy.panes_per_window
    results, want = [], []
    i = 0
    while i < len(src):  # randomized chunk boundaries
        k = int(rng.integers(1, 64))
        results.extend(agg.push(src[i:i + k], dst[i:i + k], ts[i:i + k]))
        want.extend(ref.push(src[i:i + k], dst[i:i + k], ts[i:i + k]))
        i += k
    results.extend(agg.finish())
    want.extend(ref.finish())
    assert counter_value("eventtime.late_dropped") == 0
    expiry_rounds = [r for r in results if r.index >= nw]
    assert len(expiry_rounds) >= 8
    for r in results:
        assert_window_matches_oracles(r, src, dst, ts)
    assert any(r.repair is not None and r.repair["refolded"] >= 0 for r in expiry_rounds)
    assert_results_equal(results, want)


def test_tumbling_is_the_degenerate_slide():
    src, dst, ts = make_ts_stream(n=400, vmax=24, tmax=60, seed=7)
    agg = SlidingGraphAggregator(20, verify=True)
    results = agg.push(src, dst, ts) + agg.finish()
    assert agg.policy.panes_per_window == 1
    for r in results:
        assert r.end - r.start == 20
        assert_window_matches_oracles(r, src, dst, ts)
    ref = jet.SlidingGraphAggregator(20)
    assert_results_equal(results, ref.push(src, dst, ts) + ref.finish())


def test_odd_cycle_expiry_unlatches_the_bipartite_verdict():
    agg = SlidingGraphAggregator(20, 10, summaries=("bipartite",))
    r = agg.push(np.array([0, 1, 2]), np.array([1, 2, 0]), np.array([1, 2, 3], np.int64))
    r += agg.push(np.array([0]), np.array([1]), np.array([12], np.int64))
    r += agg.push(np.array([1]), np.array([2]), np.array([22], np.int64))
    r += agg.finish()
    by_index = {w.index: w for w in r}
    assert by_index[0].bipartite is False and by_index[0].witness is not None
    assert by_index[1].bipartite is False
    assert by_index[2].bipartite is True and by_index[2].witness is None


def test_one_slow_shard_holds_the_whole_clock():
    agg = SlidingGraphAggregator(20, 10, nshards=2, summaries=("degree",))
    assert agg.push(np.array([1]), np.array([2]), np.array([35], np.int64), shard=0) == []
    assert agg.push(np.array([3]), np.array([4]), np.array([70], np.int64), shard=0) == []
    out = agg.push(np.array([5]), np.array([6]), np.array([45], np.int64), shard=1)
    assert [r.index for r in out] == [3]
    assert out[0].event_ts == 45
    assert counter_value("eventtime.late_dropped") == 0
    tail = agg.finish()
    assert [r.index for r in tail] == [4, 5, 6, 7]
    assert tail[0].degrees[5] == 1 and tail[0].degrees[6] == 1


def test_library_sliding_shapes_and_the_generator_drive():
    """``.sliding()`` of CC, degrees and bipartiteness configure the
    aggregator as the reference's do; ``drive_sliding`` over the
    generator's ts chunks equals the JAX package's drive."""
    from gelly_streaming_tpu.core.sources import GeneratorSource as JaxGen
    from gelly_streaming_tpu.library import ConnectedComponents as JaxCC
    from gelly_streaming_tpu_torch.core.sources import GeneratorSource
    from gelly_streaming_tpu_torch.library import (
        BipartitenessCheck,
        ConnectedComponents,
        DegreeDistribution,
    )

    assert ConnectedComponents.sliding(8, 4, nshards=2).tracker.nshards == 2
    assert DegreeDistribution.sliding(8).summaries == ("degree",)
    assert BipartitenessCheck.sliding(8, 2).policy.panes_per_window == 4

    def windows(gen):
        return ((0, s, d, None, t) for s, d, t in gen.iter_chunks_ts())

    got = drive_sliding(windows(GeneratorSource(scale=7, chunk=100, limit=1200, ts_rate=16)),
                        ConnectedComponents.sliding(16, 8, verify=True))
    want = jet.drive_sliding(windows(JaxGen(scale=7, chunk=100, limit=1200, ts_rate=16)),
                             JaxCC.sliding(16, 8))
    assert len(got) == 1200 // 16 // 8 + 1
    assert_results_equal(got, want)


# --------------------------------------------------------------------- #
# Chaos: kill between summary mutation and the state commit
# --------------------------------------------------------------------- #
def _chunks(n=800, seed=13):
    src, dst, ts = make_ts_stream(n=n, vmax=32, tmax=120, seed=seed)
    return [(src[i:i + 50], dst[i:i + 50], ts[i:i + 50]) for i in range(0, n, 50)]


def _run_all(agg, chunks):
    out = []
    for s, d, t in chunks:
        out.extend(agg.push(s, d, t))
    out.extend(agg.finish())
    return out


def test_kill_before_commit_recovers_oracle_identical(tmp_path):
    chunks = _chunks()
    baseline = _run_all(SlidingGraphAggregator(30, 10, verify=True), chunks)
    cdir = str(tmp_path / "commits")
    agg1 = SlidingGraphAggregator(30, 10, commit_dir=cdir)
    faults.install(FaultPlan(kill_at_window=5, kill_site="eventtime.retract",
                             kill_exit_code=None))
    with pytest.raises(SimulatedCrash):
        _run_all(agg1, chunks)
    faults.clear()
    agg2 = SlidingGraphAggregator(30, 10, commit_dir=cdir, verify=True)
    assert agg2.restore() is True
    assert agg2._done_panes == 5
    recovered = _run_all(agg2, chunks)
    assert counter_value("eventtime.late_dropped") > 0
    got = {r.index: r for r in recovered}
    want = {r.index: r for r in baseline}
    assert set(got) == {i for i in want if i >= 5}
    # the repair stats too: the restored state retracts what the
    # uninterrupted run retracted
    assert_results_equal([got[i] for i in sorted(got)], [want[i] for i in sorted(got)])


def test_commit_restore_round_trip_without_a_crash(tmp_path):
    src, dst, ts = make_ts_stream(n=300, vmax=20, tmax=60, seed=5)
    cdir = str(tmp_path / "c")
    agg = SlidingGraphAggregator(20, 10, commit_dir=cdir)
    agg.push(src, dst, ts)
    fresh = SlidingGraphAggregator(20, 10, commit_dir=cdir)
    assert fresh.restore() is True
    np.testing.assert_array_equal(fresh._cc.lab, agg._cc.lab)
    np.testing.assert_array_equal(fresh._deg.deg, agg._deg.deg)
    np.testing.assert_array_equal(fresh._bip.cover, agg._bip.cover)
    assert fresh._done_panes == agg._done_panes
    assert [p.index for p in fresh._live] == [p.index for p in agg._live]
    assert SlidingGraphAggregator(20, 10, commit_dir=str(tmp_path / "x")).restore() is False
    with pytest.raises(RuntimeError, match="commit_dir"):
        SlidingGraphAggregator(20, 10).commit()


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_commit_artifact_crosses_the_packages(tmp_path, writer):
    """A commit written by one package at pane 6 restores in the other and
    continues to the uninterrupted run's answers (both packages' replays
    of the whole source, every result equal)."""
    chunks = _chunks(seed=17)
    cut = 7  # chunks pushed before the writer stops
    cdir = str(tmp_path / "c")
    make_w = jet.SlidingGraphAggregator if writer == "jax" else SlidingGraphAggregator
    make_r = SlidingGraphAggregator if writer == "jax" else jet.SlidingGraphAggregator
    w = make_w(30, 10, commit_dir=cdir)
    for s, d, t in chunks[:cut]:
        w.push(s, d, t)
    done = w._done_panes
    assert done is not None and done > 3
    r = make_r(30, 10, commit_dir=cdir)
    assert r.restore() is True and r._done_panes == done
    resumed = _run_all(r, chunks)
    baseline = _run_all(make_r(30, 10), chunks)
    want = [b for b in baseline if b.index >= done]
    assert [x.index for x in resumed] == [x.index for x in want]
    for a, b in zip(resumed, want):
        assert a.n_edges == b.n_edges and a.top == b.top and a.bipartite == b.bipartite
        np.testing.assert_array_equal(a.labels, b.labels)
        np.testing.assert_array_equal(a.degrees, b.degrees)


def test_servable_payload_names_the_serving_slice():
    with pytest.raises(NotImplementedError, match="slice 9"):
        SlidingGraphAggregator(10).servable_payload()


# --------------------------------------------------------------------- #
# The fault plan's event-time skew
# --------------------------------------------------------------------- #
def test_ts_skew_is_deterministic_and_bounded():
    from gelly_streaming_tpu.resilience.faults import FaultPlan as JaxPlan

    records = [(i, i + 1, 0.0, 1000 + i) for i in range(10)]

    def skewed(plan_cls, seed):
        plan = plan_cls(seed=seed, skew_records=(2, 5), skew_ts_s=3)
        return list(plan.perturb_records(iter(records)))

    out1, out2 = skewed(FaultPlan, 7), skewed(FaultPlan, 7)
    assert out1 == out2 == skewed(JaxPlan, 7)
    for i, (orig, got) in enumerate(zip(records, out1)):
        if i in (2, 5):
            assert abs(got[3] - orig[3]) <= 3 and got[:3] == orig[:3]
        else:
            assert got == orig
    assert counter_value("resilience.fault_injected", site="source.perturb") >= 2


def test_skew_plan_perturbs_the_generator_ts_chunks():
    from gelly_streaming_tpu_torch.core.sources import GeneratorSource

    def all_ts():
        gen = GeneratorSource(scale=6, chunk=64, limit=256, ts_rate=8)
        return np.concatenate([t for _s, _d, t in gen.iter_chunks_ts()])

    clean = all_ts()
    with faults.injected(FaultPlan(seed=3, skew_records=(10,), skew_ts_s=5)):
        skewed = all_ts()
    diff = np.nonzero(clean != skewed)[0]
    assert list(diff) == [10] or len(diff) == 0
    if len(diff):
        assert abs(int(skewed[10]) - int(clean[10])) <= 5


def test_skewed_stream_feeds_the_lateness_policy():
    src = np.arange(40, dtype=np.int64) % 8
    dst = (np.arange(40, dtype=np.int64) + 1) % 8
    ts = np.arange(40, dtype=np.int64)
    plan = FaultPlan(seed=11, skew_records=(25,), skew_ts_s=30)
    recs = list(plan.perturb_records(
        iter([(int(s), int(d), 0.0, int(t)) for s, d, t in zip(src, dst, ts)])))
    agg = SlidingGraphAggregator(20, 10, verify=True)
    ref = jet.SlidingGraphAggregator(20, 10)
    got, want = [], []
    for s, d, _v, t in recs:
        got += agg.push(np.array([s]), np.array([d]), np.array([t], np.int64))
        want += ref.push(np.array([s]), np.array([d]), np.array([t], np.int64))
    assert_results_equal(got + agg.finish(), want + ref.finish())


# --------------------------------------------------------------------- #
# Skewed panes under superbatch="auto" (no wall clock)
# --------------------------------------------------------------------- #
def test_watermark_skew_under_auto_k_no_drops_no_oscillation(monkeypatch):
    """One shard's timestamps jitter by a bounded skew; with a lateness
    allowance covering it the assembler drops nothing, and the closed
    panes, in close order, streamed through ``ConnectedComponents(
    superbatch="auto")`` equal the JAX package's ``superbatch=1`` run
    emission for emission, with no K bouncing between two rungs more than
    once. The group stopwatch is a stub that advances one second per
    read, so K is decided from the taps, not the clock."""
    from gelly_streaming_tpu.core.stream import SimpleEdgeStream as JaxStream
    from gelly_streaming_tpu.core.window import CountWindow as JaxCount
    from gelly_streaming_tpu.datasets import IdentityDict as JaxIdentity
    from gelly_streaming_tpu.library import ConnectedComponents as JaxCC
    from gelly_streaming_tpu_torch import CountWindow, SimpleEdgeStream
    from gelly_streaming_tpu_torch.datasets import IdentityDict
    from gelly_streaming_tpu_torch.library import ConnectedComponents
    from gelly_streaming_tpu_torch.summaries import groupfold

    ticks = itertools.count()
    monkeypatch.setattr(groupfold, "_clock", lambda: float(next(ticks)))
    rng = np.random.default_rng(19)
    n = 1 << 13
    vmax = 1024
    src = rng.integers(0, vmax, n).astype(np.int64)
    dst = rng.integers(0, vmax, n).astype(np.int64)
    ts = np.arange(n, dtype=np.int64) // 8
    skew = 3
    plan = FaultPlan(seed=19, skew_records=tuple(range(1, n, 2)), skew_ts_s=skew)
    recs = list(plan.perturb_records(
        iter([(int(s), int(d), 0.0, int(t)) for s, d, t in zip(src, dst, ts)])))
    pts = np.array([r[3] for r in recs], np.int64)
    policy = EventTimeSlidingWindow(4, 4)
    assert (policy.pane_of(pts) != policy.pane_of(ts)).any()
    drop0 = counter_value("eventtime.late_dropped")
    tr = WatermarkTracker(2)
    asm = PaneAssembler(policy, allowed_lateness=2 * skew + 2)
    panes = []
    dropped = 0
    wm = tr.current()
    for lo in range(0, n, 512):
        chunk = recs[lo:lo + 512]
        for shard in (0, 1):
            mine = [r for i, r in enumerate(chunk) if (lo + i) % 2 == shard]
            dropped += asm.add(np.array([r[0] for r in mine], np.int64),
                               np.array([r[1] for r in mine], np.int64),
                               np.array([r[3] for r in mine], np.int64), wm)
            tr.observe(shard, np.array([r[3] for r in mine], np.int64))
        wm = tr.current()
        panes.extend(asm.advance(wm))
    panes.extend(asm.flush())
    assert dropped == 0
    assert counter_value("eventtime.late_dropped") == drop0
    live = [p for p in panes if len(p)]
    assert len(live) > 8
    cols = [p.cols() for p in live]
    src_all = np.concatenate([c[0] for c in cols])
    dst_all = np.concatenate([c[1] for c in cols])
    assert len(src_all) == n

    want = [str(c) for c in JaxCC(superbatch=1).run(JaxStream(
        (src_all, dst_all), window=JaxCount(64), vertex_dict=JaxIdentity(vmax)))]
    for carry in ("forest", "host"):
        agg = ConnectedComponents(superbatch="auto", carry=carry)
        auto = [str(c) for c in agg.run(SimpleEdgeStream(
            (src_all, dst_all), window=CountWindow(64), vertex_dict=IdentityDict(vmax),
            device="cpu"))]
        assert auto == want, carry
        moves = [(old, new) for old, new, _sig in agg.control.autok.history]
        assert moves
        kseq = [moves[0][0]] + [new for _old, new in moves]
        bounces: dict = {}
        i = 0
        while i + 2 < len(kseq):
            if kseq[i] == kseq[i + 2] != kseq[i + 1]:
                key = frozenset((kseq[i], kseq[i + 1]))
                bounces[key] = bounces.get(key, 0) + 1
                i += 2
            else:
                i += 1
        assert all(v <= 1 for v in bounces.values()), kseq
