"""The self-tuning control plane of the port (``control/``), the dynamic
superbatch packers and ``superbatch="auto"``, against the JAX package.

Controller dynamics are pinned on SCRIPTED taps fed to ``tap_group`` /
``tap_put``/``tap_get`` / ``tap_sweep`` directly: the port's tuner and the
JAX package's, fed the same sequence, must log the same ``history`` of
(from, to, signal), and each must do what the reference's tests require
(convergence, no oscillation under noise, bounded steps, the window-size
shift). The end-to-end ``superbatch="auto"`` runs never decide K from the
wall clock: the drive loop's stopwatch (``summaries/groupfold.py:_clock``)
is a stub that advances one second per read, or the controller is a
script that moves K mid-stream, in which case the port's emissions equal
the JAX package's under the same script (integers exactly, ranks within
the PageRank parity tests' 1e-6).

Mirrors ``tests/test_control.py:31-406`` and ``:470-786`` (the serving,
coordination and timeline cases come with later slices).
"""

import itertools

import numpy as np
import pytest

import gelly_streaming_tpu as gj
import gelly_streaming_tpu.control as jctl
import gelly_streaming_tpu_torch as gt
from gelly_streaming_tpu.core import window as jwin
from gelly_streaming_tpu.core.vertexdict import VertexDict as JaxVertexDict
from gelly_streaming_tpu.datasets import IdentityDict as JaxIdentity
from gelly_streaming_tpu_torch import obs
from gelly_streaming_tpu_torch.control import (
    AdmissionTuner,
    AutoK,
    ControlPlane,
    PrefetchTuner,
    SignalReader,
)
from gelly_streaming_tpu_torch.core.vertexdict import VertexDict
from gelly_streaming_tpu_torch.core.window import (
    CountWindow,
    ScheduledCountWindow,
    Windower,
)
from gelly_streaming_tpu_torch.datasets import IdentityDict
from gelly_streaming_tpu_torch.obs import trace
from gelly_streaming_tpu_torch.summaries import groupfold


@pytest.fixture(autouse=True)
def _fresh_obs():
    trace.disable()
    obs.set_registry(None)
    yield
    trace.disable()
    obs.set_registry(None)


@pytest.fixture
def tick_clock(monkeypatch):
    """The drive loop's group stopwatch as a stub: one second per read, so
    every group's wall is 1 s and its throughput its edge count."""
    ticks = itertools.count()
    monkeypatch.setattr(groupfold, "_clock", lambda: float(next(ticks)))


# --------------------------------------------------------------------- #
# SignalReader
# --------------------------------------------------------------------- #
def test_signal_reader_direct_taps_work_without_obs():
    r = SignalReader()
    assert r.last("x") is None
    r.observe("x", 0.5)
    r.observe("x", 0.25)
    assert r.last("x") == 0.25
    assert r.total("x") == (2, 0.75)


def test_signal_reader_registry_deltas_window():
    r = SignalReader()
    trace.enable()
    reg = obs.get_registry()
    reg.counter("pipeline.consumer_idle_s").inc(2.0)
    assert r.counter_delta("pipeline.consumer_idle_s") == pytest.approx(2.0)
    assert r.counter_delta("pipeline.consumer_idle_s") == 0.0
    reg.counter("pipeline.consumer_idle_s").inc(0.5)
    assert r.counter_delta("pipeline.consumer_idle_s") == pytest.approx(0.5)
    reg.histogram("trace.span_seconds", span="window.pack").observe(0.003)
    n, s = r.span_delta("window.pack")
    assert n == 1 and s == pytest.approx(0.003)
    assert r.span_delta("window.pack") == (0.0, 0.0)


def test_signal_reader_registry_reads_are_zero_when_disabled():
    r = SignalReader()
    obs.get_registry().counter("pipeline.consumer_idle_s").inc(3.0)
    assert r.counter_delta("pipeline.consumer_idle_s") == 0.0
    assert r.span_delta("window.pack") == (0.0, 0.0)


# --------------------------------------------------------------------- #
# AutoK on scripted throughput landscapes, beside the JAX package's
# --------------------------------------------------------------------- #
def _drive(ak, eps_of_k, *, taps, window=1024, noise=None, seed=0):
    """Feed ``taps`` synthetic group measurements from an eps(k) landscape
    (as the reference test feeds it)."""
    rng = np.random.default_rng(seed)
    for _ in range(taps):
        k = ak.current_k()
        eps = eps_of_k(k)
        if noise:
            eps *= 1.0 + rng.uniform(-noise, noise)
        edges = k * window
        ak.tap_group(k, edges, edges / eps)
    return list(ak.history)


def _pair(**kw):
    return AutoK(**kw), jctl.AutoK(**kw)


def test_autok_converges_to_the_knee_and_holds():
    landscape = {1: 1.0, 4: 3.6, 16: 9.0, 64: 11.0, 256: 11.2}
    for ak in _pair(decide_groups=2):
        _drive(ak, lambda k: landscape[k], taps=40)
        assert ak.k == 64, ak.history
        before = len(ak.history)
        _drive(ak, lambda k: landscape[k], taps=60)
        assert len(ak.history) == before
    port, ref = _pair(decide_groups=2)
    assert _drive(port, lambda k: landscape[k], taps=100) == \
        _drive(ref, lambda k: landscape[k], taps=100)


def test_autok_no_oscillation_under_noise():
    landscape = {1: 1.0, 4: 3.9, 16: 8.0, 64: 8.3, 256: 8.1}
    hist = []
    for ak in _pair(decide_groups=2):
        _drive(ak, lambda k: landscape[k], taps=60, noise=0.05, seed=7)
        settled, n_before = ak.k, len(ak.history)
        _drive(ak, lambda k: landscape[k], taps=300, noise=0.05, seed=8)
        assert ak.k == settled
        assert len(ak.history) == n_before, ak.history[n_before:]
        hist.append(ak.history)
    assert hist[0] == hist[1]


def test_autok_steps_are_bounded():
    landscape = {1: 1.0, 4: 4.0, 16: 16.0, 64: 60.0, 256: 200.0}
    port, ref = _pair(decide_groups=1)
    moves = _drive(port, lambda k: landscape[k], taps=30)
    assert moves == _drive(ref, lambda k: landscape[k], taps=30)
    for old, new, _sig in moves:
        assert max(old, new) <= min(old, new) * port.step
    assert port.k == 256


def test_autok_adapts_down_on_window_size_shift():
    def eps(k, window):
        edges = k * window
        return edges / (1.0 + 1e-3 * edges)  # per-dispatch fixed + linear

    def feed(ak, window):
        for _ in range(40):
            k = ak.current_k()
            e = k * window
            ak.tap_group(k, e, e / eps(k, window))

    hist = []
    for ak in _pair(decide_groups=2):
        feed(ak, 1024)
        k_small = ak.k
        assert k_small >= 16, ak.history
        n_before = len(ak.history)
        feed(ak, 16384)  # mid-stream shift: windows grew 16x
        assert ak.k < k_small, ak.history[n_before:]
        assert any(sig == "window-shift" for _o, _n, sig in ak.history[n_before:])
        hist.append(ak.history)
    assert hist[0] == hist[1]


def test_autok_excludes_foreign_time_from_group_taps():
    from gelly_streaming_tpu.control import signals as jsig
    from gelly_streaming_tpu_torch.control.signals import add_excluded_s, take_excluded_s

    landscape = {1: 1.0, 4: 4.0, 16: 16.0, 64: 64.0, 256: 256.0}
    for ak, add, take in ((AutoK(decide_groups=1), add_excluded_s, take_excluded_s),
                          (jctl.AutoK(decide_groups=1), jsig.add_excluded_s,
                           jsig.take_excluded_s)):
        take()
        for i in range(8):
            k = ak.current_k()
            edges = k * 1024
            honest = edges / landscape[k]
            if i == 2:
                add(20.0 * honest)
            ak.tap_group(k, edges, honest + (20.0 * honest if i == 2 else 0.0))
        assert all(sig != "probe-reverted" for _o, _n, sig in ak.history), ak.history
        assert ak.k == 256
        assert take() == 0.0


def test_autok_pinned_when_k0_equals_k_max():
    ak = AutoK(k0=8, k_max=8, decide_groups=1)
    _drive(ak, lambda k: float(k), taps=50)
    assert ak.k == 8 and ak.history == []
    with pytest.raises(ValueError, match="step"):
        AutoK(step=1)


def test_autok_span_hint_breaks_a_hold():
    trace.enable()
    reg = obs.get_registry()
    ak = AutoK(decide_groups=1)
    flat = {1: 5.0, 4: 5.0, 16: 5.0, 64: 5.0, 256: 5.0}
    ak._base = (1, 5.0)
    ak._enter_hold(5.0)
    _drive(ak, lambda k: flat[k], taps=1)
    assert ak.k == 1 and ak.history == []
    reg.histogram("trace.span_seconds", span="engine.dispatch").observe(0.5)
    reg.histogram("trace.span_seconds", span="window.pack").observe(0.001)
    _drive(ak, lambda k: flat[k], taps=1)
    assert any(sig == "dispatch-share" for _o, _n, sig in ak.history)
    _drive(ak, lambda k: 0.1, taps=1)
    assert ak.history[-1][2] == "probe-reverted"
    n = len(ak.history)
    reg.histogram("trace.span_seconds", span="engine.dispatch").observe(0.5)
    reg.histogram("trace.span_seconds", span="window.pack").observe(0.001)
    for _ in range(ak.cooldown + 2):
        _drive(ak, lambda k: flat[k], taps=1)
    assert all(s != "dispatch-share" for _o, _n2, s in ak.history[n:])


def test_retune_decisions_are_logged_when_obs_on():
    trace.enable()
    ak = AutoK(decide_groups=1)
    _drive(ak, lambda k: float(k), taps=6)
    assert ak.history
    hits = obs.get_registry().find("control.retune")
    assert hits
    labels = [lab for lab, _i in hits]
    assert all(lab["knob"] == "superbatch_k" for lab in labels)
    assert all({"from", "to", "signal"} <= set(lab) for lab in labels)
    # obs off: the knob still moves, nothing is logged
    obs.set_registry(None)
    trace.disable()
    quiet = AutoK(decide_groups=1)
    _drive(quiet, lambda k: float(k), taps=6)
    assert quiet.history == ak.history and not obs.get_registry().find("control.retune")


def test_default_plane_shape():
    from gelly_streaming_tpu_torch.control import default_plane

    plane = default_plane(4)
    assert plane.autok.k == 4 and isinstance(plane.prefetch, PrefetchTuner)
    assert plane.autok.signals is plane.signals
    assert ControlPlane().autok is None


# --------------------------------------------------------------------- #
# PrefetchTuner and AdmissionTuner
# --------------------------------------------------------------------- #
def _drive_prefetch(pt, *, idle_s, blocked_s, items):
    per = max(1, pt.decide_items)
    for _ in range(items):
        pt.tap_put(blocked_s / per)
        pt.tap_get(idle_s / per)


def _stub(pt):
    t = [0.0]

    def clock():
        t[0] += 0.01
        return t[0]

    pt._clock = clock
    return pt


@pytest.mark.parametrize("case", ["idle", "blocked", "deadband"])
def test_prefetch_tuner_moves_like_the_jax_package(case):
    depth, idle, blocked, items = {
        "idle": (2, 0.04 * 8, 0.0, 40),
        "blocked": (8, 0.0, 0.04 * 8, 40),
        "deadband": (4, 0.001, 0.001, 100),
    }[case]
    port = _stub(PrefetchTuner(depth=depth, decide_items=8))
    ref = _stub(jctl.PrefetchTuner(depth=depth, decide_items=8))
    for pt in (port, ref):
        _drive_prefetch(pt, idle_s=idle, blocked_s=blocked, items=items)
    assert port.history == ref.history and port.depth == ref.depth
    if case == "idle":
        assert port.depth > 2 and port.depth <= port.depth_max
        assert all(sig == "consumer-idle" for _o, _n, sig in port.history)
    elif case == "blocked":
        assert port.depth_min <= port.depth < 8
        assert all(sig == "producer-blocked" for _o, _n, sig in port.history)
    else:
        assert port.depth == 4 and port.history == []


def test_prefetch_with_tuner_preserves_order_and_bounds_depth():
    from gelly_streaming_tpu_torch.core.pipeline import prefetch

    pt = PrefetchTuner(depth=2, depth_max=4, decide_items=4)
    out, seen = [], []
    for x in prefetch(iter(range(200)), tuner=pt):
        out.append(x)
        seen.append(pt.depth)
    assert out == list(range(200))
    assert all(pt.depth_min <= d <= pt.depth_max for d in seen)


def _sweeps(at, waits):
    moved = []
    for w, b in waits:
        moved.append(at.tap_sweep(w, b))
    return moved


@pytest.mark.parametrize("case", ["shed", "recover", "hold", "floor"])
def test_admission_tuner_moves_like_the_jax_package(case):
    kw, waits = {
        "shed": (dict(max_pending=1000, decide_sweeps=2), [(0.9, 1.0)] * 4),
        "recover": (dict(max_pending=1000, decide_sweeps=1, cooldown=0),
                    [(0.9, 1.0)] + [(0.01, 1.0)] * 40),
        "hold": (dict(max_pending=512, decide_sweeps=1, cooldown=0),
                 [(0.35, 1.0)] * 20 + [(5.0, None)] * 20),
        "floor": (dict(max_pending=100, decide_sweeps=1, cooldown=0, floor_frac=0.2),
                  [(10.0, 1.0)] * 50),
    }[case]
    port, ref = AdmissionTuner(**kw), jctl.AdmissionTuner(**kw)
    assert _sweeps(port, waits) == _sweeps(ref, waits)
    assert port.history == ref.history
    assert (port.max_pending, port.shed_watermark) == (ref.max_pending, ref.shed_watermark)
    if case == "shed":
        assert port.floor <= port.max_pending < 1000 and port.shed_level() < 800
    elif case == "recover":
        assert port.max_pending == 1000
        assert port.shed_watermark == pytest.approx(port.shed_watermark_ceiling)
    elif case == "hold":
        assert port.max_pending == 512 and port.history == []
    else:
        assert port.max_pending == port.floor == 20
    # the raw-entry form computes the tightest budget
    a, b = AdmissionTuner(max_pending=10, decide_sweeps=1), \
        jctl.AdmissionTuner(max_pending=10, decide_sweeps=1)
    entries = [(0.0, 2.0), (1.0, None), (0.5, 1.0)]
    assert a.tap_entries(0.9, entries) == b.tap_entries(0.9, entries)
    assert a.history == b.history


# --------------------------------------------------------------------- #
# Dynamic packing + checkpoint alignment
# --------------------------------------------------------------------- #
def _script(seq):
    it = iter(seq)
    return lambda: next(it)


def _packed(groups):
    return [(g.n_seen_before, [(np.asarray(s).tolist(), np.asarray(d).tolist())
                                for s, d, _v in g.cols]) for g in groups]


@pytest.mark.parametrize("path", ["columns", "records"])
def test_dynamic_packers_equal_the_jax_package(path):
    """The same ``k_fn`` script gives the same group boundaries, columns
    and seen-count watermarks in both packages, on the column and the
    record path."""
    rng = np.random.default_rng(2)
    src = rng.integers(0, 100, 1000)
    dst = rng.integers(0, 100, 1000)
    seq = [1, 2, 4, 8, 3] * 20

    def edges():
        if path == "columns":
            return (src, dst)
        return iter([(int(a), int(b)) for a, b in zip(src, dst)])

    port = list(Windower(CountWindow(64), VertexDict(), device="cpu")
                .superbatches_dynamic(edges(), _script(seq)))
    ref = list(jwin.Windower(jwin.CountWindow(64), JaxVertexDict())
               .superbatches_dynamic(edges(), _script(seq)))
    assert [len(g) for g in port] == [1, 2, 4, 8, 1]  # 16 windows, the last partial
    assert [g.infos[0].index for g in port] == [g.infos[0].index for g in ref]
    assert _packed(port) == _packed(ref)


def test_superbatches_dynamic_matches_fixed_k_tiling():
    rng = np.random.default_rng(1)
    src = rng.integers(0, 500, 4096)
    dst = rng.integers(0, 500, 4096)
    fixed = list(Windower(CountWindow(128), VertexDict(), device="cpu")
                 .superbatches((src, dst), 4))
    dyn = list(Windower(CountWindow(128), VertexDict(), device="cpu")
               .superbatches_dynamic((src, dst), lambda: 4))
    assert _packed(fixed) == _packed(dyn)


def test_superbatches_dynamic_skip_replays_the_vertex_dict():
    rng = np.random.default_rng(3)
    src = rng.integers(0, 300, 2048)
    dst = rng.integers(0, 300, 2048)
    w_full = Windower(CountWindow(128), VertexDict(), device="cpu")
    full = list(w_full.superbatches_dynamic((src, dst), lambda: 2))
    w_skip = Windower(CountWindow(128), VertexDict(), device="cpu")
    skipped = list(w_skip.superbatches_dynamic((src, dst), lambda: 2, skip=8))
    assert sum(len(g) for g in skipped) == 8
    assert _packed(skipped)[0][1] == _packed(full[4:5])[0][1]
    assert [c for g in _packed(skipped) for c in g[1]] == \
        [c for g in _packed(full[4:]) for c in g[1]]
    assert len(w_skip.vertex_dict) == len(w_full.vertex_dict)
    with pytest.raises(ValueError, match="skip"):
        next(w_skip.superbatches_dynamic((src, dst), lambda: 2, skip=-1))


def test_scheduled_count_window_boundaries_cap_groups():
    policy = ScheduledCountWindow([(0, 4), (6, 8)])
    assert policy.size_at(0) == 4 and policy.size_at(5) == 4
    assert policy.size_at(6) == 8 and policy.run_length(4) == 2
    assert policy.run_length(7) is None and policy.size == 4
    src = np.arange(4 * 6 + 8 * 3, dtype=np.int64)
    groups = list(Windower(policy, VertexDict(), device="cpu")
                  .superbatches_dynamic((src, src.copy()), lambda: 4))
    sizes = [[len(c[0]) for c in g.cols] for g in groups]
    assert sizes == [[4, 4, 4, 4], [4, 4], [8, 8, 8]]
    ref = list(jwin.Windower(jwin.ScheduledCountWindow([(0, 4), (6, 8)]), JaxVertexDict())
               .superbatches_dynamic((src, src.copy()), lambda: 4))
    assert _packed(groups) == _packed(ref)
    with pytest.raises(ValueError, match="window 0"):
        ScheduledCountWindow([(1, 4)])
    with pytest.raises(ValueError, match="ascend"):
        ScheduledCountWindow([(0, 4), (0, 8)])


def test_generic_block_packer_and_stream_surface():
    """Streams without a windower pack their block iterator dynamically;
    ``SimpleEdgeStream.superbatches_dynamic`` routes to the windower."""
    from gelly_streaming_tpu_torch.core.window import (
        iter_superbatches_dynamic,
        superbatches_from_blocks_dynamic,
    )

    edges = [(i, i + 1, 0.0) for i in range(50)]
    stream = gt.SimpleEdgeStream(edges, window=CountWindow(5), device="cpu")
    groups = list(superbatches_from_blocks_dynamic(stream.blocks(), _script([1, 3, 2] * 9)))
    assert [len(g) for g in groups] == [1, 3, 2, 1, 3]
    assert [len(g) for g in iter_superbatches_dynamic(
        stream.prefetched(), _script([4] * 9))] == [4, 4, 2]
    assert [len(g) for g in stream.superbatches_dynamic(_script([2] * 9), skip=3)] == \
        [2, 2, 2, 1]


def test_checkpoint_aligned_tracks_group_boundaries():
    from gelly_streaming_tpu_torch.summaries.groupfold import GroupFoldable

    class W(GroupFoldable):
        superbatch = 4

        def fold_group(self, group):  # pragma: no cover - unused
            yield from ()

    w = W()
    assert w.checkpoint_aligned(4) and not w.checkpoint_aligned(3)
    w._gf_folded = 7
    assert w.checkpoint_aligned(7)
    assert not w.checkpoint_aligned(4) and not w.checkpoint_aligned(8)


def test_gf_folded_watermark_resets_after_a_group_folded_run():
    from gelly_streaming_tpu_torch.library import ConnectedComponents

    rng = np.random.default_rng(23)
    src = rng.integers(0, 256, 2048)
    dst = rng.integers(0, 256, 2048)
    agg = ConnectedComponents(superbatch=4)
    list(agg.run(_stream(src, dst, 128, 256)))
    assert agg._gf_folded is None
    assert agg.checkpoint_aligned(8) and not agg.checkpoint_aligned(3)


def test_superbatch_string_typos_fail_with_the_accepted_values():
    from gelly_streaming_tpu_torch.library import (
        BipartitenessCheck,
        ConnectedComponents,
        IncrementalPageRank,
    )

    for cls in (ConnectedComponents, IncrementalPageRank, BipartitenessCheck):
        with pytest.raises(ValueError, match='"auto"'):
            cls(superbatch="Auto")
        assert cls(superbatch="auto").superbatch_auto


# --------------------------------------------------------------------- #
# superbatch="auto" end to end
# --------------------------------------------------------------------- #
def _stream(src, dst, window, bound, jax=False):
    if jax:
        return gj.SimpleEdgeStream((src, dst), window=gj.CountWindow(window),
                                   vertex_dict=JaxIdentity(bound))
    return gt.SimpleEdgeStream((src, dst), window=CountWindow(window),
                               vertex_dict=IdentityDict(bound), device="cpu")


class Scripted:
    """A controller whose K follows a script, one entry per ``current_k``
    read (the packer reads it once per group in both packages, so the
    tiling is the same whatever the prefetch thread's timing)."""

    def __init__(self, seq):
        self._next = _script(list(seq) + [seq[-1]] * 4096)
        self.taps = []

    def current_k(self):
        return self._next()

    def tap_group(self, n_windows, n_edges, wall_s):
        self.taps.append((n_windows, n_edges))
        return n_windows


K_SCRIPT = [1, 3, 8, 3, 1, 8, 3, 8]  # few distinct K: the JAX side compiles per K


@pytest.mark.parametrize("carry", ["forest", "host"])
def test_superbatch_auto_cc_under_a_script_equals_the_jax_package(carry):
    from gelly_streaming_tpu.library import ConnectedComponents as JaxCC
    from gelly_streaming_tpu_torch.library import ConnectedComponents

    rng = np.random.default_rng(29)
    src = rng.integers(0, 512, 40 * 64)
    dst = rng.integers(0, 512, 40 * 64)
    runs = []
    for cls, jax in ((ConnectedComponents, False), (JaxCC, True)):
        agg = cls(superbatch="auto", carry=carry)
        agg.control = Scripted(K_SCRIPT)
        runs.append(([str(c) for c in agg.run(_stream(src, dst, 64, 512, jax))],
                     agg.control.taps))
    (got, taps), (want, jtaps) = runs
    assert got == want
    assert taps == jtaps and [n for n, _e in taps] == [1, 3, 8, 3, 1, 8, 3, 8, 5]


def test_superbatch_auto_bipartiteness_under_a_script_equals_the_jax_package():
    from gelly_streaming_tpu.library import BipartitenessCheck as JaxBC
    from gelly_streaming_tpu_torch.library import BipartitenessCheck

    rng = np.random.default_rng(13)
    # u even -> v odd edges: bipartite, then odd cycles arrive
    src = np.concatenate([2 * rng.integers(0, 128, 1024), rng.integers(0, 256, 1024)])
    dst = np.concatenate([2 * rng.integers(0, 128, 1024) + 1, rng.integers(0, 256, 1024)])
    runs = []
    for cls, jax in ((BipartitenessCheck, False), (JaxBC, True)):
        agg = cls(superbatch="auto", carry="forest")
        agg.control = Scripted(K_SCRIPT)
        runs.append([str(c) for c in agg.run(_stream(src, dst, 64, 256, jax))])
    assert runs[0] == runs[1]
    assert runs[0][0].startswith("(true") and runs[0][-1].startswith("(false")


def test_superbatch_auto_pagerank_under_a_script_equals_the_jax_package():
    from gelly_streaming_tpu.library import IncrementalPageRank as JaxPR
    from gelly_streaming_tpu_torch.library import IncrementalPageRank

    rng = np.random.default_rng(31)
    src = rng.integers(0, 200, 24 * 50)
    dst = rng.integers(0, 200, 24 * 50)
    got_pr, want_pr = IncrementalPageRank(superbatch="auto", tol=1e-5), \
        JaxPR(superbatch="auto", tol=1e-5)
    for pr in (got_pr, want_pr):
        pr.control = Scripted([1, 4, 2, 4, 1])
    got = list(got_pr.run(_stream(src, dst, 50, 200)))
    want = list(want_pr.run(_stream(src, dst, 50, 200, jax=True)))
    assert [e.window for e in got] == [e.window for e in want]
    assert [e.num_vertices for e in got] == [e.num_vertices for e in want]
    assert [int(e.iterations) for e in got] == [int(e.iterations) for e in want]
    jr, tr = want_pr.ranks(), got_pr.ranks()
    assert set(jr) == set(tr)
    assert max(abs(jr[v] - tr[v]) for v in jr) <= 1e-6


def test_superbatch_auto_value_identity_with_mid_stream_retunes(tick_clock):
    from gelly_streaming_tpu.library import ConnectedComponents as JaxCC
    from gelly_streaming_tpu_torch.library import ConnectedComponents

    rng = np.random.default_rng(11)
    n = 1 << 13
    src = rng.integers(0, 1024, n)
    dst = rng.integers(0, 1024, n)
    want = [str(c) for c in JaxCC(superbatch=1).run(_stream(src, dst, 128, 1024, jax=True))]
    for carry in ("forest", "host", "dense"):
        agg = ConnectedComponents(superbatch="auto", carry=carry)
        assert [str(c) for c in agg.run(_stream(src, dst, 128, 1024))] == want, carry
        assert agg.control.autok.history, carry
        assert agg.superbatch == agg.control.autok.k


def test_superbatch_auto_bipartiteness_value_identity(tick_clock):
    from gelly_streaming_tpu_torch.library import BipartitenessCheck

    rng = np.random.default_rng(13)
    n = 1 << 13
    src = rng.integers(0, 1024, n)
    dst = rng.integers(0, 1024, n)
    base = [str(c) for c in BipartitenessCheck(superbatch=1).run(_stream(src, dst, 128, 1024))]
    agg = BipartitenessCheck(superbatch="auto")
    assert [str(c) for c in agg.run(_stream(src, dst, 128, 1024))] == base
    assert agg.control.autok.history


class PerWindowCost:
    """An ``AutoK`` charged one second per window of each group, whatever
    the clock says: per-window cost and no gain from grouping (PageRank's
    fixpoint on every window)."""

    def __init__(self):
        self.inner = AutoK()

    def current_k(self):
        return self.inner.current_k()

    def tap_group(self, n_windows, n_edges, wall_s):
        return self.inner.tap_group(n_windows, n_edges, float(n_windows))


def test_superbatch_auto_pagerank_holds_k1_when_grouping_buys_nothing():
    """The negative control: the tuner probes up, sees no gain and returns
    to K = 1; ranks equal the pinned run's."""
    from gelly_streaming_tpu_torch.library import IncrementalPageRank

    rng = np.random.default_rng(7)
    src = rng.integers(0, 300, 64 * 40)
    dst = rng.integers(0, 300, 64 * 40)
    pinned = IncrementalPageRank(tol=1e-5)
    list(pinned.run(_stream(src, dst, 40, 300)))
    auto = IncrementalPageRank(superbatch="auto", tol=1e-5)
    auto.control = PerWindowCost()
    assert len(list(auto.run(_stream(src, dst, 40, 300)))) == 64
    ak = auto.control.inner
    assert ak.k == 1 and auto.superbatch == 1
    assert ak.history[:2] == [(1, 4, "initial-climb"), (4, 1, "probe-reverted")]
    pr, ar = pinned.ranks(), auto.ranks()
    assert max(abs(pr[v] - ar[v]) for v in pr) <= 1e-6


def test_superbatch_auto_kill_resume_through_autockpt(tmp_path, tick_clock):
    from gelly_streaming_tpu_torch.aggregate.autockpt import AutoCheckpoint
    from gelly_streaming_tpu_torch.library import ConnectedComponents

    rng = np.random.default_rng(5)
    n = 1 << 13
    src = rng.integers(0, 2048, n)
    dst = rng.integers(0, 2048, n)

    def make_stream(vd):
        return gt.SimpleEdgeStream((src, dst), window=CountWindow(64),
                                   vertex_dict=vd if vd is not None else IdentityDict(2048),
                                   device="cpu")

    path = str(tmp_path / "auto.ckpt")
    ref = [str(c) for c in ConnectedComponents(superbatch=1).run(make_stream(None))]
    agg = ConnectedComponents(superbatch="auto", carry="forest")
    got = []
    run = AutoCheckpoint(path, every=8).run(make_stream, agg)
    for i, c in enumerate(run):
        got.append(str(c))
        if i >= 70:
            break  # the kill
    run.close()
    done = AutoCheckpoint(path).windows_done()
    assert done > 0
    assert got[:done] == ref[:done]
    agg2 = ConnectedComponents(superbatch="auto", carry="forest")
    tail = [str(c) for c in AutoCheckpoint(path, every=8).run(make_stream, agg2)]
    assert got[:done] + tail == ref


def test_superbatch_auto_window_size_shift_matches_pinned_k1_oracle(tick_clock):
    from gelly_streaming_tpu_torch.library import ConnectedComponents

    rng = np.random.default_rng(17)
    n = 128 * 32 + 64 * 256
    src = rng.integers(0, 4096, n)
    dst = rng.integers(0, 4096, n)
    schedule = [(0, 32), (128, 256)]  # 128 small windows, then 8x

    def run(agg):
        stream = gt.SimpleEdgeStream((src, dst), window=ScheduledCountWindow(schedule),
                                     vertex_dict=IdentityDict(4096), device="cpu")
        return [c.labels() for c in agg.run(stream)]

    oracle = ConnectedComponents(superbatch="auto", carry="forest")
    oracle.control = ControlPlane(autok=AutoK(k0=1, k_max=1))
    base = run(oracle)
    assert oracle.control.autok.history == []
    assert len(base) == 128 + 64
    agg = ConnectedComponents(superbatch="auto", carry="forest")
    agg.control = ControlPlane(autok=AutoK(k_max=16, decide_groups=1),
                               prefetch=PrefetchTuner())
    got = run(agg)
    assert len(got) == len(base)
    assert all(np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
               for a, b in zip(got, base))
    hist = agg.control.autok.history
    assert any(sig == "window-shift" for _o, _n, sig in hist), hist
