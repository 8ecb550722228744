"""The fully-dynamic degree distribution: the port against the JAX package.

Mirrors ``tests/test_degrees.py``: ``ExamplesTestData.DEGREES_DATA`` and
``DEGREES_DATA_ZERO`` (``DegreeDistributionITCase.java:25-50``) and random
±event streams, against a per-event replay of the reference's two HashMap
states (``DegreeDistribution.java:83-131``) and against the JAX package's
per-window change-only emissions, for any windowing; the clamp order
inside a window; and the lazy batches read out of order or after later
windows (the histogram of each window stays its own). All integer, all
exact.
"""

import numpy as np
import pytest

from gelly_streaming_tpu.core.window import CountWindow as JaxCountWindow
from gelly_streaming_tpu.library.degrees import DegreeDistribution as JaxDegreeDistribution
from gelly_streaming_tpu_torch.core.window import CountWindow
from gelly_streaming_tpu_torch.library.degrees import DegreeDistribution

DEGREES_DATA = [
    (1, 2, "+"), (2, 3, "+"), (1, 4, "+"),
    (2, 3, "-"), (3, 4, "+"), (1, 2, "-"),
]
DEGREES_DATA_ZERO = DEGREES_DATA + [(2, 3, "-")]


def dd(wsize):
    return DegreeDistribution(CountWindow(wsize), device="cpu")


def reference_simulator(events):
    """Per-event replay of the reference's VertexDegreeCounts +
    DegreeDistributionMap HashMap states."""
    deg, hist = {}, {}

    def bump(d, c):
        hist[d] = hist.get(d, 0) + c

    for s, t, change in events:
        delta = 1 if change == "+" else -1
        for v in (s, t):
            if v in deg:
                old = deg[v]
                new = old + delta
                if new > 0:
                    deg[v] = new
                    bump(new, 1)
                else:
                    del deg[v]
                bump(old, -1)
            elif delta > 0:
                deg[v] = 1
                bump(1, 1)
    return deg, {d: c for d, c in hist.items() if c != 0}


def both(events, wsize):
    """Per-window emissions of both packages (read in order); equal."""
    j = JaxDegreeDistribution(JaxCountWindow(wsize))
    t = dd(wsize)
    je = [list(b) for b in j.run(events)]
    te = [list(b) for b in t.run(events)]
    assert te == je
    assert t.histogram() == j.histogram()
    np.testing.assert_array_equal(t.degrees(), np.asarray(j.degrees()))
    assert t.degrees().dtype == np.int32
    return t, te


def test_final_histogram_matches_reference_any_windowing():
    for data in (DEGREES_DATA, DEGREES_DATA_ZERO):
        _, ref_hist = reference_simulator(data)
        for wsize in (1, 2, 3, len(data)):
            t, emissions = both(data, wsize)
            assert t.histogram() == ref_hist, (data, wsize)
            final = {}
            for e in emissions:
                final.update(dict(e))
            for d, c in ref_hist.items():
                assert final.get(d, c) == c


def test_per_event_windows_match_simulator_incrementally():
    t = dd(1)
    for i, _ in enumerate(t.run(DEGREES_DATA_ZERO)):
        assert t.histogram() == reference_simulator(DEGREES_DATA_ZERO[: i + 1])[1], i


def test_deletion_of_unseen_vertex_is_ignored():
    t, out = both([(7, 8, "-"), (1, 2, "+")], 1)
    assert out[0] == []
    assert t.histogram() == {1: 2}


def test_clamped_resurrection_order_within_window():
    """deg 1, then (-, -, +) in ONE window: sequential clamping gives 1, a
    plain sum would give 0."""
    events = [(1, 2, "+"), (1, 2, "-"), (1, 2, "-"), (1, 2, "+")]
    _, ref_hist = reference_simulator(events)
    for wsize in (1, 3):
        t, _ = both(events, wsize)
        assert t.histogram() == ref_hist == {1: 2}


@pytest.mark.parametrize("wsize", [37, 400])
def test_large_random_event_stream_matches_simulator(wsize):
    rng = np.random.default_rng(11)
    edges = rng.integers(0, 30, size=(400, 2))
    kinds = rng.random(400) < 0.65
    events = [(int(a), int(b), "+" if k else "-") for (a, b), k in zip(edges, kinds)]
    t, _ = both(events, wsize)
    assert t.histogram() == reference_simulator(events)[1]


def test_src_dst_role_order_within_window():
    """A vertex hit as dst of one event and src of a later one in the SAME
    window folds in event order (the interleaved [s0, d0, s1, d1, ...])."""
    events = [(9, 5, "-"), (5, 7, "+")]
    for wsize in (1, 2):
        t, _ = both(events, wsize)
        assert t.histogram() == reference_simulator(events)[1], wsize
    rng = np.random.default_rng(21)
    ev = [(int(a), int(b), "+" if k else "-")
          for (a, b), k in zip(rng.integers(0, 6, size=(300, 2)), rng.random(300) < 0.5)]
    _, ref_hist = reference_simulator(ev)
    for wsize in (2, 5, 23, 300):
        t, _ = both(ev, wsize)
        assert t.histogram() == ref_hist, wsize


def test_out_of_order_batch_materialization_safe():
    """Reading an old lazy batch AFTER a newer one must not clobber the
    workload's diff base or capacity shadow: the newest read wins."""
    events = [(i % 5, (i + 1) % 5, "+") for i in range(24)]
    t = dd(6)
    batches = list(t.run(events))
    assert len(batches) == 4
    newest = list(batches[-1])
    ub_after_last = t._max_deg_ub
    oldest = list(batches[0])  # old batch read later: no watermark regression
    assert t._emit_base >= batches[-1]._ev
    assert t._max_deg_ub <= ub_after_last
    ref = dd(6)
    for b in ref.run(events):
        list(b)
    assert t.histogram() == ref.histogram()
    # the same reads in the JAX package give the same lists
    j = JaxDegreeDistribution(JaxCountWindow(6))
    jb = list(j.run(events))
    assert list(jb[-1]) == newest and list(jb[0]) == oldest


def test_windows_after_out_of_order_read_stay_correct():
    """An old batch read after a newer one tightened the shadow must not
    drag the shadow below the true max degree; real degrees raised later
    land in their own bins."""
    phase1 = [(0, 1, "+" if i % 2 == 0 else "-") for i in range(24)]
    t = dd(6)
    batches = list(t.run(phase1))
    list(batches[-1])
    list(batches[0])
    true_max = max((d for d, c in t.histogram().items() if c), default=0)
    assert t._max_deg_ub >= true_max
    phase2 = [(0, 100 + i, "+") for i in range(12)]
    for b in t.run(phase2):
        list(b)
    ref = dd(6)
    for b in ref.run(phase1 + phase2):
        list(b)
    assert t.histogram() == ref.histogram()
    assert t.histogram()[12] == 1


def test_stale_read_after_shadow_regrowth_stays_sound():
    """Tighten the shadow with a newest read, regrow it past a stale
    batch's bound with real degrees, then read the stale batch: the shadow
    stays above the true max, and a later degree 18 is not clipped."""
    phase1 = [(0, 1, "+" if i % 2 == 0 else "-") for i in range(12)]
    t = dd(6)
    b1 = list(t.run(phase1))
    list(b1[-1])
    for b in t.run([(0, 100 + i, "+") for i in range(12)]):
        list(b)
    list(b1[0])
    true_max = max((d for d, c in t.histogram().items() if c), default=0)
    assert t._max_deg_ub >= true_max
    for b in t.run([(0, 200 + i, "+") for i in range(6)]):
        list(b)
    ref = dd(6)
    for b in ref.run(phase1 + [(0, 100 + i, "+") for i in range(12)]
                     + [(0, 200 + i, "+") for i in range(6)]):
        list(b)
    assert t.histogram() == ref.histogram()
    assert t.histogram()[18] == 1


def test_lazy_batches_read_after_later_windows_keep_their_window():
    """Each window's batch holds its own histogram: reading all of them
    after the stream ended, in order, gives the in-order emissions (no
    tensor an emitted batch holds is updated in place)."""
    rng = np.random.default_rng(2)
    events = [(int(a), int(b), "+" if k else "-")
              for (a, b), k in zip(rng.integers(0, 12, size=(120, 2)), rng.random(120) < 0.7)]
    _, in_order = both(events, 10)
    t = dd(10)
    late = [list(b) for b in list(t.run(events))]
    assert late == in_order


def test_state_dict_round_trips_with_the_jax_package():
    """The checkpoint layout is shared: the port restores the JAX package's
    state and continues with the same emissions, and back."""
    head, tail = DEGREES_DATA, [(1, 5, "+"), (5, 6, "+"), (1, 5, "-")]
    j = JaxDegreeDistribution(JaxCountWindow(2))
    for b in j.run(head):
        list(b)
    t = dd(2)
    t.load_state_dict(j.state_dict())
    assert [list(b) for b in t.run(tail)] == [list(b) for b in j.run(tail)]
    back = JaxDegreeDistribution(JaxCountWindow(2))
    back.load_state_dict(t.state_dict())
    assert back.histogram() == t.histogram() == j.histogram()


def test_degree_distribution_cli_itcase(tmp_path):
    """``example/degree_distribution.py --cpu`` on ``DEGREES_DATA_ZERO``:
    the JAX package's CLI output, ending in the deletion-to-zero change."""
    from gelly_streaming_tpu.example import degree_distribution as jax_cli
    from gelly_streaming_tpu_torch.example import degree_distribution as cli

    inp = tmp_path / "events.txt"
    inp.write_text("".join(f"{s} {d} {c}\n" for s, d, c in DEGREES_DATA_ZERO))
    cli.main(["--cpu", str(inp), "1", str(tmp_path / "port.txt")])
    jax_cli.main([str(inp), "1", str(tmp_path / "jax.txt")])
    got = (tmp_path / "port.txt").read_text().splitlines()
    assert got == (tmp_path / "jax.txt").read_text().splitlines()
    assert got[-1] == "(1,1)"
