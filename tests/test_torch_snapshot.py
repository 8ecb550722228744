"""``slice()`` and the neighborhood aggregations: the port against the JAX
package.

Mirrors ``tests/test_slice.py`` (``TestSlice.java``'s fold / reduce /
apply x OUT / IN / ALL goldens on the 7-edge sample graph, multi-window
and event-time re-windowing, hub degree classes, degree planning with no
device read, the host planner against the read-back planner, and
``flat_apply_on_neighbors``' 0..n emission). Each case runs both packages
(the port with ``device="cpu"``) on the same input; user functions are
written with ``jnp`` for the JAX package and with torch for the port.
Emissions must be equal record for record: integer and the sample
graph's float sums exactly (whole numbers in float32); the random-value
sums of the generic reduce within a relative 1e-5 (float32 association
order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gelly_streaming_tpu as gj
import gelly_streaming_tpu_torch as gt
from gelly_streaming_tpu.library.triangles import WindowTriangles as JaxWindowTriangles
from gelly_streaming_tpu_torch.core.snapshot import SnapshotStream
from gelly_streaming_tpu_torch.library import WindowTriangles

FOLD_OUT = {1: 25, 2: 23, 3: 69, 4: 45, 5: 51}   # TestSlice.java:81-85
FOLD_IN = {1: 51, 2: 12, 3: 36, 4: 34, 5: 80}    # TestSlice.java:99-103
FOLD_ALL = {1: 76, 2: 35, 3: 105, 4: 79, 5: 131}  # TestSlice.java:117-121
APPLY_OUT = {1: "small", 2: "small", 3: "big", 4: "small", 5: "big"}  # :189-193
APPLY_IN = {1: "big", 2: "small", 3: "small", 4: "small", 5: "big"}   # :207-211
APPLY_ALL = {1: "big", 2: "small", 3: "big", 4: "big", 5: "big"}      # :225-229
DIRS = ["OUT", "IN", "ALL"]
FOLDS = {"OUT": FOLD_OUT, "IN": FOLD_IN, "ALL": FOLD_ALL}
APPLIES = {"OUT": APPLY_OUT, "IN": APPLY_IN, "ALL": APPLY_ALL}


def snapshots(edges, direction, window=None, block=None):
    """The same slice in both packages: (JAX, port)."""
    n = block or len(edges)
    js = gj.SimpleEdgeStream(edges, window=gj.CountWindow(n))
    ts = gt.SimpleEdgeStream(edges, window=gt.CountWindow(n), device="cpu")
    jw = None if window is None else gj.CountWindow(window)
    tw = None if window is None else gt.CountWindow(window)
    return (js.slice(jw, getattr(gj.EdgeDirection, direction)),
            ts.slice(tw, getattr(gt.EdgeDirection, direction)))


def _plain(x):
    if isinstance(x, tuple):
        return tuple(_plain(v) for v in x)
    if isinstance(x, (np.ndarray, np.generic)):
        return x.tolist()
    return x


def records(it):
    return [(int(v), _plain(r)) for v, r in it]


@pytest.mark.parametrize("direction", DIRS)
def test_fold_neighbors(sample_edges, direction):
    # SumEdgeValues fold: accum = (vertex_id, running_sum) (TestSlice.java:233-240)
    jsnap, tsnap = snapshots(sample_edges, direction)
    want = records(jsnap.fold_neighbors((0, 0.0), lambda acc, vid, nbr, val: (vid, acc[1] + val)))
    got = records(tsnap.fold_neighbors(
        (0, 0.0), lambda acc, vid, nbr, val: (vid, torch.add(acc[1], val))))
    assert got == want
    assert {v: int(r[1]) for v, r in got} == FOLDS[direction]
    assert all(r[0] == v for v, r in got)


@pytest.mark.parametrize("direction", DIRS)
def test_reduce_on_edges_generic(sample_edges, direction):
    # SumEdgeValuesReduce as an associative callable (TestSlice.java:243-249)
    jsnap, tsnap = snapshots(sample_edges, direction)
    got = records(tsnap.reduce_on_edges(lambda a, b: torch.add(a, b)))
    assert got == records(jsnap.reduce_on_edges(lambda a, b: a + b))
    assert {v: int(r) for v, r in got} == FOLDS[direction]


@pytest.mark.parametrize("direction", DIRS)
@pytest.mark.parametrize("op", ["sum", "min", "max", "prod"])
def test_reduce_on_edges_monoid_fast_path(sample_edges, direction, op):
    jsnap, tsnap = snapshots(sample_edges, direction)
    got = records(tsnap.reduce_on_edges(op))
    assert got == records(jsnap.reduce_on_edges(op))
    if op == "sum":
        assert {v: int(r) for v, r in got} == FOLDS[direction]


@pytest.mark.parametrize("direction", DIRS)
def test_apply_on_neighbors(sample_edges, direction):
    # SumEdgeValuesApply (TestSlice.java:252-268): sum > 50 -> "big"
    jsnap, tsnap = snapshots(sample_edges, direction)
    want = records(jsnap.apply_on_neighbors(
        lambda vid, nbrs, vals, valid: jnp.sum(jnp.where(valid, vals, 0.0)) > 50))
    got = records(tsnap.apply_on_neighbors(
        lambda vid, nbrs, vals, valid: torch.where(valid, vals, 0.0).sum() > 50))
    assert got == want
    assert {v: ("big" if f else "small") for v, f in got} == APPLIES[direction]


def test_multi_window_slice(sample_edges):
    # re-windowing: blocks of 2 edges into windows of 4 and 3 edges
    jsnap, tsnap = snapshots(sample_edges, "OUT", window=4, block=2)
    got = records(tsnap.reduce_on_edges("sum"))
    assert got == records(jsnap.reduce_on_edges("sum"))
    assert got == [(1, 25.0), (2, 23.0), (3, 34.0), (3, 35.0), (4, 45.0), (5, 51.0)]


def test_slice_event_time_rewindowing():
    """``slice(Time, dir)`` re-windowing of an existing block stream:
    windows span block boundaries and aggregate per time slot."""
    edges = [
        (1, 2, 0.0), (2, 3, 1.0), (1, 3, 5.0),
        (3, 4, 9.0), (4, 5, 12.0), (5, 1, 13.0),
        (2, 5, 27.0),
    ]
    out = []
    for pkg in (gj, gt):
        kw = {} if pkg is gj else {"device": "cpu"}
        stream = pkg.SimpleEdgeStream(edges, window=pkg.CountWindow(3), **kw)
        sliced = stream.slice(window=pkg.EventTimeWindow(10, timestamp_fn=lambda e: e[2]),
                              direction=pkg.EdgeDirection.OUT)
        wins = []
        for b in sliced._block_iter_fn():
            s, d, v = b.to_host()
            wins.append(sorted(zip(stream.vertex_dict.decode(s).tolist(),
                                   stream.vertex_dict.decode(d).tolist(), v.tolist())))
        out.append((wins, records(sliced.reduce_on_edges("sum"))))
    assert out[1] == out[0]
    wins, got = out[1]
    assert wins == [
        sorted([(1, 2, 0.0), (2, 3, 1.0), (1, 3, 5.0), (3, 4, 9.0)]),
        sorted([(4, 5, 12.0), (5, 1, 13.0)]),
        sorted([(2, 5, 27.0)]),
    ]
    assert got == [(1, 5.0), (2, 1.0), (3, 9.0), (4, 12.0), (5, 13.0), (2, 27.0)]


def test_slice_event_time_requires_timestamp_fn():
    stream = gt.SimpleEdgeStream([(1, 2, 0.0)], window=gt.CountWindow(2), device="cpu")
    with pytest.raises(ValueError, match="timestamp_fn"):
        list(stream.slice(window=gt.EventTimeWindow(10)).reduce_on_edges("sum"))


def test_apply_on_neighbors_hub_degree_classes():
    """A hub does not size every vertex's rows: the degree classes give
    the flat pass's results; ``max_degree`` truncates."""
    src = [0] * 300 + [1000, 1001, 1002, 1001]
    dst = list(range(1, 301)) + [2000, 2001, 2002, 2003]
    edges = list(zip(src, dst))
    jsnap, tsnap = snapshots(edges, "OUT")
    got = records(tsnap.apply_on_neighbors(lambda vid, n, v, valid: valid.sum()))
    assert got == records(jsnap.apply_on_neighbors(lambda vid, n, v, valid: valid.sum()))
    got = dict(got)
    assert got[0] == 300 and got[1000] == 1 and got[1001] == 2 and got[1002] == 1
    assert list(got) == sorted(got)
    jsnap, tsnap = snapshots(edges, "OUT")
    capped = records(tsnap.apply_on_neighbors(lambda vid, n, v, valid: valid.sum(), max_degree=8))
    assert capped == records(jsnap.apply_on_neighbors(
        lambda vid, n, v, valid: valid.sum(), max_degree=8))
    assert dict(capped)[0] == 8 and dict(capped)[1001] == 2


@pytest.mark.parametrize("direction", DIRS)
def test_apply_degree_planning_needs_no_device_readback(sample_edges, direction, monkeypatch):
    """On blocks with host columns the class planner (apply and fold) runs
    from the host: the read-back hook is rigged to fail."""
    def boom(self, degree):
        raise AssertionError("degree read back from the device on a host-cached block")

    monkeypatch.setattr(SnapshotStream, "_degree_readback", boom)
    _jsnap, tsnap = snapshots(sample_edges, direction)
    out = dict(tsnap.apply_on_neighbors(
        lambda vid, nbrs, vals, valid: torch.where(valid, vals, 0.0).sum()))
    assert {v: int(s) for v, s in out.items()} == FOLDS[direction]
    folded = dict(tsnap.fold_neighbors(0.0, lambda acc, vid, nbr, val: torch.add(acc, val)))
    assert {v: int(s) for v, s in folded.items()} == FOLDS[direction]


def test_apply_host_planner_matches_readback_planner():
    """The host-bincount planner and the read-back planner give the same
    classes and results, on a multigraph with a hub, and the JAX package's."""
    rng = np.random.default_rng(31)
    hub = [(0, int(b), 1.0) for b in rng.integers(1, 40, 25)]
    rand = [(int(a), int(b), float(v)) for (a, b), v in
            zip(rng.integers(0, 40, size=(60, 2)), rng.random(60).round(3))]
    edges = hub + rand

    def run(force_readback):
        _jsnap, snap = snapshots(edges, "ALL")
        if force_readback:
            snap._window_degrees = lambda b, degree: degree.numpy()
        return records(snap.apply_on_neighbors(
            lambda vid, n, vals, valid: torch.where(valid, vals, 0.0).sum() + valid.sum()))

    jsnap, _ = snapshots(edges, "ALL")
    want = records(jsnap.apply_on_neighbors(
        lambda vid, n, vals, valid: jnp.where(valid, vals, 0.0).sum() + valid.sum()))
    got = run(False)
    assert got == run(True)
    assert [v for v, _ in got] == [v for v, _ in want]
    np.testing.assert_allclose([r for _, r in got], [r for _, r in want], rtol=1e-6)


def test_random_multiwindow_fold_and_reduce_match_jax():
    """A random multigraph over 3 re-windowed snapshots: the order-dependent
    fold (a rolling hash of raw neighbor ids) exactly, the generic float
    reduce within 1e-5, the monoids exactly."""
    rng = np.random.default_rng(5)
    src = rng.integers(0, 50, 400)
    dst = rng.integers(0, 50, 400)
    val = rng.normal(size=400).astype(np.float32)
    edges = list(zip(src.tolist(), dst.tolist(), val.tolist()))
    jsnap, tsnap = snapshots(edges, "ALL", window=150, block=64)
    want = records(jsnap.fold_neighbors(0, lambda acc, vid, nbr, v: (acc * 31 + nbr) % 10007))
    got = records(tsnap.fold_neighbors(0, lambda acc, vid, nbr, v: (acc * 31 + nbr) % 10007))
    assert got == want and len(got) > 100
    want = records(jsnap.reduce_on_edges(lambda a, b: a + b))
    got = records(tsnap.reduce_on_edges(lambda a, b: torch.add(a, b)))
    assert [v for v, _ in got] == [v for v, _ in want]
    np.testing.assert_allclose([r for _, r in got], [r for _, r in want], rtol=1e-5, atol=1e-5)
    for op in ("min", "max"):
        assert records(tsnap.reduce_on_edges(op)) == records(jsnap.reduce_on_edges(op))


def _candidates_j(vid, nbrs, vals, valid):
    D = nbrs.shape[0]
    ii, jj = jnp.triu_indices(D, 1)
    a, b = nbrs[ii], nbrs[jj]
    return (jnp.minimum(a, b), jnp.maximum(a, b)), valid[ii] & valid[jj] & (a != b)


def _candidates_t(vid, nbrs, vals, valid):
    D = nbrs.shape[0]
    ii, jj = torch.triu_indices(D, D, 1)
    a, b = nbrs[ii], nbrs[jj]
    return (torch.minimum(a, b), torch.maximum(a, b)), valid[ii] & valid[jj] & (a != b)


def test_flat_apply_collector_parity_candidate_edges():
    """``EdgesApply`` 0..n emission: the reference's GenerateCandidateEdges
    (``WindowTriangles.java:86-114``) through the public
    ``flat_apply_on_neighbors`` counts the triangles of the dedicated
    window kernel."""
    rng = np.random.default_rng(41)
    pairs = {(min(int(a), int(b)), max(int(a), int(b)))
             for a, b in rng.integers(0, 16, size=(70, 2)) if a != b}
    edges = [(a, b, 0.0) for a, b in sorted(pairs)]
    jsnap, tsnap = snapshots(edges, "ALL")
    kfor = lambda D: max(D * (D - 1) // 2, 1)  # noqa: E731
    want = [tuple(int(x) for x in r) for r in jsnap.flat_apply_on_neighbors(_candidates_j, kfor)]
    got = [tuple(int(x) for x in r) for r in tsnap.flat_apply_on_neighbors(_candidates_t, kfor)]
    assert got == want
    eset = {(a, b) for a, b, _ in edges}
    closing = sum(1 for lo, hi in got if (lo, hi) in eset)
    assert closing % 3 == 0
    (dedicated, _), = list(WindowTriangles(gt.CountWindow(len(edges)), device="cpu").run(edges))
    (jax_count, _), = list(JaxWindowTriangles(gj.CountWindow(len(edges))).run(edges))
    assert closing // 3 == dedicated == jax_count


def test_flat_apply_zero_and_variable_emission():
    """0-emission vertices contribute nothing; the order is windows, then
    ascending vertex, then slot; a wrong ``max_out`` is rejected."""
    edges = [(1, 2, 0.0), (1, 3, 0.0), (4, 5, 0.0)]

    def nbr_list_j(vid, nbrs, vals, valid):
        return (jnp.broadcast_to(vid, nbrs.shape), nbrs), valid & (nbrs > vid)

    def nbr_list_t(vid, nbrs, vals, valid):
        return (torch.broadcast_to(vid, nbrs.shape), nbrs), valid & (nbrs > vid)

    jsnap, tsnap = snapshots(edges, "ALL")
    want = [(int(v), int(n)) for v, n in jsnap.flat_apply_on_neighbors(nbr_list_j, lambda D: D)]
    got = [(int(v), int(n)) for v, n in tsnap.flat_apply_on_neighbors(nbr_list_t, lambda D: D)]
    assert got == want == [(1, 2), (1, 3), (4, 5)]
    with pytest.raises(ValueError, match="max_out"):
        list(tsnap.flat_apply_on_neighbors(nbr_list_t, 3))

