"""Weighted matching and iterative (label-emitting) CC: the port against
the JAX package.

The same edge records go through both packages: matching events, matched
sets and weights must be equal; the iterative CC's per-window changed
``(vertex, component_id)`` pairs and its final labels must be equal, on
the incremental host path and on the summary-diff path, which must also
equal each other (including sparse, shuffled and negative raw ids and a
mid-stream downgrade). Device-encoded streams take the diff path. A
native library that does not load raises instead of switching path.

Mirrors ``tests/test_matching_iterative.py:15-197`` (the context-mesh
case, ``:198``, waits on slice 6).
"""

import itertools

import numpy as np
import pytest

from gelly_streaming_tpu.core.stream import SimpleEdgeStream as JaxStream
from gelly_streaming_tpu.core.window import CountWindow as JaxCountWindow
from gelly_streaming_tpu.library.iterative_cc import (
    IterativeConnectedComponents as JaxICC,
)
from gelly_streaming_tpu.library.matching import CentralizedWeightedMatching as JaxCWM
from gelly_streaming_tpu_torch import CountWindow, SimpleEdgeStream, datasets
from gelly_streaming_tpu_torch import native
from gelly_streaming_tpu_torch.library.iterative_cc import IterativeConnectedComponents
from gelly_streaming_tpu_torch.library.matching import (
    CentralizedWeightedMatching,
    MatchingEventType,
)


def _stream(edges, window, **kw):
    return SimpleEdgeStream(edges, window=CountWindow(window), device="cpu", **kw)


def _events(m, edges):
    return [(e.type.name, tuple(e.edge)) for e in m.run(edges)]


# --------------------------------------------------------------------- #
# matching
# --------------------------------------------------------------------- #
def test_matching_replace_rule():
    """An edge replaces collisions iff w > 2*sum(collision weights)
    (``CentralizedWeightedMatching.java:95-107``)."""
    m = CentralizedWeightedMatching()
    events = list(m.run([(1, 2, 10.0), (2, 3, 15.0), (2, 3, 25.0)]))
    assert [e.type for e in events] == [
        MatchingEventType.ADD, MatchingEventType.REMOVE, MatchingEventType.ADD,
    ]
    assert m.total_weight() == 25.0
    assert {(e.src, e.dst) for e in m.matching()} == {(2, 3)}


def test_matching_two_collisions():
    m = CentralizedWeightedMatching()
    list(m.run([(1, 2, 5.0), (3, 4, 6.0)]))
    assert list(m.run([(2, 3, 22.0)])) == []
    events = list(m.run([(2, 3, 23.0)]))
    assert [e.type for e in events] == [
        MatchingEventType.REMOVE, MatchingEventType.REMOVE, MatchingEventType.ADD,
    ]
    assert m.total_weight() == 23.0


@pytest.mark.parametrize("trial", [0, 1, 2])
def test_matching_approximation_bound_and_jax_events(trial):
    """Within the 1/6 bound of the brute-force optimum, with the JAX
    package's events exactly."""
    rng = np.random.default_rng(2 + trial)
    edges = [
        (int(a), int(b), float(w))
        for (a, b), w in zip(rng.integers(0, 8, size=(12, 2)), rng.uniform(1, 100, 12))
        if a != b
    ]
    m = CentralizedWeightedMatching()
    assert _events(m, edges) == _events(JaxCWM(), edges)
    best = 0.0
    for r in range(1, 5):
        for sub in itertools.combinations(edges, r):
            verts = [v for s, d, _ in sub for v in (s, d)]
            if len(set(verts)) == 2 * len(sub):
                best = max(best, sum(w for _, _, w in sub))
    assert m.total_weight() >= best / 6.0


def test_matching_accepts_stream_and_state_dict():
    stream = _stream([(1, 2, 3.0), (3, 4, 4.0)], 1)
    m = CentralizedWeightedMatching()
    assert len(list(m.run(stream))) == 2
    assert m.total_weight() == 7.0
    m2 = CentralizedWeightedMatching()
    m2.load_state_dict(m.state_dict())
    assert m2.matching() == m.matching()


# --------------------------------------------------------------------- #
# iterative CC
# --------------------------------------------------------------------- #
CC_EDGES = [
    (1, 2, 0.0), (1, 3, 0.0), (2, 3, 0.0),
    (6, 7, 0.0), (8, 9, 0.0), (3, 5, 0.0),
]


def _icc_run(edges, window, force_diff=False):
    icc = IterativeConnectedComponents()
    if force_diff:
        icc._mode = "diff"
    out = [list(ch) for ch in icc.run(_stream(edges, window))]
    return out, icc.labels(), icc._mode


def _jax_run(edges, window):
    icc = JaxICC()
    out = [list(ch) for ch in icc.run(JaxStream(edges, window=JaxCountWindow(window)))]
    return out, icc.labels()


def test_iterative_cc_labels_shrink_to_min_raw_id():
    out, labels, _ = _icc_run(CC_EDGES, 2)
    assert labels == {1: 1, 2: 1, 3: 1, 5: 1, 6: 6, 7: 6, 8: 8, 9: 8}
    flat = [p for e in out for p in e]
    assert flat.count((5, 1)) == 1
    assert all(c <= v for v, c in flat)
    assert (out, labels) == _jax_run(CC_EDGES, 2)


def test_iterative_cc_merge_relabels_larger_component_id():
    edges = [(5, 6, 0.0), (1, 2, 0.0), (2, 6, 0.0)]
    (w1, w2, w3), labels, _ = _icc_run(edges, 1)
    assert set(w1) == {(5, 5), (6, 5)}
    assert set(w2) == {(1, 1), (2, 1)}
    assert set(w3) == {(5, 1), (6, 1)}
    assert labels == {1: 1, 2: 1, 5: 1, 6: 1}


@pytest.mark.parametrize("window", [1, 3, 8, 40])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_iterative_incremental_matches_diff_path_and_jax(window, seed):
    """Window-identical change streams on both paths and in the JAX
    package, with sparse shuffled raw ids (compact order != raw order)."""
    rng = np.random.default_rng(seed)
    ids = rng.permutation(np.arange(100) * 7 + 13)
    edges = [(int(ids[a]), int(ids[b]), 0.0) for a, b in rng.integers(0, 100, size=(120, 2))]
    inc_out, inc_labels, inc_mode = _icc_run(edges, window)
    diff_out, diff_labels, diff_mode = _icc_run(edges, window, force_diff=True)
    assert (inc_mode, diff_mode) == ("incremental", "diff")
    assert inc_out == diff_out
    assert inc_labels == diff_labels
    assert (inc_out, inc_labels) == _jax_run(edges, window)


def test_differential_actually_exercises_incremental():
    _, _, mode = _icc_run([(1, 2, 0.0)], 1)
    assert mode == "incremental"


def test_incremental_downgrades_midstream_and_negative_ids():
    out, _, _ = _icc_run([(-1, 5, 0.0)], 1)
    assert out == [[(-1, -1), (5, -1)]]
    icc2 = IterativeConnectedComponents()
    s1 = _stream([(10, 11, 0.0), (12, 13, 0.0)], 1)
    assert [list(ch) for ch in icc2.run(s1)] == [[(10, 10), (11, 10)], [(12, 12), (13, 12)]]
    assert icc2._mode == "incremental"
    s2 = _stream([(11, 12, 0.0)], 1, vertex_dict=s1.vertex_dict).map_edges(
        lambda s, d, v: v)
    assert [list(ch) for ch in icc2.run(s2)] == [[(12, 10), (13, 10)]]
    assert icc2._mode == "diff"
    assert icc2.labels() == {10: 10, 11: 10, 12: 10, 13: 10}


def test_device_encoded_stream_takes_the_diff_path(tmp_path):
    """Device-encoded blocks carry no host columns: the diff path, window
    for window equal to the incremental path over the same file."""
    rng = np.random.default_rng(21)
    src = rng.integers(0, 300, 1200)
    dst = rng.integers(0, 300, 1200)
    p = str(tmp_path / "g.txt")
    native.write_edge_file(p, src, dst)
    runs = {}
    for name, kw in {"incremental": dict(vertex_dict=datasets.IdentityDict(512)),
                     "diff": dict(device_encode=True, min_vertex_capacity=512)}.items():
        icc = IterativeConnectedComponents()
        s = datasets.stream_file(p, window=CountWindow(256), device="cpu", **kw)
        runs[name] = ([list(ch) for ch in icc.run(s)], icc.labels(), icc._mode)
    assert runs["incremental"][2] == "incremental" and runs["diff"][2] == "diff"
    assert runs["incremental"][:2] == runs["diff"][:2]


def test_native_failure_raises_instead_of_switching_path(monkeypatch):
    """The reference falls back to the diff path on ANY exception from the
    native library; the port raises."""
    def broken(*a, **kw):
        raise RuntimeError("native library unavailable: g++ failed")

    monkeypatch.setattr(native, "CompactUnionFind", broken)
    icc = IterativeConnectedComponents()
    with pytest.raises(RuntimeError, match="native library unavailable"):
        list(icc.run(_stream(CC_EDGES, 2)))


def test_mesh_waits_on_the_multi_device_slice():
    with pytest.raises(NotImplementedError, match="slice 6"):
        IterativeConnectedComponents(mesh=object())
