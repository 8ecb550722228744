"""Randomized differential tests of the port's ported paths against
pure-Python reference implementations (the JAX package's
``tests/test_differential.py``, on the port on the CPU): streaming CC
(host dict, and the device vertex dictionary in both forms), the degree
stream, exact triangles, CC under stream transforms and bipartiteness,
over random streams, window sizes and id spaces.

Mirrors ``tests/test_differential.py``.
"""

from itertools import combinations

import numpy as np
import pytest

from gelly_streaming_tpu_torch import CountWindow, SimpleEdgeStream, datasets, native
from gelly_streaming_tpu_torch.library import (
    BipartitenessCheck,
    ConnectedComponents,
    ExactTriangleCount,
)

from _uf import union_find_components as _py_components


def _rand_edges(rng, n, vmax, sparse_ids=False):
    pairs = rng.integers(0, vmax, size=(n, 2))
    k = 7 if sparse_ids else 1
    return [(int(a) * k + 3, int(b) * k + 3, 0.0) for a, b in pairs]


def _stream(edges, window):
    return SimpleEdgeStream(edges, window=CountWindow(window), device="cpu")


def _final(stream, agg):
    last = None
    for last in stream.aggregate(agg):
        pass
    return last


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_cc_matches_python_union_find(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(20, 300))
    vmax = int(rng.integers(5, 60))
    window = int(rng.integers(1, n + 1))
    edges = _rand_edges(rng, n, vmax, sparse_ids=bool(seed % 2))
    got = sorted(_final(_stream(edges, window), ConnectedComponents()).component_sets())
    assert got == _py_components(edges), (seed, n, vmax, window)


@pytest.mark.parametrize("seed", [20, 21, 22, 23])
def test_device_encoded_cc_matches_python_union_find(tmp_path, seed):
    """The file path with vertex compaction on the device: the declared
    bound for dense ids, growth mode for sparse ones."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(20, 300))
    vmax = int(rng.integers(5, 60))
    window = int(rng.integers(1, n + 1))
    sparse = bool(seed % 2)
    edges = _rand_edges(rng, n, vmax, sparse_ids=sparse)
    p = str(tmp_path / "e.txt")
    native.write_edge_file(p, np.array([e[0] for e in edges]), np.array([e[1] for e in edges]))
    kw = dict(dense_ids=False, min_vertex_capacity=16) if sparse \
        else dict(min_vertex_capacity=vmax + 3)
    stream = datasets.stream_file(p, window=CountWindow(window), device_encode=True,
                                  device="cpu", **kw)
    got = sorted(_final(stream, ConnectedComponents()).component_sets())
    assert got == _py_components(edges), (seed, n, vmax, window)


@pytest.mark.parametrize("seed", [5, 6])
def test_degree_stream_matches_python_counts(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(30, 200))
    vmax = int(rng.integers(5, 40))
    window = int(rng.integers(1, 20))
    edges = _rand_edges(rng, n, vmax)
    final = {}
    for v, deg in _stream(edges, window).get_degrees():
        final[v] = deg
    ref = {}
    for s, d, _ in edges:
        ref[s] = ref.get(s, 0) + 1
        ref[d] = ref.get(d, 0) + 1
    assert final == ref, (seed, n, vmax, window)


@pytest.mark.parametrize("seed", [7, 8])
def test_exact_triangles_matches_brute_force(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(50, 250))
    vmax = int(rng.integers(8, 30))
    window = int(rng.integers(1, 40))
    edges = _rand_edges(rng, n, vmax)
    etc = ExactTriangleCount()
    for _ in etc.run(_stream(edges, window)):
        pass
    eset = {(min(a, b), max(a, b)) for a, b, _ in edges if a != b}
    adj = {}
    for a, b in eset:
        adj.setdefault(a, set()).add(b)
        adj.setdefault(b, set()).add(a)
    brute = sum(1 for x, y, z in combinations(sorted(adj), 3)
                if y in adj[x] and z in adj[x] and z in adj[y])
    assert int(etc._total) == brute, (seed, n, vmax, window)


@pytest.mark.parametrize("seed", [9])
def test_cc_invariant_under_stream_transforms(seed):
    rng = np.random.default_rng(seed)
    edges = _rand_edges(rng, 150, 25)
    edges = edges + edges[:40]

    def final(stream):
        return sorted(_final(stream, ConnectedComponents()).component_sets())

    base = final(_stream(edges, 16))
    assert final(_stream(edges, 16).distinct()) == base
    assert final(_stream(edges, 16).undirected()) == base


def _py_bipartite(edges):
    color, adj = {}, {}
    for s, d, _ in edges:
        adj.setdefault(s, []).append(d)
        adj.setdefault(d, []).append(s)
    for start in adj:
        if start in color:
            continue
        color[start] = 0
        stack = [start]
        while stack:
            x = stack.pop()
            for y in adj[x]:
                if y not in color:
                    color[y] = color[x] ^ 1
                    stack.append(y)
                elif color[y] == color[x] and y != x:
                    return False
    return all(s != d for s, d, _ in edges)


@pytest.mark.parametrize("seed", [11, 12, 13])
def test_bipartiteness_matches_python_two_coloring(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(20, 150))
    vmax = int(rng.integers(4, 30))
    window = int(rng.integers(1, 25))
    if seed % 2:
        pairs = rng.integers(0, vmax, size=(n, 2))
        edges = [(int(a) * 2, int(b) * 2 + 1, 0.0) for a, b in pairs]
    else:
        edges = _rand_edges(rng, n, vmax)
    last = _final(_stream(edges, window), BipartitenessCheck())
    assert last.success == _py_bipartite(edges), (seed, n, vmax, window)
