"""The plain references against tiny hand-made graphs and scipy."""

import numpy as np
import pytest
import torch

from graphbench.reference import cc, pagerank


def _cols(edges):
    s = torch.tensor([e[0] for e in edges], dtype=torch.int32)
    d = torch.tensor([e[1] for e in edges], dtype=torch.int32)
    return s, d


def test_cc_hand_made_prefixes():
    # 5-1, 1-3 | 7-6 | 3-0, 2-2 (a self loop)
    s, d = _cols([(5, 1), (1, 3), (7, 6), (3, 0), (2, 2)])
    (i2, l2), (i3, l3), (i5, l5) = cc.prefix_components(s, d, 8, [2, 3, 5])
    assert i2.tolist() == [1, 3, 5] and l2.tolist() == [1, 1, 1]
    assert i3.tolist() == [1, 3, 5, 6, 7] and l3.tolist() == [1, 1, 1, 6, 6]
    assert i5.tolist() == [0, 1, 2, 3, 5, 6, 7] and l5.tolist() == [0, 0, 2, 0, 0, 6, 6]


def test_cc_long_chain_reaches_its_least_id():
    n = 300
    order = np.random.default_rng(3).permutation(n)
    s, d = _cols(list(zip(order[:-1], order[1:])))
    ids, least = cc.prefix_components(s, d, n, [n - 1])[0]
    assert ids.tolist() == list(range(n)) and set(least.tolist()) == {0}


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_cc_against_scipy(seed):
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components

    rng = np.random.default_rng(seed)
    n, e = 2000, 1500
    src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
    got = cc.prefix_components(torch.from_numpy(src), torch.from_numpy(dst), n, [e])[0]
    _, comp = connected_components(coo_matrix((np.ones(e), (src, dst)), shape=(n, n)),
                                   directed=True, connection="weak")
    least = np.full(comp.max() + 1, n)
    np.minimum.at(least, comp, np.arange(n))
    seen = np.union1d(src, dst)
    assert got[0].tolist() == seen.tolist()
    assert got[1].tolist() == least[comp[seen]].tolist()


def test_cc_compare_counts_differences():
    want = (np.array([1, 2, 3]), np.array([1, 1, 3]))
    assert cc.compare(want, want) == (0, 0)
    assert cc.compare((np.array([1, 2, 3]), np.array([1, 1, 1])), want) == (0, 1)
    assert cc.compare((np.array([1, 2]), np.array([1, 1])), want) == (1, 3)


def test_least_of_components_from_any_labels():
    ids, least = cc.least_of_components(np.array([9, 4, 7, 2]), np.array([5, 5, 8, 8]))
    assert ids.tolist() == [2, 4, 7, 9] and least.tolist() == [2, 4, 2, 4]


def test_capped_control_misses_a_chain():
    # 1-3 joins {0, 1} and {2, 3} at 3, not at 3's root 2: one round
    # leaves 2 behind
    s, d = _cols([(0, 1), (3, 2), (1, 3)])
    want = cc.prefix_components(s, d, 4, [3])[0]
    got = cc.capped_window_labels(s, d, 4, 1, [3])[0]
    assert cc.compare(got, want)[1] > 0


def test_pagerank_hand_made_cycle_and_dangling():
    # 0 -> 1 -> 2 -> 0: uniform ranks
    s, d = _cols([(0, 1), (1, 2), (2, 0)])
    r = pagerank.fixpoint(s, d, 0.85)
    assert torch.allclose(r, torch.full((3,), 1 / 3, dtype=torch.float64), atol=1e-12)
    # 0 -> 1 with 1 dangling, t = (1 - d) / 2: r0 = t + d r1 / 2 and
    # r1 = t + d (r0 + r1 / 2)
    s, d = _cols([(0, 1)])
    r = pagerank.fixpoint(s, d, 0.85)
    a = np.array([[1, -0.85 / 2], [-0.85, 1 - 0.85 / 2]])
    want = np.linalg.solve(a, np.array([0.075, 0.075]))
    assert np.allclose(r.numpy(), want, atol=1e-12)
    assert abs(float(r.sum()) - 1) < 1e-12


def test_pagerank_ids_below_the_largest_hold_rank():
    s, d = _cols([(3, 1)])
    r = pagerank.fixpoint(s, d, 0.85)
    assert r.shape[0] == 4 and float(r[0]) > 0 and abs(float(r.sum()) - 1) < 1e-12


def test_pagerank_windowed_float64_agrees_with_fixpoint():
    rng = np.random.default_rng(4)
    src = torch.from_numpy(rng.integers(0, 300, 4000).astype(np.int32))
    dst = torch.from_numpy(rng.integers(0, 300, 4000).astype(np.int32))
    got = pagerank.windowed_ranks(src, dst, 1000, [2000, 4000], 0.85, 1e-12, 500,
                                  torch.float64)
    for g, end in zip(got, [2000, 4000]):
        l1, rel = pagerank.gaps(g, pagerank.fixpoint(src[:end], dst[:end], 0.85))
        assert l1 < 1e-10 and rel < 1e-8


def test_pagerank_gaps_count_slots_past_the_vertices():
    want = torch.tensor([0.5, 0.5], dtype=torch.float64)
    assert pagerank.gaps(torch.tensor([0.5, 0.5, 0.0]), want) == (0.0, 0.0)
    l1, rel = pagerank.gaps(torch.tensor([0.5, 0.25, 0.25]), want)
    assert l1 == pytest.approx(0.5) and rel == pytest.approx(0.5)
