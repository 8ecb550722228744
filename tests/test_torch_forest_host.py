"""The forest carry's host fold and repair in the port against the JAX
package: ``fold_edges_host``, ``fold_into_forest_host`` and
``repair_forest_host`` (with its stats) on the same seeded numpy inputs
give equal arrays, and each equals the from-scratch fold it promises.

Mirrors the host-forest cases the reference pins through
``tests/test_eventtime.py`` (the retraction's repair and the per-pane
fold), and ``tests/test_forest.py:376-440`` (the router's incremental
merged-forest delta, ``apply_forest_delta_host``).
"""

import numpy as np
import pytest

from gelly_streaming_tpu.summaries import forest as jf
from gelly_streaming_tpu_torch.summaries import forest as tf


def _table(rng, n, depth_steps=3):
    """A min-rooted pointer forest of any depth (``t[v] <= v``): random
    hooks onto smaller ids, not resolved."""
    t = np.arange(n, dtype=np.int64)
    for _ in range(depth_steps):
        v = rng.integers(1, n, n // 4)
        t[v] = np.minimum(t[v], rng.integers(0, v))
    return t


def _edges(rng, n, m):
    return rng.integers(0, n, m).astype(np.int64), rng.integers(0, n, m).astype(np.int64)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fold_edges_host_equals_the_jax_package(seed):
    rng = np.random.default_rng(seed)
    n = 300
    t = _table(rng, n)
    s, d = _edges(rng, n, 200)
    got = tf.fold_edges_host(t, s, d)
    want = jf.fold_edges_host(t, s, d)
    np.testing.assert_array_equal(got, want)
    assert np.all(got[got] == got) and np.all(got <= np.arange(n))
    # an empty group only canonicalizes
    np.testing.assert_array_equal(tf.fold_edges_host(t, s[:0], d[:0]),
                                  jf.resolve_flat_host(t))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fold_into_forest_host_equals_the_jax_package_and_the_full_fold(seed):
    rng = np.random.default_rng(10 + seed)
    n = 2000
    t = tf.fold_edges_host(np.arange(n, dtype=np.int64), *_edges(rng, n, 600))
    s, d = _edges(rng, n, 40)  # a small group against a big table
    got = tf.fold_into_forest_host(t, s, d)
    np.testing.assert_array_equal(got, jf.fold_into_forest_host(t, s, d))
    np.testing.assert_array_equal(got, tf.fold_edges_host(t, s, d))
    # a group that unites nothing new returns the table as it was
    same = tf.fold_into_forest_host(got, s, d)
    np.testing.assert_array_equal(same, got)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_repair_forest_host_equals_the_jax_package_with_its_stats(seed):
    rng = np.random.default_rng(20 + seed)
    n = 500
    panes = [_edges(rng, n, 120) for _ in range(4)]
    s_all = np.concatenate([p[0] for p in panes])
    d_all = np.concatenate([p[1] for p in panes])
    lab = tf.fold_edges_host(np.arange(n, dtype=np.int64), s_all, d_all)
    exp_s, exp_d = panes[0]
    sur_s = np.concatenate([p[0] for p in panes[1:]])
    sur_d = np.concatenate([p[1] for p in panes[1:]])
    got, stats = tf.repair_forest_host(lab, exp_s, exp_d, sur_s, sur_d)
    want, wstats = jf.repair_forest_host(lab, exp_s, exp_d, sur_s, sur_d)
    np.testing.assert_array_equal(got, want)
    assert stats == wstats
    assert stats["surviving"] == len(sur_s) and stats["roots"] > 0
    assert 0 < stats["refolded"] <= len(sur_s)
    # the oracle contract: a from-scratch fold of the survivors
    np.testing.assert_array_equal(
        got, tf.fold_edges_host(np.arange(n, dtype=np.int64), sur_s, sur_d))


def test_repair_with_nothing_expired_and_mismatched_columns():
    lab = np.arange(6, dtype=np.int64)
    z = np.zeros(0, np.int64)
    out, stats = tf.repair_forest_host(lab, z, z, np.array([1]), np.array([2]))
    np.testing.assert_array_equal(out, lab)
    assert stats == {"roots": 0, "members": 0, "refolded": 0, "surviving": 1}
    with pytest.raises(ValueError, match="expired"):
        tf.repair_forest_host(lab, np.array([1]), z, z, z)
    with pytest.raises(ValueError, match="surviving"):
        tf.repair_forest_host(lab, z, z, np.array([1]), z)


# --------------------------------------------------------------------- #
# Incremental merged-forest delta (apply_forest_delta_host)
# --------------------------------------------------------------------- #
def _union_find_components(edges):
    parent = {}

    def find(x):
        parent.setdefault(x, x)
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for a, b in edges:
        ra, rb = find(a), find(b)
        if ra != rb:
            parent[max(ra, rb)] = min(ra, rb)
    comps = {}
    for v in parent:
        comps.setdefault(find(v), set()).add(v)
    return list(comps.values())


def test_apply_forest_delta_matches_scratch_fold():
    """Repeated incremental application equals a from-scratch fold of
    the full edge set (after resolve), and the size table stays exact
    at every root — the router's O(changed) merge-refresh contract; the
    JAX package's apply on the same inputs leaves equal tables, sizes and
    touched roots at every step."""
    rng = np.random.default_rng(31)
    n = 200
    base_s = rng.integers(0, n, 300)
    base_d = rng.integers(0, n, 300)
    flat = tf.fold_edges_host(np.arange(n, dtype=np.int32), base_s, base_d)
    lab = flat.astype(np.int64)
    sizes = np.bincount(flat, minlength=n).astype(np.int64)
    jlab, jsizes = lab.copy(), sizes.copy()
    all_s, all_d = base_s.tolist(), base_d.tolist()
    for _ in range(6):
        ds = rng.integers(0, n, 15)
        dd = rng.integers(0, n, 15)
        touched = tf.apply_forest_delta_host(lab, sizes, ds, dd)
        jtouched = jf.apply_forest_delta_host(jlab, jsizes, ds, dd)
        np.testing.assert_array_equal(lab, jlab)
        np.testing.assert_array_equal(sizes, jsizes)
        np.testing.assert_array_equal(touched, jtouched)
        all_s += ds.tolist()
        all_d += dd.tolist()
        want = tf.fold_edges_host(
            np.arange(n, dtype=np.int32),
            np.asarray(all_s), np.asarray(all_d),
        )
        assert np.array_equal(tf.resolve_flat_host(lab),
                              want.astype(np.int64))
        for r in np.unique(want):
            assert sizes[r] == int(np.sum(want == r))
    # the final state also matches the union-find oracle
    comps = _union_find_components(zip(all_s, all_d))
    got = tf.resolve_flat_host(lab)
    for comp in comps:
        assert len({int(got[v]) for v in comp}) == 1


def test_apply_forest_delta_reports_touched_roots():
    for mod in (tf, jf):
        lab = np.arange(8, dtype=np.int64)
        sizes = np.ones(8, np.int64)
        # an effective union touches BOTH sides (winner and absorbed)
        t = mod.apply_forest_delta_host(lab, sizes,
                                        np.asarray([3]), np.asarray([5]))
        assert sorted(t.tolist()) == [3, 5]
        assert lab[5] == 3 and sizes[3] == 2
        # the same edge again is a no-op: nothing touched
        t = mod.apply_forest_delta_host(lab, sizes,
                                        np.asarray([3]), np.asarray([5]))
        assert len(t) == 0
        # a chained union reports the ROOTS involved, not the raw endpoints
        t = mod.apply_forest_delta_host(lab, sizes,
                                        np.asarray([5]), np.asarray([1]))
        assert sorted(t.tolist()) == [1, 3]
        assert sizes[1] == 3
        # torn delta columns are rejected, never half-applied
        with pytest.raises(ValueError):
            mod.apply_forest_delta_host(lab, sizes,
                                        np.asarray([1]), np.asarray([], np.int64))

