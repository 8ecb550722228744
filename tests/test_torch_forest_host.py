"""The forest carry's host fold and repair in the port against the JAX
package: ``fold_edges_host``, ``fold_into_forest_host`` and
``repair_forest_host`` (with its stats) on the same seeded numpy inputs
give equal arrays, and each equals the from-scratch fold it promises.

Mirrors the host-forest cases the reference pins through
``tests/test_eventtime.py`` (the retraction's repair and the per-pane
fold).
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
