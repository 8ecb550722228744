"""Segment reductions and CSR rows: the port against the JAX package.

``gelly_streaming_tpu_torch.ops.segment`` and ``ops.csr`` against
``gelly_streaming_tpu.ops.segment`` and ``ops.csr`` on the same seeded
numpy inputs, at ragged sizes with padding and empty segments. Integer
results must be equal, dtype included. Float results: the monoid
reductions ``min``/``max`` are exact; ``sum`` and ``prod`` and the
generic scan add in another order than XLA, so they are held to a
relative 1e-5 (float32); the fold applies the same float32 operations in
the same order, held to 1e-6 (XLA may fuse a multiply-add).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._pytree import tree_leaves

from gelly_streaming_tpu.ops import csr as jcsr
from gelly_streaming_tpu.ops import segment as jseg
from gelly_streaming_tpu_torch.ops import csr as tcsr
from gelly_streaming_tpu_torch.ops import segment as tseg

SHAPES = [(8, 1), (37, 10), (256, 64), (300, 7)]

# the JAX side jitted whole (one compile per shape; op-by-op dispatch of
# its scans costs seconds per case on the CPU)
_j_reduce = jax.jit(jseg.segment_reduce, static_argnums=(3, 4))
_j_count = jax.jit(jseg.segment_count, static_argnums=(2,))
_j_sort = jax.jit(jseg.sort_by_segment)
_j_generic = jax.jit(jseg.segmented_reduce_generic, static_argnums=(3, 4))
_j_build_csr = jax.jit(jcsr.build_csr, static_argnums=(4,))
_j_dense = jax.jit(jcsr.dense_neighbors, static_argnums=(1,))
_j_sorted_rows = jax.jit(jcsr.sorted_neighbor_matrix, static_argnums=(1,))
_j_subset = jax.jit(jcsr.dense_neighbors_subset, static_argnums=(2,))


def _case(seed, n, v, dtype=np.float32, used=None):
    """Ids over a subset of [0, v) (so some segments stay empty), a mask
    with holes, values of ``dtype``."""
    rng = np.random.default_rng(seed)
    pool = np.arange(v) if used is None else rng.choice(v, max(1, used), replace=False)
    ids = rng.choice(pool, n).astype(np.int32)
    nbr = rng.integers(0, v, n).astype(np.int32)
    mask = rng.random(n) < 0.8
    if dtype == np.int32:
        vals = rng.integers(-50, 50, n).astype(np.int32)
    else:
        vals = rng.normal(size=n).astype(np.float32)
    return ids, nbr, mask, vals


def _t(a):
    return torch.from_numpy(np.array(a))


def _eq(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n,v", SHAPES)
@pytest.mark.parametrize("op", ["sum", "min", "max", "prod"])
@pytest.mark.parametrize("dtype", [np.int32, np.float32])
def test_segment_reduce_matches_jax_including_empty_segments(n, v, op, dtype):
    ids, _nbr, mask, vals = _case(n * 7 + v, n, v, dtype, used=max(1, v // 2))
    if op == "prod" and dtype == np.float32:
        vals = (1.0 + 0.1 * vals).astype(np.float32)
    if op == "prod" and dtype == np.int32:
        vals = np.clip(vals, -2, 2)
    want = np.asarray(_j_reduce(jnp.asarray(vals), jnp.asarray(ids), jnp.asarray(mask), v, op))
    got = tseg.segment_reduce(_t(vals), _t(ids), _t(mask), v, op=op).numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    if dtype == np.float32 and op in ("sum", "prod"):
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_array_equal(got, want)


def test_segment_reduce_trailing_dims_match_jax():
    ids, _nbr, mask, _ = _case(3, 50, 9, used=5)
    vals = np.random.default_rng(4).normal(size=(50, 3)).astype(np.float32)
    for op in ("min", "max"):
        want = jseg.segment_reduce(jnp.asarray(vals), jnp.asarray(ids), jnp.asarray(mask), 9, op)
        _eq(tseg.segment_reduce(_t(vals), _t(ids), _t(mask), 9, op), want)


@pytest.mark.parametrize("n,v", SHAPES)
def test_segment_count_and_sort_by_segment_match_jax(n, v):
    ids, nbr, mask, vals = _case(n + v, n, v, used=max(1, v // 3))
    _eq(tseg.segment_count(_t(ids), _t(mask), v),
        _j_count(jnp.asarray(ids), jnp.asarray(mask), v))
    want = _j_sort(jnp.asarray(ids), jnp.asarray(mask), jnp.asarray(nbr),
                                (jnp.asarray(vals), jnp.asarray(nbr)))
    got = tseg.sort_by_segment(_t(ids), _t(mask), _t(nbr), (_t(vals), _t(nbr)))
    for g, w in zip(got[:3] + got[3], want[:3] + want[3]):
        _eq(g, w)
    last_w, ne_w = jseg._segment_last_index(want[0], v)
    last_g, ne_g = tseg._segment_last_index(got[0], v)
    np.testing.assert_array_equal(last_g.numpy(), np.asarray(last_w))
    _eq(ne_g, ne_w)


def _sum_max_jax(a, b):
    return a[0] + b[0], jnp.maximum(a[1], b[1])


def _add(a, b):
    return a + b


def _clamped_combine_jax(a, b):
    return a[0] + b[0], jnp.maximum(b[1], a[1] + b[0])


def _clamped_combine_torch(a, b):
    return a[0] + b[0], torch.maximum(b[1], a[1] + b[0])


@pytest.mark.parametrize("n,v", SHAPES)
def test_segmented_reduce_generic_int_combines_exact(n, v):
    """An integer sum and the non-commutative clamped-update composition
    of the degree workload: equal on every nonempty segment."""
    ids, _nbr, mask, vals = _case(n * 3 + v, n, v, np.int32, used=max(1, v // 2))
    zeros = np.zeros_like(vals)
    cases = [
        (jnp.asarray(vals), _t(vals), _add, _add),
        ((jnp.asarray(vals), jnp.asarray(zeros)), (_t(vals), _t(zeros)),
         _clamped_combine_jax, _clamped_combine_torch),
    ]
    for jv, tv, jc, tc in cases:
        want, ne_w = _j_generic(jv, jnp.asarray(ids), jnp.asarray(mask), v, jc)
        got, ne_g = tseg.segmented_reduce_generic(tv, _t(ids), _t(mask), v, tc)
        _eq(ne_g, ne_w)
        sel = np.asarray(ne_w)
        for g, w in zip(tree_leaves(got), jax.tree.leaves(want)):
            assert g.numpy().dtype == np.asarray(w).dtype
            np.testing.assert_array_equal(g.numpy()[sel], np.asarray(w)[sel])


@pytest.mark.parametrize("n,v", SHAPES)
def test_segmented_reduce_generic_float_combine_within_tolerance(n, v):
    ids, _nbr, mask, vals = _case(n * 5 + v, n, v, used=max(1, v // 2))
    want, ne_w = _j_generic(
        (jnp.asarray(vals), jnp.asarray(vals)), jnp.asarray(ids), jnp.asarray(mask), v,
        _sum_max_jax)
    got, ne_g = tseg.segmented_reduce_generic(
        (_t(vals), _t(vals)), _t(ids), _t(mask), v,
        lambda a, b: (a[0] + b[0], torch.maximum(a[1], b[1])))
    _eq(ne_g, ne_w)
    sel = np.asarray(ne_w)
    np.testing.assert_allclose(got[0].numpy()[sel], np.asarray(want[0])[sel], rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got[1].numpy()[sel], np.asarray(want[1])[sel])


@pytest.mark.parametrize("n,v", SHAPES)
def test_segmented_fold_order_dependent_matches_jax(n, v):
    """A non-associative, order-dependent fold: a rolling hash of the
    neighbor ids and a decaying float sum, through raw-id tables. Every
    nonempty segment equal; the lockstep depth is the longest segment."""
    ids, nbr, mask, vals = _case(n * 11 + v, n, v, used=max(1, v // 2))
    raw = (np.arange(v, dtype=np.int32) * 7 + 3).astype(np.int32)

    def fold_j(acc, vid, nid, val):
        return (acc[0] * 31 + nid + vid) % 1000003, acc[1] * 0.5 + val

    def fold_t(acc, vid, nid, val):
        return (acc[0] * 31 + nid + vid) % 1000003, acc[1] * 0.5 + val

    want, ne_w = jseg.segmented_fold(
        (0, 0.0), fold_j, jnp.asarray(ids), jnp.asarray(nbr), jnp.asarray(vals),
        jnp.asarray(mask), v, id_of_segment=jnp.asarray(raw), id_of_neighbor=jnp.asarray(raw))
    counts = np.bincount(ids[mask], minlength=v)
    before = tseg.FOLD_TURNS
    got, ne_g = tseg.segmented_fold(
        (0, 0.0), fold_t, _t(ids), _t(nbr), _t(vals), _t(mask), v,
        id_of_segment=_t(raw), id_of_neighbor=_t(raw),
        counts_host=counts if n % 2 else None)
    assert tseg.FOLD_TURNS - before == counts.max()
    _eq(ne_g, ne_w)
    sel = np.asarray(ne_w)
    _eq(got[0][_t(sel)], np.asarray(want[0])[sel])
    np.testing.assert_allclose(got[1].numpy()[sel], np.asarray(want[1])[sel], rtol=1e-6, atol=1e-6)
    # empty segments hold the initial value
    assert (got[0].numpy()[~sel] == 0).all() and (got[1].numpy()[~sel] == 0).all()


def test_segmented_fold_rejects_a_dtype_changing_fold():
    ids = np.array([0, 0, 1], np.int32)
    with pytest.raises(TypeError, match="dtype"):
        tseg.segmented_fold(0, lambda acc, v, n, x: acc + x, _t(ids), _t(ids),
                            _t(np.ones(3, np.float32)), _t(np.ones(3, bool)), 2)


@pytest.mark.parametrize("n,v", SHAPES)
def test_csr_and_dense_rows_match_jax(n, v):
    ids, nbr, mask, vals = _case(n * 13 + v, n, v, used=max(1, v // 2))
    jc = _j_build_csr(jnp.asarray(ids), jnp.asarray(nbr), jnp.asarray(vals),
                      jnp.asarray(mask), v)
    tc = tcsr.build_csr(_t(ids), _t(nbr), _t(vals), _t(mask), v)
    for f in ("sorted_key", "sorted_nbr", "sorted_val", "sorted_mask", "row_ptr", "degree"):
        _eq(getattr(tc, f), getattr(jc, f))
    assert tc.num_vertices == jc.num_vertices == v
    maxd = int(np.asarray(jc.degree).max())
    for D in sorted({max(maxd, 1), max(maxd // 2, 1), 8}):
        for g, w in zip(tcsr.dense_neighbors(tc, D), _j_dense(jc, D)):
            _eq(g, w)
        rows_g, valid_g = tcsr.sorted_neighbor_matrix(tc, D)
        rows_w, valid_w = _j_sorted_rows(jc, D)
        _eq(rows_g, rows_w)
        _eq(valid_g, valid_w)
        vids = np.random.default_rng(D).integers(0, v, 5).astype(np.int32)
        for g, w in zip(tcsr.dense_neighbors_subset(tc, _t(vids), D),
                        _j_subset(jc, jnp.asarray(vids), D)):
            _eq(g, w)
