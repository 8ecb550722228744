"""The on-card R-MAT generator against the numpy arithmetic it copies."""

import numpy as np
import pytest
import torch

from graphbench import generate


@pytest.mark.parametrize("t", [0.57, 0.76, 0.95, 0.19, 0.5, 1e-9, 0.9999999])
def test_f32_at_least_is_the_least_float32_at_or_above(t):
    f = generate.f32_at_least(t)
    assert f >= t
    assert float(np.nextafter(np.float32(f), np.float32(-np.inf))) < t


def _numpy_bits(r, a, b, c):
    """``datasets.rmat_edges``' own arithmetic, run on the given draws
    (its generator replaced by one that hands them out row by row)."""
    from gelly_streaming_tpu_torch import datasets

    class Rows:
        def __init__(self):
            self.i = 0

        def random(self, n):
            row = r[self.i].astype(np.float64)
            self.i += 1
            assert len(row) == n
            return row

    real = np.random.default_rng
    np.random.default_rng = lambda seed=None: Rows()
    try:
        return datasets.rmat_edges(r.shape[1], r.shape[0], seed=0, a=a, b=b, c=c)
    finally:
        np.random.default_rng = real


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 11])
def test_torch_copy_matches_numpy_on_the_same_draws(seed):
    scale, n, (a, b, c) = 9, 5000, (0.57, 0.19, 0.19)
    g = generate.generator(seed, "cpu")
    draws = torch.empty(scale, n)
    for i in range(scale):
        draws[i].uniform_(0.0, 1.0, generator=g)
    src = torch.zeros(n, dtype=torch.int32)
    dst = torch.zeros(n, dtype=torch.int32)
    for i in range(scale):
        s_bit, d_bit = generate.rmat_bits(draws[i], a, b, c)
        src = src * 2 + s_bit
        dst = dst * 2 + d_bit
    ws, wd = _numpy_bits(draws.numpy(), a, b, c)
    np.testing.assert_array_equal(src.numpy(), ws)
    np.testing.assert_array_equal(dst.numpy(), wd)
    # rmat() draws the same rows in the same order
    gs, gd = generate.rmat(n, scale, a, b, c, seed, "cpu")
    np.testing.assert_array_equal(gs.numpy(), ws)
    np.testing.assert_array_equal(gd.numpy(), wd)


def test_draws_on_a_threshold_fall_as_numpy_puts_them():
    a, b, c = 0.57, 0.19, 0.19
    edges = [np.float32(x) for x in (a, a + b, a + b + c)]
    r = np.array([[v for e in edges
                   for v in (np.nextafter(e, np.float32(0)), e, np.nextafter(e, np.float32(1)))]],
                 np.float32)
    s_bit, d_bit = generate.rmat_bits(torch.from_numpy(r[0]), a, b, c)
    ws, wd = _numpy_bits(r, a, b, c)
    np.testing.assert_array_equal(s_bit.numpy().astype(np.int64), ws)
    np.testing.assert_array_equal(d_bit.numpy().astype(np.int64), wd)


def test_same_seed_same_stream_other_seed_other_stream():
    one = generate.rmat(4096, 12, 0.57, 0.19, 0.19, 5, "cpu")
    two = generate.rmat(4096, 12, 0.57, 0.19, 0.19, 5, "cpu")
    three = generate.rmat(4096, 12, 0.57, 0.19, 0.19, 6, "cpu")
    assert torch.equal(one[0], two[0]) and torch.equal(one[1], two[1])
    assert not torch.equal(one[0], three[0])
    assert int(one[0].max()) < 4096 and int(one[0].min()) >= 0


def test_unknown_generator_is_refused():
    with pytest.raises(ValueError):
        generate.edges({"kind": "zipf"}, 1, "cpu")
