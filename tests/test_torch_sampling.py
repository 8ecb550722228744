"""Sampling triangle estimators: the port against the JAX package.

The estimators are Monte Carlo, and the two packages draw their uniforms
from different generator families (a carried ``jax.random`` key; a seeded
``torch.Generator``). So the exact checks feed the port the uniforms the
JAX package draws: the test recomputes them from the JAX key the way its
steps do (``jax.random.split`` of the key, then ``jax.random.uniform`` of
each subkey, ``library/sampling.py:63``, ``:137``). Given those, both
window forms' states, edge counts and ``beta_sum`` must be EQUAL after
every window, and whole runs must emit the same estimates. The
statistical cases run the port with its own generator at the reference's
own bounds.

Mirrors ``tests/test_sampling.py``.
"""

import itertools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gelly_streaming_tpu.core.window import CountWindow as JaxCountWindow
from gelly_streaming_tpu.library import sampling as JS
from gelly_streaming_tpu_torch.core.window import CountWindow
from gelly_streaming_tpu_torch.library import sampling as TS
from gelly_streaming_tpu_torch.library.sampling import (
    BroadcastTriangleCount,
    IncidenceSamplingTriangleCount,
)


def complete_graph_edges(n):
    return [(a, b, 0.0) for a, b in itertools.combinations(range(n), 2)]


def _btc(**kw):
    return BroadcastTriangleCount(device="cpu", **kw)


def _uniform(key, k):
    return torch.from_numpy(np.array(jax.random.uniform(key, (k,))))


def _vectorized_draws(key, k):
    """The JAX vectorized step's key split and its three uniform vectors."""
    key, k_keep, k_sel, k_third = jax.random.split(key, 4)
    return key, [_uniform(k_keep, k), _uniform(k_sel, k), _uniform(k_third, k)]


def _scan_draws(key, k, n, cap):
    """The JAX scan's per-slot key splits over a window of ``cap`` slots
    (padding included); the coin and third-vertex draws of the first
    ``n`` (the valid edges) as ``[n, k]``."""
    coins, thirds = [], []
    for i in range(cap):
        key, k_coin, k_third = jax.random.split(key, 3)
        if i < n:
            coins.append(_uniform(k_coin, k))
            thirds.append(_uniform(k_third, k))
    return key, torch.stack(coins), torch.stack(thirds)


class _JaxUniforms(BroadcastTriangleCount):
    """The port's estimator fed the JAX package's uniforms: before each
    window the draws the JAX step would make from ``key`` are queued for
    ``_draw``."""

    def __init__(self, key, **kw):
        super().__init__(device="cpu", **kw)
        self.key = key
        self._queue = []

    def _window(self, block, vdict):
        k = self.samples
        n = len(block._host_cache[0])
        if self.vertex_count <= TS._PACK_LIMIT:
            self.key, self._queue = _vectorized_draws(self.key, k)
        else:
            self.key, coins, thirds = _scan_draws(self.key, k, n, block.capacity)
            self._queue = [coins, thirds]
        return super()._window(block, vdict)

    def _draw(self, *shape):
        return self._queue.pop(0)


def _random_edges(seed, n, v):
    rng = np.random.default_rng(seed)
    s = rng.integers(0, v, n)
    d = rng.integers(0, v, n)
    return [(int(a), int(b), 0.0) for a, b in zip(s, d)]


# --------------------------------------------------------------------- #
# exact: the steps and whole runs with the JAX package's uniforms
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_window_vectorized_equals_jax_with_its_uniforms(seed):
    """Several windows of a dense random stream (a padded last window),
    the state after every one equal; beta_sum reaches non-zero values."""
    rng = np.random.default_rng(seed)
    v, k, cap = 24, 512, 256
    key = jax.random.PRNGKey(seed)
    jst, tst, ec = JS.init_sampler_state(k), TS.init_sampler_state(k, "cpu"), 0
    betas = []
    for n in (256, 256, 200):
        s = rng.integers(0, v, cap).astype(np.int32)
        d = rng.integers(0, v, cap).astype(np.int32)
        mask = np.arange(cap) < n
        key_next, draws = _vectorized_draws(key, k)
        jst, jn, key, jb = JS._window_vectorized(
            jst, jnp.int32(ec), key, (jnp.asarray(s), jnp.asarray(d)), jnp.asarray(mask), v)
        tst, ec, tb = TS._window_vectorized(
            tst, ec, torch.from_numpy(s), torch.from_numpy(d), torch.from_numpy(mask),
            n, v, *draws)
        np.testing.assert_array_equal(np.asarray(key), np.asarray(key_next))
        for f in jst:
            np.testing.assert_array_equal(np.asarray(jst[f]), tst[f].numpy(), err_msg=f)
        assert int(jn) == ec and int(jb) == int(tb)
        betas.append(int(tb))
    assert max(betas) > 0


@pytest.mark.parametrize("v", [14, 50_000])
def test_window_scan_equals_jax_with_its_uniforms(v):
    """Two windows of edges among 12 ids: over 14 vertices the third
    vertex often closes a wedge; over an id space above the vectorized
    form's limit (where the scan is the route) it almost never does."""
    rng = np.random.default_rng(v)
    k, cap, n = 128, 64, 60
    key = jax.random.PRNGKey(3)
    jst, tst, ec = JS.init_sampler_state(k), TS.init_sampler_state(k, "cpu"), 0
    for _ in range(2):
        s = rng.integers(0, 12, cap).astype(np.int32)
        d = rng.integers(0, 12, cap).astype(np.int32)
        mask = np.arange(cap) < n
        key_next, coins, thirds = _scan_draws(key, k, n, cap)
        jst, jn, key, jb = JS._window_scan(
            jst, jnp.int32(ec), key, (jnp.asarray(s), jnp.asarray(d)), jnp.asarray(mask), v)
        tst, ec = TS._window_scan(tst, ec, s[:n], d[:n], v, coins, thirds)
        np.testing.assert_array_equal(np.asarray(key), np.asarray(key_next))
        for f in jst:
            np.testing.assert_array_equal(np.asarray(jst[f]), tst[f].numpy(), err_msg=f)
        assert int(jn) == ec
    if v == 14:
        assert (tst["src_found"] & tst["trg_found"]).any()


@pytest.mark.parametrize("form", ["vectorized", "scan"])
def test_run_emissions_equal_jax_with_its_uniforms(form, monkeypatch):
    """Whole runs through the classes' own windowing, each package's route
    forced to the same form: the same emissions and the same final
    reservoir."""
    if form == "scan":
        monkeypatch.setattr(TS, "_PACK_LIMIT", -1)
        monkeypatch.setattr(JS, "_PACK_LIMIT", -1)
    vertex_count = 40
    edges = _random_edges(5, 300, 40)
    kw = dict(vertex_count=vertex_count, samples=96, window=CountWindow(64))
    port = _JaxUniforms(jax.random.PRNGKey(9), **kw)
    got = list(port.run(edges))
    ref = JS.BroadcastTriangleCount(vertex_count=vertex_count, samples=96,
                                    window=JaxCountWindow(64), seed=9)
    want = list(ref.run(edges))
    assert got == want and got
    for f, v in ref._state.items():
        np.testing.assert_array_equal(np.asarray(v), port._state[f].numpy(), err_msg=f)
    assert port._edge_count == int(ref._edge_count) == len(edges)


def test_state_dict_crosses_packages_both_ways():
    """A JAX checkpoint loads into the port and a port checkpoint into the
    JAX package (with the JAX sampler's own key: generator states do not
    cross); continuing on the same uniforms, both emit the same."""
    edges = _random_edges(6, 400, 30)
    first, second = edges[:192], edges[192:]
    kw = dict(vertex_count=30, samples=128)
    # JAX -> port
    ref = JS.BroadcastTriangleCount(window=JaxCountWindow(64), seed=1, **kw)
    list(ref.run(first))
    port = _JaxUniforms(ref._key, window=CountWindow(64), **kw)
    port.load_state_dict(ref.state_dict())
    assert port._edge_count == len(first)
    assert list(port.run(second)) == list(ref.run(second))
    # port -> JAX
    port = _JaxUniforms(jax.random.PRNGKey(2), window=CountWindow(64), **kw)
    list(port.run(first))
    ref = JS.BroadcastTriangleCount(window=JaxCountWindow(64), **kw)
    sd = port.state_dict()
    assert set(sd) >= {"state", "edge_count", "previous"}
    ref.load_state_dict({**sd, "key": np.asarray(port.key)})
    for f, v in ref._state.items():
        np.testing.assert_array_equal(np.asarray(v), port._state[f].numpy(), err_msg=f)
    assert list(ref.run(second)) == list(port.run(second))


def test_port_state_dict_restores_its_generator():
    edges = complete_graph_edges(12)
    a = _btc(vertex_count=12, samples=300, window=CountWindow(16), seed=42)
    list(a.run(edges[:32]))
    b = _btc(vertex_count=12, samples=300, window=CountWindow(16), seed=7)
    b.load_state_dict(a.state_dict())
    assert list(a.run(edges[32:])) == list(b.run(edges[32:]))


# --------------------------------------------------------------------- #
# the reference's own cases, with the port's generator
# --------------------------------------------------------------------- #
def test_triangle_free_graph_estimates_zero():
    edges = [(0, i, 0.0) for i in range(1, 40)]
    btc = _btc(vertex_count=40, samples=500, window=CountWindow(7))
    assert list(btc.run(edges)) == []
    assert btc._previous == 0


def test_estimate_on_complete_graph_statistically_close():
    n = 20
    edges = complete_graph_edges(n)  # C(20,3) = 1140 triangles
    np.random.default_rng(5).shuffle(edges)
    btc = _btc(vertex_count=n, samples=4000, window=CountWindow(64), seed=1)
    last = None
    for _, est in btc.run(edges):
        last = est
    assert last is not None
    assert 0.5 * 1140 < last < 2.0 * 1140, last


def test_deterministic_per_seed():
    edges = complete_graph_edges(12)
    runs = [list(_btc(vertex_count=12, samples=300, window=CountWindow(16),
                      seed=42).run(edges)) for _ in range(2)]
    assert runs[0] == runs[1]
    other = _btc(vertex_count=12, samples=300, window=CountWindow(16), seed=43)
    assert list(other.run(edges)) != [] or runs[0] == []


def test_incidence_variant_same_estimator():
    edges = complete_graph_edges(10)
    a = _btc(vertex_count=10, samples=200, seed=7)
    b = IncidenceSamplingTriangleCount(vertex_count=10, samples=200, seed=7, device="cpu")
    assert list(a.run(edges)) == list(b.run(edges))


def test_change_only_emission():
    edges = complete_graph_edges(15)
    out = list(_btc(vertex_count=15, samples=100, window=CountWindow(5), seed=3).run(edges))
    ests = [e for _, e in out]
    assert all(a != b for a, b in zip(ests, ests[1:]))


def test_vertex_count_validation():
    with pytest.raises(ValueError):
        _btc(vertex_count=2)


def test_vectorized_matches_scan_statistically(monkeypatch):
    n = 16
    edges = complete_graph_edges(n)  # C(16,3) = 560 triangles
    np.random.default_rng(9).shuffle(edges)

    def last_estimate():
        out = None
        for _, est in _btc(vertex_count=n, samples=3000, window=CountWindow(32),
                           seed=2).run(list(edges)):
            out = est
        return out

    a = last_estimate()
    monkeypatch.setattr(TS, "_PACK_LIMIT", -1)  # the scan form
    b = last_estimate()
    assert 0.5 * 560 < a < 2.0 * 560, a
    assert 0.5 * 560 < b < 2.0 * 560, b


def test_typed_sampler_emissions():
    from gelly_streaming_tpu_torch.utils.types import SampledEdge, TriangleEstimate

    rng = np.random.default_rng(2)
    edges = [(int(a), int(b)) for a, b in zip(rng.integers(0, 30, 400),
                                              rng.integers(0, 30, 400)) if a != b]
    btc = _btc(vertex_count=30, samples=64, window=CountWindow(50), seed=1)
    ests = list(btc.run_estimates(edges))
    assert ests and all(isinstance(e, TriangleEstimate) for e in ests)
    assert all(e.beta >= 0 and e.edge_count > 0 for e in ests)
    assert ests[-1].edge_count == len(edges)
    sampled = btc.sampled_edges()
    assert sampled and all(isinstance(s, SampledEdge) for s in sampled)
    assert len(sampled) <= 64
    assert {v for s in sampled for v in (s.edge.src, s.edge.dst)} <= set(range(30))
