"""GCN: the port against the JAX package on the CPU.

The same numpy features, weights and edges, made from a seed, go through
``gelly_streaming_tpu.models.gcn`` and ``gelly_streaming_tpu_torch.models.gcn``
(weights carried over with ``params_from_numpy``). Mirrors
``tests/test_pagerank_sage.py:195-226``
(``test_gcn_layer_matches_dense_reference``: the layer against the dense
``D^-1/2 (A+I) D^-1/2 H W + b`` formula, f32, ``rtol=atol=2e-4``, the
reference's bound, with masked edges; the forward's shape).

bf16 runs compare with ``BF16_TOL`` of the largest reference value: both
packages round the degrees, the messages and the output to bf16, and
their scatters add in orders that may differ, so single elements differ
by a few bf16 ulps (2^-8 relative each).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gelly_streaming_tpu.models import gcn as jgcn
from gelly_streaming_tpu_torch.models import gcn as tgcn
from gelly_streaming_tpu_torch.models import params_from_numpy

RTOL, ATOL = 2e-4, 2e-4  # test_pagerank_sage.py:222
BF16_TOL = 2e-2


def _graph(seed, v, e, f):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, v, e).astype(np.int32)
    dst = rng.integers(0, v, e).astype(np.int32)
    mask = rng.random(e) < 0.8
    mask[0] = False  # at least one masked edge
    h = rng.normal(size=(v, f)).astype(np.float32)
    return h, src, dst, mask


def _params_np(dims, seed):
    rng = np.random.default_rng(seed)
    return [{"w": (rng.normal(size=(fi, fo)) * np.sqrt(2.0 / (fi + fo))).astype(np.float32),
             "b": (rng.normal(size=fo) * 0.1).astype(np.float32)}
            for fi, fo in zip(dims[:-1], dims[1:])]


def _dense(h, src, dst, mask, w, b):
    V = h.shape[0]
    A = np.eye(V, dtype=np.float64)
    for s, d, m in zip(src, dst, mask):
        if m:
            A[s, d] += 1
            A[d, s] += 1
    Dm = np.diag(1.0 / np.sqrt(A.sum(1)))
    return Dm @ A @ Dm @ h.astype(np.float64) @ w + b


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def test_gcn_layer_matches_dense_formula_and_jax():
    h, src, dst, mask = _graph(6, 9, 14, 5)
    pnp = _params_np([5, 4], 0)
    want = _dense(h, src, dst, mask, pnp[0]["w"], pnp[0]["b"])
    tp = params_from_numpy(pnp, torch.float32, device="cpu")
    got = tgcn.gcn_layer(tp[0], *_t(h, src, dst, mask), activation="none")
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    jp = [{k: jnp.asarray(v) for k, v in layer.items()} for layer in pnp]
    ref = jgcn.gcn_layer(jp[0], *_j(h, src, dst, mask), activation=lambda x: x)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)
    relu = tgcn.gcn_layer(tp[0], *_t(h, src, dst, mask))
    np.testing.assert_allclose(relu.numpy(), np.maximum(want, 0), rtol=RTOL, atol=ATOL)


def test_masked_edges_carry_no_message():
    """Masking every edge leaves only the self-loop: out = h W + b."""
    h, src, dst, mask = _graph(3, 7, 10, 4)
    pnp = _params_np([4, 3], 1)
    tp = params_from_numpy(pnp, torch.float32, device="cpu")
    got = tgcn.gcn_layer(tp[0], *_t(h, src, dst, np.zeros_like(mask)), activation="none")
    np.testing.assert_allclose(got.numpy(), h @ pnp[0]["w"] + pnp[0]["b"], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("seed", [1, 2])
def test_gcn_forward_shapes_and_jax_parity(seed):
    h, src, dst, mask = _graph(seed, 32, 100, 8)
    pnp = _params_np([8, 16, 4], seed)
    tp = params_from_numpy(pnp, torch.float32, device="cpu")
    got = tgcn.gcn_forward(tp, *_t(h, src, dst, mask))
    assert got.shape == (32, 4) and got.dtype == torch.float32
    jp = [{k: jnp.asarray(v) for k, v in layer.items()} for layer in pnp]
    want = jgcn.gcn_forward(jp, *_j(h, src, dst, mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    # the last layer is linear: some outputs are negative
    assert (got < 0).any()


def test_gcn_forward_bf16_matches_jax():
    h, src, dst, mask = _graph(4, 64, 256, 16)
    pnp = _params_np([16, 32, 8], 4)
    tp = params_from_numpy(pnp, torch.bfloat16, device="cpu")
    got = tgcn.gcn_forward(tp, torch.from_numpy(h).to(torch.bfloat16), *_t(src, dst, mask))
    assert got.dtype == torch.bfloat16
    jp = [{k: jnp.asarray(v, jnp.bfloat16) for k, v in layer.items()} for layer in pnp]
    want = np.asarray(jgcn.gcn_forward(jp, jnp.asarray(h, jnp.bfloat16), *_j(src, dst, mask)),
                      np.float32)
    err = np.abs(got.float().numpy() - want).max()
    assert err <= BF16_TOL * np.abs(want).max(), err


def test_bf16_degrees_round_as_the_reference_keeps_them():
    """A vertex of degree 300: bf16 holds 301 as 300 (8 bits of mantissa);
    the port keeps the degrees in ``h.dtype`` as the reference does, so
    the layer equals the reference's bit for bit (both scatter-add in
    edge order on the CPU)."""
    n = 300
    src = np.zeros(n, np.int32)
    dst = np.arange(1, n + 1, dtype=np.int32)
    mask = np.ones(n, bool)
    h = np.random.default_rng(5).normal(size=(n + 1, 8)).astype(np.float32)
    pnp = _params_np([8, 8], 5)
    tp = params_from_numpy(pnp, torch.bfloat16, device="cpu")
    got = tgcn.gcn_layer(tp[0], torch.from_numpy(h).to(torch.bfloat16), *_t(src, dst, mask),
                         activation="none")
    jp = [{k: jnp.asarray(v, jnp.bfloat16) for k, v in layer.items()} for layer in pnp]
    want = np.asarray(jgcn.gcn_layer(jp[0], jnp.asarray(h, jnp.bfloat16), *_j(src, dst, mask),
                                     activation=lambda x: x), np.float32)
    assert float(torch.tensor(301.0, dtype=torch.bfloat16)) == 300.0
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_init_gcn_shapes_dtype_and_glorot_scale():
    params = tgcn.init_gcn([64, 128, 8], generator=torch.Generator().manual_seed(3),
                           device="cpu")
    assert [tuple(p["w"].shape) for p in params] == [(64, 128), (128, 8)]
    assert all(p["w"].dtype == p["b"].dtype == torch.bfloat16 for p in params)
    assert not params[0]["b"].any()
    std = params[0]["w"].float().std().item()
    assert abs(std - np.sqrt(2.0 / (64 + 128))) < 0.01
    again = tgcn.init_gcn([64, 128, 8], generator=torch.Generator().manual_seed(3),
                          device="cpu")
    assert torch.equal(params[1]["w"], again[1]["w"])
    # the reference's draws have the same shapes, dtype and scale
    ref = jgcn.init_gcn(jax.random.PRNGKey(3), [64, 128, 8])
    assert [p["w"].shape for p in ref] == [tuple(p["w"].shape) for p in params]


def test_params_from_numpy_carries_gcn_stacks():
    pnp = _params_np([8, 16, 4], 7)
    for dtype in (torch.float32, torch.bfloat16):
        tp = params_from_numpy(pnp, dtype, device="cpu")
        assert [sorted(layer) for layer in tp] == [["b", "w"], ["b", "w"]]
        for a, b in zip(pnp, tp):
            assert b["w"].dtype == b["b"].dtype == dtype
            np.testing.assert_array_equal(
                b["w"].float().numpy(),
                torch.from_numpy(a["w"]).to(dtype).float().numpy())


def test_gcn_layer_rejects_other_activations():
    h, src, dst, mask = _graph(0, 4, 4, 2)
    tp = params_from_numpy(_params_np([2, 2], 0), torch.float32, device="cpu")
    with pytest.raises(ValueError, match="activation"):
        tgcn.gcn_layer(tp[0], *_t(h, src, dst, mask), activation="tanh")


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves")
    from gelly_streaming_tpu_torch.resilience.errors import DeviceUnavailable

    with pytest.raises(DeviceUnavailable):
        tgcn.init_gcn([4, 4], generator=torch.Generator().manual_seed(0))
