"""Streaming GraphSAGE: the port against the JAX package, in f32 on the CPU.

The same numpy features, weights and edges, made from a seed, go through
``gelly_streaming_tpu.models.graphsage`` and through
``gelly_streaming_tpu_torch.models.graphsage`` (weights carried over with
``params_from_numpy``). Mirrors ``test_pagerank_sage.py``:
``test_graphsage_forward_shapes_and_aggregation`` (:76-102),
``test_streaming_graphsage_over_windows`` (:105-124),
``test_sage_layer_pallas_path_matches_default`` (:177) and
``test_streaming_sage_device_feature_source_matches_dict`` (:294-327), and
``__graft_entry__.py``'s SAGE check (rtol 2e-4, atol 2e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gelly_streaming_tpu as gj
import gelly_streaming_tpu_torch as gt
from gelly_streaming_tpu import datasets as jax_datasets
from gelly_streaming_tpu.models import graphsage as jsage
from gelly_streaming_tpu_torch import datasets as torch_datasets
from gelly_streaming_tpu_torch.models import graphsage as tsage
from gelly_streaming_tpu_torch.models import params_from_numpy

RTOL, ATOL = 2e-4, 2e-5  # __graft_entry__.py's SAGE parity bound


def _params_np(dims, seed):
    rng = np.random.default_rng(seed)
    return [
        {
            "w_self": rng.normal(size=(fi, fo)).astype(np.float32) / np.sqrt(fi),
            "w_nbr": rng.normal(size=(fi, fo)).astype(np.float32) / np.sqrt(fi),
            "b": rng.normal(size=(fo,)).astype(np.float32) * 0.1,
        }
        for fi, fo in zip(dims[:-1], dims[1:])
    ]


def _both(params_np):
    jp = [{k: jnp.asarray(v) for k, v in p.items()} for p in params_np]
    return jp, params_from_numpy(params_np, torch.float32, device="cpu")


def _graph(seed, v, e, f, p_mask=0.8):
    rng = np.random.default_rng(seed)
    return (
        rng.normal(size=(v, f)).astype(np.float32),
        rng.integers(0, v, e).astype(np.int32),
        rng.integers(0, v, e).astype(np.int32),
        rng.random(e) < p_mask,
    )


def test_mean_aggregate_matches_jax_and_masks_edges():
    h, _, _, _ = _graph(0, 6, 0, 4)
    src = np.array([0, 1, 2, 3, 4, 5, 0, 1, 2, 0], np.int32)
    dst = np.array([1, 2, 3, 4, 5, 0, 2, 3, 4, 5], np.int32)
    mask = np.ones(10, bool)
    th = torch.from_numpy(h)
    for m in (mask, np.where(np.arange(10) == 0, False, mask)):
        want = jsage.mean_aggregate(jnp.asarray(h), jnp.asarray(src),
                                    jnp.asarray(dst), jnp.asarray(m), 6)
        got = tsage.mean_aggregate(th, torch.from_numpy(src),
                                   torch.from_numpy(dst), torch.from_numpy(m), 6)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)
    # vertex 1's only in-neighbor is 0; masking that edge removes its message
    full = tsage.mean_aggregate(th, torch.from_numpy(src), torch.from_numpy(dst),
                                torch.ones(10, dtype=torch.bool), 6)
    np.testing.assert_allclose(full[1].numpy(), h[0], rtol=1e-6)
    np.testing.assert_allclose(got[1].numpy(), 0.0, atol=1e-6)


@pytest.mark.parametrize("seed", [1, 2])
def test_sage_forward_matches_jax(seed):
    h, src, dst, mask = _graph(seed, 40, 120, 8)
    jp, tp = _both(_params_np([8, 16, 4], seed))
    want = jsage.sage_forward(jp, jnp.asarray(h), jnp.asarray(src),
                              jnp.asarray(dst), jnp.asarray(mask))
    got = tsage.sage_forward(tp, torch.from_numpy(h), torch.from_numpy(src),
                             torch.from_numpy(dst), torch.from_numpy(mask))
    assert got.shape == (40, 4) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("activation", ["relu", "none"])
def test_sage_layer_matches_jax_pallas_and_default_paths(activation):
    h, src, dst, mask = _graph(8, 40, 90, 16, p_mask=1.0)
    jp, tp = _both(_params_np([16, 32], 8))
    args = [jnp.asarray(a) for a in (h, src, dst, mask)]
    jact = jax.nn.relu if activation == "relu" else (lambda x: x)
    want = jsage.sage_layer(jp[0], *args, activation=jact)
    if activation == "relu":  # the JAX Pallas path takes relu only
        pallas = jsage.sage_layer(jp[0], *args, use_pallas=True)
        np.testing.assert_allclose(np.asarray(pallas), np.asarray(want),
                                   rtol=2e-5, atol=2e-5)
    got = tsage.sage_layer(tp[0], *(torch.from_numpy(a) for a in (h, src, dst, mask)),
                           activation=activation)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_init_graphsage_shapes_dtype_and_scale():
    params = tsage.init_graphsage(
        [64, 128, 8], generator=torch.Generator().manual_seed(3), device="cpu"
    )
    assert [tuple(p["w_self"].shape) for p in params] == [(64, 128), (128, 8)]
    assert all(p["b"].dtype == torch.bfloat16 for p in params)
    assert not params[0]["b"].any()
    std = params[0]["w_nbr"].float().std().item()
    assert abs(std - np.sqrt(2.0 / 64)) < 0.02
    again = tsage.init_graphsage(
        [64, 128, 8], generator=torch.Generator().manual_seed(3), device="cpu"
    )
    assert torch.equal(params[1]["w_self"], again[1]["w_self"])


def test_params_from_numpy_rejects_bf16_arrays():
    bf16 = np.asarray(jnp.zeros(3, jnp.bfloat16))
    with pytest.raises(TypeError, match="float32"):
        params_from_numpy([{"b": bf16}], device="cpu")
    out = params_from_numpy([{"b": np.asarray(bf16, np.float32)}], device="cpu")
    assert out[0]["b"].dtype == torch.bfloat16


def test_streaming_golden_shapes_three_then_six():
    """Mirror of ``test_streaming_graphsage_over_windows``: vertices 1,2,3
    seen after window 1, six after window 2; every window against JAX."""
    pnp = _params_np([2, 4], 1)
    jp, tp = _both(pnp)
    feats = {v: np.full(2, float(v), np.float32) for v in range(1, 8)}
    edges = [(1, 2, 0.0), (2, 3, 0.0), (4, 5, 0.0), (5, 6, 0.0)]
    want = list(jsage.StreamingGraphSAGE(jp, 2).run(
        gj.SimpleEdgeStream(edges, window=gj.CountWindow(2)), feats))
    got = list(tsage.StreamingGraphSAGE(tp, 2).run(
        gt.SimpleEdgeStream(edges, window=gt.CountWindow(2), device="cpu"), feats))
    assert [o.shape[0] for o in got] == [3, 6]
    for a, b in zip(want, got):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=RTOL, atol=ATOL)


N_V, WIN, N_WIN, DIMS = 512, 1024, 4, [16, 32, 16]


def _slice_inputs():
    rng = np.random.default_rng(5)
    src = rng.integers(0, N_V, WIN * N_WIN).astype(np.int32)
    dst = rng.integers(0, N_V, WIN * N_WIN).astype(np.int32)
    table = rng.normal(size=(N_V, DIMS[0])).astype(np.float32)
    return (src, dst), table, _params_np(DIMS, 5)


def _run_jax(cols, feats, params_np, vdict=None):
    jp, _ = _both(params_np)
    stream = gj.SimpleEdgeStream(cols, window=gj.CountWindow(WIN), vertex_dict=vdict)
    sage = jsage.StreamingGraphSAGE(jp, DIMS[0])
    return [np.asarray(o) for o in sage.run(stream, feats)], sage, stream


def _run_torch(cols, feats, params_np, vdict=None):
    _, tp = _both(params_np)
    stream = gt.SimpleEdgeStream(cols, window=gt.CountWindow(WIN), vertex_dict=vdict,
                                 device="cpu")
    sage = tsage.StreamingGraphSAGE(tp, DIMS[0])
    return [o.numpy() for o in sage.run(stream, feats)], sage, stream


@pytest.mark.parametrize("features", ["table", "dict"])
def test_streaming_graphsage_slice_matches_jax_every_window(features):
    """The slice as a whole: 512 vertices, 4 windows of 1024 edges, dims
    [16, 32, 16] in f32, both feature paths, every window."""
    cols, table, pnp = _slice_inputs()
    if features == "table":
        want, _, _ = _run_jax(cols, jsage.TableFeatureSource(table), pnp,
                              jax_datasets.IdentityDict(N_V))
        got, _, _ = _run_torch(cols, tsage.TableFeatureSource(table, device="cpu"),
                               pnp, torch_datasets.IdentityDict(N_V))
    else:
        feats = {v: table[v] for v in range(0, N_V, 2)}  # odd ids: zeros
        want, _, _ = _run_jax(cols, feats, pnp)
        got, _, _ = _run_torch(cols, feats, pnp)
    assert len(got) == len(want) == N_WIN
    for a, b in zip(want, got):
        assert b.shape == a.shape
        np.testing.assert_allclose(b, a, rtol=RTOL, atol=ATOL)


def test_streaming_sage_device_feature_source_matches_dict():
    pnp = _params_np([2, 4], 1)
    _, tp = _both(pnp)
    n_ids = 8
    table = np.stack([np.full(2, float(v), np.float32) for v in range(n_ids)])
    feats = {v: table[v] for v in range(n_ids)}
    edges = np.array([1, 2, 4, 5]), np.array([2, 3, 5, 6])

    def stream():
        return gt.SimpleEdgeStream(edges, window=gt.CountWindow(2),
                                   vertex_dict=torch_datasets.IdentityDict(n_ids),
                                   device="cpu")

    outs_dict = list(tsage.StreamingGraphSAGE(tp, 2).run(stream(), feats))
    outs_dev = list(tsage.StreamingGraphSAGE(tp, 2).run(
        stream(), tsage.TableFeatureSource(table, device="cpu")))
    n = outs_dict[-1].shape[0]
    np.testing.assert_allclose(outs_dict[-1].numpy(), outs_dev[-1][:n].numpy(),
                               rtol=1e-5)


@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_state_dict_continues_the_stream_across_packages(direction):
    """A state taken after window 2 by one package, loaded by the other,
    continues windows 3 and 4 to the uninterrupted JAX outputs."""
    (src, dst), table, pnp = _slice_inputs()
    feats = {v: table[v] for v in range(N_V)}
    want, _, _ = _run_jax((src, dst), feats, pnp)
    head = (src[: 2 * WIN], dst[: 2 * WIN])
    tail = (src[2 * WIN:], dst[2 * WIN:])
    run_head, run_tail = (
        (_run_jax, _run_torch) if direction == "jax_to_torch" else (_run_torch, _run_jax)
    )
    _, sage, stream = run_head(head, feats, pnp)
    state = sage.state_dict()
    raw_ids = stream.vertex_dict.raw_ids()

    vdict = gt.VertexDict() if direction == "jax_to_torch" else gj.VertexDict()
    vdict.encode(raw_ids)  # restore the compact mapping first-seen-first
    _, tp = _both(pnp)
    jp, _ = _both(pnp)
    if direction == "jax_to_torch":
        resumed = tsage.StreamingGraphSAGE(tp, DIMS[0])
        resumed.load_state_dict(state)
        s = gt.SimpleEdgeStream(tail, window=gt.CountWindow(WIN), vertex_dict=vdict,
                                device="cpu")
        got = [o.numpy() for o in resumed.run(s, feats)]
    else:
        resumed = jsage.StreamingGraphSAGE(jp, DIMS[0])
        resumed.load_state_dict(state)
        s = gj.SimpleEdgeStream(tail, window=gj.CountWindow(WIN), vertex_dict=vdict)
        got = [np.asarray(o) for o in resumed.run(s, feats)]
    assert len(got) == 2
    for a, b in zip(want[2:], got):
        np.testing.assert_allclose(b, a, rtol=RTOL, atol=ATOL)


def test_bf16_state_dict_from_jax_loads_into_the_port():
    """A bf16 JAX state holds an ml_dtypes bfloat16 ``h``; the port loads
    it through float32, exactly."""
    (src, dst), table, pnp = _slice_inputs()
    jp = [{k: jnp.asarray(v, jnp.bfloat16) for k, v in p.items()} for p in pnp]
    sage = jsage.StreamingGraphSAGE(jp, DIMS[0])
    stream = gj.SimpleEdgeStream((src[:WIN], dst[:WIN]), window=gj.CountWindow(WIN))
    list(sage.run(stream, {v: table[v] for v in range(N_V)}))
    state = sage.state_dict()
    tp = params_from_numpy(pnp, torch.bfloat16, device="cpu")
    port = tsage.StreamingGraphSAGE(tp, DIMS[0])
    port.load_state_dict(state)
    assert port._h.dtype == torch.bfloat16
    np.testing.assert_array_equal(port.state_dict()["h"],
                                  np.asarray(state["h"], np.float32))
    assert port.state_dict()["n_seen"] == state["n_seen"]


def test_example_cli_embeds_the_same_vertices_as_jax(tmp_path):
    """The port's CLI (asked for the CPU) against the JAX one on the
    built-in data: the same vertices in the same order, finite norms.
    The weights differ (torch.Generator and jax.random draw differently)."""
    from gelly_streaming_tpu.example import streaming_graphsage as jax_example
    from gelly_streaming_tpu_torch.example import streaming_graphsage as example

    jax_out, torch_out = tmp_path / "jax.txt", tmp_path / "torch.txt"
    edges = tmp_path / "edges.txt"
    edges.write_text("".join(f"{k} {k + 2}\n" for k in range(1, 101)))
    jax_example.main([str(edges), "25", str(jax_out)])
    example.main(["--cpu", str(edges), "25", str(torch_out)])

    def parse(p):
        rows = [line.strip("()\n").split(",") for line in p.read_text().splitlines()]
        return [int(v) for v, _ in rows], np.array([float(n) for _, n in rows])

    jv, _ = parse(jax_out)
    tv, norms = parse(torch_out)
    assert tv == jv and len(tv) == 102
    assert np.isfinite(norms).all() and (norms > 0).any()
