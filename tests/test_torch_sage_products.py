"""Streaming GraphSAGE at ogbn-products' published widths ([100, 256, 256,
47], OGB's GraphSAGE baseline) on the port, on the CPU.

- The port's normal path (``datasets.stream_file`` over a ``.gbin`` ->
  ``StreamingGraphSAGE.run`` with a ``TableFeatureSource``) against the
  benchmark's plain float32 reference (``graphbench/reference/sage.py``)
  every window, on a stream with one hub of in-degree 2,500: in float32
  within float32 rounding, in bfloat16 within the ``sage_products_w8m``
  cell's limits. A mean that sums and counts in bfloat16 stops the hub's
  count at 256 and fails the second.
- The aggregation of the accumulator's filled prefix, taken in edge
  slices, equals one float32 aggregation of the prefix at once, for slice
  sizes that split the prefix unevenly.
- The parameters padded to widths that are multiples of 8 give the
  unpadded product exactly, and take the tensor-core kernel's rule in
  every layer where the unpadded ones do not.
- The spans ``sage.window``, ``sage.aggregate``, ``sage.matmul`` and the
  message counter are emitted once a window, a layer, a launch.
"""

import json
import os

import numpy as np
import pytest
import torch

import gelly_streaming_tpu_torch as gt
from gelly_streaming_tpu_torch import datasets
from gelly_streaming_tpu_torch.models import graphsage as tsage
from gelly_streaming_tpu_torch.obs import trace
from gelly_streaming_tpu_torch.ops import sage_kernels
from graphbench.reference import sage as ref

DIMS = [100, 256, 256, 47]
V, WINDOW, N_WINDOWS, HUB, HUB_DEGREE = 1 << 10, 1 << 11, 3, 5, 2500
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _limits():
    with open(os.path.join(ROOT, "graphbench", "workloads", "sage_products_w8m.json")) as f:
        return json.load(f)["limits"]


def _columns(seed=0):
    rng = np.random.default_rng(seed)
    e = WINDOW * N_WINDOWS
    src = rng.integers(0, V, e).astype(np.int32)
    dst = rng.integers(0, V, e).astype(np.int32)
    dst[rng.choice(e, HUB_DEGREE, replace=False)] = HUB
    return src, dst


def _params(dtype, seed=3):
    g = torch.Generator().manual_seed(seed)
    params = tsage.init_graphsage(DIMS, dtype, generator=g, device="cpu")
    for p in params:  # biases that are not zero, so their padding shows
        p["b"] = (0.1 * torch.randn(p["b"].shape, generator=g)).to(dtype)
    table = torch.randn((V, DIMS[0]), generator=g).to(dtype)
    return params, table


def _run(tmp_path, params, table, cols):
    path = str(tmp_path / "stream.gbin")
    datasets.write_binary(path, *cols)
    stream = datasets.stream_file(path, window=gt.CountWindow(WINDOW),
                                  vertex_dict=datasets.IdentityDict(V), device="cpu")
    sage = tsage.StreamingGraphSAGE(params, DIMS[0])
    return [out.clone() for out in sage.run(stream, tsage.TableFeatureSource(table, device="cpu"))]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_port_matches_the_plain_reference_every_window(dtype, tmp_path):
    """Float32: within 1e-5 (the same sums; the padded products add zeros
    in another blocking). Bfloat16: within the benchmark cell's limits,
    which one rounding of each layer's output to bfloat16 keeps to."""
    params, table = _params(dtype)
    src, dst = _columns()
    outs = _run(tmp_path, params, table, (src, dst))
    assert len(outs) == N_WINDOWS
    assert np.count_nonzero(dst == HUB) >= 2000
    limits = _limits()
    for w, got in enumerate(outs):
        end = (w + 1) * WINDOW
        s, d = torch.from_numpy(src[:end]), torch.from_numpy(dst[:end])
        assert tuple(got.shape) == (V, DIMS[-1]) and got.dtype == dtype
        want = ref.forward(table, params, s, d)
        rel, hub = ref.gaps(got, want, ref.hubs(d, V, 64))
        if dtype == torch.float32:
            assert rel <= 1e-5 and hub <= 1e-5, (w, rel, hub)
        else:
            assert rel <= limits["emb_rel_l2"] and hub <= limits["hub_rel_gap"], (w, rel, hub)


def _one_shot(h, src, dst, n, mask=None):
    """The mean of the first ``n`` lanes in one float32 aggregation."""
    s, d = src[:n].long(), dst[:n].long()
    msgs = h[s].float()
    ones = torch.ones(n)
    if mask is not None:
        msgs = msgs * mask[:n, None].float()
        ones = mask[:n].float()
    agg = torch.zeros((V, h.shape[1])).index_add_(0, d, msgs)
    cnt = torch.zeros(V, dtype=torch.int64).index_add_(0, d, ones.long())
    return (agg / torch.clamp_min(cnt, 1).float()[:, None]).to(h.dtype)


@pytest.mark.parametrize("masked", [False, True], ids=["prefix", "masked"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("slice_edges", [1, 7, 1000, 3000, 4096])
def test_sliced_prefix_aggregation_equals_one_shot(slice_edges, dtype, masked, monkeypatch):
    """A 4096-lane capacity of which the first 3001 hold messages (the
    rest the accumulator's zero padding), cut at the prefix as
    ``StreamingGraphSAGE`` cuts it: any slice size gives the one-shot
    float32 mean of the prefix bit for bit (both sum each vertex's
    messages in stream order on the CPU), with exact int64 counts."""
    rng = np.random.default_rng(11)
    cap, n = 4096, 3001
    src = torch.from_numpy(rng.integers(0, V, cap).astype(np.int32))
    dst = torch.from_numpy(rng.integers(0, V, cap).astype(np.int32))
    dst[:n][torch.from_numpy(rng.random(n) < 0.3)] = HUB
    src[n:] = 0
    dst[n:] = 0
    h = torch.from_numpy(rng.normal(size=(V, 16)).astype(np.float32)).to(dtype)
    mask = torch.from_numpy(rng.random(cap) < 0.8) if masked else None
    monkeypatch.setattr(tsage, "AGG_SLICE_EDGES", slice_edges)
    lanes = None if mask is None else mask[:n]
    got = tsage.mean_aggregate(h, src[:n], dst[:n], lanes, V)
    assert torch.equal(got, _one_shot(h, src, dst, n, mask))
    counts = tsage.in_degrees(dst[:n], lanes, V)
    want = torch.bincount(dst[:n][mask[:n]].long() if masked else dst[:n].long(), minlength=V)
    assert counts.dtype == torch.int64 and torch.equal(counts, want)


@pytest.mark.parametrize("dims", [DIMS, [3, 5, 2], [16, 32, 16]], ids=str)
def test_padded_parameters_give_the_unpadded_product_exactly(dims):
    """Integer-valued weights, biases, features and means (every sum exact
    in float32 whatever its order): each padded layer's product over the
    user's columns equals the unpadded one bit for bit, and its padded
    columns are exactly 0. A layer already on the rule keeps the user's
    tensors."""
    rng = np.random.default_rng(4)

    def ints(*shape):
        return torch.from_numpy(rng.integers(-3, 4, shape).astype(np.float32))

    params = [{"w_self": ints(fi, fo), "w_nbr": ints(fi, fo), "b": ints(fo)}
              for fi, fo in zip(dims[:-1], dims[1:])]
    padded = tsage.pad_params(params)
    for i, (p, q) in enumerate(zip(params, padded)):
        fi, fo = p["w_self"].shape
        pi, po = q["w_self"].shape
        assert pi % 8 == 0 and po % 8 == 0 and 0 <= pi - fi < 8 and 0 <= po - fo < 8
        if (pi, po) == (fi, fo):
            assert all(q[k] is p[k] for k in p)
        h, agg = ints(64, fi), ints(64, fi)
        act = "relu" if i < len(dims) - 2 else "none"
        want = sage_kernels.fused_sage_matmul(h, agg, p["w_self"], p["w_nbr"], p["b"], act)
        pad = torch.nn.functional.pad
        got = sage_kernels.fused_sage_matmul(pad(h, (0, pi - fi)), pad(agg, (0, pi - fi)),
                                             q["w_self"], q["w_nbr"], q["b"], act)
        assert torch.equal(got[:, :fo], want)
        assert not got[:, fo:].any()


@pytest.mark.parametrize("layer", range(len(DIMS) - 1))
def test_padded_published_widths_take_the_tensor_core_rule(layer):
    """In bfloat16, widths 100 -> 104 and 47 -> 48 put every layer on the
    tensor-core kernel's rule (``_variant``), where the unpadded first and
    last layers fall to the CUDA-core kernel."""
    params, _ = _params(torch.bfloat16)
    padded = tsage.pad_params(params)

    def variant(p):
        f = p["w_self"].shape[0]
        h = torch.zeros((32, f), dtype=torch.bfloat16)
        return sage_kernels._variant(h, h.clone(), p["w_self"], p["w_nbr"], p["b"])

    assert variant(padded[layer]) == "tc"
    assert variant(params[layer]) == ("tc" if layer == 1 else "simt")


class _Sink:
    def __init__(self):
        self.names = []

    def emit(self, event):
        self.names.append(event["name"])


@pytest.mark.parametrize("name, per_window", [
    ("sage.window", 1), ("sage.aggregate", 3), ("sage.matmul", 3), ("window.latency", 1),
])
def test_spans_and_message_counter_are_emitted(name, per_window, tmp_path):
    """Tracing on, three windows: each span once a window, a layer or a
    launch; the counter grows by the messages held, once a layer."""
    params, table = _params(torch.bfloat16)
    sink = _Sink()
    before = tsage.MESSAGES_AGGREGATED
    trace.add_sink(sink)
    trace.enable()
    try:
        outs = _run(tmp_path, params, table, _columns())
    finally:
        trace.disable()
        trace.remove_sink(sink)
    assert len(outs) == N_WINDOWS
    assert sink.names.count(name) == per_window * N_WINDOWS
    held = sum((w + 1) * WINDOW for w in range(N_WINDOWS))
    assert tsage.MESSAGES_AGGREGATED - before == 3 * held
