"""The port on the card: both CUDA kernels of ``fused_sage_matmul`` (the
tensor-core "tc" and the CUDA-core "simt") against their plain version,
and the streaming GraphSAGE slice on the card against the same slice on
the CPU.

Every test here is marked ``cuda`` and skips where
``torch.cuda.is_available()`` is false. The file imports only torch, numpy
and the port, so it also runs on a machine without JAX::

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

import gelly_streaming_tpu_torch as gt
from gelly_streaming_tpu_torch.datasets import IdentityDict
from gelly_streaming_tpu_torch.models import (
    StreamingGraphSAGE,
    TableFeatureSource,
    params_from_numpy,
)
from gelly_streaming_tpu_torch.ops import sage_kernels
from gelly_streaming_tpu_torch.ops.sage_kernels import (
    fused_sage_matmul,
    fused_sage_matmul_plain,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", torch.cuda.current_device())


def _operands(seed, v, f, o):
    rng = np.random.default_rng(seed)
    return [
        rng.normal(size=s).astype(np.float32)
        for s in ((v, f), (v, f), (f, o), (f, o), (o,))
    ]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_sage_matmul_kernel_matches_plain_on_card(card, dtype):
    """f32 within 1e-4 of max|ref| (summation order); bf16 within 1e-2
    (one rounding of the output to bf16). Ragged shapes and F = 0."""
    dt = getattr(torch, dtype)
    tol = 1e-4 if dt == torch.float32 else 1e-2
    for shape in [(100, 48, 72), (1, 1, 1), (257, 130, 65), (300, 0, 9)]:
        for activation in ("relu", "none"):
            ops = [torch.from_numpy(a).to(card, dt) for a in _operands(1, *shape)]
            before = sage_kernels.LAUNCHES
            got = fused_sage_matmul(*ops, activation)
            torch.cuda.synchronize()
            assert sage_kernels.LAUNCHES == before + 1
            want = fused_sage_matmul_plain(*ops, activation)
            err = (got.float() - want.float()).abs().max().item()
            assert err <= tol * max(want.float().abs().max().item(), 1.0), shape


def test_streaming_graphsage_on_card_matches_cpu(card):
    """512 vertices, 4 windows of 1024 edges, dims [16, 32, 16] in f32: the
    card's run launches the kernel twice per window and agrees with the
    CPU run (index_add_ sums in another order on the card)."""
    rng = np.random.default_rng(5)
    src = rng.integers(0, 512, 4096).astype(np.int32)
    dst = rng.integers(0, 512, 4096).astype(np.int32)
    table = rng.normal(size=(512, 16)).astype(np.float32)
    params = [
        {
            "w_self": rng.normal(size=(fi, fo)).astype(np.float32) / np.sqrt(fi),
            "w_nbr": rng.normal(size=(fi, fo)).astype(np.float32) / np.sqrt(fi),
            "b": rng.normal(size=(fo,)).astype(np.float32) * 0.1,
        }
        for fi, fo in ((16, 32), (32, 16))
    ]

    def run(device):
        stream = gt.SimpleEdgeStream((src, dst), window=gt.CountWindow(1024),
                                     vertex_dict=IdentityDict(512), device=device)
        sage = StreamingGraphSAGE(params_from_numpy(params, torch.float32, device), 16)
        return [o.cpu().numpy() for o in sage.run(
            stream, TableFeatureSource(table, device=device))]

    want = run("cpu")
    sage_kernels.LAUNCHES = 0
    sage_kernels.LAUNCHES_BY_VARIANT.update(tc=0, simt=0)
    got = run(card)
    assert sage_kernels.LAUNCHES == 2 * 4
    assert sage_kernels.LAUNCHES_BY_VARIANT == {"tc": 0, "simt": 2 * 4}  # f32
    for a, b in zip(want, got):
        np.testing.assert_allclose(b, a, rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("f, o", [(48, 72), (136, 264)])
@pytest.mark.parametrize("v", [1, 100, 257, 65537])
def test_tensor_core_kernel_matches_plain_on_ragged_shapes(card, v, f, o):
    """bf16, F and O multiples of 8 but not of 64, V off the 128-row tile,
    O > 256 (two column tiles): the call takes "tc" and agrees with the
    plain version within 1e-2 of max|ref| (one rounding to bf16)."""
    for activation in ("relu", "none"):
        ops = [torch.from_numpy(a).to(card, torch.bfloat16)
               for a in _operands(2, v, f, o)]
        before = dict(sage_kernels.LAUNCHES_BY_VARIANT)
        got = fused_sage_matmul(*ops, activation)
        torch.cuda.synchronize()
        assert sage_kernels.LAUNCHES_BY_VARIANT["tc"] == before["tc"] + 1
        assert sage_kernels.LAUNCHES_BY_VARIANT["simt"] == before["simt"]
        want = fused_sage_matmul_plain(*ops, activation)
        err = (got.float() - want.float()).abs().max().item()
        assert err <= 1e-2 * max(want.float().abs().max().item(), 1.0)


def test_bf16_slice_launches_only_the_tensor_core_kernel(card):
    """The bf16 slice ([16, 32, 16], 4 windows) launches "tc" twice per
    window and "simt" never, and agrees with the same slice on the CPU
    within 2e-2 of max|ref| (bf16 sums in another order on the card)."""
    rng = np.random.default_rng(6)
    src = rng.integers(0, 512, 4096).astype(np.int32)
    dst = rng.integers(0, 512, 4096).astype(np.int32)
    table = rng.normal(size=(512, 16)).astype(np.float32)
    params = [
        {"w_self": rng.normal(size=(fi, fo)).astype(np.float32) / np.sqrt(fi),
         "w_nbr": rng.normal(size=(fi, fo)).astype(np.float32) / np.sqrt(fi),
         "b": rng.normal(size=(fo,)).astype(np.float32) * 0.1}
        for fi, fo in ((16, 32), (32, 16))
    ]

    def run(device):
        stream = gt.SimpleEdgeStream((src, dst), window=gt.CountWindow(1024),
                                     vertex_dict=IdentityDict(512), device=device)
        sage = StreamingGraphSAGE(params_from_numpy(params, torch.bfloat16, device), 16)
        feats = TableFeatureSource(torch.from_numpy(table).to(torch.bfloat16), device=device)
        return [o.float().cpu().numpy() for o in sage.run(stream, feats)]

    want = run("cpu")
    sage_kernels.LAUNCHES_BY_VARIANT.update(tc=0, simt=0)
    got = run(card)
    assert sage_kernels.LAUNCHES_BY_VARIANT == {"tc": 2 * 4, "simt": 0}
    for a, b in zip(want, got):
        assert np.abs(b - a).max() <= 2e-2 * max(np.abs(a).max(), 1.0)


def test_device_table_loop_makes_no_host_sync(card):
    """The device-table path of ``StreamingGraphSAGE.run`` makes no host
    sync per window: run under ``torch.cuda.set_sync_debug_mode("error")``,
    any synchronizing call raises."""
    rng = np.random.default_rng(9)
    src = rng.integers(0, 1024, 8192).astype(np.int32)
    dst = rng.integers(0, 1024, 8192).astype(np.int32)
    table = TableFeatureSource(rng.normal(size=(1024, 16)).astype(np.float32),
                               device=card)
    params = params_from_numpy(
        [{"w_self": np.full((16, 8), 0.1, np.float32),
          "w_nbr": np.full((16, 8), 0.1, np.float32),
          "b": np.zeros(8, np.float32)}],
        torch.bfloat16, card,
    )

    def stream():
        return gt.SimpleEdgeStream((src, dst), window=gt.CountWindow(2048),
                                   vertex_dict=IdentityDict(1024), device=card)

    list(StreamingGraphSAGE(params, 16).run(stream(), table))  # warm caches
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        outs = list(StreamingGraphSAGE(params, 16).run(stream(), table))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert len(outs) == 4 and bool(torch.isfinite(outs[-1]).all())
