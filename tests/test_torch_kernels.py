"""The port's fused_sage_matmul against the JAX package's Pallas kernel.

The same numpy inputs, made from a seed, go through
``gelly_streaming_tpu.ops.pallas_kernels.fused_sage_matmul`` in interpret
mode (as ``test_pagerank_sage.py::test_pallas_fused_sage_matmul_matches_xla``
runs it on the CPU) and through ``gelly_streaming_tpu_torch``'s wrapper on
CPU tensors, which runs the kernel's plain PyTorch version. The CUDA
kernel itself is held against the plain version on the card by
``tests/test_torch_cuda.py`` and by ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gelly_streaming_tpu.ops.pallas_kernels import fused_sage_matmul as jax_fused
from gelly_streaming_tpu_torch.ops import cuda_build, sage_kernels
from gelly_streaming_tpu_torch.ops.sage_kernels import (
    fused_sage_matmul,
    fused_sage_matmul_plain,
)

V, F, O = 100, 48, 72  # deliberately non-tile-aligned, as the JAX test


def _operands(seed, v=V, f=F, o=O):
    rng = np.random.default_rng(seed)
    return (
        rng.normal(size=(v, f)).astype(np.float32),
        rng.normal(size=(v, f)).astype(np.float32),
        rng.normal(size=(f, o)).astype(np.float32),
        rng.normal(size=(f, o)).astype(np.float32),
        rng.normal(size=(o,)).astype(np.float32),
    )


@pytest.mark.parametrize("activation", ["relu", "none"])
def test_fused_sage_matmul_f32_matches_pallas_interpret(activation):
    ops = _operands(7)
    want = jax_fused(
        *(jnp.asarray(a) for a in ops), activation=activation, interpret=True
    )
    got = fused_sage_matmul(*(torch.from_numpy(a) for a in ops), activation)
    assert got.dtype == torch.float32 and got.shape == (V, O)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5
    )


@pytest.mark.parametrize("activation", ["relu", "none"])
def test_fused_sage_matmul_bf16_matches_pallas_interpret(activation):
    """bf16 in, f32 accumulate, bf16 out in both packages. The f32 sums
    are taken in different orders, so a result may round to the other
    neighbouring bf16 value: compared in f32, within one bf16 ulp
    (2**-7 relative)."""
    ops = _operands(11)
    want = jax_fused(
        *(jnp.asarray(a, jnp.bfloat16) for a in ops),
        activation=activation, interpret=True,
    )
    got = fused_sage_matmul(
        *(torch.from_numpy(a).to(torch.bfloat16) for a in ops), activation
    )
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want, np.float32),
        rtol=2.0 ** -7, atol=1e-3,
    )


def test_plain_version_is_the_two_matmul_formula():
    """f32 arithmetic against the float64 formula, at f32 tolerance."""
    ops = [torch.from_numpy(a) for a in _operands(3, 9, 5, 6)]
    h, agg, ws, wn, b = (t.double() for t in ops)
    want = h @ ws + agg @ wn + b
    got = fused_sage_matmul_plain(*ops, activation="none")
    assert got.dtype == torch.float32
    torch.testing.assert_close(got.double(), want, rtol=1e-5, atol=1e-5)
    relu = fused_sage_matmul_plain(*ops, activation="relu")
    torch.testing.assert_close(
        relu.double(), torch.relu(want), rtol=1e-5, atol=1e-5
    )


def _bad_operands(case):
    ops = [torch.from_numpy(a) for a in _operands(5, 8, 4, 6)]
    if case == "mixed_dtype":
        ops[2] = ops[2].to(torch.bfloat16)
    elif case == "float16":
        ops = [t.half() for t in ops]
    elif case == "shape":
        ops[3] = ops[3][:, :5].contiguous()
    elif case == "bias_shape":
        ops[4] = ops[4][:5]
    elif case == "non_contiguous":
        ops[0] = torch.from_numpy(
            np.asfortranarray(ops[0].numpy())
        )
    elif case == "meta_device":
        ops = [t.to("meta") for t in ops]
    return ops


@pytest.mark.parametrize(
    "case",
    ["mixed_dtype", "float16", "shape", "bias_shape", "non_contiguous",
     "meta_device"],
)
def test_fused_sage_matmul_rejects_what_the_kernel_does_not_take(case):
    with pytest.raises(ValueError):
        fused_sage_matmul(*_bad_operands(case))


def test_fused_sage_matmul_rejects_unknown_activation():
    ops = [torch.from_numpy(a) for a in _operands(5, 8, 4, 6)]
    with pytest.raises(ValueError, match="activation"):
        fused_sage_matmul(*ops, activation="tanh")


def test_cpu_tensors_take_the_plain_version_and_never_the_kernel(monkeypatch):
    """On the CPU the wrapper neither builds nor counts the kernel."""

    def no_build(name):
        raise AssertionError("the CUDA kernel was asked for on the CPU")

    monkeypatch.setattr(sage_kernels, "load_library", no_build)
    before = sage_kernels.LAUNCHES
    ops = [torch.from_numpy(a) for a in _operands(9)]
    torch.testing.assert_close(
        fused_sage_matmul(*ops), fused_sage_matmul_plain(*ops)
    )
    assert sage_kernels.LAUNCHES == before


def test_build_without_nvcc_raises(monkeypatch):
    import torch.utils.cpp_extension as cpp_ext

    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setenv("PATH", "")
    monkeypatch.setattr(cpp_ext, "CUDA_HOME", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_build.find_nvcc()


def test_library_path_is_keyed_by_source_and_flags(monkeypatch):
    path = cuda_build.library_path("fused_sage_matmul")
    assert path.startswith(cuda_build.BUILD_DIR)
    assert path.endswith(".so")
    monkeypatch.setattr(
        cuda_build, "NVCC_FLAGS", cuda_build.NVCC_FLAGS + ("-lineinfo",)
    )
    assert cuda_build.library_path("fused_sage_matmul") != path
