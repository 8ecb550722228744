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
    before_by_variant = dict(sage_kernels.LAUNCHES_BY_VARIANT)
    ops = [torch.from_numpy(a) for a in _operands(9)]
    torch.testing.assert_close(
        fused_sage_matmul(*ops), fused_sage_matmul_plain(*ops)
    )
    assert sage_kernels.LAUNCHES == before
    assert sage_kernels.LAUNCHES_BY_VARIANT == before_by_variant


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


def _variant_operands(case):
    """Operands for the kernel-choice rule; empty tensors, since the rule
    reads only dtypes, shapes and addresses."""
    shapes = {
        "config5_layer1": (65536, 128, 256),
        "config5_layer2": (65536, 256, 128),
        "ragged_v_f_o": (100, 48, 72),
        "float32": (65536, 128, 256),
        "f_not_multiple_of_8": (100, 130, 64),
        "o_not_multiple_of_8": (100, 128, 65),
        "misaligned_view": (100, 48, 72),
    }
    v, f, o = shapes[case]
    dtype = torch.float32 if case == "float32" else torch.bfloat16
    ops = [torch.empty(s, dtype=dtype) for s in ((v, f), (v, f), (f, o), (f, o), (o,))]
    if case == "misaligned_view":
        flat = torch.empty(v * f + 8, dtype=dtype)
        ops[1] = flat[1:1 + v * f].view(v, f)  # 2 bytes past an aligned address
        assert ops[1].is_contiguous() and ops[1].data_ptr() % 16 == 2
    return ops


@pytest.mark.parametrize(
    "case, variant",
    [
        ("config5_layer1", "tc"),
        ("config5_layer2", "tc"),
        ("ragged_v_f_o", "tc"),
        ("float32", "simt"),
        ("f_not_multiple_of_8", "simt"),
        ("o_not_multiple_of_8", "simt"),
        ("misaligned_view", "simt"),
    ],
)
def test_kernel_choice_rule(case, variant):
    """bf16 with F and O multiples of 8 and 16-byte-aligned operands takes
    the tensor-core kernel ("tc"), every other call the CUDA-core kernel
    ("simt"); BASELINE config #5's two layers take "tc"."""
    assert sage_kernels._variant(*_variant_operands(case)) == variant


def test_library_path_changes_when_a_header_changes(monkeypatch, tmp_path):
    """An edited ``csrc/*.cuh`` gives a new library path, so a stale build
    is never loaded; an unrelated file does not."""
    (tmp_path / "k.cu").write_text('#include "ptx.cuh"\n')
    (tmp_path / "ptx.cuh").write_text("// v1\n")
    monkeypatch.setattr(cuda_build, "CSRC_DIR", str(tmp_path))
    first = cuda_build.library_path("k")
    (tmp_path / "notes.txt").write_text("not a header\n")
    assert cuda_build.library_path("k") == first
    (tmp_path / "ptx.cuh").write_text("// v2\n")
    second = cuda_build.library_path("k")
    assert second != first
    (tmp_path / "more.cuh").write_text("// new header\n")
    assert cuda_build.library_path("k") not in (first, second)


# --------------------------------------------------------------------- #
# The shared launch path: ops/cuda_build.launch and csrc/launch.cuh
# --------------------------------------------------------------------- #
class _Launchers:
    """A library's C interface without a card: each call is recorded and
    answers ``code`` (a launcher) or ``value`` (a plan)."""

    def __init__(self, code=0, value=7):
        self.code, self.value = code, value
        self.calls = []

    def some_launch(self, *args):
        self.calls.append(args)
        return self.code

    def some_plan(self, *args):
        self.calls.append(args)
        return self.value

    @staticmethod
    def launch_error_string(code):
        return b"too many blocks in cooperative launch"


@pytest.fixture
def on_card_3(monkeypatch):
    """Card 3 as the operands' card, with a stream of handle 4660 current
    on it; the devices each lookup was asked about are kept."""
    import contextlib

    asked = []

    def stream(device=None):
        asked.append(device)
        return type("Stream", (), {"cuda_stream": 4660})()

    monkeypatch.setattr(cuda_build, "device_index", lambda device: 3)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", stream)
    return asked


def test_launch_passes_tensors_as_pointers_then_the_card_and_its_stream(on_card_3):
    lib = _Launchers()
    a, b = torch.zeros(4), torch.zeros(2, dtype=torch.int32)
    cuda_build.launch(lib, "some_launch", "cuda:3", a, 5, b, 0.5)
    assert lib.calls == [(a.data_ptr(), 5, b.data_ptr(), 0.5, 3, 4660)]
    assert on_card_3 == ["cuda:3"]


def test_launch_raises_on_a_refused_launch_with_its_name_message_and_code(on_card_3):
    lib = _Launchers(code=720)
    with pytest.raises(RuntimeError) as err:
        cuda_build.launch(lib, "some_launch", "cuda:3", torch.zeros(1))
    text = str(err.value)
    assert "some_launch" in text and "too many blocks in cooperative launch" in text
    assert "720" in text and len(lib.calls) == 1


@pytest.mark.parametrize("value", [0, 7, -720])
def test_query_returns_a_plan_and_raises_on_a_negated_error_code(value, on_card_3):
    """A planning call gets its arguments and the card's index, no stream;
    a negative answer is minus an error code, raised with the call's name."""
    lib = _Launchers(value=value)
    if value < 0:
        with pytest.raises(RuntimeError, match=r"some_plan failed: too many .* \(cudaError 720\)"):
            cuda_build.query(lib, "some_plan", "cuda:3", 2, 9)
    else:
        assert cuda_build.query(lib, "some_plan", "cuda:3", 2, 9) == value
    assert lib.calls == [(2, 9, 3)]


CUDA_SOURCES = ("cc_fold", "fused_sage_matmul", "k_reach", "pagerank", "reservoir_scan",
                "sage_aggregate")


def test_every_cuda_source_is_listed():
    import os

    found = sorted(f[:-3] for f in os.listdir(cuda_build.CSRC_DIR) if f.endswith(".cu"))
    assert tuple(found) == CUDA_SOURCES


@pytest.mark.parametrize("name", CUDA_SOURCES)
def test_cuda_source_uses_the_shared_launch_header(name):
    """Each source includes ``launch.cuh`` and keeps no copy of what it
    holds: no ``select_device``, error-string export, occupancy query or
    device switch of its own."""
    import os
    import re

    with open(os.path.join(cuda_build.CSRC_DIR, name + ".cu")) as f:
        src = f.read()
    assert re.search(r'^#include "launch\.cuh"$', src, re.M)
    assert not re.search(r"\bselect_device\s*\([^)]*\)\s*\{", src)
    assert not re.search(r"\w*_error_string\s*\(", src)
    assert not re.search(r"cudaSetDevice|cudaOccupancyMaxActiveBlocksPerMultiprocessor|"
                         r"cudaGetErrorString", src)
