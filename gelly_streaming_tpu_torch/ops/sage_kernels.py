"""The GraphSAGE layer's dense half as one kernel on the card.

:func:`fused_sage_matmul` computes ``act(h @ w_self + agg @ w_nbr + b)``
with one f32 accumulator across both contractions, the counterpart of
``gelly_streaming_tpu/ops/pallas_kernels.py:fused_sage_matmul``. On CUDA
tensors it launches one of two hand-written Hopper kernels in
``csrc/fused_sage_matmul.cu`` (built at first use, see
:mod:`.cuda_build`), chosen before the launch by :func:`_variant`, a rule
on the operands alone:

- ``"tc"``: the tensor-core kernel (TMA loads, ``wgmma``), for bfloat16
  with F and O positive multiples of 8 and every operand 16-byte aligned,
  which are TMA's rules for strides and addresses;
- ``"simt"``: the CUDA-core kernel, for every other call, float32 among
  them (the tensor cores' f32 input path, TF32, keeps fewer bits than the
  f32 contract).

Each launch counts in :data:`LAUNCHES` and in :data:`LAUNCHES_BY_VARIANT`.
On CPU tensors the wrapper runs :func:`fused_sage_matmul_plain`, the
plain PyTorch version the tests and ``chip_smoke.py`` hold both kernels
against. A CUDA tensor never reaches the plain version, and the choice of
kernel never depends on a build or a launch: the chosen kernel launches
or the call raises.
"""

from __future__ import annotations

import ctypes

import torch

from .cuda_build import load_library

#: launches of either CUDA kernel since import (or since a caller reset it)
LAUNCHES = 0
#: the same launches by kernel: "tc" (tensor cores) and "simt" (CUDA cores)
LAUNCHES_BY_VARIANT = {"tc": 0, "simt": 0}

ACTIVATIONS = ("relu", "none")
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def fused_sage_matmul_plain(h, agg, w_self, w_nbr, b, activation="relu"):
    """Plain PyTorch version: upcast to f32, two matmuls, bias, activation,
    cast back to ``h.dtype``."""
    _check_activation(activation)
    f32 = torch.float32
    out = h.to(f32) @ w_self.to(f32) + agg.to(f32) @ w_nbr.to(f32) + b.to(f32)
    if activation == "relu":
        out = torch.relu(out)
    return out.to(h.dtype)


def fused_sage_matmul(h, agg, w_self, w_nbr, b, activation="relu"):
    """``act(h @ w_self + agg @ w_nbr + b)``: ``h``/``agg`` [V, F], weights
    [F, O], bias [O]; float32 or bfloat16, one dtype for all five, f32
    accumulation, output [V, O] in the input dtype."""
    _check_activation(activation)
    tensors = (h, agg, w_self, w_nbr, b)
    device = h.device
    if any(t.device != device for t in tensors):
        raise ValueError(
            "fused_sage_matmul: all operands must be on one device, got "
            + ", ".join(str(t.device) for t in tensors)
        )
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_sage_matmul: unsupported device {device}")
    dtype = h.dtype
    if dtype not in _DTYPE_CODES or any(t.dtype != dtype for t in tensors):
        raise ValueError(
            "fused_sage_matmul: operands must all be float32 or all "
            "bfloat16, got " + ", ".join(str(t.dtype) for t in tensors)
        )
    if h.dim() != 2 or w_self.dim() != 2:
        raise ValueError("fused_sage_matmul: h and the weights must be 2-D")
    V, F = h.shape
    O = w_self.shape[1]
    want = ((V, F), (V, F), (F, O), (F, O), (O,))
    got = tuple(tuple(t.shape) for t in tensors)
    if got != want:
        raise ValueError(
            f"fused_sage_matmul: shapes {got} do not match h [V, F], agg "
            f"[V, F], w_self [F, O], w_nbr [F, O], b [O] = {want}"
        )
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("fused_sage_matmul: operands must be contiguous")
    if device.type == "cpu":
        return fused_sage_matmul_plain(h, agg, w_self, w_nbr, b, activation)
    out = torch.empty((V, O), dtype=dtype, device=device)
    if V == 0 or O == 0:
        return out
    _launch(_variant(*tensors), *tensors, out, activation)
    return out


def _variant(h, agg, w_self, w_nbr, b) -> str:
    """Which kernel takes these operands: ``"tc"`` for bfloat16 with F and
    O positive multiples of 8 and every operand's address a multiple of 16
    bytes (the output is allocated aligned), else ``"simt"``. A rule on
    dtypes, shapes and addresses only, decided before any launch."""
    F, O = w_self.shape
    tensors = (h, agg, w_self, w_nbr, b)
    if (
        h.dtype == torch.bfloat16
        and F > 0 and F % 8 == 0
        and O > 0 and O % 8 == 0
        and all(t.data_ptr() % 16 == 0 for t in tensors)
    ):
        return "tc"
    return "simt"


def _launch(variant, h, agg, w_self, w_nbr, b, out, activation) -> None:
    """Launch kernel ``variant`` on the current stream of ``out``'s device
    and count it; raises with ``cudaGetErrorString`` if it is refused.
    The operands are already checked by :func:`fused_sage_matmul`."""
    global LAUNCHES
    V, F = h.shape
    O = w_self.shape[1]
    relu = int(activation == "relu")
    ptrs = (h.data_ptr(), agg.data_ptr(), w_self.data_ptr(),
            w_nbr.data_ptr(), b.data_ptr(), out.data_ptr())
    lib = _library()
    device = out.device
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        if variant == "tc":
            code = lib.fused_sage_matmul_tc_launch(
                *ptrs, V, F, O, relu, _num_sms(device), stream
            )
        elif variant == "simt":
            code = lib.fused_sage_matmul_launch(
                *ptrs, V, F, O, _DTYPE_CODES[h.dtype], relu, stream
            )
        else:
            raise ValueError(f"fused_sage_matmul: unknown kernel {variant!r}")
    if code != 0:
        msg = lib.fused_sage_matmul_error_string(code).decode()
        raise RuntimeError(
            f"fused_sage_matmul ({variant}) launch failed: {msg} "
            f"(cudaError {code})"
        )
    LAUNCHES += 1
    LAUNCHES_BY_VARIANT[variant] += 1


_SMS: dict = {}


def _num_sms(device) -> int:
    """Streaming multiprocessors of ``device``: the persistent tensor-core
    kernel runs at most one block on each."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _SMS:
        _SMS[index] = torch.cuda.get_device_properties(index).multi_processor_count
    return _SMS[index]


def _check_activation(activation: str) -> None:
    if activation not in ACTIVATIONS:
        raise ValueError(
            f"fused_sage_matmul supports activation 'relu' or 'none', "
            f"got {activation!r}"
        )


def _library() -> ctypes.CDLL:
    lib = load_library("fused_sage_matmul")
    fn = lib.fused_sage_matmul_launch
    if fn.argtypes is None:  # first use: declare the C signatures
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [ptr] * 6 + [i32] * 5 + [ptr]
        fn.restype = i32
        tc = lib.fused_sage_matmul_tc_launch
        tc.argtypes = [ptr] * 6 + [i32] * 5 + [ptr]
        tc.restype = i32
        err = lib.fused_sage_matmul_error_string
        err.argtypes = [i32]
        err.restype = ctypes.c_char_p
    return lib
