"""The GraphSAGE layer's dense half as one kernel on the card.

:func:`fused_sage_matmul` computes ``act(h @ w_self + agg @ w_nbr + b)``
with one f32 accumulator across both contractions, the counterpart of
``gelly_streaming_tpu/ops/pallas_kernels.py:fused_sage_matmul``. On CUDA
tensors it launches the hand-written Hopper kernel in
``csrc/fused_sage_matmul.cu`` (built at first use, see
:mod:`.cuda_build`) and counts the launch in :data:`LAUNCHES`; on CPU
tensors it runs :func:`fused_sage_matmul_plain`, the plain PyTorch
version the tests and ``chip_smoke.py`` hold the kernel against. A CUDA
tensor never reaches the plain version: the kernel launches or the call
raises.
"""

from __future__ import annotations

import ctypes

import torch

from .cuda_build import load_library

#: launches of the CUDA kernel since import (or since a caller reset it)
LAUNCHES = 0

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
    global LAUNCHES
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
    lib = _library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        code = lib.fused_sage_matmul_launch(
            h.data_ptr(), agg.data_ptr(), w_self.data_ptr(),
            w_nbr.data_ptr(), b.data_ptr(), out.data_ptr(),
            V, F, O, _DTYPE_CODES[dtype], int(activation == "relu"), stream,
        )
    if code != 0:
        msg = lib.fused_sage_matmul_error_string(code).decode()
        raise RuntimeError(
            f"fused_sage_matmul launch failed: {msg} (cudaError {code})"
        )
    LAUNCHES += 1
    return out


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
        err = lib.fused_sage_matmul_error_string
        err.argtypes = [i32]
        err.restype = ctypes.c_char_p
    return lib
