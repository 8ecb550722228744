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

Gradients. When autograd records the call (grad mode on and an operand
that requires a gradient), the wrapper is a ``torch.autograd.Function``:
the forward is the same kernel (or the plain version on the CPU), and the
backward is plain torch matmuls in f32, each gradient cast to its
operand's dtype. The JAX package has no backward kernel either: its
``pallas_call`` has no ``custom_vjp``, and its training differentiates
XLA's products. Without a recorded graph the wrapper keeps no state.
"""

from __future__ import annotations

import ctypes

import torch

from .cuda_build import launch, load_library

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
    accumulation, output [V, O] in the input dtype. Differentiable: see
    :class:`FusedSageMatmul`."""
    tensors = (h, agg, w_self, w_nbr, b)
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return FusedSageMatmul.apply(*tensors, activation)
    return _forward(*tensors, activation)


class FusedSageMatmul(torch.autograd.Function):
    """:func:`fused_sage_matmul` under autograd. The forward launches the
    kernel (the plain version for CPU tensors); the backward, with ``g``
    the output's gradient in f32, zeroed where the relu output is not
    positive (JAX's and torch's relu both have gradient 0 at 0):
    ``dh = g @ w_self.T``, ``dagg = g @ w_nbr.T``, ``dw_self = h.T @ g``,
    ``dw_nbr = agg.T @ g``, ``db = g.sum(0)``, each computed in f32 and
    only for an operand that needs it."""

    @staticmethod
    def forward(ctx, h, agg, w_self, w_nbr, b, activation):
        out = _forward(h, agg, w_self, w_nbr, b, activation)
        ctx.activation = activation
        ctx.save_for_backward(h, agg, w_self, w_nbr, out)
        return out

    @staticmethod
    def backward(ctx, grad_out):
        h, agg, w_self, w_nbr, out = ctx.saved_tensors
        f32 = torch.float32
        g = grad_out.to(f32)
        if ctx.activation == "relu":
            g = g * (out > 0)
        need = ctx.needs_input_grad
        dh = (g @ w_self.to(f32).T).to(h.dtype) if need[0] else None
        dagg = (g @ w_nbr.to(f32).T).to(agg.dtype) if need[1] else None
        dws = (h.to(f32).T @ g).to(w_self.dtype) if need[2] else None
        dwn = (agg.to(f32).T @ g).to(w_nbr.dtype) if need[3] else None
        db = g.sum(0).to(out.dtype) if need[4] else None
        return dh, dagg, dws, dwn, db, None


def _forward(h, agg, w_self, w_nbr, b, activation):
    """The checked forward: the plain version on the CPU, the chosen
    kernel on the card."""
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
    and count it; raises if it is refused. The operands are already
    checked by :func:`fused_sage_matmul`."""
    global LAUNCHES
    V, F = h.shape
    O = w_self.shape[1]
    relu = int(activation == "relu")
    ops = (h, agg, w_self, w_nbr, b, out)
    if variant == "tc":
        launch(_library(), "fused_sage_matmul_tc_launch", out.device, *ops, V, F, O, relu)
    else:
        launch(_library(), "fused_sage_matmul_launch", out.device, *ops, V, F, O,
               _DTYPE_CODES[h.dtype], relu)
    LAUNCHES += 1
    LAUNCHES_BY_VARIANT[variant] += 1


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
        fn.argtypes = [ptr] * 6 + [i32] * 6 + [ptr]
        fn.restype = i32
        tc = lib.fused_sage_matmul_tc_launch
        tc.argtypes = [ptr] * 6 + [i32] * 5 + [ptr]
        tc.restype = i32
    return lib
