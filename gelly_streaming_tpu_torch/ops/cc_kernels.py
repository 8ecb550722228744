"""The dense CC carry's window fold, as one kernel launch a window on the card.

:func:`fold_window` folds one window's edges ``src[e] ~ dst[e]`` (where
``mask[e]``) into the carried label table and its touched flags, and returns
the new table: flat, each label the least compact id of its component in
the union of the carried forest and the window. It is the counterpart of
``label_combine(state, cc_fold(init_labels(V), src, dst, mask))`` of
``gelly_streaming_tpu/summaries/labels.py``, an XLA step in the JAX package
(two ``lax.while_loop`` fixpoints, not a Pallas kernel).

- On CUDA tensors it checks its operands and makes one launch of the kernel
  in ``csrc/cc_fold.cu`` (built at first use by :mod:`.cuda_build`),
  counted in :data:`LAUNCHES`: a copy of the carried table, a lock-free
  union-find over the window's lanes on the copy, and a compress pass, on a
  persistent cooperative grid. Nothing is read back to the host. A CUDA call
  launches the kernel or raises. The result is the same table whatever order
  the kernel's atomics take, so it needs no guard for deterministic
  algorithms.
- On CPU tensors it runs :func:`fold_window_plain`, the torch composition of
  ``summaries/labels.py`` (two fixpoints, one counted host read a turn).

The carried table must be min-rooted (``0 <= labels[v] <= v``); it need not
be flat. The returned tensors are always new: the inputs are read and never
written, so a table that was emitted stays as it was.
"""

from __future__ import annotations

import ctypes

import torch

from ..summaries.labels import cc_fold, init_labels, label_combine
from .cuda_build import launch, load_library

#: launches of the fold kernel since import (or since a caller reset it):
#: one a window on the card
LAUNCHES = 0


def fold_window_plain(labels, touched, src, dst, mask):
    """Plain PyTorch version: the carried table's combine with the window's
    own fold from a fresh table. Returns ``(labels, touched)``, new."""
    part = cc_fold(init_labels(labels.shape[0], labels.device), src, dst, mask)
    out = label_combine({"labels": labels, "touched": touched}, part)
    return out["labels"], out["touched"]


def fold_window(labels, touched, src, dst, mask):
    """One window folded into the carried table: ``labels`` int32 ``[V]``
    (min-rooted), ``touched`` bool ``[V]``, ``src``, ``dst`` int32 and
    ``mask`` bool ``[E]`` (every unmasked id below ``V``), all contiguous on
    one device. Returns new ``(labels, touched)`` tensors. The plain version
    on the CPU; on the card one launch of the kernel and no host read."""
    _check(labels, touched, src, dst, mask)
    if labels.device.type == "cpu":
        return fold_window_plain(labels, touched, src, dst, mask)
    return _fold_kernel(labels, touched, src, dst, mask)


def _fold_kernel(labels, touched, src, dst, mask):
    """The fold on the card, for checked operands: new outputs, one launch
    on the current stream of the operands' card, counted in
    :data:`LAUNCHES`; raises when the launch was refused."""
    global LAUNCHES
    out_labels = torch.empty_like(labels)
    out_touched = torch.empty_like(touched)
    launch(_library(), "cc_fold_launch", labels.device, labels, touched, src, dst, mask,
           out_labels, out_touched, src.shape[0], labels.shape[0])
    LAUNCHES += 1
    return out_labels, out_touched


def _check(labels, touched, src, dst, mask) -> None:
    """Raise ValueError on operands the fold does not take; nothing is
    launched before this passes."""
    tensors = (labels, touched, src, dst, mask)
    device = labels.device
    if any(t.device != device for t in tensors):
        raise ValueError("cc fold: all operands must be on one device, got "
                         + ", ".join(str(t.device) for t in tensors))
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"cc fold: unsupported device {device}")
    if labels.dim() != 1 or touched.shape != labels.shape:
        raise ValueError(f"cc fold: labels and touched must be one [V] shape, got "
                         f"{tuple(labels.shape)}, {tuple(touched.shape)}")
    if src.dim() != 1 or dst.shape != src.shape or mask.shape != src.shape:
        raise ValueError(f"cc fold: src, dst and mask must be one [E] shape, got "
                         f"{tuple(src.shape)}, {tuple(dst.shape)}, {tuple(mask.shape)}")
    if not 1 <= labels.shape[0] < 1 << 31 or src.shape[0] >= 1 << 31:
        raise ValueError(f"cc fold: needs 1 to 2^31 - 1 labels and fewer than 2^31 lanes, "
                         f"got {labels.shape[0]} and {src.shape[0]}")
    if labels.dtype != torch.int32 or src.dtype != torch.int32 or dst.dtype != torch.int32:
        raise ValueError(f"cc fold: labels, src and dst must be int32, got {labels.dtype}, "
                         f"{src.dtype}, {dst.dtype}")
    if touched.dtype != torch.bool or mask.dtype != torch.bool:
        raise ValueError(f"cc fold: touched and mask must be bool, got {touched.dtype}, "
                         f"{mask.dtype}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("cc fold: operands must be contiguous")


def _library() -> ctypes.CDLL:
    """The kernel's library; its C signatures are declared at first use."""
    lib = load_library("cc_fold")
    if lib.cc_fold_launch.argtypes is None:
        ptr = ctypes.c_void_p
        lib.cc_fold_launch.argtypes = [ptr] * 7 + [ctypes.c_longlong, ctypes.c_int,
                                                   ctypes.c_int, ptr]
        lib.cc_fold_launch.restype = ctypes.c_int
    return lib
