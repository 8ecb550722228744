"""PageRank's window fixpoint, as one kernel launch a window on the card.

:func:`fixpoint` runs one window's warm start and power iteration over the
carried edges ``src -> dst``: never-ranked seen vertices enter at ``1/n``,
the ranks renormalize to sum 1, then iterations run until the L1 change is
at most ``tol`` or ``chunk * max_chunks`` of them have run. It is the
counterpart of the warm start and ``fixpoint`` of
``gelly_streaming_tpu/library/pagerank.py:_make_pr_window_body`` (``:146-152``
and ``:89-136``), an XLA step in the JAX package (not a Pallas kernel) that
runs as one device program with a ``lax.while_loop`` for its early exit.

- On CUDA tensors :func:`fixpoint` checks its operands and makes one launch
  of the kernel in ``csrc/pagerank.cu`` (built at first use by
  :mod:`.cuda_build`), counted in :data:`LAUNCHES`: the warm start, the
  out-degrees, a CSR of the edges by target and every iteration run in it,
  on a persistent cooperative grid, and it stops at the converged
  iteration. Each vertex pulls the sum of its in-edges (no float atomic;
  one grid barrier an iteration). Nothing is read back to the host: the
  ranks, the last L1 change and the iteration count come back as device
  tensors. A CUDA call launches the kernel or raises. The CSR's rows are
  filled by integer atomics, so each row's sum runs in an order that
  changes from run to run: under ``torch.use_deterministic_algorithms(True)``
  it raises, as PyTorch's own nondeterministic CUDA operations do (and
  warns under ``warn_only``).
- On CPU tensors it runs :func:`fixpoint_plain`, the torch form: the
  reference's chunks of ``chunk`` iterations with a freeze flag, read on the
  host once a chunk (counted in :data:`HOST_READS`). The tests and
  ``chip_smoke.py`` hold the kernel against it; the mesh path of
  ``library/pagerank.py`` runs it with ``axis_name``, since it needs an
  all-reduce between each iteration's scatter and its teleport terms.

The returned ranks are always a new tensor: the input rank vector is read
and never written (a published one stays as it was).
"""

from __future__ import annotations

import ctypes
import warnings

import torch

from ..parallel import comm
from .cuda_build import launch, load_library

#: launches of the fixpoint kernel since import (or since a caller reset
#: it): one a window on the card
LAUNCHES = 0

#: device -> host reads of the window fixpoints: one a chunk of
#: :func:`fixpoint_plain` (CPU tensors, the mesh path), none on the kernel
#: path; callers zero it
HOST_READS = 0


def fixpoint_plain(src, dst, ranks, n_seen: int, damping: float, tol: float, chunk: int,
                   max_chunks: int, axis_name=None):
    """Plain PyTorch version: the warm start of ``ranks`` over the first
    ``n_seen`` slots, then power iteration over the edges ``src -> dst``
    until the L1 change is at most ``tol``, checked on the host once per
    ``chunk`` iterations, at most ``max_chunks`` chunks. Returns ``(ranks,
    delta, iters)``; iterations after convergence inside a chunk are
    computed and discarded, as in the reference. ``axis_name``: inside
    ``shard_map`` over this rank's edges, the degrees and each iteration's
    partial ranks all-reduce over that axis, and so does the chunk's exit
    flag, so every rank leaves at the same chunk."""
    global HOST_READS
    nv = ranks.shape[0]
    dev = ranks.device
    # warm start: never-ranked active vertices enter at uniform mass, then
    # the seen ranks renormalize to sum 1 (padding slots stay 0: the active
    # mask keeps them out of the teleport and dangling terms)
    active = torch.arange(nv, device=dev) < n_seen
    # a float32 scalar, so every term rounds as the reference's does
    n = torch.full((), float(max(n_seen, 1)), dtype=ranks.dtype, device=dev)
    ranks = torch.where(active & (ranks == 0.0), 1.0 / n, ranks)
    ranks = ranks / torch.clamp(ranks.sum(), min=1e-30)
    src_l = src.long()
    dst_l = dst.long()
    ones = torch.zeros(nv, dtype=ranks.dtype, device=dev)
    ones.index_add_(0, src_l, torch.ones(src.shape[0], dtype=ranks.dtype, device=dev))
    if axis_name is not None:
        ones = comm.all_reduce(ones, axis_name)
    deg_src = torch.clamp(ones, min=1.0)[src_l]
    dangling = active & (ones == 0.0)
    zero = torch.zeros((), dtype=ranks.dtype, device=dev)
    # damping as a float32 scalar, so 1 - d rounds as the reference's
    d = torch.full((), damping, dtype=ranks.dtype, device=dev)
    teleport = (1.0 - d) / n
    r = ranks
    delta = torch.full((), float("inf"), dtype=ranks.dtype, device=dev)
    iters = torch.zeros((), dtype=torch.int32, device=dev)
    done = torch.zeros((), dtype=torch.bool, device=dev)
    for _ in range(max_chunks):
        for _ in range(chunk):
            new = torch.zeros(nv, dtype=ranks.dtype, device=dev)
            new.index_add_(0, dst_l, r[src_l] / deg_src)
            if axis_name is not None:
                new = comm.all_reduce(new, axis_name)
            dangling_mass = torch.where(dangling, r, zero).sum()
            new = teleport + d * (new + dangling_mass / n)
            new = torch.where(active, new, zero)
            dl = (new - r).abs().sum()
            r = torch.where(done, r, new)
            delta = torch.where(done, delta, dl)
            iters = iters + (~done).to(torch.int32)
            done = done | (dl <= tol)
        HOST_READS += 1
        flag = done
        if axis_name is not None:
            # one exit for every rank, whatever each computed
            flag = comm.all_reduce(done.to(torch.int32), axis_name, op="min")
        if bool(flag):
            break
    return r, delta, iters


def fixpoint(src, dst, ranks, n_seen: int, damping: float, tol: float, chunk: int,
             max_chunks: int):
    """One window's warm start and fixpoint: ``src``, ``dst`` int32
    ``[n_edges]`` (ids below ``ranks.shape[0]``), ``ranks`` float32 ``[nv]``
    before the warm start, all contiguous on one device; ``n_seen`` the seen
    vertices, at most ``chunk * max_chunks`` iterations. Returns ``(ranks,
    delta, iters)``: a new float32 ``[nv]`` tensor, the last iteration's L1
    change (float32) and the iterations run (int32), as 0-dim tensors on
    that device. The plain version on the CPU; on the card one launch of
    the kernel and no host read."""
    _check(src, dst, ranks, n_seen, chunk, max_chunks)
    if ranks.device.type == "cpu":
        return fixpoint_plain(src, dst, ranks, n_seen, damping, tol, chunk, max_chunks)
    return _fixpoint_kernel(src, dst, ranks, n_seen, damping, tol, chunk * max_chunks)


def _fixpoint_kernel(src, dst, ranks, n_seen: int, damping: float, tol: float, max_iters: int):
    """The fixpoint on the card, for checked operands: scratch of the
    library's ``pagerank_scratch_bytes`` (the two contribution buffers, the
    degrees, the CSR, the piece list and the blocks' slots), new ``(ranks,
    delta, iters)`` tensors, one launch on the current stream of the
    operands' card, no host read; raises when the launch was refused.
    ``max_iters`` may be 0 (the warm start alone), which :func:`fixpoint`
    never asks for."""
    global LAUNCHES
    _refuse_nondeterministic()
    lib = _library()
    device = ranks.device
    scratch = torch.empty(lib.pagerank_scratch_bytes(src.shape[0], ranks.shape[0]),
                          dtype=torch.uint8, device=device)
    out = torch.empty_like(ranks)
    delta = torch.empty((), dtype=torch.float32, device=device)
    iters = torch.empty((), dtype=torch.int32, device=device)
    launch(lib, "pagerank_fixpoint_launch", device, src, dst, ranks, out, scratch, delta, iters,
           src.shape[0], ranks.shape[0], n_seen, damping, tol, max_iters)
    LAUNCHES += 1
    return out, delta, iters


def _refuse_nondeterministic() -> None:
    """Raise (or warn, under ``warn_only``) when deterministic algorithms
    are on: the kernel sums in an order that varies from run to run."""
    if not torch.are_deterministic_algorithms_enabled():
        return
    msg = ("pagerank_kernels.fixpoint on CUDA tensors does not have a deterministic "
           "implementation (its CSR is filled by atomics), but "
           "torch.use_deterministic_algorithms(True) was set")
    if torch.is_deterministic_algorithms_warn_only_enabled():
        warnings.warn(msg, UserWarning, stacklevel=3)
    else:
        raise RuntimeError(msg)


def _check(src, dst, ranks, n_seen: int, chunk: int, max_chunks: int) -> None:
    """Raise ValueError on operands the fixpoint does not take; nothing is
    launched before this passes."""
    tensors = (src, dst, ranks)
    device = ranks.device
    if any(t.device != device for t in tensors):
        raise ValueError("pagerank fixpoint: all operands must be on one device, got "
                         + ", ".join(str(t.device) for t in tensors))
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"pagerank fixpoint: unsupported device {device}")
    if src.dim() != 1 or dst.shape != src.shape or ranks.dim() != 1:
        raise ValueError(f"pagerank fixpoint: src and dst must be one [n_edges] shape and "
                         f"ranks [nv], got {tuple(src.shape)}, {tuple(dst.shape)}, "
                         f"{tuple(ranks.shape)}")
    if src.shape[0] >= 1 << 31 or ranks.shape[0] >= 1 << 31:
        raise ValueError(f"pagerank fixpoint: needs fewer than 2^31 edges and rank slots, "
                         f"got {src.shape[0]} and {ranks.shape[0]}")
    if src.dtype != torch.int32 or dst.dtype != torch.int32:
        raise ValueError(f"pagerank fixpoint: src and dst must be int32, got {src.dtype}, "
                         f"{dst.dtype}")
    if ranks.dtype != torch.float32:
        raise ValueError(f"pagerank fixpoint: ranks must be float32, got {ranks.dtype}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("pagerank fixpoint: operands must be contiguous")
    if not 0 <= n_seen < 1 << 31:
        raise ValueError(f"pagerank fixpoint: n_seen must lie in [0, 2^31), got {n_seen}")
    if chunk < 1 or max_chunks < 1 or chunk * max_chunks >= 1 << 31:
        raise ValueError(f"pagerank fixpoint: need chunk, max_chunks >= 1 and fewer than "
                         f"2^31 iterations, got {chunk}, {max_chunks}")


def _library() -> ctypes.CDLL:
    """The kernel's library; its C signatures are declared at first use."""
    lib = load_library("pagerank")
    fn = lib.pagerank_fixpoint_launch
    if fn.argtypes is None:
        ptr, i32, i64, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
        fn.argtypes = [ptr] * 7 + [i64, i32, i32, f32, f32, i32, i32, ptr]
        fn.restype = i32
        lib.pagerank_scratch_bytes.argtypes = [i64, i32]
        lib.pagerank_scratch_bytes.restype = i64
    return lib
