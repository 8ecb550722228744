"""The k >= 3 spanner's k-hop search, with its hop as a kernel on the card.

:func:`k_reach` answers, for a batch of B query edges ``(u, v)`` (B a
positive multiple of 32), whether ``v`` lies within k hops of ``u`` over
the spanner's edges, held as a CSR by target (:func:`target_csr`). It is
the counterpart of ``gelly_streaming_tpu/library/spanner.py:_k_reach_cnt``,
an XLA step in the JAX package (not a Pallas kernel). As there, 32 queries
share each 32-bit word of the frontier: query i owns bit ``i % 32`` of word
``i // 32``, so the frontier is ``W = B / 32`` words a vertex. The words are
int32 (PyTorch has no uint32 bitwise operations on CUDA): bit 31 is the sign
bit, so a bit is read as ``(x >> s) & 1``.

One hop is synchronous: every vertex's new word is its old word ORed with
the old words of its in-neighbours, all read from the hop's starting
frontier. After k hops the frontier of query i holds exactly the vertices
within k hops of ``u[i]``.

- On CUDA tensors the seeding and the read-out are torch operations and
  each hop is one launch of the hand-written kernel in ``csrc/k_reach.cu``
  (built at first use by :mod:`.cuda_build`), counted in
  :data:`LAUNCHES`. The kernel's frontier is vertex-major, ``[V, W]``, so
  one vertex's words are one contiguous row. A CUDA call launches the
  kernel or raises.
- On CPU tensors the wrapper runs :func:`k_reach_plain`, the reference's
  algorithm in torch with its ``[W, V]`` frontier: each hop gathers the
  sources' words per edge, ORs each target's run of them with a segmented
  scan, and ORs the result into the frontier. The tests and
  ``chip_smoke.py`` hold the kernel against it.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from .cuda_build import load_library

#: launches of the hop kernel since import (or since a caller reset it)
LAUNCHES = 0


class TargetCSR(NamedTuple):
    """A spanner's directed entries (both directions of each live edge)
    sorted by target. ``row_ptr[t]:row_ptr[t + 1]`` are target t's entries
    for t < V; dead entries (past ``cnt``) carry the sentinel target V and
    lie past ``row_ptr[V]``, where no row reads them."""

    row_ptr: torch.Tensor  # [V + 1] int32
    src: torch.Tensor  # [2S] int32, the sources in target order
    dst: torch.Tensor  # [2S] int32, the sorted targets


def target_csr(sp, sq, cnt, num_vertices: int) -> TargetCSR:
    """The CSR by target of the first ``cnt`` spanner edges ``(sp, sq)``:
    entries at or past ``cnt`` (a device count, never read on the host)
    go to the sentinel target V with source 0."""
    dev = sp.device
    live = torch.arange(sp.shape[0], device=dev) < cnt
    live2 = torch.cat([live, live])
    dst = torch.where(live2, torch.cat([sq, sp]), num_vertices).to(torch.int32)
    src = torch.where(live2, torch.cat([sp, sq]), 0).to(torch.int32)
    dst, order = torch.sort(dst)
    row_ptr = torch.searchsorted(
        dst, torch.arange(num_vertices + 1, dtype=torch.int32, device=dev), out_int32=True)
    return TargetCSR(row_ptr, src[order].contiguous(), dst)


def _query_bits(b: int, device):
    """(word, shift, bit) of each of ``b`` queries: word ``i // 32``, shift
    ``i % 32`` (int32) and the int32 word with only that bit set."""
    i = torch.arange(b, device=device)
    shift = i % 32
    bit = torch.where(shift == 31, -(1 << 31), torch.bitwise_left_shift(torch.ones_like(i), shift))
    return i // 32, shift.to(torch.int32), bit.to(torch.int32)


def _segmented_or(vals, dst, row_ptr, num_vertices: int):
    """Per target, the OR of the ``[E, W]`` rows ``vals`` of its entries
    (``dst`` sorted): a doubling scan in which each row takes the row d
    before it while both have one target, after which each target's last
    row holds its run's OR. Returns ``[V, W]`` (0 for a target without
    entries)."""
    e = vals.shape[0]
    if e == 0:
        return vals.new_zeros(num_vertices, vals.shape[1])
    d = 1
    while d < e:
        same = (dst[d:] == dst[:-d]).unsqueeze(1)
        vals = torch.cat([vals[:d], vals[d:] | torch.where(same, vals[:-d], 0)])
        d *= 2
    nonempty = (row_ptr[1:] > row_ptr[:-1]).unsqueeze(1)
    last = (row_ptr[1:].long() - 1).clamp(min=0)
    return torch.where(nonempty, vals[last], 0)


def k_reach_plain(csr: TargetCSR, u, v, m, num_vertices: int, k: int):
    """Plain PyTorch version, the reference's algorithm: a ``[W, V]`` int32
    frontier seeded with each unmasked query's bit at ``(i // 32, u[i])``
    by addition (distinct queries carry distinct bits, so the sum is the
    OR, and a sum of distinct powers of two with bit 31 as -2^31 never
    leaves int32), then k synchronous hops, then bit i of word
    ``(i // 32, v[i])``, masked by ``m``."""
    b = u.shape[0]
    w = b // 32
    word, shift, bit = _query_bits(b, u.device)
    frontier = torch.zeros(w * num_vertices, dtype=torch.int32, device=u.device)
    frontier.index_add_(0, word * num_vertices + u.long(), torch.where(m, bit, 0))
    frontier = frontier.view(w, num_vertices)
    src = csr.src.long()
    for _ in range(k):
        incoming = _segmented_or(frontier[:, src].T, csr.dst, csr.row_ptr, num_vertices)
        frontier = frontier | incoming.T
    return (((frontier[word, v.long()] >> shift) & 1) != 0) & m


def k_reach(csr: TargetCSR, u, v, m, num_vertices: int, k: int):
    """Whether ``v[i]`` lies within ``k`` hops of ``u[i]`` for each query
    with ``m[i]`` set (False where it is not): ``u``, ``v`` int32 [B],
    ``m`` bool [B], B a positive multiple of 32, and the CSR of
    :func:`target_csr` over ``num_vertices`` vertices, all on one device.
    The plain version on the CPU; on the card k launches of the hop
    kernel, ping-ponging two ``[V, W]`` frontiers."""
    _check(csr, u, v, m, num_vertices, k)
    if u.device.type == "cpu":
        return k_reach_plain(csr, u, v, m, num_vertices, k)
    return _k_reach_hops(csr, u, v, m, num_vertices, k)


def _k_reach_hops(csr: TargetCSR, u, v, m, num_vertices: int, k: int):
    """The search on the card, for checked operands: each query's bit
    added at ``(u[i], i // 32)`` of a vertex-major ``[V, W]`` frontier,
    k hop launches between two buffers, then bit i of ``(v[i], i // 32)``."""
    b = u.shape[0]
    w = b // 32
    word, shift, bit = _query_bits(b, u.device)
    front = torch.zeros(num_vertices * w, dtype=torch.int32, device=u.device)
    front.index_add_(0, u.long() * w + word, torch.where(m, bit, 0))
    back = torch.empty_like(front)
    for _ in range(k):
        _launch(csr.row_ptr, csr.src, front, back, num_vertices, w)
        front, back = back, front
    return (((front.view(num_vertices, w)[v.long(), word] >> shift) & 1) != 0) & m


def _check(csr: TargetCSR, u, v, m, num_vertices: int, k: int) -> None:
    """Raise ValueError on operands the search does not take; nothing is
    launched before this passes."""
    tensors = (csr.row_ptr, csr.src, csr.dst, u, v, m)
    device = u.device
    if any(t.device != device for t in tensors):
        raise ValueError("k_reach: all operands must be on one device, got "
                         + ", ".join(str(t.device) for t in tensors))
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"k_reach: unsupported device {device}")
    if num_vertices < 1 or k < 0:
        raise ValueError(f"k_reach: need num_vertices >= 1 and k >= 0, got {num_vertices}, {k}")
    b = u.shape[0] if u.dim() == 1 else -1
    if b <= 0 or b % 32 or tuple(v.shape) != (b,) or tuple(m.shape) != (b,):
        raise ValueError(
            f"k_reach: u, v and m must be [B] with B a positive multiple of 32, got "
            f"{tuple(u.shape)}, {tuple(v.shape)}, {tuple(m.shape)}")
    if u.dtype != torch.int32 or v.dtype != torch.int32 or m.dtype != torch.bool:
        raise ValueError(f"k_reach: u, v must be int32 and m bool, got {u.dtype}, "
                         f"{v.dtype}, {m.dtype}")
    if tuple(csr.row_ptr.shape) != (num_vertices + 1,):
        raise ValueError(f"k_reach: row_ptr must be [V + 1] = [{num_vertices + 1}], "
                         f"got {tuple(csr.row_ptr.shape)}")
    if csr.src.dim() != 1 or csr.dst.shape != csr.src.shape:
        raise ValueError(f"k_reach: src and dst must be one [2S] shape, got "
                         f"{tuple(csr.src.shape)}, {tuple(csr.dst.shape)}")
    if any(t.dtype != torch.int32 for t in csr):
        raise ValueError("k_reach: row_ptr, src and dst must be int32")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("k_reach: operands must be contiguous")


def _launch(row_ptr, src, front, back, num_vertices: int, words: int) -> None:
    """One hop, ``front`` -> ``back``, on the current stream of their card,
    counted; raises with ``cudaGetErrorString`` if the launch is refused.
    The device index goes to the launcher, which selects that card in the
    CUDA runtime linked into the library."""
    global LAUNCHES
    lib = _library()
    device = front.device
    index = device.index if device.index is not None else torch.cuda.current_device()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        code = lib.k_reach_hop_launch(row_ptr.data_ptr(), src.data_ptr(), front.data_ptr(),
                                      back.data_ptr(), num_vertices, words, index, stream)
    if code != 0:
        msg = lib.k_reach_error_string(code).decode()
        raise RuntimeError(f"k_reach hop launch failed: {msg} (cudaError {code})")
    LAUNCHES += 1


def _library() -> ctypes.CDLL:
    lib = load_library("k_reach")
    fn = lib.k_reach_hop_launch
    if fn.argtypes is None:  # first use: declare the C signatures
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [ptr] * 4 + [i32] * 3 + [ptr]
        fn.restype = i32
        err = lib.k_reach_error_string
        err.argtypes = [i32]
        err.restype = ctypes.c_char_p
    return lib
