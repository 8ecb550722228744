"""The k >= 3 spanner's k-hop search, as one kernel launch a search on the card.

:func:`k_reach` answers, for a batch of B query edges ``(u, v)`` (B a
positive multiple of 32), whether ``v`` lies within k hops of ``u`` over
the spanner's edges, held as a CSR by target (:func:`target_csr`). It is
the counterpart of ``gelly_streaming_tpu/library/spanner.py:_k_reach_cnt``,
an XLA step in the JAX package (not a Pallas kernel). As there, 32 queries
share each 32-bit word of the frontier: query i owns bit ``i % 32`` of word
``i // 32``, so the frontier is ``W = B / 32`` words a vertex. The words are
int32 (PyTorch has no uint32 bitwise operations on CUDA): bit 31 is the sign
bit, so a bit is read as ``(x >> s) & 1``.

One hop is synchronous: every vertex's new row is its old row ORed with
the old rows of its in-neighbours, all read from the hop's starting
frontier. After k hops the frontier of query i holds exactly the vertices
within k hops of ``u[i]``.

- On CUDA tensors :func:`k_reach` checks its operands and makes one launch
  of the search kernel in ``csrc/k_reach.cu`` (built at first use by
  :mod:`.cuda_build`), counted in :data:`LAUNCHES`: the seed, the k hops,
  the read-out and the clearing of the scratch all run in it, on a
  persistent cooperative grid. A CUDA call launches the kernel or raises.
- On CPU tensors the wrapper runs :func:`k_reach_plain`, the reference's
  algorithm in torch with its ``[W, V]`` frontier: each hop gathers the
  sources' words per edge, ORs each target's run of them with a segmented
  scan, and ORs the result into the frontier. The tests and
  ``chip_smoke.py`` hold the kernel against it.

What bounds the kernel is the rows it must move and the latency of the
dependent loads (a target's sources, then their rows), not the dense
frontier: at the spanner's cells most sources' rows are zero, or did not
change in the hop before, and most of the frontier stays zero in the first
hops. So the kernel keeps bitmaps of one bit a vertex beside its two
vertex-major ``[V, W]`` frontiers: the rows the last hop *changed* and the
rows that are *non-zero*. A hop gathers only the sources whose rows
changed in the hop before: a source whose row did not change has
``R_{h-1}[s] = R_{h-2}[s]``, which the hop before already ORed into its
targets. It reads a target's own row only where the row is non-zero, and
writes only non-zero words (rows only grow, so a word that is zero after
hop h was zero in the buffer it writes, which holds ``R_{h-2}``).

The scratch (the two frontiers and six bitmaps, three slots of each kind,
see :func:`_scratch`) is allocated zeroed once per (device, V, W), a new V
replacing the scratch of that device and width (a growing vertex capacity
gets new scratch). Every launch leaves it all zero again, so no search
fills it. It belongs to the wrapper: no two streams may search on one
device at once.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from .cuda_build import launch, load_library, query

#: launches of the search kernel since import (or since a caller reset it):
#: one a search on the card
LAUNCHES = 0

#: (device, W) -> (V, frontiers [2, V * W] int32, bitmaps [6, bitmap words] int32)
_SCRATCH: dict = {}


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
    The plain version on the CPU; on the card one launch of the search
    kernel."""
    _check(csr, u, v, m, num_vertices, k)
    if u.device.type == "cpu":
        return k_reach_plain(csr, u, v, m, num_vertices, k)
    return _k_reach_search(csr, u, v, m, num_vertices, k)


def bitmap_words(num_vertices: int) -> int:
    """int32 words of one of the kernel's bitmaps: one bit a vertex, padded
    to whole 16-byte lines (the unit of its bulk copy into shared memory)."""
    return 4 * ((num_vertices + 127) // 128)


def _scratch(device, num_vertices: int, words: int):
    """The search's zeroed scratch on ``device`` for V vertices and W words a
    vertex: ``[2, V * W]`` int32 frontiers and ``[6, bitmap_words(V)]``
    int32 bitmaps (three of rows changed, three of non-zero rows: hop h's
    in slot ``h % 3``), allocated once; a new V replaces the old."""
    key = (device, words)
    held = _SCRATCH.get(key)
    if held is None or held[0] != num_vertices:
        held = (num_vertices,
                torch.zeros(2, num_vertices * words, dtype=torch.int32, device=device),
                torch.zeros(6, bitmap_words(num_vertices), dtype=torch.int32, device=device))
        _SCRATCH[key] = held
    return held[1], held[2]


def _k_reach_search(csr: TargetCSR, u, v, m, num_vertices: int, k: int):
    """The search on the card, for checked operands: one launch on the
    wrapper's scratch, which it finds and leaves all zero."""
    w = u.shape[0] // 32
    fronts, bitmaps = _scratch(u.device, num_vertices, w)
    out = torch.empty_like(m)
    _launch(csr.row_ptr, csr.src, u, v, m, fronts, bitmaps, out, num_vertices, w, k)
    return out


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


def _launch(row_ptr, src, u, v, m, fronts, bitmaps, out, num_vertices: int, words: int,
            k: int, device_bitmap: bool = False) -> None:
    """One search on the current stream of the operands' card, counted.
    ``device_bitmap`` makes it read the changed bitmap from device memory
    even where it fits in shared memory (to measure that path; the search
    never sets it)."""
    global LAUNCHES
    launch(_library(), "k_reach_search_launch", u.device, row_ptr, src, u, v, m, fronts, bitmaps,
           out, num_vertices, words, k, int(device_bitmap))
    LAUNCHES += 1


def search_is_staged(num_vertices: int, device) -> bool:
    """Whether a search over ``num_vertices`` on the CUDA ``device`` stages
    its changed bitmap in shared memory (else it reads it from device
    memory): the launcher's own rule, from V and the card."""
    return bool(query(_library(), "k_reach_search_staged", device, num_vertices))


def _library() -> ctypes.CDLL:
    lib = load_library("k_reach")
    fn = lib.k_reach_search_launch
    if fn.argtypes is None:  # first use: declare the C signatures
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [ptr] * 8 + [i32] * 5 + [ptr]
        fn.restype = i32
        lib.k_reach_search_staged.argtypes = [i32, i32]
        lib.k_reach_search_staged.restype = i32
        lib.k_reach_bitmap_words.argtypes = [i32]
        lib.k_reach_bitmap_words.restype = i32
    return lib
