"""GraphSAGE's neighbour mean over a destination-sorted CSR of the held
messages, as one kernel launch a layer on the card.

:class:`MessageCSR` carries the messages a stream has delivered so far,
sorted by destination (stably, so each destination's messages keep their
stream order), with ``row_ptr`` over the destinations. Each window extends
it in one pass over the carried arrays: the window's messages are sorted
alone and merged in, never the whole prefix again. The upkeep is ATen
(sort, searchsorted, gathers and index copies) and makes no host read.

:func:`segment_mean` is the mean of ``h`` over each row's messages: the
counterpart of ``mean_aggregate`` of ``gelly_streaming_tpu/models/graphsage.py``
(``:53``), an XLA gather and scatter-add in the JAX package, not a Pallas
kernel.

- On CUDA tensors it checks its operands and makes one launch of the kernel
  in ``csrc/sage_aggregate.cu`` (built at first use by :mod:`.cuda_build`),
  counted in :data:`LAUNCHES`: a merge-path split of rows and messages over
  a persistent cooperative grid, sums in float32 registers, no atomic and
  no ``[E, F]`` tensor. The split is fixed by the shapes, so two launches
  give the same bits. A CUDA call launches the kernel or raises.
- On CPU tensors it runs :func:`segment_mean_plain`: a float32
  ``index_add_`` over the CSR order, then the same divide and cast.

Both count the messages they read in :data:`MESSAGES_PULLED`.
"""

from __future__ import annotations

import ctypes

import torch

from ..core.edgeblock import bucket_capacity
from .cuda_build import launch, load_library, query

#: launches of the mean kernel since import (or since a caller reset it):
#: one a layer on the card
LAUNCHES = 0

#: messages the mean read since import, on either path: a layer of
#: ``StreamingGraphSAGE`` on one device reads every held message once
MESSAGES_PULLED = 0

#: messages a slice of the plain version's ``index_add_``: its float32
#: messages take 4 GiB at F = 256
SLICE = 1 << 22

#: carried messages a slice of the CSR's merge: its int64 positions take
#: 128 MiB, and the last window of the benchmark's stream takes 7 slices
MERGE_SLICE = 1 << 24

#: the kernel's dtype codes
_DTYPES = {torch.bfloat16: 0, torch.float32: 1}

#: (card, dtype code, F) -> the most workers a launch takes there and their
#: scratch (float32 partial rows, int32 row ids), made at the first launch
#: and reused by every later one on the card's stream
_SCRATCH = {}


class MessageCSR:
    """The held messages sorted by destination, on ``device``.

    ``src`` and ``dst`` (int32, bucketed capacity) hold the sources and
    destinations of the first :attr:`n` slots in that order; ``row_ptr``
    (int64, ``n_rows + 1``) cuts them into rows, so ``row_ptr[v + 1] -
    row_ptr[v]`` is the exact in-degree of ``v``. Within a row, messages
    keep the order in which :meth:`append` received them."""

    def __init__(self, *, device):
        self.device = torch.device(device)
        self.src = torch.zeros(0, dtype=torch.int32, device=self.device)
        self.dst = torch.zeros(0, dtype=torch.int32, device=self.device)
        self.row_ptr = torch.zeros(1, dtype=torch.int64, device=self.device)
        self.n = 0
        # 0 .. n_rows, the merge's search keys, grown with the rows
        self._ids = torch.zeros(1, dtype=torch.int32, device=self.device)

    @property
    def n_rows(self) -> int:
        return self.row_ptr.shape[0] - 1

    def reserve_rows(self, n_rows: int) -> None:
        """Grow to ``n_rows`` rows (new rows empty); never shrinks."""
        extra = n_rows - self.n_rows
        if extra > 0:
            self.row_ptr = torch.cat([self.row_ptr, self.row_ptr[-1:].expand(extra)])
            self._ids = torch.arange(n_rows + 1, dtype=torch.int32, device=self.device)

    def append(self, src: torch.Tensor, dst: torch.Tensor, n_rows: int) -> None:
        """Merge one window's messages ``src -> dst`` (int32 on this device,
        every destination below ``n_rows``) after the carried ones of each
        row. A carried message moves up by the new messages into lower
        rows; a new one lands after its row's carried run."""
        self.reserve_rows(n_rows)
        m = int(src.shape[0])
        if m == 0:
            return
        dst_new, order = torch.sort(dst, stable=True)
        src_new = src.index_select(0, order)
        # new messages into rows below v, for every v: the new counts' scan
        below = torch.searchsorted(dst_new, self._ids, out_int32=True)
        old, total = self.n, self.n + m
        cap = bucket_capacity(total)
        src_out = torch.empty(cap, dtype=torch.int32, device=self.device)
        dst_out = torch.empty(cap, dtype=torch.int32, device=self.device)
        for a in range(0, old, MERGE_SLICE):
            b = min(a + MERGE_SLICE, old)
            pos = below.index_select(0, self.dst[a:b]).long()
            pos += torch.arange(a, b, device=self.device)
            src_out.index_copy_(0, pos, self.src[a:b])
            dst_out.index_copy_(0, pos, self.dst[a:b])
        # after every carried message of its row and every earlier new one
        pos = self.row_ptr.index_select(0, dst_new.long() + 1)
        pos += torch.arange(m, device=self.device)
        src_out.index_copy_(0, pos, src_new)
        dst_out.index_copy_(0, pos, dst_new)
        self.row_ptr = self.row_ptr + below
        self.src, self.dst, self.n = src_out, dst_out, total


def segment_mean_plain(h, src, row_ptr, n_messages: int):
    """Plain PyTorch version: ``index_add_`` of each message's float32 row
    into its row of the CSR, :data:`SLICE` messages at a time, divided by
    the exact count (1 where none) and cast to ``h.dtype``. On the CPU it
    sums each row's messages in their order."""
    v, f = h.shape
    counts = row_ptr[1:] - row_ptr[:-1]
    dst = torch.repeat_interleave(torch.arange(v, device=h.device), counts,
                                  output_size=n_messages)
    agg = torch.zeros((v, f), dtype=torch.float32, device=h.device)
    for a in range(0, n_messages, SLICE):
        b = min(a + SLICE, n_messages)
        agg.index_add_(0, dst[a:b], h.index_select(0, src[a:b]).to(torch.float32))
    return (agg / torch.clamp_min(counts, 1).to(torch.float32)[:, None]).to(h.dtype)


def segment_mean(h, src, row_ptr, n_messages: int):
    """The mean of ``h`` over each row's messages: ``h`` ``[V, F]``
    (bfloat16 or float32, the dtypes ``fused_sage_matmul`` takes on the card;
    ``F`` a multiple of 8), ``src`` int32
    with at least ``n_messages`` entries (every id below ``V``), ``row_ptr``
    int64 ``[V + 1]`` from 0 to ``n_messages``, all contiguous on one
    device. Returns a new ``[V, F]`` tensor of ``h.dtype``, zeros in rows
    with no message. The plain version on the CPU; on the card one launch
    of the kernel and no host read."""
    global MESSAGES_PULLED
    _check(h, src, row_ptr, n_messages)
    if h.device.type == "cpu":
        out = segment_mean_plain(h, src, row_ptr, n_messages)
    else:
        out = _mean_kernel(h, src, row_ptr, n_messages)
    MESSAGES_PULLED += n_messages
    return out


def _mean_kernel(h, src, row_ptr, n_messages: int):
    """The mean on the card, for checked operands: a new output, the
    card's scratch for the partial rows of every worker (:data:`_SCRATCH`),
    one launch on the current stream of the operands' card, counted in
    :data:`LAUNCHES`; raises when the launch was refused."""
    global LAUNCHES
    lib = _library()
    device = h.device
    v, f = h.shape
    out = torch.empty_like(h)
    dtype = _DTYPES[h.dtype]
    key = (device, dtype, f)
    if key not in _SCRATCH:
        workers = query(lib, "sage_segment_mean_max_workers", device, dtype, f)
        _SCRATCH[key] = (workers,
                         torch.empty((2, workers, f), dtype=torch.float32, device=device),
                         torch.empty((2, workers), dtype=torch.int32, device=device))
    workers, parts, rows = _SCRATCH[key]
    launch(lib, "sage_segment_mean_launch", device, h, src, row_ptr, out, parts, rows, workers,
           n_messages, v, f, dtype)
    LAUNCHES += 1
    return out


def _check(h, src, row_ptr, n_messages: int) -> None:
    """Raise ValueError on operands the mean does not take; nothing is
    launched before this passes."""
    tensors = (h, src, row_ptr)
    device = h.device
    if any(t.device != device for t in tensors):
        raise ValueError("sage segment mean: all operands must be on one device, got "
                         + ", ".join(str(t.device) for t in tensors))
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"sage segment mean: unsupported device {device}")
    if h.dim() != 2 or src.dim() != 1 or row_ptr.dim() != 1:
        raise ValueError(f"sage segment mean: h must be [V, F], src and row_ptr 1-D, got "
                         f"{tuple(h.shape)}, {tuple(src.shape)}, {tuple(row_ptr.shape)}")
    v, f = h.shape
    if not 1 <= v < 1 << 31 or row_ptr.shape[0] != v + 1:
        raise ValueError(f"sage segment mean: needs 1 to 2^31 - 1 rows and V + 1 row "
                         f"offsets, got {v} rows and {row_ptr.shape[0]} offsets")
    if not 0 <= n_messages <= src.shape[0] or n_messages >= 1 << 31:
        raise ValueError(f"sage segment mean: {n_messages} messages of {src.shape[0]} "
                         f"sources (at most 2^31 - 1)")
    if h.dtype not in _DTYPES or src.dtype != torch.int32 or row_ptr.dtype != torch.int64:
        raise ValueError(f"sage segment mean: h must be bfloat16 or float32, src "
                         f"int32 and row_ptr int64, got {h.dtype}, {src.dtype}, {row_ptr.dtype}")
    if f % 8:
        raise ValueError(f"sage segment mean: F must be a multiple of 8, got {f}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("sage segment mean: operands must be contiguous")
    if device.type == "cuda" and h.data_ptr() % 16:
        raise ValueError("sage segment mean: h must start on a 16-byte boundary")


def _library() -> ctypes.CDLL:
    """The kernel's library; its C signatures are declared at first use."""
    lib = load_library("sage_aggregate")
    if lib.sage_segment_mean_launch.argtypes is None:
        ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.sage_segment_mean_max_workers.argtypes = [i32, i32, i32]
        lib.sage_segment_mean_max_workers.restype = i64
        lib.sage_segment_mean_launch.argtypes = [ptr] * 6 + [i64, i64, i32, i32, i32, i32, ptr]
        lib.sage_segment_mean_launch.restype = i32
    return lib
