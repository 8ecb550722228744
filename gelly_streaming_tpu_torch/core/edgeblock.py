"""EdgeBlock: the device-side unit of streaming graph data (PyTorch port).

The counterpart of ``gelly_streaming_tpu/core/edgeblock.py``. A window of
edges lives on the device as a *padded edge block*:

    src : int32[capacity]   compacted source vertex ids
    dst : int32[capacity]   compacted destination vertex ids
    val : float32[capacity] edge values (zeros for unweighted graphs)
    mask: bool[capacity]    True for real edges, False for padding

``capacity`` is a power of two (see :func:`bucket_capacity`), so a stream
of windows with varying edge counts allocates only O(log N) distinct
shapes, and device tables sized by it grow only O(log N) times.

Vertex ids inside a block are *compact* int32 indices produced by
:class:`~gelly_streaming_tpu_torch.core.vertexdict.VertexDict`; raw ids
never reach the device. ``n_vertices`` rides along as host metadata so
segment reductions know their output size.

Every tensor of a block lives on one explicit device. Host columns go to
a CUDA device through pinned memory with ``non_blocking=True``, so a
window's upload does not wait for the previous window's work.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence

import numpy as np
import torch
from torch.utils import _pytree as pytree

from ..obs import trace as _trace
from .device import resolve_device

#: dtype of the edge value column
VAL_DTYPE = np.float32


def bucket_capacity(n: int, minimum: int = 8) -> int:
    """Round ``n`` up to the next power of two (>= minimum)."""
    cap = minimum
    while cap < n:
        cap *= 2
    return cap


def to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """Copy a host array to ``device``: an owned copy on the CPU; on a
    CUDA device one copy into pinned memory, then asynchronously on the
    current stream (PyTorch does not reuse the pinned buffer before the
    copy is done). Timed as the span ``window.upload`` (the host copy and
    the copy's enqueue; ``bytes`` while tracing is on)."""
    a = np.asarray(a)
    with _trace.span("window.upload", {"bytes": int(a.nbytes)} if _trace.on() else None):
        dtype = torch.from_numpy(np.zeros(0, a.dtype)).dtype
        host = torch.empty(a.shape, dtype=dtype, pin_memory=device.type == "cuda")
        host.numpy()[...] = a
        if device.type == "cpu":
            return host
        return host.to(device, non_blocking=True)


# Shared device buffers for the per-window constants: the mask (True for the
# first n slots) takes only a couple of distinct n values per stream, and
# unweighted streams share one all-zeros val buffer per capacity — reusing
# them removes ~5 MB/window of host->device transfer on the ingest path.
# Keys include the device. CAVEAT: these are shared buffers; never write in
# place into a block's mask or val.
_MASK_CACHE: dict = {}
_ZEROS_CACHE: dict = {}


def _cached_mask(cap: int, n: int, device: torch.device) -> torch.Tensor:
    key = (cap, n, device)
    m = _MASK_CACHE.get(key)
    if m is None:
        if len(_MASK_CACHE) > 256:  # odd streams (every window a new n)
            _MASK_CACHE.clear()
        mp = np.zeros(cap, bool)
        mp[:n] = True
        m = to_device(mp, device)
        _MASK_CACHE[key] = m
    return m


def _cached_zeros(cap: int, device: torch.device, dtype=VAL_DTYPE) -> torch.Tensor:
    key = (cap, device, np.dtype(dtype))
    z = _ZEROS_CACHE.get(key)
    if z is None:
        z = to_device(np.zeros(cap, dtype), device)
        _ZEROS_CACHE[key] = z
    return z


@dataclasses.dataclass(frozen=True)
class EdgeBlock:
    """A padded, masked batch of edges (one stream window or sub-window).

    All tensors share the same leading dimension (the capacity) and one
    device. ``n_vertices`` is the vertex-table capacity this block's
    compact ids index into. ``cut_ns``: when the windowing code had read
    the window's last edge, on the tracer's clock (``obs.trace.stamp``);
    None while tracing is off.
    """

    src: torch.Tensor  # int32[capacity]
    dst: torch.Tensor  # int32[capacity]
    val: Any  # float32[capacity], or a pytree of [capacity, ...] tensors
    mask: torch.Tensor  # bool[capacity]
    n_vertices: int = 0
    cut_ns: Optional[int] = None

    @property
    def capacity(self) -> int:
        return int(self.src.shape[-1])

    def num_edges(self) -> torch.Tensor:
        """Number of valid (non-padding) edges, as a device scalar."""
        return self.mask.sum(dtype=torch.int32)

    @staticmethod
    def from_arrays(
        src: np.ndarray,
        dst: np.ndarray,
        val: Optional[np.ndarray] = None,
        *,
        n_vertices: int,
        device,
        capacity: Optional[int] = None,
        val_dtype=VAL_DTYPE,
        cut_ns: Optional[int] = None,
    ) -> "EdgeBlock":
        """Build a block of capacity ``bucket_capacity(n)`` (or
        ``capacity``) on ``device`` from host arrays of compact int32 ids,
        the val column in ``val_dtype``. The mask and (for valueless
        streams) the val column come from shared cached device buffers —
        see the module-level caveat."""
        device = torch.device(device)
        n = int(np.asarray(src).shape[0])
        cap = bucket_capacity(n) if capacity is None else int(capacity)
        if n > cap:
            raise ValueError(f"{n} edges exceed capacity {cap}")
        src_p = np.zeros(cap, dtype=np.int32)
        dst_p = np.zeros(cap, dtype=np.int32)
        src_p[:n] = src
        dst_p[:n] = dst
        if val is None:
            val_d = _cached_zeros(cap, device, val_dtype)
        else:
            val_p = np.zeros(cap, dtype=val_dtype)
            val_p[:n] = val
            val_d = to_device(val_p, device)
        return EdgeBlock(
            src=to_device(src_p, device),
            dst=to_device(dst_p, device),
            val=val_d,
            mask=_cached_mask(cap, n, device),
            n_vertices=int(n_vertices),
            cut_ns=cut_ns,
        )

    def to_host(self):
        """Return (src, dst, val) numpy arrays with padding stripped
        (``val`` may be a pytree of arrays after a tuple-valued
        ``map_edges``; masking is leaf-wise).

        Blocks built by the Windower carry their pre-padding host columns
        (``_host_cache``), so this is free on the ingest path; other blocks
        download from the device.
        """
        cache = getattr(self, "_host_cache", None)
        if cache is not None:
            return cache
        mask = self.mask.cpu().numpy()
        return (
            self.src.cpu().numpy()[mask],
            self.dst.cpu().numpy()[mask],
            pytree.tree_map(lambda a: a.cpu().numpy()[mask], self.val),
        )

    def with_host_cache(self, src, dst, val, positions=None) -> "EdgeBlock":
        """Attach pre-padding host columns. Not dataclass fields, so a
        block built with ``dataclasses.replace`` (a device transform) drops
        them and must re-download.

        ``positions``: the device slot of each cached row. ``None``
        declares PREFIX alignment (cached row i lives in device slot i),
        valid only for a prefix mask; producers that cache the rows of a
        mask with holes (``distinct()``) pass the real slots."""
        object.__setattr__(self, "_host_cache", (src, dst, val))
        object.__setattr__(self, "_host_cache_pos", positions)
        return self

    def with_vertices(self, n_vertices: int) -> "EdgeBlock":
        return dataclasses.replace(self, n_vertices=int(n_vertices))


@dataclasses.dataclass(frozen=True)
class StackedEdgeBlock:
    """K consecutive windows stacked into one ``[K, cap]`` device batch:
    the superbatch unit. All rows share one capacity (the bucketed max of
    the member windows); each window keeps its own mask row, so
    per-window emission semantics are kept exactly."""

    src: torch.Tensor  # int32[k, capacity]
    dst: torch.Tensor  # int32[k, capacity]
    val: torch.Tensor  # float32[k, capacity]
    mask: torch.Tensor  # bool[k, capacity]
    n_vertices: int = 0

    @property
    def k(self) -> int:
        return int(self.src.shape[0])

    @property
    def capacity(self) -> int:
        return int(self.src.shape[-1])

    def window(self, i: int) -> EdgeBlock:
        """Row ``i`` as an :class:`EdgeBlock` (views of the stacked
        tensors)."""
        return EdgeBlock(
            src=self.src[i], dst=self.dst[i], val=self.val[i],
            mask=self.mask[i], n_vertices=self.n_vertices,
        )


def stack_host_cols(
    cols: Sequence, n_vertices: int, *, device,
    capacity: Optional[int] = None,
) -> StackedEdgeBlock:
    """THE host ``[K, cap]`` packer: per-window column triples ``(src,
    dst, val|None)`` of compact int32 ids become one
    :class:`StackedEdgeBlock` on ``device``, one upload per plane."""
    device = torch.device(device)
    counts = [len(c[0]) for c in cols]
    cap = capacity if capacity is not None else bucket_capacity(max(counts))
    k = len(cols)
    src = np.zeros((k, cap), np.int32)
    dst = np.zeros((k, cap), np.int32)
    mask = np.zeros((k, cap), bool)
    val = np.zeros((k, cap), VAL_DTYPE)
    for i, (s, d, v) in enumerate(cols):
        n = counts[i]
        src[i, :n] = s
        dst[i, :n] = d
        mask[i, :n] = True
        if v is not None:
            val[i, :n] = v
    return StackedEdgeBlock(
        src=to_device(src, device), dst=to_device(dst, device),
        val=to_device(val, device), mask=to_device(mask, device),
        n_vertices=int(n_vertices),
    )


def prefix_host_cols(block: EdgeBlock):
    """The block's host columns when they can fill one ``[K, cap]`` plane:
    prefix-aligned, with a plain array val (a pytree val from a
    tuple-valued ``map_edges`` cannot); else None."""
    cache = getattr(block, "_host_cache", None)
    if (cache is None or getattr(block, "_host_cache_pos", None) is not None
            or not (cache[2] is None or isinstance(cache[2], np.ndarray))):
        return None
    return cache


def from_arrays_tree(
    src: np.ndarray, dst: np.ndarray, val: Any, *, n_vertices: int, device,
    capacity: Optional[int] = None,
) -> EdgeBlock:
    """Like :meth:`EdgeBlock.from_arrays` but with a pytree ``val`` whose
    leaf dtypes are kept (padding with zeros of each leaf's dtype); the
    host columns are attached as the block's cache."""
    device = torch.device(device)
    n = int(np.asarray(src).shape[0])
    cap = capacity if capacity is not None else bucket_capacity(n)
    if n > cap:
        raise ValueError(f"{n} edges exceed capacity {cap}")

    def pad(a, dtype=None):
        a = np.asarray(a, dtype)
        out = np.zeros((cap,) + a.shape[1:], dtype=a.dtype)
        out[:n] = a
        return to_device(out, device)

    val_d = (pytree.tree_map(pad, val) if val is not None
             else _cached_zeros(cap, device))
    return EdgeBlock(
        src=pad(src, np.int32), dst=pad(dst, np.int32), val=val_d,
        mask=_cached_mask(cap, n, device), n_vertices=int(n_vertices),
    ).with_host_cache(
        np.asarray(src, np.int32), np.asarray(dst, np.int32),
        pytree.tree_map(np.asarray, val) if val is not None
        else np.zeros(n, VAL_DTYPE),
    )


def stack_blocks(
    blocks: Sequence[EdgeBlock], capacity: Optional[int] = None
) -> StackedEdgeBlock:
    """Pack K EdgeBlocks of one device into one :class:`StackedEdgeBlock`.

    When every block carries its pre-padding host cache (the Windower's
    blocks), the ``[K, cap]`` planes are assembled in numpy and uploaded
    once; other blocks are padded and stacked on the device."""
    if not blocks:
        raise ValueError("stack_blocks needs at least one block")
    n_vertices = max(b.n_vertices for b in blocks)
    device = blocks[0].src.device
    if all(prefix_host_cols(b) is not None for b in blocks):
        return stack_host_cols(
            [b._host_cache for b in blocks], n_vertices, device=device,
            capacity=capacity,
        )
    cap = capacity if capacity is not None else bucket_capacity(
        max(b.capacity for b in blocks)
    )

    def pad(a, fill=0):
        short = cap - a.shape[-1]
        if short == 0:
            return a
        return torch.cat([a, torch.full((short,), fill, dtype=a.dtype,
                                        device=a.device)])

    return StackedEdgeBlock(
        src=torch.stack([pad(b.src) for b in blocks]),
        dst=torch.stack([pad(b.dst) for b in blocks]),
        val=torch.stack([pad(b.val) for b in blocks]),
        mask=torch.stack([pad(b.mask, False) for b in blocks]),
        n_vertices=n_vertices,
    )


def concat_blocks(
    blocks: Sequence[EdgeBlock], capacity: Optional[int] = None, *,
    device=None,
) -> EdgeBlock:
    """Concatenate blocks into one, on the host (window re-bucketing).
    ``device`` is needed only when ``blocks`` is empty."""
    srcs, dsts, vals = [], [], []
    n_vertices = 0
    for b in blocks:
        s, d, v = b.to_host()
        srcs.append(s)
        dsts.append(d)
        vals.append(v)
        n_vertices = max(n_vertices, b.n_vertices)
        device = b.src.device
    if device is None:
        raise ValueError("concat_blocks of no blocks needs a device")
    src = np.concatenate(srcs or [np.zeros(0, np.int32)]).astype(np.int32)
    dst = np.concatenate(dsts or [np.zeros(0, np.int32)]).astype(np.int32)
    val = np.concatenate(vals or [np.zeros(0, VAL_DTYPE)]).astype(VAL_DTYPE)
    return EdgeBlock.from_arrays(
        src, dst, val, n_vertices=n_vertices, device=device, capacity=capacity,
    ).with_host_cache(src, dst, val)


class EdgeAccumulator:
    """Device-resident growing edge list at bucketed capacity.

    The carried-graph workloads (streaming GraphSAGE here) accumulate every
    window's edges. The columns live on ``device`` in a power-of-two
    bucket allocated with ``torch.zeros``; each window's edges are written
    into the next slice IN PLACE, and when the bucket grows the old prefix
    is copied into the new one. Per-window traffic is O(new edges).
    Callers that shard the columns over a mesh axis pass its size as
    ``min_capacity``, so every bucket divides by it.
    """

    def __init__(self, *, device, min_capacity: int = 8):
        self.device = resolve_device(device)
        self.min_capacity = min_capacity
        self.src = torch.zeros(0, dtype=torch.int32, device=self.device)
        self.dst = torch.zeros(0, dtype=torch.int32, device=self.device)
        self.n_edges = 0

    def append(self, s, d) -> None:
        """Append one window's endpoint columns: host arrays, or int32
        tensors already on this accumulator's device."""
        s = self._column(s)
        d = self._column(d)
        n_new = int(s.shape[0])
        total = self.n_edges + n_new
        cap = bucket_capacity(total, minimum=self.min_capacity)
        if cap > self.src.shape[0]:
            self.src = self._grown(self.src, cap)
            self.dst = self._grown(self.dst, cap)
        if n_new:
            self.src[self.n_edges:total].copy_(s)
            self.dst[self.n_edges:total].copy_(d)
        self.n_edges = total

    def _column(self, x) -> torch.Tensor:
        if isinstance(x, torch.Tensor):
            if x.device != self.device or x.dtype != torch.int32:
                raise ValueError(
                    f"EdgeAccumulator on {self.device} takes int32 columns "
                    f"there, got {x.dtype} on {x.device}"
                )
            return x
        return to_device(np.asarray(x, np.int32), self.device)

    def _grown(self, col: torch.Tensor, cap: int) -> torch.Tensor:
        new = torch.zeros(cap, dtype=torch.int32, device=self.device)
        new[: self.n_edges].copy_(col[: self.n_edges])
        return new

    def mask(self) -> torch.Tensor:
        return torch.arange(self.src.shape[0], device=self.device) < self.n_edges

    def state_dict(self) -> dict:
        return {
            "src": self.src[: self.n_edges].cpu().numpy(),
            "dst": self.dst[: self.n_edges].cpu().numpy(),
        }

    def load_state_dict(self, d: dict) -> None:
        self.src = torch.zeros(0, dtype=torch.int32, device=self.device)
        self.dst = torch.zeros(0, dtype=torch.int32, device=self.device)
        self.n_edges = 0
        self.append(d["src"], d["dst"])
