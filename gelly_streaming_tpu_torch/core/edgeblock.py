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
from typing import Optional

import numpy as np
import torch

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
    copy is done)."""
    a = np.asarray(a)
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


def _cached_zeros(cap: int, device: torch.device) -> torch.Tensor:
    key = (cap, device)
    z = _ZEROS_CACHE.get(key)
    if z is None:
        z = to_device(np.zeros(cap, VAL_DTYPE), device)
        _ZEROS_CACHE[key] = z
    return z


@dataclasses.dataclass(frozen=True)
class EdgeBlock:
    """A padded, masked batch of edges (one stream window or sub-window).

    All tensors share the same leading dimension (the capacity) and one
    device. ``n_vertices`` is the vertex-table capacity this block's
    compact ids index into.
    """

    src: torch.Tensor  # int32[capacity]
    dst: torch.Tensor  # int32[capacity]
    val: torch.Tensor  # float32[capacity]
    mask: torch.Tensor  # bool[capacity]
    n_vertices: int = 0

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
    ) -> "EdgeBlock":
        """Build a block of capacity ``bucket_capacity(n)`` on ``device``
        from host arrays of compact int32 ids. The mask and (for valueless
        streams) the val column come from shared cached device buffers —
        see the module-level caveat."""
        device = torch.device(device)
        n = int(np.asarray(src).shape[0])
        cap = bucket_capacity(n)
        src_p = np.zeros(cap, dtype=np.int32)
        dst_p = np.zeros(cap, dtype=np.int32)
        src_p[:n] = src
        dst_p[:n] = dst
        if val is None:
            val_d = _cached_zeros(cap, device)
        else:
            val_p = np.zeros(cap, dtype=VAL_DTYPE)
            val_p[:n] = val
            val_d = to_device(val_p, device)
        return EdgeBlock(
            src=to_device(src_p, device),
            dst=to_device(dst_p, device),
            val=val_d,
            mask=_cached_mask(cap, n, device),
            n_vertices=int(n_vertices),
        )

    def to_host(self):
        """Return (src, dst, val) numpy arrays with padding stripped.

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
            self.val.cpu().numpy()[mask],
        )

    def with_host_cache(self, src, dst, val) -> "EdgeBlock":
        """Attach pre-padding host columns, PREFIX-aligned with the device
        columns (cached row i lives in device slot i; the mask is a prefix
        mask). Not dataclass fields, so a block built with
        ``dataclasses.replace`` drops them and must re-download."""
        object.__setattr__(self, "_host_cache", (src, dst, val))
        return self

    def with_vertices(self, n_vertices: int) -> "EdgeBlock":
        return dataclasses.replace(self, n_vertices=int(n_vertices))


class EdgeAccumulator:
    """Device-resident growing edge list at bucketed capacity.

    The carried-graph workloads (streaming GraphSAGE here) accumulate every
    window's edges. The columns live on ``device`` in a power-of-two
    bucket allocated with ``torch.zeros``; each window's edges are written
    into the next slice IN PLACE, and when the bucket grows the old prefix
    is copied into the new one. Per-window traffic is O(new edges).
    """

    def __init__(self, *, device):
        self.device = resolve_device(device)
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
        cap = bucket_capacity(total)
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
