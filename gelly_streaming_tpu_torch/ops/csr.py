"""Per-window CSR construction and dense neighborhood rows (PyTorch port).

The counterpart of ``gelly_streaming_tpu/ops/csr.py``. The reference gives
``applyOnNeighbors`` UDFs an ``Iterable`` over a vertex's windowed
neighborhood (``SnapshotStream.java:129-181``). Here the window's edge block
is sorted by vertex, ``row_ptr`` comes from ``searchsorted`` (CSR), and the
neighbors are gathered into a padded ``[num_vertices, max_degree]`` matrix
that a ``vmap``-ed UDF reads with a validity mask.

``max_degree`` is a host value (bucketed), the price of dense shapes;
windows with skewed degrees should prefer the segment reductions
(``ops/segment.py``), which never build neighborhoods.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import torch
from torch.utils import _pytree as pytree

from ..obs import trace as _trace
from .segment import INT_MAX, segment_count, sort_by_segment


@dataclasses.dataclass(frozen=True)
class CSR:
    """Sorted-edge CSR view of one window's edge block.

    ``sorted_key``/``sorted_nbr``/``sorted_val``/``sorted_mask`` are the
    edge tensors stable-sorted by key vertex (padding last); ``row_ptr[v]``
    (int32, ``num_vertices + 1`` entries) is the first index of vertex
    ``v``'s run; ``degree[v]`` (int32) its run length.
    """

    sorted_key: torch.Tensor
    sorted_nbr: torch.Tensor
    sorted_val: Any
    sorted_mask: torch.Tensor
    row_ptr: torch.Tensor
    degree: torch.Tensor

    @property
    def num_vertices(self) -> int:
        return int(self.degree.shape[0])


def build_csr(
    key: torch.Tensor,
    nbr: torch.Tensor,
    val: Any,
    mask: torch.Tensor,
    num_vertices: int,
) -> CSR:
    """Sort one window's edges by key vertex and derive CSR offsets."""
    with _trace.span("csr.build"):
        sorted_key, sorted_mask, sorted_nbr, sorted_val = sort_by_segment(key, mask, nbr, val)
        seg = torch.arange(num_vertices + 1, dtype=sorted_key.dtype, device=sorted_key.device)
        row_ptr = torch.searchsorted(sorted_key, seg, out_int32=True)
        degree = segment_count(key, mask, num_vertices)
        return CSR(sorted_key, sorted_nbr, sorted_val, sorted_mask, row_ptr, degree)


def _rows(csr: CSR, starts: torch.Tensor, ends: torch.Tensor, max_degree: int):
    """Gather ``[T, max_degree]`` rows of the sorted neighbor and value
    columns from run starts/ends; slots past a run's end are invalid."""
    offs = torch.arange(max_degree, dtype=torch.int64, device=starts.device)
    idx = starts.long()[:, None] + offs[None, :]
    valid = idx < ends.long()[:, None]
    idx = torch.clamp(idx, 0, csr.sorted_key.shape[0] - 1)
    nbr_mat = csr.sorted_nbr[idx]
    val_mat = pytree.tree_map(lambda a: a[idx], csr.sorted_val)
    return nbr_mat, val_mat, valid


def dense_neighbors(csr: CSR, max_degree: int) -> Tuple[torch.Tensor, Any, torch.Tensor]:
    """Padded per-vertex neighbor rows of a CSR: ``(nbr_mat[V, D],
    val_mat[V, D], valid[V, D])`` with D = ``max_degree``. Entries past a
    vertex's degree are masked False; a vertex of degree > D is truncated
    (callers bucket D from the true max, so only when capped on purpose)."""
    V = csr.num_vertices
    return _rows(csr, csr.row_ptr[:V], csr.row_ptr[1:V + 1], max_degree)


def dense_neighbors_subset(
    csr: CSR, vids: torch.Tensor, max_degree: int
) -> Tuple[torch.Tensor, Any, torch.Tensor]:
    """Padded neighbor rows for SELECTED vertices only: ``[T, D]``.

    The degree-class path of ``apply_on_neighbors``: each degree class
    builds rows only as wide as its own bucket, so one hub no longer sizes
    every vertex's rows (total work sum_v bucket(deg v) <= ~4E)."""
    vids = vids.long()
    return _rows(csr, csr.row_ptr[vids], csr.row_ptr[vids + 1], max_degree)


def sorted_neighbor_matrix(csr: CSR, max_degree: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Neighbor rows sorted ascending within each row (for intersections);
    invalid slots hold ``INT_MAX`` so binary search never matches them."""
    nbr_mat, _, valid = dense_neighbors(csr, max_degree)
    rows = torch.where(valid, nbr_mat, torch.full_like(nbr_mat, INT_MAX))
    return torch.sort(rows, dim=1).values, valid
