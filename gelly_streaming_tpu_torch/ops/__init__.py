"""Kernels and device operations of the PyTorch port, each hand-written
kernel beside its plain PyTorch version."""

from .csr import CSR, build_csr, dense_neighbors, sorted_neighbor_matrix
from .device_dict import DeviceVertexDict
from .segment import (
    segment_count,
    segment_reduce,
    segmented_fold,
    segmented_reduce_generic,
    sort_by_segment,
)

__all__ = [
    "CSR",
    "DeviceVertexDict",
    "build_csr",
    "dense_neighbors",
    "segment_count",
    "segment_reduce",
    "segmented_fold",
    "segmented_reduce_generic",
    "sort_by_segment",
    "sorted_neighbor_matrix",
]
