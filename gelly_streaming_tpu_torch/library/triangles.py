"""Window triangle counting (PyTorch port of :class:`WindowTriangles` from
``gelly_streaming_tpu/library/triangles.py``).

The reference (``example/WindowTriangles.java:60-139``) generates
O(Σdeg²) wedge candidates per vertex and joins them against the real edges
across two more shuffles; here each window is one sorted-adjacency
intersection (``ops/triangles.py``), emitting ``(count,
window_max_timestamp)`` pairs like the reference's final
``timeWindowAll().sum(0)`` stream. The dense-row width is planned on the
host from the window's host columns (:func:`_oriented_degree_bucket`), so
:meth:`WindowTriangles.run_stream` reads nothing from the device per
window.

The streaming exact counter, :class:`ExactTriangleCount`, is ported in a
later slice and raises.
"""

from __future__ import annotations

from typing import Iterable, Iterator, Optional, Tuple

import numpy as np
import torch

from ..core.device import DEFAULT_DEVICE, resolve_device
from ..core.edgeblock import bucket_capacity
from ..core.window import WindowPolicy, Windower
from ..obs import trace as _trace
from ..ops.triangles import window_triangle_count

GLOBAL_KEY = -1  # the reference's "total" counter vertex id


def _window_step(block, max_degree: int):
    return window_triangle_count(block.src, block.dst, block.mask, block.n_vertices, max_degree)


class WindowTriangles:
    """Exact triangles per tumbling window.

    ``run(edges)`` yields ``(count, max_timestamp)`` per window on
    ``device`` (default ``"cuda"``; ``device="cpu"`` runs on the CPU):
    ``max_timestamp`` is the inclusive window end for event-time windows
    (Flink's ``TimeWindow.maxTimestamp()``), the window index for count
    windows. :meth:`run_stream` runs on the stream's own device.
    """

    def __init__(self, window: WindowPolicy, *, device=DEFAULT_DEVICE):
        self.window = window
        self.device = resolve_device(device)

    def run(self, edges: Iterable[Tuple]) -> Iterator[Tuple[int, Optional[float]]]:
        windower = Windower(self.window, device=self.device)
        for info, block in windower.blocks_with_info(edges):
            total, _ = _window_step(block, _plan_width(block))
            ts = info.max_timestamp if info.max_timestamp is not None else info.index
            yield int(total), ts

    def run_stream(self, stream) -> Iterator[Tuple[torch.Tensor, int]]:
        """The system path: consume a ``SimpleEdgeStream`` through
        ``stream.slice(self.window)`` (re-windowing on the host columns) and
        count per slice. Yields ``(count, window_index)`` with ``count``
        still an int32 DEVICE scalar: ``int(count)`` waits for it, and a
        consumer that does not read it makes no device read per window."""
        snaps = stream.slice(self.window)
        for i, block in enumerate(snaps._block_iter_fn()):
            total, _ = _window_step(block, _plan_width(block))
            yield total, i


def _plan_width(block) -> int:
    """The dense-row width of one window, from its host columns."""
    with _trace.span("tri.plan"):
        s, d, _ = block.to_host()
        return _oriented_degree_bucket(s, d, block.n_vertices)


def _oriented_degree_bucket(
    s: np.ndarray, d: np.ndarray, num_vertices: int,
    dense_budget_bytes: int = 2 << 30,
) -> int:
    """Power-of-two bucket covering the window's max ORIENTED out-degree,
    the dense-row width of the kernel, from the host columns.

    With degree-ordered orientation every out-neighbor of ``a`` has degree
    >= deg(a) >= outdeg(a), so outdeg(a)^2 <= 2E': the width is bounded by
    ``min(max degree, sqrt(2E))``, both from one bincount (duplicate edges
    only loosen the bound). If that bound would blow the dense ``[V,
    width]`` rows past ``dense_budget_bytes``, the exact width comes from a
    host dedup and orientation instead."""
    E = len(s)
    if E == 0:
        return bucket_capacity(0)
    deg = np.bincount(s, minlength=num_vertices)
    deg = deg + np.bincount(d, minlength=num_vertices)
    w = int(min(int(deg.max()), int(np.ceil(np.sqrt(2.0 * E))) + 1))
    cap = bucket_capacity(max(w, 8))
    if num_vertices * cap * 4 <= dense_budget_bytes:
        return cap
    u = np.minimum(s, d).astype(np.int64)
    v = np.maximum(s, d).astype(np.int64)
    ok = u != v
    u, v = u[ok], v[ok]
    if u.size == 0:
        return bucket_capacity(0)
    key = np.unique(u * num_vertices + v)
    u = key // num_vertices
    v = key % num_vertices
    deg = np.bincount(u, minlength=num_vertices) + np.bincount(v, minlength=num_vertices)
    du, dv = deg[u], deg[v]
    swap = (dv < du) | ((dv == du) & (v < u))
    a = np.where(swap, v, u)
    return bucket_capacity(int(np.bincount(a, minlength=num_vertices).max()))


class ExactTriangleCount:
    """Single-pass exact local and global triangle counting: ported with
    the remaining workloads, so constructing one raises."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "ExactTriangleCount is ported in ROADMAP Queue 1, slice 5 "
            "(the remaining workloads)"
        )
