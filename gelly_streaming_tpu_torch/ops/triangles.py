"""Window triangle counting: sorted-adjacency intersection on dense rows
(PyTorch port of the window part of ``gelly_streaming_tpu/ops/triangles.py``).

The reference's ``example/WindowTriangles.java:86-139`` builds O(Σdeg²)
wedge candidates per window and joins them against the real edges. Here a
window's triangles are counted by intersecting the sorted out-neighbor
rows of each edge's endpoints (:func:`window_triangle_count`): edges are
canonicalized, deduplicated and oriented from the smaller ``(degree, id)``
to the larger, the rows built from a CSR, and each edge searches its
source's row in its target's row, a batched ``torch.searchsorted`` over
``[edge_chunk, D]`` slices. Invalid slots hold ``INT_MAX`` so a search
never matches them. Every count is int32, as in the reference.

The streaming exact counter's packed-adjacency operations
(``ops/triangles.py:204-498`` of the reference) and the edge-sharded
window count are ported in later slices; their names raise here.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..obs import trace as _trace
from .csr import build_csr, dense_neighbors
from .segment import INT_MAX


def canonicalize(src: torch.Tensor, dst: torch.Tensor, mask: torch.Tensor):
    """(min, max) edge ordering, self-loops masked off
    (``ExactTriangleCount.java:136-146`` ProjectCanonicalEdges)."""
    u = torch.minimum(src, dst)
    v = torch.maximum(src, dst)
    return u, v, mask & (u != v)


def dedup_canonical(u: torch.Tensor, v: torch.Tensor, mask: torch.Tensor, num_vertices: int):
    """Mask duplicate canonical edges within a block, keeping each edge's
    first occurrence. The reference's two-key stable ``lax.sort`` is one
    stable sort of the int64 key ``u << 32 | v`` here."""
    del num_vertices
    u_m = torch.where(mask, u, INT_MAX).long()
    v_m = torch.where(mask, v, INT_MAX).long()
    key = (u_m << 32) | v_m
    sk, si = torch.sort(key, stable=True)
    first = torch.ones_like(mask)
    first[1:] = sk[1:] != sk[:-1]
    keep = torch.zeros_like(mask)
    keep[si] = first
    return u, v, mask & keep


def _row_membership(rows_a: torch.Tensor, rows_b: torch.Tensor):
    """For each element of ``rows_a[i]``, its position in and presence in
    ``rows_b[i]`` (both ``[E, D]``, rows sorted ascending): one batched
    ``searchsorted``. ``INT_MAX`` sentinels never count as found."""
    pos = torch.searchsorted(rows_b, rows_a)
    pos_c = torch.clamp(pos, 0, rows_b.shape[1] - 1)
    found = (torch.gather(rows_b, 1, pos_c) == rows_a) & (rows_a != INT_MAX)
    return pos_c.to(torch.int32), found


def window_triangle_count(
    src: torch.Tensor,
    dst: torch.Tensor,
    mask: torch.Tensor,
    num_vertices: int,
    max_degree: int,
    edge_chunk: int = 1 << 16,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact triangle count of one window's edge block, degree-oriented.

    Each triangle is counted once, from its lowest-ordered vertex, and the
    row width is bounded by the max *oriented out-degree* (at most about
    sqrt(2E) for any degree distribution), which ``max_degree`` must cover
    (callers bucket it on the host). The ``[E, D]`` membership
    intermediates run in ``edge_chunk`` slices to bound peak memory.

    Returns ``(total, per_vertex[V])`` as int32 device tensors;
    ``per_vertex[w]`` is the number of window triangles containing ``w``.
    """
    a, b, m, ids = _oriented_rows(src, dst, mask, num_vertices, max_degree)
    return _membership_pass(ids, a, b, m, num_vertices, edge_chunk)


def _oriented_rows(src, dst, mask, num_vertices: int, max_degree: int):
    """Canonical, deduplicated edges oriented low -> high ``(degree, id)``,
    and the sorted dense out-neighbor rows ``ids[V, max_degree]``."""
    with _trace.span("tri.oriented_rows"):
        u, v, m = canonicalize(src, dst, mask)
        u, v, m = dedup_canonical(u, v, m, num_vertices)
        mi = m.to(torch.int32)
        deg = torch.zeros(num_vertices, dtype=torch.int32, device=src.device)
        deg.index_add_(0, u.long(), mi).index_add_(0, v.long(), mi)
        du, dv = deg[u.long()], deg[v.long()]
        swap = (dv < du) | ((dv == du) & (v < u))
        a = torch.where(swap, v, u)
        b = torch.where(swap, u, v)
        csr = build_csr(a, b, torch.zeros_like(a), m, num_vertices)
        nbr_mat, _, valid = dense_neighbors(csr, max_degree)
        ids = torch.sort(torch.where(valid, nbr_mat, INT_MAX), dim=1).values
        return a, b, m, ids


#: scratch slots past the vertex table that the membership scatter sends
#: its zero adds to (see :func:`_membership_pass`)
_SPREAD = 1 << 16


def _membership_pass(ids, a, b, m, num_vertices: int, edge_chunk: int):
    """Count, for each edge slice, the members of its source's row found in
    its target's row, and scatter them to the three corners.

    The third-corner scatter adds ``found`` over the whole ``[chunk, D]``
    slice, almost all zeros. The reference sends the zeros to vertex 0;
    on a card that is millions of atomic adds on one address, so here they
    go to ``_SPREAD`` scratch slots past the table, cut off at the end
    (the sums are the same)."""
    with _trace.span("tri.membership"):
        device = ids.device
        counts = torch.zeros(num_vertices + _SPREAD, dtype=torch.int32, device=device)
        total = torch.zeros((), dtype=torch.int32, device=device)
        big = torch.full((), INT_MAX, dtype=ids.dtype, device=device)
        rows = min(edge_chunk, a.shape[0])
        pos = torch.arange(rows * ids.shape[1], dtype=torch.int32, device=device)
        spread = (num_vertices + (pos & (_SPREAD - 1))).view(rows, -1)
        for c0 in range(0, a.shape[0], edge_chunk):
            a_i = a[c0:c0 + edge_chunk].long()
            b_i = b[c0:c0 + edge_chunk].long()
            m_i = m[c0:c0 + edge_chunk]
            rows_a = torch.where(m_i[:, None], ids[a_i], big)
            _, found = _row_membership(rows_a, ids[b_i])
            fi = found.to(torch.int32)
            cm = torch.where(m_i, fi.sum(dim=1, dtype=torch.int32), 0)
            w_ids = torch.where(found, rows_a, spread[: a_i.shape[0]])
            counts.index_add_(0, w_ids.reshape(-1), fi.reshape(-1))
            counts.index_add_(0, a_i, cm).index_add_(0, b_i, cm)
            total = total + cm.sum(dtype=torch.int32)
        return total, counts[:num_vertices]


def _later(name: str, where: str):
    def fn(*args, **kwargs):
        raise NotImplementedError(f"ops.triangles.{name} is ported in {where}")

    fn.__name__ = name
    fn.__doc__ = f"Not ported yet: raises NotImplementedError ({where})."
    return fn


window_triangle_count_sharded = _later(
    "window_triangle_count_sharded", "ROADMAP Queue 1, slice 6 (multiple devices)"
)
for _name in (
    "ranged_searchsorted", "merge_packed_adjacency", "prepare_packed_window",
    "grow_packed_columns", "build_sorted_directed", "degree_class_plan",
    "chunked_class_scan", "sticky_search_steps", "packed_common_neighbor_exists",
    "packed_triangle_update",
):
    globals()[_name] = _later(_name, "ROADMAP Queue 1, slice 5 (the remaining workloads)")
