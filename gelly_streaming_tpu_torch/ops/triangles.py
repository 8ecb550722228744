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

The second half is the packed sorted adjacency that the streaming exact
counter (``library/triangles.py:ExactTriangleCount``) and the k = 2
device spanner carry (``ops/triangles.py:204-498`` of the reference):
three int32 columns ``(vertex, nbr, rank)`` sorted by ``(vertex, nbr)``,
both directions of every edge, ``INT_MAX`` vertex sentinels at the tail.
Where the reference runs a fixed-``steps`` binary search inside each
element's row (:func:`ranged_searchsorted`, kept for its own callers), the
packed operations here search the int64 composite key ``vertex << 32 |
nbr`` with one ``torch.searchsorted``: the columns are sorted by that key,
so the position of ``(v, n)`` is the number of entries less than it, which
is the row start plus the reference's position inside the row; the
positions are the same whenever the reference's ``steps`` cover the row,
as ``sticky_search_steps`` makes them. ``search_steps`` is accepted for
the reference's signatures.

The edge-sharded window count comes with ROADMAP Queue 1, slice 6, and
raises here.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
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


def window_triangle_count_sharded(*args, **kwargs):
    """Not ported yet: raises NotImplementedError (ROADMAP Queue 1, slice 6)."""
    raise NotImplementedError(
        "ops.triangles.window_triangle_count_sharded is ported in "
        "ROADMAP Queue 1, slice 6 (multiple devices)"
    )


# --------------------------------------------------------------------- #
# The packed sorted adjacency (streaming exact triangles, k = 2 spanner)
# --------------------------------------------------------------------- #
def ranged_searchsorted(arr, lo, hi, x, *, side: str = "left", steps: int = 32):
    """Elementwise binary search of ``x`` within ``arr[lo:hi)`` (each
    element its own range; ``arr`` ascending within every range): the
    leftmost (``side="left"``) or rightmost insertion position, after a
    fixed ``steps`` halvings (ranges up to 2^steps), as the reference's
    ``fori_loop``."""
    right = side == "right"
    lo = lo.to(torch.int64)
    hi = hi.to(torch.int64)
    last = arr.shape[0] - 1
    for _ in range(steps):
        mid = (lo + hi) >> 1
        v = arr[torch.clamp(mid, 0, last)]
        live = lo < hi
        go_right = ((v <= x) if right else (v < x)) & live
        lo, hi = torch.where(go_right, mid + 1, lo), torch.where(
            live, torch.where(go_right, hi, mid), hi
        )
    return lo.to(torch.int32)


def packed_key(v: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """The int64 composite key ``v << 32 | n`` of (vertex, nbr) pairs (both
    >= 0); over packed columns it ascends as they do."""
    return (v.to(torch.int64) << 32) | n.to(torch.int64)


def _count_composite(sv, sn, v, n, side: str):
    """How many (sv, sn) pairs (sorted, sentinel-padded) compare less [or
    less-or-equal for ``side="right"``] than each (v, n) query."""
    pos = torch.searchsorted(packed_key(sv, sn), packed_key(v, n), right=side == "right")
    return pos.to(torch.int32)


def merge_packed_adjacency(pv, pn, pr, new_v, new_n, new_r, n_new):
    """Merge sorted new (vertex, nbr, rank) entries into the packed sorted
    adjacency: each entry's output position is its own index plus the
    number of entries of the other input before it (a merge path: two
    searches and three scatters, no re-sort of the carried columns).

    Both inputs sorted by (vertex, nbr), ``INT_MAX`` vertex sentinels at
    the tail; real keys disjoint (callers deduplicate); the first
    ``n_new`` new entries are real (a host int or a device scalar). The
    output keeps the capacity ``len(pv)``; positions past it drop into a
    sentinel slot (the reference's ``mode="drop"``)."""
    with _trace.span("tri.merge_packed"):
        cap = pv.shape[0]
        ncap = new_v.shape[0]
        dev = pv.device
        k_old = packed_key(pv, pn)
        k_new = packed_key(new_v, new_n)
        pos_old = torch.arange(cap, device=dev) + torch.searchsorted(k_new, k_old)
        pos_new = torch.arange(ncap, device=dev) + torch.searchsorted(k_old, k_new, right=True)
        pos_old = torch.where(pv == INT_MAX, cap, pos_old).clamp_(max=cap)
        pos_new = torch.where(torch.arange(ncap, device=dev) < n_new, pos_new, cap).clamp_(max=cap)
        out_v = torch.full((cap + 1,), INT_MAX, dtype=torch.int32, device=dev)
        out_n = torch.zeros(cap + 1, dtype=torch.int32, device=dev)
        out_r = torch.zeros(cap + 1, dtype=torch.int32, device=dev)
        for out, old, new in ((out_v, pv, new_v), (out_n, pn, new_n), (out_r, pr, new_r)):
            out[pos_old] = old
            out[pos_new] = new
        return out_v[:cap], out_n[:cap], out_r[:cap]


def _sort_entries(pv_new, pn_new, pr_new):
    """New directed entries sorted by (vertex, nbr): one sort of the
    composite key (the reference's two-key ``lax.sort``)."""
    order = torch.sort(packed_key(pv_new, pn_new)).indices
    return pv_new[order], pn_new[order], pr_new[order]


def row_pointers(pv: torch.Tensor, num_vertices: int) -> torch.Tensor:
    """``row_ptr[v]``: the start of vertex v's run in the packed columns
    (``num_vertices + 1`` entries; the last is the real entry count)."""
    grid = torch.arange(num_vertices + 1, dtype=torch.int32, device=pv.device)
    return torch.searchsorted(pv, grid).to(torch.int32)


def prepare_packed_window(
    pv, pn, pr, src, dst, mask, rank0, num_vertices: int,
    search_steps: int = 32,
):
    """The window prep of streaming exact triangles, all on the device:
    canonicalize the window's edges, drop self-loops, deduplicate within
    the window, reject edges already in the packed adjacency, sort the
    survivors' two directed entries, merge them into the packed columns
    and rebuild the row pointers. Returns ``(pv, pn, pr, row_ptr, qu, qv,
    qrank, qmask)``: the q-columns are the accepted query edges aligned
    with the input slots, ranked ``rank0 + slot``."""
    del search_steps  # the composite-key search covers any row length
    n = src.shape[0]
    dev = src.device
    u, v, m = canonicalize(src, dst, mask)
    u, v, m = dedup_canonical(u, v, m, num_vertices)
    # cross-window duplicates: is (u, v) already an entry of u's row?
    k_old = packed_key(pv, pn)
    key = packed_key(u, v)
    pos = torch.searchsorted(k_old, key).clamp_(max=pv.shape[0] - 1)
    m = m & (k_old[pos] != key)
    qrank = (rank0 + torch.arange(n, dtype=torch.int64, device=dev)).to(torch.int32)
    big = torch.full_like(u, INT_MAX)
    zero = torch.zeros_like(u)
    pv_new = torch.cat([torch.where(m, u, big), torch.where(m, v, big)])
    pn_new = torch.cat([torch.where(m, v, zero), torch.where(m, u, zero)])
    pr_q = torch.where(m, qrank, zero)
    spv, spn, spr = _sort_entries(pv_new, pn_new, torch.cat([pr_q, pr_q]))
    n_new = 2 * m.sum(dtype=torch.int32)
    pv2, pn2, pr2 = merge_packed_adjacency(pv, pn, pr, spv, spn, spr, n_new)
    return pv2, pn2, pr2, row_pointers(pv2, num_vertices), u, v, qrank, m


# Shared packed-adjacency carry helpers (the streaming triangle counter AND
# the k = 2 device spanner: one implementation of the growth, host build,
# class binning and search-step policies).

def grow_packed_columns(pv, pn, pr, need: int, minimum: int = 8, *, device=None):
    """Grow (or create, on ``device``) packed (vertex, nbr, rank) columns to
    a power-of-two capacity covering ``need`` entries; appended ``INT_MAX``
    vertex sentinels keep the sort order."""
    from ..core.edgeblock import bucket_capacity

    cap = bucket_capacity(max(need, minimum))
    if pv is None:
        return (
            torch.full((cap,), INT_MAX, dtype=torch.int32, device=device),
            torch.zeros(cap, dtype=torch.int32, device=device),
            torch.zeros(cap, dtype=torch.int32, device=device),
        )
    old = pv.shape[0]
    if cap <= old:
        return pv, pn, pr
    dev = pv.device
    return (
        torch.cat([pv, torch.full((cap - old,), INT_MAX, dtype=torch.int32, device=dev)]),
        torch.cat([pn, torch.zeros(cap - old, dtype=torch.int32, device=dev)]),
        torch.cat([pr, torch.zeros(cap - old, dtype=torch.int32, device=dev)]),
    )


def build_sorted_directed(u, v, ranks=None, cap=None):
    """Host build of both directed entries of canonical edges,
    (vertex, nbr)-lexsorted and sentinel-padded: the merge input format of
    :func:`merge_packed_adjacency`. Returns numpy ``(pv, pn, pr, n_new)``."""
    from ..core.edgeblock import bucket_capacity

    pv_new = np.concatenate([u, v])
    pn_new = np.concatenate([v, u])
    if ranks is None:
        pr_new = np.zeros(len(pv_new), np.int32)
    else:
        pr_new = np.concatenate([ranks, ranks])
    order = np.lexsort((pn_new, pv_new))
    n_new = len(pv_new)
    ncap = cap if cap is not None else bucket_capacity(n_new, minimum=16)
    pvp = np.full(ncap, INT_MAX, np.int32)
    pnp = np.zeros(ncap, np.int32)
    prp = np.zeros(ncap, np.int32)
    pvp[:n_new] = pv_new[order]
    pnp[:n_new] = pn_new[order]
    prp[:n_new] = pr_new[order]
    return pvp, pnp, prp, n_new


#: min-degree classes coarsen by powers of this factor: a handful of class
#: passes per window for at most CLASS_FACTOR x enumeration-width waste
CLASS_FACTOR = 4

#: [chunk, width] int32 entries budget for dense enumeration blocks
ENUM_BUDGET = 1 << 24  # 64 MB


def degree_class_plan(mindeg, class_factor: int = CLASS_FACTOR,
                      enum_budget: int = ENUM_BUDGET):
    """Group query indices into coarse min-degree classes, on the host.

    Yields ``(width, sel, tcap, chunk)`` per class: ``sel`` the query
    indices (numpy int32), ``tcap`` their power-of-two padding, ``chunk``
    the slice keeping ``[chunk, width]`` within ``enum_budget``."""
    from ..core.edgeblock import bucket_capacity

    fbits = int(class_factor).bit_length() - 1
    exp = np.ceil(
        np.log2(np.maximum(np.maximum(mindeg, 16), 1)) / fbits
    ).astype(np.int64)
    classes = np.int64(1) << (exp * fbits)
    for c in np.unique(classes):
        sel = np.nonzero(classes == c)[0].astype(np.int32)
        tcap = bucket_capacity(len(sel), minimum=16)
        chunk = min(tcap, bucket_capacity(max(enum_budget // int(c), 16)))
        yield int(c), sel, tcap, int(chunk)


def chunked_class_scan(body_fn, carry, sel, chunk: int):
    """Run one degree class's padded selection (``-1`` padding) in
    ``chunk`` slices, ``body_fn(carry, sel_slice) -> carry``: the
    reference's ``lax.scan`` over the slices is a loop here. ``sel``'s
    length and ``chunk`` are powers of two, so the slices are exact."""
    for s_i in sel.reshape(sel.shape[0] // chunk, chunk):
        carry = body_fn(carry, s_i)
    return carry


def sticky_search_steps(current: int, max_degree: int) -> int:
    """Monotone, 8-quantized binary-search step count covering the longest
    adjacency row (the reference's compile-stable policy, kept so the
    packed steps take the reference's arguments)."""
    from ..core.edgeblock import bucket_capacity

    needed = max(4, int(bucket_capacity(max(int(max_degree), 1))).bit_length())
    return max(current, ((needed + 7) // 8) * 8)


def _packed_rows_key(pn: torch.Tensor, row_ptr: torch.Tensor) -> torch.Tensor:
    """The composite key rebuilt from the row pointers (each slot's row is
    the last row starting at or before it; sentinel slots fall in row V)."""
    slots = torch.arange(pn.shape[0], dtype=torch.int32, device=pn.device)
    rows = torch.searchsorted(row_ptr, slots, right=True) - 1
    return packed_key(rows, pn)


def _enumerate_small_rows(pn, row_ptr, qu, qv, qmask, enum_width: int):
    """Each query's smaller-degree endpoint row, enumerated ``enum_width``
    wide: ``(big, idx, valid)`` with ``idx`` the packed slots (clipped)."""
    dev = pn.device
    ql, vl = qu.long(), qv.long()
    d_u = row_ptr[ql + 1] - row_ptr[ql]
    d_v = row_ptr[vl + 1] - row_ptr[vl]
    take_u = d_u <= d_v
    small = torch.where(take_u, qu, qv).long()
    big = torch.where(take_u, qv, qu)
    cols = torch.arange(enum_width, dtype=torch.int32, device=dev)
    idx = row_ptr[small][:, None] + cols[None, :]
    valid = qmask[:, None] & (cols[None, :] < torch.minimum(d_u, d_v)[:, None])
    idx = torch.clamp(idx, 0, pn.shape[0] - 1).long()
    return big, idx, valid


def _row_member(key, big, w):
    """Position of each candidate ``w`` in row ``big[i]`` and whether it is
    there: one search of the composite key."""
    q = packed_key(big[:, None].expand_as(w), w)
    pos = torch.searchsorted(key, q).clamp_(max=key.shape[0] - 1)
    return pos, key[pos] == q


def packed_common_neighbor_exists(
    pn, row_ptr, qu, qv, qmask, enum_width: int, search_steps: int = 32, *,
    key=None,
):
    """For each query pair (qu, qv): do their packed rows share a neighbor?
    The k = 2 reachability test of the device spanner: the smaller row is
    enumerated ``enum_width`` wide (the caller groups queries by min-degree
    class) and searched in the larger. ``key``: the packed composite key,
    when the caller has it (rebuilt from ``row_ptr`` otherwise)."""
    del search_steps
    if key is None:
        key = _packed_rows_key(pn, row_ptr)
    big, idx, valid = _enumerate_small_rows(pn, row_ptr, qu, qv, qmask, enum_width)
    _, found = _row_member(key, big, pn[idx])
    return (valid & found).any(dim=1)


def packed_triangle_update(
    pn, pr, row_ptr,
    qu, qv, qrank, qmask,
    counts,
    enum_width: int,
    search_steps: int = 32,
    *,
    key=None,
):
    """Count triangles closed by query edges against the packed adjacency.

    Each query enumerates the row of its smaller-degree endpoint (the
    caller groups queries into ``enum_width`` classes) and looks each
    candidate ``w`` up in the larger endpoint's row, under the
    closed-by-the-last-edge rule: both closing edges strictly earlier (by
    rank) than the query. Returns ``(counts, delta)``, ``counts`` a new
    tensor. The third-corner scatter adds over the whole ``[chunk, width]``
    block, almost all zeros; the reference sends those to vertex 0, which
    on a card is a storm of atomics on one address, so here they go to
    ``_SPREAD`` scratch slots past the table (the sums are the same), as do
    the masked query lanes' zero adds."""
    del search_steps
    if key is None:
        key = _packed_rows_key(pn, row_ptr)
    dev = pn.device
    big, idx, valid = _enumerate_small_rows(pn, row_ptr, qu, qv, qmask, enum_width)
    w = pn[idx]
    pos, found = _row_member(key, big, w)
    r = qrank[:, None]
    match = valid & found & (pr[idx] < r) & (pr[pos] < r)
    c = match.sum(dim=1, dtype=torch.int32)
    nv = counts.shape[0]
    ext = torch.cat([counts, torch.zeros(_SPREAD, dtype=counts.dtype, device=dev)])
    lanes = torch.arange(w.numel(), dtype=torch.int32, device=dev).view(w.shape)
    w_ids = torch.where(match, w, nv + (lanes & (_SPREAD - 1)))
    ext.index_add_(0, w_ids.reshape(-1).long(), match.reshape(-1).to(counts.dtype))
    cm = torch.where(qmask, c, 0)
    qlane = nv + (torch.arange(qu.shape[0], dtype=torch.int32, device=dev) & (_SPREAD - 1))
    ext.index_add_(0, torch.where(qmask, qu, qlane).long(), cm)
    ext.index_add_(0, torch.where(qmask, qv, qlane).long(), cm)
    return ext[:nv], cm.sum(dtype=torch.int32)
