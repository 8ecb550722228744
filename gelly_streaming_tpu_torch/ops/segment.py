"""Segment reductions: per-key window state as tensor operations (PyTorch port).

The counterpart of ``gelly_streaming_tpu/ops/segment.py``. Every
neighborhood aggregation of the reference is a per-key fold over the
window's records (``SnapshotStream.java:61-181``); here it is a *segment
reduction* over a padded edge block: vertex id = segment id, edge value =
element. Three tiers, fastest first:

1. :func:`segment_reduce` — the monoids sum/min/max/prod as one scatter
   (``index_add_`` / ``scatter_reduce_``) into an output filled with the
   op's identity first, so empty segments hold what ``jax.ops.segment_*``
   gives them (0, dtype max, dtype min or -inf, 1).
2. :func:`segmented_reduce_generic` — any *associative* ``combine`` by a
   log-depth segmented scan (Hillis-Steele doubling over edges sorted by
   segment, a start flag blocking combination across segments): about
   log2(E) vectorized calls of ``combine``. ``lax.associative_scan`` of the
   reference combines in another tree, so integer results are equal and
   float results differ by association order only.
3. :func:`segmented_fold` — any (non-associative, order-dependent) fold in
   arrival order. The reference scans the window's E edges one by one
   (``lax.scan``); here the fold runs in *lockstep across segments*: turn
   ``t`` applies ``fold_fn``, lifted with :func:`torch.func.vmap`, to the
   ``t``-th edge of every segment that has one. The order inside each
   segment is the arrival order, exactly; the depth is the longest
   segment, not E, and the work is E calls' worth in total
   (:data:`FOLD_TURNS` counts the turns).

All functions take padded blocks (mask-aware) and a host ``num_segments``.
Integer outputs keep the reference's dtypes (int32 counts and offsets).
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch
from torch.func import vmap
from torch.utils import _pytree as pytree

from ..obs import trace as _trace

INT_MAX = int(np.iinfo(np.int32).max)

#: lockstep turns run by :func:`segmented_fold` (one ``fold_fn`` call each)
FOLD_TURNS = 0


def _identity(op: str, dtype: torch.dtype):
    """The value ``jax.ops.segment_<op>`` leaves in an empty segment."""
    if op in ("sum",):
        return 0
    if op == "prod":
        return 1
    if dtype.is_floating_point:
        return float("inf") if op == "min" else float("-inf")
    if dtype == torch.bool:
        return op == "min"
    info = torch.iinfo(dtype)
    return info.max if op == "min" else info.min


def _masked_ids(segment_ids: torch.Tensor, mask: torch.Tensor, sentinel: int) -> torch.Tensor:
    """Segment ids as int64 scatter indices, padding routed to ``sentinel``
    (the reference's ``mode="drop"`` slot)."""
    return torch.where(mask, segment_ids.long(), sentinel)


def segment_reduce(
    values: torch.Tensor,
    segment_ids: torch.Tensor,
    mask: torch.Tensor,
    num_segments: int,
    op: str = "sum",
) -> torch.Tensor:
    """Masked monoid segment reduction (tier 1).

    Padding rows go to a sentinel segment (``num_segments``) that is cut
    off, so they never contribute. Every segment starts at the op's
    identity, so an empty segment holds what the reference's
    ``jax.ops.segment_<op>`` gives it. ``values`` may carry trailing dims.
    """
    with _trace.span("segment.reduce"):
        if op not in ("sum", "min", "max", "prod"):
            raise ValueError(f"unknown monoid {op!r}")
        ids = _masked_ids(segment_ids, mask, num_segments)
        shape = (num_segments + 1,) + tuple(values.shape[1:])
        out = torch.full(shape, _identity(op, values.dtype), dtype=values.dtype,
                         device=values.device)
        if op == "sum":
            out.index_add_(0, ids, values)
        else:
            index = ids.view((-1,) + (1,) * (values.dim() - 1)).expand_as(values)
            reduce = {"min": "amin", "max": "amax", "prod": "prod"}[op]
            out.scatter_reduce_(0, index, values, reduce=reduce, include_self=True)
        return out[:num_segments]


def segment_count(segment_ids: torch.Tensor, mask: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Per-segment element count, int32 (degree computation). A scatter-add
    of ones, never ``bincount``, which reads its size back to the host on a
    card."""
    with _trace.span("segment.count"):
        ids = _masked_ids(segment_ids, mask, num_segments)
        out = torch.zeros(num_segments + 1, dtype=torch.int32, device=segment_ids.device)
        out.index_add_(0, ids, torch.ones_like(ids, dtype=torch.int32))
        return out[:num_segments]


# --------------------------------------------------------------------------- #
# Sorting edges by segment (shared by tiers 2-3 and CSR building)
# --------------------------------------------------------------------------- #
def sort_by_segment(
    segment_ids: torch.Tensor, mask: torch.Tensor, *arrays: Any
) -> Tuple[Any, ...]:
    """Stable-sort edge arrays (tensors or pytrees of tensors) by masked
    segment id. Padding gets ``INT_MAX`` so it sorts last; arrival order
    within a segment is kept.

    Returns ``(sorted_ids, sorted_mask, *sorted_arrays)``; ``sorted_ids``
    keeps the dtype of ``segment_ids``."""
    with _trace.span("segment.sort"):
        ids = torch.where(mask, segment_ids, torch.full_like(segment_ids, INT_MAX))
        sorted_ids, order = torch.sort(ids, stable=True)
        return (sorted_ids, mask[order]) + tuple(
            pytree.tree_map(lambda a: a[order], arr) for arr in arrays
        )


def _segment_last_index(sorted_ids: torch.Tensor, num_segments: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """For each segment: the index of its last element, and whether it is
    nonempty."""
    seg = torch.arange(num_segments, dtype=sorted_ids.dtype, device=sorted_ids.device)
    right = torch.searchsorted(sorted_ids, seg, right=True)
    left = torch.searchsorted(sorted_ids, seg)
    nonempty = right > left
    last = torch.clamp(right - 1, 0, sorted_ids.shape[0] - 1)
    return last, nonempty


def _bcast(flag: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """Broadcast a bool flag vector against a value of any rank."""
    extra = like.dim() - flag.dim()
    if extra > 0:
        flag = flag.reshape(tuple(flag.shape) + (1,) * extra)
    return flag


def segmented_reduce_generic(
    values: Any,
    segment_ids: torch.Tensor,
    mask: torch.Tensor,
    num_segments: int,
    combine: Callable[[Any, Any], Any],
) -> Tuple[Any, torch.Tensor]:
    """Arbitrary associative segmented reduction (tier 2).

    ``combine(a, b) -> c`` (``a`` the earlier elements, ``b`` the later)
    must be associative over the value pytree and written with torch
    operations that work elementwise on a leading edge dim. Returns
    ``(per_segment_result, nonempty)``; rows of empty segments hold
    whatever the scan left there and must be gated by ``nonempty``.

    Mechanism: sort by segment, then the segmented Hillis-Steele scan: at
    distance ``d`` (1, 2, 4, ...) every element not blocked by a start flag
    within ``d`` takes ``combine(x[i - d], x[i])``. After log2(E) rounds each
    element holds the reduction of its segment's prefix; each segment's
    last element is its result.
    """
    with _trace.span("segment.scan"):
        sorted_ids, _sorted_mask, vals = sort_by_segment(segment_ids, mask, values)
        n = sorted_ids.shape[0]
        flags = torch.ones(n, dtype=torch.bool, device=sorted_ids.device)
        flags[1:] = sorted_ids[1:] != sorted_ids[:-1]
        d = 1
        while d < n:
            head = pytree.tree_map(lambda a: a[:-d], vals)
            tail = pytree.tree_map(lambda a: a[d:], vals)
            merged = combine(head, tail)
            blocked = flags[d:]
            new_tail = pytree.tree_map(
                lambda m, t: torch.where(_bcast(blocked, t), t, m), merged, tail
            )
            vals = pytree.tree_map(
                lambda a, t: torch.cat([a[:d], t]), vals, new_tail
            )
            flags = torch.cat([flags[:d], flags[d:] | flags[:-d]])
            d *= 2
        last, nonempty = _segment_last_index(sorted_ids, num_segments)
        return pytree.tree_map(lambda a: a[last], vals), nonempty


def _as_leaf(x, device) -> torch.Tensor:
    """An init leaf as a tensor with the reference's default dtypes (x64
    off: Python ints are int32, floats float32)."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    a = np.asarray(x)
    if a.dtype == np.int64:
        a = a.astype(np.int32)
    elif a.dtype == np.float64:
        a = a.astype(np.float32)
    return torch.as_tensor(a, device=device)


def _write_turn(acc: torch.Tensor, new: torch.Tensor) -> None:
    """Store one turn's results into the accumulator rows it read. The
    carry keeps its dtype, as ``lax.scan``'s does: a ``fold_fn`` that
    changes it is an error there and here."""
    if new.dtype != acc.dtype:
        raise TypeError(
            f"fold_fn changed an accumulator leaf from {acc.dtype} to "
            f"{new.dtype}; give the initial value the result's dtype"
        )
    acc.copy_(new)


def segmented_fold(
    init: Any,
    fold_fn: Callable[[Any, torch.Tensor, torch.Tensor, Any], Any],
    segment_ids: torch.Tensor,
    neighbor_ids: torch.Tensor,
    values: Any,
    mask: torch.Tensor,
    num_segments: int,
    id_of_segment: Optional[torch.Tensor] = None,
    id_of_neighbor: Optional[torch.Tensor] = None,
    counts_host: Optional[np.ndarray] = None,
) -> Tuple[Any, torch.Tensor]:
    """Arbitrary per-edge fold in arrival order (tier 3), in lockstep.

    ``fold_fn(accum, vertex_id, neighbor_id, edge_value) -> accum`` is the
    ``EdgesFold.foldEdges`` analog (``EdgesFold.java:33-47``), written with
    torch operations for ONE edge; it is lifted with
    :func:`torch.func.vmap` over the segments of a turn, so it may not
    branch on data (use ``torch.where``), call ``.item()`` or write in
    place into its inputs. ``id_of_segment``/``id_of_neighbor`` map compact
    indices to raw ids (int32 tables) so the UDF sees the reference's ids.

    Turn ``t`` folds the ``t``-th edge (in arrival order) of every segment
    with more than ``t`` edges; segments are ordered by descending count,
    so those are a prefix. The turn count is the longest segment.
    ``counts_host`` (the per-segment element counts as a host array) plans
    the turns without reading the device; when omitted, the counts are
    read back once.

    Returns ``(per_segment_accum, nonempty)``; empty segments hold ``init``.
    """
    global FOLD_TURNS
    with _trace.span("segment.fold"):
        device = segment_ids.device
        _sid, _smask, sorted_nbr, sorted_vals = sort_by_segment(
            segment_ids, mask, neighbor_ids, values
        )
        counts = segment_count(segment_ids, mask, num_segments)
        if counts_host is None:
            counts_host = counts.cpu().numpy()
        counts_host = np.asarray(counts_host)
        # segments by descending count: the segments alive at turn t are the
        # first alive[t] of them
        order = torch.sort(counts, descending=True, stable=True).indices
        row_ptr = (torch.cumsum(counts, 0, dtype=torch.int64) - counts)[order]
        longest = int(counts_host.max()) if counts_host.size else 0
        alive = np.bincount(counts_host, minlength=longest + 1)[::-1].cumsum()[::-1]
        n_edges = sorted_nbr.shape[0]
        vid_all = order.to(torch.int32) if id_of_segment is None else id_of_segment[order]
        acc = pytree.tree_map(
            lambda i: _as_leaf(i, device).expand((num_segments,) + tuple(np.shape(i))).clone(),
            init,
        )
        lifted = vmap(fold_fn)
        for t in range(longest):
            k = int(alive[t + 1])  # segments with more than t edges
            idx = torch.clamp(row_ptr[:k] + t, max=n_edges - 1)
            nbr = sorted_nbr[idx]
            nid = nbr if id_of_neighbor is None else id_of_neighbor[nbr]
            val = pytree.tree_map(lambda a: a[idx], sorted_vals)
            head = pytree.tree_map(lambda a: a[:k], acc)
            new = lifted(head, vid_all[:k], nid, val)
            pytree.tree_map(_write_turn, head, new)
            FOLD_TURNS += 1
        result = pytree.tree_map(
            lambda a: torch.empty_like(a).index_copy_(0, order, a), acc
        )
        return result, counts > 0
