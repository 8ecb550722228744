"""Collective-communication layer on ``torch.distributed`` (the port's
counterpart of ``gelly_streaming_tpu/parallel/comm.py``).

The reference maps the Flink shuffles onto XLA collectives inside
``shard_map``. Here every rank is one process holding one device, and
:func:`shard_map` is the SPMD frame: it slices the edge-sharded inputs to
this rank's contiguous part, binds the mesh while ``fn`` runs (so the
collectives below find their process group by axis name, as the
reference's find their axis), and assembles the outputs:

- ``P()`` — replicated: every rank returns its own (equal) value;
- ``P(EDGE_AXIS)`` — stacked: an ``all_gather`` of the per-rank values in
  rank order, concatenated along dimension 0.

Mapping of the reference's collectives:

- ``psum``/``pmin``/``pmax`` -> :func:`all_reduce` (``ReduceOp.SUM/MIN/MAX``);
- ``lax.all_gather`` -> :func:`all_gather`;
- the ``ppermute`` butterfly -> :func:`tree_all_reduce`, each exchange a
  pair of ``dist.batch_isend_irecv`` operations;
- ``segment_min``/``segment_sum`` plus a collective ->
  :func:`sharded_segment_min` / :func:`sharded_segment_sum`.

Under autograd (the training step, where the reference differentiates
through ``shard_map`` and XLA transposes each collective), three
collectives carry their transposes:

- :func:`sum_over` — forward all-reduce-sum, backward identity: where a
  rank-partial value becomes replicated (the edge scatter's sums);
- :func:`copy_over` — forward identity, backward all-reduce-sum: on a
  replicated tensor just before a rank-varying use (the gather over this
  rank's edges, a column-sharded matmul);
- :func:`gather_columns` — forward all-gather along the last dimension,
  backward this rank's chunk: a column-sharded output made whole.

Each resolves its process group when the forward runs and keeps it for
the backward, which on the card runs on autograd's own thread, outside
the :func:`bind` of the forward.

Transport. NCCL takes every operation here on CUDA tensors, and gloo
takes its collectives (all-reduce, all-gather) on them as they are. The
butterfly's point-to-point exchange is the one gloo path that goes
through host memory: a CUDA buffer is copied to the host, exchanged and
copied back, and :data:`STAGED` counts each such buffer (the compute
stays on the card). Bool leaves travel as uint8.
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
import warnings
from typing import Any, Callable

import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree

from .mesh import EDGE_AXIS, P, mesh_shape

#: the mesh bound by the enclosing :func:`shard_map` (the axis context)
_BOUND: contextvars.ContextVar = contextvars.ContextVar("mesh", default=None)

#: collective operations issued by this process, by op ("all_reduce",
#: "all_gather", "p2p"): a run that should have crossed the mesh shows here
CALLS: collections.Counter = collections.Counter()
#: gloo operations on CUDA tensors that went through host memory, by op
STAGED: collections.Counter = collections.Counter()
#: the bytes those operations moved each way, by op
STAGED_BYTES: collections.Counter = collections.Counter()

_OPS = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN, "max": dist.ReduceOp.MAX}


def reset_counters() -> None:
    """Zero :data:`CALLS`, :data:`STAGED` and :data:`STAGED_BYTES`."""
    CALLS.clear()
    STAGED.clear()
    STAGED_BYTES.clear()


@contextlib.contextmanager
def bind(mesh):
    """Bind ``mesh`` as the axis context of the collectives (what
    :func:`shard_map` does around its function)."""
    token = _BOUND.set(mesh)
    try:
        yield mesh
    finally:
        _BOUND.reset(token)


def _group(axis_name: str):
    mesh = _BOUND.get()
    if mesh is None:
        raise RuntimeError(
            f"the {axis_name!r} collectives run inside shard_map (no mesh "
            "is bound)")
    return mesh.get_group(axis_name)


def _staged_p2p(group, t: torch.Tensor) -> bool:
    """Whether a point-to-point buffer goes through host memory (a CUDA
    tensor under gloo), counted."""
    if not t.is_cuda or dist.get_backend(group) != "gloo":
        return False
    STAGED["p2p"] += 1
    STAGED_BYTES["p2p"] += t.numel() * t.element_size()
    return True


def _wire(t: torch.Tensor) -> torch.Tensor:
    """A contiguous buffer the backends take (bool as uint8)."""
    t = t.contiguous()
    return t.view(torch.uint8) if t.dtype == torch.bool else t


def _unwire(buf: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return buf.view(torch.bool) if like.dtype == torch.bool else buf


# --------------------------------------------------------------------------- #
# The SPMD frame
# --------------------------------------------------------------------------- #
def _is_edge(spec) -> bool:
    return isinstance(spec, P) and len(spec) > 0 and spec[0] == EDGE_AXIS


def _shard_leaf(x, spec, r: int, p: int):
    from torch.distributed.tensor import DTensor

    if isinstance(x, DTensor):
        # a globally assembled column (multihost.global_edge_block): the
        # local part IS this rank's shard
        return x.to_local() if _is_edge(spec) else x.full_tensor()
    if not _is_edge(spec) or not isinstance(x, torch.Tensor):
        return x
    n = x.shape[0]
    if n % p:
        raise ValueError(
            f"an edge-sharded dimension of {n} does not divide by the "
            f"{p}-wide edge axis")
    c = n // p
    return x[r * c:(r + 1) * c]


def _shard_arg(arg, spec, r: int, p: int):
    if isinstance(spec, P):
        return pytree.tree_map(lambda x: _shard_leaf(x, spec, r, p), arg)
    return pytree.tree_map(
        lambda x, s: _shard_leaf(x, s, r, p), arg, spec,
        is_leaf=lambda s: isinstance(s, P))


def _stack_leaf(x, spec, group):
    if not _is_edge(spec):
        return x
    return _gather_cat(x, group)


def shard_map(f: Callable, mesh, in_specs, out_specs, check_vma: bool = False):
    """Run ``f`` on this rank's part of the inputs with ``mesh`` bound.

    ``in_specs`` has one spec per positional argument (a spec, or a spec
    pytree matching the argument); ``P(EDGE_AXIS)`` leaves are sliced to
    this rank's contiguous part of their leading dimension, ``P()``
    leaves pass through. ``out_specs`` says per output leaf whether it is
    replicated (``P()``) or stacked over the edge axis (``P(EDGE_AXIS)``:
    all-gathered in rank order). ``check_vma`` is accepted for the
    reference's signature."""
    def wrapped(*args):
        r = mesh.get_local_rank(EDGE_AXIS)
        p = mesh_shape(mesh)[EDGE_AXIS]
        local = [_shard_arg(a, s, r, p) for a, s in zip(args, in_specs)]
        with bind(mesh):
            out = f(*local)
            group = mesh.get_group(EDGE_AXIS)
            if isinstance(out_specs, P):
                return pytree.tree_map(
                    lambda x: _stack_leaf(x, out_specs, group), out)
            return pytree.tree_map(
                lambda x, s: _stack_leaf(x, s, group), out, out_specs,
                is_leaf=lambda s: isinstance(s, P))

    return wrapped


# --------------------------------------------------------------------------- #
# Flat collectives
# --------------------------------------------------------------------------- #
def _all_reduce_leaf(x: torch.Tensor, group, op) -> torch.Tensor:
    buf = x.clone(memory_format=torch.contiguous_format)
    CALLS["all_reduce"] += 1
    dist.all_reduce(buf, op=op, group=group)
    return buf


def all_reduce(x: Any, axis_name: str, op: str = "sum") -> Any:
    """All-reduce a pytree across a mesh axis (sum/min/max); returns new
    tensors."""
    if op not in _OPS:
        raise ValueError(f"unknown all_reduce op {op!r}")
    group = _group(axis_name)
    return pytree.tree_map(lambda t: _all_reduce_leaf(t, group, _OPS[op]), x)


def _gather_list(x: torch.Tensor, group) -> list:
    buf = _wire(x)
    outs = [torch.empty_like(buf) for _ in range(dist.get_world_size(group))]
    CALLS["all_gather"] += 1
    dist.all_gather(outs, buf, group=group)
    return [_unwire(o, x) for o in outs]


def _gather_cat(x: torch.Tensor, group) -> torch.Tensor:
    return torch.cat(_gather_list(x, group))


def all_gather(x: Any, axis_name: str, axis: int = 0, tiled: bool = False) -> Any:
    """Every rank's ``x`` in rank order: stacked on a new ``axis``, or
    concatenated along it with ``tiled``."""
    group = _group(axis_name)
    join = torch.cat if tiled else torch.stack
    return pytree.tree_map(lambda t: join(_gather_list(t, group), dim=axis), x)


# --------------------------------------------------------------------------- #
# Collectives under autograd (the training step)
# --------------------------------------------------------------------------- #
def remat(fn: Callable, *args, **kwargs):
    """``fn(*args, **kwargs)`` with its activations recomputed in the
    backward (``torch.utils.checkpoint``, non-reentrant; the reference's
    ``jax.checkpoint``). The mesh bound now is bound again while the
    recomputation runs, so its collectives find their groups there too."""
    from torch.utils.checkpoint import checkpoint

    mesh = _BOUND.get()
    return checkpoint(fn, *args, use_reentrant=False,
                      context_fn=lambda: (contextlib.nullcontext(), bind(mesh)),
                      **kwargs)


def _records(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


class _SumOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce_leaf(x, group, dist.ReduceOp.SUM)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce_leaf(g, ctx.group, dist.ReduceOp.SUM), None


class _GatherColumns(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.index = dist.get_rank(group)
        ctx.width = x.shape[-1]
        return torch.cat(_gather_list(x, group), dim=-1)

    @staticmethod
    def backward(ctx, g):
        lo = ctx.index * ctx.width
        return g[..., lo:lo + ctx.width].contiguous(), None


def sum_over(x: torch.Tensor, axis_name: str) -> torch.Tensor:
    """All-reduce-sum ``x`` over ``axis_name``; its gradient passes through
    unchanged (each rank's partial gets the replicated sum's gradient).
    Outside a recorded graph this is :func:`all_reduce`."""
    if not _records(x):
        return all_reduce(x, axis_name)
    return _SumOver.apply(x, _group(axis_name))


def copy_over(x: torch.Tensor, axis_name: str) -> torch.Tensor:
    """``x`` itself forward; its gradient is all-reduce-summed over
    ``axis_name`` (each rank's use contributes a partial). No collective
    runs outside a recorded graph."""
    if not _records(x):
        return x
    return _CopyOver.apply(x, _group(axis_name))


def gather_columns(x: torch.Tensor, axis_name: str) -> torch.Tensor:
    """Every rank's ``x`` along ``axis_name``, concatenated in rank order
    along the last dimension; the gradient keeps this rank's columns."""
    return _GatherColumns.apply(x, _group(axis_name))


def axis_index(axis_name: str) -> int:
    return dist.get_rank(_group(axis_name))


def axis_size(axis_name: str) -> int:
    return dist.get_world_size(_group(axis_name))


# --------------------------------------------------------------------------- #
# Tree reduction: the butterfly, parity with SummaryTreeReduce
# --------------------------------------------------------------------------- #
def _index(tree, i):
    return pytree.tree_map(lambda x: x[i], tree)


def stacked_reduce(stacked: Any, n: int, combine: Callable[[Any, Any], Any]) -> Any:
    """Log-depth fold of ``n`` stacked partials (leading axis) with an
    arbitrary pytree ``combine`` — the bulk engine's cross-shard merge.
    Odd counts carry the tail partial into the next level. The reference
    ``vmap``s ``combine`` over the pairs of a level; here each pair is
    one call (the combines read their fixpoint conditions on the host)."""
    while n > 1:
        half = n // 2
        merged = [combine(_index(stacked, i), _index(stacked, half + i))
                  for i in range(half)]
        merged = pytree.tree_map(lambda *xs: torch.stack(xs), *merged)
        if n % 2:
            stacked = pytree.tree_map(
                lambda m, x: torch.cat([m, x[2 * half: n]]), merged, stacked)
            n = half + 1
        else:
            stacked = merged
            n = half
    return _index(stacked, 0)


def validate_tree_degree(n_shards: int, degree: int) -> None:
    """The degree-d butterfly needs the axis size to be a power of the
    degree; callable eagerly (stream setup) so a misconfiguration fails
    before any window runs, whichever carry ends up executing."""
    if degree < 2:
        raise ValueError(f"tree_all_reduce degree must be >= 2, got {degree}")
    total = 1
    while total < n_shards:
        total *= degree
    if total != n_shards:
        raise ValueError(
            f"tree_all_reduce requires the axis size ({n_shards}) to be a "
            f"power of the tree degree ({degree}); use degree=2 for "
            "power-of-two meshes"
        )


def resolve_tree_degree(n_shards: int, degree: int) -> int:
    """Effective butterfly fan-in for this mesh: ``degree`` when the axis
    size is a power of it, else 2 (which fits every power-of-two mesh)
    with a warning, the reference's warn-and-run posture. ``degree < 2``
    raises."""
    if degree < 2:
        raise ValueError(f"tree_all_reduce degree must be >= 2, got {degree}")
    total = 1
    while total < n_shards:
        total *= degree
    if total == n_shards:
        return degree
    warnings.warn(
        f"tree degree {degree} does not fit the {n_shards}-shard edge "
        "axis (axis size must be a power of the degree); falling back "
        "to the degree-2 butterfly",
        stacklevel=2,
    )
    return 2


def _exchange(x: Any, dst: int, src: int, group) -> Any:
    """Send every leaf of ``x`` to group rank ``dst`` and receive the
    same-shaped leaves from ``src`` (one ``batch_isend_irecv``)."""
    leaves, spec = pytree.tree_flatten(x)
    sends = [_wire(t) for t in leaves]
    if any([_staged_p2p(group, t) for t in sends]):
        sends = [t.cpu() for t in sends]
    recvs = [torch.empty_like(t) for t in sends]
    g_dst = dist.get_global_rank(group, dst)
    g_src = dist.get_global_rank(group, src)
    ops = [dist.P2POp(dist.isend, t, g_dst, group) for t in sends]
    ops += [dist.P2POp(dist.irecv, t, g_src, group) for t in recvs]
    CALLS["p2p"] += len(ops)
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    out = [_unwire(r.to(t.device), t) for r, t in zip(recvs, leaves)]
    return pytree.tree_unflatten(out, spec)


def tree_all_reduce(
    x: Any,
    axis_name: str,
    combine: Callable[[Any, Any], Any],
    n_shards: int,
    degree: int = 2,
) -> Any:
    """Butterfly all-reduce with an arbitrary combine and fan-in
    ``degree`` (the reference's ``SummaryTreeReduce.enhance()`` as a
    degree-d butterfly): at round r the shards split into groups of
    ``degree`` (stride ``degree**r``); every shard receives the other
    ``degree - 1`` members' ROUND-START partials and folds them in, so
    after ``log_degree(p)`` rounds every shard holds the global combine.
    ``combine`` must be associative and commutative (each shard folds in
    its own order). ``n_shards`` must be a power of ``degree``."""
    validate_tree_degree(n_shards, degree)
    group = _group(axis_name)
    me = dist.get_rank(group)
    span_lo = 1
    while span_lo < n_shards:
        span = span_lo * degree
        # exchange the ROUND-START partial: accumulating into the source
        # would ship partially combined values on later exchanges
        x0 = x
        hi, rem = divmod(me, span)
        pos, lo = divmod(rem, span_lo)
        for j in range(1, degree):
            # shard i = hi*span + pos*group + lo receives the partial of
            # the group member at position (pos - j) mod degree
            dst = hi * span + ((pos + j) % degree) * span_lo + lo
            src = hi * span + ((pos - j) % degree) * span_lo + lo
            x = combine(x, _exchange(x0, dst, src, group))
        span_lo = span
    return x


# --------------------------------------------------------------------------- #
# Sharded segment reduction
# --------------------------------------------------------------------------- #
def _segment_identity(dtype: torch.dtype, op: str):
    if dtype.is_floating_point:
        return float("inf") if op == "min" else 0.0
    return torch.iinfo(dtype).max if op == "min" else 0


def sharded_segment_min(values: torch.Tensor, segment_ids: torch.Tensor,
                        num_segments: int, axis_name: str) -> torch.Tensor:
    """Per-shard scatter-min into a replicated table, then a MIN
    all-reduce (empty segments hold the dtype's max, as
    ``jax.ops.segment_min`` gives them)."""
    local = torch.full((num_segments,) + tuple(values.shape[1:]),
                       _segment_identity(values.dtype, "min"),
                       dtype=values.dtype, device=values.device)
    idx = segment_ids.long().view((-1,) + (1,) * (values.dim() - 1)).expand_as(values)
    local.scatter_reduce_(0, idx, values, reduce="amin", include_self=True)
    return all_reduce(local, axis_name, op="min")


def sharded_segment_sum(values: torch.Tensor, segment_ids: torch.Tensor,
                        num_segments: int, axis_name: str) -> torch.Tensor:
    """Per-shard ``index_add_`` into a replicated table, then a SUM
    all-reduce."""
    local = torch.zeros((num_segments,) + tuple(values.shape[1:]),
                        dtype=values.dtype, device=values.device)
    local.index_add_(0, segment_ids.long(), values)
    return all_reduce(local, axis_name, op="sum")
