"""Training for the GNN families (GraphSAGE and GCN), on one device or
across the mesh.

The counterpart of ``gelly_streaming_tpu/models/training.py``. One
factory of steps covers any layer-stack forward with the
``(params_stack, h, src, dst, mask, *, remat)`` signature
(:func:`.graphsage.sage_forward`,
:func:`.gcn.gcn_forward`): the loss's gradients by autograd, then plain
SGD or a ``torch.optim`` optimizer (the counterpart of an optax
transformation), with optional per-layer recomputation.

Across a mesh the step is SPMD, one process a rank: the edge columns
split over ``"edges"`` (data parallel), every weight's output columns over
``"model"`` (tensor parallel, :func:`shard_gnn_params`), and the forward
takes the axis names, whose collectives carry their transposes
(``parallel/comm.py``: ``sum_over``, ``copy_over``, ``gather_columns``).
Every rank ends a step with the same loss and with its slice of the
parameters the single-device step would hold. A mesh whose axes are both
1 is the single-device step.

Mixed precision is the reference's: each step takes an f32 copy of the
parameters, updates it with the f32 gradients and casts it back to the
parameter dtype; no f32 master persists between steps. An optimizer owns
persistent f32 buffers: each step copies the parameters into them, sets
their ``.grad``, calls ``step()`` and returns them cast back.

Deliberate differences from the reference: ``optimizer`` is a factory
``params -> torch.optim.Optimizer`` (``lambda ps: torch.optim.Adam(ps,
lr=1e-2)`` for ``optax.adam(1e-2)``: the same defaults, 0.9, 0.999, eps
1e-8 outside the square root), and its state (:class:`OptState`) is
updated in place and returned; the step returns new parameter tensors and
leaves its other inputs as they were.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from ..parallel import comm
from ..parallel.mesh import EDGE_AXIS, MODEL_AXIS, P, mesh_shape


def mse_loss(out, targets):
    return torch.mean((out.float() - targets.float()) ** 2)


def softmax_xent_loss(out, targets):
    """``targets`` are int class ids over the vertex axis."""
    logp = torch.log_softmax(out.float(), dim=-1)
    return -torch.mean(logp.gather(-1, targets.long()[:, None]))


def _model_slot(mesh) -> Tuple[int, int]:
    """(this rank's index, size) along the mesh's model axis; (0, 1)
    without a mesh."""
    if mesh is None:
        return 0, 1
    return mesh.get_local_rank(MODEL_AXIS), mesh_shape(mesh)[MODEL_AXIS]


def shard_gnn_params(params_stack, mesh):
    """This rank's part of a layer stack on the mesh: every 2-D weight keeps
    the contiguous output columns ``[:, r*O/m:(r+1)*O/m]`` of its model
    rank ``r`` of ``m``, every 1-D bias the same slice (the reference's
    ``P(None, "model")`` and ``P("model")``). With a 1-wide model axis (or
    no mesh) the stack is returned as it is. :func:`gather_gnn_params`
    all-gathers the whole stack back on every rank."""
    r, m = _model_slot(mesh)
    if m == 1:
        return params_stack

    def part(leaf):
        cols = leaf.shape[-1]
        if cols % m:
            raise ValueError(
                f"shard_gnn_params: {cols} output features do not divide over "
                f"the {m}-wide model axis")
        c = cols // m
        return leaf[..., r * c:(r + 1) * c].clone(memory_format=torch.contiguous_format)

    return [{k: part(v) for k, v in layer.items()} for layer in params_stack]


def gather_gnn_params(params_stack, mesh):
    """The whole stack from every model rank's part (the inverse of
    :func:`shard_gnn_params`): an all-gather along the last dimension over
    the model axis, in rank order. Every rank of the mesh calls it."""
    _, m = _model_slot(mesh)
    if m == 1:
        return params_stack
    with comm.bind(mesh), torch.no_grad():
        return [{k: comm.gather_columns(v, MODEL_AXIS) for k, v in layer.items()}
                for layer in params_stack]


class OptState:
    """An optimizer's state across steps: the persistent f32 buffers it
    updates and the optimizer made on them by the caller's factory."""

    def __init__(self, factory: Callable, params_stack):
        self.buffers = [v.detach().float().clone() for layer in params_stack
                        for v in layer.values()]
        self.optimizer = factory(self.buffers)


def _axes(mesh) -> dict:
    """The forward's axis keywords under ``mesh``: an axis of size 1 needs
    no collective and is left out, so a 1 x 1 mesh (or none) gives ``{}``,
    the single-device step."""
    if mesh is None:
        return {}
    shape = mesh_shape(mesh)
    axes = {}
    if shape[EDGE_AXIS] > 1:
        axes["axis_name"] = EDGE_AXIS
    if shape[MODEL_AXIS] > 1:
        axes["model_axis"] = MODEL_AXIS
    return axes


def make_sharded_train_step(
    mesh,
    forward_fn: Callable,
    *,
    lr: float = 1e-2,
    optimizer: Optional[Callable] = None,
    loss_fn: Callable = mse_loss,
    remat: bool = False,
) -> Tuple[Callable, Callable, Callable]:
    """Build a training step for a GNN layer stack over ``mesh`` (None:
    one device).

    Returns ``(step_fn, shard_params_fn, init_opt_fn)``:

    - ``step_fn(params, opt_state, h, src, dst, mask, targets) ->
      (params, opt_state, loss)``: new parameter tensors (this rank's
      slices under a model axis), the optimizer state, and the loss as a
      0-d tensor on the device (the step reads nothing on the host);
    - ``shard_params_fn(params) -> params``: this rank's slices
      (:func:`shard_gnn_params`);
    - ``init_opt_fn(params) -> opt_state``: an :class:`OptState`, or
      ``None`` for plain SGD.

    ``optimizer`` is a factory ``list of f32 tensors -> torch.optim
    optimizer``; when omitted, plain SGD with ``lr``. Under a mesh every
    rank calls ``step_fn`` with the same whole ``h``, edge columns and
    ``targets``; the edge columns' length must divide by the edge axis.
    """
    axes = _axes(mesh)

    def shard_params(params_stack):
        return shard_gnn_params(params_stack, mesh)

    def init_opt(params_stack):
        if optimizer is None:
            return None
        return OptState(optimizer, params_stack)

    def local_step(params, opt_state, h, src, dst, mask, targets):
        with torch.enable_grad():
            leaves = [{k: v.detach().requires_grad_() for k, v in layer.items()}
                      for layer in params]
            out = forward_fn(leaves, h, src, dst, mask, remat=remat, **axes)
            loss = loss_fn(out, targets)
            flat = [v for layer in leaves for v in layer.values()]
            grads = torch.autograd.grad(loss, flat)
        with torch.no_grad():
            if opt_state is None:
                new = [(p.float() - lr * g.float()).to(p.dtype)
                       for p, g in zip(flat, grads)]
            else:
                for buf, p, g in zip(opt_state.buffers, flat, grads):
                    buf.copy_(p)
                    buf.grad = g.float()
                opt_state.optimizer.step()
                new = [buf.to(p.dtype, copy=True)
                       for buf, p in zip(opt_state.buffers, flat)]
        it = iter(new)
        new_params = [{k: next(it) for k in layer} for layer in params]
        return new_params, opt_state, loss.detach()

    if not axes:
        return local_step, shard_params, init_opt

    def step(params, opt_state, h, src, dst, mask, targets):
        def shard_fn(params, h, src, dst, mask, targets):
            return local_step(params, opt_state, h, src, dst, mask, targets)

        edge = P(EDGE_AXIS)
        return comm.shard_map(
            shard_fn, mesh, (P(), P(), edge, edge, edge, P()), P(),
        )(params, h, src, dst, mask, targets)

    return step, shard_params, init_opt

