"""Streaming GCN layers (Kipf-Welling symmetric normalization).

The counterpart of ``gelly_streaming_tpu/models/gcn.py``, the second GNN
family beside GraphSAGE (:mod:`.graphsage`): the layer is
``act(D^-1/2 (A+I) D^-1/2 H W + b)`` over the accumulated edge list, the
same message passing (a gather of ``h`` at the edges' ends and an
``index_add_`` scatter) and one matmul. Degrees stay in ``h.dtype`` as
the reference keeps them (bf16 degrees round above 256); the product is
f32 (``agg.float() @ w.float()``), then the f32 bias, the activation and
the cast back. The reference computes that product in XLA, outside any
Pallas kernel, so here it is a torch matmul.

Under the training step's ``shard_map`` (``axis_name``, ``model_axis``)
each rank scatters its edge slice's messages, the partial degrees
all-reduce over the edge axis (they carry no gradient) and the messages
through :func:`~..parallel.comm.sum_over`; the weights hold this rank's
output columns and the output is gathered whole, as in
:func:`.graphsage.sage_layer`.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, List

import torch

from ..core.device import DEFAULT_DEVICE, resolve_device
from ..parallel import comm


def init_gcn(
    dims: List[int],
    dtype: torch.dtype = torch.bfloat16,
    *,
    generator: torch.Generator,
    device=DEFAULT_DEVICE,
) -> List[Dict[str, torch.Tensor]]:
    """Glorot-initialized stack of GCN layers; ``dims = [in, h1, ..., out]``.
    Weights are drawn from ``generator`` on its own device, then moved to
    ``device`` and cast to ``dtype``."""
    device = resolve_device(device)
    params = []
    for fi, fo in zip(dims[:-1], dims[1:]):
        w = torch.randn((fi, fo), generator=generator, device=generator.device)
        params.append({
            "w": (w * math.sqrt(2.0 / (fi + fo))).to(device=device, dtype=dtype),
            "b": torch.zeros(fo, dtype=dtype, device=device),
        })
    return params


def gcn_layer(params, h, src, dst, mask, *, activation: str = "relu",
              axis_name=None, model_axis=None):
    """One GCN layer over the (undirected-as-given + self-loop) edge set,
    with ``activation`` "relu" or "none"."""
    if activation not in ("relu", "none"):
        raise ValueError(f"gcn_layer: activation 'relu' or 'none', got {activation!r}")
    V = h.shape[0]
    m = mask.to(h.dtype)
    # degrees with self-loops (the +I term)
    if axis_name is None:
        deg = torch.ones(V, dtype=h.dtype, device=h.device)
    else:
        deg = torch.zeros(V, dtype=h.dtype, device=h.device)
    deg = deg.index_add_(0, src, m).index_add_(0, dst, m)
    if axis_name is not None:
        deg = comm.all_reduce(deg, axis_name) + 1
    norm = torch.rsqrt(deg)
    # both directions so A is symmetric; the gathers read this rank's edges
    hg = h if axis_name is None else comm.copy_over(h, axis_name)
    msg_fwd = hg[src] * (norm[src] * m)[:, None]
    msg_bwd = hg[dst] * (norm[dst] * m)[:, None]
    agg = torch.zeros_like(h).index_add_(0, dst, msg_fwd).index_add_(0, src, msg_bwd)
    if axis_name is not None:
        agg = comm.sum_over(agg, axis_name)
    # the self-loop contribution
    agg = agg + h * norm[:, None]
    agg = agg * norm[:, None]
    if model_axis is not None:
        agg = comm.copy_over(agg, model_axis)
    out = agg.float() @ params["w"].float() + params["b"].float()
    if activation == "relu":
        out = torch.relu(out)
    out = out.to(h.dtype)
    if model_axis is not None:
        out = comm.gather_columns(out, model_axis)
    return out


def gcn_forward(params_stack, h, src, dst, mask, *, remat: bool = False,
                axis_name=None, model_axis=None):
    """Full model: all layers, last layer linear.

    ``remat=True`` runs each layer under ``torch.utils.checkpoint`` (the
    reference's ``jax.checkpoint``): activations are recomputed in the
    backward, trading operations for device memory on deep stacks."""
    n = len(params_stack)
    for i, p in enumerate(params_stack):
        layer = functools.partial(
            gcn_layer, activation="relu" if i < n - 1 else "none",
            axis_name=axis_name, model_axis=model_axis,
        )
        h = comm.remat(layer, p, h, src, dst, mask) if remat else layer(
            p, h, src, dst, mask)
    return h
