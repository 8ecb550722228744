"""Streaming GraphSAGE: GNN layers over the window stream (BASELINE #5).

The counterpart of ``gelly_streaming_tpu/models/graphsage.py``, forward
only (the serving path):

- Neighbor aggregation is a masked mean over edge messages: a gather of
  ``h[src]`` and an ``index_add_`` scatter into ``dst``.
- The dense half of every layer, ``act(h @ w_self + agg @ w_nbr + b)``,
  is one call of :func:`~gelly_streaming_tpu_torch.ops.sage_kernels.fused_sage_matmul`:
  on the card the hand-written Hopper kernel, relu for the hidden layers
  and no activation for the last; on the CPU its plain version.

Parameters are a list of per-layer dicts of tensors ``{"w_self", "w_nbr",
"b"}``, as the JAX pytree has them. The mesh paths
(``make_sharded_forward``, ``make_sharded_train_step``) come with the
multi-device slice and training with slice 3 (ROADMAP Queue 1).
"""

from __future__ import annotations

import math
from typing import Dict, Iterator, List

import numpy as np
import torch

from ..core.device import DEFAULT_DEVICE, resolve_device
from ..core.edgeblock import EdgeAccumulator
from ..ops.sage_kernels import fused_sage_matmul


def init_graphsage(
    dims: List[int],
    dtype: torch.dtype = torch.bfloat16,
    *,
    generator: torch.Generator,
    device=DEFAULT_DEVICE,
) -> List[Dict[str, torch.Tensor]]:
    """He-initialized stack of SAGE layers; ``dims = [in, h1, ..., out]``.
    Weights are drawn from ``generator`` on its own device, then moved to
    ``device`` and cast to ``dtype``."""
    device = resolve_device(device)
    params = []
    for fi, fo in zip(dims[:-1], dims[1:]):
        scale = math.sqrt(2.0 / fi)
        layer = {}
        for name in ("w_self", "w_nbr"):
            w = torch.randn(
                (fi, fo), generator=generator, device=generator.device
            ) * scale
            layer[name] = w.to(device=device, dtype=dtype)
        layer["b"] = torch.zeros(fo, dtype=dtype, device=device)
        params.append(layer)
    return params


def mean_aggregate(h, src, dst, mask, num_vertices: int):
    """Masked mean of in-neighbor features: messages flow src -> dst.

    Sums and counts accumulate in ``h.dtype``, as in the reference. On the
    card ``index_add_`` adds with atomics, so the order of a bf16 sum, and
    its rounding, changes from run to run."""
    m = mask.to(h.dtype)
    msgs = h[src] * m[:, None]
    agg = torch.zeros(
        (num_vertices, h.shape[1]), dtype=h.dtype, device=h.device
    ).index_add_(0, dst, msgs)
    cnt = torch.zeros(num_vertices, dtype=h.dtype, device=h.device).index_add_(
        0, dst, m
    )
    return agg / torch.clamp_min(cnt, 1.0)[:, None]


def sage_layer(params, h, src, dst, mask, *, activation: str = "relu"):
    """One GraphSAGE layer: act(h @ W_self + mean_nbr(h) @ W_nbr + b), with
    ``activation`` "relu" or "none"."""
    agg = mean_aggregate(h, src, dst, mask, h.shape[0])
    return fused_sage_matmul(
        h, agg, params["w_self"], params["w_nbr"], params["b"],
        activation=activation,
    )


def sage_forward(params_stack, h, src, dst, mask):
    """Full model: all layers, last layer linear (no activation)."""
    n = len(params_stack)
    for i, p in enumerate(params_stack):
        h = sage_layer(
            p, h, src, dst, mask, activation="relu" if i < n - 1 else "none"
        )
    return h


class TableFeatureSource:
    """Device-resident feature store keyed by raw vertex id.

    ``rows(raw_ids)`` gathers feature rows ON DEVICE (ids wrap modulo the
    table length — size the table to the id space for exact stores): the
    per-window fill is one gather instead of a host dict loop over every
    newly-seen vertex.
    """

    def __init__(self, table, device=DEFAULT_DEVICE):
        self.table = torch.as_tensor(table, device=resolve_device(device))

    def rows(self, raw_ids: torch.Tensor) -> torch.Tensor:
        return self.table[raw_ids % self.table.shape[0]]


class StreamingGraphSAGE:
    """Embeddings over the accumulated streaming graph, one forward per
    window (the window stream analog of a deployed GNN encoder).

    ``run(stream, features)`` carries the accumulated edge set on the
    parameters' device; per window it re-embeds the graph so far.
    ``features`` is either

    - a dict raw id -> feature vector (missing vertices get zeros);
      windows yield ``out[:n_seen]``, host fill for newly seen vertices
      only; or
    - a :class:`TableFeatureSource` (anything with ``.rows``): the whole
      carried feature table is built by device gathers, the loop performs
      NO host sync, and windows yield the full bucketed-capacity embedding
      tensor. Rows of never-seen compact ids are filler (isolated
      vertices); they cannot influence seen vertices.
    """

    def __init__(self, params_stack, feature_dim: int):
        self.params = params_stack
        self.feature_dim = feature_dim
        self.device = params_stack[0]["w_self"].device
        # accumulated graph + feature matrix carried ON DEVICE at bucketed
        # capacity; per window only new edges / new vertices' rows move
        self._edges = EdgeAccumulator(device=self.device)
        self._h = None
        self._n_seen = 0

    def run(self, stream, features) -> Iterator[torch.Tensor]:
        if stream.get_context().device != self.device:
            raise ValueError(
                f"stream on {stream.get_context().device}, parameters on "
                f"{self.device}"
            )
        vdict = stream.vertex_dict
        dtype = self.params[0]["w_self"].dtype
        device_source = hasattr(features, "rows")
        for block in stream.blocks():
            # the block's device columns hold the window's edges in their
            # first n slots (prefix mask); n comes from the host columns
            n_new = len(block.to_host()[0])
            self._edges.append(block.src[:n_new], block.dst[:n_new])
            vcap = block.n_vertices
            if device_source:
                self._extend_features_device(vdict, features, dtype)
                yield self._forward()
                continue
            n = len(vdict)
            self._extend_features(vdict, n, vcap, features, dtype)
            yield self._forward()[:n]

    def _forward(self) -> torch.Tensor:
        e = self._edges
        return sage_forward(self.params, self._h, e.src, e.dst, e.mask())

    def state_dict(self) -> dict:
        """Checkpoint surface for the carried graph + features (params are
        user-owned and checkpointed separately). ``h`` is float32 numpy,
        which holds bf16 values exactly."""
        return {
            "edges": self._edges.state_dict(),
            "h": None if self._h is None else self._h.float().cpu().numpy(),
            "n_seen": self._n_seen,
        }

    def load_state_dict(self, d: dict) -> None:
        """Restore a state from this class or from the JAX package's
        ``StreamingGraphSAGE.state_dict`` (its bf16 ``h`` converts through
        float32)."""
        self._edges.load_state_dict(d["edges"])
        dtype = self.params[0]["w_self"].dtype
        self._h = None if d["h"] is None else torch.tensor(
            np.asarray(d["h"], np.float32), dtype=dtype, device=self.device
        )
        self._n_seen = int(d["n_seen"])

    def _extend_features_device(self, vdict, features, dtype) -> None:
        """Rebuild the carried feature table by device gather EVERY window:
        the dict's raw table changes as vertices arrive (not only when its
        capacity grows). One gather per window, no host sync."""
        raw = vdict.raw_table(self.device)
        self._h = features.rows(raw).to(dtype)
        self._n_seen = int(raw.shape[0])

    def _extend_features(self, vdict, n: int, vcap: int, features, dtype) -> None:
        """Fill feature rows for vertices first seen this window only."""
        if self._h is None:
            self._h = torch.zeros(
                (vcap, self.feature_dim), dtype=dtype, device=self.device
            )
        elif vcap > self._h.shape[0]:
            grown = torch.zeros(
                (vcap, self.feature_dim), dtype=dtype, device=self.device
            )
            grown[: self._h.shape[0]] = self._h
            self._h = grown
        if n > self._n_seen:
            raw = vdict.decode(np.arange(self._n_seen, n))
            rows = np.zeros((n - self._n_seen, self.feature_dim), np.float32)
            for i, rv in enumerate(raw):
                f = features.get(int(rv))
                if f is not None:
                    rows[i] = f
            self._h[self._n_seen:n] = torch.from_numpy(rows).to(
                device=self.device, dtype=dtype
            )
            self._n_seen = n
