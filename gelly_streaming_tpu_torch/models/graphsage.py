"""Streaming GraphSAGE: GNN layers over the window stream (BASELINE #5).

The counterpart of ``gelly_streaming_tpu/models/graphsage.py``:

- Neighbor aggregation is a masked mean over edge messages: a gather of
  ``h[src]`` and an ``index_add_`` scatter into ``dst``, summed in float32
  over edge slices of :data:`AGG_SLICE_EDGES` messages and divided by the
  exact integer in-degree (:func:`in_degrees`, once a forward). The
  reference sums and counts in ``h.dtype``: a bfloat16 count stops at 256.
  ``StreamingGraphSAGE`` on one device, which holds the growing graph
  itself, instead carries it as a CSR by destination
  (:class:`~gelly_streaming_tpu_torch.ops.sage_aggregate.MessageCSR`) and
  takes each layer's mean with one call of
  :func:`~gelly_streaming_tpu_torch.ops.sage_aggregate.segment_mean` (on
  the card one launch of its kernel, no atomic): the same float32 sums and
  exact counts, read once a message.
- The dense half of every layer, ``act(h @ w_self + agg @ w_nbr + b)``,
  is one call of :func:`~gelly_streaming_tpu_torch.ops.sage_kernels.fused_sage_matmul`:
  on the card the hand-written Hopper kernel, relu for the hidden layers
  and no activation for the last; on the CPU its plain version.

Parameters are a list of per-layer dicts of tensors ``{"w_self", "w_nbr",
"b"}``, as the JAX pytree has them. Under a mesh
(:func:`make_sharded_forward`, ``StreamingGraphSAGE(mesh=)``) the edge
columns split over the ``"edges"`` axis, each rank scatters its slice's
messages, and the partial aggregates all-reduce before the replicated
dense half.

Training differentiates this forward: the kernel's wrapper is a
``torch.autograd.Function`` (its backward is plain f32 matmuls), and
:func:`sage_forward` takes ``remat=`` (per-layer recomputation) and, under
the training step's ``shard_map``, ``model_axis=``: the weights' output
columns split over the ``"model"`` axis, each rank computes its columns
and the layer's output is all-gathered. :func:`make_sharded_train_step`
is the round-1 wrapper over the generic step of :mod:`.training`.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, Iterator, List

import numpy as np
import torch

from ..core.device import DEFAULT_DEVICE, resolve_device
from ..core.edgeblock import EdgeAccumulator
from ..obs import trace as _trace
from ..ops import cuda_build
from ..ops.sage_aggregate import MessageCSR, segment_mean
from ..ops.sage_kernels import fused_sage_matmul
from ..parallel import comm
from ..parallel.mesh import EDGE_AXIS, P, mesh_shape


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


#: messages a slice of the aggregation: the slice's float32 messages, 4 GiB
#: at F = 256, are the largest temporary; no [E, F] tensor of the whole
#: prefix is built
AGG_SLICE_EDGES = 1 << 22

#: messages aggregated since import: the lanes each layer's aggregation
#: takes in, masked lanes included (read by the benchmark's ``sage.step_mfu``)
MESSAGES_AGGREGATED = 0


def in_degrees(dst, mask, num_vertices: int, *, axis_name=None):
    """Exact int64 count of the messages into each vertex: the lanes of
    ``dst`` whose ``mask`` is set (every lane where ``mask`` is None),
    :data:`AGG_SLICE_EDGES` at a time. ``axis_name``: this rank's counts
    all-reduce over that axis. No host sync."""
    n, slice_edges = dst.shape[0], AGG_SLICE_EDGES
    cnt = torch.zeros(num_vertices, dtype=torch.int64, device=dst.device)
    ones = torch.ones(min(n, slice_edges), dtype=torch.int64, device=dst.device)
    for a in range(0, n, slice_edges):
        b = min(a + slice_edges, n)
        lanes = ones[: b - a] if mask is None else mask[a:b].to(torch.int64)
        cnt.index_add_(0, dst[a:b], lanes)
    if axis_name is not None:
        cnt = comm.all_reduce(cnt, axis_name)
    return cnt


def mean_aggregate(h, src, dst, mask, num_vertices: int, axis_name=None, *,
                   counts=None, csr=None):
    """Masked mean of in-neighbor features: messages flow src -> dst.

    ``mask`` selects the lanes that hold messages (None: every lane).
    Sums accumulate in float32 through ``index_add_``,
    :data:`AGG_SLICE_EDGES` messages at a time, and divide by the exact
    integer in-degree (``counts`` from :func:`in_degrees`, computed here
    where None); the mean is cast to ``h.dtype``. On the card
    ``index_add_`` adds with atomics, so the order of a sum, and its
    float32 rounding, changes from run to run. ``axis_name``: inside
    ``shard_map`` over this rank's edges, the partial sums and counts
    all-reduce over that axis before the divide. Under autograd the
    gather's gradient, which holds only this rank's edges, all-reduces over
    the axis too (:func:`~..parallel.comm.copy_over`).

    ``csr``: the messages as a :class:`MessageCSR` by destination instead
    (``src``, ``dst``, ``mask``, ``counts`` and ``axis_name`` None, its
    rows ``h``'s): the mean is one :func:`segment_mean` over it, the same
    float32 sums and exact counts with no atomic, and no autograd."""
    global MESSAGES_AGGREGATED
    if csr is not None:
        MESSAGES_AGGREGATED += csr.n
        return segment_mean(h, csr.src, csr.row_ptr, csr.n)
    n, slice_edges = src.shape[0], AGG_SLICE_EDGES
    if counts is None:
        counts = in_degrees(dst, mask, num_vertices, axis_name=axis_name)
    if axis_name is not None:
        h = comm.copy_over(h, axis_name)
    f32 = torch.float32
    hf = h.to(f32)
    agg = torch.zeros((num_vertices, h.shape[1]), dtype=f32, device=h.device)
    for a in range(0, n, slice_edges):
        b = min(a + slice_edges, n)
        msgs = hf.index_select(0, src[a:b])
        if mask is not None:
            msgs = msgs * mask[a:b, None].to(f32)
        agg.index_add_(0, dst[a:b], msgs)
    MESSAGES_AGGREGATED += n
    if axis_name is not None:
        agg = comm.sum_over(agg, axis_name)
    return (agg / torch.clamp_min(counts, 1).to(f32)[:, None]).to(h.dtype)


def sage_layer(params, h, src, dst, mask, *, activation: str = "relu",
               axis_name=None, model_axis=None, counts=None):
    """One GraphSAGE layer: act(h @ W_self + mean_nbr(h) @ W_nbr + b), with
    ``activation`` "relu" or "none". ``counts``: as :func:`mean_aggregate`
    takes them. ``model_axis``: the weights hold this rank's output columns
    over that axis (:func:`~.training.shard_gnn_params`); ``h`` and the
    mean enter the matmul through :func:`~..parallel.comm.copy_over` and
    the output is gathered whole. Spans: the device span ``sage.aggregate``
    around the mean (its ``.device`` event is the stream's time for it),
    ``sage.matmul`` around the kernel's launch."""
    with _trace.span("sage.aggregate", device=h.device):
        agg = mean_aggregate(h, src, dst, mask, h.shape[0], axis_name=axis_name,
                             counts=counts)
    if model_axis is not None:
        h = comm.copy_over(h, model_axis)
        agg = comm.copy_over(agg, model_axis)
    with _trace.span("sage.matmul"):
        out = fused_sage_matmul(
            h, agg, params["w_self"], params["w_nbr"], params["b"],
            activation=activation,
        )
    if model_axis is not None:
        out = comm.gather_columns(out, model_axis)
    return out


def sage_forward(params_stack, h, src, dst, mask, *, remat: bool = False,
                 axis_name=None, model_axis=None):
    """Full model: all layers, last layer linear (no activation). The
    in-degrees are counted once, for every layer.

    ``remat=True`` runs each layer under ``torch.utils.checkpoint`` (the
    reference's ``jax.checkpoint``): its activations are recomputed in the
    backward, so each layer's kernel launches twice a training step."""
    n = len(params_stack)
    counts = in_degrees(dst, mask, h.shape[0], axis_name=axis_name)
    for i, p in enumerate(params_stack):
        layer = functools.partial(
            sage_layer, activation="relu" if i < n - 1 else "none",
            axis_name=axis_name, model_axis=model_axis, counts=counts,
        )
        h = comm.remat(layer, p, h, src, dst, mask) if remat else layer(
            p, h, src, dst, mask)
    return h


def make_sharded_forward(mesh):
    """The edge-sharded streaming forward: the window's edge columns split
    over the mesh's ``"edges"`` axis, each rank scatters its slice's
    messages into a replicated [V, F] table, and the partial aggregates
    all-reduce before the (replicated) dense half, which is
    :func:`~gelly_streaming_tpu_torch.ops.sage_kernels.fused_sage_matmul`
    on every rank. ``fwd(params_stack, h, src, dst, mask, n_edges=None)``;
    with ``n_edges`` (``mask`` may be None) each rank aggregates only the
    lanes of its contiguous slice that lie below ``n_edges``."""
    def fwd(params_stack, h, src, dst, mask, n_edges=None):
        def shard_fn(params_stack, h, src_s, dst_s, mask_s=None):
            if n_edges is not None:
                c = src_s.shape[0]
                k = max(0, min(c, n_edges - comm.axis_index(EDGE_AXIS) * c))
                src_s, dst_s = src_s[:k], dst_s[:k]
            return sage_forward(params_stack, h, src_s, dst_s, mask_s,
                                axis_name=EDGE_AXIS)

        args = (params_stack, h, src, dst) + (() if mask is None else (mask,))
        specs = (P(), P(), P(EDGE_AXIS), P(EDGE_AXIS), P(EDGE_AXIS))[: len(args)]
        return comm.shard_map(shard_fn, mesh, specs, P())(*args)

    return fwd


def make_sharded_train_step(mesh, lr=1e-2):
    """The round-1 SAGE training step: data-parallel over the edge axis,
    tensor-parallel over the output features. Returns ``(step_fn,
    shard_params_fn)``; ``step_fn(params, h, src, dst, mask, targets) ->
    (params, loss)``. A thin wrapper over the generic
    :func:`~.training.make_sharded_train_step` (which adds the optimizer,
    other losses and remat)."""
    from .training import make_sharded_train_step as make_generic

    step, shard_params, _ = make_generic(mesh, sage_forward, lr=lr)

    def step_compat(params, h, src, dst, mask, targets):
        params, _, loss = step(params, None, h, src, dst, mask, targets)
        return params, loss

    return step_compat, shard_params


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


def _round8(n: int) -> int:
    return -(-int(n) // 8) * 8


def pad_params(params_stack) -> List[Dict[str, torch.Tensor]]:
    """The layers with every width rounded up to a multiple of 8, the
    tensor-core kernel's rule (``ops/sage_kernels.py:_variant``): zero rows
    in ``w_self``/``w_nbr`` for a padded input width, zero columns in them
    and in ``b`` for a padded output width. A padded hidden width feeds
    zero columns (relu of 0) into zero rows, so the product over the
    user's columns is unchanged. A layer already on the rule is the user's
    own tensors."""
    out = []
    for p in params_stack:
        fi, fo = p["w_self"].shape
        di, do = _round8(fi) - fi, _round8(fo) - fo
        if not di and not do:
            out.append(p)
            continue
        layer = {k: torch.nn.functional.pad(p[k], (0, do, 0, di)) for k in ("w_self", "w_nbr")}
        layer["b"] = torch.nn.functional.pad(p["b"], (0, do))
        out.append(layer)
    return out


class StreamingGraphSAGE:
    """Embeddings over the accumulated streaming graph, one forward per
    window (the window stream analog of a deployed GNN encoder).

    ``run(stream, features)`` carries the accumulated edge set on the
    parameters' device; per window it re-embeds the graph so far, over the
    edges held (the accumulator's filled prefix, not its capacity).
    ``features`` is either

    - a dict raw id -> feature vector (missing vertices get zeros);
      windows yield ``out[:n_seen]``, host fill for newly seen vertices
      only; or
    - a :class:`TableFeatureSource` (anything with ``.rows``): the whole
      carried feature table is built by device gathers, the loop performs
      NO host sync, and windows yield the full bucketed-capacity embedding
      tensor. Rows of never-seen compact ids are filler (isolated
      vertices); they cannot influence seen vertices.

    The model runs on copies of the parameters padded once to widths that
    are multiples of 8 (:func:`pad_params`), and the carried feature table
    has the same zero columns, so every layer can take the tensor-core
    kernel; windows yield the user's output columns. Without a mesh the
    held messages are also carried as a :class:`MessageCSR` by destination,
    extended once a window under the device span ``sage.csr``, and every
    layer's mean is one :func:`segment_mean` over it; under a mesh each
    rank aggregates its slice of the edge columns
    (:func:`make_sharded_forward`). Spans: the device span ``sage.window``
    around each window's forward, then :func:`~..obs.trace.window_done`.
    """

    def __init__(self, params_stack, feature_dim: int, mesh=None):
        self.params = params_stack
        self.feature_dim = feature_dim
        self.device = params_stack[0]["w_self"].device
        self._params = pad_params(params_stack)
        self._width = _round8(feature_dim)
        self._out_dim = params_stack[-1]["w_self"].shape[1]
        #: optional device mesh: the per-window forward shards the edge
        #: columns over the ``"edges"`` axis (:func:`make_sharded_forward`)
        self.mesh = mesh
        self._fwd = None if mesh is None else make_sharded_forward(mesh)
        # accumulated graph + feature matrix carried ON DEVICE at bucketed
        # capacity; per window only new edges / new vertices' rows move.
        # Sharded columns must divide by the edge axis at every bucket.
        min_cap = 8 if mesh is None else max(8, mesh_shape(mesh).get(EDGE_AXIS, 1))
        self._edges = EdgeAccumulator(device=self.device, min_capacity=min_cap)
        self._csr = MessageCSR(device=self.device) if mesh is None else None
        if self._csr is not None and self.device.type == "cuda":
            # both kernels a window launches, compiled side by side once
            cuda_build.load_libraries(("fused_sage_matmul", "sage_aggregate"))
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
            held = self._edges.n_edges
            self._edges.append(block.src[:n_new], block.dst[:n_new])
            vcap = block.n_vertices
            if self._csr is not None:
                e = self._edges
                with _trace.span("sage.csr", device=self.device):
                    self._csr.append(e.src[held:e.n_edges], e.dst[held:e.n_edges], vcap)
            if device_source:
                self._extend_features_device(vdict, features, dtype)
                yield self._window(block)
                continue
            n = len(vdict)
            self._extend_features(vdict, n, vcap, features, dtype)
            yield self._window(block)[:n]

    def _window(self, block) -> torch.Tensor:
        with _trace.span("sage.window", device=self.device):
            out = self._forward()
        _trace.window_done(block.cut_ns, self.device)
        return out[:, : self._out_dim]

    def _forward(self) -> torch.Tensor:
        if self._csr is None:
            e = self._edges
            return self._fwd(self._params, self._h, e.src, e.dst, None, n_edges=e.n_edges)
        return self._csr_forward()

    def _csr_forward(self) -> torch.Tensor:
        """Every layer over the carried CSR: its mean is
        :func:`mean_aggregate` over the CSR (one :func:`segment_mean`, no
        autograd), its dense half :func:`fused_sage_matmul`, under the spans
        of :func:`sage_layer`."""
        csr, h, n = self._csr, self._h, len(self._params)
        csr.reserve_rows(h.shape[0])
        for i, p in enumerate(self._params):
            with _trace.span("sage.aggregate", device=h.device):
                agg = mean_aggregate(h, None, None, None, h.shape[0], csr=csr)
            with _trace.span("sage.matmul"):
                h = fused_sage_matmul(h, agg, p["w_self"], p["w_nbr"], p["b"],
                                      activation="relu" if i < n - 1 else "none")
        return h

    def state_dict(self) -> dict:
        """Checkpoint surface for the carried graph + features (params are
        user-owned and checkpointed separately). ``h`` is float32 numpy,
        which holds bf16 values exactly, in the user's feature columns."""
        return {
            "edges": self._edges.state_dict(),
            "h": None if self._h is None
            else self._h[:, : self.feature_dim].float().cpu().numpy(),
            "n_seen": self._n_seen,
        }

    def load_state_dict(self, d: dict) -> None:
        """Restore a state from this class or from the JAX package's
        ``StreamingGraphSAGE.state_dict`` (its bf16 ``h`` converts through
        float32). Without a mesh the CSR is rebuilt from the restored
        edges."""
        self._edges.load_state_dict(d["edges"])
        dtype = self.params[0]["w_self"].dtype
        self._h = None if d["h"] is None else self._padded(torch.tensor(
            np.asarray(d["h"], np.float32), dtype=dtype, device=self.device
        ))
        self._n_seen = int(d["n_seen"])
        if self._csr is not None:
            e = self._edges
            self._csr = MessageCSR(device=self.device)
            self._csr.append(e.src[: e.n_edges], e.dst[: e.n_edges],
                             0 if self._h is None else self._h.shape[0])

    def _padded(self, rows: torch.Tensor) -> torch.Tensor:
        """``rows`` with zero columns up to the padded feature width."""
        pad = self._width - rows.shape[1]
        return torch.nn.functional.pad(rows, (0, pad)) if pad else rows

    def _extend_features_device(self, vdict, features, dtype) -> None:
        """Rebuild the carried feature table by device gather EVERY window:
        the dict's raw table changes as vertices arrive (not only when its
        capacity grows). One gather per window, no host sync."""
        raw = vdict.raw_table(self.device)
        self._h = self._padded(features.rows(raw).to(dtype))
        self._n_seen = int(raw.shape[0])

    def _extend_features(self, vdict, n: int, vcap: int, features, dtype) -> None:
        """Fill feature rows for vertices first seen this window only."""
        if self._h is None:
            self._h = torch.zeros(
                (vcap, self._width), dtype=dtype, device=self.device
            )
        elif vcap > self._h.shape[0]:
            grown = torch.zeros(
                (vcap, self._width), dtype=dtype, device=self.device
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
            self._h[self._n_seen:n, : self.feature_dim] = torch.from_numpy(rows).to(
                device=self.device, dtype=dtype
            )
            self._n_seen = n
