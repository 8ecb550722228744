"""Mean-aggregator GraphSAGE embeddings of edge prefixes, in plain PyTorch.

The graph of a prefix is its messages ``src -> dst`` as given (repeats
and self loops count). Layer ``l`` maps ``h`` to
``act(h @ w_self + mean(h) @ w_nbr + b)``: ``mean(h)`` at a vertex is the
sum of ``h[src]`` over the messages into it divided by their number (0
where none), ``act`` is relu on every layer but the last. Every id below
the table's length is a vertex.

``forward`` computes it in float32 with TF32 off: the sums over edge
slices of ``SLICE_EDGES`` messages (so that the messages of a long prefix
never exist at once) and the in-degrees counted exactly as integers. With
``accumulate=torch.bfloat16`` it is the control: the sums, the counts, the
mean and every layer's output are held in bfloat16 (the products still
accumulate in float32), so a count stops at 256 and a hub's mean is wrong.
"""

from __future__ import annotations

import torch

SLICE_EDGES = 1 << 22


def in_degrees(dst: torch.Tensor, n: int) -> torch.Tensor:
    """Messages into each of the ``n`` ids, exact (int64)."""
    return torch.bincount(dst.long(), minlength=n)


def hubs(dst: torch.Tensor, n: int, k: int) -> torch.Tensor:
    """The ``k`` ids of highest in-degree among ``n``."""
    return torch.topk(in_degrees(dst, n), min(k, n)).indices


def _mean(h, src, dst, accumulate):
    n, f = h.shape
    agg = torch.zeros((n, f), dtype=accumulate, device=h.device)
    cnt = torch.zeros(n, dtype=accumulate, device=h.device)
    for a in range(0, src.shape[0], SLICE_EDGES):
        s, d = src[a:a + SLICE_EDGES].long(), dst[a:a + SLICE_EDGES].long()
        agg.index_add_(0, d, h[s])
        if accumulate != torch.float32:
            cnt.index_add_(0, d, torch.ones(d.shape[0], dtype=accumulate, device=h.device))
    if accumulate == torch.float32:
        return agg / torch.clamp_min(in_degrees(dst, n), 1).to(torch.float32)[:, None]
    return agg / torch.clamp_min(cnt, 1.0)[:, None]


def forward(h0: torch.Tensor, params, src: torch.Tensor, dst: torch.Tensor,
            accumulate=torch.float32) -> torch.Tensor:
    """The embeddings ``[n, O]`` (float32) of the prefix ``src -> dst`` from
    features ``h0 [n, F]`` and ``params``, a list of ``{"w_self" [F, O],
    "w_nbr" [F, O], "b" [O]}`` (any float dtype, taken as float32)."""
    f32 = torch.float32
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        h = h0.to(accumulate)
        for i, p in enumerate(params):
            mean = _mean(h, src, dst, accumulate)
            out = (h.to(f32) @ p["w_self"].to(f32) + mean.to(f32) @ p["w_nbr"].to(f32)
                   + p["b"].to(f32))
            del mean
            if i < len(params) - 1:
                out = torch.relu(out)
            h = out.to(accumulate)
            del out
        return h.to(f32)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def gaps(got: torch.Tensor, want: torch.Tensor, hub_ids: torch.Tensor):
    """``(‖got - want‖_F / ‖want‖_F over the whole table, the largest
    row-wise relative L2 gap among the rows ``hub_ids``)``, in float64."""
    diff = got.double() - want.double()
    w = want.double()
    rel = float(torch.linalg.vector_norm(diff) / torch.linalg.vector_norm(w))
    rows = torch.linalg.vector_norm(diff[hub_ids], dim=1) / torch.linalg.vector_norm(
        w[hub_ids], dim=1)
    return rel, float(rows.max())
