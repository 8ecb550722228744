"""PageRank of edge prefixes, in plain PyTorch.

The graph of a prefix is its directed edges as given (repeats and self
loops count). Its vertices are the ids below one more than the largest id
in the prefix: ids stand for themselves (the configuration's dense id
space), so an id below the largest that never appeared still holds rank.
With damping ``d`` over ``n`` vertices a rank is ``(1 - d) / n`` plus ``d``
times the rank its in-neighbours pass on (each out-edge a share of its
source's rank) and a ``1 / n`` share of the rank of the vertices without
out-edges. The ranks sum to 1.

``fixpoint`` iterates that map in float64 from uniform ranks until an
iteration moves them by at most ``tol`` in L1 (the map contracts by ``d``
in L1, so the answer is within ``tol * d / (1 - d)`` of the fixpoint).

``windowed_ranks`` is the incremental procedure window by window (each
window warm-starts from the last one's ranks, new vertices at ``1 / n``,
renormalized; at most ``max_iter`` iterations or until the L1 change is at
most ``tol``), with the ranks and shares in any dtype: in float64 it is
the reference of a run, in bfloat16 the control. ``fixpoint`` is the
definition the tests hold it to.
"""

from __future__ import annotations

import torch


def _graph(src: torch.Tensor, dst: torch.Tensor, n: int, dtype):
    """Edge columns, each vertex's share ``1 / out-degree`` in ``dtype``
    (the degrees counted exactly) and the dangling vertices."""
    s, t = src.long(), dst.long()
    out = torch.bincount(s, minlength=n)
    share = (1.0 / torch.clamp(out, min=1).double()).to(dtype)
    return s, t, share, out == 0


def _iterate(r, s, t, share, dangling, d: float, n: int):
    new = torch.zeros_like(r)
    new.index_add_(0, t, (r * share)[s])
    mass = torch.where(dangling, r, torch.zeros_like(r)).sum()
    return (1.0 - d) / n + d * (new + mass / n)


def n_vertices(src: torch.Tensor, dst: torch.Tensor) -> int:
    return 1 + int(torch.maximum(src.max(), dst.max()))


def fixpoint(src: torch.Tensor, dst: torch.Tensor, damping: float, tol: float = 1e-13,
             max_iter: int = 2000) -> torch.Tensor:
    """Float64 ranks of the prefix graph ``src -> dst`` (see the module
    docstring), one per vertex id below ``n_vertices(src, dst)``."""
    n = n_vertices(src, dst)
    s, t, share, dangling = _graph(src, dst, n, torch.float64)
    r = torch.full((n,), 1.0 / n, dtype=torch.float64, device=src.device)
    for _ in range(max_iter):
        new = _iterate(r, s, t, share, dangling, damping, n)
        delta = float((new - r).abs().sum())
        r = new
        if delta <= tol:
            return r
    raise RuntimeError(f"no fixpoint to {tol:g} in {max_iter} iterations")


def windowed_ranks(src: torch.Tensor, dst: torch.Tensor, window: int, ends, damping: float,
                   tol: float, max_iter: int, dtype):
    """The incremental procedure over the stream's windows in ``dtype``;
    returns the ranks (float64 copies) at each prefix end in ``ends``."""
    want = sorted(set(int(e) for e in ends))
    out = {}
    r = torch.zeros(0, dtype=dtype, device=src.device)
    for a in range(0, want[-1], window):
        b = min(a + window, want[-1])
        n = n_vertices(src[:b], dst[:b])
        r = torch.cat([r, torch.zeros(n - r.shape[0], dtype=dtype, device=src.device)])
        r = torch.where(r == 0, torch.tensor(1.0 / n, dtype=dtype, device=src.device), r)
        r = r / r.sum()
        s, t, share, dangling = _graph(src[:b], dst[:b], n, dtype)
        for _ in range(max_iter):
            new = _iterate(r, s, t, share, dangling, damping, n)
            delta = float((new.double() - r.double()).abs().sum())
            r = new
            if delta <= tol:
                break
        if b in want:
            out[b] = r.double()
    return [out[int(e)] for e in ends]


def gaps(got: torch.Tensor, want: torch.Tensor):
    """``(L1 gap, largest gap relative to the reference rank)`` of a
    program's rank vector ``got`` (any length, slots past the reference's
    vertices must hold 0) against the reference's ``want``."""
    n = want.shape[0]
    g = got.double()
    if g.shape[0] < n:
        g = torch.cat([g, torch.zeros(n - g.shape[0], dtype=g.dtype, device=g.device)])
    diff = (g[:n] - want).abs()
    l1 = float(diff.sum() + g[n:].abs().sum())
    rel = float((diff / want).max())
    return l1, rel
