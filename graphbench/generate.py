"""Edge streams made from the seed, on the device.

The R-MAT generator is a torch copy of ``datasets.rmat_edges`` (the
Graph500 Kronecker recursion with A/B/C/D quadrant probabilities, one
draw per address bit for every edge at once). The draws come from a
``torch.Generator`` on the card instead of numpy's, so the same seed gives
the same stream on every run; the arithmetic on each draw is numpy's:
float32 draws compared against the float64 thresholds exactly
(``rmat_bits``).
"""

from __future__ import annotations

import numpy as np
import torch


def f32_at_least(t: float) -> float:
    """The least float32 that is >= ``t``: for a float32 ``r``, ``r >= t``
    in float64 is ``r >= f32_at_least(t)`` in float32."""
    f = np.float32(t)
    if float(f) < t:
        f = np.nextafter(f, np.float32(np.inf))
    return float(f)


def rmat_bits(r: torch.Tensor, a: float, b: float, c: float):
    """The (src bit, dst bit) of one address level from float32 draws ``r``,
    as ``datasets.rmat_edges`` computes them in float64:
    src takes the C and D quadrants, dst the B and D ones."""
    ab = f32_at_least(a + b)
    src_bit = r >= ab
    dst_bit = ((r >= f32_at_least(a)) & ~src_bit) | (r >= f32_at_least(a + b + c))
    return src_bit, dst_bit


def generator(seed: int, device) -> torch.Generator:
    """A generator on ``device`` seeded from any whole number."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 64))
    return g


def rmat(n_edges: int, scale: int, a: float, b: float, c: float, seed: int, device):
    """``n_edges`` R-MAT edges over ``2**scale`` ids as two int32 tensors on
    ``device``, in stream order."""
    if scale > 31:
        raise ValueError("ids must fit int32")
    g = generator(seed, device)
    src = torch.zeros(n_edges, dtype=torch.int32, device=device)
    dst = torch.zeros(n_edges, dtype=torch.int32, device=device)
    r = torch.empty(n_edges, dtype=torch.float32, device=device)
    for _ in range(scale):
        r.uniform_(0.0, 1.0, generator=g)
        s_bit, d_bit = rmat_bits(r, a, b, c)
        src.mul_(2).add_(s_bit)
        dst.mul_(2).add_(d_bit)
    return src, dst


def edges(spec: dict, seed: int, device):
    """The stream a configuration's ``generator`` block describes."""
    kind = spec["kind"]
    if kind != "rmat":
        raise ValueError(f"unknown generator {kind!r}")
    return rmat(int(spec["edges"]), int(spec["scale"]), float(spec["a"]), float(spec["b"]),
                float(spec["c"]), seed, device)
