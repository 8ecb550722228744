"""Streaming GraphSAGE encoder CLI (BASELINE config #5; no reference
analog). Embeds the accumulated graph once per window with random
features; output: the final embedding norms per vertex.

Runs on the card; ``--cpu`` runs it on the CPU instead::

    python -m gelly_streaming_tpu_torch.example.streaming_graphsage \\
        [--cpu] <input edges path> <window size (edges)> [output path]
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..core.device import DEFAULT_DEVICE
from ..core.stream import SimpleEdgeStream
from ..core.window import CountWindow
from .common import default_chain_edges, read_edges, run_main, usage, write_lines


def run(
    edges,
    window_size: int,
    feature_dim: int = 32,
    output_path: Optional[str] = None,
    seed: int = 0,
    device=DEFAULT_DEVICE,
):
    from ..models.graphsage import StreamingGraphSAGE, init_graphsage

    stream = SimpleEdgeStream(edges, window=CountWindow(window_size), device=device)
    params = init_graphsage(
        [feature_dim, 64, 32],
        generator=torch.Generator().manual_seed(seed),
        device=stream.device,
    )
    rng = np.random.default_rng(seed)
    verts = sorted({v for e in edges for v in e[:2]})
    feats = {v: rng.normal(size=feature_dim).astype(np.float32) for v in verts}
    sage = StreamingGraphSAGE(params, feature_dim=feature_dim)
    out = None
    for out in sage.run(stream, feats):
        pass
    if out is None:  # empty stream: no windows, nothing to embed
        write_lines(output_path, [])
        return None
    norms = np.linalg.norm(out.float().cpu().numpy(), axis=1)
    raw = stream.vertex_dict.decode(np.arange(len(norms)))
    write_lines(
        output_path,
        [f"({int(v)},{n:.4f})" for v, n in zip(raw, norms)],
    )
    return out


def main(args: List[str]) -> None:
    args = list(args)
    device = DEFAULT_DEVICE
    if "--cpu" in args:
        args.remove("--cpu")
        device = "cpu"
    if args:
        if len(args) not in (2, 3):
            print(
                "Usage: streaming_graphsage [--cpu] <input edges path> "
                "<window size (edges)> [output path]"
            )
            return
        edges = read_edges(args[0])
        run(
            edges, int(args[1]), output_path=args[2] if len(args) > 2 else None,
            device=device,
        )
    else:
        usage(
            "streaming_graphsage",
            "[--cpu] <input edges path> <window size (edges)> [output path]",
        )
        run(default_chain_edges(), 25, device=device)


if __name__ == "__main__":
    run_main(main)
