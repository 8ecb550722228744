"""Iterative (label-emitting) CC CLI
(``example/IterativeConnectedComponents.java:52-63``), PyTorch port.
Output: ``(vertex,componentId)`` corrected-label lines.

Runs on the card; ``--cpu`` runs it on the CPU instead::

    python -m gelly_streaming_tpu_torch.example.iterative_connected_components \\
        [--cpu] <input edges path> <window size (edges)> [output path]
"""

from __future__ import annotations

from typing import List, Optional

from ..core.device import DEFAULT_DEVICE
from ..core.stream import SimpleEdgeStream
from ..core.window import CountWindow
from ..library.iterative_cc import IterativeConnectedComponents
from .common import (
    default_chain_edges,
    read_edges,
    run_main,
    split_cpu_flag,
    usage,
    write_lines,
)


def run(edges, window_size: int, output_path: Optional[str] = None,
        device=DEFAULT_DEVICE):
    stream = SimpleEdgeStream(edges, window=CountWindow(window_size), device=device)
    icc = IterativeConnectedComponents()
    lines = []
    for changed in icc.run(stream):
        lines.extend(f"({v},{c})" for v, c in changed)
    write_lines(output_path, lines)
    return icc


def main(args: List[str]) -> None:
    args, device = split_cpu_flag(args)
    if args:
        if len(args) not in (2, 3):
            print(
                "Usage: iterative_connected_components [--cpu] <input edges "
                "path> <window size (edges)> [output path]"
            )
            return
        edges = read_edges(args[0])
        run(edges, int(args[1]), args[2] if len(args) > 2 else None, device=device)
    else:
        usage(
            "iterative_connected_components",
            "[--cpu] <input edges path> <window size (edges)> [output path]",
        )
        run(default_chain_edges(), 10, device=device)


if __name__ == "__main__":
    run_main(main)
