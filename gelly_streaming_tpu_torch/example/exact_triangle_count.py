"""Exact streaming triangle count CLI
(``example/ExactTriangleCount.java:44-66``), PyTorch port. Output: the final
``(vertex,count)`` lines, vertex -1 being the global total.

Runs on the card; ``--cpu`` runs it on the CPU instead::

    python -m gelly_streaming_tpu_torch.example.exact_triangle_count \\
        [--cpu] <input edges path> <window size (edges)> [output path]
"""

from __future__ import annotations

from typing import List, Optional

from ..core.device import DEFAULT_DEVICE
from ..core.stream import SimpleEdgeStream
from ..core.window import CountWindow
from ..library.triangles import ExactTriangleCount
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
    final = {}
    for emissions in ExactTriangleCount().run(stream):
        final.update(dict(emissions))
    write_lines(output_path, [f"({v},{c})" for v, c in sorted(final.items())])
    return final


def main(args: List[str]) -> None:
    args, device = split_cpu_flag(args)
    if args:
        if len(args) not in (2, 3):
            print(
                "Usage: exact_triangle_count [--cpu] <input edges path> "
                "<window size (edges)> [output path]"
            )
            return
        run(read_edges(args[0]), int(args[1]), args[2] if len(args) > 2 else None,
            device=device)
    else:
        usage(
            "exact_triangle_count",
            "[--cpu] <input edges path> <window size (edges)> [output path]",
        )
        run(default_chain_edges(), 100, device=device)


if __name__ == "__main__":
    run_main(main)
