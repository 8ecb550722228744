"""Window triangle count CLI (``example/WindowTriangles.java:40-160``),
PyTorch port. Input lines: ``src trg timestamp`` (event time, like the
reference's ``AscendingTimestampExtractor`` path); output lines
``(count,windowMaxTs)``, the format ``WindowTrianglesITCase`` compares.

Runs on the card; ``--cpu`` runs it on the CPU instead::

    python -m gelly_streaming_tpu_torch.example.window_triangles \\
        [--cpu] <input edges path> <output path> <window time>
"""

from __future__ import annotations

from typing import List, Optional

from ..core.device import DEFAULT_DEVICE
from ..core.window import EventTimeWindow
from ..library.triangles import WindowTriangles
from .common import (
    default_chain_edges,
    read_edges,
    run_main,
    split_cpu_flag,
    usage,
    write_lines,
)


def run(edges, window_time: float, output_path: Optional[str] = None,
        device=DEFAULT_DEVICE):
    wt = WindowTriangles(EventTimeWindow(window_time, timestamp_fn=lambda e: e[2]),
                         device=device)
    results = list(wt.run(edges))
    write_lines(output_path, [f"({c},{int(ts)})" for c, ts in results])
    return results


def main(args: List[str]) -> None:
    args, device = split_cpu_flag(args)
    if args:
        if len(args) != 3:
            print(
                "Usage: window_triangles [--cpu] <input edges path> <output path> "
                "<window time>"
            )
            return
        run(read_edges(args[0], n_fields=3), float(args[2]), args[1], device=device)
    else:
        usage("window_triangles", "[--cpu] <input edges path> <output path> <window time>")
        run(default_chain_edges(), 300.0, device=device)


if __name__ == "__main__":
    run_main(main)
