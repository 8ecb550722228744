"""Broadcast triangle-count estimate CLI
(``example/BroadcastTriangleCount.java:180-230``; defaults
vertexCount=1000, samples=10000 from ``:216-217``), PyTorch port.

Runs on the card; ``--cpu`` runs it on the CPU instead::

    python -m gelly_streaming_tpu_torch.example.broadcast_triangle_count \\
        [--cpu] <input edges path> <vertex count> <samples> [output path]

Output: ``(edgeCount,estimate)`` lines, one per change of the estimate.
"""

from __future__ import annotations

from typing import List, Optional

from ..core.device import DEFAULT_DEVICE
from ..library.sampling import BroadcastTriangleCount
from .common import (
    default_chain_edges,
    read_edges,
    run_main,
    split_cpu_flag,
    usage,
    write_lines,
)

DEFAULT_VERTEX_COUNT = 1000
DEFAULT_SAMPLES = 10000


def run(
    edges,
    vertex_count: int,
    samples: int,
    output_path: Optional[str] = None,
    estimator_cls=BroadcastTriangleCount,
    device=DEFAULT_DEVICE,
):
    est = estimator_cls(vertex_count=vertex_count, samples=samples, device=device)
    results = list(est.run(edges))
    write_lines(output_path, [f"({m},{e})" for m, e in results])
    return results


def main(args: List[str], estimator_cls=BroadcastTriangleCount,
         name: str = "broadcast_triangle_count") -> None:
    args, device = split_cpu_flag(args)
    if args:
        if len(args) not in (3, 4):
            print(
                f"Usage: {name} [--cpu] <input edges path> <vertex count> "
                "<samples> [output path]"
            )
            return
        edges = read_edges(args[0])
        run(edges, int(args[1]), int(args[2]), args[3] if len(args) > 3 else None,
            estimator_cls=estimator_cls, device=device)
    else:
        usage(name, "[--cpu] <input edges path> <vertex count> <samples> [output path]")
        run(default_chain_edges(), DEFAULT_VERTEX_COUNT, DEFAULT_SAMPLES,
            estimator_cls=estimator_cls, device=device)


if __name__ == "__main__":
    run_main(main)
