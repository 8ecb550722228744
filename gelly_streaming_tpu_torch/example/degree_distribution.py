"""Dynamic degree distribution CLI (``example/DegreeDistribution.java:42-73``),
PyTorch port. Input lines: ``src trg +`` / ``src trg -``; output:
``(degree,count)`` change lines per window.

Runs on the card; ``--cpu`` runs it on the CPU instead::

    python -m gelly_streaming_tpu_torch.example.degree_distribution \\
        [--cpu] <input events path> <window size (events)> [output path]
"""

from __future__ import annotations

from typing import List, Optional

from ..core.device import DEFAULT_DEVICE
from ..core.window import CountWindow
from ..library.degrees import DegreeDistribution
from .common import read_edges, run_main, split_cpu_flag, usage, write_lines


def run(events, window_size: int, output_path: Optional[str] = None,
        device=DEFAULT_DEVICE):
    dd = DegreeDistribution(CountWindow(window_size), device=device)
    lines = []
    for changes in dd.run(events):
        lines.extend(f"({d},{c})" for d, c in changes)
    write_lines(output_path, lines)
    return dd


def main(args: List[str]) -> None:
    args, device = split_cpu_flag(args)
    if args:
        if len(args) not in (2, 3):
            print(
                "Usage: degree_distribution [--cpu] <input events path> "
                "<window size (events)> [output path]"
            )
            return
        events = read_edges(args[0], n_fields=3, val_fn=str)
        run(events, int(args[1]), args[2] if len(args) > 2 else None, device=device)
    else:
        usage(
            "degree_distribution",
            "[--cpu] <input events path> <window size (events)> [output path]",
        )
        run([(1, 2, "+"), (2, 3, "+"), (1, 3, "+"), (2, 3, "-")], 1, device=device)


if __name__ == "__main__":
    run_main(main)
