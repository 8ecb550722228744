"""Incremental PageRank CLI (BASELINE config #4; no reference analog),
PyTorch port. Output: the final ``(vertex,rank)`` lines, 6 decimals.

Runs on the card; ``--cpu`` runs it on the CPU instead::

    python -m gelly_streaming_tpu_torch.example.incremental_pagerank \\
        [--cpu] <input edges path> <window size (edges)> [output path]
    python -m gelly_streaming_tpu_torch.example.incremental_pagerank \\
        [--cpu] --corpus <name|path> [window]
"""

from __future__ import annotations

import time
from typing import List, Optional

from ..core.device import DEFAULT_DEVICE
from ..core.stream import SimpleEdgeStream
from ..core.window import CountWindow
from ..library.pagerank import IncrementalPageRank
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
    pr = IncrementalPageRank()
    for _ in pr.run(stream):
        pass
    ranks = pr.ranks()
    write_lines(output_path, [f"({v},{r:.6f})" for v, r in sorted(ranks.items())])
    return pr


def run_corpus(name_or_path: str, window_size: int = 1 << 18, device=DEFAULT_DEVICE):
    """Rank a corpus (registry name or edge file) end to end."""
    from .. import datasets

    if name_or_path in datasets.CORPORA:
        path, is_real = datasets.ensure_corpus(name_or_path)
        print(f"corpus: {path} ({'real' if is_real else 'surrogate'})")
    else:
        path = name_or_path
    stream = datasets.stream_file(path, window=CountWindow(window_size), device=device)
    pr = IncrementalPageRank()
    t0 = time.perf_counter()
    for _ in pr.run(stream):
        pass
    ranks = pr.ranks()  # reads the final fixpoint
    print(f"Runtime: {(time.perf_counter() - t0) * 1000:.1f}")
    for v, r in sorted(ranks.items(), key=lambda kv: -kv[1])[:10]:
        print(f"({v},{r:.6f})")
    return pr


def main(args: List[str]) -> None:
    args, device = split_cpu_flag(args)
    if args and args[0] == "--corpus":
        rest = args[1:]
        name = rest[0] if rest else "livejournal"
        window = int(rest[1]) if len(rest) > 1 else 1 << 18
        run_corpus(name, window, device=device)
        return
    if args:
        if len(args) not in (2, 3):
            print(
                "Usage: incremental_pagerank [--cpu] [--corpus <name|path> "
                "[window]] | <input edges path> <window size (edges)> "
                "[output path]"
            )
            return
        run(read_edges(args[0]), int(args[1]), args[2] if len(args) > 2 else None,
            device=device)
    else:
        usage(
            "incremental_pagerank",
            "[--cpu] [--corpus <name|path> [window]] | <input edges path> "
            "<window size (edges)> [output path]",
        )
        run(default_chain_edges(), 25, device=device)


if __name__ == "__main__":
    run_main(main)
