"""Centralized weighted matching CLI
(``example/CentralizedWeightedMatching.java:41-64``), PyTorch port. Input
lines: ``src trg weight``; output: ADD/REMOVE events, then the final
matching weight; the runtime is printed. The matching is host work (one
global matching updated per edge), so this CLI takes no device::

    python -m gelly_streaming_tpu_torch.example.centralized_weighted_matching \\
        [--movielens [u.data path] | <input edges path> [output path]]
"""

from __future__ import annotations

import time
from typing import List, Optional

from ..library.matching import CentralizedWeightedMatching
from .common import read_edges, run_main, usage, write_lines


def run(edges, output_path: Optional[str] = None):
    m = CentralizedWeightedMatching()
    t0 = time.perf_counter()
    lines = [
        f"({e.type.name},({e.edge.src},{e.edge.dst},{e.edge.val}))"
        for e in m.run(edges)
    ]
    runtime_ms = (time.perf_counter() - t0) * 1000
    lines.append(f"Matching weight: {m.total_weight()}")
    write_lines(output_path, lines)
    print(f"Runtime: {runtime_ms:.1f}")  # getNetRuntime analog (:62-64)
    return m


def main(args: List[str]) -> None:
    if args and args[0] == "--movielens":
        # the reference's dataset for this workload (:41-44): the given
        # u.data file, else the real one under $GELLY_DATA or ./data, else
        # the cached surrogate
        from .. import datasets

        path = args[1] if len(args) > 1 else datasets.ensure_corpus("movielens-100k")[0]
        u, i, r = datasets.load_movielens(path)
        run(zip(u.tolist(), i.tolist(), r.tolist()))
        return
    if args:
        if len(args) not in (1, 2):
            print(
                "Usage: centralized_weighted_matching "
                "[--movielens [u.data path] | <input edges path> [output path]]"
            )
            return
        edges = read_edges(args[0], n_fields=3)
        run(edges, args[1] if len(args) > 1 else None)
    else:
        usage(
            "centralized_weighted_matching",
            "[--movielens [u.data path] | <input edges path> [output path]]",
        )
        run([(1, 2, 10.0), (2, 3, 25.0), (3, 4, 15.0)])


if __name__ == "__main__":
    run_main(main)
