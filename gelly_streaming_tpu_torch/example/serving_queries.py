"""Live query serving demo: streaming CC + concurrent point queries (the
port of ``gelly_streaming_tpu/example/serving_queries.py``).

No reference analog — gelly-streaming's summaries are write-only. This
example runs the CC aggregation behind a
:class:`~gelly_streaming_tpu_torch.serving.server.StreamServer` and answers
``connected(u, v)`` / component-size point queries WHILE the stream
ingests, printing each answer with the snapshot window and staleness it
was served at, then the per-class latency stats.

Runs on the card; ``--cpu`` runs it on the CPU instead::

    python -m gelly_streaming_tpu_torch.example.serving_queries \\
        [--cpu] [edge_file] [window_size] [u,v ...]
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from ..core.device import DEFAULT_DEVICE
from ..core.stream import SimpleEdgeStream
from ..core.window import CountWindow
from ..library import ConnectedComponents
from ..serving import ComponentSizeQuery, ConnectedQuery, StreamServer
from .common import default_chain_edges, read_edges, run_main, split_cpu_flag, usage


def run(
    edges,
    window_size: int,
    queries: Optional[List[Tuple[int, int]]] = None,
    device=DEFAULT_DEVICE,
) -> List[str]:
    stream = SimpleEdgeStream(edges, window=CountWindow(window_size), device=device)
    agg = ConnectedComponents()
    if queries is None:
        # default chain data: 1 and 5 share the odd chain; 1 and 2 never
        # connect (odd vs even chain)
        queries = [(1, 5), (1, 2), (2, 6)]
    lines: List[str] = []
    with StreamServer(agg.servable(), stream) as server:
        # live phase: ask while ingest runs (answers carry staleness)
        for u, v in queries:
            ans = server.ask(ConnectedQuery(u, v), timeout=60)
            lines.append(
                f"live connected({u},{v}) = {bool(ans.value)} "
                f"[window {ans.window}, staleness {ans.staleness}]"
            )
        server.join(600)  # stream end: answers now staleness-0
        for u, v in queries:
            ans = server.ask(ConnectedQuery(u, v), timeout=60)
            size = server.ask(ComponentSizeQuery(u), timeout=60)
            lines.append(
                f"final connected({u},{v}) = {bool(ans.value)}, "
                f"|component({u})| = {int(size.value)} "
                f"[window {ans.window}]"
            )
        stats = server.stats.snapshot()
        for qcls, s in sorted(stats["queries"].items()):
            lines.append(
                f"{qcls}: n={s['count']} p50={s['p50_ms']:.2f}ms "
                f"p99={s['p99_ms']:.2f}ms "
                f"staleness_max={s['staleness_max']}"
            )
    return lines


def main(argv: List[str]) -> None:
    argv, device = split_cpu_flag(argv)
    if argv:
        edge_path = argv[0]
        window = int(argv[1]) if len(argv) > 1 else 64
        queries = [
            tuple(int(x) for x in q.split(","))[:2] for q in argv[2:]
        ] or None
        edges = read_edges(edge_path)
    else:
        usage("ServingQueries", "[--cpu] [edge_file] [window_size] [u,v ...]")
        edges = default_chain_edges()
        window = 16
        queries = None
    for line in run(edges, window, queries, device=device):
        print(line)


if __name__ == "__main__":
    run_main(main)
