"""Live sharded ingest feeding an aggregation + serving stack (the port
of ``gelly_streaming_tpu/example/sharded_ingest_serving.py``).

The million-writes path (``core/ingest.py``: ``ShardedEdgeSource`` — N
TCP connections partitioned by the ``shard_of`` endpoint hash, GSEW
binary wire, bounded-queue backpressure) feeds a LIVE
``ConnectedComponents`` aggregation on the card whose summary is served
by a ``StreamServer`` while the connections are still streaming — writes
arrive over N sockets, reads are answered from the freshest published
snapshot, one process.

The peer half is the serve-from-memory load generator
(``core/ingest.py:serve_blobs``): the stream is synthesized, split with
``shard_of`` (the one partition rule), pre-encoded as GSEW frames, and
served one shard per port.

Runs on the card; ``--cpu`` runs it on the CPU instead::

    python -m gelly_streaming_tpu_torch.example.sharded_ingest_serving \
        [--cpu] [nshards] [window_size] [n_edges] [u,v ...]
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..core.device import DEFAULT_DEVICE
from ..core.ingest import (
    ShardedEdgeSource,
    ShardedEdgeStream,
    encode_shard_frames,
    partition_edges,
    serve_blobs,
)
from ..datasets import IdentityDict
from ..library import ConnectedComponents
from ..serving import ConnectedQuery, StreamServer
from .common import run_main, split_cpu_flag, usage


def run(
    nshards: int = 2,
    window_size: int = 256,
    n_edges: int = 1 << 14,
    queries: Optional[Sequence[Tuple[int, int]]] = None,
    n_vertices: int = 1 << 10,
    seed: int = 23,
    device=DEFAULT_DEVICE,
) -> List[str]:
    """Returns the printed lines (tests call this directly). ``device``
    (default ``"cuda"``, raising without a card) is where the windows
    and the CC carry live and the queries are answered."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n_vertices, n_edges, dtype=np.int64)
    dst = rng.integers(0, n_vertices, n_edges, dtype=np.int64)
    if queries is None:
        pairs = rng.integers(0, n_vertices, (4, 2))
        queries = [(int(a), int(b)) for a, b in pairs]

    parts = partition_edges(src, dst, None, nshards)
    blobs = [encode_shard_frames(s, d) for s, d, _v in parts]
    ports, threads, stop = serve_blobs(blobs)
    lines: List[str] = []
    try:
        source = ShardedEdgeSource(
            [("127.0.0.1", p) for p in ports], window=window_size
        )
        stream = ShardedEdgeStream(
            source, vertex_dict=IdentityDict(n_vertices), device=device
        )
        agg = ConnectedComponents()
        with StreamServer(agg.servable(), stream) as server:
            # live phase: ask while the sharded wire is still ingesting
            for u, v in queries:
                ans = server.ask(ConnectedQuery(u, v), timeout=120)
                lines.append(
                    f"live connected({u},{v}) = {bool(ans.value)} "
                    f"[window {ans.window}, staleness {ans.staleness}]"
                )
            server.join(600)  # all shard connections drained
            for u, v in queries:
                ans = server.ask(ConnectedQuery(u, v), timeout=120)
                lines.append(
                    f"final connected({u},{v}) = {bool(ans.value)} "
                    f"[window {ans.window}]"
                )
            stats = server.stats.snapshot()
            q = stats["queries"].get("ConnectedQuery", {})
            lines.append(
                f"served {q.get('count', 0)} queries over "
                f"{nshards}-shard live ingest "
                f"(p50={q.get('p50_ms', 0.0):.2f}ms)"
            )
    finally:
        stop.set()
        for t in threads:
            t.join(10)
    return lines


def main(argv: List[str]) -> None:
    argv, device = split_cpu_flag(argv)
    if not argv:
        usage("ShardedIngestServing",
              "[--cpu] [nshards] [window_size] [n_edges] [u,v ...]")
    nshards = int(argv[0]) if argv else 2
    window = int(argv[1]) if len(argv) > 1 else 256
    n_edges = int(argv[2]) if len(argv) > 2 else 1 << 14
    queries = [
        tuple(int(x) for x in q.split(","))[:2] for q in argv[3:]
    ] or None
    for line in run(nshards, window, n_edges, queries, device=device):
        print(line)


if __name__ == "__main__":
    run_main(main)
