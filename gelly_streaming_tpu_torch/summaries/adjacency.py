"""AdjacencyListGraph: host adjacency + hop-bounded BFS (the spanner oracle).

The port's copy of ``gelly_streaming_tpu/summaries/adjacency.py`` (host
only). Port-parity twin of ``summaries/AdjacencyListGraph.java:29-140``:
an undirected adjacency map with a level-tagged bounded BFS used by the
k-spanner's distance test. The spanner's per-edge decision ("is there
already a path of <= k hops?") is inherently sequential in arrival order, and
the reference runs it inside a parallelism-bound window fold — SURVEY.md §7
keeps it host-side (build order step 5), with the same API, so the algorithm
slots into the aggregation engine as a host-state summary.
"""

from __future__ import annotations

from collections import deque
from typing import Dict, Set


class AdjacencyListGraph:
    """Undirected adjacency map + bounded BFS (``AdjacencyListGraph.java``)."""

    def __init__(self) -> None:
        self.adj: Dict[int, Set[int]] = {}

    def add_edge(self, u: int, v: int) -> None:
        """Insert undirected (both directions — ``AdjacencyListGraph.java:46-67``)."""
        self.adj.setdefault(u, set()).add(v)
        self.adj.setdefault(v, set()).add(u)

    def has_edge(self, u: int, v: int) -> bool:
        return v in self.adj.get(u, ())

    def bounded_bfs(self, src: int, trg: int, k: int) -> bool:
        """True iff a path src->trg of at most k hops exists
        (``AdjacencyListGraph.java:79-116``)."""
        if src not in self.adj or trg not in self.adj:
            return False
        if src == trg:
            return True
        q: deque = deque([(src, 0)])
        visited = {src}
        while q:
            node, depth = q.popleft()
            if depth >= k:
                continue
            for nbr in self.adj.get(node, ()):
                if nbr == trg:
                    return True
                if nbr not in visited:
                    visited.add(nbr)
                    q.append((nbr, depth + 1))
        return False

    def edges(self):
        """Yield each undirected edge once (u <= v)."""
        for u, nbrs in self.adj.items():
            for v in nbrs:
                if u <= v:
                    yield u, v

    def num_edges(self) -> int:
        return sum(1 for _ in self.edges())

    def copy(self) -> "AdjacencyListGraph":
        g = AdjacencyListGraph()
        g.adj = {u: set(nbrs) for u, nbrs in self.adj.items()}
        return g

    def reset(self) -> None:
        self.adj.clear()
