"""Streaming weighted matching, 1/6-approximation, McGregor-style
(PyTorch port; a copy of ``gelly_streaming_tpu/library/matching.py``).

Placement, the same as the reference's: this algorithm is
inherently sequential — one global matching updated per edge — and the
reference runs it as a parallelism-1 flatMap
(``example/CentralizedWeightedMatching.java:56-108``). SURVEY.md §7 keeps it
host-resident; there is no batched/device formulation that preserves the
per-edge replace-iff ``w > 2·Σw(collisions)`` semantics.

One improvement over the reference: collisions are found through an
endpoint -> matched-edge index (each vertex is in at most one matched edge),
so each arrival is O(1) instead of the reference's linear scan over the
whole matching (``:80-88``).
"""

from __future__ import annotations

import enum
from typing import Iterable, Iterator, NamedTuple, Tuple

from ..core.types import Edge


class MatchingEventType(enum.Enum):
    """``util/MatchingEvent.java:26`` Type {ADD, REMOVE}."""

    ADD = "add"
    REMOVE = "remove"


class MatchingEvent(NamedTuple):
    """``util/MatchingEvent.java:24-42``."""

    type: MatchingEventType
    edge: Edge


class CentralizedWeightedMatching:
    """Maintain a weighted matching over the edge stream.

    ``run(edges)`` consumes ``(src, dst, weight)`` records (or a
    ``SimpleEdgeStream``) and yields :class:`MatchingEvent`s: a new edge
    replaces its colliding matched edges iff its weight exceeds twice their
    weight sum (the 1/6-approximation rule, ``:95-107``).
    """

    def __init__(self):
        self._by_vertex: dict = {}  # vertex -> matched Edge

    def run(self, edges) -> Iterator[MatchingEvent]:
        for s, d, w in _records(edges):
            edge = Edge(s, d, w)
            collisions = {
                id(e): e
                for e in (self._by_vertex.get(s), self._by_vertex.get(d))
                if e is not None
            }.values()
            if w > 2 * sum(e.val for e in collisions):
                for e in collisions:
                    self._by_vertex.pop(e.src, None)
                    self._by_vertex.pop(e.dst, None)  # same key for self-loops
                    yield MatchingEvent(MatchingEventType.REMOVE, e)
                self._by_vertex[s] = edge
                self._by_vertex[d] = edge
                yield MatchingEvent(MatchingEventType.ADD, edge)

    def state_dict(self) -> dict:
        """Checkpoint surface (``aggregate/checkpoint.py:save_workload``)."""
        return {"by_vertex": dict(self._by_vertex)}

    def load_state_dict(self, d: dict) -> None:
        # a checkpoint of either package: its (src, dst, val) records
        # become this package's Edge
        self._by_vertex = {v: Edge(*e) for v, e in d["by_vertex"].items()}

    def matching(self) -> set:
        """The current matched edge set."""
        return {e for e in self._by_vertex.values()}

    def total_weight(self) -> float:
        return sum(e.val for e in self.matching())


def _records(edges) -> Iterable[Tuple]:
    if hasattr(edges, "get_edges"):  # SimpleEdgeStream
        for e in edges.get_edges():
            yield (e.src, e.dst, e.val)
    else:
        for s, d, w, *_ in edges:
            yield (s, d, w)
