"""Host-side DisjointSet: API/verification twin of the dense device labels
(PyTorch port; a copy of ``gelly_streaming_tpu/summaries/disjointset.py``).

The reference's per-partition CC state is a pointer-chasing union-find over
HashMaps (``summaries/DisjointSet.java:30-154``: ``makeSet``/``find`` with
path compression/``union`` by rank/``merge``). Pointer-chasing cannot run on
an accelerator; the device-side equivalent is the dense label array in
``summaries/labels.py``. This host twin exists for three reasons:

1. API parity — users of the reference receive ``DisjointSet`` objects from
   ``aggregate(new ConnectedComponents(...))``; the device CC emits
   :class:`Components`, and this class converts/compares.
2. Differential testing — tests union the same edges here and check the
   device labels produce identical partitions.
3. Host algorithms (spanner combine) that genuinely want a union-find.

``__str__`` reproduces the Java ``toString`` shape
(``DisjointSet.java:139-153``): ``{root=[v1, v2], ...}`` — the format the
reference's ConnectedComponentsTest parses.
"""

from __future__ import annotations

from typing import Dict, Iterable, List


class DisjointSet:
    """Union-find with path compression and union by rank."""

    def __init__(self, elements: Iterable[int] = ()):  # noqa: D401
        self._parent: Dict[int, int] = {}
        self._rank: Dict[int, int] = {}
        for e in elements:
            self.make_set(e)

    def make_set(self, e: int) -> None:
        if e not in self._parent:
            self._parent[e] = e
            self._rank[e] = 0

    def find(self, e: int) -> int | None:
        """Root of ``e``'s set (path-compressing), or None if unseen
        (``DisjointSet.java:71-85``)."""
        if e not in self._parent:
            return None
        root = e
        while self._parent[root] != root:
            root = self._parent[root]
        while self._parent[e] != root:  # compress
            self._parent[e], e = root, self._parent[e]
        return root

    def union(self, a: int, b: int) -> None:
        """Union by rank (``DisjointSet.java:97-123``)."""
        self.make_set(a)
        self.make_set(b)
        ra, rb = self.find(a), self.find(b)
        if ra == rb:
            return
        if self._rank[ra] < self._rank[rb]:
            ra, rb = rb, ra
        self._parent[rb] = ra
        if self._rank[ra] == self._rank[rb]:
            self._rank[ra] += 1

    def merge(self, other: "DisjointSet") -> None:
        """Absorb another union-find, naive-hash-join style
        (``DisjointSet.java:132-136``)."""
        for e, p in other._parent.items():
            self.union(e, p)

    # ------------------------------------------------------------------ #
    def elements(self) -> List[int]:
        return list(self._parent)

    def components(self) -> Dict[int, List[int]]:
        """root -> sorted member list."""
        comps: Dict[int, List[int]] = {}
        for e in self._parent:
            comps.setdefault(self.find(e), []).append(e)
        return {r: sorted(m) for r, m in comps.items()}

    def component_sets(self) -> List[frozenset]:
        return [frozenset(m) for m in self.components().values()]

    def __len__(self) -> int:
        return len(self._parent)

    def __str__(self) -> str:
        comps = self.components()
        inner = ", ".join(
            f"{root}={members}" for root, members in sorted(comps.items())
        )
        return "{" + inner + "}"
