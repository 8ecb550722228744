"""Summaries of the PyTorch port: dense labels, the forest carry, the
group-fold contract, the signed double cover (bipartiteness), the host
adjacency of the spanner and the host union-find twin."""

from .adjacency import AdjacencyListGraph
from .candidates import Candidates, cover_fold, cover_grow, init_cover
from .disjointset import DisjointSet
from .labels import Components, cc_fold, grow_labels, init_labels, label_combine

__all__ = [
    "AdjacencyListGraph",
    "Candidates",
    "Components",
    "DisjointSet",
    "cc_fold",
    "cover_fold",
    "cover_grow",
    "grow_labels",
    "init_cover",
    "init_labels",
    "label_combine",
]
