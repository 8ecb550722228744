"""Library workloads of the PyTorch port."""

from .bipartiteness import BipartitenessCheck
from .connected_components import ConnectedComponents, ConnectedComponentsTree
from .degrees import DegreeDistribution
from .pagerank import IncrementalPageRank
from .spanner import DeviceSpanner, Spanner
from .triangles import ExactTriangleCount, WindowTriangles
from ..summaries.candidates import Candidates

__all__ = [
    "BipartitenessCheck",
    "Candidates",
    "ConnectedComponents",
    "ConnectedComponentsTree",
    "DegreeDistribution",
    "DeviceSpanner",
    "ExactTriangleCount",
    "IncrementalPageRank",
    "Spanner",
    "WindowTriangles",
]
