"""Library workloads of the PyTorch port."""

from ..summaries.candidates import Candidates
from ..summaries.disjointset import DisjointSet
from .bipartiteness import BipartitenessCheck
from .connected_components import ConnectedComponents, ConnectedComponentsTree
from .degrees import DegreeDistribution
from .iterative_cc import IterativeConnectedComponents
from .matching import CentralizedWeightedMatching, MatchingEvent, MatchingEventType
from .pagerank import IncrementalPageRank
from .sampling import BroadcastTriangleCount, IncidenceSamplingTriangleCount
from .spanner import DeviceSpanner, Spanner
from .triangles import ExactTriangleCount, WindowTriangles

__all__ = [
    "BipartitenessCheck",
    "BroadcastTriangleCount",
    "Candidates",
    "CentralizedWeightedMatching",
    "ConnectedComponents",
    "ConnectedComponentsTree",
    "DegreeDistribution",
    "DeviceSpanner",
    "DisjointSet",
    "ExactTriangleCount",
    "IncidenceSamplingTriangleCount",
    "IncrementalPageRank",
    "IterativeConnectedComponents",
    "MatchingEvent",
    "MatchingEventType",
    "Spanner",
    "WindowTriangles",
]
