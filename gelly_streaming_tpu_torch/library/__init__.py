"""Library workloads of the PyTorch port."""

from .connected_components import ConnectedComponents, ConnectedComponentsTree
from .degrees import DegreeDistribution
from .triangles import ExactTriangleCount, WindowTriangles

__all__ = [
    "ConnectedComponents",
    "ConnectedComponentsTree",
    "DegreeDistribution",
    "ExactTriangleCount",
    "WindowTriangles",
]
