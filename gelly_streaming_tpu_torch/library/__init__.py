"""Library workloads of the PyTorch port."""

from .connected_components import ConnectedComponents, ConnectedComponentsTree

__all__ = ["ConnectedComponents", "ConnectedComponentsTree"]
