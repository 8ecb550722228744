"""Models of the PyTorch port: streaming GraphSAGE (forward)."""

from .convert import params_from_numpy
from .graphsage import (
    StreamingGraphSAGE,
    TableFeatureSource,
    init_graphsage,
    mean_aggregate,
    sage_forward,
    sage_layer,
)

__all__ = [
    "StreamingGraphSAGE",
    "TableFeatureSource",
    "init_graphsage",
    "mean_aggregate",
    "params_from_numpy",
    "sage_forward",
    "sage_layer",
]
