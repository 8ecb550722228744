"""Models of the PyTorch port: streaming GraphSAGE and GCN, their forward
(on one device or edge-sharded over a mesh) and their training (on one
device, or data-parallel over the mesh's edge axis and tensor-parallel
over its model axis)."""

from .convert import params_from_numpy
from .gcn import gcn_forward, gcn_layer, init_gcn
from .graphsage import (
    StreamingGraphSAGE,
    TableFeatureSource,
    init_graphsage,
    make_sharded_forward,
    make_sharded_train_step,
    mean_aggregate,
    sage_forward,
    sage_layer,
)
from .training import (
    OptState,
    gather_gnn_params,
    make_sharded_train_step as make_gnn_train_step,
    mse_loss,
    shard_gnn_params,
    softmax_xent_loss,
)

__all__ = [
    "OptState",
    "StreamingGraphSAGE",
    "TableFeatureSource",
    "gather_gnn_params",
    "gcn_forward",
    "gcn_layer",
    "init_gcn",
    "init_graphsage",
    "make_gnn_train_step",
    "make_sharded_forward",
    "make_sharded_train_step",
    "mean_aggregate",
    "mse_loss",
    "params_from_numpy",
    "sage_forward",
    "sage_layer",
    "shard_gnn_params",
    "softmax_xent_loss",
]
