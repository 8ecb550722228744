"""gelly_streaming_tpu_torch: the PyTorch/CUDA port of gelly_streaming_tpu.

A second package beside the JAX one, which stays the reference it is held
against. It runs on an NVIDIA card by default (``device="cuda"``, raising
when there is none) and on the CPU only when asked (``device="cpu"``).
Six slices run end to end so far. Streaming Connected Components, the
headline path (file -> native parse -> count windows -> forest carry)::

    from gelly_streaming_tpu_torch import CountWindow, datasets
    from gelly_streaming_tpu_torch.library import ConnectedComponents

    stream = datasets.stream_file(path, window=CountWindow(1 << 20),
                                  vertex_dict=datasets.IdentityDict(1 << 21),
                                  prefetch_depth=2)
    agg = ConnectedComponents()          # carry "auto": "forest" on a card
    for comps in stream.aggregate(agg):  # one lazy Components per window
        ...
    agg.sync()

Streaming GraphSAGE inference::

    from gelly_streaming_tpu_torch import SimpleEdgeStream, CountWindow
    from gelly_streaming_tpu_torch.datasets import IdentityDict
    from gelly_streaming_tpu_torch.models import (
        StreamingGraphSAGE, TableFeatureSource, init_graphsage)

    stream = SimpleEdgeStream((src, dst), window=CountWindow(1 << 18),
                              vertex_dict=IdentityDict(1 << 16))
    params = init_graphsage([128, 256, 128],
                            generator=torch.Generator().manual_seed(0))
    for emb in StreamingGraphSAGE(params, 128).run(
            stream, TableFeatureSource(table)):
        ...

The window and neighborhood layer: the degree streams, ``slice()`` and
the neighborhood aggregations, window triangles (user functions are
written with torch operations)::

    stream = SimpleEdgeStream(edges, window=CountWindow(1 << 20))
    for vertex, degree in stream.get_degrees():
        ...  # continuously improving, per-window change-only
    snap = stream.slice(direction=EdgeDirection.ALL)
    for vertex, total in snap.reduce_on_edges("sum"):
        ...  # per-window neighborhood aggregate
    for count, window in WindowTriangles(CountWindow(1 << 20)).run_stream(stream):
        ...  # count is a device scalar

The remaining aggregate-and-carry workloads: incremental PageRank,
bipartiteness, exact triangles and the k-spanners::

    from gelly_streaming_tpu_torch.library import (
        BipartitenessCheck, DeviceSpanner, ExactTriangleCount, IncrementalPageRank)

    pr = IncrementalPageRank(tol=1e-6, max_iter=50)
    for emission in pr.run(stream):     # iterations, l1_delta: device scalars
        ...
    for cand in stream.aggregate(BipartitenessCheck()):
        ...  # "(true,{...})" / "(false,{})", read lazily
    for batch in ExactTriangleCount().run(stream):
        ...  # change-only (vertex, count) pairs and (-1, total)
    for edges in DeviceSpanner(k=2).run(stream):
        ...  # a lazy edge-set snapshot per window

Vertex compaction on the device (any non-negative int32 ids), the
sampling triangle estimators, iterative CC and weighted matching::

    stream = datasets.stream_file(path, window=CountWindow(1 << 20),
                                  device_encode=True, dense_ids=False)
    for changed in IterativeConnectedComponents().run(stream):
        ...  # corrected (vertex, component id) pairs
    for edge_count, estimate in BroadcastTriangleCount(
            vertex_count=1 << 15, samples=1 << 21).run(edges):
        ...

Durability: periodic checkpoint barriers with keep-last-N rotation and a
supervisor that restores from the newest valid barrier after a failure,
dedupes replayed windows and restarts under bounded backoff::

    from gelly_streaming_tpu_torch import AutoCheckpoint, Supervisor

    def make_stream(vdict):  # None on a fresh start, else the restored dict
        return datasets.stream_file(path, window=CountWindow(1 << 20),
                                    vertex_dict=vdict)

    sup = Supervisor(AutoCheckpoint("run/cc.ckpt", every=4, keep=3))
    for comps in sup.run(make_stream, ConnectedComponents):
        ...  # each window once, in order, through restarts
"""

from .core.edgeblock import EdgeBlock, bucket_capacity, concat_blocks
from .aggregate.autockpt import AutoCheckpoint
from .core.snapshot import SnapshotStream
from .core.sources import GeneratorSource, SocketEdgeSource
from .core.stream import GraphStream, SimpleEdgeStream, StreamContext
from .core.types import Edge, EdgeDirection, EventType, Vertex
from .core.vertexdict import VertexDict
from .core.window import (
    CountWindow,
    EventTimeWindow,
    ProcessingTimeWindow,
    Windower,
    blocks_from_edges,
)
from .resilience import FaultPlan, RetryPolicy, Supervisor

__version__ = "0.1.0"

__all__ = [
    "AutoCheckpoint",
    "CountWindow",
    "Edge",
    "EdgeBlock",
    "EdgeDirection",
    "EventTimeWindow",
    "EventType",
    "FaultPlan",
    "GeneratorSource",
    "GraphStream",
    "ProcessingTimeWindow",
    "RetryPolicy",
    "SimpleEdgeStream",
    "SnapshotStream",
    "SocketEdgeSource",
    "StreamContext",
    "Supervisor",
    "Vertex",
    "VertexDict",
    "Windower",
    "blocks_from_edges",
    "bucket_capacity",
    "concat_blocks",
]
