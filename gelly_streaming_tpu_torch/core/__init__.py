"""Core of the PyTorch port: types, edge blocks, vertex dictionaries,
windowing and the stream API (counterpart of ``gelly_streaming_tpu.core``)."""

from .device import resolve_device
from .edgeblock import EdgeAccumulator, EdgeBlock, bucket_capacity, concat_blocks
from .snapshot import SnapshotStream
from .stream import GraphStream, SimpleEdgeStream, StreamContext
from .types import Edge, EdgeDirection, EventType, Vertex
from .vertexdict import VertexDict
from .window import (
    CountWindow,
    EventTimeWindow,
    ProcessingTimeWindow,
    ScheduledCountWindow,
    WindowInfo,
    WindowPolicy,
    Windower,
    blocks_from_edges,
)

__all__ = [
    "CountWindow",
    "Edge",
    "EdgeAccumulator",
    "EdgeBlock",
    "EdgeDirection",
    "EventTimeWindow",
    "EventType",
    "GraphStream",
    "ProcessingTimeWindow",
    "ScheduledCountWindow",
    "SimpleEdgeStream",
    "SnapshotStream",
    "StreamContext",
    "Vertex",
    "VertexDict",
    "WindowInfo",
    "WindowPolicy",
    "Windower",
    "blocks_from_edges",
    "bucket_capacity",
    "concat_blocks",
    "resolve_device",
]
