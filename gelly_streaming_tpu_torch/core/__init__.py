"""Core of the PyTorch port: types, edge blocks, vertex dictionaries,
windowing and the stream API (counterpart of ``gelly_streaming_tpu.core``)."""

from .device import resolve_device
from .edgeblock import EdgeAccumulator, EdgeBlock, bucket_capacity
from .stream import SimpleEdgeStream, StreamContext
from .types import Edge, EdgeDirection, EventType, Vertex
from .vertexdict import VertexDict
from .window import (
    CountWindow,
    EventTimeWindow,
    ProcessingTimeWindow,
    WindowInfo,
    WindowPolicy,
    Windower,
)

__all__ = [
    "CountWindow",
    "Edge",
    "EdgeAccumulator",
    "EdgeBlock",
    "EdgeDirection",
    "EventTimeWindow",
    "EventType",
    "ProcessingTimeWindow",
    "SimpleEdgeStream",
    "StreamContext",
    "Vertex",
    "VertexDict",
    "WindowInfo",
    "WindowPolicy",
    "Windower",
    "bucket_capacity",
    "resolve_device",
]
