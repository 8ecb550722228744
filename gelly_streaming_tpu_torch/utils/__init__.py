"""Host-side helpers of the PyTorch port (copies of the
``gelly_streaming_tpu.utils`` modules): record types, per-window profiling,
the engine config and the sorted-run key set."""

from .config import EngineConfig
from .profiling import StreamProfiler, WindowStats, device_trace, profiled
from .types import SampledEdge, SignedVertex, TriangleEstimate

__all__ = [
    "EngineConfig",
    "SampledEdge",
    "SignedVertex",
    "StreamProfiler",
    "TriangleEstimate",
    "WindowStats",
    "device_trace",
    "profiled",
]
