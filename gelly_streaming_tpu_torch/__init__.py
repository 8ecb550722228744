"""gelly_streaming_tpu_torch: the PyTorch/CUDA port of gelly_streaming_tpu.

A second package beside the JAX one, which stays the reference it is held
against. It runs on an NVIDIA card by default (``device="cuda"``, raising
when there is none) and on the CPU only when asked (``device="cpu"``).
Two slices run end to end so far. Streaming Connected Components, the
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
"""

from .core.edgeblock import EdgeBlock, bucket_capacity, concat_blocks
from .core.stream import SimpleEdgeStream, StreamContext
from .core.vertexdict import VertexDict
from .core.window import CountWindow

__version__ = "0.1.0"

__all__ = [
    "CountWindow",
    "EdgeBlock",
    "SimpleEdgeStream",
    "StreamContext",
    "VertexDict",
    "bucket_capacity",
    "concat_blocks",
]
