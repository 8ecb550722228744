"""Core value types of the streaming-graph framework (PyTorch port).

A copy of ``gelly_streaming_tpu/core/types.py``. The Gelly tuple types:

- ``Edge`` mirrors the ``org.apache.flink.graph.Edge`` 3-tuple used throughout
  the reference API (e.g. ``SimpleEdgeStream.java:69``).
- ``EdgeDirection`` mirrors Gelly's ``EdgeDirection`` used by ``slice``
  (``SimpleEdgeStream.java:135-167``).
- ``EventType`` mirrors ``EventType.java:24-27`` (EDGE_ADDITION/EDGE_DELETION),
  the reference's only support for fully-dynamic streams (used by
  ``example/DegreeDistribution.java``).

Unlike the reference (boxed Java tuples flowing one record at a time through
Flink operators), edges here only exist host-side as lightweight tuples for
ingest/emission; on device they are always batched into padded
:class:`~gelly_streaming_tpu_torch.core.edgeblock.EdgeBlock` tensors.
"""

from __future__ import annotations

import enum
from typing import Any, NamedTuple


class EdgeDirection(enum.Enum):
    """Which neighborhood an operation ranges over (cf. Gelly EdgeDirection)."""

    IN = "in"
    OUT = "out"
    ALL = "all"


class EventType(enum.Enum):
    """Edge event kind for fully-dynamic streams (``EventType.java:24-27``)."""

    EDGE_ADDITION = "+"
    EDGE_DELETION = "-"


class Edge(NamedTuple):
    """A single host-side edge record: (src, dst, value).

    Mirrors Gelly's ``Edge<K, EV>``; ``value`` may be ``None`` for unweighted
    graphs (the reference's ``NullValue``).
    """

    src: int
    dst: int
    val: Any = None

    def reverse(self) -> "Edge":
        return Edge(self.dst, self.src, self.val)


class Vertex(NamedTuple):
    """A host-side vertex record (cf. Gelly ``Vertex<K, VV>``)."""

    id: int
    val: Any = None
