"""API-parity analogs of the reference's ``util/`` tuple types (PyTorch
port; a copy of ``gelly_streaming_tpu/utils/types.py``).

These are host-side emission/message records. On the device their roles
are played by dense tensors (the signed double cover replaces per-record
``SignedVertex`` flows, sampler state vectors replace routed
``SampledEdge``/``TriangleEstimate`` messages); the types remain for users
porting reference code that pattern-matches on them.
"""

from __future__ import annotations

from typing import NamedTuple

from ..core.types import Edge


class SignedVertex(NamedTuple):
    """``util/SignedVertex.java:23-41``: (vertex, sign) with ``reverse()``."""

    vertex: int
    sign: bool

    def reverse(self) -> "SignedVertex":
        return SignedVertex(self.vertex, not self.sign)


class SampledEdge(NamedTuple):
    """``util/SampledEdge.java:26-56``: routed sample message
    (subtask, instance, edge, edgeCount, resample)."""

    subtask: int
    instance: int
    edge: Edge
    edge_count: int
    resample: bool


class TriangleEstimate(NamedTuple):
    """``util/TriangleEstimate.java:25-44``: partial estimator message
    (sourceSubtask, edgeCount, beta)."""

    source: int
    edge_count: int
    beta: int
