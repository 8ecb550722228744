"""The sharded-serving router (``gelly_streaming_tpu/serving/router.py``):
not ported yet.

The routing tier (the vertex-ownership partition over N shard servers,
scatter-gather fan-out with the cross-shard CC union, the hot-key answer
cache, per-shard failover, ``ShardRouter(autotune=)``) comes with ROADMAP
Queue 1, slice 9b. Its public names are defined here and raise
``NotImplementedError`` naming that slice, so a caller learns where the
work stands instead of meeting an ``ImportError``.
"""

from __future__ import annotations

from .rpc import SLICE_9B


def _not_ported(what: str):
    raise NotImplementedError(f"{what} is ported in {SLICE_9B}")


class ShardRouter:
    """Not ported yet: raises ``NotImplementedError`` (slice 9b)."""

    def __init__(self, *args, **kwargs):
        _not_ported("ShardRouter")


def decode_pull(doc):
    """Not ported yet: raises ``NotImplementedError`` (slice 9b)."""
    _not_ported("decode_pull")


def demo_shard_edges(n_vertices, n_edges, seed, *args, **kwargs):
    """Not ported yet: raises ``NotImplementedError`` (slice 9b)."""
    _not_ported("demo_shard_edges")


def shard_demo_payloads(*args, **kwargs):
    """Not ported yet: raises ``NotImplementedError`` (slice 9b)."""
    _not_ported("shard_demo_payloads")


def router_main(cfg):
    """Not ported yet: raises ``NotImplementedError`` (slice 9b)."""
    _not_ported("router_main")


def spawn_router(cfg):
    """Not ported yet: raises ``NotImplementedError`` (slice 9b)."""
    _not_ported("spawn_router")
