"""Elastic resharding (``gelly_streaming_tpu/serving/reshard.py``): not
ported yet.

One-winner split plans elected over the fabric, child-address
publication, the actionable-prefix rule and the :class:`ReshardWatcher`
belong to the routing tier, ROADMAP Queue 1, slice 9b. Its public names
are defined here and raise ``NotImplementedError`` naming that slice.
"""

from __future__ import annotations

from .rpc import SLICE_9B


def _not_ported(what: str):
    raise NotImplementedError(f"{what} is ported in {SLICE_9B}")


class ReshardWatcher:
    """Not ported yet: raises ``NotImplementedError`` (slice 9b)."""

    def __init__(self, *args, **kwargs):
        _not_ported("ReshardWatcher")


def plan_tag(epoch):
    """Not ported yet: raises ``NotImplementedError`` (slice 9b)."""
    _not_ported("plan_tag")


def addr_tag(epoch):
    """Not ported yet: raises ``NotImplementedError`` (slice 9b)."""
    _not_ported("addr_tag")


def propose_split(store, epoch, *args, **kwargs):
    """Not ported yet: raises ``NotImplementedError`` (slice 9b)."""
    _not_ported("propose_split")


def read_plan(store, epoch):
    """Not ported yet: raises ``NotImplementedError`` (slice 9b)."""
    _not_ported("read_plan")


def publish_addr(store, epoch, addr):
    """Not ported yet: raises ``NotImplementedError`` (slice 9b)."""
    _not_ported("publish_addr")


def read_addr(store, epoch):
    """Not ported yet: raises ``NotImplementedError`` (slice 9b)."""
    _not_ported("read_addr")


def actionable_plans(store):
    """Not ported yet: raises ``NotImplementedError`` (slice 9b)."""
    _not_ported("actionable_plans")
