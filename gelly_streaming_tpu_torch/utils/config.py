"""Typed engine configuration + CLI parsing (PyTorch port of
``gelly_streaming_tpu/utils/config.py``, SURVEY.md §5).

The reference's "config system" is per-example positional-arg parsing with
hard-coded defaults (``ConnectedComponentsExample.java:78-102``) and engine
knobs as constructor params (``mergeWindowTime``, ``transientState``, tree
``degree``). One small typed config object + CLI, nothing fancier.
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Optional

from ..core.device import DEFAULT_DEVICE
from ..core.window import CountWindow, EventTimeWindow, WindowPolicy


@dataclasses.dataclass
class EngineConfig:
    """Engine-level knobs, the analogs of the reference's ctor params."""

    #: edges per merge window (CountWindow) — the mergeWindowTime analog
    window_size: int = 1 << 16
    #: event-time window span instead of a count window (when set)
    window_time: Optional[float] = None
    #: reset the running summary after each emission
    #: (``SummaryAggregation.java:113-115``)
    transient_state: bool = False
    #: tree-reduce fan-in, API parity (``SummaryTreeReduce.java:75``)
    tree_degree: int = 2
    #: fixed EdgeBlock capacity override (else power-of-two bucketing)
    capacity: Optional[int] = None
    #: edge-axis shards for a device mesh (None = all devices)
    edge_shards: Optional[int] = None
    #: run the vertex mapping on the device — see
    #: ``datasets.stream_file``. With ``id_bound`` set, the device table
    #: covers the declared dense id space; with ``id_bound=0`` this is the
    #: general arbitrary-id path (growth mode, exact host-side novelty
    #: tracking, no device-to-host reads)
    device_encode: bool = False
    #: raw id-space bound for identity/device vertex mappings (0 = general:
    #: host dictionary, or device growth mode under ``device_encode``)
    id_bound: int = 0

    def window(self, timestamp_fn=None) -> WindowPolicy:
        if self.window_time is not None:
            return EventTimeWindow(self.window_time, timestamp_fn=timestamp_fn)
        return CountWindow(self.window_size)

    def open_stream(self, path: str, device=DEFAULT_DEVICE):
        """``datasets.stream_file`` on ``device`` with this config's ingest
        knobs."""
        from .. import datasets

        kw = {}
        if self.device_encode:
            kw = dict(
                device_encode=True, min_vertex_capacity=self.id_bound,
                dense_ids=bool(self.id_bound),
            )
        elif self.id_bound:
            kw = dict(vertex_dict=datasets.IdentityDict(self.id_bound))
        return datasets.stream_file(path, window=self.window(), device=device, **kw)

    @staticmethod
    def add_args(parser: argparse.ArgumentParser) -> None:
        g = parser.add_argument_group("engine")
        g.add_argument("--window-size", type=int, default=1 << 16)
        g.add_argument("--window-time", type=float, default=None)
        g.add_argument("--transient-state", action="store_true")
        g.add_argument("--tree-degree", type=int, default=2)
        g.add_argument("--capacity", type=int, default=None)
        g.add_argument("--edge-shards", type=int, default=None)
        g.add_argument("--device-encode", action="store_true")
        g.add_argument("--id-bound", type=int, default=0)

    @classmethod
    def from_args(cls, ns: argparse.Namespace) -> "EngineConfig":
        return cls(
            window_size=ns.window_size,
            window_time=ns.window_time,
            transient_state=ns.transient_state,
            tree_degree=ns.tree_degree,
            capacity=ns.capacity,
            edge_shards=ns.edge_shards,
            device_encode=ns.device_encode,
            id_bound=ns.id_bound,
        )
