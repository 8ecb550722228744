"""Crash flight recorder: a bounded ring of the last N events per worker
(the port's copy of ``gelly_streaming_tpu/obs/flight.py``).

A killed worker's full event log tells the whole story — but only if it
made it to disk, and only if someone goes digging. The flight recorder
is the black box: a small in-memory ring of the most recent events and
spans, dumped ATOMICALLY (checksummed container + temp-and-replace, the
``resilience/integrity.py`` commit discipline) at the moment of death — a
supervisor restart, a ``FaultPlan`` kill firing ``os._exit`` — so every
failure report carries the last seconds of telemetry that led up to it.

Wiring mirrors ``resilience/faults.py``: construct a
:class:`FlightRecorder` and :func:`install` it; installation attaches it as
a sink on BOTH event sources (tracer + global registry), and the crash
sites (``Supervisor``, ``faults.fire``'s kill path, ``StreamServer``'s
worker, ``ClusterSupervisor`` via its workers' dump files) call
:func:`dump_installed` — a no-op costing one module attribute check when
nothing is installed.

ZERO DISABLED OVERHEAD is contractual: the recorder is attached as an
always-on sink — resilience counters fire with obs disabled — so the RING
WRITE ITSELF gates on ``obs.enable()``. Disabled runs pay one flag check per event and
allocate nothing.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import List, Optional

from . import trace as _trace

#: default ring capacity — small on purpose: the black box holds the
#: last seconds before death, not the flight
DEFAULT_CAPACITY = 256


class FlightRecorder:
    """Bounded event ring + atomic crash dumps.

    ``path`` is the dump base name: the first :meth:`dump` commits
    there, later dumps (one per restart, say) commit to ``path.2``,
    ``path.3``, ... so no black box overwrites an earlier one.
    ``shard`` tags dumps (and ring events at dump time) with the
    worker's shard id for cluster-level collection.
    """

    def __init__(
        self,
        path: Optional[str] = None,
        *,
        capacity: int = DEFAULT_CAPACITY,
        shard: Optional[int] = None,
    ):
        self.path = path
        self.capacity = int(capacity)
        self.shard = None if shard is None else int(shard)
        self._ring: deque = deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        self._dumps = 0

    # -- sink side ------------------------------------------------------ #
    def emit(self, event: dict) -> None:
        """Record one event. Gated on ``obs.enable()`` — the recorder
        rides the always-on sink path, so this check IS the disabled-
        mode zero-cost bound (see module doc)."""
        if _trace.on():
            with self._lock:
                self._ring.append(event)

    def note(self, name: str, **attrs) -> None:
        """Record a marker event directly (bypasses the registry; still
        gated — markers are telemetry, not operational state)."""
        if _trace.on():
            e = {"kind": "note", "name": name, "ts": time.time()}
            if attrs:
                e["attrs"] = attrs
            with self._lock:
                self._ring.append(e)

    def snapshot(self) -> List[dict]:
        with self._lock:
            return list(self._ring)

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    # -- crash side ----------------------------------------------------- #
    def dump(self, reason: str, path: Optional[str] = None,
             **extra) -> Optional[str]:
        """Atomically commit the ring as a checksummed dump file;
        returns the path (None when no path is configured). Safe at the
        worst moment: the write is temp-and-replace in the target
        directory, the payload is CRC-framed, and any failure to commit
        is swallowed WITH a registry count — a dying worker must never
        die twice in its own post-mortem."""
        from ..resilience import integrity as _integrity

        with self._lock:
            events = list(self._ring)
            self._dumps += 1
            n = self._dumps
        out = path or self.path
        if out is None:
            return None
        if n > 1:
            out = f"{out}.{n}"
        doc = {
            "kind": "flight",
            "reason": reason,
            "ts": time.time(),
            "pid": os.getpid(),
            "shard": self.shard,
            "n_events": len(events),
            "events": events,
        }
        if extra:
            doc["attrs"] = extra
        try:
            data = _integrity.wrap_checksummed(
                json.dumps(doc).encode("utf-8")
            )
            d = os.path.dirname(out)
            if d:
                os.makedirs(d, exist_ok=True)
            tmp = out + ".tmp"
            with open(tmp, "wb") as f:
                f.write(data)
            _integrity.replace_atomic(tmp, out)
        except Exception:
            from .registry import get_registry

            # crash-path best effort: the death being recorded matters
            # more than the recording; count the loss so it is visible
            get_registry().counter(
                "obs.swallowed", site="flight_dump"
            ).inc()
            return None
        return out


def read_dump(path: str) -> dict:
    """Load and validate one dump file (checksummed container). The
    container self-describes and the reader holds it to that (the
    symmetry of :meth:`FlightRecorder.dump`): ``kind`` must be
    ``"flight"`` and ``n_events`` must match the shipped ring — a
    CRC-valid file that is not a flight dump is rejected rather than
    mis-parsed into an empty black box."""
    from ..resilience import integrity as _integrity

    with open(path, "rb") as f:
        data = f.read()
    doc = json.loads(
        _integrity.unwrap_checksummed(data, origin=f"flight dump {path}")
    )
    if doc.get("kind") != "flight":
        raise ValueError(
            f"{path}: not a flight dump (kind={doc.get('kind')!r})")
    events = doc.get("events")
    if not isinstance(events, list) or doc.get("n_events") != len(events):
        raise ValueError(
            f"{path}: inconsistent flight dump "
            f"(n_events does not match the shipped ring)")
    return doc


# --------------------------------------------------------------------- #
# Global installation (one cheap check at the crash sites)
# --------------------------------------------------------------------- #
_RECORDER: Optional[FlightRecorder] = None
_LOCK = threading.Lock()


def installed() -> Optional[FlightRecorder]:
    return _RECORDER


def install(recorder: Optional[FlightRecorder]) -> Optional[FlightRecorder]:
    """Install ``recorder`` as THE process flight recorder and attach it
    to both event sources (tracer + global registry); returns it. A
    previously installed recorder is detached first. ``None``
    uninstalls."""
    global _RECORDER
    from .registry import get_registry

    with _LOCK:
        if _RECORDER is not None:
            _trace.remove_sink(_RECORDER)
            get_registry().remove_sink(_RECORDER)
        _RECORDER = recorder
        if recorder is not None:
            _trace.add_sink(recorder)
            get_registry().add_sink(recorder)
        return recorder


def uninstall() -> None:
    install(None)


def dump_installed(reason: str, path: Optional[str] = None,
                   **extra) -> Optional[str]:
    """Dump the installed recorder (no-op when none is installed) —
    the one-liner every crash site calls."""
    rec = _RECORDER
    if rec is None:
        return None
    return rec.dump(reason, path=path, **extra)


def find_dumps(directory: str) -> List[str]:
    """Every flight dump under ``directory`` (non-recursive), oldest first
    — the collection pass ``ClusterSupervisor`` runs over its workers'
    black boxes."""
    try:
        names = os.listdir(directory)
    except OSError:
        return []
    hits = [
        os.path.join(directory, n)
        for n in names
        if "flight" in n and not n.endswith(".tmp")
        and os.path.isfile(os.path.join(directory, n))
    ]
    hits.sort(key=lambda p: (os.path.getmtime(p), p))
    return hits
