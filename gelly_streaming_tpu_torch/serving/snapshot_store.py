"""Wait-free snapshot publication: the serving stack's write/read split
(the port's copy of ``gelly_streaming_tpu/serving/snapshot_store.py``).

The ingest loop must never block on readers and readers must never block
on ingest — the same discipline as the producer loop's zero-D2H rule
(``core/pipeline.py``). The contract here:

- A snapshot is an IMMUTABLE :class:`PublishedSnapshot`: payload arrays
  are never mutated after publish. Torch tensors CAN be written in place,
  so this is a rule every servable keeps: each window's fold publishes a
  buffer that no later window writes (the forest commit allocates fresh,
  the host carry's mirror update clones, the dense and degree steps are
  functional), and the previous window's buffer stays alive for any
  reader still holding it (the same property that makes per-window lazy
  emissions valid snapshots, ``summaries/forest.py``).
- Publication is ONE reference assignment. CPython guarantees attribute
  stores are atomic under the GIL, so a reader either sees the old
  snapshot or the new one, never a torn mix — the double-buffer swap of
  a classic seqlock without the retry loop, because the buffers behind
  the references are frozen.
- Readers call :meth:`SnapshotStore.latest` — one attribute read, no
  lock, O(1) regardless of writer activity. The store's lock exists only
  for :meth:`wait_for` (condition-variable sleeps of readers who want a
  *newer* snapshot than the current one); the writer grabs it just to
  notify, after the swap is already visible.
"""

from __future__ import annotations

import itertools
import os
import pickle
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch

from ..obs.registry import get_registry


def _ready_event(payload):
    """A CUDA event recorded behind the work that produces the payload's
    device tensors (None for a host payload). Recorded at publish on the
    publishing thread's current stream of the tensor's own device: the
    window's fold was enqueued there just before, so the event completes
    when the snapshot's tensors have materialized. The port's stand-in
    for ``jax.Array.is_ready``."""
    for v in payload.values():
        if isinstance(v, torch.Tensor) and v.is_cuda:
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(v.device))
            return ev
    return None


def _payload_ready(payload) -> bool:
    """True when every value of the payload has finished computing: a CUDA
    tensor when its device's current stream has no work left (a sound,
    conservative stand-in for ``jax.Array.is_ready``: the stream may also
    hold later work), an object with ``is_ready`` when that says so; host
    arrays and other objects count as ready."""
    for v in payload.values():
        if isinstance(v, torch.Tensor):
            if v.is_cuda and not torch.cuda.current_stream(v.device).query():
                return False
            continue
        ready = getattr(v, "is_ready", None)
        if ready is not None:
            try:
                if not ready():
                    return False
            except Exception:
                # a broken is_ready probe must never break a read (the
                # value counts as ready), but it is evidence the payload
                # contract is off, so it stays visible
                get_registry().counter(
                    "serving.swallowed", site="payload_ready_probe"
                ).inc()
    return True


def _snap_ready(snap: "PublishedSnapshot") -> bool:
    """True when the snapshot's device tensors have finished computing
    (a host payload is always ready)."""
    return snap.ready is None or snap.ready.query()


@dataclass(frozen=True)
class PublishedSnapshot:
    """One published summary state.

    ``payload`` is a workload-defined mapping (see the ``servable()``
    adapters) whose arrays must never be mutated after publish. The one
    non-array member is the ``vdict`` entry: the LIVE vertex dictionary,
    which is append-only (existing raw->compact mappings never change)
    and whose lookup paths are safe against concurrent ingest (native
    mutex / atomic index snapshot) — a reader may see a few ids newer
    than the snapshot's tables, which the engines treat as unseen-or-
    self-rooted, never inconsistent.
    ``window`` is the index of the last window folded in (``-1`` for a
    checkpoint boot snapshot published before any live window).
    ``watermark`` is a monotone progress counter — cumulative edges or
    events folded when the servable can count them cheaply, else the
    window index — so staleness is meaningful even across restores.
    ``epoch`` is the publishing STORE's process-unique nonce: version
    numbers restart from 1 when a store is rebuilt (a promoted standby,
    a restarted replica), so any cache keyed on version alone can serve
    a stale entry across a store swap at a coincidentally-equal
    version. Caches key on ``(epoch, version)`` instead; 0 marks a
    hand-built snapshot that never went through a store.
    ``event_ts`` is the EVENT-TIME watermark the summaries were built
    at (``-1`` when the pipeline carries no event time) — the stamp
    answers forward so a consumer can tell "how far behind the world"
    an answer is, next to ``staleness``'s "how far behind the head".
    ``boot`` is the store's CROSS-PROCESS lineage nonce:
    ``epoch`` is process-local, so a snapshot-pinned transaction
    talking through the wire needs a stamp that survives serialization
    and distinguishes a restarted store whose version counter happens
    to pass the pinned number. A standby following a mirror ADOPTS the
    primary's boot, so promotion preserves the lineage a pin names;
    a cold restart mints a new one and honestly expires old pins.
    ``ready`` is the CUDA event recorded at publish behind the payload's
    device work (None for host payloads); ``prefer_ready`` reads query
    it.
    """

    payload: Mapping[str, Any]
    window: int
    watermark: int
    version: int
    published_at: float = field(default_factory=time.monotonic)
    epoch: int = 0
    event_ts: int = -1
    boot: str = ""
    ready: Any = field(default=None, compare=False, repr=False)


class SnapshotStore:
    """Single-writer, many-reader snapshot cell.

    The writer (the server's ingest thread) calls :meth:`publish` once
    per window; any number of reader threads call :meth:`latest`
    wait-free. ``version`` increases by one per publish, so readers can
    detect progress without comparing payloads.
    """

    #: how many recent snapshots stay reachable for ``prefer_ready``
    #: reads (beyond the newest); the windows-behind-head staleness a
    #: latency-preferring reader can be handed is bounded by this
    READY_LOOKBACK = 3

    #: process-wide epoch allocator: each store instance gets a distinct
    #: nonce so (epoch, version) pairs never collide across store swaps
    _epochs = itertools.count(1)

    def __init__(self, *, retention: Optional[int] = None):
        self.epoch = next(SnapshotStore._epochs)
        # cross-process lineage nonce (see PublishedSnapshot.boot);
        # adopted wholesale when a publish carries the upstream boot
        self.boot = os.urandom(4).hex()
        # how many snapshots BEHIND the head stay version-addressable
        # for pinned transactional reads; defaults to the prefer_ready
        # lookback so the knob never shrinks what latest() could serve
        self.retention = (
            self.READY_LOOKBACK if retention is None
            else max(1, int(retention))
        )
        self._current: Optional[PublishedSnapshot] = None
        self._recent: tuple = ()  # newest-first, immutable (atomic swap)
        self._cond = threading.Condition()
        self._closed = False
        self._listeners: tuple = ()  # immutable, swapped whole

    # -- read side ----------------------------------------------------- #
    def latest(self, prefer_ready: bool = False) -> Optional[PublishedSnapshot]:
        """The newest published snapshot (or None before the first
        publish). One atomic reference read; never blocks.

        ``prefer_ready=True`` trades bounded staleness for latency: it
        returns the newest snapshot whose payload tensors have finished
        computing (its publish-time CUDA event), looking back at most
        ``READY_LOOKBACK`` windows. The head snapshot references the
        JUST-DISPATCHED window's async output — a reader that insists on
        it blocks until the fold pipeline catches up, while the window
        before is typically already materialized."""
        if not prefer_ready:
            return self._current
        recent = self._recent
        for snap in recent:
            if _snap_ready(snap):
                return snap
        return self._current

    @staticmethod
    def payload_ready(payload) -> bool:
        """Whether ``payload``'s values have finished computing (see
        ``_payload_ready``); ``latest(prefer_ready=True)`` reads the CUDA
        event recorded at publish instead."""
        return _payload_ready(payload)

    def at_version(
        self, version: int, boot: Optional[str] = None
    ) -> PublishedSnapshot:
        """The snapshot PINNED at ``(version, boot)`` — the transactional
        read path. Returns the exact version from the
        retention ring or raises a counted, typed
        :class:`~gelly_streaming_tpu_torch.serving.txn.TxnSnapshotExpired`;
        it NEVER substitutes a fresher snapshot — a transaction is told
        its snapshot is gone, not quietly handed different data.

        ``boot`` (when given) must match the snapshot's lineage nonce:
        version numbers restart across cold store swaps, so a
        numerically-equal version from a different lineage is a
        different graph and expires the pin (``kind="lineage"``)."""
        from .txn import TxnSnapshotExpired

        version = int(version)
        head = self._current
        for snap in self._recent:
            if snap.version == version:
                if boot and snap.boot and snap.boot != boot:
                    break  # same number, different lineage: not it
                return snap
        if boot and boot != self.boot:
            kind = "lineage"
            msg = (f"pinned v{version} names lineage {boot!r}; this "
                   f"store is lineage {self.boot!r} (restarted?)")
        elif head is None or version > head.version:
            kind = "ahead"
            msg = (f"pinned v{version} is ahead of this store "
                   f"(head v{0 if head is None else head.version})")
        else:
            kind = "ring_slid"
            msg = (f"pinned v{version} slid out of the retention ring "
                   f"(oldest retained v{self.oldest_retained()}, "
                   f"retention {self.retention})")
        get_registry().counter("txn.snapshot_expired", reason=kind).inc()
        raise TxnSnapshotExpired(msg, kind=kind)

    def oldest_retained(self) -> int:
        """Oldest version still version-addressable (``-1`` before any
        publish) — the health surface's oldest-pinned-readable stamp."""
        recent = self._recent
        return recent[-1].version if recent else -1

    def ring_depth(self) -> int:
        """How many snapshots the retention ring currently holds."""
        return len(self._recent)

    def head_window(self) -> int:
        """Window index of the newest snapshot; -2 before any publish
        (so a boot snapshot's ``-1`` still reads as ahead of nothing)."""
        snap = self._current
        return -2 if snap is None else snap.window

    def wait_for(
        self, min_version: int = 1, timeout: Optional[float] = None
    ) -> Optional[PublishedSnapshot]:
        """Block until a snapshot with ``version >= min_version`` exists
        (or the store closes / the timeout lapses); returns the newest
        snapshot either way. Readers that only want *some* snapshot pass
        the default ``min_version=1``."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while True:
                snap = self._current
                if snap is not None and snap.version >= min_version:
                    return snap
                if self._closed:
                    return snap
                remaining = (
                    None if deadline is None
                    else deadline - time.monotonic()
                )
                if remaining is not None and remaining <= 0:
                    return snap
                self._cond.wait(remaining)

    # -- write side ---------------------------------------------------- #
    def publish(
        self, payload: Mapping[str, Any], window: int, watermark: int,
        event_ts: int = -1, version: Optional[int] = None,
        boot: Optional[str] = None,
    ) -> PublishedSnapshot:
        """Swap in a new snapshot and wake waiters. The assignment to
        ``_current`` IS the publication point; the lock below only
        guards the condition notify.

        ``version`` overrides the monotone counter for ONE publish —
        the restart-adoption boot path republishes the mirrored
        snapshot under its original version so downstream delta
        baselines (routers, the persisted pull ring) stay valid
        instead of watching versions restart from 1. Later publishes
        continue from the override. ``boot`` likewise ADOPTS an
        upstream store's lineage nonce: a standby mirroring its
        primary publishes under the primary's boot, so a pinned
        ``(version, boot)`` survives promotion; absent, the store
        keeps its own lineage."""
        prev = self._current
        if version is None:
            version = 1 if prev is None else prev.version + 1
        if boot is not None and boot:
            self.boot = str(boot)
        snap = PublishedSnapshot(
            payload=payload,
            window=window,
            watermark=watermark,
            version=int(version),
            epoch=self.epoch,
            event_ts=int(event_ts),
            boot=self.boot,
            ready=_ready_event(payload) if hasattr(payload, "values")
            else None,
        )
        # both swaps are single reference assignments (atomic under the
        # GIL); _recent is an immutable tuple rebuilt per publish
        keep = max(self.retention, self.READY_LOOKBACK) + 1
        self._recent = (snap, *self._recent)[:keep]
        self._current = snap
        with self._cond:
            self._cond.notify_all()
        for cb in self._listeners:
            try:
                cb(snap)
            except Exception:
                # a listener failure (a full disk under the snapshot
                # mirror, say) must never take the ingest thread down
                # with it — the local snapshot is already published
                get_registry().counter(
                    "serving.swallowed", site="publish_listener"
                ).inc()
        return snap

    def add_listener(self, cb) -> None:
        """Call ``cb(snapshot)`` on the WRITER's thread after every
        publish — the hook the cross-process failover mirror uses to
        persist each snapshot. Listeners run inline with ingest, so
        they must be cheap or throttle themselves; a raising listener
        is counted and skipped, never fatal."""
        self._listeners = (*self._listeners, cb)

    def remove_listener(self, cb) -> None:
        self._listeners = tuple(x for x in self._listeners if x is not cb)

    def close(self) -> None:
        """Release any ``wait_for`` sleepers; the last snapshot stays
        readable (a closed server still answers from its final state)."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()


# --------------------------------------------------------------------- #
# Cross-process half: the shared snapshot directory
# --------------------------------------------------------------------- #
# A standby serving BINARY cannot share an in-memory store with its
# primary; what it can share is a cluster store — a shared directory
# (the historical shape) or the exchange daemon, either way reached
# through a :class:`~gelly_streaming_tpu_torch.fabric.Transport`. The mirror
# persists each published snapshot with the checkpoint commit
# discipline (the transport's atomic put of a CRC-framed container —
# a kill at any byte leaves the previous snapshot fully loadable), and
# the follower turns that store back into a ``(payload, watermark)``
# emission iterator a standby ``StreamServer`` ingests like any other
# servable. Torn or bit-rotted artifacts are REJECTED (counted,
# warned) and the follower falls back to the newest older snapshot —
# the standby never serves a half-written table.

#: snapshot tag prefix in a shared serving store
SNAP_PREFIX = "snap.v"


def _snap_tag(version: int) -> str:
    return f"{SNAP_PREFIX}{version:010d}.bin"


def _snap_path(dirpath: str, version: int) -> str:
    """The shared-dir backend's on-disk name for a snapshot version —
    kept for the recovery tests that corrupt artifacts in place."""
    return os.path.join(dirpath, _snap_tag(version))


def _snap_versions(target) -> list:
    """Committed snapshot versions in the store, newest first."""
    from ..fabric import as_transport

    out = []
    for n in as_transport(target).list(SNAP_PREFIX):
        if n.endswith(".bin"):
            try:
                out.append(int(n[len(SNAP_PREFIX):-len(".bin")]))
            except ValueError:
                continue
    out.sort(reverse=True)
    return out


class SnapshotMirror:
    """Primary-side disk mirror: persist every Nth published snapshot.

    Attach via ``store.add_listener(mirror)``; runs on the ingest
    thread, so ``every`` throttles the disk cost for fast windows. With
    ``every > 1`` up to ``every - 1`` TRAILING windows are not on disk
    at any instant — a primary killed mid-stride fails over to the
    newest committed stride, the bounded-staleness trade the knob buys.
    :meth:`flush` closes the gap at the points where it can be closed:
    the replica runtime calls it when ingest ENDS and on clean close,
    so the final published snapshot always lands then. Payload values
    must be picklable — numpy arrays and torch tensors (on any
    device) are materialized to host
    numpy at write time; a payload that cannot be pickled (an exotic
    vertex dict holding native state) cannot be disk-mirrored and
    should publish a host-shaped payload instead.

    ``dirpath`` is any store-backed cluster
    :class:`~gelly_streaming_tpu_torch.fabric.Transport`; a bare path keeps
    the historical shared-directory layout byte-identical.
    """

    def __init__(self, dirpath, *, keep: int = 2, every: int = 1):
        from ..fabric import as_transport

        self.dirpath = dirpath
        self.transport = as_transport(dirpath)
        self.keep = max(1, int(keep))
        self.every = max(1, int(every))
        self._written = -1  # newest version committed by THIS mirror

    def __call__(self, snap: PublishedSnapshot) -> None:
        if snap.version % self.every == 0:
            self.write(snap)

    def flush(self, store: "SnapshotStore") -> None:
        """Commit the store's newest snapshot if the stride skipped it.
        Idempotent per version; a concurrent listener write of the same
        version is harmless (same content, atomic replace)."""
        snap = store.latest()
        if snap is not None and snap.version > self._written:
            self.write(snap)

    def write(self, snap: PublishedSnapshot) -> str:
        """Commit one snapshot atomically; returns the committed path."""
        from ..resilience import integrity

        payload = {}
        for k, v in snap.payload.items():
            # arrays go to host numpy now (a disk mirror of a device
            # buffer is a copy either way; the file holds no tensor, so
            # it loads without torch); non-array values (the vdict) ride
            # pickle as-is
            if isinstance(v, torch.Tensor):
                v = v.detach().cpu().numpy()
            elif hasattr(v, "shape"):
                v = np.asarray(v)
            payload[k] = v
        doc = {
            "window": snap.window,
            "watermark": snap.watermark,
            "version": snap.version,
            "boot": snap.boot,
            "payload": payload,
        }
        data = integrity.wrap_checksummed(pickle.dumps(doc, protocol=4))
        tag = _snap_tag(snap.version)
        self.transport.put(tag, data, overwrite=True)
        if snap.version > self._written:
            self._written = snap.version
        self._prune()
        return self.transport.describe(tag)

    def _prune(self) -> None:
        for v in _snap_versions(self.transport)[self.keep:]:
            if not self.transport.delete(_snap_tag(v)):
                # already gone (swept by an earlier prune's race) — the
                # store converges either way; visible, not fatal
                get_registry().counter(
                    "serving.swallowed", site="snapshot_prune"
                ).inc()


def load_newest_snapshot(
    dirpath, *, newer_than: int = -1
) -> Optional[dict]:
    """The newest COMMITTED-AND-VALID snapshot doc in the store with
    ``version > newer_than`` (or None). Torn/corrupt artifacts are
    rejected through
    :func:`~gelly_streaming_tpu_torch.resilience.integrity.record_rejection`
    and the scan falls back to the next older one — the same
    newest-first-with-fallback discipline as barrier restore."""
    from ..fabric import as_transport
    from ..resilience import integrity
    from ..resilience.errors import CheckpointCorrupt

    tr = as_transport(dirpath)
    for v in _snap_versions(tr):
        if v <= newer_than:
            return None
        tag = _snap_tag(v)
        data = tr.get(tag)
        if data is None:
            continue  # pruned between list and read: benign race
        origin = tr.describe(tag)
        try:
            doc = pickle.loads(
                integrity.unwrap_checksummed(
                    data, origin=f"serving snapshot {origin}"
                )
            )
        except (CheckpointCorrupt, OSError, pickle.UnpicklingError,
                EOFError, AttributeError) as e:
            integrity.record_rejection(origin, repr(e))
            continue
        if doc.get("payload") is None:
            integrity.record_rejection(origin, "no payload in snapshot doc")
            continue
        # geometry validation (symmetry with SnapshotMirror.write:
        # every committed key is consumed here): a doc missing its
        # window/watermark/version ints is not a snapshot this follower
        # can sequence — reject it visibly and fall back
        if not (isinstance(doc.get("window"), int)
                and isinstance(doc.get("watermark"), int)
                and isinstance(doc.get("version"), int)):
            integrity.record_rejection(
                origin, "snapshot doc geometry keys missing or invalid")
            continue
        return doc
    return None


def follow_snapshots(
    dirpath,
    stop: threading.Event,
    *,
    poll_s: float = 0.05,
    carry_version: bool = False,
    device="cuda",
) -> Iterator[Tuple[dict, int]]:
    """Standby-side emission iterator over a shared snapshot store:
    yields ``(payload, watermark)`` once per NEW committed snapshot
    version until ``stop`` is set. Plug it into a ``StreamServer`` as a
    bare servable (``source=None``) and the standby serves whatever the
    primary last mirrored — including after the primary dies (the
    keep-serving-from-final-state contract, now across processes).

    ``carry_version=True`` smuggles the PRIMARY's version and boot
    lineage through the payload (``snap_version``/``snap_boot`` keys,
    popped by the ingest loop before publish): the standby's ring then
    mirrors the primary's stamps, so a promotion answers pinned
    transactional reads from the mirrored ring instead of restarting
    versions from 1 (which would both expire every pin and trip the
    router's restart-adoption slack).

    ``device`` (the port's addition, default ``"cuda"``, resolved through
    ``core/device.py:resolve_device``) receives each followed snapshot's
    numpy arrays, so a standby answers on its card like the primary;
    ``device="cpu"`` serves them from CPU tensors."""
    from ..core.device import resolve_device
    from ..fabric import as_transport

    # resolved here, not on the first next(): a missing card raises to
    # the caller, not later in the serving thread that drains the follower
    return _follow(as_transport(dirpath), stop, poll_s, carry_version,
                   resolve_device(device))


def _follow(tr, stop, poll_s, carry_version, device):
    last = -1
    while not stop.is_set():
        doc = load_newest_snapshot(tr, newer_than=last)
        if doc is None:
            stop.wait(poll_s)
            continue
        last = int(doc["version"])
        payload = doc["payload"]
        if isinstance(payload, dict):
            payload = _to_device(payload, device)
        if carry_version and isinstance(payload, dict):
            payload = dict(
                payload,
                snap_version=last,
                snap_boot=str(doc.get("boot", "")),
            )
        yield payload, int(doc["watermark"])


def _to_device(payload: dict, device) -> dict:
    """The payload with its numpy arrays uploaded to ``device``."""
    return {
        k: torch.as_tensor(v, device=device) if isinstance(v, np.ndarray)
        else v
        for k, v in payload.items()
    }
