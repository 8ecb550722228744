"""Serving replica failover: a standby server promoted on primary death
(the port's copy of ``gelly_streaming_tpu/serving/failover.py``).

Without this module the serving tier's availability story ends at the
worker thread:
``StreamServer``'s answer path survives any per-batch error, but a death
of the worker itself (an injected crash in the chaos harness, a bug past
the guards, a wedged device op the watchdog can only report) leaves
every admitted future hanging forever. This module adds the replica
analog of the pipeline's supervised recovery:

- :class:`FailoverServer` runs a PRIMARY :class:`~.server.StreamServer`
  (which owns ingest) and a STANDBY attached to the SAME
  :class:`~.snapshot_store.SnapshotStore`. Snapshots are immutable and
  publication is one reference swap, so the standby needs no catch-up
  protocol — the store IS the replicated state, and the standby's first
  answer is as fresh as the newest published snapshot.
- A monitor thread polls primary worker liveness; on death (or an
  explicit :meth:`promote`) the standby starts, the primary's admitted
  queries move over, and new submits route to the standby. In-flight
  queries past their deadline fail
  :class:`~gelly_streaming_tpu_torch.resilience.errors.DeadlineExceeded`
  (counted ``serving.failover_expired`` on top of the usual
  ``serving.deadline_expired``); the rest are RE-ANSWERED from the
  standby's newest snapshot with their original submit times and
  deadlines (``serving.failover_requeued``).
- Admission, shedding, and retry policies carry over: both replicas are
  constructed from the same configuration and share one
  :class:`~.stats.ServingStats`, so ``max_pending``, ``shed_classes``,
  the default ``retry_policy``, and the stats continuity a dashboard
  depends on are identical before and after promotion.

Ingest is NOT failed over here: if the primary's ingest thread is alive
it keeps publishing into the shared store (a worker death does not stop
the stream), and if ingest died the standby serves the newest snapshot —
the same keep-serving-from-final-state contract a closed stream already
has. Process-level ingest recovery belongs to the supervisor/cluster
layer (``resilience/supervisor.py``, ``resilience/coordinated.py``).

Every promotion is visible in the obs registry:
``serving.failover{reason=...}``, ``serving.failover_requeued``,
``serving.failover_expired``, the ``serving.promotion_seconds``
takeover-latency histogram (plus a ``serving.promotion`` span when
tracing is on), and the ``serving.worker_deaths`` the server itself
records.
"""

from __future__ import annotations

import threading
import time
from typing import Iterator, Optional, Tuple

from ..obs import trace as _trace
from ..obs.registry import get_registry
from .query import Answer, Query
from .server import StreamServer
from .snapshot_store import PublishedSnapshot, SnapshotStore
from .stats import ServingStats


def _follow_ingest(primary_done, stop) -> Iterator[Tuple[dict, int]]:
    """The standby's ingest: publish nothing, but END only when the
    PRIMARY's ingest ends (or this replica is told to stop). The
    standby also shares the primary's ``_ingest_done`` event, so the
    stream is "over" for the standby exactly when it is over for the
    shared store. An instantly-finishing empty ingest would instead
    flip the standby into post-stream mode while the primary is still
    publishing: its answers would insist on the head snapshot (whose
    arrays may reference the just-dispatched fold — the latency cliff
    ``prefer_ready`` exists to avoid) and a promotion BEFORE the first
    publish would fail adopted queries instead of holding them."""
    while not primary_done.is_set() and not stop.is_set():
        primary_done.wait(0.05)
    return
    yield  # unreachable: makes this a lazy, closeable generator


class FailoverServer:
    """A primary/standby :class:`StreamServer` pair over one shared
    snapshot store.

    Construct and :meth:`start` it exactly like a ``StreamServer`` —
    ``submit``/``ask``/``snapshot``/``close`` route to whichever replica
    is active. ``monitor_s`` sets the liveness poll period (None
    disables the monitor; promotion is then manual via
    :meth:`promote`). All other keyword arguments are the
    ``StreamServer`` configuration, applied to BOTH replicas.
    """

    #: how long a MANUAL promotion waits for a still-alive primary
    #: worker to settle its in-flight batch before stealing it
    INFLIGHT_GRACE_S = 1.0

    def __init__(
        self,
        servable,
        source=None,
        *,
        monitor_s: Optional[float] = 0.02,
        store: Optional[SnapshotStore] = None,
        stats: Optional[ServingStats] = None,
        **server_kwargs,
    ):
        self.store = store or SnapshotStore()
        self.stats = stats or ServingStats()
        self._kwargs = dict(
            server_kwargs, store=self.store, stats=self.stats
        )
        self.primary = StreamServer(servable, source, **self._kwargs)
        self.standby = StreamServer(iter(()), None, **self._kwargs)
        # follower wiring: ingest stays the primary's job, so the
        # standby's stream-ended signal must BE the primary's (shared
        # event), and its own ingest thread must outlive the primary's
        # publishing instead of finishing instantly — see _follow_ingest
        self.standby._ingest_done = self.primary._ingest_done
        self.standby._servable = _follow_ingest(
            self.primary._ingest_done, self.standby._stop_ingest
        )
        self._active = self.primary
        self.promoted = False
        self.monitor_s = monitor_s
        self._plock = threading.Lock()
        self._monitor_stop = threading.Event()
        self._monitor_thread: Optional[threading.Thread] = None
        self._closed = False

    # ------------------------------------------------------------------ #
    # Lifecycle
    # ------------------------------------------------------------------ #
    def start(self) -> "FailoverServer":
        self.primary.start()
        if self.monitor_s is not None:
            self._monitor_thread = threading.Thread(
                target=self._monitor, name="stream-server-failover",
                daemon=True,
            )
            self._monitor_thread.start()
        return self

    def __enter__(self) -> "FailoverServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    def publish_boot(self, payload: dict, watermark: int = 0) -> None:
        self.primary.publish_boot(payload, watermark)

    def _monitor(self) -> None:
        while not self._monitor_stop.wait(self.monitor_s):
            if self.promoted or self._closed:
                return
            p = self.primary
            if p._worker_thread is not None and not p.worker_alive():
                self.promote(reason="worker_death")
                return

    # ------------------------------------------------------------------ #
    # Promotion
    # ------------------------------------------------------------------ #
    def promote(self, reason: str = "manual") -> None:
        """Switch serving to the standby. Safe to call once; later calls
        are no-ops. The primary's admitted-but-unanswered queries are
        re-homed: entries past their deadline fail ``DeadlineExceeded``
        (they are late no matter who answers), the rest are adopted by
        the standby and re-answered from its newest snapshot with their
        original submit times and deadlines intact.

        Promotion LATENCY is first-class telemetry: the whole takeover
        (admission fence to active-replica switch) is timed into the
        ``serving.promotion_seconds`` histogram and, when tracing is
        on, a ``serving.promotion`` span — worker deaths were counted
        before this, but how long clients waited on the switch was
        invisible."""
        t_promo = time.perf_counter()
        with self._plock:
            if self.promoted or self._closed:
                return
            reg = get_registry()
            with _trace.span(
                "serving.promotion",
                {"reason": reason} if _trace.on() else None,
            ):
                reg.counter("serving.failover", reason=reason).inc()
                primary = self.primary
                # refuse stragglers at the primary's admission gate;
                # the flag flips under ITS lock so no submit can slip
                # between the queue steal below and the reroute of
                # self._active
                with primary._lock:
                    primary._closing = True
                    entries = list(primary._pending)
                    primary._pending.clear()
                self.standby.start()
                # the in-flight batch: if the primary worker is still
                # alive (a MANUAL switchover), it is mid-answer on
                # exactly these entries — adopting them too would
                # compute every query twice and double-record stats.
                # Give the worker a short grace to settle, then steal
                # whatever remains (the worker-death path skips the
                # wait entirely; for a wedged worker the futures'
                # done() guards make any late primary-side settle
                # harmless).
                deadline = time.monotonic() + self.INFLIGHT_GRACE_S
                while (primary.worker_alive() and primary._inflight
                       and time.monotonic() < deadline):
                    # the grace wait deliberately holds _plock: submit()
                    # and active MUST queue behind an in-flight
                    # promotion (their documented contract), and the
                    # wait is bounded by INFLIGHT_GRACE_S; probes use
                    # active_nowait to stay lock-free
                    time.sleep(0.001)
                with primary._lock:
                    entries.extend(primary._inflight_entries)
                    primary._inflight = 0
                    primary._inflight_entries = []
                now = time.perf_counter()
                keep = []
                # entries keep their TRACE CONTEXT through adoption:
                # the standby's answer spans join the same trace the
                # client minted, so the merged timeline shows one story
                # spanning submit, death, and the promoted re-answer
                for q, f, t0, dl, ctx in entries:
                    if f.done():
                        continue
                    if dl is not None and now > dl:
                        StreamServer._expire(
                            q, f, t0, dl, "failed over after"
                        )
                        reg.counter("serving.failover_expired").inc()
                    else:
                        keep.append((q, f, t0, dl, ctx))
                self.standby._adopt(keep)
                if keep:
                    reg.counter(
                        "serving.failover_requeued"
                    ).inc(len(keep))
                self._active = self.standby
                self.promoted = True
            # client-visible takeover latency: admission fence to
            # active-replica switch (always on — a promotion is
            # operational truth, like every resilience event)
            reg.histogram("serving.promotion_seconds").observe(
                time.perf_counter() - t_promo
            )

    # ------------------------------------------------------------------ #
    # Query surface (routed to the active replica)
    # ------------------------------------------------------------------ #
    @property
    def active(self) -> StreamServer:
        with self._plock:
            return self._active

    @property
    def active_nowait(self) -> StreamServer:
        """The active replica WITHOUT waiting out an in-flight
        promotion (``active`` does, and promote() holds the lock
        through its in-flight grace wait): a liveness probe must
        answer immediately mid-failover, and the reference swap is
        atomic — momentarily stale is a correct liveness answer."""
        return self._active

    @property
    def role(self) -> str:
        """Which replica is serving: ``primary`` until a promotion,
        ``standby`` after — the label an external probe needs to tell
        a healthy standby takeover from normal operation."""
        return "standby" if self.promoted else "primary"

    def heartbeat_age_s(self) -> float:
        """The ACTIVE replica's worker-beat age (see
        ``StreamServer.heartbeat_age_s``); read without waiting out an
        in-flight promotion, for the same reason as ``active_nowait``."""
        return self.active_nowait.heartbeat_age_s()

    def submit(self, query: Query, **kw):
        srv = self.active
        try:
            return srv.submit(query, **kw)
        except RuntimeError as e:
            # possibly lost the race with a concurrent promotion: the
            # primary refuses as "closed" the moment promote() starts,
            # BEFORE the standby is ready. Taking the promotion lock
            # waits out any in-flight promote; if the active replica
            # changed, one re-route settles it (promotion is one-shot).
            # A genuinely closed replica set re-raises.
            if "closed" not in str(e) or self._closed:
                raise
            with self._plock:
                now = self._active
            if now is not srv:
                return now.submit(query, **kw)
            raise

    def ask(self, query: Query, timeout: Optional[float] = None,
            deadline_s: Optional[float] = None) -> Answer:
        return self.submit(query, deadline_s=deadline_s).result(timeout)

    def snapshot(self) -> Optional[PublishedSnapshot]:
        return self.store.latest()

    def metrics_endpoint(self, **kw):
        """Start a scrape endpoint wired to the replica set:
        ``/healthz`` reports the ACTIVE replica's liveness plus the
        promotion state. See ``StreamServer.metrics_endpoint``."""
        from ..obs.endpoint import MetricsEndpoint

        return MetricsEndpoint.for_server(self, **kw).start()

    def join(self, timeout: Optional[float] = None) -> None:
        self.primary.join(timeout)

    # ------------------------------------------------------------------ #
    # Shutdown
    # ------------------------------------------------------------------ #
    def close(self, timeout: float = 30.0) -> None:
        """Close both replicas (idempotent). The primary closes first so
        ingest stops at a window boundary; each replica answers its own
        admitted stragglers on the way down. ``timeout`` bounds the
        WHOLE close: the monitor join and both replica closes
        spend one shared budget, not a fresh copy each."""
        with self._plock:
            if self._closed:
                return
            self._closed = True
        deadline = time.monotonic() + float(timeout)

        def remaining() -> float:
            return max(0.0, deadline - time.monotonic())

        self._monitor_stop.set()
        if self._monitor_thread is not None:
            self._monitor_thread.join(remaining())
        errors = []
        for srv in (self.primary, self.standby):
            try:
                srv.close(remaining())
            except BaseException as e:
                errors.append(e)
        if errors:
            raise errors[0]
