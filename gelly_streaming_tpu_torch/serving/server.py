"""StreamServer: concurrent point-query serving beside live ingest (the
port's copy of ``gelly_streaming_tpu/serving/server.py``).

Thread layout (one server = two daemon threads, same discipline as
``core/pipeline.py:prefetch`` — the producer owns the device step loop,
consumers never stall it):

- **ingest thread**: drives the servable's emission iterator (any
  per-window payload stream) and publishes one immutable snapshot per
  window into the :class:`~.snapshot_store.SnapshotStore`. Publishing is
  one atomic reference swap, so ingest never waits on readers.
- **query worker thread**: drains ALL currently-pending queries in one
  sweep, groups them by class, and answers each group with one
  vectorized :class:`~.query.QueryEngine` kernel against the latest
  snapshot — concurrent load COALESCES into bigger batches instead of
  queueing per-query dispatches (the serving analog of window batching).

Admission control is explicit: past ``max_pending`` in-flight queries,
:meth:`StreamServer.submit` raises :class:`Overloaded` immediately
instead of buffering unboundedly or blocking the caller — clients see
back-pressure, ingest sees nothing. ``close()`` stops ingest at the next
window boundary, answers every already-admitted query from the final
snapshot, and joins both threads.

On a card every thread that launches device work (the ingest thread's folds,
the worker's query steps) addresses the payload tensor's OWN device, never
the thread's current device; an answer-path error fails its batch and is
counted, never a quiet switch to the host path.
"""

from __future__ import annotations

import threading
import time
import warnings
from collections import deque
from concurrent.futures import Future, InvalidStateError
from typing import Iterator, Optional, Tuple

from ..obs import flight as _flight
from ..obs import trace as _trace
from ..obs.registry import get_registry
from ..resilience import faults as _faults
from ..resilience.errors import DeadlineExceeded, InjectedFault
from ..resilience.retry import RetryPolicy
from .query import Answer, Query, QueryEngine
from .snapshot_store import PublishedSnapshot, SnapshotStore
from .stats import ServingStats
from .txn import PinnedQuery, TxnSnapshotExpired


def _unwrap(q):
    """The engine-facing query behind a possibly-pinned entry."""
    return q.q if isinstance(q, PinnedQuery) else q


class Overloaded(RuntimeError):
    """The server's admission limit is reached; retry with back-off.
    Raised from ``submit``/``ask`` so rejection is synchronous and
    explicit — an overloaded serving tier must shed, not buffer.
    ``submit`` retries these internally when a
    :class:`~gelly_streaming_tpu_torch.resilience.RetryPolicy` is configured."""


class Shed(Overloaded):
    """The query's CLASS is being load-shed under sustained pressure
    (see ``StreamServer`` ``shed_classes``). Never retried by the
    built-in retry policy: shedding exists to lose exactly this
    traffic so the protected classes keep their latency."""


class Servable:
    """Adapter contract a workload implements to be served (see
    ``library/connected_components.py:servable`` et al.).

    ``payloads(source)`` is the emission iterator the ingest thread
    drives: per window it yields ``(payload, watermark)`` where
    ``payload`` is an immutable mapping the :class:`QueryEngine`
    understands (``labels``/``deg``/``ranks`` + ``vdict``) and
    ``watermark`` a monotone progress counter (cumulative edges where
    cheap to count, else the window ordinal). ``boot_payload()`` returns
    the same pair from already-restored carry state (or None when there
    is nothing to serve yet) — the checkpoint-boot path publishes it as
    window -1 before the first live window lands.
    """

    #: query classes this servable's payloads answer (documentation +
    #: eager misconfiguration checks)
    query_classes: tuple = ()

    def payloads(self, source) -> Iterator[Tuple[dict, int]]:
        raise NotImplementedError

    def boot_payload(self) -> Optional[Tuple[dict, int]]:
        return None


class StreamServer:
    """Serve point queries from a live stream's running summary.

    Parameters
    ----------
    servable:
        A :class:`Servable` (or any object with its ``payloads``
        contract). A bare iterator of ``(payload, watermark)`` pairs is
        accepted with ``source=None``.
    source:
        The stream / event iterable handed to ``servable.payloads``.
    max_pending:
        Admission limit: queries admitted but not yet answered. At the
        limit, ``submit`` raises :class:`Overloaded`.
    retry_policy:
        Default :class:`~gelly_streaming_tpu_torch.resilience.RetryPolicy` for
        :class:`Overloaded` rejections: ``submit`` blocks the CALLER
        through bounded-exponential, jittered re-admission attempts
        before giving up (clients get back-pressure-with-patience
        instead of hand-rolling retry loops). None (default) keeps
        rejections immediate. :class:`Shed` rejections never retry.
    shed_classes:
        Query classes (types or type names) to LOAD-SHED under
        sustained pressure: once admitted load has stayed at or above
        ``shed_watermark * max_pending`` for ``shed_after_s`` seconds,
        submits of these classes raise :class:`Shed` immediately
        (counted as ``serving.shed{cls=...}`` in the obs registry)
        while other classes keep the remaining headroom. Pressure
        clears the moment load drops below the watermark.
    watchdog_s:
        Arms a worker stall watchdog: a daemon thread that warns (and
        counts ``serving.worker_stalls``) whenever queries are pending
        but the worker loop has not completed a sweep within this many
        seconds — the serving analog of the prefetch stall watchdog.
    autotune:
        Load-aware admission: an
        :class:`~gelly_streaming_tpu_torch.control.AdmissionTuner` re-tunes
        ``max_pending`` and the shed watermark from MEASURED queue wait
        vs the deadline budgets queries actually carry — queue wait is
        the leading signal, so shedding tightens while protected
        classes still have headroom, and recovers toward the configured
        ceiling when load clears (bounded steps, hysteresis, every move
        a ``control.retune`` event). The configured ``max_pending`` /
        ``shed_watermark`` stay the CEILING — the tuner only moves
        inside them. With no deadlines in the traffic, set
        ``target_wait_s`` or the tuner holds (nothing to compare
        against).
    """

    def __init__(
        self,
        servable,
        source=None,
        *,
        max_pending: int = 1024,
        store: Optional[SnapshotStore] = None,
        engine: Optional[QueryEngine] = None,
        stats: Optional[ServingStats] = None,
        retry_policy: Optional[RetryPolicy] = None,
        shed_classes: tuple = (),
        shed_watermark: float = 0.8,
        shed_after_s: float = 0.05,
        watchdog_s: Optional[float] = None,
        autotune: bool = False,
        target_wait_s: Optional[float] = None,
    ):
        self._servable = servable
        self._source = source
        self.store = store or SnapshotStore()
        self.engine = engine or QueryEngine()
        self.stats = stats or ServingStats()
        self.max_pending = int(max_pending)
        self.retry_policy = retry_policy
        self._shed_names = frozenset(
            c if isinstance(c, str) else c.__name__ for c in shed_classes
        )
        self._shed_level = max(1, int(shed_watermark * self.max_pending))
        self.shed_after_s = float(shed_after_s)
        self.admission = None
        if autotune:
            from ..control import AdmissionTuner

            self.admission = AdmissionTuner(
                max_pending=self.max_pending,
                shed_watermark=shed_watermark,
                target_wait_s=target_wait_s,
            )
        self._pressure_t0: Optional[float] = None  # sustained-load start
        self.watchdog_s = watchdog_s
        self._worker_beat = time.monotonic()
        self._watchdog_thread: Optional[threading.Thread] = None
        self._watchdog_stop = threading.Event()
        # (query, future, t_submit, deadline_abs_or_None, trace_ctx)
        self._pending: deque = deque()
        self._inflight = 0  # drained by the worker, not yet answered
        # the drained batch's entries, kept until _settle: if the worker
        # thread DIES mid-sweep (injected crash, answer-path bug past
        # the guards) these futures would otherwise be unreachable —
        # failover promotion re-homes them onto the standby
        self._inflight_entries: list = []
        self._sweeps = 0  # completed worker sweeps (fault-plan ordinal)
        self._lock = threading.Lock()
        self._wake = threading.Event()
        self._stop_ingest = threading.Event()
        self._ingest_done = threading.Event()
        self._ingest_error: Optional[BaseException] = None
        self._closing = False
        self._closed = False
        self._window = -1  # last published live window
        self._ingest_thread: Optional[threading.Thread] = None
        self._worker_thread: Optional[threading.Thread] = None
        # flipped by a failover promotion (ReplicaServer.promote): a
        # pinned read expiring AFTER promotion is a failover casualty
        # and is additionally counted txn.failover_expired — the storm
        # gate separates those honest expiries from ring churn
        self.txn_failover = False

    # ------------------------------------------------------------------ #
    # Lifecycle
    # ------------------------------------------------------------------ #
    def publish_boot(self, payload: dict, watermark: int = 0,
                     version: Optional[int] = None,
                     boot: Optional[str] = None) -> None:
        """Publish a pre-ingest snapshot (window -1): the checkpoint-boot
        path serves the restored summary immediately, before the first
        catch-up window folds. Must run before :meth:`start`.
        ``version`` carries the mirrored snapshot's original version
        through a restart (see :meth:`SnapshotStore.publish`); ``boot``
        carries its lineage nonce the same way, so a restart-adopted
        replica stays addressable by pinned transactions."""
        if self._ingest_thread is not None:
            raise RuntimeError("publish_boot must precede start()")
        self.store.publish(payload, window=-1, watermark=watermark,
                           version=version, boot=boot)

    def start(self) -> "StreamServer":
        if self._ingest_thread is not None:
            raise RuntimeError("server already started")
        self._ingest_thread = threading.Thread(
            target=self._ingest, name="stream-server-ingest", daemon=True
        )
        self._worker_thread = threading.Thread(
            target=self._worker, name="stream-server-queries", daemon=True
        )
        self._ingest_thread.start()
        self._worker_thread.start()
        if self.watchdog_s is not None:
            self._watchdog_thread = threading.Thread(
                target=self._watchdog, name="stream-server-watchdog",
                daemon=True,
            )
            self._watchdog_thread.start()
        return self

    def __enter__(self) -> "StreamServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    def _payload_iter(self) -> Iterator[Tuple[dict, int]]:
        payloads = getattr(self._servable, "payloads", None)
        if payloads is not None:
            return payloads(self._source)
        if self._source is not None:
            raise TypeError(
                f"{type(self._servable).__name__} has no payloads(); "
                "pass a Servable, or a bare (payload, watermark) "
                "iterator with source=None"
            )
        return iter(self._servable)

    def _ingest(self) -> None:
        it = self._payload_iter()
        try:
            for payload, watermark in it:
                if self._stop_ingest.is_set():
                    break
                if payload is None:  # a window with nothing servable
                    continue
                self._window += 1
                # a mirror follower smuggles the PRIMARY's version and
                # boot lineage through the payload (carry_version) so a
                # standby's ring mirrors the primary's stamps; pop the
                # smuggled keys off a COPY — the published payload must
                # look like any other servable payload
                version = boot = None
                if hasattr(payload, "get") and "snap_version" in payload:
                    payload = dict(payload)
                    version = int(payload.pop("snap_version"))
                    boot = payload.pop("snap_boot", None)
                # an event-time pipeline's servable carries its
                # watermark stamp in the payload; count windows do not
                # (-1 = "no event time", the Answer default)
                self.store.publish(
                    payload, self._window, int(watermark),
                    event_ts=int(payload.get("event_ts", -1))
                    if hasattr(payload, "get") else -1,
                    version=version, boot=boot,
                )
        except BaseException as e:  # surfaced via join()/close()
            self._ingest_error = e
        finally:
            if self._stop_ingest.is_set():
                close = getattr(it, "close", None)
                if close is not None:
                    try:
                        close()
                    except Exception:
                        # the stream is already torn down; the close
                        # failure must not mask the shutdown, but it
                        # must be visible in the event stream
                        get_registry().counter(
                            "serving.swallowed", site="ingest_close"
                        ).inc()
            self._ingest_done.set()
            self._wake.set()  # the worker re-checks exit conditions

    # ------------------------------------------------------------------ #
    # Query surface
    # ------------------------------------------------------------------ #
    def submit(
        self,
        query: Query,
        *,
        deadline_s: Optional[float] = None,
        retry_policy: Optional[RetryPolicy] = None,
        ctx=None,
        txn=None,
    ) -> "Future[Answer]":
        """Admit one query; resolves to an :class:`~.query.Answer`.
        Raises :class:`Overloaded` at the admission limit — immediately,
        on the caller's thread, so clients get synchronous back-pressure
        — unless a retry policy (per-call, else the server default)
        absorbs it: then the CALLER blocks through bounded-backoff
        re-admission attempts (``serving.retries`` counts them) and
        only a spent budget re-raises. :class:`Shed` never retries.

        ``deadline_s`` bounds how long the query may WAIT: if the
        worker has not answered it that many seconds after submission,
        its future fails with
        :class:`~gelly_streaming_tpu_torch.resilience.errors.DeadlineExceeded`
        (``serving.deadline_expired`` counts it) instead of returning
        an arbitrarily stale answer to a caller that stopped caring.

        ``ctx`` is an optional
        :class:`~gelly_streaming_tpu_torch.obs.trace.TraceContext` the query
        rides through the pending queue: the worker stamps its stage
        spans with the trace id, and the context survives failover
        adoption, so a re-answered query stays on its original trace.
        When omitted (and tracing is on) the submitting thread's active
        context is captured — same-process callers inside a span get
        joined-up traces for free.

        ``txn`` is a decoded transaction doc (see
        :func:`~gelly_streaming_tpu_torch.serving.txn.decode_txn`): when it
        carries a ``pin``, the query is answered AT that pinned
        ``(version, boot)`` snapshot from the retention ring, or fails
        with a typed
        :class:`~gelly_streaming_tpu_torch.serving.txn.TxnSnapshotExpired` —
        never a silently fresher answer."""
        pin = None if txn is None else txn.get("pin")
        if pin is not None:
            query = PinnedQuery(query, pin[0], pin[1])
        policy = retry_policy if retry_policy is not None else self.retry_policy
        attempt = 0
        # the deadline is a TOTAL budget: pin it to a wall
        # clock once, spend retry sleeps against it, and admit with
        # what REMAINS — a query re-admitted after backoff must not be
        # granted a fresh full deadline measured from its late t0
        deadline = None if deadline_s is None \
            else time.monotonic() + float(deadline_s)
        while True:
            remaining = None if deadline is None \
                else deadline - time.monotonic()
            try:
                return self._admit(query, remaining, ctx)
            except Shed:
                raise
            except Overloaded:
                delay = None if policy is None \
                    else policy.delay_before(attempt, remaining)
                if delay is None:
                    raise
                attempt += 1
                get_registry().counter("serving.retries").inc()
                time.sleep(delay)

    def _admit(
        self, query: Query, deadline_s: Optional[float], ctx=None
    ) -> "Future[Answer]":
        declared = getattr(self._servable, "query_classes", ())
        if declared and not isinstance(_unwrap(query), tuple(declared)):
            # reject the wrong class SYNCHRONOUSLY on the caller's
            # thread: batched answering would otherwise fail the whole
            # drained sweep (hundreds of valid concurrent queries) on
            # one client's misdirected query
            raise TypeError(
                f"{type(self._servable).__name__} serves "
                f"{[c.__name__ for c in declared]}, not "
                f"{type(_unwrap(query)).__name__}"
            )
        f: "Future[Answer]" = Future()
        with self._lock:
            # the closing check must sit INSIDE the lock: an unlocked
            # read could pass just before close() flips the flag, and an
            # append landing after close()'s final leftover drain would
            # hang its future forever (no worker left to answer it).
            # Inside the lock, any append that beats the flag is still
            # caught by close()'s drain, which runs after the flag set.
            if self._closing or self._closed:
                raise RuntimeError("server is closed")
            # count the worker's drained-but-unanswered batch too, or a
            # slow answer sweep would let admissions reach 2x the limit
            admitted = len(self._pending) + self._inflight
            # sustained-pressure tracking for class shedding: the clock
            # starts when load reaches the watermark and clears the
            # moment it drops below (a burst alone never sheds)
            now = time.monotonic()
            if admitted >= self._shed_level:
                if self._pressure_t0 is None:
                    self._pressure_t0 = now
            else:
                self._pressure_t0 = None
            qname = type(_unwrap(query)).__name__
            if (
                self._shed_names
                and self._pressure_t0 is not None
                and now - self._pressure_t0 >= self.shed_after_s
                and qname in self._shed_names
            ):
                self.stats.record_rejected()
                get_registry().counter(
                    "serving.shed", cls=qname
                ).inc()
                raise Shed(
                    f"{qname} shed under sustained "
                    f"pressure ({admitted}/{self.max_pending} in flight)"
                )
            if admitted >= self.max_pending:
                self.stats.record_rejected()
                raise Overloaded(
                    f"{admitted} queries in flight "
                    f"(max_pending={self.max_pending})"
                )
            t0 = time.perf_counter()
            deadline = None if deadline_s is None else t0 + float(deadline_s)
            if ctx is None and _trace.on():
                ctx = _trace.current_context()
            self._pending.append((query, f, t0, deadline, ctx))
            self.stats.set_pending(admitted + 1)  # admission gauge
        self._wake.set()
        return f

    def submit_many(
        self,
        queries,
        *,
        deadline_s: Optional[float] = None,
        ctx=None,
        txn=None,
    ) -> list:
        """Admit a whole wire batch under ONE lock acquisition — the
        RPC front end's fast path (a 32-query frame previously paid 32
        lock/wake round trips; admission is all-or-nothing, so a
        rejected batch leaves nothing half-admitted, exactly the
        cancel-the-partial-batch semantics the wire already promises).
        Raises like :meth:`submit`; no retry-policy absorption (the
        wire client owns retry pacing). ``txn`` pins the whole batch
        at one snapshot, as in :meth:`submit`."""
        declared = getattr(self._servable, "query_classes", ())
        if declared:
            for q in queries:
                if not isinstance(q, tuple(declared)):
                    raise TypeError(
                        f"{type(self._servable).__name__} serves "
                        f"{[c.__name__ for c in declared]}, not "
                        f"{type(q).__name__}"
                    )
        pin = None if txn is None else txn.get("pin")
        if pin is not None:
            queries = [PinnedQuery(q, pin[0], pin[1]) for q in queries]
        futures = [Future() for _ in queries]
        t0 = time.perf_counter()
        deadline = None if deadline_s is None \
            else t0 + float(deadline_s)
        if ctx is None and _trace.on():
            ctx = _trace.current_context()
        with self._lock:
            if self._closing or self._closed:
                raise RuntimeError("server is closed")
            admitted = len(self._pending) + self._inflight
            now = time.monotonic()
            # pressure/shed accounting tracks each query's would-be
            # admission depth, EXACTLY like N sequential _admit calls
            # (a batch whose tail crosses the watermark must shed the
            # same classes the per-query loop would have) — but the
            # wire cancels a partially-admitted batch on Shed anyway,
            # so rejection here is all-or-nothing
            for i, q in enumerate(queries):
                cur = admitted + i
                if cur >= self._shed_level:
                    if self._pressure_t0 is None:
                        self._pressure_t0 = now
                else:
                    self._pressure_t0 = None
                qname = type(_unwrap(q)).__name__
                if (
                    self._shed_names
                    and self._pressure_t0 is not None
                    and now - self._pressure_t0 >= self.shed_after_s
                    and qname in self._shed_names
                ):
                    self.stats.record_rejected()
                    get_registry().counter(
                        "serving.shed", cls=qname
                    ).inc()
                    raise Shed(
                        f"{qname} shed under sustained "
                        f"pressure ({cur}/{self.max_pending} "
                        "in flight)"
                    )
            if admitted + len(queries) > self.max_pending:
                self.stats.record_rejected()
                raise Overloaded(
                    f"{admitted} queries in flight "
                    f"(max_pending={self.max_pending})"
                )
            self._pending.extend(
                (q, f, t0, deadline, ctx)
                for q, f in zip(queries, futures)
            )
            self.stats.set_pending(admitted + len(queries))
        self._wake.set()
        return futures

    def ask(self, query: Query, timeout: Optional[float] = None,
            deadline_s: Optional[float] = None) -> Answer:
        """Synchronous point query (submit + wait)."""
        return self.submit(query, deadline_s=deadline_s).result(timeout)

    def snapshot(self) -> Optional[PublishedSnapshot]:
        """The snapshot queries are currently answered from."""
        return self.store.latest()

    # ------------------------------------------------------------------ #
    # Worker
    # ------------------------------------------------------------------ #
    def _drain(self) -> list:
        with self._lock:
            drained = list(self._pending)
            self._pending.clear()
            # deadline sweep happens at drain time (the worker's
            # cadence): an expired query is settled with
            # DeadlineExceeded instead of joining the answer batch —
            # it must not spend engine time on an answer nobody wants
            batch = []
            now = time.perf_counter()
            expired = []
            for entry in drained:
                dl = entry[3]
                if dl is not None and now > dl:
                    expired.append(entry)
                else:
                    batch.append(entry)
            self._inflight = len(batch)
            self._inflight_entries = batch
        for q, f, t0, dl, _ctx in expired:
            self._expire(q, f, t0, dl, "unanswered after")
        if expired and not batch:
            # the whole drain expired: nothing will reach the answer
            # path's _settle, so settle here or an idle server reports
            # the expired burst as a phantom backlog forever
            self._settle()
        if batch:
            # coalescing evidence: how many concurrent queries one
            # vectorized sweep absorbed (empty sweeps are not recorded —
            # the idle poll would drown the signal)
            self.stats.record_drain(len(batch))
        return batch

    @staticmethod
    def _expire(q, f, t0, dl, verb: str) -> None:
        """Settle one deadline-expired query: count it and fail its
        future, with the same cancel-race guard as the answer path (a
        client may cancel() mid-sweep; set_exception then raises, and
        that must never kill the worker)."""
        get_registry().counter("serving.deadline_expired").inc()
        if not f.done():
            try:
                f.set_exception(DeadlineExceeded(
                    f"{type(q).__name__} {verb} its {dl - t0:.3f}s "
                    "deadline"
                ))
            except InvalidStateError:
                # client cancel() raced the sweep; the future is
                # already settled — count the race, don't hide it
                get_registry().counter(
                    "serving.swallowed", site="expire_settle_race"
                ).inc()

    def _settle(self) -> None:
        with self._lock:
            self._inflight = 0
            self._inflight_entries = []
            # the answered batch left flight: the admission gauge must
            # fall back to what is actually still waiting, or an idle
            # server reports the last burst as a phantom backlog forever
            self.stats.set_pending(len(self._pending))

    def _answer(self, batch: list) -> None:
        # during live ingest, trade bounded staleness (READY_LOOKBACK
        # windows at most) for latency: answer from the freshest snapshot
        # whose arrays already materialized instead of blocking on the
        # just-dispatched window's fold. Once the stream has ended the
        # head is insisted on, so post-stream answers are staleness-0.
        snap = self.store.latest(
            prefer_ready=not self._ingest_done.is_set()
        )
        if snap is None:
            # admitted before the first publish and the stream is gone:
            # fail explicitly rather than hang the futures
            err = RuntimeError(
                "server closed before any snapshot was published"
            )
            if self._ingest_error is not None:
                err.__cause__ = self._ingest_error
            for _, f, *_rest in batch:
                f.set_exception(err)
            return
        # partition pinned transactional reads out of the sweep: each
        # distinct (version, boot) pin answers from ITS ring snapshot
        # (or expires typed), the rest from the freshest as ever
        pinned: dict = {}
        plain = []
        for entry in batch:
            q = entry[0]
            if isinstance(q, PinnedQuery):
                pinned.setdefault((q.version, q.boot), []).append(entry)
            else:
                plain.append(entry)
        for (ver, boot), group in pinned.items():
            self._answer_pinned(ver, boot, group)
        if not plain:
            return
        batch = plain
        queries = [q for q, *_rest in batch]
        tracing = _trace.on()
        t_dispatch = time.perf_counter()
        try:
            with _trace.span(
                "serving.answer",
                {"batch": len(batch), "window": snap.window}
                if tracing else None,
            ):
                answers = self.engine.answer_batch(
                    snap, queries, head_window=self.store.head_window()
                )
        except Exception as e:
            for _, f, *_rest in batch:
                if not f.done():
                    f.set_exception(e)
            return
        now = time.perf_counter()
        self.stats.record_batch()
        if self.admission is not None:
            # load-aware admission tap (one per sweep, never per query):
            # the sweep's OLDEST queue wait — entries drain in FIFO
            # order, so the batch head waited longest — against the
            # tightest deadline budget the sweep carried
            if self.admission.tap_entries(
                t_dispatch - batch[0][2],
                ((t0_, dl_) for _q, _f, t0_, dl_, _c in batch),
            ):
                with self._lock:
                    self.max_pending = self.admission.max_pending
                    self._shed_level = self.admission.shed_level()
        # per-trace attribution: entries from one wire batch
        # share a TraceContext; group on it so each traced batch gets
        # ONE serving.query span carrying the stage breakdown (per-query
        # spans would multiply the event log by the batch size for no
        # extra information — queries of a sweep share the dispatch)
        groups: dict = {} if tracing else None
        dispatch_s = now - t_dispatch
        snapshot_age_s = time.monotonic() - snap.published_at
        for (q, f, t0, dl, ctx), ans in zip(batch, answers):
            # deadline re-check at settle time: a query drained in time
            # but answered late (a slow engine sweep) must still honor
            # its deadline rather than deliver a stale answer the
            # caller stopped waiting for
            if dl is not None and now > dl:
                self._expire(q, f, t0, dl, "answered after")
                continue
            self.stats.record(
                type(q).__name__, now - t0, ans.staleness,
                exemplar=ctx.trace_id if tracing and ctx is not None
                else None,
            )
            if tracing and ctx is not None:
                g = groups.get(id(ctx))
                if g is None:
                    groups[id(ctx)] = [ctx, t0, 1, ans.staleness]
                else:
                    g[1] = min(g[1], t0)
                    g[2] += 1
                    g[3] = max(g[3], ans.staleness)
            # a client may have cancel()ed its future mid-sweep;
            # settling it then raises InvalidStateError, which must not
            # poison the rest of the batch's answers
            if not f.done():
                try:
                    f.set_result(ans)
                except InvalidStateError:
                    get_registry().counter(
                        "serving.swallowed", site="answer_settle_race"
                    ).inc()
        if tracing and groups:
            settle_s = time.perf_counter() - now
            for ctx, t0_min, n, stale in groups.values():
                _trace.record_span(
                    "serving.query",
                    now - t0_min,
                    trace_id=ctx.trace_id,
                    parent=ctx.parent_sid,
                    attrs={
                        "n": n,
                        "queue_wait_s": round(t_dispatch - t0_min, 6),
                        "dispatch_s": round(dispatch_s, 6),
                        "settle_s": round(settle_s, 6),
                        "snapshot_age_s": round(snapshot_age_s, 6),
                        "staleness": int(stale),
                        "window": snap.window,
                    },
                )

    def _answer_pinned(self, version: int, boot: str,
                       group: list) -> None:
        """Answer one pinned group AT its ``(version, boot)`` snapshot.
        An expired pin fails the whole group with the typed error it
        deserves — the honesty contract: a transaction is told its
        snapshot is gone, never handed a fresher answer. After a
        failover promotion the expiry is additionally counted
        ``txn.failover_expired`` (the storm gate's honest-expiry lane)."""
        try:
            psnap = self.store.at_version(version, boot)
        except TxnSnapshotExpired as e:
            if self.txn_failover:
                get_registry().counter("txn.failover_expired").inc()
            for _q, f, *_rest in group:
                if not f.done():
                    try:
                        f.set_exception(e)
                    except InvalidStateError:
                        get_registry().counter(
                            "serving.swallowed",
                            site="answer_settle_race",
                        ).inc()
            return
        queries = [entry[0].q for entry in group]
        try:
            answers = self.engine.answer_batch(
                psnap, queries, head_window=self.store.head_window()
            )
        except Exception as e:
            for _q, f, *_rest in group:
                if not f.done():
                    f.set_exception(e)
            return
        get_registry().counter("txn.pinned_reads").inc(len(group))
        now = time.perf_counter()
        for (q, f, t0, dl, _ctx), ans in zip(group, answers):
            if dl is not None and now > dl:
                self._expire(q, f, t0, dl, "answered after")
                continue
            self.stats.record(type(q.q).__name__, now - t0,
                              ans.staleness)
            if not f.done():
                try:
                    f.set_result(ans)
                except InvalidStateError:
                    get_registry().counter(
                        "serving.swallowed", site="answer_settle_race"
                    ).inc()

    def _worker(self) -> None:
        try:
            self._worker_loop()
        except InjectedFault:
            # the fault plan's simulated worker death: count it and end
            # the thread QUIETLY (no interpreter-level thread traceback
            # — the death is the experiment, the failover monitor's
            # promotion is the observable)
            get_registry().counter("serving.worker_deaths").inc()
            _flight.dump_installed("serving.worker_death:injected")
        except BaseException as e:
            # the loop's answer path already survives everything; an
            # exception HERE is real worker death (a drain-path bug) —
            # record it so the failover monitor can promote a standby,
            # commit the flight recorder's ring (the events that led
            # here are this death's black box), and let the thread
            # traceback surface
            get_registry().counter("serving.worker_deaths").inc()
            _flight.dump_installed(
                "serving.worker_death", error=repr(e)[:200]
            )
            raise

    def worker_alive(self) -> bool:
        """True while the query worker thread is running — the liveness
        signal the failover monitor polls."""
        t = self._worker_thread
        return t is not None and t.is_alive()

    def heartbeat_age_s(self) -> float:
        """Seconds since the worker last completed (started) a sweep —
        the liveness AGE an external probe reads to tell a wedged
        worker (old beat, thread alive) from a healthy idle one (fresh
        beat): ``worker_alive`` alone cannot make that distinction."""
        return max(0.0, time.monotonic() - self._worker_beat)

    def metrics_endpoint(self, **kw):
        """Start a scrape endpoint wired to this server:
        ``/metrics`` renders the process registry, ``/healthz`` reports
        worker liveness / pending depth / ingest state. Keyword args
        pass through to
        :class:`~gelly_streaming_tpu_torch.obs.endpoint.MetricsEndpoint`
        (``port=0`` binds an ephemeral port). The caller owns
        ``close()``."""
        from ..obs.endpoint import MetricsEndpoint

        return MetricsEndpoint.for_server(self, **kw).start()

    def _adopt(self, entries: list) -> None:
        """Enqueue already-admitted ``(query, future, t0, deadline,
        ctx)`` entries from another server — the failover promotion
        path. The entries keep their original submit times, deadlines,
        AND trace contexts, so re-answered queries still report honest
        latency and stay on their original trace (the promoted
        replica's answer span joins the same causal story); adoption
        bypasses admission on purpose (the queries were admitted once;
        failover must not shed them)."""
        if not entries:
            return
        with self._lock:
            self._pending.extend(entries)
            self.stats.set_pending(
                len(self._pending) + self._inflight
            )
        self._wake.set()

    def _worker_loop(self) -> None:
        while True:
            # heartbeat first: the watchdog reads it to distinguish a
            # stalled sweep (answer wedged on a device op) from idling
            self._worker_beat = time.monotonic()
            if _faults.active():  # chaos hook: worker stall / crash
                _faults.fire("serving.worker", index=self._sweeps)
                if self._pending:
                    # the port's addition: a sweep with a batch to answer,
                    # so a kill can be placed where one is in flight
                    _faults.fire("serving.worker.busy", index=self._sweeps)
            self._sweeps += 1
            batch = self._drain()
            if batch:
                if self.store.latest() is None and not (
                    self._closing or self._ingest_done.is_set()
                ):
                    # nothing published yet: hold the batch until the
                    # first window (or shutdown) instead of failing
                    self.store.wait_for(1, timeout=0.1)
                    with self._lock:
                        self._pending.extendleft(reversed(batch))
                        self._inflight = 0
                        self._inflight_entries = []
                    continue
                try:
                    self._answer(batch)
                except BaseException as e:
                    # the worker thread must survive ANY answer-path
                    # error — a dead worker hangs every future forever;
                    # fail this batch and keep serving
                    for _, f, *_rest in batch:
                        if not f.done():
                            f.set_exception(e)
                finally:
                    self._settle()
                continue
            if self._closing and not self._pending:
                return
            self._wake.wait(0.05)
            self._wake.clear()

    def _watchdog(self) -> None:
        """Stall watchdog (armed via ``watchdog_s``): flags a worker
        that has queries WAITING but has not completed a sweep within
        the threshold — wedged in an answer, not idle. Warns once per
        stall episode and counts ``serving.worker_stalls``; detection
        only (restart policy belongs to the operator — killing a thread
        blocked in a device op is not safe from here)."""
        flagged = False
        interval = max(self.watchdog_s / 2, 0.01)
        # interruptible wait: close() sets the stop event, so shutdown
        # never blocks on a half-period sleep
        while not self._watchdog_stop.wait(interval):
            with self._lock:
                waiting = bool(self._pending) or self._inflight > 0
            stalled = (
                waiting
                and self._worker_thread is not None
                and self._worker_thread.is_alive()
                and time.monotonic() - self._worker_beat > self.watchdog_s
            )
            if stalled and not flagged:
                flagged = True
                get_registry().counter("serving.worker_stalls").inc()
                warnings.warn(
                    f"serving worker made no progress for "
                    f"{self.watchdog_s}s with queries pending",
                    RuntimeWarning,
                )
            elif not stalled:
                flagged = False

    # ------------------------------------------------------------------ #
    # Shutdown
    # ------------------------------------------------------------------ #
    def ingest_finished(self) -> bool:
        """True once the servable's emission iterator is exhausted (or
        failed); the server keeps serving from the final snapshot."""
        return self._ingest_done.is_set()

    def join(self, timeout: Optional[float] = None) -> None:
        """Wait for ingest to finish the stream (server keeps serving
        from the final snapshot). Re-raises an ingest-side error."""
        if not self._ingest_done.wait(timeout):
            raise TimeoutError("ingest still running")
        if self._ingest_error is not None:
            raise self._ingest_error

    def close(self, timeout: float = 30.0) -> None:
        """Stop ingest at the next window boundary, answer every
        already-admitted query from the final snapshot, join both
        threads. Idempotent. ``timeout`` bounds the WHOLE close: each
        join gets what remains of the one budget, so a wedged
        ingest thread cannot triple the caller's wait."""
        if self._closed:
            return
        deadline = time.monotonic() + float(timeout)

        def remaining() -> float:
            return max(0.0, deadline - time.monotonic())

        with _trace.span("serving.drain"):
            self._closing = True
            self._stop_ingest.set()
            self._wake.set()
            if self._ingest_thread is not None:
                self._ingest_thread.join(remaining())
            if self._worker_thread is not None:
                self._worker_thread.join(remaining())
            # a submit racing the closing flag can slip one entry past
            # the worker's exit check; answer stragglers here so no
            # future hangs
            leftovers = self._drain()
            if leftovers:
                try:
                    self._answer(leftovers)
                except BaseException as e:
                    for _, f, *_rest in leftovers:
                        if not f.done():
                            f.set_exception(e)
                finally:
                    self._settle()
            self.store.close()
            self._closed = True
            self._watchdog_stop.set()
            if self._watchdog_thread is not None:
                self._watchdog_thread.join(remaining())
        if self._ingest_error is not None:
            raise self._ingest_error
