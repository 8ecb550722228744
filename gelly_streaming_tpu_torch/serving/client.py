"""RPC query client: reconnect-and-resubmit over the serving wire (the
port's copy of ``gelly_streaming_tpu/serving/client.py``; its frames are
the reference's, so either package's client talks to either's server).

The client half of :mod:`~gelly_streaming_tpu_torch.serving.rpc`. One
:class:`RpcClient` owns one framed connection at a time to a list of
replica addresses and gives callers the SAME future surface as a local
``StreamServer.submit`` — the wire is an implementation detail:

- ``submit_batch`` registers the batch under an idempotent client id
  and sends one REQ frame; answers settle the futures whenever the
  server's RESP arrives (async, out of submission order).
- ``overloaded`` wire rejections honor the client's
  :class:`~gelly_streaming_tpu_torch.resilience.RetryPolicy` — bounded,
  jittered, deadline-clamped re-asks (``rpc.client_retries``); ``shed``
  is TERMINAL and never retried (the server sheds that class to lose
  exactly this traffic); ``not_primary`` retries with its own backoff
  while a standby finishes promoting.
- On disconnect the client reconnects (cycling the address list under
  bounded exponential backoff) and RESUBMITS every pending batch under
  its original id; the server's dedupe cache absorbs double delivery,
  so a serving-process kill is visible only as a latency blip. Batches
  whose own ``deadline_s`` lapses mid-outage fail
  :class:`~gelly_streaming_tpu_torch.resilience.errors.DeadlineExceeded`
  cleanly (``rpc.client_deadline_expired`` +
  ``rpc.client_sweeper_expired``) — every submitted query is ALWAYS
  answered or cleanly expired, never lost.
- With tracing on (``obs.enable()``) each batch mints ONE
  :class:`~gelly_streaming_tpu_torch.obs.trace.TraceContext` that rides every
  send (first, retry, reconnect resubmit) in the frame body, so server
  spans on every replica that touched the batch join one trace;
  ``rpc.client.batch`` / ``rpc.client.retry`` / ``rpc.client.resubmit``
  spans carry the client half of the story, and the per-batch
  ``rpc.client_wire_seconds`` histogram (always on) gains exemplar
  trace ids linking its tail to concrete traces.
  :meth:`RpcClient.stats_snapshot` is the client-side stats parity
  surface.
"""

from __future__ import annotations

import itertools
import json
import os
import socket as _socket
import threading
import time
from concurrent.futures import Future, InvalidStateError
from typing import List, Optional, Sequence, Tuple, Union

from ..obs import trace as _trace
from ..obs.registry import get_registry
from ..resilience.errors import DeadlineExceeded
from ..resilience.retry import RetryPolicy, exp_backoff, jittered
from .query import Answer, Query
from .rpc import (
    BAD_REQUEST,
    DEFAULT_MAX_FRAME,
    Disconnect,
    MalformedFrame,
    NOT_PRIMARY,
    OK,
    OVERLOADED,
    SHED,
    T_REQ,
    T_RESP,
    Wire,
    encode_queries,
    pack_frame,
)
from .server import Overloaded, Shed
from .txn import TxnContext, TxnSnapshotExpired


class RpcError(RuntimeError):
    """Terminal wire-level failure (server error / bad request / spent
    routing budget). Never retried by the client."""


def _sent_pin(sent, shard: int):
    """The ``(version, boot)`` pin the batch's LAST send carried for
    ``shard`` (from its recorded wire txn field), or None when that
    shard was unpinned at send time — the distinction that tells "the
    peer ignored my pin" (honest typed failure) from "this answer is
    doing the pinning" (observe it)."""
    if not sent:
        return None
    p = sent.get("pin")
    if p is not None:
        return int(p[0]), str(p[1]) if len(p) > 1 else ""
    vec = sent.get("vec")
    if not vec:
        return None
    q = vec.get(str(int(shard)))
    if q is None:
        return None
    return int(q[0]), str(q[1]) if len(q) > 1 else ""


class _Batch:
    """One pending wire batch (client side). ``ctx`` is the batch's
    :class:`~gelly_streaming_tpu_torch.obs.trace.TraceContext` (None when
    tracing was off at submit): every send — first, retry, reconnect
    resubmit — rides the SAME context, so server-side spans on every
    replica that ever touched the batch join one trace. ``parent_sid``
    is the span the batch ROOT parents to when the caller handed in an
    upstream context (the router's fan-out span) — None for a true
    root."""

    __slots__ = ("id", "enc", "futures", "deadline_abs",
                 "attempts", "routes", "ctx", "parent_sid",
                 "t0", "t_send", "t_resp",
                 "txn_ctx", "txn_doc", "txn_sent", "reasks")

    def __init__(self, qid: str, enc: list, futures: list,
                 deadline_abs: Optional[float]):
        self.id = qid
        self.enc = enc
        self.futures = futures
        self.deadline_abs = deadline_abs
        self.attempts = 0   # overloaded re-asks
        self.routes = 0     # not_primary re-asks
        self.ctx = None
        self.parent_sid = None
        self.t0 = 0.0       # perf_counter at submit (e2e measurement)
        self.t_send = 0.0   # perf_counter at the LAST send attempt
        self.t_resp = 0.0   # perf_counter when the RESP frame arrived
        self.txn_ctx = None   # TxnContext riding this batch
        self.txn_doc = None   # raw wire txn dict (router sub-requests)
        self.txn_sent = None  # the txn field the LAST send carried
        self.reasks = 0       # floor-regression fresh-id re-asks

    def remaining_s(self) -> Optional[float]:
        if self.deadline_abs is None:
            return None
        return self.deadline_abs - time.monotonic()


class RpcClient:
    """Framed-socket client for one serving replica set.

    ``addresses`` is one ``"host:port"`` (or ``(host, port)``) or a
    list of them — give it BOTH replicas of a failover pair and the
    reconnect loop finds whichever currently serves. ``retry_policy``
    governs ``overloaded`` re-asks (default: the stock
    :class:`RetryPolicy`); pass None explicitly via
    ``retry_policy=RetryPolicy(attempts=0)`` semantics if rejections
    should surface immediately.
    """

    #: deadline sweep cadence (client-side expiry during outages)
    SWEEP_S = 0.02
    #: not_primary re-ask backoff shape (a standby mid-promotion)
    ROUTE_BASE_S = 0.02
    ROUTE_MAX_S = 0.25
    #: monotonic-floor regression re-asks (fresh id each — the old id
    #: would replay the server's CACHED stale answer) before the typed
    #: failure; backoff shape for the staler survivor to catch up
    FLOOR_REASKS = 6
    FLOOR_BASE_S = 0.02
    FLOOR_MAX_S = 0.25

    def __init__(
        self,
        addresses: Union[str, Tuple[str, int], Sequence],
        *,
        retry_policy: Optional[RetryPolicy] = None,
        reconnect_base_s: float = 0.02,
        reconnect_max_s: float = 1.0,
        connect_timeout_s: float = 5.0,
        route_attempts: int = 512,
        max_frame: int = DEFAULT_MAX_FRAME,
        seed: int = 0,
        start_index: int = 0,
    ):
        if isinstance(addresses, str) or (
            isinstance(addresses, tuple)
            and len(addresses) == 2
            and isinstance(addresses[1], int)
        ):
            addresses = [addresses]
        self._addrs = [self._parse(a) for a in addresses]
        if not self._addrs:
            raise ValueError("at least one replica address is required")
        self.retry_policy = retry_policy if retry_policy is not None \
            else RetryPolicy()
        self.reconnect_base_s = float(reconnect_base_s)
        self.reconnect_max_s = float(reconnect_max_s)
        self.connect_timeout_s = float(connect_timeout_s)
        self.route_attempts = int(route_attempts)
        self.max_frame = int(max_frame)
        self.seed = int(seed)
        self._lock = threading.Lock()
        self._pending: dict = {}
        self._wire: Optional[Wire] = None
        # first address tried; an EXPLICIT spread knob, deliberately
        # not seed-derived — against a primary/standby pair an implicit
        # spread would park half the clients on a standby that never
        # promotes, spinning on not_primary. A router FLEET (every
        # member serves) passes start_index=i to balance connections.
        self._addr_i = int(start_index) % len(self._addrs)
        # highest ownership epoch any reply frame carried (the router
        # fleet reads this off its shard clients to learn of a live
        # split from ordinary traffic — serving/reshard.py)
        self.epoch_observed = 0
        # monotonic-read floor: highest (version, boot) answered per
        # shard. Every later non-pinned answer from the same lineage
        # must be >= it — a resubmit that lands on a staler survivor is
        # DETECTED here (counted rpc.client_regressions) and re-asked
        # under a fresh id, never delivered as silent time travel.
        # Mutated only on the io thread (_settle_ok); boot "" answers
        # (router-merged, no single lineage) are excluded.
        self._vfloor: dict = {}
        self._closing = threading.Event()
        self._counter = itertools.count()
        self._id_prefix = f"{os.getpid():x}.{os.urandom(3).hex()}"
        self._io_thread = threading.Thread(
            target=self._io_loop, name="rpc-client-io", daemon=True
        )
        self._sweep_thread = threading.Thread(
            target=self._sweep, name="rpc-client-sweep", daemon=True
        )
        self._io_thread.start()
        self._sweep_thread.start()

    @staticmethod
    def _parse(addr) -> Tuple[str, int]:
        if isinstance(addr, tuple):
            return str(addr[0]), int(addr[1])
        host, _, port = str(addr).rpartition(":")
        return host or "127.0.0.1", int(port)

    def __enter__(self) -> "RpcClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------------------ #
    # Submission surface
    # ------------------------------------------------------------------ #
    def submit_batch(
        self,
        queries: Sequence[Query],
        *,
        deadline_s: Optional[float] = None,
        ctx=None,
        txn=None,
    ) -> List["Future[Answer]"]:
        """Send one query batch; one future per query. ``deadline_s``
        bounds each query's TOTAL budget — network, retries, reconnects,
        and the server-side wait all spend it; expiry fails the future
        with :class:`DeadlineExceeded` (client- or server-side,
        whichever notices first).

        ``ctx`` (optional, tracing only) is an UPSTREAM
        :class:`~gelly_streaming_tpu_torch.obs.trace.TraceContext` to join:
        the batch stays on that trace id and its root span parents to
        ``ctx.parent_sid`` — the hop a fan-out router makes so client,
        router, and shard spans form one causal tree.

        ``txn`` is a
        :class:`~gelly_streaming_tpu_torch.serving.txn.TxnContext` (or a
        pre-encoded wire txn dict, the router's per-shard form): the
        batch rides the transaction's pinned vector on every send and
        observes OK answers back into the context; a pinned read is
        answered at the pinned snapshot or fails
        :class:`TxnSnapshotExpired` — never silently fresher."""
        if self._closing.is_set():
            raise RuntimeError("rpc client is closed")
        enc = encode_queries(queries)
        qid = f"{self._id_prefix}-{next(self._counter)}"
        futures: List["Future[Answer]"] = [Future() for _ in queries]
        tctx = tdoc = None
        if txn is not None:
            if isinstance(txn, TxnContext):
                tctx = txn
                # the transaction's ONE deadline budget bounds
                # every read made under it — a batch never grants
                # itself more clock than the transaction has left
                rem = tctx.remaining_s()
                if rem is not None:
                    deadline_s = rem if deadline_s is None \
                        else min(float(deadline_s), rem)
            else:
                tdoc = dict(txn)
        deadline_abs = (
            None if deadline_s is None
            else time.monotonic() + float(deadline_s)
        )
        batch = _Batch(qid, enc, futures, deadline_abs)
        batch.txn_ctx = tctx
        batch.txn_doc = tdoc
        batch.t0 = time.perf_counter()
        if _trace.on():
            # mint ONE context per batch; its parent sid is reserved
            # now so server-side spans can parent to the client's root
            # span before that root is emitted (at settle). With an
            # upstream ctx the trace id is INHERITED, not minted.
            if ctx is not None:
                batch.ctx = _trace.TraceContext(
                    trace_id=ctx.trace_id,
                    parent_sid=_trace.next_sid(),
                )
                batch.parent_sid = ctx.parent_sid
            else:
                batch.ctx = _trace.TraceContext(
                    parent_sid=_trace.next_sid()
                )
        with self._lock:
            self._pending[qid] = batch
        wire = self._wire
        if wire is not None:
            try:
                self._send_batch(wire, batch)
            except OSError:
                # the reconnect loop owns recovery; the batch is
                # registered and will be resubmitted on the next
                # connection — count the undelivered first send
                get_registry().counter(
                    "rpc.swallowed", site="client_submit_send"
                ).inc()
        return futures

    def submit(self, query: Query, *,
               deadline_s: Optional[float] = None,
               ctx=None, txn=None) -> "Future[Answer]":
        return self.submit_batch(
            [query], deadline_s=deadline_s, ctx=ctx, txn=txn
        )[0]

    def ask_batch(
        self,
        queries: Sequence[Query],
        *,
        deadline_s: Optional[float] = None,
        timeout: Optional[float] = None,
        txn=None,
    ) -> List[Answer]:
        futures = self.submit_batch(
            queries, deadline_s=deadline_s, txn=txn
        )
        # `timeout` bounds the WHOLE batch wait: each result()
        # spends what remains of one budget — N sequential waits of
        # the full timeout would wait N× what the caller asked for
        deadline = None if timeout is None \
            else time.monotonic() + float(timeout)
        out = []
        for f in futures:
            out.append(f.result(
                None if deadline is None
                else max(0.0, deadline - time.monotonic())
            ))
        return out

    def ask(self, query: Query, timeout: Optional[float] = None,
            deadline_s: Optional[float] = None, txn=None) -> Answer:
        return self.submit(
            query, deadline_s=deadline_s, txn=txn
        ).result(timeout)

    def pending(self) -> int:
        with self._lock:
            return len(self._pending)

    def stats_snapshot(self) -> dict:
        """Client-side serving stats as a plain dict — the parity
        surface for the server's ``ServingStats.snapshot()``: retries, reroutes, reconnects, resubmits, sweeper
        expiries, and the per-batch wire latency histogram, all read
        from the shared process registry (the same instruments the
        cluster event stream ships), so a client process's view of an
        outage is inspectable without scraping the server::

            {"pending": 0, "retries": 2, "reconnects": 1, ...,
             "wire_ms": {"count": 120, "p50": 1.9, "p99": 410.0}}
        """
        reg = get_registry()

        def _count(name: str) -> int:
            total = 0.0
            for _labels, inst in reg.find(name):
                total += inst.value
            return int(total)

        hist = reg.histogram("rpc.client_wire_seconds")
        doc = {
            "pending": self.pending(),
            "epoch_observed": self.epoch_observed,
            "connects": _count("rpc.client_connects"),
            "disconnects": _count("rpc.client_disconnects"),
            "reconnects": _count("rpc.client_reconnects"),
            "resubmitted": _count("rpc.client_resubmitted"),
            "retries": _count("rpc.client_retries"),
            "reroutes": _count("rpc.client_reroutes"),
            "regressions": _count("rpc.client_regressions"),
            "sweeper_expired": _count("rpc.client_sweeper_expired"),
            "deadline_expired": _count("rpc.client_deadline_expired"),
            "wire_ms": {
                "count": hist.count,
                "p50": hist.percentile(50) * 1e3,
                "p99": hist.percentile(99) * 1e3,
                "max": hist.max * 1e3,
            },
        }
        exemplars = hist.exemplars()
        if exemplars:
            doc["wire_ms"]["exemplars"] = [
                {"ms": v * 1e3, "trace": t} for v, t in exemplars
            ]
        return doc

    # ------------------------------------------------------------------ #
    # Wire plumbing
    # ------------------------------------------------------------------ #
    def _send_batch(self, wire: Wire, batch: _Batch) -> None:
        doc = {"id": batch.id, "q": batch.enc}
        remaining = batch.remaining_s()
        if remaining is not None:
            # ship the REMAINING budget, not the original one: a
            # resubmit after an outage must not grant the server a
            # fresh full deadline the client no longer has
            doc["deadline_s"] = max(0.001, remaining)
        if batch.txn_ctx is not None:
            # the vector is re-read at EVERY send (first, retry,
            # reconnect resubmit): pins acquired since the last send
            # ride too, and txn_sent records exactly what THIS send
            # carried — the settle path compares the answer stamp
            # against it to detect a peer that ignored the pin
            batch.txn_sent = batch.txn_ctx.wire_doc()
            doc["txn"] = batch.txn_sent
        elif batch.txn_doc is not None:
            batch.txn_sent = batch.txn_doc
            doc["txn"] = batch.txn_doc
        if _trace.on() and batch.ctx is not None:
            doc["tc"] = batch.ctx.to_wire()
        batch.t_send = time.perf_counter()
        wire.send(pack_frame(T_REQ, json.dumps(doc).encode("utf-8")))

    def _io_loop(self) -> None:
        reg = get_registry()
        while not self._closing.is_set():
            wire = self._connect()
            if wire is None:
                return
            self._wire = wire
            reg.counter("rpc.client_connects").inc()
            self._resubmit_all(wire)
            self._read_loop(wire)
            self._wire = None
            wire.close()
            reg.counter("rpc.client_disconnects").inc()

    def _connect(self) -> Optional[Wire]:
        """Cycle the address list under bounded exponential backoff
        until a connection lands (or the client closes)."""
        attempt = 0
        while not self._closing.is_set():
            for off in range(len(self._addrs)):
                i = (self._addr_i + off) % len(self._addrs)
                host, port = self._addrs[i]
                try:
                    sock = _socket.create_connection(
                        (host, port), timeout=self.connect_timeout_s
                    )
                except OSError:
                    continue
                try:
                    sock.settimeout(None)
                    sock.setsockopt(
                        _socket.IPPROTO_TCP, _socket.TCP_NODELAY, 1
                    )
                except OSError:
                    # the server reset the fresh connection before the
                    # options landed: release THIS socket and try the
                    # next address — an uncaught raise here would leak
                    # the fd and kill the io thread
                    get_registry().counter(
                        "rpc.swallowed", site="connect_config"
                    ).inc()
                    sock.close()
                    continue
                self._addr_i = i
                return Wire(sock)
            delay = jittered(
                exp_backoff(
                    attempt, self.reconnect_base_s, self.reconnect_max_s
                ),
                0.5, self.seed, attempt,
            )
            get_registry().counter("rpc.client_reconnects").inc()
            self._closing.wait(delay)
            attempt += 1
        return None

    def _resubmit_all(self, wire: Wire) -> None:
        with self._lock:
            batches = list(self._pending.values())
        if not batches:
            return
        get_registry().counter(
            "rpc.client_resubmitted"
        ).inc(len(batches))
        for b in batches:
            # t_send == 0 means the batch was registered but never yet
            # on any wire (submit raced the first connect): that is a
            # first send, not an outage — no resubmit span for it
            if _trace.on() and b.ctx is not None and b.t_send > 0.0:
                # the batch's client-visible outage: last send on the
                # dead connection -> resubmit on the new one. This span
                # is the attribution of a failover's latency blip — it
                # is what joins the dead replica's partial spans to the
                # promoted replica's full ones in the merged timeline
                _trace.record_span(
                    "rpc.client.resubmit",
                    time.perf_counter() - b.t_send,
                    trace_id=b.ctx.trace_id,
                    parent=b.ctx.parent_sid,
                    attrs={"id": b.id},
                )
            try:
                self._send_batch(wire, b)
            except OSError:
                # this connection is already dead; the loop will build
                # a new one and resubmit again — visible, not fatal
                get_registry().counter(
                    "rpc.swallowed", site="client_resubmit_send"
                ).inc()
                return

    def _read_loop(self, wire: Wire) -> None:
        reg = get_registry()
        while not self._closing.is_set():
            try:
                ftype, payload = wire.read(max_frame=self.max_frame)
            except Disconnect:
                return
            except MalformedFrame as e:
                reg.counter("rpc.malformed", kind=e.kind).inc()
                return
            except ConnectionResetError:
                # injected rpc.frame disconnect or a real peer reset
                return
            except OSError:
                reg.counter(
                    "rpc.swallowed", site="client_read"
                ).inc()
                return
            if ftype != T_RESP:
                reg.counter("rpc.malformed", kind="type").inc()
                return
            t_frame = time.perf_counter()  # frame-arrival stamp
            try:
                doc = json.loads(payload.decode("utf-8"))
            except (ValueError, UnicodeDecodeError):
                reg.counter("rpc.malformed", kind="json").inc()
                continue
            self._handle_resp(doc, t_frame)

    # ------------------------------------------------------------------ #
    # Response handling
    # ------------------------------------------------------------------ #
    def _handle_resp(self, doc: dict,
                     t_frame: Optional[float] = None) -> None:
        reg = get_registry()
        qid = doc.get("id")
        if qid is None:
            # a server-side notification about an unidentifiable frame
            # (our own malformed send, in practice): nothing to settle
            reg.counter("rpc.client_anon_errors").inc()
            return
        with self._lock:
            batch = self._pending.get(qid)
        if batch is None:
            return  # late duplicate of an already-settled batch
        if t_frame is not None:
            batch.t_resp = t_frame
        ep = doc.get("epoch")
        if ep is not None and int(ep) > self.epoch_observed:
            # monotone adoption: reply frames from pre-split servers
            # keep arriving after the bump and must not flap it back
            self.epoch_observed = int(ep)
        status = doc.get("status")
        if status == OK:
            self._settle_ok(batch, doc.get("answers"))
        elif status == OVERLOADED:
            attempt = batch.attempts
            batch.attempts = attempt + 1
            remaining = batch.remaining_s()
            if remaining is not None and remaining <= 0:
                # the DEADLINE spent the budget, not the retry policy:
                # defer to the sweeper so the batch fails
                # DeadlineExceeded, as the module contract promises
                return
            delay = self.retry_policy.delay_before(attempt, remaining)
            if delay is None:
                self._fail(batch, Overloaded(
                    doc.get("error") or "server overloaded "
                    "(client retry budget spent)"
                ))
            else:
                reg.counter("rpc.client_retries").inc()
                self._schedule_resend(batch, delay)
        elif status == NOT_PRIMARY:
            routes = batch.routes
            batch.routes = routes + 1
            if routes >= self.route_attempts:
                self._fail(batch, RpcError(
                    "no replica would serve (routing budget spent)"
                ))
                return
            remaining = batch.remaining_s()
            if remaining is not None and remaining <= 0:
                return  # the sweeper expires it
            delay = jittered(
                exp_backoff(routes, self.ROUTE_BASE_S, self.ROUTE_MAX_S),
                0.5, self.seed, routes,
            )
            if remaining is not None:
                delay = min(delay, max(0.001, remaining))
            reg.counter("rpc.client_reroutes").inc()
            self._schedule_resend(batch, delay)
        elif status == SHED:
            self._fail(batch, Shed(
                doc.get("error") or "query class shed under pressure"
            ))
        elif status == BAD_REQUEST:
            self._fail(batch, RpcError(
                doc.get("error") or "bad request"
            ))
        else:
            self._fail(batch, RpcError(
                doc.get("error") or f"server error (status {status!r})"
            ))

    def _schedule_resend(self, batch: _Batch, delay: float) -> None:
        t = threading.Timer(delay, self._resend, args=(batch,))
        t.daemon = True
        t.start()

    def _resend(self, batch: _Batch) -> None:
        if self._closing.is_set():
            return
        with self._lock:
            if batch.id not in self._pending:
                return
        wire = self._wire
        if wire is None:
            return  # the reconnect path resubmits every pending batch
        if _trace.on() and batch.ctx is not None:
            # an overloaded/not_primary re-ask: round trip + backoff
            # since the last send, on the SAME trace — retries are part
            # of the query's causal story, not fresh queries
            _trace.record_span(
                "rpc.client.retry",
                time.perf_counter() - batch.t_send,
                trace_id=batch.ctx.trace_id,
                parent=batch.ctx.parent_sid,
                attrs={"attempts": batch.attempts,
                       "routes": batch.routes},
            )
        try:
            self._send_batch(wire, batch)
        except OSError:
            get_registry().counter(
                "rpc.swallowed", site="client_resend"
            ).inc()

    def _settle_ok(self, batch: _Batch, answers) -> None:
        with self._lock:
            self._pending.pop(batch.id, None)
        e2e_s = time.perf_counter() - batch.t0
        if not isinstance(answers, list) or \
                len(answers) != len(batch.futures):
            # a malformed OK payload is a FAILED batch: it must not
            # land in the wire-latency histogram (or become its p99
            # exemplar) or emit a completed batch-root span
            err = RpcError(
                f"answer count mismatch ({answers!r:.120})"
            )
            for f in batch.futures:
                self._set_exc(f, err)
            return
        # monotonic-floor regression scan BEFORE delivery: a resubmit
        # that landed on a staler survivor must not answer BEHIND an
        # already-delivered answer — re-ask under a FRESH id (the old
        # id would replay the server's cached stale RESP) while the
        # survivor catches up, typed failure when the budget is spent
        floor_fail = self._regressed(batch, answers)
        if floor_fail is None:
            return  # re-asked; the batch is pending again
        # per-batch wire latency (submit -> answered), always recorded:
        # client-side latency parity with the server's ServingStats.
        # The exemplar (tracing only) links this histogram's tail to a
        # concrete trace id.
        traced = _trace.on() and batch.ctx is not None
        get_registry().histogram("rpc.client_wire_seconds").observe(
            e2e_s, exemplar=batch.ctx.trace_id if traced else None
        )
        if traced:
            # the batch's ROOT span, emitted under the sid reserved at
            # submit — every server/retry span already parents to it.
            # send_s/recv_s are the CLIENT-LOCAL stages of the
            # attribution table: submit -> last send on the wire, and
            # response-frame arrival -> this settle (encode, io-thread
            # wakeup, response parse — the milliseconds a server-only
            # view can never account for)
            now = time.perf_counter()
            _trace.record_span(
                "rpc.client.batch", e2e_s,
                trace_id=batch.ctx.trace_id,
                sid=batch.ctx.parent_sid,
                parent=batch.parent_sid,
                attrs={"n": len(batch.futures),
                       "attempts": batch.attempts,
                       "routes": batch.routes,
                       "send_s": round(
                           max(0.0, batch.t_send - batch.t0), 6),
                       "recv_s": round(
                           max(0.0, now - batch.t_resp)
                           if batch.t_resp > 0.0 else 0.0, 6)},
            )
        for i, (f, a) in enumerate(zip(batch.futures, answers)):
            try:
                if a[0] == "ok":
                    ans = Answer(
                        value=a[1], window=int(a[2]),
                        watermark=int(a[3]), staleness=int(a[4]),
                        # the snapshot version rides newer servers'
                        # replies (cache-invalidation key); absent on a
                        # v1 peer's answers, which read as version 0.
                        # the event-time watermark stamp follows it —
                        # absent reads as -1, "no event time"; the
                        # shard + boot-lineage stamps after THAT are
                        # what a transaction pins from
                        version=int(a[5]) if len(a) > 5 else 0,
                        event_ts=int(a[6]) if len(a) > 6 else -1,
                        shard=int(a[7]) if len(a) > 7 else -1,
                        boot=str(a[8]) if len(a) > 8 else "",
                    )
                    pin = _sent_pin(batch.txn_sent, ans.shard)
                    if pin is not None and \
                            (ans.version, ans.boot) != pin:
                        # the peer ignored the pin (a v1 txn-unaware
                        # server, or a stripped tag): DETECTED from
                        # the reply stamp and failed honestly — the
                        # transaction is never quietly handed this
                        # fresher (or older) answer
                        get_registry().counter(
                            "txn.unaware_peer"
                        ).inc()
                        self._set_exc(f, TxnSnapshotExpired(
                            f"pinned read (v{pin[0]}) answered at "
                            f"v{ans.version} by a txn-unaware peer",
                            kind="unaware_peer",
                        ))
                        continue
                    if i in floor_fail:
                        self._set_exc(f, RpcError(
                            f"monotonic read violated: shard "
                            f"{ans.shard} answered v{ans.version} "
                            f"behind the delivered floor "
                            f"(re-ask budget spent)"
                        ))
                        continue
                    if pin is None:
                        if batch.txn_ctx is not None:
                            batch.txn_ctx.observe(ans)
                        self._floor_note(
                            ans.shard, ans.version, ans.boot)
                    self._set_res(f, ans)
                elif a[0] == "txn_expired":
                    # typed honest expiry from the server's pinned
                    # answer path — re-raised per answer, counted at
                    # the server's raise site
                    self._set_exc(f, TxnSnapshotExpired(
                        str(a[1]),
                        kind=str(a[2]) if len(a) > 2 else "expired",
                    ))
                elif a[0] == "deadline":
                    # a SERVER-reported expiry (the answer rode a RESP
                    # frame): counted into the deadline total so
                    # deadline_expired - sweeper_expired isolates the
                    # outages the server never answered at all
                    get_registry().counter(
                        "rpc.client_deadline_expired"
                    ).inc()
                    self._set_exc(f, DeadlineExceeded(str(a[1])))
                else:
                    self._set_exc(f, RpcError(str(a[1])))
            except (IndexError, TypeError, ValueError):
                get_registry().counter(
                    "rpc.malformed", kind="answer"
                ).inc()
                self._set_exc(f, RpcError(f"malformed answer {a!r:.120}"))

    def _regressed(self, batch: _Batch, answers):
        """Floor-regression scan over a decoded OK payload.

        Returns the set of answer indices that must fail typed (re-ask
        budget spent), an empty set when nothing regressed, or None
        when the whole batch was RE-ASKED under a fresh id (satellite
        1: the resubmit-behind-the-floor bug). Pinned answers are
        exempt — a pin is exact-match checked at settle, not
        floor-checked. Runs on the io thread only (like _vfloor)."""
        hit = set()
        for i, a in enumerate(answers):
            try:
                if not (isinstance(a, list) and a and a[0] == "ok"
                        and len(a) > 8):
                    continue
                shard = int(a[7])
                boot = str(a[8])
                version = int(a[5])
            except (IndexError, TypeError, ValueError):
                continue  # the settle loop reports malformed answers
            if not boot or version <= 0:
                continue  # unstamped/merged answers carry no lineage
            if _sent_pin(batch.txn_sent, shard) is not None:
                continue
            fl = self._vfloor.get(shard)
            if fl is not None and fl[1] == boot and version < fl[0]:
                hit.add(i)
        if not hit:
            return hit
        get_registry().counter("rpc.client_regressions").inc()
        if batch.reasks >= self.FLOOR_REASKS:
            return hit  # typed failure at settle, never time travel
        batch.reasks += 1
        batch.id = f"{self._id_prefix}-{next(self._counter)}"
        with self._lock:
            self._pending[batch.id] = batch
        delay = jittered(
            exp_backoff(batch.reasks - 1, self.FLOOR_BASE_S,
                        self.FLOOR_MAX_S),
            0.5, self.seed, batch.reasks,
        )
        remaining = batch.remaining_s()
        if remaining is not None:
            delay = min(delay, max(0.001, remaining))
        self._schedule_resend(batch, delay)
        return None

    def _floor_note(self, shard: int, version: int, boot: str) -> None:
        """Advance the monotonic floor from one DELIVERED answer; a
        boot change is a new lineage and resets the shard's floor."""
        if not boot or version <= 0:
            return
        fl = self._vfloor.get(shard)
        if fl is None or fl[1] != boot or version > fl[0]:
            self._vfloor[shard] = (version, boot)

    def _fail(self, batch: _Batch, exc: BaseException) -> None:
        with self._lock:
            self._pending.pop(batch.id, None)
        for f in batch.futures:
            self._set_exc(f, exc)

    @staticmethod
    def _set_res(f: Future, ans: Answer) -> None:
        if not f.done():
            try:
                f.set_result(ans)
            except InvalidStateError:
                get_registry().counter(
                    "rpc.swallowed", site="client_settle_race"
                ).inc()

    @staticmethod
    def _set_exc(f: Future, exc: BaseException) -> None:
        if not f.done():
            try:
                f.set_exception(exc)
            except InvalidStateError:
                get_registry().counter(
                    "rpc.swallowed", site="client_settle_race"
                ).inc()

    # ------------------------------------------------------------------ #
    # Deadline sweeper (client-side expiry survives a dead server)
    # ------------------------------------------------------------------ #
    def _sweep(self) -> None:
        while not self._closing.wait(self.SWEEP_S):
            now = time.monotonic()
            expired = []
            with self._lock:
                for qid, b in list(self._pending.items()):
                    if b.deadline_abs is not None and \
                            now > b.deadline_abs:
                        expired.append(self._pending.pop(qid))
            for b in expired:
                # deadline_expired totals EVERY client-visible expiry
                # (these sweeper batches + the server-reported
                # per-answer expiries counted in _settle_ok);
                # sweeper_expired isolates the
                # ones the server never answered at all — the outage
                # signal invisible to the obs plane until now
                get_registry().counter(
                    "rpc.client_deadline_expired"
                ).inc()
                get_registry().counter(
                    "rpc.client_sweeper_expired"
                ).inc()
                exc = DeadlineExceeded(
                    "query batch unanswered within its deadline "
                    "(server unreachable or slow)"
                )
                for f in b.futures:
                    self._set_exc(f, exc)

    # ------------------------------------------------------------------ #
    def close(self) -> None:
        if self._closing.is_set():
            return
        self._closing.set()
        wire = self._wire
        if wire is not None:
            wire.close()
        self._io_thread.join(5.0)
        self._sweep_thread.join(5.0)
        with self._lock:
            leftovers = list(self._pending.values())
            self._pending.clear()
        exc = RpcError("rpc client closed with the batch pending")
        for b in leftovers:
            for f in b.futures:
                self._set_exc(f, exc)
