"""Wire-level query serving: the RPC front end on ``StreamServer.submit``
(the port's copy of ``gelly_streaming_tpu/serving/rpc.py``; its frames,
query codec and stamps are the reference's byte for byte, so a client of
either package talks to a server of either).

The TELEMETRY half of the serving tier is on the wire in
``obs/endpoint.py``'s scrape surface; this module is the query half, so a
client can reach ``submit`` from another process, kept on the same
stdlib-only stance:

- **Length-prefixed binary frames** (:data:`MAGIC` + version + type +
  payload length, then a compact JSON body). Framing is the contract a
  TCP stream needs: a reader always knows where one message ends, a
  torn read is DETECTABLE (``rpc.malformed{kind=truncated}``) instead
  of a parser wedged mid-garbage, and oversized/garbage input is
  rejected per-connection without touching the handler thread's life.
- **Batched at the socket boundary**: one REQ frame carries a whole
  query batch under ONE idempotent batch id — the wire analog of the
  worker's drain-and-coalesce discipline, so a chatty client cannot
  force per-query dispatches.
- **Async answer delivery**: the handler thread only parses and admits;
  answers ride the queries' future callbacks (the server worker's
  thread) back onto the connection, so a slow sweep never blocks the
  read loop and responses may complete out of submission order
  (clients match on the batch id).
- **The existing semantics travel**: :class:`~.server.Overloaded`
  becomes the retryable wire status ``overloaded`` (the CLIENT honors
  its :class:`~gelly_streaming_tpu_torch.resilience.RetryPolicy`; the server
  never sleeps a handler thread), :class:`~.server.Shed` is terminal
  (``shed`` — clients must not retry; shedding exists to lose exactly
  that traffic), and a per-query ``deadline_s`` rides the frame and
  expires SERVER-SIDE through ``StreamServer``'s own deadline sweep.

Cross-process failover (:class:`ReplicaServer`) extends the in-process
:class:`~.failover.FailoverServer` story to a standby serving BINARY:
the primary mirrors every published snapshot into a shared directory
(:class:`~.snapshot_store.SnapshotMirror` — CRC-framed, atomic-commit)
and maintains a heartbeat lease there (:class:`HeartbeatLease`, same
commit discipline); the standby process follows the directory
(:func:`~.snapshot_store.follow_snapshots`), answers ``not_primary``
to keep clients pointed at the primary, and PROMOTES itself when the
lease lapses — counting ``serving.lease_lapse`` +
``serving.failover{reason=lease_lapse}`` and observing
``serving.promotion_seconds``, so a cross-process takeover renders in
the same timeline vocabulary as the in-process one. Ingest is not
failed over (the primary owned it); the standby keeps serving the
newest mirrored snapshot — the keep-serving-from-final-state contract,
now across processes. Clients (:class:`~.client.RpcClient`) reconnect
and RESUBMIT in-flight batches under their original ids; the server's
dedupe cache makes double delivery harmless, so a primary kill is
client-visible only as a latency blip.

``python -m gelly_streaming_tpu_torch.serving.rpc --smoke [--cpu]`` is the
CI gate:
it boots a primary + standby replica pair as real subprocesses,
round-trips a query batch over real sockets, SIGKILLs the primary, and
asserts the client's retry lands on the promoted standby.
"""

from __future__ import annotations

import json
import os
import socket as _socket
import threading
import time
from collections import OrderedDict
from functools import partial
from typing import Callable, List, Optional, Tuple

from ..obs import trace as _trace
from ..obs.registry import get_registry
from ..resilience import faults as _faults
from .query import (
    Answer,
    BipartiteQuery,
    ComponentSizeQuery,
    ConnectedQuery,
    DegreeQuery,
    Query,
    RankQuery,
    SummaryPullQuery,
)
from .server import Overloaded, Shed, StreamServer
from .snapshot_store import (
    SnapshotMirror,
    SnapshotStore,
    follow_snapshots,
)
from .txn import TxnSnapshotExpired, active_txn_count, decode_txn, note_txn

# --------------------------------------------------------------------- #
# Wire format — the GSRP framing lives in the cluster fabric
# (fabric/wire.py) so the exchange daemon speaks the same
# frames; re-exported here because every RPC consumer (client, router,
# ingest, the fuzz tests) imports it from this module.
# --------------------------------------------------------------------- #
from ..fabric.wire import (  # noqa: E402  (re-export)
    DEFAULT_MAX_FRAME,
    HEADER,
    MAGIC,
    T_REQ,
    T_RESP,
    VERSION,
    Disconnect,
    MalformedFrame,
    pack_frame,
    read_frame,
    recv_exact,
)

# batch-level wire statuses
OK = "ok"
OVERLOADED = "overloaded"      # retryable: admission limit reached
SHED = "shed"                  # terminal: class is load-shed, never retry
NOT_PRIMARY = "not_primary"    # retryable elsewhere: replica is standby
BAD_REQUEST = "bad_request"    # terminal: the frame parsed, the request didn't
ERROR = "error"                # terminal: server-side failure

#: statuses a client may retry (everything else is terminal)
RETRYABLE = frozenset({OVERLOADED, NOT_PRIMARY})


class Wire:
    """One framed socket endpoint: serialized sends, frame-counted
    reads, both threaded through the fault plan's socket sites
    (``rpc.frame`` disconnects on the read path, one-shot frame
    truncation on the send path)."""

    def __init__(self, sock):
        self.sock = sock
        self.wlock = threading.Lock()
        self.sent = 0
        self.rcvd = 0

    def send(self, data: bytes) -> None:
        # wlock exists to SERIALIZE frame writes on one socket — a
        # frame interleaved mid-frame is wire corruption, so blocking
        # the next sender until this frame is fully out is the lock's
        # entire purpose, not contention (suppressions below)
        with self.wlock:
            idx = self.sent
            self.sent = idx + 1
            if _faults.active() and _faults.rpc_truncate(idx):
                # the torn-write shape on the wire: half a frame, then
                # the connection dies — the peer must count a clean
                # rpc.malformed{kind=truncated}, never a thread death
                try:
                    self.sock.sendall(data[: max(1, len(data) // 2)])
                finally:
                    self.close()
                raise ConnectionAbortedError("injected frame truncation")
            self.sock.sendall(data)

    def read(self, *, max_frame: int = DEFAULT_MAX_FRAME
             ) -> Tuple[int, bytes]:
        ftype, payload = read_frame(self.sock, max_frame=max_frame)
        if _faults.active():
            _faults.fire("rpc.frame", index=self.rcvd)
        self.rcvd += 1
        return ftype, payload

    def close(self) -> None:
        # shutdown BEFORE close: a reader blocked in recv on another
        # thread only wakes reliably on shutdown — close alone can
        # leave it hanging until its own next byte (ENOTCONN from an
        # already-reset peer is the normal case, not an event)
        try:
            self.sock.shutdown(_socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self.sock.close()
        except OSError:
            # double close / already-reset socket: nothing left to
            # release, but keep the event visible
            get_registry().counter(
                "rpc.swallowed", site="wire_close"
            ).inc()


# --------------------------------------------------------------------- #
# Query / answer codec (wire <-> serving/query.py types)
# --------------------------------------------------------------------- #
_Q_KINDS = {
    "C": (ConnectedQuery, 2),
    "D": (DegreeQuery, 1),
    "R": (RankQuery, 1),
    "S": (ComponentSizeQuery, 1),
    "P": (SummaryPullQuery, 0),
    "B": (BipartiteQuery, 0),
}
_Q_TAGS = {
    ConnectedQuery: "C",
    DegreeQuery: "D",
    RankQuery: "R",
    ComponentSizeQuery: "S",
    SummaryPullQuery: "P",
    BipartiteQuery: "B",
}


def encode_queries(queries) -> List[list]:
    out = []
    for q in queries:
        tag = _Q_TAGS.get(type(q))
        if tag is None:
            raise TypeError(
                f"{type(q).__name__} has no wire encoding"
            )
        if tag == "C":
            out.append([tag, int(q.u), int(q.v)])
        elif tag == "P":
            # protocol v2: the delta baseline rides as an OPTIONAL
            # trailing field — a v1-shaped pull (since_version < 0)
            # stays the bare ["P"] item old servers already accept
            if q.since_version >= 0:
                out.append([tag, int(q.since_version)])
            else:
                out.append([tag])
        elif tag == "B":
            out.append([tag])
        else:
            out.append([tag, int(q.v)])
    return out


def decode_queries(items) -> List[Query]:
    out: List[Query] = []
    for it in items:
        cls, arity = _Q_KINDS.get(it[0], (None, 0))
        if cls is None:
            raise ValueError(f"unknown or malformed query item {it!r}")
        if cls is SummaryPullQuery:
            # arity 0 (v1) or 1 (v2 with since_version) both decode
            if len(it) not in (1, 2):
                raise ValueError(
                    f"unknown or malformed query item {it!r}")
        elif len(it) != arity + 1:
            raise ValueError(f"unknown or malformed query item {it!r}")
        out.append(cls(*(int(x) for x in it[1:])))
    return out


def encode_answer(ans: Answer, shard: Optional[int] = None) -> list:
    v = ans.value
    if hasattr(v, "item"):
        v = v.item()
    # the trailing snapshot version is what a routing tier keys its
    # hot-key cache invalidation on; the event-time watermark stamp
    # after it says how far behind the WORLD the answer is; the shard
    # index + boot lineage after THAT complete the reply stamp a
    # snapshot-pinned transaction pins its vector from —
    # decoders tolerate the absence of any trailing field, so v1
    # peers stay interoperable (written here, read in
    # client._settle_ok)
    s = int(ans.shard)
    if s < 0 and shard is not None:
        s = int(shard)
    return ["ok", v, ans.window, ans.watermark, ans.staleness,
            ans.version, ans.event_ts, s, ans.boot]


# --------------------------------------------------------------------- #
# Server
# --------------------------------------------------------------------- #
class _Batch:
    """One in-flight wire batch: futures + answer slots + the delivery
    connection (re-homed when the client resubmits on a new socket).
    ``ctx``/``t_recv``/``decode_s``/``admit_s`` carry the batch's trace
    context and stage timings from the handler thread to the worker
    callback that emits the server-side spans (set only when tracing
    was on at receive time)."""

    __slots__ = ("id", "conn", "futures", "slots", "remaining",
                 "ctx", "t_recv", "decode_s", "admit_s")

    def __init__(self, qid: str, conn: Wire, futures: list):
        self.id = qid
        self.conn = conn
        self.futures = futures
        self.slots: list = [None] * len(futures)
        self.remaining = len(futures)
        self.ctx = None
        self.t_recv = 0.0
        self.decode_s = 0.0
        self.admit_s = 0.0


class RpcServer:
    """Socket front end over anything with ``StreamServer.submit``'s
    contract (a ``StreamServer``, a ``FailoverServer``, a
    ``ReplicaServer``'s inner server).

    ``gate`` (optional) is consulted per batch BEFORE admission: return
    None to serve, or a wire status (``not_primary``) to refuse — the
    standby replica's refusal hook. ``port=0`` binds an ephemeral port
    (read it back from :attr:`port`).

    Answered batches are cached (``dedupe_cap`` most recent) under
    their idempotent batch id: a client that lost the response to a
    disconnect RESUBMITS the same id and gets the cached answer
    (``rpc.deduped``) instead of recomputing; a resubmit that catches
    the batch still in flight just re-homes its delivery connection.
    """

    def __init__(
        self,
        server,
        *,
        host: str = "127.0.0.1",
        port: int = 0,
        gate: Optional[Callable[[], Optional[str]]] = None,
        max_frame: int = DEFAULT_MAX_FRAME,
        dedupe_cap: int = 1024,
        epoch: Optional[Callable[[], int]] = None,
        shard: Optional[int] = None,
        txn_narrow: bool = True,
    ):
        self.server = server
        self.host = host
        self._port = int(port)
        self.gate = gate
        # ownership-epoch provider (serving.reshard): when it returns
        # > 0, reply frames carry the epoch so routers learn of live
        # splits from ordinary traffic, no control channel needed
        self.epoch = epoch
        # this replica's shard index: stamps every reply answer (the
        # pin source a TxnContext observes) and narrows an inbound txn
        # VECTOR down to the one pin this shard must honor
        self.shard = None if shard is None else int(shard)
        # False for a ROUTER front end: a router fans a txn VECTOR out
        # across shards itself, so the decoded txn must pass through
        # un-narrowed (narrowing here would drop a multi-shard vector
        # on the floor — the front end has no single shard identity)
        self.txn_narrow = bool(txn_narrow)
        # one-time probe: does the inner server's submit path accept
        # the txn kwarg? A server without it IS a v1 txn-unaware peer
        # — the pin is dropped here and the CLIENT detects the unpinned
        # answer from the reply stamp, failing the read honestly
        import inspect

        self._txn_kwarg = False
        try:
            target = getattr(server, "submit_many", None) \
                or getattr(server, "submit", None)
            if target is not None:
                self._txn_kwarg = (
                    "txn" in inspect.signature(target).parameters
                )
        except (TypeError, ValueError):
            pass
        self.max_frame = int(max_frame)
        self.dedupe_cap = int(dedupe_cap)
        self._lock = threading.Lock()
        self._conns: set = set()
        self._done: "OrderedDict[str, bytes]" = OrderedDict()
        self._inflight: dict = {}
        self._listener = None
        self._accept_thread: Optional[threading.Thread] = None
        self._closing = threading.Event()

    # ------------------------------------------------------------------ #
    @property
    def port(self) -> int:
        return self._port

    @property
    def address(self) -> str:
        return f"{self.host}:{self._port}"

    def start(self) -> "RpcServer":
        if self._listener is not None:
            raise RuntimeError("rpc server already started")
        s = _socket.socket(_socket.AF_INET, _socket.SOCK_STREAM)
        try:
            s.setsockopt(_socket.SOL_SOCKET, _socket.SO_REUSEADDR, 1)
            s.bind((self.host, self._port))
            s.listen(128)
            # a bounded accept timeout is the shutdown path: closing a
            # listener does NOT wake a thread blocked in accept on
            # Linux, so the loop polls the closing flag at this cadence
            s.settimeout(0.25)
        except OSError:
            # bind/listen failed (port taken, perms): the caller gets
            # the error, not a leaked listener fd
            s.close()
            raise
        self._listener = s
        self._port = s.getsockname()[1]
        self._accept_thread = threading.Thread(
            target=self._accept, name="rpc-accept", daemon=True
        )
        self._accept_thread.start()
        return self

    def __enter__(self) -> "RpcServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    def _accept(self) -> None:
        while not self._closing.is_set():
            try:
                sock, _addr = self._listener.accept()
            except TimeoutError:
                continue  # the closing-flag poll cadence
            except OSError:
                if self._closing.is_set():
                    return
                get_registry().counter(
                    "rpc.swallowed", site="accept"
                ).inc()
                continue
            try:
                sock.settimeout(None)
                sock.setsockopt(_socket.IPPROTO_TCP,
                                _socket.TCP_NODELAY, 1)
            except OSError:
                # a peer that connected and reset immediately: config
                # on its socket can raise — that must drop THIS socket
                # (closed, counted), never kill the accept thread and
                # leave the whole server deaf
                get_registry().counter(
                    "rpc.swallowed", site="accept_config"
                ).inc()
                sock.close()
                continue
            conn = Wire(sock)
            with self._lock:
                if self._closing.is_set():
                    conn.close()
                    return
                self._conns.add(conn)
            get_registry().counter("rpc.connects").inc()
            threading.Thread(
                target=self._handle, args=(conn,),
                name="rpc-conn", daemon=True,
            ).start()

    # ------------------------------------------------------------------ #
    def _handle(self, conn: Wire) -> None:
        """Per-connection read loop. EVERY exit path is per-connection:
        malformed bytes, injected disconnects, and peer resets end THIS
        socket (counted), never the handler pool or the server."""
        reg = get_registry()
        try:
            while not self._closing.is_set():
                try:
                    ftype, payload = conn.read(max_frame=self.max_frame)
                except Disconnect:
                    return
                except MalformedFrame as e:
                    reg.counter("rpc.malformed", kind=e.kind).inc()
                    self._respond(conn, None, ERROR,
                                  error=f"malformed frame: {e.kind}")
                    return
                except ConnectionResetError:
                    # the fault plan's injected mid-stream disconnect
                    # (rpc.frame site) or a real peer reset between
                    # frames: clean per-connection teardown
                    return
                if ftype != T_REQ:
                    reg.counter("rpc.malformed", kind="type").inc()
                    self._respond(conn, None, ERROR,
                                  error=f"unexpected frame type {ftype}")
                    return
                t_recv = time.perf_counter()
                doc = None
                try:
                    doc = json.loads(payload.decode("utf-8"))
                    qid = str(doc["id"])
                    queries = decode_queries(doc["q"])
                    deadline_s = doc.get("deadline_s")
                    # coerce HERE, not at submit: a non-numeric
                    # deadline must be a terminal bad_request, never a
                    # handler-thread death inside _admit's float()
                    if deadline_s is not None:
                        deadline_s = float(deadline_s)
                except (ValueError, KeyError, TypeError,
                        UnicodeDecodeError) as e:
                    reg.counter("rpc.malformed", kind="request").inc()
                    bad_id = doc.get("id") if isinstance(doc, dict) \
                        else None
                    self._respond(conn, bad_id, BAD_REQUEST,
                                  error=repr(e)[:200])
                    continue
                # trace extraction is GATED: the tc field is parsed and
                # a context allocated only when tracing is on (the
                # disabled wire path allocates nothing for it); a
                # missing/garbage tc is an untraced batch
                ctx = None
                decode_s = 0.0
                if _trace.on():
                    ctx = _trace.TraceContext.from_wire(doc.get("tc"))
                    decode_s = time.perf_counter() - t_recv
                    if ctx is not None:
                        _trace.record_span(
                            "rpc.decode", decode_s,
                            trace_id=ctx.trace_id,
                            parent=ctx.parent_sid,
                            attrs={"id": qid},
                        )
                # the txn field is OPTIONAL and tolerant: absent or
                # garbage decodes as None (unpinned request); a v1
                # client never sends it, a v1 server never reads it
                txn = decode_txn(doc.get("txn"))
                self._serve_batch(conn, qid, queries, deadline_s,
                                  ctx, t_recv, decode_s, txn=txn)
        finally:
            with self._lock:
                self._conns.discard(conn)
            conn.close()
            reg.counter("rpc.disconnects").inc()

    def _serve_batch(self, conn: Wire, qid: str, queries: list,
                     deadline_s, ctx=None, t_recv: float = 0.0,
                     decode_s: float = 0.0, txn=None) -> None:
        reg = get_registry()
        if txn is not None:
            note_txn(txn.get("id", ""))
            if self.txn_narrow:
                txn = self._narrow_txn(txn)
        with self._lock:
            cached = self._done.get(qid)
            if cached is not None:
                self._done.move_to_end(qid)
            inflight = None
            if cached is None:
                inflight = self._inflight.get(qid)
                if inflight is not None:
                    # the client resubmitted (reconnect) while the
                    # batch is still being answered: deliver to the
                    # NEW connection, don't recompute
                    inflight.conn = conn
        if cached is not None:
            reg.counter("rpc.deduped").inc()
            self._send(conn, cached)
            return
        if inflight is not None:
            reg.counter("rpc.deduped").inc()
            return
        gate = self.gate
        refusal = gate() if gate is not None else None
        if refusal is not None:
            reg.counter("rpc.not_primary").inc()
            self._respond(conn, qid, refusal)
            return
        t_admit = time.perf_counter()
        futures: list = []
        # one-lock batch admission when the server offers it (the
        # whole-frame fast path); the per-query loop stays the
        # compatibility path for bare submit-only servers
        many = getattr(self.server, "submit_many", None)
        # the txn kwarg rides only when the probe found it: a server
        # without it is a v1 peer — the pin is DROPPED here and the
        # client fails the unpinned answer honestly via the reply stamp
        kw = {}
        if txn is not None and self._txn_kwarg:
            kw["txn"] = txn
        try:
            if many is not None:
                futures = many(queries, deadline_s=deadline_s, ctx=ctx,
                               **kw)
            else:
                for q in queries:
                    futures.append(
                        self.server.submit(q, deadline_s=deadline_s,
                                           ctx=ctx, **kw)
                    )
        except Shed as e:
            self._cancel(futures)
            self._respond(conn, qid, SHED, error=str(e)[:200])
            return
        except Overloaded as e:
            # a partial batch must not half-admit: cancel what slipped
            # in and report the whole batch retryable — queries are
            # idempotent reads, so the client's full resubmit is safe
            self._cancel(futures)
            self._respond(conn, qid, OVERLOADED, error=str(e)[:200])
            return
        except TypeError as e:
            self._cancel(futures)
            self._respond(conn, qid, BAD_REQUEST, error=str(e)[:200])
            return
        except RuntimeError as e:
            self._cancel(futures)
            self._respond(conn, qid, ERROR, error=str(e)[:200])
            return
        except Exception as e:
            # the no-thread-death contract is structural, not an
            # enumeration: ANY admission-path surprise fails THIS
            # batch terminally (counted), never the handler thread
            self._cancel(futures)
            reg.counter("rpc.answer_errors").inc()
            self._respond(conn, qid, ERROR, error=repr(e)[:200])
            return
        batch = _Batch(qid, conn, futures)
        if _trace.on() and ctx is not None:
            batch.ctx = ctx
            batch.t_recv = t_recv
            batch.decode_s = decode_s
            batch.admit_s = time.perf_counter() - t_admit
            _trace.record_span(
                "rpc.admit", batch.admit_s,
                trace_id=ctx.trace_id, parent=ctx.parent_sid,
                attrs={"n": len(queries)},
            )
        with self._lock:
            self._inflight[qid] = batch
        reg.counter("rpc.batches").inc()
        reg.counter("rpc.queries").inc(len(queries))
        for i, f in enumerate(futures):
            f.add_done_callback(partial(self._one_done, batch, i))

    def _narrow_txn(self, txn: dict) -> Optional[dict]:
        """Narrow a wire txn down to THIS shard's single pin.

        A router-directed sub-request already carries ``pin``; a
        client's direct request carries the full ``vec`` — only the
        entry for this replica's shard (or the sole entry, for an
        unsharded deployment) applies here. A vector with no entry for
        this shard means the transaction has not pinned it yet: the
        request runs unpinned and the ANSWER's stamp does the pinning.
        """
        if txn.get("pin") is not None:
            return txn
        vec = txn.get("vec")
        if not vec:
            return None  # bare id: nothing pinned yet
        pin = None
        if self.shard is not None:
            pin = vec.get(self.shard)
        elif len(vec) == 1:
            pin = next(iter(vec.values()))
        if pin is None:
            return None
        return {"id": txn.get("id", ""), "pin": pin, "vec": None}

    @staticmethod
    def _cancel(futures: list) -> None:
        for f in futures:
            f.cancel()

    def _one_done(self, batch: _Batch, i: int, fut) -> None:
        """Future callback (the serving worker's thread): record one
        answer slot; the LAST slot serializes and delivers the batch."""
        batch.slots[i] = self._encode_result(fut)
        with self._lock:
            batch.remaining -= 1
            if batch.remaining:
                return
            self._inflight.pop(batch.id, None)
        t_reply = time.perf_counter()
        doc = {"id": batch.id, "status": OK, "answers": batch.slots}
        if self.epoch is not None:
            try:
                ep = int(self.epoch())
            except Exception:
                # a broken epoch provider must never cost an answer;
                # the frame just rides without the stamp, counted
                get_registry().counter(
                    "rpc.swallowed", site="epoch_probe").inc()
                ep = 0
            if ep > 0:
                doc["epoch"] = ep
        data = pack_frame(T_RESP, json.dumps(doc).encode("utf-8"))
        with self._lock:
            self._done[batch.id] = data
            while len(self._done) > self.dedupe_cap:
                self._done.popitem(last=False)
            conn = batch.conn
        self._send(conn, data)
        if _trace.on() and batch.ctx is not None:
            # wire reply (serialize + send) and the whole server-side
            # residence of the batch: recv -> last answer on the wire.
            # The residence span is what the attribution table compares
            # against the client's own end-to-end measurement.
            now = time.perf_counter()
            ctx = batch.ctx
            _trace.record_span(
                "rpc.reply", now - t_reply,
                trace_id=ctx.trace_id, parent=ctx.parent_sid,
            )
            _trace.record_span(
                "rpc.server.batch", now - batch.t_recv,
                trace_id=ctx.trace_id, parent=ctx.parent_sid,
                attrs={
                    "n": len(batch.slots),
                    "decode_s": round(batch.decode_s, 6),
                    "admit_s": round(batch.admit_s, 6),
                    "reply_s": round(now - t_reply, 6),
                },
            )

    def _encode_result(self, fut) -> list:
        from concurrent.futures import CancelledError

        from ..resilience.errors import DeadlineExceeded

        try:
            ans = fut.result(0)
        except DeadlineExceeded as e:
            return ["deadline", str(e)[:200]]
        except CancelledError:
            return ["error", "cancelled"]
        except TxnSnapshotExpired as e:
            # typed HONEST expiry on the wire: the client re-raises it
            # per answer — a pinned read whose snapshot is gone fails,
            # it is never quietly handed a fresher answer (already
            # counted txn.snapshot_expired at the raise site)
            return ["txn_expired", str(e)[:200],
                    getattr(e, "kind", "expired")]
        except BaseException as e:
            get_registry().counter("rpc.answer_errors").inc()
            return ["error", repr(e)[:200]]
        return encode_answer(ans, shard=self.shard)

    # ------------------------------------------------------------------ #
    def _respond(self, conn: Wire, qid, status: str,
                 error: Optional[str] = None) -> None:
        doc = {"id": qid, "status": status}
        if error:
            doc["error"] = error
        self._send(conn, pack_frame(
            T_RESP, json.dumps(doc).encode("utf-8")
        ))

    def _send(self, conn: Wire, data: bytes) -> None:
        try:
            conn.send(data)
        except OSError:
            # the connection died under the answer; the response stays
            # in the dedupe cache, so the client's resubmit on its next
            # connection collects it — count the undelivered send
            get_registry().counter(
                "rpc.swallowed", site="answer_send"
            ).inc()

    # ------------------------------------------------------------------ #
    def close(self) -> None:
        if self._closing.is_set():
            return
        self._closing.set()
        if self._listener is not None:
            try:
                self._listener.close()
            except OSError:
                get_registry().counter(
                    "rpc.swallowed", site="listener_close"
                ).inc()
        with self._lock:
            conns = list(self._conns)
            self._conns.clear()
        for c in conns:
            c.close()
        if self._accept_thread is not None:
            self._accept_thread.join(5.0)


# --------------------------------------------------------------------- #
# Heartbeat lease (the shared directory's liveness record)
# --------------------------------------------------------------------- #
HEARTBEAT_NAME = "heartbeat.bin"


class HeartbeatLease:
    """Primary liveness as an atomic CRC-framed record in the shared
    serving directory.

    The primary commits ``{role, pid, port, ts, lease_s}`` every
    ``beat_s`` with the checkpoint commit discipline (the transport's
    CRC-framed atomic put) so a reader NEVER sees a torn record — it
    sees the previous beat or the new one. The standby promotes when
    the newest record's age exceeds its own declared ``lease_s``: a
    dead primary stops beating, a live one cannot lapse (``beat_s``
    defaults to ``lease_s / 5``).

    ``dirpath`` is any store-backed cluster
    :class:`~gelly_streaming_tpu_torch.fabric.Transport` (a bare path keeps
    the historical shared-directory record, byte-identical).
    """

    def __init__(
        self,
        dirpath,
        *,
        lease_s: float = 0.5,
        beat_s: Optional[float] = None,
        role: str = "primary",
        port: Optional[int] = None,
    ):
        from ..fabric import as_transport

        self.dirpath = dirpath
        self.transport = as_transport(dirpath)
        self.lease_s = float(lease_s)
        self.beat_s = float(beat_s) if beat_s is not None \
            else self.lease_s / 5.0
        self.role = role
        self.port = port
        self.path = self.transport.describe(HEARTBEAT_NAME)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def write(self) -> None:
        doc = {
            "role": self.role,
            "pid": os.getpid(),
            "port": self.port,
            "ts": time.time(),
            "lease_s": self.lease_s,
        }
        self.transport.put_framed(
            HEARTBEAT_NAME, json.dumps(doc).encode("utf-8"),
            overwrite=True,
        )

    def start(self) -> "HeartbeatLease":
        self.write()
        self._thread = threading.Thread(
            target=self._beat, name="rpc-heartbeat", daemon=True
        )
        self._thread.start()
        return self

    def _beat(self) -> None:
        while not self._stop.wait(self.beat_s):
            try:
                self.write()
            except OSError:
                # a full/unwritable shared dir: the standby will see
                # the lease lapse and promote — which is the CORRECT
                # outcome for a primary that cannot commit state, so
                # count it and keep trying rather than crash serving
                get_registry().counter(
                    "rpc.swallowed", site="heartbeat_write"
                ).inc()

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(5.0)

    # -- reader side ---------------------------------------------------- #
    @staticmethod
    def read(dirpath) -> Optional[dict]:
        """The newest committed heartbeat record, or None when absent
        or invalid (an invalid record is rejected VISIBLY and treated
        as absent — put atomicity makes it near-impossible, so it is
        evidence of external damage, not a normal state)."""
        from ..fabric import as_transport
        from ..resilience import integrity

        tr = as_transport(dirpath)
        data = tr.get_framed(HEARTBEAT_NAME)
        if data is None:
            return None
        try:
            return json.loads(data)
        except ValueError as e:
            integrity.record_rejection(
                tr.describe(HEARTBEAT_NAME), repr(e)
            )
            return None

    @staticmethod
    def age_s(dirpath) -> Optional[Tuple[float, float]]:
        """(age, declared lease) of the newest heartbeat, or None when
        no valid record exists yet."""
        doc = HeartbeatLease.read(dirpath)
        if doc is None:
            return None
        return max(0.0, time.time() - float(doc["ts"])), \
            float(doc.get("lease_s", 0.5))


# --------------------------------------------------------------------- #
# Replica runtime (the cross-process failover pair's halves)
# --------------------------------------------------------------------- #
class ReplicaServer:
    """One serving replica of a cross-process failover pair.

    ``role="primary"``: owns ingest (a servable + source, exactly like
    ``StreamServer``), mirrors every published snapshot into
    ``dirpath`` and beats the heartbeat lease there, and serves RPC
    queries on ``host:port``.

    ``role="standby"``: follows ``dirpath`` (each mirrored snapshot is
    ingested into its own local store), refuses queries with the
    retryable ``not_primary`` status, and monitors the heartbeat; when
    the lease lapses it :meth:`promote`s — opens its gate, takes over
    the heartbeat, and starts answering from the newest followed
    snapshot. Promotion is one-shot and fully observable
    (``serving.lease_lapse``, ``serving.failover{reason=lease_lapse}``,
    ``serving.promotion_seconds``, a ``serving.promotion`` span).

    A replica constructed with ``role="primary"`` whose serving
    directory already holds a FRESH lease (another replica actively
    beating — the standby a previous incarnation failed over to)
    REJOINS AS STANDBY instead of seizing serving back:
    ``self.rejoined`` is set, ``serving.rejoin_demoted`` counted, and
    the replica behaves exactly like a booted standby — following the
    directory, refusing ``not_primary``, promoting only if the current
    holder's lease lapses. A promoted replica therefore stays promoted
    until IT fails, however many times the old primary restarts.

    Ingest does NOT fail over: the dead primary's stream dies with it,
    and the promoted standby serves the last mirrored snapshot — the
    same keep-serving-from-final-state contract a closed stream has.
    Stream-processing recovery stays with the supervisor/cluster layer.

    ``device`` (the port's addition, default ``"cuda"``) is where a
    standby's followed snapshots live: the mirror holds host numpy, and
    the standby uploads each one to ``device``, so it answers on its card
    like the primary. A standby without a card raises
    ``DeviceUnavailable`` unless built with ``device="cpu"``. A primary
    serves its servable's own tensors and reads ``device`` only if it
    rejoins as standby.

    ``role="split"`` (elastic resharding): the CHILD of a live shard
    split. Follows the PARENT's serving directory exactly like a
    standby, uploading each followed snapshot to ``device`` — but its
    gate is OPEN (it answers immediately from the followed state), it
    never monitors or touches the parent's lease, and it never promotes.
    The parent keeps every key, so the child serving the full followed
    table is oracle-identical on the moved half of the keyspace —
    routers send it only keys whose ``split_side`` bit moved
    (``core.ingest.vertex_owner_epoch``).

    ``reshard={"store": <dir>, "shard": <int>}`` attaches a
    :class:`~gelly_streaming_tpu_torch.serving.reshard.ReshardWatcher`:
    the replica learns the live ownership epoch and stamps it on every
    reply frame (``RpcServer(epoch=...)``), which is how routers hear
    about splits from ordinary traffic. An adopted plan whose parent is
    THIS shard is counted ``reshard.split``; any other adoption is
    ``reshard.adopt``.
    """

    def __init__(
        self,
        servable=None,
        source=None,
        *,
        dirpath: str,
        role: str = "primary",
        host: str = "127.0.0.1",
        port: int = 0,
        lease_s: float = 0.5,
        beat_s: Optional[float] = None,
        mirror_every: int = 1,
        mirror_keep: int = 2,
        poll_s: float = 0.02,
        monitor: bool = True,
        reshard: Optional[dict] = None,
        device="cuda",
        **server_kwargs,
    ):
        if role not in ("primary", "standby", "split"):
            raise ValueError(
                f"role must be primary/standby/split, got {role!r}")
        self.dirpath = dirpath
        self.rejoined = False
        if role == "primary":
            # failed-back primary REJOINS as standby: if another
            # replica HOLDS the lease in this serving directory (the
            # standby this process's predecessor failed over to),
            # seizing serving back would put two primaries on one
            # keyspace. A fresh record alone is not proof of a holder
            # — a fast supervisor restart can boot the SAME replica
            # within its own predecessor's lease window, and
            # self-demoting then would discard ingest forever. So a
            # fresh record is confirmed by watching for a BEAT: only a
            # record whose timestamp advances within the declared
            # lease window has a live writer behind it. Observed beat
            # -> demote (follow the directory, promote only if that
            # holder lapses); no beat / stale record -> a dead
            # predecessor's leftovers, normal primary boot proceeds.
            if self._lease_actively_held(dirpath):
                role = "standby"
                self.rejoined = True
                get_registry().counter("serving.rejoin_demoted").inc()
        self.role = role
        self.lease_s = float(lease_s)
        self.beat_s = beat_s
        self.promoted = False
        self.monitor = monitor and role == "standby"
        self._poll_s = float(poll_s)
        self._stop_follow = threading.Event()
        self._mon_stop = threading.Event()
        self._mon_thread: Optional[threading.Thread] = None
        self._plock = threading.Lock()
        self._closed = False
        self.lease: Optional[HeartbeatLease] = None
        self._reshard_cfg = reshard
        self._reshard = None  # ReshardWatcher, created in start()
        self._reshard_seen = 0  # adopted-plan prefix already counted
        self.shard = None if reshard is None else reshard.get("shard")
        if role == "primary":
            if servable is None:
                raise ValueError("a primary replica needs a servable")
            self.store = SnapshotStore()
            self.mirror = SnapshotMirror(
                dirpath, keep=mirror_keep, every=mirror_every
            )
            self.store.add_listener(self.mirror)
            self.server = StreamServer(
                servable, source, store=self.store, **server_kwargs
            )
        else:
            self.mirror = None
            # carry_version: the follower mirrors the PRIMARY's version
            # sequence and boot lineage into this store, so a standby's
            # ring holds the same (version, boot) addresses a client's
            # transaction pinned — promotion preserves pins
            follower = follow_snapshots(
                dirpath, self._stop_follow, poll_s=self._poll_s,
                carry_version=True, device=device,
            )
            self.server = StreamServer(follower, None, **server_kwargs)
            self.store = self.server.store
        self.rpc = RpcServer(
            self.server, host=host, port=port, gate=self._gate,
            epoch=self._epoch, shard=self.shard,
        )

    # ------------------------------------------------------------------ #
    @staticmethod
    def _lease_actively_held(dirpath: str) -> bool:
        """True when a LIVE replica is beating the directory's lease:
        the newest record is fresh AND its timestamp advances within
        one declared lease window (beats land every ``lease_s / 5``).
        Blocks at most one lease window — paid only on the rare boot
        into a directory with a fresh record."""
        got = HeartbeatLease.age_s(dirpath)
        if got is None or got[0] > got[1]:
            return False  # no record, or already lapsed: no holder
        first = HeartbeatLease.read(dirpath)
        if first is None:
            return False
        deadline = time.monotonic() + float(got[1])
        while time.monotonic() < deadline:
            time.sleep(min(0.02, got[1] / 10))
            rec = HeartbeatLease.read(dirpath)
            if rec is not None and rec.get("ts") != first.get("ts"):
                return True  # the writer beat: genuinely held
        return False  # fresh but silent: a dead predecessor's record

    def _gate(self) -> Optional[str]:
        # a split child answers from boot — its traffic is routed by
        # ownership epoch, not by lease, so there is nothing to refuse
        return None if self.role in ("primary", "split") else NOT_PRIMARY

    def _epoch(self) -> int:
        """Current ownership epoch for reply-frame stamping (0 before
        any split is actionable, or with no reshard store attached)."""
        w = self._reshard
        return 0 if w is None else w.epoch()

    def _on_reshard(self, plans: list) -> None:
        """Watcher callback: count each NEWLY adopted plan — a split
        of this shard's own keyspace (``reshard.split``) reads
        differently in the storm timeline than a peer's split this
        replica merely adopts (``reshard.adopt``)."""
        reg = get_registry()
        for p in plans[self._reshard_seen:]:
            if self.shard is not None and p["parent"] == self.shard:
                reg.counter(
                    "reshard.split", epoch=str(p["epoch"]),
                    parent=str(p["parent"]), child=str(p["child"]),
                ).inc()
            else:
                reg.counter(
                    "reshard.adopt", epoch=str(p["epoch"]),
                    site="replica",
                ).inc()
        self._reshard_seen = len(plans)

    def start(self) -> "ReplicaServer":
        if self._reshard_cfg is not None:
            from .reshard import ReshardWatcher

            self._reshard = ReshardWatcher(
                self._reshard_cfg["store"],
                poll_s=float(self._reshard_cfg.get("poll_s", 0.1)),
                on_adopt=self._on_reshard,
            )
        self.server.start()
        self.rpc.start()
        if self.role == "primary":
            # the lease's first commit is shared-directory file I/O:
            # it happens OUTSIDE _plock so a slow shared mount
            # never stalls close()/promote() callers queued on the lock
            self._install_lease(HeartbeatLease(
                self.dirpath, lease_s=self.lease_s,
                beat_s=self.beat_s, port=self.rpc.port,
            ).start())
            # the mirror stride may skip trailing windows; when ingest
            # ENDS the newest snapshot is the final state and must be
            # on the shared dir for any later failover to serve it
            threading.Thread(
                target=self._flush_on_ingest_end,
                name="rpc-mirror-flush", daemon=True,
            ).start()
        elif self.monitor:
            self._mon_thread = threading.Thread(
                target=self._monitor, name="rpc-lease-monitor",
                daemon=True,
            )
            self._mon_thread.start()
        return self

    def __enter__(self) -> "ReplicaServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    def _flush_on_ingest_end(self) -> None:
        self.server._ingest_done.wait()
        if not self._closed:
            try:
                self.mirror.flush(self.store)
            except OSError:
                # same posture as the heartbeat writer: an unwritable
                # shared dir surfaces as a lease lapse, not a crash
                get_registry().counter(
                    "rpc.swallowed", site="mirror_flush"
                ).inc()

    def _monitor(self) -> None:
        """Watch the primary's lease; a lapse promotes this standby.
        Promotion needs EVIDENCE the primary existed: before the first
        valid heartbeat there is nothing to lapse (a standby booted
        ahead of its primary waits, it does not seize)."""
        poll = min(self._poll_s, self.lease_s / 4)
        while not self._mon_stop.wait(poll):
            if self.promoted or self._closed:
                return
            got = HeartbeatLease.age_s(self.dirpath)
            if got is None:
                continue
            age, lease = got
            if age > lease:
                get_registry().counter("serving.lease_lapse").inc()
                self.promote(
                    reason="lease_lapse",
                    _t0=time.perf_counter(),
                )
                return

    # ------------------------------------------------------------------ #
    def _install_lease(self, lease: "HeartbeatLease") -> None:
        """Publish an already-started lease under the promotion lock.
        The lease's file I/O stays OUTSIDE ``_plock``; only the
        reference swap is locked. A close() that raced the commit wins:
        the fresh lease is released instead of leaking its beat
        thread."""
        with self._plock:
            if not self._closed:
                self.lease = lease
                return
        lease.close()

    def promote(self, reason: str = "manual",
                _t0: Optional[float] = None) -> None:
        """Take over serving: open the query gate, own the heartbeat.
        One-shot; later calls are no-ops. ``serving.promotion_seconds``
        measures lapse-detection (or call) to heartbeat-takeover — the
        latency a client's retry actually waits out on top of its
        reconnect."""
        t0 = time.perf_counter() if _t0 is None else _t0
        reg = get_registry()
        with _trace.span(
            "serving.promotion",
            {"reason": reason} if _trace.on() else None,
        ):
            with self._plock:
                if self.promoted or self._closed:
                    return
                reg.counter("serving.failover", reason=reason).inc()
                self.role = "primary"  # the gate reads this: queries flow
                self.promoted = True
                # pinned reads this promoted standby cannot satisfy
                # from its mirrored ring are failover expiries from
                # here on (txn.failover_expired) — counted differently
                # because they tell the lost-trailing-state story
                self.server.txn_failover = True
            # the heartbeat takeover is shared-directory file I/O:
            # committed outside _plock so health probes and
            # close() never queue behind a disk write
            self._install_lease(HeartbeatLease(
                self.dirpath, lease_s=self.lease_s,
                beat_s=self.beat_s, port=self.rpc.port,
            ).start())
            reg.histogram("serving.promotion_seconds").observe(
                time.perf_counter() - t0
            )

    # ------------------------------------------------------------------ #
    # Query surface (local, for tests/symmetry; the wire is the point)
    # ------------------------------------------------------------------ #
    def submit(self, query: Query, **kw):
        return self.server.submit(query, **kw)

    def ask(self, query: Query, timeout: Optional[float] = None,
            deadline_s: Optional[float] = None) -> Answer:
        return self.server.ask(query, timeout, deadline_s=deadline_s)

    def heartbeat_age_s(self) -> Optional[float]:
        """Age of the newest heartbeat record in the shared directory —
        what an external probe reads to tell a wedged primary (stale
        beat) from a healthy standby (fresh beat, standby role)."""
        got = HeartbeatLease.age_s(self.dirpath)
        return None if got is None else round(got[0], 4)

    def health(self) -> dict:
        doc = {
            "role": self.role,
            "promoted": bool(self.promoted),
            "rejoined": bool(self.rejoined),
            "worker_alive": bool(self.server.worker_alive()),
            "pending": len(self.server._pending),
            "heartbeat_age_s": self.heartbeat_age_s(),
            "rpc_port": self.rpc.port,
            "epoch": self._epoch(),
            # the transaction probe surface: how deep the
            # pinned-readable ring is, the OLDEST version a pin can
            # still be answered at, and how many transactions touched
            # this replica within the tracker TTL
            "txn": {
                "retention": self.store.retention,
                "ring_depth": self.store.ring_depth(),
                "oldest_pinned": self.store.oldest_retained(),
                "active": active_txn_count(),
            },
        }
        rec = HeartbeatLease.read(self.dirpath)
        if rec is not None:
            # who holds the lease RIGHT NOW — the record's role/pid/
            # port exist for exactly this probe surface (every
            # key the writer commits has a reader), and it is how an
            # external check tells "this standby is healthy because a
            # live primary beats" from "nobody is beating"
            doc["lease"] = {
                "role": rec.get("role"),
                "pid": rec.get("pid"),
                "port": rec.get("port"),
            }
        doc["ok"] = doc["worker_alive"]
        return doc

    def metrics_endpoint(self, **kw):
        """Scrape endpoint for this replica: ``/healthz`` reports role,
        promotion state, and heartbeat age next to worker liveness."""
        from ..obs.endpoint import MetricsEndpoint

        return MetricsEndpoint(health=self.health, **kw).start()

    # ------------------------------------------------------------------ #
    def close(self, timeout: float = 30.0) -> None:
        with self._plock:
            if self._closed:
                return
            self._closed = True
        # one budget for the whole close: the monitor join and
        # the server drain spend what REMAINS of `timeout`, not a
        # fresh copy each
        deadline = time.monotonic() + float(timeout)
        self._mon_stop.set()
        if self._reshard is not None:
            self._reshard.close(max(0.0, deadline - time.monotonic()))
        if self._mon_thread is not None:
            self._mon_thread.join(
                max(0.0, deadline - time.monotonic()))
        if self.lease is not None:
            self.lease.close()
        self.rpc.close()
        self._stop_follow.set()
        self.server.close(max(0.0, deadline - time.monotonic()))
        if self.mirror is not None:
            try:
                self.mirror.flush(self.store)
            except OSError:
                get_registry().counter(
                    "rpc.swallowed", site="mirror_flush"
                ).inc()


# --------------------------------------------------------------------- #
# The serving binary (subprocess entry) + CI smoke
# --------------------------------------------------------------------- #
#: exit code for an injected kill (matches resilience/chaos.py KILL_RC)
KILL_RC = 17

#: repo root for subprocess sys.path injection (same derivation as
#: resilience/chaos.py — replicas must import this package regardless
#: of the launching process's cwd)
REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)


def demo_payloads(windows: int = 200, vcap: int = 64,
                  pace_s: float = 0.005, device="cuda"):
    """The replica binary's demo servable: per window, a CC label table
    whose zero-rooted chain grows by one vertex — cheap, deterministic,
    and every window's answers differ, so staleness is testable. The
    table is a tensor on ``device`` (each window's is a fresh one, so a
    published snapshot is never written again; ``"cuda"`` raises without
    a card)."""
    import numpy as np
    import torch

    from ..core.device import resolve_device
    from ..datasets import IdentityDict

    device = resolve_device(device)
    vd = IdentityDict(vcap)
    vd.observe(vcap - 1)
    labels = np.arange(vcap, dtype=np.int32)
    for w in range(windows):
        labels = labels.copy()
        labels[: min(vcap, w + 2)] = 0
        yield {"labels": torch.as_tensor(labels, device=device),
               "vdict": vd}, w + 1
        if pace_s:
            time.sleep(pace_s)


def replica_main(cfg: dict) -> None:
    """One serving replica as a real process. ``cfg`` keys: ``dir``,
    ``role``, ``portfile`` (the bound port is committed there
    atomically), optional ``events`` (streaming ShardSink path),
    ``flight`` (flight-recorder dump base), ``kill_at_sweep`` (a
    FaultPlan kill at the first worker sweep at or after it that finds
    a batch pending, the ``serving.worker.busy`` site ->
    ``os._exit(KILL_RC)`` with the black box dumped first; the reference
    kills at that sweep whatever it holds, often with no batch in
    flight), ``windows``/``vcap``/``pace_s`` (primary demo stream),
    ``lease_s``, ``run_s`` (wall-clock cap), ``meta``, ``device``
    (where the replica's tables live and its queries run: default
    ``"cuda"``, each replica making its own CUDA context; raises without
    a card unless ``"cpu"``).

    Also: ``autotune``/``target_wait_s`` (load-aware admission on the
    inner StreamServer), ``pullring`` (persist the delta pull ring next
    to the snapshot mirror), ``adopt_boot`` (republish the newest
    mirrored snapshot under its ORIGINAL version before ingest,
    restoring the pull ring when present — the restarted-shard bridge).

    The routing tier's keys: ``cc_shard`` (the primary serves one shard
    of the partitioned deployment, :func:`~.router.shard_demo_payloads`,
    its tables on ``device``), ``reshard`` (``{"store": dir, "shard":
    k}`` — epoch stamping + adoption), ``role="split"`` + ``split_epoch``
    (boot as a split child of ``dir``'s parent shard, uploading the
    followed snapshots to ``device``, and publish this process's address
    under the split epoch once servable; ``split_boot_timeout_s`` bounds
    that wait)."""
    import signal

    from ..core.device import resolve_device
    from ..obs import flight as obs_flight
    from ..obs import trace as obs_trace
    from ..obs.cluster import ShardSink
    from ..resilience import faults

    device = resolve_device(cfg.get("device", "cuda"))
    role = cfg["role"]
    sink = None
    if cfg.get("events"):
        sink = ShardSink(cfg["events"], shard=cfg.get("shard"))
        get_registry().add_sink(sink)
        obs_trace.add_sink(sink)
        # span events ARE the shipped evidence; the registry mirror
        # (trace.span_seconds) would double every span in the event
        # log for a surface nothing scrapes in a bench replica
        obs_trace.enable(registry_spans=False)
    if cfg.get("flight"):
        obs_flight.install(obs_flight.FlightRecorder(
            cfg["flight"], capacity=128, shard=cfg.get("shard"),
        ))
    kill_at = cfg.get("kill_at_sweep")
    if kill_at is not None:
        faults.install(faults.FaultPlan(
            seed=int(cfg.get("seed", 0)),
            kill_site="serving.worker.busy",
            kill_at_window=int(kill_at),
            kill_at_or_after=True,
            kill_exit_code=KILL_RC,
        ))
    kw = dict(
        lease_s=float(cfg.get("lease_s", 0.5)),
        max_pending=int(cfg.get("max_pending", 1 << 14)),
    )
    if cfg.get("autotune"):
        kw["autotune"] = True
        if cfg.get("target_wait_s") is not None:
            kw["target_wait_s"] = float(cfg["target_wait_s"])
    if cfg.get("reshard"):
        kw["reshard"] = cfg["reshard"]
    if role == "primary":
        if cfg.get("cc_shard"):
            # one SHARD of the partitioned serving deployment: real CC
            # forest + degree folds over the edges this shard owns
            # (serving/router.py — the sharded scenarios' replica shape)
            from .router import shard_demo_payloads

            servable = shard_demo_payloads(**cfg["cc_shard"], device=device)
        else:
            servable = demo_payloads(
                windows=int(cfg.get("windows", 200)),
                vcap=int(cfg.get("vcap", 64)),
                pace_s=float(cfg.get("pace_s", 0.005)),
                device=device,
            )
        rep = ReplicaServer(
            servable, None, dirpath=cfg["dir"], role="primary", **kw
        )
        if cfg.get("pullring"):
            from .query import PullRingMirror

            rep.store.add_listener(PullRingMirror(
                rep.server.engine, cfg["dir"],
                every=int(cfg.get("pullring_every", 1)),
            ))
        if cfg.get("adopt_boot") and not rep.rejoined:
            # restart adoption: republish the newest mirrored snapshot
            # under its ORIGINAL version so delta baselines (and the
            # persisted pull ring) survive the restart; a missing
            # mirror just means a cold boot
            from .snapshot_store import _to_device, load_newest_snapshot

            doc = load_newest_snapshot(cfg["dir"])
            if doc is not None:
                # boot lineage rides the mirror: a restart-adopted
                # snapshot keeps its ORIGINAL (version, boot) address,
                # so an exact-version pin on it stays satisfiable (the
                # content is identical); absent boot = old mirror =
                # fresh lineage, pins reset honestly
                rep.server.publish_boot(
                    _to_device(doc["payload"], device),
                    int(doc["watermark"]),
                    version=int(doc["version"]),
                    boot=doc.get("boot"),
                )
                if cfg.get("pullring"):
                    from .query import load_pull_ring

                    rep.server.engine.restore_chain(
                        load_pull_ring(cfg["dir"]),
                        rep.store.epoch, int(doc["version"]),
                    )
    else:
        rep = ReplicaServer(dirpath=cfg["dir"], role=role, device=device,
                            **kw)
    rep.start()
    if role == "split" and cfg.get("reshard"):
        # the child address is published ONLY once servable (first
        # followed snapshot answered) — the actionable-prefix rule in
        # serving/reshard.py is what keeps routers from adopting an
        # epoch whose child would refuse traffic
        from .reshard import publish_addr

        rep.store.wait_for(
            min_version=1,
            timeout=float(cfg.get("split_boot_timeout_s", 60.0)),
        )
        publish_addr(
            cfg["reshard"]["store"], int(cfg["split_epoch"]),
            f"127.0.0.1:{rep.rpc.port}",
        )
    if cfg.get("portfile"):
        from ..resilience import integrity

        tmp = cfg["portfile"] + ".tmp"
        with open(tmp, "w") as f:
            f.write(str(rep.rpc.port))
        integrity.replace_atomic(tmp, cfg["portfile"])
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    deadline = time.monotonic() + float(cfg.get("run_s", 600.0))
    while not stop.is_set() and time.monotonic() < deadline:
        stop.wait(0.05)
    meta = {
        "role": rep.role,
        "promoted": rep.promoted,
        "port": rep.rpc.port,
        "device": str(device),
    }
    adm = getattr(rep.server, "admission", None)
    if cfg.get("autotune") and adm is not None:
        # the admission tuner's full trajectory: every knob move plus
        # the final watermark — the committed shed-trajectory evidence
        meta["autotune"] = {
            "knob": adm.knob,
            "ceiling": adm.ceiling,
            "max_pending": adm.max_pending,
            "shed_watermark": round(adm.shed_watermark, 4),
            "history": [list(h) for h in adm.history],
        }
    rep.close()
    if cfg.get("meta"):
        with open(cfg["meta"], "w") as f:
            json.dump(meta, f)
    if sink is not None:
        sink.close()
        get_registry().remove_sink(sink)
    faults.clear()


def _replica_code() -> str:
    return (
        "import sys, json; "
        f"sys.path.insert(0, {REPO_ROOT!r}); "
        "from gelly_streaming_tpu_torch.serving import rpc; "
        "rpc.replica_main(json.loads(sys.argv[1]))"
    )


def spawn_replica(cfg: dict):
    """Launch one replica binary detached (stdout/stderr to a log file
    next to its portfile — a killed replica must never deadlock the
    launcher on a full pipe). Returns the Popen, with ``log_path`` set."""
    import subprocess
    import sys as _sys

    os.makedirs(cfg["dir"], exist_ok=True)
    log_path = os.path.join(
        cfg["dir"], f"replica.{cfg['role']}.log"
    )
    logf = open(log_path, "wb")
    try:
        p = subprocess.Popen(
            [_sys.executable, "-c", _replica_code(), json.dumps(cfg)],
            stdout=logf, stderr=subprocess.STDOUT,
        )
    finally:
        logf.close()  # the child holds its own dup of the fd
    p.log_path = log_path
    return p


def wait_portfile(path: str, timeout_s: float = 90.0) -> int:
    """Poll a replica's committed portfile; the bound port, or raises."""
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        try:
            with open(path) as f:
                text = f.read().strip()
            if text:
                return int(text)
        except (OSError, ValueError):
            pass
        time.sleep(0.02)
    raise TimeoutError(f"no replica port committed at {path}")


def smoke(verbose: bool = True, device: str = "cuda") -> bool:
    """CI gate: a primary + standby replica pair as REAL subprocesses
    (their tables on ``device``), one client batch round-tripped over
    real sockets, the primary SIGKILLed, and the client's retry asserted
    to land on the promoted standby. Returns True on success."""
    import shutil
    import tempfile

    from .client import RpcClient

    say = print if verbose else (lambda *a, **k: None)
    root = tempfile.mkdtemp(prefix="rpc_smoke_")
    primary = standby = None
    client = None
    ok = False
    try:
        shared = os.path.join(root, "shared")
        os.makedirs(shared, exist_ok=True)
        base = dict(
            dir=shared, lease_s=0.4, windows=2000, pace_s=0.01,
            vcap=64, run_s=300.0, device=device,
        )
        primary = spawn_replica(dict(
            base, role="primary",
            portfile=os.path.join(root, "primary.port"),
            events=os.path.join(root, "events.primary.jsonl"),
        ))
        standby = spawn_replica(dict(
            base, role="standby",
            portfile=os.path.join(root, "standby.port"),
            events=os.path.join(root, "events.standby.jsonl"),
        ))
        p_port = wait_portfile(os.path.join(root, "primary.port"))
        s_port = wait_portfile(os.path.join(root, "standby.port"))
        say(f"rpc-smoke: primary :{p_port}, standby :{s_port}")
        client = RpcClient(
            [f"127.0.0.1:{p_port}", f"127.0.0.1:{s_port}"],
        )
        answers = client.ask_batch(
            [ConnectedQuery(0, 1), ComponentSizeQuery(0)],
            deadline_s=60.0, timeout=60.0,
        )
        if answers[0].value is not True or int(answers[1].value) < 2:
            say(f"RPC SMOKE FAIL: pre-kill answers wrong: "
                f"{[a.value for a in answers]}")
            return False
        say(f"rpc-smoke: pre-kill batch ok "
            f"(connected={answers[0].value}, "
            f"size={answers[1].value}, window={answers[0].window})")
        primary.kill()
        primary.wait(30)
        t0 = time.perf_counter()
        answers = client.ask_batch(
            [ConnectedQuery(0, 1)], deadline_s=60.0, timeout=60.0,
        )
        blip = time.perf_counter() - t0
        if answers[0].value is not True:
            say("RPC SMOKE FAIL: post-kill answer wrong")
            return False
        events_path = os.path.join(root, "events.standby.jsonl")
        promoted = False
        with open(events_path) as f:
            for line in f:
                if '"serving.failover"' in line and "lease_lapse" in line:
                    promoted = True
                    break
        if not promoted:
            say("RPC SMOKE FAIL: standby never recorded the "
                "lease-lapse promotion")
            return False
        say(f"RPC SMOKE OK: primary killed, standby promoted on lease "
            f"lapse, client retry answered in {blip:.2f}s")
        ok = True
        return True
    finally:
        if client is not None:
            client.close()
        for p in (primary, standby):
            if p is not None and p.poll() is None:
                p.terminate()
                try:
                    p.wait(15)
                except Exception:
                    get_registry().counter(
                        "rpc.swallowed", site="smoke_teardown"
                    ).inc()
                    p.kill()
        if not ok and verbose and standby is not None:
            try:
                with open(standby.log_path, "rb") as f:
                    print("standby log tail:",
                          f.read()[-2000:].decode(errors="replace"))
            except OSError:
                pass
        shutil.rmtree(root, ignore_errors=True)


if __name__ == "__main__":
    import sys

    if "--smoke" in sys.argv:
        sys.exit(0 if smoke(
            device="cpu" if "--cpu" in sys.argv else "cuda") else 1)
    if "--replica" in sys.argv:
        replica_main(json.loads(
            sys.argv[sys.argv.index("--replica") + 1]
        ))
        sys.exit(0)
    print(
        "usage: python -m gelly_streaming_tpu_torch.serving.rpc "
        "--smoke [--cpu] | --replica '<json cfg>'",
        file=sys.stderr,
    )
    sys.exit(2)
