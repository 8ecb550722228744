"""Socket-backed transport: GSRP frames against a tiny exchange daemon
(the port's copy of ``gelly_streaming_tpu/fabric/exchange.py``; a JAX
package client and a port client speak to either package's daemon).

The shared-dir backend assumes every participant mounts one filesystem;
standbys and shards on separate machines need the same tag-store
contract over TCP. This module provides it in the repo's stdlib-only
stance: :class:`ExchangeDaemon` is an in-memory tag store behind a
listening socket (thread per connection, one lock around the dict —
the store IS the serialization point, exactly like the directory was),
and :class:`SocketTransport` is the client, speaking length-prefixed
GSRP frames (:mod:`~gelly_streaming_tpu_torch.fabric.wire` — one frame
grammar, one fuzz discipline) with the serving client's
bounded-reconnect behavior.

Deployment shape: the daemon runs on the coordinator (or any stable
host) and OWNS the exchange state, so tags survive worker kills and
restarts — the replay-safety the coordinated layer needs — but not a
daemon death. Durable restore state (epoch barriers, rendezvous
records) therefore stays on a persistent store; the daemon carries the
in-flight exchange/election traffic. ``put(overwrite=False)`` is
one-winner by construction: the daemon applies ops under its lock, so
exactly one concurrent put observes the tag absent.

Every wire fault is counted evidence (``fabric.malformed{kind=...}``,
``fabric.reconnects``) — the same contract the RPC fuzz tests pin for
``rpc.malformed``: no broad handler on the socket path may swallow
uncounted.
"""

from __future__ import annotations

import json
import socket as _socket
import struct
import threading
import time
from typing import List, NamedTuple, Optional, Tuple

from ..obs.registry import get_registry
from ..resilience.errors import TransientSourceError
from .base import TagStat, Transport
from .wire import (
    DEFAULT_MAX_FRAME,
    Disconnect,
    MalformedFrame,
    T_XREQ,
    T_XRESP,
    pack_frame,
    read_frame,
)

#: ops the exchange protocol speaks (one tag-store call each)
OPS = ("put", "get", "stat", "list", "delete", "ping")

_HEAD_LEN = struct.Struct("<I")


def _split_doc(payload: bytes, *, what: str) -> Tuple[dict, bytes]:
    """``json-length | json | body`` — the XREQ/XRESP payload shape."""
    if len(payload) < _HEAD_LEN.size:
        raise MalformedFrame(
            "truncated", f"{what} payload of {len(payload)} bytes has "
            f"no header")
    (n,) = _HEAD_LEN.unpack(payload[:_HEAD_LEN.size])
    head_end = _HEAD_LEN.size + n
    if len(payload) < head_end:
        raise MalformedFrame(
            "truncated",
            f"{what} header promises {n} json bytes, "
            f"{len(payload) - _HEAD_LEN.size} present")
    try:
        doc = json.loads(payload[_HEAD_LEN.size:head_end])
    except ValueError as e:
        raise MalformedFrame("json", f"{what} header: {e}") from e
    if not isinstance(doc, dict):
        raise MalformedFrame("json", f"{what} header is not an object")
    return doc, payload[head_end:]


def pack_request(op: str, tag: str = "", *, overwrite: bool = False,
                 prefix: str = "", body: bytes = b"") -> bytes:
    """One tag-store op as an XREQ payload."""
    doc = {"op": op, "tag": tag, "overwrite": bool(overwrite),
           "prefix": prefix}
    head = json.dumps(doc, separators=(",", ":")).encode("utf-8")
    return _HEAD_LEN.pack(len(head)) + head + body


def unpack_request(payload: bytes
                   ) -> Tuple[str, str, bool, str, bytes]:
    """Decode an XREQ payload -> ``(op, tag, overwrite, prefix, body)``;
    an unknown op is a :class:`MalformedFrame` (``request``)."""
    doc, body = _split_doc(payload, what="request")
    op = doc.get("op")
    if op not in OPS:
        raise MalformedFrame("request", f"unknown op {op!r}")
    return (op, str(doc.get("tag", "")),
            bool(doc.get("overwrite", False)),
            str(doc.get("prefix", "")), body)


class ExchangeResponse(NamedTuple):
    ok: bool
    created: bool
    found: bool
    size: int
    version: int
    tags: List[str]
    err: str
    body: bytes


def pack_response(*, ok: bool = True, created: bool = False,
                  found: bool = False, size: int = 0, version: int = 0,
                  tags: Tuple[str, ...] = (), err: str = "",
                  body: bytes = b"") -> bytes:
    """One op outcome as an XRESP payload."""
    doc = {"ok": bool(ok), "created": bool(created),
           "found": bool(found), "size": int(size),
           "version": int(version), "tags": list(tags), "err": err}
    head = json.dumps(doc, separators=(",", ":")).encode("utf-8")
    return _HEAD_LEN.pack(len(head)) + head + body


def unpack_response(payload: bytes) -> ExchangeResponse:
    """Decode an XRESP payload into :class:`ExchangeResponse`."""
    doc, body = _split_doc(payload, what="response")
    return ExchangeResponse(
        ok=bool(doc.get("ok", False)),
        created=bool(doc.get("created", False)),
        found=bool(doc.get("found", False)),
        size=int(doc.get("size", 0)),
        version=int(doc.get("version", 0)),
        tags=[str(t) for t in (doc.get("tags") or [])],
        err=str(doc.get("err", "")),
        body=body,
    )


class ExchangeDaemon:
    """The in-memory tag store behind a socket; see the module
    docstring. Start with :meth:`start`, address at ``(host, port)``;
    runs until :meth:`stop`."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0, *,
                 max_frame: int = DEFAULT_MAX_FRAME):
        self._store = {}  # tag -> (payload bytes, version int)
        self._next_version = 1
        self._lock = threading.Lock()
        self._max_frame = int(max_frame)
        self._stop = threading.Event()
        self._listener = _socket.socket(_socket.AF_INET,
                                        _socket.SOCK_STREAM)
        self._listener.setsockopt(_socket.SOL_SOCKET,
                                  _socket.SO_REUSEADDR, 1)
        self._listener.bind((host, int(port)))
        self._listener.listen(64)
        self.host, self.port = self._listener.getsockname()[:2]
        self._accept_thread: Optional[threading.Thread] = None

    @property
    def address(self) -> str:
        return f"{self.host}:{self.port}"

    def start(self) -> "ExchangeDaemon":
        t = threading.Thread(target=self._accept_loop,
                             name="fabric-exchange-accept", daemon=True)
        t.start()
        self._accept_thread = t
        return self

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _addr = self._listener.accept()
            except OSError:
                # listener closed by stop(): the loop's normal exit;
                # anything else also ends accept — count it either way
                # so an unexpected listener death is not silent
                get_registry().counter(
                    "fabric.swallowed", site="daemon_accept").inc()
                return
            self._spawn_conn(conn)

    def _spawn_conn(self, conn) -> None:
        """Hand ``conn``'s ownership to its serve thread (which closes
        it on every exit path)."""
        threading.Thread(
            target=self._serve, args=(conn,),
            name="fabric-exchange-conn", daemon=True,
        ).start()

    def _serve(self, conn) -> None:
        try:
            conn.setsockopt(_socket.IPPROTO_TCP, _socket.TCP_NODELAY, 1)
            while not self._stop.is_set():
                try:
                    ftype, payload = read_frame(
                        conn, max_frame=self._max_frame)
                    if ftype != T_XREQ:
                        raise MalformedFrame(
                            "type", f"unexpected frame type {ftype}")
                    resp = self._handle(payload)
                except Disconnect:
                    return
                except MalformedFrame as e:
                    get_registry().counter(
                        "fabric.malformed", kind=e.kind).inc()
                    return
                try:
                    conn.sendall(pack_frame(T_XRESP, resp))
                except OSError:
                    get_registry().counter(
                        "fabric.swallowed", site="daemon_send").inc()
                    return
        except Exception:
            # a handler-thread death must leave evidence: count, then
            # let the thread end
            get_registry().counter(
                "fabric.swallowed", site="daemon_conn").inc()
        finally:
            try:
                conn.close()
            except OSError:
                get_registry().counter(
                    "fabric.swallowed", site="daemon_close").inc()

    def _handle(self, payload: bytes) -> bytes:
        op, tag, overwrite, prefix, body = unpack_request(payload)
        with self._lock:
            if op == "put":
                if overwrite or tag not in self._store:
                    self._store[tag] = (body, self._next_version)
                    self._next_version += 1
                    return pack_response(created=True)
                return pack_response(created=False)
            if op == "get":
                hit = self._store.get(tag)
                if hit is None:
                    return pack_response(found=False)
                return pack_response(found=True, size=len(hit[0]),
                                     version=hit[1], body=hit[0])
            if op == "stat":
                hit = self._store.get(tag)
                if hit is None:
                    return pack_response(found=False)
                return pack_response(found=True, size=len(hit[0]),
                                     version=hit[1])
            if op == "list":
                tags = tuple(sorted(
                    t for t in self._store if t.startswith(prefix)))
                return pack_response(found=True, tags=tags)
            if op == "delete":
                return pack_response(
                    found=self._store.pop(tag, None) is not None)
            return pack_response(found=True)  # ping

    def stop(self) -> None:
        self._stop.set()
        try:
            # shutdown wakes an accept() blocked on the listener (a bare
            # close leaves the accept thread waiting out its join timeout)
            self._listener.shutdown(_socket.SHUT_RDWR)
        except OSError:
            pass  # not listening any more: close below is all there is
        try:
            self._listener.close()
        except OSError:
            get_registry().counter(
                "fabric.swallowed", site="daemon_stop").inc()
        if self._accept_thread is not None:
            self._accept_thread.join(timeout=5.0)


class SocketTransport(Transport):
    """Tag store over one exchange daemon; see the module docstring.

    ``persistent`` is True in the sense the coordinated layer needs —
    tags survive WORKER kills and restarts (the daemon owns them) —
    but not a daemon death; durable restore state belongs on a
    shared-dir store.
    """

    backend = "socket"
    persistent = True

    #: reconnect attempts per request before the fault is the caller's
    MAX_ATTEMPTS = 5
    #: backoff start/cap between reconnect attempts
    BACKOFF_S = (0.02, 0.5)

    def __init__(self, address, process_id: int = 0,
                 num_processes: int = 1, *, timeout_s: float = 60.0,
                 poll_s: float = 0.002,
                 max_frame: int = DEFAULT_MAX_FRAME):
        if isinstance(address, str):
            host, _, port = address.rpartition(":")
            address = (host or "127.0.0.1", int(port))
        self.address = (str(address[0]), int(address[1]))
        self.process_id = int(process_id)
        self.num_processes = int(num_processes)
        self.timeout_s = float(timeout_s)
        self.poll_s = float(poll_s)
        self._max_frame = int(max_frame)
        self._sock = None
        self._lock = threading.Lock()

    # ---------------------------------------------------------------- #
    def _connected(self):
        if self._sock is None:
            s = _socket.create_connection(self.address, timeout=30.0)
            try:
                s.setsockopt(_socket.IPPROTO_TCP,
                             _socket.TCP_NODELAY, 1)
            except OSError:
                # a daemon that reset immediately: drop THIS socket,
                # let the reconnect loop classify the failure
                s.close()
                raise
            self._sock = s
        return self._sock

    def _drop(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                get_registry().counter(
                    "fabric.swallowed", site="client_close").inc()
            self._sock = None

    def _request(self, req: bytes) -> ExchangeResponse:
        """One round-trip, with the serving client's bounded-reconnect
        discipline: a dropped/garbled connection is counted
        (``fabric.reconnects`` / ``fabric.malformed{kind}``), backed
        off, and retried a bounded number of times before the fault
        escalates as transient."""
        frame = pack_frame(T_XREQ, req)
        backoff, cap = self.BACKOFF_S
        last = "unreachable"
        for attempt in range(self.MAX_ATTEMPTS):
            with self._lock:
                try:
                    # the lock serializes whole round-trips on the one
                    # socket: connect, send, and the response read
                    sock = self._connected()
                    sock.sendall(frame)
                    ftype, payload = read_frame(
                        sock, max_frame=self._max_frame)
                    if ftype != T_XRESP:
                        raise MalformedFrame(
                            "type", f"unexpected frame type {ftype}")
                    return unpack_response(payload)
                except MalformedFrame as e:
                    get_registry().counter(
                        "fabric.malformed", kind=e.kind).inc()
                    last = f"malformed:{e.kind}"
                    self._drop()
                except (OSError, Disconnect) as e:
                    get_registry().counter("fabric.reconnects").inc()
                    last = repr(e)
                    self._drop()
            if attempt + 1 < self.MAX_ATTEMPTS:
                time.sleep(backoff)
                backoff = min(cap, backoff * 2)
        raise TransientSourceError(
            f"exchange daemon {self.address[0]}:{self.address[1]} "
            f"unreachable after {self.MAX_ATTEMPTS} attempts ({last})"
        )

    # ---------------------------------------------------------------- #
    # The byte layer
    # ---------------------------------------------------------------- #
    def put(self, tag: str, payload: bytes, *,
            overwrite: bool = False) -> bool:
        resp = self._request(pack_request(
            "put", tag, overwrite=overwrite, body=payload))
        return resp.created

    def _get_once(self, tag: str) -> Optional[bytes]:
        resp = self._request(pack_request("get", tag))
        return resp.body if resp.found else None

    def stat(self, tag: str) -> Optional[TagStat]:
        resp = self._request(pack_request("stat", tag))
        if not resp.found:
            return None
        return TagStat(size=resp.size, version=resp.version)

    def list(self, prefix: str = "") -> List[str]:
        return self._request(pack_request("list", prefix=prefix)).tags

    def delete(self, tag: str) -> bool:
        return self._request(pack_request("delete", tag)).found

    def close(self) -> None:
        with self._lock:
            self._drop()
