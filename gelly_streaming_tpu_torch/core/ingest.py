"""Sharded parallel ingest: the million-writes path (the port's copy of
``gelly_streaming_tpu/core/ingest.py``).

Every other source enters through ONE Python reader. This module is the
keyed-shuffle ingest of the reference, kept on the host (numpy and
sockets; nothing here touches the card):

- :class:`ShardedEdgeSource` — N concurrent TCP connections, one per
  shard, records partitioned by **edge-endpoint hash** (:func:`shard_of`,
  the one partition rule the producer, the readers and the oracle tests
  share). Each shard's reader thread decodes, assembles **per-shard count
  windows** and hands closed windows over a bounded queue; the merge side
  yields them in arrival order.
- **GSEW binary wire format** — length-prefixed frames carrying raw
  little-endian i32/i64 edge columns, decoded into numpy columns by ONE
  native call per frame (``native.decode_edge_frame``; numpy fallback
  only where the library cannot be built). Frames carry a per-connection
  sequence number, so a reconnecting peer can replay from any earlier
  point (**at-least-once**) and the reader dedupes to exactly-once at
  frame granularity. GSEW v2 adds an optional i64 event-time column. The
  frames are byte-identical to the JAX package's, so either package's
  peer feeds the other's source.
- **Explicit backpressure** — each shard queue is BOUNDED
  (:func:`~gelly_streaming_tpu_torch.core.pipeline.bounded_put`): a slow
  consumer blocks the reader's put, which stops ``recv``, which lets TCP
  flow control push back on the producer. Evidence:
  ``source.shard_depth{shard}`` gauge, ``source.backpressure_s`` counter,
  ``source.backpressure_stalls/resumes{shard}`` episode counters (the
  timeline's INGEST-STALL / INGEST-RESUME story lines).
- :class:`ShardedEdgeStream` — merges closed shard windows into the
  block/superbatch execution path on the stream's device: per-window
  blocks through the shared
  :class:`~gelly_streaming_tpu_torch.core.window.Windower` (each keeps its
  host columns, so streaming CC picks the forest carry on a card), and
  ``superbatches(k)`` packs K closed windows with ONE group encode and no
  per-window device work
  (:meth:`~gelly_streaming_tpu_torch.core.window.Windower.pack_window_cols`).
  Reader threads do host numpy only; the upload happens on the consumer's
  thread.

RESILIENCE (the ``SocketEdgeSource`` contract): connection errors
reconnect with bounded exponential backoff (``reconnect`` attempts,
``source.reconnects`` counted); a malformed byte stream — bad
magic/version, oversized or geometry-inconsistent length, torn frames — is
a counted ``source.malformed_frames{kind}`` plus a clean reconnect, never a
dead reader thread. A CLEAN peer close at a frame boundary ends that
shard. An installed :class:`~gelly_streaming_tpu_torch.resilience.FaultPlan`'s
``disconnect_at_record`` fires per record ordinal, dropping the whole
in-flight frame so the peer's replay re-delivers it exactly once.

``python -m gelly_streaming_tpu_torch.core.ingest --serve ...`` is the
serve-from-memory load-generator peer: it synthesizes an R-MAT stream,
partitions it with :func:`shard_of`, pre-encodes each shard's frames (or
text lines), and serves each connection from memory. It never initialises
CUDA.
"""

from __future__ import annotations

import queue
import socket as _socket
import struct
import threading
import time
import warnings
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from ..obs import trace as _trace
from ..obs.registry import get_registry
from ..resilience import faults as _faults
from ..resilience.errors import TransientSourceError
from ..resilience.retry import exp_backoff
from .device import DEFAULT_DEVICE
from .pipeline import bounded_put
from .stream import SimpleEdgeStream, StreamContext
from .window import CountWindow, Windower, take_cols

# --------------------------------------------------------------------- #
# GSEW wire format
# --------------------------------------------------------------------- #
#: frame magic (also the protocol's garbage detector)
MAGIC = b"GSEW"
VERSION = 1
#: GSEW v2: identical header/column layout plus the optional i64
#: event-timestamp column (``F_TS``). v1 frames stay byte-identical —
#: a ts-less stream never pays the version bump, and every reader
#: accepts both.
VERSION_TS = 2
#: header: magic | version | flags | n_edges | payload length | sequence
HEADER = struct.Struct("<4sBBIIQ")
#: flags bit 0: int64 endpoint columns (else int32)
F_WIDE = 1
#: flags bit 1: float64 value column present
F_VAL = 2
#: flags bit 2: int64 event-timestamp column present (v2 frames only;
#: the column rides LAST in the payload so the native column decoder
#: consumes the unchanged prefix)
F_TS = 4
#: reject frames declaring more edges than this before reading them
MAX_FRAME_EDGES = 1 << 22
#: reject payloads past this byte length before reading them
DEFAULT_MAX_FRAME = 64 << 20

_DONE = object()  # per-shard end-of-stream sentinel on the window queue


class Disconnect(Exception):
    """Peer closed at a frame boundary — the clean end of a shard."""


class MalformedFrame(ValueError):
    """The byte stream violated the frame contract; ``kind`` is the
    ``source.malformed_frames{kind=...}`` label (magic/version/
    oversized/columns/truncated/ts_missing)."""

    def __init__(self, kind: str, msg: str):
        super().__init__(msg)
        self.kind = kind


class _Stopped(Exception):
    """Internal unwind: the source was closed mid-read."""


def pack_edge_frame(
    src: np.ndarray,
    dst: np.ndarray,
    val: Optional[np.ndarray] = None,
    *,
    seq: int = 0,
    wide: Optional[bool] = None,
    ts: Optional[np.ndarray] = None,
) -> bytes:
    """Encode one GSEW frame: header + raw little-endian columns
    (src, then dst, then the optional float64 value column, then the
    optional int64 event-timestamp column).

    ``wide=None`` picks int32 columns when every id fits (half the
    wire bytes — the common dense-id case), int64 otherwise. ``seq``
    is the per-connection frame sequence number (1-based; 0 = unknown,
    never deduped) the reader uses to drop at-least-once replays.
    ``ts`` makes the frame GSEW v2 (``F_TS``); without it the frame is
    byte-identical v1 — old readers never see a version they cannot
    parse unless the stream actually carries event time.
    """
    src = np.ascontiguousarray(src, np.int64)
    dst = np.ascontiguousarray(dst, np.int64)
    n = src.shape[0]
    if dst.shape[0] != n:
        raise ValueError("src/dst column lengths disagree")
    if n > MAX_FRAME_EDGES:
        raise ValueError(
            f"{n} edges exceeds the {MAX_FRAME_EDGES}-edge frame bound"
        )
    if wide is None:
        i32 = np.iinfo(np.int32)
        wide = bool(n) and bool(
            min(int(src.min()), int(dst.min())) < i32.min
            or max(int(src.max()), int(dst.max())) > i32.max
        )
    # encoder and reader must agree on BOTH bounds:
    # a frame the encoder emits but every reader rejects as oversized
    # would dead-loop the replay path, so reject it at pack time
    nbytes = (
        n * (8 if wide else 4) * 2
        + (8 * n if val is not None else 0)
        + (8 * n if ts is not None else 0)
    )
    if nbytes > DEFAULT_MAX_FRAME:
        raise ValueError(
            f"frame payload of {nbytes} bytes exceeds the reader bound "
            f"{DEFAULT_MAX_FRAME}; lower frame_edges (wide/val/ts "
            "columns cost up to 32 bytes per edge)"
        )
    dt = "<i8" if wide else "<i4"
    flags = (
        (F_WIDE if wide else 0)
        | (F_VAL if val is not None else 0)
        | (F_TS if ts is not None else 0)
    )
    parts = [src.astype(dt, copy=False).tobytes(),
             dst.astype(dt, copy=False).tobytes()]
    if val is not None:
        val = np.ascontiguousarray(val, np.float64)
        if val.shape[0] != n:
            raise ValueError("val column length disagrees with src/dst")
        parts.append(val.astype("<f8", copy=False).tobytes())
    if ts is not None:
        ts = np.ascontiguousarray(ts, np.int64)
        if ts.shape[0] != n:
            raise ValueError("ts column length disagrees with src/dst")
        parts.append(ts.astype("<i8", copy=False).tobytes())
    payload = b"".join(parts)
    version = VERSION_TS if ts is not None else VERSION
    return HEADER.pack(MAGIC, version, flags, n, len(payload), seq) + payload


def decode_frame_payload(payload: bytes, n_edges: int, flags: int):
    """Decode a frame payload into ``(src i64, dst i64, val f64|None)``
    columns — one native call per frame
    (:func:`gelly_streaming_tpu_torch.native.decode_edge_frame`) — plus a
    trailing ``ts i64`` column when the frame carries ``F_TS`` (the
    return arity mirrors the flags, the codec-symmetry rule: a v1
    frame decodes exactly as it always did). The ts column rides LAST
    in the payload precisely so the native decoder's prefix stays
    byte-identical across versions."""
    from .. import native as _native

    ts = None
    if flags & F_TS:
        tail = 8 * n_edges
        if len(payload) < tail:
            raise MalformedFrame(
                "columns",
                f"payload of {len(payload)} bytes cannot carry a "
                f"{tail}-byte ts column",
            )
        ts = np.frombuffer(
            payload, "<i8", n_edges, len(payload) - tail
        ).astype(np.int64, copy=True)
        payload = payload[:-tail] if tail else payload
    try:
        cols = _native.decode_edge_frame(
            payload, n_edges, bool(flags & F_WIDE), bool(flags & F_VAL)
        )
    except ValueError as e:
        raise MalformedFrame("columns", str(e)) from e
    return cols if ts is None else cols + (ts,)


def frame_geometry(n_edges: int, flags: int) -> int:
    """Payload byte length the header's (n_edges, flags) pair implies."""
    isz = 8 if flags & F_WIDE else 4
    return (
        n_edges * isz * 2
        + (8 * n_edges if flags & F_VAL else 0)
        + (8 * n_edges if flags & F_TS else 0)
    )


def read_edge_frame(
    sock,
    *,
    max_edges: int = MAX_FRAME_EDGES,
    max_frame: int = DEFAULT_MAX_FRAME,
    stop: Optional[threading.Event] = None,
) -> Tuple[int, int, int, bytes]:
    """One complete frame off the socket: ``(seq, flags, n_edges,
    payload)``. Raises :class:`Disconnect` at a clean frame boundary,
    :class:`MalformedFrame` for everything the frame contract rejects,
    and re-raises ``socket.timeout`` only when it struck at a boundary
    with nothing read (an idle tick the caller may poll through)."""
    head = _recv_exact(sock, HEADER.size, at_boundary=True, stop=stop)
    magic, version, flags, n_edges, plen, seq = HEADER.unpack(head)
    if magic != MAGIC:
        raise MalformedFrame("magic", f"bad magic {magic!r}")
    if version not in (VERSION, VERSION_TS):
        raise MalformedFrame("version", f"unsupported version {version}")
    if version == VERSION and flags & F_TS:
        # the ts column is exactly what v2 versions: a v1 frame
        # claiming one is a contract violation, not a decode attempt
        raise MalformedFrame(
            "version", "ts column flag requires a version-2 frame"
        )
    if n_edges > max_edges or plen > max_frame:
        raise MalformedFrame(
            "oversized",
            f"frame declares {n_edges} edges / {plen} payload bytes "
            f"(bounds: {max_edges} edges, {max_frame} bytes)",
        )
    want = frame_geometry(n_edges, flags)
    if plen != want:
        raise MalformedFrame(
            "columns",
            f"payload length {plen} disagrees with the column geometry "
            f"{want} (n={n_edges}, flags={flags})",
        )
    payload = _recv_exact(sock, plen, stop=stop) if plen else b""
    return seq, flags, n_edges, payload


def _recv_exact(
    sock,
    n: int,
    *,
    at_boundary: bool = False,
    stop: Optional[threading.Event] = None,
) -> bytes:
    """Read exactly ``n`` bytes. An orderly EOF (``recv() == b""``,
    i.e. the peer's FIN) before the FIRST byte of a frame is a clean
    :class:`Disconnect` — the ONLY clean end; a reset at a boundary
    re-raises as the OSError it is (a reconnectable failure, never a
    silent end-of-stream). EOF or a reset mid-frame is a
    :class:`MalformedFrame` (``truncated``). A receive timeout at a
    boundary with nothing read propagates (the reader's idle/stop poll
    tick); mid-frame it keeps waiting — a slow peer is not a torn one —
    unless ``stop`` was set, which unwinds via :class:`_Stopped`."""
    buf = b""
    while len(buf) < n:
        if stop is not None and stop.is_set():
            raise _Stopped()
        try:
            chunk = sock.recv(n - len(buf))
        except _socket.timeout:
            if at_boundary and not buf:
                raise
            continue
        except OSError as e:
            if at_boundary and not buf:
                # a reset between frames is NOT a clean close: only the
                # peer's FIN (empty recv below) may end the shard —
                # mapping resets to Disconnect would silently truncate
                # the stream while budget remains to reconnect
                raise
            raise MalformedFrame(
                "truncated",
                f"connection lost after {len(buf)}/{n} bytes: {e!r}",
            ) from e
        if not chunk:
            if at_boundary and not buf:
                raise Disconnect("peer closed")
            raise MalformedFrame(
                "truncated", f"peer closed after {len(buf)}/{n} bytes"
            )
        buf += chunk
    return buf


# --------------------------------------------------------------------- #
# Partitioning: the keyed-shuffle rule
# --------------------------------------------------------------------- #
def shard_of(src, dst, nshards: int) -> np.ndarray:
    """Deterministic edge -> shard assignment by endpoint hash.

    THE one partition rule (same ethos as ``window.is_column_input``):
    the load generator, any real producer, and the oracle tests must
    agree on which shard owns an edge, so the rule lives in exactly one
    place. Vectorized 64-bit mix of both endpoints; stable across runs
    and processes."""
    s = np.asarray(src).astype(np.uint64)
    d = np.asarray(dst).astype(np.uint64)
    h = s * np.uint64(0x9E3779B97F4A7C15) ^ (
        d * np.uint64(0xC2B2AE3D27D4EB4F)
    )
    h ^= h >> np.uint64(33)
    return (h % np.uint64(nshards)).astype(np.int64)


def partition_edges(
    src, dst, val=None, nshards: int = 1, ts=None
) -> List[Tuple]:
    """Split edge columns into per-shard column triples, stream order
    preserved within each shard (what a keyed shuffle delivers). With
    ``ts`` (an aligned i64 event-timestamp column) each entry is the
    4-tuple ``(src, dst, val|None, ts)`` instead — order preservation
    is what keeps per-shard watermarks honest."""
    src = np.asarray(src)
    dst = np.asarray(dst)
    owner = shard_of(src, dst, nshards)
    out = []
    for i in range(nshards):
        m = owner == i
        cols = (
            src[m], dst[m], None if val is None else np.asarray(val)[m]
        )
        if ts is not None:
            cols = cols + (np.asarray(ts, np.int64)[m],)
        out.append(cols)
    return out


def vertex_owner(ids, nshards: int) -> np.ndarray:
    """Deterministic vertex -> shard assignment for SERVING keyspace
    partitioning: the one vertex rule, DERIVED from :func:`shard_of`
    (a vertex is the degenerate edge ``(v, v)``) so producers, the
    query router, and the oracle tests all agree through one hash."""
    return shard_of(ids, ids, nshards)


def partition_edges_by_vertex(
    src, dst, val=None, nshards: int = 1
) -> List[Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]]:
    """Split edge columns by VERTEX ownership: each edge is delivered
    to the owner of EACH endpoint (one copy when both endpoints share
    an owner), stream order preserved within each shard.

    This is the sharded-serving delivery rule (:func:`vertex_owner`):
    a vertex's owner shard receives every edge incident to it, so
    per-vertex answers (degree, rank mass) are owner-complete, while
    global connectivity stays reconstructable as the union of per-shard
    summaries (every edge lives in at least one shard)."""
    src = np.asarray(src)
    dst = np.asarray(dst)
    os_ = vertex_owner(src, nshards)
    od = vertex_owner(dst, nshards)
    out = []
    for i in range(nshards):
        m = (os_ == i) | (od == i)
        out.append((
            src[m], dst[m], None if val is None else np.asarray(val)[m]
        ))
    return out


# --------------------------------------------------------------------- #
# Ownership epochs: the elastic-resharding rule
# --------------------------------------------------------------------- #
def split_side(ids, salt: int) -> np.ndarray:
    """The per-vertex coin of ONE split generation: a salt-keyed 64-bit
    finalizer over the raw vertex id, reduced to its low bit. True
    means the vertex moves to the split's CHILD shard, False means it
    stays with the parent. Deterministic across processes (the same
    ethos as :func:`shard_of`) and INDEPENDENT of the base hash — the
    salt decorrelates the coin from ``vertex_owner``'s bucket choice so
    a split moves ~half the parent's keyspace, not a skewed sliver."""
    h = np.asarray(ids).astype(np.uint64) ^ np.uint64(salt & (2**64 - 1))
    h = (h ^ (h >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    h = (h ^ (h >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    h ^= h >> np.uint64(31)
    return (h & np.uint64(1)).astype(bool)


def vertex_owner_epoch(ids, nshards: int, splits=()) -> np.ndarray:
    """Vertex ownership under an epoch of live splits: epoch 0 is
    :func:`vertex_owner` over the BOOT shard count, and each entry of
    ``splits`` (applied in order — the ownership epoch is the prefix
    length) re-assigns the parent-owned vertices whose
    :func:`split_side` coin came up True to the split's child shard.

    Every ruling party — routers fanning out, the load generator
    aiming keys, the oracle tests — derives ownership through THIS one
    function, so a split can never make two components disagree about
    who owns a vertex at a given epoch. A split dict carries
    ``{"parent": int, "child": int, "salt": int}``; the salt is chosen
    by the split coordinator (one per split) and travels inside the
    elected plan."""
    own = vertex_owner(ids, nshards)
    for sp in splits:
        parent = int(sp["parent"])
        child = int(sp["child"])
        m = own == parent
        if not np.any(m):
            continue
        side = split_side(np.asarray(ids)[m], int(sp["salt"]))
        moved = own[m]
        moved[side] = child
        own[m] = moved
    return own


# --------------------------------------------------------------------- #
# The sharded source
# --------------------------------------------------------------------- #
class _Shard:
    """One connection's reader state: the bounded window queue, the
    replay-dedup watermark, and lazily-resolved obs instruments."""

    __slots__ = ("index", "addr", "q", "thread", "error", "last_seq",
                 "nrec", "pend", "have", "watermark", "_gauge", "_stall",
                 "_resume", "_late")

    def __init__(self, index: int, addr, depth: int):
        self.index = index
        self.addr = addr
        self.q: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
        self.thread: Optional[threading.Thread] = None
        self.error: Optional[BaseException] = None
        self.last_seq = 0   # highest accepted frame seq (replay dedup)
        self.nrec = 0       # accepted-record ordinal (fault hook index)
        self.pend: list = []  # buffered column triples of the open window
        self.have = 0
        # per-shard event-time watermark: max observed ts (monotone;
        # GSEW preserves per-shard arrival order so the max IS the
        # promise). Written only by this shard's reader thread; the
        # cross-shard merge happens on demand at the consumer.
        self.watermark: Optional[int] = None
        self._gauge = None
        self._stall = None
        self._resume = None
        self._late = None  # lazy eventtime.late_dropped counter


class ShardedEdgeSource:
    """N concurrent shard connections feeding per-shard count windows.

    ``addresses`` is one ``(host, port)`` per shard; the peer must serve
    each connection the records :func:`shard_of` assigns to that shard
    (the keyed-shuffle contract — :func:`partition_edges` implements it
    for in-memory producers, the ``--serve`` CLI for subprocesses).
    ``window`` is the per-shard count-window size; closed windows are
    handed over a bounded queue of ``queue_windows`` entries — the
    explicit backpressure boundary (see the module docstring).

    ``fmt="binary"`` reads GSEW frames (exactly-once across reconnects
    via frame sequence dedup); ``fmt="text"`` reads the line protocol
    ``SocketEdgeSource`` speaks, batch-parsed natively per recv
    (at-least-once across reconnects — lines carry no sequence).

    Consume via :meth:`windows` (closed windows in arrival order) or
    :meth:`stream` (a :class:`ShardedEdgeStream` on the block/superbatch
    execution path). Single-use, like every stream source here.
    """

    def __init__(
        self,
        addresses: Sequence[Tuple[str, int]],
        *,
        window: int,
        fmt: str = "binary",
        queue_windows: int = 4,
        weighted: bool = False,
        timestamps: bool = False,
        allowed_lateness_s: int = 0,
        tick_s: float = 0.2,
        reconnect: int = 5,
        reconnect_base_s: float = 0.05,
        reconnect_max_s: float = 2.0,
        stall_event_s: float = 0.5,
        max_frame_edges: int = MAX_FRAME_EDGES,
    ):
        if fmt not in ("binary", "text"):
            raise ValueError(f"fmt must be binary/text, got {fmt!r}")
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        if timestamps and fmt != "binary":
            raise ValueError(
                "timestamps=True requires fmt='binary' (the line "
                "protocol carries no ts column; use SocketEdgeSource's "
                "ts extractor for text streams)"
            )
        if allowed_lateness_s < 0:
            raise ValueError(
                f"allowed_lateness_s must be >= 0, got {allowed_lateness_s}"
            )
        self.window = int(window)
        self.fmt = fmt
        self.weighted = weighted
        self.timestamps = bool(timestamps)
        self.allowed_lateness_s = int(allowed_lateness_s)
        self.tick_s = float(tick_s)
        self.reconnect = int(reconnect)
        self.reconnect_base_s = float(reconnect_base_s)
        self.reconnect_max_s = float(reconnect_max_s)
        self.stall_event_s = float(stall_event_s)
        self.max_frame_edges = int(max_frame_edges)
        self._stop = threading.Event()
        self._tokens: "queue.Queue[int]" = queue.Queue()
        self._shards = [
            _Shard(i, tuple(a), queue_windows)
            for i, a in enumerate(addresses)
        ]
        self._started = False
        self._consumed = False
        self._ended: set = set()  # shards whose _DONE was consumed

    @property
    def nshards(self) -> int:
        return len(self._shards)

    # ------------------------------------------------------------------ #
    def start(self) -> "ShardedEdgeSource":
        if self._started:
            return self
        self._started = True
        for sh in self._shards:
            t = threading.Thread(
                target=self._run_reader, args=(sh,), daemon=True,
                name=f"ingest-shard-{sh.index}",
            )
            sh.thread = t
            t.start()
        return self

    def close(self, join_timeout_s: float = 10.0) -> None:
        self._stop.set()
        # ONE total budget across every reader join: N slow threads
        # share join_timeout_s, they do not each get a fresh one
        deadline = time.monotonic() + join_timeout_s
        for sh in self._shards:
            t = sh.thread
            if t is None:
                continue
            t.join(timeout=max(0.0, deadline - time.monotonic()))
            if t.is_alive():
                # same posture as pipeline.prefetch: a reader that never
                # honored the stop flag is a silent leak — surface it
                get_registry().counter("source.reader_leaked").inc()
                warnings.warn(
                    f"ingest shard {sh.index}: reader thread did not "
                    f"exit within {join_timeout_s}s of close; thread "
                    "(and its socket) leaked",
                    RuntimeWarning,
                    stacklevel=2,
                )

    # ------------------------------------------------------------------ #
    def windows(
        self,
    ) -> Iterator[Tuple[int, np.ndarray, np.ndarray, Optional[np.ndarray]]]:
        """Yield ``(shard, src, dst, val|None)`` closed windows in
        arrival order until every shard ends cleanly. Single use. A
        shard's reader error (exhausted reconnect budget, injected
        fatal) re-raises HERE, after its queued windows drained."""
        for sh, item in self._merged_items():
            yield (sh.index,) + item[:3]

    def windows_ts(
        self,
    ) -> Iterator[Tuple[int, np.ndarray, np.ndarray,
                        Optional[np.ndarray], np.ndarray]]:
        """Yield ``(shard, src, dst, val|None, ts)`` closed windows in
        arrival order — the event-time consumer surface (what
        :func:`gelly_streaming_tpu_torch.eventtime.stream.drive_sliding`
        drives). Requires ``timestamps=True``; single use."""
        if not self.timestamps:
            raise RuntimeError(
                "windows_ts() requires ShardedEdgeSource(timestamps=True)"
            )
        for sh, item in self._merged_items():
            yield (sh.index,) + item

    def _merged_items(self):
        if self._consumed:
            raise RuntimeError("ShardedEdgeSource is single-use")
        self._consumed = True
        self.start()
        done = 0
        n = len(self._shards)
        try:
            while done < n:
                try:
                    tok = self._tokens.get(timeout=1.0)
                except queue.Empty:
                    if self._stop.is_set():
                        return
                    if not any(
                        sh.thread is not None and sh.thread.is_alive()
                        for sh in self._shards
                    ) and all(sh.q.empty() for sh in self._shards):
                        raise RuntimeError(
                            "ingest reader threads died without handoff"
                        )
                    continue
                sh = self._shards[tok]
                try:
                    item = sh.q.get_nowait()
                except queue.Empty:
                    continue  # close() raced the token; nothing to do
                if item is _DONE:
                    done += 1
                    self._ended.add(sh.index)
                    if sh.error is not None:
                        raise sh.error
                    continue
                yield sh, item
        finally:
            self.close()

    # ------------------------------------------------------------------ #
    # Event-time progress (timestamps=True)
    # ------------------------------------------------------------------ #
    def shard_watermarks(self) -> List[int]:
        """Per-shard watermarks (max accepted ts; ``NO_WATERMARK`` for
        a shard that has not observed event time yet)."""
        from ..eventtime.watermark import NO_WATERMARK

        return [
            NO_WATERMARK if sh.watermark is None else sh.watermark
            for sh in self._shards
        ]

    def watermark(self) -> int:
        """The merged event-time watermark: the min over LIVE shards'
        marks (THE cross-shard rule,
        :func:`gelly_streaming_tpu_torch.eventtime.watermark.merge_watermarks`).
        Ended shards leave the merge — a closed stream holds nothing
        back."""
        from ..eventtime.watermark import NO_WATERMARK, merge_watermarks

        return merge_watermarks(
            NO_WATERMARK if sh.watermark is None else sh.watermark
            for sh in self._shards
            if sh.index not in self._ended
        )

    def stream(self, vertex_dict=None, context=None, *,
               val_dtype=np.float32, device=None) -> "ShardedEdgeStream":
        """The merged stream on the block/superbatch execution path, on
        ``device`` (default ``"cuda"``; ``context``'s device when a
        context is given)."""
        return ShardedEdgeStream(
            self, vertex_dict=vertex_dict, context=context,
            val_dtype=val_dtype, device=device,
        )

    # ------------------------------------------------------------------ #
    # Reader threads
    # ------------------------------------------------------------------ #
    def _run_reader(self, sh: _Shard) -> None:
        try:
            if self.fmt == "binary":
                self._read_binary(sh)
            else:
                self._read_text(sh)
        except _Stopped:
            pass
        except BaseException as e:
            # not a swallow: the error is COUNTED here and re-raised at
            # the consumer's merge loop once this shard's queue drains
            sh.error = e
            get_registry().counter(
                "source.reader_errors", shard=str(sh.index)
            ).inc()
        finally:
            if bounded_put(sh.q, _DONE, self._stop):
                self._tokens.put(sh.index)

    def _read_binary(self, sh: _Shard) -> None:
        attempts = 0
        # consecutive malformed frames with NO new data accepted in
        # between: a deterministic mid-stream corruption would otherwise
        # reconnect forever (each replay's intact prefix refills the
        # reconnect budget while seq-dedup yields no progress)
        malformed_streak = 0
        while not self._stop.is_set():
            try:
                sock = _socket.create_connection(sh.addr, timeout=5.0)
            except OSError as e:
                attempts += 1
                self._backoff(sh, attempts, e)
                continue
            clean = False
            failure: Optional[Exception] = None  # reconnect cause
            try:
                sock.settimeout(self.tick_s)
                while True:
                    try:
                        seq, flags, n, payload = read_edge_frame(
                            sock, max_edges=self.max_frame_edges,
                            stop=self._stop,
                        )
                    except _socket.timeout:
                        if self._stop.is_set():
                            raise _Stopped() from None
                        continue  # idle boundary tick
                    except Disconnect:
                        clean = True
                        break
                    attempts = 0  # an intact frame refills the budget
                    if seq and seq <= sh.last_seq:
                        # at-least-once replay after a reconnect: the
                        # peer re-served an already-accepted frame
                        get_registry().counter(
                            "source.replayed_frames", shard=str(sh.index)
                        ).inc()
                        continue
                    with _trace.span(
                        "ingest.decode",
                        {"edges": int(n), "shard": sh.index}
                        if _trace.on() else None,
                    ):
                        cols = decode_frame_payload(payload, n, flags)
                    src, dst, val = cols[:3]
                    ts = cols[3] if len(cols) > 3 else None
                    if self.timestamps and ts is None:
                        # a ts-expecting reader fed a ts-less stream is
                        # a misconfigured pairing, not decodable data:
                        # counted malformed + reconnect, and the streak
                        # guard classifies the determinism
                        raise MalformedFrame(
                            "ts_missing",
                            "reader expects event timestamps but the "
                            "frame carries no ts column (GSEW v1 peer?)",
                        )
                    # fault hook BEFORE the frame is accepted: an
                    # injected disconnect drops the WHOLE frame (seq
                    # watermark unmoved), so the peer's replay
                    # re-delivers it exactly once
                    if _faults.active():
                        for j in range(n):
                            _faults.fire(
                                "source.record", index=sh.nrec + j
                            )
                    if seq:
                        sh.last_seq = seq
                    sh.nrec += n
                    malformed_streak = 0  # real progress, not a replay
                    if not self.weighted:
                        val = None
                    if not self.timestamps:
                        ts = None  # tolerated, unused: count windows
                    elif ts is not None and len(ts):
                        ts, src, dst, val = self._drop_late(
                            sh, ts, src, dst, val
                        )
                        hi = int(ts.max()) if len(ts) else None
                        if hi is not None and (
                            sh.watermark is None or hi > sh.watermark
                        ):
                            sh.watermark = hi
                        if not len(src):
                            continue
                    if not self._buffer_cols(sh, src, dst, val, ts):
                        raise _Stopped()
            except MalformedFrame as e:
                # counted evidence + clean reconnect: framing cannot
                # resync mid-garbage, so the connection is dropped and
                # the budgeted backoff below applies
                self._count_malformed(sh, e.kind)
                malformed_streak += 1
                failure = e
            except OSError as e:
                # reset / injected disconnect mid-stream: reconnect;
                # the in-flight frame died with the connection and the
                # peer re-serves it (at-least-once, deduped by seq)
                failure = e
            finally:
                sock.close()
            if clean:
                self._flush_tail(sh)
                return
            if failure is not None:
                if malformed_streak > self.reconnect:
                    # the stream is corrupt, not flaky: every reconnect
                    # replays the same garbage at the same point — give
                    # up with a classified error instead of looping
                    raise TransientSourceError(
                        f"ingest shard {sh.index} "
                        f"({sh.addr[0]}:{sh.addr[1]}): "
                        f"{malformed_streak} consecutive malformed "
                        "frames with no new data between reconnects"
                    ) from failure
                # backoff AFTER teardown, outside the handler: an
                # exhausted budget raises TransientSourceError (a
                # ConnectionError), which the except OSError above
                # must never re-catch
                attempts += 1
                self._backoff(sh, attempts, failure)

    def _read_text(self, sh: _Shard) -> None:
        attempts = 0
        while not self._stop.is_set():
            try:
                sock = _socket.create_connection(sh.addr, timeout=5.0)
            except OSError as e:
                attempts += 1
                self._backoff(sh, attempts, e)
                continue
            buf = b""
            clean = False
            failure: Optional[Exception] = None
            try:
                sock.settimeout(self.tick_s)
                while True:
                    if self._stop.is_set():
                        raise _Stopped()
                    try:
                        data = sock.recv(1 << 16)
                    except _socket.timeout:
                        continue
                    if not data:
                        clean = True
                        break
                    attempts = 0
                    buf += data
                    if b"\n" not in buf:
                        continue
                    lines, buf = buf.rsplit(b"\n", 1)
                    if not self._parse_text_chunk(sh, lines):
                        raise _Stopped()
            except OSError as e:
                failure = e
            finally:
                sock.close()
            if clean:
                if buf.strip():
                    self._parse_text_chunk(sh, buf)
                self._flush_tail(sh)
                return
            if failure is not None:
                attempts += 1
                self._backoff(sh, attempts, failure)

    def _parse_text_chunk(self, sh: _Shard, lines: bytes) -> bool:
        from .. import native as _native

        with _trace.span(
            "ingest.decode",
            {"bytes": len(lines), "shard": sh.index}
            if _trace.on() else None,
        ):
            src, dst, val, malformed = _native.parse_edge_lines(lines)
        if malformed:
            get_registry().counter(
                "source.malformed_lines"
            ).inc(malformed)
        n = len(src)
        if n == 0:
            return True
        if _faults.active():
            for j in range(n):
                _faults.fire("source.record", index=sh.nrec + j)
        sh.nrec += n
        if not self.weighted:
            val = None
        return self._buffer_cols(sh, src, dst, val)

    # ------------------------------------------------------------------ #
    # Window assembly + the backpressure boundary
    # ------------------------------------------------------------------ #
    def _drop_late(self, sh: _Shard, ts, src, dst, val):
        """The source-level lateness policy: a record older than this
        shard's watermark minus ``allowed_lateness_s`` is DROPPED and
        counted ``eventtime.late_dropped`` (the LATE-DROP story line) —
        never silently absorbed into a window that event time already
        passed. Within the allowance, out-of-order records pass through
        (the pane assembler buffers them into their proper pane)."""
        if sh.watermark is None:
            return ts, src, dst, val
        late = ts < sh.watermark - self.allowed_lateness_s
        n_late = int(late.sum())
        if not n_late:
            return ts, src, dst, val
        if sh._late is None:
            sh._late = get_registry().counter(
                "eventtime.late_dropped", shard=str(sh.index)
            )
        sh._late.inc(n_late)
        keep = ~late
        return (
            ts[keep], src[keep], dst[keep],
            None if val is None else val[keep],
        )

    def _buffer_cols(self, sh: _Shard, src, dst, val, ts=None) -> bool:
        sh.pend.append(
            (src, dst, val) if ts is None else (src, dst, val, ts)
        )
        sh.have += len(src)
        while sh.have >= self.window:
            sh.have -= self.window
            if not self._put_window(
                sh, take_cols(sh.pend, self.window, np.float64)
            ):
                return False
        return True

    def _flush_tail(self, sh: _Shard) -> None:
        if sh.have:
            take = sh.have
            sh.have = 0
            self._put_window(sh, take_cols(sh.pend, take, np.float64))

    def _put_window(self, sh: _Shard, cols) -> bool:
        stalled = [False]

        def on_wait(waited: float) -> None:
            if not stalled[0] and waited >= self.stall_event_s:
                stalled[0] = True
                if sh._stall is None:
                    sh._stall = get_registry().counter(
                        "source.backpressure_stalls", shard=str(sh.index)
                    )
                sh._stall.inc()

        def on_done(waited: float) -> None:
            if waited > 0:
                get_registry().counter("source.backpressure_s").inc(waited)
            if stalled[0]:
                if sh._resume is None:
                    sh._resume = get_registry().counter(
                        "source.backpressure_resumes", shard=str(sh.index)
                    )
                sh._resume.inc()

        if not bounded_put(
            sh.q, cols, self._stop, on_wait=on_wait, on_done=on_done
        ):
            return False
        if sh._gauge is None:
            sh._gauge = get_registry().gauge(
                "source.shard_depth", shard=str(sh.index)
            )
        sh._gauge.set(sh.q.qsize())
        self._tokens.put(sh.index)
        return True

    def _count_malformed(self, sh: _Shard, kind: str) -> None:
        # every frame-contract violation is counted evidence (the fuzz
        # contract: a malformed byte stream is a clean reconnect, never
        # a dead reader thread — and never a silent one)
        get_registry().counter(
            "source.malformed_frames", kind=kind, shard=str(sh.index)
        ).inc()

    # ------------------------------------------------------------------ #
    def _backoff(self, sh: _Shard, attempts: int, err: Exception) -> None:
        """One budgeted reconnect delay (the ``SocketEdgeSource``
        resilience contract): counted, bounded-exponential, waited out
        in slices so ``close()`` never blocks a full delay. Raises
        :class:`TransientSourceError` past the budget."""
        get_registry().counter("source.reconnects").inc()
        if attempts > self.reconnect:
            raise TransientSourceError(
                f"ingest shard {sh.index} ({sh.addr[0]}:{sh.addr[1]}) "
                f"gave up after {attempts - 1} reconnect attempts"
            ) from err
        delay = exp_backoff(
            attempts - 1, self.reconnect_base_s, self.reconnect_max_s
        )
        while delay > 0:
            if self._stop.is_set():
                raise _Stopped()
            step = min(0.05, delay)
            time.sleep(step)
            delay -= step


# --------------------------------------------------------------------- #
# The merged stream: closed shard windows -> block/superbatch path
# --------------------------------------------------------------------- #
class ShardedEdgeStream(SimpleEdgeStream):
    """A real :class:`~gelly_streaming_tpu_torch.core.stream.SimpleEdgeStream`
    over a :class:`ShardedEdgeSource`'s merged windows: aggregations,
    transforms and emission streams work unchanged.

    Per-window blocks go through the shared
    :class:`~gelly_streaming_tpu_torch.core.window.Windower` (one encode and
    one block on the stream's device per closed shard window, with its
    host columns), and :meth:`superbatches` packs K closed windows with ONE
    group encode and no per-window device work
    (:meth:`~gelly_streaming_tpu_torch.core.window.Windower.pack_window_cols`).
    ``device`` defaults to ``"cuda"`` and raises without a card; the CPU
    runs when asked for. Single use, like the source underneath."""

    def __init__(self, source: ShardedEdgeSource, *, vertex_dict=None,
                 context=None, val_dtype=np.float32, device=None):
        if context is None:
            context = StreamContext(DEFAULT_DEVICE if device is None else device)
        windower = Windower(
            CountWindow(source.window), vertex_dict,
            device=context.device, val_dtype=val_dtype,
        )
        self._sharded_source = source
        self._shard_windower = windower
        super().__init__(
            context=context, device=device, _blocks=self._shard_blocks,
            _vdict=windower.vertex_dict,
        )

    def _shard_blocks(self):
        w = self._shard_windower
        for _shard, src, dst, val in self._sharded_source.windows():
            yield w._block_from_arrays(src, dst, val)

    def superbatches(self, k: int):
        """K closed shard windows per
        :class:`~gelly_streaming_tpu_torch.core.window.SuperbatchGroup`."""
        if k < 1:
            raise ValueError(f"superbatch k must be >= 1, got {k}")

        def gen():
            w = self._shard_windower
            group: list = []
            index = 0
            for _shard, src, dst, val in self._sharded_source.windows():
                group.append((src, dst, val))
                if len(group) >= k:
                    yield w.pack_window_cols(group, index)
                    index += len(group)
                    group = []
            if group:
                yield w.pack_window_cols(group, index)

        return gen()


# --------------------------------------------------------------------- #
# Serve-from-memory peer (the load generator's server half)
# --------------------------------------------------------------------- #
def encode_shard_frames(
    src, dst, val=None, *, frame_edges: int = 8192,
    wide: Optional[bool] = None, ts=None,
) -> bytes:
    """Pre-encode one shard's whole stream as consecutive GSEW frames
    (seq 1..N) — what the serve-from-memory peer sends verbatim.
    ``ts`` (an i64 column aligned with src/dst) makes every frame
    GSEW v2."""
    src = np.asarray(src)
    dst = np.asarray(dst)
    if ts is not None:
        ts = np.asarray(ts, np.int64)
    parts = []
    seq = 0
    for a in range(0, len(src), frame_edges):
        b = a + frame_edges
        seq += 1
        parts.append(pack_edge_frame(
            src[a:b], dst[a:b],
            None if val is None else np.asarray(val)[a:b],
            seq=seq, wide=wide,
            ts=None if ts is None else ts[a:b],
        ))
    return b"".join(parts)


def encode_shard_text(src, dst) -> bytes:
    """One shard's stream as the line protocol (the text baseline)."""
    return "".join(
        f"{int(s)}\t{int(d)}\n"
        for s, d in zip(np.asarray(src).tolist(), np.asarray(dst).tolist())
    ).encode()


def serve_blobs(
    blobs: Sequence[bytes], *, host: str = "127.0.0.1",
    accepts: int = 1, chunk: int = 1 << 18,
) -> Tuple[List[int], List[threading.Thread], threading.Event]:
    """Serve each pre-encoded blob on its own listening port: accept up
    to ``accepts`` connections sequentially and send the WHOLE blob to
    each (a re-accept replays from the start — the at-least-once peer
    the reconnect tests need). Returns ``(ports, threads, stop)``;
    setting ``stop`` ends the accept loops at their next poll."""
    stop = threading.Event()
    ports: List[int] = []
    threads: List[threading.Thread] = []
    for i, blob in enumerate(blobs):
        srv = _socket.create_server((host, 0))
        srv.settimeout(0.2)
        ports.append(srv.getsockname()[1])

        def run(srv=srv, blob=blob, shard=i):
            served = 0
            try:
                while served < accepts and not stop.is_set():
                    try:
                        conn, _ = srv.accept()
                    except _socket.timeout:
                        continue
                    except OSError:
                        # listener torn down under us: the stop path
                        get_registry().counter(
                            "source.swallowed", site="serve_accept"
                        ).inc()
                        return
                    try:
                        for a in range(0, len(blob), chunk):
                            if stop.is_set():
                                break
                            conn.sendall(blob[a:a + chunk])
                    except OSError:
                        # peer vanished mid-send (reconnect tests kill
                        # readers on purpose): count, move to the next
                        # accept — the replay is the contract
                        get_registry().counter(
                            "source.swallowed", site="serve_send"
                        ).inc()
                    finally:
                        conn.close()
                    served += 1
            finally:
                srv.close()

        t = threading.Thread(target=run, daemon=True,
                             name=f"ingest-serve-{i}")
        t.start()
        threads.append(t)
    return ports, threads, stop


def main(argv: Optional[List[str]] = None) -> int:
    """``python -m gelly_streaming_tpu_torch.core.ingest --serve ...`` — the
    serve-from-memory load-generator peer (host numpy and sockets only; it
    never initialises CUDA).
    Synthesizes an R-MAT stream, partitions it by :func:`shard_of`,
    pre-encodes per-shard blobs, prints ``{"ports": [...]}`` on stdout
    once ready, serves one connection per shard, and exits."""
    import json
    import sys

    argv = list(sys.argv[1:] if argv is None else argv)

    def take(flag: str, default=None):
        if flag in argv:
            i = argv.index(flag)
            v = argv[i + 1]
            del argv[i:i + 2]
            return v
        return default

    if "--serve" not in argv:
        print(
            "usage: python -m gelly_streaming_tpu_torch.core.ingest --serve "
            "--shards N --edges M [--scale S] [--seed K] "
            "[--format binary|text] [--frame-edges F] [--accepts A] "
            "[--timestamps] [--ts-rate R]",
            file=sys.stderr,
        )
        return 2
    argv.remove("--serve")
    shards = int(take("--shards", "1"))
    n_edges = int(take("--edges", str(1 << 20)))
    scale = int(take("--scale", "20"))
    seed = int(take("--seed", "7"))
    fmt = take("--format", "binary")
    frame_edges = int(take("--frame-edges", "8192"))
    accepts = int(take("--accepts", "1"))
    timestamps = "--timestamps" in argv
    if timestamps:
        argv.remove("--timestamps")
    ts_rate = int(take("--ts-rate", "4096"))
    from ..datasets import rmat_edges

    src, dst = rmat_edges(n_edges, scale, seed=seed)
    ts = None
    if timestamps:
        # synthetic event time: ts_rate edges per tick, monotone over
        # the pre-partition stream (per-shard order preserved, so each
        # shard's watermark promise holds on the wire)
        ts = np.arange(n_edges, dtype=np.int64) // max(1, ts_rate)
    parts = partition_edges(src, dst, None, shards, ts=ts)
    if fmt == "binary":
        blobs = [
            encode_shard_frames(
                p[0], p[1], frame_edges=frame_edges,
                ts=p[3] if timestamps else None,
            )
            for p in parts
        ]
    else:
        blobs = [encode_shard_text(p[0], p[1]) for p in parts]
    ports, threads, _stop = serve_blobs(blobs, accepts=accepts)
    print(json.dumps({
        "ports": ports,
        "edges": int(n_edges),
        "per_shard": [int(len(p[0])) for p in parts],
        "format": fmt,
        "timestamps": bool(timestamps),
    }), flush=True)
    for t in threads:
        t.join()
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
