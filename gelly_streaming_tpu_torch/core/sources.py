"""Unbounded / live edge sources (the port's copy of
``gelly_streaming_tpu/core/sources.py``).

The reference gets these free from Flink ``DataStream``: sockets
(``env.socketTextStream``), collections, files. The file/array/iterator
ingest covers the bounded cases; this module adds the LIVE ones — an edge
stream with no known end, consumed as it arrives — and both feed
``SimpleEdgeStream`` on the card like any other edge iterable:

- :class:`SocketEdgeSource` — line-delimited edge records over TCP, the
  ``socketTextStream`` parity path, parsed with the file parser's grammar,
  one chunk-parse call per ``recv`` (``native.parse_edge_lines``).
- :class:`GeneratorSource` — unbounded synthetic stream (R-MAT chunks),
  for tests and runs that need "no end" semantics without a network.
  :meth:`GeneratorSource.iter_chunks` exposes the R-MAT columns directly;
  the windower consumes them on its chunk path.

Event time: ``SocketEdgeSource(ts_extractor=f)`` appends ``f(s, d, v)``
to each record as a fourth field; ``GeneratorSource(ts_rate=r)`` stamps
``ts_start + ordinal // r`` (:meth:`GeneratorSource.iter_chunks_ts` yields
``(src, dst, ts)`` columns for a
:class:`~gelly_streaming_tpu_torch.eventtime.SlidingGraphAggregator`).
The sharded scale-out path (``ShardedEdgeSource``, the binary wire
format) comes with ROADMAP Queue 1, slice 7b (ingest).

Both yield ``None`` ticks while idle so a ``ProcessingTimeWindow`` can
close an open window on schedule even when no records arrive.

RESILIENCE: connection errors — refused connects, resets mid-stream,
injected disconnects — RECONNECT with bounded exponential backoff
(``reconnect`` attempts, ``source.reconnects`` counted in the obs
registry) instead of killing the pipeline; only an exhausted budget raises
:class:`~.resilience.errors.TransientSourceError`, which the
``Supervisor`` classifies as restartable. A CLEAN peer close ends
iteration. Malformed lines are counted (``source.malformed_lines``), and
both sources honor an installed ``FaultPlan`` (record
drop/duplicate/reorder, disconnect-at-record-n; site ``source.record``).
"""

from __future__ import annotations

import socket
import time
from typing import Iterator, Optional, Tuple

import numpy as np

from ..obs.registry import get_registry
from ..resilience import faults as _faults
from ..resilience.errors import TransientSourceError
from ..resilience.retry import exp_backoff

def _perturbed(records: Iterator) -> Iterator:
    """Route a record iterator through the installed fault plan's
    drop/duplicate/reorder schedule (no-op — and no wrapper generator —
    when no plan with record perturbations is installed)."""
    plan = _faults.plan()
    if plan is not None and plan.perturbs_records():
        return plan.perturb_records(records)
    return records


def _with_ts(records: Iterator, extractor) -> Iterator:
    """Append an event timestamp to each record: ``(s, d, v)`` becomes
    ``(s, d, v, ts)`` via ``extractor(s, d, v) -> int``; ``None`` idle
    ticks pass through. Applied BEFORE the fault plan's perturbation, so
    an installed skew schedule (``FaultPlan.skew_records``) jitters the
    extracted ts like any other field."""
    for rec in records:
        if rec is None:
            yield None
            continue
        yield rec + (int(extractor(*rec)),)


class SocketEdgeSource:
    """Unbounded edge records over TCP (``env.socketTextStream`` parity).

    Lines follow the FILE parser's grammar (``native.parse_edge_lines``;
    space/tab/comma separators, ``#``/``%`` comments, third column as
    number or ``+``/``-`` event flag) and complete lines are parsed in
    ONE chunk-parse call per ``recv`` — the native scanner when the
    library builds, the byte-equivalent regex fallback otherwise.
    Malformed lines (non-blank, non-comment, grammar-rejected) are
    counted into the obs registry (``source.malformed_lines``) and
    skipped; when a
    fault plan is installed the source drops back to per-line parsing
    so record-ordinal faults interleave with parsing exactly as the
    wire delivered them. Iteration ends when the peer closes the
    connection CLEANLY (a live deployment would simply never close).
    ``tick_s``: receive timeout after which a ``None`` time tick is
    yielded instead of a record.

    Connection ERRORS (refused, reset, timeout at connect) reconnect
    with bounded exponential backoff: up to ``reconnect`` consecutive
    failed attempts, each waiting ``reconnect_base_s * 2**attempt``
    capped at ``reconnect_max_s`` — waited out in ``tick_s`` slices
    with a ``None`` tick yielded per slice, so processing-time windows
    keep closing on schedule all the way through an outage. The budget
    resets whenever data arrives; exhausting it raises
    :class:`TransientSourceError`. ``reconnect=0`` restores the
    fail-fast behavior.
    """

    def __init__(
        self,
        host: str,
        port: int,
        tick_s: float = 0.05,
        weighted: bool = False,
        reconnect: int = 5,
        reconnect_base_s: float = 0.05,
        reconnect_max_s: float = 2.0,
        ts_extractor=None,
    ):
        self.host = host
        self.port = port
        self.tick_s = tick_s
        self.weighted = weighted
        self.reconnect = int(reconnect)
        self.reconnect_base_s = float(reconnect_base_s)
        self.reconnect_max_s = float(reconnect_max_s)
        # event-time extractor: ``f(s, d, v) -> int`` turns each record into
        # ``(s, d, v, ts)`` (the line protocol has no ts column, so event
        # time rides whatever field the deployment encodes it in)
        self.ts_extractor = ts_extractor
        self._malformed = None  # lazy counter (registry may be swapped)

    def __iter__(self) -> Iterator[Optional[Tuple]]:
        records = self._records()
        if self.ts_extractor is not None:
            records = _with_ts(records, self.ts_extractor)
        return _perturbed(records)

    # ------------------------------------------------------------------ #
    def _records(self) -> Iterator[Optional[Tuple]]:
        attempts = 0  # consecutive failures since the last received data
        nrec = 0      # record ordinal for the injection hook
        while True:
            try:
                sock = socket.create_connection((self.host, self.port))
            except OSError as e:
                attempts += 1
                yield from self._backoff_ticks(attempts, e)
                continue
            sock.settimeout(self.tick_s)
            buf = b""
            clean_close = False
            try:
                while True:
                    try:
                        data = sock.recv(1 << 16)
                    except socket.timeout:
                        yield None  # idle tick: lets time windows close
                        continue
                    if not data:  # peer closed CLEANLY: the stream's end
                        clean_close = True
                        break
                    attempts = 0  # data flowed: reconnect budget refills
                    buf += data
                    if b"\n" not in buf:
                        continue
                    lines, buf = buf.rsplit(b"\n", 1)
                    if _faults.active():
                        # per-line path: record-ordinal faults must
                        # interleave with parsing exactly as the wire
                        # delivered the lines (a chunk parse would
                        # count lines past an injected disconnect)
                        for line in lines.split(b"\n"):
                            rec = self._parse_one(line)
                            if rec is not None:
                                _faults.fire("source.record", index=nrec)
                                nrec += 1
                                yield rec
                    else:
                        for rec in self._parse_chunk(lines):
                            nrec += 1
                            yield rec
            except OSError as e:
                # reset / injected disconnect mid-stream: reconnect.
                # Parsed-but-unyielded tail records of the dead
                # connection are dropped with it — the peer re-serves
                # (at-least-once), exactly Flink's source-replay shape.
                attempts += 1
                yield from self._backoff_ticks(attempts, e)
                continue
            finally:
                sock.close()
            if clean_close:
                rec = self._parse_one(buf)
                if rec is not None:
                    if _faults.active():
                        _faults.fire("source.record", index=nrec)
                    yield rec
                return

    def _backoff_ticks(self, attempts: int, err: OSError):
        """Record one connection failure, then wait out the
        bounded-exponential delay in ``tick_s`` slices, yielding a
        ``None`` tick per slice — processing-time windows keep closing
        on schedule THROUGH the outage, not only between backoffs.
        Raises :class:`TransientSourceError` past the budget
        (``reconnect=0`` fails fast, the legacy behavior)."""
        get_registry().counter("source.reconnects").inc()
        if attempts > self.reconnect:
            raise TransientSourceError(
                f"socket source {self.host}:{self.port} gave up after "
                f"{attempts - 1} reconnect attempts"
            ) from err
        delay = exp_backoff(
            attempts - 1, self.reconnect_base_s, self.reconnect_max_s
        )
        while True:
            yield None
            if delay <= 0:
                return
            step = min(max(self.tick_s, 1e-3), delay)
            time.sleep(step)
            delay -= step

    def _parse_chunk(self, lines: bytes) -> Iterator[Tuple]:
        """Parse a recv batch of complete lines in ONE chunk-parse call
        (the file parser's grammar; malformed lines counted) and yield
        per-record tuples."""
        from .. import native as _native

        src, dst, val, malformed = _native.parse_edge_lines(lines)
        if malformed:
            self._count_malformed(malformed)
        if self.weighted and val is not None:
            for s, d, v in zip(src.tolist(), dst.tolist(), val.tolist()):
                yield (s, d, v)
        else:
            for s, d in zip(src.tolist(), dst.tolist()):
                yield (s, d, 0.0)

    def _parse_one(self, line: bytes) -> Optional[Tuple]:
        """One line through the same grammar as the chunk path (used on
        the fault-interleaved path and for the clean-close tail)."""
        from .. import native as _native

        src, dst, val, malformed = _native.parse_edge_lines(line)
        if malformed:
            self._count_malformed(malformed)
        if len(src) == 0:
            return None
        v = (
            float(val[0])
            if self.weighted and val is not None
            else 0.0
        )
        return (int(src[0]), int(dst[0]), v)

    def _count_malformed(self, n: int = 1) -> None:
        # a malformed line is DATA the operator should know about, not
        # noise (no silent discards); resolved lazily so a
        # source built before obs/test registry swaps still reports
        if self._malformed is None:
            self._malformed = get_registry().counter(
                "source.malformed_lines"
            )
        self._malformed.inc(n)


class GeneratorSource:
    """Unbounded synthetic edge stream: R-MAT chunks, forever (or for
    ``limit`` edges when given — tests need an end). Honors an installed
    fault plan's record perturbations like the socket source."""

    def __init__(
        self,
        scale: int = 16,
        chunk: int = 1 << 14,
        seed: int = 0,
        limit: Optional[int] = None,
        ts_rate: Optional[int] = None,
        ts_start: int = 0,
    ):
        self.scale = scale
        self.chunk = chunk
        self.seed = seed
        self.limit = limit
        # synthetic event time: ``ts_rate`` edges per tick from ``ts_start``
        # (monotone, so the stream's own max is a valid watermark)
        if ts_rate is not None and ts_rate < 1:
            raise ValueError(f"ts_rate must be >= 1, got {ts_rate}")
        self.ts_rate = ts_rate
        self.ts_start = int(ts_start)

    def __iter__(self) -> Iterator[Tuple]:
        if self.ts_rate is not None:
            return _perturbed(self._records_ts())
        return _perturbed(self._records())

    def iter_chunks(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """Column-chunk fast path: yield the R-MAT
        ``(src, dst)`` int64 columns directly, no ``.tolist()`` +
        per-edge tuple round trip — the windower's chunk path
        (``Windower.blocks_from_chunks``) consumes these as-is, so the
        synthetic load generator is never itself the bottleneck.

        When an installed fault plan perturbs records, the chunks are
        re-assembled FROM the perturbed record path (perturbation
        schedules are per-record), so chaos runs see identical streams
        on either path."""
        plan = _faults.plan()
        if plan is not None and plan.perturbs_records():
            yield from self._rechunked_records()
            return
        yield from self._column_chunks()

    def _column_chunks(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        from ..datasets import rmat_edges

        produced = 0
        step = 0
        while self.limit is None or produced < self.limit:
            n = self.chunk
            if self.limit is not None:
                n = min(n, self.limit - produced)
            yield rmat_edges(n, self.scale, seed=self.seed + step)
            produced += n
            step += 1

    def _rechunked_records(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        buf_s: list = []
        buf_d: list = []
        for rec in _perturbed(self._records()):
            if rec is None:
                continue
            buf_s.append(rec[0])
            buf_d.append(rec[1])
            if len(buf_s) >= self.chunk:
                yield (np.asarray(buf_s, np.int64),
                       np.asarray(buf_d, np.int64))
                buf_s, buf_d = [], []
        if buf_s:
            yield np.asarray(buf_s, np.int64), np.asarray(buf_d, np.int64)

    def _records(self) -> Iterator[Tuple]:
        for src, dst in self._column_chunks():
            for s, d in zip(src.tolist(), dst.tolist()):
                yield (s, d, 0.0)

    # ------------------------------------------------------------------ #
    # Event time
    # ------------------------------------------------------------------ #
    def _records_ts(self) -> Iterator[Tuple]:
        ordinal = 0
        for src, dst in self._column_chunks():
            for s, d in zip(src.tolist(), dst.tolist()):
                yield (s, d, 0.0, self.ts_start + ordinal // self.ts_rate)
                ordinal += 1

    def iter_chunks_ts(
        self,
    ) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        """:meth:`iter_chunks` with the synthetic i64 ts column appended:
        ``(src, dst, ts)``. Requires ``ts_rate``. Under a fault plan with
        record perturbations the chunks re-assemble from the perturbed
        record path (any ts skew included)."""
        if self.ts_rate is None:
            raise RuntimeError(
                "iter_chunks_ts() requires GeneratorSource(ts_rate=...)"
            )
        plan = _faults.plan()
        if plan is not None and plan.perturbs_records():
            bs: list = []
            bd: list = []
            bt: list = []
            for rec in _perturbed(self._records_ts()):
                if rec is None:
                    continue
                bs.append(rec[0])
                bd.append(rec[1])
                bt.append(rec[3])
                if len(bs) >= self.chunk:
                    yield (np.asarray(bs, np.int64), np.asarray(bd, np.int64),
                           np.asarray(bt, np.int64))
                    bs, bd, bt = [], [], []
            if bs:
                yield (np.asarray(bs, np.int64), np.asarray(bd, np.int64),
                       np.asarray(bt, np.int64))
            return
        produced = 0
        for src, dst in self._column_chunks():
            n = len(src)
            ts = (self.ts_start
                  + (produced + np.arange(n, dtype=np.int64)) // self.ts_rate)
            produced += n
            yield src, dst, ts
