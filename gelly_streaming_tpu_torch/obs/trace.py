"""Structured, low-overhead pipeline tracing (the port's copy of
``gelly_streaming_tpu/obs/trace.py``).

``span("window.pack")`` wraps a stage; nested spans form a tree via a
thread-local stack (each pipeline thread: windower, prefetch producer,
serving worker, gets its own lineage). A finished span becomes ONE event
dict pushed to the attached sinks and one observation in the global
registry's ``trace.span_seconds{span=...}`` histogram, so span timing shows
up in the same snapshot/Prometheus surface as every other metric (and
``AutoK``'s span hint reads it there). Optionally
(``enable(torch_annotations=True)``) each span also opens a
``torch.profiler.record_function`` range, so host stages line up against
device kernels in a ``torch.profiler`` trace.

CROSS-PROCESS TRACES: a :class:`TraceContext` carries a trace id + a parent
span id across threads, futures, and the RPC wire. The query client mints
one per batch (``TraceContext()``), injects it into the frame body
(:meth:`TraceContext.to_wire`), and the serving path extracts it
(:meth:`TraceContext.from_wire`) and stamps every stage span with the trace
id, so one query's causal path across client, primary, and promoted standby
joins on ``trace`` in the merged shard event stream. Propagation is
EXPLICIT where threads change hands: the context is thread-local only for
same-thread nesting (:func:`activate`); code that hops threads (future
callbacks, the serving worker's drained entries) carries the context object
itself and emits via :func:`record_span`, which synthesizes a finished-span
event without touching any thread's span stack. Span ids are process-local
(the merged stream disambiguates by ``shard``); the trace id is the one
globally meaningful join key. The wire form is the reference's, so a trace
crosses between the two packages' clients and servers.

DISABLED COST IS THE DESIGN CONSTRAINT: ``span()`` with tracing off is one
attribute check returning a SHARED no-op singleton (no object, no dict, no
clock read). Hot sites that would pay even for building an attrs dict guard
on :func:`on` first.

Timing semantics: spans measure HOST wall time between ``__enter__`` and
``__exit__``. Around asynchronous CUDA work that is enqueue time, not
device time. A DEVICE span (``span(name, device=...)`` with a CUDA device)
also records a pair of ``torch.cuda.Event(enable_timing=True)`` on the
device's current stream, at enter and at exit, and later emits one more
event, ``<name>.device``: its ``dur_s`` is the stream's time from the
span's first device work to its last, on the card's clock. That is not
kernel time alone: it holds the stream's idle time between the span's
launches (a host read inside the span leaves the card idle until the next
launch) and any work other threads put on the same stream meanwhile (the
prefetch producer's encodes on the default stream). The pairs wait in a
bounded FIFO (:data:`DEVICE_PENDING_MAX`; an overflow drops the oldest and
counts it in ``trace.device_spans_dropped``) and are read without blocking,
once a window: :func:`window_done` polls the oldest with ``Event.query()``
(and so does a push into a full FIFO), so no span exit inside a window
pays for it. :func:`disable` waits for the rest and emits them; a pair
whose span exits after :func:`disable` is not kept. On the CPU a device
span is a host span.

ONE CLOCK: every span event carries ``t0_ns``, its start in Unix ns
(``time.time_ns()``), the clock ``torch.profiler`` stamps its host records with
in torch 2.x (Kineto's approximate clock converted to Unix time: a
record's ``start_ns()`` and a span's ``t0_ns`` compare directly). A device
start is put on it through one anchor a card: at :func:`enable` (or at the
first device span after it) the card is synchronized once, an event
recorded and ``time.time_ns()`` read beside it; a device time is then the
anchor's host reading plus the anchor event's ``elapsed_time`` to it (the
card's and the host's clocks drift apart by parts per million of the time
since the anchor). ``ts`` stays the end on ``time.time()``, which the
cluster merge orders by.

WINDOW LATENCY: the windowing code stamps each window's cut
(:func:`stamp`, on ``EdgeBlock.cut_ns``) when it has read the window's last
edge, and the workload calls :func:`window_done` once the window's fold is
enqueued; ``window.latency`` is then emitted with ``dur_s`` from the cut to
the fold's completion on the card (on the CPU: to the call).
"""

from __future__ import annotations

import collections
import itertools
import os
import sys
import threading
import time
from typing import Optional


class _Config:
    __slots__ = ("enabled", "annotate_torch", "registry_spans")

    def __init__(self):
        self.enabled = False
        self.annotate_torch = False
        self.registry_spans = True


_CFG = _Config()
_SINKS: list = []
_LOCAL = threading.local()
_IDS = itertools.count(1)

#: device records waiting to be read, at most this many: past it the
#: oldest is dropped and counted in ``trace.device_spans_dropped``
DEVICE_PENDING_MAX = 4096
_PENDING: collections.deque = collections.deque()
_PENDING_LOCK = threading.Lock()
#: CUDA device index -> (anchor event, ``time.time_ns()`` read beside it)
_ANCHORS: dict = {}


def stamp() -> Optional[int]:
    """The shared clock (``time.time_ns()``) while tracing is on, else None
    and no clock read: a window's cut."""
    return time.time_ns() if _CFG.enabled else None


def on() -> bool:
    """True when tracing is enabled (the hot-path guard)."""
    return _CFG.enabled


enabled = on  # alias; both read naturally at call sites


def enable(*, torch_annotations: bool = False,
           registry_spans: bool = True) -> None:
    """Turn span recording on.

    ``torch_annotations`` additionally opens a
    ``torch.profiler.record_function`` range per span (device-trace
    alignment). ``registry_spans`` mirrors span durations into the global
    registry's ``trace.span_seconds`` histogram (on by default: it is what
    makes span timing visible to the Prometheus/snapshot exporters and to
    ``AutoK``'s span hint).
    """
    _CFG.annotate_torch = bool(torch_annotations)
    _CFG.registry_spans = bool(registry_spans)
    torch = sys.modules.get("torch")
    if torch is not None and torch.cuda.is_initialized():
        _anchor(torch.cuda.current_device())
    _CFG.enabled = True


def disable() -> None:
    """Turn span recording off, after waiting for the device records still
    pending and emitting them."""
    _resolve(wait=True)
    _CFG.enabled = False
    _CFG.annotate_torch = False
    with _PENDING_LOCK:
        _PENDING.clear()  # pushed by another thread after the drain
    _ANCHORS.clear()


def add_sink(sink) -> None:
    """Attach a span-event sink (``sink.emit(event_dict)``)."""
    if sink not in _SINKS:
        _SINKS.append(sink)


def remove_sink(sink) -> None:
    if sink in _SINKS:
        _SINKS.remove(sink)


def sinks() -> list:
    return list(_SINKS)


# --------------------------------------------------------------------- #
# Trace context (cross-thread / cross-process propagation)
# --------------------------------------------------------------------- #
def new_trace_id() -> str:
    """A fresh 16-hex-char trace id (random, so ids minted by many
    client processes never collide — the property the merged cluster
    stream depends on; span SIDS stay per-process counters)."""
    return os.urandom(8).hex()


def next_sid() -> int:
    """Reserve one span id from the process counter — for call sites
    that must name a span's id BEFORE the span's event is emitted (the
    RPC client advertises its batch-root sid on the wire so server-side
    spans can parent to it)."""
    return next(_IDS)


class TraceContext:
    """One query batch's identity across threads and processes.

    ``trace_id`` is the global join key (minted once, client-side);
    ``parent_sid`` is the span id server/child spans parent to —
    typically the minting side's root span, whose id is reserved with
    :func:`next_sid` so it can travel before the root span finishes.

    The context is a plain carryable object: store it on a batch, a
    future, or a pending-queue entry and every hop keeps the trace —
    that explicit handoff is the design (thread-locals silently drop
    context at thread boundaries; queues and executors cross them
    constantly in the serving tier).
    """

    __slots__ = ("trace_id", "parent_sid")

    def __init__(self, trace_id: Optional[str] = None,
                 parent_sid: Optional[int] = None):
        self.trace_id = trace_id if trace_id else new_trace_id()
        self.parent_sid = parent_sid

    def __repr__(self) -> str:
        return f"TraceContext({self.trace_id!r}, {self.parent_sid!r})"

    # -- wire codec ---------------------------------------------------- #
    def to_wire(self) -> dict:
        """The compact frame-body form (``{"t": ..., "s": ...}``)."""
        doc = {"t": self.trace_id}
        if self.parent_sid is not None:
            doc["s"] = int(self.parent_sid)
        return doc

    @classmethod
    def from_wire(cls, doc) -> Optional["TraceContext"]:
        """Rebuild a context from a frame body. TOLERANT by contract:
        a missing/garbage ``tc`` field is an untraced batch, never a
        request error — tracing must not change the wire's accept set."""
        if not isinstance(doc, dict):
            return None
        tid = doc.get("t")
        if not isinstance(tid, str) or not tid:
            return None
        sid = doc.get("s")
        return cls(tid, int(sid) if isinstance(sid, int) else None)


def current_context() -> Optional[TraceContext]:
    """The context active on THIS thread (None outside any activation)."""
    return getattr(_LOCAL, "ctx", None)


class _Activation:
    """``with activate(ctx):`` — scoped thread-local context install."""

    __slots__ = ("ctx", "prev")

    def __init__(self, ctx: Optional[TraceContext]):
        self.ctx = ctx
        self.prev = None

    def __enter__(self) -> Optional[TraceContext]:
        self.prev = getattr(_LOCAL, "ctx", None)
        _LOCAL.ctx = self.ctx
        return self.ctx

    def __exit__(self, *exc) -> bool:
        _LOCAL.ctx = self.prev
        return False


def activate(ctx: Optional[TraceContext]) -> _Activation:
    """Install ``ctx`` as this thread's current context for the block:
    spans opened inside are stamped with its trace id (and root spans
    parent to its ``parent_sid``). This is the explicit cross-thread
    handoff — a worker thread activates the context it was HANDED, it
    never inherits one implicitly."""
    return _Activation(ctx)


def record_span(
    name: str,
    dur_s: float,
    *,
    trace_id: Optional[str] = None,
    parent: Optional[int] = None,
    sid: Optional[int] = None,
    attrs: Optional[dict] = None,
    ts: Optional[float] = None,
    t0_ns: Optional[int] = None,
) -> Optional[int]:
    """Emit one already-finished span event without entering the
    thread's span stack — the async/cross-thread form of ``span()``
    (future callbacks and drained-queue settles know their duration
    only after the fact, on a thread that never opened the span).
    ``ts`` is its end (default now), ``t0_ns`` its start on the shared
    clock (default ``ts`` less ``dur_s``).

    Returns the span's sid (pass ``sid=`` to emit under a pre-reserved
    id from :func:`next_sid`), or None when tracing is disabled — the
    disabled path is one flag check, nothing allocated."""
    if not _CFG.enabled:
        return None
    span_id = next(_IDS) if sid is None else int(sid)
    if ts is None:
        ts = time.time()
    event = {
        "kind": "span",
        "name": name,
        "ts": ts,
        "t0_ns": (round(ts * 1e9) - round(dur_s * 1e9)) if t0_ns is None else int(t0_ns),
        "dur_s": float(dur_s),
        "sid": span_id,
        "depth": 0,
    }
    if trace_id:
        event["trace"] = trace_id
    if parent is not None:
        event["parent"] = parent
    if attrs:
        event["attrs"] = attrs
    for s in _SINKS:
        s.emit(event)
    if _CFG.registry_spans:
        from .registry import get_registry

        get_registry().histogram(
            "trace.span_seconds", span=name
        ).observe(float(dur_s))
    return span_id


class _NoopSpan:
    """The disabled-mode singleton: every method is a no-op, entering
    returns the singleton itself. ``recording`` lets call sites skip
    building expensive attributes."""

    __slots__ = ()
    recording = False

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        return self


NOOP_SPAN = _NoopSpan()


class Span:
    """One recorded stage. Use via ``with span("pack", {...}):``."""

    __slots__ = ("name", "attrs", "sid", "parent", "depth", "t0",
                 "t0_ns", "dur_s", "_ann", "ctx", "_dev", "_ev0")
    recording = True

    def __init__(self, name: str, attrs: Optional[dict] = None,
                 device=None):
        self.name = name
        self.attrs = attrs
        self.sid = 0
        self.parent = None
        self.depth = 0
        self.t0 = 0.0
        self.t0_ns = 0
        self.dur_s = 0.0
        self._ann = None
        self.ctx = None
        self._dev = _cuda_index(device)  # a device span's card, else None
        self._ev0 = None

    def set(self, **attrs) -> "Span":
        """Attach attributes after entry (lets call sites add values
        computed inside the span without paying for them when tracing
        is off — guard on ``.recording``)."""
        if self.attrs is None:
            self.attrs = {}
        self.attrs.update(attrs)
        return self

    def __enter__(self) -> "Span":
        stack = getattr(_LOCAL, "stack", None)
        if stack is None:
            stack = _LOCAL.stack = []
        self.sid = next(_IDS)
        self.depth = len(stack)
        self.ctx = getattr(_LOCAL, "ctx", None)
        if stack:
            self.parent = stack[-1].sid
        elif self.ctx is not None:
            # a root span under an activated context parents to the
            # context's (possibly remote) span id — the cross-process
            # link the timeline joins on
            self.parent = self.ctx.parent_sid
        else:
            self.parent = None
        stack.append(self)
        if _CFG.annotate_torch:
            from torch.profiler import record_function

            self._ann = record_function(self.name)
            self._ann.__enter__()
        self.t0_ns = time.time_ns()
        if self._dev is not None and _CFG.enabled:
            _anchor(self._dev)
            self._ev0 = _record_event(self._dev)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        self.dur_s = time.perf_counter() - self.t0
        if self._ev0 is not None and _CFG.enabled:
            _push(_DeviceRecord(
                self.name + ".device", self._ev0, _record_event(self._dev),
                self._dev, None, self.sid,
                self.ctx.trace_id if self.ctx is not None else None, self.attrs,
            ))
        if self._ann is not None:
            self._ann.__exit__(*exc)
        stack = getattr(_LOCAL, "stack", None)
        if stack and stack[-1] is self:
            stack.pop()
        elif stack and self in stack:  # mis-nested exit: drop through it
            del stack[stack.index(self):]
        event = {
            "kind": "span",
            "name": self.name,
            "ts": time.time(),
            "t0_ns": self.t0_ns,
            "dur_s": self.dur_s,
            "sid": self.sid,
            "depth": self.depth,
        }
        if self.parent is not None:
            event["parent"] = self.parent
        if self.ctx is not None:
            event["trace"] = self.ctx.trace_id
        if self.attrs:
            event["attrs"] = self.attrs
        for s in _SINKS:
            s.emit(event)
        if _CFG.registry_spans:
            from .registry import get_registry

            get_registry().histogram(
                "trace.span_seconds", span=self.name
            ).observe(self.dur_s)
        return False


def span(name: str, attrs: Optional[dict] = None, *, device=None):
    """A context manager timing one named stage (no-op when disabled).

    ``attrs`` is an optional plain dict of span attributes (window
    index, superbatch K, block edges, ...). Truly hot call sites guard
    with :func:`on` before building the dict; everywhere else the dict
    literal's cost is negligible next to the stage it measures.

    ``device``: the ``torch.device`` the stage's work runs on. A CUDA
    device makes this a device span, which also emits ``<name>.device``
    with the stream time from its first device work to its last (see the
    module's timing semantics).
    """
    if not _CFG.enabled:
        return NOOP_SPAN
    return Span(name, attrs, device)


def window_done(cut_ns: Optional[int], device) -> None:
    """A window's fold has been enqueued on ``device``: emit
    ``window.latency`` from the window's cut ``cut_ns`` (:func:`stamp`) to
    the completion of the work enqueued so far on the device's current
    stream, both on the shared clock; on the CPU, to now (a block with no
    cut emits none). Then emit the device records that are complete: the
    one poll of the FIFO a window. Nothing happens while tracing is off."""
    if not _CFG.enabled:
        return
    index = _cuda_index(device)
    if cut_ns is not None:
        if index is None:
            record_span("window.latency", (time.time_ns() - cut_ns) / 1e9,
                        t0_ns=cut_ns)
        else:
            _anchor(index)
            _push(_DeviceRecord("window.latency", None, _record_event(index),
                                index, cut_ns, None, None, None))
    if _PENDING:
        _resolve()


# --------------------------------------------------------------------- #
# Device records: CUDA event pairs read without blocking
# --------------------------------------------------------------------- #
class _DeviceRecord:
    """One pending device record: a device span's pair of events (``start``
    set), or a window's fold-done event with its cut (``start`` None,
    ``t0_ns`` the cut). ``sid``/``trace``/``attrs`` are the host span's;
    ``anchor`` is card ``index``'s anchor when the record was made (None
    once :func:`disable` has cleared it)."""

    __slots__ = ("name", "start", "end", "index", "t0_ns", "sid", "trace",
                 "attrs", "anchor")

    def __init__(self, name, start, end, index, t0_ns, sid, trace, attrs):
        self.name = name
        self.start = start
        self.end = end
        self.index = index
        self.t0_ns = t0_ns
        self.sid = sid
        self.trace = trace
        self.attrs = attrs
        self.anchor = _ANCHORS.get(index)


def _cuda_index(device) -> Optional[int]:
    """The CUDA device index of a ``torch.device``; None for any other."""
    if getattr(device, "type", None) != "cuda":
        return None
    if device.index is not None:
        return device.index
    import torch

    return torch.cuda.current_device()


def _record_event(index: int):
    """A timing event recorded on card ``index``'s current stream."""
    import torch

    ev = torch.cuda.Event(enable_timing=True)
    ev.record(torch.cuda.current_stream(index))
    return ev


def _anchor(index: int) -> tuple:
    """Card ``index``'s anchor, made once per :func:`enable`: synchronize,
    record an event on the idle card, read ``time.time_ns()`` beside it."""
    a = _ANCHORS.get(index)
    if a is None:
        import torch

        torch.cuda.synchronize(index)
        ev = _record_event(index)
        a = _ANCHORS[index] = (ev, time.time_ns())
        ev.synchronize()  # complete, so that any later event times against it
    return a


def _push(rec: _DeviceRecord) -> None:
    """Queue a device record; a full FIFO first emits what is complete
    (for a path with no :func:`window_done`), then drops its oldest,
    counted."""
    if len(_PENDING) >= DEVICE_PENDING_MAX:
        _resolve()
    with _PENDING_LOCK:
        dropped = len(_PENDING) >= DEVICE_PENDING_MAX
        if dropped:
            _PENDING.popleft()
        _PENDING.append(rec)
    if dropped:
        from .registry import get_registry

        get_registry().counter("trace.device_spans_dropped").inc()


def _resolve(wait: bool = False) -> None:
    """Emit the pending device records that are complete, oldest first,
    stopping at the first that is not; ``wait`` (only :func:`disable`)
    waits for each instead."""
    with _PENDING_LOCK:
        while _PENDING:
            rec = _PENDING[0]
            if not rec.end.query():
                if not wait:
                    return
                rec.end.synchronize()
            _PENDING.popleft()
            _emit_device(rec)


def _emit_device(rec: _DeviceRecord) -> None:
    """One complete device record as a span event on the shared clock;
    none for a record made against an anchor that is gone (pushed by a span
    that :func:`disable` overtook)."""
    if rec.anchor is None or _ANCHORS.get(rec.index) is not rec.anchor:
        return
    anchor, host_ns = rec.anchor
    end_ns = host_ns + round(anchor.elapsed_time(rec.end) * 1e6)
    if rec.start is None:
        t0_ns, dur_s = rec.t0_ns, (end_ns - rec.t0_ns) / 1e9
    else:
        t0_ns = host_ns + round(anchor.elapsed_time(rec.start) * 1e6)
        dur_s = rec.start.elapsed_time(rec.end) / 1e3
    record_span(rec.name, dur_s, trace_id=rec.trace, parent=rec.sid,
                attrs=rec.attrs, ts=end_ns / 1e9, t0_ns=t0_ns)


def current_span() -> Optional[Span]:
    """The innermost open span on this thread (None outside any span)."""
    stack = getattr(_LOCAL, "stack", None)
    return stack[-1] if stack else None
