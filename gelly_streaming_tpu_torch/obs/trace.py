"""Lightweight structured spans over the pipeline's host-side stages.

The counterpart of ``gelly_streaming_tpu/obs/trace.py``, as far as the
windowing path uses it. ``span("window.pack")`` wraps a stage; nested
spans form a tree via a thread-local stack. A finished span becomes ONE
event dict pushed to the attached sinks. Optionally
(``enable(torch_annotations=True)``) each span also opens a
``torch.profiler.record_function`` range, so host stages line up against
device kernels in a ``torch.profiler`` trace.

The registry mirror (``trace.span_seconds``) and the cross-process
:class:`TraceContext` of the reference module come with the serving slice
(ROADMAP Queue 1, slice 9).

DISABLED COST IS THE DESIGN CONSTRAINT: ``span()`` with tracing off is one
attribute check returning a SHARED no-op singleton. Hot sites that would
pay even for building an attrs dict guard on :func:`on` first.

Timing semantics: spans measure HOST wall time between ``__enter__`` and
``__exit__``. Around asynchronous CUDA work that is enqueue time, not
device time.
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import Optional


class _Config:
    __slots__ = ("enabled", "annotate_torch")

    def __init__(self):
        self.enabled = False
        self.annotate_torch = False


_CFG = _Config()
_SINKS: list = []
_LOCAL = threading.local()
_IDS = itertools.count(1)


def on() -> bool:
    """True when tracing is enabled (the hot-path guard)."""
    return _CFG.enabled


def enable(*, torch_annotations: bool = False) -> None:
    """Turn span recording on. ``torch_annotations`` additionally opens a
    ``torch.profiler.record_function`` range per span."""
    _CFG.annotate_torch = bool(torch_annotations)
    _CFG.enabled = True


def disable() -> None:
    _CFG.enabled = False
    _CFG.annotate_torch = False


def add_sink(sink) -> None:
    """Attach a span-event sink (``sink.emit(event_dict)``)."""
    if sink not in _SINKS:
        _SINKS.append(sink)


def remove_sink(sink) -> None:
    if sink in _SINKS:
        _SINKS.remove(sink)


class _NoopSpan:
    """The disabled-mode singleton: every method is a no-op."""

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

    __slots__ = ("name", "attrs", "sid", "parent", "depth", "t0", "dur_s",
                 "_ann")
    recording = True

    def __init__(self, name: str, attrs: Optional[dict] = None):
        self.name = name
        self.attrs = attrs
        self.sid = 0
        self.parent = None
        self.depth = 0
        self.t0 = 0.0
        self.dur_s = 0.0
        self._ann = None

    def set(self, **attrs) -> "Span":
        """Attach attributes after entry (values computed inside the span;
        call sites guard on ``.recording``)."""
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
        self.parent = stack[-1].sid if stack else None
        stack.append(self)
        if _CFG.annotate_torch:
            from torch.profiler import record_function

            self._ann = record_function(self.name)
            self._ann.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        self.dur_s = time.perf_counter() - self.t0
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
            "dur_s": self.dur_s,
            "sid": self.sid,
            "depth": self.depth,
        }
        if self.parent is not None:
            event["parent"] = self.parent
        if self.attrs:
            event["attrs"] = self.attrs
        for s in _SINKS:
            s.emit(event)
        return False


def span(name: str, attrs: Optional[dict] = None):
    """A context manager timing one named stage (no-op when disabled)."""
    if not _CFG.enabled:
        return NOOP_SPAN
    return Span(name, attrs)
