"""Host/device overlap: background block prefetch (PyTorch port).

The counterpart of ``gelly_streaming_tpu/core/pipeline.py``. While the
device computes window N, the host should already be parsing, windowing
and uploading window N+1. :func:`prefetch` runs any block (or group)
iterator on a daemon thread with a small bounded queue.

Usage::

    for comps in agg.run(stream.prefetched()):   # or prefetch(iterator)
        ...

Exceptions raised by the producer are re-raised at the consumer's next
pull, after the items already queued drain.

PyTorch keeps the current CUDA device per thread, so the producer thread
is pinned to the stream's device (``device=``): otherwise what it
uploads without an explicit index would land on card 0.

An installed ``FaultPlan`` (``resilience/faults.py``) is consulted at
each item the consumer takes (site ``pipeline.item``, index = the item's
ordinal): the in-process kill the ``Supervisor`` recovers from.

``tuner=`` (a :class:`~gelly_streaming_tpu_torch.control.PrefetchTuner`)
makes the depth adaptive: the queue is allocated at the tuner's
``depth_max`` and the producer honours its live ``depth``.
"""

from __future__ import annotations

import contextlib
import queue
import threading
import time
import warnings
from typing import Any, Iterator, Optional, TypeVar

import torch

from ..obs import trace as _trace
from ..obs.registry import get_registry
from ..resilience import faults as _faults
from ..resilience.errors import StallError

T = TypeVar("T")

_SENTINEL = object()


def superbatch_prefetch_depth(superbatch: int, base: int = 2) -> int:
    """Prefetch depth matched to a superbatch of K windows: a full group
    plus one window (``K + 1``), so the host assembles group N+1 while
    the device folds group N."""
    return max(int(base), int(superbatch) + 1)


def bounded_put(q: "queue.Queue", item: Any, stop: threading.Event, *,
                timeout: float = 0.1,
                on_wait: Optional[Any] = None,
                on_done: Optional[Any] = None) -> bool:
    """Put ``item`` on a bounded queue, polling ``stop`` between attempts:
    a FULL queue blocks the producer right here (backpressure).

    ``on_wait(waited_s)`` fires after each full-queue timeout slice with
    the cumulative wait; ``on_done(waited_s)`` once after a successful
    put. Returns False when ``stop`` was set before the item could be
    enqueued (the consumer is gone)."""
    waited = 0.0
    while not stop.is_set():
        try:
            q.put(item, timeout=timeout)
        except queue.Full:
            waited += timeout
            if on_wait is not None:
                on_wait(waited)
            continue
        if on_done is not None:
            on_done(waited)
        return True
    return False


def _on_device(device) -> contextlib.AbstractContextManager:
    """Make ``device`` the calling thread's current CUDA device (a no-op
    for the CPU or no device)."""
    if device is not None and torch.device(device).type == "cuda":
        return torch.cuda.device(torch.device(device))
    return contextlib.nullcontext()


def prefetch(iterator: Iterator[T], depth: int = 2,
             name: str = "pipeline", *,
             device=None,
             stall_timeout_s: Optional[float] = None,
             join_timeout_s: float = 10.0,
             tuner=None) -> Iterator[T]:
    """Iterate ``iterator`` on a background thread, ``depth`` items ahead.

    ``device`` is the stream's device; the producer thread runs with it
    as its current CUDA device.

    If the consumer abandons the generator early (break, exception,
    garbage collection), the producer notices the stop flag and exits
    instead of blocking forever on the bounded queue, and the source
    iterator is closed. A producer that does not exit within
    ``join_timeout_s`` is reported: a warning, and
    ``<name>.producer_leaked`` in the obs registry.

    ``stall_timeout_s`` arms a consumer-side watchdog: a queue that stays
    empty that long raises :class:`StallError` (``<name>.stalls`` counts
    it). The first item is exempt: its gap includes the first window's
    set-up.

    With tracing on (``obs.trace.enable()``) the coupling is measured into
    the registry: ``<name>.queue_depth`` (items ready at each pull),
    ``<name>.producer_blocked_s`` (host blocked on a full queue: the
    device side is the bottleneck) and ``<name>.consumer_idle_s``
    (consumer blocked on an empty queue: the host side is).

    ``tuner`` (a :class:`~gelly_streaming_tpu_torch.control.PrefetchTuner`)
    makes the depth ADAPTIVE: the queue is allocated at the tuner's
    ``depth_max`` and the producer honours the tuner's live ``depth`` as a
    soft cap, while both sides tap their blocked and idle seconds into the
    tuner, which moves the depth with hysteresis and bounded steps. A tuner
    costs one clock read per item on each side, whatever the obs flag;
    ``depth`` is then ignored."""
    soft_cap = tuner
    maxsize = max(1, depth) if tuner is None else max(1, tuner.depth_max)
    q: "queue.Queue[Any]" = queue.Queue(maxsize=maxsize)
    # the soft cap's wake-up channel: the consumer notifies after every
    # pull, so a producer waiting at the cap blocks on a condition
    space = threading.Condition() if soft_cap is not None else None
    error: list = []
    stop = threading.Event()
    inst: list = [None]

    def _instruments():
        if inst[0] is None:
            reg = get_registry()
            inst[0] = (
                reg.gauge(name + ".queue_depth"),
                reg.counter(name + ".producer_blocked_s"),
                reg.counter(name + ".consumer_idle_s"),
            )
        return inst[0]

    def _put(item) -> bool:
        obs = _trace.on()
        measured = obs or soft_cap is not None
        t0 = time.perf_counter() if measured else 0.0
        if soft_cap is not None:
            # soft depth cap: the tuner's live depth bounds how far the
            # producer runs ahead while the queue stays allocated at
            # depth_max. A condition wait, not a semaphore: the cap moves
            # between puts; the timeout slice covers stop and retune races
            with space:
                while q.qsize() >= soft_cap.depth:
                    if stop.is_set():
                        return False
                    space.wait(0.05)

        def done(_waited):
            if measured:
                dt = time.perf_counter() - t0
                if soft_cap is not None:
                    soft_cap.tap_put(dt if dt > 1e-4 else 0.0)
                if obs and dt > 1e-4:  # count real blocking, not put cost
                    _instruments()[1].inc(dt)

        return bounded_put(q, item, stop, on_done=done)

    def produce():
        try:
            with _on_device(device):
                for item in iterator:
                    if not _put(item):
                        break
        except BaseException as e:  # re-raised consumer-side
            error.append(e)
        finally:
            if stop.is_set():
                close = getattr(iterator, "close", None)
                if close is not None:
                    try:
                        close()
                    except Exception:
                        # abandoned-consumer teardown must not displace
                        # the consumer's own exit; count it instead
                        get_registry().counter(
                            name + ".swallowed", site="iterator_close"
                        ).inc()
            _put(_SENTINEL)

    def _blocking_get():
        if stall_timeout_s is None or n == 0:
            return q.get()
        try:
            return q.get(timeout=stall_timeout_s)
        except queue.Empty:
            get_registry().counter(name + ".stalls").inc()
            raise StallError(
                f"{name}: no item for {stall_timeout_s}s with the producer "
                "thread " + ("alive" if t.is_alive() else "gone")
            ) from None

    t = threading.Thread(target=produce, daemon=True)
    t.start()
    n = 0
    try:
        while True:
            obs = _trace.on()
            if obs or soft_cap is not None:
                if obs:
                    depth_g, _pw, cw = _instruments()
                    depth_g.set(q.qsize())
                t0 = time.perf_counter()
                item = _blocking_get()
                dt = time.perf_counter() - t0
                if soft_cap is not None:
                    # wake a producer waiting at the soft cap: a slot opened
                    with space:
                        space.notify()
                    soft_cap.tap_get(dt if dt > 1e-4 else 0.0)
                if obs and dt > 1e-4:  # real starvation, not get cost
                    cw.inc(dt)
            else:
                item = _blocking_get()
            if item is _SENTINEL:
                if error:
                    raise error[0]
                return
            if _faults.active():  # chaos hook: kill/stall at item n
                _faults.fire("pipeline.item", index=n)
            n += 1
            yield item
    finally:
        stop.set()
        # let the producer leave its current item: a daemon thread killed
        # at interpreter teardown in the middle of a device operation
        # aborts the process
        t.join(timeout=join_timeout_s)
        if t.is_alive():
            get_registry().counter(name + ".producer_leaked").inc()
            warnings.warn(
                f"{name}: prefetch producer thread did not exit within "
                f"{join_timeout_s}s of consumer shutdown; thread (and its "
                "source iterator) leaked",
                RuntimeWarning,
                stacklevel=2,
            )
