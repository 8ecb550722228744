"""Supervised recovery: restart a checkpointed pipeline until it finishes
(the port's copy of ``gelly_streaming_tpu/resilience/supervisor.py``).

Flink's runtime pairs its checkpoint coordinator with a RESTART
strategy — a failed job restores the last barrier and replays, with the
restart budget and backoff as first-class configuration. The repo's
``AutoCheckpoint`` (``aggregate/autockpt.py``) covers
the barrier/restore half; this module adds the supervision half:

- :meth:`Supervisor.run` drives ``AutoCheckpoint.run(make_stream, work)``
  and, on failure, CLASSIFIES the exception (transient environment
  fault vs. poison window vs. fatal), restores from the newest valid
  barrier, and retries under bounded exponential backoff with
  deterministic jitter.
- Replayed windows that were already emitted before the failure are
  DEDUPLICATED: the consumer sees each window ordinal exactly once per
  process, in order. (Replay is value-identical by the checkpoint
  contract — the tests assert it — so suppression loses
  nothing; across a real process kill the at-least-once contract of the
  module doc in ``autockpt.py`` still applies.)
- A window that keeps failing across ``poison_limit`` consecutive
  restores is declared :class:`~.errors.PoisonWindowError` instead of
  burning the whole restart budget on data that will never fold.

Recovery telemetry flows into the obs registry:
``resilience.restarts{kind=...}``, ``resilience.deduped_windows``,
``resilience.backoff_s``, ``resilience.poison_windows``, and a
``resilience.recovery_seconds`` histogram (failure to first
post-restart emission).

Pass ``work`` as a ZERO-ARG FACTORY when possible: a freshly built
workload plus barrier restore is guaranteed clean, whereas reusing one
object relies on its ``restore_state``/``load_state_dict`` fully
overwriting mid-window wreckage (true for the repo's aggregations, but
the factory needs no such audit). A non-callable ``work`` is deep-copied
once up front so a failure BEFORE the first barrier can still restart
from pristine state.
"""

from __future__ import annotations

import copy
import time
from typing import Any, Callable, Iterator, Optional

from ..obs import flight as _flight
from ..obs.registry import get_registry
from .errors import (
    DeviceUnavailable,
    InjectedFault,
    PoisonWindowError,
    RestartBudgetExceeded,
    StallError,
    TransientSourceError,
)
from .retry import exp_backoff, jittered


class Supervisor:
    """Run a checkpointed workload to completion through failures.

    Parameters
    ----------
    checkpoint:
        An ``AutoCheckpoint`` (``aggregate/autockpt.py``)
        or a path (one is constructed with default cadence).
    max_restarts:
        Total restart budget across the run; exceeding it raises
        :class:`~.errors.RestartBudgetExceeded` chaining the last error.
    poison_limit:
        Consecutive failures AT THE SAME window ordinal (for
        window-classified errors) before
        :class:`~.errors.PoisonWindowError` is raised.
    backoff_base_s / backoff_max_s / jitter / seed:
        Bounded exponential backoff between restarts, deterministic in
        ``seed`` (see ``resilience/retry.py``).
    classify:
        Optional ``exc -> "transient" | "window" | "fatal"`` override.
    sleep:
        Injection point for tests (defaults to ``time.sleep``).
    """

    #: never caught: the process is coming down, the consumer closed us,
    #: or the device the run asks for is absent
    FATAL = (KeyboardInterrupt, SystemExit, GeneratorExit, MemoryError,
             DeviceUnavailable)

    #: environment faults: restart is expected to succeed, so repeated
    #: hits at one ordinal spend restart budget, not poison count
    TRANSIENT = (
        TransientSourceError,
        StallError,
        InjectedFault,
        ConnectionError,
        TimeoutError,
    )

    def __init__(
        self,
        checkpoint,
        *,
        max_restarts: int = 8,
        poison_limit: int = 3,
        backoff_base_s: float = 0.05,
        backoff_max_s: float = 2.0,
        jitter: float = 0.5,
        seed: int = 0,
        classify: Optional[Callable[[BaseException], str]] = None,
        sleep: Callable[[float], None] = time.sleep,
    ):
        if isinstance(checkpoint, str):
            from ..aggregate.autockpt import AutoCheckpoint

            checkpoint = AutoCheckpoint(checkpoint)
        self.ckpt = checkpoint
        self.max_restarts = int(max_restarts)
        self.poison_limit = int(poison_limit)
        self.backoff_base_s = float(backoff_base_s)
        self.backoff_max_s = float(backoff_max_s)
        self.jitter = float(jitter)
        self.seed = int(seed)
        self._classify = classify or self.default_classify
        self._sleep = sleep
        #: restarts performed by the most recent :meth:`run`
        self.restarts = 0

    # ------------------------------------------------------------------ #
    @classmethod
    def default_classify(cls, e: BaseException) -> str:
        if isinstance(e, cls.FATAL):
            return "fatal"
        if isinstance(e, cls.TRANSIENT):
            return "transient"
        return "window"

    # ------------------------------------------------------------------ #
    def run(self, make_stream: Callable, work) -> Iterator[Any]:
        """Yield the workload's per-window emissions exactly as an
        uninterrupted ``AutoCheckpoint.run`` would, surviving restarts.

        ``make_stream(vdict)`` must rebuild the stream over the SAME
        source each attempt (the ``AutoCheckpoint.run`` contract);
        ``work`` is a workload/aggregation or a zero-arg factory for
        one (preferred — see module doc).
        """
        factory = work if callable(work) else None
        pristine = None if factory is not None else copy.deepcopy(work)
        current = factory() if factory is not None else work
        reg = get_registry()
        self.restarts = 0
        emitted = 0          # next ordinal the consumer has NOT seen
        fail_ordinal = None  # poison tracking
        fail_count = 0
        t_fail = None        # set at failure, cleared on first emission
        while True:
            # re-scan the disk on every attempt: between a failure and
            # its restart the barrier set may have changed under us (a
            # coordinated peer committed or tore an epoch, the chaos
            # harness corrupted the head) — restarting from a cached
            # pre-failure payload could silently resurrect damage or,
            # in the multi-host layout, restore a different epoch than
            # the peers agree on
            inv = getattr(self.ckpt, "invalidate", None)
            if inv is not None:
                inv()
            done = self.ckpt.windows_done()
            ordinal = done
            try:
                for em in self.ckpt.run(make_stream, current):
                    if ordinal >= emitted:
                        if t_fail is not None:
                            reg.histogram(
                                "resilience.recovery_seconds"
                            ).observe(time.perf_counter() - t_fail)
                            t_fail = None
                        yield em
                        emitted = ordinal + 1
                    else:
                        # replayed pre-failure window: value-identical
                        # by the checkpoint contract, suppressed so the
                        # consumer sees each ordinal once
                        reg.counter("resilience.deduped_windows").inc()
                    ordinal += 1
                return
            except self.FATAL:
                raise
            except BaseException as e:
                kind = self._classify(e)
                # every failure commits the black box BEFORE any
                # restart decision: the ring holds the events that led
                # here, and the dump path rides the failure report
                # (PoisonWindowError / RestartBudgetExceeded) so a
                # post-mortem starts from telemetry, not from grep
                dump_path = _flight.dump_installed(
                    f"supervisor:{kind}",
                    ordinal=ordinal,
                    error=repr(e)[:200],
                )
                if dump_path is not None:
                    reg.counter("resilience.flight_dumps").inc()
                if kind == "fatal":
                    raise
                # poison counting tracks WINDOW-classified failures
                # only: transient flaps at the same ordinal (a source
                # down across several restarts) spend restart budget,
                # never poison count — mixing them would condemn a
                # window for its environment's sins
                if kind == "window":
                    if ordinal == fail_ordinal:
                        fail_count += 1
                    else:
                        fail_ordinal, fail_count = ordinal, 1
                    if fail_count >= self.poison_limit:
                        reg.counter("resilience.poison_windows").inc()
                        raise PoisonWindowError(ordinal, fail_count) from e
                if self.restarts >= self.max_restarts:
                    raise RestartBudgetExceeded(
                        f"{self.restarts} restarts exhausted at window "
                        f"{ordinal} ({kind}: {e!r})"
                        + (f"; flight dump: {dump_path}"
                           if dump_path else "")
                    ) from e
                attempt = self.restarts
                self.restarts += 1
                reg.counter("resilience.restarts", kind=kind).inc()
                delay = jittered(
                    exp_backoff(
                        attempt, self.backoff_base_s, self.backoff_max_s
                    ),
                    self.jitter, self.seed, attempt,
                )
                reg.counter("resilience.backoff_s").inc(delay)
                t_fail = time.perf_counter()
                if delay > 0:
                    self._sleep(delay)
                current = self._fresh_work(factory, pristine, current)

    # ------------------------------------------------------------------ #
    def _fresh_work(self, factory, pristine, current):
        if factory is not None:
            return factory()
        # decide from the disk's CURRENT barrier state, not the attempt's
        # cached payload: if every barrier was destroyed between the
        # failure and this restart, the next attempt restores nothing —
        # reusing the mutated object then would run mid-window wreckage
        # as if it were pristine state
        inv = getattr(self.ckpt, "invalidate", None)
        if inv is not None:
            inv()
        if self.ckpt.windows_done() > 0:
            # the barrier restore inside AutoCheckpoint.run overwrites
            # the carried state wholesale (restore_state /
            # load_state_dict), so the mutated object is safe to reuse
            return current
        return copy.deepcopy(pristine)
