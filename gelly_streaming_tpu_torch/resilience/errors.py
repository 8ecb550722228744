"""Resilience-layer exception taxonomy (the port's copy of
``gelly_streaming_tpu/resilience/errors.py``; the supervisor and the fault
plan it names come with ROADMAP Queue 1, slice 7).

One small module so every other layer (checkpointing, pipeline, sources,
serving, supervision) can share failure types without import cycles:
nothing here imports anything from the repo.

The taxonomy mirrors what the supervisor classifies
(``resilience/supervisor.py``):

- **transient** — the environment hiccupped (source disconnect, stalled
  prefetch, injected crash); restarting from the last barrier is
  expected to succeed. :class:`TransientSourceError`, :class:`StallError`,
  :class:`InjectedFault`.
- **poison** — the same window keeps failing across restarts: the DATA
  (or a bug it tickles) is at fault, and retrying forever would loop.
  :class:`PoisonWindowError`.
- **fatal** — the process must not continue (interpreter shutdown,
  memory exhaustion) or the recovery budget is spent
  (:class:`RestartBudgetExceeded`).

:class:`CheckpointCorrupt` marks an artifact that failed integrity
validation (checksum, leaf count, structure) — raised at LOAD time so a
torn snapshot can never be silently restored into live state.
"""

from __future__ import annotations


class CheckpointCorrupt(ValueError):
    """A checkpoint artifact failed integrity validation (truncated file,
    checksum mismatch, leaf count disagreeing with its sidecar). Subclass
    of ``ValueError`` so pre-existing ``load_pytree`` rejection handling
    keeps working."""


class TransientSourceError(ConnectionError):
    """A live source gave up after its own bounded reconnect budget; the
    supervisor may restart the whole pipeline (which re-builds the
    source) with backoff."""


class StallError(RuntimeError):
    """A watchdog fired: a pipeline stage stopped making progress (the
    prefetch queue stayed empty past ``stall_timeout_s`` with the
    producer still alive, i.e. wedged rather than slow)."""


class PoisonWindowError(RuntimeError):
    """The same window ordinal failed ``poison_limit`` consecutive
    recovery attempts — the failure deterministically follows the data,
    so restarting again would loop forever. Carries ``ordinal``; the
    triggering exception chains via ``__cause__``."""

    def __init__(self, ordinal: int, attempts: int):
        super().__init__(
            f"window {ordinal} failed {attempts} consecutive recovery "
            "attempts; classifying as poison (not restarting again)"
        )
        self.ordinal = int(ordinal)
        self.attempts = int(attempts)


class RestartBudgetExceeded(RuntimeError):
    """The supervisor's ``max_restarts`` budget is spent; the last
    failure chains via ``__cause__``."""


class InjectedFault(RuntimeError):
    """Base class for failures raised by the deterministic fault plan
    (``resilience/faults.py``). Test-only traffic;
    classified as transient by the default supervisor policy."""


class SimulatedCrash(InjectedFault):
    """An in-process stand-in for a process kill: raised by the fault
    plan's kill point so a single test process can exercise the
    crash/restore loop without forking."""


class DeadlineExceeded(TimeoutError):
    """A served query's per-query deadline expired before the worker
    answered it (the query was admitted, then shed at answer time)."""
