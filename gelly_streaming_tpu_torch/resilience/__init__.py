"""Resilience layer of the port (the counterpart of
``gelly_streaming_tpu/resilience/``): checkpoint integrity, supervised
recovery and deterministic fault injection.

- ``integrity`` — content checksums + atomic multi-file commit for
  checkpoint artifacts; every rejected artifact is visible as
  ``resilience.ckpt_rejected`` in the obs registry.
- ``supervisor`` (+ ``retry``, ``errors``) — restart a checkpointed
  pipeline from the newest valid barrier under bounded exponential
  backoff, classify failures (transient / poison window / fatal), and
  deduplicate replayed emissions.
- ``faults`` — a seeded deterministic :class:`FaultPlan` behind test-only
  hook points (pipeline, sources, checkpoints).

The distributed half (coordinated epoch barriers and the cluster
supervisor) comes with ROADMAP Queue 1, slice 7b (ingest);
the chaos sweep and the serving tier's retry and shed with slice 9.

Telemetry rides the obs registry: ``resilience.restarts{kind=...}``,
``resilience.ckpt_rejected``, ``resilience.recovery_seconds``,
``resilience.deduped_windows``, ``resilience.fault_injected{site=...}``,
``pipeline.producer_leaked``, ``pipeline.stalls``,
``source.malformed_lines``, ``source.reconnects``.
"""

from . import faults
from .errors import (
    CheckpointCorrupt,
    DeadlineExceeded,
    DeviceUnavailable,
    InjectedFault,
    PoisonWindowError,
    RestartBudgetExceeded,
    SimulatedCrash,
    StallError,
    TransientSourceError,
)
from .faults import FaultPlan
from .retry import RetryPolicy, exp_backoff, jittered
from .supervisor import Supervisor

__all__ = [
    "CheckpointCorrupt",
    "DeadlineExceeded",
    "DeviceUnavailable",
    "FaultPlan",
    "InjectedFault",
    "PoisonWindowError",
    "RestartBudgetExceeded",
    "RetryPolicy",
    "SimulatedCrash",
    "StallError",
    "Supervisor",
    "TransientSourceError",
    "exp_backoff",
    "faults",
    "jittered",
]
