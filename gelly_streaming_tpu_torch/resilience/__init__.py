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
- ``coordinated`` — the distributed half: per-shard epoch barriers
  aligned across processes with a restore-side rendezvous (the newest
  epoch valid across ALL shards; mixed-epoch restores impossible by
  construction) and :class:`ClusterSupervisor` restart-all process
  supervision. ``chaos.run_mp_sweep`` kills one worker of N at every
  window ordinal and demands oracle-identical recovery with
  byte-identical vertex dictionaries; its workers run their CC on the
  card unless told ``device="cpu"``.

``chaos.run_sweep`` is the single-process kill sweep; the serving
scenarios (``failover_main``, ``run_rpc_scenario``) kill a serving worker
or a whole serving binary under live query traffic; the sharded and storm
scenarios (``run_sharded_scenario``, ``run_storm_scenario``) put the
routing tier in front of shard replicas and kill, promote and split under
load. Every replica runs its tables on the card unless told
``device="cpu"``; the routers never touch it.

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

#: the coordinated layer's names, loaded on first use: ``coordinated``
#: builds on ``aggregate.autockpt``, whose imports reach ``core.device``,
#: which imports this package's ``errors`` (an eager import would cycle)
_COORDINATED = ("ClusterError", "ClusterSupervisor", "CoordinatedCheckpoint",
                "select_epoch")


def __getattr__(name: str):
    if name in _COORDINATED:
        from . import coordinated

        return getattr(coordinated, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "CheckpointCorrupt",
    "ClusterError",
    "ClusterSupervisor",
    "CoordinatedCheckpoint",
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
    "select_epoch",
]
