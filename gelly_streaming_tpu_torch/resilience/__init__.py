"""Failure types of the port (resilience layer)."""

from .errors import (
    CheckpointCorrupt,
    DeadlineExceeded,
    InjectedFault,
    PoisonWindowError,
    RestartBudgetExceeded,
    SimulatedCrash,
    StallError,
    TransientSourceError,
)

__all__ = [
    "CheckpointCorrupt",
    "DeadlineExceeded",
    "InjectedFault",
    "PoisonWindowError",
    "RestartBudgetExceeded",
    "SimulatedCrash",
    "StallError",
    "TransientSourceError",
]
