"""Self-tuning control plane of the port: the retune signals
(:mod:`.signals`) and the knob tuners that consume them
(:mod:`.controller`: :class:`AutoK`, :class:`PrefetchTuner`,
:class:`AdmissionTuner`, bundled by :class:`ControlPlane`)."""

from .controller import (
    AdmissionTuner,
    AutoK,
    ControlPlane,
    PrefetchTuner,
    default_plane,
    log_retune,
)
from .signals import SignalReader, add_excluded_s, take_excluded_s

__all__ = [
    "AdmissionTuner",
    "AutoK",
    "ControlPlane",
    "PrefetchTuner",
    "SignalReader",
    "add_excluded_s",
    "default_plane",
    "log_retune",
    "take_excluded_s",
]
