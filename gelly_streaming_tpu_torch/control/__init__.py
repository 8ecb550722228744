"""Control plane of the port: the retune signals (the controllers of
``gelly_streaming_tpu/control/`` come with ROADMAP Queue 1, slice 7b)."""

from .signals import SignalReader, add_excluded_s, take_excluded_s

__all__ = ["SignalReader", "add_excluded_s", "take_excluded_s"]
