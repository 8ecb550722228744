"""Cluster transport fabric: one exchange interface, its backends (the
port's copy of ``gelly_streaming_tpu/fabric/``; host code only).

See :mod:`~gelly_streaming_tpu_torch.fabric.base` for the contract. The
public surface:

- :class:`Transport` / :class:`TagStat` / :class:`TransportUnsupported`
  — the interface;
- :class:`SharedDirTransport` — tag = file under a shared directory
  (the JAX package's layout, byte for byte);
- :class:`SocketTransport` / :class:`ExchangeDaemon` — GSRP frames
  against a tiny stdlib exchange daemon;
- :class:`CollectiveTransport` — the group primitives over a
  multi-device runtime; constructing it raises until ROADMAP Queue 1,
  slice 6 (multiple devices);
- :class:`ElectedK` — the cadence-agreement adapter riding
  ``Transport.elect``;
- :func:`as_transport` — the string-coercion seam: a bare string becomes
  a shared-dir transport.

``python -m gelly_streaming_tpu_torch.fabric --smoke`` runs the 2-process
smoke over the shared-dir and socket backends; ``--daemon`` runs the
exchange daemon in the foreground.
"""

from __future__ import annotations

from .agreement import ElectedK
from .base import TagStat, Transport, TransportUnsupported
from .collective import CollectiveTransport
from .exchange import ExchangeDaemon, SocketTransport
from .shared_dir import SharedDirTransport

__all__ = [
    "CollectiveTransport",
    "ElectedK",
    "ExchangeDaemon",
    "SharedDirTransport",
    "SocketTransport",
    "TagStat",
    "Transport",
    "TransportUnsupported",
    "as_transport",
]


def as_transport(obj, **kwargs) -> Transport:
    """Coerce a consumer's ``transport`` argument: a :class:`Transport`
    passes through; a string is a shared directory."""
    if isinstance(obj, Transport):
        return obj
    if isinstance(obj, (str, bytes)) or hasattr(obj, "__fspath__"):
        return SharedDirTransport(str(obj), **kwargs)
    raise TypeError(
        f"expected a Transport or a shared-directory path, "
        f"got {type(obj).__name__}")
