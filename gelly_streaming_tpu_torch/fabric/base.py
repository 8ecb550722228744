"""The ``Transport`` contract: one exchange interface under every seam
(the port's copy of ``gelly_streaming_tpu/fabric/base.py``).

The layer the reference's Flink gets for free — the network stack under
``keyBy``/``broadcast``. The cross-process seams (coordinated epoch
barriers, the dict-exchange allgather, and later snapshot mirroring and
heartbeat leases) all route through this one interface, with these
backends:

- :class:`~gelly_streaming_tpu_torch.fabric.shared_dir.SharedDirTransport`
  — tag = file under a shared directory.
- :class:`~gelly_streaming_tpu_torch.fabric.exchange.SocketTransport` —
  GSRP frames against a tiny stdlib exchange daemon; the
  object-store-shaped backend for shards on separate machines.
- :class:`~gelly_streaming_tpu_torch.fabric.collective.CollectiveTransport`
  — the group primitives over a live multi-device runtime, which comes
  with ROADMAP Queue 1, slice 6 (multiple devices).

Every payload on the wire is numpy (``np.save`` bytes), a builtin pickle
or raw bytes — never a torch object — so a JAX-package rank and a port
rank read each other's tags.

The contract, in the recovery-safe terms the coordinated layer needs:

- **Tag store**: :meth:`~Transport.put` / :meth:`~Transport.get` /
  :meth:`~Transport.stat` / :meth:`~Transport.list` /
  :meth:`~Transport.delete` move raw bytes by string tag. A put is
  ATOMIC (a reader sees the previous value or the new one, never a
  torn middle) and ``put(overwrite=False)`` is ONE-WINNER (exactly one
  concurrent writer returns True; everyone else observes the winner's
  fully-written value).
- **Replay safety**: tags persist for the transport's lifetime (the
  ``persistent`` attribute — True when they also survive process
  restarts), so a process replaying work after a restore re-reads what
  its peers published BEFORE the failure instead of re-running their
  side of old exchanges.
- **Idempotence**: re-publishing a tag that exists is a no-op skip
  (proposals are pure functions of their inputs, so a replayed publish
  would be byte-identical anyway).
- **Group primitives** (:meth:`~Transport.allgather`,
  :meth:`~Transport.broadcast`, :meth:`~Transport.barrier`,
  :meth:`~Transport.elect`) are derived from the store by default —
  an allgather is N idempotent puts plus N polled gets — so a backend
  only implements the byte layer; the collective backend overrides the
  group layer natively instead.
- **Framed payloads**: :meth:`~Transport.put_framed` /
  :meth:`~Transport.get_framed` wrap the bytes in the repo's CRC
  container (``resilience/integrity.py``); a torn or corrupted payload
  is a counted :func:`~gelly_streaming_tpu_torch.resilience.integrity.record_rejection`,
  never a silently-wrong read.

:meth:`~Transport.elect` is the agreement primitive the cadence layer
rides: every participant proposes a value under one tag, exactly one
proposal wins (the store's one-winner put), and every participant —
including one replaying after a restart — reads the SAME winner back.
"""

from __future__ import annotations

import abc
import io
import pickle
import time
from typing import List, NamedTuple, Optional

import numpy as np

from ..obs import trace as _trace
from ..obs.registry import get_registry
from ..resilience.errors import CheckpointCorrupt, TransientSourceError
from ..resilience.integrity import (
    record_rejection,
    unwrap_checksummed,
    wrap_checksummed,
)


class TagStat(NamedTuple):
    """Store metadata for one tag: payload size and a version that
    changes whenever the value does (backends choose the clock —
    mtime_ns for files, a put counter for the daemon)."""

    size: int
    version: int


class TransportUnsupported(RuntimeError):
    """The backend cannot provide this primitive (the collective
    transport has no tag store) — callers that need it must pick a
    store-backed transport."""


class Transport(abc.ABC):
    """One cluster exchange handle; see the module docstring for the
    contract. ``process_id``/``num_processes`` scope the group
    primitives; ``timeout_s``/``poll_s`` bound every wait."""

    #: backend label on counters/timeline lines
    backend: str = "abstract"
    #: tags survive process restarts (shared-dir: yes; the socket
    #: daemon: only as long as the daemon itself; collective: no store)
    persistent: bool = True

    process_id: int = 0
    num_processes: int = 1
    timeout_s: float = 60.0
    poll_s: float = 0.002

    # ---------------------------------------------------------------- #
    # The byte layer (backend-provided)
    # ---------------------------------------------------------------- #
    @abc.abstractmethod
    def put(self, tag: str, payload: bytes, *,
            overwrite: bool = False) -> bool:
        """Publish ``payload`` under ``tag`` atomically. Returns True
        when this call created/replaced the value; with
        ``overwrite=False`` a tag that already exists is left untouched
        and the call returns False (the one-winner primitive)."""

    @abc.abstractmethod
    def _get_once(self, tag: str) -> Optional[bytes]:
        """One non-blocking read: the full payload, or None when the
        tag does not exist (yet)."""

    @abc.abstractmethod
    def stat(self, tag: str) -> Optional[TagStat]:
        """Size + version of a tag, None when absent."""

    @abc.abstractmethod
    def list(self, prefix: str = "") -> List[str]:
        """Sorted tags starting with ``prefix`` (in-flight temp
        artifacts excluded)."""

    @abc.abstractmethod
    def delete(self, tag: str) -> bool:
        """Remove a tag; True when it existed."""

    def describe(self, tag: str) -> str:
        """A human-facing locator for ``tag`` — what rejection records
        and return values name as "the artifact". The shared-dir
        backend returns the real filesystem path (the historical
        surface every recovery test and operator runbook knows); other
        backends return ``backend:tag``."""
        return f"{self.backend}:{tag}"

    # ---------------------------------------------------------------- #
    # Waiting reads + framed payloads (shared)
    # ---------------------------------------------------------------- #
    def get(self, tag: str, *, timeout_s: float = 0.0
            ) -> Optional[bytes]:
        """Read a tag's payload, polling up to ``timeout_s`` for it to
        appear; None when still absent at the deadline."""
        deadline = time.monotonic() + float(timeout_s)
        while True:
            data = self._get_once(tag)
            if data is not None:
                return data
            if time.monotonic() >= deadline:
                return None
            time.sleep(self.poll_s)

    def put_framed(self, tag: str, payload: bytes, *,
                   overwrite: bool = False) -> bool:
        """``put`` with the CRC container around the payload."""
        return self.put(tag, wrap_checksummed(payload),
                        overwrite=overwrite)

    def get_framed(self, tag: str, *, timeout_s: float = 0.0
                   ) -> Optional[bytes]:
        """``get`` + CRC validation. A present-but-corrupt payload is
        RECORDED (``resilience.ckpt_rejected``) and read as absent —
        the caller's retry/fallback logic sees one consistent shape."""
        data = self.get(tag, timeout_s=timeout_s)
        if data is None:
            return None
        try:
            return unwrap_checksummed(data, origin=self.describe(tag))
        except CheckpointCorrupt as e:
            record_rejection(self.describe(tag), str(e))
            return None

    # ---------------------------------------------------------------- #
    # Group primitives (store-derived defaults)
    # ---------------------------------------------------------------- #
    def _member_tag(self, tag: str, rank: int) -> str:
        # the legacy exchange layout: <tag>.p<rank>.npy — kept
        # byte-identical so shared-dir runs written before the fabric
        # existed replay through it unchanged
        return f"{tag}.p{rank}.npy"

    def allgather(self, tag: str, arr: np.ndarray) -> list:
        """Every rank publishes its array under ``tag``; returns all
        ranks' arrays in rank order. Publication is idempotent (replay
        re-reads, never re-writes); a peer that never publishes fails
        the exchange with
        :class:`~gelly_streaming_tpu_torch.resilience.errors.TransientSourceError`
        after ``timeout_s`` — the supervisor classifies that transient
        and restarts the cluster from the agreed epoch."""
        arr = np.asarray(arr)
        buf = io.BytesIO()
        np.save(buf, arr)
        self.put(self._member_tag(tag, self.process_id), buf.getvalue())
        if _trace.on():
            get_registry().counter(
                "fabric.exchange", backend=self.backend, tag=tag,
            ).inc()
        deadline = time.monotonic() + self.timeout_s
        out = []
        for rank in range(self.num_processes):
            member = self._member_tag(tag, rank)
            while True:
                data = self._get_once(member)
                if data is not None:
                    try:
                        out.append(np.load(io.BytesIO(data),
                                           allow_pickle=False))
                        break
                    except ValueError:
                        # a torn publish from a non-atomic writer:
                        # treat as not-yet-published and keep polling
                        data = None
                if time.monotonic() >= deadline:
                    raise TransientSourceError(
                        f"exchange {tag!r}: rank {rank} never "
                        f"published within {self.timeout_s}s"
                    )
                time.sleep(self.poll_s)
        return out

    def broadcast(self, tag: str, payload: Optional[bytes] = None, *,
                  root: int = 0) -> bytes:
        """Root publishes ``payload`` (CRC-framed) under ``tag``; every
        rank returns the root's bytes."""
        member = f"{tag}.b{int(root)}"
        if self.process_id == int(root) and payload is not None:
            self.put_framed(member, payload)
        data = self.get_framed(member, timeout_s=self.timeout_s)
        if data is None:
            raise TransientSourceError(
                f"broadcast {tag!r}: root {root} never published "
                f"within {self.timeout_s}s"
            )
        return data

    def barrier(self, tag: str) -> None:
        """All ranks reach ``tag`` before any returns — a zero-payload
        allgather, so it inherits the replay/timeout discipline."""
        self.allgather(tag, np.zeros(1, np.int8))

    def elect(self, tag: str, value):
        """One-winner agreement: every participant proposes ``value``
        under ``tag``; the store's one-winner put picks EXACTLY one
        proposal and every participant returns the winner's value —
        including a participant replaying after a restart, which finds
        the persisted winner and re-reads it (never re-votes). The
        winner's payload rides the CRC container; a corrupted winner is
        recorded and raised, never silently mis-read."""
        blob = wrap_checksummed(pickle.dumps(value, protocol=4))
        won = self.put(tag, blob)
        if _trace.on():
            get_registry().counter(
                "fabric.elect", backend=self.backend, tag=tag,
                won=str(bool(won)).lower(),
            ).inc()
        data = self.get(tag, timeout_s=self.timeout_s)
        if data is None:
            raise TransientSourceError(
                f"elect {tag!r}: no winner within {self.timeout_s}s"
            )
        try:
            payload = unwrap_checksummed(data, origin=f"elect:{tag}")
        except CheckpointCorrupt as e:
            record_rejection(f"{self.backend}:{tag}", str(e))
            raise
        return pickle.loads(payload)
