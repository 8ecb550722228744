"""Checkpoint integrity: content checksums + atomic commit helpers (the
port's copy of ``gelly_streaming_tpu/resilience/integrity.py``: the same
container and checksums, so each package reads the other's files).

Flink's recovery guarantee rests on checkpoints that are either fully
committed or invisible (asynchronous barrier snapshotting — Carbone et
al.); the repo's numpy/pickle snapshots must earn the same property on a
plain filesystem. Two primitives provide it:

- **Atomic commit**: every artifact is written to a temp name in the
  same directory and moved into place with ``os.replace`` — a kill at
  any byte leaves either the previous committed file or none, never a
  half-written one under the live name. Multi-file checkpoints order
  their replaces so ONE file is the commit point (``save_pytree``
  commits on the ``.json`` sidecar; the ``.npz`` alone is not a
  checkpoint).
- **Content checksums**: CRC32 over the payload bytes, validated at
  load. Catches the failure atomic rename cannot: bit rot, a partial
  copy from another host, or a deliberately corrupted file (the chaos
  harness's flip-byte fault). Rejection raises
  :class:`~.errors.CheckpointCorrupt`
  and is RECORDED — every rejected artifact increments
  ``resilience.ckpt_rejected`` in the obs registry, so "zero torn loads"
  is a checkable property of a run's event log, not a hope.

The checksummed single-file container (:func:`wrap_checksummed` /
:func:`unwrap_checksummed`) frames arbitrary payload bytes as
``magic | crc32 | length | payload``; files without the magic are passed
through untouched so pre-resilience checkpoints keep loading.
"""

from __future__ import annotations

import os
import struct
import warnings
import zlib

from ..obs.registry import get_registry
from .errors import CheckpointCorrupt

#: container magic for checksummed single-file artifacts (version 1)
MAGIC = b"GSCKPT1\n"

_HEADER = struct.Struct("<II")  # crc32, payload length


def arrays_crc32(arrays) -> int:
    """CRC32 over the raw bytes of numpy arrays, in iteration order.

    This is the pytree checkpoint's CONTENT checksum: computed from the
    in-memory arrays at save time (no re-read of the just-written file
    inside the barrier's serialize span) and from the loaded arrays at
    restore time (which are materialized anyway) — one sequential pass
    either way, never a second trip through a multi-GB ``.npz``.
    """
    import numpy as np

    crc = 0
    for a in arrays:
        a = np.ascontiguousarray(a)
        crc = zlib.crc32(memoryview(a).cast("B"), crc)
    return crc & 0xFFFFFFFF


def replace_atomic(tmp: str, path: str) -> None:
    """Alias for ``os.replace`` kept here so commit points read as what
    they are at call sites (``integrity.replace_atomic(tmp, json_path)``
    is the barrier commit)."""
    os.replace(tmp, path)


def wrap_checksummed(payload: bytes) -> bytes:
    """Frame payload bytes as ``MAGIC | crc32 | length | payload``."""
    return MAGIC + _HEADER.pack(zlib.crc32(payload) & 0xFFFFFFFF,
                                len(payload)) + payload


def unwrap_checksummed(data: bytes, *, origin: str = "checkpoint") -> bytes:
    """Validate and strip the checksummed container.

    Data not starting with :data:`MAGIC` is returned unchanged (legacy
    artifact — rename-atomicity is its only guarantee, as before).
    A present-but-wrong frame (truncated payload, checksum mismatch)
    raises :class:`CheckpointCorrupt`.
    """
    if not data.startswith(MAGIC):
        return data
    head_end = len(MAGIC) + _HEADER.size
    if len(data) < head_end:
        raise CheckpointCorrupt(f"{origin}: truncated container header")
    crc, length = _HEADER.unpack(data[len(MAGIC):head_end])
    payload = data[head_end:]
    if len(payload) != length:
        raise CheckpointCorrupt(
            f"{origin}: payload is {len(payload)} bytes, header promised "
            f"{length} (truncated or over-written file)"
        )
    if (zlib.crc32(payload) & 0xFFFFFFFF) != crc:
        raise CheckpointCorrupt(f"{origin}: payload checksum mismatch")
    return payload


def record_rejection(path: str, reason: str) -> None:
    """One rejected checkpoint artifact: bump the obs counter (the chaos
    harness's evidence stream) and warn — rejection is a recovery event
    an operator should see, not a silent branch."""
    get_registry().counter("resilience.ckpt_rejected").inc()
    warnings.warn(
        f"rejected checkpoint artifact {path}: {reason}",
        RuntimeWarning,
        stacklevel=2,
    )
