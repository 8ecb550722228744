"""GSRP frame primitives — the length-prefixed wire layer (the port's
copy of ``gelly_streaming_tpu/fabric/wire.py``, byte for byte the same
frames).

Length-prefixed binary frames (magic | version | type | payload length):
a reader always knows where one message ends, a torn read is a
DETECTABLE ``MalformedFrame("truncated")`` instead of a parser wedged
mid-garbage, and an oversized length field is rejected before it can
allocate. The fabric's socket backend and the serving RPC
(``serving/rpc.py`` re-exports this module) speak them: one frame
grammar for every socket.

The constants (:data:`MAGIC`, :data:`VERSION`, :data:`HEADER`,
:data:`DEFAULT_MAX_FRAME`), the exception taxonomy (:class:`Disconnect`
at clean boundaries, :class:`MalformedFrame` with its counted ``kind``),
and the three functions (:func:`pack_frame`, :func:`recv_exact`,
:func:`read_frame`).

Frame types are allocated per consumer from one registry below so two
protocols can never collide on a type byte: the RPC query path owns
1-9, the fabric exchange protocol 10-19.
"""

from __future__ import annotations

import struct
from typing import Tuple

#: frame magic (also the protocol's garbage detector)
MAGIC = b"GSRP"
VERSION = 1
#: header: magic | version | frame type | payload length
HEADER = struct.Struct("<4sBBI")
#: reject frames past this length before reading them (an attacker's —
#: or a corrupted peer's — length field must not allocate unboundedly)
DEFAULT_MAX_FRAME = 8 << 20

# ---- frame-type registry (one byte space, partitioned per consumer) --- #
T_REQ = 1    # serving RPC: client -> server, one query batch
T_RESP = 2   # serving RPC: server -> client, one batch's outcome
T_XREQ = 10   # fabric exchange: client -> daemon, one tag-store op
T_XRESP = 11  # fabric exchange: daemon -> client, the op's outcome


class Disconnect(Exception):
    """Peer closed at a frame boundary — the clean end of a connection."""


class MalformedFrame(ValueError):
    """The byte stream violated the frame contract; ``kind`` is the
    ``rpc.malformed{kind=...}`` / ``fabric.malformed{kind=...}`` label
    (magic/version/oversized/truncated/json/request)."""

    def __init__(self, kind: str, msg: str):
        super().__init__(msg)
        self.kind = kind


def pack_frame(ftype: int, payload: bytes) -> bytes:
    return HEADER.pack(MAGIC, VERSION, ftype, len(payload)) + payload


def recv_exact(sock, n: int, *, at_boundary: bool = False) -> bytes:
    """Read exactly ``n`` bytes. EOF (or a reset) before the FIRST byte
    of a frame is a clean :class:`Disconnect`; EOF mid-frame is a
    :class:`MalformedFrame` (``truncated``) — the distinction the fuzz
    tests pin."""
    buf = b""
    while len(buf) < n:
        try:
            chunk = sock.recv(n - len(buf))
        except OSError as e:
            if at_boundary and not buf:
                raise Disconnect(repr(e)) from e
            raise MalformedFrame(
                "truncated",
                f"connection lost after {len(buf)}/{n} bytes: {e!r}",
            ) from e
        if not chunk:
            if at_boundary and not buf:
                raise Disconnect("peer closed")
            raise MalformedFrame(
                "truncated", f"peer closed after {len(buf)}/{n} bytes"
            )
        buf += chunk
    return buf


def read_frame(sock, *, max_frame: int = DEFAULT_MAX_FRAME
               ) -> Tuple[int, bytes]:
    """One complete frame off the socket; raises :class:`Disconnect` at
    a clean boundary, :class:`MalformedFrame` for everything the frame
    contract rejects."""
    head = recv_exact(sock, HEADER.size, at_boundary=True)
    magic, version, ftype, length = HEADER.unpack(head)
    if magic != MAGIC:
        raise MalformedFrame("magic", f"bad magic {magic!r}")
    if version != VERSION:
        raise MalformedFrame("version", f"unsupported version {version}")
    if length > max_frame:
        raise MalformedFrame(
            "oversized", f"frame of {length} bytes exceeds {max_frame}"
        )
    payload = recv_exact(sock, length) if length else b""
    return ftype, payload
