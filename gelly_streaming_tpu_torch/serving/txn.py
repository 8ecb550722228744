"""Snapshot-pinned read transactions (the port's copy of
``gelly_streaming_tpu/serving/txn.py``).

Answering from whatever snapshot is freshest lets a client issuing two
related queries observe two different graph versions, and a failover or
live split mid-sequence makes the skew arbitrary. This module is the
client-visible half of the fix:

- A :class:`TxnContext` pins a per-shard ``{shard: (version, boot)}``
  VECTOR from the stamps ordinary reply frames already carry
  (``Answer.version`` + the ``shard``/``boot`` trailers) — no
  extra round trip. The first answer a transaction sees from a shard
  pins that shard; every later read the context rides is answered AT
  the pinned snapshot or fails honestly.
- Expiry is TYPED and counted, never silent: a pinned version that
  slid out of the serving ring (``SnapshotStore.at_version``), a
  peer that ignored the pin (detected via the reply stamp), or a
  failover that lost the pinned state all raise
  :class:`TxnSnapshotExpired` with a ``kind`` tag — a transaction is
  told its snapshot is gone, it is never quietly handed a fresher
  answer.
- ``boot`` is the snapshot store's LINEAGE nonce: version numbers
  restart across store swaps, so a pin is only satisfied by the same
  (version, lineage) pair — a cold-restarted shard whose counter
  happens to pass the pinned number can never coincidentally satisfy
  it (a restart RESETS a pin, it does not feed it).

The wire codec (:func:`encode_txn`/:func:`decode_txn`) is tolerant in
both directions: v1 peers ignore the ``txn`` REQ field entirely (the
client detects the unpinned answer from the reply stamp), and a decoder
handed garbage reads it as "no transaction" rather than dying.

A transaction's deadline is ONE budget: pinned at
:class:`TxnContext` construction and spent across begin, every read,
and the expiry sweeps — a retry never grants itself a fresh clock.
"""

from __future__ import annotations

import os
import threading
import time
from collections import OrderedDict
from typing import Dict, Optional, Tuple

from ..obs.registry import get_registry


class TxnSnapshotExpired(RuntimeError):
    """A pinned snapshot is no longer readable. ``kind`` names why:

    - ``ring_slid``: the pinned version aged out of the serving ring
      under sustained publishing (the retention bound).
    - ``ahead``: the pin is newer than anything this store published —
      the pin came from a different incarnation's future.
    - ``lineage``: the store's boot lineage changed (cold restart /
      fresh store); a numerically-equal version is NOT the snapshot.
    - ``unaware_peer``: the answering peer ignored the pin (a v1
      server) — detected from the reply stamp, failed honestly.
    - ``failover``: a promoted standby's mirrored ring does not hold
      the pinned state (counted ``txn.failover_expired``).

    Always counted at the raise site; never replaced by a silently
    fresher answer.
    """

    def __init__(self, msg: str, *, kind: str = "expired"):
        super().__init__(msg)
        self.kind = kind


class PinnedQuery:
    """Server-side wrapper marrying one query to its pinned snapshot.

    Rides the serving worker's pending entries in the query slot so the
    answer path can group a drained sweep by pin and answer each group
    from ``SnapshotStore.at_version`` — the wrapper never crosses the
    wire (the REQ ``txn`` field does) and never reaches an engine
    kernel (the worker unwraps ``.q``)."""

    __slots__ = ("q", "version", "boot")

    def __init__(self, q, version: int, boot: str = ""):
        self.q = q
        self.version = int(version)
        self.boot = str(boot)

    def __repr__(self) -> str:  # surfaces in deadline/expiry messages
        return (f"PinnedQuery({type(self.q).__name__}"
                f"@v{self.version})")


# --------------------------------------------------------------------- #
# Wire codec (pair: every key written here is read back below)
# --------------------------------------------------------------------- #
def encode_txn(txn_id: str, *, pin: Optional[tuple] = None,
               vec: Optional[dict] = None) -> dict:
    """Pack a transaction's identity + pins as the REQ ``txn`` field.

    ``pin`` is the single ``(version, boot)`` a shard-directed
    sub-request carries (the router's per-owner form); ``vec`` is the
    full ``{shard: (version, boot)}`` vector a client sends a router.
    Either, both, or neither may be present — a bare id announces a
    transaction that has not pinned anything yet (its first answers do
    the pinning)."""
    doc: dict = {"id": str(txn_id)}
    if pin is not None:
        doc["pin"] = [int(pin[0]), str(pin[1])]
    if vec is not None:
        doc["vec"] = {
            str(int(s)): [int(v), str(b)] for s, (v, b) in vec.items()
        }
    return doc


def decode_txn(doc) -> Optional[dict]:
    """Decode a REQ ``txn`` field into ``{"id", "pin", "vec"}``
    (``pin`` a ``(version, boot)`` tuple or None, ``vec`` a
    ``{int shard: (version, boot)}`` dict or None).

    Tolerant by contract: None/garbage decodes as None ("no
    transaction", counted ``rpc.malformed{kind=txn}`` when the field
    was present but unreadable) — a malformed pin must degrade to an
    unpinned request the CLIENT then fails via the reply stamp, never
    to a dead handler thread."""
    if doc is None:
        return None
    try:
        if not isinstance(doc, dict):
            raise TypeError("txn field must be a dict")
        out: dict = {"id": str(doc.get("id", "")), "pin": None,
                     "vec": None}
        raw = doc.get("pin")
        if raw is not None:
            out["pin"] = (
                int(raw[0]), str(raw[1]) if len(raw) > 1 else "",
            )
        rawv = doc.get("vec")
        if rawv is not None:
            vec: Dict[int, Tuple[int, str]] = {}
            for k, item in rawv.items():
                vec[int(k)] = (
                    int(item[0]),
                    str(item[1]) if len(item) > 1 else "",
                )
            out["vec"] = vec
        return out
    except (TypeError, ValueError, KeyError, IndexError):
        get_registry().counter("rpc.malformed", kind="txn").inc()
        return None


# --------------------------------------------------------------------- #
# Client-side transaction context
# --------------------------------------------------------------------- #
class TxnContext:
    """One snapshot-pinned read transaction.

    Pass it to :meth:`~gelly_streaming_tpu_torch.serving.client.RpcClient`
    submit/ask calls (``txn=ctx``): the client rides the context's
    vector on every REQ frame and observes every OK answer back into
    it, so the FIRST answer from each shard pins that shard and every
    later read is answered at the pinned snapshot or raises
    :class:`TxnSnapshotExpired`. The vector is captured from ordinary
    reply stamps — beginning a transaction costs no extra round trip.

    ``deadline_s`` is the transaction's ONE total budget: it is
    pinned to the wall clock here, and every read made under the
    context spends what REMAINS of it — begin, reads, retries, and
    expiry sweeps share the single clock."""

    def __init__(self, *, deadline_s: Optional[float] = None):
        self.id = os.urandom(6).hex()
        self._vec: Dict[int, Tuple[int, str]] = {}
        self._lock = threading.Lock()
        self._deadline = (
            None if deadline_s is None
            else time.monotonic() + float(deadline_s)
        )
        get_registry().counter("txn.begin").inc()
        note_txn(self.id)

    def remaining_s(self) -> Optional[float]:
        """What is left of the transaction's one deadline budget (None
        when unbounded); never negative."""
        if self._deadline is None:
            return None
        return max(0.0, self._deadline - time.monotonic())

    def observe(self, answer) -> None:
        """Pin from one OK answer's reply stamp: the first answer seen
        from a shard pins ``(version, boot)`` for it; later answers
        from an already-pinned shard are ignored (they are either the
        pinned snapshot's own stamps or the reason an expiry raised)."""
        shard = int(getattr(answer, "shard", -1))
        boot = str(getattr(answer, "boot", ""))
        version = int(getattr(answer, "version", 0))
        if version <= 0 or not boot:
            # a v1 peer's unstamped answer pins nothing, and neither
            # does a router-merged cross-shard answer (shard=-1,
            # boot="", version=summed) — pins are per-shard lineage
            # facts; the MERGED classes pin through the vector the
            # per-shard answers already built
            return
        with self._lock:
            if shard not in self._vec:
                self._vec[shard] = (version, boot)
                note_txn(self.id)

    def vector(self) -> Dict[int, Tuple[int, str]]:
        """A copy of the pinned ``{shard: (version, boot)}`` vector."""
        with self._lock:
            return dict(self._vec)

    def pin_for(self, shard: int) -> Optional[Tuple[int, str]]:
        with self._lock:
            return self._vec.get(int(shard))

    @property
    def pinned(self) -> bool:
        with self._lock:
            return bool(self._vec)

    def wire_doc(self) -> dict:
        """The REQ ``txn`` field for this context's current vector."""
        return encode_txn(self.id, vec=self.vector())


# --------------------------------------------------------------------- #
# Active-transaction tracker (the /healthz "active" gauge)
# --------------------------------------------------------------------- #
class ActiveTxns:
    """Recently-seen transaction ids, TTL-pruned: the health surface's
    per-replica active-transaction count. Bounded both ways (cap +
    TTL) — a tracker must never become the leak it exists to report."""

    TTL_S = 30.0
    CAP = 4096

    def __init__(self):
        self._lock = threading.Lock()
        self._seen: "OrderedDict[str, float]" = OrderedDict()

    def note(self, txn_id: str) -> None:
        if not txn_id:
            return
        now = time.monotonic()
        with self._lock:
            self._seen[txn_id] = now
            self._seen.move_to_end(txn_id)
            while len(self._seen) > self.CAP:
                self._seen.popitem(last=False)

    def count(self) -> int:
        cutoff = time.monotonic() - self.TTL_S
        with self._lock:
            stale = [k for k, ts in self._seen.items() if ts < cutoff]
            for k in stale:
                del self._seen[k]
            return len(self._seen)


_ACTIVE = ActiveTxns()


def note_txn(txn_id: str) -> None:
    """Record one transaction sighting in the process-wide tracker
    (called at begin client-side and per pinned REQ server-side)."""
    _ACTIVE.note(txn_id)


def active_txn_count() -> int:
    """Transactions seen within the tracker TTL — the health gauge."""
    return _ACTIVE.count()
