"""Elastic resharding coordination: ownership-epoch plans over fabric
(the port's copy of ``gelly_streaming_tpu/serving/reshard.py``; host
only, no device state).

The serving tier boots with a fixed shard count (``router.ShardRouter``
fans out by ``core.ingest.vertex_owner``).  A live split moves HALF of
one hot shard's keyspace to a new child shard without stopping the
stream.  The pieces:

- A **split plan** ``{"epoch", "parent", "child", "salt"}`` is agreed
  via :meth:`fabric.base.Transport.elect` — the same one-winner
  machinery as ``ElectedK`` (``fabric/agreement.py``).  Exactly one
  proposal wins per epoch; a replaying proposer finds the persisted
  winner and re-reads it, never re-votes.  The plan composes with the
  boot hash through :func:`core.ingest.vertex_owner_epoch`: keys whose
  ``split_side(ids, salt)`` bit is set move from ``parent`` to
  ``child``; the rest stay put.
- The child shard **publishes its address** under the same store once
  (and only once) it is servable.  A plan is *actionable* only when
  both the elected plan AND the child address exist — so a router can
  never adopt an epoch whose child would refuse traffic.
- Ownership epochs form a **dense prefix**: epoch ``k`` means plans
  ``1..k`` are all actionable.  :func:`actionable_plans` returns that
  longest prefix; its length IS the epoch.  A gap (plan 2 actionable
  but plan 1 not) stops the prefix at 0 — adoption is ordered, never
  speculative.
- :class:`ReshardWatcher` polls the store from a daemon thread and
  fires ``on_adopt`` when the prefix grows.  Shard replicas use it to
  learn the current epoch they stamp on reply frames
  (``rpc.RpcServer(epoch=...)``); routers learn new epochs from those
  frames and pull the plans here (``router.ShardRouter``).

Everything rides the CRC container (``put_framed``/``get_framed``), so
a torn plan or address reads as absent-and-recorded, never mis-parsed.
"""

from __future__ import annotations

import pickle
import threading
from typing import Callable, Dict, List, Optional

from ..obs import trace as _trace
from ..obs.registry import get_registry
from ..resilience.integrity import record_rejection

PLAN_PREFIX = "reshard.plan.e"
ADDR_PREFIX = "reshard.addr.e"

_PLAN_KEYS = ("epoch", "parent", "child", "salt")


def plan_tag(epoch: int) -> str:
    """Store tag for the elected split plan of ``epoch``."""
    return f"{PLAN_PREFIX}{int(epoch):08d}"


def addr_tag(epoch: int) -> str:
    """Store tag for the child shard's published address of
    ``epoch``."""
    return f"{ADDR_PREFIX}{int(epoch):08d}"


def _validate_plan(plan, origin: str) -> Optional[Dict[str, int]]:
    """Shape-check a decoded plan; a malformed one is RECORDED and read
    as absent (same contract as ``get_framed`` on a torn frame)."""
    if not isinstance(plan, dict) or any(k not in plan for k in _PLAN_KEYS):
        record_rejection(origin, f"malformed split plan: {plan!r:.120}")
        return None
    try:
        out = {k: int(plan[k]) for k in _PLAN_KEYS}
    except (TypeError, ValueError) as e:
        record_rejection(origin, f"non-integer split plan field: {e!r}")
        return None
    if out["parent"] == out["child"] or out["child"] < 0 or out["parent"] < 0:
        record_rejection(origin, f"degenerate split plan: {out!r}")
        return None
    return out


def propose_split(store, epoch: int, *, parent: int, child: int,
                  salt: int) -> Dict[str, int]:
    """Propose a split for ``epoch``; return the WINNING plan.

    One-winner: concurrent proposers for the same epoch all return the
    same plan (whichever the store's one-winner put picked), and a
    proposer replaying after a restart re-reads the persisted winner.
    The returned plan — not the proposal — is what everyone acts on.
    """
    from ..fabric import as_transport

    tr = as_transport(store)
    plan = {
        "epoch": int(epoch),
        "parent": int(parent),
        "child": int(child),
        "salt": int(salt) & (2 ** 64 - 1),
    }
    if plan["parent"] == plan["child"]:
        raise ValueError(f"split parent == child ({parent})")
    won = tr.elect(plan_tag(epoch), plan)
    out = _validate_plan(won, tr.describe(plan_tag(epoch)))
    if out is None:
        # the elected winner itself is malformed — this is not a torn
        # frame (elect CRC-checks) but a bad proposer; surface it
        raise ValueError(f"elected split plan malformed: {won!r:.120}")
    if _trace.on():
        get_registry().counter(
            "reshard.agree", epoch=str(out["epoch"]),
            parent=str(out["parent"]), child=str(out["child"]),
        ).inc()
    return out


def read_plan(store, epoch: int) -> Optional[Dict[str, int]]:
    """Non-proposing read of an elected plan (``None`` if not yet
    elected, torn, or malformed — torn/malformed are recorded)."""
    from ..fabric import as_transport

    tr = as_transport(store)
    data = tr.get_framed(plan_tag(epoch))
    if data is None:
        return None
    try:
        plan = pickle.loads(data)
    except Exception as e:
        record_rejection(tr.describe(plan_tag(epoch)),
                         f"undecodable split plan: {e!r}")
        return None
    return _validate_plan(plan, tr.describe(plan_tag(epoch)))


def publish_addr(store, epoch: int, addr: str) -> None:
    """Publish the child shard's serving address for ``epoch``.

    Overwrite is deliberate: a restarted child re-publishes its (new)
    port under the same epoch and routers re-resolve on their next
    adoption poll.
    """
    from ..fabric import as_transport

    as_transport(store).put_framed(
        addr_tag(epoch), str(addr).encode("utf-8"), overwrite=True)


def read_addr(store, epoch: int) -> Optional[str]:
    """Child address for ``epoch`` (``None`` if unpublished/torn)."""
    from ..fabric import as_transport

    tr = as_transport(store)
    data = tr.get_framed(addr_tag(epoch))
    if data is None:
        return None
    try:
        return data.decode("utf-8")
    except UnicodeDecodeError as e:
        record_rejection(tr.describe(addr_tag(epoch)),
                         f"undecodable child addr: {e!r}")
        return None


def actionable_plans(store, *, limit: int = 64) -> List[Dict]:
    """Longest DENSE prefix of actionable split plans.

    Epoch ``k`` is actionable when its plan is elected AND its child
    address is published.  Returns plans ``1..k`` (each with an
    ``"addr"`` key) for the largest such dense ``k``; the list length
    is the current ownership epoch.  Ordering matters: splits compose
    (``vertex_owner_epoch`` applies them in sequence), so a later plan
    must never be adopted before an earlier one.
    """
    out: List[Dict] = []
    for epoch in range(1, int(limit) + 1):
        plan = read_plan(store, epoch)
        if plan is None:
            break
        addr = read_addr(store, epoch)
        if addr is None:
            break
        out.append(dict(plan, addr=addr))
    return out


class ReshardWatcher:
    """Poll a reshard store for epoch growth from a daemon thread.

    ``on_adopt(plans)`` fires with the FULL actionable prefix each time
    it grows (never shrinks — adopted plans are immutable history).
    ``epoch()``/``splits()``/``addrs()`` read the latest adopted state
    without touching the store.  Poll errors are swallowed-and-counted
    (``reshard.swallowed{site=watch}``): a flaky store read must not
    kill the watcher, the next poll retries.
    """

    def __init__(self, store, *, poll_s: float = 0.1,
                 on_adopt: Optional[Callable[[List[Dict]], None]] = None,
                 limit: int = 64, start: bool = True) -> None:
        self.store = store
        self.poll_s = float(poll_s)
        self.limit = int(limit)
        self._on_adopt = on_adopt
        self._lock = threading.Lock()
        self._plans: List[Dict] = []
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        if start:
            self.refresh()
            self._thread = threading.Thread(
                target=self._run, name="reshard-watch", daemon=True)
            self._thread.start()

    # ------------------------------------------------------------- #
    def epoch(self) -> int:
        with self._lock:
            return len(self._plans)

    def splits(self) -> List[Dict]:
        """Adopted plans WITHOUT addresses — the ``splits`` argument
        for :func:`core.ingest.vertex_owner_epoch`."""
        with self._lock:
            return [{k: p[k] for k in _PLAN_KEYS} for p in self._plans]

    def addrs(self) -> List[str]:
        with self._lock:
            return [p["addr"] for p in self._plans]

    def plans(self) -> List[Dict]:
        with self._lock:
            return [dict(p) for p in self._plans]

    # ------------------------------------------------------------- #
    def refresh(self) -> int:
        """One synchronous poll; returns the current epoch."""
        plans = actionable_plans(self.store, limit=self.limit)
        fire = None
        with self._lock:
            if len(plans) > len(self._plans):
                self._plans = plans
                fire = [dict(p) for p in plans]
        if fire is not None and self._on_adopt is not None:
            self._on_adopt(fire)
        with self._lock:
            return len(self._plans)

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                self.refresh()
            except Exception:
                # counted, not fatal: the watcher must outlive one bad
                # store read — the next poll sees a consistent store
                get_registry().counter(
                    "reshard.swallowed", site="watch").inc()
            self._stop.wait(self.poll_s)

    def close(self, timeout: float = 10.0) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout)
        self._thread = None
