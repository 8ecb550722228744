"""Deterministic fault injection: a seeded plan behind test-only hooks
(the port's copy of ``gelly_streaming_tpu/resilience/faults.py``).

Production stream engines treat recovery as a TESTED property, not a
code path that exists (MillWheel's idempotent-replay guarantee was
proven by killing workers, not by reading the code). This module is the
repo's kill switchboard: a :class:`FaultPlan` describes exactly which
fault fires where — kill after window k, corrupt the barrier committed
at window b, disconnect the socket at record n, drop/duplicate/swap
specific source records, stall a consumer — and hook points threaded
through ``core/pipeline.py``, ``core/sources.py``,
``aggregate/autockpt.py`` and ``serving/server.py`` consult it.

Everything is deterministic: faults fire on exact indices (window
ordinal, record ordinal, barrier watermark), and the only randomness —
the corruption byte offset — derives from the plan's ``seed``. Running
the same plan twice produces byte-identical failure sequences, which is
what lets a chaos run assert ORACLE-IDENTICAL recovery at every kill
point instead of "it didn't crash".

Hook-point cost when disarmed is one module-attribute check
(``faults.active()`` is ``_PLAN is not None``); no plan object, index
arithmetic, or registry lookup happens on production runs.

Usage::

    plan = FaultPlan(kill_at_window=5)
    with faults.injected(plan):
        ...            # SimulatedCrash fires after window 5, once

Every fired fault increments ``resilience.fault_injected{site=...}`` in
the obs registry so a chaos run's event log records what was done to it
alongside how it recovered.
"""

from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass, field
from typing import Iterator, Optional, Tuple

from ..obs.registry import get_registry
from .errors import SimulatedCrash


@dataclass
class FaultPlan:
    """One deterministic failure schedule. All indices are 0-based
    ordinals counted at the hook site (window ordinal for kills, record
    ordinal for source faults, ``windows_done`` for barrier corruption).

    ``kill_at_window`` fires at the ``kill_site`` hook ONLY (default
    ``chaos.window``, the harness drive loop; ``pipeline.item`` kills
    at a prefetch-item ordinal instead — note that under superbatching
    those are GROUP indices, not window indices, so the two sites count
    different things and a kill must name the one it means):
    :class:`SimulatedCrash` when ``kill_exit_code`` is None (the
    in-process crash the supervisor recovers from), else ``os._exit``
    (the real process kill the chaos workers use). Kills are ONE-SHOT:
    after restart the replayed ordinal passes the hook again, and
    re-firing would turn every kill test into a poison-window loop.

    ``kill_at_or_after`` (the port's addition) fires the kill at the
    first ordinal at or after ``kill_at_window`` that reaches the site,
    for a site that is not passed at every ordinal: the serving worker's
    ``serving.worker.busy`` fires only on a sweep that finds a batch
    pending, so a replica's ``kill_at_sweep`` always lands with a batch
    in flight.
    """

    seed: int = 0
    # -- kill / stall (pipeline sites) --------------------------------- #
    kill_at_window: Optional[int] = None
    kill_site: str = "chaos.window"
    kill_exit_code: Optional[int] = None
    kill_at_or_after: bool = False
    stall_site: Optional[str] = None       # e.g. "serving.worker"
    stall_at_index: int = 0
    stall_s: float = 0.0
    # -- rpc wire faults (frame ordinals on the socket path) ------------ #
    rpc_disconnect_at_frame: Optional[int] = None
    rpc_truncate_at_frame: Optional[int] = None
    # -- source perturbation (record ordinals) ------------------------- #
    disconnect_at_record: Optional[int] = None
    drop_records: Tuple[int, ...] = ()
    duplicate_records: Tuple[int, ...] = ()
    swap_records: Tuple[int, ...] = ()     # swap record i with record i+1
    # -- event-time skew: jitter record i's timestamp field
    # by a deterministic bounded offset in [-skew_ts_s, +skew_ts_s],
    # derived from (seed, i) — the out-of-order-ARRIVAL analog of
    # swap_records, testing watermark/lateness handling instead of
    # delivery order. ``skew_ts_field`` indexes the ts inside the
    # record tuple (-1 = last element, the ``(s, d, v, ts)`` shape)
    skew_records: Tuple[int, ...] = ()
    skew_ts_s: int = 0
    skew_ts_field: int = -1
    # -- checkpoint corruption ----------------------------------------- #
    corrupt_at_barrier: Optional[int] = None
    corrupt_mode: str = "flip"             # "flip" | "truncate"
    # -- one-shot bookkeeping (mutable run state) ----------------------- #
    _fired: set = field(default_factory=set, repr=False)

    def perturbs_records(self) -> bool:
        return bool(
            self.drop_records or self.duplicate_records
            or self.swap_records or self.skew_records
        )

    # ------------------------------------------------------------------ #
    def _once(self, key) -> bool:
        if key in self._fired:
            return False
        self._fired.add(key)
        return True

    def _count(self, site: str) -> None:
        get_registry().counter(
            "resilience.fault_injected", site=site
        ).inc()

    def fire(self, site: str, *, index: Optional[int] = None,
             path: Optional[str] = None) -> None:
        """Consult the plan at one hook point; may sleep, raise, corrupt
        a file, or kill the process. No-op for sites/indices the plan
        does not name."""
        if (
            self.stall_site == site
            and (index or 0) == self.stall_at_index
            and self.stall_s > 0
            and self._once(("stall", site, index))
        ):
            self._count(site)
            time.sleep(self.stall_s)
        if site == self.kill_site:
            if (
                self.kill_at_window is not None
                and index is not None
                and (index == self.kill_at_window
                     or (self.kill_at_or_after
                         and index > self.kill_at_window))
                and self._once(("kill", self.kill_at_window))
            ):
                self._count(site)
                # the black box goes down WITH the plane: an os._exit
                # kill gives no later hook, so the installed flight
                # recorder (if any) commits its ring right here —
                # the fault_injected count above is the last event in it
                from ..obs import flight as _flight

                _flight.dump_installed(
                    f"fault_kill:{site}", index=index,
                )
                if self.kill_exit_code is not None:
                    os._exit(self.kill_exit_code)
                raise SimulatedCrash(
                    f"injected kill after window {index} ({site})"
                )
        elif site == "source.record":
            if (
                self.disconnect_at_record is not None
                and index == self.disconnect_at_record
                and self._once(("disconnect", index))
            ):
                self._count(site)
                raise ConnectionResetError(
                    f"injected disconnect at record {index}"
                )
        elif site == "rpc.frame":
            # the serving RPC read paths (server handler + client reader)
            # consult this after every complete frame: a mid-stream
            # disconnect is the wire analog of disconnect_at_record,
            # counted at the same one-shot discipline (frame ordinals are
            # per-connection)
            if (
                self.rpc_disconnect_at_frame is not None
                and index == self.rpc_disconnect_at_frame
                and self._once(("rpc_disconnect", index))
            ):
                self._count(site)
                raise ConnectionResetError(
                    f"injected disconnect at frame {index}"
                )
        elif site == "checkpoint.committed":
            if (
                self.corrupt_at_barrier is not None
                and index == self.corrupt_at_barrier
                and path is not None
                and self._once(("corrupt", index))
            ):
                self._count(site)
                corrupt_file(path, self.corrupt_mode, seed=self.seed)

    def truncate_frame(self, index: Optional[int]) -> bool:
        """True when the RPC send path should commit only HALF of frame
        ``index`` and drop the connection — the torn-write shape on the
        wire (the socket analog of ``corrupt_mode="truncate"``).
        One-shot, counted as site ``rpc.send``; a pure query, so the
        send path stays in charge of its own socket teardown."""
        if (
            self.rpc_truncate_at_frame is not None
            and index == self.rpc_truncate_at_frame
            and self._once(("rpc_truncate", index))
        ):
            self._count("rpc.send")
            return True
        return False

    # ------------------------------------------------------------------ #
    def perturb_records(self, records: Iterator) -> Iterator:
        """Apply drop/duplicate/swap faults to a record iterator.

        Indices count REAL records only; ``None`` idle ticks pass
        through unindexed (they are time, not data). ``swap_records``
        holds record ``i`` back and emits ``i+1`` first — a bounded,
        deterministic reorder (the shape out-of-order delivery actually
        takes at a window boundary). ``skew_records`` jitters record
        ``i``'s timestamp field by a seed-derived bounded offset —
        event-time disorder without reordering delivery.
        """
        drop = set(self.drop_records)
        dup = set(self.duplicate_records)
        swap = set(self.swap_records)
        skew = set(self.skew_records)
        held = None  # (index, record) awaiting its swap partner
        i = 0
        for rec in records:
            if rec is None:
                yield rec
                continue
            idx = i
            i += 1
            if idx in drop:
                self._count("source.perturb")
                continue
            if idx in skew:
                self._count("source.perturb")
                rec = self._skewed(rec, idx)
            if held is not None:
                yield rec
                if idx in dup:
                    yield rec
                yield held[1]
                if held[0] in dup:
                    yield held[1]
                held = None
                continue
            if idx in swap:
                self._count("source.perturb")
                held = (idx, rec)
                continue
            yield rec
            if idx in dup:
                self._count("source.perturb")
                yield rec
        if held is not None:  # swap partner never arrived: emit late
            yield held[1]

    def _skewed(self, rec: tuple, idx: int):
        """Record ``idx`` with its timestamp field jittered by a
        DETERMINISTIC bounded offset in ``[-skew_ts_s, +skew_ts_s]``
        derived from ``(seed, idx)`` — same plan, same jitter, every
        run (the seeded-chaos rule). Records too short to carry the
        field pass through untouched (a ts-less stream has no event
        time to skew)."""
        f = self.skew_ts_field
        pos = f if f >= 0 else len(rec) + f
        if self.skew_ts_s <= 0 or not (0 <= pos < len(rec)):
            return rec
        span = 2 * self.skew_ts_s + 1
        # splitmix-style integer mix of (seed, idx): cheap, stateless,
        # and identical across processes — no RNG object to carry
        h = (idx * 0x9E3779B97F4A7C15 + self.seed * 0xC2B2AE3D27D4EB4F)
        h ^= h >> 31
        offset = (h % span) - self.skew_ts_s
        out = list(rec)
        out[pos] = int(out[pos]) + offset
        return tuple(out)


def corrupt_file(path: str, mode: str = "flip", *, seed: int = 0) -> None:
    """Deterministically damage a committed artifact in place.

    ``flip`` XORs one byte at an offset derived from ``seed`` (second
    half of the file, so the payload — not just the container header —
    is what the checksum must catch); ``truncate`` keeps the first half
    (the torn-write shape). Used by the fault plan and directly by
    tests/the chaos sweep.
    """
    size = os.path.getsize(path)
    if size == 0:
        return
    if mode == "truncate":
        with open(path, "rb+") as f:
            f.truncate(max(1, size // 2))
        return
    if mode != "flip":
        raise ValueError(f"corrupt mode must be flip/truncate, got {mode!r}")
    offset = size // 2 + (seed % max(1, size - size // 2))
    offset = min(offset, size - 1)
    with open(path, "rb+") as f:
        f.seek(offset)
        b = f.read(1)
        f.seek(offset)
        f.write(bytes([b[0] ^ 0xFF]))


# --------------------------------------------------------------------- #
# Global installation (the hook points' single cheap check)
# --------------------------------------------------------------------- #
_PLAN: Optional[FaultPlan] = None
_LOCK = threading.Lock()


def active() -> bool:
    """True when a plan is installed — the one check production hook
    sites pay."""
    return _PLAN is not None


def plan() -> Optional[FaultPlan]:
    return _PLAN


def install(p: Optional[FaultPlan]) -> None:
    global _PLAN
    with _LOCK:
        _PLAN = p


def clear() -> None:
    install(None)


def fire(site: str, *, index: Optional[int] = None,
         path: Optional[str] = None) -> None:
    """Module-level dispatch: forwards to the installed plan, no-op
    otherwise. Hook sites guard with :func:`active` first so the
    common case never enters this function."""
    p = _PLAN
    if p is not None:
        p.fire(site, index=index, path=path)


class injected:
    """``with faults.injected(plan): ...`` — install for the block,
    always clear after (a leaked plan would sabotage the next test)."""

    def __init__(self, p: FaultPlan):
        self._p = p

    def __enter__(self) -> FaultPlan:
        install(self._p)
        return self._p

    def __exit__(self, *exc) -> None:
        clear()


def rpc_truncate(index: Optional[int]) -> bool:
    """Module-level dispatch for :meth:`FaultPlan.truncate_frame`;
    False when no plan is installed (the production-path answer)."""
    p = _PLAN
    return p is not None and p.truncate_frame(index)
