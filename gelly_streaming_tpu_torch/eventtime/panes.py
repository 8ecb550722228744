"""Pane/slice decomposition: sliding windows as unions of tumbling panes
(the port's copy of ``gelly_streaming_tpu/eventtime/panes.py``).

A sliding window of ``(size, slide)`` with ``size % slide == 0`` is the
union of ``size // slide`` consecutive PANES of length ``slide``: each
record is stored ONCE, in its pane, and windows are composed at emission.
Panes matter for two reasons:

1. **They pack like count windows.** A closed pane is a plain raw-id
   column tuple, exactly what
   :meth:`~gelly_streaming_tpu_torch.core.window.Windower.pack_window_cols`
   packs into a :class:`~gelly_streaming_tpu_torch.core.window.SuperbatchGroup`,
   so the superbatch/group-fold path (``drive_group_folded``, prefetch,
   checkpointing, auto-K) consumes event-time panes unchanged, on the
   stream's device.
2. **They are the retraction unit.** When the window slides, exactly one
   pane expires; its edge columns are kept until then, so retraction gets
   the expired multiset AND the surviving one as concatenations of views.

LATENESS: a record whose pane already closed is DROPPED and counted
``eventtime.late_dropped``, never silently absorbed into a closed pane
(which would corrupt the retraction arithmetic). Records inside the
allowance land in their pane while it is open; panes close once the
watermark passes ``pane_end + allowed_lateness``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..obs.registry import get_registry
from .watermark import NO_WATERMARK


@dataclasses.dataclass(frozen=True)
class EventTimeSlidingWindow:
    """The sliding event-time policy: ``size`` and ``slide`` in event time
    units (``slide == size`` is tumbling). The pane length is ``slide``;
    ``size % slide == 0`` is required so every window is whole panes."""

    size: int
    slide: Optional[int] = None

    def __post_init__(self):
        slide = self.size if self.slide is None else self.slide
        object.__setattr__(self, "slide", int(slide))
        object.__setattr__(self, "size", int(self.size))
        if self.size < 1:
            raise ValueError(f"size must be >= 1, got {self.size}")
        if self.slide < 1 or self.slide > self.size:
            raise ValueError(
                f"slide must be in [1, size], got {self.slide}"
            )
        if self.size % self.slide:
            raise ValueError(
                f"size ({self.size}) must be a multiple of slide "
                f"({self.slide}) — sliding windows decompose into "
                "whole panes"
            )

    @property
    def pane_size(self) -> int:
        return self.slide

    @property
    def panes_per_window(self) -> int:
        return self.size // self.slide

    def pane_of(self, ts) -> np.ndarray:
        """Pane index per timestamp (floor division, i64 exact)."""
        return np.floor_divide(np.asarray(ts, np.int64), self.slide)


@dataclasses.dataclass
class Pane:
    """One closed pane: the raw-id edge columns that arrived inside
    ``[start, end)``, kept until the pane expires out of its last window."""

    index: int
    start: int
    end: int
    src: np.ndarray
    dst: np.ndarray
    ts: np.ndarray

    def __len__(self) -> int:
        return len(self.src)

    def cols(self) -> Tuple[np.ndarray, np.ndarray, None]:
        """The ``(src, dst, val|None)`` triple ``pack_window_cols`` packs:
        a closed pane IS a closed count window to the superbatch path."""
        return self.src, self.dst, None


class PaneAssembler:
    """Assign arriving edge columns to panes; close panes as the watermark
    passes them; drop (and count) records past the lateness allowance.

    ``add(src, dst, ts, watermark)`` buffers per-pane column chunks
    (whole-array numpy bucketing). ``advance(watermark)`` returns every
    pane whose ``end + allowed_lateness <= watermark``, in index order,
    EMPTY panes between closed ones included (emission cadence is event
    time, not data arrival). ``flush()`` closes everything left (end of
    stream)."""

    def __init__(self, policy: EventTimeSlidingWindow, *,
                 allowed_lateness: int = 0):
        if allowed_lateness < 0:
            raise ValueError(
                f"allowed_lateness must be >= 0, got {allowed_lateness}"
            )
        self.policy = policy
        self.allowed_lateness = int(allowed_lateness)
        self._open: Dict[int, list] = {}   # pane index -> column chunks
        self._next_pane: Optional[int] = None  # lowest un-closed slot
        # False until a slot ACTUALLY closes (or a restore pins the
        # cursor): before then ``_next_pane`` is only the earliest pane
        # SEEN, and a cross-shard record for an earlier pane is legal
        self._sealed = False
        self._late = None  # lazy eventtime.late_dropped counter

    def _count_late(self, n: int) -> None:
        if self._late is None:
            self._late = get_registry().counter("eventtime.late_dropped")
        self._late.inc(n)

    def add(self, src, dst, ts, watermark: int = NO_WATERMARK) -> int:
        """Buffer one column chunk, dropping records later than the
        allowance relative to ``watermark`` (the CALLER's merged clock: the
        assembler owns no tracker, so shard-merge policy stays in one
        place). Returns the number of late-dropped records."""
        src = np.asarray(src, np.int64)
        dst = np.asarray(dst, np.int64)
        ts = np.asarray(ts, np.int64)
        if not (len(src) == len(dst) == len(ts)):
            raise ValueError(
                f"src/dst/ts column lengths disagree: "
                f"{len(src)}/{len(dst)}/{len(ts)}"
            )
        if len(src) == 0:
            return 0
        dropped = 0
        if watermark != NO_WATERMARK:
            horizon = watermark - self.allowed_lateness
            # a record is late when its PANE already closed: panes close at
            # end + lateness <= watermark, i.e. pane_end <= horizon
            pane_end = (self.policy.pane_of(ts) + 1) * self.policy.slide
            late = pane_end <= horizon
            dropped = int(late.sum())
            if dropped:
                self._count_late(dropped)
                keep = ~late
                src, dst, ts = src[keep], dst[keep], ts[keep]
                if len(src) == 0:
                    return dropped
        panes = self.policy.pane_of(ts)
        if self._next_pane is not None and self._sealed:
            # a record whose pane ALREADY closed is late whatever the
            # allowance arithmetic says (its close consumed the slot)
            closed = panes < self._next_pane
            n_closed = int(closed.sum())
            if n_closed:
                dropped += n_closed
                self._count_late(n_closed)
                keep = ~closed
                src, dst, ts = src[keep], dst[keep], ts[keep]
                panes = panes[keep]
                if len(src) == 0:
                    return dropped
        lo = int(panes.min())
        if self._next_pane is None or (not self._sealed
                                       and lo < self._next_pane):
            self._next_pane = lo
        order = np.argsort(panes, kind="stable")
        sp, ss, sd, st = panes[order], src[order], dst[order], ts[order]
        bounds = np.nonzero(np.diff(sp))[0] + 1
        starts = np.concatenate([[0], bounds])
        ends = np.concatenate([bounds, [len(sp)]])
        for a, b in zip(starts.tolist(), ends.tolist()):
            p = int(sp[a])
            self._open.setdefault(p, []).append(
                (ss[a:b], sd[a:b], st[a:b])
            )
        return dropped

    def advance(self, watermark: int) -> List[Pane]:
        """Close every pane the watermark (minus the lateness allowance)
        has passed, in index order, empty slots included."""
        if watermark == NO_WATERMARK or self._next_pane is None:
            return []
        horizon = watermark - self.allowed_lateness
        out: List[Pane] = []
        while (self._next_pane + 1) * self.policy.slide <= horizon:
            out.append(self._close(self._next_pane))
            self._next_pane += 1
        return out

    def flush(self) -> List[Pane]:
        """Close everything left, in index order (end of stream)."""
        if self._next_pane is None:
            return []
        out: List[Pane] = []
        while self._open:
            out.append(self._close(self._next_pane))
            self._next_pane += 1
        return out

    def _close(self, p: int) -> Pane:
        self._sealed = True
        chunks = self._open.pop(p, None)
        slide = self.policy.slide
        if not chunks:
            z = np.zeros(0, np.int64)
            return Pane(p, p * slide, (p + 1) * slide, z, z, z)
        if len(chunks) == 1:
            s, d, t = chunks[0]
        else:
            s = np.concatenate([c[0] for c in chunks])
            d = np.concatenate([c[1] for c in chunks])
            t = np.concatenate([c[2] for c in chunks])
        return Pane(p, p * slide, (p + 1) * slide, s, d, t)

    # ------------------------------------------------------------------ #
    # Checkpoint surface
    # ------------------------------------------------------------------ #
    def state_dict(self) -> dict:
        return {
            "next_pane": self._next_pane,
            "sealed": self._sealed,
            "open": {
                int(p): [
                    (c[0].copy(), c[1].copy(), c[2].copy())
                    for c in chunks
                ]
                for p, chunks in self._open.items()
            },
        }

    def load_state_dict(self, state: dict) -> None:
        self._next_pane = (
            None if state["next_pane"] is None else int(state["next_pane"])
        )
        self._sealed = bool(state.get("sealed", self._next_pane is not None))
        self._open = {
            int(p): [
                (np.asarray(c[0], np.int64), np.asarray(c[1], np.int64),
                 np.asarray(c[2], np.int64))
                for c in chunks
            ]
            for p, chunks in state["open"].items()
        }
