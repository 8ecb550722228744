"""The sliding-window drive loop: close -> retract -> fold -> emit (the
port's copy of ``gelly_streaming_tpu/eventtime/stream.py``).

:class:`SlidingGraphAggregator` runs one crash-recoverable order per
closed pane:

1. **close**: the pane assembler hands over the pane the merged watermark
   passed (``eventtime.pane_close``);
2. **retract**: panes that age out of the new window expire through the
   decremental summaries (forest repair, degree subtraction, cover repair
   and latch re-resolution; ``eventtime.retract``);
3. **fold**: the new pane's edges union in;
4. **commit**: with a ``commit_dir``, the whole state (summaries, live
   panes, clocks) commits as ONE atomic checksummed artifact BEFORE the
   window result is emitted.

The fault hook ``eventtime.retract`` fires between steps 3 and 4: the
summaries have mutated, the commit has not happened. Recovery restores the
last committed pane boundary and the source replays; records of
already-committed panes drop as late (their slot closed), panes from
``done_panes`` on re-close and re-fold, and the answers equal an
uninterrupted run's.

``verify=True`` compares every emission with the from-scratch oracles on
the surviving edge multiset and raises on a mismatch.

The artifact is an ``np.savez`` of the same arrays under the same names as
the reference's, in the same checksummed frame, so either package restores
the other's.
"""

from __future__ import annotations

import dataclasses
import io
import os
import time
from typing import Iterator, List, Optional, Tuple

import numpy as np

from ..obs.registry import get_registry
from ..resilience import faults as _faults
from ..resilience.integrity import (
    replace_atomic,
    unwrap_checksummed,
    wrap_checksummed,
)
from .panes import EventTimeSlidingWindow, Pane, PaneAssembler
from .retract import (
    DecBipartite,
    DecDegree,
    DecForest,
    oracle_bipartite,
    oracle_degrees,
    oracle_labels,
)
from .watermark import NO_WATERMARK, WatermarkTracker

#: the committed state artifact's filename inside ``commit_dir``
STATE_FILE = "eventtime_state.bin"

_SUMMARIES = ("cc", "degree", "bipartite")


@dataclasses.dataclass
class WindowResult:
    """One emitted sliding window: the summaries over the surviving edge
    multiset of panes ``[end_pane - panes_per_window + 1, end_pane]``,
    stamped with the event-time watermark at emission."""

    index: int          # the window's END pane index
    start: int          # event-time start (may predate the stream)
    end: int            # event-time end, exclusive
    event_ts: int       # merged watermark at emission
    n_edges: int        # live multiset size
    labels: Optional[np.ndarray] = None
    degrees: Optional[np.ndarray] = None
    top: Optional[list] = None
    bipartite: Optional[bool] = None
    witness: Optional[int] = None
    repair: Optional[dict] = None  # last retraction's repair stats


class SlidingGraphAggregator:
    """Event-time sliding CC/degree/bipartiteness with retraction.

    ``size``/``slide`` are event-time units (``slide=None``: tumbling);
    ``allowed_lateness`` is the pane assembler's lateness policy;
    ``nshards`` the watermark tracker's width (the min-merge rule).
    ``summaries`` picks which decremental summaries run. Timestamps arrive
    as a per-record i64 column (:meth:`push`), and the clock advances from
    data per shard, or explicitly via :meth:`advance_watermark`.
    Single-writer, like every carry of the package.
    """

    def __init__(
        self,
        size: int,
        slide: Optional[int] = None,
        *,
        allowed_lateness: int = 0,
        nshards: int = 1,
        summaries: Tuple[str, ...] = _SUMMARIES,
        heavy_k: int = 8,
        commit_dir: Optional[str] = None,
        verify: bool = False,
    ):
        for s in summaries:
            if s not in _SUMMARIES:
                raise ValueError(
                    f"unknown summary {s!r}; pick from {_SUMMARIES}"
                )
        self.policy = EventTimeSlidingWindow(size, slide)
        self.assembler = PaneAssembler(
            self.policy, allowed_lateness=allowed_lateness
        )
        self.tracker = WatermarkTracker(nshards)
        self.summaries = tuple(summaries)
        self.heavy_k = int(heavy_k)
        self.commit_dir = commit_dir
        self.verify = bool(verify)
        self._cc = DecForest() if "cc" in summaries else None
        self._deg = DecDegree() if "degree" in summaries else None
        self._bip = DecBipartite() if "bipartite" in summaries else None
        self._live: List[Pane] = []   # panes inside the current span
        self._done_panes: Optional[int] = None  # next pane index to fold
        self._pane_close = None  # lazy counters
        self._retract = None
        self._replayed = None
        self._finished = False

    # ------------------------------------------------------------------ #
    # Ingest
    # ------------------------------------------------------------------ #
    def push(self, src, dst, ts, *, shard: int = 0) -> List[WindowResult]:
        """Feed one timestamped column chunk from ``shard``; returns the
        window results its watermark advance released (possibly none: one
        slow shard holds the clock)."""
        # records precede their watermark: the chunk buffers against the
        # PRIOR merged clock, then the clock advances and closes the panes
        # it passed
        self.assembler.add(src, dst, ts, self.tracker.current())
        wm = self.tracker.observe(shard, ts)
        return self._drain(wm)

    def advance_watermark(self, watermark: int, *,
                          shard: int = 0) -> List[WindowResult]:
        """Explicit per-shard watermark punctuation (no records)."""
        wm = self.tracker.observe(shard, np.int64(watermark))
        return self._drain(wm)

    def finish(self) -> List[WindowResult]:
        """End of stream: every shard's promise becomes total, every open
        pane closes, the tail windows emit."""
        if self._finished:
            return []
        self._finished = True
        for s in range(self.tracker.nshards):
            self.tracker.finish(s)
        return self._process(self.assembler.flush())

    def _drain(self, wm: int) -> List[WindowResult]:
        return self._process(self.assembler.advance(wm))

    # ------------------------------------------------------------------ #
    # The pane cycle
    # ------------------------------------------------------------------ #
    def _process(self, panes: List[Pane]) -> List[WindowResult]:
        out: List[WindowResult] = []
        for pane in panes:
            if self._done_panes is not None and \
                    pane.index < self._done_panes:
                # at-least-once replay after a restore: the committed state
                # already folded this pane (counted, not silent)
                if self._replayed is None:
                    self._replayed = get_registry().counter(
                        "eventtime.replayed_panes"
                    )
                self._replayed.inc()
                continue
            out.append(self._cycle(pane))
        return out

    def _cycle(self, pane: Pane) -> WindowResult:
        if self._pane_close is None:
            self._pane_close = get_registry().counter("eventtime.pane_close")
            self._retract = get_registry().counter("eventtime.retract")
        self._pane_close.inc()
        self._grow_for(pane)
        nw = self.policy.panes_per_window
        # retract FIRST: panes leaving the span as `pane` enters it
        expired = []
        while self._live and self._live[0].index <= pane.index - nw:
            expired.append(self._live.pop(0))
        repair_stats = None
        if expired and any(len(p) for p in expired):
            exp_s = np.concatenate([p.src for p in expired])
            exp_d = np.concatenate([p.dst for p in expired])
            sur_s, sur_d = self._live_cols()
            if self._deg is not None:
                self._deg.retract(exp_s, exp_d)
            if self._cc is not None:
                repair_stats = self._cc.retract(exp_s, exp_d, sur_s, sur_d)
            if self._bip is not None:
                self._bip.retract(exp_s, exp_d, sur_s, sur_d)
            self._retract.inc()
        # fold the new pane in (the add-only path)
        if len(pane):
            if self._deg is not None:
                self._deg.add(pane.src, pane.dst)
            if self._cc is not None:
                self._cc.add(pane.src, pane.dst)
            if self._bip is not None:
                self._bip.add(pane.src, pane.dst)
        self._live.append(pane)
        self._done_panes = pane.index + 1
        # the chaos target: summaries mutated, commit not yet durable
        if _faults.active():
            _faults.fire("eventtime.retract", index=pane.index)
        if self.commit_dir is not None:
            self.commit()
        res = self._emit(pane, repair_stats)
        if self.verify:
            self._self_check(res)
        return res

    def _grow_for(self, pane: Pane) -> None:
        if not len(pane):
            return
        need = int(max(pane.src.max(), pane.dst.max())) + 1
        for summary in (self._deg, self._cc, self._bip):
            if summary is not None:
                summary.grow(need)

    def _live_cols(self) -> Tuple[np.ndarray, np.ndarray]:
        if not self._live:
            z = np.zeros(0, np.int64)
            return z, z
        return (
            np.concatenate([p.src for p in self._live]),
            np.concatenate([p.dst for p in self._live]),
        )

    def _emit(self, pane: Pane,
              repair_stats: Optional[dict]) -> WindowResult:
        res = WindowResult(
            index=pane.index,
            start=pane.end - self.policy.size,
            end=pane.end,
            event_ts=self.tracker.current(),
            n_edges=int(sum(len(p) for p in self._live)),
            repair=repair_stats,
        )
        if self._cc is not None:
            res.labels = self._cc.labels().copy()
        if self._deg is not None:
            res.degrees = self._deg.deg.copy()
            res.top = self._deg.top_k(self.heavy_k)
        if self._bip is not None:
            res.bipartite = self._bip.is_bipartite()
            res.witness = self._bip.conflict_witness()
        return res

    # ------------------------------------------------------------------ #
    # Oracle self-check (the zero-mismatch contract)
    # ------------------------------------------------------------------ #
    def _self_check(self, res: WindowResult) -> None:
        s, d = self._live_cols()
        if res.labels is not None:
            if not np.array_equal(res.labels,
                                  oracle_labels(self._cc.vcap, s, d)):
                raise AssertionError(
                    f"window {res.index}: CC labels diverge from the "
                    "from-scratch oracle on the surviving multiset"
                )
        if res.degrees is not None:
            if not np.array_equal(res.degrees,
                                  oracle_degrees(self._deg.vcap, s, d)):
                raise AssertionError(
                    f"window {res.index}: degrees diverge from the "
                    "from-scratch oracle on the surviving multiset"
                )
        if res.bipartite is not None:
            want = oracle_bipartite(self._bip.vcap, s, d)
            if res.bipartite != want:
                raise AssertionError(
                    f"window {res.index}: bipartite verdict "
                    f"{res.bipartite} diverges from the oracle {want}"
                )

    # ------------------------------------------------------------------ #
    # Commit / restore (atomic, checksummed)
    # ------------------------------------------------------------------ #
    def commit(self) -> str:
        """Commit the full state as ONE atomic checksummed artifact;
        returns its path. Live panes, summaries, clocks and the pane cursor
        travel together, so a restore can never pair a post-retraction
        summary with a pre-retraction pane list."""
        if self.commit_dir is None:
            raise RuntimeError("no commit_dir configured")
        os.makedirs(self.commit_dir, exist_ok=True)
        arrays = {
            "done_panes": np.asarray(
                [-1 if self._done_panes is None else self._done_panes],
                np.int64,
            ),
            "marks": np.asarray(self.tracker.state_dict()["marks"], np.int64),
            "live_meta": np.asarray(
                [[p.index, p.start, p.end] for p in self._live], np.int64,
            ).reshape(-1, 3),
        }
        for i, p in enumerate(self._live):
            arrays[f"pane{i}_src"] = p.src
            arrays[f"pane{i}_dst"] = p.dst
            arrays[f"pane{i}_ts"] = p.ts
        if self._cc is not None:
            arrays["cc_lab"] = self._cc.lab
        if self._deg is not None:
            arrays["deg"] = self._deg.deg
        if self._bip is not None:
            arrays["cover"] = self._bip.cover
            arrays["bip_vcap"] = np.asarray([self._bip.vcap], np.int64)
        buf = io.BytesIO()
        np.savez(buf, **arrays)
        path = os.path.join(self.commit_dir, STATE_FILE)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(wrap_checksummed(buf.getvalue()))
        replace_atomic(tmp, path)
        return path

    def restore(self) -> bool:
        """Load the last committed state; False when none exists. A corrupt
        artifact raises through ``unwrap_checksummed`` (a counted
        rejection); it is never half-loaded."""
        if self.commit_dir is None:
            raise RuntimeError("no commit_dir configured")
        path = os.path.join(self.commit_dir, STATE_FILE)
        if not os.path.exists(path):
            return False
        with open(path, "rb") as f:
            payload = unwrap_checksummed(f.read(), origin=path)
        data = np.load(io.BytesIO(payload))
        done = int(data["done_panes"][0])
        self._done_panes = None if done < 0 else done
        marks = data["marks"].tolist()
        self.tracker.load_state_dict({
            "marks": marks,
            "live": [True] * len(marks),
            "merged": NO_WATERMARK,
        })
        # re-merge from the restored marks (advances the gauge too)
        self.tracker.observe(0, np.zeros(0, np.int64))
        meta = data["live_meta"]
        self._live = [
            Pane(
                int(meta[i][0]), int(meta[i][1]), int(meta[i][2]),
                np.asarray(data[f"pane{i}_src"], np.int64),
                np.asarray(data[f"pane{i}_dst"], np.int64),
                np.asarray(data[f"pane{i}_ts"], np.int64),
            )
            for i in range(meta.shape[0])
        ]
        if self._cc is not None and "cc_lab" in data:
            self._cc.load_state_dict({"lab": data["cc_lab"]})
        if self._deg is not None and "deg" in data:
            self._deg.load_state_dict({"deg": data["deg"]})
        if self._bip is not None and "cover" in data:
            self._bip.load_state_dict({
                "vcap": int(data["bip_vcap"][0]),
                "cover": data["cover"],
            })
        # replayed records of already-folded panes must drop as late: the
        # assembler's closed-slot cursor is the committed cursor, SEALED
        if self._done_panes is not None:
            self.assembler._next_pane = self._done_panes
            self.assembler._sealed = True
        return True

    def servable_payload(self) -> dict:
        """The serving-shape snapshot payload: the summaries (host numpy
        copies, so a later pane never writes a published one) plus the
        ``event_ts`` watermark stamp the snapshot store publishes and
        :class:`~gelly_streaming_tpu_torch.serving.query.Answer`
        reports."""
        payload: dict = {"event_ts": int(self.tracker.current())}
        if self._cc is not None:
            payload["labels"] = self._cc.labels().copy()
        if self._deg is not None:
            payload["deg"] = self._deg.deg.copy()
        if self._bip is not None:
            payload["bipartite"] = self._bip.is_bipartite()
        return payload


def drive_sliding(
    windows_ts: Iterator, agg: SlidingGraphAggregator, *,
    deadline_s: Optional[float] = None,
) -> List[WindowResult]:
    """Drive an aggregator from ``(shard, src, dst, val|None, ts)`` tuples
    (the ``windows_ts()`` shape of a sharded source). ``deadline_s`` is a
    TOTAL wall budget: once spent, the drive stops consuming and flushes
    what it has (a bound for smoke runs, not a correctness knob)."""
    deadline = (
        None if deadline_s is None else time.monotonic() + deadline_s
    )
    results: List[WindowResult] = []
    for shard, src, dst, _val, ts in windows_ts:
        results.extend(agg.push(src, dst, ts, shard=shard))
        if deadline is not None and time.monotonic() >= deadline:
            break
    results.extend(agg.finish())
    return results
