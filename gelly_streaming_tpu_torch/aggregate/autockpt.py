"""Periodic auto-checkpointing: the Flink-transparent restore analog (the
port's copy of ``gelly_streaming_tpu/aggregate/autockpt.py``; a barrier
file of either package resumes in the other).

The reference inherits fault tolerance from Flink: ``Merger implements
ListCheckpointed`` (``SummaryAggregation.java:127-135``) — the runtime
snapshots the running summary on every checkpoint barrier and, on
failover, restores it and replays the source from the checkpointed
offset. ``aggregate/checkpoint.py`` covers the snapshot; this module adds
the BARRIER and the RESUME so a killed process restarts and finishes with
output identical to an uninterrupted run:

- every ``every`` windows, :class:`AutoCheckpoint` atomically writes ONE
  file (state + vertex dictionary + windows_done) via write-temp +
  ``os.replace`` — a kill mid-snapshot leaves the previous barrier
  intact;
- on restart, the state restores and the replayed source fast-forwards
  by the recorded window count. The skipped windows still flow through
  the vertex dictionary (replay is idempotent: first-seen ordinal
  compaction assigns identical compact ids on identical prefixes), so
  ids assigned after resume continue exactly where the checkpoint left
  off.

Works for both carried-state workloads (``state_dict``/
``load_state_dict``: triangles, PageRank, spanner, samplers, SAGE,
degrees) and engine aggregations (``snapshot_state``/``restore_state``:
CC, bipartiteness, ...). Emissions between the last barrier and a kill
are re-emitted after resume, like Flink's at-least-once outputs without
transactional sinks (the ``Supervisor`` dedupes them within a process).

SUPERBATCH GRANULARITY: under ``superbatch=K > 1`` the carried summary is
only observable on group boundaries, so barriers land only on window
indices that are BOTH a multiple of ``every`` and a group boundary
(effectively ``lcm(every, K)``); mid-superbatch kills restore from the
last group-aligned barrier and replay.

THE PAYLOAD HOLDS NUMPY AND BUILTINS ONLY: ``{windows_done, kind, state,
vdict}``, the aggregation kind's ``state`` being ``{"summary": <numpy
pytree>, "vcap": int}`` and ``vdict`` the plain dict of
:meth:`AutoCheckpoint._vdict_payload`. No tensor and no class of this
package is pickled, so the JAX package unpickles a barrier of this one
without it, and the reverse.

THE DEVICE WAIT. A barrier's ``checkpoint.barrier_wait`` span is the
state capture: the download that waits on the carry's device work (and,
for CC's forest carry, the host resolution of the forest to flat labels);
``checkpoint.serialize`` is the pickle, the checksum and the write.

ADAPTIVE K: under ``superbatch="auto"`` the controller re-tiles the groups
mid-run, so no static stride exists; a barrier lands on the FIRST group
boundary at least ``every`` windows past the previous barrier (the work's
``checkpoint_aligned``), and a resume re-packs the skipped windows through
the dynamic packer (``_SkipStream.superbatches_dynamic``).
"""

from __future__ import annotations

import math
import os
import pickle
import re
import time
from typing import Any, Callable, Iterator, Optional

import numpy as np

from ..control.signals import SignalReader, add_excluded_s
from ..obs import trace as _trace
from ..resilience import faults as _faults
from ..resilience import integrity as _integrity
from .checkpoint import host_tree

#: the barrier and segment stopwatch (a test replaces it with a stub clock)
_clock = time.perf_counter


class _SkipStream:
    """View of a stream whose first ``skip`` windows are consumed (for
    vertex-dictionary replay) but not surfaced to the workload."""

    def __init__(self, stream, skip: int):
        self._stream = stream
        self._skip = skip

    def __getattr__(self, name):
        return getattr(self._stream, name)

    def blocks(self):
        it = self._stream.blocks()
        for i, block in enumerate(it):
            if i >= self._skip:
                yield block

    def superbatches(self, k: int):
        """Group-granular replay skip. ``skip`` is always group-aligned
        (barriers land on ``checkpoint_granularity`` multiples), so when
        the wrapped stream has a packer and the tiling agrees, ``skip //
        k`` whole groups are skipped THROUGH it: they still pack (the
        vertex-dictionary replay) and are never surfaced. A misaligned
        ``k`` (the work was reconfigured between runs) falls back to
        packing the skipped block iterator."""
        inner = getattr(self._stream, "superbatches", None)
        if callable(inner) and self._skip % k == 0:
            it = inner(k)
            for _ in range(self._skip // k):
                if next(it, None) is None:
                    break
            yield from it
            return
        from ..core.pipeline import prefetch, superbatch_prefetch_depth
        from ..core.window import superbatches_from_blocks

        yield from superbatches_from_blocks(
            prefetch(self.blocks(), superbatch_prefetch_depth(k),
                     device=getattr(self._stream, "device", None)), k
        )

    def superbatches_dynamic(self, k_fn, skip: int = 0):
        """The adaptive-K replay skip (the ``superbatch="auto"`` resume):
        the inner dynamic packer packs the skipped windows (the
        vertex-dictionary replay) without surfacing them. The resumed
        controller may re-tile from the barrier on: values are the same
        under any tiling, and barriers only land on group boundaries.
        Defined here so that ``__getattr__`` never hands out the inner
        stream's packer with the skip dropped."""
        inner = getattr(self._stream, "superbatches_dynamic", None)
        if callable(inner):
            yield from inner(k_fn, skip=self._skip + skip)
            return
        from ..core.pipeline import prefetch, superbatch_prefetch_depth
        from ..core.window import superbatches_from_blocks_dynamic

        # self.blocks() consumes self._skip; a nested wrapper's skip too
        blocks = self.blocks()
        for _ in range(skip):
            if next(blocks, None) is None:
                break
        yield from superbatches_from_blocks_dynamic(
            prefetch(blocks, superbatch_prefetch_depth(int(k_fn())),
                     device=getattr(self._stream, "device", None)),
            k_fn,
        )


class AutoCheckpoint:
    """Snapshot ``work`` every ``every`` windows; resume transparently.

    ``run(make_stream, work)`` yields the per-window emissions exactly as
    ``work.run(stream)`` (or ``aggregation.run(stream)``) would, starting
    from the last completed barrier when ``path`` holds one.
    ``make_stream(vdict)`` must build the stream over the SAME source,
    with ``vdict`` (restored; None on a fresh start) as its vertex
    dictionary when given.

    INTEGRITY + ROTATION: each barrier commits as a checksummed container
    (CRC32 over the pickled payload) via temp + ``os.replace``, and the
    previous ``keep - 1`` barriers rotate to ``path.1``, ``path.2``, ...
    (renames only — a kill mid-rotation loses nothing). Loading scans
    head-first and falls back to the NEWEST VALID barrier when the head is
    torn, truncated, or corrupt; every rejected artifact is recorded as
    ``resilience.ckpt_rejected`` in the obs registry and warned. If every
    barrier is invalid the run restarts from scratch after recording each
    rejection — recovery never silently loads damage.
    """

    #: ``every="auto"``: barrier-overhead budget as a fraction of wall
    #: time, and the cadence clamp the tuner moves within
    AUTO_TARGET_OVERHEAD = 0.05
    AUTO_MIN_EVERY = 1
    AUTO_MAX_EVERY = 4096

    def __init__(self, path: str, every=8, keep: int = 2, *,
                 target_overhead: Optional[float] = None):
        self.path = path
        #: ``every="auto"`` tunes the cadence from the measured cost of
        #: each barrier vs the measured per-window wall time, so at most
        #: ``target_overhead`` of the run is spent inside barriers. The
        #: tuned value is re-derived after every barrier and always lands
        #: on a superbatch-group boundary (see run()).
        self.auto = every == "auto"
        self.every = 2 if self.auto else int(every)
        self.target_overhead = float(
            self.AUTO_TARGET_OVERHEAD if target_overhead is None else target_overhead
        )
        #: barrier and window costs are direct taps on a SignalReader, so
        #: tuning works with obs disabled
        self.signals = SignalReader()
        self.keep = max(1, int(keep))
        #: artifacts already rejected, keyed by (path, mtime_ns, size):
        #: repeated scans must not re-count the SAME damaged bytes; an
        #: externally replaced file gets a new key and re-validates
        self._rejected_seen: set = set()
        self._cache = None  # loaded payload (invalidated on snapshot)
        # True when _cache holds a scan RESULT, the negative "no barrier
        # found" one included: one attempt's reads must all agree
        self._cache_valid = False
        #: vertex dictionary restored by the last :meth:`run` (None on a
        #: fresh start), for consumers that decode restored state when the
        #: resumed stream yields nothing
        self.restored_vdict = None

    # ------------------------------------------------------------------ #
    @property
    def measured_barrier_s(self) -> Optional[float]:
        """Last measured barrier cost in seconds (state capture +
        serialize + commit; None before the first barrier)."""
        return self.signals.last("checkpoint.barrier_s")

    @property
    def measured_window_s(self) -> Optional[float]:
        """Last measured mean per-window wall seconds of the segment before
        a barrier (None before the first)."""
        return self.signals.last("checkpoint.window_s")

    # ------------------------------------------------------------------ #
    def invalidate(self) -> None:
        """Drop the cached barrier payload so the next read re-scans the
        disk (the supervisor calls this before every (re)start attempt)."""
        self._cache = None
        self._cache_valid = False

    def discard(self) -> None:
        """Delete every artifact of THIS checkpoint — the head, its
        crash-leftover temp, and all numbered rotation slots — and drop
        the cache: the fresh-start path (the example CLIs' ``--fresh``).
        Prefix-sharing siblings (``/d/run1`` vs ``/d/run10``) are never
        touched."""
        d, base = os.path.split(self.path)
        try:
            names = os.listdir(d or ".")
        except OSError:
            names = []
        for name in names:
            if name == base or name == base + ".tmp" or (
                name.startswith(base + ".")
                and re.fullmatch(r"\d+", name[len(base) + 1:])
            ):
                try:
                    os.remove(os.path.join(d or ".", name))
                except OSError:
                    pass
        self._cache = None
        self._cache_valid = False

    def windows_done(self) -> int:
        """Windows completed at the last barrier (0 if no checkpoint)."""
        payload = self._load()
        return 0 if payload is None else payload["windows_done"]

    def run(self, make_stream: Callable, work) -> Iterator[Any]:
        with _trace.span("checkpoint.restore") as sp:
            payload = self._load()
            done = 0
            vdict = None
            if payload is not None:
                done = payload["windows_done"]
                vdict = self._restore_vdict(payload["vdict"])
                self._restore_work(work, payload)
            if sp.recording:
                sp.set(windows_done=done)
        self.restored_vdict = vdict
        stream = make_stream(vdict)
        src = _SkipStream(stream, done) if done else stream
        # barrier alignment (see module doc): the work reports its
        # EFFECTIVE granularity (1 when its run loop opts out of
        # superbatching), and group-folded workloads their exact group
        # boundaries (checkpoint_aligned over windows-since-resume)
        gran = getattr(work, "checkpoint_granularity", None)
        k = int(gran()) if callable(gran) else 1
        if self.auto and self.every % k:
            self.every = self.every + (k - self.every % k)
        aligned = getattr(work, "checkpoint_aligned", None)
        use_pred = callable(aligned)
        # a dynamically tiled work (superbatch="auto") has no static group
        # stride for the modulo cadence to meet: its barriers land on the
        # FIRST group boundary at least `every` windows past the previous
        # barrier (the counting rule of the auto cadence)
        dynamic = bool(getattr(work, "superbatch_auto", False))
        w = done
        last_barrier = done
        seg_t0 = _clock()  # start of the inter-barrier segment
        for batch in work.run(src):
            yield batch
            w += 1
            # the fixed cadence keeps the modulo rule (barriers on
            # multiples of `every`, a resume re-tiles identically); the
            # auto tuner counts windows SINCE the last barrier, because
            # `every` itself moves between barriers
            due = (w - last_barrier >= self.every if self.auto or dynamic
                   else w % self.every == 0)
            ok = aligned(w - done) if use_pred else w % k == 0
            if due and ok:
                window_s = (_clock() - seg_t0) / max(1, w - last_barrier)
                self._snapshot(work, stream.vertex_dict, w)
                last_barrier = w
                if self.auto:
                    self._retune(window_s, k)
                seg_t0 = _clock()

    def _retune(self, window_s: float, k: int) -> None:
        """Re-derive the auto cadence from the just-measured barrier cost
        and the measured per-window wall time: ``every >= barrier_s /
        (target_overhead * window_s)`` keeps the fraction of wall time
        spent in barriers at or under the target, rounded UP to a
        superbatch-group multiple and clamped to [AUTO_MIN_EVERY,
        AUTO_MAX_EVERY]."""
        self.signals.observe("checkpoint.window_s", window_s)
        barrier_s = self.measured_barrier_s
        if not barrier_s or window_s <= 0:
            return
        want = math.ceil(barrier_s / (self.target_overhead * window_s))
        want = max(self.AUTO_MIN_EVERY, want, k)
        if want % k:
            want = want + (k - want % k)
        # clamp AFTER rounding, to the largest superbatch multiple under
        # the ceiling (never below k itself: barriers must stay aligned)
        cap = max(self.AUTO_MAX_EVERY - self.AUTO_MAX_EVERY % k, k)
        self.every = min(want, cap)

    def restored_emission(self, work):
        """For ENGINE aggregations: the emission the restored barrier's
        summary would produce — what a consumer should surface when
        :meth:`run` yields nothing because the barrier already covers the
        whole source. None for workload-kind objects."""
        if hasattr(work, "state_dict") or not hasattr(work, "transform"):
            return None
        return work.transform(work._summary, self.restored_vdict)

    # ------------------------------------------------------------------ #
    def _snapshot(self, work, vdict, windows_done: int) -> None:
        t0 = _clock()
        with _trace.span(
            "checkpoint.barrier",
            {"windows_done": windows_done} if _trace.on() else None,
        ) as sp:
            # barrier_wait: capturing the state waits on the carry's
            # in-flight device work (the download is the sync), kept
            # apart from the host serialize time below
            with _trace.span("checkpoint.barrier_wait"):
                if hasattr(work, "state_dict"):
                    kind, state = "workload", work.state_dict()
                else:
                    kind = "aggregation"
                    snap = work.snapshot_state()
                    state = {
                        "summary": snap if getattr(work, "host_state", False)
                        else host_tree(snap),
                        "vcap": int(work._vcap),
                    }
            if sp.recording:
                sp.set(kind=kind)
            payload = {
                "windows_done": windows_done,
                "kind": kind,
                "state": state,
                "vdict": self._vdict_payload(vdict),
            }
            with _trace.span("checkpoint.serialize"):
                committed = self._commit(payload)
        # invalidate, do NOT cache: payload["state"] may alias LIVE
        # workload arrays; only the pickled file is a point-in-time copy
        self._cache = None
        self._cache_valid = False
        barrier_s = _clock() - t0
        self.signals.observe("checkpoint.barrier_s", barrier_s)
        # credited as FOREIGN time to this thread's throughput taps
        add_excluded_s(barrier_s)
        if _faults.active():  # chaos hook: corrupt the barrier just written
            _faults.fire("checkpoint.committed", index=windows_done, path=committed)

    def _commit(self, payload: dict) -> str:
        """Serialize + atomically commit one barrier; returns the committed
        path (the chaos corruption hook's target)."""
        data = _integrity.wrap_checksummed(pickle.dumps(payload))
        tmp = self.path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(data)
        self._rotate()
        os.replace(tmp, self.path)  # atomic barrier commit
        return self.path

    def _rotate(self) -> None:
        """Shift committed barriers one slot down (``path`` -> ``path.1`` ->
        ... -> dropped past ``keep - 1``) ahead of a new head commit.
        Renames only. A head this instance already REJECTED is unlinked
        instead of rotated: shifting corrupt bytes over ``path.1`` would
        overwrite the good fallback those bytes forced us onto."""
        if self.keep <= 1:
            return
        try:
            st = os.stat(self.path)
            if (self.path, st.st_mtime_ns, st.st_size) in self._rejected_seen:
                os.remove(self.path)
        except OSError:
            pass
        for i in range(self.keep - 1, 0, -1):
            src = self.path if i == 1 else f"{self.path}.{i - 1}"
            if os.path.exists(src):
                os.replace(src, f"{self.path}.{i}")

    #: keys a valid barrier payload must carry
    _PAYLOAD_KEYS = frozenset(("windows_done", "kind", "state", "vdict"))

    def _load(self) -> Optional[dict]:
        """Read (and cache) the NEWEST VALID barrier payload: head first,
        then the rotation slots; invalid artifacts are rejected (recorded +
        warned) and the scan falls through to the previous barrier. The
        negative result caches too; :meth:`invalidate` re-scans."""
        if self._cache_valid:
            return self._cache
        payload = None
        for cand in self._candidates():
            payload = self._read_barrier(cand)
            if payload is not None:
                break
        self._cache = payload
        self._cache_valid = True
        return payload

    def _candidates(self) -> list:
        """Barrier files newest-first: the head plus every rotation slot on
        disk. The scan TOLERATES GAPS (a kill between two rotation renames
        leaves e.g. ``path`` and ``path.2`` with no ``path.1``) and runs
        past ``self.keep`` with slack, so a reader configured with a
        smaller ``keep`` than the writer's still sees the deeper history."""
        out = [self.path]
        for i in range(1, max(self.keep + 1, 9)):
            p = f"{self.path}.{i}"
            if os.path.exists(p):
                out.append(p)
        return out

    def _read_barrier(self, path: str) -> Optional[dict]:
        """One candidate: unwrap + checksum + unpickle + shape-check.
        Returns None (after recording the rejection ONCE per damaged file
        version) on any damage."""
        try:
            st = os.stat(path)
        except FileNotFoundError:
            return None
        except OSError as e:
            key = (path, "stat", type(e).__name__)
            if key not in self._rejected_seen:
                self._rejected_seen.add(key)
                _integrity.record_rejection(path, f"unstatable: {e!r}")
            return None
        key = (path, st.st_mtime_ns, st.st_size)
        if key in self._rejected_seen:
            return None
        try:
            with open(path, "rb") as f:
                data = f.read()
        except OSError as e:
            self._rejected_seen.add(key)
            _integrity.record_rejection(path, repr(e))
            return None
        return self._barrier_payload(data, path, key)

    def _barrier_payload(self, data: bytes, origin: str, key) -> Optional[dict]:
        """Validate one barrier's BYTES — unwrap + checksum + unpickle +
        shape-check. Returns None (after recording the rejection once per
        ``key``) on any damage."""
        if key in self._rejected_seen:
            return None
        try:
            payload = pickle.loads(_integrity.unwrap_checksummed(data, origin=origin))
            if not isinstance(payload, dict) or not self._PAYLOAD_KEYS <= payload.keys():
                raise ValueError("barrier payload missing required keys")
            return payload
        except Exception as e:
            self._rejected_seen.add(key)
            _integrity.record_rejection(origin, repr(e))
            return None

    def _restore_work(self, work, payload: dict) -> None:
        if payload["kind"] == "workload":
            work.load_state_dict(payload["state"])
        else:
            work.restore_state(payload["state"]["summary"], vcap=payload["state"]["vcap"])

    # ------------------------------------------------------------------ #
    @staticmethod
    def _vdict_payload(vdict) -> Optional[dict]:
        """The vertex dictionary as the plain dict both packages write."""
        from ..core.vertexdict import VertexDict
        from ..datasets import IdentityDict

        if isinstance(vdict, VertexDict):
            return {"kind": "vertexdict", "raw_ids": np.asarray(vdict.raw_ids())}
        if isinstance(vdict, IdentityDict):
            return {"kind": "identity", "id_bound": int(vdict.id_bound),
                    "observed": int(len(vdict))}
        return None

    @staticmethod
    def _restore_vdict(payload: Optional[dict]):
        if payload is None:
            return None
        if payload["kind"] == "vertexdict":
            from ..core.vertexdict import VertexDict

            d = VertexDict()
            if len(payload["raw_ids"]):
                d.encode(payload["raw_ids"])
            return d
        from ..datasets import IdentityDict

        d = IdentityDict(payload["id_bound"])
        d.observe(payload["observed"] - 1)
        return d
