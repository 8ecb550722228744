"""Multi-host coordinated barriers + cluster-level supervised recovery
(the port's copy of ``gelly_streaming_tpu/resilience/coordinated.py``;
host code: the epoch artifacts of either package restore in the other).

The reference scales out on Flink's cluster runtime, whose fault
tolerance is asynchronous barrier snapshotting (Carbone et al. 2015, the
Chandy-Lamport refinement): barriers flow through every parallel subtask
at the same stream position, each subtask snapshots its shard, and the
checkpoint coordinator declares the checkpoint complete only once EVERY
subtask has acknowledged — restore then uses exactly one complete
checkpoint, never a mix. This module is that protocol for the repo's
multi-controller SPMD layout (``parallel/multihost.py``), built on the
cluster transport fabric (``gelly_streaming_tpu_torch/fabric``) instead of an
RPC coordinator — every epoch artifact moves through a
:class:`~gelly_streaming_tpu_torch.fabric.Transport` (a bare directory path
coerces to the shared-dir backend, byte-identical to the historical
layout; a socket transport points the same protocol at the exchange
daemon):

- :class:`CoordinatedCheckpoint` (an
  :class:`~gelly_streaming_tpu_torch.aggregate.autockpt.AutoCheckpoint`
  subclass) aligns barriers across processes at the same
  superbatch-aligned window ordinal — every process runs the same
  ``every`` x granularity cadence, so barrier ordinals agree with no
  messages. Each process commits its SHARD's CRC-framed barrier
  (``e<ordinal>.p<pid>.ckpt``) plus a tiny rendezvous record
  (``e<ordinal>.p<pid>.json``: epoch, window ordinal, process id, shard
  container CRC) — the record commit is atomic and per-shard, so the
  commit path never blocks on peers (the "asynchronous" in asynchronous
  barrier snapshotting).
- :func:`select_epoch` is the restore-side coordinator analog: scan the
  rendezvous records, pick the NEWEST epoch for which every one of the
  ``num_processes`` shards has a valid artifact (record readable, shard
  file present, size + CRC matching), and fall back coherently past
  torn or incomplete epochs. Every process runs the same pure scan over
  the same directory, so all restarting processes agree on the epoch
  without talking — and a mixed-epoch restore (shard A from epoch 6,
  shard B from epoch 4) is impossible by construction: the selected
  epoch number IS the restore input for every shard.
- :class:`ClusterSupervisor` is the process-level restart strategy (the
  JobManager's "restart the whole job" policy): it spawns one worker
  process per shard, and when ANY worker dies it terminates the rest
  and relaunches all of them — each relaunched worker re-selects the
  same agreed epoch, restores its shard, and replays with the
  deduplication the in-process
  :class:`~gelly_streaming_tpu_torch.resilience.supervisor.Supervisor`
  already provides.

Every coordination event is visible in the obs registry:
``resilience.coord_commits``, ``resilience.epoch_incomplete`` /
``resilience.epoch_torn`` (epochs skipped during selection),
``resilience.epoch_fallbacks`` (selection passed over a newer damaged
epoch), the ``resilience.epoch_selected`` gauge, and
``resilience.cluster_restarts{reason=...}`` on the supervisor side.
"""

from __future__ import annotations

import json
import os
import re
import time
import zlib
from typing import Callable, List, Optional, Tuple

from ..aggregate.autockpt import AutoCheckpoint
from ..fabric import as_transport
from ..obs.registry import get_registry
from . import integrity as _integrity
from .errors import RestartBudgetExceeded
from .retry import exp_backoff, jittered

#: shard barrier / rendezvous tag name shapes
_SHARD_RE = re.compile(r"^e(\d{8})\.p(\d+)\.json$")


def _shard_tag(epoch: int, pid: int) -> str:
    return f"e{epoch:08d}.p{pid}"


def list_epochs(target) -> List[int]:
    """Every epoch ordinal with at least one rendezvous record in the
    store, ascending. ``target`` is a
    :class:`~gelly_streaming_tpu_torch.fabric.Transport` or a shared
    directory path."""
    names = as_transport(target).list()
    return sorted({
        int(m.group(1)) for m in map(_SHARD_RE.match, names) if m
    })


def read_rendezvous(target, epoch: int, pid: int) -> Optional[dict]:
    """One shard's rendezvous record for ``epoch`` (None when missing or
    unreadable — the caller treats both as an incomplete epoch)."""
    data = as_transport(target).get(_shard_tag(epoch, pid) + ".json")
    if data is None:
        return None
    try:
        return json.loads(data.decode())
    except (ValueError, UnicodeDecodeError):
        return None


def _shard_valid(target, epoch: int, pid: int,
                 rec: dict, num_processes: int,
                 cache: Optional[dict] = None) -> Tuple[bool, str]:
    """Validate one shard's artifact against its rendezvous record:
    geometry (nprocs, epoch == windows_done), artifact presence, size,
    and container CRC. Returns (ok, reason).

    ``cache`` (keyed by locator + store version + the record's promised
    crc/size) memoizes the full-content CRC pass: barriers are
    write-once, so an unchanged artifact version keeps its verdict and
    the per-commit GC / per-restore selection scans do NOT re-read
    every container in the store."""
    if rec.get("nprocs") != num_processes:
        return False, (
            f"rendezvous nprocs={rec.get('nprocs')} != {num_processes}"
        )
    if rec.get("epoch") != epoch or rec.get("windows_done") != epoch:
        # a record whose ordinal disagrees with its epoch slot would
        # stitch shards from different stream positions into one
        # "checkpoint" — exactly the mixed-epoch restore this protocol
        # exists to forbid
        return False, (
            f"rendezvous ordinal {rec.get('windows_done')} disagrees "
            f"with epoch {epoch}"
        )
    tr = as_transport(target)
    tag = _shard_tag(epoch, pid) + ".ckpt"
    st = tr.stat(tag)
    if st is None:
        return False, "shard artifact unreadable: missing"
    if st.size != rec.get("size"):
        return False, (
            f"shard artifact is {st.size} bytes, record promised "
            f"{rec.get('size')}"
        )
    key = (tr.describe(tag), st.version, st.size,
           rec.get("crc"), rec.get("size"))
    if cache is not None and key in cache:
        return cache[key]
    data = tr.get(tag)
    if data is None:
        return False, "shard artifact unreadable: missing"
    if len(data) != rec.get("size"):
        return False, (
            f"shard artifact is {len(data)} bytes, record promised "
            f"{rec.get('size')}"
        )
    if (zlib.crc32(data) & 0xFFFFFFFF) != rec.get("crc"):
        result = (False, "shard container checksum mismatch")
    else:
        result = (True, "")
    if cache is not None:
        cache[key] = result
    return result


def select_epoch(
    target,
    num_processes: int,
    *,
    max_epoch: Optional[int] = None,
    record: bool = True,
    cache: Optional[dict] = None,
) -> Optional[int]:
    """The newest epoch for which EVERY shard has a valid artifact.

    This is the restore-side rendezvous: epochs are scanned newest-first
    and an epoch is selected only when all ``num_processes`` rendezvous
    records exist, agree on the geometry and ordinal, and their shard
    files validate (presence, size, container CRC). Anything less —  a
    process died before committing its shard (incomplete), a shard file
    was torn or bit-rotted (torn) — skips the WHOLE epoch, never a
    subset of its shards, so a restore can never mix epochs. Returns
    None when no complete epoch exists (restart from scratch; correct
    under the at-least-once emission contract).

    The scan is a pure function of the store contents, so every
    restarting process computes the same answer with no coordinator.
    ``record=True`` mirrors each skip into the obs registry
    (``resilience.epoch_incomplete`` / ``resilience.epoch_torn``) and
    counts a ``resilience.epoch_fallbacks`` when the selected epoch is
    not the newest in the store.
    """
    reg = get_registry()
    tr = as_transport(target)
    epochs = [
        e for e in reversed(list_epochs(tr))
        if max_epoch is None or e <= max_epoch
    ]
    for i, epoch in enumerate(epochs):
        missing = []
        torn = []
        for pid in range(num_processes):
            rec = read_rendezvous(tr, epoch, pid)
            if rec is None:
                missing.append(pid)
                continue
            ok, reason = _shard_valid(
                tr, epoch, pid, rec, num_processes, cache=cache
            )
            if not ok:
                torn.append((pid, reason))
        if not missing and not torn:
            if record and i > 0:
                reg.counter("resilience.epoch_fallbacks").inc()
            if record:
                reg.gauge("resilience.epoch_selected").set(epoch)
            return epoch
        if record:
            if torn:
                reg.counter("resilience.epoch_torn").inc()
                for pid, reason in torn:
                    _integrity.record_rejection(
                        tr.describe(_shard_tag(epoch, pid) + ".ckpt"),
                        f"epoch {epoch}: {reason}",
                    )
            else:
                reg.counter("resilience.epoch_incomplete").inc()
    return None


class CoordinatedCheckpoint(AutoCheckpoint):
    """Per-shard barriers aligned across processes, restored by epoch
    rendezvous.

    Every process of the multi-host run constructs one of these over the
    SAME shared ``directory`` with its own ``process_id``; the barrier
    cadence (``every`` x the work's superbatch granularity) is identical
    everywhere, so all processes commit at the same window ordinals —
    the epoch. Committing is per-shard and never waits on peers; restore
    (:meth:`windows_done` / :meth:`run`) selects the newest COMPLETE
    epoch via :func:`select_epoch` and loads only this process's shard
    of it.

    ``keep`` bounds how many of this process's own committed epochs stay
    in the store (each process garbage-collects only its own shard
    artifacts, so a slow peer can never have an epoch deleted out from
    under it by a fast one before the fast one has committed ``keep``
    newer epochs).

    ``transport`` selects the store the epoch artifacts move through —
    any store-backed :class:`~gelly_streaming_tpu_torch.fabric.Transport`
    (None keeps the historical behavior: the shared-dir backend over
    ``directory``, byte-identical layout). ``directory`` stays required
    either way: the inherited single-process machinery keeps its local
    scratch path there.
    """

    def __init__(
        self,
        directory: str,
        *,
        process_id: int,
        num_processes: int,
        every=8,
        keep: int = 3,
        transport=None,
    ):
        if every == "auto":
            # the whole rendezvous protocol rests on every process
            # committing at the SAME ordinals with no messages; a
            # per-process tuner would derive different cadences from
            # each host's own timing noise, after which no epoch is
            # ever complete again — fail loudly instead
            raise ValueError(
                'every="auto" cannot be used with coordinated barriers: '
                "the cadence must be identical on every process for "
                "epochs to align. Pick a fixed `every` (tune it "
                "single-host first if needed) and configure the same "
                "value everywhere."
            )
        os.makedirs(directory, exist_ok=True)
        self.dir = directory
        self.process_id = int(process_id)
        self.num_processes = int(num_processes)
        if not 0 <= self.process_id < self.num_processes:
            raise ValueError(
                f"process_id {process_id} outside 0..{num_processes - 1}"
            )
        #: the one cluster-exchange handle every epoch artifact moves
        #: through — rendezvous records, shard containers, GC, and the
        #: cadence elections (no code below this seam touches the
        #: shared directory directly)
        self.transport = as_transport(
            directory if transport is None else transport,
            process_id=self.process_id,
            num_processes=self.num_processes,
        )
        #: the epoch the last load selected (None before any load / when
        #: no complete epoch exists) — the number every process agrees on
        self.epoch: Optional[int] = None
        #: memoizes full-content CRC verdicts per file version (barriers
        #: are write-once) so the per-commit GC scan and the restore
        #: selection never re-read an already-verified container
        self._valid_cache: dict = {}
        super().__init__(
            os.path.join(directory, f"shard.p{self.process_id}"),
            every=every, keep=keep,
        )

    def run(self, make_stream, work):
        """``superbatch="auto"`` historically raised here: each process
        learning its own K re-tiles its groups from its host's OWN
        timing noise, barrier-eligible window ordinals diverge, and no
        epoch ever completes. The transport's agreement primitive
        dissolves the conflict — the workload's controller is wrapped
        in :class:`~gelly_streaming_tpu_torch.fabric.ElectedK`, which elects
        ONE process's learned K per epoch through
        :meth:`~gelly_streaming_tpu_torch.fabric.Transport.elect`, so every
        process tiles with the same agreed K and the barriers align by
        construction (see ``fabric/agreement.py`` for why the election
        runs on the packer's call schedule, not the commit clock)."""
        if getattr(work, "superbatch_auto", False):
            self._wire_cadence_agreement(work)
        return super().run(make_stream, work)

    def _wire_cadence_agreement(self, work) -> None:
        """Wrap the workload's local K learner in the agreed-K adapter,
        anchored at THIS attempt's restore epoch. Re-wiring happens on
        every ``run()`` call: a supervisor restart restores from a new
        epoch, and the adapter's election schedule must restart from
        that ordinal (its tags are absolute, so it re-reads the winners
        the pre-failure run persisted)."""
        from ..fabric import ElectedK

        plane = getattr(work, "control", None)
        if plane is None:
            from ..control import default_plane

            plane = default_plane(1)
            work.control = plane
        inner = getattr(plane, "autok", None)
        if inner is None:
            inner = plane  # a bare controller standing in for the plane
        if isinstance(inner, ElectedK):
            inner = inner.inner  # re-anchor, never stack wrappers
        elected = ElectedK(
            inner, self.transport, every=self.every,
            done=self.windows_done(),
        )
        if getattr(plane, "autok", None) is not None:
            plane.autok = elected
        else:
            work.control = elected

    # -- commit side ---------------------------------------------------- #
    def _commit(self, payload: dict) -> str:
        """Commit this shard's barrier for epoch ``windows_done``: the
        CRC-framed container lands first (an atomic transport put),
        then the rendezvous record naming it — the record is the
        shard's commit point, so a kill between the two puts leaves an
        invisible container, never a record pointing at nothing. Peers
        are not consulted: epoch completeness is decided at restore
        time."""
        import pickle

        epoch = payload["windows_done"]
        tag = _shard_tag(epoch, self.process_id)
        data = _integrity.wrap_checksummed(pickle.dumps(payload))
        self.transport.put(tag + ".ckpt", data, overwrite=True)
        rec = {
            "epoch": epoch,
            "windows_done": epoch,
            "process": self.process_id,
            "nprocs": self.num_processes,
            "crc": zlib.crc32(data) & 0xFFFFFFFF,
            "size": len(data),
        }
        self.transport.put(  # shard commit point
            tag + ".json", json.dumps(rec).encode(), overwrite=True
        )
        get_registry().counter("resilience.coord_commits").inc()
        self._gc(epoch)
        return self.transport.describe(tag + ".ckpt")

    def _gc(self, committed_epoch: int) -> None:
        """Drop this process's shard files for epochs older than the
        ``keep``-th newest COMPLETE-AND-VALID epoch. Restorability is
        the deletion gate, not this process's own history: a fast shard
        that trimmed by its own epoch count alone would delete its half
        of the only epochs a slow peer has fully committed — leaving
        the cluster with NO complete epoch to restore from — and
        counting rendezvous records alone would let torn or bit-rotted
        epochs (which :func:`select_epoch` will SKIP at restore)
        advance the floor over the last genuinely loadable ones, the
        same rotate-over-the-good-fallback failure the single-process
        ``_rotate`` was hardened against. Validation is the same
        presence+size+CRC check selection uses; the epoch set on disk
        is bounded (~keep plus stragglers), so the extra pass is cheap.
        With fewer than ``keep`` valid epochs on disk nothing is
        deleted. Unlinks touch OWN files only; peers collect theirs, so
        a torn epoch can only be produced by damage, never by a cleanup
        race."""

        def _restorable(e: int) -> bool:
            for pid in range(self.num_processes):
                rec = read_rendezvous(self.transport, e, pid)
                if rec is None:
                    return False
                ok, _ = _shard_valid(
                    self.transport, e, pid, rec, self.num_processes,
                    cache=self._valid_cache,
                )
                if not ok:
                    return False
            return True

        complete = [
            e for e in list_epochs(self.transport) if _restorable(e)
        ]
        if len(complete) < self.keep:
            return
        floor = complete[-self.keep]
        for e in list_epochs(self.transport):
            if e >= floor:
                continue
            tag = _shard_tag(e, self.process_id)
            for suffix in (".json", ".ckpt"):
                self.transport.delete(tag + suffix)

    def discard(self) -> None:
        """Fresh start for THIS PROCESS's shard: remove its epoch
        barriers and rendezvous records (plus the inherited
        single-process path artifacts) and drop the caches. Peers'
        shards are never touched — each process owns only its own
        artifacts, the same ownership rule :meth:`_gc` follows."""
        for e in list_epochs(self.transport):
            tag = _shard_tag(e, self.process_id)
            for suffix in (".json", ".ckpt"):
                self.transport.delete(tag + suffix)
        self._valid_cache.clear()
        super().discard()

    # -- restore side --------------------------------------------------- #
    def _load(self) -> Optional[dict]:
        """Epoch rendezvous + own-shard read. If the selected epoch's
        own shard fails to unpickle despite a matching container CRC
        (damage between validation and read), the epoch is excluded and
        selection falls back — the fallback is re-selected over the
        whole directory, so it stays an ALL-shards-valid epoch.

        The NO-EPOCH result caches like a found one (base-class
        contract): peers commit concurrently, so two scans in one
        attempt can genuinely disagree — every read between
        ``invalidate()`` calls must return the same answer or the
        supervisor's replay ordinals desynchronize from the restore."""
        if self._cache_valid:
            return self._cache
        ceiling: Optional[int] = None
        while True:
            epoch = select_epoch(
                self.transport, self.num_processes, max_epoch=ceiling,
                cache=self._valid_cache,
            )
            self.epoch = epoch
            if epoch is None:
                self._cache = None
                self._cache_valid = True
                return None
            tag = _shard_tag(epoch, self.process_id) + ".ckpt"
            payload = None
            data = self.transport.get(tag)
            if data is not None:
                st = self.transport.stat(tag)
                origin = self.transport.describe(tag)
                key = (origin, st.version if st else 0, len(data))
                payload = self._barrier_payload(data, origin, key)
            if payload is not None:
                self._cache = payload
                self._cache_valid = True
                return payload
            get_registry().counter("resilience.epoch_torn").inc()
            ceiling = epoch - 1


class ClusterError(RuntimeError):
    """A cluster worker failed in a way the restart policy does not
    cover (unexpected exit code); carries the worker's stderr tail."""


class ClusterSupervisor:
    """Restart-all process supervision over one worker per shard.

    The Flink restart strategy at process granularity: ``spawn(pid,
    attempt)`` launches worker ``pid`` (a ``subprocess.Popen``); when
    any worker exits with a code in ``restart_codes`` (or is killed by
    a signal), the remaining workers are terminated and ALL are
    relaunched — each re-runs the epoch rendezvous and restores from
    the agreed epoch, so the cluster never runs with shards on
    different epochs. Exits outside ``restart_codes`` raise
    :class:`ClusterError` immediately (a deterministic worker bug must
    not burn the restart budget).

    ``before_restart(attempt)`` runs between teardown and relaunch (the
    chaos harness injects its torn-epoch corruption there). Restarts
    are counted as ``resilience.cluster_restarts{reason=...}`` and
    bounded by ``max_restarts`` (then
    :class:`~.errors.RestartBudgetExceeded`), with the supervisor's
    bounded-exponential backoff rule between attempts.

    ``flight_dir`` names the directory the workers' flight recorders
    dump into (each worker installs its own
    :class:`~gelly_streaming_tpu_torch.obs.flight.FlightRecorder`; a
    ``FaultPlan`` kill or an in-worker supervisor restart commits the
    ring there). Every worker death's newly-appeared dumps are
    collected into the failure report: the ``flight_dumps`` list of
    :meth:`run`'s result, and the :class:`ClusterError` message for
    non-restartable deaths — the restart carries its black box.
    """

    def __init__(
        self,
        spawn: Callable,
        num_processes: int,
        *,
        max_restarts: int = 4,
        restart_codes: Tuple[int, ...] = (),
        backoff_base_s: float = 0.05,
        backoff_max_s: float = 2.0,
        jitter: float = 0.0,
        seed: int = 0,
        poll_s: float = 0.02,
        terminate_grace_s: float = 5.0,
        before_restart: Optional[Callable[[int], None]] = None,
        flight_dir: Optional[str] = None,
    ):
        self._spawn = spawn
        self.num_processes = int(num_processes)
        self.max_restarts = int(max_restarts)
        self.restart_codes = set(restart_codes)
        self.backoff_base_s = float(backoff_base_s)
        self.backoff_max_s = float(backoff_max_s)
        self.jitter = float(jitter)
        self.seed = int(seed)
        self.poll_s = float(poll_s)
        self.terminate_grace_s = float(terminate_grace_s)
        self._before_restart = before_restart
        self.flight_dir = flight_dir
        #: restarts performed by the most recent :meth:`run`
        self.restarts = 0
        #: (pid, exit_code) of every worker death that triggered a
        #: restart, in order — the sweep's evidence of WHO was killed
        self.worker_exits: List[Tuple[int, int]] = []
        #: flight-recorder dump paths collected across the run, in
        #: discovery order (newest deaths last)
        self.flight_dumps: List[str] = []

    def _collect_flight_dumps(self) -> List[str]:
        """Newly-appeared dumps in ``flight_dir`` since the last
        collection (the per-death sweep of the workers' black boxes)."""
        if self.flight_dir is None:
            return []
        from ..obs import flight as _flight

        fresh = [
            p for p in _flight.find_dumps(self.flight_dir)
            if p not in self.flight_dumps
        ]
        self.flight_dumps.extend(fresh)
        return fresh

    @staticmethod
    def _describe_dumps(paths: List[str]) -> str:
        """One line per dump for a failure report: path, reason, ring
        size — readable without opening the files."""
        from ..obs import flight as _flight

        out = []
        for p in paths:
            try:
                doc = _flight.read_dump(p)
                out.append(
                    f"{p} (reason={doc.get('reason')}, "
                    f"{doc.get('n_events')} events)"
                )
            except Exception:
                out.append(f"{p} (unreadable)")
        return "; ".join(out)

    def _teardown(self, procs: list) -> None:
        for p in procs:
            if p is not None and p.poll() is None:
                p.terminate()
        deadline = time.monotonic() + self.terminate_grace_s
        for p in procs:
            if p is None:
                continue
            while p.poll() is None and time.monotonic() < deadline:
                time.sleep(self.poll_s)
            if p.poll() is None:
                p.kill()
                p.wait()

    def run(self) -> dict:
        """Drive the cluster to an all-zero exit; returns
        ``{"restarts": n, "worker_exits": [(pid, rc), ...],
        "flight_dumps": [path, ...]}``."""
        reg = get_registry()
        self.restarts = 0
        self.worker_exits = []
        self.flight_dumps = []
        attempt = 0
        while True:
            procs = [
                self._spawn(pid, attempt)
                for pid in range(self.num_processes)
            ]
            failed: Optional[Tuple[int, int]] = None
            live = set(range(self.num_processes))
            while live and failed is None:
                for pid in sorted(live):
                    rc = procs[pid].poll()
                    if rc is None:
                        continue
                    live.discard(pid)
                    if rc != 0:
                        failed = (pid, rc)
                        break
                if live and failed is None:
                    time.sleep(self.poll_s)
            if failed is None:
                self._collect_flight_dumps()
                return {
                    "restarts": self.restarts,
                    "worker_exits": list(self.worker_exits),
                    "flight_dumps": list(self.flight_dumps),
                }
            pid, rc = failed
            self.worker_exits.append((pid, rc))
            # a signal death (negative rc) is environmental; a listed
            # code is an expected injected kill; anything else is a
            # worker bug and restarting would loop on it
            transient = rc < 0 or rc in self.restart_codes
            self._teardown(procs)
            # the dead worker's black box: collected AFTER teardown so
            # a dump committed in its dying instants is on disk
            fresh_dumps = self._collect_flight_dumps()
            if not transient:
                # spawners that pipe stderr expose it on the Popen;
                # spawners that redirect to a log file (the in-repo
                # chaos spawner — pipes could deadlock a terminated
                # worker) advertise the path as ``proc.log_path``
                err = b""
                if procs[pid].stderr is not None:
                    try:
                        err = procs[pid].stderr.read() or b""
                    except Exception:
                        # diagnostics collection on an already-failed
                        # worker: the ClusterError below still raises,
                        # just without a tail — record the gap
                        get_registry().counter(
                            "resilience.swallowed",
                            site="worker_stderr_read",
                        ).inc()
                elif getattr(procs[pid], "log_path", None):
                    try:
                        with open(procs[pid].log_path, "rb") as f:
                            err = f.read()
                    except OSError:
                        pass
                if isinstance(err, str):
                    err = err.encode()
                raise ClusterError(
                    f"worker {pid} exited rc={rc} (not a restartable "
                    f"code): {err[-2000:].decode(errors='replace')}"
                    + (f"\nflight dumps: "
                       f"{self._describe_dumps(fresh_dumps)}"
                       if fresh_dumps else "")
                )
            if self.restarts >= self.max_restarts:
                raise RestartBudgetExceeded(
                    f"{self.restarts} cluster restarts exhausted "
                    f"(worker {pid} rc={rc})"
                    + (f"; flight dumps: "
                       f"{self._describe_dumps(self.flight_dumps)}"
                       if self.flight_dumps else "")
                )
            self.restarts += 1
            reg.counter(
                "resilience.cluster_restarts",
                reason="kill" if rc in self.restart_codes else "signal",
            ).inc()
            delay = jittered(
                exp_backoff(
                    self.restarts - 1, self.backoff_base_s,
                    self.backoff_max_s,
                ),
                self.jitter, self.seed, self.restarts - 1,
            )
            if delay > 0:
                time.sleep(delay)
            if self._before_restart is not None:
                self._before_restart(self.restarts)
            attempt += 1
