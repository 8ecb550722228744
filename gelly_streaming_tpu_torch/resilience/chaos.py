"""Deterministic chaos harness, its multi-process half (the port's copy of
``gelly_streaming_tpu/resilience/chaos.py``).

:func:`run_mp_sweep` is the DISTRIBUTED kill sweep: an N-process cluster
with coordinated epoch barriers
(:mod:`~gelly_streaming_tpu_torch.resilience.coordinated`) and the
file-exchange dictionary contract
(:class:`~gelly_streaming_tpu_torch.parallel.multihost.FileExchangeTransport`),
where one worker of N is killed hard (``os._exit``) at every window
ordinal, the
:class:`~gelly_streaming_tpu_torch.resilience.coordinated.ClusterSupervisor`
restarts the whole cluster from the agreed epoch, and the sweep asserts
oracle-identical emissions, byte-identical VertexDicts, and that no
relaunch ever restored from an incomplete epoch.

Each worker (:func:`mp_worker_main`) is a fresh interpreter that runs its
shard's streaming CC on ``cfg["device"]`` (default ``"cuda"``: each worker
makes its own CUDA context on the one card; tests pass ``"cpu"``). The
sweep's own process never touches the card. Workers append one flushed JSONL digest
line per window BEFORE the kill hook fires, and stream their obs events
through a :class:`~gelly_streaming_tpu_torch.obs.cluster.ShardSink`, so
the pre-crash evidence survives ``os._exit``.

The single-process sweep (``run_sweep``, ``worker_main``) and the serving
scenarios (replica failover, the cross-process RPC failover, the sharded
and storm scenarios) come with ROADMAP Queue 1, slice 9 (serving): they
raise ``NotImplementedError`` naming it, and so does
``run_mp_sweep(failover=True)`` or ``rpc=True``.

Worker entry point (subprocess only)::

    python -m gelly_streaming_tpu_torch.resilience.chaos mp_worker '<json cfg>'
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Callable, Optional

#: worker exit code for an injected kill (distinct from real failures)
KILL_RC = 17

#: repo root (the directory holding ``gelly_streaming_tpu_torch``), for
#: subprocess sys.path injection — workers must import this package
#: regardless of the sweep process's cwd
REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)

#: default single-process sweep geometry (the sweep itself is slice 9)
DEFAULTS = dict(
    windows=24, window_edges=256, superbatch=2, every=2, seed=1234
)

#: multi-process sweep geometry: 2 processes (kill-one-of-N at every
#: window ordinal), window_edges divisible by the process count so the
#: interleaved pre-partition tiles windows exactly
MP_DEFAULTS = dict(
    processes=2, windows=12, window_edges=128, superbatch=2, every=2,
    seed=4321,
)

_SLICE9 = "ROADMAP Queue 1, slice 9 (serving)"


def _not_ported(what: str):
    raise NotImplementedError(f"{what} is ported in {_SLICE9}")


def corpus(seed: int, n_edges: int) -> list:
    """Deterministic edge list with SPARSE raw ids (vertex-dict replay
    must reproduce exact compact-id assignment across restarts). Equal
    to the JAX package's for the same arguments."""
    import numpy as np

    rng = np.random.default_rng(seed)
    pairs = rng.integers(0, 600, size=(n_edges, 2))
    return [(int(a) * 7 + 3, int(b) * 7 + 3, 0.0) for a, b in pairs]


def digest(emission) -> str:
    """Stable fingerprint of one per-window emission (the Components
    string form is canonical: sorted roots, sorted members; equal to the
    JAX package's for equal components)."""
    import hashlib

    return hashlib.sha1(str(emission).encode()).hexdigest()[:16]


# --------------------------------------------------------------------- #
# Worker telemetry
# --------------------------------------------------------------------- #
def _worker_obs(cfg: dict, shard: Optional[int] = None):
    """Shared worker telemetry wiring: a streaming :class:`ShardSink`
    (every event hits disk the moment it is emitted, so the pre-kill story
    survives ``os._exit``), tracing on (spans + the flight ring's gate),
    and a flight recorder when the sweep asked for one
    (``cfg["flight"]``). Returns the sink."""
    from ..obs import flight as obs_flight
    from ..obs import trace as obs_trace
    from ..obs.cluster import ShardSink
    from ..obs.registry import get_registry

    sink = ShardSink(cfg["events"], shard=shard)
    get_registry().add_sink(sink)
    obs_trace.add_sink(sink)
    obs_trace.enable()
    if cfg.get("flight"):
        obs_flight.install(obs_flight.FlightRecorder(
            cfg["flight"], capacity=128, shard=shard,
        ))
    return sink


def worker_main(cfg: dict) -> None:
    """The single-process sweep's worker: not ported yet (raises)."""
    _not_ported("the single-process chaos sweep (worker_main)")


def _worker_code(entry: str) -> str:
    return (
        "import sys, json; "
        f"sys.path.insert(0, {REPO_ROOT!r}); "
        "from gelly_streaming_tpu_torch.resilience import chaos; "
        f"chaos.{entry}(json.loads(sys.argv[1]))"
    )


def _spawn_worker(cfg: dict, timeout: float = 600.0,
                  entry: str = "worker_main"):
    import subprocess

    return subprocess.run(
        [sys.executable, "-c", _worker_code(entry), json.dumps(cfg)],
        capture_output=True, text=True, timeout=timeout,
        env=dict(os.environ),
    )


# --------------------------------------------------------------------- #
# Multi-process worker (one shard of the coordinated cluster)
# --------------------------------------------------------------------- #
def mp_worker_main(cfg: dict) -> None:
    """One shard of the distributed sweep's cluster. ``cfg`` keys:
    ``root`` (shared directory: ``ckpt/`` epochs + ``exchange/`` files),
    ``process``/``processes``, ``digests``/``events``/``meta``
    (per-process paths), ``kill_after`` (windows consumed before
    ``os._exit``; fires only when ``process == victim``), ``device``
    (where the shard's CC runs; default ``"cuda"``), plus the sweep
    geometry. Each process windows its interleaved shard of the global
    corpus (edge ``i`` belongs to process ``i % N``), agrees on
    raw->compact ids through a persisted exchange transport, and commits
    coordinated epoch barriers.

    ``transport`` selects the exchange backend: ``"shared_dir"`` (default
    — files under ``root/exchange``) or ``"socket"`` (GSRP frames against
    the sweep's exchange daemon at ``exchange_addr``). Epoch barriers
    stay on the shared directory in BOTH modes: the daemon's store is
    in-memory, and barrier restore must survive the daemon host too.

    Each digest line carries the cluster attempt that wrote it (``a``,
    from ``cfg["attempt"]``) and its wall time (``t``), so the sweep can
    measure the time from a kill to the relaunch's first emission."""
    import numpy as np

    from ..core.stream import SimpleEdgeStream
    from ..core.vertexdict import VertexDict
    from ..core.window import CountWindow
    from ..library import ConnectedComponents
    from ..obs.registry import get_registry
    from ..parallel.multihost import FileExchangeTransport, dict_exchange_encode
    from . import faults
    from .coordinated import CoordinatedCheckpoint
    from .supervisor import Supervisor

    pid = int(cfg["process"])
    nprocs = int(cfg["processes"])
    attempt = int(cfg.get("attempt", 0))
    windows = int(cfg["windows"])
    we = int(cfg["window_edges"])
    device = cfg.get("device", "cuda")
    if we % nprocs:
        raise ValueError("window_edges must divide by the process count")
    lw = we // nprocs  # local (per-shard) window size
    raw = corpus(cfg["seed"], windows * we)
    mine = raw[pid::nprocs]
    if cfg.get("transport") == "socket":
        from ..fabric import SocketTransport

        fx = SocketTransport(
            str(cfg["exchange_addr"]), pid, nprocs,
            timeout_s=float(cfg.get("exchange_timeout_s", 60.0)),
        )
    else:
        fx = FileExchangeTransport(
            os.path.join(cfg["root"], "exchange"), pid, nprocs,
            timeout_s=float(cfg.get("exchange_timeout_s", 60.0)),
        )
    sink = _worker_obs(cfg, shard=pid)
    seen_vd = {}  # the live stream's vertex dict (for the final CRC)

    def make_stream(vd):
        vd_eff = vd if vd is not None else VertexDict()
        seen_vd["vd"] = vd_eff

        def gen():
            for w in range(windows):
                chunk = mine[w * lw:(w + 1) * lw]
                src = np.array([e[0] for e in chunk], np.int64)
                dst = np.array([e[1] for e in chunk], np.int64)
                # the union fold is the point; the returned compact
                # columns are re-derived by the windower's own encode
                dict_exchange_encode(
                    None, vd_eff, src, dst, transport=fx, window=w
                )
                yield from chunk

        return SimpleEdgeStream(
            gen(), window=CountWindow(lw), vertex_dict=vd_eff, device=device,
        )

    def make_work():
        return ConnectedComponents(superbatch=cfg["superbatch"])

    cc = CoordinatedCheckpoint(
        os.path.join(cfg["root"], "ckpt"),
        process_id=pid, num_processes=nprocs,
        every=cfg["every"], keep=3,
    )
    sup = Supervisor(cc, backoff_base_s=0.0, jitter=0.0, seed=cfg["seed"])
    kill_after = int(cfg.get("kill_after", -1))
    if kill_after >= 0 and int(cfg.get("victim", -1)) == pid:
        faults.install(faults.FaultPlan(
            seed=cfg["seed"],
            kill_at_window=kill_after - 1,
            kill_exit_code=KILL_RC,
        ))
    t0 = time.perf_counter()
    first = None
    yielded = 0
    resumed_epoch = None
    with open(cfg["digests"], "a") as out:
        ordinal = None
        for comps in sup.run(make_stream, make_work):
            if first is None:
                first = time.perf_counter() - t0
            if ordinal is None:
                # label base = the epoch the supervisor ACTUALLY restored
                # for the attempt that produced this first emission (read
                # via the attempt's own cached load): a pre-run scan could
                # disagree with it, since a peer's healing commit can
                # complete a newer epoch in between
                resumed_epoch = ordinal = cc.windows_done()
            out.write(json.dumps({"o": ordinal, "d": digest(comps),
                                  "a": attempt, "t": time.time()}) + "\n")
            out.flush()  # pre-crash evidence must survive os._exit
            if faults.active():
                faults.fire("chaos.window", index=ordinal)
            ordinal += 1
            yielded += 1
    if resumed_epoch is None:
        # nothing was emitted: the barrier already covered the whole
        # stream, so the resumed epoch is the (cached) restored one
        resumed_epoch = cc.windows_done()
    import zlib

    vd = seen_vd.get("vd")
    vd_crc = (
        None if vd is None
        else zlib.crc32(np.ascontiguousarray(vd.raw_ids()).tobytes())
        & 0xFFFFFFFF
    )
    with open(cfg["meta"], "w") as f:
        json.dump({
            "process": pid,
            "resumed_epoch": resumed_epoch,
            "restarts": sup.restarts,
            "yielded": yielded,
            "vd_crc": vd_crc,
            "device": str(device),
            "first_emission_s": first,
            "total_s": time.perf_counter() - t0,
        }, f)
    sink.close()
    get_registry().remove_sink(sink)
    faults.clear()


# --------------------------------------------------------------------- #
# The serving scenarios and the single-process sweep: slice 9
# --------------------------------------------------------------------- #
def failover_main(cfg: dict) -> None:
    """The serving replica failover scenario: not ported yet (raises)."""
    _not_ported("the serving failover scenario (failover_main)")


def trace_attribution(*args, **kwargs):
    """Per-stage attribution of a serving trace: not ported yet (raises)."""
    _not_ported("trace_attribution")


def run_rpc_scenario(*args, **kwargs) -> dict:
    """The cross-process RPC failover scenario: not ported yet (raises)."""
    _not_ported("the RPC failover scenario (run_rpc_scenario)")


def run_sharded_scenario(*args, **kwargs) -> dict:
    """The sharded-serving scenario: not ported yet (raises)."""
    _not_ported("the sharded-serving scenario (run_sharded_scenario)")


def run_storm_scenario(*args, **kwargs) -> dict:
    """The storm scenario: not ported yet (raises)."""
    _not_ported("the storm scenario (run_storm_scenario)")


def run_sweep(**kwargs) -> dict:
    """The single-process kill sweep: not ported yet (raises)."""
    _not_ported("the single-process chaos sweep (run_sweep)")


# --------------------------------------------------------------------- #
# Event shipping
# --------------------------------------------------------------------- #
def _read_jsonl(path: str) -> list:
    if not os.path.exists(path):
        return []
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


def _count_events(events_path: str, name: str) -> int:
    return sum(
        1 for e in _read_jsonl(events_path) if e.get("name") == name
    )


def _count_rejections(events_path: str) -> int:
    return _count_events(events_path, "resilience.ckpt_rejected")


def _ship_events(obs_f, source, point: str) -> int:
    """Append one run directory's shard events (shard-stamped,
    ``ts``-ordered, tagged with the sweep point) to the merged obs log,
    plus one marker line per flight dump found there."""
    if obs_f is None:
        return 0
    from ..obs import flight as obs_flight
    from ..obs.cluster import iter_shard_events

    n = 0
    for ev in iter_shard_events(source):
        ev["point"] = point
        obs_f.write(json.dumps(ev) + "\n")
        n += 1
    root = source if isinstance(source, str) and os.path.isdir(source) \
        else None
    if root is not None:
        for p in obs_flight.find_dumps(root):
            try:
                doc = obs_flight.read_dump(p)
            except Exception:
                doc = {"reason": "unreadable", "n_events": None}
            obs_f.write(json.dumps({
                "kind": "meta", "name": "flight_dump", "point": point,
                "path": os.path.basename(p),
                "reason": doc.get("reason"),
                "n_events": doc.get("n_events"),
                "ts": os.path.getmtime(p),
            }) + "\n")
            n += 1
    obs_f.flush()
    return n


def _write_phase_markers(obs_f, phases) -> None:
    """Append one ``storm_phase`` meta line per phase wall of the sweep to the
    merged obs log — the timeline renderer's section breaks."""
    if obs_f is None:
        return
    for name, ts in phases:
        obs_f.write(json.dumps({
            "kind": "meta", "name": "storm_phase",
            "phase": name, "ts": ts, "point": "storm",
        }) + "\n")
    obs_f.flush()


def _kill_to_first_emission(d: str, victim: int, processes: int) -> Optional[float]:
    """Seconds from the injected kill (the victim's
    ``resilience.fault_injected`` event) to the first digest line a
    relaunched worker wrote; None when either is missing."""
    from ..obs.cluster import shard_events_path

    kills = [
        e["ts"] for e in _read_jsonl(shard_events_path(d, victim))
        if e.get("name") == "resilience.fault_injected"
        and isinstance(e.get("ts"), (int, float))
    ]
    if not kills:
        return None
    kill_ts = min(kills)
    after = [
        line["t"]
        for pid in range(processes)
        for line in _read_jsonl(os.path.join(d, f"digests.p{pid}.jsonl"))
        if line.get("a", 0) >= 1 and isinstance(line.get("t"), (int, float))
    ]
    return (min(after) - kill_ts) if after else None


# --------------------------------------------------------------------- #
# The multi-process sweep
# --------------------------------------------------------------------- #
def run_mp_sweep(
    *,
    processes: int = MP_DEFAULTS["processes"],
    windows: int = MP_DEFAULTS["windows"],
    window_edges: int = MP_DEFAULTS["window_edges"],
    superbatch: int = MP_DEFAULTS["superbatch"],
    every: int = MP_DEFAULTS["every"],
    seed: int = MP_DEFAULTS["seed"],
    transport: str = "shared_dir",
    corrupt: bool = True,
    failover: bool = True,
    rpc: bool = True,
    workdir: Optional[str] = None,
    obs_log: Optional[str] = None,
    log: Optional[Callable[[str], None]] = None,
    device: str = "cuda",
) -> dict:
    """Distributed kill sweep over an N-process coordinated cluster.

    ``transport`` selects the per-window dict-exchange backend the workers
    ride: ``"shared_dir"`` (files under each point's ``exchange/``) or
    ``"socket"`` (the sweep runs one
    :class:`~gelly_streaming_tpu_torch.fabric.exchange.ExchangeDaemon` per
    point; the daemon, owned by the never-killed sweep process, carries exchange
    tags across worker kills and relaunches). Epoch barriers and
    rendezvous stay on the shared directory in both modes.

    For every window ordinal ``k``, worker ``k % N`` dies hard after ``k``
    windows; the :class:`ClusterSupervisor` terminates the rest and
    relaunches ALL workers, which rendezvous on the newest COMPLETE epoch
    and replay. Asserted per point: the combined digest stream is
    oracle-identical with full per-process window coverage, every
    relaunched worker resumed from a complete epoch, and the final
    VertexDicts are byte-identical across processes and to the oracle's.
    One point (``corrupt=True``) additionally corrupts one shard of the
    newest complete epoch between kill and relaunch — the whole epoch must
    be skipped (torn, visible in the event logs) and every worker must
    fall back below it. Each point records ``kill_to_first_emission_s``:
    the kill's event time to the first digest line written after it
    (teardown, relaunch, interpreter and device start, rendezvous,
    restore and replay).

    ``device`` is where every worker's CC runs (default ``"cuda"``; each
    worker creates its own CUDA context); the sweep's process never touches
    the card. ``failover=True`` and ``rpc=True`` (the serving scenarios)
    raise ``NotImplementedError`` naming ROADMAP Queue 1, slice 9.

    ``obs_log`` writes the sweep's MERGED, shard-labeled event stream:
    every worker's :class:`ShardSink` stream (kills included), flight-dump
    markers, and the sweep's own coordination events under shard
    ``sweep``.
    """
    if failover:
        _not_ported("the serving failover point of run_mp_sweep (failover=True)")
    if rpc:
        _not_ported("the RPC failover point of run_mp_sweep (rpc=True)")
    import shutil
    import subprocess
    import tempfile

    from ..obs.cluster import ShardSink, shard_events_path
    from ..obs.registry import get_registry, nearest_rank
    from .coordinated import ClusterSupervisor, select_epoch

    say = log or (lambda s: print(s, file=sys.stderr, flush=True))
    root = workdir or tempfile.mkdtemp(prefix="chaos_mp_")
    env = dict(os.environ)
    obs_f = open(obs_log, "w") if obs_log else None
    sweep_sink = None
    if obs_f is not None:
        # the sweep's registry carries the cluster-level half of the
        # story (cluster_restarts, epoch selection during corruption
        # probes); ship it as its own shard at the end
        sweep_sink = ShardSink(os.path.join(root, "sweep-events.jsonl"))
        get_registry().add_sink(sweep_sink)
    daemons = {}  # point dir -> ExchangeDaemon (socket mode only)
    try:
        geometry = dict(
            processes=processes, windows=windows, window_edges=window_edges,
            superbatch=superbatch, every=every, seed=seed,
            transport=transport, device=str(device),
        )

        def start_daemon(d: str) -> None:
            if transport != "socket":
                return
            from ..fabric import ExchangeDaemon

            daemons[d] = ExchangeDaemon().start()

        def stop_daemon(d: str) -> None:
            dm = daemons.pop(d, None)
            if dm is not None:
                dm.stop()

        def cfg_for(d: str, pid: int, kill_after: int, victim: int,
                    attempt: int = 0) -> dict:
            return dict(
                geometry,
                root=d,
                exchange_addr=(
                    daemons[d].address if d in daemons else None
                ),
                process=pid,
                attempt=attempt,
                victim=victim,
                kill_after=kill_after,
                digests=os.path.join(d, f"digests.p{pid}.jsonl"),
                events=shard_events_path(d, pid),
                meta=os.path.join(d, f"meta.p{pid}.json"),
                flight=os.path.join(d, f"flight.p{pid}.a{attempt}.json"),
            )

        def spawner(d: str, victim: int, kill_after: int):
            """spawn(pid, attempt) for the ClusterSupervisor: the kill plan
            rides only the FIRST attempt; relaunches run clean. Worker
            output goes to per-attempt log files (no pipes — a terminated
            worker must never deadlock the sweep on a full pipe)."""

            def spawn(pid: int, attempt: int):
                cfg = cfg_for(
                    d, pid,
                    kill_after if attempt == 0 else -1,
                    victim,
                    attempt=attempt,
                )
                log_path = os.path.join(d, f"worker.p{pid}.a{attempt}.log")
                with open(log_path, "wb") as logf:
                    # the child holds its own dup of the fd; closing the
                    # sweep's copy immediately keeps it from
                    # accumulating open files
                    p = subprocess.Popen(
                        [sys.executable, "-c", _worker_code("mp_worker_main"),
                         json.dumps(cfg)],
                        stdout=logf, stderr=subprocess.STDOUT, env=env,
                    )
                p.log_path = log_path  # ClusterError reads its tail
                return p

            return spawn

        def read_point(d: str) -> tuple:
            """(digest lines per (pid, o), metas per pid) for one point."""
            lines = {}
            bad_dupes = []
            for pid in range(processes):
                for line in _read_jsonl(
                    os.path.join(d, f"digests.p{pid}.jsonl")
                ):
                    key = (pid, line["o"])
                    if key in lines and lines[key] != line["d"]:
                        bad_dupes.append(key)
                    lines[key] = line["d"]
            metas = {}
            for pid in range(processes):
                p = os.path.join(d, f"meta.p{pid}.json")
                if os.path.exists(p):
                    with open(p) as f:
                        metas[pid] = json.load(f)
            return lines, metas, bad_dupes

        # -- oracle: one uninterrupted cluster run ------------------------- #
        oracle_dir = os.path.join(root, "oracle")
        os.makedirs(oracle_dir, exist_ok=True)
        say(f"chaos-mp: oracle cluster ({processes} procs x {windows} "
            f"windows x {window_edges} edges, superbatch={superbatch}, "
            f"every={every}, device={device})...")
        start_daemon(oracle_dir)
        cs = ClusterSupervisor(
            spawner(oracle_dir, victim=-1, kill_after=-1), processes,
            restart_codes=(KILL_RC,), backoff_base_s=0.0,
            flight_dir=oracle_dir,
        )
        t_oracle = time.perf_counter()
        try:
            cs.run()
        finally:
            stop_daemon(oracle_dir)
        oracle_s = time.perf_counter() - t_oracle
        oracle, oracle_metas, dupes = read_point(oracle_dir)
        want_keys = {
            (pid, o) for pid in range(processes) for o in range(windows)
        }
        if set(oracle) != want_keys or dupes:
            raise RuntimeError(
                f"chaos-mp oracle covered {len(oracle)}/{len(want_keys)} "
                f"(pid, window) points ({len(dupes)} digest conflicts)"
            )
        oracle_vd = {m["vd_crc"] for m in oracle_metas.values()}
        if len(oracle_metas) != processes or len(oracle_vd) != 1:
            raise RuntimeError(
                f"chaos-mp oracle VertexDicts disagree across processes: "
                f"{oracle_vd}"
            )
        oracle_vd_crc = next(iter(oracle_vd))
        _ship_events(obs_f, oracle_dir, "oracle")

        # the torn-epoch corruption point: late enough that a fallback epoch
        # exists below the one being torn
        corrupt_k = max(2 * every + 2, windows // 2) if corrupt else None
        if corrupt_k is not None and corrupt_k > windows:
            corrupt_k = None

        points = []
        all_ok = True
        for k in range(1, windows + 1):
            d = os.path.join(root, f"kill_{k:03d}")
            os.makedirs(d, exist_ok=True)
            victim = k % processes
            point = {
                "kill_after": k,
                "victim": victim,
                "corrupt": "flip" if k == corrupt_k else None,
            }
            corrupted_epoch = {}

            def before_restart(attempt: int, _d=d, _k=k, _v=victim,
                               _ce=corrupted_epoch):
                if _k != corrupt_k or attempt != 1:
                    return
                ckpt_dir = os.path.join(_d, "ckpt")
                epoch = select_epoch(ckpt_dir, processes, record=False)
                if epoch is None:
                    return
                from .faults import corrupt_file

                shard = os.path.join(
                    ckpt_dir, f"e{epoch:08d}.p{_v}.ckpt"
                )
                if os.path.exists(shard):
                    corrupt_file(shard, "flip", seed=seed + _k)
                    _ce["epoch"] = epoch

            start_daemon(d)
            cs = ClusterSupervisor(
                spawner(d, victim=victim, kill_after=k), processes,
                restart_codes=(KILL_RC,), backoff_base_s=0.0,
                before_restart=before_restart,
                flight_dir=d,
            )
            t0 = time.perf_counter()
            try:
                res = cs.run()
            except Exception as e:
                # one unrecoverable point must not throw away the
                # evidence of every point already measured — record it
                # failed and keep sweeping
                point.update(
                    resume_s=round(time.perf_counter() - t0, 3),
                    ok=False,
                    reason=f"cluster did not recover: {e!r:.800}",
                    flight_dumps=[
                        os.path.basename(p) for p in cs.flight_dumps
                    ],
                )
                all_ok = False
                points.append(point)
                _ship_events(obs_f, d, f"kill_{k:03d}")
                say(f"chaos-mp: kill@{k} victim=p{victim} -> "
                    f"UNRECOVERED: {type(e).__name__}")
                continue
            finally:
                stop_daemon(d)
            resume_s = time.perf_counter() - t0
            lines, metas, dupes = read_point(d)
            bad = [
                key for key, dg in lines.items() if oracle.get(key) != dg
            ]
            covered_ok = set(lines) >= want_keys
            resumed = {m["resumed_epoch"] for m in metas.values()}
            vd_crcs = {m.get("vd_crc") for m in metas.values()}
            killed = [e for e in res["worker_exits"] if e[1] == KILL_RC]
            point.update(
                resume_s=round(resume_s, 3),
                cluster_restarts=res["restarts"],
                worker_exits=res["worker_exits"],
                resumed_epochs=sorted(resumed),
                first_emission_s=min(
                    (m["first_emission_s"] for m in metas.values()
                     if m.get("first_emission_s") is not None),
                    default=None,
                ),
                kill_to_first_emission_s=_kill_to_first_emission(
                    d, victim, processes),
                epoch_torn_events=sum(
                    _count_events(
                        shard_events_path(d, p),
                        "resilience.epoch_torn",
                    )
                    for p in range(processes)
                ),
                ckpt_rejected_events=sum(
                    _count_rejections(shard_events_path(d, p))
                    for p in range(processes)
                ),
                flight_dumps=[
                    os.path.basename(p) for p in res["flight_dumps"]
                ],
            )
            # the contract, point by point: oracle-identical digests over
            # full coverage; every relaunched worker restored from A
            # complete epoch; byte-identical dictionaries; the injected
            # kill really landed. Workers USUALLY agree on one epoch, but
            # agreement is time-of-scan dependent: a fast worker that
            # restores from epoch e and replays forward re-commits its
            # shards, and that healing commit can COMPLETE a newer epoch
            # before a slower-booting peer runs its own rendezvous. Both
            # restores are complete-epoch restores, and deterministic
            # replay + digest dedupe make the outcome identical, so skew
            # is recorded (``epoch_agreed``) but only CORRECTNESS failures
            # fail the point.
            ok = (
                not bad and not dupes and covered_ok
                and len(metas) == processes
                and bool(resumed)
                and vd_crcs == {oracle_vd_crc}
                and killed and killed[0][0] == victim
                and res["restarts"] >= 1
                # the victim's kill fired under an installed flight
                # recorder; its dump is the point's black box and must be
                # in the ClusterSupervisor's failure report
                and len(point["flight_dumps"]) >= 1
            )
            point["epoch_agreed"] = len(resumed) == 1
            if k == corrupt_k and "epoch" in corrupted_epoch:
                # the FIRST rendezvous after the corruption must have
                # skipped the torn epoch (fallback strictly below it) and
                # visibly rejected it
                ok = ok and min(resumed) < corrupted_epoch["epoch"]
                ok = ok and point["epoch_torn_events"] >= 1
                point["corrupted_epoch"] = corrupted_epoch["epoch"]
            point["ok"] = ok
            if not ok:
                point["reason"] = (
                    f"{len(bad)} digest mismatches ({len(dupes)} conflicting "
                    f"dupes), covered={len(set(lines) & want_keys)}/"
                    f"{len(want_keys)}, resumed_epochs={sorted(resumed)}, "
                    f"vd_match={vd_crcs == {oracle_vd_crc}}, "
                    f"exits={res['worker_exits']}, "
                    f"flight_dumps={len(point['flight_dumps'])}"
                )
                all_ok = False
            points.append(point)
            _ship_events(obs_f, d, f"kill_{k:03d}")
            say(f"chaos-mp: kill@{k} victim=p{victim}"
                + ("+flip" if k == corrupt_k else "")
                + f" -> resumed_epoch={sorted(resumed)} "
                f"restarts={res['restarts']} ok={ok}")

        recov = sorted(
            p["first_emission_s"] for p in points
            if p.get("ok") and p.get("first_emission_s") is not None
        )
        kill_gaps = sorted(
            p["kill_to_first_emission_s"] for p in points
            if p.get("ok") and p.get("kill_to_first_emission_s") is not None
        )
        resumes = sorted(
            p["resume_s"] for p in points if p.get("ok") and "resume_s" in p
        )
        doc = {
            "config": geometry,
            "ok": all_ok,
            "oracle_s": oracle_s,
            "kill_points": len(points),
            "cluster_restarts_total": sum(
                p.get("cluster_restarts", 0) for p in points
            ),
            "epoch_torn_events_total": sum(
                p.get("epoch_torn_events", 0) for p in points
            ),
            "flight_dumps_total": sum(
                len(p.get("flight_dumps", ())) for p in points
            ),
            "recovery_s": {
                # worker start to first (re-)emission after relaunch:
                # rendezvous + restore + replay, excluding interpreter boot
                "p50": nearest_rank(recov, 50),
                "p90": nearest_rank(recov, 90),
                "max": recov[-1] if recov else None,
            },
            "kill_to_first_emission_s": {
                "p50": nearest_rank(kill_gaps, 50),
                "max": kill_gaps[-1] if kill_gaps else None,
            },
            "resume_wall_s": {
                "p50": nearest_rank(resumes, 50),
                "max": resumes[-1] if resumes else None,
            },
            "points": points,
            "failover": None,
            "rpc_failover": None,
        }
        if obs_f is not None:
            get_registry().remove_sink(sweep_sink)
            sweep_sink.close()
            _ship_events(obs_f, {"sweep": sweep_sink.path}, "sweep")
            doc["obs_log"] = os.path.basename(obs_log)
            obs_f.close()
        if workdir is None:
            shutil.rmtree(root, ignore_errors=True)
        return doc
    finally:
        # never leave the sweep's sink attached to the process-global
        # registry or the obs log handle open when an oracle check or
        # ClusterError aborts the sweep
        if sweep_sink is not None:
            get_registry().remove_sink(sweep_sink)
            sweep_sink.close()
        if obs_f is not None:
            obs_f.close()
        for dm in daemons.values():  # an abort mid-point leaves one
            dm.stop()


if __name__ == "__main__":
    if len(sys.argv) >= 3 and sys.argv[1] == "mp_worker":
        mp_worker_main(json.loads(sys.argv[2]))
    elif "--multiprocess" in sys.argv:
        print(json.dumps(run_mp_sweep(failover=False, rpc=False), indent=2))
    else:
        _not_ported("the single-process chaos sweep")
