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

:func:`run_sweep` is the single-process sweep: an ORACLE pass of the
superbatched CC pipeline, then for each kill point ``k`` a fresh worker
(:func:`worker_main`) that dies hard after ``k`` windows, optionally a
corrupted barrier head, and a relaunch to completion; every digest line
must equal the oracle's and together they must cover every window.

The serving scenarios: :func:`failover_main` kills the primary serving
worker in-process and proves the standby takeover; :func:`run_rpc_scenario`
kills the primary serving BINARY of a cross-process replica pair under live
multi-connection wire traffic (zero client-visible failures, promotion on
lease lapse, traces that cross the kill, :func:`trace_attribution`).
:func:`run_sharded_scenario` puts the routing tier in front of N shard
replicas (scaling cells, the hot-key cache, the cross-shard CC oracle, a
shard kill, delta pulls under churn), and :func:`run_storm_scenario` runs a
router fleet through a router kill, a shard promotion and a live split with
a transactional lane. Every replica of every scenario runs its tables on
``device`` (default ``"cuda"``, a CUDA context per replica process); the
routers and the scenario's own process never touch the card.

Worker entry points (subprocess only)::

    python -m gelly_streaming_tpu_torch.resilience.chaos worker '<json cfg>'
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

#: default single-process sweep geometry
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


def _check_replica_device(device) -> None:
    """Raise ``DeviceUnavailable`` before any replica is spawned when
    ``device`` names a card this machine lacks — a scenario whose
    replicas would all die at boot fails fast instead of timing out on
    their portfiles. Creates no CUDA context in this process."""
    import torch

    from .errors import DeviceUnavailable

    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise DeviceUnavailable(
            f"device {str(device)!r} was asked for but "
            "torch.cuda.is_available() is false; pass device='cpu' to "
            "run the replicas on the CPU")


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
    """Drive the supervised CC pipeline once. ``cfg`` keys: ``ckpt``,
    ``digests``, ``events``, ``meta`` (paths), ``kill_after`` (windows
    consumed before ``os._exit(KILL_RC)``; -1 = run to completion),
    optionally ``flight`` (flight-recorder dump base path), ``device``
    (where the CC runs; default ``"cuda"``, raising without a card), plus
    the sweep geometry (``windows``/``window_edges``/``superbatch``
    /``every``/``seed``)."""
    from ..aggregate.autockpt import AutoCheckpoint
    from ..core.stream import SimpleEdgeStream
    from ..core.window import CountWindow
    from ..library import ConnectedComponents
    from ..obs.registry import get_registry
    from . import faults
    from .supervisor import Supervisor

    raw = corpus(cfg["seed"], cfg["windows"] * cfg["window_edges"])
    sink = _worker_obs(cfg)

    device = cfg.get("device", "cuda")

    def make_stream(vd):
        return SimpleEdgeStream(
            raw, window=CountWindow(cfg["window_edges"]), vertex_dict=vd,
            device=device,
        )

    def make_work():
        return ConnectedComponents(superbatch=cfg["superbatch"])

    ac = AutoCheckpoint(cfg["ckpt"], every=cfg["every"], keep=3)
    resumed_from = ac.windows_done()
    sup = Supervisor(
        ac, backoff_base_s=0.0, jitter=0.0, seed=cfg["seed"]
    )
    kill_after = int(cfg.get("kill_after", -1))
    if kill_after >= 0:
        faults.install(faults.FaultPlan(
            seed=cfg["seed"],
            kill_at_window=kill_after - 1,
            kill_exit_code=KILL_RC,
        ))
    t0 = time.perf_counter()
    first = None
    yielded = 0
    with open(cfg["digests"], "a") as out:
        ordinal = resumed_from
        for comps in sup.run(make_stream, make_work):
            if first is None:
                first = time.perf_counter() - t0
            out.write(json.dumps({"o": ordinal, "d": digest(comps)}) + "\n")
            # flush BEFORE the kill hook: os._exit drops python-level
            # buffers, and the pre-crash digest lines are the evidence
            out.flush()
            if faults.active():
                faults.fire("chaos.window", index=ordinal)
            ordinal += 1
            yielded += 1
    with open(cfg["meta"], "w") as f:
        json.dump({
            "resumed_from": resumed_from,
            "restarts": sup.restarts,
            "yielded": yielded,
            "first_emission_s": first,
            "total_s": time.perf_counter() - t0,
        }, f)
    sink.close()
    get_registry().remove_sink(sink)
    faults.clear()


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
# Serving replica failover scenario (in-process: a worker death)
# --------------------------------------------------------------------- #
def failover_main(cfg: dict) -> None:
    """Kill the primary serving worker mid-stream and prove the standby
    takeover contract: expired in-flight queries fail DeadlineExceeded,
    the rest are re-answered from the standby's newest snapshot, new
    submits keep working, and every failover event lands in the obs
    event log. ``cfg`` keys: ``events``, ``meta``, ``seed``, ``device``
    (where the label tables live and the queries run; default
    ``"cuda"``)."""
    import numpy as np
    import torch

    from ..core.device import resolve_device

    from ..datasets import IdentityDict
    from ..obs import flight as obs_flight
    from ..obs.registry import get_registry
    from ..serving import ConnectedQuery, FailoverServer
    from . import faults
    from .errors import DeadlineExceeded

    # same wiring as every other chaos worker: streaming ShardSink
    # (ts-stamped events, kill-proof) + tracing + the flight recorder
    # whose dump the injected worker death must commit
    device = resolve_device(cfg.get("device", "cuda"))
    sink = _worker_obs(cfg)
    V = 32
    vd = IdentityDict(V)
    vd.observe(V - 1)

    def payloads():
        labels = np.arange(V, dtype=np.int32)
        for w in range(200):
            labels = labels.copy()
            labels[: min(V, w + 2)] = 0  # a chain growing one node/window
            yield {"labels": torch.as_tensor(labels, device=device),
                   "vdict": vd}, w + 1
            time.sleep(0.005)

    meta = {"promoted": False, "reanswered": 0, "expired": 0, "post": 0}
    # the worker dies on its 6th sweep (~0.3s in): deterministic ordinal,
    # wall timing irrelevant to the assertions below
    with faults.injected(faults.FaultPlan(
        seed=cfg["seed"], kill_site="serving.worker", kill_at_window=5,
    )):
        fs = FailoverServer(
            payloads(), None, monitor_s=None, max_pending=64,
        ).start()
        try:
            fs.store.wait_for(1, timeout=30)
            # admitted BEFORE the death: answered by the primary if it
            # gets there in time, re-answered by the standby otherwise —
            # either way the future must settle with the right value
            f_pre = fs.submit(ConnectedQuery(0, 1))
            deadline = time.monotonic() + 30
            while fs.primary.worker_alive() and time.monotonic() < deadline:
                time.sleep(0.01)
            assert not fs.primary.worker_alive(), "worker never died"
            # admitted while the worker is dead: one already-hopeless
            # deadline, two that the standby must re-answer
            f_exp = fs.primary.submit(ConnectedQuery(0, 1), deadline_s=0.01)
            f_ok = fs.primary.submit(ConnectedQuery(0, 1))
            f_ok2 = fs.primary.submit(ConnectedQuery(0, 1), deadline_s=30.0)
            time.sleep(0.05)  # f_exp's deadline lapses
            fs.promote(reason="worker_death")
            meta["promoted"] = fs.promoted
            try:
                f_exp.result(30)
            except DeadlineExceeded:
                meta["expired"] += 1
            for f in (f_ok, f_ok2):
                if f.result(30).value is True:
                    meta["reanswered"] += 1
            meta["pre"] = bool(f_pre.result(30).value)
            if fs.ask(ConnectedQuery(0, 1), timeout=30).value is True:
                meta["post"] = 1
        finally:
            fs.close()
    reg = get_registry()
    meta["failover_events"] = reg.counter(
        "serving.failover", reason="worker_death"
    ).value
    meta["worker_deaths"] = reg.counter("serving.worker_deaths").value
    meta["promotion_seconds_count"] = reg.histogram(
        "serving.promotion_seconds"
    ).count
    if cfg.get("flight"):
        meta["flight_dumps"] = [
            os.path.basename(p)
            for p in obs_flight.find_dumps(os.path.dirname(cfg["flight"]))
        ]
    with open(cfg["meta"], "w") as f:
        json.dump(meta, f)
    sink.close()
    get_registry().remove_sink(sink)


# --------------------------------------------------------------------- #
# RPC cross-process failover scenario (kill the serving BINARY under
# live multi-connection wire traffic)
# --------------------------------------------------------------------- #
#: the per-stage keys of the attribution table: client_send (submit ->
#: bytes on the wire), the server-side stages in wire order, then
#: client_recv (response frame -> futures settled); client_wait covers
#: retry/resubmit outage spans separately
ATTRIBUTION_STAGES = (
    "client_send", "decode", "admit", "queue_wait", "dispatch",
    "settle", "reply", "client_recv",
)


def trace_attribution(
    root,
    kill_wall: Optional[float] = None,
    back_wall: Optional[float] = None,
) -> dict:
    """Fold a traced RPC run's merged span stream into the per-stage
    attribution table.

    Per trace with a completed client root span (``rpc.client.batch``):
    the end-to-end client measurement, the answering replica's
    server-side residence (newest ``rpc.server.batch``) with its stage
    breakdown (decode/admit from its attrs; queue_wait/dispatch/settle
    from the answering sweep's ``serving.query``), the client-side wait
    spans (retry/resubmit), and the attribution COVERAGE — attributed
    time over the client's own e2e, the honesty ratio the bench
    asserts. Traces are bucketed steady vs promotion-window by overlap
    with ``[kill_wall, back_wall]``; a trace counts as KILL-CROSSING
    when its client waited out an outage (resubmit/retry span) and its
    server spans came from at least two distinct shards — the dead
    primary and the promoted standby."""
    from collections import defaultdict

    from ..obs.cluster import iter_shard_events
    from ..obs.registry import nearest_rank

    by_trace: dict = defaultdict(list)
    for e in iter_shard_events(root):
        if e.get("kind") == "span" and e.get("trace"):
            by_trace[e["trace"]].append(e)

    def bucket():
        return {
            "e2e": [], "coverage": [], "client_wait": [],
            "unattributed": [], "stages": defaultdict(list),
        }

    per = {"steady": bucket(), "promotion_window": bucket()}
    crossing = 0
    completed = 0
    example = None
    for tid in sorted(by_trace):
        spans = by_trace[tid]
        roots = [s for s in spans if s["name"] == "rpc.client.batch"]
        if not roots:
            continue  # unanswered (expired) or foreign trace
        completed += 1
        c = roots[-1]
        e2e = float(c["dur_s"])
        end = float(c["ts"])
        start = end - e2e
        promo = (
            kill_wall is not None and back_wall is not None
            and end >= kill_wall and start <= back_wall
        )
        server_batches = sorted(
            (s for s in spans if s["name"] == "rpc.server.batch"),
            key=lambda s: float(s["ts"]),
        )
        sweeps = sorted(
            (s for s in spans if s["name"] == "serving.query"),
            key=lambda s: float(s["ts"]),
        )
        waits = [
            s for s in spans
            if s["name"] in ("rpc.client.retry", "rpc.client.resubmit")
        ]
        server_s = float(server_batches[-1]["dur_s"]) \
            if server_batches else 0.0
        wait_s = sum(float(s["dur_s"]) for s in waits)
        c_at = c.get("attrs") or {}
        send_s = float(c_at.get("send_s", 0.0))
        recv_s = float(c_at.get("recv_s", 0.0))
        # send_s spans submit -> LAST send, so for a retried batch it
        # overlaps the wait spans (which cover send -> resend cycles);
        # take whichever accounts for more, never both
        attributed = server_s + recv_s + max(send_s, wait_s)
        server_shards = {
            s.get("shard") for s in spans
            if s["name"] in ("rpc.decode", "rpc.admit",
                             "rpc.server.batch", "serving.query")
        } - {None}
        if waits and len(server_shards) >= 2:
            crossing += 1
            if example is None:
                example = tid
        b = per["promotion_window" if promo else "steady"]
        b["e2e"].append(e2e)
        b["coverage"].append(attributed / e2e if e2e > 0 else 1.0)
        b["client_wait"].append(wait_s)
        b["unattributed"].append(max(0.0, e2e - attributed))
        b["stages"]["client_send"].append(send_s)
        b["stages"]["client_recv"].append(recv_s)
        if server_batches:
            at = server_batches[-1].get("attrs") or {}
            b["stages"]["decode"].append(float(at.get("decode_s", 0.0)))
            b["stages"]["admit"].append(float(at.get("admit_s", 0.0)))
            b["stages"]["reply"].append(float(at.get("reply_s", 0.0)))
        if sweeps:
            at = sweeps[-1].get("attrs") or {}
            b["stages"]["queue_wait"].append(
                float(at.get("queue_wait_s", 0.0)))
            b["stages"]["dispatch"].append(
                float(at.get("dispatch_s", 0.0)))
            b["stages"]["settle"].append(
                float(at.get("settle_s", 0.0)))

    def summarize(b: dict) -> dict:
        e2e_ms = sorted(v * 1e3 for v in b["e2e"])
        cov = sorted(b["coverage"])

        def mean_ms(xs):
            return round(sum(xs) / len(xs) * 1e3, 3) if xs else None

        return {
            "traces": len(b["e2e"]),
            # None for an empty bucket, like every other field here —
            # a 0.0 p50 would read as "measured zero latency"
            "e2e_ms": {
                "p50": round(nearest_rank(e2e_ms, 50), 3),
                "p99": round(nearest_rank(e2e_ms, 99), 3),
            } if e2e_ms else None,
            "stages_ms": {
                k: mean_ms(b["stages"][k]) for k in ATTRIBUTION_STAGES
            },
            "client_wait_ms": mean_ms(b["client_wait"]),
            "unattributed_ms": mean_ms(b["unattributed"]),
            "unattributed_p50_ms": (
                round(nearest_rank(
                    sorted(v * 1e3 for v in b["unattributed"]), 50), 3)
                if b["unattributed"] else None
            ),
            "coverage_p50": (
                round(nearest_rank(cov, 50), 4) if cov else None
            ),
        }

    return {
        "traces_total": len(by_trace),
        "traces_completed": completed,
        "kill_crossing_traces": crossing,
        "example_kill_crossing_trace": example,
        "steady": summarize(per["steady"]),
        "promotion_window": summarize(per["promotion_window"]),
    }


def run_rpc_scenario(
    root: str,
    *,
    seed: int = MP_DEFAULTS["seed"],
    clients: int = 3,
    batch: int = 8,
    pace_s: float = 0.01,
    kill_at_sweep: int = 120,
    lease_s: float = 0.4,
    deadline_s: float = 30.0,
    post_kill_batches: int = 25,
    vcap: int = 64,
    autotune: bool = False,
    target_wait_s: Optional[float] = None,
    log: Optional[Callable[[str], None]] = None,
    obs_f=None,
    device: str = "cuda",
) -> dict:
    """The wire-level availability proof: a primary + standby
    serving BINARY pair on a shared snapshot directory, a
    multi-connection client load generator sustaining batched query
    traffic, and a ``FaultPlan`` kill (the ``serving.worker.busy`` site
    at the first sweep at or after ``kill_at_sweep`` that holds a batch,
    ``os._exit`` with the flight recorder's black box dumped first) of
    the primary mid-run. The standby promotes on heartbeat-lease lapse;
    clients reconnect and resubmit under their original batch ids.

    Asserted: ZERO client-visible query failures — every submitted
    query resolves to an answer or a clean ``DeadlineExceeded`` within
    its own budget — plus the promotion evidence (``serving.failover``
    with ``reason=lease_lapse`` and a ``serving.promotion_seconds``
    observation in the standby's event stream) and the dead primary's
    flight dump. Client-MEASURED batch latency is reported separately
    for steady state and for the promotion window (batches whose life
    overlapped the outage), which is the artifact's headline.

    The run is TRACED: the scenario's own process enables tracing and ships
    its client-side spans as shard ``p2``, so the merged OBS log holds
    end-to-end traces — client batch root + retry/resubmit spans joined
    to each replica's decode/admit/dispatch/reply spans by trace id.
    The committed artifact gains a per-stage ATTRIBUTION table (steady
    vs promotion window), and the scenario additionally asserts that at
    least one trace CROSSES the kill (client resubmit spans joined to
    both the dead primary's and the promoted standby's server spans)
    and that per-stage attribution accounts for the client-measured
    end-to-end latency of answered steady-state batches to within 10%.

    ``device`` is where both replicas' label tables live and their
    queries run (default ``"cuda"``: each replica process makes its own
    CUDA context; the scenario's own process never touches the card).
    """
    import threading

    from ..obs import trace as obs_trace
    from ..obs.cluster import ShardSink, shard_events_path
    from ..obs.registry import get_registry, nearest_rank
    from ..serving.client import RpcClient
    from ..serving.query import ConnectedQuery
    from ..serving.rpc import spawn_replica, wait_portfile
    from .errors import DeadlineExceeded

    say = log or (lambda s: print(s, file=sys.stderr, flush=True))
    os.makedirs(root, exist_ok=True)
    client_sink = None
    shared = os.path.join(root, "shared")
    base = dict(
        dir=shared, lease_s=lease_s, windows=1 << 20, pace_s=0.01,
        vcap=vcap, run_s=600.0, seed=seed, device=device,
    )
    if autotune:
        # load-aware admission on both replicas;
        # the promoted standby's meta carries the tuner's trajectory
        base.update(autotune=True, target_wait_s=target_wait_s)
    standby_meta = os.path.join(root, "standby.meta.json")
    primary = spawn_replica(dict(
        base, role="primary", shard=0,
        kill_at_sweep=kill_at_sweep,
        portfile=os.path.join(root, "primary.port"),
        events=shard_events_path(root, 0),
        flight=os.path.join(root, "flight.p0.json"),
    ))
    standby = spawn_replica(dict(
        base, role="standby", shard=1,
        portfile=os.path.join(root, "standby.port"),
        events=shard_events_path(root, 1),
        meta=standby_meta,
    ))
    doc: dict = {
        "config": dict(
            clients=clients, batch=batch, pace_s=pace_s,
            kill_at_sweep=kill_at_sweep, lease_s=lease_s,
            deadline_s=deadline_s, seed=seed, autotune=autotune,
            device=device,
        ),
    }
    try:
        # this process IS the client of the trace story: its
        # spans (batch roots, retries, resubmits) and client-side
        # counters ship as shard p2 next to the replicas' p0/p1
        # streams. Attached INSIDE the try so a failed setup releases
        # them in the finally (no obs sink may leak);
        # registry_spans off for the same reason as replica_main — the
        # span events themselves are the committed evidence
        client_sink = ShardSink(shard_events_path(root, 2), shard=2)
        obs_trace.add_sink(client_sink)
        get_registry().add_sink(client_sink)
        obs_trace.enable(registry_spans=False)
        # perf_counter -> wall-clock offset: span events carry wall
        # ts, this process's kill/recovery stamps are perf_counter — one
        # offset joins the two clocks for promotion-window bucketing
        wall_off = time.time() - time.perf_counter()
        p_port = wait_portfile(os.path.join(root, "primary.port"))
        s_port = wait_portfile(os.path.join(root, "standby.port"))
        addrs = [f"127.0.0.1:{p_port}", f"127.0.0.1:{s_port}"]
        say(f"chaos-rpc: primary :{p_port} (kill@sweep {kill_at_sweep}), "
            f"standby :{s_port}, {clients} client connections x "
            f"{batch}-query batches")

        kill_seen = [None]  # perf_counter stamp of the observed death

        def watch_primary():
            primary.wait()
            kill_seen[0] = time.perf_counter()

        watcher = threading.Thread(target=watch_primary, daemon=True)
        watcher.start()

        # (submit_ts, settle_ts, ok, deadline, error_repr) per batch
        records: list = []
        rec_lock = threading.Lock()
        client_errs: list = []

        def drive(ci: int) -> None:
            # one CONNECTION per load thread: the multi-connection
            # half of the contract, each with its own reconnect loop
            import numpy as np

            rng = np.random.default_rng(seed + ci)
            cl = RpcClient(addrs, seed=seed + ci)
            try:
                post = 0
                while post < post_kill_batches:
                    qs = [
                        ConnectedQuery(int(a), int(b))
                        for a, b in rng.integers(0, vcap, (batch, 2))
                    ]
                    t0 = time.perf_counter()
                    futs = cl.submit_batch(qs, deadline_s=deadline_s)
                    n_dead = 0
                    err = None
                    for f in futs:
                        try:
                            f.result(deadline_s + 30)
                        except DeadlineExceeded:
                            n_dead += 1
                        except BaseException as e:
                            err = err or repr(e)[:200]
                    t1 = time.perf_counter()
                    with rec_lock:
                        records.append(
                            (t0, t1, err is None, n_dead, err)
                        )
                    if kill_seen[0] is not None and t1 > kill_seen[0]:
                        post += 1
                    if pace_s:
                        time.sleep(pace_s)
            except BaseException as e:
                # a dead load generator would under-report the outage;
                # its failure is the scenario's failure
                client_errs.append(repr(e)[:400])
            finally:
                cl.close()

        threads = [
            threading.Thread(target=drive, args=(i,), daemon=True)
            for i in range(clients)
        ]
        t_start = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
        watcher.join(60)
        t_kill = kill_seen[0]
        primary_rc = primary.returncode

        # -- classify batches: steady vs promotion window --------------- #
        answered = sum(1 for r in records if r[2])
        failures = sum(1 for r in records if not r[2])
        deadline_expired = sum(r[3] for r in records)
        t_back = None
        if t_kill is not None:
            settled_after = sorted(
                r[1] for r in records if r[2] and r[1] > t_kill
            )
            t_back = settled_after[0] if settled_after else None
        steady, promo = [], []
        for t0, t1, ok_b, _nd, _e in records:
            if not ok_b:
                continue
            lat = (t1 - t0) * 1000.0
            if (
                t_kill is not None and t_back is not None
                and t1 >= t_kill and t0 <= t_back
            ):
                promo.append(lat)
            else:
                steady.append(lat)
        steady.sort()
        promo.sort()

        # -- autotune trajectory: the drive is
        # over, so the promoted standby can be retired NOW — its exit
        # meta carries the admission tuner's full shed-watermark
        # trajectory (moves + final knobs), and the retune events below
        # are read after its stream is complete ------------------------ #
        if autotune:
            if standby.poll() is None:
                standby.terminate()
                try:
                    standby.wait(20)
                except Exception:
                    _kill_replica(standby)
            try:
                with open(standby_meta) as f:
                    sb_tuner = json.load(f).get("autotune")
            except (OSError, ValueError):
                sb_tuner = None
            doc["autotune"] = {
                "standby": sb_tuner,
                "retunes": [
                    {"shard": f"p{sh}", "ts": e.get("ts"),
                     **(e.get("labels") or {})}
                    for sh in (0, 1)
                    for e in _read_jsonl(shard_events_path(root, sh))
                    if e.get("name") == "control.retune"
                ],
            }

        # -- promotion evidence from the standby's event stream --------- #
        sb_events = _read_jsonl(shard_events_path(root, 1))
        promoted = any(
            e.get("name") == "serving.failover"
            and (e.get("labels") or {}).get("reason") == "lease_lapse"
            for e in sb_events
        )
        promotion_obs = [
            float(e["v"]) for e in sb_events
            if e.get("name") == "serving.promotion_seconds"
            and "v" in e
        ]
        from ..obs import flight as obs_flight

        flight_dumps = [
            os.path.basename(p) for p in obs_flight.find_dumps(root)
        ]

        # -- per-stage trace attribution --------------------------------- #
        attribution = trace_attribution(
            root,
            kill_wall=(t_kill + wall_off if t_kill is not None
                       else None),
            back_wall=(t_back + wall_off if t_back is not None
                       else None),
        )
        wire_ex = get_registry().histogram(
            "rpc.client_wire_seconds"
        ).exemplars()
        cov = attribution["steady"]["coverage_p50"]
        # the unattributed residue per trace (thread wakeups + socket
        # syscalls BETWEEN spans) is a host constant, not a fraction of
        # e2e: on a fast box a ~0.35ms OS gap under a ~2ms e2e fails a
        # pure ratio gate while attributing exactly as much as ever —
        # so the 10% ratio check gets an absolute scheduling floor
        unattr = attribution["steady"]["unattributed_p50_ms"]
        traced_ok = (
            attribution["kill_crossing_traces"] >= 1
            and cov is not None and cov <= 1.05
            and (cov >= 0.9
                 or (unattr is not None and unattr <= 0.5))
        )
        ok = (
            not client_errs
            and failures == 0
            and t_kill is not None
            and primary_rc == KILL_RC
            and t_back is not None
            and promoted
            and len(promotion_obs) >= 1
            and len(flight_dumps) >= 1
            and traced_ok
        )
        doc.update(
            ok=ok,
            batches=len(records),
            queries=len(records) * batch,
            queries_answered=answered * batch - deadline_expired,
            failures=failures,
            client_errors=client_errs,
            deadline_expired=deadline_expired,
            primary_rc=primary_rc,
            kill_wall_s=(
                round(t_kill - t_start, 3) if t_kill is not None
                else None
            ),
            outage_s=(
                round(t_back - t_kill, 3)
                if t_kill is not None and t_back is not None else None
            ),
            steady={
                "batches": len(steady),
                "p50_ms": round(nearest_rank(steady, 50), 3),
                "p99_ms": round(nearest_rank(steady, 99), 3),
            },
            promotion_window={
                "batches": len(promo),
                "p50_ms": round(nearest_rank(promo, 50), 3),
                "p99_ms": round(nearest_rank(promo, 99), 3),
                "max_ms": round(promo[-1], 3) if promo else None,
            },
            serving_promotion_seconds=(
                round(promotion_obs[0], 4) if promotion_obs else None
            ),
            promoted=promoted,
            flight_dumps=flight_dumps,
            attribution=attribution,
            wire_p99_exemplar_trace=(
                wire_ex[0][1] if wire_ex else None
            ),
            note=(
                "client-measured batch latency over live wire traffic "
                "across a primary serving-binary kill: zero failures "
                "means every query was answered or cleanly "
                "DeadlineExceeded within its own budget; the promotion "
                "window covers batches whose life overlapped the "
                "outage. attribution breaks answered batches into "
                "per-stage time from the merged trace spans (steady "
                "coverage_p50 is attributed/e2e — asserted within 10% "
                "or within a 0.5ms absolute inter-span scheduling "
                "floor, the OS residue that does not shrink with e2e); "
                "wire_p99_exemplar_trace links the wire-latency "
                "histogram's tail to one renderable trace "
                "(obs.timeline --trace <id> over the OBS log)"
            ),
        )
        if not ok:
            doc["reason"] = (
                f"failures={failures}, client_errs={len(client_errs)}, "
                f"primary_rc={primary_rc}, recovered={t_back is not None}, "
                f"promoted={promoted}, "
                f"crossing={attribution['kill_crossing_traces']}, "
                f"coverage_p50={cov}, unattributed_p50={unattr}, "
                f"promotion_obs={len(promotion_obs)}, "
                f"flight_dumps={len(flight_dumps)}"
            )
        say(f"chaos-rpc: ok={ok} batches={len(records)} "
            f"failures={failures} outage={doc.get('outage_s')}s "
            f"steady_p99={doc['steady']['p99_ms']}ms "
            f"promo_p99={doc['promotion_window']['p99_ms']}ms "
            f"traces={attribution['traces_completed']} "
            f"crossing={attribution['kill_crossing_traces']} "
            f"coverage_p50={cov}")
        return doc
    finally:
        if client_sink is not None:
            obs_trace.disable()
            obs_trace.remove_sink(client_sink)
            get_registry().remove_sink(client_sink)
        for p in (primary, standby):
            if p.poll() is None:
                p.terminate()
                try:
                    p.wait(20)
                except Exception:
                    _kill_replica(p)
        if client_sink is not None:
            client_sink.close()
        _ship_events(obs_f, root, "rpc_failover")


# --------------------------------------------------------------------- #
# Sharded serving scenario: router fan-out + hot-key cache
# --------------------------------------------------------------------- #
#: sharded scenario geometry. The keyspace (16k vertices) is TWICE the
#: router's default cache capacity, so the hot-key cache holds the
#: Zipfian HEAD, never the whole keyspace — hits are the power-law hot
#: set, tail keys keep fanning out. Load cells drive enough concurrent
#: connections to SATURATE (closed-loop latency-bound numbers would
#: measure scheduling, not capacity).
SHARDED_DEFAULTS = dict(
    n_vertices=1 << 14, n_edges=1 << 15, window=2048, seed=29,
    batch=32, measure_s=4.0, zipf_a=1.5, deadline_s=30.0, lease_s=0.4,
    # churn cell: ~1% of the keyspace touched per version
    # bump (each edge touches <= 2 vertices), paced so the routers
    # observe every bump as a separate refresh
    churn_bumps=24, churn_frac=0.01, churn_pace_s=0.15,
)

#: event-shard ids for the non-replica processes of the sharded story
#: (replicas are p0..p<n-1>)
ROUTER_SHARD = 10
CLIENT_SHARD = 11


def _spawn_shard_replicas(cell_dir: str, n: int, *, base_cfg: dict,
                          standby_shards=(), lease_s: float,
                          events: bool = False, device: str = "cuda"):
    """Spawn ``n`` shard primaries (each on its own serving directory),
    plus a standby for every shard in ``standby_shards``. Returns
    ``(procs, shard_addrs)`` where ``shard_addrs[k]`` lists the shard's
    primary (and standby) address — the router's per-shard failover
    address list. ``events`` attaches streaming ShardSinks (the
    EVIDENCE cell's shape; measurement-only cells skip them so the
    event stream never rides inside a QPS number). ``device`` is where
    every replica's tables live (each makes its own CUDA context)."""
    from ..serving.rpc import spawn_replica, wait_portfile

    procs = []
    from ..obs.cluster import shard_events_path

    for k in range(n):
        sdir = os.path.join(cell_dir, f"s{k}")
        cfg = dict(
            dir=sdir, role="primary", lease_s=lease_s, run_s=600.0,
            shard=k,
            cc_shard=dict(base_cfg, shard=k, nshards=n),
            portfile=os.path.join(cell_dir, f"s{k}.primary.port"),
            device=device,
        )
        if events:
            cfg["events"] = shard_events_path(cell_dir, k)
        procs.append(spawn_replica(cfg))
    for k in standby_shards:
        sdir = os.path.join(cell_dir, f"s{k}")
        cfg = dict(
            dir=sdir, role="standby", lease_s=lease_s, run_s=600.0,
            shard=100 + k,
            portfile=os.path.join(cell_dir, f"s{k}.standby.port"),
            device=device,
        )
        if events:
            cfg["events"] = shard_events_path(cell_dir, 100 + k)
        procs.append(spawn_replica(cfg))
    out = []
    for k in range(n):
        port = wait_portfile(
            os.path.join(cell_dir, f"s{k}.primary.port"))
        entry = [f"127.0.0.1:{port}"]
        if k in standby_shards:
            sport = wait_portfile(
                os.path.join(cell_dir, f"s{k}.standby.port"))
            entry.append(f"127.0.0.1:{sport}")
        out.append(entry)
    return procs, out


def _wait_watermark(addr, want: int, timeout_s: float = 120.0) -> None:
    """Block until the replica's published watermark reaches ``want``
    (its shard stream fully folded) — measurements must not race
    ingest."""
    from ..serving.client import RpcClient
    from ..serving.query import DegreeQuery

    cl = RpcClient([addr] if isinstance(addr, str) else addr)
    try:
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            ans = cl.ask(DegreeQuery(0), timeout=30, deadline_s=30)
            if int(ans.watermark) >= want:
                return
            time.sleep(0.05)
        raise TimeoutError(
            f"shard at {addr} never reached watermark {want}"
        )
    finally:
        cl.close()


def _median_load(addrs, keys_fn, *, reps: int = 3, **kw):
    """``reps`` independent :func:`_drive_load` passes; returns the
    MEDIAN-qps pass's full dict with every pass's qps recorded. The
    gate-bearing cells use this: on a shared 2-core host a single pass
    swings tens of percent with scheduler luck, and a ratio of two
    single passes from different cells measures that luck, not the
    tier."""
    runs = sorted(
        (_drive_load(addrs, keys_fn, **kw) for _ in range(reps)),
        key=lambda d: d["qps"],
    )
    out = dict(runs[len(runs) // 2])
    out["qps_all"] = [d["qps"] for d in runs]
    # failure accounting must cover EVERY pass, not just the median one
    out["failures"] = sum(d["failures"] for d in runs)
    out["deadline_expired"] = sum(d["deadline_expired"] for d in runs)
    out["errors"] = [e for d in runs for e in d["errors"]]
    return out


def _drive_load(addrs, keys_fn, *, batch: int, duration_s: float,
                deadline_s: float, clients: int = 2, seed: int = 0,
                query_cls=None):
    """Closed-loop load: ``clients`` threads, each its own connection,
    each submitting ``batch``-query frames of ``query_cls`` over keys
    from ``keys_fn(rng, batch)`` until ``duration_s`` elapses. Returns
    aggregate qps + batch-latency percentiles + failure counts."""
    import threading

    import numpy as np

    from ..obs.registry import nearest_rank
    from ..serving.client import RpcClient
    from ..serving.query import DegreeQuery
    from .errors import DeadlineExceeded

    qcls = query_cls or DegreeQuery
    lock = threading.Lock()
    lats: list = []
    counts = [0, 0, 0]  # answered, failures, deadline_expired
    errs: list = []

    def drive(ci: int) -> None:
        rng = np.random.default_rng(seed + 1000 + ci)
        cl = RpcClient(addrs, seed=seed + ci)
        try:
            end = time.monotonic() + duration_s
            while time.monotonic() < end:
                ks = keys_fn(rng, batch)
                qs = [qcls(int(v)) for v in ks]
                t0 = time.perf_counter()
                futs = cl.submit_batch(qs, deadline_s=deadline_s)
                n_ok = n_dead = n_fail = 0
                for f in futs:
                    try:
                        f.result(deadline_s + 30)
                        n_ok += 1
                    except DeadlineExceeded:
                        n_dead += 1
                    except BaseException as e:
                        n_fail += 1
                        if len(errs) < 5:
                            errs.append(repr(e)[:200])
                lat = (time.perf_counter() - t0) * 1000.0
                with lock:
                    lats.append(lat)
                    counts[0] += n_ok
                    counts[1] += n_fail
                    counts[2] += n_dead
        except BaseException as e:
            with lock:
                errs.append(repr(e)[:400])
        finally:
            cl.close()

    threads = [
        threading.Thread(target=drive, args=(i,), daemon=True)
        for i in range(clients)
    ]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(duration_s + 120)
    wall = time.perf_counter() - t0
    lats.sort()
    return {
        "qps": round(counts[0] / wall, 1) if wall else 0.0,
        "batches": len(lats),
        "p50_ms": round(nearest_rank(lats, 50), 3) if lats else None,
        "p99_ms": round(nearest_rank(lats, 99), 3) if lats else None,
        "answered": counts[0],
        "failures": counts[1],
        "deadline_expired": counts[2],
        "errors": errs,
    }


def _teardown(procs) -> None:
    for p in procs:
        if p.poll() is None:
            p.terminate()
            try:
                p.wait(20)
            except Exception:
                _kill_replica(p)


def run_sharded_scenario(
    root: str,
    *,
    n_vertices: int = SHARDED_DEFAULTS["n_vertices"],
    n_edges: int = SHARDED_DEFAULTS["n_edges"],
    window: int = SHARDED_DEFAULTS["window"],
    seed: int = SHARDED_DEFAULTS["seed"],
    batch: int = SHARDED_DEFAULTS["batch"],
    measure_s: float = SHARDED_DEFAULTS["measure_s"],
    zipf_a: float = SHARDED_DEFAULTS["zipf_a"],
    deadline_s: float = SHARDED_DEFAULTS["deadline_s"],
    lease_s: float = SHARDED_DEFAULTS["lease_s"],
    churn_bumps: int = SHARDED_DEFAULTS["churn_bumps"],
    churn_frac: float = SHARDED_DEFAULTS["churn_frac"],
    churn_pace_s: float = SHARDED_DEFAULTS["churn_pace_s"],
    clients: int = 4,
    oracle_checks: int = 512,
    kill_hold_s: float = 1.0,
    post_kill_batches: int = 40,
    log: Optional[Callable[[str], None]] = None,
    obs_f=None,
    device: str = "cuda",
) -> dict:
    """The sharded-serving proof: shard replicas + the
    routing tier as REAL processes on one box, measured end to end.

    Cells (each torn down before the next):

    - **c1** — one shard holding the WHOLE keyspace: the single-replica
      baseline, measured DIRECT (client -> replica, the wire-level
      failover pair's shape)
      under uniform and Zipfian key traffic, plus the router-with-one-
      shard cell of the scaling curve.
    - **c2** — two shards (shard 0 with a standby): the scaling cell,
      Zipfian latency with the hot-key cache OFF vs ON (the headline:
      cache-on aggregate QPS vs the c1 single-replica baseline), the
      cross-shard CC oracle-identity check, one TRACED batch whose
      spans must join client, router, and both shards, and the
      kill-one-shard point — shard 0's primary SIGKILLed under live
      per-owner traffic; the unaffected shard's keys must see ZERO
      failures (and no outage), shard 0's keys fail over to its
      standby with zero failures and a measured blip.
    - **c3** — the delta-pull churn cell: the 2-shard
      topology under LIVE INGEST (paced ~1%-touched version bumps),
      one pull-protocol-v2 router vs one full-re-pull baseline router
      on the same stream; the gate is per-refresh pulled bytes AND
      router merge-refresh time both >= 5x below the baseline, with a
      post-churn oracle identity check on both routers.
    - **c4** — four shards: the tail of the scaling curve.

    The box's core count is recorded (``host_cores``): on a 2-core
    host the cache-off fan-out cells are CORE-BOUND (router + shards +
    client share two cores; the same plateau the sharded ingest sweep
    records) — the headline is the cache tier, which REDUCES total work
    per query rather than spreading it.

    ``device`` (default ``"cuda"``) is where every shard replica's
    tables live and its query steps run: each replica process makes its
    own CUDA context. The routers never touch the card
    (:func:`~gelly_streaming_tpu_torch.serving.router.spawn_router`), and
    neither does this process: its oracle is the host fold.
    """
    import threading

    import numpy as np

    from ..core.ingest import partition_edges_by_vertex, vertex_owner
    from ..obs import trace as obs_trace
    from ..obs.cluster import ShardSink, shard_events_path
    from ..obs.registry import get_registry, nearest_rank
    from ..serving.client import RpcClient
    from ..serving.query import (
        ComponentSizeQuery,
        ConnectedQuery,
        DegreeQuery,
    )
    from ..serving.router import (
        demo_shard_edges,
        spawn_router,
    )
    from ..serving.rpc import wait_portfile
    from ..summaries.forest import fold_edges_host, resolve_flat_host

    _check_replica_device(device)
    say = log or (lambda s: print(s, file=sys.stderr, flush=True))
    os.makedirs(root, exist_ok=True)
    base_cfg = dict(
        n_vertices=n_vertices, n_edges=n_edges, seed=seed,
        window=window,
    )
    # the scenario-side oracle: same generator, whole stream, one fold
    src, dst = demo_shard_edges(n_vertices, n_edges, seed)
    olab = fold_edges_host(
        np.arange(n_vertices, dtype=np.int32), src, dst)
    osizes = np.bincount(olab, minlength=n_vertices)
    odeg = (np.bincount(src, minlength=n_vertices)
            + np.bincount(dst, minlength=n_vertices))
    perm = np.random.default_rng(seed + 5).permutation(n_vertices)

    def uniform_keys(rng, k):
        return rng.integers(0, n_vertices, k)

    def zipf_keys(rng, k):
        return perm[(rng.zipf(zipf_a, k) - 1) % n_vertices]

    def shard_watermarks(n: int):
        parts = partition_edges_by_vertex(src, dst, None, n)
        return [len(s) for s, _d, _v in parts]

    doc: dict = {
        "config": dict(
            n_vertices=n_vertices, n_edges=n_edges, window=window,
            seed=seed, batch=batch, measure_s=measure_s,
            zipf_a=zipf_a, clients=clients, lease_s=lease_s,
            host_cores=os.cpu_count(),
        ),
    }

    # `deadline_s` names a PER-BATCH budget: every load-cell batch and
    # every kill-phase batch is an independent query set with its own
    # full budget (the rebind declares that intent; the oracle/trace
    # sections spend one budget through remaining-computations)
    per_batch_deadline_s = float(deadline_s)

    def spawn_cell_router(cell_dir: str, shard_addrs, *, cache: bool,
                          tag: str, events: bool = False,
                          delta: bool = True):
        cfg = dict(
            shards=shard_addrs, cache=cache, delta=delta,
            portfile=os.path.join(cell_dir, f"router.{tag}.port"),
            meta=os.path.join(cell_dir, f"router.{tag}.meta.json"),
            run_s=600.0,
        )
        if events:
            cfg["events"] = shard_events_path(cell_dir, ROUTER_SHARD)
            cfg["shard"] = ROUTER_SHARD
        p = spawn_router(cfg)
        port = wait_portfile(cfg["portfile"])
        return p, f"127.0.0.1:{port}", cfg["meta"]

    scaling: dict = {}
    try:
        # ---- cell 1: single shard -------------------------------------- #
        c1 = os.path.join(root, "c1")
        os.makedirs(c1, exist_ok=True)
        procs, shard_addrs = _spawn_shard_replicas(
            c1, 1, base_cfg=base_cfg, lease_s=lease_s, device=device)
        try:
            _wait_watermark(shard_addrs[0], shard_watermarks(1)[0])
            say("sharded: c1 up (1 shard, whole keyspace)")
            direct_uniform = _drive_load(
                shard_addrs[0], uniform_keys, batch=batch,
                duration_s=measure_s, deadline_s=per_batch_deadline_s,
                clients=clients, seed=seed)
            direct_zipf = _median_load(
                shard_addrs[0], zipf_keys, batch=batch,
                duration_s=measure_s, deadline_s=per_batch_deadline_s,
                clients=clients, seed=seed + 1)
            rp, raddr, _meta = spawn_cell_router(
                c1, shard_addrs, cache=False, tag="off")
            routed1 = _drive_load(
                [raddr], uniform_keys, batch=batch,
                duration_s=measure_s, deadline_s=per_batch_deadline_s,
                clients=clients, seed=seed + 2)
            _teardown([rp])
            scaling["s1"] = {"qps": routed1["qps"],
                             "p50_ms": routed1["p50_ms"],
                             "p99_ms": routed1["p99_ms"]}
            doc["single_replica"] = {
                "uniform": direct_uniform, "zipf": direct_zipf,
            }
            say(f"sharded: c1 direct zipf qps={direct_zipf['qps']} "
                f"routed-1shard qps={routed1['qps']}")
        finally:
            _teardown(procs)
            _ship_events(obs_f, c1, "c1")

        # ---- cell 2a: two shards, MEASUREMENT (no event sinks — the
        # QPS/latency cells must not time the evidence stream) --------- #
        c2 = os.path.join(root, "c2")
        os.makedirs(c2, exist_ok=True)
        procs, shard_addrs = _spawn_shard_replicas(
            c2, 2, base_cfg=base_cfg, lease_s=lease_s, device=device)
        client_sink = None
        try:
            wm = shard_watermarks(2)
            for k in range(2):
                _wait_watermark(shard_addrs[k][0], wm[k])
            say("sharded: c2 up (2 shards, measurement phase)")
            rp_off, raddr_off, _m = spawn_cell_router(
                c2, shard_addrs, cache=False, tag="off")
            routed2 = _drive_load(
                [raddr_off], uniform_keys, batch=batch,
                duration_s=measure_s, deadline_s=per_batch_deadline_s,
                clients=clients, seed=seed + 3)
            scaling["s2"] = {"qps": routed2["qps"],
                             "p50_ms": routed2["p50_ms"],
                             "p99_ms": routed2["p99_ms"]}
            zipf_off = _median_load(
                [raddr_off], zipf_keys, batch=batch,
                duration_s=measure_s, deadline_s=per_batch_deadline_s,
                clients=clients, seed=seed + 4)
            _teardown([rp_off])

            rp_on, raddr_on, meta_on = spawn_cell_router(
                c2, shard_addrs, cache=True, tag="on")
            # warm the Zipfian HEAD into the cache, then measure
            _drive_load([raddr_on], zipf_keys, batch=batch,
                        duration_s=2.0, deadline_s=per_batch_deadline_s,
                        clients=2, seed=seed + 5)
            zipf_on = _median_load(
                [raddr_on], zipf_keys, batch=batch,
                duration_s=measure_s, deadline_s=per_batch_deadline_s,
                clients=clients, seed=seed + 6)
            # the cache's BEST case, measured for the record: a tiny
            # hot set (64 keys — "millions of users hammering a small
            # hot set"), every batch short-circuiting the fan-out
            hot_keys_arr = perm[:64]

            def hot_keys(rng, k):
                return rng.choice(hot_keys_arr, k)

            hot_on = _median_load(
                [raddr_on], hot_keys, batch=batch,
                duration_s=measure_s / 2, deadline_s=per_batch_deadline_s,
                clients=clients, seed=seed + 7)

            # ---- CC oracle identity through the router ---------------- #
            rng = np.random.default_rng(seed + 9)
            cl = RpcClient([raddr_on], seed=seed + 9)
            cc_bad = 0
            # ONE budget across the three sequential oracle batches
            #: each forward ships what remains of it
            odl = time.monotonic() + deadline_s

            def oremain() -> float:
                return max(0.5, odl - time.monotonic())

            try:
                us = rng.integers(0, n_vertices, oracle_checks)
                vs = rng.integers(0, n_vertices, oracle_checks)
                futs = cl.submit_batch(
                    [ConnectedQuery(int(a), int(b))
                     for a, b in zip(us, vs)],
                    deadline_s=oremain())
                for a, b, f in zip(us, vs, futs):
                    want = bool(olab[a] == olab[b])
                    if bool(f.result(60).value) is not want:
                        cc_bad += 1
                ks = rng.integers(0, n_vertices, oracle_checks)
                futs = cl.submit_batch(
                    [ComponentSizeQuery(int(v)) for v in ks],
                    deadline_s=oremain())
                for v, f in zip(ks, futs):
                    if int(f.result(60).value) != int(osizes[olab[v]]):
                        cc_bad += 1
                futs = cl.submit_batch(
                    [DegreeQuery(int(v)) for v in ks],
                    deadline_s=oremain())
                for v, f in zip(ks, futs):
                    if int(f.result(60).value) != int(odeg[v]):
                        cc_bad += 1
            finally:
                cl.close()
            doc["oracle"] = {
                "checked": int(3 * oracle_checks),
                "mismatches": int(cc_bad),
            }
            say(f"sharded: oracle checks {3 * oracle_checks}, "
                f"mismatches {cc_bad}")
            _teardown([rp_on])
            try:
                with open(meta_on) as f:
                    doc["router_cache_stats"] = json.load(f)
            except (OSError, ValueError):
                doc["router_cache_stats"] = None
        finally:
            _teardown(procs)

        # ---- cell 2b: two shards, EVIDENCE (event sinks everywhere:
        # same data, same partition — the traced join and the
        # kill-one-shard story, at story rates, not QPS rates). FRESH
        # serving directories: reusing 2a's would hand the new
        # replicas a dead predecessor's lease/mirror state (and the
        # standby would rightly promote over it) ----------------------- #
        c2e = os.path.join(root, "c2e")
        os.makedirs(c2e, exist_ok=True)
        procs, shard_addrs = _spawn_shard_replicas(
            c2e, 2, base_cfg=base_cfg, standby_shards=(0,),
            lease_s=lease_s, events=True, device=device)
        try:
            wm = shard_watermarks(2)
            for k in range(2):
                _wait_watermark(shard_addrs[k][0], wm[k])
            say("sharded: c2 evidence phase up (shard 0 has a standby)")
            rp_tr, raddr_tr, _mt = spawn_cell_router(
                c2e, shard_addrs, cache=False, tag="tr", events=True)

            # ---- traced batch: client -> router -> both shards -------- #
            client_sink = ShardSink(
                shard_events_path(c2e, CLIENT_SHARD),
                shard=CLIENT_SHARD)
            obs_trace.add_sink(client_sink)
            get_registry().add_sink(client_sink)
            obs_trace.enable(registry_spans=False)
            owners = vertex_owner(
                np.arange(n_vertices, dtype=np.int64), 2)
            some0 = np.where(owners == 0)[0][:batch // 2]
            some1 = np.where(owners == 1)[0][:batch // 2]
            cl = RpcClient([raddr_tr], seed=seed + 11)
            # one budget across the two traced batches
            tdl = time.monotonic() + deadline_s
            try:
                qs = [DegreeQuery(int(v))
                      for v in np.concatenate([some0, some1])]
                for f in cl.submit_batch(
                    qs, deadline_s=max(0.5, tdl - time.monotonic())
                ):
                    f.result(60)
                qs = [ConnectedQuery(int(some0[0]), int(some1[0]))]
                for f in cl.submit_batch(
                    qs, deadline_s=max(0.5, tdl - time.monotonic())
                ):
                    f.result(60)
            finally:
                cl.close()
            obs_trace.disable()
            obs_trace.remove_sink(client_sink)
            get_registry().remove_sink(client_sink)
            client_sink.close()
            client_sink = None
            joined_trace, trace_shards = _find_joined_trace(c2e)
            doc["trace"] = {
                "joined_trace": joined_trace,
                "span_shards": trace_shards,
            }
            say(f"sharded: joined trace {joined_trace} across "
                f"{trace_shards}")

            # ---- kill one shard under live per-owner traffic ---------- #
            keys0 = np.where(owners == 0)[0]
            keys1 = np.where(owners == 1)[0]
            kill_seen = [None]
            kill_records: dict = {"affected": [], "unaffected": []}
            kill_errs: list = []
            kl = threading.Lock()
            stop_kill = threading.Event()
            from .errors import DeadlineExceeded

            def kill_drive(tag: str, keys: np.ndarray, ci: int) -> None:
                rng2 = np.random.default_rng(seed + 20 + ci)
                cl2 = RpcClient([raddr_tr], seed=seed + 20 + ci)
                # each loop batch is an INDEPENDENT query with its own
                # full budget (not one budget re-spent — the rebind is
                # the declared intent)
                per_batch_s = per_batch_deadline_s
                try:
                    post = 0
                    while post < post_kill_batches and \
                            not stop_kill.is_set():
                        ks = rng2.choice(keys, batch)
                        t0 = time.perf_counter()
                        futs = cl2.submit_batch(
                            [DegreeQuery(int(v)) for v in ks],
                            deadline_s=per_batch_s)
                        fails = 0
                        for f in futs:
                            try:
                                f.result(deadline_s + 30)
                            except DeadlineExceeded:
                                fails += 1
                            except BaseException:
                                fails += 1
                        t1 = time.perf_counter()
                        with kl:
                            kill_records[tag].append((t0, t1, fails))
                        if kill_seen[0] is not None and \
                                t1 > kill_seen[0]:
                            post += 1
                        time.sleep(0.005)
                except BaseException as e:
                    # a DEAD load generator would let the zero-failure
                    # gate pass vacuously (nobody left to observe the
                    # outage): its death is the scenario's failure,
                    # same contract as run_rpc_scenario's client_errs
                    with kl:
                        kill_errs.append(f"{tag}: {e!r:.300}")
                finally:
                    cl2.close()

            threads = [
                threading.Thread(target=kill_drive,
                                 args=("affected", keys0, 0),
                                 daemon=True),
                threading.Thread(target=kill_drive,
                                 args=("unaffected", keys1, 1),
                                 daemon=True),
            ]
            for t in threads:
                t.start()
            time.sleep(kill_hold_s)  # steady traffic before the kill
            procs[0].kill()          # shard 0's PRIMARY, hard
            procs[0].wait(30)
            kill_seen[0] = time.perf_counter()
            for t in threads:
                t.join(300)
            # a load thread that never reached its post-kill quota (a stuck
            # failover) is STOPPED here and given a moment to exit;
            # aggregation below must read a quiesced copy, not a list
            # a live thread is still appending to
            stop_kill.set()
            for t in threads:
                t.join(30)
            with kl:
                kill_records = {
                    tag: list(recs)
                    for tag, recs in kill_records.items()
                }
            kill = {"primary_rc": procs[0].returncode}
            for tag in ("affected", "unaffected"):
                recs = kill_records[tag]
                fails = sum(r[2] for r in recs)
                post = [r for r in recs if kill_seen[0] is not None
                        and r[1] > kill_seen[0]]
                lats = sorted(
                    (r[1] - r[0]) * 1000.0 for r in post)
                kill[tag] = {
                    "batches": len(recs),
                    "post_kill_batches": len(post),
                    "failures": int(fails),
                    "post_kill_p99_ms": (
                        round(nearest_rank(lats, 99), 3)
                        if lats else None),
                    "post_kill_max_ms": (
                        round(lats[-1], 3) if lats else None),
                }
            # the standby's promotion evidence (shard 100+0's stream)
            sb_events = _read_jsonl(shard_events_path(c2e, 100))
            kill["promoted"] = any(
                e.get("name") == "serving.failover"
                and (e.get("labels") or {}).get("reason")
                == "lease_lapse"
                for e in sb_events
            )
            kill["driver_errors"] = list(kill_errs)
            doc["shard_kill"] = kill
            say(f"sharded: kill point — affected "
                f"failures={kill['affected']['failures']} "
                f"max={kill['affected']['post_kill_max_ms']}ms, "
                f"unaffected "
                f"failures={kill['unaffected']['failures']} "
                f"p99={kill['unaffected']['post_kill_p99_ms']}ms, "
                f"promoted={kill['promoted']}")

            _teardown([rp_tr])
        finally:
            if client_sink is not None:
                obs_trace.disable()
                obs_trace.remove_sink(client_sink)
                get_registry().remove_sink(client_sink)
                client_sink.close()
            _teardown(procs)
            _ship_events(obs_f, c2e, "c2")

        # ---- cell 3: delta-pull churn ----------------------- #
        # the same 2-shard topology under LIVE INGEST: after the main
        # stream, each shard folds `churn_bumps` paced version bumps of
        # ~churn_frac touched vertices each. Two routers ride the same
        # stream — pull protocol v2 (delta=True) vs the full-re-pull
        # baseline (delta=False) — and the committed evidence is their
        # per-refresh pulled bytes and merge-refresh time, plus a
        # post-churn oracle identity check on BOTH.
        c3 = os.path.join(root, "c3")
        os.makedirs(c3, exist_ok=True)
        # the churn cell rides a 4x-larger keyspace than the load
        # cells: the claim under test is O(changed rows) vs O(forest),
        # and a bigger forest keeps the full-rebuild baseline well
        # clear of the box's scheduling-noise floor (~1-2ms per
        # refresh under cell load), which would otherwise dominate
        # BOTH sides of the ratio and wash the gate out
        churn_nv = 4 * n_vertices
        churn_edges = max(1, int(churn_nv * churn_frac) // 2)
        churn_seed = seed + 40
        # the shards hold their churn tails on this gate file until
        # both routers are up and the load threads are issuing queries —
        # otherwise the paced bumps race the routers' process boot and
        # the delta path has nothing to refresh against
        churn_gate = os.path.join(c3, "churn.go")
        procs, shard_addrs = _spawn_shard_replicas(
            c3, 2,
            base_cfg=dict(
                base_cfg, n_vertices=churn_nv,
                churn_bumps=churn_bumps,
                churn_edges=churn_edges, churn_seed=churn_seed,
                churn_pace_s=churn_pace_s, churn_gate=churn_gate,
            ),
            lease_s=lease_s, device=device)
        try:
            src3, dst3 = demo_shard_edges(churn_nv, n_edges, seed)
            parts3 = partition_edges_by_vertex(src3, dst3, None, 2)
            wm = [len(s) for s, _d, _v in parts3]
            for k in range(2):
                _wait_watermark(shard_addrs[k][0], wm[k])
            say(f"sharded: c3 up (2 shards + {churn_bumps} churn bumps "
                f"of {churn_edges} edges)")
            rp_d, raddr_d, meta_d = spawn_cell_router(
                c3, shard_addrs, cache=False, tag="delta")
            rp_f, raddr_f, meta_f = spawn_cell_router(
                c3, shard_addrs, cache=False, tag="full", delta=False)

            # scenario-side post-churn oracle: the shards fold global
            # slice [k*churn_edges, (k+1)*churn_edges) at bump k, so
            # folding the WHOLE churn stream on top of the main fold
            # reproduces their final state exactly
            csrc, cdst = demo_shard_edges(
                churn_nv, churn_bumps * churn_edges, churn_seed)
            olab3 = fold_edges_host(
                np.arange(churn_nv, dtype=np.int32), src3, dst3)
            clab = resolve_flat_host(
                fold_edges_host(olab3, csrc, cdst))
            cparts = partition_edges_by_vertex(csrc, cdst, None, 2)
            final_wm = [wm[k] + len(cparts[k][0]) for k in range(2)]
            owners3 = vertex_owner(
                np.arange(churn_nv, dtype=np.int64), 2)
            probe = [int(np.where(owners3 == k)[0][0])
                     for k in range(2)]

            churn_errs: list = []

            def churn_drive(raddr: str, ci: int) -> None:
                # mixed load over live ingest: Connected queries hit
                # the merged forest (each version bump triggers the
                # next refresh), the Degree sprinkle carries fresh
                # per-shard version observations back to the router
                rng3 = np.random.default_rng(seed + 50 + ci)
                cl3 = RpcClient([raddr], seed=seed + 50 + ci)
                try:
                    end = (time.monotonic()
                           + churn_bumps * churn_pace_s + 4.0)
                    while time.monotonic() < end:
                        us3 = rng3.integers(0, churn_nv, batch - 2)
                        vs3 = rng3.integers(0, churn_nv, batch - 2)
                        qs3 = [ConnectedQuery(int(a), int(b))
                               for a, b in zip(us3, vs3)]
                        qs3 += [DegreeQuery(p) for p in probe]
                        for f in cl3.submit_batch(
                                qs3,
                                deadline_s=per_batch_deadline_s):
                            f.result(deadline_s + 30)
                        time.sleep(0.01)
                except BaseException as e:
                    churn_errs.append(f"r{ci}: {e!r:.300}")
                finally:
                    cl3.close()

            cthreads = [
                threading.Thread(target=churn_drive, args=(a, i),
                                 daemon=True)
                for i, a in enumerate((raddr_d, raddr_f))
            ]
            for t in cthreads:
                t.start()
            # both routers are live and under drive: release the
            # shards' churn tails
            with open(churn_gate, "w") as f:
                f.write("go")
            for t in cthreads:
                t.join(churn_bumps * churn_pace_s + 120)

            # converge each router onto the FINAL churned state, then
            # oracle-check its merged answers against the scenario's fold
            churn_bad = 0
            converged = []
            orng = np.random.default_rng(seed + 60)
            for raddr in (raddr_d, raddr_f):
                cl3 = RpcClient([raddr], seed=seed + 61)
                try:
                    cdl = time.monotonic() + deadline_s

                    def cremain() -> float:
                        return max(0.5, cdl - time.monotonic())

                    done = False
                    while time.monotonic() < cdl and not done:
                        ws = [int(cl3.ask(
                            DegreeQuery(probe[k]), timeout=30,
                            deadline_s=cremain()).watermark)
                            for k in range(2)]
                        ans = cl3.ask(
                            ConnectedQuery(probe[0], probe[1]),
                            timeout=30, deadline_s=cremain())
                        done = (
                            ws[0] >= final_wm[0]
                            and ws[1] >= final_wm[1]
                            and int(ans.watermark) >= sum(final_wm)
                        )
                        if not done:
                            time.sleep(0.05)
                    converged.append(done)
                    us3 = orng.integers(0, churn_nv, oracle_checks)
                    vs3 = orng.integers(0, churn_nv, oracle_checks)
                    futs = cl3.submit_batch(
                        [ConnectedQuery(int(a), int(b))
                         for a, b in zip(us3, vs3)],
                        deadline_s=cremain())
                    for a, b, f in zip(us3, vs3, futs):
                        want = bool(clab[a] == clab[b])
                        if bool(f.result(60).value) is not want:
                            churn_bad += 1
                finally:
                    cl3.close()
            _teardown([rp_d, rp_f])
            try:
                with open(meta_d) as f:
                    md = json.load(f)
                with open(meta_f) as f:
                    mf = json.load(f)
            except (OSError, ValueError):
                md = mf = None
            if md and mf:
                d_ref = max(1, md["merges_delta"])
                f_ref = max(1, mf["merges_full"])
                # per-refresh steady state: the delta router's boot
                # refresh is a full pull by construction and stays in
                # its *_full columns; the ratios compare what each
                # refresh COSTS once the tier is up
                d_bytes = md["pull_bytes_delta"] / d_ref
                f_bytes = mf["pull_bytes_full"] / f_ref
                d_merge = md["merge_s_delta"] / d_ref
                f_merge = mf["merge_s_full"] / f_ref
                bytes_x = f_bytes / max(d_bytes, 1.0)
                merge_x = f_merge / max(d_merge, 1e-6)
                churn_ok = (
                    not churn_errs and churn_bad == 0
                    and all(converged) and len(converged) == 2
                    and md["merges_delta"] >= 3
                    and mf["merges_full"] >= 3
                    and md["pull_malformed"] == 0
                    and mf["pull_malformed"] == 0
                    and bytes_x >= 5.0 and merge_x >= 5.0
                )
            else:
                d_bytes = f_bytes = d_merge = f_merge = None
                bytes_x = merge_x = None
                churn_ok = False
            doc["churn"] = {
                "config": dict(
                    churn_nv=churn_nv, churn_bumps=churn_bumps,
                    churn_edges=churn_edges, churn_frac=churn_frac,
                    churn_pace_s=churn_pace_s, churn_seed=churn_seed,
                ),
                "oracle_checked": int(2 * oracle_checks),
                "oracle_mismatches": int(churn_bad),
                "converged": converged,
                "driver_errors": list(churn_errs),
                "delta_router": md,
                "full_router": mf,
                "delta_bytes_per_refresh": (
                    round(d_bytes, 1) if d_bytes is not None else None),
                "full_bytes_per_refresh": (
                    round(f_bytes, 1) if f_bytes is not None else None),
                "delta_merge_s_per_refresh": (
                    round(d_merge, 6) if d_merge is not None else None),
                "full_merge_s_per_refresh": (
                    round(f_merge, 6) if f_merge is not None else None),
                "bytes_x": (
                    round(bytes_x, 1) if bytes_x is not None else None),
                "merge_x": (
                    round(merge_x, 1) if merge_x is not None else None),
                "churn_ok": churn_ok,
            }
            say(f"sharded: churn — delta {doc['churn']['delta_bytes_per_refresh']}B/refresh "
                f"vs full {doc['churn']['full_bytes_per_refresh']}B "
                f"({doc['churn']['bytes_x']}x), merge "
                f"{doc['churn']['delta_merge_s_per_refresh']}s vs "
                f"{doc['churn']['full_merge_s_per_refresh']}s "
                f"({doc['churn']['merge_x']}x), "
                f"mismatches={churn_bad}, ok={churn_ok}")
        finally:
            _teardown(procs)
            _ship_events(obs_f, c3, "c3")

        # ---- cell 4: scaling tail -------------------------------------- #
        c4 = os.path.join(root, "c4")
        os.makedirs(c4, exist_ok=True)
        procs, shard_addrs = _spawn_shard_replicas(
            c4, 4, base_cfg=base_cfg, lease_s=lease_s, device=device)
        try:
            wm = shard_watermarks(4)
            for k in range(4):
                _wait_watermark(shard_addrs[k][0], wm[k])
            rp, raddr, _m = spawn_cell_router(
                c4, shard_addrs, cache=False, tag="off")
            routed4 = _drive_load(
                [raddr], uniform_keys, batch=batch,
                duration_s=measure_s, deadline_s=per_batch_deadline_s,
                clients=clients, seed=seed + 30)
            _teardown([rp])
            scaling["s4"] = {"qps": routed4["qps"],
                             "p50_ms": routed4["p50_ms"],
                             "p99_ms": routed4["p99_ms"]}
        finally:
            _teardown(procs)
            _ship_events(obs_f, c4, "c4")

        # ---- verdict --------------------------------------------------- #
        single_zipf = doc["single_replica"]["zipf"]
        headline_x = (
            zipf_on["qps"] / single_zipf["qps"]
            if single_zipf["qps"] else None
        )
        doc["scaling"] = scaling
        doc["zipf"] = {
            "cache_off": zipf_off, "cache_on": zipf_on,
            "hot_set_cache_on": hot_on,
        }
        # the gate is CORE-AWARE, as the sharded ingest sweep's is: the
        # fan-out's aggregate-QPS scaling needs cores for its extra
        # processes (client + router + N shards). On >= 4 cores the
        # Zipfian cache-on tier must beat a single replica >= 1.6x
        # (the acceptance bar). On a 2-core host every cell
        # time-slices the same two cores, so no process layout can
        # win aggregate QPS honestly; the fallback gate is that the
        # tier's HOT-SET path (every batch short-circuited at the
        # router) holds PARITY WITHIN MEASUREMENT NOISE (>= 0.7x a
        # bare replica, median-of-3 cells — single passes on this box
        # swing tens of percent with scheduler luck) — i.e. keyspace
        # partitioning, per-shard failover, and exact cross-shard
        # merges ride along at near-zero hot-path cost — with the
        # full curve recorded as core-bound.
        cores = os.cpu_count() or 1
        core_bound = cores < 4
        hot_x = (
            hot_on["qps"] / single_zipf["qps"]
            if single_zipf["qps"] else None
        )
        if core_bound:
            headline_ok = hot_x is not None and hot_x >= 0.7
            required = "hot_set_vs_single_x >= 0.7 (core-bound parity)"
        else:
            headline_ok = headline_x is not None and headline_x >= 1.6
            required = "vs_single_x >= 1.6"
        doc["headline"] = {
            "qps": zipf_on["qps"],
            "single_replica_qps": single_zipf["qps"],
            "vs_single_x": (
                round(headline_x, 3) if headline_x else None),
            "hot_set_qps": hot_on["qps"],
            "hot_set_vs_single_x": (
                round(hot_x, 3) if hot_x else None),
            "core_bound": core_bound,
            "host_cores": cores,
            "required": required,
            "headline_ok": headline_ok,
        }
        load_cells = (
            direct_uniform, direct_zipf, routed1, routed2,
            zipf_off, zipf_on, hot_on, routed4,
        )
        # load-thread deaths count as failures: a dead load
        # generator would let every zero-failure gate pass vacuously
        # (the run_rpc_scenario client_errs contract)
        load_fail = sum(
            d["failures"] + d["deadline_expired"] + len(d["errors"])
            for d in load_cells
        )
        ok = (
            load_fail == 0
            and doc["oracle"]["mismatches"] == 0
            and headline_ok
            and zipf_on["p50_ms"] is not None
            and zipf_off["p50_ms"] is not None
            and zipf_on["p50_ms"] < zipf_off["p50_ms"]
            and doc["shard_kill"]["unaffected"]["failures"] == 0
            and doc["shard_kill"]["affected"]["failures"] == 0
            and not doc["shard_kill"]["driver_errors"]
            and doc["shard_kill"]["promoted"]
            and doc["trace"]["joined_trace"] is not None
            and doc["churn"]["churn_ok"]
        )
        doc["ok"] = ok
        doc["note"] = (
            "aggregate QPS and client-measured batch latency through "
            "the sharded routing tier on one box. scaling s1/s2/s4 is "
            "the cache-off fan-out curve — CORE-BOUND past host_cores "
            "(client + router + N shard processes time-slice the same "
            "cores; the honesty precedent is the ingest sweep's "
            "host_cores note), so on a 2-core host the curve records "
            "scheduling, not capacity, and the headline gate falls "
            "back to hot-set parity-within-noise vs a bare replica "
            "(headline.required; gate cells are median-of-3 passes). "
            "The headline compares the 2-shard "
            "tier UNDER ITS PRODUCTION CONFIG (hot-key cache, "
            "Zipfian traffic) against a single replica serving the "
            "same traffic directly; hot_set_qps is the cache's best "
            "case (64-key hot set, every batch short-circuiting the "
            "fan-out at the router). oracle: connected/size/degree "
            "answers vs a single-host fold of the whole stream. "
            "shard_kill: shard 0's primary SIGKILLed under live "
            "per-owner load; its standby promotes on lease lapse; "
            "the unaffected shard's keys see zero failures and no "
            "outage. churn: pull protocol v2 (since_version deltas) "
            "vs the full-re-pull baseline over the same live-ingest "
            "stream — per-refresh pulled bytes and router merge time "
            "must both sit >= 5x below the baseline, with post-churn "
            "oracle identity on both routers."
        )
        if not ok:
            doc["reason"] = (
                f"load_fail={load_fail}, "
                f"oracle_mismatches={doc['oracle']['mismatches']}, "
                f"headline={doc['headline']}, "
                f"cache_p50=({zipf_on['p50_ms']} vs "
                f"{zipf_off['p50_ms']}), "
                f"kill={doc['shard_kill']}, "
                f"trace={doc['trace']}, "
                f"churn={doc['churn']}"
            )
        say(f"sharded: ok={ok} scaling="
            f"{ {k: v['qps'] for k, v in scaling.items()} } "
            f"headline={zipf_on['qps']} "
            f"({doc['headline']['vs_single_x']}x single) "
            f"cache p50 {zipf_on['p50_ms']} vs {zipf_off['p50_ms']}")
        return doc
    finally:
        # per-cell teardown already ran in each cell's own finally; the
        # CALLER owns root's removal (kept for post-mortems)
        pass


def _find_joined_trace(root: str, *, exclude=None, require=None):
    """The first trace id whose spans include the client's batch root,
    the router's fan-out, and >= 2 distinct SHARD processes — the
    causal join the sharded story promises. Returns
    ``(trace_id or None, {shard: [span names]})`` for the best trace.

    ``exclude`` overrides the non-replica shard labels (the storm runs
    a router FLEET, so its routers sit on two event shards); ``require``
    names specific replica shards the join must cross (the storm's
    both-post-split-shards gate) instead of the any-two default."""
    from collections import defaultdict

    from ..obs.cluster import iter_shard_events

    if exclude is None:
        exclude = (f"p{ROUTER_SHARD}", f"p{CLIENT_SHARD}")
    excluded = set(exclude) | {"?"}
    by_trace: dict = defaultdict(list)
    for e in iter_shard_events(root):
        if e.get("kind") == "span" and e.get("trace"):
            by_trace[e["trace"]].append(e)
    best = (None, {})
    for tid in sorted(by_trace):
        spans = by_trace[tid]
        shards = defaultdict(list)
        for s in spans:
            shards[s.get("shard") or "?"].append(s["name"])
        names = {n for ns in shards.values() for n in ns}
        replica_shards = {
            sh for sh in shards if sh not in excluded
        }
        joined = (
            set(require) <= replica_shards if require is not None
            else len(replica_shards) >= 2
        )
        if (
            "rpc.client.batch" in names
            and "serving.router.fanout" in names
            and joined
        ):
            return tid, {k: sorted(set(v)) for k, v in shards.items()}
        if len(shards) > len(best[1]):
            best = (None, {k: sorted(set(v))
                           for k, v in shards.items()})
    return best


# --------------------------------------------------------------------- #
# Failover-storm scenario: router fleet + live split, one run
# --------------------------------------------------------------------- #
#: storm geometry. Smaller than SHARDED_DEFAULTS: the storm measures
#: SURVIVAL (zero client-visible failures through two kills and a live
#: split), not capacity, so the stream only needs to be big enough that
#: every phase runs under real concurrent load. ``target_wait_s`` is
#: the autotune budget — the storm's batches carry NO deadline, so the
#: admission tuners on both tiers compare queue waits against this
#: target (a kill blip breaches it, the quiet phases recover it: the
#: RETUNE lines of the timeline), while the shed floor stays far above
#: the closed-loop pending depth — tuning moves, shedding never bites.
STORM_DEFAULTS = dict(
    n_vertices=1 << 13, n_edges=1 << 14, window=2048, seed=31,
    batch=32, zipf_a=1.5, lease_s=0.4, phase_s=2.5, clients=3,
    oracle_checks=256, deadline_s=30.0, target_wait_s=0.05,
)

#: the storm's router FLEET is two processes; the first rides
#: ROUTER_SHARD, the second its own event shard (CLIENT_SHARD stays
#: the scenario process's)
STORM_ROUTER2_SHARD = 12
#: the split child's event shard IS its post-split shard index
STORM_CHILD_SHARD = 2


def _poll_events(path: str, pred, timeout_s: float) -> bool:
    """Poll one shard event file until ``pred`` matches an event (the
    cross-process evidence the storm sequences its phases on)."""
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if any(pred(e) for e in _read_jsonl(path)):
            return True
        time.sleep(0.1)
    return False


def run_storm_scenario(
    root: str,
    *,
    n_vertices: int = STORM_DEFAULTS["n_vertices"],
    n_edges: int = STORM_DEFAULTS["n_edges"],
    window: int = STORM_DEFAULTS["window"],
    seed: int = STORM_DEFAULTS["seed"],
    batch: int = STORM_DEFAULTS["batch"],
    zipf_a: float = STORM_DEFAULTS["zipf_a"],
    lease_s: float = STORM_DEFAULTS["lease_s"],
    phase_s: float = STORM_DEFAULTS["phase_s"],
    clients: int = STORM_DEFAULTS["clients"],
    oracle_checks: int = STORM_DEFAULTS["oracle_checks"],
    deadline_s: float = STORM_DEFAULTS["deadline_s"],
    target_wait_s: float = STORM_DEFAULTS["target_wait_s"],
    split_boot_timeout_s: float = 90.0,
    log: Optional[Callable[[str], None]] = None,
    obs_f=None,
    device: str = "cuda",
) -> dict:
    """The failover-storm proof: one sustained Zipfian run
    through a router FLEET over 2 shard replicas, surviving — in one
    run, under continuous multi-connection load —

    1. **KILL** — SIGKILL one router of the fleet: clients cycle to the
       survivor on their per-fleet address lists (idempotent batch ids
       make the resubmit harmless), and the survivor's hot-key cache
       rebuilds from ordinary reply frames;
    2. **PROMOTE** — SIGKILL shard 0's primary: its standby promotes on
       lease lapse, the routers fail over through shard 0's address
       list;
    3. **SPLIT** — a live split of shard 1: the scenario elects the plan
       over the fabric (one winner), a split child boots from the
       parent's snapshot mirror and publishes its address under epoch 1
       once servable, the surviving router adopts the epoch off reply-
       frame stamps and grows a third shard client mid-traffic;
    4. **RETUNE** — ``autotune=True`` on BOTH serving tiers throughout:
       the storm's blips move the admission knobs, the quiet phases
       recover them, and the gate is NO oscillation (at most one revert
       per knob per phase).

    Gates: zero client-visible failures across every phase (load-thread
    deaths count — the run_rpc_scenario client_errs contract), zero
    oracle mismatches post-split (connected/size/degree vs a single-
    host fold of the whole stream), at least one trace joining client
    -> surviving router -> BOTH post-split shards, promotion + adoption
    evidence in the shipped event streams, and the revert bound above.

    It adds a TRANSACTIONAL lane: a client thread running
    snapshot-pinned multi-read transactions (:class:`~.txn.TxnContext`)
    through every phase. Gate: zero repeated-read / oracle violations,
    at least one committed transaction spanning each of KILL, PROMOTE,
    and SPLIT, and no lane failures other than typed, counted
    :class:`~.txn.TxnSnapshotExpired` honest expiries.

    ``device`` (default ``"cuda"``) is where every shard replica's
    tables live — the two primaries, shard 0's standby and the split
    child, each with its own CUDA context; the split child uploads the
    parent's mirrored snapshots to it. The router fleet and this
    process never touch the card.
    """
    import threading

    import numpy as np

    from ..core.ingest import (
        partition_edges_by_vertex,
        vertex_owner_epoch,
    )
    from ..obs import trace as obs_trace
    from ..obs.cluster import ShardSink, shard_events_path
    from ..obs.registry import get_registry, nearest_rank
    from ..serving.client import RpcClient
    from ..serving.query import (
        ComponentSizeQuery,
        ConnectedQuery,
        DegreeQuery,
    )
    from ..serving.reshard import propose_split
    from ..serving.router import demo_shard_edges, spawn_router
    from ..serving.rpc import spawn_replica, wait_portfile
    from ..summaries.forest import fold_edges_host

    _check_replica_device(device)
    say = log or (lambda s: print(s, file=sys.stderr, flush=True))
    os.makedirs(root, exist_ok=True)
    store = os.path.join(root, "reshard")
    os.makedirs(store, exist_ok=True)
    base_cfg = dict(
        n_vertices=n_vertices, n_edges=n_edges, seed=seed,
        window=window,
    )
    # the scenario-side oracle: same generator, whole stream, one fold —
    # the split child serves the PARENT's summary, so post-split
    # answers must still match this fold exactly
    src, dst = demo_shard_edges(n_vertices, n_edges, seed)
    olab = fold_edges_host(
        np.arange(n_vertices, dtype=np.int32), src, dst)
    osizes = np.bincount(olab, minlength=n_vertices)
    odeg = (np.bincount(src, minlength=n_vertices)
            + np.bincount(dst, minlength=n_vertices))
    perm = np.random.default_rng(seed + 5).permutation(n_vertices)

    def zipf_keys(rng, k):
        return perm[(rng.zipf(zipf_a, k) - 1) % n_vertices]

    doc: dict = {
        "config": dict(
            n_vertices=n_vertices, n_edges=n_edges, window=window,
            seed=seed, batch=batch, zipf_a=zipf_a, phase_s=phase_s,
            clients=clients, lease_s=lease_s,
            target_wait_s=target_wait_s,
            host_cores=os.cpu_count(),
        ),
    }
    #: the one split of the storm: shard 1 -> (1, 2) at epoch 1
    split_plan = dict(epoch=1, parent=1, child=2, salt=seed)

    procs: list = []
    routers: list = []
    client_sink = None
    #: (name, wall ts) — the storm's phase walls, in event-stream time
    phases: list = []
    try:
        # ---- boot: 2 shard primaries (+ shard 0 standby), autotune +
        # epoch stamping everywhere, event sinks everywhere (the storm
        # IS the evidence cell) ---------------------------------------- #
        for k in range(2):
            sdir = os.path.join(root, f"s{k}")
            procs.append(spawn_replica(dict(
                dir=sdir, role="primary", lease_s=lease_s,
                run_s=900.0, shard=k, autotune=True,
                target_wait_s=target_wait_s,
                reshard=dict(store=store, shard=k),
                cc_shard=dict(base_cfg, shard=k, nshards=2),
                portfile=os.path.join(root, f"s{k}.primary.port"),
                events=shard_events_path(root, k), device=device,
            )))
        procs.append(spawn_replica(dict(
            dir=os.path.join(root, "s0"), role="standby",
            lease_s=lease_s, run_s=900.0, shard=100, autotune=True,
            target_wait_s=target_wait_s,
            portfile=os.path.join(root, "s0.standby.port"),
            events=shard_events_path(root, 100), device=device,
        )))
        shard_addrs = []
        for k in range(2):
            entry = ["127.0.0.1:%d" % wait_portfile(
                os.path.join(root, f"s{k}.primary.port"))]
            if k == 0:
                entry.append("127.0.0.1:%d" % wait_portfile(
                    os.path.join(root, "s0.standby.port")))
            shard_addrs.append(entry)
        parts = partition_edges_by_vertex(src, dst, None, 2)
        wm = [len(s) for s, _d, _v in parts]
        for k in range(2):
            _wait_watermark(shard_addrs[k][0], wm[k])
        say("storm: 2 shards up (shard 0 has a standby)")

        def spawn_fleet_router(tag: str, ev_shard: int):
            cfg = dict(
                shards=shard_addrs, cache=True, delta=True,
                autotune=True, target_wait_s=target_wait_s,
                reshard=store, run_s=900.0,
                portfile=os.path.join(root, f"router.{tag}.port"),
                meta=os.path.join(root, f"router.{tag}.meta.json"),
                events=shard_events_path(root, ev_shard),
                shard=ev_shard,
            )
            p = spawn_router(cfg)
            return p, "127.0.0.1:%d" % wait_portfile(cfg["portfile"])

        r1p, r1addr = spawn_fleet_router("a", ROUTER_SHARD)
        r2p, r2addr = spawn_fleet_router("b", STORM_ROUTER2_SHARD)
        routers = [r1p, r2p]
        fleet = [r1addr, r2addr]
        say(f"storm: router fleet up ({r1addr}, {r2addr})")

        # the scenario's own evidence stream (the split election + the
        # traced batch); tracing is enabled only around those moments
        # so the load loops below run at measurement rates
        client_sink = ShardSink(
            shard_events_path(root, CLIENT_SHARD), shard=CLIENT_SHARD)
        obs_trace.add_sink(client_sink)
        get_registry().add_sink(client_sink)

        # ---- the storm load: every phase runs under this ------------- #
        lock = threading.Lock()
        records: list = []  # (wall_t0, wall_t1, lat_ms, fails)
        errs: list = []
        stop = threading.Event()

        def storm_drive(ci: int) -> None:
            rng = np.random.default_rng(seed + 100 + ci)
            # the fleet list IS the client's address list; start_index
            # spreads the fleet so the router kill is a mid-traffic
            # failover for some clients, a no-op for the rest
            cl = RpcClient(fleet, seed=seed + 100 + ci,
                           start_index=ci)
            try:
                while not stop.is_set():
                    ks = zipf_keys(rng, batch)
                    w0 = time.time()
                    t0 = time.perf_counter()
                    # deadline-less on purpose: the admission tuners
                    # then judge queue waits against target_wait_s
                    # (see STORM_DEFAULTS), and no phase can trade a
                    # failure for a DeadlineExceeded
                    futs = cl.submit_batch(
                        [DegreeQuery(int(v)) for v in ks])
                    fails = 0
                    for f in futs:
                        try:
                            f.result(90)
                        except BaseException as e:
                            fails += 1
                            if len(errs) < 5:
                                with lock:
                                    errs.append(repr(e)[:200])
                    lat = (time.perf_counter() - t0) * 1000.0
                    with lock:
                        records.append((w0, time.time(), lat, fails))
                    time.sleep(0.002)
            except BaseException as e:
                # a DEAD load generator would let the zero-failure
                # gate pass vacuously: its death is the scenario's
                # failure (the run_rpc_scenario client_errs contract)
                with lock:
                    errs.append(f"client{ci}: {e!r:.300}")
            finally:
                cl.close()

        # ---- the transactional lane: snapshot-pinned
        # multi-read transactions riding the same storm. Each txn pins
        # a per-shard snapshot vector from its first reads, re-reads
        # the same keys, and commits only if every repeat is BYTE-
        # IDENTICAL (value, version, boot lineage) and matches the
        # single-host oracle. A TxnSnapshotExpired is an HONEST
        # failure (typed, counted, never a silently fresher answer);
        # anything else is a lane error that fails the gate ---------- #
        from ..serving.txn import TxnContext, TxnSnapshotExpired

        tlock = threading.Lock()
        txn_recs: list = []   # (wall_t0, wall_t1, committed)
        tstats = {"txns": 0, "committed": 0, "expired": 0,
                  "violations": 0, "reads": 0}
        texp_kinds: dict = {}
        terrs: list = []

        def txn_drive() -> None:
            cl = RpcClient(fleet, seed=seed + 500, start_index=1)
            rng = np.random.default_rng(seed + 500)
            try:
                while not stop.is_set():
                    w0 = time.time()
                    committed = False
                    expired = False
                    viol = 0
                    reads = 0
                    try:
                        t = TxnContext(deadline_s=90.0)
                        ks = [int(v) for v in zipf_keys(rng, 4)]
                        first = [cl.ask(DegreeQuery(k), timeout=90,
                                        txn=t) for k in ks]
                        again = [cl.ask(DegreeQuery(k), timeout=90,
                                        txn=t) for k in ks]
                        reads = len(first) + len(again)
                        for a, b in zip(first, again):
                            if (a.value, a.version, a.boot) != \
                                    (b.value, b.version, b.boot):
                                viol += 1
                        for k, a in zip(ks, first):
                            if int(a.value) != int(odeg[k]):
                                viol += 1
                        committed = True
                    except TxnSnapshotExpired as e:
                        expired = True
                        with tlock:
                            texp_kinds[e.kind] = \
                                texp_kinds.get(e.kind, 0) + 1
                    except BaseException as e:
                        with tlock:
                            if len(terrs) < 5:
                                terrs.append(repr(e)[:200])
                    with tlock:
                        tstats["txns"] += 1
                        tstats["committed"] += int(committed)
                        tstats["expired"] += int(expired)
                        tstats["violations"] += viol
                        tstats["reads"] += reads
                        txn_recs.append((w0, time.time(), committed))
                    time.sleep(0.002)
            except BaseException as e:
                # same contract as storm_drive: a dead transactional
                # lane must not let its gates pass vacuously
                with tlock:
                    terrs.append(f"txn_lane: {e!r:.300}")
            finally:
                cl.close()

        threads = [
            threading.Thread(target=storm_drive, args=(i,),
                             daemon=True)
            for i in range(clients)
        ] + [threading.Thread(target=txn_drive, daemon=True)]
        phases.append(("steady", time.time()))
        for t in threads:
            t.start()
        time.sleep(phase_s)

        # ---- phase 2: KILL one router of the fleet ------------------- #
        phases.append(("kill_router", time.time()))
        r1p.kill()
        r1p.wait(30)
        say("storm: router a SIGKILLed")
        time.sleep(phase_s)

        # ---- phase 3: KILL shard 0's primary -> PROMOTE -------------- #
        phases.append(("kill_shard", time.time()))
        procs[0].kill()
        procs[0].wait(30)
        say("storm: shard 0 primary SIGKILLed")
        promoted = _poll_events(
            shard_events_path(root, 100),
            lambda e: e.get("name") == "serving.failover"
            and (e.get("labels") or {}).get("reason") == "lease_lapse",
            timeout_s=max(phase_s, 10 * lease_s + 20.0),
        )
        say(f"storm: standby promoted={promoted}")
        time.sleep(phase_s)

        # ---- phase 4: SPLIT shard 1 live ----------------------------- #
        phases.append(("split", time.time()))
        # ONE split budget for the whole phase: the plan commit, the
        # child's snapshot restore + address publish, and the router's
        # adoption all spend from the same clock — each wait gets what
        # REMAINS, never the full original
        split_t0 = time.monotonic()

        def split_left() -> float:
            return max(1.0, split_boot_timeout_s
                       - (time.monotonic() - split_t0))

        obs_trace.enable(registry_spans=False)
        try:
            propose_split(
                store, split_plan["epoch"],
                parent=split_plan["parent"],
                child=split_plan["child"], salt=split_plan["salt"],
            )
        finally:
            obs_trace.disable()
        child_p = spawn_replica(dict(
            # the child FOLLOWS the parent's serving dir (snapshot
            # handoff + catch-up are the mirror it boots from)
            dir=os.path.join(root, "s1"), role="split",
            lease_s=lease_s, run_s=900.0, shard=STORM_CHILD_SHARD,
            autotune=True, target_wait_s=target_wait_s,
            reshard=dict(store=store, shard=STORM_CHILD_SHARD),
            split_epoch=split_plan["epoch"],
            split_boot_timeout_s=split_left(),
            portfile=os.path.join(root, "s2.split.port"),
            events=shard_events_path(root, STORM_CHILD_SHARD),
            device=device,
        ))
        procs.append(child_p)
        child_addr = "127.0.0.1:%d" % wait_portfile(
            os.path.join(root, "s2.split.port"),
            timeout_s=split_left())
        adopted = _poll_events(
            shard_events_path(root, STORM_ROUTER2_SHARD),
            lambda e: e.get("name") == "reshard.adopt"
            and (e.get("labels") or {}).get("site") == "router",
            timeout_s=split_left(),
        )
        say(f"storm: split child at {child_addr}, "
            f"router adopted={adopted}")

        # ---- phase 5: RETUNE — the tuners settle under the new
        # geometry while the load keeps running ------------------------ #
        phases.append(("retune", time.time()))
        time.sleep(phase_s)
        phases.append(("end", time.time()))
        stop.set()
        for t in threads:
            t.join(300)
        survivor_alive = r2p.poll() is None

        # ---- per-phase load accounting ------------------------------- #
        with lock:
            recs = list(records)
            errs = list(errs)
        walls = phases
        load: dict = {}
        for i, (name, t0w) in enumerate(walls[:-1]):
            t1w = walls[i + 1][1]
            in_phase = [r for r in recs if t0w <= r[1] < t1w]
            lats = sorted(r[2] for r in in_phase)
            load[name] = {
                "batches": len(in_phase),
                "failures": int(sum(r[3] for r in in_phase)),
                "p50_ms": (round(nearest_rank(lats, 50), 3)
                           if lats else None),
                "p99_ms": (round(nearest_rank(lats, 99), 3)
                           if lats else None),
            }
        total_failures = int(sum(r[3] for r in recs))
        doc["load"] = load
        wall = ((max(r[1] for r in recs) - min(r[0] for r in recs))
                if recs else 0.0)
        doc["load_total"] = {
            "batches": len(recs), "failures": total_failures,
            "driver_errors": errs,
            # client-visible throughput across the WHOLE storm — kills,
            # split, and retunes included
            "qps": (round(len(recs) * batch / wall, 1)
                    if wall > 0 else None),
            # the zero-failures contract as a 1/0 indicator (a fresh 0
            # regresses, 1 passes)
            "zero_failures": int(total_failures == 0 and not errs),
        }

        # ---- transactional-lane accounting ---------------- #
        with tlock:
            trecs = list(txn_recs)
            tstat = dict(tstats)
            texp = dict(texp_kinds)
            terr = list(terrs)
        spanning: dict = {}
        for name in ("kill_router", "kill_shard", "split"):
            i = next(i for i, (n, _t) in enumerate(walls)
                     if n == name)
            t0w, t1w = walls[i][1], walls[i + 1][1]
            # a txn SPANS the phase when its begin..commit interval
            # overlaps the phase window — only COMMITTED txns count
            # (an expired one proved honesty, not survival)
            spanning[name] = int(sum(
                1 for w0, w1, c in trecs
                if c and w0 < t1w and w1 > t0w))
        twall = ((max(r[1] for r in trecs) - min(r[0] for r in trecs))
                 if trecs else 0.0)
        # the 1/0 indicator —
        # zero repeated-read/oracle violations, no lane deaths, and at
        # least one committed txn spanning EACH chaos phase
        tzero = int(
            tstat["violations"] == 0 and not terr
            and all(v >= 1 for v in spanning.values())
        )
        doc["txn"] = {
            "txns": tstat["txns"],
            "committed": tstat["committed"],
            "expired": tstat["expired"],
            "expired_kinds": texp,
            "violations": tstat["violations"],
            "reads": tstat["reads"],
            "driver_errors": terr,
            "spanning": spanning,
            "qps": (round(tstat["reads"] / twall, 1)
                    if twall > 0 else None),
            "zero_violations": tzero,
        }
        say(f"storm: txn lane {tstat['txns']} txns "
            f"({tstat['committed']} committed, "
            f"{tstat['expired']} expired honestly), "
            f"violations={tstat['violations']}, spanning={spanning}")

        # ---- convergence + the joined trace -------------------------- #
        # both post-split shards must serve the FULL shard-1 stream
        _wait_watermark(shard_addrs[1][0], wm[1])
        _wait_watermark(child_addr, wm[1])
        owners = vertex_owner_epoch(
            np.arange(n_vertices, dtype=np.int64), 2, [split_plan])
        stay = np.where(owners == 1)[0][:batch // 2]
        moved = np.where(owners == 2)[0][:batch // 2]
        obs_trace.enable(registry_spans=False)
        cl = RpcClient([r2addr], seed=seed + 11)
        try:
            tdl = time.monotonic() + deadline_s
            for f in cl.submit_batch(
                [DegreeQuery(int(v))
                 for v in np.concatenate([stay, moved])],
                deadline_s=max(0.5, tdl - time.monotonic()),
            ):
                f.result(60)
        finally:
            cl.close()
            obs_trace.disable()
        joined_trace, trace_shards = _find_joined_trace(
            root,
            exclude=(f"p{ROUTER_SHARD}", f"p{STORM_ROUTER2_SHARD}",
                     f"p{CLIENT_SHARD}"),
            require={"p1", f"p{STORM_CHILD_SHARD}"},
        )
        doc["trace"] = {
            "joined_trace": joined_trace,
            "span_shards": trace_shards,
        }
        say(f"storm: joined trace {joined_trace} across "
            f"{trace_shards}")

        # ---- post-split oracle through the surviving router ---------- #
        rng = np.random.default_rng(seed + 9)
        cl = RpcClient([r2addr], seed=seed + 9)
        bad = 0
        odl = time.monotonic() + deadline_s

        def oremain() -> float:
            return max(0.5, odl - time.monotonic())

        try:
            us = rng.integers(0, n_vertices, oracle_checks)
            vs = rng.integers(0, n_vertices, oracle_checks)
            futs = cl.submit_batch(
                [ConnectedQuery(int(a), int(b))
                 for a, b in zip(us, vs)],
                deadline_s=oremain())
            for a, b, f in zip(us, vs, futs):
                want = bool(olab[a] == olab[b])
                if bool(f.result(60).value) is not want:
                    bad += 1
            # random keys plus BOTH halves of the split shard's
            # keyspace: the moved keys are the ones a mis-adopted
            # epoch would answer from the wrong table
            ks = np.concatenate([
                rng.integers(0, n_vertices, oracle_checks),
                stay, moved,
            ])
            futs = cl.submit_batch(
                [ComponentSizeQuery(int(v)) for v in ks],
                deadline_s=oremain())
            for v, f in zip(ks, futs):
                if int(f.result(60).value) != int(osizes[olab[v]]):
                    bad += 1
            futs = cl.submit_batch(
                [DegreeQuery(int(v)) for v in ks],
                deadline_s=oremain())
            for v, f in zip(ks, futs):
                if int(f.result(60).value) != int(odeg[v]):
                    bad += 1
        finally:
            cl.close()
        doc["oracle"] = {
            "checked": int(len(us) + 2 * len(ks)),
            "mismatches": int(bad),
        }
        say(f"storm: oracle checks {doc['oracle']['checked']}, "
            f"mismatches {bad}")

        # ---- retune timeline: moves allowed, oscillation is not ------ #
        from ..obs.cluster import iter_shard_events

        retunes: dict = {}
        for e in iter_shard_events(root):
            if e.get("name") != "control.retune":
                continue
            lab = e.get("labels") or {}
            key = (e.get("shard") or "?", lab.get("knob") or "?")
            retunes.setdefault(key, []).append(
                (e.get("ts") or 0.0, lab.get("from"), lab.get("to")))
        worst_reverts = 0
        retune_doc = []
        for (sh, knob), moves in sorted(retunes.items()):
            moves.sort()
            for i, (name, t0w) in enumerate(walls[:-1]):
                t1w = walls[i + 1][1]
                ph = [m for m in moves if t0w <= m[0] < t1w]
                # a revert is one A->B->A pair of CONSECUTIVE moves:
                # allowed once per phase (probe + settle), oscillation
                # is more
                rev = sum(
                    1 for a, b in zip(ph, ph[1:])
                    if a[1] == b[2] and a[2] == b[1]
                )
                if ph or rev:
                    retune_doc.append({
                        "shard": sh, "knob": knob, "phase": name,
                        "moves": len(ph), "reverts": rev,
                    })
                worst_reverts = max(worst_reverts, rev)
        doc["retune"] = {
            "timeline": retune_doc,
            "total_moves": int(sum(len(m) for m in retunes.values())),
            "worst_reverts_per_phase": int(worst_reverts),
        }

        # ---- evidence counts + verdict ------------------------------- #
        doc["storm"] = {
            "phases": [
                {"phase": n, "ts": t} for n, t in walls
            ],
            "promoted": bool(promoted),
            "router_killed_rc": r1p.returncode,
            "survivor_alive": bool(survivor_alive),
            "split_adopted": bool(adopted),
            "split_events": _count_events(
                shard_events_path(root, 1), "reshard.split"),
            "agree_events": _count_events(
                shard_events_path(root, CLIENT_SHARD),
                "reshard.agree"),
        }
        every_phase_loaded = all(
            load[n]["batches"] > 0 for n, _t in walls[:-1]
        )
        ok = (
            total_failures == 0
            and not errs
            and every_phase_loaded
            and promoted
            and adopted
            and survivor_alive
            and doc["storm"]["split_events"] >= 1
            and doc["oracle"]["mismatches"] == 0
            and doc["trace"]["joined_trace"] is not None
            and worst_reverts <= 1
            and doc["txn"]["zero_violations"] == 1
        )
        doc["ok"] = bool(ok)
        doc["note"] = (
            "the failover storm: one sustained Zipfian run through a "
            "2-router fleet over 2 shards, surviving a router SIGKILL "
            "(clients cycle to the survivor, idempotent batch ids "
            "make the resubmit harmless), a shard-primary SIGKILL "
            "(lease-lapse standby promotion), and a LIVE split of "
            "shard 1 (one-winner plan election, child boots from the "
            "parent's snapshot mirror, the surviving router adopts "
            "epoch 1 off reply-frame stamps and grows a third shard "
            "client mid-traffic) — with autotune on both tiers. "
            "Gates: zero client-visible failures in every phase "
            "(load-thread deaths count), zero oracle mismatches post-split "
            "vs a single-host fold, >=1 trace joining client -> "
            "surviving router -> both post-split shards, and no knob "
            "reverting more than once per phase. Batches carry no "
            "deadline so the admission tuners judge waits against "
            "target_wait_s; the shed floor sits far above the "
            "closed-loop pending depth, so knobs move but shedding "
            "never manufactures a failure. A transactional lane "
            "runs snapshot-pinned multi-read transactions "
            "through the same storm: at least one committed txn spans "
            "each of KILL, PROMOTE, and SPLIT with zero repeated-read "
            "or oracle violations — the only permitted failures are "
            "typed, counted TxnSnapshotExpired honesty."
        )
        if not ok:
            doc["reason"] = (
                f"failures={total_failures}, errs={errs}, "
                f"loaded={every_phase_loaded}, promoted={promoted}, "
                f"adopted={adopted}, survivor={survivor_alive}, "
                f"split_events={doc['storm']['split_events']}, "
                f"oracle={doc['oracle']['mismatches']}, "
                f"trace={doc['trace']['joined_trace']}, "
                f"worst_reverts={worst_reverts}, "
                f"txn={doc['txn']['zero_violations']} "
                f"(violations={doc['txn']['violations']}, "
                f"spanning={doc['txn']['spanning']}, "
                f"errs={doc['txn']['driver_errors']})"
            )
        say(f"storm: ok={ok} failures={total_failures} "
            f"promoted={promoted} adopted={adopted} "
            f"retune_moves={doc['retune']['total_moves']} "
            f"worst_reverts={worst_reverts}")
        return doc
    finally:
        if client_sink is not None:
            obs_trace.disable()
            obs_trace.remove_sink(client_sink)
            get_registry().remove_sink(client_sink)
            client_sink.close()
        _teardown(routers)
        _teardown(procs)
        _ship_events(obs_f, root, "storm")
        # the scenario's phase markers: the committed OBS timeline's
        # KILL -> PROMOTE -> SPLIT -> RETUNE walls
        _write_phase_markers(obs_f, phases)


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
# The single-process sweep: kill the CC pipeline at every window
# --------------------------------------------------------------------- #
def run_sweep(
    *,
    windows: int = DEFAULTS["windows"],
    window_edges: int = DEFAULTS["window_edges"],
    superbatch: int = DEFAULTS["superbatch"],
    every: int = DEFAULTS["every"],
    seed: int = DEFAULTS["seed"],
    corrupt: bool = True,
    workdir: Optional[str] = None,
    obs_log: Optional[str] = None,
    log: Optional[Callable[[str], None]] = None,
    device: str = "cuda",
) -> dict:
    """Kill-at-every-window sweep; returns the artifact document.

    For every ``k`` in ``1..windows``: run a worker that dies after
    ``k`` windows, then relaunch to completion, asserting the combined
    digest stream is oracle-identical and covers every window. With
    ``corrupt=True`` two kill points additionally flip-byte / truncate
    the committed barrier head between kill and resume, proving the
    fallback-to-previous-barrier path end to end (visible as
    ``ckpt_rejected`` counts in those points).

    ``obs_log`` commits the merged event evidence: every point's worker
    event stream (streamed to disk by the workers' :class:`ShardSink`,
    so pre-kill events are INCLUDED) plus flight-dump markers, one
    JSONL file, flushed point by point.

    ``device`` is where every worker's CC runs (default ``"cuda"``: each
    worker makes its own CUDA context; the sweep's process never touches
    the card).
    """
    import shutil
    import tempfile

    from ..obs.registry import nearest_rank

    say = log or (lambda s: print(s, file=sys.stderr, flush=True))
    root = workdir or tempfile.mkdtemp(prefix="chaos_")
    obs_f = open(obs_log, "w") if obs_log else None
    try:
        geometry = dict(
            windows=windows, window_edges=window_edges,
            superbatch=superbatch, every=every, seed=seed, device=device,
        )

        def cfg_for(d: str, kill_after: int) -> dict:
            return dict(
                geometry,
                ckpt=os.path.join(d, "c.ckpt"),
                digests=os.path.join(d, "digests.jsonl"),
                events=os.path.join(d, "events.jsonl"),
                meta=os.path.join(d, "meta.json"),
                flight=os.path.join(d, "flight.json"),
                kill_after=kill_after,
            )

        # -- oracle: one uninterrupted run --------------------------------- #
        oracle_dir = os.path.join(root, "oracle")
        os.makedirs(oracle_dir, exist_ok=True)
        say(f"chaos: oracle run ({windows} windows x {window_edges} edges, "
            f"superbatch={superbatch}, every={every})...")
        r = _spawn_worker(cfg_for(oracle_dir, -1))
        if r.returncode != 0:
            raise RuntimeError(
                f"chaos oracle run failed rc={r.returncode}: {r.stderr[-2000:]}"
            )
        oracle = {
            line["o"]: line["d"]
            for line in _read_jsonl(os.path.join(oracle_dir, "digests.jsonl"))
        }
        if sorted(oracle) != list(range(windows)):
            raise RuntimeError(
                f"chaos oracle covered windows {sorted(oracle)}, "
                f"expected 0..{windows - 1}"
            )
        _ship_events(obs_f, oracle_dir, "oracle")

        # two corruption points (one per mode), centered in the sweep so a
        # barrier definitely exists to corrupt
        corrupt_at = {}
        if corrupt and windows >= 2 * every + 2:
            corrupt_at[max(every + 1, windows // 3)] = "flip"
            corrupt_at[max(every + 2, (2 * windows) // 3)] = "truncate"

        points = []
        all_ok = True
        for k in range(1, windows + 1):
            d = os.path.join(root, f"kill_{k:03d}")
            os.makedirs(d, exist_ok=True)
            cfg = cfg_for(d, k)
            point = {"kill_after": k, "corrupt": corrupt_at.get(k)}
            r = _spawn_worker(cfg)
            if r.returncode != KILL_RC:
                point.update(ok=False, reason=(
                    f"kill run rc={r.returncode} (expected {KILL_RC}): "
                    f"{r.stderr[-500:]}"
                ))
                points.append(point)
                all_ok = False
                _ship_events(obs_f, d, f"kill_{k:03d}")
                continue
            mode = corrupt_at.get(k)
            if mode is not None and os.path.exists(cfg["ckpt"]):
                from .faults import corrupt_file

                corrupt_file(cfg["ckpt"], mode, seed=seed + k)
            t0 = time.perf_counter()
            # the resume run gets its OWN flight base: the recorder's
            # no-overwrite suffixing is per-process, so a dump in the fresh
            # resume process would otherwise replace the kill's black box
            r = _spawn_worker(dict(
                cfg, kill_after=-1,
                flight=os.path.join(d, "flight.resume.json"),
            ))
            resume_s = time.perf_counter() - t0
            if r.returncode != 0:
                point.update(ok=False, reason=(
                    f"resume rc={r.returncode}: {r.stderr[-500:]}"
                ))
                points.append(point)
                all_ok = False
                _ship_events(obs_f, d, f"kill_{k:03d}")
                continue
            lines = _read_jsonl(cfg["digests"])
            bad = [
                line for line in lines if oracle.get(line["o"]) != line["d"]
            ]
            covered = sorted({line["o"] for line in lines})
            with open(cfg["meta"]) as f:
                meta = json.load(f)
            from ..obs import flight as obs_flight

            point.update(
                resume_s=round(resume_s, 3),
                first_emission_s=round(meta["first_emission_s"], 4)
                if meta["first_emission_s"] is not None else None,
                resumed_from=meta["resumed_from"],
                replayed=max(0, k - meta["resumed_from"]),
                in_process_restarts=meta["restarts"],
                ckpt_rejected=_count_rejections(cfg["events"]),
                flight_dumps=[
                    os.path.basename(p) for p in obs_flight.find_dumps(d)
                ],
            )
            # the kill fired under an installed recorder, so the point's
            # black box must exist — a sweep whose crashes leave no flight
            # evidence has lost its post-mortem story
            ok = (not bad and covered == list(range(windows))
                  and len(point["flight_dumps"]) >= 1)
            if mode is not None and meta["resumed_from"] > 0:
                # a corrupted head must have been REJECTED (visible in the
                # event log), never loaded
                ok = ok and point["ckpt_rejected"] >= 1
            point["ok"] = ok
            if not ok:
                point["reason"] = (
                    f"{len(bad)} digest mismatches, covered {len(covered)}/"
                    f"{windows} windows, "
                    f"{len(point['flight_dumps'])} flight dumps"
                )
                all_ok = False
            points.append(point)
            _ship_events(obs_f, d, f"kill_{k:03d}")
            say(f"chaos: kill@{k}"
                + (f"+{mode}" if mode else "")
                + f" -> resumed_from={point.get('resumed_from')} "
                f"rejected={point.get('ckpt_rejected')} ok={ok}")

        recov = sorted(
            p["first_emission_s"] for p in points
            if p.get("ok") and p.get("first_emission_s") is not None
        )
        resumes = sorted(
            p["resume_s"] for p in points if p.get("ok") and "resume_s" in p
        )
        doc = {
            "config": geometry,
            "ok": all_ok,
            "kill_points": len(points),
            "restarts_total": sum(
                1 + p.get("in_process_restarts", 0) for p in points
            ),
            "ckpt_rejected_total": sum(
                p.get("ckpt_rejected", 0) for p in points
            ),
            "flight_dumps_total": sum(
                len(p.get("flight_dumps", ())) for p in points
            ),
            "recovery_s": {
                # supervisor-measured: worker start to first (re-)emission,
                # i.e. restore + replay, excluding interpreter boot
                "p50": nearest_rank(recov, 50),
                "p90": nearest_rank(recov, 90),
                "max": recov[-1] if recov else None,
            },
            "resume_wall_s": {
                # full relaunch wall time; dominated by interpreter + torch
                # import on this harness's tiny windows
                "p50": nearest_rank(resumes, 50),
                "max": resumes[-1] if resumes else None,
            },
            "points": points,
            "note": (
                "every kill point must replay to oracle-identical digests "
                "over full window coverage AND leave >=1 flight-recorder "
                "dump (the kill's black box); corrupt points additionally "
                "require the torn head to be rejected (ckpt_rejected >= 1) "
                "with recovery from the previous barrier"
            ),
        }
        if obs_f is not None:
            doc["obs_log"] = os.path.basename(obs_log)
            obs_f.close()
        if workdir is None:
            shutil.rmtree(root, ignore_errors=True)
        return doc
    finally:
        # the obs log handle must not outlive the sweep, even when an
        # oracle check raises mid-sweep (the kept workdir still holds
        # the per-point evidence for the post-mortem)
        if obs_f is not None:
            obs_f.close()


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
    the card; ``device`` also carries into the serving points. With
    ``failover=True`` the sweep also runs the serving-replica failover
    scenario (:func:`failover_main`) and folds its evidence in;
    ``rpc=True`` additionally runs the CROSS-PROCESS wire scenario
    (:func:`run_rpc_scenario` — kill the primary serving binary under
    live multi-connection RPC traffic, standby promoted on lease lapse,
    zero client-visible failures).

    ``obs_log`` writes the sweep's MERGED, shard-labeled event stream:
    every worker's :class:`ShardSink` stream (kills included), flight-dump
    markers, and the sweep's own coordination events under shard
    ``sweep``.
    """
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

        # -- serving replica failover point -------------------------------- #
        failover_doc = None
        if failover:
            fd = os.path.join(root, "failover")
            os.makedirs(fd, exist_ok=True)
            cfg = {
                "events": os.path.join(fd, "events.jsonl"),
                "meta": os.path.join(fd, "meta.json"),
                "flight": os.path.join(fd, "flight.json"),
                "seed": seed,
                "device": device,
            }
            say("chaos-mp: serving failover scenario...")
            r = _spawn_worker(cfg, entry="failover_main")
            if r.returncode != 0:
                failover_doc = {
                    "ok": False,
                    "reason": f"rc={r.returncode}: {r.stderr[-800:]}",
                }
                all_ok = False
            else:
                with open(cfg["meta"]) as f:
                    meta = json.load(f)
                fo_ok = (
                    meta["promoted"] and meta["reanswered"] == 2
                    and meta["expired"] == 1 and meta["post"] == 1
                    and meta["failover_events"] >= 1
                    and _count_events(cfg["events"], "serving.failover") >= 1
                    # the promotion's latency is now measured, and the dead
                    # worker left its black box
                    and meta.get("promotion_seconds_count", 0) >= 1
                    and len(meta.get("flight_dumps", ())) >= 1
                )
                failover_doc = {"ok": fo_ok, **meta}
                all_ok = all_ok and fo_ok
            _ship_events(obs_f, fd, "failover")
            say(f"chaos-mp: failover ok={failover_doc['ok']}")

        # -- cross-process RPC failover point ------------------------------ #
        rpc_doc = None
        if rpc:
            say("chaos-mp: rpc cross-process failover scenario...")
            try:
                rpc_doc = run_rpc_scenario(
                    os.path.join(root, "rpc"),
                    seed=seed, clients=2, batch=8,
                    post_kill_batches=15, kill_at_sweep=100,
                    log=say, obs_f=obs_f, device=device,
                )
            except Exception as e:
                rpc_doc = {"ok": False, "reason": f"{e!r:.800}"}
            all_ok = all_ok and rpc_doc["ok"]

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
            "failover": failover_doc,
            "rpc_failover": rpc_doc,
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
    elif len(sys.argv) >= 3 and sys.argv[1] == "worker":
        worker_main(json.loads(sys.argv[2]))
    elif "--multiprocess" in sys.argv:
        print(json.dumps(run_mp_sweep(), indent=2))
    else:
        print(json.dumps(run_sweep(), indent=2))
