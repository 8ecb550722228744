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
lease lapse, traces that cross the kill, :func:`trace_attribution`). Both
run their tables on ``device`` (default ``"cuda"``). The sharded and storm
scenarios come with ROADMAP Queue 1, slice 9b (the routing tier): they
raise ``NotImplementedError`` naming it.

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

_SLICE9B = "ROADMAP Queue 1, slice 9b (the routing tier)"


def _not_ported(what: str):
    raise NotImplementedError(f"{what} is ported in {_SLICE9B}")


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


def _kill_replica(p) -> None:
    """Last-resort teardown for a replica that ignored SIGTERM: counted
    so a wedged shutdown is visible in the scenario's event stream."""
    from ..obs.registry import get_registry

    get_registry().counter(
        "rpc.swallowed", site="scenario_teardown"
    ).inc()
    p.kill()


def run_sharded_scenario(*args, **kwargs) -> dict:
    """The sharded-serving scenario: not ported yet (raises, slice 9b)."""
    _not_ported("the sharded-serving scenario (run_sharded_scenario)")


def run_storm_scenario(*args, **kwargs) -> dict:
    """The storm scenario: not ported yet (raises, slice 9b)."""
    _not_ported("the storm scenario (run_storm_scenario)")


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
