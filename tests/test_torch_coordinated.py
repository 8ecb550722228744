"""Coordinated multi-process recovery in the port
(``resilience/coordinated.py``, ``parallel/multihost.py``'s host half,
``resilience/chaos.py``'s multi-process half) against the JAX package, on
the CPU.

Pinned here: the restore-side epoch rendezvous (the newest epoch complete
and valid across ALL shards; incomplete, torn and foreign epochs skipped;
the negative result cached until ``invalidate``), the GC that never
strands a slow peer, the file exchange's replay, the dict exchange keeping
dictionaries byte-identical, two-shard recovery on threads (fixed K and
``superbatch="auto"`` under the elected K), and the ``ClusterSupervisor``'s
restart-all, fatal classification and budget. Across the packages:
``select_epoch`` of each package on the other's cluster directory picks
the same epoch, a JAX epoch restores into a port shard, the dict exchange
of a JAX rank and a port rank keeps both dictionaries identical, and a
thread cluster of each package emits the same digests. Last, a reduced
port ``run_mp_sweep`` (two worker processes, kill and relaunch at each of
two windows) on ``device="cpu"``.

Mirrors ``tests/test_coordinated.py:61-500`` and ``:629``'s reduced sweep
(the serving failover cases at ``:522-627`` are mirrored in
``tests/test_torch_serving.py``); the in-process serving failover worker
of the sweep's failover point runs here too.
"""

import json
import os
import threading
import warnings

import numpy as np
import pytest

from gelly_streaming_tpu.resilience import coordinated as jcoord
from gelly_streaming_tpu_torch import obs
from gelly_streaming_tpu_torch.parallel.multihost import (
    FileExchangeTransport,
    dict_exchange_encode,
)
from gelly_streaming_tpu_torch.resilience import (
    ClusterError,
    ClusterSupervisor,
    CoordinatedCheckpoint,
    RestartBudgetExceeded,
    TransientSourceError,
    select_epoch,
)
from gelly_streaming_tpu_torch.resilience.chaos import digest
from gelly_streaming_tpu_torch.resilience.faults import corrupt_file

N = 2  # the "2-process" geometry all rendezvous cases use


@pytest.fixture
def registry():
    reg = obs.set_registry(None)
    yield reg
    obs.set_registry(None)


def _commit(d, epoch, pid, marker=0, pkg=None):
    """One shard's barrier + rendezvous record for ``epoch`` (synthetic
    payload; the selection protocol only reads the container bytes),
    written by the port (``pkg=None``) or the JAX package."""
    cls = CoordinatedCheckpoint if pkg is None else pkg.CoordinatedCheckpoint
    cc = cls(str(d), process_id=pid, num_processes=N, every=2)
    cc._commit({"windows_done": epoch, "kind": "workload",
                "state": {"marker": marker}, "vdict": None})


# --------------------------------------------------------------------- #
# 1. Epoch rendezvous selection
# --------------------------------------------------------------------- #
def test_select_newest_complete_epoch(tmp_path, registry):
    for e in (2, 4):
        for p in range(N):
            _commit(tmp_path, e, p)
    assert select_epoch(str(tmp_path), N) == 4
    assert registry.gauge("resilience.epoch_selected").value == 4


def test_select_skips_missing_shard_epoch(tmp_path, registry):
    for e in (2, 4):
        for p in range(N):
            _commit(tmp_path, e, p)
    _commit(tmp_path, 6, 0)  # p1 died before committing epoch 6
    assert select_epoch(str(tmp_path), N) == 4
    assert registry.counter("resilience.epoch_incomplete").value >= 1
    for p in range(N):
        cc = CoordinatedCheckpoint(str(tmp_path), process_id=p, num_processes=N, every=2)
        assert cc.windows_done() == 4
        assert cc.epoch == 4


def test_no_epoch_result_is_cached_until_invalidate(tmp_path, registry):
    cc = CoordinatedCheckpoint(str(tmp_path), process_id=0, num_processes=N, every=2)
    assert cc.windows_done() == 0
    for p in range(N):
        _commit(tmp_path, 2, p)
    assert cc.windows_done() == 0
    assert cc.epoch is None
    cc.invalidate()
    assert cc.windows_done() == 2
    assert cc.epoch == 2


def test_select_skips_torn_epoch(tmp_path, registry):
    for e in (2, 4):
        for p in range(N):
            _commit(tmp_path, e, p)
    corrupt_file(str(tmp_path / "e00000004.p1.ckpt"), "flip", seed=7)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        assert select_epoch(str(tmp_path), N) == 2
        cc0 = CoordinatedCheckpoint(str(tmp_path), process_id=0, num_processes=N, every=2)
        assert cc0.windows_done() == 2
    assert registry.counter("resilience.epoch_torn").value >= 1
    assert registry.counter("resilience.epoch_fallbacks").value >= 1
    assert registry.counter("resilience.ckpt_rejected").value >= 1


def test_select_rejects_foreign_geometry_and_ordinal(tmp_path, registry):
    for p in range(N):
        _commit(tmp_path, 2, p)
    rec_path = str(tmp_path / "e00000002.p1.json")
    with open(rec_path) as f:
        rec = json.load(f)
    rec["nprocs"] = 3
    with open(rec_path, "w") as f:
        json.dump(rec, f)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        assert select_epoch(str(tmp_path), N) is None
    rec["nprocs"] = N
    rec["windows_done"] = 4
    with open(rec_path, "w") as f:
        json.dump(rec, f)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        assert select_epoch(str(tmp_path), N) is None


def test_gc_never_strands_a_slow_peer(tmp_path, registry):
    for e in (2, 4):
        for p in range(N):
            _commit(tmp_path, e, p)
    for e in (6, 8, 10, 12):
        _commit(tmp_path, e, 0)
    assert select_epoch(str(tmp_path), N, record=False) == 4
    assert os.path.exists(tmp_path / "e00000002.p0.ckpt")
    for e in (6, 8, 10, 12):
        _commit(tmp_path, e, 1)
    for p in range(N):
        _commit(tmp_path, 14, p)
    assert select_epoch(str(tmp_path), N, record=False) == 14
    assert not os.path.exists(tmp_path / "e00000002.p0.ckpt")
    assert not os.path.exists(tmp_path / "e00000002.p1.ckpt")
    assert os.path.exists(tmp_path / "e00000010.p0.ckpt")


def test_coordinated_rejects_auto_cadence(tmp_path):
    with pytest.raises(ValueError, match="identical on every process"):
        CoordinatedCheckpoint(str(tmp_path), process_id=0, num_processes=N, every="auto")
    with pytest.raises(ValueError, match="outside"):
        CoordinatedCheckpoint(str(tmp_path), process_id=2, num_processes=N, every=2)


def test_gc_floor_ignores_torn_epochs(tmp_path, registry):
    for e in (2, 4, 6, 8, 10):
        for p in range(N):
            _commit(tmp_path, e, p)
    corrupt_file(str(tmp_path / "e00000008.p1.ckpt"), "flip", seed=1)
    corrupt_file(str(tmp_path / "e00000010.p1.ckpt"), "flip", seed=2)
    for p in range(N):
        _commit(tmp_path, 12, p)
    for p in range(N):
        assert os.path.exists(tmp_path / f"e00000006.p{p}.ckpt"), p
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        assert select_epoch(str(tmp_path), N, record=False) == 12


def test_discard_removes_only_this_process_shards(tmp_path, registry):
    for e in (2, 4):
        for p in range(N):
            _commit(tmp_path, e, p)
    cc = CoordinatedCheckpoint(str(tmp_path), process_id=1, num_processes=N, every=2)
    cc.discard()
    assert not any(n.endswith(".p1.ckpt") or n.endswith(".p1.json") for n in os.listdir(tmp_path))
    assert os.path.exists(tmp_path / "e00000004.p0.ckpt")
    assert select_epoch(str(tmp_path), N, record=False) is None


# --------------------------------------------------------------------- #
# 2. Across the packages: one cluster directory
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("writer", ["jax", "port", "mixed"])
def test_select_epoch_agrees_across_packages(tmp_path, registry, writer):
    """The rendezvous records and shard containers of either package (and
    a cluster whose shards were written by one of each) select the same
    epoch in both packages, torn epochs included."""
    def pkg_for(pid):
        if writer == "jax" or (writer == "mixed" and pid == 0):
            return jcoord
        return None

    for e in (2, 4, 6):
        for p in range(N):
            _commit(tmp_path, e, p, marker=e, pkg=pkg_for(p))
    _commit(tmp_path, 8, 0, pkg=pkg_for(0))  # incomplete
    assert select_epoch(str(tmp_path), N) == jcoord.select_epoch(str(tmp_path), N) == 6
    assert jcoord.list_epochs(str(tmp_path)) == \
        __import__("gelly_streaming_tpu_torch.resilience.coordinated",
                   fromlist=["list_epochs"]).list_epochs(str(tmp_path)) == [2, 4, 6, 8]
    corrupt_file(str(tmp_path / "e00000006.p1.ckpt"), "flip", seed=3)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        assert select_epoch(str(tmp_path), N) == jcoord.select_epoch(str(tmp_path), N) == 4
    for p in range(N):
        rec = jcoord.read_rendezvous(str(tmp_path), 4, p)
        from gelly_streaming_tpu_torch.resilience.coordinated import read_rendezvous

        assert read_rendezvous(str(tmp_path), 4, p) == rec


def test_a_jax_epoch_restores_into_a_port_shard(tmp_path, registry):
    for p in range(N):
        _commit(tmp_path, 2, p, marker=20 + p, pkg=jcoord)
    for p in range(N):
        cc = CoordinatedCheckpoint(str(tmp_path), process_id=p, num_processes=N, every=2)
        assert cc.windows_done() == 2
        assert cc._load()["state"] == {"marker": 20 + p}


# --------------------------------------------------------------------- #
# 3. File exchange: determinism, replay, timeout
# --------------------------------------------------------------------- #
def _two_ranks(fn0, fn1):
    out, errs = {}, []

    def run(i, fn):
        try:
            out[i] = fn()
        except BaseException as e:
            errs.append(e)

    ts = [threading.Thread(target=run, args=(i, f)) for i, f in enumerate((fn0, fn1))]
    for t in ts:
        t.start()
    for t in ts:
        t.join(60)
    assert not errs, errs
    return out


def test_file_exchange_allgather_and_replay(tmp_path):
    root = str(tmp_path / "x")
    a = FileExchangeTransport(root, 0, 2, timeout_s=10)
    b = FileExchangeTransport(root, 1, 2, timeout_s=10)
    out = _two_ranks(lambda: a.allgather("w00000000.ids", np.arange(4)),
                     lambda: b.allgather("w00000000.ids", np.arange(4) * 10))
    for key in (0, 1):
        assert [g.tolist() for g in out[key]] == [[0, 1, 2, 3], [0, 10, 20, 30]]
    replay = FileExchangeTransport(root, 0, 2, timeout_s=10).allgather(
        "w00000000.ids", np.arange(4) + 99)
    assert [g.tolist() for g in replay] == [[0, 1, 2, 3], [0, 10, 20, 30]]


def test_file_exchange_timeout_is_transient(tmp_path):
    tr = FileExchangeTransport(str(tmp_path), 0, 2, timeout_s=0.1)
    with pytest.raises(TransientSourceError, match="never published"):
        tr.allgather("w00000000.n", np.array([1]))


def _sparse_shards(seed=5):
    rng = np.random.default_rng(seed)
    pool = rng.integers(1 << 40, 1 << 41, size=32).astype(np.int64)
    return {p: (pool[rng.integers(0, 32, 12)], pool[rng.integers(0, 32, 12)]) for p in range(2)}


def test_dict_exchange_over_files_keeps_dicts_identical(tmp_path):
    from gelly_streaming_tpu_torch.core.vertexdict import VertexDict

    shard = _sparse_shards()
    root = str(tmp_path / "x")
    dicts = {}

    def rank(pid):
        tr = FileExchangeTransport(root, pid, 2, timeout_s=10)
        vd = VertexDict()
        src, dst = shard[pid]
        for w in range(3):
            sl = slice(w * 4, (w + 1) * 4)
            dict_exchange_encode(None, vd, src[sl], dst[sl], transport=tr, window=w)
        dicts[pid] = vd.raw_ids().tolist()

    _two_ranks(lambda: rank(0), lambda: rank(1))
    assert dicts[0] == dicts[1] and dicts[0]
    before = dicts[0]
    rank(0)
    assert dicts[0] == before


def test_dict_exchange_across_packages_keeps_dicts_identical(tmp_path):
    """A JAX rank and a port rank over one exchange directory (the JAX
    package's int32 hi/lo planes and tags): equal dictionaries, equal to
    an all-JAX exchange's, and 40-bit ids survive the planes."""
    from gelly_streaming_tpu.core.vertexdict import VertexDict as JVertexDict
    from gelly_streaming_tpu.parallel import multihost as jmh
    from gelly_streaming_tpu_torch.core.vertexdict import VertexDict

    shard = _sparse_shards(seed=8)

    def run(root, pkgs):
        dicts = {}

        def rank(pid):
            jax_side = pkgs[pid] == "jax"
            tr = (jmh.FileExchangeTransport if jax_side else FileExchangeTransport)(
                root, pid, 2, timeout_s=10)
            vd = JVertexDict() if jax_side else VertexDict()
            enc = jmh.dict_exchange_encode if jax_side else dict_exchange_encode
            src, dst = shard[pid]
            out = []
            for w in range(3):
                sl = slice(w * 4, (w + 1) * 4)
                s, d = enc(None, vd, src[sl], dst[sl], transport=tr, window=w)
                out.append((np.asarray(s).tolist(), np.asarray(d).tolist()))
            dicts[pid] = (np.asarray(vd.raw_ids()).tolist(), out)

        _two_ranks(lambda: rank(0), lambda: rank(1))
        return dicts

    mixed = run(str(tmp_path / "mixed"), ("jax", "port"))
    ref = run(str(tmp_path / "jax"), ("jax", "jax"))
    assert mixed[0][0] == mixed[1][0] == ref[0][0]
    assert min(mixed[1][0]) >= 1 << 40
    assert mixed == ref


def test_dict_exchange_without_a_transport_raises_naming_slice_6():
    from gelly_streaming_tpu_torch.core.vertexdict import VertexDict
    from gelly_streaming_tpu_torch.parallel import multihost

    with pytest.raises(NotImplementedError, match="slice 6"):
        dict_exchange_encode(None, VertexDict(), np.arange(2), np.arange(2))
    with pytest.raises(ValueError, match="window"):
        dict_exchange_encode(None, VertexDict(), np.arange(2), np.arange(2),
                             transport=FileExchangeTransport("/nonexistent-dir", 0, 1))
    for fn, args in ((multihost.initialize, ()), (multihost.is_coordinator, ()),
                     (multihost.global_edge_block, (None, [])),
                     (multihost.global_block, (None, None)),
                     (multihost.globalize_stream, (None, None))):
        with pytest.raises(NotImplementedError, match="slice 6"):
            fn(*args)


# --------------------------------------------------------------------- #
# 4. Two-shard coordinated runs with in-process crash recovery
# --------------------------------------------------------------------- #
def _shard_corpus(seed=99, windows=6, window_edges=32, nprocs=2):
    rng = np.random.default_rng(seed)
    pairs = rng.integers(0, 80, size=(windows * window_edges, 2))
    raw = [(int(a) * 5 + 1, int(b) * 5 + 1, 0.0) for a, b in pairs]
    return [raw[p::nprocs] for p in range(nprocs)]


def _run_cluster(root, shards, *, windows, lw, crash_at=None, superbatch=2, pkg="port"):
    """Drive both shards' supervised pipelines on two threads over one
    shared checkpoint/exchange directory (the port's on ``device="cpu"``,
    or the JAX package's). ``crash_at=(pid, ordinal)`` raises
    SimulatedCrash inside that shard's stream once."""
    if pkg == "port":
        from gelly_streaming_tpu_torch.core.stream import SimpleEdgeStream
        from gelly_streaming_tpu_torch.core.vertexdict import VertexDict
        from gelly_streaming_tpu_torch.core.window import CountWindow
        from gelly_streaming_tpu_torch.library import ConnectedComponents
        from gelly_streaming_tpu_torch.resilience import Supervisor
        from gelly_streaming_tpu_torch.resilience.errors import SimulatedCrash

        fx_cls, enc, cc_cls = FileExchangeTransport, dict_exchange_encode, CoordinatedCheckpoint
        stream_kw = {"device": "cpu"}
    else:
        from gelly_streaming_tpu.core.stream import SimpleEdgeStream
        from gelly_streaming_tpu.core.vertexdict import VertexDict
        from gelly_streaming_tpu.core.window import CountWindow
        from gelly_streaming_tpu.library import ConnectedComponents
        from gelly_streaming_tpu.parallel import multihost as jmh
        from gelly_streaming_tpu.resilience import Supervisor
        from gelly_streaming_tpu.resilience.errors import SimulatedCrash

        fx_cls, enc, cc_cls = jmh.FileExchangeTransport, jmh.dict_exchange_encode, \
            jcoord.CoordinatedCheckpoint
        stream_kw = {}

    results = {}
    errors = []

    def worker(pid):
        try:
            fx = fx_cls(os.path.join(root, "exchange"), pid, len(shards), timeout_s=60)
            mine = shards[pid]
            armed = {"crash": crash_at is not None and crash_at[0] == pid}

            def make_stream(vd):
                vd_eff = vd if vd is not None else VertexDict()

                def gen():
                    for w in range(windows):
                        chunk = mine[w * lw:(w + 1) * lw]
                        src = np.array([e[0] for e in chunk], np.int64)
                        dst = np.array([e[1] for e in chunk], np.int64)
                        enc(None, vd_eff, src, dst, transport=fx, window=w)
                        if armed["crash"] and w == crash_at[1]:
                            armed["crash"] = False
                            raise SimulatedCrash(f"injected at {w}")
                        yield from chunk

                return SimpleEdgeStream(gen(), window=CountWindow(lw), vertex_dict=vd_eff,
                                        **stream_kw)

            cc = cc_cls(os.path.join(root, "ckpt"), process_id=pid,
                        num_processes=len(shards), every=2, keep=3)
            sup = Supervisor(cc, backoff_base_s=0.0, jitter=0.0)
            digests = []
            o = cc.windows_done()
            for comps in sup.run(make_stream,
                                 lambda: ConnectedComponents(superbatch=superbatch)):
                digests.append((o, digest(comps)))
                o += 1
            results[pid] = {"digests": digests, "restarts": sup.restarts,
                            "resumed": cc.epoch}
        except BaseException as e:
            errors.append((pid, e))

    ts = [threading.Thread(target=worker, args=(p,)) for p in range(len(shards))]
    for t in ts:
        t.start()
    for t in ts:
        t.join(300)
    assert not errors, errors
    return results


def test_coordinated_two_shard_recovery_oracle_identical(tmp_path, registry):
    windows, lw = 6, 16
    shards = _shard_corpus(windows=windows, window_edges=2 * lw)
    oracle = _run_cluster(str(tmp_path / "oracle"), shards, windows=windows, lw=lw)
    crashed = _run_cluster(str(tmp_path / "crash"), shards, windows=windows, lw=lw,
                           crash_at=(1, 4))
    for pid in range(2):
        assert crashed[pid]["digests"] == oracle[pid]["digests"]
    assert crashed[1]["restarts"] == 1
    assert registry.counter("resilience.coord_commits").value >= 4
    assert registry.counter("resilience.restarts", kind="transient").value == 1


def test_thread_clusters_of_both_packages_emit_the_same_digests(tmp_path):
    windows, lw = 6, 16
    shards = _shard_corpus(seed=7, windows=windows, window_edges=2 * lw)
    mine = _run_cluster(str(tmp_path / "port"), shards, windows=windows, lw=lw)
    ref = _run_cluster(str(tmp_path / "jax"), shards, windows=windows, lw=lw, pkg="jax")
    for pid in range(2):
        assert mine[pid]["digests"] == ref[pid]["digests"]


def test_coordinated_superbatch_auto_kill_resume_value_identical(tmp_path, registry,
                                                                 monkeypatch):
    """Both shards run ``superbatch="auto"`` with their AutoKs wrapped in
    ElectedK by the coordinated layer; one shard crashes, restores from
    the agreed epoch, replays the PERSISTED election winners, and both
    shards' emissions equal an uninterrupted auto cluster's and the
    pinned-K oracle's. The drive loop's stopwatch is a stub."""
    import itertools

    from gelly_streaming_tpu_torch.fabric import SharedDirTransport
    from gelly_streaming_tpu_torch.summaries import groupfold

    ticks = itertools.count()
    lock = threading.Lock()

    def clock():
        with lock:
            return float(next(ticks))

    monkeypatch.setattr(groupfold, "_clock", clock)
    windows, lw = 6, 16
    shards = _shard_corpus(windows=windows, window_edges=2 * lw)
    pinned = _run_cluster(str(tmp_path / "pinned"), shards, windows=windows, lw=lw,
                          superbatch=1)
    oracle = _run_cluster(str(tmp_path / "oracle"), shards, windows=windows, lw=lw,
                          superbatch="auto")
    crashed = _run_cluster(str(tmp_path / "crash"), shards, windows=windows, lw=lw,
                           crash_at=(1, 4), superbatch="auto")
    for pid in range(2):
        assert oracle[pid]["digests"] == pinned[pid]["digests"]
        assert crashed[pid]["digests"] == oracle[pid]["digests"]
    assert crashed[1]["restarts"] == 1
    for d in ("oracle", "crash"):
        assert SharedDirTransport(str(tmp_path / d / "ckpt")).list("cadence.e"), d


# --------------------------------------------------------------------- #
# 5. ClusterSupervisor: restart-all, fatal classification, budget
# --------------------------------------------------------------------- #
def _spawn_script(tmp_path, script):
    import subprocess
    import sys

    def spawn(pid, attempt):
        return subprocess.Popen([sys.executable, "-c", script, str(pid), str(attempt),
                                 str(tmp_path)])

    return spawn


_DIE_ONCE = """
import sys
pid, attempt = int(sys.argv[1]), int(sys.argv[2])
if attempt == 0 and pid == 1:
    sys.exit(17)
"""


def test_cluster_supervisor_restarts_all_on_one_death(tmp_path, registry):
    cs = ClusterSupervisor(_spawn_script(tmp_path, _DIE_ONCE), 2, restart_codes=(17,),
                           backoff_base_s=0.0)
    res = cs.run()
    assert res["restarts"] == 1
    assert res["worker_exits"] == [(1, 17)]
    assert registry.counter("resilience.cluster_restarts", reason="kill").value == 1


def test_cluster_supervisor_unknown_rc_is_fatal(tmp_path):
    cs = ClusterSupervisor(_spawn_script(tmp_path, "import sys; sys.exit(3)"), 2,
                           restart_codes=(17,), backoff_base_s=0.0)
    with pytest.raises(ClusterError, match="rc=3"):
        cs.run()


def test_cluster_supervisor_budget(tmp_path):
    cs = ClusterSupervisor(
        _spawn_script(tmp_path, "import sys; sys.exit(17 if int(sys.argv[1]) else 0)"),
        2, restart_codes=(17,), max_restarts=2, backoff_base_s=0.0)
    with pytest.raises(RestartBudgetExceeded):
        cs.run()
    assert cs.restarts == 2


# --------------------------------------------------------------------- #
# 6. The reduced 2-process kill sweep, workers on the CPU
# --------------------------------------------------------------------- #
@pytest.mark.slow
def test_chaos_mp_kill_sweep_reduced_on_the_cpu(tmp_path):
    """Ten worker interpreters in five rounds (each imports torch, about
    3 s here): about 20 s alone, more under the suite's parallel workers,
    so the sweep runs outside tier-1, as the reference's reduced sweep
    does; the in-process worker case below covers the worker's code in
    tier-1."""
    from gelly_streaming_tpu_torch.resilience import chaos

    doc = chaos.run_mp_sweep(processes=2, windows=2, window_edges=32, corrupt=False,
                             failover=False, rpc=False, device="cpu",
                             workdir=str(tmp_path), log=lambda s: None)
    assert doc["ok"], doc["points"]
    assert doc["kill_points"] == 2
    assert doc["cluster_restarts_total"] == 2
    assert doc["config"]["device"] == "cpu"
    for p in doc["points"]:
        assert p["flight_dumps"] and p["kill_to_first_emission_s"] > 0


def test_mp_worker_main_in_process_single_shard(tmp_path):
    """``mp_worker_main`` run in this process as a one-shard cluster on
    the CPU (no kill): one digest line per window, equal to the JAX
    package's CC over the same corpus, its epochs committed, and a meta
    record naming the device and the dictionary's CRC."""
    import zlib

    from gelly_streaming_tpu.core.stream import SimpleEdgeStream as JStream
    from gelly_streaming_tpu.core.window import CountWindow as JCount
    from gelly_streaming_tpu.library import ConnectedComponents as JCC
    from gelly_streaming_tpu_torch.obs.cluster import shard_events_path
    from gelly_streaming_tpu_torch.resilience import chaos

    d = str(tmp_path)
    cfg = dict(chaos.MP_DEFAULTS, processes=1, windows=4, window_edges=32, root=d,
               process=0, victim=-1, kill_after=-1, device="cpu",
               digests=os.path.join(d, "digests.p0.jsonl"), events=shard_events_path(d, 0),
               meta=os.path.join(d, "meta.p0.json"), flight=None)
    try:
        chaos.mp_worker_main(cfg)
    finally:
        obs.reset()
    lines = chaos._read_jsonl(cfg["digests"])
    raw = chaos.corpus(cfg["seed"], 4 * 32)
    want = [chaos.digest(c) for c in JCC(superbatch=2).run(JStream(raw, window=JCount(32)))]
    assert [ln["o"] for ln in lines] == [0, 1, 2, 3]
    assert [ln["d"] for ln in lines] == want
    with open(cfg["meta"]) as f:
        meta = json.load(f)
    assert meta["device"] == "cpu" and meta["yielded"] == 4 and meta["resumed_epoch"] == 0
    # the dictionary: each window's exchange proposal (first occurrence
    # over src then dst) folded in window order
    seen = {}
    for w in range(4):
        chunk = raw[w * 32:(w + 1) * 32]
        for v in [e[0] for e in chunk] + [e[1] for e in chunk]:
            seen.setdefault(v, len(seen))
    want_crc = zlib.crc32(np.array(list(seen), np.int64).tobytes()) & 0xFFFFFFFF
    assert meta["vd_crc"] == want_crc
    assert select_epoch(os.path.join(d, "ckpt"), 1, record=False) == 4
    assert chaos._count_events(cfg["events"], "resilience.coord_commits") == 2


def test_chaos_serving_points_and_single_process_sweep_raise_naming_slice_9(tmp_path):
    """The serving points are ported (slice 9a): the sweep's failover
    worker, run in-process here, meets the sweep's own pass conditions,
    and the attribution table of an untraced directory equals the JAX
    package's. The routing tier's scenarios (slice 9b) are ported: their
    parameters are the JAX package's plus ``device``, their geometry
    constants equal the JAX package's, and without a card their default
    device raises before any replica is spawned."""
    import inspect

    import torch

    from gelly_streaming_tpu.resilience import chaos as jchaos
    from gelly_streaming_tpu_torch.resilience import DeviceUnavailable, chaos

    for name in ("run_sharded_scenario", "run_storm_scenario"):
        fn, jfn = getattr(chaos, name), getattr(jchaos, name)
        params = inspect.signature(fn).parameters
        jparams = inspect.signature(jfn).parameters
        assert list(params) == list(jparams) + ["device"]
        assert params["device"].default == "cuda"
        assert all(params[k].default == jparams[k].default for k in jparams)
        if not torch.cuda.is_available():
            with pytest.raises(DeviceUnavailable):
                fn(str(tmp_path / name))
            assert not (tmp_path / name).exists()  # nothing was spawned
    for const in ("SHARDED_DEFAULTS", "STORM_DEFAULTS", "ROUTER_SHARD",
                  "CLIENT_SHARD", "STORM_ROUTER2_SHARD", "STORM_CHILD_SHARD"):
        assert getattr(chaos, const) == getattr(jchaos, const), const
    cfg = {"events": str(tmp_path / "events.jsonl"), "meta": str(tmp_path / "meta.json"),
           "flight": str(tmp_path / "flight.json"), "seed": 4321, "device": "cpu"}
    try:
        chaos.failover_main(cfg)
    finally:
        obs.reset()
    with open(cfg["meta"]) as f:
        meta = json.load(f)
    assert meta["promoted"] and meta["reanswered"] == 2 and meta["expired"] == 1
    assert meta["post"] == 1 and meta["pre"] is True and meta["failover_events"] >= 1
    assert meta["promotion_seconds_count"] >= 1 and len(meta["flight_dumps"]) >= 1
    assert chaos._count_events(cfg["events"], "serving.failover") >= 1
    assert chaos.trace_attribution(str(tmp_path)) == jchaos.trace_attribution(str(tmp_path))
    assert chaos.ATTRIBUTION_STAGES == jchaos.ATTRIBUTION_STAGES


def test_chaos_corpus_and_digest_equal_the_jax_packages():
    from gelly_streaming_tpu.resilience import chaos as jchaos
    from gelly_streaming_tpu_torch.resilience import chaos

    assert chaos.corpus(4321, 256) == jchaos.corpus(4321, 256)
    assert chaos.MP_DEFAULTS == jchaos.MP_DEFAULTS and chaos.KILL_RC == jchaos.KILL_RC
    assert chaos.digest("x") == jchaos.digest("x")
