"""The port's elastic resharding (``gelly_streaming_tpu_torch/serving/
reshard.py`` and the split role of ``serving/rpc.py``), mirroring
``tests/test_reshard.py`` case by case with replicas on the CPU, then
across the packages (the last section): plans elected by either package
read alike, and replicas of both stamp equal epochs and shards.

Ownership epochs, split-plan
agreement, the actionable-prefix rule, the persisted pull ring, and a
LIVE in-process split adopted by a router under traffic.

Pinned contracts:

- ``split_side`` is deterministic and ~balanced; ``vertex_owner_epoch``
  composes splits on top of the BOOT hash and never moves a key whose
  shard did not split;
- ``propose_split`` is one-winner: concurrent/replayed proposers all
  return the persisted winner;
- a plan is actionable only with a published child address, and epochs
  form a dense prefix (a gap stops adoption);
- the persisted pull ring restores a restarted engine's delta chain
  when (and only when) it matches the boot snapshot's version; a torn
  or mismatched ring degrades to the counted full fallback;
- a live split under traffic: routers adopt the epoch off ordinary
  reply frames, fan moved keys to the child, and answers stay
  oracle-identical across the split boundary.
"""

import os
import time

import numpy as np
import pytest

from gelly_streaming_tpu_torch import obs
from gelly_streaming_tpu_torch.core.ingest import (
    split_side,
    vertex_owner,
    vertex_owner_epoch,
)
from gelly_streaming_tpu_torch.datasets import IdentityDict
from gelly_streaming_tpu_torch.obs.registry import get_registry
from gelly_streaming_tpu_torch.serving import (
    ConnectedQuery,
    ComponentSizeQuery,
    DegreeQuery,
    QueryEngine,
    RpcServer,
    ShardRouter,
    SnapshotStore,
)
from gelly_streaming_tpu_torch.serving import reshard
from gelly_streaming_tpu_torch.serving.query import (
    PULL_RING_TAG,
    PullRingMirror,
    load_pull_ring,
)
from gelly_streaming_tpu_torch.serving.router import shard_demo_payloads
from gelly_streaming_tpu_torch.summaries.forest import fold_edges_host


@pytest.fixture(autouse=True)
def _obs_hygiene():
    obs.reset()
    yield
    obs.reset()


def counter_value(name, **labels):
    total = 0.0
    for lab, inst in get_registry().find(name):
        if all(lab.get(k) == v for k, v in labels.items()):
            total += inst.value
    return total


# --------------------------------------------------------------------- #
# Ownership epochs
# --------------------------------------------------------------------- #
def test_split_side_deterministic_and_balanced():
    ids = np.arange(1 << 12, dtype=np.int64)
    a = split_side(ids, 7)
    b = split_side(ids, 7)
    assert np.array_equal(a, b)
    # a different salt is a different coin
    c = split_side(ids, 8)
    assert not np.array_equal(a, c)
    frac = a.mean()
    assert 0.45 < frac < 0.55, frac


def test_vertex_owner_epoch_only_moves_the_split_shards_keys():
    ids = np.arange(1 << 12, dtype=np.int64)
    boot = vertex_owner(ids, 3)
    sp = {"parent": 1, "child": 3, "salt": 99}
    own = vertex_owner_epoch(ids, 3, [sp])
    # epoch 0 == boot hash
    assert np.array_equal(vertex_owner_epoch(ids, 3), boot)
    # non-split shards are untouched
    assert np.array_equal(own[boot == 0], boot[boot == 0])
    assert np.array_equal(own[boot == 2], boot[boot == 2])
    # the split shard's keys go to parent or child, by the salt coin
    m = boot == 1
    side = split_side(ids[m], 99)
    assert np.array_equal(own[m], np.where(side, 3, 1))
    # splits COMPOSE: splitting the child again moves only child keys
    sp2 = {"parent": 3, "child": 4, "salt": 5}
    own2 = vertex_owner_epoch(ids, 3, [sp, sp2])
    assert np.array_equal(own2[own != 3], own[own != 3])
    assert set(np.unique(own2[own == 3])) <= {3, 4}


# --------------------------------------------------------------------- #
# Plan agreement + the actionable prefix
# --------------------------------------------------------------------- #
def test_propose_split_is_one_winner_across_replays(tmp_path):
    d = str(tmp_path)
    won = reshard.propose_split(d, 1, parent=0, child=2, salt=11)
    assert won == {"epoch": 1, "parent": 0, "child": 2, "salt": 11}
    # a second (losing / replaying) proposer gets the SAME winner
    again = reshard.propose_split(d, 1, parent=0, child=2, salt=999)
    assert again == won
    assert reshard.read_plan(d, 1) == won
    assert counter_value("reshard.agree", epoch="1") == 0  # untraced


def test_degenerate_split_plan_is_refused(tmp_path):
    with pytest.raises(ValueError):
        reshard.propose_split(str(tmp_path), 1, parent=2, child=2,
                              salt=1)


def test_actionable_prefix_requires_child_addr_and_density(tmp_path):
    d = str(tmp_path)
    assert reshard.actionable_plans(d) == []
    reshard.propose_split(d, 1, parent=0, child=2, salt=3)
    # elected but no address: NOT actionable
    assert reshard.actionable_plans(d) == []
    # epoch 2 fully actionable but epoch 1's addr missing: still []
    reshard.propose_split(d, 2, parent=1, child=3, salt=4)
    reshard.publish_addr(d, 2, "127.0.0.1:2")
    assert reshard.actionable_plans(d) == []
    reshard.publish_addr(d, 1, "127.0.0.1:1")
    plans = reshard.actionable_plans(d)
    assert [p["epoch"] for p in plans] == [1, 2]
    assert [p["addr"] for p in plans] == ["127.0.0.1:1", "127.0.0.1:2"]


def test_torn_plan_reads_as_absent_and_recorded(tmp_path):
    d = str(tmp_path)
    reshard.propose_split(d, 1, parent=0, child=2, salt=3)
    reshard.publish_addr(d, 1, "127.0.0.1:1")
    # tear the elected plan's CRC frame on disk
    path = os.path.join(d, reshard.plan_tag(1))
    with open(path, "r+b") as f:
        f.seek(-1, os.SEEK_END)
        last = f.read(1)
        f.seek(-1, os.SEEK_END)
        f.write(bytes([last[0] ^ 0xFF]))
    assert reshard.read_plan(d, 1) is None
    assert reshard.actionable_plans(d) == []
    assert counter_value("resilience.ckpt_rejected") >= 1


def test_reshard_watcher_fires_on_adopt_once_per_epoch(tmp_path):
    d = str(tmp_path)
    fired = []
    w = reshard.ReshardWatcher(d, poll_s=0.01,
                               on_adopt=lambda ps: fired.append(ps))
    try:
        assert w.epoch() == 0
        reshard.propose_split(d, 1, parent=0, child=1, salt=6)
        reshard.publish_addr(d, 1, "127.0.0.1:9")
        deadline = time.monotonic() + 10
        while w.epoch() < 1 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert w.epoch() == 1
        assert w.addrs() == ["127.0.0.1:9"]
        assert w.splits()[0]["salt"] == 6
        time.sleep(0.1)  # more polls must NOT re-fire
        assert len(fired) == 1
    finally:
        w.close()


# --------------------------------------------------------------------- #
# Persisted pull ring
# --------------------------------------------------------------------- #
def _publish_stream(store, eng, dirpath, versions=4, n=32):
    vd = IdentityDict(n)
    vd.observe(n - 1)
    store.add_listener(PullRingMirror(eng, dirpath))
    lab = np.arange(n, dtype=np.int32)
    for w in range(versions):
        lab = lab.copy()
        lab[: w + 2] = 0
        store.publish({"labels": lab, "vdict": vd}, w, w + 1)
    return lab, vd


def test_pull_ring_round_trips_a_restart_as_delta(tmp_path):
    d = str(tmp_path)
    store, eng = SnapshotStore(), QueryEngine()
    lab, vd = _publish_stream(store, eng, d)
    state = load_pull_ring(d)
    assert state["version"] == 4 and len(state["ring"]) == 3

    # "restart": fresh store + engine, boot snapshot at the SAME
    # version (the adopt_boot path), ring restored
    store2, eng2 = SnapshotStore(), QueryEngine()
    snap2 = store2.publish({"labels": lab, "vdict": vd}, -1, 4,
                           version=4)
    assert snap2.version == 4
    assert eng2.restore_chain(state, store2.epoch, 4)
    doc = eng2.summary_pull(snap2, since_version=2)
    assert doc["kind"] == "delta"
    # the same pull WITHOUT the ring pays the full fallback
    eng3 = QueryEngine()
    doc3 = eng3.summary_pull(snap2, since_version=2)
    assert doc3["kind"] == "full" and doc3["why"] == "no_chain"


def test_pull_ring_version_mismatch_degrades_counted(tmp_path):
    d = str(tmp_path)
    store, eng = SnapshotStore(), QueryEngine()
    lab, vd = _publish_stream(store, eng, d)
    state = load_pull_ring(d)
    eng2 = QueryEngine()
    # boot snapshot is OLDER than the persisted ring head: refuse
    assert not eng2.restore_chain(state, 1, 3)
    assert counter_value("serving.pullring_rejected",
                         reason="version") == 1
    assert not eng2.restore_chain({}, 1, 4)
    assert counter_value("serving.pullring_rejected",
                         reason="empty") == 1


def test_torn_pull_ring_reads_as_absent(tmp_path):
    d = str(tmp_path)
    store, eng = SnapshotStore(), QueryEngine()
    _publish_stream(store, eng, d)
    path = os.path.join(d, PULL_RING_TAG)
    with open(path, "r+b") as f:
        f.seek(-2, os.SEEK_END)
        f.write(b"\xff\xff")
    assert load_pull_ring(d) == {}
    assert counter_value("resilience.ckpt_rejected") >= 1


def test_restored_chain_extends_under_new_publishes(tmp_path):
    """After a restore, the NEXT published version diffs against the
    restored table — the ring keeps growing instead of resetting."""
    d = str(tmp_path)
    store, eng = SnapshotStore(), QueryEngine()
    lab, vd = _publish_stream(store, eng, d)
    state = load_pull_ring(d)
    store2, eng2 = SnapshotStore(), QueryEngine()
    store2.publish({"labels": lab, "vdict": vd}, -1, 4, version=4)
    assert eng2.restore_chain(state, store2.epoch, 4)
    lab2 = lab.copy()
    lab2[:10] = 0
    snap = store2.publish({"labels": lab2, "vdict": vd}, 0, 5)
    assert snap.version == 5
    doc = eng2.summary_pull(snap, since_version=4)
    assert doc["kind"] == "delta"


# --------------------------------------------------------------------- #
# The live split, end to end (in-process, real sockets)
# --------------------------------------------------------------------- #
def test_live_split_adopts_epoch_and_stays_oracle_identical(tmp_path):
    from gelly_streaming_tpu_torch.serving import ReplicaServer

    nv, ne, seed, window = 256, 1200, 13, 256
    store_dir = str(tmp_path / "reshard")
    os.makedirs(store_dir, exist_ok=True)
    reps = [
        ReplicaServer(
            shard_demo_payloads(n_vertices=nv, n_edges=ne, seed=seed,
                                window=window, shard=k, nshards=2, device="cpu"),
            None, dirpath=str(tmp_path / f"s{k}"), role="primary",
            lease_s=2.0,
            reshard={"store": store_dir, "shard": k, "poll_s": 0.02},
        ).start()
        for k in range(2)
    ]
    router = None
    child = None
    try:
        for r in reps:
            r.server.join(60)
        router = ShardRouter(
            [[f"127.0.0.1:{r.rpc.port}"] for r in reps],
            cache=False, reshard=store_dir,
        )
        # pre-split sanity + reply frames observed at epoch 0
        assert router.ask(DegreeQuery(0), timeout=60,
                          deadline_s=30) is not None
        assert router.health()["epoch"] == 0

        # the split: plan elected, child boots from shard 1's mirror,
        # address published once servable — exactly replica_main's
        # role="split" sequence
        won = reshard.propose_split(store_dir, 1, parent=1, child=2,
                                    salt=seed)
        child = ReplicaServer(
            dirpath=str(tmp_path / "s1"), role="split",
            reshard={"store": store_dir, "shard": 2, "poll_s": 0.02},
            device="cpu",
        ).start()
        assert child.store.wait_for(min_version=1, timeout=60)
        reshard.publish_addr(store_dir, 1,
                             f"127.0.0.1:{child.rpc.port}")

        # drive ordinary traffic until the router adopts off the
        # reply-frame epoch stamps
        deadline = time.monotonic() + 30
        rng = np.random.default_rng(3)
        while (router.health()["epoch"] < 1
               and time.monotonic() < deadline):
            ks = rng.integers(0, nv, 8)
            for f in [router.submit(DegreeQuery(int(v)), deadline_s=20)
                      for v in ks]:
                f.result(30)
            time.sleep(0.02)
        assert router.health()["epoch"] == 1
        assert router.health()["shards"] == 3
        assert counter_value("reshard.adopt", site="router") == 1
        # the parent replica saw its OWN split; shard 0 adopted
        assert counter_value("reshard.split", parent="1") >= 1

        # post-split oracle identity on keys from BOTH halves of the
        # split shard (and the untouched shard), all routed classes
        src, dst = _demo_edges(nv, ne, seed)
        olab = _resolve(fold_edges_host(
            np.arange(nv, dtype=np.int32), src, dst))
        osizes = np.bincount(olab, minlength=nv)[olab]
        odeg = (np.bincount(src, minlength=nv)
                + np.bincount(dst, minlength=nv))
        own = vertex_owner_epoch(
            np.arange(nv, dtype=np.int64), 2,
            [{k: won[k] for k in ("parent", "child", "salt")}])
        assert {0, 1, 2} <= set(own.tolist())  # all three serve keys
        probe = np.concatenate([
            np.where(own == s)[0][:12] for s in (0, 1, 2)])
        futs = [router.submit(DegreeQuery(int(v)), deadline_s=30)
                for v in probe]
        for v, f in zip(probe, futs):
            assert f.result(60).value == odeg[v], int(v)
        us = rng.integers(0, nv, 50)
        vs = rng.integers(0, nv, 50)
        futs = [router.submit(ConnectedQuery(int(a), int(b)),
                              deadline_s=30)
                for a, b in zip(us, vs)]
        for a, b, f in zip(us, vs, futs):
            assert bool(f.result(60).value) is bool(olab[a] == olab[b])
        futs = [router.submit(ComponentSizeQuery(int(v)),
                              deadline_s=30) for v in probe]
        for v, f in zip(probe, futs):
            assert f.result(60).value == osizes[v], int(v)
    finally:
        if router is not None:
            router.close()
        if child is not None:
            child.close()
        for r in reps:
            r.close()


def _demo_edges(nv, ne, seed):
    from gelly_streaming_tpu_torch.serving.router import demo_shard_edges

    return demo_shard_edges(nv, ne, seed)


def _resolve(lab):
    from gelly_streaming_tpu_torch.summaries.forest import resolve_flat_host

    return resolve_flat_host(lab)


def test_router_refuses_out_of_order_child_geometry(tmp_path):
    """A plan whose child index does not extend the client list is
    refused (counted), and nothing after it is adopted."""
    router = ShardRouter([["127.0.0.1:1"]], cache=False,
                         reshard=str(tmp_path))
    try:
        # child index 5 != len(clients) == 1
        reshard.propose_split(str(tmp_path), 1, parent=0, child=5,
                              salt=1)
        reshard.publish_addr(str(tmp_path), 1, "127.0.0.1:2")
        router._clients[0].epoch_observed = 1  # simulate a stamp
        router._maybe_adopt_epoch()
        assert router.health()["epoch"] == 0
        assert router.health()["shards"] == 1
        assert counter_value("router.swallowed",
                             site="reshard_geometry") == 1
    finally:
        router.close()


def test_rpc_client_start_index_spreads_a_fleet(tmp_path):
    """start_index picks the FIRST address tried — the explicit spread
    knob for router fleets (every member serves, unlike a
    primary/standby pair where implicit spreading would park clients
    on a non-serving standby)."""
    from gelly_streaming_tpu_torch.serving import RpcClient, StreamServer

    def served():
        vd = IdentityDict(8)
        vd.observe(7)
        yield {"labels": np.zeros(8, np.int32),
               "deg": np.zeros(8, np.int64), "vdict": vd}, 1

    s0 = StreamServer(served(), None).start()
    s1 = StreamServer(served(), None).start()
    s0.join(30)
    s1.join(30)
    r0, r1 = RpcServer(s0).start(), RpcServer(s1).start()
    addrs = [f"127.0.0.1:{r0.port}", f"127.0.0.1:{r1.port}"]
    try:
        cl = RpcClient(addrs, start_index=1)
        try:
            assert cl.ask(DegreeQuery(0), timeout=30,
                          deadline_s=20) is not None
        finally:
            cl.close()
        # the batch landed on the SECOND server, first try
        assert len(r1._done) == 1 and len(r0._done) == 0
    finally:
        r0.close()
        r1.close()
        s0.close()
        s1.close()


# --------------------------------------------------------------------- #
# Across the packages
# --------------------------------------------------------------------- #
def test_plans_elected_by_either_package_read_alike(tmp_path):
    """One store, two packages: the first proposer of either package
    wins for both, a plan or address written by one reads alike in the
    other, and the actionable prefix (the ownership epoch) is equal."""
    from gelly_streaming_tpu.serving import reshard as jreshard

    d = str(tmp_path)
    assert reshard.plan_tag(3) == jreshard.plan_tag(3)
    assert reshard.addr_tag(3) == jreshard.addr_tag(3)
    won = jreshard.propose_split(d, 1, parent=0, child=2, salt=11)
    assert reshard.propose_split(d, 1, parent=1, child=3, salt=5) == won
    won2 = reshard.propose_split(d, 2, parent=1, child=3, salt=2 ** 70 + 9)
    assert jreshard.propose_split(d, 2, parent=0, child=4, salt=1) == won2
    assert won2["salt"] == (2 ** 70 + 9) & (2 ** 64 - 1)
    for e in (1, 2):
        assert reshard.read_plan(d, e) == jreshard.read_plan(d, e)
    reshard.publish_addr(d, 1, "127.0.0.1:11")
    jreshard.publish_addr(d, 2, "127.0.0.1:12")
    assert reshard.read_addr(d, 2) == jreshard.read_addr(d, 2) == "127.0.0.1:12"
    plans = reshard.actionable_plans(d)
    assert plans == jreshard.actionable_plans(d)
    assert [p["epoch"] for p in plans] == [1, 2]
    seen = []
    w = reshard.ReshardWatcher(d, poll_s=0.02, on_adopt=seen.append)
    try:
        assert w.epoch() == 2 and seen == [plans]
        assert w.splits() == [{k: p[k] for k in ("epoch", "parent", "child",
                                                   "salt")} for p in plans]
        assert w.addrs() == ["127.0.0.1:11", "127.0.0.1:12"]
    finally:
        w.close()


def test_replicas_of_both_packages_stamp_equal_epochs_and_shards(tmp_path):
    """A shard primary of each package on the same seeded stream and one
    reshard store: reply frames carry no epoch before the split and
    epoch 1 after it, with the same shard stamp and answers (boot
    nonces blanked); ``health()`` reports the epoch; the parent counts
    its own split. The split child uploads its followed snapshots to
    its device (CPU tensors here), as its siblings hold theirs."""
    import json
    import socket

    import torch

    from gelly_streaming_tpu.serving import ReplicaServer as JReplica
    from gelly_streaming_tpu.serving.router import (
        shard_demo_payloads as jpayloads,
    )
    from gelly_streaming_tpu_torch.serving import ReplicaServer
    from gelly_streaming_tpu_torch.serving.rpc import (
        T_REQ,
        encode_queries,
        pack_frame,
        read_frame,
    )

    nv, ne, seed, window = 128, 600, 17, 128
    store_dir = str(tmp_path / "reshard")
    os.makedirs(store_dir, exist_ok=True)
    kw = dict(n_vertices=nv, n_edges=ne, seed=seed, window=window,
              shard=1, nshards=2)
    rs = {"store": store_dir, "shard": 1, "poll_s": 0.02}
    port_rep = ReplicaServer(shard_demo_payloads(device="cpu", **kw), None,
                             dirpath=str(tmp_path / "p1"), lease_s=2.0,
                             reshard=dict(rs)).start()
    jax_rep = JReplica(jpayloads(**kw), None, dirpath=str(tmp_path / "j1"),
                       lease_s=2.0, reshard=dict(rs)).start()
    child = None
    wire = encode_queries([DegreeQuery(v) for v in range(0, nv, 9)])

    def ask(port, qid):
        # a fresh batch id each time: a repeated one is answered from
        # the server's dedupe cache, with the frame of its first answer
        with socket.create_connection(("127.0.0.1", port), timeout=30) as s:
            s.sendall(pack_frame(T_REQ, json.dumps(
                {"id": qid, "q": wire}).encode()))
            doc = json.loads(read_frame(s)[1].decode())
        doc["answers"] = [a[:8] for a in doc["answers"]]
        return doc

    try:
        port_rep.server.join(60)
        jax_rep.server.join(60)
        before = ask(port_rep.rpc.port, "b")
        assert "epoch" not in before and before == ask(jax_rep.rpc.port, "b")
        assert {a[7] for a in before["answers"]} == {1}
        assert port_rep.health()["epoch"] == 0
        reshard.propose_split(store_dir, 1, parent=1, child=2, salt=seed)
        child = ReplicaServer(dirpath=str(tmp_path / "p1"), role="split",
                              reshard={"store": store_dir, "shard": 2},
                              device="cpu").start()
        assert child.store.wait_for(min_version=1, timeout=60)
        labels = child.store.latest().payload["labels"]
        assert isinstance(labels, torch.Tensor) and labels.device.type == "cpu"
        reshard.publish_addr(store_dir, 1, f"127.0.0.1:{child.rpc.port}")
        deadline = time.monotonic() + 20
        while time.monotonic() < deadline and not (
                port_rep.health()["epoch"] == jax_rep.health()["epoch"]
                == child.health()["epoch"] == 1):
            time.sleep(0.02)
        after = ask(port_rep.rpc.port, "a")
        assert after["epoch"] == 1 and after == ask(jax_rep.rpc.port, "a")
        assert counter_value("reshard.split", parent="1", child="2") == 1
        assert child.health()["epoch"] == 1
        assert child.ask(DegreeQuery(0), timeout=30).value == \
            port_rep.ask(DegreeQuery(0), timeout=30).value
    finally:
        if child is not None:
            child.close()
        port_rep.close()
        jax_rep.close()


# --------------------------------------------------------------------- #
# The failover storm, reduced, replicas on the CPU (slow)
# --------------------------------------------------------------------- #
@pytest.mark.slow
def test_run_storm_scenario_reduced_on_the_cpu(tmp_path):
    """``bench.py --storm --smoke``'s geometry with every shard replica
    (two primaries, shard 0's standby, the split child) on the CPU: the
    storm's own verdict, zero client-visible failures in every phase,
    the promotion, the adopted split, the post-split oracle, the
    transactional lane and the trace joining both post-split shards."""
    from gelly_streaming_tpu_torch.resilience import chaos

    doc = chaos.run_storm_scenario(
        str(tmp_path), n_vertices=1 << 11, n_edges=1 << 12, phase_s=1.2,
        clients=2, oracle_checks=64, device="cpu", log=lambda s: None)
    assert doc["ok"], doc.get("reason")
    assert all(v["failures"] == 0 and v["batches"] > 0
               for v in doc["load"].values())
    assert doc["storm"]["promoted"] and doc["storm"]["split_adopted"]
    assert doc["oracle"]["mismatches"] == 0
    assert doc["txn"]["violations"] == 0 and doc["txn"]["zero_violations"] == 1
    assert {"p1", "p2"} <= set(doc["trace"]["span_shards"])
