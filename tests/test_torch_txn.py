"""Snapshot-pinned read transactions of the port
(``gelly_streaming_tpu_torch/serving/txn.py``, ``SnapshotStore.at_version``):
the pin/expiry contract end to end.

Mirrors ``tests/test_txn.py:136-510`` case by case (the chain payloads are
torch tensors here; the router's shards hold CPU tensors). Then, across the
packages: the txn codec decodes the other package's docs alike,
``at_version`` raises the same expiry kinds for the same publish sequence,
and a pinned vector through either package's router reads alike.
"""

import json
import os
import time
import types

import numpy as np
import pytest
import torch

from gelly_streaming_tpu_torch import obs
from gelly_streaming_tpu_torch.datasets import IdentityDict
from gelly_streaming_tpu_torch.obs import timeline
from gelly_streaming_tpu_torch.obs.registry import get_registry
from gelly_streaming_tpu_torch.resilience import faults
from gelly_streaming_tpu_torch.serving import (
    ComponentSizeQuery,
    ConnectedQuery,
    DegreeQuery,
    ReplicaServer,
    RpcClient,
    RpcError,
    RpcServer,
    SnapshotStore,
    StreamServer,
    TxnContext,
    TxnSnapshotExpired,
)
from gelly_streaming_tpu_torch.serving.txn import (
    active_txn_count,
    decode_txn,
    encode_txn,
    note_txn,
)


@pytest.fixture(autouse=True)
def _obs_hygiene():
    obs.reset()
    faults.clear()
    yield
    obs.reset()
    faults.clear()


V = 32


def chain_payloads(windows=3, pace_s=0.0):
    """The replica demo stream: a zero-rooted chain growing one vertex
    per window, so ``ComponentSizeQuery(0)`` DIFFERS across versions —
    a pinned read that silently slipped to a fresher snapshot would
    change value, not just stamp."""
    vd = IdentityDict(V)
    vd.observe(V - 1)
    labels = np.arange(V, dtype=np.int32)
    for w in range(windows):
        labels = labels.copy()
        labels[: min(V, w + 2)] = 0
        yield {"labels": torch.as_tensor(labels), "vdict": vd}, w + 1
        if pace_s:
            time.sleep(pace_s)


def chain_server(windows=3, retention=64, **kw):
    srv = StreamServer(
        chain_payloads(windows=windows), None,
        store=SnapshotStore(retention=retention),
        max_pending=kw.pop("max_pending", 1024), **kw,
    ).start()
    srv.store.wait_for(windows, timeout=30)
    srv.join(30)
    return srv


def republish(srv, bump=1, grow=0):
    """Publish ``bump`` more versions on a settled server; ``grow``
    extends the zero-rooted chain so the FRESH answer value moves."""
    snap = srv.store.latest()
    payload = snap.payload
    if grow:
        labels = np.asarray(payload["labels"]).copy()
        labels[: min(V, int(np.sum(labels == 0)) + grow)] = 0
        payload = {**payload, "labels": labels}
    for i in range(bump):
        snap = srv.store.publish(
            payload, int(snap.window) + 1 + i, int(snap.watermark) + 1 + i
        )
    return snap


def counter_value(name, **labels):
    total = 0.0
    for lab, inst in get_registry().find(name):
        if all(lab.get(k) == v for k, v in labels.items()):
            total += inst.value
    return total


# --------------------------------------------------------------------- #
# Wire codec
# --------------------------------------------------------------------- #
def test_txn_codec_round_trips_and_tolerates_garbage():
    out = decode_txn(encode_txn("abc", pin=(7, "boot1")))
    assert out == {"id": "abc", "pin": (7, "boot1"), "vec": None}
    out = decode_txn(encode_txn("abc", vec={0: (3, "b0"), 1: (9, "b1")}))
    assert out["id"] == "abc" and out["pin"] is None
    assert out["vec"] == {0: (3, "b0"), 1: (9, "b1")}
    # bare id: a transaction that has not pinned anything yet
    out = decode_txn(encode_txn("abc"))
    assert out == {"id": "abc", "pin": None, "vec": None}
    # the whole codec survives a JSON round trip (what the wire does)
    doc = json.loads(json.dumps(encode_txn("x", vec={2: (5, "bb")})))
    assert decode_txn(doc)["vec"] == {2: (5, "bb")}
    # absent field is "no transaction", not an error — and not counted
    assert decode_txn(None) is None
    assert counter_value("rpc.malformed", kind="txn") == 0
    # garbage degrades to "no transaction", counted
    assert decode_txn(["not", "a", "dict"]) is None
    assert decode_txn({"id": "x", "pin": "garbage"}) is None
    assert decode_txn({"id": "x", "vec": {"0": "nope"}}) is None
    assert counter_value("rpc.malformed", kind="txn") >= 3


# --------------------------------------------------------------------- #
# SnapshotStore.at_version — the retention ring's pin contract
# --------------------------------------------------------------------- #
def test_at_version_exact_hit_and_typed_expiry_kinds():
    store = SnapshotStore(retention=4)
    vd = IdentityDict(8)
    vd.observe(7)
    payload = {"labels": np.arange(8, dtype=np.int32), "vdict": vd}
    for w in range(8):
        store.publish(payload, w, w)
    # keep = max(retention, READY_LOOKBACK) + 1 = 5: v4..v8 addressable
    assert store.ring_depth() == 5
    assert store.oldest_retained() == 4
    snap = store.at_version(6)
    assert snap.version == 6
    # the boot-qualified form matches the store's own lineage
    assert store.at_version(6, store.boot).version == 6
    with pytest.raises(TxnSnapshotExpired) as ei:
        store.at_version(2)
    assert ei.value.kind == "ring_slid"
    assert counter_value("txn.snapshot_expired", reason="ring_slid") >= 1
    with pytest.raises(TxnSnapshotExpired) as ei:
        store.at_version(99)
    assert ei.value.kind == "ahead"
    # same version NUMBER, different lineage: NOT the pinned snapshot
    with pytest.raises(TxnSnapshotExpired) as ei:
        store.at_version(6, "other-lineage")
    assert ei.value.kind == "lineage"
    assert counter_value("txn.snapshot_expired", reason="lineage") >= 1


# --------------------------------------------------------------------- #
# TxnContext pin discipline
# --------------------------------------------------------------------- #
def test_txn_context_pins_first_stamp_and_skips_unstamped():
    t = TxnContext()
    assert counter_value("txn.begin") >= 1
    assert not t.pinned and t.remaining_s() is None
    # first stamped answer from a shard pins it; later ones are ignored
    t.observe(types.SimpleNamespace(shard=0, version=5, boot="b0"))
    t.observe(types.SimpleNamespace(shard=0, version=9, boot="b0"))
    assert t.vector() == {0: (5, "b0")}
    # a v1 peer's unstamped answer and a router-merged cross-shard
    # answer (shard=-1, boot="", version=summed) pin NOTHING
    t.observe(types.SimpleNamespace(shard=-1, version=42, boot=""))
    t.observe(types.SimpleNamespace(shard=1, version=0, boot="b1"))
    assert t.vector() == {0: (5, "b0")}
    t.observe(types.SimpleNamespace(shard=1, version=3, boot="b1"))
    assert t.pin_for(1) == (3, "b1")
    assert t.wire_doc() == {
        "id": t.id, "vec": {"0": [5, "b0"], "1": [3, "b1"]},
    }
    # the deadline is ONE budget pinned at construction
    td = TxnContext(deadline_s=5.0)
    r = td.remaining_s()
    assert r is not None and 0.0 < r <= 5.0


def test_active_txn_tracker_feeds_the_health_gauge():
    base = active_txn_count()
    note_txn("txn-test-a")
    note_txn("txn-test-a")  # same id counts once
    note_txn("txn-test-b")
    assert active_txn_count() >= base + 2


# --------------------------------------------------------------------- #
# End to end over one wire server: pinned repeats, ring-slid expiry
# --------------------------------------------------------------------- #
def test_pinned_reads_repeat_identically_across_publishes():
    srv = chain_server(windows=3, retention=64)
    rpc = RpcServer(srv, shard=0).start()
    cl = RpcClient(f"127.0.0.1:{rpc.port}")
    try:
        t = TxnContext(deadline_s=60)
        first = cl.ask(ComponentSizeQuery(0), timeout=30, txn=t)
        assert int(first.value) == 4  # chain length at window 3
        assert t.vector() == {0: (3, srv.store.boot)}
        # the graph moves on: 2 fresher versions with a LONGER chain
        republish(srv, bump=2, grow=6)
        again = cl.ask(ComponentSizeQuery(0), timeout=30, txn=t)
        assert (int(again.value), again.version, again.boot) == \
            (int(first.value), first.version, first.boot)
        conn = cl.ask(ConnectedQuery(0, 3), timeout=30, txn=t)
        conn2 = cl.ask(ConnectedQuery(0, 3), timeout=30, txn=t)
        assert (conn.value, conn.version) == (conn2.value, conn2.version)
        assert counter_value("txn.pinned_reads") >= 3
        # a non-transactional read sees the fresher, larger component
        fresh = cl.ask(ComponentSizeQuery(0), timeout=30)
        assert fresh.version == 5 and int(fresh.value) == 10
    finally:
        cl.close()
        rpc.close()
        srv.close()


def test_ring_slid_pin_expires_typed_under_sustained_publish():
    srv = chain_server(windows=2, retention=3)
    rpc = RpcServer(srv, shard=0).start()
    cl = RpcClient(f"127.0.0.1:{rpc.port}")
    try:
        t = TxnContext(deadline_s=60)
        cl.ask(ComponentSizeQuery(0), timeout=30, txn=t)
        assert t.pin_for(0) == (2, srv.store.boot)
        # sustained publishing slides v2 out of the 4-deep ring
        republish(srv, bump=6)
        with pytest.raises(TxnSnapshotExpired) as ei:
            cl.ask(ComponentSizeQuery(0), timeout=30, txn=t)
        assert ei.value.kind == "ring_slid"
        assert counter_value(
            "txn.snapshot_expired", reason="ring_slid") >= 1
        # honesty both ways: the expiry did not poison fresh traffic
        fresh = cl.ask(ComponentSizeQuery(0), timeout=30)
        assert fresh.version == 8
    finally:
        cl.close()
        rpc.close()
        srv.close()


# --------------------------------------------------------------------- #
# v1 txn-unaware peer (satellite 3: the tag-stripping deployment)
# --------------------------------------------------------------------- #
class _V1Server:
    """A v1 peer: delegates serving but its submit path has NO ``txn``
    kwarg — the RpcServer ctor probe finds none and drops the pin, so
    the answer comes back stamped at whatever is freshest."""

    def __init__(self, inner):
        self._inner = inner

    def submit(self, query, *, deadline_s=None, retry_policy=None,
               ctx=None):
        return self._inner.submit(
            query, deadline_s=deadline_s, retry_policy=retry_policy,
            ctx=ctx,
        )


def test_v1_peer_without_txn_kwarg_fails_pinned_read_honestly():
    srv = chain_server(windows=3, retention=64)
    rpc = RpcServer(_V1Server(srv), shard=0).start()
    assert rpc._txn_kwarg is False
    cl = RpcClient(f"127.0.0.1:{rpc.port}")
    try:
        t = TxnContext(deadline_s=60)
        first = cl.ask(ComponentSizeQuery(0), timeout=30, txn=t)
        assert t.pin_for(0) == (first.version, first.boot)
        # the store moves on; the v1 peer answers FRESH despite the pin
        # — the client detects the stamp mismatch and fails the read,
        # it never delivers the fresher value into the transaction
        republish(srv, bump=1, grow=6)
        with pytest.raises(TxnSnapshotExpired) as ei:
            cl.ask(ComponentSizeQuery(0), timeout=30, txn=t)
        assert ei.value.kind == "unaware_peer"
        assert counter_value("txn.unaware_peer") >= 1
    finally:
        cl.close()
        rpc.close()
        srv.close()


# --------------------------------------------------------------------- #
# Restart adoption: a pin RESETS, it is never re-fed
# --------------------------------------------------------------------- #
def test_cold_restart_same_version_number_expires_pin_not_feeds_it():
    srv_a = chain_server(windows=3, retention=64)
    rpc = RpcServer(srv_a, shard=0).start()
    cl = RpcClient(f"127.0.0.1:{rpc.port}")
    srv_b = None
    try:
        t = TxnContext(deadline_s=60)
        pinned = cl.ask(ComponentSizeQuery(0), timeout=30, txn=t)
        assert t.pin_for(0) == (3, srv_a.store.boot)
        # cold restart: a FRESH store whose counter passes the same
        # numeric version under a new boot lineage
        srv_b = chain_server(windows=3, retention=64)
        assert srv_b.store.latest().version == pinned.version
        assert srv_b.store.boot != srv_a.store.boot
        rpc.server = srv_b
        # the numerically-equal version must EXPIRE the pin (lineage),
        # never satisfy it
        with pytest.raises(TxnSnapshotExpired) as ei:
            cl.ask(ComponentSizeQuery(0), timeout=30, txn=t)
        assert ei.value.kind == "lineage"
        # non-transactional reads FOLLOW the new lineage: the client's
        # monotonic floor resets on the boot change instead of calling
        # the restart a regression
        fresh = cl.ask(ComponentSizeQuery(0), timeout=30)
        assert fresh.boot == srv_b.store.boot
        assert counter_value("rpc.client_regressions") == 0
    finally:
        cl.close()
        rpc.close()
        srv_a.close()
        if srv_b is not None:
            srv_b.close()


# --------------------------------------------------------------------- #
# Satellite 1: reconnect-resubmit behind the monotonic floor
# --------------------------------------------------------------------- #
def test_resubmit_onto_staler_survivor_is_counted_and_typed():
    # two replicas of ONE lineage: the survivor trails the primary
    srv_a = chain_server(windows=2, retention=64)
    srv_b = chain_server(windows=2, retention=64)
    snap_a = srv_a.store.latest()
    srv_a.store.publish(snap_a.payload, 10, 10, version=10,
                        boot="lineage-floor")
    snap_b = srv_b.store.latest()
    srv_b.store.publish(snap_b.payload, 5, 5, version=5,
                        boot="lineage-floor")
    rpc_a = RpcServer(srv_a, shard=0).start()
    rpc_b = RpcServer(srv_b, shard=0).start()
    cl = RpcClient([f"127.0.0.1:{rpc_a.port}",
                    f"127.0.0.1:{rpc_b.port}"])
    try:
        first = cl.ask(ConnectedQuery(0, 1), timeout=30)
        assert (first.version, first.boot) == (10, "lineage-floor")
        # the primary dies; the reconnect loop resubmits onto the
        # stale survivor — v5 is BEHIND the delivered v10 floor
        rpc_a.close()
        srv_a.close()
        with pytest.raises(RpcError) as ei:
            cl.ask(ConnectedQuery(0, 1), timeout=30, deadline_s=30)
        assert "monotonic read violated" in str(ei.value)
        # counted, re-asked under fresh ids, then failed typed — the
        # stale answer was never delivered as silent time travel
        assert counter_value("rpc.client_regressions") >= 1
        assert cl.stats_snapshot()["regressions"] >= 1
    finally:
        cl.close()
        rpc_b.close()
        srv_b.close()
        srv_a.close()


# --------------------------------------------------------------------- #
# Health surface + timeline story (satellite 2)
# --------------------------------------------------------------------- #
def test_healthz_carries_the_txn_probe_block(tmp_path):
    rep = ReplicaServer(
        chain_payloads(windows=3), None,
        dirpath=str(tmp_path / "shared"), role="primary", lease_s=5.0,
    ).start()
    try:
        rep.store.wait_for(3, timeout=30)
        TxnContext()  # notes itself in the process-wide tracker
        blk = rep.health()["txn"]
        assert blk["retention"] >= 1
        assert 1 <= blk["ring_depth"] <= blk["retention"] + 1
        assert 1 <= blk["oldest_pinned"] <= 3
        assert blk["active"] >= 1
    finally:
        rep.close()


def _write_events(path, events):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        for e in events:
            f.write(json.dumps(e) + "\n")


def test_timeline_tells_the_txn_story_in_order(tmp_path):
    d = str(tmp_path)
    t0 = time.time()
    _write_events(os.path.join(d, "events.p0.jsonl"), [
        {"kind": "counter", "name": "txn.begin", "v": 1, "ts": t0 + 0.1},
        {"kind": "counter", "name": "txn.pinned_reads", "v": 4,
         "ts": t0 + 0.5},
        {"kind": "counter", "name": "txn.snapshot_expired", "v": 1,
         "labels": {"reason": "ring_slid"}, "ts": t0 + 1.0},
        {"kind": "counter", "name": "txn.failover_expired", "v": 1,
         "ts": t0 + 1.5},
    ])
    lines = timeline.render(timeline.load_run(d))
    begin = next(i for i, x in enumerate(lines) if "TXN-BEGIN" in x)
    read = next(i for i, x in enumerate(lines) if "TXN-READ" in x)
    expired = [i for i, x in enumerate(lines) if "TXN-EXPIRED" in x]
    assert len(expired) == 2
    assert begin < read < expired[0] < expired[1]


# --------------------------------------------------------------------- #
# Across the packages
# --------------------------------------------------------------------- #
def test_txn_codec_decodes_the_jax_packages_docs_alike():
    from gelly_streaming_tpu.serving import txn as jtxn

    docs = [jtxn.encode_txn("a", pin=(3, "ff")),
            jtxn.encode_txn("b", vec={0: (1, "x"), 4: (7, "y")}),
            jtxn.encode_txn("c"), {"id": 5}, "garbage", None, {"pin": [1]}]
    for doc in docs:
        assert decode_txn(json.loads(json.dumps(doc))) == \
            jtxn.decode_txn(json.loads(json.dumps(doc)))


def test_at_version_expiry_kinds_equal_the_jax_packages():
    from gelly_streaming_tpu.serving import SnapshotStore as JaxStore
    from gelly_streaming_tpu.serving import TxnSnapshotExpired as JaxExpired

    def kinds(store_cls, exc):
        store = store_cls(retention=2)
        store.boot = "b0"
        out = []
        for i in range(6):
            store.publish({"labels": np.arange(4)}, i, i)
        for version, boot in ((6, "b0"), (5, None), (4, "b0"), (2, "b0"),
                              (9, "b0"), (6, "other")):
            try:
                out.append(("hit", store.at_version(version, boot).version))
            except exc as e:
                out.append(("expired", e.kind))
        return out

    assert kinds(SnapshotStore, TxnSnapshotExpired) == kinds(JaxStore, JaxExpired)


# --------------------------------------------------------------------- #
# Through the router: a pinned VECTOR survives version advances
# --------------------------------------------------------------------- #
def _pinned_router_stack(nshards=2, retention=64, seed=9, pkg=None):
    """Shard servers of one package (the port's by default, their tables
    CPU tensors), its router, an RpcServer in front of the router and a
    client of that package. Returns ``(client, servers, close)``."""
    if pkg is None:
        import gelly_streaming_tpu_torch.serving as pkg
        from gelly_streaming_tpu_torch.serving.router import shard_demo_payloads

        payloads = lambda **kw: shard_demo_payloads(device="cpu", **kw)
    else:
        from gelly_streaming_tpu.serving.router import shard_demo_payloads as payloads
    servers, rpcs, addrs = [], [], []
    for s in range(nshards):
        srv = pkg.StreamServer(
            payloads(n_vertices=256, n_edges=1200, seed=seed, window=256,
                     shard=s, nshards=nshards),
            None, store=pkg.SnapshotStore(retention=retention),
            max_pending=1 << 12,
        ).start()
        srv.join(60)
        servers.append(srv)
        rpc = pkg.RpcServer(srv, shard=s).start()
        rpcs.append(rpc)
        addrs.append([f"127.0.0.1:{rpc.port}"])
    router = pkg.ShardRouter(addrs)
    front = pkg.RpcServer(router, epoch=lambda: router._epoch,
                          txn_narrow=False).start()
    cl = pkg.RpcClient(f"127.0.0.1:{front.port}")

    def close():
        cl.close()
        front.close()
        router.close()
        for r in rpcs:
            r.close()
        for s_ in servers:
            s_.close()

    return cl, servers, close


def test_router_pinned_vector_survives_version_advance():
    cl, servers, close = _pinned_router_stack()
    try:
        t = TxnContext(deadline_s=120)
        firsts = {}
        for v in range(8):  # vertices 0..7 cover both shards' owners
            firsts[v] = cl.ask(DegreeQuery(v), timeout=60, txn=t)
        vec = t.vector()
        assert set(vec) == {0, 1}  # both shards pinned from stamps
        # cross-shard merged reads under the SAME pinned vector
        conn1 = cl.ask(ConnectedQuery(0, 3), timeout=60, txn=t)
        size1 = cl.ask(ComponentSizeQuery(0), timeout=60, txn=t)
        assert counter_value("router.pinned_merges") >= 1
        # every shard publishes 3 fresher versions
        for srv in servers:
            republish(srv, bump=3)
        # point repeats: byte-identical (value, version, boot)
        for v, first in firsts.items():
            again = cl.ask(DegreeQuery(v), timeout=60, txn=t)
            assert (int(again.value), again.version, again.boot) == \
                (int(first.value), first.version, first.boot)
        # merged repeats: identical values at the pinned vector
        conn2 = cl.ask(ConnectedQuery(0, 3), timeout=60, txn=t)
        size2 = cl.ask(ComponentSizeQuery(0), timeout=60, txn=t)
        assert conn2.value == conn1.value
        assert int(size2.value) == int(size1.value)
        assert counter_value("router.pinned_pulls") >= 1
        # fresh traffic still observes the advance (uncached vertex:
        # the hot-key cache only serves exact pinned or fresh stamps)
        fresh = cl.ask(DegreeQuery(101), timeout=60)
        owner = int(fresh.shard)
        assert fresh.version > vec[owner][0]
        assert t.vector() == vec  # fresh reads never mutate the pin
    finally:
        close()


def test_pinned_vectors_through_either_packages_router_read_alike():
    """The same pinned transaction through each package's router stack:
    equal pinned versions per shard and equal values, before and after
    every shard publishes fresher versions."""
    import gelly_streaming_tpu.serving as jserving
    from gelly_streaming_tpu import obs as jobs

    jobs.reset()
    stacks = [(_pinned_router_stack(), ConnectedQuery, ComponentSizeQuery,
               DegreeQuery, TxnContext),
              (_pinned_router_stack(pkg=jserving), jserving.ConnectedQuery,
               jserving.ComponentSizeQuery, jserving.DegreeQuery,
               jserving.TxnContext)]
    try:
        reads = []
        for (cl, servers, _close), cq, sq, dq, txn_cls in stacks:
            t = txn_cls(deadline_s=120)
            qs = [dq(v) for v in range(8)] + [cq(0, 3), sq(0), cq(5, 200)]
            first = [cl.ask(q, timeout=60, txn=t) for q in qs]
            for srv in servers:
                republish(srv, bump=3)
            again = [cl.ask(q, timeout=60, txn=t) for q in qs]
            assert [a.value for a in again] == [a.value for a in first]
            reads.append(([a.value for a in first],
                          {k: v[0] for k, v in t.vector().items()}))
        assert reads[0] == reads[1]
    finally:
        for (_cl, _s, close), *_rest in stacks:
            close()
        jobs.reset()
