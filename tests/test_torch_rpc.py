"""Wire-level serving of the port (``gelly_streaming_tpu_torch/serving/
rpc.py``, ``client.py``): the RPC front end on ``StreamServer.submit`` +
cross-process heartbeat-lease failover, and the wire ACROSS the packages.

Mirrors ``tests/test_rpc.py:119-943`` case by case (the port's chain
payloads are torch tensors, so the snapshot mirror converts them to numpy),
then pins what only two packages can show:

- the frames, the query codec, the answer codec and the txn codec are
  byte-identical to the JAX package's;
- a JAX ``RpcClient`` against a port ``RpcServer``, and the reverse, give
  equal answers with equal stamps, and a trace context crosses with them;
- a snapshot mirror written by the port holds numpy only, loads in a fresh
  port process, and whether it crosses packages is recorded.
"""

import json
import os
import socket
import threading
import time

import numpy as np
import pytest
import torch

from gelly_streaming_tpu_torch import obs
from gelly_streaming_tpu_torch.datasets import IdentityDict
from gelly_streaming_tpu_torch.obs import timeline
from gelly_streaming_tpu_torch.obs.registry import get_registry
from gelly_streaming_tpu_torch.resilience import faults
from gelly_streaming_tpu_torch.resilience.errors import DeadlineExceeded
from gelly_streaming_tpu_torch.resilience.retry import RetryPolicy
from gelly_streaming_tpu_torch.serving import (
    ComponentSizeQuery,
    ConnectedQuery,
    DegreeQuery,
    FailoverServer,
    HeartbeatLease,
    Overloaded,
    ReplicaServer,
    RpcClient,
    RpcServer,
    Shed,
    SnapshotMirror,
    SnapshotStore,
    StreamServer,
    follow_snapshots,
)
from gelly_streaming_tpu_torch.serving.rpc import (
    HEADER,
    MAGIC,
    T_REQ,
    T_RESP,
    VERSION,
    Disconnect,
    MalformedFrame,
    decode_queries,
    encode_queries,
    pack_frame,
    read_frame,
)
from gelly_streaming_tpu_torch.serving.snapshot_store import (
    load_newest_snapshot,
)


@pytest.fixture(autouse=True)
def _obs_hygiene():
    obs.reset()
    faults.clear()
    yield
    obs.reset()
    faults.clear()


V = 32


def chain_payloads(windows=200, pace_s=0.002):
    """A CC label table whose zero-rooted chain grows one vertex per
    window (the replica binary's demo stream, small)."""
    vd = IdentityDict(V)
    vd.observe(V - 1)
    labels = np.arange(V, dtype=np.int32)
    for w in range(windows):
        labels = labels.copy()
        labels[: min(V, w + 2)] = 0
        # a fresh tensor per window: a published snapshot is never
        # written again
        yield {"labels": torch.as_tensor(labels), "vdict": vd}, w + 1
        if pace_s:
            time.sleep(pace_s)


def started_server(**kw):
    srv = StreamServer(chain_payloads(), None,
                       max_pending=kw.pop("max_pending", 1024), **kw)
    srv.start()
    srv.store.wait_for(1, timeout=10)
    return srv


def counter_value(name, **labels):
    reg = get_registry()
    for lab, inst in reg.find(name):
        if all(lab.get(k) == v for k, v in labels.items()):
            return inst.value
    return 0.0


# --------------------------------------------------------------------- #
# Wire format + codec
# --------------------------------------------------------------------- #
def test_frame_round_trip_over_socketpair():
    a, b = socket.socketpair()
    try:
        payload = json.dumps({"id": "x", "q": [["C", 1, 2]]}).encode()
        a.sendall(pack_frame(T_REQ, payload))
        ftype, got = read_frame(b)
        assert ftype == T_REQ and got == payload
        a.close()
        with pytest.raises(Disconnect):
            read_frame(b)
    finally:
        b.close()


def test_query_codec_round_trips_every_class():
    qs = [ConnectedQuery(3, 9), DegreeQuery(4), ComponentSizeQuery(7)]
    from gelly_streaming_tpu_torch.serving import RankQuery

    qs.append(RankQuery(5))
    assert decode_queries(encode_queries(qs)) == qs
    with pytest.raises(ValueError):
        decode_queries([["Z", 1]])
    with pytest.raises(ValueError):
        decode_queries([["C", 1]])  # wrong arity


@pytest.mark.parametrize("raw, kind", [
    (b"XXXX" + bytes(6), "magic"),
    (HEADER.pack(MAGIC, VERSION + 9, T_REQ, 0), "version"),
    (HEADER.pack(MAGIC, VERSION, T_REQ, 1 << 30), "oversized"),
    (HEADER.pack(MAGIC, VERSION, T_REQ, 64) + b"short", "truncated"),
    (HEADER.pack(MAGIC, VERSION, T_REQ, 8)[:6], "truncated"),
])
def test_malformed_byte_streams_are_classified(raw, kind):
    a, b = socket.socketpair()
    try:
        a.sendall(raw)
        a.close()  # mid-frame EOF for the short cases
        with pytest.raises(MalformedFrame) as ei:
            read_frame(b)
        assert ei.value.kind == kind
    finally:
        b.close()


# --------------------------------------------------------------------- #
# Server: fuzz + per-connection isolation
# --------------------------------------------------------------------- #
def raw_conn(rpc):
    s = socket.create_connection(("127.0.0.1", rpc.port), timeout=10)
    s.settimeout(10)
    return s


def test_malformed_frames_count_and_never_kill_the_server():
    srv = started_server()
    rpc = RpcServer(srv).start()
    client = RpcClient(rpc.address)
    try:
        # a healthy connection answering before, during, and after
        assert client.ask(ConnectedQuery(0, 1), timeout=10).value is True
        cases = [
            b"garbage garbage garbage",                      # magic
            HEADER.pack(MAGIC, VERSION, T_REQ, 1 << 29),     # oversized
            HEADER.pack(MAGIC, VERSION, T_REQ, 128) + b"x",  # truncated
            pack_frame(T_REQ, b"\xff\xfe not json"),         # request
            pack_frame(99, b""),                             # type
        ]
        for raw in cases:
            s = raw_conn(rpc)
            s.sendall(raw)
            s.shutdown(socket.SHUT_WR)  # EOF ends the short frames
            # the server answers with an error frame and/or closes; the
            # read draining to EOF proves a clean per-connection end
            try:
                while s.recv(4096):
                    pass
            except OSError:
                pass
            s.close()
        deadline = time.monotonic() + 5
        want = {"magic", "oversized", "truncated", "request", "type"}
        seen = set()
        while time.monotonic() < deadline and not want <= seen:
            seen = {
                lab.get("kind")
                for lab, inst in get_registry().find("rpc.malformed")
                if inst.value >= 1
            }
            time.sleep(0.01)
        assert want <= seen, f"malformed kinds counted: {seen}"
        # the server survived all of it
        assert client.ask(ConnectedQuery(0, 1), timeout=10).value is True
        assert srv.worker_alive()
    finally:
        client.close()
        rpc.close()
        srv.close()


def test_injected_mid_stream_disconnect_is_resubmitted(tmp_path):
    srv = started_server()
    rpc = RpcServer(srv).start()
    # the server's Wire reads frame 0 of the connection and fires the
    # plan: an injected ConnectionResetError mid-stream. The client
    # reconnects and resubmits the SAME batch id; the answer lands.
    with faults.injected(faults.FaultPlan(rpc_disconnect_at_frame=0)):
        client = RpcClient(rpc.address)
        try:
            ans = client.ask_batch(
                [ConnectedQuery(0, 1), ComponentSizeQuery(2)],
                deadline_s=30, timeout=30,
            )
            assert ans[0].value is True
        finally:
            client.close()
    assert counter_value(
        "resilience.fault_injected", site="rpc.frame") >= 1
    assert counter_value("rpc.client_resubmitted") >= 1


def test_injected_frame_truncation_counts_and_recovers():
    srv = started_server()
    rpc = RpcServer(srv).start()
    # frame send ordinal 0 is the client's REQ: half the frame goes out
    # and the socket dies. The SERVER must classify it as a counted
    # truncated frame (never a handler death); the client reconnects
    # and the resubmit answers.
    with faults.injected(faults.FaultPlan(rpc_truncate_at_frame=0)):
        client = RpcClient(rpc.address)
        try:
            ans = client.ask(ConnectedQuery(0, 1),
                             deadline_s=30, timeout=30)
            assert ans.value is True
        finally:
            client.close()
    deadline = time.monotonic() + 5
    while time.monotonic() < deadline and not counter_value(
            "rpc.malformed", kind="truncated"):
        time.sleep(0.01)
    assert counter_value("rpc.malformed", kind="truncated") >= 1
    assert counter_value("resilience.fault_injected",
                         site="rpc.send") >= 1
    rpc.close()
    srv.close()


# --------------------------------------------------------------------- #
# Semantics over the wire
# --------------------------------------------------------------------- #
def test_round_trip_matches_local_answers():
    srv = started_server()
    rpc = RpcServer(srv).start()
    client = RpcClient(rpc.address)
    try:
        wire = client.ask_batch(
            [ConnectedQuery(0, 1), ComponentSizeQuery(0),
             ConnectedQuery(30, 31)],
            deadline_s=20, timeout=20,
        )
        assert wire[0].value is True
        assert int(wire[1].value) >= 2
        assert wire[2].value is False or wire[2].value is True
        # staleness/window stamps travel
        assert wire[0].window >= 0 and wire[0].staleness >= 0
        # a query class the payload cannot serve is a TERMINAL error
        from gelly_streaming_tpu_torch.serving import RpcError

        with pytest.raises(RpcError):
            client.ask(DegreeQuery(1), timeout=20)
    finally:
        client.close()
        rpc.close()
        srv.close()


def test_overloaded_is_retryable_and_budget_bounded():
    # an UNSTARTED server admits but never answers: the second query of
    # the batch trips admission, the whole batch reports overloaded,
    # and the client's RetryPolicy paces bounded re-asks before failing
    srv = StreamServer(iter(()), None, max_pending=1)
    rpc = RpcServer(srv).start()
    client = RpcClient(
        rpc.address,
        retry_policy=RetryPolicy(attempts=2, base_s=0.01, jitter=0.0),
    )
    try:
        futs = client.submit_batch(
            [ConnectedQuery(0, 1), ConnectedQuery(1, 2)]
        )
        with pytest.raises(Overloaded):
            futs[0].result(20)
        with pytest.raises(Overloaded):
            futs[1].result(20)
        assert counter_value("rpc.client_retries") == 2
    finally:
        client.close()
        rpc.close()


def test_shed_is_terminal_and_never_retried():
    srv = StreamServer(
        iter(()), None, max_pending=2,
        shed_classes=(ConnectedQuery,), shed_watermark=0.5,
        shed_after_s=0.0,
    )
    rpc = RpcServer(srv).start()
    client = RpcClient(rpc.address)
    try:
        futs = client.submit_batch(
            [ConnectedQuery(0, 1), ConnectedQuery(1, 2)]
        )
        with pytest.raises(Shed):
            futs[1].result(20)
        assert counter_value("rpc.client_retries") == 0
    finally:
        client.close()
        rpc.close()


def test_deadline_expires_cleanly_without_a_live_server():
    srv = StreamServer(iter(()), None, max_pending=64)  # never started
    rpc = RpcServer(srv).start()
    client = RpcClient(rpc.address)
    try:
        t0 = time.monotonic()
        futs = client.submit_batch(
            [ConnectedQuery(0, 1)], deadline_s=0.2
        )
        with pytest.raises(DeadlineExceeded):
            futs[0].result(10)
        assert time.monotonic() - t0 < 5.0
        assert counter_value("rpc.client_deadline_expired") >= 1
    finally:
        client.close()
        rpc.close()


def test_duplicate_batch_id_is_deduped_from_cache():
    srv = started_server()
    rpc = RpcServer(srv).start()
    try:
        s = raw_conn(rpc)
        req = pack_frame(T_REQ, json.dumps(
            {"id": "dup-1", "q": [["C", 0, 1]]}
        ).encode())
        s.sendall(req)
        ftype, p1 = read_frame(s)
        assert ftype == T_RESP
        s.sendall(req)  # same id again: served from the dedupe cache
        ftype, p2 = read_frame(s)
        assert json.loads(p1) == json.loads(p2)
        assert json.loads(p1)["status"] == "ok"
        assert counter_value("rpc.deduped") >= 1
        s.close()
    finally:
        rpc.close()
        srv.close()


def test_bad_request_is_terminal():
    srv = started_server()
    rpc = RpcServer(srv).start()
    try:
        s = raw_conn(rpc)
        s.sendall(pack_frame(T_REQ, json.dumps(
            {"id": "bad-1", "q": [["Z", 1]]}
        ).encode()))
        _, payload = read_frame(s)
        doc = json.loads(payload)
        assert doc["status"] == "bad_request"
        assert doc["id"] == "bad-1"
        assert counter_value("rpc.malformed", kind="request") >= 1
        s.close()
    finally:
        rpc.close()
        srv.close()


def test_non_numeric_deadline_is_bad_request_not_thread_death():
    # review finding: float("abc") inside _admit would have killed the
    # handler thread; the coercion belongs to request parsing, where a
    # bad deadline is a TERMINAL bad_request the client never retries
    srv = started_server()
    rpc = RpcServer(srv).start()
    try:
        s = raw_conn(rpc)
        req = {"id": "dl-1", "q": [["C", 0, 1]], "deadline_s": "abc"}
        s.sendall(pack_frame(T_REQ, json.dumps(req).encode()))
        _, payload = read_frame(s)
        doc = json.loads(payload)
        assert doc["status"] == "bad_request"
        # the SAME connection keeps serving (the handler survived)
        s.sendall(pack_frame(T_REQ, json.dumps(
            {"id": "dl-2", "q": [["C", 0, 1]], "deadline_s": 10.0}
        ).encode()))
        _, payload = read_frame(s)
        assert json.loads(payload)["status"] == "ok"
        s.close()
    finally:
        rpc.close()
        srv.close()


def test_deadline_spent_during_overloaded_retry_fails_deadline():
    # review finding: a deadline spent mid-retry must surface as
    # DeadlineExceeded (the contract), never as Overloaded — the retry
    # budget is not what ran out
    srv = StreamServer(iter(()), None, max_pending=1)
    rpc = RpcServer(srv).start()
    client = RpcClient(
        rpc.address,
        retry_policy=RetryPolicy(attempts=100, base_s=0.02, jitter=0.0),
    )
    try:
        futs = client.submit_batch(
            [ConnectedQuery(0, 1), ConnectedQuery(1, 2)],
            deadline_s=0.25,
        )
        with pytest.raises(DeadlineExceeded):
            futs[0].result(20)
    finally:
        client.close()
        rpc.close()


# --------------------------------------------------------------------- #
# Shared snapshot directory (mirror + follower)
# --------------------------------------------------------------------- #
def publish_n(store, n, start=0):
    vd = IdentityDict(V)
    vd.observe(V - 1)
    for w in range(start, start + n):
        labels = np.arange(V, dtype=np.int32)
        labels[: min(V, w + 2)] = 0
        store.publish({"labels": labels, "vdict": vd}, w, w + 1)


def test_snapshot_mirror_round_trips_payloads(tmp_path):
    store = SnapshotStore()
    store.add_listener(SnapshotMirror(str(tmp_path)))
    publish_n(store, 3)
    doc = load_newest_snapshot(str(tmp_path))
    assert doc["version"] == 3 and doc["watermark"] == 3
    assert doc["payload"]["labels"][3] == 0
    assert doc["payload"]["vdict"].lookup(5) == 5


def test_torn_mirrored_snapshot_is_rejected_with_fallback(tmp_path):
    from gelly_streaming_tpu_torch.resilience.faults import corrupt_file
    from gelly_streaming_tpu_torch.serving.snapshot_store import _snap_path

    store = SnapshotStore()
    store.add_listener(SnapshotMirror(str(tmp_path), keep=3))
    publish_n(store, 3)
    corrupt_file(_snap_path(str(tmp_path), 3), "flip")
    with pytest.warns(RuntimeWarning, match="rejected"):
        doc = load_newest_snapshot(str(tmp_path))
    assert doc["version"] == 2  # fell back past the torn head
    assert counter_value("resilience.ckpt_rejected") >= 1


def test_mirror_flush_commits_a_stride_skipped_final_snapshot(tmp_path):
    # review finding: every=N skipped trailing windows forever; flush
    # (wired to ingest-end and close in the replica runtime) commits
    # the newest snapshot so failover serves the FINAL state
    store = SnapshotStore()
    mirror = SnapshotMirror(str(tmp_path), every=3, keep=4)
    store.add_listener(mirror)
    publish_n(store, 4)  # versions 1..4; only v3 is on the stride
    assert load_newest_snapshot(str(tmp_path))["version"] == 3
    mirror.flush(store)
    assert load_newest_snapshot(str(tmp_path))["version"] == 4
    mirror.flush(store)  # idempotent per version
    assert load_newest_snapshot(str(tmp_path))["version"] == 4


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="pins the raise of a machine without a card")
def test_standby_defaults_to_the_card(tmp_path):
    # a standby, like every entry point of the port, serves on the card
    # unless built with device="cpu": without one it raises at
    # construction, not later in its serving thread
    from gelly_streaming_tpu_torch.resilience.errors import DeviceUnavailable

    with pytest.raises(DeviceUnavailable):
        follow_snapshots(str(tmp_path), threading.Event())
    with pytest.raises(DeviceUnavailable):
        ReplicaServer(dirpath=str(tmp_path), role="standby", monitor=False)


def test_follower_holds_cpu_tensors_when_asked(tmp_path):
    store = SnapshotStore()
    store.add_listener(SnapshotMirror(str(tmp_path), keep=4))
    stop = threading.Event()
    it = follow_snapshots(str(tmp_path), stop, poll_s=0.01, device="cpu")
    store.publish({"labels": torch.arange(5, dtype=torch.int32)}, 1, 1)
    payload, _ = next(it)
    stop.set()
    assert isinstance(payload["labels"], torch.Tensor)
    assert payload["labels"].device.type == "cpu"
    assert payload["labels"].tolist() == [0, 1, 2, 3, 4]


def test_follower_yields_each_new_version_once(tmp_path):
    store = SnapshotStore()
    store.add_listener(SnapshotMirror(str(tmp_path), keep=4))
    stop = threading.Event()
    it = follow_snapshots(str(tmp_path), stop, poll_s=0.01, device="cpu")
    publish_n(store, 1)
    payload, wm = next(it)
    assert wm == 1
    publish_n(store, 2, start=1)
    payload, wm = next(it)
    assert wm == 3  # the follower jumps to the NEWEST, never replays
    stop.set()
    assert list(it) == []


# --------------------------------------------------------------------- #
# Cross-process failover (in-process replica pair over a shared dir)
# --------------------------------------------------------------------- #
@pytest.mark.chaos_fast
def test_lease_lapse_promotes_standby_and_client_follows(tmp_path):
    shared = str(tmp_path / "shared")
    primary = ReplicaServer(
        chain_payloads(windows=2000, pace_s=0.005), None,
        dirpath=shared, role="primary", lease_s=0.3,
    ).start()
    standby = ReplicaServer(
        dirpath=shared, role="standby", lease_s=0.3, device="cpu",
    ).start()
    client = RpcClient(
        [primary.rpc.address, standby.rpc.address]
    )
    try:
        ans = client.ask(ConnectedQuery(0, 1),
                         deadline_s=30, timeout=30)
        assert ans.value is True
        assert standby.health()["role"] == "standby"
        assert primary.health()["role"] == "primary"
        hb = standby.heartbeat_age_s()
        assert hb is not None and hb < 10.0
        # the primary dies: rpc listener, heartbeat, serving — all gone
        primary.close()
        ans = client.ask(ConnectedQuery(0, 1),
                         deadline_s=30, timeout=30)
        assert ans.value is True
        assert standby.promoted
        assert standby.health()["role"] == "primary"
        assert counter_value("serving.lease_lapse") >= 1
        assert counter_value("serving.failover",
                             reason="lease_lapse") >= 1
        hist = get_registry().histogram("serving.promotion_seconds")
        assert hist.count >= 1
    finally:
        client.close()
        standby.close()
        primary.close()


def test_standby_refuses_until_promoted(tmp_path):
    shared = str(tmp_path / "shared")
    store = SnapshotStore()
    store.add_listener(SnapshotMirror(shared))
    publish_n(store, 2)
    standby = ReplicaServer(
        dirpath=shared, role="standby", lease_s=0.5, monitor=False,
        device="cpu",
    ).start()
    client = RpcClient(standby.rpc.address, route_attempts=2)
    try:
        from gelly_streaming_tpu_torch.serving import RpcError

        with pytest.raises(RpcError):
            client.ask(ConnectedQuery(0, 1), timeout=20)
        assert counter_value("rpc.not_primary") >= 3
        standby.promote(reason="manual")
        ans = client.ask(ConnectedQuery(0, 1),
                         deadline_s=20, timeout=20)
        assert ans.value is True
    finally:
        client.close()
        standby.close()


# --------------------------------------------------------------------- #
# End-to-end query tracing over the wire
# --------------------------------------------------------------------- #
def test_trace_context_rides_the_wire_end_to_end():
    """One client batch -> one trace: the context minted client-side
    rides the frame body, and every server stage span (decode, admit,
    the answering sweep, reply, the server residence) carries the same
    trace id, parented to the client's batch-root sid."""
    obs.enable()
    sink = obs.JsonlSink()
    obs.attach_sink(sink)
    srv = started_server()
    rpc = RpcServer(srv).start()
    client = RpcClient(rpc.address)
    try:
        ans = client.ask_batch(
            [ConnectedQuery(0, 1), ComponentSizeQuery(0)],
            deadline_s=20, timeout=20,
        )
        assert ans[0].value is True
        deadline = time.monotonic() + 5
        want = {"rpc.decode", "rpc.admit", "serving.query", "rpc.reply",
                "rpc.server.batch", "rpc.client.batch"}
        spans = {}
        while time.monotonic() < deadline and \
                not want <= set(spans):
            spans = {}
            for e in sink.events:
                if e.get("kind") == "span" and e.get("trace"):
                    spans.setdefault(e["name"], e)
            time.sleep(0.01)
        assert want <= set(spans), sorted(spans)
        root = spans["rpc.client.batch"]
        # ONE trace joins all stages; server spans parent to the root
        for name in want:
            assert spans[name]["trace"] == root["trace"], name
        for name in want - {"rpc.client.batch"}:
            assert spans[name]["parent"] == root["sid"], name
        # the attribution attrs ride the answering sweep's span
        at = spans["serving.query"]["attrs"]
        for key in ("queue_wait_s", "dispatch_s", "settle_s",
                    "snapshot_age_s", "staleness", "window"):
            assert key in at, key
        # the wire-latency histogram's exemplar links to this trace
        ex = get_registry().histogram(
            "rpc.client_wire_seconds").exemplars()
        assert any(t == root["trace"] for _v, t in ex)
    finally:
        client.close()
        rpc.close()
        srv.close()


def test_untraced_wire_stays_untraced_and_tolerates_garbage_tc():
    """Tracing off -> no context minted, no span events; a frame that
    carries a garbage tc field is served normally (from_wire is
    tolerant by contract)."""
    sink = obs.JsonlSink()
    obs.attach_sink(sink)  # attached but DISABLED
    srv = started_server()
    rpc = RpcServer(srv).start()
    try:
        client = RpcClient(rpc.address)
        assert client.ask(ConnectedQuery(0, 1),
                          timeout=20).value is True
        client.close()
        assert not [e for e in sink.events if e.get("kind") == "span"]
        # garbage tc on a raw frame: answered ok even with tracing ON
        obs.enable()
        s = raw_conn(rpc)
        s.sendall(pack_frame(T_REQ, json.dumps({
            "id": "tc-garbage", "q": [["C", 0, 1]],
            "tc": {"bogus": True},
        }).encode()))
        _, payload = read_frame(s)
        assert json.loads(payload)["status"] == "ok"
        s.close()
    finally:
        rpc.close()
        srv.close()


def test_client_retries_stay_on_the_same_trace():
    """Overloaded re-asks are part of the query's causal story: every
    retry span and the final root span carry the ONE trace id minted at
    submit (the frame resent under the same batch id and tc)."""
    obs.enable()
    sink = obs.JsonlSink()
    obs.attach_sink(sink)
    srv = StreamServer(iter(()), None, max_pending=1)
    rpc = RpcServer(srv).start()
    client = RpcClient(
        rpc.address,
        retry_policy=RetryPolicy(attempts=2, base_s=0.01, jitter=0.0),
    )
    try:
        futs = client.submit_batch(
            [ConnectedQuery(0, 1), ConnectedQuery(1, 2)]
        )
        with pytest.raises(Overloaded):
            futs[0].result(20)
        retries = [e for e in sink.events
                   if e.get("name") == "rpc.client.retry"]
        assert len(retries) == 2
        traces = {e["trace"] for e in retries}
        assert len(traces) == 1
    finally:
        client.close()
        rpc.close()


def test_failover_adoption_preserves_trace_context():
    """In-flight entries adopted across a promotion keep their original
    TraceContext: the standby's answering sweep emits its span on the
    SAME trace the query was submitted under."""
    from gelly_streaming_tpu_torch.serving import FailoverServer

    obs.enable()
    sink = obs.JsonlSink()
    obs.attach_sink(sink)
    with faults.injected(faults.FaultPlan(
        kill_site="serving.worker", kill_at_window=2
    )):
        fs = FailoverServer(
            chain_payloads(windows=3, pace_s=0.0), None,
            monitor_s=None, max_pending=64,
        ).start()
        try:
            deadline = time.monotonic() + 30
            while fs.primary.worker_alive() and \
                    time.monotonic() < deadline:
                time.sleep(0.01)
            assert not fs.primary.worker_alive()
            ctx = obs.TraceContext(parent_sid=obs.next_sid())
            f = fs.primary.submit(ConnectedQuery(0, 1), ctx=ctx)
            fs.promote(reason="worker_death")
            assert f.result(30).value is True
        finally:
            fs.close()
    sweeps = [e for e in sink.events
              if e.get("name") == "serving.query"]
    ours = [e for e in sweeps if e.get("trace") == ctx.trace_id]
    assert ours, [e.get("trace") for e in sweeps]
    assert ours[-1]["parent"] == ctx.parent_sid


# --------------------------------------------------------------------- #
# /healthz role + heartbeat age (the failover satellite)
# --------------------------------------------------------------------- #
def test_failover_healthz_reports_role_and_heartbeat_age():
    fs = FailoverServer(
        chain_payloads(windows=500, pace_s=0.005), None,
        monitor_s=None, max_pending=64,
    ).start()
    ep = fs.metrics_endpoint(port=0)
    try:
        import urllib.request

        def healthz():
            with urllib.request.urlopen(
                f"{ep.url}/healthz", timeout=10
            ) as r:
                return json.loads(r.read().decode())

        doc = healthz()
        assert doc["role"] == "primary" and doc["promoted"] is False
        assert doc["heartbeat_age_s"] >= 0.0
        assert doc["worker_alive"] is True and doc["ok"] is True
        fs.promote(reason="manual")
        doc = healthz()
        assert doc["role"] == "standby" and doc["promoted"] is True
        assert doc["heartbeat_age_s"] >= 0.0
    finally:
        ep.close()
        fs.close()


@pytest.mark.chaos_fast
def test_healthz_role_flips_across_a_live_promotion(tmp_path):
    """/healthz probed over REAL HTTP while the
    lease monitor runs — role reads standby before the kill, flips to
    primary (promoted=true) after the lease lapses, and
    heartbeat_age_s stays fresh throughout because the promoted
    standby takes the beat over."""
    import urllib.request

    shared = str(tmp_path / "shared")
    # a generous lease: a loaded CI host can stall the beat thread for
    # hundreds of ms, and a pre-kill lapse would flip the role early
    lease_s = 1.0
    primary = ReplicaServer(
        chain_payloads(windows=2000, pace_s=0.005), None,
        dirpath=shared, role="primary", lease_s=lease_s,
    ).start()
    standby = ReplicaServer(
        dirpath=shared, role="standby", lease_s=lease_s, device="cpu",
    ).start()
    ep = standby.metrics_endpoint(port=0)

    def healthz():
        with urllib.request.urlopen(
            f"{ep.url}/healthz", timeout=10
        ) as r:
            return json.loads(r.read().decode())

    try:
        doc = healthz()
        assert doc["role"] == "standby" and doc["promoted"] is False
        assert doc["worker_alive"] is True and doc["ok"] is True
        # fresh while the PRIMARY beats
        assert doc["heartbeat_age_s"] is not None
        assert doc["heartbeat_age_s"] < 10.0
        primary.close()  # the lease stops beating; the monitor promotes
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            doc = healthz()
            if doc.get("role") == "primary":
                break
            time.sleep(0.02)
        assert doc["role"] == "primary" and doc["promoted"] is True
        assert doc["ok"] is True and doc["worker_alive"] is True
        # fresh again because the PROMOTED STANDBY owns the beat now:
        # poll past its first own beats and require sub-lease age
        deadline = time.monotonic() + 10
        age = None
        while time.monotonic() < deadline:
            age = healthz()["heartbeat_age_s"]
            if age is not None and age < lease_s:
                break
            time.sleep(0.02)
        assert age is not None and age < lease_s, age
    finally:
        ep.close()
        standby.close()
        primary.close()


def test_heartbeat_lease_records_are_crc_framed_and_atomic(tmp_path):
    lease = HeartbeatLease(str(tmp_path), lease_s=0.4, port=1234)
    lease.write()
    doc = HeartbeatLease.read(str(tmp_path))
    assert doc["port"] == 1234 and doc["lease_s"] == 0.4
    age, lease_s = HeartbeatLease.age_s(str(tmp_path))
    assert age < 5.0 and lease_s == 0.4
    # a corrupted record is rejected visibly and treated as absent
    from gelly_streaming_tpu_torch.resilience.faults import corrupt_file

    corrupt_file(os.path.join(str(tmp_path), "heartbeat.bin"), "flip")
    with pytest.warns(RuntimeWarning, match="rejected"):
        assert HeartbeatLease.read(str(tmp_path)) is None


# --------------------------------------------------------------------- #
# Timeline: the RPC story
# --------------------------------------------------------------------- #
def test_timeline_renders_the_rpc_failover_story_in_order():
    events = [
        {"kind": "counter", "name": "rpc.connects", "v": 1,
         "ts": 10.0, "shard": "p0"},
        {"kind": "counter", "name": "rpc.disconnects", "v": 1,
         "ts": 11.0, "shard": "p0"},
        {"kind": "counter", "name": "serving.lease_lapse", "v": 1,
         "ts": 11.4, "shard": "p1"},
        {"kind": "counter", "name": "serving.failover", "v": 1,
         "labels": {"reason": "lease_lapse"}, "ts": 11.45,
         "shard": "p1"},
        {"kind": "hist", "name": "serving.promotion_seconds",
         "v": 0.012, "ts": 11.46, "shard": "p1"},
        {"kind": "counter", "name": "rpc.connects", "v": 1,
         "ts": 11.5, "shard": "p1"},
        # noise the story must filter out
        {"kind": "counter", "name": "rpc.batches", "v": 1, "ts": 10.5},
    ]
    lines = timeline.render(events)
    tags = [line.split("]", 1)[1].split()[0] for line in lines]
    assert tags == ["CONNECT", "DISCONNECT", "LEASE-LAPSE", "PROMOTE",
                    "PROMOTED", "CONNECT"]
    assert "reason=lease_lapse" in lines[3]
    # --all keeps the noise
    assert len(timeline.render(events, all_events=True)) == 7


def test_timeline_renders_malformed_frames():
    lines = timeline.render([
        {"kind": "counter", "name": "rpc.malformed", "v": 1,
         "labels": {"kind": "truncated"}, "ts": 1.0, "shard": "p0"},
    ])
    assert len(lines) == 1 and "MALFORMED" in lines[0]
    assert "kind=truncated" in lines[0]


def _trace_story_events():
    return [
        {"kind": "span", "name": "rpc.decode", "ts": 10.0,
         "dur_s": 1e-4, "sid": 5, "depth": 0, "trace": "tA",
         "parent": 1, "shard": "p0"},
        {"kind": "span", "name": "rpc.client.resubmit", "ts": 10.4,
         "dur_s": 0.4, "sid": 2, "depth": 0, "trace": "tA",
         "parent": 1, "shard": "p2"},
        {"kind": "span", "name": "serving.query", "ts": 10.5,
         "dur_s": 0.001, "sid": 9, "depth": 0, "trace": "tA",
         "parent": 1, "shard": "p1"},
        {"kind": "span", "name": "rpc.client.batch", "ts": 10.6,
         "dur_s": 0.6, "sid": 1, "depth": 0, "trace": "tA",
         "shard": "p2"},
        # another trace + an untraced metric event: both filtered out
        {"kind": "span", "name": "serving.query", "ts": 10.2,
         "dur_s": 0.001, "sid": 11, "depth": 0, "trace": "tB",
         "shard": "p1"},
        {"kind": "counter", "name": "rpc.connects", "v": 1,
         "ts": 10.1, "shard": "p1"},
    ]


def test_timeline_trace_filter_renders_one_causal_story(tmp_path, capsys):
    events = _trace_story_events()
    kept = timeline.filter_events(events, trace="tA")
    assert [e["sid"] for e in kept] == [5, 2, 9, 1]
    # through the CLI: ts-ordered, every event of the trace rendered
    # (spans included without needing --all), nothing else
    path = tmp_path / "events.jsonl"
    path.write_text("".join(json.dumps(e) + "\n" for e in events))
    rc = timeline.main([str(path), "--trace", "tA"])
    out = capsys.readouterr().out
    assert rc == 0
    body = [line for line in out.splitlines()
            if not line.startswith("#")]
    assert len(body) == 4
    assert "[          p0]" in body[0]  # decode on the dead primary
    assert "rpc.client.resubmit" in body[1]
    assert "[          p1]" in body[2]  # the promoted standby answers
    assert "rpc.client.batch" in body[3]
    assert "rpc.connects" not in out and "tB" not in out


def test_timeline_since_until_window_filters(tmp_path, capsys):
    events = _trace_story_events()
    # absolute bounds are inclusive
    kept = timeline.filter_events(events, since=10.2, until=10.5)
    assert {e["sid"] for e in kept} == {2, 9, 11}
    # relative (+s) forms resolve against the run's own t0 and keep
    # the rendered offsets anchored to the SAME zero
    path = tmp_path / "events.jsonl"
    path.write_text("".join(json.dumps(e) + "\n" for e in events))
    rc = timeline.main(
        [str(path), "--all", "--since", "+0.15", "--until", "+0.45"]
    )
    out = capsys.readouterr().out
    assert rc == 0
    body = [line for line in out.splitlines()
            if not line.startswith("#")]
    # events at +0.2, +0.4 survive; offsets still run-anchored
    assert len(body) == 2
    assert body[0].startswith("+   0.200s")
    assert body[1].startswith("+   0.400s")
    # an empty window is reported as no events (exit 1)
    assert timeline.main(
        [str(path), "--since", "999999999999"]
    ) == 1
    capsys.readouterr()


# --------------------------------------------------------------------- #
# The CI gate, pinned as a test (subprocess pair + SIGKILL + retry)
# --------------------------------------------------------------------- #
@pytest.mark.slow
def test_rpc_smoke_is_green():
    from gelly_streaming_tpu_torch.serving.rpc import smoke

    assert smoke(verbose=False, device="cpu") is True


# --------------------------------------------------------------------- #
# Across the packages: the same frames, answers, stamps and traces
# --------------------------------------------------------------------- #
def _jax_serving():
    from gelly_streaming_tpu import obs as jobs
    from gelly_streaming_tpu import serving as jserving
    from gelly_streaming_tpu.serving import rpc as jrpc

    return jobs, jserving, jrpc


def _all_queries(mod):
    return [mod.ConnectedQuery(0, 1), mod.DegreeQuery(4), mod.RankQuery(5),
            mod.ComponentSizeQuery(7), mod.SummaryPullQuery(),
            mod.SummaryPullQuery(since_version=3), mod.BipartiteQuery()]


def test_frames_and_codecs_are_byte_identical_to_the_jax_packages():
    from gelly_streaming_tpu_torch import serving
    from gelly_streaming_tpu_torch.serving import rpc
    from gelly_streaming_tpu_torch.serving.query import Answer
    from gelly_streaming_tpu_torch.serving.txn import encode_txn as tenc

    _jobs, jserving, jrpc = _jax_serving()
    from gelly_streaming_tpu.serving.txn import encode_txn as jenc

    for ftype in (T_REQ, T_RESP):
        assert pack_frame(ftype, b'{"id":"x"}') == jrpc.pack_frame(ftype, b'{"id":"x"}')
    wire = encode_queries(_all_queries(serving))
    assert json.dumps(wire) == json.dumps(jrpc.encode_queries(_all_queries(jserving)))
    assert [type(q).__name__ for q in jrpc.decode_queries(wire)] == \
        [type(q).__name__ for q in _all_queries(serving)]
    assert decode_queries(jrpc.encode_queries(_all_queries(jserving))) == _all_queries(serving)
    for value in (True, 3, 0.25, {"bipartite": False, "witness": 7}):
        a = Answer(value=value, window=4, watermark=90, staleness=1, version=6,
                   event_ts=12, boot="b00t")
        ja = jserving.Answer(value=value, window=4, watermark=90, staleness=1,
                             version=6, event_ts=12, boot="b00t")
        assert json.dumps(rpc.encode_answer(a, shard=2)) == \
            json.dumps(jrpc.encode_answer(ja, shard=2))
    # a torch scalar answers like a numpy scalar
    t = Answer(value=torch.tensor(5), window=0, watermark=0, staleness=0)
    assert rpc.encode_answer(t)[1] == 5
    for tid, kw in (("t1", {"pin": (4, "ab")}), ("t2", {"vec": {0: (3, "x"), 2: (9, "y")}}),
                    ("t3", {})):
        assert json.dumps(tenc(tid, **kw)) == json.dumps(jenc(tid, **kw))
    assert rpc.RETRYABLE == jrpc.RETRYABLE and rpc.HEARTBEAT_NAME == jrpc.HEARTBEAT_NAME


def _stamps(answers):
    return [(a.value, a.window, a.watermark, a.version, a.shard, a.boot)
            for a in answers]


@pytest.mark.parametrize("server_pkg", ["port", "jax"])
def test_the_other_packages_client_gets_equal_answers_stamps_and_trace(server_pkg):
    """A JAX ``RpcClient`` against a port ``RpcServer`` (and the reverse)
    answers exactly as the server's own package's client does, with the
    same window/version/shard/boot stamps, and the client's trace id is
    the one the server's spans carry."""
    jobs, jserving, jrpc = _jax_serving()
    from gelly_streaming_tpu.serving.client import RpcClient as JaxClient

    if server_pkg == "port":
        srv = started_server()
        srv.join(30)
        rpc = RpcServer(srv, shard=3).start()
        server_obs, client_obs = obs, jobs
        clients = (RpcClient, JaxClient)
        qmods = (None, jserving)
    else:
        def jpayloads():
            for payload, wm in chain_payloads(windows=40, pace_s=0.0):
                yield {**payload, "labels": payload["labels"].numpy()}, wm

        srv = jserving.StreamServer(jpayloads(), None, max_pending=1024).start()
        srv.join(30)
        rpc = jrpc.RpcServer(srv, shard=3).start()
        server_obs, client_obs = jobs, obs
        clients = (JaxClient, RpcClient)
        qmods = (jserving, None)
    from gelly_streaming_tpu_torch import serving as tserving

    answers = []
    try:
        for cls, mod in zip(clients, qmods):
            q = mod or tserving
            cl = cls(f"127.0.0.1:{rpc.port}")
            try:
                answers.append(cl.ask_batch(
                    [q.ConnectedQuery(0, 1), q.ComponentSizeQuery(0),
                     q.ConnectedQuery(5, 30)], deadline_s=20, timeout=20))
            finally:
                cl.close()
        assert _stamps(answers[0]) == _stamps(answers[1])
        assert [a.shard for a in answers[1]] == [3, 3, 3]
        # the trace crosses: the OTHER package's client mints it
        client_obs.enable()
        server_obs.enable()
        csink, ssink = client_obs.JsonlSink(), server_obs.JsonlSink()
        client_obs.attach_sink(csink)
        server_obs.attach_sink(ssink)
        cl = clients[1](f"127.0.0.1:{rpc.port}")
        try:
            cl.ask_batch([(qmods[1] or tserving).ConnectedQuery(0, 1)],
                         deadline_s=20, timeout=20)
        finally:
            cl.close()
        deadline = time.monotonic() + 5
        while time.monotonic() < deadline and not any(
                e.get("name") == "rpc.server.batch" for e in ssink.events):
            time.sleep(0.01)
        root = next(e for e in csink.events if e.get("name") == "rpc.client.batch")
        server_spans = [e for e in ssink.events
                        if e.get("kind") == "span" and e.get("trace")]
        assert {e["name"] for e in server_spans} >= {"rpc.decode", "rpc.admit",
                                                     "rpc.server.batch"}
        assert {e["trace"] for e in server_spans} == {root["trace"]}
        assert {e["parent"] for e in server_spans} == {root["sid"]}
    finally:
        jobs.reset()
        rpc.close()
        srv.close()


def test_a_pinned_transaction_pins_equal_vectors_from_either_client():
    from gelly_streaming_tpu.serving import TxnContext as JaxTxn
    from gelly_streaming_tpu.serving import ConnectedQuery as JQ
    from gelly_streaming_tpu.serving.client import RpcClient as JaxClient
    from gelly_streaming_tpu_torch.serving import TxnContext

    srv = StreamServer(chain_payloads(windows=5, pace_s=0.0), None,
                       store=SnapshotStore(retention=64)).start()
    srv.join(30)
    rpc = RpcServer(srv, shard=0).start()
    try:
        vecs, wants = [], []
        for cls, txn_cls, q in ((RpcClient, TxnContext, ConnectedQuery),
                                (JaxClient, JaxTxn, JQ)):
            cl = cls(rpc.address)
            try:
                wants.append({0: (srv.store.latest().version, srv.store.boot)})
                t = txn_cls(deadline_s=30)
                first = cl.ask(q(0, 1), txn=t, timeout=20)
                # a newer version lands; the pinned read repeats the pin
                snap = srv.store.latest()
                srv.store.publish(snap.payload, snap.window + 1, snap.watermark + 1)
                again = cl.ask(q(0, 1), txn=t, timeout=20)
                assert (again.value, again.version, again.boot) == \
                    (first.value, first.version, first.boot)
                vecs.append(t.vector())
            finally:
                cl.close()
        assert vecs == wants and wants[0][0][0] == 5
    finally:
        rpc.close()
        srv.close()


def test_port_mirror_holds_numpy_and_loads_in_a_fresh_process(tmp_path):
    """A mirror written from torch tensors holds numpy arrays only (it
    unpickles without torch tensors), loads in a fresh port process, and
    — recorded, not required — loads in the JAX package too, its vdict
    staying the port's pickled class."""
    import pickle
    import subprocess
    import sys

    from gelly_streaming_tpu.serving.snapshot_store import (
        load_newest_snapshot as jax_load,
    )
    from gelly_streaming_tpu_torch.resilience import integrity

    store = SnapshotStore()
    mirror = SnapshotMirror(str(tmp_path))
    store.add_listener(mirror)
    payload, wm = next(chain_payloads(windows=1, pace_s=0.0))
    store.publish(payload, 0, wm)
    path = os.path.join(str(tmp_path), os.listdir(str(tmp_path))[0])
    with open(path, "rb") as f:
        doc = pickle.loads(integrity.unwrap_checksummed(f.read(), origin=path))
    assert isinstance(doc["payload"]["labels"], np.ndarray)
    np.testing.assert_array_equal(doc["payload"]["labels"], payload["labels"].numpy())
    code = ("import sys; sys.path.insert(0, sys.argv[2]); "
            "from gelly_streaming_tpu_torch.serving.snapshot_store import "
            "load_newest_snapshot as L; d = L(sys.argv[1]); "
            "print(d['version'], d['payload']['labels'].tolist()[:4], "
            "type(d['payload']['vdict']).__module__)")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path), repo],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split() == ["1", "[0,", "0,", "2,", "3]",
                                  "gelly_streaming_tpu_torch.datasets"]
    jdoc = jax_load(str(tmp_path))
    np.testing.assert_array_equal(jdoc["payload"]["labels"], doc["payload"]["labels"])
    assert type(jdoc["payload"]["vdict"]).__module__ == "gelly_streaming_tpu_torch.datasets"


def test_standby_on_a_device_answers_from_uploaded_snapshots(tmp_path):
    """A standby given ``device`` uploads each followed snapshot (the
    mirror holds numpy): on the CPU the tables become tensors, and the
    answers equal the primary's."""
    shared = str(tmp_path / "shared")
    primary = ReplicaServer(chain_payloads(windows=6, pace_s=0.0), None,
                            dirpath=shared, role="primary", lease_s=5.0)
    standby = ReplicaServer(dirpath=shared, role="standby", lease_s=5.0,
                            device="cpu", monitor=False)
    primary.start()
    standby.start()
    try:
        primary.server.join(30)
        primary.mirror.flush(primary.store)
        deadline = time.monotonic() + 20
        while time.monotonic() < deadline and (
                standby.store.latest() is None
                or standby.store.latest().version < primary.store.latest().version):
            time.sleep(0.01)
        snap = standby.store.latest()
        assert isinstance(snap.payload["labels"], torch.Tensor)
        standby.promote(reason="manual")
        for q in (ConnectedQuery(0, 5), ComponentSizeQuery(0), ConnectedQuery(9, 30)):
            a, b = primary.ask(q, timeout=20), standby.ask(q, timeout=20)
            assert (a.value, a.version, a.boot) == (b.value, b.version, b.boot)
    finally:
        standby.close()
        primary.close()


def test_routing_tier_parts_raise_naming_slice_9b(tmp_path):
    """The routing tier's parts of the wire (slice 9b) are ported: each
    part that used to raise here now works as the JAX package's does,
    and the ones that place tables default to the card (raising
    ``DeviceUnavailable`` without one)."""
    from gelly_streaming_tpu.serving import reshard as jreshard
    from gelly_streaming_tpu_torch.resilience.errors import DeviceUnavailable
    from gelly_streaming_tpu_torch.serving import reshard, router
    from gelly_streaming_tpu_torch.serving.rpc import replica_main

    r = router.ShardRouter([["127.0.0.1:1"]])
    try:
        assert r.nshards == 1 and r.health()["epoch"] == 0
    finally:
        r.close()
    w = reshard.ReshardWatcher(str(tmp_path))
    try:
        assert w.epoch() == 0 and w.plans() == []
    finally:
        w.close()
    won = reshard.propose_split(str(tmp_path), 1, parent=0, child=1, salt=3)
    assert won == jreshard.read_plan(str(tmp_path), 1)
    # a split child answers from boot: its gate is open, a standby's is not
    split = ReplicaServer(dirpath=str(tmp_path / "s"), role="split", device="cpu")
    standby = ReplicaServer(dirpath=str(tmp_path / "s"), role="standby", device="cpu",
                            reshard={"store": str(tmp_path), "shard": 0})
    try:
        assert split._gate() is None and standby._gate() == "not_primary"
        assert standby.shard == 0 and standby.rpc.shard == 0
        assert standby.health()["epoch"] == 0  # the watcher starts with start()
    finally:
        split.close()
        standby.close()
    if not torch.cuda.is_available():
        with pytest.raises(DeviceUnavailable):
            router.shard_demo_payloads(n_vertices=8, n_edges=8)
        with pytest.raises(DeviceUnavailable):
            ReplicaServer(dirpath=str(tmp_path / "c"), role="split")
        with pytest.raises(DeviceUnavailable):
            replica_main({"role": "primary", "dir": str(tmp_path / "m"),
                          "cc_shard": {"n_vertices": 8, "n_edges": 8}})


@pytest.mark.slow
def test_chaos_mp_sweep_with_its_serving_points_on_the_cpu(tmp_path):
    """The reduced 2-process sweep with its failover and rpc points (the
    defaults), replicas and workers on the CPU."""
    from gelly_streaming_tpu_torch.resilience import chaos

    doc = chaos.run_mp_sweep(processes=2, windows=2, window_edges=32,
                             corrupt=False, device="cpu",
                             workdir=str(tmp_path), log=lambda s: None)
    assert doc["failover"]["ok"], doc["failover"]
    assert doc["rpc_failover"]["ok"], doc["rpc_failover"].get("reason")
    assert doc["ok"]
