"""The port's transport fabric (``fabric/``) against the JAX package: one
contract, both store-backed backends (shared-dir, socket), and the two
packages on one store.

Every case of the conformance suite runs on both backends through a
parametrized fixture: atomic one-winner puts, replay idempotence, torn or
corrupt framed payloads rejected as counted evidence, allgather and
barrier and broadcast, agreement determinism across restarts, and
kill-between-put-and-get recovery. Then the cross-package cases: a JAX
rank and a port rank in one shared directory and against one exchange
daemon (either package's) gather equal arrays and agree on one election
winner; the elected K (``ElectedK``) of both packages over one store
replays the same winners. The collective backend comes with the mesh:
constructing it raises naming slice 6.

Mirrors ``tests/test_fabric.py:72-400`` (the two-process collective case
at ``:401`` becomes the raise) and ``tests/test_control.py:582-651``. The
auto-K case never reads the wall clock: the drive loop's stopwatch
(``summaries/groupfold.py:_clock``) is a stub.
"""

import itertools
import os
import socket as _socket
import threading
import warnings

import numpy as np
import pytest

from gelly_streaming_tpu import fabric as jfab
from gelly_streaming_tpu_torch import obs
from gelly_streaming_tpu_torch.fabric import (
    CollectiveTransport,
    ElectedK,
    ExchangeDaemon,
    SharedDirTransport,
    SocketTransport,
    Transport,
    TransportUnsupported,
    as_transport,
)
from gelly_streaming_tpu_torch.fabric import wire
from gelly_streaming_tpu_torch.resilience.errors import TransientSourceError
from gelly_streaming_tpu_torch.resilience.integrity import wrap_checksummed


@pytest.fixture
def registry():
    reg = obs.set_registry(None)
    yield reg
    obs.set_registry(None)


@pytest.fixture
def tick_clock(monkeypatch):
    from gelly_streaming_tpu_torch.summaries import groupfold

    ticks = itertools.count()
    monkeypatch.setattr(groupfold, "_clock", lambda: float(next(ticks)))


@pytest.fixture(params=["shared_dir", "socket"])
def fabric(request, tmp_path):
    """``make(pid, nprocs, **kw)`` -> a fresh port Transport client over
    ONE shared store (separate clients model separate processes)."""
    if request.param == "shared_dir":
        def make(pid=0, nprocs=1, **kw):
            return SharedDirTransport(str(tmp_path), pid, nprocs, **kw)

        yield make
        return
    daemon = ExchangeDaemon().start()
    made = []

    def make(pid=0, nprocs=1, **kw):
        t = SocketTransport(daemon.address, pid, nprocs, **kw)
        made.append(t)
        return t

    yield make
    for t in made:
        t.close()
    daemon.stop()


def run_ranks(fns):
    out, errs = {}, []

    def one(i, fn):
        try:
            out[i] = fn()
        except BaseException as e:  # surfaced below
            errs.append(e)

    ts = [threading.Thread(target=one, args=(i, fn)) for i, fn in enumerate(fns)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(60)
    assert not errs, errs
    return out


# --------------------------------------------------------------------- #
# 1. The byte layer
# --------------------------------------------------------------------- #
def test_store_roundtrip_stat_list_delete(fabric):
    tr = fabric()
    assert tr.get("t1") is None and tr.stat("t1") is None
    assert tr.put("t1", b"abc", overwrite=True)
    assert tr.get("t1") == b"abc"
    st = tr.stat("t1")
    assert st is not None and st.size == 3
    tr.put("t2.x", b"zz", overwrite=True)
    assert tr.list("t") == ["t1", "t2.x"]
    assert tr.list("t2") == ["t2.x"]
    assert tr.delete("t1") and not tr.delete("t1")
    assert tr.get("t1") is None


def test_put_is_replay_idempotent_and_one_winner(fabric):
    tr = fabric()
    assert tr.put("tag", b"first") is True
    assert tr.put("tag", b"second") is False
    assert tr.get("tag") == b"first"
    wins = []
    payloads = [bytes([i]) * 64 for i in range(8)]

    def racer(i):
        if fabric().put("race", payloads[i]):
            wins.append(i)

    ts = [threading.Thread(target=racer, args=(i,)) for i in range(8)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(30)
    assert len(wins) == 1
    assert fabric().get("race") == payloads[wins[0]]


def test_version_changes_on_overwrite(fabric):
    tr = fabric()
    tr.put("v", b"a", overwrite=True)
    v1 = tr.stat("v").version
    tr.put("v", b"bb", overwrite=True)
    st = tr.stat("v")
    assert (st.size, st.version != v1) == (2, True)


# --------------------------------------------------------------------- #
# 2. Framed payloads
# --------------------------------------------------------------------- #
def test_get_framed_rejects_corrupt_and_torn_payloads(fabric, registry):
    tr = fabric()
    tr.put_framed("good", b"payload", overwrite=True)
    assert tr.get_framed("good") == b"payload"
    blob = bytearray(wrap_checksummed(b"payload"))
    blob[-1] ^= 0xFF
    tr.put("flip", bytes(blob), overwrite=True)
    tr.put("torn", wrap_checksummed(b"payload")[:-3], overwrite=True)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        assert tr.get_framed("flip") is None
        assert tr.get_framed("torn") is None
    assert registry.counter("resilience.ckpt_rejected").value >= 2


# --------------------------------------------------------------------- #
# 3. Group primitives over the store
# --------------------------------------------------------------------- #
def test_allgather_rank_order_and_replay(fabric):
    a, b = fabric(0, 2, timeout_s=30), fabric(1, 2, timeout_s=30)
    out = run_ranks([lambda: a.allgather("x0", np.arange(3)),
                     lambda: b.allgather("x0", np.arange(3) * 10)])
    for pid in (0, 1):
        np.testing.assert_array_equal(out[pid][0], np.arange(3))
        np.testing.assert_array_equal(out[pid][1], np.arange(3) * 10)
    again = a.allgather("x0", np.arange(3))
    np.testing.assert_array_equal(again[1], np.arange(3) * 10)


def test_allgather_missing_peer_is_transient(fabric):
    tr = fabric(0, 2, timeout_s=0.2)
    with pytest.raises(TransientSourceError, match="never published"):
        tr.allgather("lonely", np.ones(2))


def test_barrier_and_broadcast(fabric):
    a, b = fabric(0, 2, timeout_s=30), fabric(1, 2, timeout_s=30)

    def rank(tr, pid):
        got = tr.broadcast("cfg", b"root-bytes" if pid == 0 else None)
        tr.barrier("after-cfg")
        return got

    assert run_ranks([lambda: rank(a, 0), lambda: rank(b, 1)]) == {
        0: b"root-bytes", 1: b"root-bytes"}


# --------------------------------------------------------------------- #
# 4. Agreement
# --------------------------------------------------------------------- #
def test_elect_one_winner_every_reader_agrees(fabric):
    results = run_ranks([lambda p=p: fabric(p, 4).elect("leader", f"val-{p}")
                         for p in range(4)])
    assert len(set(results.values())) == 1
    winner = next(iter(results.values()))
    assert winner in {f"val-{p}" for p in range(4)}
    assert fabric(9, 4).elect("leader", "late-proposal") == winner


def test_kill_between_put_and_get_recovers(fabric):
    writer = fabric(0, 2)
    writer.put("will-survive", b"pre-kill bytes")
    if hasattr(writer, "close"):
        writer.close()
    del writer
    reader = fabric(1, 2)
    assert reader.get("will-survive", timeout_s=5) == b"pre-kill bytes"


# --------------------------------------------------------------------- #
# 5. ElectedK
# --------------------------------------------------------------------- #
class _FixedK:
    def __init__(self, k):
        self.k = k
        self.taps = 0

    def current_k(self):
        return self.k

    def tap_group(self, n_windows, n_edges, wall_s):
        self.taps += 1
        return self.k


def test_elected_k_agrees_across_processes(fabric):
    ka = ElectedK(_FixedK(2), fabric(0, 2), every=4)
    kb = ElectedK(_FixedK(5), fabric(1, 2), every=4)
    seq_a = [ka.current_k() for _ in range(6)]
    seq_b = [kb.current_k() for _ in range(6)]
    assert seq_a == seq_b
    assert set(seq_a) <= {2, 5}
    assert ka.tap_group(2, 100, 0.01) == ka.k_agreed
    assert ka.inner.taps == 1
    assert ka.k == 2  # unknown attributes delegate to the inner learner


def test_elected_k_respects_resume_origin(fabric):
    first = ElectedK(_FixedK(2), fabric(0, 1), every=4)
    assert [first.current_k() for _ in range(6)] == [2] * 6
    resumed = ElectedK(_FixedK(7), fabric(0, 1), every=4, done=8)
    assert [resumed.current_k() for _ in range(2)] == [2, 2]
    assert resumed.current_k() == 7


# --------------------------------------------------------------------- #
# 6. Coercion + timeline story
# --------------------------------------------------------------------- #
def test_as_transport_coercion(tmp_path):
    tr = as_transport(str(tmp_path))
    assert isinstance(tr, SharedDirTransport) and tr.root == str(tmp_path)
    assert as_transport(tr) is tr
    assert isinstance(as_transport(tmp_path), SharedDirTransport)
    assert isinstance(tr, Transport)
    with pytest.raises(TypeError, match="Transport"):
        as_transport(42)


def test_read_coercion_is_side_effect_free(tmp_path):
    target = str(tmp_path / "not-yet")
    tr = as_transport(target)
    assert tr.get("x") is None and tr.list() == []
    assert not os.path.exists(target)
    tr.put("x", b"1")
    assert os.path.isdir(target)


def test_timeline_renders_fabric_story_lines():
    from gelly_streaming_tpu.obs import timeline as jtimeline
    from gelly_streaming_tpu_torch.obs import timeline

    events = [
        {"kind": "counter", "name": "fabric.exchange", "v": 1, "ts": 1.0, "shard": "p0",
         "labels": {"backend": "socket", "tag": "w0"}},
        {"kind": "counter", "name": "fabric.elect", "v": 1, "ts": 2.0, "shard": "p0",
         "labels": {"backend": "socket", "tag": "cadence.e00000000", "won": "true"}},
        {"kind": "counter", "name": "fabric.agree", "v": 1, "ts": 3.0, "shard": "p0",
         "labels": {"backend": "socket", "epoch": "0", "k": "4"}},
        {"kind": "counter", "name": "resilience.coord_commits", "v": 1, "ts": 4.0,
         "shard": "p0"},
    ]
    lines = timeline.render(events)
    assert lines == jtimeline.render(events)
    assert len(lines) == 4
    assert "EXCHANGE" in lines[0] and "backend=socket" in lines[0]
    assert "ELECT" in lines[1] and "tag=cadence.e00000000" in lines[1]
    assert "AGREE" in lines[2] and "k=4" in lines[2]
    assert "COMMIT" in lines[3]


def test_fabric_counters_flow_through_trace(fabric, registry):
    obs.enable()
    try:
        a, b = fabric(0, 2, timeout_s=30), fabric(1, 2, timeout_s=30)
        run_ranks([lambda: a.allgather("tr", np.ones(1) * 0),
                   lambda: b.allgather("tr", np.ones(1) * 1)])
        fabric(0, 2).elect("tr-lead", 1)
    finally:
        obs.disable()
    backend = a.backend
    assert registry.counter("fabric.exchange", backend=backend, tag="tr").value >= 2
    assert registry.counter("fabric.elect", backend=backend, tag="tr-lead",
                            won="true").value == 1


# --------------------------------------------------------------------- #
# 7. Socket specifics
# --------------------------------------------------------------------- #
def test_daemon_counts_malformed_frames(registry):
    daemon = ExchangeDaemon().start()
    try:
        with _socket.create_connection((daemon.host, daemon.port), timeout=10) as s:
            s.sendall(b"NOPE" + b"\x00" * 12)
            try:
                assert s.recv(1) == b""
            except ConnectionResetError:
                pass
    finally:
        daemon.stop()
    assert registry.counter("fabric.malformed", kind="magic").value >= 1


def test_client_bounded_reconnect_then_transient(registry, monkeypatch):
    monkeypatch.setattr(SocketTransport, "BACKOFF_S", (0.001, 0.002))
    daemon = ExchangeDaemon().start()
    tr = SocketTransport(daemon.address, timeout_s=1)
    tr.put("x", b"1", overwrite=True)
    daemon.stop()
    tr.close()
    with pytest.raises(TransientSourceError, match="unreachable"):
        tr.get("x")
    assert registry.counter("fabric.reconnects").value >= SocketTransport.MAX_ATTEMPTS - 1


def test_wire_frames_are_the_jax_packages():
    from gelly_streaming_tpu.fabric import exchange as jx
    from gelly_streaming_tpu.fabric import wire as jwire
    from gelly_streaming_tpu_torch.fabric import exchange as px

    assert wire.pack_frame(wire.T_XREQ, b"abc") == jwire.pack_frame(jwire.T_XREQ, b"abc")
    req = px.pack_request("put", "w00000001.ids", overwrite=True, body=b"\x00\x01")
    assert req == jx.pack_request("put", "w00000001.ids", overwrite=True, body=b"\x00\x01")
    assert px.unpack_request(req) == jx.unpack_request(req)
    resp = px.pack_response(found=True, size=2, version=7, tags=("a", "b"), body=b"zz")
    assert resp == jx.pack_response(found=True, size=2, version=7, tags=("a", "b"), body=b"zz")
    assert tuple(px.unpack_response(resp)) == tuple(jx.unpack_response(resp))
    a, b = _socket.socketpair()
    try:
        a.sendall(b"GSRP" + bytes([9, 10]) + b"\x00" * 4)
        with pytest.raises(wire.MalformedFrame) as ei:
            wire.read_frame(b)
        assert ei.value.kind == "version"
    finally:
        a.close()
        b.close()


# --------------------------------------------------------------------- #
# 8. The collective backend comes with the mesh
# --------------------------------------------------------------------- #
def test_collective_transport_raises_naming_slice_6():
    with pytest.raises(NotImplementedError, match="slice 6"):
        CollectiveTransport()
    assert issubclass(CollectiveTransport, Transport)
    assert issubclass(TransportUnsupported, RuntimeError)


def test_fabric_cli_prints_usage_without_a_mode(capsys):
    from gelly_streaming_tpu_torch.fabric.__main__ import _check, main

    assert main([]) == 2
    assert "usage" in capsys.readouterr().err
    outs = [(0, '{"pid": %d, "gathered": [0, 1], "k": 11, "k_replay": 11, '
                '"peers": ["payload-0", "payload-1"]}' % p, "") for p in range(2)]
    assert _check("socket", outs, 2) == {"ok": True, "elected_k": 11, "processes": 2}
    with pytest.raises(SystemExit, match="disagreement"):
        _check("socket", [outs[0], (0, outs[1][1].replace('"k": 11', '"k": 10'), "")], 2)


# --------------------------------------------------------------------- #
# 9. The two packages on one store
# --------------------------------------------------------------------- #
@pytest.fixture(params=["shared_dir", "port_daemon", "jax_daemon"])
def mixed(request, tmp_path):
    """``(jax_rank, port_rank)`` makers over ONE store: a shared directory,
    or one exchange daemon of either package."""
    daemons, made = [], []
    if request.param == "shared_dir":
        def mk(pkg, pid, n, **kw):
            cls = jfab.SharedDirTransport if pkg == "jax" else SharedDirTransport
            return cls(str(tmp_path), pid, n, **kw)
    else:
        d = (ExchangeDaemon() if request.param == "port_daemon" else jfab.ExchangeDaemon()).start()
        daemons.append(d)

        def mk(pkg, pid, n, **kw):
            cls = jfab.SocketTransport if pkg == "jax" else SocketTransport
            t = cls(d.address, pid, n, **kw)
            made.append(t)
            return t
    yield mk
    for t in made:
        t.close()
    for d in daemons:
        # wake the accept loop first: the JAX package's stop() only closes
        # its listener, and a blocked accept() then waits out the join
        try:
            d._listener.shutdown(_socket.SHUT_RDWR)
        except OSError:
            pass
        d.stop()


def test_jax_and_port_ranks_gather_equal_arrays_and_agree_on_one_winner(mixed):
    j = mixed("jax", 0, 2, timeout_s=30)
    p = mixed("port", 1, 2, timeout_s=30)
    planes = [np.arange(8, dtype=np.int32).reshape(2, 4), (np.arange(8) - 3).astype(np.int32)
              .reshape(2, 4) * 1000]

    def rank(tr, pid):
        g = tr.allgather("w00000000.ids", planes[pid])
        k = tr.elect("cadence.e00000000", 10 + pid)
        tr.barrier("done")
        return g, k

    out = run_ranks([lambda: rank(j, 0), lambda: rank(p, 1)])
    for pid in (0, 1):
        g, _ = out[pid]
        assert [x.tolist() for x in g] == [x.tolist() for x in planes]
    assert out[0][1] == out[1][1] in (10, 11)
    # a replaying rank of either package re-reads the persisted winner
    assert mixed("port", 0, 2).elect("cadence.e00000000", 99) == out[0][1]
    assert mixed("jax", 1, 2).elect("cadence.e00000000", 98) == out[0][1]


def test_elected_k_of_both_packages_replays_the_same_winners(tmp_path):
    """The port's ``ElectedK`` over the JAX package's persisted elections
    (and the reverse) tiles exactly as the first incarnation did."""
    from gelly_streaming_tpu.control import AutoK as JAutoK
    from gelly_streaming_tpu_torch.control import AutoK

    jtr = jfab.SharedDirTransport(str(tmp_path))
    first = jfab.ElectedK(JAutoK(k0=3, k_max=8), jtr, every=4)
    ks = [first.current_k() for _ in range(6)]
    second = ElectedK(AutoK(k0=1, k_max=8), SharedDirTransport(str(tmp_path)), every=4)
    assert [second.current_k() for _ in range(6)] == ks
    third = jfab.ElectedK(JAutoK(k0=5, k_max=8), jtr, every=4)
    assert [third.current_k() for _ in range(6)] == ks


# --------------------------------------------------------------------- #
# 10. The elected K on the coordinated path (tests/test_control.py:582)
# --------------------------------------------------------------------- #
def _cc_stream(src, dst, window, bound):
    from gelly_streaming_tpu_torch.core.stream import SimpleEdgeStream
    from gelly_streaming_tpu_torch.core.window import CountWindow
    from gelly_streaming_tpu_torch.datasets import IdentityDict

    return SimpleEdgeStream((src, dst), window=CountWindow(window),
                            vertex_dict=IdentityDict(bound), device="cpu")


def test_coordinated_wires_cadence_agreement(tmp_path, tick_clock):
    """Coordinated runs wrap the work's AutoK in an ElectedK riding the
    checkpoint's own transport; the run stays value-identical to the
    pinned-K oracle and to the JAX package's run."""
    from gelly_streaming_tpu.library import ConnectedComponents as JCC
    from gelly_streaming_tpu_torch.library import ConnectedComponents
    from gelly_streaming_tpu_torch.resilience.coordinated import CoordinatedCheckpoint

    rng = np.random.default_rng(23)
    n = 1 << 13
    src = rng.integers(0, 1024, n)
    dst = rng.integers(0, 1024, n)
    base = [str(c) for c in ConnectedComponents(superbatch=1).run(_cc_stream(src, dst, 128,
                                                                             1024))]
    cc = CoordinatedCheckpoint(str(tmp_path), process_id=0, num_processes=1, every=4)
    agg = ConnectedComponents(superbatch="auto")
    got = [str(c) for c in cc.run(lambda vd: _cc_stream(src, dst, 128, 1024), agg)]
    assert got == base
    assert isinstance(agg.control.autok, ElectedK)
    assert cc.transport.list("cadence.e")

    from gelly_streaming_tpu.core.stream import SimpleEdgeStream as JStream
    from gelly_streaming_tpu.core.window import CountWindow as JCount
    from gelly_streaming_tpu.datasets import IdentityDict as JIdentity

    jbase = [str(c) for c in JCC(superbatch=1).run(
        JStream((src, dst), window=JCount(128), vertex_dict=JIdentity(1024)))]
    assert got == jbase


def test_elected_k_replays_persisted_winners(tmp_path):
    from gelly_streaming_tpu_torch.control import AutoK

    tr = SharedDirTransport(str(tmp_path))
    first = ElectedK(AutoK(k0=3, k_max=8), tr, every=4)
    ks = [first.current_k() for _ in range(6)]
    second = ElectedK(AutoK(k0=1, k_max=8), tr, every=4)
    assert [second.current_k() for _ in range(6)] == ks
