"""The port's resilience layer: checkpoint integrity, supervised recovery,
deterministic fault injection, resilient sources and the prefetch
watchdogs, on the CPU.

Every corrupt barrier falls back to the newest valid one with emissions
equal to an uninterrupted run; the ``Supervisor`` restarts after an
injected kill or a source disconnect with the consumer-visible sequence
unchanged, declares poison windows and spends a bounded restart budget;
the fault plan is deterministic; the socket source reconnects with
backoff and counts malformed lines; the prefetch producer's leak and
stall are reported. The headline path of ``chip_smoke.py`` phase 16 runs
here at a small size: a file stream with prefetch killed at
``pipeline.item`` under ``example/common.supervised_emissions``, then a
corrupt head barrier.

Mirrors ``tests/test_resilience.py:58-597`` (the serving cases and the
chaos sweep come with the serving slice).
"""

import hashlib
import os
import shutil
import socket
import threading
import warnings

import numpy as np
import pytest

import gelly_streaming_tpu_torch as gt
from gelly_streaming_tpu_torch import obs
from gelly_streaming_tpu_torch.aggregate.autockpt import AutoCheckpoint
from gelly_streaming_tpu_torch.library import ConnectedComponents
from gelly_streaming_tpu_torch.obs import flight
from gelly_streaming_tpu_torch.resilience import (
    CheckpointCorrupt,
    FaultPlan,
    PoisonWindowError,
    RestartBudgetExceeded,
    Supervisor,
    TransientSourceError,
    faults,
    integrity,
)
from gelly_streaming_tpu_torch.resilience.errors import StallError
from gelly_streaming_tpu_torch.resilience.faults import corrupt_file


@pytest.fixture
def registry():
    """An isolated obs registry: resilience counters without bleed."""
    reg = obs.set_registry(None)
    yield reg
    obs.set_registry(None)


def digest(emission) -> str:
    """Stable fingerprint of one per-window emission (the Components string
    form is canonical: sorted roots, sorted members)."""
    return hashlib.sha1(str(emission).encode()).hexdigest()[:16]


def _edges(n_windows=12, window=16, seed=321):
    rng = np.random.default_rng(seed)
    pairs = rng.integers(0, 50, size=(n_windows * window, 2))
    return [(int(a) * 3 + 5, int(b) * 3 + 5, 0.0) for a, b in pairs]


def _stream(raw, vd):
    return gt.SimpleEdgeStream(raw, window=gt.CountWindow(16), vertex_dict=vd, device="cpu")


def _cc_oracle(raw, ckpt, every=2, keep=3):
    ac = AutoCheckpoint(ckpt, every=every, keep=keep)
    return [digest(c) for c in ac.run(lambda vd: _stream(raw, vd), ConnectedComponents())]


# --------------------------------------------------------------------- #
# 1. the checksummed container
# --------------------------------------------------------------------- #
def test_checksummed_container_roundtrip_and_rejection():
    payload = b"x" * 1000
    data = integrity.wrap_checksummed(payload)
    assert integrity.unwrap_checksummed(data) == payload
    assert integrity.unwrap_checksummed(payload) == payload  # no magic: as is
    with pytest.raises(CheckpointCorrupt, match="truncated|promised"):
        integrity.unwrap_checksummed(data[: len(data) // 2])
    flipped = bytearray(data)
    flipped[-1] ^= 0xFF
    with pytest.raises(CheckpointCorrupt, match="checksum"):
        integrity.unwrap_checksummed(bytes(flipped))


def test_container_and_crc_equal_the_reference():
    from gelly_streaming_tpu.resilience import integrity as jint

    arrays = [np.arange(10, dtype=np.int32), np.ones(3, bool), np.zeros((2, 2), np.float32)]
    assert integrity.arrays_crc32(arrays) == jint.arrays_crc32(arrays)
    assert integrity.wrap_checksummed(b"payload") == jint.wrap_checksummed(b"payload")
    assert integrity.MAGIC == jint.MAGIC == b"GSCKPT1\n"


# --------------------------------------------------------------------- #
# 2. corrupt barriers: recovery uses the newest VALID one
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("target,mode,expect_resume,expect_rejected", [
    ("", "flip", 2, True),        # head torn -> previous barrier
    ("", "truncate", 2, True),
    (".1", "flip", 4, False),     # head valid -> rotation slot unread
    (".1", "truncate", 4, False),
])
def test_corrupt_barrier_falls_back_value_identical(
    tmp_path, registry, target, mode, expect_resume, expect_rejected
):
    raw = _edges()
    oracle = _cc_oracle(raw, str(tmp_path / "oracle.ckpt"))
    live = str(tmp_path / "live.ckpt")
    ac = AutoCheckpoint(live, every=2, keep=3)
    for i, _ in enumerate(ac.run(lambda vd: _stream(raw, vd), ConnectedComponents())):
        if i >= 4:  # barriers at 2 and 4
            break
    assert os.path.exists(live) and os.path.exists(live + ".1")

    d = tmp_path / f"case{target}_{mode}"
    d.mkdir()
    ckpt = str(d / "live.ckpt")
    shutil.copy(live, ckpt)
    shutil.copy(live + ".1", ckpt + ".1")
    corrupt_file(ckpt + target, mode, seed=11)

    before = registry.counter("resilience.ckpt_rejected").value
    ac2 = AutoCheckpoint(ckpt, every=2, keep=3)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        assert ac2.windows_done() == expect_resume
        outs = [digest(c) for c in ac2.run(lambda vd: _stream(raw, vd), ConnectedComponents())]
    assert outs == oracle[expect_resume:]
    rejected = registry.counter("resilience.ckpt_rejected").value - before
    assert (rejected >= 1) == expect_rejected


def test_fallback_tolerates_rotation_gap(tmp_path, registry):
    """A kill BETWEEN rotation renames leaves head + .2 with no .1; a
    corrupt head still falls back to .2."""
    raw = _edges()
    oracle = _cc_oracle(raw, str(tmp_path / "oracle.ckpt"))
    ckpt = str(tmp_path / "gap.ckpt")
    ac = AutoCheckpoint(ckpt, every=2, keep=3)
    for i, _ in enumerate(ac.run(lambda vd: _stream(raw, vd), ConnectedComponents())):
        if i >= 6:  # head=6, .1=4, .2=2
            break
    os.replace(ckpt + ".1", ckpt + ".2")
    corrupt_file(ckpt, "flip", seed=3)
    ac2 = AutoCheckpoint(ckpt, every=2, keep=3)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        assert ac2.windows_done() == 4
        outs = [digest(c) for c in ac2.run(lambda vd: _stream(raw, vd), ConnectedComponents())]
    assert outs == oracle[4:]


def test_corrupt_head_not_rotated_over_good_fallback(tmp_path, registry):
    """keep=2: a rejected head is UNLINKED at the next barrier, never
    rotated onto path.1 (the one good barrier)."""
    raw = _edges()
    ckpt = str(tmp_path / "h.ckpt")
    ac = AutoCheckpoint(ckpt, every=2, keep=2)
    for i, _ in enumerate(ac.run(lambda vd: _stream(raw, vd), ConnectedComponents())):
        if i >= 4:  # head=4, .1=2
            break
    corrupt_file(ckpt, "flip", seed=5)
    ac2 = AutoCheckpoint(ckpt, every=2, keep=2)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        assert ac2.windows_done() == 2
        run = ac2.run(lambda vd: _stream(raw, vd), ConnectedComponents())
        for i, _ in enumerate(run):
            if i >= 4:  # past the first NEW barrier (w=4)
                break
        run.close()
    probe = AutoCheckpoint(ckpt, every=2, keep=2)
    assert probe._read_barrier(ckpt) is not None
    assert probe._read_barrier(ckpt + ".1") is not None


def test_fault_plan_corrupts_the_barrier_it_names(tmp_path, registry):
    """The ``checkpoint.committed`` site: the plan damages barrier 4 as it
    commits; a later reader falls back past it and counts the rejection."""
    raw = _edges(n_windows=5)
    ckpt = str(tmp_path / "f.ckpt")
    with faults.injected(FaultPlan(corrupt_at_barrier=4)):
        list(AutoCheckpoint(ckpt, every=2, keep=3).run(lambda vd: _stream(raw, vd),
                                                       ConnectedComponents()))
    assert registry.counter("resilience.fault_injected", site="checkpoint.committed").value == 1
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        assert AutoCheckpoint(ckpt, keep=3).windows_done() == 2
    assert registry.counter("resilience.ckpt_rejected").value == 1


# --------------------------------------------------------------------- #
# 3. the Supervisor: restart + dedupe, poison windows, restart budget
# --------------------------------------------------------------------- #
def test_supervisor_recovers_from_injected_kill(tmp_path, registry):
    """A SimulatedCrash between windows restarts from the barrier; the
    consumer-visible sequence equals the uninterrupted oracle exactly."""
    raw = _edges()
    oracle = _cc_oracle(raw, str(tmp_path / "oracle.ckpt"))

    def make_stream(vd):
        s = _stream(raw, vd)
        orig = s._block_source

        def wrapped():
            for i, b in enumerate(orig()):
                yield b
                if faults.active():  # fires BETWEEN windows, like a kill
                    faults.fire("chaos.window", index=i)

        s._block_source = wrapped
        return s

    sup = Supervisor(AutoCheckpoint(str(tmp_path / "sup.ckpt"), every=2, keep=3),
                     backoff_base_s=0.0, jitter=0.0)
    # the kill fires when window 7 is pulled (index 6, one past the
    # window-6 barrier): the restart REPLAYS window 6 and must dedupe it
    with faults.injected(FaultPlan(kill_at_window=6)):
        outs = [digest(c) for c in sup.run(make_stream, ConnectedComponents)]
    assert outs == oracle
    assert sup.restarts == 1
    assert registry.counter("resilience.restarts", kind="transient").value == 1
    assert registry.counter("resilience.deduped_windows").value >= 1
    assert registry.histogram("resilience.recovery_seconds").count == 1


def test_supervisor_recovers_from_source_disconnect(tmp_path, registry):
    raw = _edges()
    oracle = _cc_oracle(raw, str(tmp_path / "oracle.ckpt"))

    def source():
        for i, e in enumerate(raw):
            if faults.active():
                faults.fire("source.record", index=i)
            yield e

    sup = Supervisor(AutoCheckpoint(str(tmp_path / "sup.ckpt"), every=2, keep=3),
                     backoff_base_s=0.0, jitter=0.0)
    with faults.injected(FaultPlan(disconnect_at_record=70)):
        outs = [digest(c) for c in sup.run(lambda vd: _stream(source(), vd),
                                           ConnectedComponents)]
    assert outs == oracle
    assert sup.restarts == 1


class _Fragile:
    """A minimal checkpointable workload that fails at a fixed window."""

    def __init__(self, fail_at, exc_factory):
        self.fail_at = fail_at
        self.exc_factory = exc_factory

    def state_dict(self):
        return {}

    def load_state_dict(self, state):
        pass

    def run(self, stream):
        for i, _ in enumerate(stream.blocks()):
            if i == self.fail_at:
                raise self.exc_factory()
            yield i


def test_supervisor_declares_poison_window(tmp_path, registry):
    raw = _edges(n_windows=6)
    sup = Supervisor(AutoCheckpoint(str(tmp_path / "p.ckpt"), every=100),
                     poison_limit=2, backoff_base_s=0.0, jitter=0.0)
    with pytest.raises(PoisonWindowError) as ei:
        list(sup.run(lambda vd: _stream(raw, vd),
                     lambda: _Fragile(3, lambda: ValueError("bad data"))))
    assert ei.value.ordinal == 3
    assert isinstance(ei.value.__cause__, ValueError)
    assert registry.counter("resilience.poison_windows").value == 1
    assert sup.restarts == 1


def test_supervisor_transient_flaps_do_not_poison(tmp_path, registry):
    raw = _edges(n_windows=6)
    calls = {"n": 0}

    def exc_factory():
        calls["n"] += 1
        if calls["n"] <= 2:
            return TransientSourceError("flap")
        return ValueError("bad data")

    sup = Supervisor(AutoCheckpoint(str(tmp_path / "m.ckpt"), every=100),
                     poison_limit=2, max_restarts=10, backoff_base_s=0.0, jitter=0.0)
    with pytest.raises(PoisonWindowError):
        list(sup.run(lambda vd: _stream(raw, vd), lambda: _Fragile(2, exc_factory)))
    # transient, transient, window (count 1), window (count 2 -> poison)
    assert calls["n"] == 4
    assert sup.restarts == 3


def test_supervisor_restart_budget(tmp_path):
    raw = _edges(n_windows=4)
    sup = Supervisor(AutoCheckpoint(str(tmp_path / "b.ckpt"), every=100),
                     max_restarts=2, backoff_base_s=0.0, jitter=0.0)
    with pytest.raises(RestartBudgetExceeded) as ei:
        list(sup.run(lambda vd: _stream(raw, vd),
                     lambda: _Fragile(1, lambda: TransientSourceError("down"))))
    assert isinstance(ei.value.__cause__, TransientSourceError)
    assert sup.restarts == 2


def test_supervisor_backoff_is_bounded_and_deterministic(tmp_path, registry):
    """The delays between restarts follow ``exp_backoff`` with the seeded
    jitter, slept through the injected ``sleep``."""
    from gelly_streaming_tpu_torch.resilience import exp_backoff, jittered

    slept = []
    sup = Supervisor(AutoCheckpoint(str(tmp_path / "k.ckpt"), every=100), max_restarts=3,
                     backoff_base_s=0.1, backoff_max_s=0.25, jitter=0.5, seed=4,
                     sleep=slept.append)
    with pytest.raises(RestartBudgetExceeded):
        list(sup.run(lambda vd: _stream(_edges(n_windows=2), vd),
                     lambda: _Fragile(0, lambda: TransientSourceError("down"))))
    assert slept == [jittered(exp_backoff(i, 0.1, 0.25), 0.5, 4, i) for i in range(3)]
    assert all(0.1 <= d <= 0.25 * 1.5 for d in slept)


def test_supervisor_failure_dumps_the_flight_recorder(tmp_path, registry):
    """Every failure commits the installed black box before the restart
    decision; the dump reads back as a checksummed container."""
    raw = _edges(n_windows=4)
    rec = flight.install(flight.FlightRecorder(str(tmp_path / "flight.json")))
    obs.enable()
    try:
        sup = Supervisor(AutoCheckpoint(str(tmp_path / "fl.ckpt"), every=100),
                         max_restarts=1, backoff_base_s=0.0, jitter=0.0)
        with pytest.raises(RestartBudgetExceeded, match="flight dump"):
            list(sup.run(lambda vd: _stream(raw, vd),
                         lambda: _Fragile(1, lambda: TransientSourceError("down"))))
    finally:
        obs.disable()
        flight.uninstall()
    assert rec is not None and registry.counter("resilience.flight_dumps").value == 2
    first = flight.read_dump(str(tmp_path / "flight.json"))
    assert first["reason"] == "supervisor:transient" and first["attrs"]["ordinal"] == 1
    # the second failure's dump (its own file) holds the first restart
    second = flight.read_dump(str(tmp_path / "flight.json.2"))
    assert any(e.get("name") == "resilience.restarts" for e in second["events"])


# --------------------------------------------------------------------- #
# 4. the headline path: prefetched file stream, pipeline.item kill
# --------------------------------------------------------------------- #
def test_pipeline_item_kill_then_corrupt_head(tmp_path, registry):
    """``chip_smoke.py`` phase 16 (a)-(b) at a small size: a text file
    through ``stream_file`` with ``prefetch_depth=2`` into streaming CC
    under ``supervised_emissions(every=4, keep=3)``, killed as item 9 is
    taken: one restart, a resume from barrier 8, the replayed window
    deduped, the last window equal to an uninterrupted run. Then a flipped
    head barrier: a fresh checkpoint resumes from the rotated barrier 12
    with one rejection and the same labels."""
    from gelly_streaming_tpu_torch import datasets
    from gelly_streaming_tpu_torch.example.common import supervised_emissions

    rng = np.random.default_rng(8)
    src, dst = rng.integers(0, 512, 16 * 64), rng.integers(0, 512, 16 * 64)
    path = tmp_path / "g.txt"
    path.write_text("".join(f"{a} {b}\n" for a, b in zip(src.tolist(), dst.tolist())))

    def make_stream(vd):
        return datasets.stream_file(
            str(path), window=gt.CountWindow(64),
            vertex_dict=vd if vd is not None else datasets.IdentityDict(512),
            prefetch_depth=2, device="cpu")

    want = None
    for want in make_stream(None).aggregate(ConnectedComponents(carry="forest")):
        pass
    want = want.labels()
    ckpt = str(tmp_path / "ck" / "cc.ckpt")
    with faults.injected(FaultPlan(kill_at_window=9, kill_site="pipeline.item")):
        emissions, ac = supervised_emissions(ckpt, 4, make_stream,
                                             ConnectedComponents(carry="forest"), keep=3)
        seen = [c.labels() for c in emissions]
    assert len(seen) == 16
    assert registry.counter("resilience.restarts", kind="transient").value == 1
    # emitted 0..8, the kill as item 9 is taken, the resume at barrier 8
    # replays window 8 once
    assert registry.counter("resilience.deduped_windows").value == 1
    for a, b in zip(seen[-1], want):
        np.testing.assert_array_equal(a, b)
    assert [AutoCheckpoint(p)._read_barrier(p)["windows_done"]
            for p in (ckpt, ckpt + ".1", ckpt + ".2")] == [16, 12, 8]

    corrupt_file(ckpt, "flip")
    fresh = AutoCheckpoint(ckpt, every=4, keep=3)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        assert fresh.windows_done() == 12
        last = None
        for last in fresh.run(make_stream, ConnectedComponents(carry="forest")):
            pass
    assert registry.counter("resilience.ckpt_rejected").value == 1
    for a, b in zip(last.labels(), want):
        np.testing.assert_array_equal(a, b)


# --------------------------------------------------------------------- #
# 5. fault plan determinism, sources
# --------------------------------------------------------------------- #
def test_fault_plan_record_perturbation_deterministic():
    def run():
        plan = FaultPlan(drop_records=(1,), duplicate_records=(3,), swap_records=(5,))
        return list(plan.perturb_records(iter(range(8))))

    out = run()
    assert out == [0, 2, 3, 3, 4, 6, 5, 7]
    assert out == run()
    plan = FaultPlan(drop_records=(1,))
    assert list(plan.perturb_records(iter([0, None, 1, None, 2]))) == [0, None, None, 2]


def test_fault_plan_equals_the_reference():
    """The same plan perturbs the same records in both packages."""
    from gelly_streaming_tpu.resilience import FaultPlan as JaxPlan

    kw = dict(seed=3, drop_records=(2, 9), duplicate_records=(4,), swap_records=(6,),
              skew_records=(1, 7), skew_ts_s=5)
    recs = [(i, i + 1, 0.0, 100 + i) for i in range(12)]
    assert list(FaultPlan(**kw).perturb_records(iter(recs))) == list(
        JaxPlan(**kw).perturb_records(iter(recs)))


def test_generator_source_honors_fault_plan():
    from gelly_streaming_tpu_torch.core.sources import GeneratorSource

    def run():
        with faults.injected(FaultPlan(drop_records=(2,), duplicate_records=(5,))):
            return list(GeneratorSource(scale=8, chunk=4, limit=8))

    a, b = run(), run()
    assert a == b
    assert len(a) == 8  # one dropped, one duplicated
    plain = list(GeneratorSource(scale=8, chunk=4, limit=8))
    assert a != plain and set(a) <= set(plain)


def test_generator_source_feeds_a_stream_like_the_reference():
    """Both sources feed ``SimpleEdgeStream``: the generator's chunk path
    gives the JAX package's components."""
    import gelly_streaming_tpu as gj
    from gelly_streaming_tpu.core.sources import GeneratorSource as JaxGen
    from gelly_streaming_tpu.library import ConnectedComponents as JaxCC
    from gelly_streaming_tpu_torch.core.sources import GeneratorSource

    last = jlast = None
    for last in gt.SimpleEdgeStream(GeneratorSource(scale=9, chunk=100, limit=700),
                                    window=gt.CountWindow(256), device="cpu").aggregate(
            ConnectedComponents()):
        pass
    for jlast in gj.SimpleEdgeStream(JaxGen(scale=9, chunk=100, limit=700),
                                     window=gj.CountWindow(256)).aggregate(JaxCC()):
        pass
    assert str(last) == str(jlast)


def test_event_time_records_name_their_slice():
    from gelly_streaming_tpu_torch.core.sources import GeneratorSource, SocketEdgeSource

    with pytest.raises(NotImplementedError, match="slice 8"):
        GeneratorSource(ts_rate=4)
    with pytest.raises(NotImplementedError, match="slice 8"):
        SocketEdgeSource("127.0.0.1", 1, ts_extractor=lambda s, d, v: int(v))


def _serve(payload, times):
    srv = socket.create_server(("127.0.0.1", 0))
    port = srv.getsockname()[1]

    def serve():
        for _ in range(times):
            conn, _ = srv.accept()
            try:
                conn.sendall(payload)
            except OSError:
                pass
            finally:
                conn.close()
        srv.close()

    t = threading.Thread(target=serve, daemon=True)
    t.start()
    return port, t


def test_socket_source_reconnects_and_counts_malformed(registry):
    from gelly_streaming_tpu_torch.core.sources import SocketEdgeSource

    edges = [(i, i + 1) for i in range(20)]
    payload = (
        "# comment\n"
        + "not-an-edge\n"          # malformed: one field
        + "".join(f"{s}\t{d}\n" for s, d in edges)
        + "1 2 notaweight-ok\n"    # fine unweighted (extra field unread)
        + "x y\n"                  # malformed: non-integer ids
    ).encode()
    port, t = _serve(payload, 2)  # the reconnect gets a second serve
    src = SocketEdgeSource("127.0.0.1", port, tick_s=0.02, reconnect=4, reconnect_base_s=0.01)
    with faults.injected(FaultPlan(disconnect_at_record=5)):
        got = [r for r in src if r is not None]
    t.join(10)
    assert not t.is_alive()
    # at-least-once across the reconnect: every edge arrives, none invented
    assert {(s, d) for s, d, _ in got} == set(edges) | {(1, 2)}
    assert len(got) >= len(edges)
    assert registry.counter("source.reconnects").value >= 1
    # conn 1 parses one malformed line before the record-5 disconnect
    # discards its remainder; conn 2 serves both; comments never count
    assert registry.counter("source.malformed_lines").value == 3


def test_socket_source_feeds_a_stream(registry):
    """The chunk-parse path (no fault plan) into CC: the components of the
    served edges."""
    from gelly_streaming_tpu_torch.core.sources import SocketEdgeSource

    payload = "".join(f"{k} {k + 2}\n" for k in range(1, 41)).encode()
    port, t = _serve(payload, 1)
    last = None
    for last in _stream(SocketEdgeSource("127.0.0.1", port, tick_s=0.02, reconnect=0),
                        None).aggregate(ConnectedComponents()):
        pass
    t.join(10)
    assert sorted(len(c) for c in last.component_sets()) == [21, 21]
    assert registry.counter("source.malformed_lines").value == 0


def test_socket_source_exhausted_reconnect_raises(registry):
    from gelly_streaming_tpu_torch.core.sources import SocketEdgeSource

    srv = socket.create_server(("127.0.0.1", 0))  # nothing listens after close
    port = srv.getsockname()[1]
    srv.close()
    src = SocketEdgeSource("127.0.0.1", port, reconnect=2, reconnect_base_s=0.01)
    with pytest.raises(TransientSourceError):
        list(src)
    assert registry.counter("source.reconnects").value == 3


# --------------------------------------------------------------------- #
# 6. prefetch: producer-leak warning, stall watchdog
# --------------------------------------------------------------------- #
def test_prefetch_producer_leak_warns_and_counts(registry):
    from gelly_streaming_tpu_torch.core.pipeline import prefetch

    release = threading.Event()

    def wedged():
        yield 1
        release.wait(30)  # ignores the stop flag: a wedged producer
        yield 2

    it = prefetch(wedged(), depth=1, join_timeout_s=0.2)
    assert next(it) == 1
    with pytest.warns(RuntimeWarning, match="producer thread did not"):
        it.close()
    assert registry.counter("pipeline.producer_leaked").value == 1
    release.set()


def test_prefetch_stall_watchdog_raises(registry):
    from gelly_streaming_tpu_torch.core.pipeline import prefetch

    release = threading.Event()

    def stalled():
        yield 1  # the first item's gap is exempt
        release.wait(30)
        yield 2

    it = prefetch(stalled(), depth=1, stall_timeout_s=0.15, join_timeout_s=0.1)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        assert next(it) == 1
        with pytest.raises(StallError, match="alive"):
            next(it)
        it.close()
    assert registry.counter("pipeline.stalls").value == 1
    release.set()
