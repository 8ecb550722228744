"""``AutoCheckpoint`` of the port: kill and resume, atomic commit, rotation,
the auto cadence, and barriers that cross the packages.

A process killed between barriers restarts from the last one and ends
with the final state of an uninterrupted run (the worker at the bottom of
this file runs in a subprocess on the CPU and dies by ``os._exit``). The
``every="auto"`` cases run on a stub clock: the barrier and window costs
are what the test makes them, never slept. A barrier written by the JAX
package at window 4 resumes in the port to the JAX package's final result,
and the reverse; a restricted unpickler that admits only numpy and
builtins loads every kind of barrier the port writes.

Mirrors ``tests/test_autockpt.py`` (and ``tests/_ckpt_worker.py``).
"""

import json
import os
import pickle
import subprocess
import sys

import numpy as np

WINDOW = 16
N_EDGES = 160


def _worker_edges():
    """A fixed stream with SPARSE raw ids (the vertex-dict replay must give
    the same compact ids after a restart)."""
    rng = np.random.default_rng(1234)
    pairs = rng.integers(0, 40, size=(N_EDGES, 2))
    return [(int(a) * 3 + 11, int(b) * 3 + 11, 0.0) for a, b in pairs]


def _worker(kind, ckpt_path, out_path, kill_after):
    """Run ``kind`` under AutoCheckpoint(every=2) on the CPU. With
    ``kill_after >= 0`` die hard after that many windows; with -1 run to
    the end and write the final state (and the barrier resumed from)."""
    from gelly_streaming_tpu_torch import CountWindow, SimpleEdgeStream
    from gelly_streaming_tpu_torch.aggregate.autockpt import AutoCheckpoint

    raw = _worker_edges()

    def make_stream(vdict):
        return SimpleEdgeStream(raw, window=CountWindow(WINDOW), vertex_dict=vdict,
                                device="cpu")

    ac = AutoCheckpoint(ckpt_path, every=2)
    resumed_from = ac.windows_done()
    if kind == "triangles":
        from gelly_streaming_tpu_torch.library import ExactTriangleCount

        work = ExactTriangleCount()
    else:
        from gelly_streaming_tpu_torch.library import ConnectedComponents

        # "cc": the auto carry (host on the CPU); "cc_forest": the card's
        work = ConnectedComponents(carry="forest" if kind == "cc_forest" else "auto")
    n = 0
    last = None
    for last in ac.run(make_stream, work):
        if kind == "triangles":
            list(last)  # materialize the change-only emission
        n += 1
        if 0 <= kill_after <= n:
            os._exit(17)
    if kind == "triangles":
        state = work.state_dict()
        final = {"total": state["total"],
                 "counts": [[int(i), int(c)] for i, c in enumerate(state["counts"]) if c]}
    else:
        final = {"components": str(last)}
    final["resumed_from"] = resumed_from
    with open(out_path, "w") as f:
        json.dump(final, f)


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    _worker(sys.argv[1], sys.argv[2], sys.argv[3], int(sys.argv[4]))
    sys.exit(0)

import pytest  # noqa: E402

import gelly_streaming_tpu_torch as gt  # noqa: E402
from gelly_streaming_tpu_torch.aggregate import autockpt  # noqa: E402
from gelly_streaming_tpu_torch.aggregate.autockpt import AutoCheckpoint  # noqa: E402


def _run_worker(kind, ckpt, out, kill_after, timeout=240):
    return subprocess.run(
        [sys.executable, os.path.abspath(__file__), kind, ckpt, out, str(kill_after)],
        capture_output=True, text=True, timeout=timeout,
    )


@pytest.mark.parametrize("kind", ["triangles", "cc", "cc_forest"])
def test_kill_and_resume_matches_uninterrupted(tmp_path, kind):
    """The uninterrupted run here in-process; the killed run and the
    restarted PROCESS in subprocesses (two a kind)."""
    ref_out = str(tmp_path / "ref.json")
    _worker(kind, str(tmp_path / "ref.ckpt"), ref_out, -1)

    kr_ckpt = str(tmp_path / "kr.ckpt")
    kr_out = str(tmp_path / "kr.json")
    r = _run_worker(kind, kr_ckpt, kr_out, 5)  # barriers land every 2
    assert r.returncode == 17, (r.returncode, r.stderr[-2000:])
    assert not os.path.exists(kr_out), "a killed run must not write output"
    assert os.path.exists(kr_ckpt), "a barrier must have committed"
    r = _run_worker(kind, kr_ckpt, kr_out, -1)
    assert r.returncode == 0, r.stderr[-2000:]

    with open(ref_out) as f:
        ref = json.load(f)
    with open(kr_out) as f:
        resumed = json.load(f)
    assert resumed.pop("resumed_from") == 4, "the resume must start from barrier 4"
    assert ref.pop("resumed_from") == 0
    assert resumed == ref, "the resumed final state diverged from the uninterrupted one"


def test_snapshot_commit_is_atomic(tmp_path):
    """A temp file left by a mid-write crash never shadows the committed
    barrier."""
    path = str(tmp_path / "c.ckpt")
    ac = AutoCheckpoint(path, every=1)

    class W:
        def state_dict(self):
            return {"x": 1}

    ac._snapshot(W(), None, windows_done=3)
    with open(path + ".tmp", "wb") as f:
        f.write(b"partial garbage")
    assert ac.windows_done() == 3


def test_rotation_keeps_last_n_and_discard(tmp_path):
    raw = _worker_edges()
    path = str(tmp_path / "r.ckpt")
    sibling = str(tmp_path / "r.ckpt0")
    open(sibling, "w").close()
    ac = AutoCheckpoint(path, every=2, keep=3)
    list(ac.run(lambda vd: gt.SimpleEdgeStream(raw, window=gt.CountWindow(WINDOW),
                                               vertex_dict=vd, device="cpu"),
                _cc()))
    # 10 windows: barriers at 2, 4, 6, 8, 10 -> head=10, .1=8, .2=6
    assert [AutoCheckpoint(p)._read_barrier(p)["windows_done"]
            for p in (path, path + ".1", path + ".2")] == [10, 8, 6]
    assert not os.path.exists(path + ".3")
    ac.discard()
    assert not any(os.path.exists(p) for p in (path, path + ".1", path + ".2"))
    assert os.path.exists(sibling), "a prefix-sharing sibling is not this checkpoint's"
    assert AutoCheckpoint(path).windows_done() == 0


def _cc(carry="auto"):
    from gelly_streaming_tpu_torch.library import ConnectedComponents

    return ConnectedComponents(carry=carry)


def test_device_spanner_resume(tmp_path):
    """Interrupt a DeviceSpanner after a barrier, restore into a FRESH
    instance, finish: the final spanner keeps every pre-crash acceptance
    and is a valid 2-spanner of the whole stream."""
    from gelly_streaming_tpu_torch.library import DeviceSpanner
    from tests.test_device_spanner import assert_valid_spanner

    rng = np.random.default_rng(77)
    raw = [(int(a) * 5 + 2, int(b) * 5 + 2, 0.0) for a, b in rng.integers(0, 25, size=(96, 2))]
    path = str(tmp_path / "sp.ckpt")

    def make_stream(vd):
        return gt.SimpleEdgeStream(raw, window=gt.CountWindow(8), vertex_dict=vd, device="cpu")

    sp1 = DeviceSpanner(k=2)
    for i, _ in enumerate(AutoCheckpoint(path, every=3).run(make_stream, sp1)):
        if i >= 6:  # crash after the window-6 barrier committed
            break
    mid_edges = sp1.edges()
    sp2 = DeviceSpanner(k=2)
    ac2 = AutoCheckpoint(path, every=3)
    assert ac2.windows_done() == 6
    for _ in ac2.run(make_stream, sp2):
        pass
    final = sp2.edges()
    assert mid_edges and set(mid_edges) <= set(final)
    assert AutoCheckpoint(path, every=3).windows_done() == 12
    assert_valid_spanner([(s, d) for s, d, _ in raw], final, 2)


# --------------------------------------------------------------------- #
# every="auto", on a stub clock and on fed signals
# --------------------------------------------------------------------- #
class _StubClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


class _TunableWork:
    """A checkpointable workload whose barrier and window costs advance the
    stub clock by fixed amounts."""

    def __init__(self, clock, barrier_s=0.0, window_s=0.0, granularity=1):
        self.clock = clock
        self.barrier_s = barrier_s
        self.window_s = window_s
        self.granularity = granularity

    def checkpoint_granularity(self):
        return self.granularity

    def state_dict(self):
        self.clock.t += self.barrier_s
        return {"x": 1}

    def load_state_dict(self, state):
        pass

    def run(self, stream):
        for i, _ in enumerate(stream.blocks()):
            self.clock.t += self.window_s
            yield i


def _auto_stream_factory(n_windows=40, window=4):
    rng = np.random.default_rng(11)
    raw = [(int(a), int(b), 0.0) for a, b in rng.integers(0, 30, size=(n_windows * window, 2))]

    def make_stream(vd):
        return gt.SimpleEdgeStream(raw, window=gt.CountWindow(window), vertex_dict=vd,
                                   device="cpu")

    return make_stream


def _formula(ac, k=1):
    import math

    want = math.ceil(ac.measured_barrier_s / (ac.target_overhead * ac.measured_window_s))
    want = max(ac.AUTO_MIN_EVERY, want, k)
    return min(want + (-want) % k, ac.AUTO_MAX_EVERY)


@pytest.fixture
def clock(monkeypatch):
    c = _StubClock()
    monkeypatch.setattr(autockpt, "_clock", c)
    return c


def test_auto_every_widens_under_expensive_barriers(tmp_path, clock):
    """Barriers 10x a window: the cadence stretches until barrier time is
    at the 5 % target (0.05 / (0.05 * 0.005) = 200 windows)."""
    ac = AutoCheckpoint(str(tmp_path / "a.ckpt"), every="auto")
    list(ac.run(_auto_stream_factory(), _TunableWork(clock, barrier_s=0.05, window_s=0.005)))
    assert ac.measured_barrier_s == pytest.approx(0.05)
    assert ac.measured_window_s == pytest.approx(0.005)
    assert ac.every == _formula(ac) and 199 <= ac.every <= 201
    # the initial-cadence barrier committed a resumable state
    assert AutoCheckpoint(str(tmp_path / "a.ckpt")).windows_done() == 2


def test_auto_every_stays_tight_for_cheap_barriers(tmp_path, clock):
    ac = AutoCheckpoint(str(tmp_path / "b.ckpt"), every="auto")
    list(ac.run(_auto_stream_factory(n_windows=12),
                _TunableWork(clock, barrier_s=0.001, window_s=0.01)))
    assert ac.every == _formula(ac) and ac.every <= 3
    assert AutoCheckpoint(str(tmp_path / "b.ckpt")).windows_done() >= 10


def test_auto_every_aligns_to_superbatch_granularity(tmp_path, clock):
    ac = AutoCheckpoint(str(tmp_path / "c.ckpt"), every="auto")
    list(ac.run(_auto_stream_factory(n_windows=30),
                _TunableWork(clock, barrier_s=0.004, window_s=0.002, granularity=3)))
    assert ac.every % 3 == 0 and ac.every == _formula(ac, 3)


def test_auto_retune_from_fed_signals(tmp_path):
    """The tuner reads the SignalReader taps: fed values, no run."""
    ac = AutoCheckpoint(str(tmp_path / "d.ckpt"), every="auto")
    ac.signals.observe("checkpoint.barrier_s", 0.25)
    ac._retune(0.01, 1)  # 0.25 / (0.05 * 0.01) = 500
    assert ac.every == 500 and ac.measured_window_s == 0.01
    ac._retune(0.01, 7)  # rounded up to a group multiple
    assert ac.every == 504
    ac.signals.observe("checkpoint.barrier_s", 1e3)
    ac._retune(0.01, 7)  # clamped under the ceiling, still aligned
    assert ac.every == AutoCheckpoint.AUTO_MAX_EVERY - AutoCheckpoint.AUTO_MAX_EVERY % 7
    ac.signals.observe("checkpoint.barrier_s", 0.0)
    ac._retune(0.01, 1)  # a free barrier leaves the cadence where it is
    assert ac.every == AutoCheckpoint.AUTO_MAX_EVERY - AutoCheckpoint.AUTO_MAX_EVERY % 7


def test_auto_every_resumes_like_fixed(tmp_path, clock):
    """An interrupted auto-cadence run restores from its last barrier under
    the Supervisor; the emissions cover the stream exactly once."""
    from gelly_streaming_tpu_torch.resilience import Supervisor
    from gelly_streaming_tpu_torch.resilience.errors import SimulatedCrash

    class _CrashOnce:
        def __init__(self):
            self.n = 0
            self.crashed = False

        def state_dict(self):
            return {"n": self.n}

        def load_state_dict(self, state):
            self.n = state["n"]

        def run(self, stream):
            for _ in stream.blocks():
                clock.t += 0.01
                if self.n == 13 and not self.crashed:
                    self.crashed = True
                    raise SimulatedCrash("boom")
                out = self.n
                self.n += 1
                yield out

    crasher = _CrashOnce()
    sup = Supervisor(AutoCheckpoint(str(tmp_path / "e.ckpt"), every="auto"),
                     backoff_base_s=0.0, jitter=0.0)
    assert list(sup.run(_auto_stream_factory(n_windows=20), crasher)) == list(range(20))
    assert sup.restarts == 1


# --------------------------------------------------------------------- #
# barriers across the packages
# --------------------------------------------------------------------- #
def _pkg_stream(pkg, kind_of_dict):
    """``make_stream(vdict)`` over the same edges for either package, with
    a host VertexDict (sparse ids) or an IdentityDict."""
    import gelly_streaming_tpu as gj
    from gelly_streaming_tpu import datasets as jd
    from gelly_streaming_tpu_torch import datasets as td

    raw = _worker_edges()
    mod = gj if pkg == "jax" else gt
    ident = jd.IdentityDict if pkg == "jax" else td.IdentityDict
    kw = {} if pkg == "jax" else {"device": "cpu"}

    def make_stream(vdict):
        if vdict is None and kind_of_dict == "identity":
            vdict = ident(1 << 8)
        return mod.SimpleEdgeStream(raw, window=mod.CountWindow(WINDOW), vertex_dict=vdict, **kw)

    return make_stream


def _pkg_cc(pkg):
    if pkg == "jax":
        from gelly_streaming_tpu import library as lib
    else:
        from gelly_streaming_tpu_torch import library as lib
    return lib.ConnectedComponents(carry="forest")


def _pkg_ckpt(pkg):
    if pkg == "jax":
        from gelly_streaming_tpu.aggregate.autockpt import AutoCheckpoint as A
        return A
    return AutoCheckpoint


def _last(emissions, read=False):
    """The last of a run's emissions (``read``: list each one as it comes,
    as a lazy change-only batch must be)."""
    last = None
    for last in emissions:
        if read:
            list(last)
    return last


@pytest.mark.parametrize("writer,reader", [("jax", "torch"), ("torch", "jax")])
@pytest.mark.parametrize("vdict_kind", ["vertexdict", "identity"])
def test_barrier_resumes_across_packages(tmp_path, writer, reader, vdict_kind):
    """CC's barrier from the writer at window 4 (it stops after window 5);
    the reader resumes there and ends with the labels of the writer's
    uninterrupted run. The workload kind's ``state_dict`` pickles cross in
    ``tests/test_torch_checkpoint.py``."""
    want = str(_last(_pkg_stream(writer, vdict_kind)(None).aggregate(_pkg_cc(writer))))
    path = str(tmp_path / "x.ckpt")
    run = _pkg_ckpt(writer)(path, every=4).run(_pkg_stream(writer, vdict_kind), _pkg_cc(writer))
    for i, _ in enumerate(run):
        if i >= 4:
            break
    run.close()
    ac = _pkg_ckpt(reader)(path, every=4)
    assert ac.windows_done() == 4
    assert str(_last(ac.run(_pkg_stream(reader, vdict_kind), _pkg_cc(reader)))) == want


class _NumpyOnly(pickle.Unpickler):
    """Admits numpy and builtins, nothing else."""

    def find_class(self, module, name):
        if module == "builtins" or module == "numpy" or module.startswith("numpy."):
            return super().find_class(module, name)
        raise pickle.UnpicklingError(f"barrier pickles {module}.{name}")


def _restricted_load(path):
    import io

    from gelly_streaming_tpu_torch.resilience import integrity

    with open(path, "rb") as f:
        data = integrity.unwrap_checksummed(f.read())
    return _NumpyOnly(io.BytesIO(data)).load()


def test_every_port_barrier_holds_numpy_and_builtins_only(tmp_path):
    """Each kind of barrier the port writes — aggregations (CC forest, host
    and dense carries, bipartiteness) and workloads (exact triangles,
    PageRank, the device spanner, degrees, the sampler) with a host
    VertexDict or an IdentityDict — loads through a numpy-and-builtins
    unpickler."""
    from gelly_streaming_tpu_torch import library as lib
    from gelly_streaming_tpu_torch.datasets import IdentityDict

    def stream(vd):
        return gt.SimpleEdgeStream(_worker_edges(), window=gt.CountWindow(WINDOW),
                                   vertex_dict=vd, device="cpu")

    works = {
        "cc_forest": (lib.ConnectedComponents(carry="forest"), None),
        "cc_host": (lib.ConnectedComponents(carry="host"), None),
        "cc_dense": (lib.ConnectedComponents(carry="dense"), None),
        "bip": (lib.BipartitenessCheck(), None),
        "triangles": (lib.ExactTriangleCount(), None),
        "pagerank": (lib.IncrementalPageRank(), None),
        "spanner": (lib.DeviceSpanner(k=2), None),
        "cc_identity": (lib.ConnectedComponents(), IdentityDict(1 << 8)),
    }
    for name, (work, vd) in works.items():
        path = str(tmp_path / f"{name}.ckpt")
        ac = AutoCheckpoint(path, every=2)
        _last(ac.run(lambda v, vd=vd: stream(v if v is not None else vd), work),
              read=name == "triangles")
        payload = _restricted_load(path)
        assert payload["windows_done"] == 10, name
        assert payload["vdict"]["kind"] == ("identity" if vd is not None else "vertexdict")
    # workloads that take edge records rather than a stream: a barrier of
    # their state written directly
    dd = lib.DegreeDistribution(gt.CountWindow(8), device="cpu")
    list(dd.run([(s, d, "+") for s, d, _ in _worker_edges()]))
    btc = lib.BroadcastTriangleCount(vertex_count=256, samples=64, window=gt.CountWindow(32),
                                     device="cpu")
    list(btc.run(_worker_edges()))
    for name, work in (("degrees", dd), ("sampler", btc)):
        path = str(tmp_path / f"{name}.ckpt")
        AutoCheckpoint(path)._snapshot(work, None, 7)
        assert _restricted_load(path)["state"].keys() == work.state_dict().keys()
