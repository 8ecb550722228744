"""Streaming k-spanners: the port against the JAX package.

The same edges, made with numpy from a seed, go through
``gelly_streaming_tpu`` and ``gelly_streaming_tpu_torch`` (on the CPU).
Every window's spanner edge set must be equal, for the host fold
(``Spanner``) and for ``DeviceSpanner`` with k = 2 (the packed
common-neighbor path) and k = 3 (the frontier search), at window 1 and at
larger windows; the k-spanner guarantee is checked by BFS.

Mirrors ``tests/test_device_spanner.py`` (validity for any windowing,
window 1 equal to the host fold, the redundant-edge drop, the memory
budget, the lazy-read reconcile) and ``tests/test_library.py:113-130``
(path graph, shortcut drop), plus the checkpoint across packages and the
CLI (``tests/test_examples.py:74, 214``).
"""

from collections import deque

import numpy as np
import pytest
import torch

import gelly_streaming_tpu as gj
import gelly_streaming_tpu_torch as gt
from gelly_streaming_tpu.datasets import IdentityDict as JaxIdentityDict
from gelly_streaming_tpu.example import spanner as jax_cli
from gelly_streaming_tpu.library.spanner import DeviceSpanner as JaxDS
from gelly_streaming_tpu.library.spanner import Spanner as JaxSpanner
from gelly_streaming_tpu.library.spanner import _gen_append as jax_gen_append
from gelly_streaming_tpu_torch.datasets import IdentityDict
from gelly_streaming_tpu_torch.example import spanner as torch_cli
from gelly_streaming_tpu_torch.library import spanner as tsp
from gelly_streaming_tpu_torch.library.spanner import DeviceSpanner as TorchDS
from gelly_streaming_tpu_torch.library.spanner import Spanner as TorchSpanner


def _jstream(edges, window, vdict=None):
    return gj.SimpleEdgeStream(edges, window=gj.CountWindow(window), vertex_dict=vdict)


def _tstream(edges, window, vdict=None):
    return gt.SimpleEdgeStream(edges, window=gt.CountWindow(window), vertex_dict=vdict,
                               device="cpu")


def _edges(seed, n=64, v=20):
    rng = np.random.default_rng(seed)
    return [(int(a), int(b), 0.0) for a, b in rng.integers(0, v, size=(n, 2))]


def bfs_dist(edges, a, b, cap):
    adj = {}
    for u, v in edges:
        adj.setdefault(u, set()).add(v)
        adj.setdefault(v, set()).add(u)
    if a == b:
        return 0
    seen = {a}
    q = deque([(a, 0)])
    while q:
        x, dist = q.popleft()
        if dist >= cap:
            continue
        for y in adj.get(x, ()):
            if y == b:
                return dist + 1
            if y not in seen:
                seen.add(y)
                q.append((y, dist + 1))
    return cap + 1


def assert_valid_spanner(all_edges, spanner, k):
    for u, v, *_ in all_edges:
        if u == v:
            continue
        e = (min(u, v), max(u, v))
        if e not in spanner:
            assert bfs_dist(spanner, e[0], e[1], k) <= k, e


@pytest.mark.parametrize("window", [1, 4, 16, 64])
@pytest.mark.parametrize("k", [2, 3])
def test_device_spanner_matches_jax_and_is_valid(window, k):
    raw = _edges(7)
    jout = [set(e) for e in JaxDS(k=k).run(_jstream(raw, window))]
    tout = [set(e) for e in TorchDS(k=k).run(_tstream(raw, window))]
    assert tout == jout
    assert_valid_spanner(raw, tout[-1], k)


@pytest.mark.parametrize("k", [2, 3, 4])
@pytest.mark.parametrize("window", [37, 256])
def test_device_spanner_larger_windows_match_jax(k, window):
    raw = _edges(3, n=600, v=90)
    jds, tds = JaxDS(k=k), TorchDS(k=k)
    jout = [set(e) for e in jds.run(_jstream(raw, window))]
    tout = [set(e) for e in tds.run(_tstream(raw, window))]
    assert tout == jout
    assert tds.edges() == jds.edges() == tout[-1]
    assert_valid_spanner(raw, tout[-1], k)


@pytest.mark.parametrize("k", [2, 3])
def test_device_spanner_window1_matches_host(k):
    rng = np.random.default_rng(9)
    raw = [(int(a), int(b), 0.0) for a, b in rng.integers(0, 15, size=(40, 2)) if a != b]
    dev = TorchDS(k=k)
    for _ in dev.run(_tstream(raw, 1)):
        pass
    host_last = None
    for host_last in _tstream(raw, 1).aggregate(TorchSpanner(k=k)):
        pass
    assert dev.edges() == {(min(u, v), max(u, v)) for u, v in host_last.edges()}


@pytest.mark.parametrize("k", [2, 3])
@pytest.mark.parametrize("window", [1, 3, 10])
def test_host_spanner_matches_jax(k, window):
    raw = _edges(5, n=80, v=25)
    jout = [sorted(g.edges()) for g in _jstream(raw, window).aggregate(JaxSpanner(k=k))]
    tout = [sorted(g.edges()) for g in _tstream(raw, window).aggregate(TorchSpanner(k=k))]
    assert tout == jout
    assert_valid_spanner(raw, {(min(a, b), max(a, b)) for a, b in tout[-1]}, k)


def test_host_spanner_path_and_shortcut():
    path = [(i, i + 1, 0.0) for i in range(6)]
    last = list(_tstream(path, 3).aggregate(TorchSpanner(k=2)))[-1]
    assert sorted(last.edges()) == [(i, i + 1) for i in range(6)]
    tri = [(1, 2, 0.0), (2, 3, 0.0), (1, 3, 0.0)]
    g = list(_tstream(tri, 3).aggregate(TorchSpanner(k=2)))[-1]
    assert g.num_edges() == 2 and g.bounded_bfs(1, 3, 2)
    agg = TorchSpanner(k=2, transient_state=True)
    assert [g.num_edges() for g in _tstream(tri + tri, 3).aggregate(agg)] == [2, 2]
    assert agg.checkpoint_granularity() == 1


def test_device_spanner_drops_redundant_edges():
    edges = [(1, 2, 0.0), (2, 3, 0.0), (1, 3, 0.0)]
    for k in (2, 3):
        sp = TorchDS(k=k)
        for _ in sp.run(_tstream(edges, 1)):
            pass
        assert sp.edges() == {(1, 2), (2, 3)}


def test_memory_budget_shrinks_query_batches():
    rng = np.random.default_rng(8)
    src, dst = rng.integers(0, 120, 600), rng.integers(0, 120, 600)

    def final(budget):
        sp = TorchDS(k=3, mem_budget_entries=budget)
        out = None
        for out in sp.run(gt.SimpleEdgeStream((src, dst), window=gt.CountWindow(100),
                                              device="cpu")):
            pass
        return sp, out

    sp_small, small = final(1 << 12)
    sp_big, big = final(1 << 28)
    assert sp_small._batch_cap(128) < sp_big._batch_cap(128)
    assert sp_small._batch_cap(128) == 32
    assert small == big


@pytest.mark.parametrize("k", [2, 3])
def test_lazy_read_reconciles_capacity_bound(k):
    rng = np.random.default_rng(11)
    raw = [(int(a), int(b), 0.0) for a, b in rng.integers(0, 12, size=(400, 2)) if a != b]
    sp = TorchDS(k=k)
    snaps = list(sp.run(_tstream(raw, 50)))
    ub_before = sp._cnt_ub
    true_edges = len(snaps[-1])
    scale = 2 if k == 2 else 1
    assert sp._cnt_ub <= scale * true_edges + (sp._add_total - snaps[-1]._add)
    assert sp._cnt_ub < ub_before
    ub_after = sp._cnt_ub
    list(snaps[0])  # a stale snapshot read later: no regression
    assert sp._cnt_ub <= ub_after
    assert sp._cnt_ub >= scale * true_edges
    # held snapshots keep their window (every tensor a snapshot holds is its own)
    again = [set(s) for s in TorchDS(k=k).run(_tstream(raw, 50))]
    assert [set(s) for s in snaps] == again


@pytest.mark.parametrize("k", [2, 3])
@pytest.mark.parametrize("restore_in", ["port", "jax"])
def test_state_dict_across_packages_continues(k, restore_in):
    raw = _edges(21, n=400, v=60)
    first, second = raw[:200], raw[200:]
    base = JaxDS(k=k)
    jd = JaxIdentityDict(64)
    list(base.run(_jstream(first, 40, jd)))
    want = [set(e) for e in base.run(_jstream(second, 40, jd))]
    if restore_in == "port":
        src = JaxDS(k=k)
        list(src.run(_jstream(first, 40, JaxIdentityDict(64))))
        resumed = TorchDS(k=k)
        resumed.load_state_dict(src.state_dict())
        got = [set(e) for e in resumed.run(_tstream(second, 40, IdentityDict(64)))]
    else:
        src = TorchDS(k=k)
        list(src.run(_tstream(first, 40, IdentityDict(64))))
        state = src.state_dict()
        assert state["su"].dtype == np.int32
        resumed = JaxDS(k=k)
        resumed.load_state_dict(state)
        got = [set(e) for e in resumed.run(_jstream(second, 40, JaxIdentityDict(64)))]
    assert got == want
    assert resumed.edges() == base.edges()


def test_gen_append_matches_jax():
    import jax.numpy as jnp

    rng = np.random.default_rng(4)
    sp = rng.integers(0, 50, 32).astype(np.int32)
    sq = rng.integers(0, 50, 32).astype(np.int32)
    qu = rng.integers(0, 50, 16).astype(np.int32)
    qv = rng.integers(0, 50, 16).astype(np.int32)
    keep = rng.random(16) < 0.5
    for cnt in (3, 25):
        j = jax_gen_append(jnp.asarray(sp), jnp.asarray(sq), jnp.int32(cnt), jnp.asarray(qu),
                           jnp.asarray(qv), jnp.asarray(keep))
        t = tsp._gen_append(torch.from_numpy(sp), torch.from_numpy(sq),
                            torch.tensor(cnt, dtype=torch.int32), torch.from_numpy(qu),
                            torch.from_numpy(qv), torch.from_numpy(keep))
        for a, b in zip(j, t):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_device_spanner_emits_on_the_stream_device_and_syncs():
    sp = TorchDS(k=2, expected_edges=64)
    out = list(sp.run(_tstream(_edges(2), 16)))
    assert sp._pv.device.type == "cpu" and sp._pv.shape[0] >= 128 and len(out) == 4
    sp.sync()


def test_cli_matches_jax(tmp_path):
    inp = tmp_path / "edges.txt"
    inp.write_text("\n".join(f"{a} {b}" for a, b, _ in _edges(31, n=80, v=25)))
    for extra in ([], ["--device"]):
        jo, to = tmp_path / "j.txt", tmp_path / "t.txt"
        jax_cli.main([str(inp), "10", "3", str(jo)] + extra)
        torch_cli.main(["--cpu", str(inp), "10", "3", str(to)] + extra)
        assert to.read_text() == jo.read_text() and to.read_text()
    tri = tmp_path / "tri.txt"
    tri.write_text("1 2\n2 3\n1 3\n")
    torch_cli.main(["--cpu", str(tri), "10", "3", str(to)])
    assert len(to.read_text().splitlines()) == 2
