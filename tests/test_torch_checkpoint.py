"""Checkpoints of the port (``aggregate/checkpoint.py``) against the JAX
package's: one on-disk format for both.

The pytree checkpoint (``.g<N>.npz`` + JSON sidecar) round-trips and
rejects a torn pair, a checksum mismatch, a wrong leaf count and a key
path or shape mismatch. The ordering trap: a state with unsorted dict keys
and ``None`` written by one package is read by the other, and both write
the same sidecar (key paths, leaf count, meta, content checksum). Then
every checkpoint kind crosses the packages both ways: ``save_aggregation``
for CC (forest, host and dense carries) and bipartiteness,
``save_workload`` for PageRank, degrees, exact triangles, the device
spanner, matching and the sampler, and ``save_vertex_dict``; the restored
run equals the writer's uninterrupted run (integers exactly, PageRank
within the reference test's 1e-5).

Mirrors ``tests/test_workload_checkpoint.py`` and the pytree cases of
``tests/test_resilience.py:58-124``.
"""

import json
import os

import jax
import numpy as np
import pytest

import gelly_streaming_tpu as gj
import gelly_streaming_tpu_torch as gt
from gelly_streaming_tpu import library as jlib
from gelly_streaming_tpu.aggregate import checkpoint as jck
from gelly_streaming_tpu_torch import library as tlib
from gelly_streaming_tpu_torch import obs
from gelly_streaming_tpu_torch.aggregate import checkpoint as tck
from gelly_streaming_tpu_torch.ops.device_dict import DeviceVertexDict
from gelly_streaming_tpu_torch.resilience import CheckpointCorrupt
from gelly_streaming_tpu_torch.resilience.faults import corrupt_file

RNG = np.random.default_rng(12)
EDGES = [
    (int(a), int(b), float(w))
    for (a, b), w in zip(RNG.integers(0, 16, (40, 2)), RNG.uniform(1, 9, 40))
]
SPLIT = 20  # resume point (window-aligned for window=4 or 5)
DIRECTIONS = ["jax_to_torch", "torch_to_jax"]


@pytest.fixture
def registry():
    reg = obs.set_registry(None)
    yield reg
    obs.set_registry(None)


def _jstream(edges, window, vdict=None):
    return gj.SimpleEdgeStream(edges, window=gj.CountWindow(window), vertex_dict=vdict)


def _tstream(edges, window, vdict=None):
    return gt.SimpleEdgeStream(edges, window=gt.CountWindow(window), vertex_dict=vdict,
                               device="cpu")


def _jresume(vdict, tail, window=4):
    wi = gj.Windower(gj.CountWindow(window), vdict)
    return gj.SimpleEdgeStream(_blocks=lambda: wi.blocks(iter(tail)), _vdict=vdict)


def _tresume(vdict, tail, window=4):
    wi = gt.Windower(gt.CountWindow(window), vdict, device="cpu")
    return gt.SimpleEdgeStream(_blocks=lambda: wi.blocks(iter(tail)), _vdict=vdict,
                               device="cpu")


# the two packages, by role: (checkpoint module, stream, resume stream, library)
_PKG = {
    "jax": (jck, _jstream, _jresume, jlib),
    "torch": (tck, _tstream, _tresume, tlib),
}


def _roles(direction):
    writer, reader = direction.split("_to_")
    return _PKG[writer], _PKG[reader]


def _drain(it):
    for _ in it:
        pass


# --------------------------------------------------------------------- #
# pytree checkpoints: round trip and rejection
# --------------------------------------------------------------------- #
def test_pytree_roundtrip_keeps_structure_dtypes_and_meta(tmp_path):
    import torch

    tree = {"z": torch.arange(6, dtype=torch.int32), "a": (np.ones(3, np.float32), None),
            "m": [np.zeros(2, bool), {"k": np.int64(7)}]}
    path = str(tmp_path / "p")
    tck.save_pytree(path, tree, meta={"vcap": 6})
    got, meta = tck.load_pytree(path, tree)
    assert meta == {"vcap": 6}
    assert list(got) == ["z", "a", "m"] and got["a"][1] is None
    np.testing.assert_array_equal(got["z"], np.arange(6, dtype=np.int32))
    assert got["z"].dtype == np.int32 and got["m"][0].dtype == bool
    assert got["m"][1]["k"] == 7
    # a second save commits a new generation and sweeps the old one
    tck.save_pytree(path, tree)
    assert len(tck._generation_files(path)) == 1


def test_pytree_torn_pair_rejected(tmp_path, registry):
    """Mirrors ``tests/test_resilience.py:75`` on the port: the sidecar is
    the commit point; every damage to the array file it names is a
    CheckpointCorrupt and counted as ``resilience.ckpt_rejected``."""
    path = str(tmp_path / "c")
    tree = {"a": np.arange(8, dtype=np.int32), "b": np.ones(4, np.float32)}
    tck.save_pytree(path, tree)
    got, _ = tck.load_pytree(path, tree)
    assert np.array_equal(got["a"], tree["a"])
    with open(path + ".json") as f:
        npz = tck._npz_path(path, json.load(f))

    # a newer generation whose sidecar never committed: the pair stands
    np.savez(path + ".g9.npz", leaf_0=np.zeros(8, np.int32))
    got, _ = tck.load_pytree(path, tree)
    assert np.array_equal(got["a"], tree["a"])
    os.remove(path + ".g9.npz")

    np.savez(npz, leaf_0=np.zeros(8, np.int32), leaf_1=np.ones(4, np.float32))
    with pytest.raises(CheckpointCorrupt, match="checksum"):
        tck.load_pytree(path, tree)
    np.savez(npz, leaf_0=np.zeros(8, np.int32))
    with pytest.raises(CheckpointCorrupt, match="leaf"):
        tck.load_pytree(path, tree)

    tck.save_pytree(path, tree)
    with open(path + ".json") as f:
        npz = tck._npz_path(path, json.load(f))
    corrupt_file(npz, "flip", seed=9)
    with pytest.raises(CheckpointCorrupt, match="checksum|torn or corrupt"):
        tck.load_pytree(path, tree)
    os.remove(npz)
    with pytest.raises(CheckpointCorrupt, match="unreadable|missing"):
        tck.load_pytree(path, tree)
    assert registry.counter("resilience.ckpt_rejected").value >= 4


@pytest.mark.parametrize("template,match", [
    ({"a": np.zeros(8, np.int32), "c": np.ones(4, np.float32)}, "structure"),
    ({"a": np.zeros(9, np.int32), "b": np.ones(4, np.float32)}, "shape"),
    ({"a": np.zeros(8, np.float32), "b": np.ones(4, np.float32)}, "dtype"),
    ({"a": np.zeros(8, np.int32)}, "leaves"),
])
def test_pytree_template_mismatch_rejected(tmp_path, template, match):
    path = str(tmp_path / "t")
    tck.save_pytree(path, {"a": np.arange(8, dtype=np.int32), "b": np.ones(4, np.float32)})
    with pytest.raises(ValueError, match=match):
        tck.load_pytree(path, template)


# --------------------------------------------------------------------- #
# the ordering trap: unsorted dict keys and a None leaf, both ways
# --------------------------------------------------------------------- #
def _trap_state():
    return {
        "zeta": np.arange(5, dtype=np.int32),
        "alpha": [np.linspace(0, 1, 3).astype(np.float32), None,
                  (np.array([True, False]),)],
        "mid": None,
        "beta": {"y": np.int64(3), "x": np.arange(4, dtype=np.int64)},
    }


@pytest.mark.parametrize("direction", DIRECTIONS)
def test_unsorted_keys_and_none_cross_packages(tmp_path, direction):
    (wck, *_), (rck, *_) = _roles(direction)
    path = str(tmp_path / "trap")
    wck.save_pytree(path, _trap_state(), meta={"vcap": 5})
    got, meta = rck.load_pytree(path, _trap_state())
    want = _trap_state()
    assert meta == {"vcap": 5}
    np.testing.assert_array_equal(got["zeta"], want["zeta"])
    np.testing.assert_array_equal(got["alpha"][0], want["alpha"][0])
    assert got["alpha"][1] is None and got["mid"] is None
    np.testing.assert_array_equal(got["alpha"][2][0], want["alpha"][2][0])
    np.testing.assert_array_equal(got["beta"]["x"], want["beta"]["x"])
    assert int(got["beta"]["y"]) == 3


def test_sidecars_of_both_packages_agree(tmp_path):
    """The same state written by each package: equal key paths, leaf count,
    meta and content checksum (``treedef`` is informational)."""
    jck.save_pytree(str(tmp_path / "j"), _trap_state(), meta={"vcap": 5})
    tck.save_pytree(str(tmp_path / "t"), _trap_state(), meta={"vcap": 5})
    with open(tmp_path / "j.json") as f:
        j = json.load(f)
    with open(tmp_path / "t.json") as f:
        t = json.load(f)
    for key in ("keypaths", "n_leaves", "meta", "leaves_crc32"):
        assert t[key] == j[key], key
    flat = jax.tree_util.tree_flatten_with_path(_trap_state())[0]
    assert [k for k, _ in tck.flatten_with_keys(_trap_state())] == [
        jax.tree_util.keystr(p) for p, _ in flat]


# --------------------------------------------------------------------- #
# aggregations: CC on every carry, bipartiteness
# --------------------------------------------------------------------- #
def _agg(lib, kind, carry):
    cls = lib.ConnectedComponents if kind == "cc" else lib.BipartitenessCheck
    return cls(carry=carry)


def _final(last, kind):
    if kind == "cc":
        return sorted(sorted(s) for s in last.component_sets())
    return str(last)


@pytest.mark.parametrize("direction", DIRECTIONS)
@pytest.mark.parametrize("kind,carry", [("cc", "forest"), ("cc", "host"), ("cc", "dense"),
                                        ("bip", "forest"), ("bip", "dense")])
def test_aggregation_checkpoint_crosses_packages(tmp_path, direction, kind, carry):
    (wck, wstream, _, wlib), (rck, _, rresume, rlib) = _roles(direction)
    edges = [(s, d, 0.0) for s, d, _ in EDGES]
    full = None
    for full in wstream(edges, 4).aggregate(_agg(wlib, kind, carry)):
        pass
    first = _agg(wlib, kind, carry)
    stream = wstream(edges[:SPLIT], 4)
    _drain(stream.aggregate(first))
    path = str(tmp_path / "agg")
    wck.save_aggregation(path, first, stream.vertex_dict)

    second = _agg(rlib, kind, carry)
    vdict = rck.restore_aggregation(path, second)
    last = None
    for last in rresume(vdict, edges[SPLIT:]).aggregate(second):
        pass
    assert _final(last, kind) == _final(full, kind)


def test_cc_sidecar_equals_reference(tmp_path):
    """The same CC state saved by each package: the same sidecar and the
    same arrays (int32 labels, bool touched)."""
    jagg, tagg = jlib.ConnectedComponents(carry="forest"), tlib.ConnectedComponents(carry="forest")
    _drain(_jstream(EDGES, 4).aggregate(jagg))
    _drain(_tstream(EDGES, 4).aggregate(tagg))
    jck.save_aggregation(str(tmp_path / "j"), jagg)
    tck.save_aggregation(str(tmp_path / "t"), tagg)
    with open(tmp_path / "j.json") as f:
        j = json.load(f)
    with open(tmp_path / "t.json") as f:
        t = json.load(f)
    assert t["keypaths"] == j["keypaths"] == ["['labels']", "['touched']"]
    for key in ("n_leaves", "meta", "leaves_crc32"):
        assert t[key] == j[key], key
    arrays = np.load(tmp_path / t["npz"])
    assert arrays["leaf_0"].dtype == np.int32 and arrays["leaf_1"].dtype == bool


# --------------------------------------------------------------------- #
# workloads (state_dict pickles), both ways
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("direction", DIRECTIONS)
def test_pagerank_checkpoint_crosses_packages(tmp_path, direction):
    (wck, wstream, _, wlib), (rck, _, rresume, rlib) = _roles(direction)
    full = wlib.IncrementalPageRank(tol=1e-9, max_iter=300)
    _drain(full.run(wstream(EDGES, 4)))
    first = wlib.IncrementalPageRank(tol=1e-9, max_iter=300)
    stream = wstream(EDGES[:SPLIT], 4)
    _drain(first.run(stream))
    path = str(tmp_path / "pr")
    wck.save_workload(path, first, stream.vertex_dict)
    second = rlib.IncrementalPageRank(tol=1e-9, max_iter=300)
    vdict = rck.restore_workload(path, second)
    _drain(second.run(rresume(vdict, EDGES[SPLIT:])))
    got, want = second.ranks(), full.ranks()
    assert set(got) == set(want)
    for v in want:
        assert got[v] == pytest.approx(want[v], abs=1e-5)


@pytest.mark.parametrize("direction", DIRECTIONS)
def test_exact_triangles_checkpoint_crosses_packages(tmp_path, direction):
    (wck, wstream, _, wlib), (rck, _, rresume, rlib) = _roles(direction)

    def collect(runs):
        final = {}
        for e in runs:
            final.update(dict(e))
        return final

    want = collect(wlib.ExactTriangleCount().run(wstream(EDGES, 5)))
    first = wlib.ExactTriangleCount()
    stream = wstream(EDGES[:SPLIT], 5)
    partial = collect(first.run(stream))
    path = str(tmp_path / "tri")
    wck.save_workload(path, first, stream.vertex_dict)
    second = rlib.ExactTriangleCount()
    vdict = rck.restore_workload(path, second)
    partial.update(collect(second.run(rresume(vdict, EDGES[SPLIT:], window=5))))
    assert partial == want


@pytest.mark.parametrize("direction", DIRECTIONS)
def test_degree_distribution_checkpoint_crosses_packages(tmp_path, direction):
    (wck, *_, wlib), (rck, *_, rlib) = _roles(direction)
    events = [(s, d, "+" if i % 3 else "-") for i, (s, d, _) in enumerate(EDGES)]

    def dd(lib):
        if lib is tlib:
            return lib.DegreeDistribution(gt.CountWindow(4), device="cpu")
        return lib.DegreeDistribution(gj.CountWindow(4))

    full = dd(wlib)
    _drain(full.run(events))
    first = dd(wlib)
    _drain(first.run(events[:SPLIT]))
    path = str(tmp_path / "dd")
    wck.save_workload(path, first)
    second = dd(rlib)
    rck.restore_workload(path, second)  # restores the vertex dict too
    _drain(second.run(events[SPLIT:]))
    assert second.histogram() == full.histogram()
    np.testing.assert_array_equal(np.asarray(second.degrees()), np.asarray(full.degrees()))


@pytest.mark.parametrize("direction", DIRECTIONS)
@pytest.mark.parametrize("k", [2, 3])
def test_device_spanner_checkpoint_crosses_packages(tmp_path, direction, k):
    """k = 2 rebuilds the packed adjacency, k = 3 the frontier search; the
    resumed spanner equals the writer's uninterrupted one."""
    (wck, wstream, _, wlib), (rck, _, rresume, rlib) = _roles(direction)
    full = wlib.DeviceSpanner(k=k)
    _drain(full.run(wstream(EDGES, 4)))
    first = wlib.DeviceSpanner(k=k)
    stream = wstream(EDGES[:SPLIT], 4)
    _drain(first.run(stream))
    path = str(tmp_path / f"sp{k}")
    wck.save_workload(path, first, stream.vertex_dict)
    second = rlib.DeviceSpanner(k=k)
    vdict = rck.restore_workload(path, second)
    _drain(second.run(rresume(vdict, EDGES[SPLIT:])))
    assert second.edges() == full.edges()


@pytest.mark.parametrize("direction", DIRECTIONS)
def test_matching_checkpoint_crosses_packages(tmp_path, direction):
    (wck, *_, wlib), (rck, *_, rlib) = _roles(direction)
    first = wlib.CentralizedWeightedMatching()
    _drain(first.run(EDGES[:SPLIT]))
    path = str(tmp_path / "m")
    wck.save_workload(path, first)
    second = rlib.CentralizedWeightedMatching()
    rck.restore_workload(path, second)
    _drain(second.run(EDGES[SPLIT:]))
    full = wlib.CentralizedWeightedMatching()
    _drain(full.run(EDGES))
    assert {tuple(e) for e in second.matching()} == {tuple(e) for e in full.matching()}
    assert second.total_weight() == pytest.approx(full.total_weight(), abs=1e-9)


@pytest.mark.parametrize("direction", DIRECTIONS)
def test_sampler_checkpoint_crosses_packages(tmp_path, direction):
    """The sampler's state crosses; its random stream does not (a JAX key
    against a torch generator), so the port runs on the JAX package's
    uniforms here (``test_torch_sampling._JaxUniforms``) and its
    checkpoint carries that key for the JAX side."""
    import itertools

    from test_torch_sampling import _JaxUniforms

    class _Keyed(_JaxUniforms):
        def state_dict(self):
            return {**super().state_dict(), "key": np.asarray(self.key)}

        def load_state_dict(self, d):
            super().load_state_dict(d)
            self.key = jax.numpy.asarray(d["key"])

    edges = [(a, b, 0.0) for a, b in itertools.combinations(range(12), 2)]
    kw = dict(vertex_count=12, samples=300)
    full = jlib.BroadcastTriangleCount(window=gj.CountWindow(8), seed=5, **kw)
    full_out = list(full.run(edges))
    path = str(tmp_path / "est")
    if direction == "jax_to_torch":
        first = jlib.BroadcastTriangleCount(window=gj.CountWindow(8), seed=5, **kw)
        out1 = list(first.run(edges[:32]))
        jck.save_workload(path, first)
        second = _Keyed(jax.random.PRNGKey(0), window=gt.CountWindow(8), **kw)
        tck.restore_workload(path, second)
    else:
        first = _Keyed(jax.random.PRNGKey(5), window=gt.CountWindow(8), **kw)
        out1 = list(first.run(edges[:32]))
        tck.save_workload(path, first)
        second = jlib.BroadcastTriangleCount(window=gj.CountWindow(8), **kw)
        jck.restore_workload(path, second)
    assert out1 + list(second.run(edges[32:])) == full_out


# --------------------------------------------------------------------- #
# vertex dictionaries
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("direction", DIRECTIONS)
def test_vertex_dict_crosses_packages(tmp_path, direction):
    (wck, *_), (rck, *_) = _roles(direction)
    raw = np.random.default_rng(3).integers(0, 10_000, 300)
    d = (gj.VertexDict() if direction == "jax_to_torch" else gt.VertexDict())
    d.encode(raw)
    path = str(tmp_path / "v")
    wck.save_vertex_dict(path, d)
    back = rck.load_vertex_dict(path)
    np.testing.assert_array_equal(np.asarray(back.raw_ids()), np.asarray(d.raw_ids()))
    probe = np.asarray(d.raw_ids())[[0, 5, -1]]
    np.testing.assert_array_equal(back.encode(probe), [0, 5, len(d) - 1])


def test_device_vertex_dict_saves_like_the_host_dict(tmp_path):
    """``save_vertex_dict`` of the port's ``DeviceVertexDict`` restores
    into a host dict with the same first-seen mapping, in either package
    (mirrors ``tests/test_device_dict.py:150``)."""
    dev = DeviceVertexDict(min_capacity=64, device="cpu")
    rng = np.random.default_rng(10)
    for _ in range(3):
        dev.encode(rng.integers(0, 500, 200))
    path = str(tmp_path / "ck")
    tck.save_vertex_dict(path, dev)
    for loader in (tck.load_vertex_dict, jck.load_vertex_dict):
        host = loader(path)
        np.testing.assert_array_equal(host.raw_ids(), dev.raw_ids())
        assert host.encode(np.array([dev.raw_ids()[5], 99999], np.int64))[0] == 5


def test_restore_server_names_its_slice(tmp_path):
    """``restore_server`` is ported (slice 9a): a port-written CC
    checkpoint boots servers of both packages that answer alike from the
    boot snapshot; and the routing tier (slice 9b) serves it: a router of
    each package in front of each restored server answers the same."""
    from gelly_streaming_tpu.serving import ConnectedQuery as JQ
    from gelly_streaming_tpu.serving import RpcServer as JRpc
    from gelly_streaming_tpu.serving import ShardRouter as JRouter
    from gelly_streaming_tpu_torch.serving import ConnectedQuery as TQ
    from gelly_streaming_tpu_torch.serving import RpcServer as TRpc
    from gelly_streaming_tpu_torch.serving import ShardRouter

    edges = [(1, 2, 0.0), (2, 3, 0.0), (7, 8, 0.0)]
    s = gt.SimpleEdgeStream(edges, window=gt.CountWindow(2), device="cpu")
    agg = tlib.ConnectedComponents(carry="forest")
    for _ in s.aggregate(agg):
        pass
    path = str(tmp_path / "cc")
    tck.save_aggregation(path, agg, vdict=s.vertex_dict)
    # empty catch-up streams: every answer comes from the boot snapshot
    src = gt.SimpleEdgeStream([], window=gt.CountWindow(2),
                              vertex_dict=tck.load_vertex_dict(path), device="cpu")
    jsrc = gj.SimpleEdgeStream([], window=gj.CountWindow(2),
                               vertex_dict=jck.load_vertex_dict(path))
    srv = tck.restore_server(path, tlib.ConnectedComponents(carry="forest"),
                             src, start=False)
    jsrv = jck.restore_server(path, jlib.ConnectedComponents(), jsrc, start=False)
    try:
        for server, q in ((srv, TQ), (jsrv, JQ)):
            server.start()
            got = [server.ask(q(u, v), 30) for u, v in ((1, 3), (1, 7), (7, 8))]
            assert [a.value for a in got] == [True, False, True]
            assert {a.window for a in got} == {-1}
        for server, rpc_cls in ((srv, TRpc), (jsrv, JRpc)):
            rpc = rpc_cls(server).start()
            try:
                for router_cls, q in ((ShardRouter, TQ), (JRouter, JQ)):
                    router = router_cls([[f"127.0.0.1:{rpc.port}"]])
                    try:
                        got = router.ask_batch(
                            [q(u, v) for u, v in ((1, 3), (1, 7), (7, 8))],
                            deadline_s=30, timeout=60)
                        assert [bool(a.value) for a in got] == [True, False, True]
                    finally:
                        router.close()
            finally:
                rpc.close()
    finally:
        srv.close()
        jsrv.close()
