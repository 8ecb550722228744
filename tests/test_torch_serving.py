"""The port's single-process serving tier against the JAX package's:
the four query steps, ``QueryEngine`` on both paths, live serving, the
servables, checkpoint boot, snapshot immutability and failover.

- the torch steps (``_batch_roots``, ``_gather``, ``_gather_sizes``,
  ``_component_size_table``) equal the JAX package's jitted steps on seeded
  forests with long chains, the JAX side padded to its pow2 buckets (the
  padding lanes dropped), the port unpadded;
- ``QueryEngine`` answers mixed batches equal to the JAX engine's on the
  host path, on the torch steps (``prefer_host=False``, CPU tensors) and
  under ``"auto"``; pull docs are byte-identical, delta chain included;
- live answers during ingest equal the DSU oracle AND the JAX engine at the
  answered snapshot's window, for every CC carry;
- ``restore_server`` boots from a checkpoint written by either package;
- a held snapshot's bytes never change while later windows fold, for every
  carry at ``superbatch`` 1 and 4 (torch tensors can be written in place,
  so this is the servables' rule, not the language's);
- admission, deadlines, retry, shedding and failover as in the reference.

Mirrors ``tests/test_serving.py:54-435``, ``tests/test_resilience.py:
599-714`` and ``tests/test_coordinated.py:522-627``.
"""

import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gelly_streaming_tpu as gj
import gelly_streaming_tpu_torch as gt
from gelly_streaming_tpu import serving as jserving
from gelly_streaming_tpu.library import BipartitenessCheck as JaxBC
from gelly_streaming_tpu.library import ConnectedComponents as JaxCC
from gelly_streaming_tpu.serving import query as jq
from gelly_streaming_tpu_torch import obs
from gelly_streaming_tpu_torch.datasets import IdentityDict
from gelly_streaming_tpu_torch.library import (
    BipartitenessCheck,
    ConnectedComponents,
)
from gelly_streaming_tpu_torch.library.degrees import DegreeDistribution
from gelly_streaming_tpu_torch.library.pagerank import IncrementalPageRank
from gelly_streaming_tpu_torch.resilience import faults
from gelly_streaming_tpu_torch.resilience.errors import DeadlineExceeded
from gelly_streaming_tpu_torch.resilience.faults import FaultPlan
from gelly_streaming_tpu_torch.serving import (
    BipartiteQuery,
    ComponentSizeQuery,
    ConnectedQuery,
    DegreeQuery,
    FailoverServer,
    Overloaded,
    PublishedSnapshot,
    QueryEngine,
    RankQuery,
    RetryPolicy,
    Shed,
    SnapshotStore,
    StreamServer,
)
from gelly_streaming_tpu_torch.serving import query as tq

from _uf import union_find_components


@pytest.fixture(autouse=True)
def _hygiene():
    obs.reset()
    faults.clear()
    yield
    obs.reset()
    faults.clear()


@pytest.fixture
def registry():
    return obs.get_registry()


def _forest(seed, vcap=300, chain=200):
    """A min-rooted pointer forest (``canon[v] <= v``) with one chain of
    ``chain`` hops and random pointers elsewhere."""
    rng = np.random.default_rng(seed)
    canon = np.arange(vcap, dtype=np.int32)
    canon[1:chain] = np.arange(chain - 1, dtype=np.int32)
    rest = np.arange(chain, vcap)
    canon[rest] = (rng.random(len(rest)) * (rest + 1)).astype(np.int32)
    return canon


def _ids(seed, vcap, n=37):
    return np.random.default_rng(seed + 1).integers(0, vcap, n).astype(np.int32)


# --------------------------------------------------------------------- #
# 1. The four device steps, against the JAX package's jitted steps
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_batch_roots_equals_the_jax_step_on_long_chains(seed):
    canon, = (_forest(seed),)
    ids = _ids(seed, len(canon))
    ids[0] = 199  # the chain's tail: 199 turns to its root
    want = np.asarray(jq._batch_roots(jnp.asarray(canon),
                                      jnp.asarray(jq._pad_ids(ids))))[: len(ids)]
    before = tq.HOST_READS
    got = tq._batch_roots(torch.from_numpy(canon), torch.from_numpy(ids))
    np.testing.assert_array_equal(got.numpy(), want)
    # one host read per turn: the gather starts one hop in, 198 more hops
    # reach the root, and one more turn finds nothing left to move
    assert tq.HOST_READS - before == 199
    np.testing.assert_array_equal(want, tq._host_batch_roots(canon, ids))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_size_table_and_gathers_equal_the_jax_steps(seed):
    canon = _forest(seed)
    ids = _ids(seed, len(canon))
    jlab, jsizes = jq._component_size_table(jnp.asarray(canon))
    lab, sizes = tq._component_size_table(torch.from_numpy(canon))
    np.testing.assert_array_equal(lab.numpy(), np.asarray(jlab))
    np.testing.assert_array_equal(sizes.numpy(), np.asarray(jsizes))
    assert sizes.dtype == torch.int32
    padded = jnp.asarray(jq._pad_ids(ids))
    want = np.asarray(jq._gather_sizes(jlab, jsizes, padded))[: len(ids)]
    got = tq._gather_sizes(lab, sizes, torch.from_numpy(ids))
    np.testing.assert_array_equal(got.numpy(), want)
    table = np.random.default_rng(seed).random(len(canon)).astype(np.float32)
    want = np.asarray(jq._gather(jnp.asarray(table), padded))[: len(ids)]
    np.testing.assert_array_equal(tq._gather(torch.from_numpy(table),
                                             torch.from_numpy(ids)).numpy(), want)


def test_size_table_reads_count_in_the_engine_not_the_fold():
    # the size table's canonicalization turns are the engine's reads: a
    # fold running meanwhile on another thread (the server's ingest) keeps
    # its own counter, so neither counts the other's reads
    from gelly_streaming_tpu_torch.summaries import labels as tl

    canon = np.arange(64, dtype=np.int32)
    canon[1:] = np.arange(63, dtype=np.int32)  # one chain: 6 jumping turns
    q0, f0 = tq.HOST_READS, tl.HOST_READS
    tq._component_size_table(torch.from_numpy(canon))
    assert tq.HOST_READS - q0 == 7  # 6 turns that move, 1 that finds none
    assert tl.HOST_READS == f0


# --------------------------------------------------------------------- #
# 2. QueryEngine, both paths, against the JAX engine
# --------------------------------------------------------------------- #
def _payloads(seed, vcap=64):
    """Equal payloads for both packages: a CC forest, degrees, ranks and a
    bipartiteness cover over raw ids ``3 * compact``."""
    rng = np.random.default_rng(seed)
    canon = _forest(seed, vcap=vcap, chain=40)
    deg = rng.integers(0, 9, vcap).astype(np.int32)
    ranks = rng.random(vcap).astype(np.float32)
    cover = np.arange(2 * vcap, dtype=np.int32)
    for v in range(5, 20):  # an odd cycle's conflict: v and v+vcap joined
        cover[v + vcap] = v if v % 4 == 0 else v + vcap
    tids = rng.permutation(vcap).astype(np.int32)
    tcount = vcap - 5
    raw = np.arange(vcap, dtype=np.int64) * 3
    out = []
    for pkg in (gt, gj):
        vd = pkg.VertexDict()
        vd.encode(raw)
        out.append({"labels": canon, "deg": deg, "ranks": ranks, "cover": cover,
                    "tids": tids, "tcount": tcount, "vdict": vd})
    return out


def _queries(mod, seed, vcap=64):
    rng = np.random.default_rng(seed + 7)
    raw = lambda: int(rng.integers(0, 3 * vcap + 6))  # noqa: E731 (unseen ids too)
    qs = []
    for _ in range(40):
        qs += [mod.ConnectedQuery(raw(), raw()), mod.ComponentSizeQuery(raw()),
               mod.DegreeQuery(raw()), mod.RankQuery(raw())]
    return qs + [mod.SummaryPullQuery(), mod.BipartiteQuery()]


def _as_port(payload, tensors):
    if not tensors:
        return payload
    return {k: torch.from_numpy(v.copy()) if isinstance(v, np.ndarray) and k != "tids"
            else v for k, v in payload.items()}


@pytest.mark.parametrize("prefer_host,tensors", [
    (True, False), (True, True), (False, False), (False, True), ("auto", True)])
def test_query_engine_answers_equal_the_jax_engine(prefer_host, tensors):
    import json

    tp, jp = _payloads(3)
    tsnap = PublishedSnapshot(payload=_as_port(tp, tensors), window=4, watermark=9,
                              version=2, epoch=1)
    jsnap = jserving.PublishedSnapshot(payload=jp, window=4, watermark=9, version=2,
                                       epoch=1)
    from gelly_streaming_tpu_torch import serving as tserving

    before = tq.HOST_READS
    got = QueryEngine(prefer_host=prefer_host).answer_batch(
        tsnap, _queries(tserving, 3), head_window=6)
    want = jq.QueryEngine(prefer_host=False).answer_batch(
        jsnap, _queries(jserving, 3), head_window=6)
    assert [(a.value, a.window, a.staleness, a.version) for a in got[:-2]] == \
        [(a.value, a.window, a.staleness, a.version) for a in want[:-2]]
    # the pull doc byte for byte, and the bipartite verdict + witness
    assert json.dumps(got[-2].value) == json.dumps(want[-2].value)
    assert got[-1].value == want[-1].value and got[-1].value["bipartite"] is False
    # the torch steps read their loop conditions to the host (downloads
    # count only on a card); the host path reads nothing
    if prefer_host is False:
        assert tq.HOST_READS - before >= 1
    else:
        assert tq.HOST_READS == before


def test_summary_pull_delta_chain_equals_the_jax_engines():
    """Two versions of a forest: full and delta pulls (covered, stale,
    ahead, equal) are byte-identical to the JAX engine's."""
    import json

    engines = (QueryEngine(), jq.QueryEngine())
    tp, jp = _payloads(5)
    canon2 = tp["labels"].copy()
    canon2[50:64] = 0  # a merge: the roots of 50..63 and their subtrees change
    docs = []
    for eng, payload, snap_cls in ((engines[0], tp, PublishedSnapshot),
                                   (engines[1], jp, jserving.PublishedSnapshot)):
        out = []
        for version, canon in ((1, payload["labels"]), (2, canon2)):
            snap = snap_cls(payload={**payload, "labels": canon}, window=version,
                            watermark=version, version=version, epoch=7)
            for since in (-1, 0, 1, 2, 5):
                out.append(json.dumps(eng.summary_pull(snap, since)))
        docs.append(out)
    assert docs[0] == docs[1]
    delta = tq.decode_pull_doc(json.loads(docs[0][7]))  # v2 since v1
    assert delta["kind"] == "delta" and 0 < delta["n"] < 64


@pytest.mark.parametrize("doc,kind", [
    ("x", "type"), ({"kind": "odd", "n": 0, "u64": "", "r64": ""}, "tag"),
    ({"n": 0, "u64": ""}, "missing"), ({"n": -1, "u64": "", "r64": ""}, "type"),
    ({"n": 1, "u64": "!!", "r64": ""}, "b64"), ({"n": 2, "u64": "", "r64": ""}, "geometry"),
    ({"kind": "delta", "n": 0, "u64": "", "r64": ""}, "base"),
])
def test_pull_doc_decode_rejects_alike(doc, kind):
    with pytest.raises(tq.MalformedPull) as got:
        tq.decode_pull_doc(doc)
    with pytest.raises(jq.MalformedPull) as want:
        jq.decode_pull_doc(doc)
    assert got.value.kind == want.value.kind == kind


# --------------------------------------------------------------------- #
# 3. Live serving against the oracle and the JAX engine
# --------------------------------------------------------------------- #
def _dsu_window_roots(src, dst, window, n_vertices):
    parent = list(range(n_vertices))

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    out = []
    for start in range(0, len(src), window):
        for a, b in zip(src[start:start + window], dst[start:start + window]):
            ra, rb = find(int(a)), find(int(b))
            if ra != rb:
                parent[max(ra, rb)] = min(ra, rb)
        out.append(np.asarray([find(v) for v in range(n_vertices)]))
    return out


def _jax_window_snapshots(edges, window):
    """The JAX package's CC payload at every window, as snapshots."""
    stream = gj.SimpleEdgeStream(edges, window=gj.CountWindow(window))
    snaps = []
    for w, (payload, wm) in enumerate(JaxCC().servable()
                                      .payloads(stream)):
        frozen = {**payload, "labels": np.asarray(payload["labels"]).copy()}
        snaps.append(jserving.PublishedSnapshot(payload=frozen, window=w,
                                                watermark=wm, version=w + 1))
    return snaps


@pytest.mark.parametrize("carry", ["forest", "host", "dense"])
def test_live_answers_match_the_oracle_and_the_jax_engine(carry):
    rng = np.random.default_rng(42)
    n_vertices, window, n_win = 96, 50, 16
    src = rng.integers(0, n_vertices, window * n_win)
    dst = rng.integers(0, n_vertices, window * n_win)
    edges = [(int(a), int(b), 0.0) for a, b in zip(src, dst)]
    roots = _dsu_window_roots(src, dst, window, n_vertices)
    jsnaps = _jax_window_snapshots(edges, window)
    jengine = jq.QueryEngine()
    gate = threading.Event()

    def slowed():
        for i, e in enumerate(edges):
            if i % window == 0 and i:
                gate.wait(0.002)  # let queries land mid-stream
            yield e

    stream = gt.SimpleEdgeStream(slowed(), window=gt.CountWindow(window), device="cpu")
    server = StreamServer(ConnectedComponents(carry=carry).servable(), stream,
                          max_pending=1 << 14).start()
    qu = rng.integers(0, n_vertices, 1500)
    qv = rng.integers(0, n_vertices, 1500)
    futures = []
    for i in range(len(qu)):
        futures.append(server.submit(ConnectedQuery(int(qu[i]), int(qv[i]))))
        if i % 100 == 0:
            time.sleep(0.001)
    gate.set()
    windows = set()
    try:
        for i, f in enumerate(futures):
            ans = f.result(60)
            windows.add(ans.window)
            r = roots[ans.window]
            assert ans.value == bool(r[qu[i]] == r[qv[i]]), (i, ans)
            jans = jengine.answer_batch(jsnaps[ans.window],
                                        [jserving.ConnectedQuery(int(qu[i]), int(qv[i]))])
            assert ans.value == jans[0].value
        server.join(60)
        final = server.ask(ComponentSizeQuery(int(qu[0])), 30)
        assert final.staleness == 0 and final.window == n_win - 1
        jfinal = jengine.answer_batch(jsnaps[-1], [jserving.ComponentSizeQuery(int(qu[0]))])
        assert final.value == jfinal[0].value
    finally:
        server.close()
    stats = server.stats.snapshot()
    assert stats["queries"]["ConnectedQuery"]["count"] == len(qu) + 0
    assert stats["batches"] < len(qu)


def test_component_size_and_final_components_match_oracle():
    rng = np.random.default_rng(3)
    n_vertices = 40
    src = rng.integers(0, n_vertices, 300)
    dst = rng.integers(0, n_vertices, 300)
    edges = [(int(a), int(b), 0.0) for a, b in zip(src, dst)]
    stream = gt.SimpleEdgeStream(edges, window=gt.CountWindow(64), device="cpu")
    with StreamServer(ConnectedComponents().servable(), stream) as server:
        server.join(60)
        comps = union_find_components(zip(src.tolist(), dst.tolist()))
        by_vertex = {v: comp for comp in comps for v in comp}
        for v in range(n_vertices):
            size = server.ask(ComponentSizeQuery(v), 30)
            if v not in by_vertex:
                assert size.value in (0, 1)
            else:
                assert size.value == len(by_vertex[v]), (v, size)
        u, v = sorted(by_vertex)[0], sorted(by_vertex)[-1]
        assert server.ask(ConnectedQuery(u, v), 30).value == (by_vertex[u] is by_vertex[v])


def test_staleness_zero_after_stream_end():
    edges = [(i, (i + 1) % 100, 0.0) for i in range(100)]
    stream = gt.SimpleEdgeStream(edges, window=gt.CountWindow(10), device="cpu")
    with StreamServer(ConnectedComponents().servable(), stream) as server:
        server.join(60)
        ans = server.ask(ConnectedQuery(0, 99), 30)
        assert ans.value is True
        assert ans.window == 9 and ans.staleness == 0
        assert ans.watermark == 100  # exact edge watermark (host cache)


def test_snapshot_swap_atomicity_under_writer():
    store = SnapshotStore()
    n_pub = 2000
    stop = threading.Event()
    torn = []

    def write():
        for i in range(n_pub):
            a = torch.full((8,), i)
            store.publish({"a": a, "b": -a}, window=i, watermark=i)
        stop.set()

    def read():
        last = 0
        while not stop.is_set() or store.latest() is None:
            snap = store.latest()
            if snap is None:
                continue
            a, b = snap.payload["a"], snap.payload["b"]
            if not torch.equal(a, -b) or int(a[0]) != snap.window:
                torn.append(snap.version)
            if snap.version < last:
                torn.append(("version regressed", snap.version))
            last = snap.version
            # a host payload has no publish event: always ready
            assert snap.ready is None and store.latest(prefer_ready=True) is not None

    readers = [threading.Thread(target=read) for _ in range(3)]
    w = threading.Thread(target=write)
    for t in readers + [w]:
        t.start()
    for t in [w] + readers:
        t.join(30)
    assert not any(t.is_alive() for t in readers + [w])
    assert not torn
    final = store.latest()
    assert final.version == n_pub and final.window == n_pub - 1


def test_wrong_query_class_rejected_synchronously():
    stream = gt.SimpleEdgeStream([(0, 1, 0.0), (1, 2, 0.0)], window=gt.CountWindow(2),
                                 device="cpu")
    with StreamServer(ConnectedComponents().servable(), stream) as server:
        server.join(60)
        with pytest.raises(TypeError, match="DegreeQuery"):
            server.submit(DegreeQuery(0))
        assert server.ask(ConnectedQuery(0, 2), 30).value is True


def test_overloaded_rejection_at_queue_limit():
    release = threading.Event()

    def blocked_payloads():
        release.wait(30)
        return
        yield  # pragma: no cover

    server = StreamServer(blocked_payloads(), None, max_pending=4).start()
    futs = [server.submit(ConnectedQuery(0, 1)) for _ in range(4)]
    with pytest.raises(Overloaded):
        server.submit(ConnectedQuery(0, 1))
    assert server.stats.snapshot()["rejected"] == 1
    release.set()
    server.close()
    for f in futs:
        with pytest.raises(RuntimeError):
            f.result(5)


def test_pending_gauge_clears_after_settle():
    rng = np.random.default_rng(21)
    edges = [(int(a), int(b), 0.0) for a, b in rng.integers(0, 32, (200, 2))]
    stream = gt.SimpleEdgeStream(edges, window=gt.CountWindow(50), device="cpu")
    server = StreamServer(ConnectedComponents().servable(), stream, max_pending=1024).start()
    futs = [server.submit(ConnectedQuery(int(a), int(b)))
            for a, b in rng.integers(0, 32, (40, 2))]
    for f in futs:
        f.result(60)
    server.join(60)
    server.close()
    assert server.stats.registry.gauge("serving.pending").value == 0.0


# --------------------------------------------------------------------- #
# 4. Checkpoint boot from either package's checkpoint
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_checkpoint_boot_then_serve(tmp_path, writer):
    from gelly_streaming_tpu.aggregate import checkpoint as jck
    from gelly_streaming_tpu_torch.aggregate.checkpoint import (
        load_vertex_dict,
        restore_server,
    )

    rng = np.random.default_rng(7)
    n_vertices = 64
    raw_ids = rng.permutation(10_000)[:n_vertices]
    e1, f1, e2, f2 = rng.integers(0, n_vertices, (4, 400))

    def pairs(es, fs):
        return [(int(raw_ids[a]), int(raw_ids[b]), 0.0) for a, b in zip(es, fs)]

    path = str(tmp_path / "cc")
    if writer == "port":
        from gelly_streaming_tpu_torch.aggregate.checkpoint import save_aggregation

        s1 = gt.SimpleEdgeStream(pairs(e1, f1), window=gt.CountWindow(50), device="cpu")
        agg1 = ConnectedComponents()
        for _ in s1.aggregate(agg1):
            pass
        save_aggregation(path, agg1, vdict=s1.vertex_dict)
    else:
        s1 = gj.SimpleEdgeStream(pairs(e1, f1), window=gj.CountWindow(50))
        agg1 = JaxCC()
        for _ in s1.aggregate(agg1):
            pass
        jck.save_aggregation(path, agg1, vdict=s1.vertex_dict)
    vdict = load_vertex_dict(path)
    s2 = gt.SimpleEdgeStream(pairs(e2, f2), window=gt.CountWindow(50),
                             vertex_dict=vdict, device="cpu")
    server = restore_server(path, ConnectedComponents(), s2)
    try:
        boot = server.snapshot()
        assert boot is not None and boot.version >= 1
        half = union_find_components([p[:2] for p in pairs(e1, f1)])
        by_v1 = {v: c for c in half for v in c}
        u, v, _ = pairs(e1, f1)[0]
        ans = server.ask(ConnectedQuery(u, v), 30)
        if ans.window == -1:
            assert ans.value == (by_v1.get(u) is by_v1.get(v) and u in by_v1)
        server.join(60)
        full = union_find_components([p[:2] for p in pairs(e1, f1) + pairs(e2, f2)])
        by_v = {v: c for c in full for v in c}
        for a, b in rng.integers(0, n_vertices, (200, 2)):
            u, v = int(raw_ids[a]), int(raw_ids[b])
            want = (u in by_v and by_v.get(u) is by_v.get(v)) or u == v
            got = server.ask(ConnectedQuery(u, v), 30)
            assert got.value == want and got.staleness == 0, (u, v, got)
    finally:
        server.close()


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_degree_workload_boots_from_either_packages_checkpoint(tmp_path, writer):
    from gelly_streaming_tpu.aggregate import checkpoint as jck
    from gelly_streaming_tpu.library.degrees import DegreeDistribution as JaxDD
    from gelly_streaming_tpu_torch.aggregate import checkpoint as tck

    events = [(1, 2, "+"), (2, 3, "+"), (1, 3, "+"), (5, 6, "+")]
    path = str(tmp_path / "dd")
    if writer == "port":
        dd = DegreeDistribution(gt.CountWindow(2), device="cpu")
        list(dd.run(events))
        tck.save_workload(path, dd, vdict=dd._windower.vertex_dict)
    else:
        dd = JaxDD(window=gj.CountWindow(2))
        list(dd.run(events))
        jck.save_workload(path, dd, vdict=dd._windower.vertex_dict)
    server = tck.restore_server(path, DegreeDistribution(gt.CountWindow(2), device="cpu"),
                                [], start=False)
    server.start()
    try:
        got = [server.ask(DegreeQuery(v), 30) for v in (1, 2, 3, 5, 99)]
        assert [a.value for a in got] == [2, 2, 2, 1, 0]
        assert {a.window for a in got} == {-1}
    finally:
        server.close()


# --------------------------------------------------------------------- #
# 5. Snapshot immutability, every carry, superbatch 1 and 4
# --------------------------------------------------------------------- #
def _frozen(payload):
    out = {}
    for k, v in payload.items():
        if k == "tids":
            out[k] = np.array(v[: payload["tcount"]], copy=True)
        elif isinstance(v, torch.Tensor):
            out[k] = v.detach().cpu().numpy().copy()
        elif isinstance(v, np.ndarray):
            out[k] = v.copy()
    return out


def _assert_held_snapshot_unchanged(servable, source, windows):
    it = servable.payloads(source)
    first, _wm = next(it)
    held = _frozen(first)
    rest = sum(1 for _ in it)
    assert rest >= windows - 2  # later windows really folded
    for k, v in _frozen(first).items():
        np.testing.assert_array_equal(v, held[k], err_msg=k)
    return first


def _cc_edges(n=8 * 64, vmax=120, seed=11):
    rng = np.random.default_rng(seed)
    return [(int(a), int(b), 0.0) for a, b in rng.integers(0, vmax, (n, 2))]


@pytest.mark.parametrize("superbatch", [1, 4])
@pytest.mark.parametrize("carry", ["forest", "host", "dense"])
def test_held_cc_snapshot_is_immutable(carry, superbatch):
    stream = gt.SimpleEdgeStream(_cc_edges(), window=gt.CountWindow(64), device="cpu")
    agg = ConnectedComponents(carry=carry, superbatch=superbatch)
    first = _assert_held_snapshot_unchanged(agg.servable(), stream, 8)
    assert agg._cc_mode == carry and first["labels"] is not agg._summary["labels"]


@pytest.mark.parametrize("superbatch", [1, 4])
@pytest.mark.parametrize("carry", ["forest", "host", "dense"])
def test_held_bipartiteness_snapshot_is_immutable(carry, superbatch):
    stream = gt.SimpleEdgeStream(_cc_edges(seed=12), window=gt.CountWindow(64),
                                 device="cpu")
    agg = BipartitenessCheck(carry=carry, superbatch=superbatch)
    _assert_held_snapshot_unchanged(agg.servable(), stream, 8)
    assert agg._bp_mode == carry


@pytest.mark.parametrize("superbatch", [1, 4])
def test_held_rank_snapshot_is_immutable(superbatch):
    stream = gt.SimpleEdgeStream(_cc_edges(seed=13), window=gt.CountWindow(64),
                                 device="cpu")
    pr = IncrementalPageRank(tol=1e-4, superbatch=superbatch)
    _assert_held_snapshot_unchanged(pr.servable(), stream, 8)


def test_held_degree_snapshot_is_immutable():
    rng = np.random.default_rng(14)
    events = [(int(a), int(b), "+" if rng.random() < 0.8 else "-")
              for a, b in rng.integers(0, 50, (512, 2))]
    dd = DegreeDistribution(gt.CountWindow(64), device="cpu")
    _assert_held_snapshot_unchanged(dd.servable(), events, 8)


# --------------------------------------------------------------------- #
# 6. Degree, rank and bipartiteness serving
# --------------------------------------------------------------------- #
def test_degree_serving_matches_truth_and_the_jax_servable():
    from gelly_streaming_tpu.library.degrees import DegreeDistribution as JaxDD

    rng = np.random.default_rng(5)
    events = [(int(a), int(b), "+") for a, b in rng.integers(0, 32, (500, 2))]
    deg = {}
    for a, b, _ in events:
        deg[a] = deg.get(a, 0) + 1
        deg[b] = deg.get(b, 0) + 1
    servers = (StreamServer(DegreeDistribution(gt.CountWindow(64), device="cpu")
                            .servable(), events),
               jserving.StreamServer(JaxDD(window=gj.CountWindow(64)).servable(), events))
    for s in servers:
        s.start()
    try:
        for s in servers:
            s.join(60)
        for v in list(range(32)) + [10_000]:
            got = servers[0].ask(DegreeQuery(v), 30)
            want = servers[1].ask(jserving.DegreeQuery(v), 30)
            assert got.value == want.value == deg.get(v, 0), v
            assert (got.window, got.watermark) == (want.window, want.watermark)
    finally:
        for s in servers:
            s.close()


def test_rank_serving_matches_ranks_view_and_the_jax_servable():
    from gelly_streaming_tpu.library.pagerank import IncrementalPageRank as JaxPR

    rng = np.random.default_rng(9)
    edges = [(int(a), int(b), 0.0) for a, b in rng.integers(0, 32, (400, 2))]
    pr = IncrementalPageRank(tol=1e-5, max_iter=200)
    jpr = JaxPR(tol=1e-5, max_iter=200)
    server = StreamServer(pr.servable(), gt.SimpleEdgeStream(
        edges, window=gt.CountWindow(100), device="cpu")).start()
    jserver = jserving.StreamServer(jpr.servable(), gj.SimpleEdgeStream(
        edges, window=gj.CountWindow(100))).start()
    try:
        server.join(60)
        jserver.join(60)
        truth = pr.ranks()
        for v, want in list(truth.items())[:16]:
            got = server.ask(RankQuery(v), 30)
            np.testing.assert_allclose(got.value, want, rtol=1e-5)
            np.testing.assert_allclose(got.value,
                                       jserver.ask(jserving.RankQuery(v), 30).value,
                                       rtol=1e-4, atol=1e-6)
        assert server.ask(RankQuery(99_999), 30).value == 0.0
    finally:
        server.close()
        jserver.close()


@pytest.mark.parametrize("carry", ["forest", "host", "dense"])
def test_bipartite_serving_matches_the_jax_servable(carry):
    edges_ok = [(2 * i, 2 * i + 1, 0.0) for i in range(20)] + \
        [(2 * i + 1, 2 * i + 2, 0.0) for i in range(19)]
    edges_odd = edges_ok + [(4, 8, 0.0), (3, 9, 0.0)]  # an odd cycle, even first
    answers = []
    for edges in (edges_ok, edges_odd):
        server = StreamServer(BipartitenessCheck(carry=carry).servable(), gt.SimpleEdgeStream(
            edges, window=gt.CountWindow(16), device="cpu")).start()
        jserver = jserving.StreamServer(
            JaxBC().servable(),
            gj.SimpleEdgeStream(edges, window=gj.CountWindow(16))).start()
        try:
            server.join(60)
            jserver.join(60)
            got = server.ask(BipartiteQuery(), 30)
            want = jserver.ask(jserving.BipartiteQuery(), 30)
            assert got.value == want.value and got.window == want.window
            answers.append(got.value)
        finally:
            server.close()
            jserver.close()
    assert answers[0] == {"bipartite": True, "witness": None}
    assert answers[1]["bipartite"] is False


# --------------------------------------------------------------------- #
# 7. Deadlines, retry, shedding (tests/test_resilience.py:599-714)
# --------------------------------------------------------------------- #
def _held_server(**kw):
    release = threading.Event()

    def blocked_payloads():
        release.wait(30)
        return
        yield  # pragma: no cover

    return StreamServer(blocked_payloads(), None, **kw), release


def test_serving_deadline_expires_unanswered_query(registry):
    server, release = _held_server(max_pending=8)
    server.start()
    try:
        f = server.submit(ConnectedQuery(0, 1), deadline_s=0.01)
        with pytest.raises(DeadlineExceeded):
            f.result(10)
        assert registry.counter("serving.deadline_expired").value == 1
        deadline = time.perf_counter() + 5
        while time.perf_counter() < deadline:
            if server.stats.registry.gauge("serving.pending").value == 0:
                break
            time.sleep(0.01)
        assert server.stats.registry.gauge("serving.pending").value == 0
    finally:
        release.set()
        server.close()


def test_serving_retry_policy_rides_out_a_stall(registry):
    labels = torch.arange(4, dtype=torch.int32)
    labels[1] = 0
    vdict = IdentityDict(4)
    vdict.observe(3)

    def payloads():
        yield {"labels": labels, "vdict": vdict}, 1

    with faults.injected(FaultPlan(stall_site="serving.worker", stall_s=0.25)):
        server = StreamServer(payloads(), None, max_pending=1).start()
        try:
            first = server.submit(ConnectedQuery(0, 1))
            with pytest.raises(Overloaded):
                server.submit(ConnectedQuery(0, 1))
            f = server.submit(ConnectedQuery(0, 1), retry_policy=RetryPolicy(
                attempts=20, base_s=0.02, max_s=0.05, jitter=0.0))
            assert first.result(10).value is True
            assert f.result(10).value is True
            assert registry.counter("serving.retries").value >= 1
        finally:
            server.close()


def test_serving_sheds_low_priority_class_under_pressure(registry):
    server, release = _held_server(max_pending=4, shed_classes=(ComponentSizeQuery,),
                                   shed_watermark=0.5, shed_after_s=0.0)
    for _ in range(2):
        server.submit(ConnectedQuery(0, 1))
    with pytest.raises(Shed):
        server.submit(ComponentSizeQuery(1))
    assert registry.counter("serving.shed", cls="ComponentSizeQuery").value == 1
    server.submit(ConnectedQuery(0, 1))
    server.submit(ConnectedQuery(0, 1))
    with pytest.raises(Overloaded):
        server.submit(ConnectedQuery(0, 1))
    t0 = time.perf_counter()
    with pytest.raises(Shed):
        server.submit(ComponentSizeQuery(2),
                      retry_policy=RetryPolicy(attempts=50, base_s=0.05))
    assert time.perf_counter() - t0 < 0.5
    release.set()


def test_autotuned_admission_moves_inside_its_ceiling(registry):
    """``autotune=True`` wires the ported AdmissionTuner: a sweep whose
    queue wait eats the deadline budget tightens ``max_pending`` below
    the configured ceiling, never above it."""
    server, release = _held_server(max_pending=64, autotune=True)
    try:
        assert server.admission is not None and server.admission.ceiling == 64
        t0 = time.perf_counter() - 1.0
        for _ in range(3 * server.admission.decide_sweeps):
            if server.admission.tap_entries(0.9, [(t0, t0 + 1.0)]):
                server.max_pending = server.admission.max_pending
        assert server.max_pending < 64
    finally:
        release.set()
        server.close()


# --------------------------------------------------------------------- #
# 8. Failover (tests/test_coordinated.py:522-627)
# --------------------------------------------------------------------- #
def _failover_pair(**kw):
    vd = IdentityDict(8)
    vd.observe(7)
    labels = torch.arange(8, dtype=torch.int32)
    labels[1] = 0
    hold = threading.Event()

    def payloads():
        yield {"labels": labels, "vdict": vd}, 1
        hold.wait(30)

    return FailoverServer(payloads(), None, **kw), hold


def test_failover_monitor_promotes_on_worker_death(registry):
    with faults.injected(FaultPlan(kill_site="serving.worker", kill_at_window=3)):
        fs, hold = _failover_pair(monitor_s=0.005, max_pending=16)
        fs.start()
        try:
            fs.store.wait_for(1, timeout=20)
            deadline = time.monotonic() + 20
            while not fs.promoted and time.monotonic() < deadline:
                time.sleep(0.005)
            assert fs.promoted and not fs.primary.worker_alive()
            assert fs.ask(ConnectedQuery(0, 1), timeout=20).value is True
            assert fs.active is fs.standby
        finally:
            hold.set()
            fs.close()
    assert registry.counter("serving.failover", reason="worker_death").value == 1
    assert registry.counter("serving.worker_deaths").value == 1


def test_fault_plan_kill_at_or_after_fires_once_at_the_first_ordinal_past():
    plan = FaultPlan(kill_site="serving.worker.busy", kill_at_window=5,
                     kill_at_or_after=True)
    plan.fire("serving.worker.busy", index=3)
    plan.fire("serving.worker", index=7)  # another site
    with pytest.raises(faults.SimulatedCrash, match="window 8"):
        plan.fire("serving.worker.busy", index=8)
    plan.fire("serving.worker.busy", index=9)  # one-shot
    exact = FaultPlan(kill_site="serving.worker.busy", kill_at_window=5)
    exact.fire("serving.worker.busy", index=8)  # the reference's rule: == only


def test_busy_kill_waits_for_a_sweep_with_a_batch(registry):
    # the replicas' kill_at_sweep: idle sweeps past N pass, and the worker
    # dies at the first sweep that finds a query pending, so a batch is in
    # flight at the kill
    plan = FaultPlan(kill_site="serving.worker.busy", kill_at_window=2,
                     kill_at_or_after=True)
    with faults.injected(plan):
        fs, hold = _failover_pair(monitor_s=None, max_pending=16)
        srv = fs.primary
        fs.start()
        try:
            fs.store.wait_for(1, timeout=20)
            deadline = time.monotonic() + 20
            while srv._sweeps <= 4 and time.monotonic() < deadline:
                time.sleep(0.01)
            assert srv._sweeps > 4 and srv.worker_alive()
            f = srv.submit(ConnectedQuery(0, 1))
            while srv.worker_alive() and time.monotonic() < deadline:
                time.sleep(0.005)
            assert not srv.worker_alive() and not f.done()
        finally:
            hold.set()
            fs.close()
    assert registry.counter("serving.worker_deaths").value == 1
    assert registry.counter("resilience.fault_injected",
                            site="serving.worker.busy").value == 1


def test_failover_expires_late_queries_and_reanswers_the_rest(registry):
    with faults.injected(FaultPlan(kill_site="serving.worker", kill_at_window=3)):
        fs, hold = _failover_pair(monitor_s=None, max_pending=16)
        fs.start()
        try:
            fs.store.wait_for(1, timeout=20)
            deadline = time.monotonic() + 20
            while fs.primary.worker_alive() and time.monotonic() < deadline:
                time.sleep(0.005)
            assert not fs.primary.worker_alive()
            f_exp = fs.primary.submit(ConnectedQuery(0, 1), deadline_s=0.005)
            f_ok = fs.primary.submit(ConnectedQuery(0, 1))
            f_ok2 = fs.primary.submit(ConnectedQuery(0, 1), deadline_s=20.0)
            time.sleep(0.02)
            fs.promote(reason="worker_death")
            with pytest.raises(DeadlineExceeded):
                f_exp.result(20)
            assert f_ok.result(20).value is True
            assert f_ok2.result(20).value is True
        finally:
            hold.set()
            fs.close()
    assert registry.counter("serving.failover_requeued").value == 2
    assert registry.counter("serving.failover_expired").value == 1
    assert registry.counter("serving.deadline_expired").value == 1


def test_failover_policies_carry_over(registry):
    rp = RetryPolicy(attempts=2)
    fs, hold = _failover_pair(monitor_s=None, max_pending=2, retry_policy=rp,
                              shed_classes=("ComponentSizeQuery",))
    fs.start()
    try:
        fs.store.wait_for(1, timeout=20)
        for srv in (fs.primary, fs.standby):
            assert srv.max_pending == 2 and srv.retry_policy is rp
            assert srv._shed_names == {"ComponentSizeQuery"}
            assert srv.stats is fs.stats and srv.store is fs.store
        fs.promote(reason="manual")
        fs.promote(reason="manual")
        assert registry.counter("serving.failover", reason="manual").value == 1
        assert fs.ask(ConnectedQuery(0, 1), timeout=20).value is True
    finally:
        hold.set()
        fs.close()


# --------------------------------------------------------------------- #
# 9. The example CLI and the reduced single-process kill sweep
# --------------------------------------------------------------------- #
def test_serving_queries_cli_equals_the_jax_packages():
    from gelly_streaming_tpu.example import serving_queries as jcli
    from gelly_streaming_tpu_torch.example import serving_queries as tcli

    edges = [(k, k + 2, 0.0) for k in range(1, 101)]
    got = tcli.run(edges, 16, device="cpu")
    want = jcli.run(edges, 16)
    # the final lines carry no timing: equal; the live lines' windows race
    assert [x for x in got if x.startswith("final")] == \
        [x for x in want if x.startswith("final")]
    assert len(got) == len(want)


@pytest.mark.slow
def test_chaos_kill_sweep_reduced_on_the_cpu(tmp_path):
    from gelly_streaming_tpu_torch.resilience import chaos

    doc = chaos.run_sweep(windows=5, window_edges=96, superbatch=2, every=2,
                          workdir=str(tmp_path), device="cpu", log=lambda s: None)
    assert doc["ok"], doc["points"]
    assert doc["kill_points"] == 5
