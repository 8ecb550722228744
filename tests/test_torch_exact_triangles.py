"""Streaming exact triangles and the packed sorted adjacency: the port
against the JAX package.

The same inputs, made with numpy from a seed, go through
``gelly_streaming_tpu`` and ``gelly_streaming_tpu_torch`` (on the CPU).
Every result is an integer and must match exactly: each packed operation's
output columns, positions and counts, and ``ExactTriangleCount``'s
per-window batches and running totals.

Mirrors ``tests/test_triangles.py:76-140`` (final counts, once per triangle
across windows, the incremental stream against brute force) and
``:157-345`` (the large recount with growth, the merge-path property, the
ranged search property, a ``distinct()`` stream, the checkpoint round trip
with duplicates), plus the CLI (``tests/test_examples.py:83``).
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gelly_streaming_tpu as gj
import gelly_streaming_tpu_torch as gt
from gelly_streaming_tpu.datasets import IdentityDict as JaxIdentityDict
from gelly_streaming_tpu.example import exact_triangle_count as jax_cli
from gelly_streaming_tpu.library.triangles import ExactTriangleCount as JaxETC
from gelly_streaming_tpu.ops import triangles as jtri
from gelly_streaming_tpu_torch.datasets import IdentityDict
from gelly_streaming_tpu_torch.example import exact_triangle_count as torch_cli
from gelly_streaming_tpu_torch.library.triangles import GLOBAL_KEY
from gelly_streaming_tpu_torch.library.triangles import ExactTriangleCount as TorchETC
from gelly_streaming_tpu_torch.ops import triangles as ttri

BIG = np.iinfo(np.int32).max

# ExamplesTestData.TRIANGLES_DATA (src, trg), as tests/test_triangles.py:22
TRIANGLES_DATA = [
    (1, 2), (1, 3), (3, 2), (2, 4), (3, 4), (3, 5), (4, 5), (4, 6), (6, 5), (5, 7),
    (6, 7), (8, 6), (7, 8), (7, 9), (8, 9), (10, 8), (9, 10), (9, 11), (10, 11),
]


def _t(a, dtype=torch.int32):
    return torch.as_tensor(np.asarray(a)).to(dtype)


def _j(a, dtype=jnp.int32):
    return jnp.asarray(np.asarray(a), dtype)


def _eq(jx, tx):
    np.testing.assert_array_equal(np.asarray(jx), tx.numpy())


def _random_edges(seed, n, v):
    rng = np.random.default_rng(seed)
    return [(int(a), int(b), 0.0) for a, b in rng.integers(0, v, size=(n, 2))]


def _batches(workload, stream):
    return [list(b) for b in workload.run(stream)]


def _run_both(edges, window, vdict_bound=None):
    jd = JaxIdentityDict(vdict_bound) if vdict_bound else None
    td = IdentityDict(vdict_bound) if vdict_bound else None
    jet, tet = JaxETC(), TorchETC()
    jout = _batches(jet, gj.SimpleEdgeStream(edges, window=gj.CountWindow(window), vertex_dict=jd))
    tout = _batches(tet, gt.SimpleEdgeStream(edges, window=gt.CountWindow(window),
                                             vertex_dict=td, device="cpu"))
    return jout, tout, jet, tet


def _brute_force(edges):
    adj = {}
    for s, d, *_ in edges:
        if s != d:
            adj.setdefault(s, set()).add(d)
            adj.setdefault(d, set()).add(s)
    counts = {v: 0 for v in adj}
    total = 0
    for a, b, c in itertools.combinations(sorted(adj), 3):
        if b in adj[a] and c in adj[a] and c in adj[b]:
            total += 1
            for x in (a, b, c):
                counts[x] += 1
    return total, counts


# --------------------------------------------------------------------- #
# The packed operations, one by one
# --------------------------------------------------------------------- #
def test_ranged_searchsorted_matches_jax_and_numpy():
    rng = np.random.default_rng(22)
    runs = [np.sort(rng.integers(0, 100, rng.integers(0, 20))) for _ in range(8)]
    arr = np.concatenate(runs)
    bounds = np.cumsum([0] + [len(r) for r in runs])
    for side in ("left", "right"):
        los, his, xs, want = [], [], [], []
        for i, r in enumerate(runs):
            for q in rng.integers(-5, 110, 10):
                los.append(bounds[i])
                his.append(bounds[i + 1])
                xs.append(q)
                want.append(bounds[i] + np.searchsorted(r, q, side=side))
        for steps in (3, 32):
            got = ttri.ranged_searchsorted(_t(arr), _t(los), _t(his), _t(xs), side=side,
                                           steps=steps)
            ref = jtri.ranged_searchsorted(_j(arr), _j(los), _j(his), _j(xs), side=side,
                                           steps=steps)
            _eq(ref, got)
            assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("side", ["left", "right"])
def test_count_composite_matches_jax(side):
    rng = np.random.default_rng(5)
    keys = np.unique(rng.integers(0, 40, (60, 2)), axis=0)
    sv = np.concatenate([keys[:, 0], np.full(4, BIG)])
    sn = np.concatenate([keys[:, 1], np.zeros(4, np.int64)])
    q = rng.integers(0, 42, (50, 2))
    q = np.concatenate([q, keys[:10]])
    got = ttri._count_composite(_t(sv), _t(sn), _t(q[:, 0]), _t(q[:, 1]), side)
    ref = jtri._count_composite(_j(sv), _j(sn), _j(q[:, 0]), _j(q[:, 1]), side)
    _eq(ref, got)


def test_merge_packed_adjacency_matches_jax_and_lexsort():
    """Merge-path result == lexsort of the concatenation (random rounds,
    disjoint keys, sentinel padding), equal to the JAX op each round."""
    rng = np.random.default_rng(21)
    acc = np.zeros((0, 3), np.int64)
    tpv, tpn, tpr = ttri.grow_packed_columns(None, None, None, 8, device="cpu")
    jpv, jpn, jpr = jtri.grow_packed_columns(None, None, None, 8)
    seen = set()
    for _ in range(6):
        cand = rng.integers(0, 50, (rng.integers(1, 40), 2))
        fresh = list(dict.fromkeys(tuple(x) for x in cand if tuple(x) not in seen))
        if not fresh:
            continue
        new = np.array(fresh, np.int64)
        ranks = rng.integers(0, 1000, len(new))
        order = np.lexsort((new[:, 1], new[:, 0]))
        nv, nn, nr = new[order, 0], new[order, 1], ranks[order]
        ncap = gt.bucket_capacity(len(nv), minimum=8)
        need = len(seen) + len(fresh)
        tpv, tpn, tpr = ttri.grow_packed_columns(tpv, tpn, tpr, need)
        jpv, jpn, jpr = jtri.grow_packed_columns(jpv, jpn, jpr, need)

        def pad(a, fill=0):
            out = np.full(ncap, fill, np.int32)
            out[: len(a)] = a
            return out

        new_cols = (pad(nv, BIG), pad(nn), pad(nr))
        tpv, tpn, tpr = ttri.merge_packed_adjacency(tpv, tpn, tpr, *map(_t, new_cols), len(nv))
        jpv, jpn, jpr = jtri.merge_packed_adjacency(jpv, jpn, jpr, *map(_j, new_cols), len(nv))
        for a, b in ((jpv, tpv), (jpn, tpn), (jpr, tpr)):
            _eq(a, b)
        seen.update(fresh)
        acc = np.concatenate([acc, np.stack([nv, nn, nr], 1)])
        want = acc[np.lexsort((acc[:, 1], acc[:, 0]))]
        k = len(acc)
        np.testing.assert_array_equal(tpv.numpy()[:k], want[:, 0])
        np.testing.assert_array_equal(tpn.numpy()[:k], want[:, 1])
        np.testing.assert_array_equal(tpr.numpy()[:k], want[:, 2])
        assert (tpv.numpy()[k:] == BIG).all()


def _packed_windows(seed, n_windows=4, n=128, v=64):
    """Both packages' packed carries window by window, with each window's
    prep outputs: yields (jax outputs, port outputs)."""
    rng = np.random.default_rng(seed)
    jcols = jtri.grow_packed_columns(None, None, None, 2048)
    tcols = ttri.grow_packed_columns(None, None, None, 2048, device="cpu")
    rank0 = 0
    for _ in range(n_windows):
        s = rng.integers(0, v, n)
        d = rng.integers(0, v, n)
        m = np.ones(n, bool)
        m[-9:] = False
        jo = jtri.prepare_packed_window(*jcols, _j(s), _j(d), _j(m, bool), jnp.int32(rank0), v)
        to = ttri.prepare_packed_window(*tcols, _t(s), _t(d), _t(m, torch.bool), rank0, v)
        yield jo, to
        jcols, tcols = jo[:3], to[:3]
        rank0 += n


@pytest.mark.parametrize("seed", [0, 1])
def test_prepare_packed_window_matches_jax(seed):
    for jo, to in _packed_windows(seed):
        assert len(jo) == len(to) == 8
        for a, b in zip(jo, to):
            _eq(a, b)


@pytest.mark.parametrize("width", [4, 16, 64])
def test_packed_triangle_update_and_common_neighbors_match_jax(width):
    for jo, to in _packed_windows(3):
        _, jpn, jpr, jrp, jqu, jqv, jqr, jqm = jo
        pv, pn, pr, rp, qu, qv, qr, qm = to
        jc, jd = jtri.packed_triangle_update(
            jpn, jpr, jrp, jqu, jqv, jqr, jqm, jnp.arange(64, dtype=jnp.int32), width)
        for key in (None, ttri.packed_key(pv, pn)):
            tc, td = ttri.packed_triangle_update(
                pn, pr, rp, qu, qv, qr, qm, torch.arange(64, dtype=torch.int32), width, key=key)
            _eq(jc, tc)
            assert int(jd) == int(td) and td.dtype == torch.int32
            je = jtri.packed_common_neighbor_exists(jpn, jrp, jqu, jqv, jqm, width)
            te = ttri.packed_common_neighbor_exists(pn, rp, qu, qv, qm, width, key=key)
            _eq(je, te)


def test_degree_class_plan_and_host_helpers_match_jax():
    rng = np.random.default_rng(9)
    mindeg = rng.integers(0, 5000, 3000)
    want = list(jtri.degree_class_plan(mindeg))
    got = list(ttri.degree_class_plan(mindeg))
    assert [(w, t, c) for w, _, t, c in want] == [(w, t, c) for w, _, t, c in got]
    for (_, a, _, _), (_, b, _, _) in zip(want, got):
        np.testing.assert_array_equal(a, b)
    u = rng.integers(0, 30, 20).astype(np.int32)
    v = u + 1 + rng.integers(0, 30, 20).astype(np.int32)
    r = rng.integers(0, 100, 20).astype(np.int32)
    for a, b in zip(jtri.build_sorted_directed(u, v, r), ttri.build_sorted_directed(u, v, r)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for cur, deg in ((8, 1), (8, 300), (16, 70000), (24, 3)):
        assert jtri.sticky_search_steps(cur, deg) == ttri.sticky_search_steps(cur, deg)
    tcols = ttri.grow_packed_columns(None, None, None, 20, device="cpu")
    jcols = jtri.grow_packed_columns(None, None, None, 20)
    for a, b in zip(jcols, tcols):
        _eq(a, b)
    for a, b in zip(jtri.grow_packed_columns(*jcols, 100), ttri.grow_packed_columns(*tcols, 100)):
        _eq(a, b)


def test_chunked_class_scan_visits_every_slice_in_order():
    sel = torch.arange(16, dtype=torch.int32)
    seen = ttri.chunked_class_scan(lambda c, s: c + [s.tolist()], [], sel, 4)
    assert seen == [list(range(i, i + 4)) for i in range(0, 16, 4)]


# --------------------------------------------------------------------- #
# ExactTriangleCount end to end
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("window", [1, 4, 14])
def test_exact_triangle_count_final_counts_match_jax(window):
    edges = [(s, d, 0.0) for s, d in TRIANGLES_DATA]
    jout, tout, _, _ = _run_both(edges, window)
    assert jout == tout
    final = {}
    for b in tout:
        final.update(dict(b))
    total, counts = _brute_force(edges)
    assert final[GLOBAL_KEY] == total == 9
    assert {v: c for v, c in final.items() if v != GLOBAL_KEY and c} == \
        {v: c for v, c in counts.items() if c}


def test_exact_triangle_count_once_per_triangle_across_windows():
    edges = [(1, 2, 0.0), (2, 3, 0.0), (1, 2, 0.0), (3, 1, 0.0), (2, 1, 0.0)]
    jout, tout, _, _ = _run_both(edges, 2)
    assert jout == tout
    assert [dict(e).get(GLOBAL_KEY) for e in tout] == [None, 1, None]
    assert dict(tout[1]) == {1: 1, 2: 1, 3: 1, GLOBAL_KEY: 1}


@pytest.mark.parametrize("seed,window", [(3, 10), (4, 7), (5, 64)])
def test_incremental_stream_matches_jax_and_brute_force(seed, window):
    edges = _random_edges(seed, 200, 14)
    jout, tout, _, _ = _run_both(edges, window)
    assert jout == tout
    total = 0
    for i, batch in enumerate(tout):
        total = dict(batch).get(GLOBAL_KEY, total)
        assert total == _brute_force(edges[: (i + 1) * window])[0], i


def test_large_recount_with_growth_matches_jax():
    """Vertex- and degree-bucket growth mid-stream (test_triangles.py:157)."""
    rng = np.random.default_rng(17)
    src = np.concatenate([rng.integers(0, 40, 600), rng.integers(0, 160, 600),
                          rng.integers(0, 600, 600)])
    dst = np.concatenate([rng.integers(0, 40, 600), rng.integers(0, 160, 600),
                          rng.integers(0, 600, 600)])
    edges = [(int(a), int(b), 0.0) for a, b in zip(src, dst)]
    jout, tout, jet, tet = _run_both(edges, 250)
    assert jout == tout
    final = {}
    for b in tout:
        final.update(dict(b))
    total, counts = _brute_force(edges)
    assert final[GLOBAL_KEY] == total
    assert {v: c for v, c in final.items() if v != GLOBAL_KEY and c} == \
        {v: c for v, c in counts.items() if c}
    assert tet._n_packed == jet._n_packed
    _eq(jet._pv, tet._pv)


def test_identity_dict_stream_matches_jax():
    edges = _random_edges(8, 3000, 1 << 9)
    jout, tout, _, _ = _run_both(edges, 1 << 10, vdict_bound=1 << 9)
    assert jout == tout and len(tout) == 3


def test_distinct_stream_matches_jax():
    edges = [(1, 2), (1, 2), (2, 3), (1, 3), (1, 2), (3, 4), (2, 4)]
    src = np.array([e[0] for e in edges])
    dst = np.array([e[1] for e in edges])
    jout = _batches(JaxETC(), gj.SimpleEdgeStream((src, dst), window=gj.CountWindow(3)).distinct())
    tout = _batches(TorchETC(), gt.SimpleEdgeStream(
        (src, dst), window=gt.CountWindow(3), device="cpu").distinct())
    assert jout == tout
    assert [dict(b).get(GLOBAL_KEY) for b in tout if dict(b).get(GLOBAL_KEY)][-1] == 2


def test_lazy_batches_read_late_keep_their_window():
    """Batches read after later windows ran give the change-only lists of
    a stream-order read (every tensor a batch holds is its own)."""
    edges = _random_edges(11, 300, 16)
    stream = lambda: gt.SimpleEdgeStream(edges, window=gt.CountWindow(50), device="cpu")
    eager = _batches(TorchETC(), stream())
    held = list(TorchETC().run(stream()))
    assert [list(b) for b in held] == eager


@pytest.mark.parametrize("restore_in", ["port", "jax", "port_from_port"])
def test_checkpoint_roundtrip_with_duplicates_across_packages(restore_in):
    """Raw columns carry duplicates and self-loops; a state saved by one
    package continues in the other with equal batches and totals."""
    edges1 = [(1, 2), (2, 2), (2, 3), (1, 2)]
    edges2 = [(1, 3), (3, 4), (2, 4), (2, 3)]

    def cols(edges):
        return np.array([e[0] for e in edges]), np.array([e[1] for e in edges])

    def jstream(edges):
        return gj.SimpleEdgeStream(cols(edges), window=gj.CountWindow(2),
                                   vertex_dict=JaxIdentityDict(8))

    def tstream(edges):
        return gt.SimpleEdgeStream(cols(edges), window=gt.CountWindow(2),
                                   vertex_dict=IdentityDict(8), device="cpu")

    base = JaxETC()
    _batches(base, jstream(edges1))
    want = _batches(base, jstream(edges2))
    if restore_in == "port":
        state = {k: (np.array(v) if isinstance(v, np.ndarray) else v)
                 for k, v in _first(JaxETC(), jstream(edges1)).items()}
        resumed = TorchETC()
        resumed.load_state_dict(state)
        got = _batches(resumed, tstream(edges2))
    elif restore_in == "jax":
        resumed = JaxETC()
        resumed.load_state_dict(_first(TorchETC(), tstream(edges1)))
        got = _batches(resumed, jstream(edges2))
    else:
        resumed = TorchETC()
        resumed.load_state_dict(_first(TorchETC(), tstream(edges1)))
        got = _batches(resumed, tstream(edges2))
    assert got == want
    assert int(resumed._total) == int(base._total) == 2


def _first(workload, stream):
    _batches(workload, stream)
    return workload.state_dict()


def test_state_dict_matches_jax():
    edges = _random_edges(12, 400, 30)
    _, _, jet, tet = _run_both(edges, 64)
    js, ts = jet.state_dict(), tet.state_dict()
    assert set(js) == set(ts)
    for k in ("u", "v", "deg", "counts"):
        np.testing.assert_array_equal(np.asarray(js[k]), ts[k])
    assert js["total"] == ts["total"] and js["n_raw"] == ts["n_raw"]


def test_window_loop_keeps_counts_on_the_stream_device():
    tet = TorchETC()
    out = list(tet.run(gt.SimpleEdgeStream(_random_edges(2, 100, 10),
                                           window=gt.CountWindow(20), device="cpu")))
    assert tet._counts.device.type == "cpu" and len(out) == 5
    tet.sync()


def test_cli_matches_jax(tmp_path):
    inp = tmp_path / "edges.txt"
    inp.write_text("\n".join(f"{s} {d}" for s, d in TRIANGLES_DATA))
    jo, to = tmp_path / "j.txt", tmp_path / "t.txt"
    jax_cli.main([str(inp), "5", str(jo)])
    torch_cli.main(["--cpu", str(inp), "5", str(to)])
    assert to.read_text() == jo.read_text()
    lines = dict(tuple(map(int, ln.strip("()").split(","))) for ln in to.read_text().splitlines())
    assert lines[-1] == 9
