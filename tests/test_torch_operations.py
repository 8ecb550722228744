"""Stream operations and time windows: the port against the JAX package.

Mirrors ``tests/test_operations.py`` (the reference's test/operations
suite on the 7-edge sample graph: properties, transforms, degree streams,
``distinct``, ``union``, running counts, vertex aggregates) and the
time-window tests of ``tests/test_core.py``. Each case runs the JAX
package and the port (``device="cpu"``) on the same input and requires
the same emissions window by window, and the reference's golden values.
User functions are written twice: with ``jnp`` for the JAX package and
with torch for the port. Integer results are exact; the edge values are
float32 in both packages and compared exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gelly_streaming_tpu as gj
import gelly_streaming_tpu_torch as gt
from gelly_streaming_tpu.core.window import Windower as JaxWindower
from gelly_streaming_tpu_torch.core.emission import LazyCountRange, LazyRecordBatch
from gelly_streaming_tpu_torch.core.window import Windower

SAMPLE_SET = sorted(
    [(1, 2, 12.0), (1, 3, 13.0), (2, 3, 23.0), (3, 4, 34.0),
     (3, 5, 35.0), (4, 5, 45.0), (5, 1, 51.0)]
)


def streams(edges, n=3):
    return (gj.SimpleEdgeStream(edges, window=gj.CountWindow(n)),
            gt.SimpleEdgeStream(edges, window=gt.CountWindow(n), device="cpu"))


def _rec(x):
    if isinstance(x, tuple):
        return tuple(_rec(v) for v in x)
    return x.item() if hasattr(x, "item") else x


def per_window(emission):
    """Emission batches as lists of plain Python records."""
    return [[_rec(tuple(r)) if isinstance(r, tuple) else _rec(r) for r in b]
            for b in emission.batches()]


def edges_set(stream):
    return sorted((e.src, e.dst, float(e.val)) for e in stream.get_edges())


def both_edges(js, ts):
    """Per-window edge emissions of both packages, equal; returns the
    sorted flat set."""
    jw = [[(e.src, e.dst, _rec(e.val)) for e in b] for b in js.get_edges().batches()]
    tw = [[(e.src, e.dst, _rec(e.val)) for e in b] for b in ts.get_edges().batches()]
    assert tw == jw
    return sorted(r for w in tw for r in w)


def test_graph_stream_creation(sample_edges):
    # TestGraphStreamCreation.java:60-67
    assert both_edges(*streams(sample_edges)) == SAMPLE_SET


def test_get_vertices(sample_edges):
    # TestGetVertices.java:61-66
    js, ts = streams(sample_edges)
    jv = [[v.id for v in b] for b in js.get_vertices().batches()]
    tv = [[v.id for v in b] for b in ts.get_vertices().batches()]
    assert tv == jv and sorted(sum(tv, [])) == [1, 2, 3, 4, 5]


def test_map_edges(sample_edges):
    # TestMapEdges.java:71-78 (add-one mapper)
    js, ts = streams(sample_edges)
    got = both_edges(js.map_edges(lambda s, d, v: v + jnp.float32(1)),
                     ts.map_edges(lambda s, d, v: v + torch.tensor(1.0)))
    assert got == sorted((a, b, v + 1) for a, b, v in SAMPLE_SET)


def test_map_edges_tuple_value(sample_edges):
    # TestMapEdges.java:99-106 (tuple-valued mapper)
    js, ts = streams(sample_edges)
    got = both_edges(js.map_edges(lambda s, d, v: (v, v + 1)),
                     ts.map_edges(lambda s, d, v: (v, torch.add(v, 1))))
    assert got == sorted((a, b, (v, v + 1)) for a, b, v in SAMPLE_SET)


def test_chained_maps(sample_edges):
    # TestMapEdges.java:129-136
    js, ts = streams(sample_edges)
    got = both_edges(
        js.map_edges(lambda s, d, v: v + 1).map_edges(lambda s, d, v: (v, v + 1)),
        ts.map_edges(lambda s, d, v: torch.add(v, 1)).map_edges(
            lambda s, d, v: (v, torch.add(v, 1))),
    )
    assert got == sorted((a, b, (v + 1, v + 2)) for a, b, v in SAMPLE_SET)


def test_filter_edges(sample_edges):
    # TestFilterEdges.java:70-75 (value > 20)
    js, ts = streams(sample_edges)
    got = both_edges(js.filter_edges(lambda s, d, v: v > 20),
                     ts.filter_edges(lambda s, d, v: torch.gt(v, 20)))
    assert got == sorted(t for t in SAMPLE_SET if t[2] > 20)


def test_filter_edges_empty_and_discard(sample_edges):
    # TestFilterEdges.java:96-106 and :128
    js, ts = streams(sample_edges)
    keep = both_edges(js.filter_edges(lambda s, d, v: jnp.ones_like(v, bool)),
                      ts.filter_edges(lambda s, d, v: torch.ones_like(v, dtype=torch.bool)))
    assert keep == SAMPLE_SET
    drop = both_edges(js.filter_edges(lambda s, d, v: jnp.zeros_like(v, bool)),
                      ts.filter_edges(lambda s, d, v: torch.zeros_like(v, dtype=torch.bool)))
    assert drop == []


def test_filter_vertices(sample_edges):
    # TestFilterVertices.java:70-74 (vertex id > 1, both endpoints)
    js, ts = streams(sample_edges)
    got = both_edges(js.filter_vertices(lambda vid: vid > 1),
                     ts.filter_vertices(lambda vid: torch.gt(vid, 1)))
    assert got == sorted(t for t in SAMPLE_SET if t[0] > 1 and t[1] > 1)


def test_distinct(sample_edges):
    # TestDistinct.java: the sample graph twice -> the sample graph
    js, ts = streams(sample_edges + sample_edges, 4)
    assert both_edges(js.distinct(), ts.distinct()) == SAMPLE_SET
    # surviving rows keep their device slots (a mask with holes)
    for jb, tb in zip(js.distinct().blocks(), ts.distinct().blocks()):
        np.testing.assert_array_equal(tb.mask.numpy(), np.asarray(jb.mask))
        np.testing.assert_array_equal(tb._host_cache_pos, jb._host_cache_pos)


def test_reverse(sample_edges):
    # TestReverse.java:62-68
    got = both_edges(*(s.reverse() for s in streams(sample_edges)))
    assert got == sorted((b, a, v) for a, b, v in SAMPLE_SET)


def test_undirected(sample_edges):
    # TestUndirected.java:62-75
    got = both_edges(*(s.undirected() for s in streams(sample_edges)))
    assert got == sorted([(a, b, v) for a, b, v in SAMPLE_SET]
                         + [(b, a, v) for a, b, v in SAMPLE_SET])


def test_union(sample_edges):
    # TestUnion.java:59-86: 4-edge graph union 3-edge graph -> sample graph
    ja, ta = streams(sample_edges[:4], 2)
    jb, tb = streams(sample_edges[4:], 2)
    assert both_edges(ja.union(jb), ta.union(tb)) == SAMPLE_SET


def test_number_of_vertices(sample_edges):
    # TestNumberOfEntities.java:73-77: running count 1..5
    js, ts = streams(sample_edges, 1)
    assert per_window(ts.number_of_vertices()) == per_window(js.number_of_vertices())
    assert list(ts.number_of_vertices()) == [1, 2, 3, 4, 5]


def test_number_of_edges(sample_edges):
    # TestNumberOfEntities.java:96-102: running count 1..7
    js, ts = streams(sample_edges, 1)
    assert per_window(ts.number_of_edges()) == per_window(js.number_of_edges())
    assert list(ts.number_of_edges()) == [1, 2, 3, 4, 5, 6, 7]


@pytest.mark.parametrize("which,expected", [
    # TestGetDegrees.java:68-81, :94-100, :113-119 (per record at
    # CountWindow(1), the reference's continuously improving updates)
    ("get_degrees", [(1, 1), (1, 2), (1, 3), (2, 1), (2, 2), (3, 1), (3, 2), (3, 3), (3, 4),
                     (4, 1), (4, 2), (5, 1), (5, 2), (5, 3)]),
    ("get_in_degrees", [(1, 1), (2, 1), (3, 1), (3, 2), (4, 1), (5, 1), (5, 2)]),
    ("get_out_degrees", [(1, 1), (1, 2), (2, 1), (3, 1), (3, 2), (4, 1), (5, 1)]),
])
def test_degree_streams_per_record(sample_edges, which, expected):
    js, ts = streams(sample_edges, 1)
    tw = per_window(getattr(ts, which)())
    assert tw == per_window(getattr(js, which)())
    assert sorted(sum(tw, [])) == sorted(expected)


def test_get_degrees_windowed_final_state(sample_edges):
    # change-only per-window emission: the final degree per vertex matches
    js, ts = streams(sample_edges, 3)
    tw = per_window(ts.get_degrees())
    assert tw == per_window(js.get_degrees())
    assert dict(sum(tw, [])) == {1: 3, 2: 2, 3: 4, 4: 2, 5: 3}
    # the emitted columns keep the reference's int32 ids and degrees
    batch = next(iter(ts.get_degrees().batches()))
    assert batch.columns[1].dtype == np.int32


def test_distinct_fallback_matches_native(monkeypatch):
    """The sorted-run fallback (no native library) agrees with the native
    hash path across windows, and with the JAX package."""
    import gelly_streaming_tpu_torch.native as native

    rng = np.random.default_rng(3)
    s = rng.integers(0, 40, 600)
    d = rng.integers(0, 40, 600)

    def run(force_fallback):
        stream = gt.SimpleEdgeStream((s, d), window=gt.CountWindow(16), device="cpu")
        if force_fallback:
            class Boom:
                def __init__(self):
                    raise RuntimeError("no toolchain")

            monkeypatch.setattr(native, "NativeEncoder", Boom)
        out = [b.to_host()[:2] for b in stream.distinct().blocks()]
        return [(int(a), int(b)) for bs, bd in out for a, b in zip(bs.tolist(), bd.tolist())]

    want = [(int(a), int(b))
            for blk in gj.SimpleEdgeStream((s, d), window=gj.CountWindow(16)).distinct().blocks()
            for a, b in zip(*(c.tolist() for c in blk.to_host()[:2]))]
    a = run(False)
    b = run(True)
    assert a == b == want
    assert len(a) == len(set(zip(s.tolist(), d.tolist())))


def test_property_streams_on_device_transformed_blocks(sample_edges):
    """Blocks made by device transforms have no host columns; the property
    streams take their device paths (device seen mask, device running
    count, lazy reads) and match the JAX package."""
    def filtered(pkg):
        if pkg is gj:
            return gj.SimpleEdgeStream(sample_edges, window=gj.CountWindow(2)).filter_edges(
                lambda s, d, v: v < 40.0)
        return gt.SimpleEdgeStream(sample_edges, window=gt.CountWindow(2),
                                   device="cpu").filter_edges(lambda s, d, v: torch.lt(v, 40.0))

    assert all(getattr(b, "_host_cache", None) is None for b in filtered(gt).blocks())
    kept = [(s, d, v) for s, d, v in sample_edges if v < 40.0]
    assert both_edges(filtered(gj), filtered(gt)) == sorted(kept)
    assert ([[v.id for v in b] for b in filtered(gt).get_vertices().batches()]
            == [[v.id for v in b] for b in filtered(gj).get_vertices().batches()])
    assert [v.id for v in filtered(gt).get_vertices()] == [1, 2, 3, 4, 5]
    assert per_window(filtered(gt).number_of_edges()) == per_window(filtered(gj).number_of_edges())
    assert list(filtered(gt).number_of_edges()) == list(range(1, len(kept) + 1))
    # laziness: producing every batch materializes none
    batches = list(filtered(gt).get_vertices().batches())
    assert any(isinstance(b, LazyRecordBatch) for b in batches)
    assert all(b._cols is None for b in batches if isinstance(b, LazyRecordBatch))
    cbatches = list(filtered(gt).number_of_edges().batches())
    assert any(isinstance(b, LazyCountRange) for b in cbatches)
    assert all(b._range is None for b in cbatches if isinstance(b, LazyCountRange))


def test_vertex_aggregate_map_case():
    """``SimpleEdgeStream.java:489-494``, map case: emit the source vertex
    with its edge value doubled."""
    edges = [(1, 2, 10.0), (3, 4, 20.0), (1, 4, 30.0)]
    js = gj.SimpleEdgeStream(edges, window=gj.CountWindow(2))
    ts = gt.SimpleEdgeStream(edges, window=gt.CountWindow(2), device="cpu")
    want = [(int(k), float(v)) for k, v in js.vertex_aggregate(
        lambda s, d, v: ((s, v), jnp.bool_(True)), lambda k, v: (k, v * 2.0))]
    got = [(int(k), float(v)) for k, v in ts.vertex_aggregate(
        lambda s, d, v: ((s, v), torch.tensor(True)), lambda k, v: (k, torch.mul(v, 2.0)))]
    assert got == want == [(1, 20.0), (3, 40.0), (1, 60.0)]


def test_vertex_aggregate_flatmap_case():
    """0..n emission per edge: both endpoints of the edges above a value
    threshold, neither below; a wrong ``max_out`` is rejected."""
    edges = [(1, 2, 5.0), (3, 4, 50.0), (5, 6, 7.0), (7, 8, 70.0)]
    js = gj.SimpleEdgeStream(edges, window=gj.CountWindow(4))
    ts = gt.SimpleEdgeStream(edges, window=gt.CountWindow(4), device="cpu")

    def mapper_j(s, d, v):
        return (jnp.stack([s, d]), jnp.stack([v, v])), jnp.stack([v > 10.0, v > 10.0])

    def mapper_t(s, d, v):
        return (torch.stack([s, d]), torch.stack([v, v])), torch.stack([v > 10.0, v > 10.0])

    want = [(int(k), float(v)) for k, v in js.vertex_aggregate(
        mapper_j, lambda k, v: (k, v), max_out=2)]
    got = [(int(k), float(v)) for k, v in ts.vertex_aggregate(
        mapper_t, lambda k, v: (k, v), max_out=2)]
    assert got == want == [(3, 50.0), (4, 50.0), (7, 70.0), (8, 70.0)]
    with pytest.raises(ValueError, match="max_out"):
        list(ts.vertex_aggregate(mapper_t, lambda k, v: (k, v), max_out=3))


def test_global_aggregate_and_build_neighborhood(sample_edges):
    """The generic carried aggregate (change-only) and the per-edge
    neighborhood snapshots, against the JAX package."""
    js, ts = streams(sample_edges, 2)

    def upd_j(state, b):
        state = state + int(np.asarray(b.mask).sum())
        return state, state // 3

    def upd_t(state, b):
        state = state + int(b.mask.sum())
        return state, state // 3

    assert list(ts.global_aggregate(upd_t, 0)) == list(js.global_aggregate(upd_j, 0)) == [0, 1, 2]
    assert list(ts.build_neighborhood()) == list(js.build_neighborhood())
    assert list(ts.build_neighborhood(directed=True)) == list(js.build_neighborhood(directed=True))


# --------------------------------------------------------------------- #
# Time windows (tests/test_core.py:57-111)
# --------------------------------------------------------------------- #
def _windows(w, edges):
    out = []
    for info, b in w.blocks_with_info(edges):
        s, d, v = b.to_host()
        out.append(((info.index, info.start, info.end, info.max_timestamp),
                    s.tolist(), d.tolist(), np.asarray(v).tolist(), b.capacity, b.n_vertices))
    return out


def test_event_time_windower():
    edges = [(1, 2, 0.0, 10), (2, 3, 0.0, 15), (3, 4, 0.0, 25), (4, 5, 0.0, 40)]
    jw = JaxWindower(gj.EventTimeWindow(10, timestamp_fn=lambda e: e[3]))
    tw = Windower(gt.EventTimeWindow(10, timestamp_fn=lambda e: e[3]), device="cpu")
    got = _windows(tw, edges)
    assert got == _windows(jw, edges)
    assert [len(w[1]) for w in got] == [2, 1, 1]
    assert [w[0][3] for w in got] == [19, 29, 49]


def test_event_time_array_path_respects_timestamp_fn():
    src = np.arange(6, dtype=np.int64)
    dst = src + 100
    ts = np.array([0, 1, 12, 13, 25, 26], np.float64)
    wrong_ts = np.zeros(6, np.float64)
    cols = (src, dst, ts, wrong_ts)
    jw = JaxWindower(gj.EventTimeWindow(10, timestamp_fn=lambda e: e[2]))
    tw = Windower(gt.EventTimeWindow(10, timestamp_fn=lambda e: e[2]), device="cpu")
    got = _windows(tw, cols)
    assert got == _windows(jw, cols)
    assert [w[0][1] for w in got] == [0, 10, 20]
    bad = Windower(gt.EventTimeWindow(10, timestamp_fn=lambda e: float(len(str(e)))),
                   device="cpu")
    with pytest.raises(ValueError):
        list(bad.blocks_with_info((src, dst, ts)))


def test_event_time_array_path_requires_timestamp_fn():
    src = np.arange(4, dtype=np.int64)
    with pytest.raises(ValueError, match="timestamp_fn"):
        list(Windower(gt.EventTimeWindow(10), device="cpu").blocks_with_info(
            (src, src + 1, np.zeros(4))))
    with pytest.raises(ValueError, match="timestamp_fn"):
        list(Windower(gt.EventTimeWindow(10), device="cpu").blocks_with_info([(1, 2, 0.0)]))
    w2 = Windower(gt.EventTimeWindow(10, timestamp_fn=lambda e: e[2]), device="cpu")
    with pytest.raises(ValueError, match=r"\[N, 2\] or \[N, 3\]"):
        list(w2.blocks_with_info(np.zeros((4, 4))))


def test_event_time_chunked_path_matches_jax():
    """File-scale chunks: windows span chunk boundaries, a slot boundary
    inside a chunk splits it, values carried through."""
    rng = np.random.default_rng(7)
    n = 500
    ts = np.sort(rng.integers(0, 2000, n)).astype(np.float32)
    src = rng.integers(0, 60, n)
    dst = rng.integers(0, 60, n)
    chunks = [(src[a:a + 64], dst[a:a + 64], ts[a:a + 64]) for a in range(0, n, 64)]
    jw = JaxWindower(gj.EventTimeWindow(300, timestamp_fn=lambda e: e[2]))
    tw = Windower(gt.EventTimeWindow(300, timestamp_fn=lambda e: e[2]), device="cpu")
    want = [(i.index, i.start, i.end, *(np.asarray(c).tolist() for c in b.to_host()))
            for i, b in jw.blocks_from_chunks(iter(chunks))]
    got = [(i.index, i.start, i.end, *(np.asarray(c).tolist() for c in b.to_host()))
           for i, b in tw.blocks_from_chunks(iter(chunks))]
    assert got == want and len(got) == 7


def test_processing_time_window_closes_on_count_and_ticks():
    """Wall-clock windows: ``max_count`` closes a burst; a ``None`` tick
    after ``seconds`` closes an open window (the JAX package's rule)."""
    edges = [(i, i + 1) for i in range(10)]
    tw = Windower(gt.ProcessingTimeWindow(3600.0, max_count=4), device="cpu")
    jw = JaxWindower(gj.ProcessingTimeWindow(3600.0, max_count=4))
    got = _windows(tw, edges)
    assert got == _windows(jw, edges)
    assert [len(w[1]) for w in got] == [4, 4, 2]
    ticked = Windower(gt.ProcessingTimeWindow(0.0), device="cpu")
    assert [len(w[1]) for w in _windows(ticked, [(1, 2), None, (3, 4)])] == [1, 1]
