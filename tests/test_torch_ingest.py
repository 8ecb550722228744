"""Native ingest, datasets, windowing of chunks and the prefetch pipeline:
the port against the JAX package.

The port builds its own copy of ``native/ingest.cpp``; the same files,
made by ``write_edge_file`` or written out with comments, tabs, commas and
a ragged last chunk, go through both packages' parsers, and the columns
must match exactly. ``NativeWindowPrep`` must give equal touched sets and
a consistent renumbering, ``CompactUnionFind`` the same folds,
``synthesize`` the same bytes (on a small spec), and ``stream_file`` into
streaming CC the same components.

Mirrors ``tests/test_native.py`` and ``tests/test_datasets.py:56`` (and
``tests/test_pipeline.py``'s early-abandon case for ``prefetch``).
"""

import os
import threading

import numpy as np
import pytest
import torch

import gelly_streaming_tpu as gj
import gelly_streaming_tpu_torch as gt
from gelly_streaming_tpu import datasets as jax_datasets
from gelly_streaming_tpu import native as jax_native
from gelly_streaming_tpu.core.window import Windower as JaxWindower
from gelly_streaming_tpu.library import ConnectedComponents as JaxCC
from gelly_streaming_tpu_torch import datasets as torch_datasets
from gelly_streaming_tpu_torch import native as torch_native
from gelly_streaming_tpu_torch.core.pipeline import prefetch
from gelly_streaming_tpu_torch.core.vertexdict import VertexDict
from gelly_streaming_tpu_torch.core.window import Windower, take_cols
from gelly_streaming_tpu_torch.library import ConnectedComponents as TorchCC

from _uf import union_find_components


@pytest.fixture
def edge_file(tmp_path):
    p = tmp_path / "edges.txt"
    p.write_text(
        "# comment line\n"
        "1 2 100\n"
        "3\t4\t2.5\n"
        "5,6,350\n"
        "\n"
        "7 8 +\n"
        "9 10 -\n"
        "% another comment\n"
        "11 12\n"
        "13 14 -3.5"  # no trailing newline
    )
    return str(p)


def _cols_equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if x is None or y is None:
            assert x is None and y is None
        else:
            assert np.asarray(x).dtype == np.asarray(y).dtype
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_native_library_builds_from_the_port_source():
    assert torch_native.native_available(), torch_native.BUILD_ERROR
    path = torch_native.library_path()
    assert os.path.dirname(path).endswith(os.path.join("gelly_streaming_tpu_torch", "_build"))
    assert os.path.exists(path)


def test_parse_matches_jax_and_fallback(edge_file):
    got = torch_native.parse_edge_file(edge_file)
    _cols_equal(got, jax_native.parse_edge_file(edge_file))
    _cols_equal(got, torch_native._parse_python(edge_file))
    assert got[0].tolist() == [1, 3, 5, 7, 9, 11, 13]
    assert got[2].tolist() == [100.0, 2.5, 350.0, 1.0, -1.0, 0.0, -3.5]


def test_no_trailing_newline_and_missing_file(tmp_path):
    p = tmp_path / "e.txt"
    p.write_text("1 2\n3 4")
    src, dst, val = torch_native.parse_edge_file(str(p))
    assert src.tolist() == [1, 3] and dst.tolist() == [2, 4] and val is None
    with pytest.raises(IOError):
        torch_native.parse_edge_file(str(tmp_path / "missing.txt"))


@pytest.mark.parametrize("chunk_edges", [700, 1 << 20])
def test_chunks_of_a_written_file_match_jax(tmp_path, chunk_edges):
    """``write_edge_file`` output (tabs), parsed in chunks with a ragged
    last chunk: the same chunk columns from both packages."""
    rng = np.random.default_rng(4)
    a = rng.integers(0, 10000, 5003)
    b = rng.integers(0, 10000, 5003)
    p = str(tmp_path / "w.txt")
    with open(p, "w") as f:
        f.write("# header\n")
    torch_native.write_edge_file(p, a, b, append=True)
    jp = str(tmp_path / "wj.txt")
    with open(jp, "w") as f:
        f.write("# header\n")
    jax_native.write_edge_file(jp, a, b, append=True)
    assert open(p, "rb").read() == open(jp, "rb").read()
    tc = list(torch_native.iter_edge_chunks(p, chunk_edges))
    jc = list(jax_native.iter_edge_chunks(p, chunk_edges))
    assert len(tc) == len(jc) >= 1
    for x, y in zip(tc, jc):
        _cols_equal(x, y)
    assert np.concatenate([c[0] for c in tc]).tolist() == a.tolist()
    ti = list(torch_native.iter_edge_chunks_i32(p, chunk_edges, id_bound=10000))
    ji = list(jax_native.iter_edge_chunks_i32(p, chunk_edges, id_bound=10000))
    for x, y in zip(ti, ji):
        _cols_equal(x, y)


def test_chunks_skip_comment_runs_and_reject_oversized_lines(tmp_path):
    p = tmp_path / "c.txt"
    with open(p, "w") as f:
        f.write("# head\n")
        for i in range(50):
            f.write(f"{i} {i + 1}\n")
        for _ in range(200):
            f.write("%" + "x" * 60 + "\n")
        for i in range(50, 100):
            f.write(f"{i} {i + 1}\n")
    chunks = list(torch_native.iter_edge_chunks(str(p), chunk_edges=4))
    assert np.concatenate([c[0] for c in chunks]).tolist() == list(range(100))
    q = tmp_path / "long.txt"
    q.write_text("1 2\n# " + "y" * 20000 + "\n3 4\n")
    with pytest.raises(IOError):
        list(torch_native.iter_edge_chunks(str(q), chunk_edges=2))


def test_i32_bound_check_matches_jax(tmp_path):
    p = tmp_path / "g.txt"
    p.write_text("# c\n1 2\n3 4 0.5\n70000 5\n")
    _cols_equal(list(torch_native.iter_edge_chunks_i32(str(p)))[0],
                list(jax_native.iter_edge_chunks_i32(str(p)))[0])
    for mod in (torch_native, jax_native):
        with pytest.raises(ValueError, match="dense-id"):
            list(mod.iter_edge_chunks_i32(str(p), id_bound=100))


def test_native_encoder_matches_numpy_and_jax():
    rng = np.random.default_rng(13)
    batches = [rng.integers(0, 500, rng.integers(1, 400)) for _ in range(8)]
    a = VertexDict()
    assert a._native is not None
    b = VertexDict()
    b._native = None  # the numpy path
    j = gj.VertexDict()
    for batch in batches:
        want = j.encode(batch)
        np.testing.assert_array_equal(a.encode(batch), want)
        np.testing.assert_array_equal(b.encode(batch), want)
    s, d = batches[0], batches[1][: len(batches[0])]
    s = s[: len(d)]
    for x, y in zip(a.encode_pair(s, d), j.encode_pair(s, d)):
        np.testing.assert_array_equal(x, y)
    assert a.raw_ids().tolist() == j.raw_ids().tolist()
    probe = int(batches[0][0])
    assert a.lookup(probe) == b.lookup(probe) == j.lookup(probe)
    assert a.lookup(10**12) is None
    np.testing.assert_array_equal(a.lookup_batch(batches[2]), j.lookup_batch(batches[2]))


def test_iter_encode_file_matches_jax(tmp_path):
    p = tmp_path / "r.txt"
    p.write_text("".join(f"{a * 7919} {b * 104729}\n" for a, b in
                         np.random.default_rng(2).integers(0, 300, (2000, 2))))
    a, j = VertexDict(), gj.VertexDict()
    tc = list(a.iter_encode_file(str(p), 300))
    jc = list(j.iter_encode_file(str(p), 300))
    for x, y in zip(tc, jc):
        _cols_equal(x, y)
    assert a.raw_ids().tolist() == j.raw_ids().tolist()


def test_native_window_prep_matches_jax_and_numpy():
    """Equal touched SETS and a consistent renumbering (order may differ:
    arrival vs sorted, which the forest steps do not see)."""
    from gelly_streaming_tpu_torch.summaries.forest import WindowPrep

    prep = torch_native.NativeWindowPrep()
    jprep = jax_native.NativeWindowPrep()
    fallback = WindowPrep()
    fallback._native = None
    rng = np.random.default_rng(3)
    for _ in range(3):
        v = int(rng.integers(16, 500))
        n = int(rng.integers(1, 400))
        src = rng.integers(0, v, n).astype(np.int32)
        dst = rng.integers(0, v, n).astype(np.int32)
        for tids, lu, lv in (prep.run(src, dst, v), fallback.prep(src, dst, v)):
            assert np.array_equal(tids[lu], src) and np.array_equal(tids[lv], dst)
            bm = np.zeros(v, bool)
            bm[src] = True
            bm[dst] = True
            assert np.array_equal(np.sort(tids), np.nonzero(bm)[0])
        _cols_equal(prep.run(src, dst, v), jprep.run(src, dst, v))
        with pytest.raises(ValueError):
            prep.run(np.array([v], np.int32), np.array([0], np.int32), v)


def test_compact_union_find_matches_jax():
    rng = np.random.default_rng(9)
    vcap = 256
    t, j = torch_native.CompactUnionFind(), jax_native.CompactUnionFind()
    windows = [
        (rng.integers(0, vcap, 50).astype(np.int32), rng.integers(0, vcap, 50).astype(np.int32))
        for _ in range(6)
    ]
    for s, d in windows[:3]:
        _cols_equal(t.fold(s, d, vcap), j.fold(s, d, vcap))
    tw, tg, tr, tc = t.fold_group(windows[3:], vcap)
    jw, jg, jr, jc = j.fold_group(windows[3:], vcap)
    for a, b in zip(tw, jw):
        _cols_equal(a, b)
    _cols_equal((tg, tr, tc), (jg, jr, jc))
    np.testing.assert_array_equal(t.flatten(vcap), j.flatten(vcap))
    edges = [(int(a), int(b)) for s, d in windows for a, b in zip(s, d)]
    flat = t.flatten(vcap)
    groups = {}
    for v in {x for e in edges for x in e}:
        groups.setdefault(flat[v], set()).add(v)
    assert {frozenset(g) for g in groups.values()} == set(union_find_components(edges))
    with pytest.raises(ValueError, match="min-rooted"):
        t.load(np.array([0, 2, 1], np.int32))


def test_cc_baseline_matches_jax():
    rng = np.random.default_rng(1)
    s = rng.integers(0, 2000, 5000)
    d = rng.integers(0, 2000, 5000)
    assert torch_native.cc_baseline(s, d, 1000)[1] == jax_native.cc_baseline(s, d, 1000)[1]


# --------------------------------------------------------------------- #
# Windows over chunks
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("encoded", [False, True])
def test_blocks_from_chunks_match_jax(encoded):
    rng = np.random.default_rng(6)
    sizes = [5, 17, 1, 30, 9]
    chunks = []
    for n in sizes:
        s = rng.integers(0, 64, n)
        d = rng.integers(0, 64, n)
        if encoded:
            s, d = s.astype(np.int32), d.astype(np.int32)
        chunks.append((s, d, rng.random(n) if n % 2 else None))
    if encoded:
        jw = JaxWindower(gj.CountWindow(8), jax_datasets.IdentityDict(64))
        tw = Windower(gt.CountWindow(8), torch_datasets.IdentityDict(64), device="cpu")
    else:
        jw = JaxWindower(gj.CountWindow(8))
        tw = Windower(gt.CountWindow(8), device="cpu")
    jb = list(jw.blocks_from_chunks(iter(chunks), encoded=encoded))
    tb = list(tw.blocks_from_chunks(iter(chunks), encoded=encoded))
    assert len(tb) == len(jb) == -(-sum(sizes) // 8)
    for (ji, a), (ti, b) in zip(jb, tb):
        assert ti.index == ji.index
        assert b.capacity == a.capacity and b.n_vertices == a.n_vertices
        for x, y in zip(a.to_host(), b.to_host()):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
        np.testing.assert_array_equal(np.asarray(a.src), b.src.numpy())
        np.testing.assert_array_equal(np.asarray(a.mask), b.mask.numpy())


def test_take_cols_slices_and_concatenates():
    pend = [(np.arange(3), np.arange(3) + 10, None),
            (np.arange(3, 8), np.arange(3, 8) + 10, np.ones(5, np.float32))]
    s, d, v = take_cols(pend, 2)
    assert s.tolist() == [0, 1] and v is None and len(pend[0][0]) == 1
    s, d, v = take_cols(pend, 4)
    assert s.tolist() == [2, 3, 4, 5] and v.tolist() == [0.0, 1.0, 1.0, 1.0]
    assert pend[0][0].tolist() == [6, 7]


# --------------------------------------------------------------------- #
# Datasets and stream_file
# --------------------------------------------------------------------- #
CC_FILE = "# c\n1 2\n2 3\n6 7\n8 9\n5 6\n"
CC_WANT = {frozenset({1, 2, 3}), frozenset({5, 6, 7}), frozenset({8, 9})}


@pytest.mark.parametrize("vdict", ["vertexdict", "identity", "numpy", "gbin"])
@pytest.mark.parametrize("prefetch_depth", [0, 2])
def test_stream_file_cc_end_to_end(tmp_path, vdict, prefetch_depth):
    p = tmp_path / "cc.txt"
    p.write_text(CC_FILE)
    path = str(p)
    tv = jv = None
    if vdict == "identity":
        tv, jv = torch_datasets.IdentityDict(16), jax_datasets.IdentityDict(16)
    elif vdict == "numpy":
        tv, jv = VertexDict(), gj.VertexDict()
        tv._native = None  # the parser followed by the numpy encode
    elif vdict == "gbin":
        path = torch_datasets.binary_cache(path)
        assert path == jax_datasets.binary_cache(str(p))
    ts = torch_datasets.stream_file(
        path, window=gt.CountWindow(2), vertex_dict=tv,
        prefetch_depth=prefetch_depth, device="cpu",
    )
    js = jax_datasets.stream_file(
        path, window=gj.CountWindow(2), vertex_dict=jv, prefetch_depth=prefetch_depth,
    )
    for carry in ("forest", "host", "dense"):
        tout = [str(c) for c in ts.aggregate(TorchCC(carry=carry))]
        jout = [str(c) for c in js.aggregate(JaxCC(carry=carry))]
        assert tout == jout
        assert len(tout) == 3
    last = None
    for last in ts.aggregate(TorchCC()):
        pass
    assert set(last.component_sets()) == CC_WANT


def test_stream_file_runs_on_the_card_by_default(tmp_path):
    """Without ``device=`` the stream is asked for on the card: with no card
    it raises, and nothing moves quietly to the CPU. The device-encode path
    (vertex compaction on the device) runs where it is asked to: on the
    CPU, to the same components."""
    p = tmp_path / "cc.txt"
    p.write_text(CC_FILE)
    for kw in ({}, {"device_encode": True}):
        if torch.cuda.is_available():
            assert torch_datasets.stream_file(str(p), **kw).device.type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="device='cpu'"):
                torch_datasets.stream_file(str(p), **kw)
    last = None
    for last in torch_datasets.stream_file(
        str(p), window=gt.CountWindow(2), device_encode=True, device="cpu"
    ).aggregate(TorchCC()):
        pass
    assert set(last.component_sets()) == CC_WANT


def test_binary_cache_matches_jax(tmp_path):
    p = tmp_path / "b.txt"
    p.write_text("1 2 0.5\n3 4 1.5\n5 6 2\n")
    tb = torch_datasets.binary_cache(str(p), str(tmp_path / "t.gbin"))
    jb = jax_datasets.binary_cache(str(p), str(tmp_path / "j.gbin"))
    assert open(tb, "rb").read() == open(jb, "rb").read()
    for x, y in zip(torch_datasets.iter_binary_chunks(tb, 2),
                    jax_datasets.iter_binary_chunks(jb, 2)):
        _cols_equal(x, y)


def test_synthesize_writes_the_same_bytes(tmp_path, monkeypatch):
    """A small surrogate spec (several chunks, so the per-chunk seeds
    count): the port's file is byte-identical to the JAX package's."""
    spec = dict(name="tiny", filename="tiny.txt", url="https://example.org/tiny",
                n_edges=5000, n_vertices=1 << 10, surrogate_edges=5000,
                surrogate_vscale=1 << 10)
    monkeypatch.setitem(torch_datasets.CORPORA, "tiny", torch_datasets.CorpusSpec(**spec))
    monkeypatch.setitem(jax_datasets.CORPORA, "tiny", jax_datasets.CorpusSpec(**spec))
    t = torch_datasets.synthesize("tiny", str(tmp_path / "t.txt"), seed=3, chunk=1 << 11)
    j = jax_datasets.synthesize("tiny", str(tmp_path / "j.txt"), seed=3, chunk=1 << 11)
    assert open(t, "rb").read() == open(j, "rb").read()
    src, dst, _ = torch_native.parse_edge_file(t)
    assert len(src) == 5000 and int(max(src.max(), dst.max())) < 1 << 10
    # the registry's headline corpus keeps its published surrogate size
    lj = torch_datasets.CORPORA["livejournal"]
    assert (lj.surrogate_edges, lj.surrogate_vscale) == (1 << 24, 1 << 21)


def test_ensure_corpus_caches_under_the_temp_dir(tmp_path, monkeypatch):
    spec = torch_datasets.CorpusSpec(
        name="tiny", filename="tiny.txt", url="https://example.org/tiny",
        n_edges=300, n_vertices=64, surrogate_edges=300, surrogate_vscale=64,
    )
    monkeypatch.setitem(torch_datasets.CORPORA, "tiny", spec)
    monkeypatch.setattr("tempfile.tempdir", str(tmp_path))
    monkeypatch.delenv("GELLY_DATA", raising=False)
    monkeypatch.chdir(tmp_path)
    path, real = torch_datasets.ensure_corpus("tiny")
    assert not real and path.startswith(str(tmp_path / "gelly_data"))
    assert torch_datasets.ensure_corpus("tiny") == (path, False)  # cached
    assert os.listdir(tmp_path / "gelly_data") == [os.path.basename(path)]
    (tmp_path / "data").mkdir()
    (tmp_path / "data" / "tiny.txt").write_text("1 2\n")
    assert torch_datasets.ensure_corpus("tiny") == (str(tmp_path / "data" / "tiny.txt"), True)


# --------------------------------------------------------------------- #
# prefetch
# --------------------------------------------------------------------- #
def test_prefetch_early_abandon_stops_the_producer():
    closed = threading.Event()
    produced = []

    def source():
        try:
            for i in range(10_000):
                produced.append(i)
                yield i
        finally:
            closed.set()

    before = threading.active_count()
    it = prefetch(source(), depth=2, device="cpu")
    assert [next(it) for _ in range(3)] == [0, 1, 2]
    assert threading.active_count() == before + 1
    it.close()  # joins the producer
    assert closed.wait(5.0)
    assert threading.active_count() == before
    assert len(produced) < 100


def test_prefetch_reraises_the_producer_error_after_the_queue():
    def source():
        yield 1
        yield 2
        raise KeyError("boom")

    got = []
    with pytest.raises(KeyError):
        for x in prefetch(source(), depth=4):
            got.append(x)
    assert got == [1, 2]


def test_prefetched_stream_matches_the_plain_stream():
    edges = [(int(a), int(b), 0.0) for a, b in np.random.default_rng(0).integers(0, 50, (200, 2))]
    s = gt.SimpleEdgeStream(edges, window=gt.CountWindow(16), device="cpu")
    plain = [str(c) for c in s.aggregate(TorchCC(carry="forest"))]
    pre = [str(c) for c in s.prefetched(3).aggregate(TorchCC(carry="forest"))]
    assert pre == plain
    last = list(s.prefetched().aggregate(TorchCC()))[-1]
    assert set(last.component_sets()) == set(union_find_components(edges))
