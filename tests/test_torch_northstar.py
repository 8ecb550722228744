"""The north-star shape at small sizes: the port against the JAX package.

``chip_smoke.py`` phase ``northstar`` runs ``bench.py:2566 run_northstar``
on the card: the ``livejournal-xl`` surrogate (R-MAT scale 23, 2^27
edges) written as its binary cache from regenerated columns, then
streaming CC in 2^20-edge windows (device encoded, and through
``IdentityDict``) and in one window of the whole stream. These tests hold
each piece of that path against the JAX package on the CPU:

- the surrogate's generator at scale 23: the port's ``rmat_edges``, the
  JAX package's and ``chip_smoke.rmat_columns`` (the oracle's, threaded)
  on the seeds of the corpus's first two chunks, and the chunk seeds
  ``synthesize`` uses;
- the binary cache written from columns (``datasets.write_binary``) and
  from text (``datasets.binary_cache``), byte for byte, and the JAX
  package's cache of the same text;
- one ``CountWindow`` wider than ``chunk_edges`` and at least the stream,
  so that parser chunks concatenate, for each carry and for the device
  encode, final components equal to the JAX package's;
- the same edges in small windows and in one window, equal components.

Mirrors ``bench.py:run_northstar`` and ``tests/test_forest.py``'s carry
checks (``:39-183``), ``tests/test_datasets.py:56`` (the surrogate's
bytes) and ``tests/test_device_dict.py:66-116`` (the device encode into
CC).
"""

import numpy as np
import pytest

import chip_smoke
import gelly_streaming_tpu as gj
from gelly_streaming_tpu import datasets as jax_datasets
from gelly_streaming_tpu.library import ConnectedComponents as JaxCC
from gelly_streaming_tpu_torch import CountWindow
from gelly_streaming_tpu_torch import datasets as torch_datasets
from gelly_streaming_tpu_torch import native as torch_native
from gelly_streaming_tpu_torch.library import ConnectedComponents as TorchCC

XL = torch_datasets.CORPORA["livejournal-xl"]
XL_SCALE = XL.surrogate_vscale.bit_length() - 1
SCALE = 12  # the small corpus: ids below 4096
CHUNK = 1 << 12
N_EDGES = 3 * CHUNK + 123  # a ragged last chunk
CARRIES = ["forest", "host", "dense"]


def test_xl_spec_is_the_north_star_surrogate():
    """``run_northstar``'s corpus: 2^27 edges over ids below 2^23, as in
    the JAX package's registry."""
    jxl = jax_datasets.CORPORA["livejournal-xl"]
    assert (XL.surrogate_edges, XL.surrogate_vscale) == (1 << 27, 1 << 23)
    assert (jxl.surrogate_edges, jxl.surrogate_vscale) == (XL.surrogate_edges,
                                                          XL.surrogate_vscale)
    assert XL_SCALE == 23


@pytest.mark.parametrize("seed", [0, 1 << 22])
def test_scale23_generator_matches_jax_and_the_oracle(seed):
    """The seeds of the xl corpus's first two chunks (``synthesize`` seeds
    chunk ``start`` with ``seed + start``), 2^12 edges each: the port's
    generator, the JAX package's and the oracle's agree exactly, and every
    id lies below 2^23."""
    n = 1 << 12
    ts, td = torch_datasets.rmat_edges(n, XL_SCALE, seed=seed)
    js, jd = jax_datasets.rmat_edges(n, XL_SCALE, seed=seed)
    os_, od = chip_smoke.rmat_columns(n, XL_SCALE, chunk=n, seed=seed)
    for got in ((js, jd), (os_, od)):
        np.testing.assert_array_equal(ts, got[0])
        np.testing.assert_array_equal(td, got[1])
    assert int(max(ts.max(), td.max())) < 1 << XL_SCALE and int(min(ts.min(), td.min())) >= 0


def _tiny_spec(monkeypatch):
    spec = dict(name="ns-tiny", filename="ns-tiny.txt", url="https://example.org/ns-tiny",
                n_edges=N_EDGES, n_vertices=1 << SCALE, surrogate_edges=N_EDGES,
                surrogate_vscale=1 << SCALE)
    monkeypatch.setitem(torch_datasets.CORPORA, "ns-tiny", torch_datasets.CorpusSpec(**spec))
    monkeypatch.setitem(jax_datasets.CORPORA, "ns-tiny", jax_datasets.CorpusSpec(**spec))


def test_oracle_columns_follow_synthesize_chunk_seeds(tmp_path, monkeypatch):
    """Several chunks and a ragged last one: the oracle's threaded columns
    equal what the port's ``synthesize`` writes (and the JAX package's,
    byte for byte), in chunk order."""
    _tiny_spec(monkeypatch)
    t = torch_datasets.synthesize("ns-tiny", str(tmp_path / "t.txt"), chunk=CHUNK)
    j = jax_datasets.synthesize("ns-tiny", str(tmp_path / "j.txt"), chunk=CHUNK)
    assert open(t, "rb").read() == open(j, "rb").read()
    src, dst, _ = torch_native.parse_edge_file(t)
    os_, od = chip_smoke.rmat_columns(N_EDGES, SCALE, chunk=CHUNK)
    np.testing.assert_array_equal(src, os_)
    np.testing.assert_array_equal(dst, od)


def test_rmat_columns_threads_keep_chunk_order():
    """Chunks made on a pool of threads join in their order: equal to the
    chunks made one after another."""
    src, dst = chip_smoke.rmat_columns(9 * 1000 + 7, 10, chunk=1000, seed=5)
    parts = [chip_smoke._rmat_chunk(s, min(1000, 9007 - s), 10, 0.57, 0.19, 0.19, 5)
             for s in range(0, 9007, 1000)]
    np.testing.assert_array_equal(src, np.concatenate([p[0] for p in parts]))
    np.testing.assert_array_equal(dst, np.concatenate([p[1] for p in parts]))


def _corpus(tmp_path):
    """The small surrogate's columns, its text file and its binary cache."""
    src, dst = chip_smoke.rmat_columns(N_EDGES, SCALE, chunk=CHUNK)
    text = str(tmp_path / "ns.txt")
    torch_native.write_edge_file(text, src, dst)
    return src, dst, text, torch_datasets.binary_cache(text)


def test_binary_from_columns_equals_binary_from_text(tmp_path):
    """2^14 edges: ``write_binary`` of the columns, the port's cache of
    the text and the JAX package's cache of the same text are the same
    bytes, and the file reads back as the columns."""
    src, dst = chip_smoke.rmat_columns(1 << 14, SCALE, chunk=CHUNK)
    text = str(tmp_path / "g.txt")
    torch_native.write_edge_file(text, src, dst)
    from_text = torch_datasets.binary_cache(text)
    jax_bin = jax_datasets.binary_cache(text, bin_path=str(tmp_path / "j.gbin"))
    from_cols = torch_datasets.write_binary(str(tmp_path / "c.gbin"), src, dst)
    want = open(from_text, "rb").read()
    assert open(from_cols, "rb").read() == want == open(jax_bin, "rb").read()
    chunks = list(torch_datasets.iter_binary_chunks(from_cols, 5000))
    np.testing.assert_array_equal(np.concatenate([c[0] for c in chunks]), src)
    np.testing.assert_array_equal(np.concatenate([c[1] for c in chunks]), dst)
    assert all(c[2] is None for c in chunks)


def test_write_binary_rejects_ids_outside_int32(tmp_path):
    with pytest.raises(ValueError, match="int32"):
        torch_datasets.write_binary(str(tmp_path / "x.gbin"), np.array([0, 1 << 31]),
                                    np.array([1, 2]))
    with pytest.raises(ValueError, match="int32"):
        torch_datasets.write_binary(str(tmp_path / "y.gbin"), np.array([0, -1]),
                                    np.array([1, 2]))


def _final(stream, agg):
    last = None
    n = 0
    for last in stream.aggregate(agg):
        n += 1
    return n, last


def _torch_stream(path, window, form):
    if form == "device_encode":
        return torch_datasets.stream_file(
            path, window=CountWindow(window), device_encode=True,
            min_vertex_capacity=1 << SCALE, chunk_edges=CHUNK, prefetch_depth=2,
            device="cpu")
    return torch_datasets.stream_file(
        path, window=CountWindow(window), vertex_dict=torch_datasets.IdentityDict(1 << SCALE),
        chunk_edges=CHUNK, prefetch_depth=2, device="cpu")


def _jax_stream(path, window, form):
    if form == "device_encode":
        return jax_datasets.stream_file(
            path, window=gj.CountWindow(window), device_encode=True,
            min_vertex_capacity=1 << SCALE, chunk_edges=CHUNK)
    return jax_datasets.stream_file(
        path, window=gj.CountWindow(window), vertex_dict=jax_datasets.IdentityDict(1 << SCALE),
        chunk_edges=CHUNK)


FORMS = [(carry, "identity") for carry in CARRIES] + [("auto", "device_encode")]


@pytest.mark.parametrize("source", ["text", "binary"])
@pytest.mark.parametrize("carry,form", FORMS)
def test_one_window_over_many_chunks_matches_jax(tmp_path, carry, form, source):
    """``window_100m``'s shape: one ``CountWindow`` wider than the parser's
    chunks and at least the stream, so the chunks concatenate into one
    window; the final components equal the JAX package's on the same
    stream, and scipy's."""
    src, dst, text, binp = _corpus(tmp_path)
    path = text if source == "text" else binp
    window = 1 << 14  # >= N_EDGES, four chunks of CHUNK
    agg = TorchCC(carry=carry)
    stream = _torch_stream(path, window, form)
    n, got = _final(stream, agg)
    jn, want = _final(_jax_stream(path, window, form), JaxCC(carry=carry))
    assert n == jn == 1
    assert got.components == want.components
    assert agg._cc_mode == ("dense" if form == "device_encode" else carry)
    # the check phase northstar makes: scipy's least id on every seen id
    ref = chip_smoke.oracle_labels(src, dst, 1 << SCALE)
    seen = np.unique(np.concatenate([src, dst]))
    same, bad, comps = chip_smoke._raw_partition(got, stream.vertex_dict, ref, seen)
    assert same and bad == 0 and comps == len(np.unique(ref[seen]))


@pytest.mark.parametrize("carry,form", FORMS)
def test_small_windows_and_one_window_agree(tmp_path, carry, form):
    """``window_1m`` against ``window_100m`` at a small size: the same
    binary corpus in windows of 2^10 and in one window ends in the same
    components, in both packages."""
    _, _, _, binp = _corpus(tmp_path)
    n_small, small = _final(_torch_stream(binp, 1 << 10, form), TorchCC(carry=carry))
    n_one, one = _final(_torch_stream(binp, 1 << 14, form), TorchCC(carry=carry))
    assert (n_small, n_one) == (-(-N_EDGES // (1 << 10)), 1)
    assert small.components == one.components
    _, jsmall = _final(_jax_stream(binp, 1 << 10, form), JaxCC(carry=carry))
    assert jsmall.components == small.components


def test_raw_partition_counts_mismatches():
    """The phase's check counts the seen ids whose component's least raw id
    differs from scipy's, and reports differing seen sets."""

    class _Emission:
        def __init__(self, ids, lab):
            self._v = (np.asarray(ids), np.asarray(lab))

        def labels(self):
            return self._v

    class _Identity:
        @staticmethod
        def decode(idx):
            return np.asarray(idx, np.int64)

    want = np.array([0, 0, 2, 2, 4])
    seen = np.array([0, 1, 2, 3])
    assert chip_smoke._raw_partition(_Emission([0, 1, 2, 3], [0, 0, 2, 2]), _Identity,
                                     want, seen) == (True, 0, 2)
    # 1 joined to 2's component: its least id becomes 0 for 2 and 3
    assert chip_smoke._raw_partition(_Emission([0, 1, 2, 3], [0, 0, 0, 0]), _Identity,
                                     want, seen) == (True, 2, 1)
    same, bad, _ = chip_smoke._raw_partition(_Emission([0, 1, 2], [0, 0, 2]), _Identity,
                                             want, seen)
    assert not same and bad == len(seen)
