"""The window and neighborhood slice end to end: BASELINE configs #1 and #3
at a small size, in both packages.

- Config #1, continuous degrees (``bench.py:bench_degrees_e2e``): an R-MAT
  edge file -> its binary cache -> ``datasets.stream_file(...,
  CountWindow, IdentityDict, prefetch_depth=2)`` -> ``get_degrees()`` ->
  ``batches()``.
- Config #3, window triangles (``bench.py:bench_window_triangles_e2e``):
  Zipf columns -> ``SimpleEdgeStream(CountWindow, IdentityDict)`` ->
  ``WindowTriangles(CountWindow).run_stream`` (through ``slice()``).

2^16 edges in 4 windows; the port runs with ``device="cpu"``. Every
window's emission must equal the JAX package's: the changed vertex ids
and their degrees (int32), and the triangle counts.
"""

import numpy as np

import gelly_streaming_tpu as gj
import gelly_streaming_tpu_torch as gt
from gelly_streaming_tpu import datasets as jax_datasets
from gelly_streaming_tpu.library.triangles import WindowTriangles as JaxWindowTriangles
from gelly_streaming_tpu_torch import datasets, native
from gelly_streaming_tpu_torch.library import WindowTriangles

N_EDGES = 1 << 16
WINDOW = 1 << 14
SCALE = 12


def test_config1_degrees_chain_matches_jax(tmp_path):
    src, dst = datasets.rmat_edges(N_EDGES, SCALE, seed=3)
    text = str(tmp_path / "edges.txt")
    native.write_edge_file(text, src, dst)
    tbin = datasets.binary_cache(text, str(tmp_path / "port.gbin"))
    jbin = jax_datasets.binary_cache(text, str(tmp_path / "jax.gbin"))

    tstream = datasets.stream_file(tbin, window=gt.CountWindow(WINDOW),
                                   vertex_dict=datasets.IdentityDict(1 << SCALE),
                                   prefetch_depth=2, device="cpu")
    jstream = jax_datasets.stream_file(jbin, window=gj.CountWindow(WINDOW),
                                       vertex_dict=jax_datasets.IdentityDict(1 << SCALE),
                                       prefetch_depth=2)
    got = [b.columns for b in tstream.get_degrees().batches()]
    want = [b.columns for b in jstream.get_degrees().batches()]
    assert len(got) == len(want) == N_EDGES // WINDOW
    for (gi, gd), (wi, wd) in zip(got, want):
        np.testing.assert_array_equal(gi, np.asarray(wi))
        np.testing.assert_array_equal(gd, np.asarray(wd))
        assert gd.dtype == np.int32
    # after the last window: every vertex's degree is its endpoint count
    final = np.zeros(1 << SCALE, np.int64)
    for ids, degs in got:
        final[ids] = degs
    np.testing.assert_array_equal(
        final, np.bincount(src, minlength=1 << SCALE) + np.bincount(dst, minlength=1 << SCALE))


def test_config3_window_triangles_chain_matches_jax():
    rng = np.random.default_rng(9)
    n_vertices = 1 << 12
    u, v = rng.random(N_EDGES), rng.random(N_EDGES)
    src = np.minimum((n_vertices * u**0.75 * rng.random(N_EDGES)).astype(np.int64),
                     n_vertices - 1).astype(np.int32)
    dst = np.minimum((n_vertices * v**0.75 * rng.random(N_EDGES)).astype(np.int64),
                     n_vertices - 1).astype(np.int32)
    tstream = gt.SimpleEdgeStream((src, dst), window=gt.CountWindow(WINDOW),
                                  vertex_dict=datasets.IdentityDict(n_vertices), device="cpu")
    jstream = gj.SimpleEdgeStream((src, dst), window=gj.CountWindow(WINDOW),
                                  vertex_dict=jax_datasets.IdentityDict(n_vertices))
    got = [(int(c), i) for c, i in
           WindowTriangles(gt.CountWindow(WINDOW), device="cpu").run_stream(tstream)]
    want = [(int(c), i) for c, i in
            JaxWindowTriangles(gj.CountWindow(WINDOW)).run_stream(jstream)]
    assert got == want and len(got) == N_EDGES // WINDOW and all(c > 0 for c, _ in got)
