"""Window triangles: the port against the JAX package.

Mirrors ``tests/test_triangles.py:34-75`` (``WindowTrianglesITCase``'s
golden ``(count, windowMaxTs)`` over ``ExamplesTestData.TRIANGLES_DATA``,
one window over everything against brute force, no triangles, duplicate
edges) and ``:298`` (``run_stream`` through ``slice()`` against ``run``),
plus the window kernel's per-vertex counts and a Zipf stream of 2^14
vertices in 2^16-edge windows against the JAX package's ``run_stream``.
Every count is an integer and must be equal (int32 in both packages).
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gelly_streaming_tpu as gj
import gelly_streaming_tpu_torch as gt
from gelly_streaming_tpu.datasets import IdentityDict as JaxIdentityDict
from gelly_streaming_tpu.library.triangles import WindowTriangles as JaxWindowTriangles
from gelly_streaming_tpu.ops import triangles as jtri
from gelly_streaming_tpu_torch.datasets import IdentityDict
from gelly_streaming_tpu_torch.library import WindowTriangles
from gelly_streaming_tpu_torch.library.triangles import _oriented_degree_bucket
from gelly_streaming_tpu_torch.ops import triangles as ttri

# ExamplesTestData.TRIANGLES_DATA: (src, trg, timestamp)
TRIANGLES_DATA = [
    (1, 2, 100), (1, 3, 150), (3, 2, 200), (2, 4, 250), (3, 4, 300),
    (3, 5, 350), (4, 5, 400), (4, 6, 450), (6, 5, 500), (5, 7, 550),
    (6, 7, 600), (8, 6, 650), (7, 8, 700), (7, 9, 750), (8, 9, 800),
    (10, 8, 850), (9, 10, 900), (9, 11, 950), (10, 11, 1000),
]
WINDOW_GOLDEN = [(2, 399), (3, 799), (2, 1199)]


def make_stream(n_vertices, n_edges, seed=7):
    """``bench.py:make_stream``: Zipf-skewed endpoints (config #3's data)."""
    rng = np.random.default_rng(seed)
    u = rng.random(n_edges)
    v = rng.random(n_edges)
    src = np.minimum((n_vertices * u**0.75 * rng.random(n_edges)).astype(np.int64), n_vertices - 1)
    dst = np.minimum((n_vertices * v**0.75 * rng.random(n_edges)).astype(np.int64), n_vertices - 1)
    return src.astype(np.int32), dst.astype(np.int32)


def both_run(window_j, window_t, edges):
    want = list(JaxWindowTriangles(window_j).run(edges))
    got = list(WindowTriangles(window_t, device="cpu").run(edges))
    assert got == want
    return got


def test_window_triangles_golden():
    got = both_run(gj.EventTimeWindow(400, timestamp_fn=lambda e: e[2]),
                   gt.EventTimeWindow(400, timestamp_fn=lambda e: e[2]), TRIANGLES_DATA)
    assert got == WINDOW_GOLDEN


def _brute_force_total(edges):
    adj = {}
    for s, d, *_ in edges:
        adj.setdefault(s, set()).add(d)
        adj.setdefault(d, set()).add(s)
    return sum(1 for a, b, c in itertools.combinations(sorted(adj), 3)
               if b in adj[a] and c in adj[a] and c in adj[b])


def test_window_triangles_count_window_all_at_once():
    n = len(TRIANGLES_DATA)
    [(count, idx)] = both_run(gj.CountWindow(n), gt.CountWindow(n), TRIANGLES_DATA)
    assert idx == 0 and count == 9 == _brute_force_total(TRIANGLES_DATA)


def test_window_triangles_empty_and_no_triangle():
    edges = [(1, 2, 0.0), (3, 4, 0.0), (5, 6, 0.0)]
    assert both_run(gj.CountWindow(3), gt.CountWindow(3), edges) == [(0, 0)]


def test_window_triangles_duplicate_edges_not_double_counted():
    edges = [(1, 2, 0), (2, 3, 0), (3, 1, 0), (2, 1, 0), (1, 3, 0)]
    assert both_run(gj.CountWindow(10), gt.CountWindow(10), edges) == [(1, 0)]


def test_window_triangles_run_stream_matches_run():
    """The ``slice()`` system path counts what the windower path counts,
    re-windowing 5-edge blocks into 7-edge slices; counts stay int32
    device scalars until read."""
    src = np.array([e[0] for e in TRIANGLES_DATA])
    dst = np.array([e[1] for e in TRIANGLES_DATA])
    stream = gt.SimpleEdgeStream((src, dst), window=gt.CountWindow(5), device="cpu")
    out = list(WindowTriangles(gt.CountWindow(7), device="cpu").run_stream(stream))
    assert all(isinstance(c, torch.Tensor) and c.dtype == torch.int32 for c, _ in out)
    jstream = gj.SimpleEdgeStream((src, dst), window=gj.CountWindow(5))
    want = [(int(c), i) for c, i in JaxWindowTriangles(gj.CountWindow(7)).run_stream(jstream)]
    assert [(int(c), i) for c, i in out] == want
    run = list(WindowTriangles(gt.CountWindow(7), device="cpu").run(
        [(int(s), int(d)) for s, d in zip(src, dst)]))
    assert [c for c, _ in want] == [c for c, _ in run]


@pytest.mark.parametrize("seed", [0, 1])
def test_window_kernel_per_vertex_counts_and_prep_match_jax(seed):
    """``window_triangle_count``'s total and per-vertex counts, and its
    canonical dedup, on a random multigraph with self-loops and padding;
    a row width above the oriented out-degree bound gives the same
    counts, and small edge chunks too."""
    rng = np.random.default_rng(seed)
    n, v = 300, 40
    src = rng.integers(0, v, n).astype(np.int32)
    dst = rng.integers(0, v, n).astype(np.int32)
    mask = rng.random(n) < 0.9
    width = _oriented_degree_bucket(src[mask], dst[mask], v)
    want_total, want_pv = jax.jit(jtri.window_triangle_count, static_argnums=(3, 4))(
        jnp.asarray(src), jnp.asarray(dst), jnp.asarray(mask), v, width)
    for w, chunk in ((width, 1 << 16), (2 * width, 64)):
        total, pv = ttri.window_triangle_count(
            torch.from_numpy(src), torch.from_numpy(dst), torch.from_numpy(mask), v, w,
            edge_chunk=chunk)
        assert total.dtype == pv.dtype == torch.int32
        assert int(total) == int(want_total) > 0
        np.testing.assert_array_equal(pv.numpy(), np.asarray(want_pv))
    assert int(pv.sum()) == 3 * int(total)
    ju = jtri.dedup_canonical(*jtri.canonicalize(
        jnp.asarray(src), jnp.asarray(dst), jnp.asarray(mask)), v)
    tu = ttri.dedup_canonical(*ttri.canonicalize(
        torch.from_numpy(src), torch.from_numpy(dst), torch.from_numpy(mask)), v)
    for a, b in zip(tu, ju):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_zipf_stream_run_stream_matches_jax():
    """Config #3's generator at 2^14 vertices in 2^16-edge windows (4
    windows) through ``slice()``: every window's count equals the JAX
    package's."""
    n_vertices, window = 1 << 14, 1 << 16
    src, dst = make_stream(n_vertices, 4 * window, seed=9)
    stream = gt.SimpleEdgeStream((src, dst), window=gt.CountWindow(window),
                                 vertex_dict=IdentityDict(n_vertices), device="cpu")
    got = [(int(c), i) for c, i in WindowTriangles(gt.CountWindow(window),
                                                   device="cpu").run_stream(stream)]
    jstream = gj.SimpleEdgeStream((src, dst), window=gj.CountWindow(window),
                                  vertex_dict=JaxIdentityDict(n_vertices))
    want = [(int(c), i) for c, i in JaxWindowTriangles(gj.CountWindow(window)).run_stream(jstream)]
    assert got == want and len(got) == 4 and min(c for c, _ in got) > 0


def test_exact_triangle_count_is_a_later_slice():
    """ExactTriangleCount and the packed operations came with slice 5 (their
    parity tests are tests/test_torch_exact_triangles.py); what stays for a
    later slice on the triangle path is the edge-sharded window count."""
    from gelly_streaming_tpu_torch.library import ExactTriangleCount

    assert ExactTriangleCount()._counts is None
    counts, delta = ttri.packed_triangle_update(
        *ttri.grow_packed_columns(None, None, None, 8, device="cpu")[1:],
        torch.zeros(5, dtype=torch.int32), *(torch.zeros(1, dtype=torch.int32),) * 3,
        torch.ones(1, dtype=torch.bool), torch.zeros(4, dtype=torch.int32), 4)
    assert int(delta) == 0 and counts.shape == (4,)
    with pytest.raises(NotImplementedError, match="slice 6"):
        ttri.window_triangle_count_sharded()


def test_window_triangles_cli_itcase(tmp_path):
    """``example/window_triangles.py --cpu``: ``WindowTrianglesITCase``'s
    output lines, equal to the JAX package's CLI."""
    from gelly_streaming_tpu.example import window_triangles as jax_cli
    from gelly_streaming_tpu_torch.example import window_triangles as cli

    inp = tmp_path / "edges.txt"
    inp.write_text("".join(f"{s} {d} {t}\n" for s, d, t in TRIANGLES_DATA))
    cli.main(["--cpu", str(inp), str(tmp_path / "port.txt"), "400"])
    jax_cli.main([str(inp), str(tmp_path / "jax.txt"), "400"])
    got = (tmp_path / "port.txt").read_text().splitlines()
    assert got == (tmp_path / "jax.txt").read_text().splitlines()
    assert set(got) == {"(2,399)", "(3,799)", "(2,1199)"}
