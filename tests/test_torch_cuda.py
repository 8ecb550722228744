"""The port on the card: both CUDA kernels of ``fused_sage_matmul`` (the
tensor-core "tc" and the CUDA-core "simt") against their plain version,
the streaming GraphSAGE slice on the card against the same slice on the
CPU, streaming Connected Components on the card (every carry, per
window and in superbatches, and from a file) against the CPU, with the
forest carry's host reads bounded by its fixpoint turns, and the window
and neighborhood layer (the degree update, the segmented scan, the
lockstep fold, the window triangle count) against the CPU, with the
degree and triangle loops making no host sync per window, and slice 5a:
PageRank (ranks within 1e-6 of the CPU, one host read per chunk),
bipartiteness on every carry and superbatch, exact triangles and the
device spanners (k = 2, 3) against the CPU with no host sync per window.

Every test here is marked ``cuda`` and skips where
``torch.cuda.is_available()`` is false. The file imports only torch, numpy
and the port, so it also runs on a machine without JAX::

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

import gelly_streaming_tpu_torch as gt
from gelly_streaming_tpu_torch.datasets import IdentityDict
from gelly_streaming_tpu_torch.models import (
    StreamingGraphSAGE,
    TableFeatureSource,
    params_from_numpy,
)
from gelly_streaming_tpu_torch.ops import sage_kernels
from gelly_streaming_tpu_torch.ops.sage_kernels import (
    fused_sage_matmul,
    fused_sage_matmul_plain,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", torch.cuda.current_device())


def _operands(seed, v, f, o):
    rng = np.random.default_rng(seed)
    return [
        rng.normal(size=s).astype(np.float32)
        for s in ((v, f), (v, f), (f, o), (f, o), (o,))
    ]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_sage_matmul_kernel_matches_plain_on_card(card, dtype):
    """f32 within 1e-4 of max|ref| (summation order); bf16 within 1e-2
    (one rounding of the output to bf16). Ragged shapes and F = 0."""
    dt = getattr(torch, dtype)
    tol = 1e-4 if dt == torch.float32 else 1e-2
    for shape in [(100, 48, 72), (1, 1, 1), (257, 130, 65), (300, 0, 9)]:
        for activation in ("relu", "none"):
            ops = [torch.from_numpy(a).to(card, dt) for a in _operands(1, *shape)]
            before = sage_kernels.LAUNCHES
            got = fused_sage_matmul(*ops, activation)
            torch.cuda.synchronize()
            assert sage_kernels.LAUNCHES == before + 1
            want = fused_sage_matmul_plain(*ops, activation)
            err = (got.float() - want.float()).abs().max().item()
            assert err <= tol * max(want.float().abs().max().item(), 1.0), shape


def test_streaming_graphsage_on_card_matches_cpu(card):
    """512 vertices, 4 windows of 1024 edges, dims [16, 32, 16] in f32: the
    card's run launches the kernel twice per window and agrees with the
    CPU run (index_add_ sums in another order on the card)."""
    rng = np.random.default_rng(5)
    src = rng.integers(0, 512, 4096).astype(np.int32)
    dst = rng.integers(0, 512, 4096).astype(np.int32)
    table = rng.normal(size=(512, 16)).astype(np.float32)
    params = [
        {
            "w_self": rng.normal(size=(fi, fo)).astype(np.float32) / np.sqrt(fi),
            "w_nbr": rng.normal(size=(fi, fo)).astype(np.float32) / np.sqrt(fi),
            "b": rng.normal(size=(fo,)).astype(np.float32) * 0.1,
        }
        for fi, fo in ((16, 32), (32, 16))
    ]

    def run(device):
        stream = gt.SimpleEdgeStream((src, dst), window=gt.CountWindow(1024),
                                     vertex_dict=IdentityDict(512), device=device)
        sage = StreamingGraphSAGE(params_from_numpy(params, torch.float32, device), 16)
        return [o.cpu().numpy() for o in sage.run(
            stream, TableFeatureSource(table, device=device))]

    want = run("cpu")
    sage_kernels.LAUNCHES = 0
    sage_kernels.LAUNCHES_BY_VARIANT.update(tc=0, simt=0)
    got = run(card)
    assert sage_kernels.LAUNCHES == 2 * 4
    assert sage_kernels.LAUNCHES_BY_VARIANT == {"tc": 0, "simt": 2 * 4}  # f32
    for a, b in zip(want, got):
        np.testing.assert_allclose(b, a, rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("f, o", [(48, 72), (136, 264)])
@pytest.mark.parametrize("v", [1, 100, 257, 65537])
def test_tensor_core_kernel_matches_plain_on_ragged_shapes(card, v, f, o):
    """bf16, F and O multiples of 8 but not of 64, V off the 128-row tile,
    O > 256 (two column tiles): the call takes "tc" and agrees with the
    plain version within 1e-2 of max|ref| (one rounding to bf16)."""
    for activation in ("relu", "none"):
        ops = [torch.from_numpy(a).to(card, torch.bfloat16)
               for a in _operands(2, v, f, o)]
        before = dict(sage_kernels.LAUNCHES_BY_VARIANT)
        got = fused_sage_matmul(*ops, activation)
        torch.cuda.synchronize()
        assert sage_kernels.LAUNCHES_BY_VARIANT["tc"] == before["tc"] + 1
        assert sage_kernels.LAUNCHES_BY_VARIANT["simt"] == before["simt"]
        want = fused_sage_matmul_plain(*ops, activation)
        err = (got.float() - want.float()).abs().max().item()
        assert err <= 1e-2 * max(want.float().abs().max().item(), 1.0)


def test_bf16_slice_launches_only_the_tensor_core_kernel(card):
    """The bf16 slice ([16, 32, 16], 4 windows) launches "tc" twice per
    window and "simt" never, and agrees with the same slice on the CPU
    within 2e-2 of max|ref| (bf16 sums in another order on the card)."""
    rng = np.random.default_rng(6)
    src = rng.integers(0, 512, 4096).astype(np.int32)
    dst = rng.integers(0, 512, 4096).astype(np.int32)
    table = rng.normal(size=(512, 16)).astype(np.float32)
    params = [
        {"w_self": rng.normal(size=(fi, fo)).astype(np.float32) / np.sqrt(fi),
         "w_nbr": rng.normal(size=(fi, fo)).astype(np.float32) / np.sqrt(fi),
         "b": rng.normal(size=(fo,)).astype(np.float32) * 0.1}
        for fi, fo in ((16, 32), (32, 16))
    ]

    def run(device):
        stream = gt.SimpleEdgeStream((src, dst), window=gt.CountWindow(1024),
                                     vertex_dict=IdentityDict(512), device=device)
        sage = StreamingGraphSAGE(params_from_numpy(params, torch.bfloat16, device), 16)
        feats = TableFeatureSource(torch.from_numpy(table).to(torch.bfloat16), device=device)
        return [o.float().cpu().numpy() for o in sage.run(stream, feats)]

    want = run("cpu")
    sage_kernels.LAUNCHES_BY_VARIANT.update(tc=0, simt=0)
    got = run(card)
    assert sage_kernels.LAUNCHES_BY_VARIANT == {"tc": 2 * 4, "simt": 0}
    for a, b in zip(want, got):
        assert np.abs(b - a).max() <= 2e-2 * max(np.abs(a).max(), 1.0)


def test_device_table_loop_makes_no_host_sync(card):
    """The device-table path of ``StreamingGraphSAGE.run`` makes no host
    sync per window: run under ``torch.cuda.set_sync_debug_mode("error")``,
    any synchronizing call raises."""
    rng = np.random.default_rng(9)
    src = rng.integers(0, 1024, 8192).astype(np.int32)
    dst = rng.integers(0, 1024, 8192).astype(np.int32)
    table = TableFeatureSource(rng.normal(size=(1024, 16)).astype(np.float32),
                               device=card)
    params = params_from_numpy(
        [{"w_self": np.full((16, 8), 0.1, np.float32),
          "w_nbr": np.full((16, 8), 0.1, np.float32),
          "b": np.zeros(8, np.float32)}],
        torch.bfloat16, card,
    )

    def stream():
        return gt.SimpleEdgeStream((src, dst), window=gt.CountWindow(2048),
                                   vertex_dict=IdentityDict(1024), device=card)

    list(StreamingGraphSAGE(params, 16).run(stream(), table))  # warm caches
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        outs = list(StreamingGraphSAGE(params, 16).run(stream(), table))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert len(outs) == 4 and bool(torch.isfinite(outs[-1]).all())


# --------------------------------------------------------------------- #
# Streaming Connected Components on the card
# --------------------------------------------------------------------- #
def _cc_run(device, carry, superbatch=1, window=256):
    from gelly_streaming_tpu_torch.library import ConnectedComponents

    rng = np.random.default_rng(21)
    src = rng.integers(0, 3000, 4000)
    dst = rng.integers(0, 3000, 4000)
    stream = gt.SimpleEdgeStream((src, dst), window=gt.CountWindow(window),
                                 vertex_dict=IdentityDict(1 << 12), device=device)
    agg = ConnectedComponents(carry=carry, superbatch=superbatch)
    out = [c.labels() for c in stream.aggregate(agg)]
    agg.sync()
    return out, agg


@pytest.mark.parametrize("superbatch", [1, 4])
@pytest.mark.parametrize("carry", ["forest", "host", "dense"])
def test_cc_on_card_matches_cpu(card, carry, superbatch):
    """Every carry on the card gives the CPU's per-window labels and
    checkpoint state exactly (integer results; the order of a scatter's
    writes never decides a value)."""
    want, cpu_agg = _cc_run("cpu", carry, superbatch)
    got, agg = _cc_run(card, carry, superbatch)
    assert agg._cc_mode == carry and len(got) == len(want) == 16
    for (wi, wl), (gi, gl) in zip(want, got):
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gl, wl)
    a, b = cpu_agg.snapshot_state(), agg.snapshot_state()
    np.testing.assert_array_equal(a["labels"], b["labels"])
    np.testing.assert_array_equal(a["touched"], b["touched"])


def test_cc_auto_carry_is_the_forest_on_card(card):
    from gelly_streaming_tpu_torch.library import ConnectedComponents

    stream = gt.SimpleEdgeStream([(1, 2), (2, 3), (6, 7)], window=gt.CountWindow(2),
                                 device=card)
    agg = ConnectedComponents()
    last = list(stream.aggregate(agg))[-1]
    assert agg._cc_mode == "forest" and agg._canon.device.type == "cuda"
    assert str(last) == "{1=[1, 2, 3], 6=[6, 7]}"


def test_cc_host_reads_per_window_are_the_fixpoint_turns(card):
    """The forest carry on the card reads to the host once per fixpoint
    turn and nowhere else while it folds: reads <= turns + 2 a window."""
    from gelly_streaming_tpu_torch.summaries import labels

    _cc_run(card, "forest")  # warm
    labels.HOST_READS = labels.FIXPOINT_TURNS = 0
    out, _agg = _cc_run(card, "forest")
    reads, turns = labels.HOST_READS, labels.FIXPOINT_TURNS
    # the 16 windows' labels() downloads count too: one forest each
    assert reads <= turns + 2 * len(out)
    assert 0 < turns <= 64 * len(out)


def test_stream_file_cc_on_card_matches_cpu(card, tmp_path):
    """File -> native parse -> windows (prefetched on the card's device) ->
    CC, on the card and on the CPU."""
    from gelly_streaming_tpu_torch import datasets, native
    from gelly_streaming_tpu_torch.library import ConnectedComponents

    rng = np.random.default_rng(4)
    path = str(tmp_path / "g.txt")
    native.write_edge_file(path, rng.integers(0, 5000, 20000), rng.integers(0, 5000, 20000))

    def run(device):
        stream = datasets.stream_file(path, window=gt.CountWindow(4096),
                                      vertex_dict=datasets.IdentityDict(1 << 13),
                                      prefetch_depth=2, device=device)
        agg = ConnectedComponents()
        out = [c.labels() for c in stream.aggregate(agg)]
        return out, agg._cc_mode

    want, cpu_mode = run("cpu")
    got, mode = run(card)
    assert (cpu_mode, mode) == ("host", "forest") and len(got) == 5
    for (wi, wl), (gi, gl) in zip(want, got):
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gl, wl)


# --------------------------------------------------------------------- #
# The window and neighborhood layer on the card
# --------------------------------------------------------------------- #
def _zipf(seed, n_vertices, n_edges):
    rng = np.random.default_rng(seed)
    u, v = rng.random(n_edges), rng.random(n_edges)
    src = np.minimum((n_vertices * u**0.75 * rng.random(n_edges)).astype(np.int64), n_vertices - 1)
    dst = np.minimum((n_vertices * v**0.75 * rng.random(n_edges)).astype(np.int64), n_vertices - 1)
    return src.astype(np.int32), dst.astype(np.int32)


def test_degree_stream_on_card_matches_cpu_without_host_sync(card):
    """Every window's changed ids and degrees equal the CPU's; the loop runs
    under ``set_sync_debug_mode("error")`` (any implicit host sync raises)
    until the stream's one wait at its end."""
    src, dst = _zipf(3, 1 << 12, 1 << 15)

    def stream(device):
        return gt.SimpleEdgeStream((src, dst), window=gt.CountWindow(1 << 12),
                                   vertex_dict=IdentityDict(1 << 12), device=device)

    want = [b.columns for b in stream("cpu").get_degrees().batches()]
    list(stream(card).get_degrees().batches())  # warm
    torch.cuda.synchronize()
    batches = []
    torch.cuda.set_sync_debug_mode("error")
    try:
        for b in stream(card).get_degrees().batches():
            batches.append(b)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert len(batches) == len(want) == 8
    for b, (wi, wd) in zip(batches, want):
        np.testing.assert_array_equal(b.columns[0], wi)
        np.testing.assert_array_equal(b.columns[1], wd)


def test_segmented_scan_and_lockstep_fold_on_card_match_cpu(card):
    """The generic scan (the degree workload's clamped composition, and a
    float sum within 1e-5) and the lockstep fold (an order-dependent hash,
    exact) give the CPU's results."""
    from gelly_streaming_tpu_torch.ops import segment

    rng = np.random.default_rng(8)
    n, v = 5000, 300
    ids = rng.integers(0, v, n).astype(np.int32)
    nbr = rng.integers(0, v, n).astype(np.int32)
    mask = rng.random(n) < 0.9
    ints = rng.integers(-3, 4, n).astype(np.int32)
    vals = rng.normal(size=n).astype(np.float32)

    def combine(a, b):
        return a[0] + b[0], torch.maximum(b[1], a[1] + b[0]), a[2] + b[2]

    def fold(acc, vid, nid, val):
        return (acc[0] * 31 + nid + vid) % 1000003, acc[1] * 0.5 + val

    def run(device):
        t = [torch.from_numpy(a).to(device) for a in (ids, nbr, mask, ints, vals)]
        (s, m, f), ne = segment.segmented_reduce_generic(
            (t[3], torch.zeros_like(t[3]), t[4]), t[0], t[2], v, combine)
        before = segment.FOLD_TURNS
        (h, d), ne2 = segment.segmented_fold((0, 0.0), fold, t[0], t[1], t[4], t[2], v)
        turns = segment.FOLD_TURNS - before
        return [x.cpu().numpy() for x in (s, m, f, ne, h, d, ne2)], turns

    (s, m, f, ne, h, d, ne2), turns = run("cpu")
    (gs, gm, gf, gne, gh, gd, gne2), gturns = run(card)
    np.testing.assert_array_equal(gne, ne)
    np.testing.assert_array_equal(gs[ne], s[ne])
    np.testing.assert_array_equal(gm[ne], m[ne])
    np.testing.assert_allclose(gf[ne], f[ne], rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(gne2, ne2)
    np.testing.assert_array_equal(gh, h)
    np.testing.assert_allclose(gd, d, rtol=1e-6, atol=1e-6)
    assert gturns == turns == np.bincount(ids[mask], minlength=v).max()


def test_window_triangles_on_card_match_cpu_without_host_sync(card):
    """``window_triangle_count``'s total and per-vertex counts equal the
    CPU's; ``run_stream`` gives the CPU's counts and its loop makes no host
    sync (the counts stay device scalars)."""
    from gelly_streaming_tpu_torch.library import WindowTriangles
    from gelly_streaming_tpu_torch.library.triangles import _oriented_degree_bucket
    from gelly_streaming_tpu_torch.ops.triangles import window_triangle_count

    src, dst = _zipf(9, 1 << 12, 1 << 16)
    width = _oriented_degree_bucket(src[: 1 << 15], dst[: 1 << 15], 1 << 12)
    out = []
    for device in ("cpu", card):
        s = torch.from_numpy(src[: 1 << 15]).to(device)
        d = torch.from_numpy(dst[: 1 << 15]).to(device)
        m = torch.ones(1 << 15, dtype=torch.bool, device=device)
        total, pv = window_triangle_count(s, d, m, 1 << 12, width)
        out.append((int(total), pv.cpu().numpy()))
    assert out[1][0] == out[0][0] > 0
    np.testing.assert_array_equal(out[1][1], out[0][1])

    def counts(device, strict=False):
        stream = gt.SimpleEdgeStream((src, dst), window=gt.CountWindow(1 << 14),
                                     vertex_dict=IdentityDict(1 << 12), device=device)
        wt = WindowTriangles(gt.CountWindow(1 << 14), device=device)
        if strict:
            torch.cuda.set_sync_debug_mode("error")
        try:
            totals = [c for c, _ in wt.run_stream(stream)]
        finally:
            torch.cuda.set_sync_debug_mode("default")
        return [int(c) for c in totals]

    want = counts("cpu")
    counts(card)  # warm
    assert counts(card, strict=True) == want and len(want) == 4


# --------------------------------------------------------------------- #
# Slice 5: PageRank, bipartiteness, exact triangles, the spanners
# --------------------------------------------------------------------- #
def _syncs(run):
    """``run()`` under ``set_sync_debug_mode("error")``: any host sync
    raises."""
    torch.cuda.set_sync_debug_mode("error")
    try:
        return run()
    finally:
        torch.cuda.set_sync_debug_mode("default")


@pytest.mark.parametrize("superbatch", [1, 4])
def test_pagerank_on_card_matches_cpu(card, superbatch):
    """Ranks within 1e-6 of the CPU run's, iterations within 2 (float
    atomics sum in another order on the card); one host read per chunk."""
    from gelly_streaming_tpu_torch.library import IncrementalPageRank
    from gelly_streaming_tpu_torch.library import pagerank as tpr

    src, dst = _zipf(11, 1 << 12, 1 << 15)
    out = {}
    for device in ("cpu", card):
        stream = gt.SimpleEdgeStream((src, dst), window=gt.CountWindow(1 << 13),
                                     vertex_dict=IdentityDict(1 << 12), device=device)
        pr = IncrementalPageRank(superbatch=superbatch)
        tpr.HOST_READS = 0
        ems = list(pr.run(stream))
        iters = [int(e.iterations) for e in ems]
        out[str(device)] = (pr._carry[2].cpu().numpy(), iters, tpr.HOST_READS)
    (rc, ic, _), (rg, ig, reads) = out["cpu"], out[str(card)]
    assert np.abs(rc - rg).max() <= 1e-6 and abs(rg.sum() - 1) <= 1e-5
    assert max(abs(a - b) for a, b in zip(ic, ig)) <= 2
    assert reads == sum(-(-i // 10) for i in ig)


@pytest.mark.parametrize("superbatch", [1, 4])
@pytest.mark.parametrize("carry", ["forest", "host", "dense"])
def test_bipartiteness_on_card_matches_cpu(card, carry, superbatch):
    from gelly_streaming_tpu_torch.library import BipartitenessCheck

    src, dst = _zipf(12, 1 << 12, 1 << 14)
    tests = [(src & ~1, dst | 1), (src, dst)]  # bipartite by construction, then not
    for s, d in tests:
        out = {}
        for device in ("cpu", card):
            stream = gt.SimpleEdgeStream((s, d), window=gt.CountWindow(1 << 12),
                                         vertex_dict=IdentityDict(1 << 12), device=device)
            agg = BipartitenessCheck(carry=carry, superbatch=superbatch)
            out[str(device)] = [str(c) for c in stream.aggregate(agg)]
        assert out[str(card)] == out["cpu"] and len(out["cpu"]) == 4
    assert out["cpu"][-1] == "(false,{})"


def test_bipartiteness_auto_is_the_forest_on_card(card):
    from gelly_streaming_tpu_torch.library import BipartitenessCheck

    src, dst = _zipf(13, 1 << 10, 1 << 12)
    agg = BipartitenessCheck()
    stream = gt.SimpleEdgeStream((src & ~1, dst | 1), window=gt.CountWindow(1 << 10),
                                 vertex_dict=IdentityDict(1 << 10), device=card)
    last = list(stream.aggregate(agg))[-1]
    assert agg._bp_mode == "forest" and last.success
    assert agg._failed.device.type == "cuda"


def test_exact_triangles_on_card_match_cpu_without_host_sync(card):
    from gelly_streaming_tpu_torch.library import ExactTriangleCount

    src, dst = _zipf(14, 1 << 11, 1 << 15)

    def run(device, strict=False):
        stream = gt.SimpleEdgeStream((src, dst), window=gt.CountWindow(1 << 13),
                                     vertex_dict=IdentityDict(1 << 11), device=device)
        etc = ExactTriangleCount()
        batches = _syncs(lambda: list(etc.run(stream))) if strict else list(etc.run(stream))
        return [list(b) for b in batches], etc

    want, _ = run("cpu")
    run(card)  # warm
    got, etc = run(card, strict=True)
    assert got == want and len(got) == 4
    assert etc._counts.device.type == "cuda"


@pytest.mark.parametrize("k", [2, 3])
def test_device_spanner_on_card_matches_cpu_without_host_sync(card, k):
    from gelly_streaming_tpu_torch.library import DeviceSpanner

    src, dst = _zipf(15, 1 << 11, 1 << 14)

    def run(device, strict=False):
        stream = gt.SimpleEdgeStream((src, dst), window=gt.CountWindow(1 << 12),
                                     vertex_dict=IdentityDict(1 << 11), device=device)
        sp = DeviceSpanner(k=k)
        snaps = _syncs(lambda: list(sp.run(stream))) if strict else list(sp.run(stream))
        return [set(s) for s in snaps]

    want = run("cpu")
    run(card)  # warm
    assert run(card, strict=True) == want and len(want) == 4
