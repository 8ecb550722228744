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
device spanners (k = 2, 3) against the CPU with no host sync per window,
and slice 5b: the device vertex dictionary against the CPU, the
device-encode ingest in both forms with no host sync, both sampling
window forms against the CPU fed the same uniforms, and iterative CC's
diff path against its incremental path, and slice 7a: an ``AutoCheckpoint``
barrier (CC's forest carry, and a workload) written on the card restores on
the CPU and the reverse, and a supervised run killed at ``pipeline.item``
on the card resumes to the uninterrupted labels, and slice 7b (ingest):
sharded binary ingest into CC on the card equals the same run on the CPU
(the forest carry picked on the card), and one ``mp_worker_main`` on the
card resumes from the epoch a CPU worker committed, and slice 9a (serving):
a held snapshot's bytes stay unchanged on the card for every carry at
superbatch 1 and 4, the query engine's torch steps on the card answer
equal to its host path and to the CPU, a live ``StreamServer`` answers on
the card from a CUDA-event-ready snapshot, and a standby given the card
uploads the primary's mirrored snapshots, and slice 9b (routing): a
2-shard router over servers whose tables are CUDA tensors answers equal to
the host fold of the whole stream, a split child given the card holds its
followed snapshots there, and a process that ran a ``ShardRouter`` alone
never made a CUDA context.

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


# --------------------------------------------------------------------- #
# Slice 5b: the device vertex dictionary, the estimators, iterative CC
# --------------------------------------------------------------------- #
def test_encode_batch_on_card_matches_cpu(card):
    """Known, new, repeated and near-INT32_MAX ids, then an overflow of the
    16-key table: every output id and state field equal to the CPU's."""
    from gelly_streaming_tpu_torch.ops import device_dict as dd

    batches = [np.arange(10, 0, -1), np.array([3, 3, 7, 2**31 - 2, 0, 7]),
               np.arange(12), np.arange(5, 30)]
    states = {"cpu": dd.init_table(16, "cpu"), "card": dd.init_table(16, card)}
    for b in batches:
        b = torch.from_numpy(b.astype(np.int32))
        outs = {}
        for name, dev in (("cpu", "cpu"), ("card", card)):
            states[name], outs[name] = dd.encode_batch(states[name], b.to(dev))
        assert torch.equal(outs["card"].cpu(), outs["cpu"])
        for f in states["cpu"]:
            assert torch.equal(states["card"][f].cpu(), states["cpu"][f]), f
    assert int(states["card"]["probe"]) < 0


@pytest.mark.parametrize("form", ["bound", "growth"])
def test_device_encode_ingest_makes_no_host_sync_and_cc_matches_cpu(card, tmp_path, form):
    """The device-encode window loop (parse, upload, encode) under
    ``set_sync_debug_mode("error")``; the components on the card equal
    the CPU's, the probe non-negative."""
    from gelly_streaming_tpu_torch import datasets, native
    from gelly_streaming_tpu_torch.library import ConnectedComponents

    rng = np.random.default_rng(13)
    src, dst = rng.integers(0, 5000, 20000), rng.integers(0, 5000, 20000)
    if form == "growth":  # sparse int32 ids through an injective map
        src, dst = src * 7919 % (2**31 - 1), dst * 7919 % (2**31 - 1)
    p = str(tmp_path / "g.txt")
    native.write_edge_file(p, src, dst)
    kw = (dict(dense_ids=False, min_vertex_capacity=16) if form == "growth"
          else dict(min_vertex_capacity=1 << 13))

    def stream(device):
        return datasets.stream_file(p, window=gt.CountWindow(4096), device_encode=True,
                                    device=device, **kw)

    list(stream(card).blocks())  # warm the caches
    torch.cuda.synchronize()
    s = stream(card)
    blocks = _syncs(lambda: list(s.blocks()))
    assert len(blocks) == 5 and int(s.vertex_dict._state["probe"]) >= 0
    got = want = None
    for got in stream(card).aggregate(ConnectedComponents()):
        pass
    for want in stream("cpu").aggregate(ConnectedComponents()):
        pass
    assert sorted(got.component_sets()) == sorted(want.component_sets())


@pytest.mark.parametrize("form", ["vectorized", "scan"])
def test_sampling_on_card_matches_cpu_with_the_same_uniforms(card, form):
    from gelly_streaming_tpu_torch.library import sampling

    rng = np.random.default_rng(17)
    v, k, cap, n = (40, 4096, 1024, 1000) if form == "vectorized" else (60000, 512, 64, 60)
    s = rng.integers(0, 40, cap).astype(np.int32)
    d = rng.integers(0, 40, cap).astype(np.int32)
    mask = np.arange(cap) < n
    st = {"cpu": sampling.init_sampler_state(k, "cpu"), "card": sampling.init_sampler_state(k, card)}
    ec = 0
    for _ in range(3):
        if form == "vectorized":
            u = [torch.rand(k) for _ in range(3)]
            out = {}
            for name, dev in (("cpu", "cpu"), ("card", card)):
                st[name], n_total, beta = sampling._window_vectorized(
                    st[name], ec, torch.from_numpy(s).to(dev), torch.from_numpy(d).to(dev),
                    torch.from_numpy(mask).to(dev), n, v, *(x.to(dev) for x in u))
                out[name] = int(beta)
            assert out["card"] == out["cpu"]
        else:
            u = [torch.rand(n, k) for _ in range(2)]
            for name, dev in (("cpu", "cpu"), ("card", card)):
                st[name], n_total = sampling._window_scan(
                    st[name], ec, s[:n], d[:n], v, *(x.to(dev) for x in u))
        ec = n_total
        for f in st["cpu"]:
            assert torch.equal(st["card"][f].cpu(), st["cpu"][f]), f


def test_iterative_cc_diff_path_on_card_matches_incremental(card, tmp_path):
    from gelly_streaming_tpu_torch import datasets, native
    from gelly_streaming_tpu_torch.library import IterativeConnectedComponents

    rng = np.random.default_rng(21)
    src = rng.integers(0, 3000, 12000)
    dst = rng.integers(0, 3000, 12000)
    p = str(tmp_path / "g.txt")
    native.write_edge_file(p, src, dst)
    runs = {}
    for name, kw in {"incremental": dict(vertex_dict=IdentityDict(4096)),
                     "diff": dict(device_encode=True, min_vertex_capacity=4096)}.items():
        icc = IterativeConnectedComponents()
        s = datasets.stream_file(p, window=gt.CountWindow(3000), device=card, **kw)
        runs[name] = ([list(b) for b in icc.run(s)], icc.labels(), icc._mode)
    assert runs["incremental"][2] == "incremental" and runs["diff"][2] == "diff"
    assert runs["incremental"][:2] == runs["diff"][:2]


# --------------------------------------------------------------------- #
# Slice 7a: barriers across devices, a supervised kill on the card
# --------------------------------------------------------------------- #
def _ckpt_stream(device, vdict=None):
    rng = np.random.default_rng(31)
    edges = list(zip(rng.integers(0, 3000, 12 * 512).tolist(),
                     rng.integers(0, 3000, 12 * 512).tolist()))
    return gt.SimpleEdgeStream(edges, window=gt.CountWindow(512), device=device,
                               vertex_dict=vdict)


@pytest.mark.parametrize("writer,reader", [("card", "cpu"), ("cpu", "card")])
def test_cc_barrier_crosses_devices(card, tmp_path, writer, reader):
    """The forest carry's barrier at window 8, written on one device,
    resumes on the other: the state lands on the reader's device and the
    last window's labels equal an uninterrupted run's."""
    from gelly_streaming_tpu_torch.aggregate.autockpt import AutoCheckpoint
    from gelly_streaming_tpu_torch.library import ConnectedComponents

    dev = {"card": card, "cpu": "cpu"}
    want = list(_ckpt_stream("cpu").aggregate(ConnectedComponents(carry="forest")))[-1].labels()
    path = str(tmp_path / "cc.ckpt")
    run = AutoCheckpoint(path, every=4).run(lambda vd: _ckpt_stream(dev[writer], vd),
                                            ConnectedComponents(carry="forest"))
    for i, _ in enumerate(run):
        if i >= 8:
            break
    run.close()
    ac = AutoCheckpoint(path, every=4)
    assert ac.windows_done() == 8
    agg = ConnectedComponents(carry="forest")
    last = list(ac.run(lambda vd: _ckpt_stream(dev[reader], vd), agg))[-1]
    assert agg._canon.device.type == ("cuda" if reader == "card" else "cpu")
    for a, b in zip(last.labels(), want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("writer,reader", [("card", "cpu"), ("cpu", "card")])
def test_workload_barrier_crosses_devices(card, tmp_path, writer, reader):
    """Exact triangles: the barrier at window 6 from one device resumes on
    the other to the uninterrupted totals."""
    from gelly_streaming_tpu_torch.aggregate.autockpt import AutoCheckpoint
    from gelly_streaming_tpu_torch.library import ExactTriangleCount

    dev = {"card": card, "cpu": "cpu"}
    full = ExactTriangleCount()
    for b in full.run(_ckpt_stream("cpu")):
        list(b)
    path = str(tmp_path / "tri.ckpt")
    run = AutoCheckpoint(path, every=3).run(lambda vd: _ckpt_stream(dev[writer], vd),
                                            ExactTriangleCount())
    for i, b in enumerate(run):
        list(b)
        if i >= 6:
            break
    run.close()
    second = ExactTriangleCount()
    for b in AutoCheckpoint(path, every=3).run(lambda vd: _ckpt_stream(dev[reader], vd), second):
        list(b)
    got, want = second.state_dict(), full.state_dict()
    assert got["total"] == want["total"]
    np.testing.assert_array_equal(got["counts"], want["counts"])


def test_supervised_pipeline_item_kill_on_card(card, tmp_path):
    """A prefetched file stream on the card killed as item 5 is taken:
    one restart from barrier 4, the replayed window deduped, the last
    labels equal to the CPU's uninterrupted run."""
    from gelly_streaming_tpu_torch import datasets, native, obs
    from gelly_streaming_tpu_torch.example.common import supervised_emissions
    from gelly_streaming_tpu_torch.library import ConnectedComponents
    from gelly_streaming_tpu_torch.resilience import FaultPlan, faults

    rng = np.random.default_rng(6)
    path = str(tmp_path / "g.txt")
    native.write_edge_file(path, rng.integers(0, 4096, 8 * 2048),
                           rng.integers(0, 4096, 8 * 2048))

    def make_stream(device):
        return lambda vd: datasets.stream_file(
            path, window=gt.CountWindow(2048),
            vertex_dict=vd if vd is not None else datasets.IdentityDict(4096),
            prefetch_depth=2, device=device)

    want = list(make_stream("cpu")(None).aggregate(ConnectedComponents()))[-1].labels()
    reg = obs.set_registry(None)
    try:
        with faults.injected(FaultPlan(kill_at_window=5, kill_site="pipeline.item")):
            emissions, _ = supervised_emissions(str(tmp_path / "ck" / "cc.ckpt"), 4,
                                                make_stream(card), ConnectedComponents,
                                                keep=3)
            got = [c.labels() for c in emissions]
        assert reg.counter("resilience.restarts", kind="transient").value == 1
        assert reg.counter("resilience.deduped_windows").value == 1
    finally:
        obs.set_registry(None)
    assert len(got) == 8
    for a, b in zip(got[-1], want):
        np.testing.assert_array_equal(a, b)


def _sharded_cc(device, superbatch, seed=51):
    from gelly_streaming_tpu_torch.core.ingest import (
        ShardedEdgeSource,
        encode_shard_frames,
        partition_edges,
        serve_blobs,
    )

    rng = np.random.default_rng(seed)
    src = rng.integers(0, 60000, 20000).astype(np.int64)
    dst = rng.integers(0, 60000, 20000).astype(np.int64)
    blobs = [encode_shard_frames(s, d, frame_edges=512)
             for s, d, _ in partition_edges(src, dst, None, 4)]
    ports, threads, _stop = serve_blobs(blobs)
    stream = ShardedEdgeSource([("127.0.0.1", p) for p in ports], window=1024).stream(
        device=device)
    from gelly_streaming_tpu_torch.library import ConnectedComponents

    agg = ConnectedComponents(superbatch=superbatch)
    last = None
    for last in stream.aggregate(agg):
        pass
    agg.sync()
    for t in threads:
        t.join(10)
    return last, agg._cc_mode


@pytest.mark.parametrize("superbatch", [1, 4])
def test_sharded_binary_ingest_cc_on_card_matches_cpu(card, superbatch):
    """The merged window order interleaves shards nondeterministically, so
    the final components are compared (they do not depend on the order)."""
    got, mode = _sharded_cc(card, superbatch)
    want, _ = _sharded_cc("cpu", superbatch)
    assert mode == "forest"
    assert {frozenset(c) for c in got.component_sets()} == \
        {frozenset(c) for c in want.component_sets()}


def test_mp_worker_on_card_resumes_from_a_cpu_workers_epoch(card, tmp_path):
    """A one-shard cluster: the CPU worker runs the first half of the
    corpus and commits its epochs; the card worker, over the same
    directory and the whole corpus, resumes from that epoch and emits the
    rest, each window's digest equal to an uninterrupted CPU run's."""
    import json
    import os

    from gelly_streaming_tpu_torch import obs
    from gelly_streaming_tpu_torch.obs.cluster import shard_events_path
    from gelly_streaming_tpu_torch.resilience import chaos

    def run(root, device, windows, tag):
        cfg = dict(chaos.MP_DEFAULTS, processes=1, windows=windows, window_edges=64,
                   root=root, process=0, victim=-1, kill_after=-1, device=device,
                   digests=os.path.join(root, f"digests.{tag}.jsonl"),
                   events=shard_events_path(root, 0),
                   meta=os.path.join(root, f"meta.{tag}.json"), flight=None)
        try:
            chaos.mp_worker_main(cfg)
        finally:
            obs.reset()
        with open(cfg["meta"]) as f:
            return chaos._read_jsonl(cfg["digests"]), json.load(f)

    oracle, _ = run(str(tmp_path / "oracle"), "cpu", 8, "o")
    shared = str(tmp_path / "shared")
    first, _ = run(shared, "cpu", 4, "cpu")
    rest, meta = run(shared, str(card), 8, "card")
    assert [ln["o"] for ln in first] == [0, 1, 2, 3]
    assert meta["resumed_epoch"] == 4 and meta["device"] == str(card)
    assert [ln["o"] for ln in rest] == [4, 5, 6, 7]
    assert [ln["d"] for ln in first + rest] == [ln["d"] for ln in oracle]


# --------------------------------------------------------------------- #
# Slice 9a: serving
# --------------------------------------------------------------------- #
def _serving_edges(n=8 * 512, vmax=3000, seed=40):
    rng = np.random.default_rng(seed)
    return [(int(a), int(b), 0.0) for a, b in rng.integers(0, vmax, (n, 2))]


def _frozen_payload(payload):
    out = {}
    for k, v in payload.items():
        if k == "tids":
            out[k] = np.array(v[: payload["tcount"]], copy=True)
        elif isinstance(v, torch.Tensor):
            out[k] = v.detach().cpu().numpy().copy()
    return out


@pytest.mark.parametrize("superbatch", [1, 4])
@pytest.mark.parametrize("workload", ["cc-forest", "cc-host", "cc-dense", "bip-forest",
                                      "bip-host", "bip-dense", "pagerank"])
def test_held_snapshot_stays_unchanged_on_card(card, workload, superbatch):
    from gelly_streaming_tpu_torch.library import BipartitenessCheck, ConnectedComponents
    from gelly_streaming_tpu_torch.library.pagerank import IncrementalPageRank

    kind, _, carry = workload.partition("-")
    if kind == "cc":
        work = ConnectedComponents(carry=carry, superbatch=superbatch)
    elif kind == "bip":
        work = BipartitenessCheck(carry=carry, superbatch=superbatch)
    else:
        work = IncrementalPageRank(tol=1e-4, superbatch=superbatch)
    stream = gt.SimpleEdgeStream(_serving_edges(), window=gt.CountWindow(512), device=card)
    it = work.servable().payloads(stream)
    first, _wm = next(it)
    assert any(isinstance(v, torch.Tensor) and v.is_cuda for v in first.values())
    held = _frozen_payload(first)
    assert sum(1 for _ in it) >= 6
    torch.cuda.synchronize()
    for k, v in _frozen_payload(first).items():
        np.testing.assert_array_equal(v, held[k], err_msg=k)


def test_held_degree_snapshot_stays_unchanged_on_card(card):
    from gelly_streaming_tpu_torch.library.degrees import DegreeDistribution

    rng = np.random.default_rng(41)
    events = [(int(a), int(b), "+" if rng.random() < 0.8 else "-")
              for a, b in rng.integers(0, 500, (4096, 2))]
    it = DegreeDistribution(gt.CountWindow(512), device=card).servable().payloads(events)
    first, _wm = next(it)
    held = _frozen_payload(first)
    assert sum(1 for _ in it) == 7
    np.testing.assert_array_equal(_frozen_payload(first)["deg"], held["deg"])


@pytest.mark.parametrize("prefer_host", [False, True, "auto"])
def test_query_engine_on_card_equals_host_path_and_cpu(card, prefer_host):
    from gelly_streaming_tpu_torch.library import ConnectedComponents
    from gelly_streaming_tpu_torch.serving import (
        ComponentSizeQuery,
        ConnectedQuery,
        PublishedSnapshot,
        QueryEngine,
        SummaryPullQuery,
    )
    from gelly_streaming_tpu_torch.serving import query as tq

    edges = _serving_edges()
    snaps = []
    for dev in (card, torch.device("cpu")):
        stream = gt.SimpleEdgeStream(edges, window=gt.CountWindow(512), device=dev)
        payload = None
        for payload, _wm in ConnectedComponents(carry="forest").servable().payloads(stream):
            pass
        snaps.append(PublishedSnapshot(payload=payload, window=7, watermark=0, version=1))
    rng = np.random.default_rng(42)
    qs = [ConnectedQuery(int(a), int(b)) for a, b in rng.integers(0, 3100, (512, 2))]
    qs += [ComponentSizeQuery(int(a)) for a in rng.integers(0, 3100, 256)]
    qs.append(SummaryPullQuery())
    before = tq.HOST_READS
    got = QueryEngine(prefer_host=prefer_host).answer_batch(snaps[0], qs)
    reads = tq.HOST_READS - before
    want = QueryEngine(prefer_host=True).answer_batch(snaps[1], qs)
    assert [a.value for a in got] == [a.value for a in want]
    if prefer_host is True:
        assert reads == 1  # one download of the table for the version
    else:
        assert reads >= 3  # the chase's turns + the downloads of the answers


def test_live_server_answers_on_card(card):
    from gelly_streaming_tpu_torch.library import ConnectedComponents
    from gelly_streaming_tpu_torch.serving import ConnectedQuery, StreamServer

    edges = _serving_edges()
    stream = gt.SimpleEdgeStream(edges, window=gt.CountWindow(512), device=card)
    with StreamServer(ConnectedComponents().servable(), stream) as server:
        futs = [server.submit(ConnectedQuery(a, b)) for a, b, _ in edges[:256]]
        assert all(f.result(60).value is True for f in futs)
        server.join(120)
        snap = server.snapshot()
        assert snap.payload["labels"].is_cuda and snap.ready is not None
        torch.cuda.synchronize()
        assert snap.ready.query()
        assert server.store.latest(prefer_ready=True) is snap
        ans = server.ask(ConnectedQuery(*edges[-1][:2]), 30)
        assert ans.value is True and ans.staleness == 0


def test_standby_default_device_holds_cuda_tensors(card, tmp_path):
    from gelly_streaming_tpu_torch.serving import ReplicaServer
    from gelly_streaming_tpu_torch.serving.rpc import demo_payloads

    shared = str(tmp_path / "shared")
    primary = ReplicaServer(demo_payloads(windows=3, pace_s=0.0, device=card), None,
                            dirpath=shared, role="primary", lease_s=5.0)
    standby = ReplicaServer(dirpath=shared, role="standby", lease_s=5.0, monitor=False)
    primary.start()
    standby.start()
    try:
        primary.server.join(30)
        primary.mirror.flush(primary.store)
        import time

        deadline = time.monotonic() + 30
        while time.monotonic() < deadline and standby.store.latest() is None:
            time.sleep(0.01)
        assert standby.store.latest().payload["labels"].is_cuda
    finally:
        standby.close()
        primary.close()


def test_standby_on_card_uploads_mirrored_snapshots(card, tmp_path):
    from gelly_streaming_tpu_torch.serving import ComponentSizeQuery, ReplicaServer
    from gelly_streaming_tpu_torch.serving.rpc import demo_payloads

    shared = str(tmp_path / "shared")
    primary = ReplicaServer(demo_payloads(windows=6, pace_s=0.0, device=card), None,
                            dirpath=shared, role="primary", lease_s=5.0)
    standby = ReplicaServer(dirpath=shared, role="standby", lease_s=5.0, device=card,
                            monitor=False)
    primary.start()
    standby.start()
    try:
        primary.server.join(30)
        primary.mirror.flush(primary.store)
        import time

        deadline = time.monotonic() + 30
        while time.monotonic() < deadline and (
                standby.store.latest() is None
                or standby.store.latest().version < primary.store.latest().version):
            time.sleep(0.01)
        assert standby.store.latest().payload["labels"].is_cuda
        standby.promote(reason="manual")
        a = primary.ask(ComponentSizeQuery(0), timeout=30)
        b = standby.ask(ComponentSizeQuery(0), timeout=30)
        assert (a.value, a.version) == (b.value, b.version) == (7, 6)
    finally:
        standby.close()
        primary.close()


def _shard_stack_on(device, nshards=2, nv=512, ne=3000, seed=7, window=512):
    """``nshards`` shard servers whose tables live on ``device``, each
    behind an ``RpcServer``. Returns ``(addrs, close)``."""
    from gelly_streaming_tpu_torch.serving import RpcServer, StreamServer
    from gelly_streaming_tpu_torch.serving.router import shard_demo_payloads

    servers, rpcs = [], []
    for k in range(nshards):
        srv = StreamServer(shard_demo_payloads(
            n_vertices=nv, n_edges=ne, seed=seed, window=window, shard=k,
            nshards=nshards, device=device), None).start()
        srv.join(60)
        assert srv.snapshot().payload["labels"].device.type == torch.device(device).type
        servers.append(srv)
        rpcs.append(RpcServer(srv, shard=k).start())

    def close():
        for r in rpcs:
            r.close()
        for s_ in servers:
            s_.close()

    return [[f"127.0.0.1:{r.port}"] for r in rpcs], close


def test_router_over_card_shards_equals_the_host_fold(card):
    from gelly_streaming_tpu_torch.serving import (
        ComponentSizeQuery,
        ConnectedQuery,
        DegreeQuery,
        ShardRouter,
    )
    from gelly_streaming_tpu_torch.serving.router import demo_shard_edges
    from gelly_streaming_tpu_torch.summaries.forest import fold_edges_host

    nv, ne, seed = 512, 3000, 7
    addrs, close = _shard_stack_on(card, nv=nv, ne=ne, seed=seed)
    router = ShardRouter(addrs)
    try:
        src, dst = demo_shard_edges(nv, ne, seed)
        lab = fold_edges_host(np.arange(nv, dtype=np.int32), src, dst)
        sizes = np.bincount(lab, minlength=nv)
        deg = np.bincount(src, minlength=nv) + np.bincount(dst, minlength=nv)
        rng = np.random.default_rng(3)
        us, vs = rng.integers(0, nv, 200), rng.integers(0, nv, 200)
        qs = ([ConnectedQuery(int(u), int(v)) for u, v in zip(us, vs)]
              + [ComponentSizeQuery(int(u)) for u in us[:100]]
              + [DegreeQuery(int(u)) for u in us[:100]])
        got = [a.value for a in router.ask_batch(qs, deadline_s=60, timeout=120)]
        want = ([bool(lab[u] == lab[v]) for u, v in zip(us, vs)]
                + [int(sizes[lab[u]]) for u in us[:100]]
                + [int(deg[u]) for u in us[:100]])
        assert got == want
    finally:
        router.close()
        close()


def test_split_child_on_card_holds_followed_snapshots_there(card, tmp_path):
    from gelly_streaming_tpu_torch.serving import DegreeQuery, ReplicaServer
    from gelly_streaming_tpu_torch.serving.router import shard_demo_payloads

    shared = str(tmp_path / "s1")
    parent = ReplicaServer(shard_demo_payloads(n_vertices=256, n_edges=1200, seed=5,
                                               window=256, shard=1, nshards=2, device=card),
                           None, dirpath=shared, role="primary", lease_s=5.0)
    child = ReplicaServer(dirpath=shared, role="split", device=card)
    parent.start()
    child.start()
    try:
        parent.server.join(30)
        parent.mirror.flush(parent.store)
        # the child follows the mirror version by version: wait for the last
        last = parent.store.latest().version
        assert child.store.wait_for(min_version=last, timeout=30).version == last
        assert child.store.latest().payload["labels"].is_cuda
        assert child.ask(DegreeQuery(3), timeout=30).value == \
            parent.ask(DegreeQuery(3), timeout=30).value
    finally:
        child.close()
        parent.close()


_ROUTER_ALONE = """
import json, sys
import numpy as np
import torch
from gelly_streaming_tpu_torch.serving import ComponentSizeQuery, ConnectedQuery, DegreeQuery, ShardRouter

router = ShardRouter(json.loads(sys.argv[1]))
try:
    qs = [ConnectedQuery(0, v) for v in range(40)] + [ComponentSizeQuery(5), DegreeQuery(9)]
    got = [a.value for a in router.ask_batch(qs, deadline_s=60, timeout=120)]
    stats = router.stats_snapshot()
finally:
    router.close()
print(json.dumps({"answers": [int(v) for v in got], "pulls": stats["pulls"],
                  "cuda_initialized": torch.cuda.is_initialized()}))
"""


def test_a_router_process_never_makes_a_cuda_context(card):
    """A process that imports the port and runs a ``ShardRouter`` alone,
    fan-outs and the merged CC route included, with the card visible to
    it, never initializes CUDA: the router holds no device state."""
    import json
    import os
    import subprocess
    import sys

    addrs, close = _shard_stack_on(card)
    try:
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        out = subprocess.run([sys.executable, "-c", _ROUTER_ALONE, json.dumps(addrs)],
                             capture_output=True, text=True, timeout=300, cwd=root,
                             env=dict(os.environ, PYTHONPATH=root))
        assert out.returncode == 0, out.stderr[-2000:]
        doc = json.loads(out.stdout.strip().splitlines()[-1])
        assert doc["pulls"] >= 2 and len(doc["answers"]) == 42
        assert doc["cuda_initialized"] is False
    finally:
        close()
