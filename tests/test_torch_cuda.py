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
never made a CUDA context, and slice 6 (the mesh): the sharded GraphSAGE
forward over an NCCL world of one equals the forward without a mesh bit
for bit, and (with two cards or more) both kernels launch on the card of
their operands whatever the current device is, and slice 3 (training): the
kernel's gradients on the card equal autograd through its plain version,
a training step launches "tc" twice (four times with remat), and the
training entry points raise without a card, and the k >= 3 spanner's search
kernel (``csrc/k_reach.cu``, one launch a search): equal to its plain
version over a grid of batch widths, vertex counts, hops and live counts,
and at B = 2048, at V = 2^21 (its bitmap read from device memory), with a
hub of in-degree 2^16, and over consecutive searches on one scratch, which
each leaves all zero; equal to the one-launch-a-hop search with no host
sync; launched on its operands' card, refusing a malformed CSR before any
launch, and the k = 3 spanner searching in several batches a window on the
card equal to the CPU without a host sync, and PageRank's fixpoint kernel
(``csrc/pagerank.cu``, one launch a window, pulling over a CSR by
target): against its plain version at config #4's last window, with a hub
of in-degree 2^16 (cut into 64 pieces), with every vertex dangling, at the
cap, with rows of one piece's length and one more, and with in-edges into
padding rows (ranks within 1e-6, iterations within 2); against the first
(push) design on the same operands, and both with no iteration equal to
the warm start; one launch a window, no push launch and no host read
through the entry point; no host sync in the window step; launched on its
operands' card; refused under deterministic algorithms; and superbatch 4
within 1e-6 of superbatch 1, and the sampling estimators' reservoir scan
kernel (``csrc/reservoir_scan.cu``, one launch a draw batch): equal to its
plain version bit for bit for k in {1, 33, 10000}, batches of 1 and 1677
edges, an edge count across 2^24 and an id space above 2^24, at k = 10,000
with almost no coin (m0 = 2^30), at k = 1 over 2^16 edges with a tail of
closing pairs past the second grid barrier, and a whole scan-route run on
the card equal to its CPU replay, one launch a batch.

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
    atomics sum in another order on the card); on the card no host read
    (the fixpoint kernel), one a chunk on the CPU."""
    from gelly_streaming_tpu_torch.library import IncrementalPageRank
    from gelly_streaming_tpu_torch.ops import pagerank_kernels as pk

    src, dst = _zipf(11, 1 << 12, 1 << 15)
    out = {}
    for device in ("cpu", card):
        stream = gt.SimpleEdgeStream((src, dst), window=gt.CountWindow(1 << 13),
                                     vertex_dict=IdentityDict(1 << 12), device=device)
        pr = IncrementalPageRank(superbatch=superbatch)
        pk.HOST_READS = 0
        ems = list(pr.run(stream))
        iters = [int(e.iterations) for e in ems]
        out[str(device)] = (pr._carry[2].cpu().numpy(), iters, pk.HOST_READS)
    (rc, ic, cpu_reads), (rg, ig, reads) = out["cpu"], out[str(card)]
    assert np.abs(rc - rg).max() <= 1e-6 and abs(rg.sum() - 1) <= 1e-5
    assert max(abs(a - b) for a, b in zip(ic, ig)) <= 2
    assert cpu_reads == sum(-(-i // 10) for i in ic)
    assert reads == 0


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


def test_sharded_forward_over_an_nccl_world_of_one_equals_the_plain_forward(card):
    """An NCCL world of one on the card: the edge-sharded forward (the
    all-reduce, then ``fused_sage_matmul``) equals the forward without a
    mesh bit for bit under deterministic algorithms, in bf16 ("tc") and f32
    ("simt"), and launches the kernel twice a window."""
    import torch.distributed as dist

    from gelly_streaming_tpu_torch.parallel import make_mesh

    owned = not dist.is_initialized()
    mesh = make_mesh(1, device=card)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        rng = np.random.default_rng(40)
        src, dst = rng.integers(0, 512, (2, 4096))
        table = TableFeatureSource(rng.normal(size=(512, 16)).astype(np.float32), device=card)
        for dtype, variant in ((torch.bfloat16, "tc"), (torch.float32, "simt")):
            params = params_from_numpy(
                [{k: rng.normal(size=sh).astype(np.float32) for k, sh in
                  (("w_self", (16, 32)), ("w_nbr", (16, 32)), ("b", (32,)))},
                 {k: rng.normal(size=sh).astype(np.float32) for k, sh in
                  (("w_self", (32, 16)), ("w_nbr", (32, 16)), ("b", (16,)))}],
                dtype, device=card)
            outs = []
            for m in (None, mesh):
                stream = gt.SimpleEdgeStream((src, dst), window=gt.CountWindow(1024),
                                             vertex_dict=IdentityDict(512), device=card)
                before = dict(sage_kernels.LAUNCHES_BY_VARIANT)
                outs.append(list(StreamingGraphSAGE(params, 16, mesh=m).run(stream, table)))
                torch.cuda.synchronize()
                assert sage_kernels.LAUNCHES_BY_VARIANT[variant] - before[variant] == 8
            assert len(outs[1]) == 4
            assert all(torch.equal(a, b) for a, b in zip(*outs)), dtype
    finally:
        torch.use_deterministic_algorithms(False)
        if owned:
            dist.destroy_process_group()


def test_kernels_launch_on_the_operands_card(card):
    """The ctypes launchers select the operands' card in the CUDA runtime
    linked into their library (its current device is its own, not
    PyTorch's): with card 0 current, operands on card 1 launch there, and
    the tensor-core kernel's shared-memory attribute holds on each card."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards or more")
    torch.cuda.set_device(0)
    for index in (1, 0, 1):
        dev = torch.device("cuda", index)
        for dtype, variant in ((torch.bfloat16, "tc"), (torch.float32, "simt")):
            ops = [torch.from_numpy(a).to(dev, dtype) for a in _operands(2, 300, 64, 128)]
            before = sage_kernels.LAUNCHES_BY_VARIANT[variant]
            got = fused_sage_matmul(*ops, "relu")
            torch.cuda.synchronize(dev)
            assert sage_kernels.LAUNCHES_BY_VARIANT[variant] == before + 1
            assert got.device == dev
            want = fused_sage_matmul_plain(*ops, "relu")
            tol = 1e-2 if dtype == torch.bfloat16 else 1e-4
            err = (got.float() - want.float()).abs().max().item()
            assert err <= tol * max(want.float().abs().max().item(), 1.0), (index, variant)
    assert torch.cuda.current_device() == 0


@pytest.mark.parametrize("dtype, variant", [("bfloat16", "tc"), ("float32", "simt")])
@pytest.mark.parametrize("activation", ["relu", "none"])
def test_kernel_gradients_on_card_equal_the_plain_versions(card, dtype, variant, activation):
    """Slice 3: ``fused_sage_matmul`` under autograd on the card (the kernel
    forward, the f32 matmul backward) against autograd through
    ``fused_sage_matmul_plain`` on the card. Tolerance of each gradient,
    relative to its largest entry: the kernel's forward differs from the
    plain one by summation order (f32) and one bf16 rounding of the output,
    which a relu mask may flip at an output near 0."""
    dt = getattr(torch, dtype)
    ops = [torch.from_numpy(a).to(card, dt) for a in _operands(5, 300, 64, 128)]
    a = [t.clone().requires_grad_() for t in ops]
    b = [t.clone().requires_grad_() for t in ops]
    before = sage_kernels.LAUNCHES_BY_VARIANT[variant]
    out = fused_sage_matmul(*a, activation)
    assert sage_kernels.LAUNCHES_BY_VARIANT[variant] == before + 1
    g = torch.randn(out.shape, generator=torch.Generator().manual_seed(6)).to(card, dt)
    got = torch.autograd.grad(out, a, g)
    want = torch.autograd.grad(fused_sage_matmul_plain(*b, activation), b, g)
    torch.cuda.synchronize()
    tol = 2e-2 if dtype == "bfloat16" else 1e-4
    for name, x, y in zip(("h", "agg", "w_self", "w_nbr", "b"), got, want):
        assert x.dtype == dt and x.device == y.device == card
        err = (x.float() - y.float()).abs().max().item()
        assert err <= tol * y.float().abs().max().item(), (name, err)


@pytest.mark.parametrize("remat", [False, True])
def test_training_step_launches_the_tensor_core_kernel(card, remat):
    """One bf16 GraphSAGE training step of two layers launches "tc" twice,
    four times with remat (the recomputed forward), and "simt" never; the
    step reads nothing on the host and its loss is a 0-d tensor on the
    card."""
    from gelly_streaming_tpu_torch.models import init_graphsage, make_gnn_train_step, sage_forward

    rng = np.random.default_rng(7)
    params = init_graphsage([64, 128, 32], torch.bfloat16,
                            generator=torch.Generator().manual_seed(0), device=card)
    h = torch.from_numpy(rng.normal(size=(1024, 64)).astype(np.float32)).to(card, torch.bfloat16)
    src, dst = (torch.from_numpy(x.astype(np.int32)).to(card) for x in rng.integers(0, 1024, (2, 8192)))
    mask = torch.ones(8192, dtype=torch.bool, device=card)
    targets = torch.from_numpy(rng.normal(size=(1024, 32)).astype(np.float32)).to(card)
    step, _, _ = make_gnn_train_step(None, sage_forward, lr=0.05, remat=remat)
    before = dict(sage_kernels.LAUNCHES_BY_VARIANT)
    torch.cuda.set_sync_debug_mode("error")
    try:
        new, _, loss = step(params, None, h, src, dst, mask, targets)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    launched = {k: sage_kernels.LAUNCHES_BY_VARIANT[k] - before[k] for k in before}
    assert launched == {"tc": 4 if remat else 2, "simt": 0}
    assert loss.dim() == 0 and loss.device == card and bool(torch.isfinite(loss))
    assert all(v.device == card and v.dtype == torch.bfloat16 for layer in new for v in layer.values())


_NO_CARD = """
import torch
from gelly_streaming_tpu_torch.graft_entry import entry
from gelly_streaming_tpu_torch.models import init_gcn
from gelly_streaming_tpu_torch.resilience.errors import DeviceUnavailable
assert not torch.cuda.is_available()
for call in (entry, lambda: init_gcn([4, 4], generator=torch.Generator().manual_seed(0))):
    try:
        call()
    except DeviceUnavailable:
        continue
    raise SystemExit("no raise")
print("raised")
"""


def test_training_entry_points_without_a_card_raise(card):
    """With the card hidden (``CUDA_VISIBLE_DEVICES=""``), ``entry()`` and
    ``init_gcn`` on their default ``device="cuda"`` raise
    ``DeviceUnavailable``: nothing moves to the CPU unasked."""
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", _NO_CARD], capture_output=True, text=True,
                         timeout=300, cwd=root,
                         env=dict(os.environ, PYTHONPATH=root, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode == 0 and out.stdout.strip().endswith("raised"), out.stderr[-2000:]


# --------------------------------------------------------------------- #
# The k >= 3 spanner's search kernel (csrc/k_reach.cu)
# --------------------------------------------------------------------- #
def _reach_inputs(seed, b, nv, s, cnt, device):
    """A seeded spanner of ``s`` columns among vertices ``0 .. V - 2``
    (self-loops and repeated edges included) with ``cnt`` of them live, and
    ``b`` queries (a fifth masked, some ``u == v``) on ``device``."""
    from gelly_streaming_tpu_torch.ops import reach_kernels as rk

    rng = np.random.default_rng(seed)
    hi = max(nv - 1, 1)
    sp = rng.integers(0, hi, s).astype(np.int32)
    sq = rng.integers(0, hi, s).astype(np.int32)
    sq[: s // 8] = sp[: s // 8]
    sp[s // 8: s // 4], sq[s // 8: s // 4] = sp[s // 4: 3 * s // 8], sq[s // 4: 3 * s // 8]
    u = rng.integers(0, nv, b).astype(np.int32)
    v = np.where(rng.random(b) < 0.1, u, rng.integers(0, nv, b)).astype(np.int32)
    m = rng.random(b) >= 0.2
    t = [torch.from_numpy(a).to(device) for a in (sp, sq, u, v, m)]
    csr = rk.target_csr(t[0], t[1], torch.tensor(cnt, dtype=torch.int32, device=device), nv)
    return csr, t[2], t[3], t[4]


@pytest.mark.parametrize("k", [1, 2, 3, 4])
@pytest.mark.parametrize("nv", [1, 7, 90, 4096])
@pytest.mark.parametrize("b", [32, 96, 1024])
def test_k_reach_kernel_matches_plain_on_card(card, b, nv, k):
    """The kernel's answers equal the plain version's exactly, for W = 1, 3
    and 32 words a vertex, no, some and all columns live; each call
    launches the search kernel once."""
    from gelly_streaming_tpu_torch.ops import reach_kernels as rk

    s = {1: 6, 7: 12, 90: 120, 4096: 6144}[nv]
    for cnt in (0, s // 2 + 1, s):
        csr, u, v, m = _reach_inputs(b + nv + k, b, nv, s, cnt, card)
        before = rk.LAUNCHES
        got = rk.k_reach(csr, u, v, m, nv, k)
        torch.cuda.synchronize(card)
        assert rk.LAUNCHES == before + 1
        want = rk.k_reach_plain(csr, u, v, m, nv, k)
        assert got.device == card and torch.equal(got, want), cnt


def test_k_reach_kernel_launches_on_the_operands_card(card):
    """With card 0 current, a search on card 1's operands launches there."""
    from gelly_streaming_tpu_torch.ops import reach_kernels as rk

    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards or more")
    torch.cuda.set_device(0)
    for index in (1, 0, 1):
        dev = torch.device("cuda", index)
        csr, u, v, m = _reach_inputs(3, 64, 300, 600, 400, dev)
        got = rk.k_reach(csr, u, v, m, 300, 3)
        torch.cuda.synchronize(dev)
        assert got.device == dev
        host = rk.TargetCSR(*(t.cpu() for t in csr))
        assert torch.equal(got.cpu(), rk.k_reach_plain(host, u.cpu(), v.cpu(), m.cpu(), 300, 3))
    assert torch.cuda.current_device() == 0


def test_k_reach_malformed_row_ptr_raises_before_a_launch(card):
    from gelly_streaming_tpu_torch.ops import reach_kernels as rk

    csr, u, v, m = _reach_inputs(4, 32, 50, 80, 80, card)
    before = rk.LAUNCHES
    with pytest.raises(ValueError, match="row_ptr"):
        rk.k_reach(csr._replace(row_ptr=csr.row_ptr[:-1]), u, v, m, 50, 3)
    with pytest.raises(ValueError, match="row_ptr"):
        rk.k_reach(csr, u, v, m, 51, 3)
    assert rk.LAUNCHES == before


def test_multi_batch_k3_spanner_on_card_matches_cpu(card):
    """At a budget of 2^14 bytes over 2^11 vertices (batches of 64) every
    window searches in several batches through the kernel, without a host
    sync, and emits the CPU's edge sets."""
    from gelly_streaming_tpu_torch.library import DeviceSpanner
    from gelly_streaming_tpu_torch.ops import reach_kernels as rk

    src, dst = _zipf(16, 1 << 11, 1 << 14)

    def run(device, strict=False):
        stream = gt.SimpleEdgeStream((src, dst), window=gt.CountWindow(1 << 12),
                                     vertex_dict=IdentityDict(1 << 11), device=device)
        sp = DeviceSpanner(k=3, mem_budget_entries=1 << 14)
        assert sp._batch_cap(1 << 11) == 64
        snaps = _syncs(lambda: list(sp.run(stream))) if strict else list(sp.run(stream))
        return [set(s) for s in snaps]

    want = run("cpu")
    run(card)  # warm
    before = rk.LAUNCHES
    assert run(card, strict=True) == want and len(want) == 4
    assert rk.LAUNCHES - before >= 3 * 2  # windows 1-3, several searches each


def _scratch_is_zero(rk, device, nv, b):
    fronts, bitmaps = rk._scratch(device, nv, b // 32)
    return not bool(fronts.any()) and not bool(bitmaps.any())


def _search_equal(rk, card, csr, u, v, m, nv, k):
    """One search against the plain version and the one-launch-a-hop
    search; one launch, and the scratch left all zero."""
    before = rk.LAUNCHES
    got = rk.k_reach(csr, u, v, m, nv, k)
    torch.cuda.synchronize(card)
    assert rk.LAUNCHES == before + 1
    assert torch.equal(got, rk.k_reach_plain(csr, u, v, m, nv, k)), (nv, k)
    assert torch.equal(got, rk.k_reach_by_hops(csr, u, v, m, nv, k)), (nv, k)
    assert _scratch_is_zero(rk, card, nv, u.shape[0])
    return got


@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_k_reach_kernel_matches_plain_at_2048_queries(card, k):
    """B = 2048: W = 64 words a vertex, two a lane of the target's warp."""
    from gelly_streaming_tpu_torch.ops import reach_kernels as rk

    for cnt in (3000, 6144):
        csr, u, v, m = _reach_inputs(2048 + k, 2048, 4096, 6144, cnt, card)
        _search_equal(rk, card, csr, u, v, m, 4096, k)


def test_k_reach_kernel_reads_the_bitmap_from_device_memory_above_shared_memory(card):
    """At V = 2^21 the changed bitmap (256 KB) does not fit in a block, so
    the search reads it from device memory; at V = 2^18 (32 KB) it is
    staged in shared memory. Both answer as the plain version."""
    from gelly_streaming_tpu_torch.ops import reach_kernels as rk

    assert rk.search_is_staged(1 << 18, card)
    assert not rk.search_is_staged(1 << 21, card)
    lib = rk._library()
    for nv in (1, 4099, 1 << 18, 1 << 21):
        assert lib.k_reach_bitmap_words(nv) == rk.bitmap_words(nv)
    nv = 1 << 21
    for k in (1, 3):
        csr, u, v, m = _reach_inputs(21 + k, 256, nv, 1 << 21, 1 << 21, card)
        _search_equal(rk, card, csr, u, v, m, nv, k)


def test_k_reach_kernel_with_a_hub_of_in_degree_65536(card):
    """One target with 2^16 sources (2,048 loads of 32 for its warp),
    reached from all of them in one hop."""
    from gelly_streaming_tpu_torch.ops import reach_kernels as rk

    rng = np.random.default_rng(16)
    nv, hub = 1 << 17, 0
    sp = np.concatenate([np.arange(1, 1 + (1 << 16)), rng.integers(1, nv, 1 << 16)])
    sq = np.concatenate([np.full(1 << 16, hub), rng.integers(1, nv, 1 << 16)])
    b = 1024
    u = rng.integers(1, nv, b).astype(np.int32)
    v = np.where(rng.random(b) < 0.5, hub, rng.integers(0, nv, b)).astype(np.int32)
    m = rng.random(b) >= 0.2
    t = [torch.from_numpy(a).to(card) for a in (sp.astype(np.int32), sq.astype(np.int32), u, v, m)]
    csr = rk.target_csr(t[0], t[1], torch.tensor(len(sp), dtype=torch.int32, device=card), nv)
    for k in (1, 2, 3):
        got = _search_equal(rk, card, csr, *t[2:], nv, k).cpu().numpy()
        assert got[m & (u <= 1 << 16) & (v == hub)].all()


def test_k_reach_consecutive_searches_share_one_scratch(card):
    """Searches over different CSRs, hop counts (k = 0 too) and queries one
    after another on one scratch, which each leaves all zero; a larger V
    gets new scratch, and the old V's comes back zeroed."""
    from gelly_streaming_tpu_torch.ops import reach_kernels as rk

    b = 1024
    for step, (nv, k) in enumerate([(5000, 3), (5000, 0), (5000, 2), (70000, 3), (5000, 4)]):
        for cnt in (2000, 4000, 7000):
            csr, u, v, m = _reach_inputs(100 + step * 7 + cnt, b, nv, 7000, cnt, card)
            _search_equal(rk, card, csr, u, v, m, nv, k)


def test_k_reach_search_equals_the_hop_search_without_a_host_sync(card):
    """On seeded cases the one-launch search and the one-launch-a-hop
    search, both enqueued under strict sync mode (a host sync raises),
    give the same answers, also equal to the plain version."""
    from gelly_streaming_tpu_torch.ops import reach_kernels as rk

    cases = [(b, nv, k) for b in (32, 96, 1024) for nv in (333, 4099) for k in (1, 3, 4)]
    inputs = [(_reach_inputs(7 * i, b, nv, 3 * nv, 2 * nv, card), nv, k)
              for i, (b, nv, k) in enumerate(cases)]
    torch.cuda.synchronize(card)
    got = []
    torch.cuda.set_sync_debug_mode("error")
    try:
        for (csr, u, v, m), nv, k in inputs:
            got.append((rk.k_reach(csr, u, v, m, nv, k), rk.k_reach_by_hops(csr, u, v, m, nv, k)))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    for ((csr, u, v, m), nv, k), (new, old) in zip(inputs, got):
        assert torch.equal(new, old) and torch.equal(new, rk.k_reach_plain(csr, u, v, m, nv, k))


# --------------------------------------------------------------------- #
# PageRank's fixpoint kernel (csrc/pagerank.cu)
# --------------------------------------------------------------------- #
def _pr_stream(src, dst, nv, window, device):
    return gt.SimpleEdgeStream((src, dst), window=gt.CountWindow(window),
                               vertex_dict=IdentityDict(nv), device=device)


def _last_window_operands(card, nv=1 << 18, ne=1 << 20, window=1 << 18, seed=11):
    """Config #4's last window on the card: the carry's ranks after the
    windows before it, all the edges, the seen vertices."""
    from gelly_streaming_tpu_torch.library import IncrementalPageRank

    src, dst = _zipf(seed, nv, ne)
    pr = IncrementalPageRank(tol=1e-6, max_iter=50)
    for _ in pr.run(_pr_stream(src[:ne - window], dst[:ne - window], nv, window, card)):
        pass
    n_seen = 1 + int(max(src.max(), dst.max()))
    return (torch.from_numpy(src).to(card), torch.from_numpy(dst).to(card), pr._carry[2],
            n_seen)


def _ranks_close(r, p):
    """Each rank within 1e-4 of the plain one relative to itself, plus
    1e-10 (float atomics reorder the sums; a hub of in-degree 2^16 moves by
    about 6e-6 of itself)."""
    return bool(((r - p).abs() <= 1e-4 * p.abs() + 1e-10).all())


def _fixpoint_equal(card, src, dst, ranks, n_seen, tol=1e-6, chunk=10, max_chunks=5, rtol=0.0,
                    reference=torch.float32):
    """One kernel launch against the plain version on the same card
    tensors (run in ``reference``, float32 or float64): ranks within 1e-6
    (plus ``rtol`` of the plain rank, for a vertex whose rank sums many
    float32 terms) and each within 1e-4 of itself (plus 1e-10: at 2^18
    vertices a rank is about 1e-6, as small as the absolute bound), the
    ranks' sum within 1e-5 of the plain ranks' (float32 rounding at a hub
    loses mass, so neither need sum to 1), iterations within 2, the input
    ranks unchanged."""
    from gelly_streaming_tpu_torch.ops import pagerank_kernels as pk

    held = ranks.clone()
    before = pk.LAUNCHES
    r, delta, it = pk.fixpoint(src, dst, ranks, n_seen, 0.85, tol, chunk, max_chunks)
    torch.cuda.synchronize(card)
    assert pk.LAUNCHES == before + 1
    pr, pdelta, pit = pk.fixpoint_plain(src, dst, ranks.to(reference), n_seen, 0.85, tol, chunk,
                                        max_chunks)
    assert r.device == card and delta.device == card and it.device == card
    assert r.dtype == torch.float32 and delta.dtype == torch.float32 and it.dtype == torch.int32
    assert torch.equal(ranks, held) and r.data_ptr() != ranks.data_ptr()
    err = float(((r - pr).abs() - rtol * pr.abs()).max()) if r.numel() else 0.0
    assert err <= 1e-6, err
    assert _ranks_close(r, pr), float(((r - pr).abs() / pr.abs().clamp(min=1e-30)).max())
    assert abs(float(r.double().sum()) - float(pr.double().sum())) <= 1e-5
    assert abs(int(it) - int(pit)) <= 2, (int(it), int(pit))
    if int(it) < chunk * max_chunks:
        assert float(delta) <= tol
    return r, delta, it


def test_pagerank_kernel_matches_plain_at_config_4s_last_window(card):
    from gelly_streaming_tpu_torch.ops import pagerank_kernels as pk

    assert pk._library().slot_floats == pk._library().pagerank_slot_floats() == 8
    src, dst, ranks, n_seen = _last_window_operands(card)
    r, _, it = _fixpoint_equal(card, src, dst, ranks, n_seen)
    assert 1 <= int(it) <= 50 and abs(float(r.double().sum()) - 1) <= 1e-5


def test_pagerank_kernel_with_a_hub_of_in_degree_65536(card):
    """Vertex 0 receives 2^16 edges: 64 pieces of 1024, each summed by a
    warp, the last to arrive adding the partials in piece order. The plain
    version is the reference here in float64: in float32 its one-by-one
    adds into the hub's sum of about 0.25 round at the hub's ulp, and 2^16
    such adds of near-equal terms drift by about 4e-4 of the rank (the L1
    change then stalls near 3e-4 and runs to the cap), while the kernel's
    sums of 32 terms a lane, a warp's tree and 64 partials stay within the
    1e-6 bound of float64 and converge when it does."""
    rng = np.random.default_rng(17)
    nv = 1 << 17
    src = np.concatenate([np.arange(1, 1 + (1 << 16)), rng.integers(0, nv, 1 << 16)])
    dst = np.concatenate([np.zeros(1 << 16, np.int64), rng.integers(0, nv, 1 << 16)])
    ranks = torch.zeros(nv, device=card)
    t = [torch.from_numpy(a.astype(np.int32)).to(card) for a in (src, dst)]
    for tol in (1e-4, 1e-6):
        r, _, _ = _fixpoint_equal(card, *t, ranks, nv, tol=tol, reference=torch.float64)
        assert int(r.argmax()) == 0


def test_pagerank_kernel_with_every_vertex_dangling(card):
    """No edges: every seen vertex dangles, ranks stay uniform over the
    seen ones, the rest 0; also with every slot seen."""
    empty = torch.zeros(0, dtype=torch.int32, device=card)
    nv = 1000
    for n_seen in (600, nv):
        r, _, it = _fixpoint_equal(card, empty, empty, torch.zeros(nv, device=card), n_seen)
        want = torch.zeros(nv, device=card)
        want[:n_seen] = 1.0 / n_seen
        assert float((r - want).abs().max()) <= 1e-7 and int(it) == 1


def test_pagerank_kernel_reaches_the_cap(card):
    """tol 0: chunk * max_chunks iterations, as the plain version."""
    src, dst = _zipf(12, 1 << 12, 1 << 15)
    t = [torch.from_numpy(a).to(card) for a in (src, dst)]
    _, _, it = _fixpoint_equal(card, *t, torch.zeros(1 << 12, device=card), 1 << 12, tol=0.0,
                               chunk=4, max_chunks=3)
    assert int(it) == 12


# csrc/pagerank.cu's split: rows of more than ROW_THREAD entries are cut
# into pieces of at most PIECE
PR_ROW_THREAD, PR_PIECE = 32, 1024


def test_pagerank_kernel_with_rows_of_a_piece_and_one_more(card):
    """Rows of 32 and 33 entries (a thread's, a warp's), of 1024 (one
    piece), 1025 (two) and 3073 (four) beside random edges, all seen; then
    the same with the long rows past ``n_seen``, whose ranks stay 0."""
    rng = np.random.default_rng(23)
    nv = 1 << 14
    lens = {5: PR_ROW_THREAD, 6: PR_ROW_THREAD + 1, 7: PR_PIECE, 8: PR_PIECE + 1,
            9: 3 * PR_PIECE + 1}
    src = np.concatenate([rng.integers(0, nv, sum(lens.values())), rng.integers(0, nv, 1 << 16)])
    dst = np.concatenate([np.repeat(list(lens), list(lens.values())),
                          rng.integers(16, nv, 1 << 16)])
    order = rng.permutation(len(src))
    t = [torch.from_numpy(a[order].astype(np.int32)).to(card) for a in (src, dst)]
    for tol in (1e-4, 1e-6):
        _fixpoint_equal(card, *t, torch.zeros(nv, device=card), nv, tol=tol)
    # the same long rows into padding slots (past n_seen): no pieces, ranks 0
    pad = dst.copy()
    pad[:sum(lens.values())] += nv
    t = [torch.from_numpy(a[order].astype(np.int32)).to(card) for a in (src, pad)]
    r, _, _ = _fixpoint_equal(card, *t, torch.zeros(nv + 16, device=card), nv)
    assert float(r[nv:].abs().max()) == 0.0


def test_pagerank_pull_matches_the_push_design(card):
    """The library's kernel (the pull) and the first design (the push,
    reached only through its private entry) on config #4's last window:
    ranks within 1e-6 and 1e-4 of each other relative to the push's,
    iterations within 2; each design counted in its own counter; and with no
    iteration both return the warm start."""
    from gelly_streaming_tpu_torch.ops import pagerank_kernels as pk

    src, dst, ranks, n_seen = _last_window_operands(card)
    launches, push = pk.LAUNCHES, pk.PUSH_LAUNCHES
    r, _, it = pk._fixpoint_kernel(src, dst, ranks, n_seen, 0.85, 1e-6, 50)
    q, _, qit = pk._fixpoint_push(src, dst, ranks, n_seen, 0.85, 1e-6, 50)
    torch.cuda.synchronize(card)
    assert pk.LAUNCHES == launches + 1 and pk.PUSH_LAUNCHES == push + 1
    assert float((r - q).abs().max()) <= 1e-6 and _ranks_close(r, q)
    assert abs(int(it) - int(qit)) <= 2
    active = torch.arange(ranks.shape[0], device=card) < n_seen
    warm = torch.where(active & (ranks == 0), 1.0 / torch.tensor(float(n_seen), device=card),
                       ranks)
    warm = warm / warm.sum()
    for run in (pk._fixpoint_kernel, pk._fixpoint_push):
        w, delta, it0 = run(src, dst, ranks, n_seen, 0.85, 1e-6, 0)
        assert int(it0) == 0 and float(delta) == float("inf")
        assert _ranks_close(w, warm) and float((w - warm).abs().max()) <= 1e-9


def test_pagerank_makes_one_launch_a_window_and_no_host_read(card):
    from gelly_streaming_tpu_torch.library import IncrementalPageRank
    from gelly_streaming_tpu_torch.ops import pagerank_kernels as pk

    src, dst = _zipf(13, 1 << 12, 1 << 15)
    for superbatch in (1, 4):
        pk.LAUNCHES = pk.HOST_READS = pk.PUSH_LAUNCHES = 0
        ems = list(IncrementalPageRank(superbatch=superbatch).run(
            _pr_stream(src, dst, 1 << 12, 1 << 12, card)))
        assert len(ems) == 8 and pk.LAUNCHES == 8 and pk.HOST_READS == 0
        assert pk.PUSH_LAUNCHES == 0


def test_pagerank_window_step_makes_no_host_sync(card):
    """The window step (the appends and the one launch) under
    ``set_sync_debug_mode("error")``; its scalars read afterwards."""
    from gelly_streaming_tpu_torch.library import pagerank as tpr

    src, dst = _zipf(14, 1 << 12, 1 << 14)
    nv, cap = 1 << 12, 1 << 13
    carry = (torch.zeros(1 << 14, dtype=torch.int32, device=card),
             torch.zeros(1 << 14, dtype=torch.int32, device=card),
             torch.zeros(nv, device=card))
    blocks = [(torch.from_numpy(src[i:i + cap]).to(card), torch.from_numpy(dst[i:i + cap]).to(card))
              for i in (0, cap)]
    n_seen = 1 + int(max(src.max(), dst.max()))
    torch.cuda.synchronize(card)
    out = []

    def steps():
        nonlocal carry
        for w, (bs, bd) in enumerate(blocks):
            carry, delta, iters = tpr._window_step(carry, bs, bd, w * cap, cap, n_seen, 0.85,
                                                   1e-6, 10, 5)
            out.append((delta, iters))

    _syncs(steps)
    assert all(1 <= int(it) <= 50 for _, it in out)
    assert abs(float(carry[2].sum()) - 1) <= 1e-5


def test_pagerank_kernel_launches_on_the_operands_card(card):
    """With card 0 current, a fixpoint on card 1's operands launches there."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards or more")
    src, dst = _zipf(15, 1 << 10, 1 << 13)
    torch.cuda.set_device(0)
    for index in (1, 0, 1):
        dev = torch.device("cuda", index)
        t = [torch.from_numpy(a).to(dev) for a in (src, dst)]
        r, _, _ = _fixpoint_equal(dev, *t, torch.zeros(1 << 10, device=dev), 1 << 10)
        assert r.device == dev
    assert torch.cuda.current_device() == 0


def test_pagerank_kernel_refuses_deterministic_algorithms(card):
    from gelly_streaming_tpu_torch.ops import pagerank_kernels as pk

    src, dst = (torch.from_numpy(a).to(card) for a in _zipf(16, 1 << 10, 1 << 12))
    ranks = torch.zeros(1 << 10, device=card)
    before = pk.LAUNCHES
    torch.use_deterministic_algorithms(True)
    try:
        with pytest.raises(RuntimeError, match="deterministic"):
            pk.fixpoint(src, dst, ranks, 1 << 10, 0.85, 1e-6, 10, 5)
    finally:
        torch.use_deterministic_algorithms(False)
    assert pk.LAUNCHES == before


def test_pagerank_superbatch_4_within_1e6_of_1_on_card(card):
    from gelly_streaming_tpu_torch.library import IncrementalPageRank

    src, dst = _zipf(18, 1 << 14, 1 << 17)
    got = {}
    for k in (1, 4):
        pr = IncrementalPageRank(superbatch=k)
        ems = list(pr.run(_pr_stream(src, dst, 1 << 14, 1 << 14, card)))
        got[k] = (pr._carry[2], [int(e.iterations) for e in ems])
    assert float((got[1][0] - got[4][0]).abs().max()) <= 1e-6
    assert max(abs(a - b) for a, b in zip(got[1][1], got[4][1])) <= 2


def _scan_operands(card, k, n, m0, v, seed, low=0.25):
    """A batch for the reservoir scan: ``n`` edges among 12 ids (self-loops
    and a repeated edge included; for ``v`` above 2^24 some ids at its top),
    a carried state, and uniforms with a share ``low`` of the coins one ulp
    below their threshold (so coins come up at any ``m0``)."""
    from gelly_streaming_tpu_torch.library import sampling

    rng = np.random.default_rng(seed)
    s = rng.integers(0, 12, n)
    d = rng.integers(0, 12, n)
    d[::5] = s[::5]
    s[1::7], d[1::7] = s[0], d[0]
    if v > 1 << 24:
        s[2::4] = v - 1 - rng.integers(0, 3, len(s[2::4]))
    thr = (np.float32(1.0) / np.arange(m0 + 1, m0 + n + 1).astype(np.float32))[:, None]
    coin = rng.random((n, k), dtype=np.float32)
    low = rng.random((n, k)) < low
    coin[low] = np.broadcast_to(np.nextafter(thr, np.float32(0)), (n, k))[low]
    third = rng.random((n, k), dtype=np.float32)
    st = {f: x.to(card) for f, x in sampling.init_sampler_state(k, "cpu").items()}
    st["src"][::2] = 0
    st["trg"][::2] = 1
    st["third"][::2] = 2
    return (st, m0, torch.from_numpy(s.astype(np.int32)).to(card),
            torch.from_numpy(d.astype(np.int32)).to(card), v,
            torch.from_numpy(coin).to(card), torch.from_numpy(third).to(card))


@pytest.mark.parametrize("v, m0", [(1 << 16, 0), ((1 << 24) + 3, (1 << 24) - 800)])
@pytest.mark.parametrize("n", [1, 1677])
@pytest.mark.parametrize("k", [1, 33, 10_000])
def test_reservoir_scan_kernel_matches_plain_on_card(card, k, n, v, m0):
    """The kernel against its plain version on the card, fed the same
    uniforms: every column equal bit for bit, the inputs unchanged."""
    from gelly_streaming_tpu_torch.ops import sampling_kernels as sk

    args = _scan_operands(card, k, n, m0, v, seed=k + n)
    held = {f: x.clone() for f, x in args[0].items()}
    before = sk.LAUNCHES
    got, m = sk.reservoir_scan(*args)
    assert sk.LAUNCHES == before + 1 and m == m0 + n
    want, m_plain = sk.reservoir_scan_plain(*args)
    torch.cuda.synchronize()
    assert m_plain == m
    for f in held:
        assert torch.equal(args[0][f], held[f]), f
        assert got[f].dtype == held[f].dtype and torch.equal(got[f], want[f]), f
    if n > 1:
        assert bool((got["src"] != held["src"]).any())


def test_reservoir_scan_kernel_without_coins_on_card(card):
    """k = 10,000 at m0 = 2^30, uniforms as drawn: almost no coin comes up,
    so the fields stay and the carried pairs (0, 2) and (1, 2) of the even
    samples set their flags; equal to the plain version bit for bit."""
    from gelly_streaming_tpu_torch.ops import sampling_kernels as sk

    args = _scan_operands(card, 10_000, 1677, 1 << 30, 1 << 16, seed=43, low=0.0)
    held = {f: x.clone() for f, x in args[0].items()}
    got, _ = sk.reservoir_scan(*args)
    want, _ = sk.reservoir_scan_plain(*args)
    torch.cuda.synchronize()
    for f in held:
        assert torch.equal(got[f], want[f]), f
    kept = (got["src"] == held["src"]) & (got["trg"] == held["trg"]) & (
        got["third"] == held["third"])
    assert int((~kept).sum()) <= 2
    assert bool(got["src_found"][::2][kept[::2]].all())
    assert not bool(got["src_found"][1::2][kept[1::2]].any())


def _third_np(a, b, ut, v):
    """The third vertex of edge ``(a, b)`` from the float32 draw ``ut``."""
    u1, u2 = min(a, b), max(a, b)
    nv = v - 1 - (u1 != u2)
    c = min(int(np.float32(ut) * np.float32(nv)), nv - 1)
    c += c >= u1
    c += (u1 != u2) and c >= u2
    return c


def test_reservoir_scan_kernel_long_tail_on_card(card):
    """k = 1 at 2^16 edges (the estimators' batch at small k): the last
    replacement at edge 100, its closing pair with trg at edge 2000 (inside
    the tail's first chunk of 4096) and with src at the batch's end (a
    later chunk, past the second grid barrier). The plain version runs on
    the CPU copy: 2^16 edges of it on the card take half a minute."""
    from gelly_streaming_tpu_torch.library import sampling
    from gelly_streaming_tpu_torch.ops import sampling_kernels as sk

    k, n, v, last = 1, 1 << 16, 1 << 16, 100
    rng = np.random.default_rng(47)
    s = rng.integers(0, 12, n).astype(np.int32)
    d = rng.integers(0, 12, n).astype(np.int32)
    thr = (np.float32(1.0) / np.arange(1, n + 1).astype(np.float32))[:, None]
    coin = rng.random((n, k), dtype=np.float32)
    coin[last + 1:] = np.nextafter(thr[last + 1:], np.float32(1))
    coin[last] = np.nextafter(thr[last], np.float32(0))
    third = rng.random((n, k), dtype=np.float32)
    c = _third_np(int(s[last]), int(d[last]), third[last, 0], v)
    s[2000], d[2000] = c, d[last]
    s[n - 3], d[n - 3] = s[last], c
    cpu = (sampling.init_sampler_state(k, "cpu"), 0, torch.from_numpy(s), torch.from_numpy(d),
           v, torch.from_numpy(coin), torch.from_numpy(third))
    args = ({f: x.to(card) for f, x in cpu[0].items()}, 0,
            *(t.to(card) if torch.is_tensor(t) else t for t in cpu[2:]))
    before = sk.LAUNCHES
    got, m = sk.reservoir_scan(*args)
    assert sk.LAUNCHES == before + 1 and m == n
    want, _ = sk.reservoir_scan_plain(*cpu)
    for f in want:
        assert torch.equal(got[f].cpu(), want[f]), f
    assert int(got["src"][0]) == s[last] and int(got["third"][0]) == c
    assert bool(got["src_found"][0]) and bool(got["trg_found"][0])


def test_broadcast_triangle_count_scan_route_on_card_matches_cpu(card, monkeypatch):
    """A whole run over an id space above the vectorized limit on the card
    (the kernel, one launch a draw batch) equals its replay on the CPU fed
    the same uniforms: every window's state and every emission."""
    from gelly_streaming_tpu_torch.library import sampling
    from gelly_streaming_tpu_torch.ops import sampling_kernels as sk

    k = 1000
    monkeypatch.setattr(sampling, "_SCAN_DRAW_ELEMS", 300 * k)  # 300 edges a batch
    rng = np.random.default_rng(31)
    edges = [(int(a), int(b), 0.0) for a, b in rng.integers(0, 24, (1400, 2))]

    class Recording(sampling.BroadcastTriangleCount):
        def __init__(self, device, replay=None):
            super().__init__(vertex_count=60_000, samples=k, window=gt.CountWindow(512),
                             seed=5, device=device)
            self.drawn = [] if replay is None else list(replay)
            self.replay = replay is not None
            self.states = []

        def _draw(self, *shape):
            if self.replay:
                return self.drawn.pop(0)
            u = super()._draw(*shape)
            self.drawn.append(u.cpu())
            return u

        def _window(self, block, vdict):
            n = super()._window(block, vdict)
            self.states.append({f: x.cpu() for f, x in self._state.items()})
            return n

    before = sk.LAUNCHES
    on_card = Recording(card)
    got = list(on_card.run(edges))
    launches = sk.LAUNCHES - before
    on_cpu = Recording("cpu", replay=on_card.drawn)
    want = list(on_cpu.run(edges))
    assert launches == 2 + 2 + 2  # windows of 512, 512 and 376 edges in batches of 300
    assert got == want and len(on_card.states) == 3
    for a, b in zip(on_card.states, on_cpu.states):
        for f in a:
            assert torch.equal(a[f], b[f]), f
    assert on_card._edge_count == 1400
