#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (gelly_streaming_tpu_torch) on one
NVIDIA card: build every kernel, hold each against its plain PyTorch
version, drive streaming GraphSAGE, streaming Connected Components, the
degree stream, window triangles, the neighborhood aggregations,
incremental PageRank, bipartiteness, exact triangles, the device
spanner, the device vertex dictionary, the sampling triangle estimators
and iterative CC end to end, and print the results.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. device  — a CUDA card must be present; prints its name and power limit
   as ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``.
2. build   — compiles ``gelly_streaming_tpu_torch/csrc/*.cu`` with nvcc for
   sm_90a (one nvcc per source, started together), prints ptxas's register
   and spill report, and counts the ``HGMMA`` (wgmma) and ``UTMALDG`` (TMA
   load) instructions of the tensor-core kernel in ``cuobjdump -sass``;
   either count at 0 fails ("not checked" where there is no cuobjdump).
3. kernels — ``fused_sage_matmul`` against ``fused_sage_matmul_plain`` on the
   card, each call asserting which kernel it launched: the two layer shapes
   of BASELINE config #5 (bf16 takes "tc", f32 "simt"); the ragged "tc"
   shapes V in {1, 100, 257, 65537} x (F, O) in {(48, 72), (136, 264)};
   the "simt" shapes of the first slice, f32 and bf16 views whose address
   is 2 bytes off 16-byte alignment; relu and none. Then, at the config #5
   shapes in bf16, the times of the kernel, its plain version, the library
   (cuBLAS ``addmm`` on pre-concatenated operands, timed here only) and the
   "simt" kernel, each launch timed alone with a cold L2 (see ``cold_ms``),
   beside the bound; and the warm loop of the first slice on a labelled
   line of its own.
4. slice   — config #5 streaming GraphSAGE through the port's entry points:
   ``SimpleEdgeStream`` with ``CountWindow(1 << 18)`` over
   ``IdentityDict(1 << 16)`` into ``StreamingGraphSAGE`` with a
   ``TableFeatureSource``, dims [128, 256, 128] in bf16, 4 windows (the
   edge accumulator crosses 2^18 -> 2^19 -> 2^20). The counts are set to 0
   just before: the run must launch "tc" exactly twice per window and
   "simt" never; the last window's embeddings are held against a reference
   composed on the card from the plain functions; then edges/s, ms per
   window and where the time goes.
5. cc      — streaming Connected Components, the headline cell of
   ``bench.py:bench_cc_e2e``: the ``livejournal`` surrogate (R-MAT scale 21,
   2^24 edges, made here by the port's ``ensure_corpus`` and cached under the
   temporary directory) through ``datasets.stream_file`` with
   ``CountWindow(1 << 20)``, ``IdentityDict(1 << 21)`` and
   ``prefetch_depth=2`` into ``ConnectedComponents()`` (carry "auto", which
   must pick "forest"), ``sync()`` inside the timed region. The native
   library must have loaded. One warm pass, then the median of 3 steady
   passes: edges/s, p50/p95 window latency, host reads per window. The last
   window's labels are held exactly against ``scipy``'s connected
   components of the same edges regenerated here from the R-MAT seeds (no
   parsing); the first 4 windows' labels of the host and dense carries and
   of the forest carry with ``superbatch=4`` must equal the forest carry's.
   Then one profiled pass: the top operations by device time, the busy
   share, the peak device memory, and the device time and launches of each
   CC step (``cc.*`` spans as ``record_function`` ranges).
6. degrees — BASELINE config #1, ``bench.py:bench_degrees_e2e``: phase 5's
   corpus through its binary cache (``datasets.binary_cache``, as
   ``bench.py`` builds it) into ``datasets.stream_file`` with
   ``CountWindow(1 << 20)``, ``IdentityDict(1 << 21)``,
   ``prefetch_depth=2``, then ``get_degrees().batches()`` drained. One warm
   pass, then the median of 3 steady passes: edges/s and ms per window.
   One more pass under ``torch.cuda.set_sync_debug_mode("warn")`` counts
   the host syncs inside the window loop (expected 0) and after it (the
   stream's one wait). The degrees after the 16 windows must equal
   ``np.bincount`` of the regenerated R-MAT edges, and the last window's
   emitted ids and degrees the numpy oracle, exactly. Then a
   ``DegreeDistribution`` run of 2^20 seeded +/- events on the card must
   equal the same run on the CPU, window by window.
7. triangles — BASELINE config #3, ``bench.py:bench_window_triangles_e2e``:
   ``make_stream(1 << 17, 2 << 20, seed=9)`` through ``SimpleEdgeStream``
   (``CountWindow(1 << 20)``, ``IdentityDict(1 << 17)``) into
   ``WindowTriangles(CountWindow(1 << 20)).run_stream``, the counts left on
   the card until the pass ends. The same timing and sync count as phase 6;
   each window's count must equal scipy's ``(A @ A).multiply(A).sum()`` on
   the degree-oriented, deduplicated adjacency, and window 0's per-vertex
   counts the port's on the CPU.
8. neighborhood — window 0 of the config #3 stream with seeded float edge
   values, ``slice(direction=ALL)``: ``reduce_on_edges("sum")``, an
   associative callable, ``fold_neighbors`` (lockstep turns printed),
   ``apply_on_neighbors`` and ``flat_apply_on_neighbors``, each timed on
   the card (emission included) and held against the port on the CPU
   (floats within ``NBR_TOL``).
   Phases 6 and 7 end with a profile of one pass each, the device steps
   opened as ``record_function`` ranges: the top operations by device
   time, the busy share, device-to-host copies, peak memory, and each
   step's device ms, launches and byte bound per window (phases 9-12 end
   the same way).
9. pagerank — BASELINE config #4, ``bench.py:bench_pagerank``:
   ``make_stream(1 << 18, 1 << 20, seed=11)`` in ``CountWindow(1 << 18)``
   over ``IdentityDict(1 << 18)`` into ``IncrementalPageRank(tol=1e-6,
   max_iter=50)``, ``sync()`` inside the timed region; one warm pass, the
   median of 3: edges/s, ms and iterations a window, host reads a window.
   The final ranks must be within 1e-5 of a float64 scipy run of the
   reference's procedure and every window's iterations within 2 of its;
   ``superbatch=4`` within 1e-6 of ``superbatch=1``. Then a scale pass on
   phase 6's binary cache (16 windows of 2^20 over 2^21 ids) against the
   same oracle.
10. bipartiteness — ``bench.py:bench_bipartiteness_e2e``: the binary cache
   through ``stream_file`` into ``BipartitenessCheck()`` (carry "auto" must
   pick "forest"), timed like phase 9; the verdicts after window 0 and the
   last window equal to scipy's components of the 2V-node double cover;
   the same edges mapped to ``(u & ~1, v | 1)`` must be bipartite, window
   0's coloring proper; on 4 windows of both streams the host and dense
   carries and ``superbatch=4`` equal to the forest carry.
11. exact triangles — ``bench.py:bench_exact_triangles``:
   ``make_stream(1 << 17, 1 << 20, seed=15)`` in ``CountWindow(1 << 18)``,
   the batches unread until the pass ends; edges/s, host syncs in the loop
   (0 expected); after every window the running total and per-vertex
   counts equal to scipy's ``(A @ A).multiply(A)`` on the prefix graph.
12. spanner — ``bench.py:bench_spanner``: ``make_stream(1 << 18, 1 << 20,
   seed=17)``, k = 2, ``DeviceSpanner(expected_edges=1 << 20)``; edges/s,
   host syncs in the loop (0); the edge set equal to the port's on the CPU
   and every dropped edge within 2 spanner hops (sparse products); then
   k = 3 on the 2^18-edge prefix and on 2^16 edges over 2^12 vertices in
   4 windows, each equal to the CPU's.
13. device-encode — the CC cell with vertex compaction on the card
   (``bench.py:bench_cc_e2e_device`` and ``bench_cc_e2e_device_text``):
   phase 6's binary cache with ``device_encode=True, min_vertex_capacity=
   1 << 21`` (the declared id bound), and the text corpus with
   ``device_encode=True, dense_ids=False`` and a ``1 << 10`` hint (the table
   grows by re-padding from host novelty tracking), each in
   ``CountWindow(1 << 20)`` with ``prefetch_depth=2`` into
   ``ConnectedComponents()``, ``sync()`` timed. Device-encoded blocks carry
   no host columns, so the carry is the dense one (as in the reference).
   One warm pass, the median of 3: edges/s, p50/p95, the CC fold's host
   reads a window. The last window's partition, decoded to raw ids, must
   equal scipy's; window 0's compact ids the host ``VertexDict``'s; the
   ingest's window loop (parse, upload, encode) makes 0 host syncs; the
   ``probe`` ends non-negative and equal to the ids seen. A profiled pass
   (no prefetch, so the encode's ranges are in the trace) gives the busy
   share and ``dict.encode``'s device ms and launches a window against
   ``dict_encode_bytes``. Then the corpus's first 2 windows mapped to
   sparse int32 ids (an injective affine map mod 2^31 - 1) must encode as
   the host dict does.
14. sampling — ``make_stream(1 << 15, 1 << 22, seed=19)`` made
   duplicate-free and loop-free, in windows of 2^20 over ``vertex_count =
   1 << 15`` (the vectorized form). k is the least power of two at which
   the expected ``beta_sum``, ``k T / (m (V - 2))`` for scipy's exact
   triangle count T, is at least 100; the final estimate must lie within 4
   binomial standard errors of T; every window's state must equal the
   port's on the CPU fed the same uniforms, and the incidence estimator's
   output the broadcast one's. The scan form on 2^12 edges over 2^16
   vertices against the CPU the same way, with its ms per edge. Edges/s,
   ms a window, busy share, ``sampling.window`` device ms and launches.
15. iterative cc — the first 4 windows (2^18 edges each) of
   ``make_stream(1 << 18, 1 << 20, seed=21)`` through ``IdentityDict`` (the
   incremental host path) and through ``device_encode`` (the diff path on
   the card): after each window the labels accumulated from the emissions
   must equal scipy's least raw id of each component, and the two paths
   each other; ms a window of each, and a profile of each (``icc.*``
   ranges).
16. a ``{"kernels": [...]}`` line, and last the ``{"ok": true, ...}`` line.

TF32 is off for float32 matmuls (``torch.backends.cuda.matmul.allow_tf32 =
False``), so the plain version's f32 products are full f32.
"""

import functools
import json
import os
import shutil
import statistics
import subprocess
import time
import warnings

import numpy as np

# BASELINE config #5 (bench.py: bench_graphsage_e2e)
N_VERTICES = 1 << 16
WINDOW = 1 << 18
N_WINDOWS = 4
DIMS = [128, 256, 128]
STREAM_SEED = 13

# streaming CC, the headline cell (bench.py: CORPUS, WINDOW, ID_BOUND)
CC_CORPUS = "livejournal"
CC_WINDOW = 1 << 20
CC_ID_BOUND = 1 << 21
CC_PREFIX_WINDOWS = 4
CC_STEADY_PASSES = 3

# BASELINE config #4 (bench.py: bench_pagerank): 4 windows of 2^18
PR_VERTICES = 1 << 18
PR_EDGES = 1 << 20
PR_WINDOW = 1 << 18
PR_SEED = 11
PR_TOL = 1e-6
PR_MAX_ITER = 50
# final ranks against the float64 oracle (tests/test_pagerank_sage.py:47),
# iterations within 2 of it (the L1 change at tol 1e-6 is near the
# float32 noise floor), superbatch 4 against 1 (float atomics)
PR_RANK_TOL = 1e-5
PR_ITER_SLACK = 2
PR_K4_TOL = 1e-6
PR_STEPS = ("pagerank.window", "pagerank.fixpoint")

# bipartiteness (bench.py: bench_bipartiteness_e2e) on phase 5's corpus
BIP_STEPS = ("bip.cover_step", "cc.chase_and_group", "cc.propagate", "cc.commit_roots",
             "cc.window_prep", "cc.window_upload")

# exact triangles (bench.py: bench_exact_triangles): 4 windows of 2^18
ETC_VERTICES = 1 << 17
ETC_EDGES = 1 << 20
ETC_WINDOW = 1 << 18
ETC_SEED = 15
ETC_STEPS = ("tri.packed_prep", "tri.packed_count", "tri.merge_packed")

# the device spanner (bench.py: bench_spanner): k = 2, 4 windows of 2^18;
# k = 3 also on 2^16 edges over 2^12 vertices in 4 windows
SP_VERTICES = 1 << 18
SP_EDGES = 1 << 20
SP_WINDOW = 1 << 18
SP_SEED = 17
SP3_EDGES = 1 << 16
SP3_VERTICES = 1 << 12
SP_STEPS = ("spanner.k2", "spanner.k2_merge")
SP3_STEPS = ("spanner.k_reach", "spanner.append")
CC_STEPS = ("cc.window_prep", "cc.window_upload", "cc.chase_and_group", "cc.propagate",
            "cc.commit_roots", "cc.commit", "cc.forest_superbatch", "cc.resolve_flat",
            "cc.mirror_update", "engine.sync")

# BASELINE config #1 (bench.py: bench_degrees_e2e) on phase 5's corpus
DEG_STEPS = ("degree.update", "segment.count")
# a DegreeDistribution run held between the card and the CPU
DD_EVENTS = 1 << 20
DD_VERTICES = 1 << 14
DD_WINDOW = 1 << 16
DD_SEED = 5

# BASELINE config #3 (bench.py: bench_window_triangles_e2e)
TRI_VERTICES = 1 << 17
TRI_WINDOW = 1 << 20
TRI_WINDOWS = 2
TRI_SEED = 9
TRI_STEPS = ("tri.oriented_rows", "tri.membership", "csr.build", "segment.sort",
             "segment.count", "tri.plan", "window.rewindow", "window.pack")
STEADY_PASSES = 3

# BASELINE config #4 (bench.py: bench_pagerank): 4 windows of 2^18
PR_VERTICES = 1 << 18
PR_EDGES = 1 << 20
PR_WINDOW = 1 << 18
PR_SEED = 11
PR_TOL = 1e-6
PR_MAX_ITER = 50
# final ranks against the float64 oracle (tests/test_pagerank_sage.py:47),
# iterations within 2 of it (the L1 change at tol 1e-6 is near the
# float32 noise floor), superbatch 4 against 1 (float atomics)
PR_RANK_TOL = 1e-5
PR_ITER_SLACK = 2
PR_K4_TOL = 1e-6
PR_STEPS = ("pagerank.window", "pagerank.fixpoint")

# bipartiteness (bench.py: bench_bipartiteness_e2e) on phase 5's corpus
BIP_STEPS = ("bip.cover_step", "cc.chase_and_group", "cc.propagate", "cc.commit_roots",
             "cc.window_prep", "cc.window_upload")

# exact triangles (bench.py: bench_exact_triangles): 4 windows of 2^18
ETC_VERTICES = 1 << 17
ETC_EDGES = 1 << 20
ETC_WINDOW = 1 << 18
ETC_SEED = 15
ETC_STEPS = ("tri.packed_prep", "tri.packed_count", "tri.merge_packed")

# the device spanner (bench.py: bench_spanner): k = 2, 4 windows of 2^18;
# k = 3 also on 2^16 edges over 2^12 vertices in 4 windows
SP_VERTICES = 1 << 18
SP_EDGES = 1 << 20
SP_WINDOW = 1 << 18
SP_SEED = 17
SP3_EDGES = 1 << 16
SP3_VERTICES = 1 << 12
SP_STEPS = ("spanner.k2", "spanner.k2_merge")
SP3_STEPS = ("spanner.k_reach", "spanner.append")

# phase 8: the seeded edge values of window 0, and the tolerance of its
# float results between the card and the CPU (relative to max(|x|, 1)):
# scatter-adds sum in another order on the card
NBR_SEED = 17
NBR_TOL = 1e-5

# the obs spans that open record_function ranges: device-side copies of
# them are ranges, not kernels
SPAN_PREFIXES = ("cc.", "window.", "engine.", "ingest.", "degree.", "tri.", "segment.",
                 "csr.", "pagerank.", "bip.", "spanner.", "dict.", "sampling.", "icc.")

# phase 13: the CC cell with vertex compaction on the device
# (bench.py: bench_cc_e2e_device, bench_cc_e2e_device_text)
DE_HINT = 1 << 10  # the growth form's pre-sizing hint
DE_STEPS = ("dict.encode", "engine.dispatch", "cc.propagate")
DE_SPARSE_WINDOWS = 2  # windows of the corpus mapped to sparse int32 ids
DE_SPARSE_PRIME = (1 << 31) - 1  # the map x -> (a x + b) mod p is injective
# phase 14: the sampling triangle estimators
SMP_VERTICES = 1 << 15
SMP_EDGES = 1 << 22
SMP_SEED = 19
SMP_WINDOW = 1 << 20
SMP_TARGET_BETA = 100  # k: the least power of two with E[beta_sum] >= this
SMP_MAX_K = 1 << 24
SMP_SE = 4  # the estimate within this many binomial standard errors
SMP_SCAN_EDGES = 1 << 12
SMP_SCAN_VERTICES = 1 << 16  # above the vectorized form's 46340
SMP_SCAN_K = 1 << 12
SMP_STEPS = ("sampling.window",)  # the scan form's range is "sampling.scan"
# phase 15: iterative CC
ICC_VERTICES = 1 << 18
ICC_EDGES = 1 << 20
ICC_SEED = 21
ICC_WINDOW = 1 << 18
ICC_STEPS = ("icc.incremental", "icc.diff", "dict.encode", "engine.dispatch", "cc.propagate")

# H100 SXM peaks (NVIDIA data sheet): HBM rate and dense bf16 tensor rate;
# float32 work counts against the CUDA cores' f32 rate
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12}

# kernel vs plain: f32 differs only by summation order; bf16 also by the
# one rounding of the output to bf16 (each relative to max|ref|)
KERNEL_TOL = {"float32": 1e-4, "bfloat16": 1e-2}
# end to end, bf16: index_add_ sums with atomics in an order that changes
# from run to run, in bf16, and both layers round to bf16
SLICE_TOL = 2e-2

# written before every timed launch: more than twice the H100's 50 MB L2
FLUSH_BYTES = 256 << 20
TIMED_LAUNCHES = 25


def make_stream(n_vertices, n_edges, seed=7):
    """Power-law-ish random edge stream (Zipf endpoints, like social graphs);
    the generator of bench.py's config #5."""
    rng = np.random.default_rng(seed)
    u = rng.random(n_edges)
    v = rng.random(n_edges)
    a = 0.75  # skew
    src = np.minimum((n_vertices * u**a * rng.random(n_edges)).astype(np.int64), n_vertices - 1)
    dst = np.minimum((n_vertices * v**a * rng.random(n_edges)).astype(np.int64), n_vertices - 1)
    return src.astype(np.int32), dst.astype(np.int32)


def say(*parts):
    print(*parts, flush=True)


def cold_ms(torch, fn, flush, iters=TIMED_LAUNCHES, warmup=3):
    """Median device time of one call of ``fn`` with a cold L2: before each
    call the ``flush`` buffer (``FLUSH_BYTES``) is written, which evicts the
    operands from L2, and each call runs between its own pair of CUDA
    events. The write of the buffer takes longer on the card than the host
    takes to enqueue the call, so the events time the call, not the host."""
    for _ in range(warmup):
        fn()
    pairs = []
    for _ in range(iters):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in pairs)


def cuda_ms(torch, fn, iters=20, warmup=3):
    """Mean device time of ``fn`` over ``iters`` back-to-back calls on the
    same operands, by one pair of CUDA events (the first slice's timing;
    operands that fit in L2 stay warm there)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_device(torch):
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this script needs an NVIDIA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    say(smi)
    say(f"torch {torch.__version__} cuda {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} card(s)")
    torch.backends.cuda.matmul.allow_tf32 = False
    say("tf32 off for float32 matmuls (torch.backends.cuda.matmul.allow_tf32 = False)")
    return smi


def phase_build():
    from gelly_streaming_tpu_torch.ops import cuda_build

    t0 = time.perf_counter()
    paths = cuda_build.build_all()
    say(f"build: {len(paths)} kernel source(s) in {time.perf_counter() - t0:.2f} s")
    for name in paths:
        info = cuda_build.BUILD_INFO[name]
        say(f"  {name}: nvcc {info['seconds']:.2f} s")
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line:
                say("   ", line.strip())
    sass_counts(paths["fused_sage_matmul"], cuda_build.find_nvcc())


def sass_counts(library, nvcc):
    """Counts of HGMMA (wgmma) and UTMALDG (TMA tile load) in each instance
    of the tensor-core kernel, from ``cuobjdump -sass`` of the built library;
    fails if an instance has none of either."""
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    if not os.path.isfile(cuobjdump):
        cuobjdump = shutil.which("cuobjdump")
    if not cuobjdump:
        say("sass: HGMMA and UTMALDG not checked (no cuobjdump)")
        return
    sass = subprocess.run([cuobjdump, "-sass", library], capture_output=True, text=True,
                          check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :", 1)[1].strip()
            if "fused_sage_matmul_tc_kernel" not in fn:
                fn = None
            else:
                counts[fn] = {"HGMMA": 0, "UTMALDG": 0}
        elif fn is not None:
            for op in ("HGMMA", "UTMALDG"):
                counts[fn][op] += op in line
    if not counts:
        raise AssertionError("cuobjdump shows no fused_sage_matmul_tc_kernel")
    for fn, c in sorted(counts.items()):
        say(f"sass: {fn}: HGMMA {c['HGMMA']}, UTMALDG {c['UTMALDG']}")
        if c["HGMMA"] == 0 or c["UTMALDG"] == 0:
            raise AssertionError(f"the tensor-core kernel {fn} has no wgmma or no TMA load")


def _operands(torch, gen, v, f, o, dtype):
    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    return rnd(v, f), rnd(v, f), rnd(f, o), rnd(f, o), rnd(o)


def bound_ms(v, f, o, dtype_name):
    """Least time on the card: each operand read once, the output written
    once, against the 4*V*F*O multiply-adds (plus bias) at peak."""
    size = 2 if dtype_name == "bfloat16" else 4
    nbytes = (2 * v * f + 2 * f * o + o + v * o) * size
    ops = 4 * v * f * o + v * o
    return max(nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS_PER_S[dtype_name]) * 1e3, nbytes, ops


def _check_kernel(torch, sk, ops, act, variant, label):
    """One wrapper call on the card, which must launch ``variant``, against
    the plain version at ``KERNEL_TOL``; returns the max abs error."""
    dtype_name = str(ops[0].dtype).replace("torch.", "")
    before = dict(sk.LAUNCHES_BY_VARIANT)
    got = sk.fused_sage_matmul(*ops, act)
    torch.cuda.synchronize()
    launched = {k: sk.LAUNCHES_BY_VARIANT[k] - before[k] for k in before}
    want = sk.fused_sage_matmul_plain(*ops, act)
    err = (got.float() - want.float()).abs().max().item()
    ref = want.float().abs().max().item()
    tol = KERNEL_TOL[dtype_name] * max(ref, 1.0)
    ok = (err <= tol and bool(torch.isfinite(got).all())
          and launched == {k: int(k == variant) for k in launched})
    say(f"kernel vs plain {label} {dtype_name} {act} [{variant}]: max_abs_err {err:.3e} "
        f"(max|ref| {ref:.3e}, tol {tol:.3e}) launched {launched} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"fused_sage_matmul ({variant}) failed at {label} {dtype_name} {act}")
    return err


def _misaligned(torch, t):
    """A contiguous copy of ``t`` whose address is 2 bytes past a multiple
    of 16 (an element into a fresh allocation)."""
    flat = torch.empty(t.numel() + 8, dtype=t.dtype, device=t.device)
    view = flat[1:1 + t.numel()].view(t.shape)
    view.copy_(t)
    assert view.data_ptr() % 16 == 2
    return view


def phase_kernels(torch):
    from gelly_streaming_tpu_torch.ops import sage_kernels as sk

    gen = torch.Generator(device="cuda").manual_seed(0)
    main = [(N_VERTICES, DIMS[0], DIMS[1]), (N_VERTICES, DIMS[1], DIMS[2])]
    main_err = 0.0
    # config #5 shapes: bf16 on the tensor cores, f32 on the CUDA cores
    for v, f, o in main:
        for dtype_name, variant in (("bfloat16", "tc"), ("float32", "simt")):
            ops = _operands(torch, gen, v, f, o, getattr(torch, dtype_name))
            for act in ("relu", "none"):
                err = _check_kernel(torch, sk, ops, act, variant, f"[{v},{f}]x[{f},{o}]")
                if variant == "tc":
                    main_err = max(main_err, err)
    # ragged tensor-core shapes: V and F tails, O > 256 (two column tiles)
    for f, o in ((48, 72), (136, 264)):
        for v in (1, 100, 257, 65537):
            ops = _operands(torch, gen, v, f, o, torch.bfloat16)
            for act in ("relu", "none"):
                _check_kernel(torch, sk, ops, act, "tc", f"[{v},{f}]x[{f},{o}]")
    # the CUDA-core kernel: f32, F and O off multiples of 8, misaligned bf16
    for v, f, o in ((100, 48, 72), (257, 130, 65), (1, 1, 1)):
        for dtype_name in ("float32", "bfloat16"):
            ops = _operands(torch, gen, v, f, o, getattr(torch, dtype_name))
            if dtype_name == "bfloat16" and f % 8 == 0 and o % 8 == 0:
                ops = tuple(_misaligned(torch, t) for t in ops)
            for act in ("relu", "none"):
                _check_kernel(torch, sk, ops, act, "simt", f"[{v},{f}]x[{f},{o}]")

    # times at the main path's shapes: layer 1 relu, layer 2 none, bf16
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    rows = []
    for (v, f, o), act in zip(main, ("relu", "none")):
        h, agg, ws, wn, b = _operands(torch, gen, v, f, o, torch.bfloat16)
        cat_x = torch.cat([h, agg], dim=1)
        cat_w = torch.cat([ws, wn], dim=0)
        out = torch.empty((v, o), dtype=torch.bfloat16, device="cuda")

        def kernel():
            return sk.fused_sage_matmul(h, agg, ws, wn, b, act)

        def simt():
            sk._launch("simt", h, agg, ws, wn, b, out, act)

        def plain():
            return sk.fused_sage_matmul_plain(h, agg, ws, wn, b, act)

        def library():
            y = torch.addmm(b, cat_x, cat_w)
            return torch.relu_(y) if act == "relu" else y

        row = {
            "shape": f"[{v},{f}]x[{f},{o}] {act}",
            "kernel_ms": cold_ms(torch, kernel, flush),
            "plain_ms": cold_ms(torch, plain, flush),
            "library_ms": cold_ms(torch, library, flush),
            "simt_ms": cold_ms(torch, simt, flush),
        }
        row["bound_ms"], row["bytes"], row["ops"] = bound_ms(v, f, o, "bfloat16")
        row["bound_share"] = row["bound_ms"] / row["kernel_ms"]
        t0 = time.perf_counter()
        for _ in range(100):
            kernel()
        row["host_us_per_call"] = (time.perf_counter() - t0) * 1e4
        torch.cuda.synchronize()
        say("time (cold L2, median of each launch alone) " + json.dumps(row))
        if row["bound_share"] > 1.0:
            raise AssertionError("the kernel ran faster than its bound: the timing is wrong")
        warm = {"shape": row["shape"], "kernel_ms": cuda_ms(torch, kernel),
                "plain_ms": cuda_ms(torch, plain), "library_ms": cuda_ms(torch, library),
                "simt_ms": cuda_ms(torch, simt)}
        say("time (warm loop as in the first slice: mean of 20 back-to-back launches) "
            + json.dumps(warm))
        row["warm"] = warm
        rows.append(row)
    del flush
    return main_err, rows


def _run_slice(torch, src, dst, params, table):
    from gelly_streaming_tpu_torch import CountWindow, SimpleEdgeStream
    from gelly_streaming_tpu_torch.datasets import IdentityDict
    from gelly_streaming_tpu_torch.models import StreamingGraphSAGE

    stream = SimpleEdgeStream(
        (src, dst), window=CountWindow(WINDOW),
        vertex_dict=IdentityDict(N_VERTICES), device="cuda",
    )
    return list(StreamingGraphSAGE(params, feature_dim=DIMS[0]).run(stream, table))


def phase_slice(torch, kernel_rows):
    from gelly_streaming_tpu_torch.models import TableFeatureSource, init_graphsage
    from gelly_streaming_tpu_torch.models.graphsage import mean_aggregate
    from gelly_streaming_tpu_torch.ops import sage_kernels as sk

    src, dst = make_stream(N_VERTICES, WINDOW * N_WINDOWS, seed=STREAM_SEED)
    params = init_graphsage(
        DIMS, torch.bfloat16, generator=torch.Generator().manual_seed(0), device="cuda"
    )
    table = TableFeatureSource(
        torch.randn((N_VERTICES, DIMS[0]), generator=torch.Generator().manual_seed(1))
        .to(torch.bfloat16), device="cuda",
    )

    # the main path, counted: every window's layers go through the
    # tensor-core kernel
    sk.LAUNCHES = 0
    sk.LAUNCHES_BY_VARIANT.update(tc=0, simt=0)
    outs = _run_slice(torch, src, dst, params, table)
    torch.cuda.synchronize()
    launches = sk.LAUNCHES
    by_variant = dict(sk.LAUNCHES_BY_VARIANT)
    say(f"slice: {len(outs)} windows, fused_sage_matmul launches {launches} {by_variant} "
        f"(expected tc {2 * N_WINDOWS}, simt 0)")
    if len(outs) != N_WINDOWS or by_variant != {"tc": 2 * N_WINDOWS, "simt": 0}:
        raise AssertionError("the main path did not launch the tensor-core kernel twice "
                             "per window, and only it")
    for out in outs:
        if tuple(out.shape) != (N_VERTICES, DIMS[-1]) or not bool(torch.isfinite(out).all()):
            raise AssertionError(f"bad embeddings: shape {tuple(out.shape)}")

    # reference on the card from the plain functions, over all 2^20 edges
    s = torch.from_numpy(src).to("cuda")
    d = torch.from_numpy(dst).to("cuda")
    mask = torch.ones(s.shape[0], dtype=torch.bool, device="cuda")
    h = table.table
    for i, p in enumerate(params):
        agg = mean_aggregate(h, s, d, mask, N_VERTICES)
        act = "relu" if i < len(params) - 1 else "none"
        h = sk.fused_sage_matmul_plain(h, agg, p["w_self"], p["w_nbr"], p["b"], act)
    diff = (outs[-1].float() - h.float()).abs()
    ref = h.float().abs().max().item()
    err = diff.max().item()
    say(f"slice vs plain-composed reference (last window, {src.shape[0]} edges): "
        f"max_abs_err {err:.3e}, mean_abs_err {diff.mean().item():.3e}, "
        f"max|ref| {ref:.3e}, tol {SLICE_TOL * ref:.3e}")
    if not err <= SLICE_TOL * ref:
        raise AssertionError("the slice's embeddings disagree with the reference")
    del outs, s, d, mask, h, agg, diff

    # steady passes after the warm one above: host clock around a whole
    # pass (windowing, uploads, forward), ended by a synchronize
    times = []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(3):
        t0 = time.perf_counter()
        _run_slice(torch, src, dst, params, table)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    wall = statistics.median(times)
    ms_window = wall / N_WINDOWS * 1e3
    kernel_window_ms = sum(r["kernel_ms"] for r in kernel_rows)
    result = {
        "launches": launches,
        "edges_per_s": WINDOW * N_WINDOWS / wall,
        "ms_per_window": ms_window,
        "pass_s": times,
        "kernel_ms_per_window": kernel_window_ms,
        "kernel_share": kernel_window_ms / ms_window,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
    }
    say("slice " + json.dumps(result))
    profile_pass(torch, lambda: _run_slice(torch, src, dst, params, table), wall)
    return result


def profile_pass(torch, one_pass, wall, prof=None):
    """Device time by kernel over one pass (torch.profiler): the busy share
    and the eight kernels that take the most device time (of ``prof`` when
    the pass was already profiled)."""
    from torch.profiler import ProfilerActivity, profile

    if prof is None:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            one_pass()
            torch.cuda.synchronize()
    events = prof.key_averages()

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    # the device-side copies of the obs spans' record_function ranges are
    # ranges, not kernels
    kernels = [e for e in events if e.device_type.name == "CUDA" and dev_us(e) > 0
               and not e.key.startswith(SPAN_PREFIXES)]
    total_us = sum(dev_us(e) for e in kernels)
    if total_us == 0:
        say("profile: no device time in the trace (not measured)")
        return None
    say(f"profile: device busy {total_us / 1e3:.3f} ms over a {wall * 1e3:.3f} ms pass "
        f"(busy share {total_us / 1e6 / wall:.3f}, not corrected for profiler overhead)")
    for e in sorted(kernels, key=dev_us, reverse=True)[:8]:
        say(f"  {dev_us(e) / total_us:6.3f}  {dev_us(e) / 1e3:9.3f} ms  x{e.count:<4d} {e.key[:90]}")
    return total_us / 1e6 / wall


@functools.lru_cache(maxsize=1)
def rmat_oracle_edges(n_edges, scale, chunk=1 << 22, a=0.57, b=0.19, c=0.19):
    """The surrogate's edge columns regenerated from the seeds the corpus
    writer uses (chunk ``start`` takes seed ``start``), by an R-MAT written
    out here: the oracle needs neither the port nor the file. Kept for
    phase 6, which checks the same edges; callers only read them."""
    srcs, dsts = [], []
    for start in range(0, n_edges, chunk):
        n = min(chunk, n_edges - start)
        rng = np.random.default_rng(start)
        src = np.zeros(n, np.int64)
        dst = np.zeros(n, np.int64)
        for _ in range(scale):
            r = rng.random(n)
            src = (src << 1) | (r >= a + b)
            dst = (dst << 1) | ((r >= a) & (r < a + b) | (r >= a + b + c))
        srcs.append(src)
        dsts.append(dst)
    return np.concatenate(srcs), np.concatenate(dsts)


def oracle_labels(src, dst, n):
    """Each vertex's least vertex id in its component, by scipy."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components

    graph = coo_matrix((np.ones(len(src), np.int8), (src, dst)), shape=(n, n))
    ncomp, comp = connected_components(graph, directed=True, connection="weak")
    least = np.full(ncomp, n, np.int64)
    np.minimum.at(least, comp, np.arange(n))
    return least[comp]


def _cc_pass(torch, path, carry="auto", superbatch=1, windows=None):
    """One pass of the headline cell as ``bench_cc_e2e`` runs it: returns
    the result dict and the emissions (only the last, unless ``windows``
    asks for the first few, which stops the stream there)."""
    from gelly_streaming_tpu_torch import CountWindow, datasets
    from gelly_streaming_tpu_torch.library import ConnectedComponents
    from gelly_streaming_tpu_torch.summaries import labels

    stream = datasets.stream_file(
        path, window=CountWindow(CC_WINDOW), vertex_dict=datasets.IdentityDict(CC_ID_BOUND),
        prefetch_depth=2, device="cuda",
    )
    agg = ConnectedComponents(carry=carry, superbatch=superbatch)
    labels.HOST_READS = labels.FIXPOINT_TURNS = 0
    kept, lat = [], []
    t0 = last_t = time.perf_counter()
    it = stream.aggregate(agg)
    for comps in it:
        now = time.perf_counter()
        lat.append(now - last_t)
        last_t = now
        kept = kept + [comps] if windows else [comps]
        if windows and len(kept) == windows:
            it.close()
            break
    agg.sync()
    dt = time.perf_counter() - t0
    lat_ms = np.asarray(lat) * 1e3
    n_win = len(lat)
    return {
        "windows": n_win,
        "seconds": dt,
        "p50_ms": float(np.percentile(lat_ms, 50)),
        "p95_ms": float(np.percentile(lat_ms, 95)),
        "carry": agg._cc_mode,
        "host_reads_per_window": labels.HOST_READS / n_win,
        "fixpoint_turns_per_window": labels.FIXPOINT_TURNS / n_win,
    }, kept, agg


class _SpanTotals:
    """An obs span sink: calls and host seconds by span name, over every
    thread (the prefetch producer's spans included)."""

    def __init__(self):
        import threading

        self.lock = threading.Lock()
        self.totals = {}

    def emit(self, event):
        with self.lock:
            row = self.totals.setdefault(event["name"], [0, 0.0])
            row[0] += 1
            row[1] += event["dur_s"]


def cc_step_bytes(t, t_group, n, v, k):
    """Bytes each CC device step must move for a window of ``n`` edges
    touching ``t`` vertices over a ``v``-vertex forest (``t_group`` touched
    by a group of ``k`` windows): each input read once, each output written
    once, int32 lanes, bool masks; the gathers read only the entries they
    need, and the commit copies the forest (read and write) since every
    emission keeps its own."""
    return {
        # tid, tmask, the chased forest entries; r, v2, key_ written
        "cc.chase_and_group": 21 * t,
        # lu, lv; the seed and the group targets; the local labels written
        "cc.propagate": 8 * n + 16 * t,
        # the forest read and its new copy written; local, key_, r, tid, tmask
        "cc.commit_roots": 8 * v + 17 * t,
        # per window of the group: lu, lv, the label table in and out, key_,
        # nr_k written; a k-th of the group's chase and commit
        "cc.forest_superbatch": 8 * n + 20 * t_group + (38 * t_group + 8 * v) / k,
        # the forest read once, the flat labels written
        "cc.resolve_flat": 8 * v,
        # the forest read and its new copy written; at least t (index, value)
        "cc.mirror_update": 8 * v + 12 * t,
    }


def _step_table(prof, names, per):
    """Device time and kernel launches under each named range (the CPU-side
    ``record_function`` events of the trace), divided by ``per``."""
    out = {}

    def kernels(e):
        return (len(e.kernels), sum(k.duration for k in e.kernels)), e.cpu_children

    for e in prof.events():
        if e.name not in names or e.device_type.name != "CPU":
            continue
        n = dur = 0
        stack = [e]
        while stack:
            (kn, kd), children = kernels(stack.pop())
            n += kn
            dur += kd
            stack.extend(children)
        row = out.setdefault(e.name, {"calls": 0, "launches": 0, "device_ms": 0.0})
        row["calls"] += 1
        row["launches"] += n
        row["device_ms"] += dur / 1e3
    return {k: {f: v / per for f, v in row.items()} for k, row in out.items()}


def phase_cc(torch):
    from gelly_streaming_tpu_torch import datasets, native
    from gelly_streaming_tpu_torch.obs import trace
    from gelly_streaming_tpu_torch.ops import sage_kernels as sk
    from gelly_streaming_tpu_torch.summaries import forest

    t0 = time.perf_counter()
    path, is_real = datasets.ensure_corpus(CC_CORPUS)
    spec = datasets.CORPORA[CC_CORPUS]
    say(f"cc corpus: {path} ({'real' if is_real else 'surrogate'}), "
        f"{os.path.getsize(path)} bytes, ready in {time.perf_counter() - t0:.2f} s")
    if is_real:
        raise AssertionError("the headline cell is the surrogate; a real corpus was found")
    n_edges = spec.surrogate_edges
    if not native.native_available():
        raise AssertionError(f"the native library did not load: {native.BUILD_ERROR}")
    say(f"cc native library: {native.library_path()}")

    # the timed cell: one warm pass, then the median of the steady passes;
    # the counts of every kernel are 0 just before and read just after
    sk.LAUNCHES = 0
    warm, _, _ = _cc_pass(torch, path)
    passes = [_cc_pass(torch, path) for _ in range(CC_STEADY_PASSES)]
    say(f"cc fused_sage_matmul launches in the CC passes: {sk.LAUNCHES} (the path has no "
        "hand-written kernel; its device steps are PyTorch operations)")
    results = [p[0] for p in passes]
    for r in results:
        r["edges_per_s"] = n_edges / r["seconds"]
    order = sorted(range(len(results)), key=lambda i: results[i]["edges_per_s"])
    mid = order[len(order) // 2]
    cell = dict(results[mid])
    cell["edges_per_s_all"] = [r["edges_per_s"] for r in results]
    cell["warm_seconds"] = warm["seconds"]
    cell["corpus_edges"] = n_edges
    say("cc cell " + json.dumps(cell))
    if cell["carry"] != "forest" or cell["windows"] != n_edges // CC_WINDOW:
        raise AssertionError(f"the cell ran carry {cell['carry']} over {cell['windows']} windows")

    # correctness: the last window against scipy on the regenerated edges
    last = passes[mid][1][-1]
    t1 = time.perf_counter()
    src, dst = rmat_oracle_edges(n_edges, int(spec.surrogate_vscale).bit_length() - 1)
    want = oracle_labels(src, dst, CC_ID_BOUND)
    seen = np.zeros(CC_ID_BOUND, bool)
    seen[src] = True
    seen[dst] = True
    ids, got = last.labels()
    want_ids = np.nonzero(seen)[0]
    n_comp = len(np.unique(got))
    ok = (np.array_equal(ids, want_ids) and np.array_equal(got, want[want_ids])
          and n_comp == len(np.unique(want[want_ids])))
    say(f"cc vs scipy (last window, {len(ids)} vertices seen): components {n_comp}, "
        f"mismatches {int(np.sum(got != want[want_ids])) if len(ids) == len(want_ids) else 'n/a'}, "
        f"{'exact' if ok else 'FAIL'} ({time.perf_counter() - t1:.1f} s)")
    if not ok:
        raise AssertionError("the forest carry disagrees with scipy's components")
    cell["components"] = n_comp
    cell["vertices_seen"] = int(len(ids))
    # touched vertices per window and per group of the prefix: the sizes
    # the device steps' bounds are counted from
    touched = [np.unique(np.concatenate([src[a:a + CC_WINDOW], dst[a:a + CC_WINDOW]])).size
               for a in range(0, n_edges, CC_WINDOW)]
    prefix = CC_WINDOW * CC_PREFIX_WINDOWS
    t_group = np.unique(np.concatenate([src[:prefix], dst[:prefix]])).size
    cell["touched_per_window"] = float(np.mean(touched))
    cell["touched_prefix_group"] = int(t_group)
    say(f"cc touched vertices per window: mean {np.mean(touched):.0f}, min {min(touched)}, "
        f"max {max(touched)}; the first {CC_PREFIX_WINDOWS} windows together {t_group}")
    del src, dst, want, seen, passes

    # the other carries and the superbatch on the first windows
    base = [c.labels() for c in _cc_pass(torch, path, windows=CC_PREFIX_WINDOWS)[1]]
    for carry, k in (("host", 1), ("dense", 1), ("forest", CC_PREFIX_WINDOWS)):
        r, ems, _ = _cc_pass(torch, path, carry=carry, superbatch=k, windows=CC_PREFIX_WINDOWS)
        same = len(ems) == len(base) and all(
            np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
            for a, b in zip(base, (c.labels() for c in ems))
        )
        say(f"cc prefix {CC_PREFIX_WINDOWS} windows, carry {r['carry']} superbatch {k}: "
            f"{r['seconds'] * 1e3 / r['windows']:.1f} ms a window, "
            f"{'equal to the forest carry' if same else 'FAIL'}")
        if not same or r["carry"] != carry:
            raise AssertionError(f"carry {carry} (superbatch {k}) disagrees with the forest carry")

    # host time by span over one pass (no profiler): every thread's spans
    sink = _SpanTotals()
    trace.add_sink(sink)
    trace.enable()
    try:
        r, _, _ = _cc_pass(torch, path)
    finally:
        trace.disable()
        trace.remove_sink(sink)
    host = {name: {"calls": c / r["windows"], "host_ms": sec * 1e3 / r["windows"]}
            for name, (c, sec) in sorted(sink.totals.items())}
    say(f"cc host time per window by span (a pass of {r['seconds'] * 1e3:.1f} ms, "
        f"{r['seconds'] * 1e3 / r['windows']:.2f} ms a window; ingest.parse and window.pack "
        "run on the prefetch thread) " + json.dumps(host))
    cell["host_spans"] = host

    # where the time goes: one profiled pass, then the other steps
    from torch.profiler import ProfilerActivity, profile

    trace.enable(torch_annotations=True)
    try:
        torch.cuda.reset_peak_memory_stats()
        t2 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            r, ems, agg = _cc_pass(torch, path)
            torch.cuda.synchronize()
        wall = time.perf_counter() - t2
        cell["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
        profile_pass(torch, lambda: None, wall, prof=prof)
        steps = _step_table(prof, CC_STEPS, r["windows"])
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof2:
            forest.resolve_flat(agg._canon)
            _cc_pass(torch, path, carry="host", windows=CC_PREFIX_WINDOWS)
            _cc_pass(torch, path, superbatch=CC_PREFIX_WINDOWS, windows=CC_PREFIX_WINDOWS)
            torch.cuda.synchronize()
        others = _step_table(prof2, ("cc.resolve_flat", "cc.mirror_update",
                                     "cc.forest_superbatch"), CC_PREFIX_WINDOWS)
        others["cc.resolve_flat"] = {f: v * CC_PREFIX_WINDOWS
                                     for f, v in others.get("cc.resolve_flat", {}).items()}
    finally:
        trace.disable()
    say(f"cc peak device memory over a pass: {cell['peak_mem_gb']:.3f} GB")
    table = {**steps, **others}
    nbytes = cc_step_bytes(cell["touched_per_window"], t_group, CC_WINDOW, CC_ID_BOUND,
                           CC_PREFIX_WINDOWS)
    for name, row in table.items():
        if name in nbytes:
            row["bytes"] = nbytes[name]
            row["bound_ms"] = nbytes[name] / HBM_BYTES_PER_S * 1e3
            row["bound_share"] = row["bound_ms"] / row["device_ms"] if row["device_ms"] else None
    say("cc steps (device ms and launches per window of the forest pass; resolve_flat per "
        "call; mirror_update and forest_superbatch per window of the 4-window prefix; "
        "bound by bytes) " + json.dumps(table))
    cell["steps"] = table
    return cell


# --------------------------------------------------------------------- #
# The window and neighborhood layer (phases 6-9)
# --------------------------------------------------------------------- #
def _n_syncs(log):
    # the text of c10's warn_or_error_on_sync (set_sync_debug_mode's own
    # "prototype feature" notice is not a sync)
    return sum("called a synchronizing CUDA operation" in str(w.message) for w in log)


def count_syncs(torch, items):
    """Drain ``items`` (one per window) under
    ``torch.cuda.set_sync_debug_mode("warn")``: PyTorch then warns at every
    implicit host sync (a device-to-host read, a stream wait). Returns
    (windows, syncs up to the last window's item, syncs after it)."""
    with warnings.catch_warnings(record=True) as log:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            n = in_loop = 0
            for _ in items:
                n += 1
                in_loop = _n_syncs(log)
            after = _n_syncs(log) - in_loop
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return n, in_loop, after


def timed_passes(torch, one_pass, n_edges):
    """One warm pass, then ``STEADY_PASSES``: the host clock around each
    pass, which ends in a synchronize. Returns the cell's dict (the
    median pass) and its windows."""
    one_pass()
    times, windows = [], 0
    for _ in range(STEADY_PASSES):
        t0 = time.perf_counter()
        windows = one_pass()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    med = statistics.median(times)
    return {"windows": windows, "edges_per_s": n_edges / med, "ms_per_window": med / windows * 1e3,
            "edges_per_s_all": [n_edges / t for t in times], "pass_s": times}


def window_step_bytes(n, v, d=0):
    """Bytes each step of phases 6 and 7 must move for a window of ``n``
    edges over ``v`` vertices (rows ``d`` wide): each input read once, each
    output written once; int32 ids, bool masks."""
    return {
        # src, dst, mask, the degree vector in; the new vector and the
        # packed [2, 2n] ids and degrees out
        "degree.update": 9 * n + 8 * v + 16 * n,
        # ids and mask in, the counts out (per call)
        "segment.count": 5 * n + 4 * v,
        # ids, mask and the int32 payloads in and out (one payload: 13 n)
        "segment.sort": 2 * 13 * n,
        # key, nbr, val, mask in; the sorted four, row_ptr and degree out
        "csr.build": 26 * n + 8 * v,
        # src, dst, mask in; a, b, m and the sorted [v, d] rows out
        "tri.oriented_rows": 9 * n + 9 * n + 4 * v * d,
        # the rows, a, b, m in; the per-vertex counts and the total out
        "tri.membership": 4 * v * d + 9 * n + 4 * v,
    }


def step_rows(prof, names, per, nbytes):
    table = _step_table(prof, names, per)
    for name, row in table.items():
        if name in nbytes:
            row["bound_ms"] = nbytes[name] / HBM_BYTES_PER_S * 1e3
            row["bound_share"] = row["bound_ms"] / row["device_ms"] if row["device_ms"] else None
    return table


def profile_cell(torch, label, one_pass, names, nbytes):
    """One profiled pass with the device steps as record_function ranges:
    busy share, top operations, device-to-host copies, peak memory and
    the per-window step table."""
    from torch.profiler import ProfilerActivity, profile

    from gelly_streaming_tpu_torch.obs import trace

    # host time by span over one pass (every thread's spans)
    sink = _SpanTotals()
    trace.add_sink(sink)
    trace.enable()
    try:
        windows = one_pass()
    finally:
        trace.disable()
        trace.remove_sink(sink)
    host = {name: {"calls": c / windows, "host_ms": sec * 1e3 / windows}
            for name, (c, sec) in sorted(sink.totals.items())}
    say(f"{label} host time per window by span " + json.dumps(host))
    trace.enable(torch_annotations=True)
    try:
        torch.cuda.reset_peak_memory_stats()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            # the clock starts inside: the profiler's own start-up is not
            # part of the pass
            t0 = time.perf_counter()
            windows = one_pass()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        trace.disable()
    say(f"{label} profile ({windows} windows):")
    busy = profile_pass(torch, lambda: None, wall, prof=prof)
    d2h = sum(1 for e in prof.events() if e.device_type.name == "CUDA" and "DtoH" in e.name)
    peak = torch.cuda.max_memory_allocated() / 1e9
    table = step_rows(prof, names, windows, nbytes)
    say(f"{label} device-to-host copies in the profiled pass: {d2h}; peak device memory "
        f"{peak:.3f} GB")
    say(f"{label} steps (device ms, launches and bytes' bound per window) " + json.dumps(table))
    return {"busy_share": busy, "d2h_copies": d2h, "peak_mem_gb": peak, "steps": table,
            "host_spans": host}


def _deg_batches(bin_path):
    from gelly_streaming_tpu_torch import CountWindow, datasets

    stream = datasets.stream_file(
        bin_path, window=CountWindow(CC_WINDOW), vertex_dict=datasets.IdentityDict(CC_ID_BOUND),
        prefetch_depth=2, device="cuda",
    )
    return stream.get_degrees().batches()


def _dd_events():
    rng = np.random.default_rng(DD_SEED)
    s = rng.integers(0, DD_VERTICES, DD_EVENTS).tolist()
    d = rng.integers(0, DD_VERTICES, DD_EVENTS).tolist()
    kinds = (rng.random(DD_EVENTS) < 0.7).tolist()
    return [(a, b, "+" if k else "-") for a, b, k in zip(s, d, kinds)]


def phase_degrees(torch):
    from gelly_streaming_tpu_torch import CountWindow, datasets
    from gelly_streaming_tpu_torch.library import DegreeDistribution

    path, _ = datasets.ensure_corpus(CC_CORPUS)
    spec = datasets.CORPORA[CC_CORPUS]
    n_edges = spec.surrogate_edges
    t0 = time.perf_counter()
    bin_path = datasets.binary_cache(path)
    say(f"degrees: binary cache {bin_path} ({os.path.getsize(bin_path)} bytes) in "
        f"{time.perf_counter() - t0:.2f} s")

    def one_pass():
        return sum(1 for _ in _deg_batches(bin_path))

    cell = timed_passes(torch, one_pass, n_edges)
    n, in_loop, after = count_syncs(torch, _deg_batches(bin_path))
    cell.update(host_syncs_in_loop=in_loop, host_syncs_per_window=in_loop / n,
                host_syncs_after_loop=after)
    say("degrees cell " + json.dumps(cell))
    if cell["windows"] != n_edges // CC_WINDOW or in_loop != 0:
        raise AssertionError(f"the degree loop ran {cell['windows']} windows with {in_loop} "
                             "host syncs")

    # correctness: every window's emission read, against numpy
    cols = [b.columns for b in _deg_batches(bin_path)]
    src, dst = rmat_oracle_edges(n_edges, int(spec.surrogate_vscale).bit_length() - 1)
    want = np.bincount(src, minlength=CC_ID_BOUND) + np.bincount(dst, minlength=CC_ID_BOUND)
    final = np.zeros(CC_ID_BOUND, np.int64)
    for ids, degs in cols:
        final[ids] = degs
    last_ids = np.unique(np.concatenate([src[-CC_WINDOW:], dst[-CC_WINDOW:]]))
    ok = (np.array_equal(final, want) and np.array_equal(cols[-1][0], last_ids)
          and np.array_equal(cols[-1][1], want[last_ids]) and cols[-1][1].dtype == np.int32)
    say(f"degrees vs numpy: {int((final > 0).sum())} vertices, max degree {int(want.max())}, "
        f"last window {len(last_ids)} changed vertices: {'exact' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the degree stream disagrees with np.bincount")

    # the fully dynamic workload: the card against the CPU
    events = _dd_events()
    out = {}
    for device in ("cpu", "cuda"):
        dd = DegreeDistribution(CountWindow(DD_WINDOW), device=device)
        t1 = time.perf_counter()
        emitted = [list(b) for b in dd.run(events)]
        out[device] = (emitted, dd.histogram(), dd.degrees(), time.perf_counter() - t1)
    (ce, ch, cd, cs), (ge, gh, gd, gs) = out["cpu"], out["cuda"]
    ok = ge == ce and gh == ch and np.array_equal(gd, cd)
    say(f"degree distribution, {DD_EVENTS} events in {len(ge)} windows: card {gs:.2f} s, cpu "
        f"{cs:.2f} s, {len(gh)} histogram bins, {'equal' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("DegreeDistribution on the card disagrees with the CPU")
    nbytes = window_step_bytes(CC_WINDOW, CC_ID_BOUND)
    nbytes["segment.count"] *= 2  # the src and the dst counts
    cell["profile"] = profile_cell(torch, "degrees", one_pass, DEG_STEPS, nbytes)
    return cell


def oracle_triangles(src, dst, n):
    """The triangle count of one window by scipy: the degree-oriented,
    deduplicated adjacency A (a -> b when (deg, id) of a is smaller), and
    the sum of (A @ A) * A."""
    from scipy.sparse import csr_matrix

    u = np.minimum(src, dst).astype(np.int64)
    v = np.maximum(src, dst).astype(np.int64)
    ok = u != v
    key = np.unique(u[ok] * n + v[ok])
    u, v = key // n, key % n
    deg = np.bincount(u, minlength=n) + np.bincount(v, minlength=n)
    swap = (deg[v] < deg[u]) | ((deg[v] == deg[u]) & (v < u))
    a = np.where(swap, v, u)
    b = np.where(swap, u, v)
    adj = csr_matrix((np.ones(len(a), np.int64), (a, b)), shape=(n, n))
    return int((adj @ adj).multiply(adj).sum())


def _tri_stream(src, dst, device="cuda", val=None):
    from gelly_streaming_tpu_torch import CountWindow, SimpleEdgeStream
    from gelly_streaming_tpu_torch.datasets import IdentityDict

    cols = (src, dst) if val is None else (src, dst, val)
    return SimpleEdgeStream(cols, window=CountWindow(TRI_WINDOW),
                            vertex_dict=IdentityDict(TRI_VERTICES), device=device)


def _tri_counts(src, dst):
    from gelly_streaming_tpu_torch import CountWindow
    from gelly_streaming_tpu_torch.library import WindowTriangles

    return WindowTriangles(CountWindow(TRI_WINDOW)).run_stream(_tri_stream(src, dst))


def phase_triangles(torch):
    from gelly_streaming_tpu_torch import CountWindow
    from gelly_streaming_tpu_torch.library.triangles import _oriented_degree_bucket
    from gelly_streaming_tpu_torch.ops.triangles import window_triangle_count

    src, dst = make_stream(TRI_VERTICES, TRI_WINDOW * TRI_WINDOWS, seed=TRI_SEED)
    kept = []

    def one_pass():
        kept[:] = [c for c, _ in _tri_counts(src, dst)]
        return len(kept)

    cell = timed_passes(torch, one_pass, TRI_WINDOW * TRI_WINDOWS)
    n, in_loop, after = count_syncs(torch, _tri_counts(src, dst))
    cell.update(host_syncs_in_loop=in_loop, host_syncs_per_window=in_loop / n,
                host_syncs_after_loop=after)
    got = [int(c) for c in kept]
    want = [oracle_triangles(src[a:a + TRI_WINDOW], dst[a:a + TRI_WINDOW], TRI_VERTICES)
            for a in range(0, len(src), TRI_WINDOW)]
    cell["counts"] = got
    say("triangles cell " + json.dumps(cell))
    say(f"triangles vs scipy: port {got}, scipy {want}: {'exact' if got == want else 'FAIL'}")
    if got != want or in_loop != 0 or cell["windows"] != TRI_WINDOWS:
        raise AssertionError("window triangles disagree with scipy or read the device per window")

    # window 0's per-vertex counts: the card against the CPU
    per = {}
    for device in ("cuda", "cpu"):
        block = next(_tri_stream(src, dst, device).slice(CountWindow(TRI_WINDOW))._block_iter_fn())
        s_h, d_h, _ = block.to_host()
        width = _oriented_degree_bucket(s_h, d_h, block.n_vertices)
        total, pv = window_triangle_count(block.src, block.dst, block.mask, block.n_vertices,
                                          width)
        per[device] = (int(total), pv.cpu().numpy(), width)
    ok = per["cuda"][0] == per["cpu"][0] == want[0] and np.array_equal(per["cuda"][1],
                                                                      per["cpu"][1])
    say(f"triangles window 0 per vertex: width {per['cuda'][2]}, {int((per['cuda'][1] > 0).sum())} "
        f"vertices in a triangle, sum {int(per['cuda'][1].sum())} (= 3 x {per['cuda'][0]}): "
        f"{'equal to the CPU' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("per-vertex triangle counts on the card disagree with the CPU")
    cell["width"] = per["cuda"][2]
    cell["profile"] = profile_cell(
        torch, "triangles", one_pass, TRI_STEPS,
        window_step_bytes(TRI_WINDOW, TRI_VERTICES, per["cuda"][2]))
    return cell


def _neighborhood_ops(torch):
    """The five neighborhood operations of phase 8, as (name, callable on
    a SnapshotStream, exact) with the UDFs written in torch."""
    def fold(acc, vid, nid, val):
        return acc[0] + 1, (acc[1] * 31 + nid) % 1000003, acc[2] * 0.5 + val

    def apply(vid, nbrs, vals, valid):
        return valid.sum(), torch.where(valid, vals, 0.0).amax()

    def flat(vid, nbrs, vals, valid):
        emit = valid & (nbrs > vid) & (vals > 0.99)
        return (torch.broadcast_to(vid, nbrs.shape), nbrs), emit

    return [
        ("reduce_on_edges(sum)", lambda s: s.reduce_on_edges("sum")),
        ("reduce_on_edges(callable)", lambda s: s.reduce_on_edges(lambda a, b: torch.add(a, b))),
        ("fold_neighbors", lambda s: s.fold_neighbors((0, 0, 0.0), fold)),
        ("apply_on_neighbors", lambda s: s.apply_on_neighbors(apply)),
        ("flat_apply_on_neighbors", lambda s: s.flat_apply_on_neighbors(flat, lambda d: d)),
    ]


def _split_numbers(records):
    """The integers and the floats of a list of (nested tuple) records."""
    ints, floats = [], []

    def walk(x):
        if isinstance(x, tuple):
            for y in x:
                walk(y)
        else:
            (floats if isinstance(x, float) else ints).append(x)

    for rec in records:
        walk(rec)
    return ints, np.asarray(floats, np.float64)


def phase_neighborhood(torch):
    from gelly_streaming_tpu_torch import EdgeDirection
    from gelly_streaming_tpu_torch.ops import segment

    src, dst = make_stream(TRI_VERTICES, TRI_WINDOW * TRI_WINDOWS, seed=TRI_SEED)
    src, dst = src[:TRI_WINDOW], dst[:TRI_WINDOW]
    val = np.random.default_rng(NBR_SEED).random(TRI_WINDOW).astype(np.float32)
    rows = {}
    for name, op in _neighborhood_ops(torch):
        res = {}
        for device in ("cuda", "cpu"):
            snap = _tri_stream(src, dst, device, val).slice(direction=EdgeDirection.ALL)
            turns = segment.FOLD_TURNS
            t0 = time.perf_counter()
            out = list(op(snap))
            if device == "cuda":
                torch.cuda.synchronize()
            res[device] = (out, (time.perf_counter() - t0) * 1e3, segment.FOLD_TURNS - turns)
        (g, g_ms, g_turns), (c, c_ms, c_turns) = res["cuda"], res["cpu"]
        gi, gf = _split_numbers(g)
        ci, cf = _split_numbers(c)
        err = float(np.max(np.abs(gf - cf) / np.maximum(np.abs(cf), 1.0))) if len(cf) else 0.0
        ok = len(g) == len(c) and gi == ci and gf.shape == cf.shape and err <= NBR_TOL
        rows[name] = {"records": len(g), "ms": g_ms, "cpu_ms": c_ms, "turns": g_turns,
                      "max_rel_err": err}
        say(f"neighborhood {name}: {len(g)} records, card {g_ms:.1f} ms, cpu {c_ms:.1f} ms"
            + (f", lockstep turns {g_turns} (cpu {c_turns})" if g_turns else "")
            + f", float max rel err {err:.2e} (tol {NBR_TOL:g}): "
            + ("equal to the CPU" if ok else "FAIL"))
        if not ok or g_turns != c_turns:
            raise AssertionError(f"{name} on the card disagrees with the CPU")
    deg = np.bincount(src, minlength=TRI_VERTICES) + np.bincount(dst, minlength=TRI_VERTICES)
    if rows["fold_neighbors"]["turns"] != deg.max():
        raise AssertionError("the fold did not run one lockstep turn per edge of the longest "
                             "neighborhood")
    return rows



# --------------------------------------------------------------------- #
# The remaining workloads (phases 9-13)
# --------------------------------------------------------------------- #
def _pr_stream(src, dst, device="cuda"):
    from gelly_streaming_tpu_torch import CountWindow, SimpleEdgeStream
    from gelly_streaming_tpu_torch.datasets import IdentityDict

    return SimpleEdgeStream((src, dst), window=CountWindow(PR_WINDOW),
                            vertex_dict=IdentityDict(PR_VERTICES), device=device)


def _pr_pass(stream, superbatch=1):
    """One pass of config #4 as ``bench_pagerank`` runs it (``sync()``
    inside): the workload, its emissions, seconds, host reads."""
    from gelly_streaming_tpu_torch.library import pagerank

    pr = pagerank.IncrementalPageRank(tol=PR_TOL, max_iter=PR_MAX_ITER, superbatch=superbatch)
    pagerank.HOST_READS = 0
    t0 = time.perf_counter()
    ems = list(pr.run(stream))
    pr.sync()
    return pr, ems, time.perf_counter() - t0, pagerank.HOST_READS


def pagerank_oracle(src, dst, window, n_vertices, tol=PR_TOL, max_iter=PR_MAX_ITER,
                    chunk=10, damping=0.85):
    """The reference's procedure in float64 with scipy: per window append
    the edges, warm start (new seen vertices at 1/n, renormalize), power
    iterations until the L1 change is at most ``tol`` or the cap (max_iter
    rounded up to a chunk), dangling mass spread uniformly over the seen
    vertices (ids below 1 + the largest id seen). Returns the final ranks
    and the iterations of each window."""
    from scipy.sparse import csr_matrix

    cap = -(-max_iter // chunk) * chunk
    r = np.zeros(n_vertices)
    iters = []
    n_seen = 0
    for a in range(0, len(src), window):
        s, t = src[: a + window], dst[: a + window]
        n_seen = max(n_seen, 1 + int(max(src[a:a + window].max(), dst[a:a + window].max())))
        active = np.arange(n_vertices) < n_seen
        r = np.where(active & (r == 0.0), 1.0 / n_seen, r)
        r = r / max(r.sum(), 1e-30)
        out = np.bincount(s, minlength=n_vertices).astype(np.float64)
        m = csr_matrix((1.0 / out[s], (t, s)), shape=(n_vertices, n_vertices))
        dangling = active & (out == 0)
        for it in range(1, cap + 1):
            new = (1 - damping) / n_seen + damping * (m @ r + r[dangling].sum() / n_seen)
            new[~active] = 0.0
            dl = np.abs(new - r).sum()
            r = new
            if dl <= tol:
                break
        iters.append(it)
    return r, iters


def pr_step_bytes(n, e, v):
    """Bytes the PageRank steps must move per window of ``n`` new edges
    over ``e`` accumulated edges and ``v`` rank slots: each input read
    once, each output written once (the iterations re-read the edges; a
    bound counts them once)."""
    return {
        # the block in and its copy into the carry; the fixpoint's
        "pagerank.window": 16 * n + 8 * e + 8 * v,
        # the edge columns and the ranks in, the ranks out
        "pagerank.fixpoint": 8 * e + 8 * v,
    }


def phase_pagerank(torch):
    """BASELINE config #4 (``bench.py:bench_pagerank``) and a scale pass on
    phase 5's corpus."""
    from gelly_streaming_tpu_torch import CountWindow, datasets
    from gelly_streaming_tpu_torch.library import pagerank

    src, dst = make_stream(PR_VERTICES, PR_EDGES, seed=PR_SEED)
    n_win = PR_EDGES // PR_WINDOW
    _pr_pass(_pr_stream(src, dst))  # warm
    runs = [_pr_pass(_pr_stream(src, dst)) for _ in range(STEADY_PASSES)]
    times = [r[2] for r in runs]
    mid = sorted(range(len(runs)), key=lambda i: times[i])[len(runs) // 2]
    pr, ems, sec, reads = runs[mid]
    iters = [int(e.iterations) for e in ems]
    cell = {"windows": len(ems), "edges_per_s": PR_EDGES / sec, "ms_per_window": sec / n_win * 1e3,
            "edges_per_s_all": [PR_EDGES / t for t in times], "pass_s": times,
            "iterations_per_window": iters, "host_reads_per_window": reads / len(ems),
            "l1_delta": [float(e.l1_delta) for e in ems]}
    say("pagerank cell " + json.dumps(cell))
    if len(ems) != n_win:
        raise AssertionError(f"pagerank ran {len(ems)} windows")

    t0 = time.perf_counter()
    want, want_iters = pagerank_oracle(src, dst, PR_WINDOW, PR_VERTICES)
    got = pr._carry[2].cpu().numpy().astype(np.float64)
    err = float(np.abs(got - want).max())
    it_diff = max(abs(a - b) for a, b in zip(iters, want_iters))
    ok = err <= PR_RANK_TOL and it_diff <= PR_ITER_SLACK and abs(got.sum() - 1) <= 1e-5
    say(f"pagerank vs the float64 scipy oracle ({time.perf_counter() - t0:.1f} s): max abs rank "
        f"error {err:.3e} (tol {PR_RANK_TOL:g}), iterations port {iters} oracle {want_iters} "
        f"(tol +-{PR_ITER_SLACK}), rank sum {got.sum():.7f}: {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("config #4 PageRank disagrees with the float64 oracle")
    cell.update(max_abs_rank_err=err, oracle_iterations=want_iters)

    pr4, ems4, sec4, _ = _pr_pass(_pr_stream(src, dst), superbatch=4)
    err4 = float((pr4._carry[2] - pr._carry[2]).abs().max())
    say(f"pagerank superbatch 4: {sec4 * 1e3 / len(ems4):.2f} ms a window, iterations "
        f"{[int(e.iterations) for e in ems4]}, max abs rank difference to superbatch 1 "
        f"{err4:.3e} (tol {PR_K4_TOL:g}): {'ok' if err4 <= PR_K4_TOL else 'FAIL'}")
    if not err4 <= PR_K4_TOL or len(ems4) != n_win:
        raise AssertionError("PageRank with superbatch 4 disagrees with superbatch 1")
    cell["superbatch4_max_abs_diff"] = err4

    # the scale pass: the livejournal surrogate's binary cache, 16 windows
    path, _ = datasets.ensure_corpus(CC_CORPUS)
    spec = datasets.CORPORA[CC_CORPUS]
    bin_path = datasets.binary_cache(path)
    stream = datasets.stream_file(bin_path, window=CountWindow(CC_WINDOW),
                                  vertex_dict=datasets.IdentityDict(CC_ID_BOUND),
                                  prefetch_depth=2, device="cuda")
    prs, ems_s, sec_s, reads_s = _pr_pass(stream)
    n_edges = spec.surrogate_edges
    rs, rd = rmat_oracle_edges(n_edges, int(spec.surrogate_vscale).bit_length() - 1)
    t1 = time.perf_counter()
    want_s, want_iters_s = pagerank_oracle(rs, rd, CC_WINDOW, CC_ID_BOUND)
    got_s = prs._carry[2].cpu().numpy().astype(np.float64)
    err_s = float(np.abs(got_s - want_s).max())
    iters_s = [int(e.iterations) for e in ems_s]
    scale = {"windows": len(ems_s), "edges_per_s": n_edges / sec_s,
             "ms_per_window": sec_s / len(ems_s) * 1e3, "iterations_per_window": iters_s,
             "oracle_iterations": want_iters_s, "host_reads_per_window": reads_s / len(ems_s),
             "max_abs_rank_err": err_s}
    say(f"pagerank scale pass ({CC_CORPUS} surrogate, {n_edges} edges, oracle "
        f"{time.perf_counter() - t1:.1f} s) " + json.dumps(scale))
    if len(ems_s) != n_edges // CC_WINDOW or not err_s <= PR_RANK_TOL:
        raise AssertionError("the PageRank scale pass disagrees with the float64 oracle")
    cell["scale"] = scale
    cell["profile"] = profile_cell(
        torch, "pagerank", lambda: len(_pr_pass(_pr_stream(src, dst))[1]), PR_STEPS,
        pr_step_bytes(PR_WINDOW, PR_EDGES * (n_win + 1) // (2 * n_win), PR_VERTICES))
    return cell


def _bip_stream(path_or_cols, device="cuda"):
    from gelly_streaming_tpu_torch import CountWindow, SimpleEdgeStream, datasets

    if isinstance(path_or_cols, str):
        return datasets.stream_file(path_or_cols, window=CountWindow(CC_WINDOW),
                                    vertex_dict=datasets.IdentityDict(CC_ID_BOUND),
                                    prefetch_depth=2, device=device)
    return SimpleEdgeStream(path_or_cols, window=CountWindow(CC_WINDOW),
                            vertex_dict=datasets.IdentityDict(CC_ID_BOUND), device=device)


def _bip_pass(source, carry="auto", superbatch=1, windows=None):
    """One pass of ``bench_bipartiteness_e2e``: the emissions (all, or the
    first ``windows``), seconds, the carry, host reads."""
    from gelly_streaming_tpu_torch.library import BipartitenessCheck
    from gelly_streaming_tpu_torch.summaries import labels

    agg = BipartitenessCheck(carry=carry, superbatch=superbatch)
    labels.HOST_READS = 0
    t0 = time.perf_counter()
    kept = []
    it = _bip_stream(source).aggregate(agg)
    for c in it:
        kept.append(c)
        if windows and len(kept) == windows:
            it.close()
            break
    agg.sync()
    return kept, time.perf_counter() - t0, agg._bp_mode, labels.HOST_READS


def bipartite_oracle(src, dst, n):
    """Bipartite iff no seen vertex's two cover nodes share a component of
    the 2n-node signed double cover (scipy's connected components)."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components

    u = np.concatenate([src, src + n])
    w = np.concatenate([dst + n, dst])
    g = coo_matrix((np.ones(len(u), np.int8), (u, w)), shape=(2 * n, 2 * n))
    _, comp = connected_components(g, directed=True, connection="weak")
    seen = np.zeros(n, bool)
    seen[src] = True
    seen[dst] = True
    v = np.nonzero(seen)[0]
    return not bool(np.any(comp[v] == comp[v + n]))


def _coloring_ok(cand, src, dst):
    """Whether a bipartite emission's components are a proper 2-coloring of
    the edges: both ends in one component, on opposite sides."""
    col = cand.coloring()
    if col is None:
        return False
    ids, comp, sign = col
    c = np.full(CC_ID_BOUND, -1, np.int64)
    g = np.zeros(CC_ID_BOUND, bool)
    c[ids] = comp
    g[ids] = sign
    return bool(np.all(c[src] >= 0) and np.all(c[src] == c[dst]) and np.all(g[src] != g[dst]))


def cover_step_bytes(t, n, v):
    """Bytes of the signed-cover window step for ``n`` edges touching ``t``
    vertices over ``v`` base vertices: the CC forest step's
    (``cc_step_bytes``) over both cover halves, the 2v-entry forest copied
    once."""
    return {"bip.cover_step": 2 * 21 * t + 2 * (8 * n + 16 * t) + 16 * v + 2 * 17 * t}


def phase_bipartiteness(torch):
    """``bench.py:bench_bipartiteness_e2e`` on phase 6's binary cache."""
    from gelly_streaming_tpu_torch import datasets

    path, _ = datasets.ensure_corpus(CC_CORPUS)
    spec = datasets.CORPORA[CC_CORPUS]
    n_edges = spec.surrogate_edges
    bin_path = datasets.binary_cache(path)
    _bip_pass(bin_path)  # warm
    runs = [_bip_pass(bin_path) for _ in range(STEADY_PASSES)]
    times = [r[1] for r in runs]
    mid = sorted(range(len(runs)), key=lambda i: times[i])[len(runs) // 2]
    ems, sec, mode, reads = runs[mid]
    cell = {"windows": len(ems), "edges_per_s": n_edges / sec,
            "ms_per_window": sec / len(ems) * 1e3,
            "edges_per_s_all": [n_edges / t for t in times], "pass_s": times, "carry": mode,
            "host_reads_per_window": reads / len(ems)}
    say("bipartiteness cell " + json.dumps(cell))
    if mode != "forest" or len(ems) != n_edges // CC_WINDOW:
        raise AssertionError(f"bipartiteness ran carry {mode} over {len(ems)} windows")

    src, dst = rmat_oracle_edges(n_edges, int(spec.surrogate_vscale).bit_length() - 1)
    t0 = time.perf_counter()
    want = [bipartite_oracle(src[:CC_WINDOW], dst[:CC_WINDOW], CC_ID_BOUND),
            bipartite_oracle(src, dst, CC_ID_BOUND)]
    got = [ems[0].success, ems[-1].success]
    say(f"bipartiteness vs scipy on the double cover ({time.perf_counter() - t0:.1f} s): window 0 "
        f"and last: port {got}, scipy {want}: {'equal' if got == want else 'FAIL'}")
    if got != want:
        raise AssertionError("the bipartiteness verdict disagrees with scipy")
    del ems, runs

    # the same edges mapped to (u & ~1, v | 1): bipartite by construction
    bsrc = (src & ~1).astype(np.int32)
    bdst = (dst | 1).astype(np.int32)
    ems_b, sec_b, mode_b, reads_b = _bip_pass((bsrc, bdst))
    col_ok = _coloring_ok(ems_b[0], bsrc[:CC_WINDOW], bdst[:CC_WINDOW])
    verdict = ems_b[-1].success
    say(f"bipartiteness on (u & ~1, v | 1) ({sec_b * 1e3 / len(ems_b):.1f} ms a window, carry "
        f"{mode_b}, {reads_b / len(ems_b):.1f} host reads a window): last verdict {verdict}, "
        f"window 0 a proper 2-coloring: {col_ok}")
    if not (verdict and col_ok):
        raise AssertionError("the bipartite-by-construction stream was not found bipartite")
    cell["mapped"] = {"ms_per_window": sec_b * 1e3 / len(ems_b), "bipartite": verdict,
                      "host_reads_per_window": reads_b / len(ems_b)}
    del ems_b

    # the other carries and the superbatch on the first windows, both streams
    for source, label in ((bin_path, "rmat"), ((bsrc, bdst), "mapped")):
        base = _bip_pass(source, carry="forest", windows=CC_PREFIX_WINDOWS)[0]
        base_v = [c.success for c in base]
        base_c = [c.coloring() for c in base]
        for carry, k in (("host", 1), ("dense", 1), ("forest", CC_PREFIX_WINDOWS)):
            ems_k, sec_k, mode_k, _ = _bip_pass(source, carry=carry, superbatch=k,
                                                windows=CC_PREFIX_WINDOWS)
            same = [c.success for c in ems_k] == base_v and mode_k == carry
            if same and label == "mapped":
                same = all(np.array_equal(a[0], b[0]) and np.array_equal(a[2], b[2])
                           for a, b in zip(base_c, (c.coloring() for c in ems_k)))
            say(f"bipartiteness prefix {CC_PREFIX_WINDOWS} windows ({label}), carry {mode_k} "
                f"superbatch {k}: {sec_k * 1e3 / len(ems_k):.1f} ms a window, "
                f"{'equal to the forest carry' if same else 'FAIL'}")
            if not same:
                raise AssertionError(f"bipartiteness carry {carry} (superbatch {k}) disagrees")
    touched = np.unique(np.concatenate([src[:CC_WINDOW], dst[:CC_WINDOW]])).size
    cell["profile"] = profile_cell(
        torch, "bipartiteness", lambda: len(_bip_pass(bin_path, windows=CC_PREFIX_WINDOWS)[0]),
        BIP_STEPS, cover_step_bytes(touched, CC_WINDOW, CC_ID_BOUND))
    return cell


def _etc_batches(src, dst, device="cuda"):
    from gelly_streaming_tpu_torch import CountWindow, SimpleEdgeStream
    from gelly_streaming_tpu_torch.datasets import IdentityDict
    from gelly_streaming_tpu_torch.library import ExactTriangleCount

    stream = SimpleEdgeStream((src, dst), window=CountWindow(ETC_WINDOW),
                              vertex_dict=IdentityDict(ETC_VERTICES), device=device)
    etc = ExactTriangleCount()
    return etc, etc.run(stream)


def oracle_prefix_triangles(src, dst, n):
    """Total and per-vertex triangle counts of the deduplicated undirected
    simple graph of the edges, by scipy: ``(A @ A).multiply(A)``."""
    from scipy.sparse import csr_matrix

    u = np.minimum(src, dst).astype(np.int64)
    v = np.maximum(src, dst).astype(np.int64)
    ok = u != v
    key = np.unique(u[ok] * n + v[ok])
    u, v = key // n, key % n
    a = csr_matrix((np.ones(2 * len(u), np.int64), (np.concatenate([u, v]),
                                                    np.concatenate([v, u]))), shape=(n, n))
    per = np.asarray((a @ a).multiply(a).sum(axis=1)).ravel() // 2
    return int(per.sum() // 3), per


def etc_step_bytes(n, p, v):
    """Bytes of the exact counter's steps per window of ``n`` slots, ``p``
    packed entries, ``v`` vertices: each input read once, each output
    written once."""
    return {
        # src, dst, mask and the packed columns in; the packed columns,
        # row_ptr and the four query columns out
        "tri.packed_prep": 9 * n + 12 * p + 12 * p + 4 * v + 13 * n,
        # pn, pr, row_ptr, the query columns and the counts in; counts out
        "tri.packed_count": 8 * p + 4 * v + 13 * n + 8 * v,
    }


def phase_exact_triangles(torch):
    """``bench.py:bench_exact_triangles``: batches left unread until the
    pass ends, then every window's running total and per-vertex counts held
    exactly against scipy on the prefix graph."""
    src, dst = make_stream(ETC_VERTICES, ETC_EDGES, seed=ETC_SEED)
    kept = []

    def one_pass():
        etc, it = _etc_batches(src, dst)
        kept[:] = list(it)
        etc.sync()
        return len(kept)

    cell = timed_passes(torch, one_pass, ETC_EDGES)
    n, in_loop, after = count_syncs(torch, _etc_batches(src, dst)[1])
    cell.update(host_syncs_in_loop=in_loop, host_syncs_per_window=in_loop / n,
                host_syncs_after_loop=after)
    say("exact triangles cell " + json.dumps(cell))
    if in_loop != 0 or cell["windows"] != ETC_EDGES // ETC_WINDOW:
        raise AssertionError(f"the exact counter ran {cell['windows']} windows with {in_loop} "
                             "host syncs in the loop")
    t0 = time.perf_counter()
    counts = np.zeros(ETC_VERTICES, np.int64)
    total = 0
    ok = True
    totals = []
    for i, batch in enumerate(kept):
        for vid, c in batch:
            if vid == -1:
                total = c
            else:
                counts[vid] = c
        want_total, want_per = oracle_prefix_triangles(src[: (i + 1) * ETC_WINDOW],
                                                       dst[: (i + 1) * ETC_WINDOW], ETC_VERTICES)
        ok = ok and total == want_total and np.array_equal(counts, want_per)
        totals.append((total, want_total))
    say(f"exact triangles vs scipy, every window ({time.perf_counter() - t0:.1f} s): running "
        f"totals (port, scipy) {totals}, per-vertex counts {'exact' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the exact triangle counts disagree with scipy")
    cell["totals"] = [t for t, _ in totals]
    etc, it = _etc_batches(src, dst)
    list(it)
    cell["profile"] = profile_cell(torch, "exact triangles", one_pass, ETC_STEPS,
                                   etc_step_bytes(ETC_WINDOW, etc._n_packed, ETC_VERTICES))
    return cell


def _spanner_run(src, dst, k, window, n_vertices, device="cuda", expected=0):
    from gelly_streaming_tpu_torch import CountWindow, SimpleEdgeStream
    from gelly_streaming_tpu_torch.datasets import IdentityDict
    from gelly_streaming_tpu_torch.library import DeviceSpanner

    stream = SimpleEdgeStream((src, dst), window=CountWindow(window),
                              vertex_dict=IdentityDict(n_vertices), device=device)
    sp = DeviceSpanner(k=k, expected_edges=expected)
    return sp, sp.run(stream)


def _spanner_edges(sp):
    su, sv = sp._host_columns()
    key = (su.astype(np.int64) << 32) | sv.astype(np.int64)
    return np.sort(key)


def spanner_check_2hops(src, dst, keys, n):
    """Every distinct stream edge not in the spanner has a spanner path of
    at most 2 hops (the spanner rows of its ends share a vertex), by sparse
    products over chunks of the dropped edges. Returns (dropped, bad)."""
    from scipy.sparse import csr_matrix

    u = np.minimum(src, dst).astype(np.int64)
    v = np.maximum(src, dst).astype(np.int64)
    ok = u != v
    cand = np.unique((u[ok] << 32) | v[ok])
    dropped = cand[~np.isin(cand, keys)]
    su, sv = keys >> 32, keys & 0xFFFFFFFF
    s = csr_matrix((np.ones(2 * len(su), np.int8), (np.concatenate([su, sv]),
                                                    np.concatenate([sv, su]))), shape=(n, n))
    du, dv = dropped >> 32, dropped & 0xFFFFFFFF
    bad = 0
    for a in range(0, len(dropped), 1 << 14):
        rows = s[du[a:a + (1 << 14)]].multiply(s[dv[a:a + (1 << 14)]])
        bad += int(np.sum(np.asarray(rows.sum(axis=1)).ravel() == 0))
    return len(dropped), bad


def spanner_step_bytes(q, p, v):
    """Bytes of the k = 2 spanner steps per window of ``q`` first-seen
    queries over ``p`` packed entries and ``v`` vertices."""
    return {
        # pn, row_ptr, the queries and their class selection in; the
        # accumulator out (per window, all classes)
        "spanner.k2": 4 * p + 4 * v + 12 * q + q,
        # the packed columns and the queries in, the packed columns out
        "spanner.k2_merge": 12 * p + 10 * q + 12 * p,
    }


def phase_spanner(torch):
    """``bench.py:bench_spanner``: k = 2 with ``expected_edges``, the edge
    set against the port on the CPU and the 2-hop guarantee; then k = 3 on
    a prefix, against the CPU."""
    src, dst = make_stream(SP_VERTICES, SP_EDGES, seed=SP_SEED)

    def one_pass():
        sp, it = _spanner_run(src, dst, 2, SP_WINDOW, SP_VERTICES, expected=SP_EDGES)
        n = sum(1 for _ in it)
        sp.sync()
        return n

    cell = timed_passes(torch, one_pass, SP_EDGES)
    n, in_loop, after = count_syncs(
        torch, _spanner_run(src, dst, 2, SP_WINDOW, SP_VERTICES, expected=SP_EDGES)[1])
    cell.update(host_syncs_in_loop=in_loop, host_syncs_per_window=in_loop / n,
                host_syncs_after_loop=after)
    say("spanner cell " + json.dumps(cell))
    if in_loop != 0 or cell["windows"] != SP_EDGES // SP_WINDOW:
        raise AssertionError("the device spanner read the device in its window loop")
    sp, it = _spanner_run(src, dst, 2, SP_WINDOW, SP_VERTICES, expected=SP_EDGES)
    list(it)
    got = _spanner_edges(sp)
    t0 = time.perf_counter()
    sp_c, it_c = _spanner_run(src, dst, 2, SP_WINDOW, SP_VERTICES, device="cpu",
                              expected=SP_EDGES)
    list(it_c)
    want = _spanner_edges(sp_c)
    cpu_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    dropped, bad = spanner_check_2hops(src, dst, got, SP_VERTICES)
    same = np.array_equal(got, want)
    say(f"spanner k=2: {len(got)} edges kept, {dropped} dropped, the port on the CPU "
        f"({cpu_s:.1f} s) {'equal' if same else 'FAIL'}, dropped edges without a 2-hop path "
        f"{bad} ({time.perf_counter() - t1:.1f} s)")
    if not same or bad:
        raise AssertionError("the device spanner disagrees with the CPU or breaks the 2-hop bound")
    cell.update(kept=int(len(got)), dropped=dropped)

    # k = 3: the 2^18-edge prefix (one window), then a smaller stream in
    # four windows, so the frontier search meets a spanner
    k3 = {}
    for label, (s3, d3, w3, v3) in {
        "prefix": (src[:SP_WINDOW], dst[:SP_WINDOW], SP_WINDOW, SP_VERTICES),
        "windows": (src[:SP3_EDGES] % SP3_VERTICES, dst[:SP3_EDGES] % SP3_VERTICES,
                    SP3_EDGES // 4, SP3_VERTICES),
    }.items():
        res = {}
        for device in ("cuda", "cpu"):
            t2 = time.perf_counter()
            sp3, it3 = _spanner_run(s3, d3, 3, w3, v3, device=device)
            nw = sum(1 for _ in it3)
            sp3.sync()
            res[device] = (_spanner_edges(sp3), time.perf_counter() - t2, nw)
        same3 = np.array_equal(res["cuda"][0], res["cpu"][0])
        k3[label] = {"edges": len(s3), "windows": res["cuda"][2], "kept": int(len(res["cuda"][0])),
                     "card_s": res["cuda"][1], "cpu_s": res["cpu"][1], "equal": same3}
        say(f"spanner k=3 {label}: " + json.dumps(k3[label]))
        if not same3:
            raise AssertionError("the k=3 device spanner on the card disagrees with the CPU")
    cell["k3"] = k3
    q = SP_WINDOW  # at most the window's first-seen queries
    cell["profile"] = profile_cell(torch, "spanner", one_pass, SP_STEPS,
                                   spanner_step_bytes(q, 2 * len(got), SP_VERTICES))
    s3, d3 = src[:SP3_EDGES] % SP3_VERTICES, dst[:SP3_EDGES] % SP3_VERTICES

    def k3_pass():
        sp3, it3 = _spanner_run(s3, d3, 3, SP3_EDGES // 4, SP3_VERTICES)
        n3 = sum(1 for _ in it3)
        sp3.sync()
        return n3

    cell["profile_k3"] = profile_cell(
        torch, "spanner k=3", k3_pass, SP3_STEPS,
        k_reach_bytes(k3["windows"]["kept"] // 2, SP3_EDGES // 4))
    return cell


def k_reach_bytes(s, q):
    """Bytes of the k >= 3 search and append per window: the spanner
    columns at the window's start (``s`` edges, taken as half the final
    spanner) and the ``q`` queries in, the verdicts out; the append reads
    the columns and the queries and writes the new columns."""
    return {"spanner.k_reach": 8 * s + 10 * q, "spanner.append": 8 * s + 9 * q + 8 * s}

# --------------------------------------------------------------------- #
# Slice 5b: the device vertex dictionary, the estimators, iterative CC
# --------------------------------------------------------------------- #
def dict_encode_bytes(n, kcap):
    """Bytes of one ``dict.encode`` of a window of ``n`` edges into a table
    of ``kcap`` keys: the raw src and dst columns read and their compact
    ids written (int32), the table's keys, ids and reverse table read once
    and written once (int32 each)."""
    return 8 * n + 8 * n + 12 * kcap + 12 * kcap


def _de_stream(path, form, prefetch=2):
    from gelly_streaming_tpu_torch import CountWindow, datasets

    bound = form == "id_bound"
    return datasets.stream_file(
        path, window=CountWindow(CC_WINDOW), device_encode=True,
        min_vertex_capacity=CC_ID_BOUND if bound else DE_HINT, dense_ids=bound,
        prefetch_depth=prefetch, device="cuda",
    )


def _de_pass(torch, path, form, prefetch=2):
    """One pass of ``bench_cc_e2e_device`` (``id_bound``: the binary cache)
    or ``bench_cc_e2e_device_text`` (``growth``: the text file), ``sync()``
    inside the timed region."""
    from gelly_streaming_tpu_torch.library import ConnectedComponents
    from gelly_streaming_tpu_torch.ops import device_dict
    from gelly_streaming_tpu_torch.summaries import labels

    stream = _de_stream(path, form, prefetch)
    agg = ConnectedComponents()
    labels.HOST_READS = labels.FIXPOINT_TURNS = 0
    device_dict.ENCODES = 0
    lat, last = [], None
    t0 = last_t = time.perf_counter()
    for last in stream.aggregate(agg):
        now = time.perf_counter()
        lat.append(now - last_t)
        last_t = now
    agg.sync()
    dt = time.perf_counter() - t0
    lat_ms = np.asarray(lat) * 1e3
    n_win = len(lat)
    return {
        "windows": n_win, "seconds": dt,
        "p50_ms": float(np.percentile(lat_ms, 50)), "p95_ms": float(np.percentile(lat_ms, 95)),
        "carry": agg._cc_mode, "encodes": device_dict.ENCODES,
        "host_reads_per_window": labels.HOST_READS / n_win,
        "table_capacity": stream.vertex_dict.capacity,
    }, last, stream


def _raw_partition_ok(last, vdict, want, seen):
    """The emission's partition decoded to raw ids against scipy's
    (``want``: each vertex's least raw id in its component; ``seen``: the
    raw ids seen, ascending)."""
    ids, lab = last.labels()
    raw = vdict.decode(ids)
    uniq, inv = np.unique(lab, return_inverse=True)
    least = np.full(len(uniq), np.iinfo(np.int64).max, np.int64)
    np.minimum.at(least, inv, raw)
    order = np.argsort(raw)
    ok = np.array_equal(raw[order], seen) and np.array_equal(least[inv][order], want[seen])
    return ok, len(seen), len(uniq)


def phase_device_encode(torch):
    from torch.profiler import ProfilerActivity, profile

    from gelly_streaming_tpu_torch import CountWindow, datasets, native
    from gelly_streaming_tpu_torch.core.vertexdict import VertexDict
    from gelly_streaming_tpu_torch.obs import trace

    path, _ = datasets.ensure_corpus(CC_CORPUS)
    spec = datasets.CORPORA[CC_CORPUS]
    n_edges = spec.surrogate_edges
    bin_path = datasets.binary_cache(path)
    src, dst = rmat_oracle_edges(n_edges, int(spec.surrogate_vscale).bit_length() - 1)
    want = oracle_labels(src, dst, CC_ID_BOUND)
    seen = np.unique(np.concatenate([src, dst]))
    cells = {}
    for form, fpath in (("id_bound", bin_path), ("growth", path)):
        warm, _, _ = _de_pass(torch, fpath, form)
        passes = [_de_pass(torch, fpath, form) for _ in range(CC_STEADY_PASSES)]
        results = [p[0] for p in passes]
        for r in results:
            r["edges_per_s"] = n_edges / r["seconds"]
        mid = sorted(range(len(results)), key=lambda i: results[i]["edges_per_s"])[1]
        cell = dict(results[mid])
        cell["edges_per_s_all"] = [r["edges_per_s"] for r in results]
        cell["warm_seconds"] = warm["seconds"]
        if cell["windows"] != n_edges // CC_WINDOW or cell["encodes"] != cell["windows"]:
            raise AssertionError(f"device-encode {form}: {cell['windows']} windows, "
                                 f"{cell['encodes']} encodes")
        # correctness: the last window's partition in raw ids against scipy
        last, stream = passes[mid][1], passes[mid][2]
        vd = stream.vertex_dict
        t1 = time.perf_counter()
        ok, n_seen, n_comp = _raw_partition_ok(last, vd, want, seen)
        probe = int(vd._state["probe"])
        cell.update(components=n_comp, vertices_seen=n_seen, probe=probe)
        say(f"device-encode {form} vs scipy (last window, {n_seen} vertices): components "
            f"{n_comp}, {'exact' if ok else 'FAIL'}; probe {probe} "
            f"({time.perf_counter() - t1:.1f} s)")
        if not ok or probe < 0 or probe != n_seen:
            raise AssertionError(f"device-encode {form} disagrees with scipy or overflowed")
        # window 0's compact ids against the port's host VertexDict
        b0 = next(iter(_de_stream(fpath, form, prefetch=0).blocks()))
        hs, hd = VertexDict().encode_pair(src[:CC_WINDOW], dst[:CC_WINDOW])
        same0 = (np.array_equal(b0.src[:CC_WINDOW].cpu().numpy(), hs)
                 and np.array_equal(b0.dst[:CC_WINDOW].cpu().numpy(), hd))
        # host syncs of the ingest's window loop (parse, upload, encode)
        n, in_loop, after = count_syncs(torch, _de_stream(fpath, form, prefetch=0).blocks())
        cell.update(window0_ids_equal_host_dict=same0, host_syncs_in_loop=in_loop,
                    host_syncs_after_loop=after)
        say(f"device-encode {form} cell " + json.dumps(cell))
        if not same0 or in_loop != 0 or n != cell["windows"]:
            raise AssertionError(f"device-encode {form}: window 0 ids equal {same0}, "
                                 f"{in_loop} host syncs in the ingest loop")
        # where the time goes: one profiled pass on the main thread (no
        # prefetch: the producer thread's ranges are not in the profile)
        trace.enable(torch_annotations=True)
        try:
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t2 = time.perf_counter()
                r, _, st = _de_pass(torch, fpath, form, prefetch=0)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t2
        finally:
            trace.disable()
        say(f"device-encode {form} profile ({r['windows']} windows, no prefetch, "
            f"{wall * 1e3:.1f} ms):")
        cell["busy_share"] = profile_pass(torch, lambda: None, wall, prof=prof)
        steps = step_rows(prof, DE_STEPS, r["windows"],
                          {"dict.encode": dict_encode_bytes(CC_WINDOW, st.vertex_dict.capacity)})
        say(f"device-encode {form} steps (device ms, launches and bytes' bound per window; "
            "dict.encode bound at the final table capacity) " + json.dumps(steps))
        cell["steps"] = steps
        cells[form] = cell
        del passes

    # sparse arbitrary int32 ids: the corpus's first windows through an
    # injective affine map mod 2^31 - 1, against the host dict
    m = DE_SPARSE_WINDOWS * CC_WINDOW
    ms = (src[:m] * 48271 + 12345) % DE_SPARSE_PRIME
    md = (dst[:m] * 48271 + 12345) % DE_SPARSE_PRIME
    sparse_path = os.path.join(os.path.dirname(path), "smoke_sparse_ids.txt")
    native.write_edge_file(sparse_path, ms, md)
    stream = datasets.stream_file(sparse_path, window=CountWindow(CC_WINDOW), device_encode=True,
                                  dense_ids=False, min_vertex_capacity=DE_HINT, device="cuda")
    host = VertexDict()
    ok = True
    for i, b in enumerate(stream.blocks()):
        a, z = i * CC_WINDOW, (i + 1) * CC_WINDOW
        hs, hd = host.encode_pair(ms[a:z], md[a:z])
        ok &= (np.array_equal(b.src[:CC_WINDOW].cpu().numpy(), hs)
               and np.array_equal(b.dst[:CC_WINDOW].cpu().numpy(), hd))
    vd = stream.vertex_dict
    ok &= np.array_equal(vd.raw_ids(), host.raw_ids())
    say(f"device-encode sparse int32 ids ({m} edges, {len(host)} ids up to "
        f"{int(max(ms.max(), md.max()))}, table {vd.capacity}): "
        f"{'equal to the host dict' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the device dictionary disagrees with the host dict on sparse ids")
    os.remove(sparse_path)
    return cells


def _simple_stream(n_vertices, n_edges, seed):
    """``make_stream`` made duplicate-free and loop-free: each canonical
    pair's first arrival."""
    src, dst = make_stream(n_vertices, n_edges, seed=seed)
    s, d = src.astype(np.int64), dst.astype(np.int64)
    key = np.where(s != d, np.minimum(s, d) * n_vertices + np.maximum(s, d), -1)
    _, first = np.unique(key, return_index=True)
    first = np.sort(first[key[first] >= 0])
    return src[first], dst[first]


def exact_triangles(src, dst, n):
    """scipy: triangles of the simple graph, with edges oriented from the
    lower (degree, id) rank to the higher, as ``sum((L @ L) * L)``."""
    from scipy.sparse import csr_matrix

    s, d = src.astype(np.int64), dst.astype(np.int64)
    deg = np.bincount(np.concatenate([s, d]), minlength=n)
    rank = np.empty(n, np.int64)
    rank[np.lexsort((np.arange(n), deg))] = np.arange(n)
    up = rank[s] < rank[d]
    a, b = np.where(up, s, d), np.where(up, d, s)
    lo = csr_matrix((np.ones(len(a)), (a, b)), shape=(n, n))
    return int(round((lo @ lo).multiply(lo).sum()))


def sampling_window_bytes(e, k):
    """Bytes of one vectorized window update: the window's src, dst (int32)
    and mask read; the three [k] uniforms read; the sample columns (three
    int32, two bool) read and written."""
    return 9 * e + 12 * k + 2 * 14 * k


def sampling_scan_bytes(e, k):
    """Bytes of the scan over a window of ``e`` edges: per edge the two [k]
    uniforms read and the sample columns (three int32, two bool) read and
    written."""
    return e * (8 * k + 2 * 14 * k)


def _recording(cls, device):
    """An estimator class that records its uniforms and its state after
    every window (``replay`` feeds recorded uniforms back instead)."""

    class Recording(cls):
        def __init__(self, *a, replay=None, **kw):
            super().__init__(*a, device=device, **kw)
            self.drawn = [] if replay is None else list(replay)
            self.replay = replay is not None
            self.states = []

        def _draw(self, *shape):
            if self.replay:
                return self.drawn.pop(0).to(self.device)
            u = super()._draw(*shape)
            self.drawn.append(u.cpu())
            return u

        def _window(self, block, vdict):
            n = super()._window(block, vdict)
            self.states.append({f: v.cpu().numpy() for f, v in self._state.items()})
            return n

    return Recording


def _states_equal(a, b):
    return len(a) == len(b) and all(
        all(np.array_equal(x[f], y[f]) for f in x) for x, y in zip(a, b))


def phase_sampling(torch):
    from gelly_streaming_tpu_torch import CountWindow
    from gelly_streaming_tpu_torch.library import sampling

    src, dst = _simple_stream(SMP_VERTICES, SMP_EDGES, SMP_SEED)
    m, v = len(src), SMP_VERTICES
    t0 = time.perf_counter()
    tri = exact_triangles(src, dst, v)
    p = tri / (m * (v - 2))
    k = 1
    while k * p < SMP_TARGET_BETA and k < SMP_MAX_K:
        k *= 2
    say(f"sampling stream: {m} distinct edges over {v} vertices, {tri} triangles (scipy, "
        f"{time.perf_counter() - t0:.1f} s); k = {k} samples, E[beta_sum] = {k * p:.1f}")
    edges = (src, dst)
    cls = _recording(sampling.BroadcastTriangleCount, "cuda")

    def run(c=cls, **kw):
        est = c(vertex_count=v, samples=k, window=CountWindow(SMP_WINDOW), seed=SMP_SEED, **kw)
        out = list(est.run(edges))
        torch.cuda.synchronize()
        return est, out

    def one_pass():
        # the plain estimator: no recording, no per-window copies
        run(sampling.BroadcastTriangleCount, device="cuda")
        return -(-m // SMP_WINDOW)

    cell = timed_passes(torch, one_pass, m)
    est, out = run()
    se = m * (v - 2) / k * np.sqrt(k * p * (1 - p))
    final = out[-1][1] if out else 0
    cell.update(samples=k, triangles=tri, estimate=final, beta=est._last_beta,
                standard_error=se, emissions=len(out))
    ok = abs(final - tri) <= SMP_SE * se and out[-1][0] == m
    say(f"sampling estimate {final} against {tri} (scipy): {abs(final - tri) / se:.2f} "
        f"standard errors, {'within' if ok else 'OUTSIDE'} {SMP_SE}")
    if not ok:
        raise AssertionError("the triangle estimate is outside its bound")
    # every window's state against the CPU fed the same uniforms
    t1 = time.perf_counter()
    cpu = _recording(sampling.BroadcastTriangleCount, "cpu")
    est_c, out_c = run(cpu, replay=est.drawn)
    same = _states_equal(est.states, est_c.states) and out == out_c
    inc, out_i = run(_recording(sampling.IncidenceSamplingTriangleCount, "cuda"))
    same_i = out_i == out and _states_equal(inc.states, est.states)
    say(f"sampling vectorized: {len(est.states)} windows equal to the CPU fed the same "
        f"uniforms: {same} ({time.perf_counter() - t1:.1f} s); the incidence estimator "
        f"equal: {same_i}")
    if not (same and same_i):
        raise AssertionError("the vectorized estimator on the card disagrees with the CPU")

    # the scan form: an id space above the vectorized limit
    ss, sd = src[:SMP_SCAN_EDGES], dst[:SMP_SCAN_EDGES]

    def scan_run(c, **kw):
        e = c(vertex_count=SMP_SCAN_VERTICES, samples=SMP_SCAN_K,
              window=CountWindow(SMP_SCAN_EDGES), seed=SMP_SEED, **kw)
        t = time.perf_counter()
        o = list(e.run((ss, sd)))
        torch.cuda.synchronize()
        return e, o, time.perf_counter() - t

    scan_run(cls)  # warm
    es, os_, secs = scan_run(cls)
    ec, oc, _ = scan_run(_recording(sampling.BroadcastTriangleCount, "cpu"), replay=es.drawn)
    same_s = _states_equal(es.states, ec.states) and os_ == oc
    cell["scan"] = {"edges": SMP_SCAN_EDGES, "vertex_count": SMP_SCAN_VERTICES,
                    "samples": SMP_SCAN_K, "ms_per_edge": secs * 1e3 / SMP_SCAN_EDGES,
                    "equal_to_cpu": same_s}
    say("sampling scan " + json.dumps(cell["scan"]))
    if not same_s:
        raise AssertionError("the scan estimator on the card disagrees with the CPU")
    say("sampling cell " + json.dumps({f: x for f, x in cell.items() if f != "profile"}))
    cell["profile"] = profile_cell(torch, "sampling", one_pass, SMP_STEPS,
                                   {"sampling.window": sampling_window_bytes(SMP_WINDOW, k)})

    def scan_pass():
        scan_run(sampling.BroadcastTriangleCount, device="cuda")
        return 1

    cell["profile_scan"] = profile_cell(
        torch, "sampling scan", scan_pass, ("sampling.scan",),
        {"sampling.scan": sampling_scan_bytes(SMP_SCAN_EDGES, SMP_SCAN_K)})
    return cell


def phase_iterative_cc(torch):
    from gelly_streaming_tpu_torch import CountWindow, SimpleEdgeStream, datasets, native
    from gelly_streaming_tpu_torch.library import IterativeConnectedComponents

    src, dst = make_stream(ICC_VERTICES, ICC_EDGES, seed=ICC_SEED)
    path = os.path.join(datasets.cache_dir(), "smoke_icc.txt")
    os.makedirs(datasets.cache_dir(), exist_ok=True)
    native.write_edge_file(path, src, dst)
    n_win = ICC_EDGES // ICC_WINDOW

    def streams():
        return {
            "incremental": SimpleEdgeStream(
                (src, dst), window=CountWindow(ICC_WINDOW),
                vertex_dict=datasets.IdentityDict(ICC_VERTICES), device="cuda"),
            "diff": datasets.stream_file(
                path, window=CountWindow(ICC_WINDOW), device_encode=True,
                min_vertex_capacity=ICC_VERTICES, device="cuda"),
        }

    def one_pass(name):
        icc = IterativeConnectedComponents()
        out = []
        for batch in icc.run(streams()[name]):
            out.append(batch)
            torch.cuda.synchronize()
        return icc, out

    got, times = {}, {}
    for name in ("incremental", "diff"):
        one_pass(name)  # warm
        t0 = time.perf_counter()
        icc, out = one_pass(name)
        times[name] = (time.perf_counter() - t0) * 1e3 / len(out)
        got[name] = (icc, out)
    labels = np.full(ICC_VERTICES, -1, np.int64)
    ok = all(got[n][0]._mode == n for n in got) and len(got["diff"][1]) == n_win
    for w in range(n_win):
        a, b = got["incremental"][1][w], got["diff"][1][w]
        ok &= a == b
        labels[a._v] = a._c
        z = (w + 1) * ICC_WINDOW
        want = oracle_labels(src[:z].astype(np.int64), dst[:z].astype(np.int64), ICC_VERTICES)
        seen = np.unique(np.concatenate([src[:z], dst[:z]]))
        ok &= np.array_equal(labels[seen], want[seen]) and int((labels >= 0).sum()) == len(seen)
    cell = {"windows": n_win, "ms_per_window": times,
            "modes": {n: got[n][0]._mode for n in got}, "emitted": [len(x) for x in got["diff"][1]],
            "equal": bool(ok)}
    say("iterative cc cell " + json.dumps(cell))
    if not ok:
        raise AssertionError("iterative CC: the paths disagree or differ from scipy")
    cell["profile"] = {
        name: profile_cell(torch, f"iterative cc {name}", lambda n=name: len(one_pass(n)[1]),
                           ICC_STEPS, {})
        for name in ("incremental", "diff")
    }
    os.remove(path)
    return cell



def main():
    import torch

    phase_device(torch)
    phase_build()
    main_err, rows = phase_kernels(torch)
    slice_result = phase_slice(torch, rows)
    phase_cc(torch)
    phase_degrees(torch)
    phase_triangles(torch)
    phase_neighborhood(torch)
    phase_pagerank(torch)
    phase_bipartiteness(torch)
    phase_exact_triangles(torch)
    phase_spanner(torch)
    phase_device_encode(torch)
    phase_sampling(torch)
    phase_iterative_cc(torch)
    kernel = {
        "name": "fused_sage_matmul",
        "variant": "tc",
        "route": "cuda",
        "source": "gelly_streaming_tpu_torch/csrc/fused_sage_matmul.cu",
        "replaces": "gelly_streaming_tpu/ops/pallas_kernels.py:51",
        "launches": slice_result["launches"],
        "max_abs_err": main_err,
        "ms": sum(r["kernel_ms"] for r in rows),
        "plain_ms": sum(r["plain_ms"] for r in rows),
        "bound_ms": sum(r["bound_ms"] for r in rows),
        "bound_by": "bytes",
        "library_ms": sum(r["library_ms"] for r in rows),
        "bound_share": sum(r["bound_ms"] for r in rows) / sum(r["kernel_ms"] for r in rows),
        "warm_ms": sum(r["warm"]["kernel_ms"] for r in rows),
        "per": f"window: {rows[0]['shape']} + {rows[1]['shape']}, bf16, cold L2",
        "status": "ported",
    }
    say(json.dumps({"kernels": [kernel]}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
