#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (gelly_streaming_tpu_torch) on one
NVIDIA card: build every kernel, hold each against its plain PyTorch
version, drive streaming GraphSAGE, streaming Connected Components, the
degree stream, window triangles and the neighborhood aggregations end to
end, and print the results.

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
9. a profile of one pass of phase 6 and one of phase 7, the device steps
   opened as ``record_function`` ranges: the top operations by device
   time, the busy share, device-to-host copies, peak memory, and each
   step's device ms, launches and byte bound per window.
10. a ``{"kernels": [...]}`` line, and last the ``{"ok": true, ...}`` line.

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

# phase 8: the seeded edge values of window 0, and the tolerance of its
# float results between the card and the CPU (relative to max(|x|, 1)):
# scatter-adds sum in another order on the card
NBR_SEED = 17
NBR_TOL = 1e-5

# the obs spans that open record_function ranges: device-side copies of
# them are ranges, not kernels
SPAN_PREFIXES = ("cc.", "window.", "engine.", "ingest.", "degree.", "tri.", "segment.",
                 "csr.")

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
