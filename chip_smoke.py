#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (gelly_streaming_tpu_torch) on one
NVIDIA card: build every kernel, hold each against its plain PyTorch
version, drive streaming GraphSAGE end to end, and print the results.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. device  — a CUDA card must be present; prints its name and power limit
   as ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``.
2. build   — compiles ``gelly_streaming_tpu_torch/csrc/*.cu`` with nvcc for
   sm_90a (one nvcc per source, started together).
3. kernels — ``fused_sage_matmul`` against ``fused_sage_matmul_plain`` on the
   card at V=100/F=48/O=72 and at the two layer shapes of BASELINE config
   #5, f32 and bf16, relu and none; then kernel, plain, library (cuBLAS
   ``addmm`` on pre-concatenated operands, timed here only) and bound
   times at the config #5 shapes.
4. slice   — config #5 streaming GraphSAGE through the port's entry points:
   ``SimpleEdgeStream`` with ``CountWindow(1 << 18)`` over
   ``IdentityDict(1 << 16)`` into ``StreamingGraphSAGE`` with a
   ``TableFeatureSource``, dims [128, 256, 128] in bf16, 4 windows (the
   edge accumulator crosses 2^18 -> 2^19 -> 2^20). The kernel's launch
   count must rise by exactly 2 per window; the last window's embeddings
   are held against a reference composed on the card from the plain
   functions; then edges/s, ms per window and where the time goes.
5. a ``{"kernels": [...]}`` line, and last the ``{"ok": true, ...}`` line.

TF32 is off for float32 matmuls (``torch.backends.cuda.matmul.allow_tf32 =
False``), so the plain version's f32 products are full f32.
"""

import json
import statistics
import subprocess
import time

import numpy as np

# BASELINE config #5 (bench.py: bench_graphsage_e2e)
N_VERTICES = 1 << 16
WINDOW = 1 << 18
N_WINDOWS = 4
DIMS = [128, 256, 128]
STREAM_SEED = 13

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


def cuda_ms(torch, fn, iters=20, warmup=3):
    """Mean device time of ``fn`` over ``iters`` calls, by CUDA events."""
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


def phase_kernels(torch):
    from gelly_streaming_tpu_torch.ops import sage_kernels as sk

    gen = torch.Generator(device="cuda").manual_seed(0)
    shapes = [(100, 48, 72), (N_VERTICES, DIMS[0], DIMS[1]), (N_VERTICES, DIMS[1], DIMS[2])]
    main_err = 0.0
    for v, f, o in shapes:
        for dtype_name in ("float32", "bfloat16"):
            dtype = getattr(torch, dtype_name)
            ops = _operands(torch, gen, v, f, o, dtype)
            for act in ("relu", "none"):
                got = sk.fused_sage_matmul(*ops, act)
                torch.cuda.synchronize()
                want = sk.fused_sage_matmul_plain(*ops, act)
                err = (got.float() - want.float()).abs().max().item()
                ref = want.float().abs().max().item()
                tol = KERNEL_TOL[dtype_name] * max(ref, 1.0)
                ok = err <= tol and bool(torch.isfinite(got).all())
                say(f"kernel vs plain [{v},{f}]x[{f},{o}] {dtype_name} {act}: "
                    f"max_abs_err {err:.3e} (max|ref| {ref:.3e}, tol {tol:.3e}) "
                    f"{'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError(f"fused_sage_matmul disagrees with its plain version "
                                         f"at [{v},{f}]x[{f},{o}] {dtype_name} {act}")
                if v == N_VERTICES and dtype_name == "bfloat16":
                    main_err = max(main_err, err)

    # times at the main path's shapes: layer 1 relu, layer 2 none, bf16
    rows = []
    for (v, f, o), act in zip(shapes[1:], ("relu", "none")):
        h, agg, ws, wn, b = _operands(torch, gen, v, f, o, torch.bfloat16)
        cat_x = torch.cat([h, agg], dim=1)
        cat_w = torch.cat([ws, wn], dim=0)

        def library():
            out = torch.addmm(b, cat_x, cat_w)
            return torch.relu_(out) if act == "relu" else out

        row = {
            "shape": f"[{v},{f}]x[{f},{o}] {act}",
            "kernel_ms": cuda_ms(torch, lambda: sk.fused_sage_matmul(h, agg, ws, wn, b, act)),
            "plain_ms": cuda_ms(torch, lambda: sk.fused_sage_matmul_plain(h, agg, ws, wn, b, act)),
            "library_ms": cuda_ms(torch, library),
        }
        row["bound_ms"], row["bytes"], row["ops"] = bound_ms(v, f, o, "bfloat16")
        say("time " + json.dumps(row))
        rows.append(row)
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

    # the main path, counted: every window's layers go through the kernel
    sk.LAUNCHES = 0
    outs = _run_slice(torch, src, dst, params, table)
    torch.cuda.synchronize()
    launches = sk.LAUNCHES
    say(f"slice: {len(outs)} windows, fused_sage_matmul launches {launches} "
        f"(expected {2 * N_WINDOWS})")
    if len(outs) != N_WINDOWS or launches != 2 * N_WINDOWS:
        raise AssertionError("the main path did not launch the kernel twice per window")
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


def profile_pass(torch, one_pass, wall):
    """Device time by kernel over one pass (torch.profiler): the busy share
    and the eight kernels that take the most device time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        one_pass()
        torch.cuda.synchronize()
    events = prof.key_averages()

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    kernels = [e for e in events if e.device_type.name == "CUDA" and dev_us(e) > 0]
    total_us = sum(dev_us(e) for e in kernels)
    if total_us == 0:
        say("profile: no device time in the trace (not measured)")
        return
    say(f"profile: device busy {total_us / 1e3:.3f} ms over a {wall * 1e3:.3f} ms pass "
        f"(busy share {total_us / 1e6 / wall:.3f}, not corrected for profiler overhead)")
    for e in sorted(kernels, key=dev_us, reverse=True)[:8]:
        say(f"  {dev_us(e) / total_us:6.3f}  {dev_us(e) / 1e3:9.3f} ms  x{e.count:<4d} {e.key[:90]}")


def main():
    import torch

    phase_device(torch)
    phase_build()
    main_err, rows = phase_kernels(torch)
    slice_result = phase_slice(torch, rows)
    kernel = {
        "name": "fused_sage_matmul",
        "route": "cuda",
        "source": "gelly_streaming_tpu_torch/csrc/fused_sage_matmul.cu",
        "replaces": "gelly_streaming_tpu/ops/pallas_kernels.py:52",
        "launches": slice_result["launches"],
        "max_abs_err": main_err,
        "ms": sum(r["kernel_ms"] for r in rows),
        "plain_ms": sum(r["plain_ms"] for r in rows),
        "bound_ms": sum(r["bound_ms"] for r in rows),
        "bound_by": "bytes",
        "library_ms": sum(r["library_ms"] for r in rows),
        "per": f"window: {rows[0]['shape']} + {rows[1]['shape']}, bf16",
        "status": "ported",
    }
    say(json.dumps({"kernels": [kernel]}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
