"""One run of one cell: make the stream from the seed, warm up, measure (or
trace), check the kept outputs against the reference, and build the
result line.

The measured window runs passes back to back, each a fresh job over the
whole stream, and stops at the first window completed after ``seconds``.
A window is delivered when the work queued for it is complete on the
card: a CUDA event recorded after each emission marks it, and the gaps
between consecutive marks (the first from the window's start) are read on
the device's clock. ``edges_per_s`` counts the edges of every window
emitted, over the window's host-clock length up to the synchronize that
ends it.

Kept outputs: the last window of the first pass (the most edges), and one
window at a position drawn from the seed in each of the next
``sampled_passes`` passes, where the window reaches them.
"""

from __future__ import annotations

import gc
import os
import random
import sys
import tempfile
import time

import numpy as np
import torch

from graphbench import generate, manifest, profiling

#: top-level module names that may not be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "gelly_streaming_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is forbidden."""
    tops = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def merge(base: dict, over) -> dict:
    """``base`` with ``over``'s keys replaced, nested dicts merged."""
    out = dict(base)
    for k, v in (over or {}).items():
        out[k] = merge(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


class Data:
    """The stream the harness made: host columns, the ``.gbin`` both
    sides read, and (after the window) the columns on the device for the
    reference."""

    def __init__(self, src: np.ndarray, dst: np.ndarray, path: str, id_bound: int):
        self.src, self.dst, self.path = src, dst, path
        self.n_edges = len(src)
        self.id_bound = int(id_bound)
        self._dev = None

    def device_columns(self, device):
        if self._dev is None:
            self._dev = (torch.from_numpy(self.src).to(device),
                         torch.from_numpy(self.dst).to(device))
        return self._dev


class Marks:
    """Window completion marks: CUDA events on the card, the host clock on
    the CPU (where a run only rehearses the path)."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"
        self.marks = []

    def mark(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())

    def gaps_ms(self) -> list:
        if self.cuda:
            torch.cuda.synchronize()
            return [a.elapsed_time(b) for a, b in zip(self.marks, self.marks[1:])]
        return [(b - a) * 1e3 for a, b in zip(self.marks, self.marks[1:])]


def keep_plan(seed: int, windows_per_pass: int, sampled_passes: int) -> dict:
    """Pass index -> the position of the window kept in it."""
    rng = random.Random(int(seed))
    plan = {0: windows_per_pass - 1}
    for p in range(1, sampled_passes + 1):
        plan[p] = rng.randrange(windows_per_pass)
    return plan


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def drive(job, plan, marks, deadline=None, passes=None, annotate=False):
    """Run passes until the first window completed after ``deadline`` (host
    clock) or for ``passes`` whole passes. Returns the run's record."""
    rec = {"windows": 0, "edges": 0, "kept": [], "short": 0, "positions": []}
    p = 0
    while passes is None or p < passes:
        at = plan.get(p)
        it = job.run_pass(lambda pos, at=at: pos == at)
        n, cut = 0, False
        try:
            while True:
                if annotate:
                    with torch.profiler.record_function(profiling.NEXT):
                        item = next(it, None)
                else:
                    item = next(it, None)
                if item is None:
                    break
                edges, kept = item
                marks.mark()
                rec["windows"] += 1
                rec["edges"] += edges
                rec["positions"].append(n)
                n += 1
                if kept is not None:
                    rec["kept"].append(kept)
                if deadline is not None and time.perf_counter() >= deadline:
                    cut = True
                    break
        finally:
            it.close()
        if not cut:
            rec["short"] = max(rec["short"], job.windows_per_pass - n)
        p += 1
        if cut:
            break
    return rec


def _counters(mods):
    """Current values of the module counters the metric readers name."""
    import importlib

    out = {}
    for mod in mods:
        for key, (module, attr) in getattr(mod, "COUNTERS", {}).items():
            out[key] = getattr(importlib.import_module(module), attr)
    return out


def _registry(mods):
    from gelly_streaming_tpu_torch.obs.registry import get_registry

    reg = get_registry()
    out = {}
    for mod in mods:
        for name in getattr(mod, "REGISTRY", ()):
            found = reg.find(name)
            out[name] = sum(inst.value for _, inst in found) if found else None
    return out


def _traced(job, cell, plan, device, mods):
    """The traced run: ``trace_passes`` whole passes under the profiler."""
    ranges = sorted({r for m in mods for r in getattr(m, "RANGES", ())})
    kernels = sorted({k for m in mods for k in getattr(m, "KERNELS", ())})
    c0, g0 = _counters(mods), _registry(mods)
    marks = Marks(device)
    with profiling.traced(torch, device) as rec_t:
        rec = drive(job, plan, marks, passes=int(cell["trace_passes"]), annotate=True)
    c1, g1 = _counters(mods), _registry(mods)
    t = profiling.reduce(rec_t, ranges, kernels)
    t.update(
        windows=rec["windows"], edges=rec["edges"],
        counters={k: c1[k] - c0[k] for k in c1},
        registry={k: (g1[k] or 0.0) - (g0[k] or 0.0) for k in g1 if g1[k] is not None},
        sizes=job.sizes(rec["positions"]),
    )
    metrics = {}
    for name, mod in zip(cell["metrics"], mods):
        value = mod.read(t)
        if value is not None:
            metrics[name] = {"value": float(value), "unit": mod.UNIT}
    return rec, metrics, t


def run_cell(name: str, seed: int, seconds: float, trace: bool, device, t_start: float,
             overrides=None, data_dir=None):
    """One run of the cell ``name``. Returns ``(result, check_lines)``: the
    result dict in the order of the printed line (``checks`` last) and one
    line a compared number, its value beside its limit."""
    overrides = overrides or {}
    cell = merge(manifest.workload(name), overrides.get("workload"))
    config = merge(manifest.config(cell["config"]), overrides.get("config"))
    job_mod = manifest.job(config["job"])
    device = torch.device(device)

    stamps = [("imports", time.perf_counter())]
    src, dst = generate.edges(config["generator"], seed, device)
    src_h, dst_h = src.cpu().numpy(), dst.cpu().numpy()
    del src, dst
    stamps.append(("generate", time.perf_counter()))
    path = os.path.join(data_dir or tempfile.gettempdir(), f"graphbench-{name}-{seed}.gbin")
    from gelly_streaming_tpu_torch import datasets

    datasets.write_binary(path, src_h, dst_h)
    stamps.append(("write", time.perf_counter()))
    try:
        data = Data(src_h, dst_h, path, config["id_bound"])
        job = job_mod.Job(cell, config, data, device)
        plan = keep_plan(seed, job.windows_per_pass, int(cell["sampled_passes"]))
        for _ in range(int(cell["warm_passes"])):
            drive(job, {}, Marks(device), passes=1)
        _sync(device)
        stamps.append(("warm", time.perf_counter()))
        gc.collect()
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        dev_info = {
            "platform": "gpu" if device.type == "cuda" else device.type,
            "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
            "count": 1,
        }
        breakdown = None
        if trace:
            mods = [manifest.metric(m) for m in cell["metrics"]]
            setup_s = time.perf_counter() - t_start
            rec, metrics, t = _traced(job, cell, plan, device, mods)
            dev_info.update(busy_s=t["busy_s"], window_s=t["window_s"])
            breakdown = {"device_ops": t["device_ops"], "idle_gaps": t["idle_gaps"]}
        else:
            marks = Marks(device)
            t0 = time.perf_counter()
            setup_s = t0 - t_start
            marks.mark()
            rec = drive(job, plan, marks, deadline=t0 + seconds)
            _sync(device)
            window_s = time.perf_counter() - t0
            gaps = marks.gaps_ms()
            values = {
                "edges_per_s": (rec["edges"] / window_s, "edges/s"),
                "window_ms_p95": (float(np.percentile(gaps, 95)), "ms"),
                "setup_s": (setup_s, "s"),
            }
            metrics = {k: {"value": values[k][0], "unit": values[k][1]}
                       for k in cell["end_to_end"]}
        dev_info["memory_peak_bytes"] = (
            int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0)

        # the program's state goes before the reference runs
        answers = [job.collect(k) for k in rec.pop("kept")]
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        per_answer = job.check(answers)
    finally:
        if os.path.exists(path):
            os.remove(path)

    limits = cell["limits"]
    numbers = {k: max([a[k] for a in per_answer], default=0) for k in limits
               if k != "windows_short"}
    numbers["windows_short"] = rec["short"]
    failed = sum(any(a[k] > limits[k] for k in a) for a in per_answer)
    correct = (bool(answers) and failed == 0
               and all(numbers[k] <= limits[k] for k in limits))
    result = {
        "correct": correct,
        "attempted": rec["windows"],
        "failed": failed,
        "metrics": metrics,
        "device": dev_info,
    }
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    lines = ["set-up " + ", ".join(f"{k} {b - a:.3f} s" for (_, a), (k, b)
                                   in zip([("", t_start)] + stamps, stamps))]
    lines.append(f"windows checked {[p for p, _ in answers]}")
    lines += [f"check {k} {v!r} limit {limits[k]!r}" for k, v in numbers.items()]
    return result, lines
