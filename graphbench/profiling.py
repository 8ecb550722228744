"""The traced run: ``torch.profiler`` over whole passes with the program's
spans as profiler ranges, reduced to what the per-layer metrics read.

- Host time by span comes from a span sink (every thread, the prefetch
  producer's too).
- Device time under a range is the time of the kernels launched inside it
  (the profiler links each launch to the ranges around it); ranges opened
  on other threads are seen where the installed torch can profile every
  thread (``profile_all_threads``).
- Device time of a kernel by name (a ctypes launch sits under no PyTorch
  range) and of the host-to-device copies comes from the device events.
- ``busy_s`` is the union of the device's kernel, copy and set intervals.
- Idle gaps are named by what the main thread was inside at the gap's
  middle (``wait(...)`` when it was waiting for the next window, with the
  producer thread's innermost range).
"""

from __future__ import annotations

import bisect
import contextlib
import threading
import time

#: the harness's own ranges on the main thread
MARK = "graphbench.window"
NEXT = "graphbench.next"
SETTLE_S = 0.05
PRIMER_LAUNCHES = 128


class SpanSink:
    """An obs span sink: calls and host seconds by span name."""

    def __init__(self):
        self.lock = threading.Lock()
        self.totals = {}

    def emit(self, event):
        with self.lock:
            row = self.totals.setdefault(event["name"], [0, 0.0])
            row[0] += 1
            row[1] += event["dur_s"]


def _profile(torch, cuda: bool):
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    try:
        cfg = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    except (AttributeError, TypeError):
        return profile(activities=acts)
    return profile(activities=acts, experimental_config=cfg)


@contextlib.contextmanager
def traced(torch, device):
    """Profile the block with the program's spans on: yields a dict that
    holds, once the block has ended, ``prof``, ``spans`` and the window's
    host-clock length ``window_s``."""
    from gelly_streaming_tpu_torch.obs import trace

    cuda = device.type == "cuda"
    sink = SpanSink()
    out = {"spans": sink.totals}
    prof = _profile(torch, cuda)
    trace.add_sink(sink)
    trace.enable(torch_annotations=True)
    try:
        with prof:
            if cuda:
                # a trace can lose its first device records: small launches
                # go first, and only the marked window counts
                primer = torch.zeros(1, device=device)
                for _ in range(PRIMER_LAUNCHES):
                    primer.add_(1)
                torch.cuda.synchronize(device)
            time.sleep(SETTLE_S)
            with torch.profiler.record_function(MARK):
                t0 = time.perf_counter()
                yield out
                if cuda:
                    torch.cuda.synchronize(device)
                out["window_s"] = time.perf_counter() - t0
            time.sleep(SETTLE_S)
    finally:
        trace.disable()
        trace.remove_sink(sink)
    out["prof"] = prof


def kernel_name(name: str) -> str:
    """A device record's function name without namespaces, template or
    parameter lists: ``(anonymous namespace)::k(Args)`` -> ``k``."""
    s = name.replace("(anonymous namespace)::", "").split("(")[0].split("<")[0].strip()
    if s.startswith("void "):
        s = s[5:]
    return s.split("::")[-1]


def _dev(e):
    return e.device_type.name == "CUDA"


def _span_names(prof, spans):
    names = set(spans) | {MARK, NEXT}
    for e in prof.events():
        if getattr(e, "is_user_annotation", False):
            names.add(e.name)
    return names


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return out


def _innermost(ranges, starts, t):
    """The innermost range of one thread's (start, end, name) list, sorted
    by start, that holds ``t``; None when none does."""
    i = bisect.bisect_right(starts, t)
    for j in range(i - 1, max(-1, i - 400), -1):
        a, b, name = ranges[j]
        if b >= t:
            return name
    return None


def reduce(rec, range_names=(), kernel_names=()):
    """What the metric readers read of a traced block (see ``traced``)."""
    prof, spans = rec["prof"], rec["spans"]
    events = prof.events()
    names = _span_names(prof, spans)
    mark = [e for e in events if e.name == MARK and not _dev(e)]
    w0, w1 = mark[0].time_range.start, mark[0].time_range.end
    lo, hi = w0 - SETTLE_S * 1e6 / 2, w1 + SETTLE_S * 1e6 / 2

    device, by_op, h2d_us, kernels = [], {}, 0.0, {k: [0, 0.0] for k in kernel_names}
    for e in events:
        if not _dev(e) or e.name in names or not lo <= e.time_range.start <= hi:
            continue
        a, b = e.time_range.start, e.time_range.end
        device.append((a, b))
        row = by_op.setdefault(e.name, [0, 0.0])
        row[0] += 1
        row[1] += b - a
        if "HtoD" in e.name:
            h2d_us += b - a
        base = kernel_name(e.name)
        if base in kernels:
            kernels[base][0] += 1
            kernels[base][1] += b - a

    ranges_ms = {}
    host_ranges = {}
    for e in events:
        if _dev(e) or e.name not in names or not w0 <= e.time_range.start <= w1:
            continue
        host_ranges.setdefault(e.thread, []).append(
            (e.time_range.start, e.time_range.end, e.name))
        if e.name in range_names:
            us, stack = 0.0, [e]
            while stack:
                x = stack.pop()
                us += sum(k.duration for k in x.kernels)
                stack.extend(x.cpu_children)
            ranges_ms[e.name] = ranges_ms.get(e.name, 0.0) + us / 1e3

    busy = _union(device)
    busy_us = sum(b - a for a, b in busy)
    main = mark[0].thread
    for v in host_ranges.values():
        v.sort()
    idx = {t: [r[0] for r in v] for t, v in host_ranges.items()}
    inside = [(max(a, w0), min(b, w1)) for a, b in busy if b > w0 and a < w1]
    gaps, edges = {}, [w0] + [x for iv in inside for x in iv] + [w1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = (a + b) / 2
        what = _innermost(host_ranges.get(main, []), idx.get(main, []), mid) or "no range"
        if what in (NEXT, MARK):
            other = [_innermost(v, idx[t], mid) for t, v in host_ranges.items() if t != main]
            inner = sorted({o for o in other if o})
            what = f"wait({','.join(inner) or 'no range'})" if what == NEXT else "harness"
        gaps[what] = gaps.get(what, 0.0) + (b - a) / 1e6
    return {
        "window_s": rec["window_s"],
        "busy_s": busy_us / 1e6,
        "spans": {k: (c, s) for k, (c, s) in spans.items()},
        "ranges_ms": ranges_ms,
        "kernels_ms": {k: (n, us / 1e3) for k, (n, us) in kernels.items()},
        "h2d_ms": h2d_us / 1e3,
        "device_ops": sorted(([k, v[1] / 1e6] for k, v in by_op.items()),
                             key=lambda r: -r[1])[:10],
        "idle_gaps": sorted(([k, v] for k, v in gaps.items()), key=lambda r: -r[1])[:10],
    }
