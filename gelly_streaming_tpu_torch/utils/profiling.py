"""Per-window step timing and device tracing (PyTorch port of
``gelly_streaming_tpu/utils/profiling.py``, SURVEY.md §5).

- :func:`profiled` wraps any per-window emission iterator and yields
  ``(result, WindowStats)`` pairs — the metrics ARE a stream.
- :class:`StreamProfiler` aggregates those stats (edges/sec, p50/p95
  window latency); with observability enabled (or a registry passed) every
  recorded window mirrors into ``<name>.window_seconds`` /
  ``<name>.window_edges``; percentiles use the repo-wide
  :func:`~gelly_streaming_tpu_torch.obs.registry.nearest_rank` rule.
- :func:`device_trace` is a ``torch.profiler`` trace of the CPU and, where
  there is one, the CUDA device, written for TensorBoard / Perfetto.
- :func:`chip_spec` and :func:`roofline_entry` anchor a kernel's time to the
  attached card's published peaks. Only the NVIDIA H100 SXM's are known
  here; any other device reports its peaks as unknown (``None``), and the
  roofline shares are then left out rather than guessed.

Timing covers host wall time of each ``next()``; around asynchronous CUDA
work that is enqueue time unless the stream synchronizes.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Iterator, List, Optional, Tuple

from ..core.emission import WindowStats
from ..obs import trace as _trace
from ..obs.registry import get_registry, nearest_rank


class StreamProfiler:
    """Aggregate window stats; exposes throughput and latency percentiles.

    ``registry`` (optional) pins where mirrored metrics go; by default
    they go to the global obs registry ONLY while observability is
    enabled, so a bare profiler stays a private list. ``name`` prefixes the
    mirrored instrument names.
    """

    def __init__(self, registry=None, name: str = "profiler"):
        self.stats: List[WindowStats] = []
        self._registry = registry
        self._name = name

    def record(self, s: WindowStats) -> None:
        self.stats.append(s)
        reg = self._registry
        if reg is None and _trace.on():
            reg = get_registry()
        if reg is not None:
            reg.histogram(self._name + ".window_seconds").observe(s.wall_seconds)
            if s.edges:
                reg.counter(self._name + ".window_edges").inc(s.edges)

    def total_edges(self) -> int:
        return sum(s.edges or 0 for s in self.stats)

    def total_seconds(self) -> float:
        return sum(s.wall_seconds for s in self.stats)

    def edges_per_sec(self) -> float:
        t = self.total_seconds()
        return self.total_edges() / t if t > 0 else 0.0

    def latency_percentile(self, q: float) -> float:
        """q in [0, 100]: nearest-rank percentile of per-window wall time
        (seconds)."""
        return nearest_rank(sorted(s.wall_seconds for s in self.stats), q)

    def summary(self) -> dict:
        return {
            "windows": len(self.stats),
            "edges": self.total_edges(),
            "edges_per_sec": self.edges_per_sec(),
            "p50_window_s": self.latency_percentile(50),
            "p95_window_s": self.latency_percentile(95),
        }


def profiled(
    iterator: Iterator[Any],
    profiler: Optional[StreamProfiler] = None,
    edges_per_window: Optional[Iterator[int]] = None,
) -> Iterator[Tuple[Any, WindowStats]]:
    """Yield ``(result, WindowStats)`` per window of any emission stream.

    Timing covers the work to produce each emission (the ``next()`` call):
    host windowing, the device step's enqueue and host emission."""
    prof = profiler if profiler is not None else StreamProfiler()
    idx = 0
    it = iter(iterator)
    sizes = iter(edges_per_window) if edges_per_window is not None else None
    while True:
        t0 = time.perf_counter()
        try:
            result = next(it)
        except StopIteration:
            return
        dt = time.perf_counter() - t0
        n = next(sizes, None) if sizes is not None else None
        stats = WindowStats(idx, dt, n)
        prof.record(stats)
        yield result, stats
        idx += 1


@contextlib.contextmanager
def device_trace(log_dir: str):
    """A ``torch.profiler`` trace of the block: CPU activity, and the CUDA
    device's when a card is present; the Chrome trace is written to
    ``<log_dir>/trace.json`` (TensorBoard / Perfetto read it)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


# --------------------------------------------------------------------- #
# Roofline accounting: a kernel's time against the card's published peaks
# --------------------------------------------------------------------- #

#: published dense peaks (bf16 FLOP/s, HBM bytes/s) by a substring of
#: ``torch.cuda.get_device_name``: NVIDIA's data sheet for the H100 SXM
#: (989 TFLOP/s bf16 without sparsity, 3.35 TB/s HBM3), at its 700 W limit
_CARD_PEAKS = {
    "H100 80GB HBM3": (989e12, 3.35e12),
}


def chip_spec() -> dict:
    """The attached card's name and published peaks: ``{"kind",
    "peak_bf16_flops", "hbm_bytes_s"}``. The peaks are ``None`` for a card
    this table does not know, and for a host without a card (``kind``
    says ``"cpu"``)."""
    import torch

    if not torch.cuda.is_available():
        return {"kind": "cpu", "peak_bf16_flops": None, "hbm_bytes_s": None}
    kind = torch.cuda.get_device_name()
    for key, (flops, bw) in _CARD_PEAKS.items():
        if key in kind:
            return {"kind": kind, "peak_bf16_flops": flops, "hbm_bytes_s": bw}
    return {"kind": kind, "peak_bf16_flops": None, "hbm_bytes_s": None}


def roofline_entry(
    seconds: float, *, flops: float = 0.0, bytes_moved: float = 0.0,
    model: str = "",
) -> dict:
    """One kernel's achieved rate against the card's roofline.

    ``flops``/``bytes_moved`` are the caller's analytic model of the work
    (the ``model`` string says what was counted). The shares of peak
    (``mfu_pct``, ``hbm_pct``) appear only where the card's peak is known
    (:func:`chip_spec`)."""
    spec = chip_spec()
    out = {"time_ms": seconds * 1e3, "model": model, "kind": spec["kind"]}
    if flops:
        out["gflops_s"] = flops / seconds / 1e9
        if spec["peak_bf16_flops"]:
            out["mfu_pct"] = 100.0 * flops / seconds / spec["peak_bf16_flops"]
    if bytes_moved:
        out["gbytes_s"] = bytes_moved / seconds / 1e9
        if spec["hbm_bytes_s"]:
            out["hbm_pct"] = 100.0 * bytes_moved / seconds / spec["hbm_bytes_s"]
    return out
