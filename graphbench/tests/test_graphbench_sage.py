"""The ``sage_products_w8m`` cell's pieces on the CPU: its four readers on a
synthetic trace (and on one without what they read: a program without the
spans, or a cell that does not run the model), the control reading not
correct and a sound tiny run reading correct, as
``test_graphbench_faults.py`` does for CC and PageRank."""

import time

import pytest
import torch

from graphbench import control, harness, manifest

CELL = "sage_products_w8m"
#: the cell at 2^10 ids and 2^14 messages in windows of 2^12 (4 a pass),
#: the published widths kept
TINY = {
    "config": {"generator": {"scale": 10, "edges": 1 << 14}, "id_bound": 1 << 10,
               "program": {"id_bound": 1 << 10}},
    "workload": {"window_edges": 1 << 12},
}
SEED = 2**31 + 29
DIMS = [100, 256, 256, 47]
V = 1 << 21


def _t(**over):
    t = {"windows": 15, "window_s": 5.0, "ranges_ms": {}, "kernels_ms": {}, "spans": {},
         "counters": {}, "registry": {}, "busy_s": 4.0,
         "sizes": {"window_edges": [1 << 23] * 15, "held_edges": [(w + 1) << 23 for w in range(15)],
                   "vertices": V, "dims": DIMS, "launches": {"tc": 45, "simt": 0}}}
    t.update(over)
    return t


def test_aggregate_ms_reads_its_device_span_over_the_windows():
    mod = manifest.metric("sage.aggregate_ms")
    assert mod.UNIT == "ms" and mod.SPAN == "sage.aggregate.device"
    spans = {"sage.aggregate.device": (45, 6.0), "sage.aggregate": (45, 99.0)}
    assert mod.read(_t(spans=spans)) == pytest.approx(400.0)
    assert mod.read(_t(ranges_ms={"sage.aggregate": 300.0})) is None
    assert mod.read(_t(spans=spans, windows=0)) is None


def test_matmul_roofline_counts_each_layer_at_its_bound():
    mod = manifest.metric("sage.matmul_roofline")
    assert mod.UNIT == "%"
    # layer 2 (256 -> 256) by hand: bytes 2 (2 V 256 + 2 256^2 + 256 + 256 V)
    b = 2 * (2 * V * 256 + 2 * 256 * 256 + 256 + V * 256)
    assert mod.layer_bytes(V, 256, 256) == b
    assert mod.layer_flops(V, 256, 256) == 4 * V * 256 * 256
    bound = sum(max(mod.layer_bytes(V, f, o) / 3.35e12, mod.layer_flops(V, f, o) / 989e12)
                for f, o in zip(DIMS[:-1], DIMS[1:]))
    # every layer is bound by its bytes at these widths
    assert bound == pytest.approx(sum(mod.layer_bytes(V, f, o) for f, o in
                                      zip(DIMS[:-1], DIMS[1:])) / 3.35e12)
    kernels = {"fused_sage_matmul_tc_kernel": (45, 60.0), "fused_sage_matmul_kernel": (0, 0.0)}
    got = mod.read(_t(kernels_ms=kernels))
    assert got == pytest.approx(100 * bound * 15 * 1e3 / 60.0)
    assert 0 < got < 100
    # the CUDA-core kernel's time counts too
    both = {"fused_sage_matmul_tc_kernel": (30, 40.0), "fused_sage_matmul_kernel": (15, 20.0)}
    assert mod.read(_t(kernels_ms=both)) == pytest.approx(got)
    assert mod.read(_t()) is None
    assert mod.read(_t(kernels_ms=kernels, sizes={})) is None


def test_step_mfu_counts_products_and_aggregation_adds():
    """The adds from the program's message counter: 3 layers aggregating
    each window's held messages give the held messages at every width."""
    mod = manifest.metric("sage.step_mfu")
    assert mod.UNIT == "%"
    assert mod.COUNTERS == {"graphsage.MESSAGES_AGGREGATED": (
        "gelly_streaming_tpu_torch.models.graphsage", "MESSAGES_AGGREGATED")}
    held = _t()["sizes"]["held_edges"]
    t = _t(counters={"graphsage.MESSAGES_AGGREGATED": 3 * sum(held)})
    flops = sum(4 * V * f * o * 15 for f, o in zip(DIMS[:-1], DIMS[1:]))
    flops += sum(e * f for e in held for f in DIMS[:-1])
    assert mod.read(t) == pytest.approx(100 * flops / (5.0 * 989e12))
    assert mod.read(dict(t, window_s=0.0)) is None
    assert mod.read(dict(t, sizes={"window_edges": [1]})) is None
    assert mod.read(_t()) is None


def test_simt_launches_reads_the_jobs_launch_count_a_window():
    mod = manifest.metric("sage.simt_launches")
    assert mod.UNIT == "launches/window"
    assert mod.read(_t()) == 0.0
    t = _t()
    t["sizes"]["launches"] = {"tc": 15, "simt": 30}
    assert mod.read(t) == pytest.approx(2.0)
    assert mod.read(_t(sizes={})) is None
    assert mod.read(_t(windows=0)) is None


def test_config_states_the_programs_aggregation_slice():
    from gelly_streaming_tpu_torch.models import graphsage

    program = manifest.config(manifest.workload(CELL)["config"])["program"]
    assert program["aggregate_slice_edges"] == graphsage.AGG_SLICE_EDGES
    assert program["dims"] == DIMS and program["accumulate"] == "float32"


def test_control_reads_not_correct():
    """The reference with bfloat16 sums and counts in the program's place:
    the hub's count stops at 256 and its rows fail ``hub_rel_gap``."""
    out = control.read_control(CELL, SEED, "cpu", overrides=TINY)
    assert out["correct"] is False
    assert out["numbers"]["hub_rel_gap"] > out["limits"]["hub_rel_gap"]


def test_sound_tiny_run_reads_correct(tmp_path):
    """Long enough for the first pass, whose last window is kept, on a
    busy host too (a pass takes about a second here)."""
    result, lines = harness.run_cell(CELL, SEED, 8.0, False, "cpu", time.perf_counter(),
                                     overrides=TINY, data_dir=str(tmp_path))
    assert result["correct"] is True, lines
    assert result["checks"]["windows_short"]["value"] == 0
    assert 0 < result["checks"]["emb_rel_l2"]["value"] <= result["checks"]["emb_rel_l2"]["limit"]


def test_traced_tiny_run_reads_the_program_counter(tmp_path):
    """Traced on the CPU: no device events, so the device readers leave
    their metrics out; the launch counter (the plain version counts no
    launch), the producer's wait and the step's share of the peak (from
    the message counter) are read."""
    result, _ = harness.run_cell(CELL, SEED, 0.3, True, "cpu", time.perf_counter(),
                                 overrides=TINY, data_dir=str(tmp_path))
    assert result["correct"] is True
    m = result["metrics"]
    assert m["sage.simt_launches"]["value"] == 0.0
    assert m["sage.step_mfu"]["value"] > 0
    assert m["ingest.wait_ms"]["value"] >= 0
    assert "sage.matmul_roofline" not in m and "sage.aggregate_ms" not in m


def _half(real):
    def append(self, s, d):
        n = int(s.shape[0]) // 2
        return real(self, s[:n], d[:n])
    return append


def _altered(real):
    def window(self, block):
        out = real(self, block).clone()
        out[0] *= 2  # id 0: the R-MAT stream's largest in-degree
        return out
    return window


def _no_mean(h, src, dst, mask, num_vertices, axis_name=None, **kwargs):
    return torch.zeros_like(h)


@pytest.mark.parametrize("fault", ["no_mean", "half", "altered"])
def test_fault_is_caught(fault, tmp_path, monkeypatch):
    """The aggregation left out, half of each window's messages left out of
    the held graph, an answer altered where it is produced: each reads not
    correct."""
    from gelly_streaming_tpu_torch.core.edgeblock import EdgeAccumulator
    from gelly_streaming_tpu_torch.models import graphsage

    if fault == "no_mean":
        monkeypatch.setattr(graphsage, "mean_aggregate", _no_mean)
    elif fault == "half":
        monkeypatch.setattr(EdgeAccumulator, "append", _half(EdgeAccumulator.append))
    else:
        monkeypatch.setattr(graphsage.StreamingGraphSAGE, "_window",
                            _altered(graphsage.StreamingGraphSAGE._window))
    result, _ = harness.run_cell(CELL, SEED, 8.0, False, "cpu", time.perf_counter(),
                                 overrides=TINY, data_dir=str(tmp_path))
    assert result["correct"] is False
