"""The readers of the program's own span events (``t["spans"]``: calls and
seconds by event name): each reads its event over the traced pass's
windows, or over its calls for the latency, and returns None where the
event is absent (a program without it, or a cell that does not run it)."""

import time

import pytest

from graphbench import harness, manifest

#: reader -> (event it reads, divided by the windows (True) or by its calls)
READERS = {
    "pagerank.fixpoint_device_ms": ("pagerank.fixpoint.device", True),
    "cc.carry_span_ms": ("engine.dispatch.device", True),
    "cc.read_wait_ms": ("cc.host_read", True),
    "upload.host_ms": ("window.upload", True),
    "window.latency_ms": ("window.latency", False),
}


def _t(spans, windows=64):
    return {"spans": spans, "windows": windows, "kernels_ms": {}, "counters": {},
            "registry": {}}


@pytest.mark.parametrize("name", sorted(READERS))
def test_span_reader_divides_its_seconds(name):
    event, per_window = READERS[name]
    mod = manifest.metric(name)
    assert mod.UNIT == "ms" and mod.SPAN == event
    spans = {event: (128, 0.768), "other": (5, 99.0), event + ".device": (7, 50.0)}
    want = 0.768 * 1e3 / (64 if per_window else 128)
    assert mod.read(_t(spans)) == pytest.approx(want)


@pytest.mark.parametrize("name", sorted(READERS))
def test_span_reader_without_its_event_reads_nothing(name):
    mod = manifest.metric(name)
    assert mod.read(_t({"window.pack": (64, 0.2), "dict.encode": (64, 0.1)})) is None
    event, per_window = READERS[name]
    if per_window:
        assert mod.read(_t({event: (1, 0.1)}, windows=0)) is None
    else:
        assert mod.read(_t({event: (0, 0.0)})) is None


@pytest.mark.parametrize("cell, found", [
    ("cc_s23_w1m", {"cc.read_wait_ms", "upload.host_ms", "window.latency_ms"}),
    ("pr_s22_w1m", {"upload.host_ms", "window.latency_ms"}),
])
def test_span_readers_on_a_tiny_traced_cpu_run(cell, found, tiny, tmp_path):
    """A tiny traced run on the CPU with the readers added to the cell's
    list: the host spans read positive; the ``.device`` events, made only
    on a card, read nothing and leave their metrics out."""
    over = dict(tiny[cell])
    over["workload"] = dict(over["workload"],
                            metrics=manifest.workload(cell)["metrics"] + sorted(READERS))
    result, _ = harness.run_cell(cell, 2**31 + 29, 0.3, True, "cpu", time.perf_counter(),
                                 overrides=over, data_dir=str(tmp_path))
    assert result["correct"] is True
    got = set(result["metrics"]) & set(READERS)
    assert got == found
    for name in got:
        assert result["metrics"][name]["value"] > 0 and result["metrics"][name]["unit"] == "ms"
