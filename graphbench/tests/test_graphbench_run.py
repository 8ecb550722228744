"""Runs of the cells at tiny sizes on the CPU, the result line's shape, and
the command's refusals."""

import json
import os
import subprocess
import sys
import time

import pytest
import torch

from graphbench import harness, manifest

ROOT = os.path.dirname(manifest.ROOT)


def _bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", manifest.names("workloads"))
def test_tiny_run_is_correct_and_well_formed(cell, trace, tiny, tmp_path):
    result, lines = harness.run_cell(cell, 2**31 + 17, 0.3, trace, "cpu", time.perf_counter(),
                                     overrides=tiny[cell], data_dir=str(tmp_path))
    assert result["correct"] is True and result["failed"] == 0
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(result)[-1] == "checks"
    spec = manifest.workload(cell)
    units = {m["name"]: m["unit"] for m in _bench()["end_to_end"] + _bench()["per_layer"]}
    if trace:
        assert set(result["metrics"]) <= set(spec["metrics"]) and result["metrics"]
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
        assert "window_s" in result["device"] and "busy_s" in result["device"]
    else:
        assert set(result["metrics"]) == set(spec["end_to_end"])
    for k, v in result["metrics"].items():
        assert v["unit"] == units[k]
    assert set(result["checks"]) == set(spec["limits"])
    assert lines[-len(spec["limits"]):] == [
        f"check {k} {v['value']!r} limit {v['limit']!r}" for k, v in result["checks"].items()]
    assert not os.listdir(tmp_path)  # the stream's file is removed


def test_keep_plan_is_the_seeds():
    a = harness.keep_plan(2**33 + 1, 128, 3)
    assert a == harness.keep_plan(2**33 + 1, 128, 3)
    assert a[0] == 127 and set(a) == {0, 1, 2, 3}
    assert all(0 <= p < 128 for p in a.values())


def test_forbidden_modules_compare_whole_names(monkeypatch):
    base = set(harness.forbidden_modules())
    monkeypatch.setitem(sys.modules, "gelly_streaming_tpu_torch_x", object())
    assert set(harness.forbidden_modules()) == base
    monkeypatch.setitem(sys.modules, "gelly_streaming_tpu.ops", object())
    assert "gelly_streaming_tpu" in harness.forbidden_modules()


def test_without_a_card_the_command_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    p = subprocess.run([sys.executable, os.path.join(ROOT, "graphbench", "run.py"),
                        "--workload", manifest.names("workloads")[0], "--seed", "1",
                        "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert p.returncode == 2 and p.stdout == ""


@pytest.mark.cuda
@pytest.mark.parametrize("cell", manifest.names("workloads"))
def test_cell_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    p = subprocess.run([sys.executable, os.path.join(ROOT, "graphbench", "run.py"),
                        "--workload", cell, "--seed", "2", "--seconds", "2", "--trace", "0"],
                       capture_output=True, text=True, cwd=ROOT, timeout=600)
    assert p.returncode == 0, p.stderr[-4000:]
    result = json.loads(p.stdout.strip().splitlines()[-1])
    assert result["correct"] is True and result["device"]["platform"] == "gpu"
