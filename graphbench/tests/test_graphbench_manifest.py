"""Every piece is found by its name, and BENCHMARK.json names only pieces
that exist, as the harness reads them."""

import json
import os

import pytest

from graphbench import manifest

ROOT = os.path.dirname(manifest.ROOT)


def _bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("cell", manifest.names("workloads"))
def test_workload_finds_its_config_job_and_metrics(cell):
    w = manifest.workload(cell)
    c = manifest.config(w["config"])
    job = manifest.job(c["job"])
    assert hasattr(job, "Job")
    for m in w["metrics"]:
        mod = manifest.metric(m)
        assert callable(mod.read) and mod.UNIT
    assert w["limits"]["windows_short"] == 0
    assert int(w["window_edges"]) > 0 and w["why"]


@pytest.mark.parametrize("name", manifest.names("metrics"))
def test_every_metric_file_loads(name):
    mod = manifest.metric(name)
    assert callable(mod.read) and isinstance(mod.UNIT, str)


def test_unknown_names_are_refused():
    with pytest.raises(KeyError):
        manifest.workload("no_such_cell")
    with pytest.raises(KeyError):
        manifest.metric("no.such_metric")


def test_benchmark_json_matches_the_files():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert b["paths"] == ["graphbench"]
    configs = {c["name"]: c for c in b["configs"]}
    for name, c in configs.items():
        assert c["file"] == f"graphbench/configs/{name}.json"
        assert os.path.isfile(os.path.join(ROOT, c["file"]))
        assert c["reduced"] == manifest.config(name)["reduced"]
        assert c["source"] == manifest.config(name)["source"]
    cells = {w["name"]: w for w in b["workloads"]}
    assert set(cells) == set(manifest.names("workloads"))
    for name, w in cells.items():
        spec = manifest.workload(name)
        assert (w["config"], w["traffic"], w["chips"], w["why"]) == (
            spec["config"], spec["traffic"], spec["chips"], spec["why"])
        e2e = [m["name"] for m in b["end_to_end"] if name in m.get("workloads", [name])]
        assert sorted(e2e) == sorted(spec["end_to_end"])
        per = [m["name"] for m in b["per_layer"] if name in m.get("workloads", [name])]
        assert sorted(per) == sorted(spec["metrics"])
    assert {w["config"] for w in b["workloads"]} == set(configs)
    for m in b["per_layer"]:
        assert manifest.metric(m["name"]).UNIT == m["unit"]
        assert m["moves"] in {e["name"] for e in b["end_to_end"]}
    for m in b["end_to_end"]:
        assert 0 < m["bound"] <= 0.25
