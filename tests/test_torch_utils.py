"""The port's auxiliary modules: profiling streams, the engine config, the
record types, the sorted-run key set, the device peaks, and the host
``DisjointSet``, each beside the JAX package's.

Mirrors ``tests/test_utils.py`` (its JAX-only ``chip_spec`` case, ``:187``,
has a card-naming counterpart here) and the ``DisjointSet`` cases of
``tests/test_summaries.py``.
"""

import argparse
import json
import time

import numpy as np
import pytest
import torch

from gelly_streaming_tpu import native as jax_native
from gelly_streaming_tpu.summaries import DisjointSet as JaxDisjointSet
from gelly_streaming_tpu.utils.keyruns import SortedRunSet as JaxSortedRunSet
from gelly_streaming_tpu_torch import CountWindow, EventTimeWindow, SimpleEdgeStream
from gelly_streaming_tpu_torch.library import ConnectedComponents
from gelly_streaming_tpu_torch.summaries import DisjointSet
from gelly_streaming_tpu_torch.utils import (
    EngineConfig,
    SignedVertex,
    StreamProfiler,
    device_trace,
    profiled,
)
from gelly_streaming_tpu_torch.utils import profiling


def _stream(edges, window):
    return SimpleEdgeStream(edges, window=CountWindow(window), device="cpu")


def test_profiled_aggregation_stream(sample_edges):
    prof = StreamProfiler()
    results = [r for r, _ in profiled(_stream(sample_edges, 3).aggregate(
        ConnectedComponents()), prof)]
    assert len(results) == 3
    s = prof.summary()
    assert s["windows"] == 3
    assert s["p50_window_s"] > 0
    assert prof.latency_percentile(95) >= prof.latency_percentile(50) >= 0


def test_profiled_counts_edges():
    def gen():
        for i in range(4):
            time.sleep(0.001)
            yield i

    prof = StreamProfiler()
    out = list(profiled(gen(), prof, edges_per_window=iter([10, 20, 30, 40])))
    assert [r for r, _ in out] == [0, 1, 2, 3]
    assert prof.total_edges() == 100
    assert prof.edges_per_sec() > 0


def test_profiler_mirrors_into_a_registry():
    from gelly_streaming_tpu_torch.obs.registry import MetricRegistry

    reg = MetricRegistry()
    prof = StreamProfiler(registry=reg, name="cc")
    list(profiled(iter([1, 2]), prof, edges_per_window=iter([5, 7])))
    snap = json.dumps(reg.snapshot(), default=str)
    assert "cc.window_seconds" in snap and "cc.window_edges" in snap


def test_engine_config_window_selection():
    assert isinstance(EngineConfig(window_size=128).window(), CountWindow)
    w = EngineConfig(window_time=300.0).window(timestamp_fn=lambda e: e[2])
    assert isinstance(w, EventTimeWindow)
    assert w.size == 300.0


def test_engine_config_cli_roundtrip():
    parser = argparse.ArgumentParser()
    EngineConfig.add_args(parser)
    cfg = EngineConfig.from_args(parser.parse_args(["--window-size", "64",
                                                    "--transient-state"]))
    assert cfg.window_size == 64
    assert cfg.transient_state is True
    assert cfg.tree_degree == 2


@pytest.mark.parametrize("knobs", [["--device-encode", "--id-bound", "8"],
                                   ["--device-encode"], ["--id-bound", "8"], []])
def test_engine_config_ingest_knobs(tmp_path, knobs):
    """Each ingest mode of the config (device encode with a bound and in
    growth mode, identity, the host dict) gives the same components."""
    p = tmp_path / "g.txt"
    jax_native.write_edge_file(str(p), np.array([0, 1, 5]), np.array([1, 2, 6]))
    parser = argparse.ArgumentParser()
    EngineConfig.add_args(parser)
    cfg = EngineConfig.from_args(parser.parse_args(["--window-size", "2", *knobs]))
    last = None
    for last in cfg.open_stream(str(p), device="cpu").aggregate(ConnectedComponents()):
        pass
    assert sorted(last.component_sets()) == [frozenset({0, 1, 2}), frozenset({5, 6})]


def test_signed_vertex_reverse():
    sv = SignedVertex(5, True)
    assert sv.reverse() == SignedVertex(5, False)
    assert sv.reverse().reverse() == sv


def test_emission_stream_flat_and_batched_views():
    from gelly_streaming_tpu_torch.core.emission import EmissionStream

    def batches():
        yield [1, 2, 3]
        yield []
        yield [4, 5]

    es = EmissionStream(batches)
    assert list(es) == [1, 2, 3, 4, 5]
    assert [list(b) for b in es.batches()] == [[1, 2, 3], [], [4, 5]]
    assert list(es) == [1, 2, 3, 4, 5]
    prof = StreamProfiler()
    assert list(es.with_profiler(prof)) == [1, 2, 3, 4, 5]
    assert [s.edges for s in prof.stats] == [3, 0, 2]


def test_property_streams_are_emission_streams():
    from gelly_streaming_tpu_torch.core.emission import EmissionStream

    s = SimpleEdgeStream((np.array([1, 2, 3, 1]), np.array([2, 3, 4, 3])),
                         window=CountWindow(2), device="cpu")
    degrees = s.get_degrees()
    assert isinstance(degrees, EmissionStream)
    flat = list(degrees)
    grouped = [list(b) for b in degrees.batches()]
    assert flat == [x for b in grouped for x in b]
    assert len(grouped) == 2
    assert [v.id for v in s.get_vertices()] == [1, 2, 3, 4]
    assert list(s.number_of_vertices()) == [1, 2, 3, 4]
    assert list(s.number_of_edges()) == [1, 2, 3, 4]


def test_sorted_run_set_matches_naive_and_jax():
    from gelly_streaming_tpu_torch.utils.keyruns import SortedRunSet

    rng = np.random.default_rng(11)
    s, j, ref = SortedRunSet(), JaxSortedRunSet(), set()
    for _ in range(40):
        keys = np.unique(rng.integers(0, 500, rng.integers(1, 60)).astype(np.int64))
        new = s.filter_new(keys)
        assert new.tolist() == sorted(set(keys.tolist()) - ref)
        np.testing.assert_array_equal(new, j.filter_new(keys))
        s.add(new)
        j.add(new)
        ref |= set(keys.tolist())
        probe = rng.integers(0, 600, 32).astype(np.int64)
        assert s.contains(probe).tolist() == [int(p) in ref for p in probe]
    assert len(s._runs) <= 12
    assert s.to_array().tolist() == sorted(ref)


def test_chip_spec_names_the_card_and_holds_no_tpu_figure(monkeypatch):
    """Without a card: "cpu" and unknown peaks. A card named like the
    H100 SXM: its published peaks. Any other card: its name, unknown
    peaks, and no share of a peak in the roofline entry."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert profiling.chip_spec() == {"kind": "cpu", "peak_bf16_flops": None,
                                     "hbm_bytes_s": None}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: "NVIDIA H100 80GB HBM3")
    spec = profiling.chip_spec()
    assert spec == {"kind": "NVIDIA H100 80GB HBM3", "peak_bf16_flops": 989e12,
                    "hbm_bytes_s": 3.35e12}
    e = profiling.roofline_entry(1e-3, bytes_moved=3.35e9, flops=1e9)
    assert e["hbm_pct"] == pytest.approx(100.0) and e["mfu_pct"] > 0
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: "Some Other GPU")
    spec = profiling.chip_spec()
    assert spec["kind"] == "Some Other GPU" and spec["hbm_bytes_s"] is None
    e = profiling.roofline_entry(1e-3, bytes_moved=1e9)
    assert "hbm_pct" not in e and e["gbytes_s"] == pytest.approx(1000.0)


def test_device_trace_writes_a_trace(tmp_path):
    with device_trace(str(tmp_path / "tr")):
        torch.arange(16).sum()
    assert (tmp_path / "tr" / "trace.json").stat().st_size > 0


# --------------------------------------------------------------------- #
# host DisjointSet (tests/test_summaries.py:18-55)
# --------------------------------------------------------------------- #
def test_disjointset_union_find():
    ds = DisjointSet()
    for e in (1, 2, 3, 4):
        ds.make_set(e)
    ds.union(1, 2)
    ds.union(3, 4)
    assert ds.find(1) == ds.find(2)
    assert ds.find(3) == ds.find(4)
    assert ds.find(1) != ds.find(3)
    assert len(ds.components()) == 2
    ds.union(2, 3)
    assert len(ds.components()) == 1
    assert ds.find(99) is None


def test_disjointset_merge():
    a, b = DisjointSet(), DisjointSet()
    a.union(1, 2)
    b.union(2, 3)
    b.union(4, 5)
    a.merge(b)
    assert a.find(1) == a.find(3)
    assert a.find(4) == a.find(5)
    assert a.find(1) != a.find(4)
    assert len(a.components()) == 2


def test_disjointset_str_format_equals_jax():
    rng = np.random.default_rng(3)
    ds, js = DisjointSet(), JaxDisjointSet()
    for a, b in rng.integers(0, 30, size=(25, 2)).tolist():
        ds.union(a, b)
        js.union(a, b)
    assert str(ds) == str(js)
    assert sorted(ds.component_sets(), key=sorted) == sorted(js.component_sets(), key=sorted)
    one = DisjointSet()
    one.union(1, 2)
    assert str(one) in ("{1=[1, 2]}", "{2=[1, 2]}")
