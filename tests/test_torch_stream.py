"""Windowing, vertex dictionaries and the edge accumulator: the port
against the JAX package.

The same records or numpy columns, made from a seed, go through
``gelly_streaming_tpu.SimpleEdgeStream`` and through
``gelly_streaming_tpu_torch.SimpleEdgeStream(device="cpu")``. Block counts,
``to_host`` columns, ``n_vertices`` and the vertex encodings must match
exactly. Also here: the accumulator's growth and state, the absence of a
CPU fallback, and the rule that the port imports nothing of JAX.
"""

import ast
import pathlib

import numpy as np
import pytest
import torch

import gelly_streaming_tpu as gj
import gelly_streaming_tpu_torch as gt
from gelly_streaming_tpu import datasets as jax_datasets
from gelly_streaming_tpu.core.edgeblock import EdgeAccumulator as JaxAccumulator
from gelly_streaming_tpu_torch import datasets as torch_datasets
from gelly_streaming_tpu_torch.core.edgeblock import EdgeAccumulator
from gelly_streaming_tpu_torch.library import (
    ConnectedComponents,
    DegreeDistribution,
    IterativeConnectedComponents,
    WindowTriangles,
)
from gelly_streaming_tpu_torch.ops import triangles as ttri

REPO = pathlib.Path(__file__).resolve().parents[1]


def _blocks_equal(jax_stream, torch_stream):
    jb = list(jax_stream.blocks())
    tb = list(torch_stream.blocks())
    assert len(jb) == len(tb)
    for a, b in zip(jb, tb):
        assert b.capacity == a.capacity
        assert b.n_vertices == a.n_vertices
        assert b.src.dtype == torch.int32 and b.src.device.type == "cpu"
        for x, y in zip(a.to_host(), b.to_host()):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
        # device columns: padded, masked by a prefix mask
        np.testing.assert_array_equal(np.asarray(a.src), b.src.numpy())
        np.testing.assert_array_equal(np.asarray(a.dst), b.dst.numpy())
        np.testing.assert_array_equal(np.asarray(a.mask), b.mask.numpy())
        np.testing.assert_array_equal(np.asarray(a.val), b.val.numpy())
        assert int(b.num_edges()) == int(a.num_edges())
    return len(tb)


@pytest.mark.parametrize("size", [1, 2, 3, 7])
def test_record_windows_match_jax(sample_edges, size):
    js = gj.SimpleEdgeStream(sample_edges, window=gj.CountWindow(size))
    ts = gt.SimpleEdgeStream(sample_edges, window=gt.CountWindow(size), device="cpu")
    n = _blocks_equal(js, ts)
    assert n == -(-len(sample_edges) // size)
    np.testing.assert_array_equal(
        js.vertex_dict.raw_ids(), ts.vertex_dict.raw_ids()
    )


@pytest.mark.parametrize("with_val", [False, True])
def test_column_windows_match_jax_under_vertex_dict(with_val):
    rng = np.random.default_rng(21)
    n = 1000
    pool = rng.integers(0, 10**9, 300)  # sparse raw ids, each seen often
    src = rng.choice(pool, n)
    dst = rng.choice(pool, n)
    cols = (src, dst, rng.random(n).astype(np.float32)) if with_val else (src, dst)
    js = gj.SimpleEdgeStream(cols, window=gj.CountWindow(96))
    ts = gt.SimpleEdgeStream(cols, window=gt.CountWindow(96), device="cpu")
    assert _blocks_equal(js, ts) == -(-n // 96)
    jv, tv = js.vertex_dict, ts.vertex_dict
    assert len(jv) == len(tv) and jv.capacity == tv.capacity
    np.testing.assert_array_equal(jv.raw_ids(), tv.raw_ids())
    probe = np.concatenate([src[:50], [-5, 10**12]])
    np.testing.assert_array_equal(jv.lookup_batch(probe), tv.lookup_batch(probe))
    assert tv.lookup(int(src[0])) == jv.lookup(int(src[0]))
    assert tv.lookup(-5) is None
    idx = np.arange(len(tv))[::7]
    np.testing.assert_array_equal(jv.decode(idx), tv.decode(idx))


def test_column_windows_match_jax_under_identity_dict():
    rng = np.random.default_rng(4)
    src = rng.integers(0, 512, 4096).astype(np.int32)
    dst = rng.integers(0, 512, 4096).astype(np.int32)
    jd, td = jax_datasets.IdentityDict(512), torch_datasets.IdentityDict(512)
    js = gj.SimpleEdgeStream((src, dst), window=gj.CountWindow(1024), vertex_dict=jd)
    ts = gt.SimpleEdgeStream(
        (src, dst), window=gt.CountWindow(1024), vertex_dict=td, device="cpu"
    )
    assert _blocks_equal(js, ts) == 4
    assert len(jd) == len(td) and jd.capacity == td.capacity
    np.testing.assert_array_equal(jd.raw_ids(), td.raw_ids())
    np.testing.assert_array_equal(
        np.asarray(jd.raw_table()), td.raw_table("cpu").numpy()
    )
    probe = np.array([0, 511, 512, -1])
    np.testing.assert_array_equal(jd.lookup_batch(probe), td.lookup_batch(probe))
    with pytest.raises(ValueError):
        td.encode(np.array([512]))


def test_array_input_with_values_matches_jax():
    rng = np.random.default_rng(8)
    arr = np.stack(
        [rng.integers(0, 40, 50), rng.integers(0, 40, 50), rng.integers(0, 9, 50)],
        axis=1,
    )
    js = gj.SimpleEdgeStream(arr, window=gj.CountWindow(16))
    ts = gt.SimpleEdgeStream(arr, window=gt.CountWindow(16), device="cpu")
    assert _blocks_equal(js, ts) == 4


def test_vertex_dict_raw_table_matches_jax():
    jv, tv = gj.VertexDict(), gt.VertexDict()
    raw = np.array([40, 7, 40, 99, 3, 7, 12], np.int64)
    np.testing.assert_array_equal(jv.encode(raw), tv.encode(raw))
    np.testing.assert_array_equal(
        np.asarray(jv.raw_table()), tv.raw_table("cpu").numpy()
    )
    assert tv.raw_table("cpu") is tv.raw_table("cpu")  # cached per size
    tv.encode(np.array([2**40]))
    with pytest.raises(ValueError, match="int32"):
        tv.raw_table("cpu")


@pytest.mark.parametrize("n", [0, 1, 7, 8, 9, 1000, 1 << 20])
def test_bucket_capacity_matches_jax(n):
    assert gt.bucket_capacity(n) == gj.bucket_capacity(n)
    assert gt.bucket_capacity(n, minimum=64) == gj.bucket_capacity(n, minimum=64)


def test_edge_accumulator_grows_across_buckets_like_jax():
    rng = np.random.default_rng(2)
    ja, ta = JaxAccumulator(), EdgeAccumulator(device="cpu")
    caps = []
    for n_new in [3, 5, 1, 20, 0, 100, 400]:
        s = rng.integers(0, 64, n_new).astype(np.int32)
        d = rng.integers(0, 64, n_new).astype(np.int32)
        ja.append(s, d)
        # the port also takes device columns (the streaming path's form)
        ta.append(torch.from_numpy(s), d)
        assert ta.n_edges == ja.n_edges
        assert ta.src.shape[0] == ja.src.shape[0]
        np.testing.assert_array_equal(ta.src.numpy(), np.asarray(ja.src))
        np.testing.assert_array_equal(ta.dst.numpy(), np.asarray(ja.dst))
        np.testing.assert_array_equal(ta.mask().numpy(), np.asarray(ja.mask()))
        caps.append(ta.src.shape[0])
    assert caps == [8, 8, 16, 32, 32, 256, 1024]
    with pytest.raises(ValueError, match="int32"):
        ta.append(torch.zeros(2, dtype=torch.int64), np.zeros(2, np.int32))


def test_edge_accumulator_state_dict_round_trips_across_packages():
    rng = np.random.default_rng(3)
    s = rng.integers(0, 100, 77).astype(np.int32)
    d = rng.integers(0, 100, 77).astype(np.int32)
    ja = JaxAccumulator()
    ja.append(s, d)
    ta = EdgeAccumulator(device="cpu")
    ta.load_state_dict(ja.state_dict())
    np.testing.assert_array_equal(ta.state_dict()["src"], s)
    np.testing.assert_array_equal(ta.state_dict()["dst"], d)
    back = JaxAccumulator()
    back.load_state_dict(ta.state_dict())
    np.testing.assert_array_equal(np.asarray(back.src), ta.src.numpy())
    assert back.n_edges == ta.n_edges == 77


def test_edge_block_caches_are_keyed_by_device_and_shared():
    a = gt.EdgeBlock.from_arrays(np.arange(3), np.arange(3), n_vertices=8, device="cpu")
    b = gt.EdgeBlock.from_arrays(np.arange(3), np.arange(3), n_vertices=8, device="cpu")
    assert a.mask is b.mask and a.val is b.val
    assert a.capacity == 8 and a.mask.numpy().tolist() == [True] * 3 + [False] * 5
    c = gt.EdgeBlock.from_arrays(np.arange(9), np.arange(9), n_vertices=8, device="cpu")
    assert c.capacity == 16 and c.mask is not a.mask
    assert a.with_vertices(16).n_vertices == 16


def _meshed_slice_reduce(edges):
    stream = gt.SimpleEdgeStream(edges, device="cpu")
    stream.context.mesh = object()  # a context that carries a device mesh
    return stream.slice().reduce_on_edges("sum")


@pytest.mark.parametrize(
    "make",
    [
        # the window and neighborhood layer is ported (slice 4): what stays
        # for later slices on its paths still raises
        lambda e: DegreeDistribution.sliding(10, device="cpu"),
        # the exact counter is ported (slice 5); the triangle path's
        # edge-sharded count stays for slice 6
        lambda e: [ttri.window_triangle_count_sharded(e)],
        _meshed_slice_reduce,
        # streaming CC is ported (slice 2): what stays for later slices on
        # the aggregate, superbatch and file paths still raises
        lambda e: gt.SimpleEdgeStream(e, device="cpu").aggregate(
            ConnectedComponents.sliding(10)
        ),
        lambda e: gt.SimpleEdgeStream(e, device="cpu").superbatches_dynamic(lambda: 4),
        # the device vertex dictionary and iterative CC are ported (slice
        # 5b); iterative CC over a sharded mesh stays for slice 6
        lambda e: IterativeConnectedComponents(mesh=object()),
    ],
    ids=["degrees_sliding", "exact_triangles", "meshed_slice", "aggregate",
         "superbatches", "iterative_cc_mesh"],
)
def test_later_slices_raise_not_implemented_naming_their_slice(sample_edges, make):
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1, slice"):
        out = make(sample_edges)
        next(iter(out))


def test_entry_points_without_cpu_raise_when_cuda_is_absent(monkeypatch, sample_edges):
    """No fallback hides the device: with no card, every entry point that
    is not told device="cpu" raises instead of running on the CPU."""
    from gelly_streaming_tpu_torch.example import degree_distribution, window_triangles
    from gelly_streaming_tpu_torch.example import streaming_graphsage as example
    from gelly_streaming_tpu_torch.models import (
        TableFeatureSource,
        init_graphsage,
        params_from_numpy,
    )

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = [
        lambda: gt.SimpleEdgeStream(sample_edges),
        lambda: gt.StreamContext(),
        lambda: init_graphsage([4, 2], generator=torch.Generator()),
        lambda: TableFeatureSource(np.zeros((4, 2), np.float32)),
        lambda: params_from_numpy([{"b": np.zeros(2, np.float32)}]),
        lambda: example.run(sample_edges, 3),
        lambda: example.main([]),
        lambda: DegreeDistribution(),
        lambda: WindowTriangles(gt.CountWindow(3)),
        lambda: degree_distribution.main([]),
        lambda: window_triangles.main([]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert gt.StreamContext(device="cpu").device == torch.device("cpu")


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_and_chip_smoke_import_no_jax():
    files = sorted((REPO / "gelly_streaming_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 10
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "gelly_streaming_tpu"), (
                f"{path.relative_to(REPO)} imports {mod}"
            )


class _ListSink:
    def __init__(self):
        self.events = []

    def emit(self, event):
        self.events.append(event)


@pytest.fixture
def tracing():
    from gelly_streaming_tpu_torch.obs import trace

    sink = _ListSink()
    trace.add_sink(sink)
    try:
        yield trace, sink
    finally:
        trace.disable()
        trace.remove_sink(sink)


def test_span_nesting_and_attributes(tracing):
    """Mirror of ``test_obs.py::test_span_nesting_and_attributes`` (the
    registry mirror is not ported in this slice)."""
    trace, sink = tracing
    trace.enable()
    with trace.span("outer", {"window_index": 3}):
        with trace.span("inner", {"edges": 1024}):
            pass
    inner, outer = sink.events
    assert inner["name"] == "inner" and outer["name"] == "outer"
    assert inner["depth"] == 1 and outer["depth"] == 0
    assert inner["parent"] == outer["sid"] and "parent" not in outer
    assert inner["attrs"] == {"edges": 1024}
    assert outer["dur_s"] >= inner["dur_s"] >= 0


def test_disabled_span_is_the_shared_noop(tracing):
    trace, sink = tracing
    assert not trace.on()
    assert trace.span("pack") is trace.span("dispatch") is trace.NOOP_SPAN
    with trace.span("pack") as sp:
        assert sp is trace.NOOP_SPAN
    assert sink.events == []


def test_window_pack_spans_reach_sinks_and_the_torch_profiler(tracing, sample_edges):
    """Each window's pack is one ``window.pack`` span; with
    ``torch_annotations`` it is also a ``record_function`` range."""
    from torch.profiler import ProfilerActivity, profile

    trace, sink = tracing
    trace.enable(torch_annotations=True)
    stream = gt.SimpleEdgeStream(sample_edges, window=gt.CountWindow(3), device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert len(list(stream.blocks())) == 3
    packs = [e for e in sink.events if e["name"] == "window.pack"]
    assert [e["attrs"]["edges"] for e in packs] == [3, 3, 1]
    names = {e.key for e in prof.key_averages()}
    assert "window.pack" in names
