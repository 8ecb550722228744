"""Streaming bipartiteness: the port against the JAX package.

The same edges, made with numpy from a seed, go through
``gelly_streaming_tpu`` and ``gelly_streaming_tpu_torch`` (on the CPU),
each carry pinned explicitly on both sides. Verdicts and ``components``
must match exactly, window by window (the ``str`` of every emission), for
the forest, host and dense carries and ``superbatch`` K in {1, 4}; the
``snapshot_state`` format is one across carries and across packages.

Mirrors ``tests/test_library.py:89-101`` (the golden strings),
``tests/test_forest.py:191-345`` (cover forest against dense and truth, a
star and an odd cycle, growth across buckets, checkpoints across carries,
a held emission across dict growth) and ``tests/test_groupfold.py:73-100``
(group-fold conformance, host against forest), plus the CLI
(``tests/test_examples.py:65``).
"""

from collections import deque

import numpy as np
import pytest
import torch

import gelly_streaming_tpu as gj
import gelly_streaming_tpu_torch as gt
from gelly_streaming_tpu.example import bipartiteness_check as jax_cli
from gelly_streaming_tpu.library import BipartitenessCheck as JaxBC
from gelly_streaming_tpu.summaries import candidates as jcand
from gelly_streaming_tpu_torch.example import bipartiteness_check as torch_cli
from gelly_streaming_tpu_torch.library import BipartitenessCheck as TorchBC
from gelly_streaming_tpu_torch.summaries import candidates as tcand
from gelly_streaming_tpu_torch.summaries.forest import WindowPrep
from gelly_streaming_tpu_torch.summaries.groupfold import verify_group_fold

CARRIES = ["forest", "host", "dense"]
BIPARTITE_EDGES = [(1, 2), (1, 3), (1, 4), (4, 5), (4, 7), (4, 9)]
BIPARTITE_GOLDEN = (
    "(true,{1={1=(1,true), 2=(2,false), 3=(3,false), 4=(4,false), "
    "5=(5,true), 7=(7,true), 9=(9,true)}})"
)
NONBIPARTITE_EDGES = [(1, 2), (2, 3), (3, 1), (4, 5), (5, 7), (4, 1)]


def _jstream(edges, window):
    return gj.SimpleEdgeStream(edges, window=gj.CountWindow(window))


def _tstream(edges, window):
    return gt.SimpleEdgeStream(edges, window=gt.CountWindow(window), device="cpu")


def _run_both(edges, window, carry, k=1):
    jagg = JaxBC(carry=carry, superbatch=k)
    tagg = TorchBC(carry=carry, superbatch=k)
    jout = [str(c) for c in _jstream(edges, window).aggregate(jagg)]
    tout = [str(c) for c in _tstream(edges, window).aggregate(tagg)]
    return jout, tout, jagg, tagg


def _edges(seed, n=60, v=24):
    rng = np.random.default_rng(seed)
    return [(int(a), int(b), 0.0) for a, b in rng.integers(0, v, size=(n, 2)) if a != b]


def _bip_edges(seed, n=400, half=80):
    rng = np.random.default_rng(seed)
    return [(int(a), int(b), 0.0)
            for a, b in zip(rng.integers(0, half, n), rng.integers(half, 2 * half, n))]


def _py_bipartite(edges):
    adj = {}
    for a, b, *_ in edges:
        adj.setdefault(a, set()).add(b)
        adj.setdefault(b, set()).add(a)
    color = {}
    for s in adj:
        if s in color:
            continue
        color[s] = 0
        q = deque([s])
        while q:
            x = q.popleft()
            for y in adj[x]:
                if y not in color:
                    color[y] = color[x] ^ 1
                    q.append(y)
                elif color[y] == color[x]:
                    return False
    return True


@pytest.mark.parametrize("carry", CARRIES)
@pytest.mark.parametrize("window", [1, 3, 6])
def test_golden_strings_match_jax(carry, window):
    jout, tout, _, _ = _run_both([(a, b, 0.0) for a, b in BIPARTITE_EDGES], window, carry)
    assert tout == jout and tout[-1] == BIPARTITE_GOLDEN
    jout, tout, _, _ = _run_both([(a, b, 0.0) for a, b in NONBIPARTITE_EDGES], window, carry)
    assert tout == jout and tout[-1] == "(false,{})"


@pytest.mark.parametrize("carry", CARRIES)
@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("seed,window", [(1, 3), (2, 16), (5, 64)])
def test_carries_match_jax_and_truth(carry, k, seed, window):
    edges = _edges(seed)
    jout, tout, jagg, tagg = _run_both(edges, window, carry, k)
    assert tout == jout
    assert tagg._bp_mode == jagg._bp_mode == carry
    assert (tout[-1] != "(false,{})") == _py_bipartite(edges)


@pytest.mark.parametrize("carry", CARRIES)
@pytest.mark.parametrize("k", [1, 4])
def test_bipartite_stream_with_late_odd_cycle_matches_jax(carry, k):
    edges = _bip_edges(3) + [(0, 1, 0.0), (1, 2, 0.0), (2, 0, 0.0)] + _bip_edges(4, n=60)
    jout, tout, _, _ = _run_both(edges, 23, carry, k)
    assert tout == jout
    assert tout[-1] == "(false,{})" and tout[0] != "(false,{})"


@pytest.mark.parametrize("carry", ["forest", "host"])
def test_star_and_odd_cycle_latch(carry):
    star = [(0, i, 0.0) for i in range(1, 40)]
    jout, tout, _, tagg = _run_both(star, 7, carry)
    assert tout == jout and tout[-1].startswith("(true,") and tagg._bp_mode == carry
    cyc = star + [(1, 2, 0.0), (2, 3, 0.0), (3, 1, 0.0), (50, 51, 0.0)]
    jout, tout, _, _ = _run_both(cyc, 2, carry)
    assert tout == jout and tout[-1] == "(false,{})"


@pytest.mark.parametrize("carry", CARRIES)
@pytest.mark.parametrize("k", [1, 4])
def test_growth_across_buckets_matches_jax(carry, k):
    """Vertex growth re-indexes the negative cover half (ids AND pointer
    values shift) without corrupting components or the verdict."""
    path = [(i, i + 1, 0.0) for i in range(300)]  # even path: bipartite
    for edges, want in ((path, True), (path + [(0, 299, 0.0)], True),
                        (path + [(0, 298, 0.0)], False)):
        jout, tout, _, _ = _run_both(edges, 7, carry, k)
        assert tout == jout
        assert tout[-1].startswith("(true,") == want


@pytest.mark.parametrize("carry", ["forest", "host"])
def test_held_emissions_keep_their_window(carry):
    """Emissions read after later windows (and after the dict grew past
    their vcap) give what a read in stream order gives."""
    edges = [(i, i + 1, 0.0) for i in range(60)]
    eager = [str(c) for c in _tstream(edges, 2).aggregate(TorchBC(carry=carry))]
    held = list(_tstream(edges, 2).aggregate(TorchBC(carry=carry)))
    assert held[-1].success and held[0].success
    assert [str(c) for c in reversed(held)] == eager[::-1]
    assert set(held[0].components) == {0}


@pytest.mark.parametrize("carry", CARRIES)
def test_group_fold_conformance_and_out_of_order_reads(carry):
    edges = _bip_edges(7, n=300) + _edges(8, n=40, v=160)
    verify_group_fold(lambda kk: TorchBC(carry=carry, superbatch=kk),
                      lambda: _tstream(edges, 23), 4)
    ems = list(_tstream(edges, 23).aggregate(TorchBC(carry=carry, superbatch=8)))
    back = [str(c) for c in reversed(ems)][::-1]
    assert back == [str(c) for c in _tstream(edges, 23).aggregate(TorchBC(carry=carry))]


def test_host_and_forest_identical():
    edges = _bip_edges(9) + _edges(10, n=30, v=160)
    base = [str(c) for c in _tstream(edges, 23).aggregate(TorchBC(carry="forest"))]
    for k in (1, 4):
        got = [str(c) for c in _tstream(edges, 23).aggregate(TorchBC(carry="host", superbatch=k))]
        assert got == base


@pytest.mark.parametrize("src_carry", CARRIES)
@pytest.mark.parametrize("dst_carry", CARRIES)
def test_snapshot_restored_across_carries(src_carry, dst_carry):
    edges = _edges(11, n=80, v=20)
    first, second = edges[:40], edges[40:]
    agg = TorchBC(carry=src_carry)
    list(_tstream(first, 5).aggregate(agg))
    state = agg.snapshot_state()
    assert state["labels"].shape == state["touched"].shape
    agg2 = TorchBC(carry=dst_carry)
    agg2.restore_state(state)
    last = None
    for last in _cont_stream(first, second, 5).aggregate(agg2):
        pass
    assert last.success == _py_bipartite(edges)


def _cont_stream(first, second, window):
    """The second half of a stream with the first half's vertex dict."""
    from gelly_streaming_tpu_torch.core.vertexdict import VertexDict

    vd = VertexDict()
    raw = np.array([[a, b] for a, b, _ in first], np.int64)
    vd.encode(raw.reshape(-1))
    return gt.SimpleEdgeStream(second, window=gt.CountWindow(window), vertex_dict=vd,
                               device="cpu")


@pytest.mark.parametrize("carry", ["forest", "host", "dense"])
@pytest.mark.parametrize("restore_in", ["port", "jax"])
def test_snapshot_state_across_packages(carry, restore_in):
    """A cover snapshot of one package restores in the other; the next
    windows' verdicts and components agree."""
    from gelly_streaming_tpu.core.vertexdict import VertexDict as JaxVertexDict
    from gelly_streaming_tpu_torch.core.vertexdict import VertexDict

    edges = _bip_edges(12, n=200, half=40)
    first, second = edges[:120], edges[120:] + [(0, 1, 0.0), (1, 2, 0.0), (2, 0, 0.0)]
    raw = np.array([[a, b] for a, b, _ in first], np.int64).reshape(-1)
    jagg, tagg = JaxBC(carry=carry), TorchBC(carry=carry)
    list(_jstream(first, 30).aggregate(jagg))
    list(_tstream(first, 30).aggregate(tagg))
    js, ts = jagg.snapshot_state(), tagg.snapshot_state()
    np.testing.assert_array_equal(np.asarray(js["labels"]), ts["labels"])
    np.testing.assert_array_equal(np.asarray(js["touched"]), ts["touched"])
    jd, td = JaxVertexDict(), VertexDict()
    jd.encode(raw)
    td.encode(raw)
    want_agg = JaxBC(carry=carry)
    want_agg.restore_state(js)
    want = [str(c) for c in gj.SimpleEdgeStream(
        second, window=gj.CountWindow(30), vertex_dict=jd).aggregate(want_agg)]
    if restore_in == "port":
        agg2 = TorchBC(carry=carry)
        agg2.restore_state({k: np.asarray(v) for k, v in js.items()})
        got = [str(c) for c in gt.SimpleEdgeStream(
            second, window=gt.CountWindow(30), vertex_dict=td, device="cpu").aggregate(agg2)]
    else:
        jd2 = JaxVertexDict()
        jd2.encode(raw)
        agg2 = JaxBC(carry=carry)
        agg2.restore_state(ts)
        got = [str(c) for c in gj.SimpleEdgeStream(
            second, window=gj.CountWindow(30), vertex_dict=jd2).aggregate(agg2)]
    assert got == want and got[-1] == "(false,{})" and got[0] != "(false,{})"


def test_transient_state_matches_jax():
    edges = _edges(13, n=60)
    for carry in CARRIES:
        jagg, tagg = JaxBC(carry=carry, transient_state=True), TorchBC(carry=carry,
                                                                        transient_state=True)
        jout = [str(c) for c in _jstream(edges, 7).aggregate(jagg)]
        tout = [str(c) for c in _tstream(edges, 7).aggregate(tagg)]
        assert tout == jout


def test_cover_steps_match_jax():
    """The cover window step, its pad mask and the re-index rule, op by op."""
    rng = np.random.default_rng(14)
    vcap = 32
    canon_t = torch.arange(2 * vcap, dtype=torch.int32)
    canon_j = np.arange(2 * vcap, dtype=np.int32)
    failed_t = torch.tensor(False)
    import jax.numpy as jnp

    from gelly_streaming_tpu.summaries.forest import WindowPrep as JaxWindowPrep

    failed_j = jnp.bool_(False)
    canon_j = jnp.asarray(canon_j)
    tp, jp = WindowPrep(), JaxWindowPrep()
    for _ in range(5):
        s = rng.integers(0, vcap, 9).astype(np.int32)
        d = rng.integers(0, vcap, 9).astype(np.int32)
        canon_t, failed_t, tids_t = tcand.cover_forest_window(canon_t, failed_t, s, d, vcap, tp)
        canon_j, failed_j, tids_j = jcand.cover_forest_window(canon_j, failed_j, s, d, vcap, jp)
        np.testing.assert_array_equal(np.sort(tids_t), np.sort(tids_j))
        assert bool(failed_t) == bool(failed_j)
        from gelly_streaming_tpu_torch.summaries.forest import resolve_flat_host

        np.testing.assert_array_equal(resolve_flat_host(canon_t.numpy()),
                                      resolve_flat_host(np.asarray(canon_j)))
    lab = rng.integers(0, 2 * vcap, 2 * vcap).astype(np.int32)
    np.testing.assert_array_equal(tcand._shift_cover_labels(lab, vcap, 4 * vcap),
                                  jcand._shift_cover_labels(lab, vcap, 4 * vcap))
    # a pad row (0, 0) must not fabricate an odd cycle
    c2, f2, _ = tcand.cover_forest_window(torch.arange(2 * vcap, dtype=torch.int32),
                                          torch.tensor(False), np.array([1], np.int32),
                                          np.array([2], np.int32), vcap, WindowPrep())
    assert not bool(f2)


def test_coloring_is_a_proper_two_coloring():
    edges = _bip_edges(15, n=200, half=50)
    last = list(_tstream(edges, 50).aggregate(TorchBC(carry="forest")))[-1]
    ids, comp, sign = last.coloring()
    raw = dict(zip(last._lazy[5].decode(ids).tolist(), zip(comp.tolist(), sign.tolist())))
    for a, b, _ in edges:
        assert raw[a][0] == raw[b][0] and raw[a][1] != raw[b][1]
    want = {r: s for vs in last.components.values() for r, s in vs.items()}
    assert {r: s for r, (_, s) in raw.items()} == want


def test_later_slices_raise():
    # the event-time shape is ported (slice 8); its serving payload stays
    sliding = TorchBC.sliding(10)
    assert sliding.summaries == ("bipartite",)
    with pytest.raises(NotImplementedError, match="slice 9"):
        sliding.servable_payload()
    with pytest.raises(NotImplementedError, match="slice 9"):
        TorchBC().servable()
    with pytest.raises(NotImplementedError, match="slice 6"):
        TorchBC(mesh=object())


def test_cli_matches_jax(tmp_path):
    inp = tmp_path / "edges.txt"
    for text in ("1 2\n2 3\n3 1\n", "1 2\n1 3\n1 4\n4 5\n4 7\n4 9\n"):
        inp.write_text(text)
        jo, to = tmp_path / "j.txt", tmp_path / "t.txt"
        jax_cli.main([str(inp), "10", str(jo)])
        torch_cli.main(["--cpu", str(inp), "10", str(to)])
        assert to.read_text() == jo.read_text()
    assert to.read_text().strip() == BIPARTITE_GOLDEN
