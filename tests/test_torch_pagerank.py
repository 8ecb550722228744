"""Incremental PageRank: the port against the JAX package.

The same edges, made with numpy from a seed, go through
``gelly_streaming_tpu`` and ``gelly_streaming_tpu_torch`` (on the CPU).
Ranks must agree within abs 1e-6 and sum to 1 within 1e-5; the per-window
iteration counts must be equal wherever the convergence test is decided
above float32 rounding (tol 1e-4 and 1e-5 here); ``l1_delta`` must be at
most ``tol`` wherever the reference converged.

Below that the count is decided by rounding, not by the data: at the
default tol 1e-6 the L1 change of a converging window sits at the float32
noise floor of a few hundred ranks, and at the reference tests' 1e-8..1e-10
(a few ranks of about 0.2, whose float32 spacing is 1.5e-8) a window
converges only when the iteration lands on an exact float32 fixed point.
The reference's own jitted step and its eager run round differently there
(``(1 - d) / n + d * (...)`` fuses differently), so the counts are not
compared at those tolerances: the ranks are, within 1e-6, and the default
tol's counts within 2 (``test_default_tol_iterations_within_two_of_jax``).

Mirrors ``tests/test_pagerank_sage.py:38-75`` (dense reference, warm start,
dangling mass), the PageRank cases of ``tests/test_groupfold.py``
(``superbatch`` values and ranks, the identity dict, the conformance
check), a vertex-capacity growth mid-stream, the cross-package
``state_dict`` both ways, and the CLI (``tests/test_examples.py:128``).
"""

import numpy as np
import pytest
import torch

import gelly_streaming_tpu as gj
import gelly_streaming_tpu_torch as gt
from gelly_streaming_tpu.datasets import IdentityDict as JaxIdentityDict
from gelly_streaming_tpu.example import incremental_pagerank as jax_cli
from gelly_streaming_tpu.library.pagerank import IncrementalPageRank as JaxPR
from gelly_streaming_tpu_torch.datasets import IdentityDict
from gelly_streaming_tpu_torch.example import incremental_pagerank as torch_cli
from gelly_streaming_tpu_torch.library import pagerank as tpr
from gelly_streaming_tpu_torch.library.pagerank import IncrementalPageRank as TorchPR
from gelly_streaming_tpu_torch.summaries.groupfold import verify_group_fold

RANK_TOL = 1e-6
SUM_TOL = 1e-5

EDGES = [
    (1, 2, 0.0), (2, 3, 0.0), (3, 1, 0.0), (3, 4, 0.0),
    (4, 5, 0.0), (5, 1, 0.0), (2, 4, 0.0), (6, 1, 0.0),
]


def reference_pagerank(edges, d=0.85, tol=1e-10):
    """Dense float64 power iteration (tests/test_pagerank_sage.py:11)."""
    verts = sorted({v for e in edges for v in e[:2]})
    idx = {v: i for i, v in enumerate(verts)}
    n = len(verts)
    out_deg = np.zeros(n)
    for s, _t, *_ in edges:
        out_deg[idx[s]] += 1
    r = np.full(n, 1.0 / n)
    for _ in range(10000):
        new = np.zeros(n)
        for s, t, *_ in edges:
            new[idx[t]] += r[idx[s]] / out_deg[idx[s]]
        dangling = sum(r[i] for i in range(n) if out_deg[i] == 0)
        new = (1 - d) / n + d * (new + dangling / n)
        if np.abs(new - r).sum() < tol:
            break
        r = new
    return {v: r[idx[v]] for v in verts}


def _edges(seed, n=600, v=120, lo=0):
    rng = np.random.default_rng(seed)
    return [(int(a), int(b), 0.0) for a, b in rng.integers(lo, v, size=(n, 2))]


def _run_both(edges, window, vdict_bound=None, **kw):
    jd = JaxIdentityDict(vdict_bound) if vdict_bound else None
    td = IdentityDict(vdict_bound) if vdict_bound else None
    jp, tp = JaxPR(**kw), TorchPR(**kw)
    je = list(jp.run(gj.SimpleEdgeStream(edges, window=gj.CountWindow(window), vertex_dict=jd)))
    te = list(tp.run(gt.SimpleEdgeStream(edges, window=gt.CountWindow(window),
                                         vertex_dict=td, device="cpu")))
    return je, te, jp, tp


def _assert_ranks_close(jp, tp):
    jr, tr = jp.ranks(), tp.ranks()
    assert set(jr) == set(tr)
    err = max(abs(jr[v] - tr[v]) for v in jr)
    assert err <= RANK_TOL, err
    assert sum(tr.values()) == pytest.approx(1.0, abs=SUM_TOL)


def _iters(emissions):
    return [int(e.iterations) for e in emissions]


def test_pagerank_matches_dense_reference_and_jax():
    je, te, jp, tp = _run_both(EDGES, 3, tol=1e-9, max_iter=500)
    assert len(te) == 3
    want = reference_pagerank(EDGES)
    got = tp.ranks()
    for v in want:
        assert got[v] == pytest.approx(want[v], abs=1e-5), v
    _assert_ranks_close(jp, tp)


def test_warm_start_converges_faster():
    rng = np.random.default_rng(0)
    big = [(int(a), int(b), 0.0) for a, b in rng.integers(0, 200, (2000, 2))]
    small = [(int(a), int(b), 0.0) for a, b in rng.integers(0, 200, (20, 2))]
    je, te, jp, tp = _run_both(big + small, 2000, tol=1e-8, max_iter=500)
    first, second = te
    assert int(second.iterations) < int(first.iterations)
    assert int(second.iterations) < 30
    _assert_ranks_close(jp, tp)


def test_dangling_mass_conserved():
    edges = [(1, 3, 0.0), (2, 3, 0.0)]  # vertex 3 is a sink
    je, te, jp, tp = _run_both(edges, 10, tol=1e-10, max_iter=500)
    got = tp.ranks()
    want = reference_pagerank(edges)
    for v in want:
        assert got[v] == pytest.approx(want[v], abs=1e-6)
    _assert_ranks_close(jp, tp)


@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("tol", [1e-4, 1e-5])
@pytest.mark.parametrize("seed,window", [(1, 50), (2, 23)])
def test_per_window_iterations_and_ranks_match_jax(k, tol, seed, window):
    edges = _edges(seed)
    je, te, jp, tp = _run_both(edges, window, tol=tol, superbatch=k)
    assert len(te) == len(je) == -(-len(edges) // window)
    assert _iters(je) == _iters(te)
    assert [e.num_vertices for e in je] == [e.num_vertices for e in te]
    assert [e.window for e in te] == list(range(len(te)))
    for a, b in zip(je, te):
        if int(a.iterations) < jp.max_chunks * jp.chunk:  # the reference converged
            assert float(b.l1_delta) <= tol
    _assert_ranks_close(jp, tp)
    assert tp._n_edges == jp._n_edges == len(edges)


@pytest.mark.parametrize("k", [1, 4])
def test_default_tol_iterations_within_two_of_jax(k):
    """tol 1e-6 is the float32 noise floor of these L1 changes: iteration
    counts agree within 2 (here most are equal), ranks within 1e-6."""
    diffs = []
    for seed in range(3):
        je, te, jp, tp = _run_both(_edges(10 + seed, n=1200, v=200), 100, superbatch=k)
        diffs += [abs(a - b) for a, b in zip(_iters(je), _iters(te))]
        for a, b in zip(je, te):
            if int(a.iterations) < jp.max_chunks * jp.chunk:
                assert float(b.l1_delta) <= jp.tol
        _assert_ranks_close(jp, tp)
    assert max(diffs) <= 2
    assert sum(d == 0 for d in diffs) >= 0.9 * len(diffs)


def test_vertex_capacity_growth_midstream_matches_jax():
    """Ids jump past the vertex bucket mid-stream (8 -> 16 -> ... -> 512)."""
    edges = _edges(3, n=80, v=8) + _edges(4, n=200, v=100) + _edges(5, n=300, v=500)
    je, te, jp, tp = _run_both(edges, 40, tol=1e-5)
    assert _iters(je) == _iters(te)
    assert [e.num_vertices for e in je] == [e.num_vertices for e in te]
    assert tp._carry[2].shape[0] == jp._carry[2].shape[0] == 512
    _assert_ranks_close(jp, tp)


def test_identity_dict_with_dangling_vertices_matches_jax():
    rng = np.random.default_rng(6)
    # the second half of the ids only ever receives: sinks
    edges = [(int(a), int(b), 0.0)
             for a, b in zip(rng.integers(0, 64, 500), rng.integers(0, 128, 500))]
    for k in (1, 4):
        je, te, jp, tp = _run_both(edges, 64, vdict_bound=128, tol=1e-5, superbatch=k)
        assert _iters(je) == _iters(te)
        _assert_ranks_close(jp, tp)


def test_group_fold_conformance():
    """verify_group_fold: superbatch K emissions equal the per-window ones
    (iterations, seen vertices; the L1 change within float tolerance)."""
    edges = _edges(7, n=400)

    def norm(e):
        return (e.window, e.num_vertices, int(e.iterations), round(float(e.l1_delta), 9))

    verify_group_fold(
        lambda kk: TorchPR(tol=1e-5, superbatch=kk),
        lambda: gt.SimpleEdgeStream(edges, window=gt.CountWindow(23), device="cpu"),
        4, normalize=norm,
    )


def test_host_reads_are_one_per_chunk():
    edges = _edges(8, n=300)
    tpr.HOST_READS = 0
    te = list(TorchPR(tol=1e-5, chunk=10).run(
        gt.SimpleEdgeStream(edges, window=gt.CountWindow(100), device="cpu")))
    want = sum(-(-int(e.iterations) // 10) for e in te)
    assert tpr.HOST_READS == want


@pytest.mark.parametrize("restore_in", ["port", "jax"])
def test_state_dict_across_packages_continues(restore_in):
    """A state saved by one package continues in the other: the next
    windows' iterations equal and ranks within 1e-6."""
    first, second = _edges(20, n=300, v=150), _edges(21, n=300, v=180)
    vb = 256

    def jstream(e):
        return gj.SimpleEdgeStream(e, window=gj.CountWindow(60), vertex_dict=JaxIdentityDict(vb))

    def tstream(e):
        return gt.SimpleEdgeStream(e, window=gt.CountWindow(60), vertex_dict=IdentityDict(vb),
                                   device="cpu")

    base = JaxPR(tol=1e-5)
    list(base.run(jstream(first)))
    want = list(base.run(jstream(second)))
    if restore_in == "port":
        resumed = TorchPR(tol=1e-5)
        src = JaxPR(tol=1e-5)
        list(src.run(jstream(first)))
        resumed.load_state_dict(src.state_dict())
        got = list(resumed.run(tstream(second)))
    else:
        src = TorchPR(tol=1e-5)
        list(src.run(tstream(first)))
        state = src.state_dict()
        assert state["ranks"].dtype == np.float32 and state["n_seen"] == 150
        resumed = JaxPR(tol=1e-5)
        resumed.load_state_dict(state)
        got = list(resumed.run(jstream(second)))
    assert _iters(got) == _iters(want)
    _assert_ranks_close(base, resumed)


def test_state_dict_format_matches_jax():
    je, te, jp, tp = _run_both(_edges(22, n=200), 50, tol=1e-5)
    js, ts = jp.state_dict(), tp.state_dict()
    assert set(js) == set(ts)
    np.testing.assert_array_equal(np.asarray(js["edges"]["src"]), ts["edges"]["src"])
    np.testing.assert_array_equal(np.asarray(js["edges"]["dst"]), ts["edges"]["dst"])
    np.testing.assert_allclose(np.asarray(js["ranks"]), ts["ranks"], atol=RANK_TOL)
    assert js["n_seen"] == ts["n_seen"]
    empty = TorchPR().state_dict()
    assert empty["ranks"] is None and len(empty["edges"]["src"]) == 0


def test_later_slices_and_capacity_rule_raise():
    # superbatch="auto" is ported (slice 7b's control half)
    assert TorchPR(superbatch="auto").superbatch_auto
    with pytest.raises(ValueError, match='"auto"'):
        TorchPR(superbatch="Auto")
    with pytest.raises(NotImplementedError, match="slice 6"):
        TorchPR(mesh=object())
    with pytest.raises(NotImplementedError, match="slice 9"):
        TorchPR().servable()
    carry = (torch.zeros(8, dtype=torch.int32), torch.zeros(8, dtype=torch.int32),
             torch.zeros(4))
    with pytest.raises(AssertionError, match="capacity"):
        tpr._window_step(carry, torch.zeros(8, dtype=torch.int32),
                         torch.zeros(8, dtype=torch.int32), 4, 4, 4, 0.85, 1e-6, 10, 1)


def test_cli_matches_jax(tmp_path, capsys):
    inp = tmp_path / "edges.txt"
    inp.write_text("1 2\n2 3\n3 1\n3 4\n4 1\n5 4\n")
    jo, to = tmp_path / "j.txt", tmp_path / "t.txt"
    jax_cli.main([str(inp), "2", str(jo)])
    torch_cli.main(["--cpu", str(inp), "2", str(to)])
    assert to.read_text() == jo.read_text()
    vals = [float(ln.strip("()").split(",")[1]) for ln in to.read_text().splitlines()]
    assert len(vals) == 5 and sum(vals) == pytest.approx(1.0, abs=1e-3)
    torch_cli.main(["--cpu", "--corpus", str(inp), "3"])
    assert "Runtime:" in capsys.readouterr().out


def test_cacheless_group_falls_back_per_window():
    """Groups whose blocks carry no host columns take the declared
    per-window fallback with the same values (tests/test_groupfold.py:227)."""
    from gelly_streaming_tpu_torch.core.edgeblock import EdgeBlock

    rng = np.random.default_rng(19)
    wins = [(rng.integers(0, 160, 40).astype(np.int32), rng.integers(0, 160, 40).astype(np.int32))
            for _ in range(6)]

    class Bare:
        device = torch.device("cpu")

        def __init__(self):
            self.vertex_dict = IdentityDict(160)
            self.vertex_dict.observe(159)

        def blocks(self):
            for s, d in wins:
                yield EdgeBlock.from_arrays(s, d, None, n_vertices=160, device="cpu")

    def rerun(k):
        pr = TorchPR(tol=1e-5, superbatch=k)
        return [(e.window, e.num_vertices, int(e.iterations)) for e in pr.run(Bare())], pr

    base, p1 = rerun(1)
    got, p4 = rerun(4)
    assert got == base and len(got) == 6
    assert torch.allclose(p1._carry[2], p4._carry[2], atol=RANK_TOL)


def test_entry_points_without_cpu_raise_when_cuda_is_absent(monkeypatch):
    """No fallback hides the device: the slice's CLIs and streams not told
    --cpu / device="cpu" raise when there is no card."""
    from gelly_streaming_tpu_torch.example import (
        bipartiteness_check,
        exact_triangle_count,
        spanner,
    )

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for cli in (torch_cli, bipartiteness_check, exact_triangle_count, spanner):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cli.main([])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        torch_cli.run(EDGES, 3)
