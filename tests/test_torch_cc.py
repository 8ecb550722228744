"""Streaming Connected Components: the port against the JAX package.

The same edges, made with numpy from a seed, go through
``gelly_streaming_tpu`` and ``gelly_streaming_tpu_torch`` (on the CPU,
``device="cpu"``), each carry pinned explicitly on both sides (the JAX
package's ``auto`` picks ``host`` on a CPU). Integer results must match
exactly: per-window ``Components``, ``snapshot_state()`` labels and
touched masks, component counts, and the device steps' outputs.

Mirrors ``tests/test_forest.py:39-183`` (carries against dense and truth,
snapshot isolation, adversarial re-rooting, growth across buckets,
``transient_state``, the downgrade to dense, and the checkpoint round
trip, here in memory through ``snapshot_state``/``restore_state`` and
across the two packages), ``tests/test_library.py:37-56, 79`` (the
6-edge golden, its ``str`` format, the tree variant, intermediate
emissions), ``tests/test_summaries.py:87-140`` (``cc_fold``,
``label_combine``, ``grow_labels``) and ``tests/test_superbatch.py:56-90``
(superbatch emissions, out-of-order reads, checkpoint states).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gelly_streaming_tpu as gj
import gelly_streaming_tpu_torch as gt
from gelly_streaming_tpu import datasets as jax_datasets
from gelly_streaming_tpu.library import ConnectedComponents as JaxCC
from gelly_streaming_tpu.library import ConnectedComponentsTree as JaxCCTree
from gelly_streaming_tpu.summaries import forest as jax_forest
from gelly_streaming_tpu.summaries import labels as jax_labels
from gelly_streaming_tpu_torch import datasets as torch_datasets
from gelly_streaming_tpu_torch.library import ConnectedComponents as TorchCC
from gelly_streaming_tpu_torch.library import ConnectedComponentsTree as TorchCCTree
from gelly_streaming_tpu_torch.library.connected_components import _auto_carry
from gelly_streaming_tpu_torch.summaries import forest as torch_forest
from gelly_streaming_tpu_torch.summaries import labels as torch_labels

from _uf import union_find_components

CARRIES = ["forest", "host", "dense"]
CC_EDGES = [(1, 2, 0.0), (1, 3, 0.0), (2, 3, 0.0), (1, 5, 0.0), (6, 7, 0.0), (8, 9, 0.0)]
CC_EXPECTED = [frozenset({1, 2, 3, 5}), frozenset({6, 7}), frozenset({8, 9})]


def _jstream(edges, window, vdict=None):
    return gj.SimpleEdgeStream(edges, window=gj.CountWindow(window), vertex_dict=vdict)


def _tstream(edges, window, vdict=None):
    return gt.SimpleEdgeStream(
        edges, window=gt.CountWindow(window), vertex_dict=vdict, device="cpu"
    )


def _random_edges(seed, n, v):
    rng = np.random.default_rng(seed)
    return [(int(a), int(b), 0.0) for a, b in rng.integers(0, v, size=(n, 2))]


def _run_both(edges, window, carry, **kw):
    """Per-window emission strings of both packages, and both aggs."""
    jagg = JaxCC(carry=carry, **kw)
    tagg = TorchCC(carry=carry, **kw)
    jout = [str(c) for c in _jstream(edges, window).aggregate(jagg)]
    tout = [str(c) for c in _tstream(edges, window).aggregate(tagg)]
    return jout, tout, jagg, tagg


def _states_equal(a, b):
    np.testing.assert_array_equal(np.asarray(a["labels"]), np.asarray(b["labels"]))
    np.testing.assert_array_equal(np.asarray(a["touched"]), np.asarray(b["touched"]))


# --------------------------------------------------------------------- #
# Carries against dense, truth and the JAX package (test_forest.py)
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("carry", CARRIES)
@pytest.mark.parametrize("window", [1, 3, 16, 64])
def test_carry_matches_jax_dense_and_truth(window, carry):
    edges = _random_edges(17, 120, 40)
    jout, tout, jagg, tagg = _run_both(edges, window, carry)
    assert tagg._cc_mode == carry
    assert tout == jout
    dense = [str(c) for c in _tstream(edges, window).aggregate(TorchCC(carry="dense"))]
    assert tout == dense
    _states_equal(tagg.snapshot_state(), jagg.snapshot_state())
    last = None
    for last in _tstream(edges, window).aggregate(TorchCC(carry=carry)):
        pass
    assert set(last.component_sets()) == set(union_find_components(edges))


def test_auto_carry_reads_the_stream_device():
    """``auto`` is "forest" on a CUDA device and, on the CPU, "host" where
    the native library builds (the JAX package reads its global backend)."""
    assert _auto_carry(torch.device("cuda", 0)) == "forest"
    assert _auto_carry(torch.device("cpu")) == "host"
    edges = [(i, i + 1, 0.0) for i in range(20)]
    agg = TorchCC()
    for _ in _tstream(edges, 4).aggregate(agg):
        pass
    assert agg._cc_mode == "host" and agg._canon is not None


@pytest.mark.parametrize("carry", ["forest", "host"])
def test_emission_snapshot_isolation(carry):
    """An early emission read AFTER later windows reflects ITS window: the
    commit copies the forest, so no later window writes an emitted one."""
    edges = [(0, 1, 0.0), (2, 3, 0.0), (1, 2, 0.0), (4, 5, 0.0)]
    emissions = list(_tstream(edges, 1).aggregate(TorchCC(carry=carry)))
    assert set(emissions[-1].component_sets()) == {frozenset({0, 1, 2, 3}), frozenset({4, 5})}
    assert emissions[0].component_sets() == [frozenset({0, 1})]
    assert set(emissions[1].component_sets()) == {frozenset({0, 1}), frozenset({2, 3})}
    assert emissions[2].component_sets() == [frozenset({0, 1, 2, 3})]


@pytest.mark.parametrize("carry", ["forest", "host"])
def test_adversarial_rerooting_chains(carry):
    """Each window joins a new SMALLER vertex, re-rooting the component
    every time: the worst case for pointer chains."""
    n = 60
    edges = [(n - i, n - i - 1, 0.0) for i in range(n)]
    jout, tout, _, _ = _run_both(edges, 1, carry)
    assert tout == jout
    emissions = list(_tstream(edges, 1).aggregate(TorchCC(carry=carry)))
    assert emissions[-1].component_sets() == [frozenset(range(n + 1))]
    (comp,) = emissions[n // 2].component_sets()
    assert comp == frozenset(range(n - (n // 2) - 1, n + 1))
    assert list(emissions[-1].components.keys()) == [0]


@pytest.mark.parametrize("carry", ["forest", "host"])
def test_growth_across_capacity_buckets(carry):
    edges = [(i, i + 1, 0.0) for i in range(300)]
    jout, tout, jagg, tagg = _run_both(edges, 7, carry)
    assert tout == jout
    assert tagg._vcap == jagg._vcap == 512
    _states_equal(tagg.snapshot_state(), jagg.snapshot_state())


@pytest.mark.parametrize("carry", CARRIES)
def test_transient_state_is_per_window(carry):
    edges = [(0, 1, 0.0), (1, 2, 0.0), (3, 4, 0.0), (0, 4, 0.0)]
    out = [
        e.component_sets()
        for e in _tstream(edges, 1).aggregate(TorchCC(transient_state=True, carry=carry))
    ]
    assert out == [
        [frozenset({0, 1})], [frozenset({1, 2})], [frozenset({3, 4})], [frozenset({0, 4})],
    ]
    jout, tout, _, _ = _run_both(edges, 1, carry, transient_state=True)
    assert tout == jout


@pytest.mark.parametrize("carry", ["forest", "host"])
def test_downgrade_to_dense_midstream(carry):
    """A windowed carry that meets blocks without host columns downgrades
    to the dense engine without losing merges, in both packages."""
    edges1 = [(0, 1, 0.0), (2, 3, 0.0)]
    edges2 = [(1, 2, 0.0), (4, 5, 0.0)]
    expected = {frozenset({0, 1, 2, 3}), frozenset({4, 5})}

    tagg = TorchCC(carry=carry)
    s1 = _tstream(edges1, 1)
    for _ in tagg.run(s1):
        pass
    assert tagg._cc_mode == carry
    vd = s1.vertex_dict
    # dataclasses.replace drops the host cache: the blocks then hold only
    # device columns, like a device-transformed stream's
    s2 = gt.SimpleEdgeStream(
        _blocks=lambda: (dataclasses.replace(b) for b in _tstream(edges2, 1, vd).blocks()),
        _vdict=vd, device="cpu",
    )
    tout = [str(c) for c in tagg.run(s2)]
    assert tagg._cc_mode == "dense"

    jagg = JaxCC(carry=carry)
    j1 = _jstream(edges1, 1)
    for _ in jagg.run(j1):
        pass
    j2 = gj.SimpleEdgeStream(
        edges2, window=gj.CountWindow(1), vertex_dict=j1.vertex_dict
    ).map_edges(lambda s, d, v: v)
    jout = [str(c) for c in jagg.run(j2)]
    assert jagg._cc_mode == "dense"
    assert tout == jout
    assert set(TorchCC(carry="dense").transform(tagg._summary, vd).component_sets()) == expected


def _first_windows(agg, stream, n):
    it = agg.run(stream)
    for _ in range(n):
        next(it)
    it.close()


@pytest.mark.parametrize("carry", ["forest", "host"])
@pytest.mark.parametrize("restore_in", ["port", "jax"])
def test_checkpoint_roundtrip_across_packages(carry, restore_in):
    """The checkpoint format (canonical flat labels + touched) is shared by
    the carries and by the two packages: a state snapshotted after 4
    windows in either package, restored into the OTHER windowed carry of
    the other package (or the port), continues to the right components."""
    edges = _random_edges(23, 80, 30)
    bound = 32
    other = "host" if carry == "forest" else "forest"
    tagg = TorchCC(carry=carry)
    _first_windows(tagg, _tstream(edges, 10, torch_datasets.IdentityDict(bound)), 4)
    jagg = JaxCC(carry=carry)
    _first_windows(jagg, _jstream(edges, 10, jax_datasets.IdentityDict(bound)), 4)
    assert tagg._cc_mode == jagg._cc_mode == carry
    t_state, j_state = tagg.snapshot_state(), jagg.snapshot_state()
    _states_equal(t_state, j_state)

    if restore_in == "port":
        agg2 = TorchCC(carry=other)
        agg2.restore_state(j_state)
        cont = _tstream(edges[40:], 10, torch_datasets.IdentityDict(bound))
    else:
        agg2 = JaxCC(carry=other)
        agg2.restore_state(t_state)
        cont = _jstream(edges[40:], 10, jax_datasets.IdentityDict(bound))
    last = None
    for last in agg2.run(cont):
        pass
    assert agg2._cc_mode == other
    assert set(last.component_sets()) == set(union_find_components(edges))

    # and the port restored from itself, continuing on the same carry
    agg3 = TorchCC(carry=carry)
    agg3.restore_state(t_state)
    for last in agg3.run(_tstream(edges[40:], 10, torch_datasets.IdentityDict(bound))):
        pass
    assert set(last.component_sets()) == set(union_find_components(edges))


def test_restore_rejects_a_table_that_is_not_min_rooted():
    agg = TorchCC(carry="forest")
    agg.restore_state({"labels": np.array([0, 2, 2], np.int32),
                       "touched": np.ones(3, bool)})
    with pytest.raises(ValueError, match="min-rooted"):
        list(agg.run(_tstream([(0, 1, 0.0)], 1, torch_datasets.IdentityDict(3))))


# --------------------------------------------------------------------- #
# The 6-edge golden (test_library.py)
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("carry", CARRIES)
@pytest.mark.parametrize("window", [1, 2, 6])
def test_connected_components_golden(window, carry):
    jout, tout, _, tagg = _run_both(CC_EDGES, window, carry)
    assert tout == jout
    last = None
    for last in _tstream(CC_EDGES, window).aggregate(TorchCC(carry=carry)):
        pass
    assert set(last.component_sets()) == set(CC_EXPECTED)
    assert last.num_components() == 3


def test_connected_components_str_format():
    last = None
    for last in _tstream(CC_EDGES, 6).aggregate(TorchCC()):
        pass
    assert str(last) == "{1=[1, 2, 3, 5], 6=[6, 7], 8=[8, 9]}"


@pytest.mark.parametrize("window", [2, 6])
def test_connected_components_tree(window):
    tout = [str(c) for c in _tstream(CC_EDGES, window).aggregate(TorchCCTree())]
    jout = [str(c) for c in _jstream(CC_EDGES, window).aggregate(JaxCCTree())]
    assert tout == jout
    assert tout[-1] == "{1=[1, 2, 3, 5], 6=[6, 7], 8=[8, 9]}"
    with pytest.raises(ValueError, match="degree"):
        TorchCCTree(degree=1)


def test_cc_intermediate_emissions():
    emissions = list(_tstream(CC_EDGES, 2).aggregate(TorchCC()))
    assert len(emissions) == 3
    assert emissions[0].component_sets() == [frozenset({1, 2, 3})]
    assert set(emissions[-1].component_sets()) == set(CC_EXPECTED)


def test_later_slices_raise():
    with pytest.raises(NotImplementedError, match="slice 6"):
        TorchCC(mesh=object())
    with pytest.raises(NotImplementedError, match="slice 7"):
        TorchCC(superbatch="auto")
    with pytest.raises(NotImplementedError, match="slice 9"):
        TorchCC().servable()
    with pytest.raises(NotImplementedError, match="slice 8"):
        TorchCC.sliding(10)


# --------------------------------------------------------------------- #
# Dense labels (test_summaries.py)
# --------------------------------------------------------------------- #
def _both_fold(n, edges):
    s, d = edges[:, 0].astype(np.int32), edges[:, 1].astype(np.int32)
    m = np.ones(len(edges), bool)
    j = jax_labels.cc_fold(jax_labels.init_labels(n), jnp.asarray(s), jnp.asarray(d),
                           jnp.asarray(m))
    t = torch_labels.cc_fold(torch_labels.init_labels(n, "cpu"), torch.from_numpy(s),
                             torch.from_numpy(d), torch.from_numpy(m))
    return j, t


def test_cc_fold_matches_jax_and_truth():
    rng = np.random.default_rng(0)
    n = 64
    edges = rng.integers(0, n, size=(200, 2))
    j, t = _both_fold(n, edges)
    _states_equal(j, t)
    lab = t["labels"].numpy()
    groups = {}
    for v in range(n):
        groups.setdefault(lab[v], set()).add(v)
    truth = union_find_components([(int(a), int(b)) for a, b in edges])
    truth += [frozenset({v}) for v in range(n) if not any(v in c for c in truth)]
    assert {frozenset(g) for g in groups.values()} == set(truth)


def test_cc_fold_masked_rows_are_inert():
    """Masked rows neither hook nor mark touched (the reference's +inf
    rows and mode="drop" writes)."""
    s = torch.tensor([0, 5, 2], dtype=torch.int32)
    d = torch.tensor([1, 6, 3], dtype=torch.int32)
    m = torch.tensor([True, False, True])
    t = torch_labels.cc_fold(torch_labels.init_labels(8, "cpu"), s, d, m)
    j = jax_labels.cc_fold(jax_labels.init_labels(8), jnp.asarray(s.numpy()),
                           jnp.asarray(d.numpy()), jnp.asarray(m.numpy()))
    _states_equal(j, t)
    assert t["labels"].tolist() == [0, 0, 2, 2, 4, 5, 6, 7]
    assert t["touched"].tolist() == [True, True, True, True, False, False, False, False]


def test_label_combine_preserves_cross_links():
    n = 8
    one = torch.ones(1, dtype=torch.bool)
    a = torch_labels.cc_fold(torch_labels.init_labels(n, "cpu"), torch.tensor([5]),
                             torch.tensor([3]), one)
    b = torch_labels.cc_fold(torch_labels.init_labels(n, "cpu"), torch.tensor([5]),
                             torch.tensor([1]), one)
    lab = torch_labels.label_combine(a, b)["labels"]
    assert lab[5] == lab[3] == lab[1] == 1


def test_label_combine_matches_jax():
    rng = np.random.default_rng(7)
    n = 64
    j1, t1 = _both_fold(n, rng.integers(0, n, size=(80, 2)))
    j2, t2 = _both_fold(n, rng.integers(0, n, size=(80, 2)))
    _states_equal(jax_labels.label_combine(j1, j2), torch_labels.label_combine(t1, t2))


def test_grow_labels_matches_jax():
    j, t = _both_fold(4, np.array([[0, 3]]))
    jg, tg = jax_labels.grow_labels(j, 8), torch_labels.grow_labels(t, 8)
    _states_equal(jg, tg)
    assert tg["labels"].shape[0] == 8 and tg["labels"][3] == 0 and tg["labels"][7] == 7
    assert torch_labels.grow_labels(tg, 4) is tg


# --------------------------------------------------------------------- #
# The forest steps, one by one, against the JAX package
# --------------------------------------------------------------------- #
def _random_forest(rng, vcap):
    """A min-rooted pointer forest with chains (canon[v] <= v)."""
    canon = np.arange(vcap, dtype=np.int32)
    for v in range(1, vcap):
        if rng.random() < 0.6:
            canon[v] = rng.integers(0, v)
    return canon


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_chase_and_group_and_commit_match_jax(seed):
    rng = np.random.default_rng(seed)
    vcap, tcap, t = 64, 32, 21
    canon = _random_forest(rng, vcap)
    tid = np.zeros(tcap, np.int32)
    tid[:t] = rng.choice(vcap, t, replace=False)
    tmask = np.arange(tcap) < t
    jr = jax_forest.chase_and_group(jnp.asarray(canon), jnp.asarray(tid),
                                    jnp.asarray(tmask), tcap, vcap)
    tr = torch_forest.chase_and_group(torch.from_numpy(canon), torch.from_numpy(tid),
                                      torch.from_numpy(tmask), tcap, vcap)
    for a, b in zip(jr, tr):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    r, v2, key_, iota = tr
    local = torch_forest._make_local_fixpoint(tcap, "cpu")(iota, torch.zeros(8, dtype=torch.int32),
                                                          torch.zeros(8, dtype=torch.int32), v2)
    canon_t = torch.from_numpy(canon)
    new_t, nr_t = torch_forest.commit_roots(canon_t, local, key_, r, torch.from_numpy(tid),
                                            torch.from_numpy(tmask), tcap, vcap)
    new_j, nr_j = jax_forest.commit_roots(
        jnp.asarray(canon), jnp.asarray(local.numpy()), jnp.asarray(key_.numpy()),
        jnp.asarray(r.numpy()), jnp.asarray(tid), jnp.asarray(tmask), tcap, vcap)
    np.testing.assert_array_equal(np.asarray(new_j), new_t.numpy())
    np.testing.assert_array_equal(np.asarray(nr_j), nr_t.numpy())
    # the commit wrote a copy: the input forest is unchanged
    np.testing.assert_array_equal(canon_t.numpy(), canon)


def test_forest_windows_and_resolve_match_jax():
    """forest_window over a sequence of windows, then resolve_flat on the
    device and resolve_flat_host: the same forest values, step by step."""
    rng = np.random.default_rng(5)
    vcap = 128
    jc = jax_forest.init_forest(vcap)
    tc = torch_forest.init_forest(vcap, "cpu")
    jp, tp = jax_forest.WindowPrep(), torch_forest.WindowPrep()
    for _ in range(6):
        s = rng.integers(0, vcap, 40).astype(np.int32)
        d = rng.integers(0, vcap, 40).astype(np.int32)
        jc, jt = jax_forest.forest_window(jc, s, d, vcap, jp)
        tc, tt = torch_forest.forest_window(tc, s, d, vcap, tp)
        np.testing.assert_array_equal(np.sort(np.asarray(jt)), np.sort(tt))
        np.testing.assert_array_equal(
            np.asarray(jax_forest.resolve_flat(jc)), torch_forest.resolve_flat(tc).numpy()
        )
    flat = torch_forest.resolve_flat(tc).numpy()
    np.testing.assert_array_equal(flat, torch_forest.resolve_flat_host(tc.numpy()))
    assert torch_forest.grow_forest(tc, 256)[200] == 200


@pytest.mark.parametrize("k", [2, 4])
def test_forest_superbatch_replay_matches_per_window(k):
    rng = np.random.default_rng(11)
    vcap = 64
    windows = [
        (rng.integers(0, vcap, 12).astype(np.int32), rng.integers(0, vcap, 12).astype(np.int32))
        for _ in range(k)
    ]
    canon = torch_forest.init_forest(vcap, "cpu")
    new, tids, replay = torch_forest.forest_superbatch(
        canon, windows, vcap, torch_forest.WindowPrep()
    )
    jnew, _jtids, jreplay = jax_forest.forest_superbatch(
        jax_forest.init_forest(vcap), windows, vcap, jax_forest.WindowPrep()
    )
    per = torch_forest.init_forest(vcap, "cpu")
    prep = torch_forest.WindowPrep()
    for i, (s, d) in enumerate(windows):
        per, _ = torch_forest.forest_window(per, s, d, vcap, prep)
        want = torch_forest.resolve_flat_host(per.numpy())
        np.testing.assert_array_equal(torch_forest.resolve_flat_host(replay.canon_np(i)), want)
        np.testing.assert_array_equal(
            jax_forest.resolve_flat_host(jreplay.canon_np(i)), want
        )
    np.testing.assert_array_equal(
        torch_forest.resolve_flat(new).numpy(), np.asarray(jax_forest.resolve_flat(jnew))
    )
    assert len(tids) == k


def test_mirror_update_matches_jax_and_copies():
    vcap = 16
    base = torch_forest.init_forest(vcap, "cpu")
    idx = np.array([5, 9, 5], np.int32)
    val = np.array([1, 2, 1], np.int32)
    got = torch_forest.mirror_update(base, idx, val, vcap)
    want = jax_forest.mirror_update(jax_forest.init_forest(vcap), idx, val, vcap)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert base.tolist() == list(range(vcap))
    assert torch_forest.mirror_update(base, idx[:0], val[:0], vcap) is base


def test_fixpoint_turns_are_the_host_reads():
    """On the forest path every host read is a fixpoint turn (the CPU
    carry's downloads are not reads from a device)."""
    torch_labels.HOST_READS = torch_labels.FIXPOINT_TURNS = 0
    edges = _random_edges(3, 200, 50)
    for c in _tstream(edges, 20).aggregate(TorchCC(carry="forest")):
        str(c)
    assert torch_labels.HOST_READS == torch_labels.FIXPOINT_TURNS > 0


# --------------------------------------------------------------------- #
# Superbatches (test_superbatch.py)
# --------------------------------------------------------------------- #
SB_WINDOW = 23


@pytest.mark.parametrize("carry", CARRIES)
@pytest.mark.parametrize("k", [2, 4])
def test_cc_superbatch_emissions_identical(carry, k):
    edges = _random_edges(1, 700, 160)
    base = [str(c) for c in _jstream(edges, SB_WINDOW).aggregate(JaxCC(carry="forest"))]
    tagg = TorchCC(carry=carry, superbatch=k)
    got = [str(c) for c in _tstream(edges, SB_WINDOW).aggregate(tagg)]
    assert tagg._cc_mode == carry
    assert got == base
    jgot = [str(c) for c in _jstream(edges, SB_WINDOW).aggregate(JaxCC(carry=carry, superbatch=k))]
    assert jgot == base


@pytest.mark.parametrize("carry", ["forest", "host"])
def test_cc_superbatch_out_of_order_reads(carry):
    edges = _random_edges(2, 700, 160)
    base = [str(c) for c in _jstream(edges, SB_WINDOW).aggregate(JaxCC(carry="forest"))]
    ems = list(_tstream(edges, SB_WINDOW).aggregate(TorchCC(carry=carry, superbatch=8)))
    for i in (5, 2, 7, 0, 6, 2):
        assert str(ems[i]) == base[i], f"window {i}"


@pytest.mark.parametrize("carry", CARRIES)
def test_cc_superbatch_checkpoint_state_identical(carry):
    edges = _random_edges(3, 700, 160)
    states = []
    for k in (1, 5):
        agg = TorchCC(carry=carry, superbatch=k)
        for _ in _tstream(edges, SB_WINDOW).aggregate(agg):
            pass
        states.append(agg.snapshot_state())
    jagg = JaxCC(carry=carry, superbatch=5)
    for _ in _jstream(edges, SB_WINDOW).aggregate(jagg):
        pass
    _states_equal(states[0], states[1])
    _states_equal(states[1], jagg.snapshot_state())


@pytest.mark.parametrize("k", [2, 4])
def test_group_fold_conformance(k):
    from gelly_streaming_tpu_torch.summaries.groupfold import verify_group_fold

    edges = _random_edges(4, 300, 90)
    verify_group_fold(
        lambda kk: TorchCC(carry="forest", superbatch=kk),
        lambda: _tstream(edges, SB_WINDOW), k,
    )


def test_superbatch_groups_match_jax_packer():
    rng = np.random.default_rng(8)
    src = rng.integers(0, 160, 500).astype(np.int64)
    dst = rng.integers(0, 160, 500).astype(np.int64)
    from gelly_streaming_tpu.core.window import Windower as JaxWindower
    from gelly_streaming_tpu_torch.core.window import Windower

    jg = list(JaxWindower(gj.CountWindow(37), jax_datasets.IdentityDict(160))
              .superbatches((src, dst), 4))
    tg = list(Windower(gt.CountWindow(37), torch_datasets.IdentityDict(160), device="cpu")
              .superbatches((src, dst), 4))
    assert [len(g) for g in tg] == [len(g) for g in jg]
    for a, b in zip(jg, tg):
        assert b.n_vertices == a.n_vertices
        for (s1, d1, _), (s2, d2, _) in zip(a.cols, b.cols):
            np.testing.assert_array_equal(s1, s2)
            np.testing.assert_array_equal(d1, d2)
        sa, sb = a.stacked(), b.stacked()
        np.testing.assert_array_equal(np.asarray(sa.src), sb.src.numpy())
        np.testing.assert_array_equal(np.asarray(sa.mask), sb.mask.numpy())


def test_example_cli_matches_jax(tmp_path, capsys):
    """``python -m gelly_streaming_tpu_torch.example.connected_components``:
    the same output file as the JAX package's CLI; ``--cpu`` on the CLI
    runs the file path, and the checkpoint flags raise (slice 7)."""
    from gelly_streaming_tpu.example import connected_components as jax_example
    from gelly_streaming_tpu_torch.example import connected_components as example

    edges = _random_edges(31, 90, 40)
    example.run(edges, 16, str(tmp_path / "t.txt"), device="cpu")
    jax_example.run(edges, 16, str(tmp_path / "j.txt"))
    assert (tmp_path / "t.txt").read_text() == (tmp_path / "j.txt").read_text()
    edge_file = tmp_path / "e.txt"
    edge_file.write_text("".join(f"{a} {b}\n" for a, b, _ in edges))
    example.main(["--cpu", str(edge_file), "16", str(tmp_path / "cli.txt")])
    assert (tmp_path / "cli.txt").read_text() == (tmp_path / "j.txt").read_text()
    example.main(["--cpu", "--corpus", str(edge_file), "16", "--carry", "forest"])
    assert "(carry: forest)" in capsys.readouterr().out
    with pytest.raises(NotImplementedError, match="slice 7"):
        example.main(["--cpu", str(edge_file), "16", "--checkpoint", "x"])


def test_cc_steps_are_spans():
    """Each device step of the forest carry is one obs span per window (a
    ``record_function`` range under ``torch_annotations``), the names
    ``chip_smoke.py`` reads its step table from."""
    from gelly_streaming_tpu_torch.obs import trace

    events = []

    class Sink:
        def emit(self, event):
            events.append(event["name"])

    sink = Sink()
    trace.add_sink(sink)
    trace.enable()
    try:
        list(_tstream(CC_EDGES, 2).aggregate(TorchCC(carry="forest")))
        list(_tstream(CC_EDGES, 2).aggregate(TorchCC(carry="forest", superbatch=3)))
    finally:
        trace.disable()
        trace.remove_sink(sink)
    # 3 windows one by one, then one group of 3 (a prep per window and one
    # for the group; one chase, one fixpoint per window, one commit)
    want = {"cc.window_prep": 3 + 4, "cc.window_upload": 3 + 1,
            "cc.chase_and_group": 3 + 1, "cc.propagate": 3 + 3,
            "cc.commit_roots": 3, "cc.commit": 3 + 1, "cc.forest_superbatch": 1}
    assert {name: events.count(name) for name in want} == want
