"""The port's training step across the mesh against its single-device step
and against the JAX package's sharded step on a mesh of the same shape.

Meshes (edges x model): 1x2 (tensor parallel alone) and 2x1 (data
parallel alone) in a gloo world of 2 CPU ranks, 2x2 in a world of 4, and
4x2 in a world of 8 (the reference test's 8-device mesh; the JAX side
runs on ``tests/conftest.py``'s 8 virtual CPU devices). The worlds are
``test_torch_mesh.py``'s: one persistent gloo world per width, this file
running itself as the rank worker. Every rank runs every case for each
mesh shape of its width and pickles the parameters it gathers back
(``gather_gnn_params``) after every step, and the losses.

Checks: after every step the gathered parameters and the loss are
bit-equal across the ranks of a world; they are within ``RTOL``/``ATOL``
of the port's single-device step and of the JAX sharded step. That bound
is float32 rounding grown over ``STEPS`` steps: the sharded step sums the
edge messages rank by rank and all-reduces them, the single-device step
sums them in one scatter, so each step's gradients differ by a few ulps,
and Adam's normalised updates carry the difference on.

Mirrors ``tests/test_pagerank_sage.py:127-155``
(``test_sharded_train_step_runs_on_virtual_mesh``: the round-1 SAGE step
learns on a 2x2 mesh) and ``:227-269``
(``test_gcn_sharded_train_step_with_optax_and_remat``: GCN with Adam and
remat on the 4x2 mesh, and plain SGD with no optimizer state), and runs
``dryrun_multichip`` (``__graft_entry__.py:48``) on every rank of the
worlds of 2, 4 and 8.
"""

import os
import sys
import tempfile

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_mesh import each_rank, main, spawn_worlds  # noqa: E402

#: the mesh shapes (edges, model) each world width runs
SHAPES = {2: [(1, 2), (2, 1)], 4: [(2, 2)], 8: [(4, 2)]}
WIDTHS = sorted(SHAPES)
STEPS = 5
RTOL, ATOL = 1e-4, 1e-5
V, E, DIMS = 32, 64, [8, 16, 8]
#: (family, optimizer, loss, remat)
CONFIGS = [("sage", "sgd", "mse", False), ("sage", "adam", "xent", False),
           ("gcn", "sgd", "xent", False), ("gcn", "adam", "mse", True)]


def _config_id(cfg):
    return "-".join(str(x) for x in cfg)


# --------------------------------------------------------------------- #
# Inputs, made with numpy from a seed
# --------------------------------------------------------------------- #
def _inputs():
    rng = np.random.default_rng(11)
    h = rng.normal(size=(V, DIMS[0])).astype(np.float32)
    src = rng.integers(0, V, E).astype(np.int32)
    dst = rng.integers(0, V, E).astype(np.int32)
    mask = rng.random(E) < 0.9
    targets = rng.normal(size=(V, DIMS[-1])).astype(np.float32)
    classes = rng.integers(0, DIMS[-1], V).astype(np.int32)
    return h, src, dst, mask, targets, classes


def _params(family):
    rng = np.random.default_rng(12 if family == "sage" else 13)
    out = []
    for fi, fo in zip(DIMS[:-1], DIMS[1:]):
        layer = {k: (rng.normal(size=(fi, fo)) / np.sqrt(fi)).astype(np.float32)
                 for k in (("w_self", "w_nbr") if family == "sage" else ("w",))}
        layer["b"] = (rng.normal(size=fo) * 0.1).astype(np.float32)
        out.append(layer)
    return out


def _flat(params):
    return np.concatenate([np.asarray(v, np.float32).ravel()
                           for layer in params for _, v in sorted(layer.items())])


# --------------------------------------------------------------------- #
# The port's side (runs in every rank; mesh=None is the single device)
# --------------------------------------------------------------------- #
def port_train(cfg, mesh):
    """``STEPS`` steps of ``cfg``: the flat gathered parameters after each
    step and the losses."""
    import torch

    from gelly_streaming_tpu_torch.models import (
        gather_gnn_params,
        gcn_forward,
        make_gnn_train_step,
        mse_loss,
        params_from_numpy,
        sage_forward,
        softmax_xent_loss,
    )

    family, opt, loss, remat = cfg
    h, src, dst, mask, targets, classes = (torch.from_numpy(a) for a in _inputs())
    step, shard, init_opt = make_gnn_train_step(
        mesh, sage_forward if family == "sage" else gcn_forward, lr=0.05,
        optimizer=(lambda ps: torch.optim.Adam(ps, lr=1e-2)) if opt == "adam" else None,
        loss_fn=mse_loss if loss == "mse" else softmax_xent_loss, remat=remat)
    params = shard(params_from_numpy(_params(family), torch.float32, device="cpu"))
    state = init_opt(params)
    flats, losses = [], []
    for _ in range(STEPS):
        params, state, lv = step(params, state, h, src, dst, mask,
                                 targets if loss == "mse" else classes)
        flats.append(_flat([{k: v.numpy() for k, v in layer.items()}
                            for layer in gather_gnn_params(params, mesh)]))
        losses.append(lv.item())
    return np.stack(flats), np.array(losses)


def port_round1(mesh):
    """The round-1 SAGE wrapper (``graphsage.make_sharded_train_step``)."""
    import torch

    from gelly_streaming_tpu_torch.models import gather_gnn_params, params_from_numpy
    from gelly_streaming_tpu_torch.models.graphsage import make_sharded_train_step

    h, src, dst, mask, targets, _ = (torch.from_numpy(a) for a in _inputs())
    step, shard = make_sharded_train_step(mesh, lr=0.1)
    params = shard(params_from_numpy(_params("sage"), torch.float32, device="cpu"))
    losses = []
    for _ in range(STEPS):
        params, loss = step(params, h, src, dst, mask, targets)
        losses.append(loss.item())
    full = gather_gnn_params(params, mesh)
    return _flat([{k: v.numpy() for k, v in layer.items()} for layer in full]), np.array(losses)


def _mesh_cases(_mesh):
    """Every config on each mesh shape of this world's width."""
    import torch.distributed as dist

    from gelly_streaming_tpu_torch.parallel import make_mesh

    out = {}
    for shape in SHAPES[dist.get_world_size()]:
        mesh = make_mesh(*shape, device="cpu")
        for cfg in CONFIGS:
            out[(shape, cfg)] = port_train(cfg, mesh)
        out[(shape, "round1")] = port_round1(mesh)
    return out


def _dryrun(_mesh):
    import torch.distributed as dist

    from gelly_streaming_tpu_torch.graft_entry import dryrun_multichip

    dryrun_multichip(dist.get_world_size(), device="cpu")
    return True


CASES = {"train": _mesh_cases, "dryrun": _dryrun}


@pytest.fixture(scope="module")
def worlds():
    with tempfile.TemporaryDirectory() as d:
        yield spawn_worlds(os.path.abspath(__file__), WIDTHS, d)


# --------------------------------------------------------------------- #
# The reference's side
# --------------------------------------------------------------------- #
def jax_train(cfg, shape):
    import jax.numpy as jnp
    import optax

    from gelly_streaming_tpu.models import gcn_forward, sage_forward
    from gelly_streaming_tpu.models import training as jtr
    from gelly_streaming_tpu.parallel import make_mesh

    family, opt, loss, remat = cfg
    h, src, dst, mask, targets, classes = (jnp.asarray(a) for a in _inputs())
    step, shard, init_opt = jtr.make_sharded_train_step(
        make_mesh(*shape), sage_forward if family == "sage" else gcn_forward, lr=0.05,
        optimizer=optax.adam(1e-2) if opt == "adam" else None,
        loss_fn=jtr.mse_loss if loss == "mse" else jtr.softmax_xent_loss, remat=remat)
    params = shard([{k: jnp.asarray(v) for k, v in layer.items()} for layer in _params(family)])
    state = init_opt(params)
    flats, losses = [], []
    for _ in range(STEPS):
        params, state, lv = step(params, state, h, src, dst, mask,
                                 targets if loss == "mse" else classes)
        flats.append(_flat(params))
        losses.append(float(lv))
    return np.stack(flats), np.array(losses)


def _ranks_agree(worlds, shape, key):
    """The ranks of ``shape``'s world hold bit-equal results for ``key``;
    returns rank 0's."""
    width = shape[0] * shape[1]
    ranks = worlds[width]
    first = ranks[0]["train"][(shape, key)]
    for r, res in enumerate(ranks[1:], 1):
        got = res["train"][(shape, key)]
        for a, b in zip(got, first):
            np.testing.assert_array_equal(a, b, err_msg=f"{shape} {key} rank {r}")
    return first


_SHAPE_CASES = [s for w in WIDTHS for s in SHAPES[w]]


# --------------------------------------------------------------------- #
# The tests
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("cfg", CONFIGS, ids=_config_id)
@pytest.mark.parametrize("shape", _SHAPE_CASES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_sharded_step_matches_single_device_and_jax(worlds, shape, cfg):
    params, losses = _ranks_agree(worlds, shape, cfg)
    want_params, want_losses = port_train(cfg, None)
    np.testing.assert_allclose(params, want_params, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(losses, want_losses, rtol=RTOL, atol=ATOL)
    jax_params, jax_losses = jax_train(cfg, shape)
    np.testing.assert_allclose(params, jax_params, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(losses, jax_losses, rtol=RTOL, atol=ATOL)
    assert losses[-1] < losses[0]


def test_data_parallel_gradients_sum_over_the_edge_ranks(worlds):
    """On the 2x1 mesh each rank's gather ``h[src]`` reads its own half of
    the edges, so the hidden layer's gradient must all-reduce over the edge
    axis in the backward (``comm.copy_over`` in ``mean_aggregate``); without
    it each rank's first-layer gradients hold only its edges' share and the
    parameters leave the single-device step's after one step."""
    shape, cfg = (2, 1), ("sage", "sgd", "mse", False)
    params, _ = _ranks_agree(worlds, shape, cfg)
    want, _ = port_train(cfg, None)
    np.testing.assert_allclose(params[0], want[0], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("shape", _SHAPE_CASES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_round1_sage_step_learns_on_the_mesh(worlds, shape):
    """``test_sharded_train_step_runs_on_virtual_mesh``: the loss falls
    over the steps; every rank agrees, and with the single-device step."""
    import torch

    from gelly_streaming_tpu_torch.models import params_from_numpy
    from gelly_streaming_tpu_torch.models.graphsage import make_sharded_train_step

    params, losses = _ranks_agree(worlds, shape, "round1")
    assert losses[-1] < losses[0]
    step, _ = make_sharded_train_step(None, lr=0.1)
    h, src, dst, mask, targets, _ = (torch.from_numpy(a) for a in _inputs())
    p = params_from_numpy(_params("sage"), torch.float32, device="cpu")
    want = []
    for _ in range(STEPS):
        p, loss = step(p, h, src, dst, mask, targets)
        want.append(loss.item())
    np.testing.assert_allclose(losses, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(
        params, _flat([{k: v.numpy() for k, v in layer.items()} for layer in p]),
        rtol=RTOL, atol=ATOL)


def test_dryrun_multichip_on_every_rank(worlds):
    """``dryrun_multichip(n)`` on every rank of the worlds of 2, 4 and 8:
    each section's asserts hold (a rank that fails ends its world)."""
    for p, r, ok in each_rank(worlds, "dryrun"):
        assert ok is True, (p, r)
    assert sorted(worlds) == WIDTHS


if __name__ == "__main__":
    main(CASES)
