"""Training on one device: the port against the JAX package on the CPU.

The same numpy features, edges, targets and weights, made from a seed, go
through ``gelly_streaming_tpu.models.training.make_sharded_train_step`` on
a one-device JAX mesh ``make_mesh(1, 1)`` and through the port's step
(weights carried over with ``params_from_numpy``), both families, plain
SGD and ``optax.adam(1e-2)`` against ``torch.optim.Adam(lr=1e-2)``, both
losses, in f32: the losses and the parameters of every step agree within
``RTOL``/``ATOL``. The packages sum the scatter's messages and the
matmuls' products in different orders, so each step's gradients differ by
float32 rounding (a few ulps), and Adam's normalised updates carry that
on; the bound leaves about ten times the largest difference seen.

Also: the kernel wrapper's gradients against autograd through its plain
version (``FusedSageMatmul``), remat against the plain forward for both
families (``tests/test_pagerank_sage.py:271-292``,
``test_remat_forward_matches_plain``: ``rtol=1e-6``) and its gradients,
the bf16 GCN run with Adam and remat of ``:227-269``
(``test_gcn_sharded_train_step_with_optax_and_remat``: the loss falls by
10 % or more, and stays within ``BF16_TOL`` of the JAX run), the step's
functional semantics, and ``entry()`` against ``__graft_entry__.entry``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import __graft_entry__ as jax_entry
from gelly_streaming_tpu.models import gcn as jgcn
from gelly_streaming_tpu.models import graphsage as jsage
from gelly_streaming_tpu.models import training as jtr
from gelly_streaming_tpu.parallel import make_mesh as jax_make_mesh
from gelly_streaming_tpu_torch.graft_entry import entry
from gelly_streaming_tpu_torch.models import gcn as tgcn
from gelly_streaming_tpu_torch.models import graphsage as tsage
from gelly_streaming_tpu_torch.models import params_from_numpy
from gelly_streaming_tpu_torch.models import training as ttr
from gelly_streaming_tpu_torch.ops.sage_kernels import (
    FusedSageMatmul,
    fused_sage_matmul,
    fused_sage_matmul_plain,
)

RTOL, ATOL = 1e-4, 1e-5
#: bf16 losses: each step rounds every parameter to bf16 (2^-8 relative)
#: in both packages, from sums taken in different orders
BF16_TOL = 2e-2
V, E, DIMS = 32, 96, [8, 16, 4]
FAMILIES = {"sage": (jsage.sage_forward, tsage.sage_forward),
            "gcn": (jgcn.gcn_forward, tgcn.gcn_forward)}
LOSSES = {"mse": (jtr.mse_loss, ttr.mse_loss),
          "xent": (jtr.softmax_xent_loss, ttr.softmax_xent_loss)}


def _inputs(seed=0, v=V, e=E, f=DIMS[0], o=DIMS[-1]):
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(v, f)).astype(np.float32)
    src = rng.integers(0, v, e).astype(np.int32)
    dst = rng.integers(0, v, e).astype(np.int32)
    mask = rng.random(e) < 0.9
    targets = rng.normal(size=(v, o)).astype(np.float32)
    classes = rng.integers(0, o, v).astype(np.int32)
    return h, src, dst, mask, targets, classes


def _params_np(family, dims=DIMS, seed=1):
    rng = np.random.default_rng(seed)
    names = ("w_self", "w_nbr") if family == "sage" else ("w",)
    out = []
    for fi, fo in zip(dims[:-1], dims[1:]):
        layer = {k: (rng.normal(size=(fi, fo)) / np.sqrt(fi)).astype(np.float32)
                 for k in names}
        layer["b"] = (rng.normal(size=fo) * 0.1).astype(np.float32)
        out.append(layer)
    return out


def _flat(params):
    return np.concatenate([np.asarray(v, np.float32).ravel()
                           for layer in params for _, v in sorted(layer.items())])


def _tflat(params):
    return _flat([{k: v.float().numpy() for k, v in layer.items()} for layer in params])


def _run_jax(family, opt, loss, steps, dtype=jnp.float32, remat=False, inputs=None):
    h, src, dst, mask, targets, classes = inputs or _inputs()
    step, shard, init_opt = jtr.make_sharded_train_step(
        jax_make_mesh(1, 1), FAMILIES[family][0], lr=0.05,
        optimizer=optax.adam(1e-2) if opt == "adam" else None,
        loss_fn=LOSSES[loss][0], remat=remat)
    params = shard([{k: jnp.asarray(v, dtype) for k, v in layer.items()}
                    for layer in _params_np(family)])
    state = init_opt(params)
    args = [jnp.asarray(h, dtype), jnp.asarray(src), jnp.asarray(dst), jnp.asarray(mask),
            jnp.asarray(targets if loss == "mse" else classes)]
    flats, losses = [], []
    for _ in range(steps):
        params, state, lv = step(params, state, *args)
        flats.append(_flat(params))
        losses.append(float(lv))
    return np.stack(flats), np.array(losses)


def _torch_step(family, opt, loss, mesh=None, remat=False):
    return ttr.make_sharded_train_step(
        mesh, FAMILIES[family][1], lr=0.05,
        optimizer=(lambda ps: torch.optim.Adam(ps, lr=1e-2)) if opt == "adam" else None,
        loss_fn=LOSSES[loss][1], remat=remat)


def _run_torch(family, opt, loss, steps, dtype=torch.float32, remat=False, mesh=None,
               inputs=None):
    h, src, dst, mask, targets, classes = inputs or _inputs()
    step, shard, init_opt = _torch_step(family, opt, loss, mesh, remat)
    params = shard(params_from_numpy(_params_np(family), dtype, device="cpu"))
    state = init_opt(params)
    args = [torch.from_numpy(h).to(dtype)] + [torch.from_numpy(a) for a in (
        src, dst, mask, targets if loss == "mse" else classes)]
    flats, losses = [], []
    for _ in range(steps):
        params, state, lv = step(params, state, *args)
        assert lv.dim() == 0 and lv.dtype == torch.float32
        flats.append(_tflat(params))
        losses.append(lv.item())
    return np.stack(flats), np.array(losses)


# --------------------------------------------------------------------- #
# The kernel wrapper under autograd
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("activation", ["relu", "none"])
def test_wrapper_gradients_equal_autograd_through_the_plain_version(dtype, activation):
    """Row 0's preactivation is exactly 0 (zero features, zero bias): relu's
    gradient there is 0 in both. Tolerance: f32 rounding for f32; for bf16
    one rounding of the f32 product to bf16 (2^-8 relative)."""
    rng = np.random.default_rng(3)
    ops = [torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(dtype)
           for s in ((40, 8), (40, 8), (8, 12), (8, 12), (12,))]
    ops[0][0] = 0
    ops[1][0] = 0
    ops[4].zero_()
    a = [t.clone().requires_grad_() for t in ops]
    b = [t.clone().requires_grad_() for t in ops]
    out_a = fused_sage_matmul(*a, activation)
    out_b = fused_sage_matmul_plain(*b, activation)
    assert out_a.grad_fn is not None and type(out_a.grad_fn).__name__.startswith(
        FusedSageMatmul.__name__)
    g = torch.from_numpy(rng.normal(size=tuple(out_a.shape)).astype(np.float32)).to(dtype)
    got = torch.autograd.grad(out_a, a, g)
    want = torch.autograd.grad(out_b, b, g)
    tol = 1e-6 if dtype == torch.float32 else 2 ** -8
    for name, x, y in zip(("h", "agg", "w_self", "w_nbr", "b"), got, want):
        assert x.dtype == dtype, name
        np.testing.assert_allclose(x.float().numpy(), y.float().numpy(), rtol=tol,
                                   atol=tol, err_msg=name)
    if activation == "relu":
        assert not got[0][0].any() and not got[1][0].any()


def test_wrapper_keeps_no_autograd_state_without_a_gradient():
    ops = [torch.ones(s) for s in ((4, 8), (4, 8), (8, 8), (8, 8), (8,))]
    assert fused_sage_matmul(*ops).grad_fn is None
    req = [t.clone().requires_grad_() for t in ops]
    with torch.no_grad():
        assert fused_sage_matmul(*req).grad_fn is None
    # only the gradients asked for are computed
    w = ops[2].clone().requires_grad_()
    (gw,) = torch.autograd.grad(fused_sage_matmul(ops[0], ops[1], w, ops[3], ops[4]).sum(), w)
    assert gw.shape == w.shape


# --------------------------------------------------------------------- #
# Remat
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("family", ["sage", "gcn"])
def test_remat_forward_and_gradients_match_plain(family):
    h, src, dst, mask, targets, _ = _inputs(1)
    jp = [{k: jnp.asarray(v) for k, v in layer.items()} for layer in _params_np(family)]
    jfwd, tfwd = FAMILIES[family]
    want = np.asarray(jfwd(jp, *(jnp.asarray(a) for a in (h, src, dst, mask)), remat=True))
    args = [torch.from_numpy(a) for a in (h, src, dst, mask)]
    grads = {}
    for remat in (False, True):
        tp = [{k: v.requires_grad_() for k, v in layer.items()}
              for layer in params_from_numpy(_params_np(family), torch.float32, device="cpu")]
        out = tfwd(tp, *args, remat=remat)
        np.testing.assert_allclose(out.detach().numpy(), want, rtol=2e-4, atol=2e-5)
        grads[remat] = (out, torch.autograd.grad(
            ttr.mse_loss(out, torch.from_numpy(targets)),
            [v for layer in tp for v in layer.values()]))
    np.testing.assert_allclose(grads[True][0].detach().numpy(),
                               grads[False][0].detach().numpy(), rtol=1e-6)
    for a, b in zip(grads[True][1], grads[False][1]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


# --------------------------------------------------------------------- #
# The single-device step against the JAX step on a 1 x 1 mesh
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("loss", ["mse", "xent"])
@pytest.mark.parametrize("opt", ["sgd", "adam"])
@pytest.mark.parametrize("family", ["sage", "gcn"])
def test_single_device_step_matches_jax_every_step(family, opt, loss):
    jp, jl = _run_jax(family, opt, loss, 8)
    tp, tl = _run_torch(family, opt, loss, 8)
    np.testing.assert_allclose(tl, jl, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tp, jp, rtol=RTOL, atol=ATOL)
    assert tl[-1] < tl[0]


def test_one_by_one_mesh_is_the_single_device_step():
    """``make_mesh(1, 1)`` (a gloo world of one) gives the single-device
    step: the same parameters bit for bit, and no collective."""
    from gelly_streaming_tpu_torch.parallel import comm
    from test_torch_mesh import world_of_one

    want = _run_torch("sage", "adam", "mse", 3)
    with world_of_one():
        from gelly_streaming_tpu_torch.parallel import make_mesh

        mesh = make_mesh(1, 1, device="cpu")
        comm.reset_counters()
        got = _run_torch("sage", "adam", "mse", 3, mesh=mesh)
        assert not comm.CALLS
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def test_bf16_gcn_adam_remat_learns_like_jax():
    """``test_gcn_sharded_train_step_with_optax_and_remat`` on one device:
    its inputs and weights (V = 64, E = 256, F = 16, dims [16, 32, 8], bf16),
    12 Adam steps with remat; then plain SGD needs no optimizer state."""
    rng = np.random.default_rng(0)
    v, e, f = 64, 256, 16
    src = rng.integers(0, v, e).astype(np.int32)
    dst = rng.integers(0, v, e).astype(np.int32)
    h = rng.normal(size=(v, f)).astype(np.float32)
    inputs = (h, src, dst, np.ones(e, bool), rng.normal(size=(v, 8)).astype(np.float32))
    # the reference test's weights, carried across through float32
    params = [{k: np.asarray(x, np.float32) for k, x in layer.items()}
              for layer in jgcn.init_gcn(jax.random.PRNGKey(0), [f, 32, 8])]

    def run_jax():
        step, shard, init_opt = jtr.make_sharded_train_step(
            jax_make_mesh(1, 1), jgcn.gcn_forward, optimizer=optax.adam(1e-2), remat=True)
        p = shard([{k: jnp.asarray(x, jnp.bfloat16) for k, x in layer.items()}
                   for layer in params])
        st = init_opt(p)
        args = [jnp.asarray(inputs[0], jnp.bfloat16)] + [jnp.asarray(a) for a in inputs[1:]]
        out = []
        for _ in range(12):
            p, st, lv = step(p, st, *args)
            out.append(float(lv))
        return np.array(out)

    step, shard, init_opt = ttr.make_sharded_train_step(
        None, tgcn.gcn_forward, optimizer=lambda ps: torch.optim.Adam(ps, lr=1e-2),
        remat=True)
    p = shard(params_from_numpy(params, torch.bfloat16, device="cpu"))
    st = init_opt(p)
    args = [torch.from_numpy(inputs[0]).to(torch.bfloat16)] + [
        torch.from_numpy(a) for a in inputs[1:]]
    losses = []
    for _ in range(12):
        p, st, lv = step(p, st, *args)
        losses.append(lv.item())
        assert p[0]["w"].dtype == torch.bfloat16
    assert losses[-1] < losses[0] * 0.9, losses
    np.testing.assert_allclose(losses, run_jax(), rtol=BF16_TOL)

    step2, shard2, init2 = ttr.make_sharded_train_step(None, tgcn.gcn_forward, lr=1e-2)
    p2 = shard2(params_from_numpy(params, torch.bfloat16, device="cpu"))
    assert init2(p2) is None
    p2, _, l0 = step2(p2, None, *args)
    p2, _, l1 = step2(p2, None, *args)
    assert float(l1) < float(l0)


# --------------------------------------------------------------------- #
# Functional semantics
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_step_leaves_its_inputs_unchanged(opt):
    h, src, dst, mask, targets, _ = (torch.from_numpy(a) for a in _inputs(4))
    step, shard, init_opt = _torch_step("sage", opt, "mse")
    params = shard(params_from_numpy(_params_np("sage"), torch.float32, device="cpu"))
    state = init_opt(params)
    assert (state is None) == (opt == "sgd")
    inputs = (h, src, dst, mask, targets)
    before = ([{k: v.clone() for k, v in layer.items()} for layer in params],
              [t.clone() for t in inputs])
    p1, state, _ = step(params, state, *inputs)
    kept = [{k: v.clone() for k, v in layer.items()} for layer in p1]
    p2, state, _ = step(p1, state, *inputs)
    for old, new in ((before[0], params), (kept, p1)):
        for a, b in zip(old, new):
            for k in a:
                assert torch.equal(a[k], b[k]), k
    for a, b in zip(before[1], inputs):
        assert torch.equal(a, b)
    assert not any(torch.equal(p1[0][k], p2[0][k]) for k in p1[0] if k != "b")
    assert all(not v.requires_grad for layer in p2 for v in layer.values())


def test_shard_gnn_params_without_a_model_axis_is_the_stack():
    params = params_from_numpy(_params_np("gcn"), torch.float32, device="cpu")
    assert ttr.shard_gnn_params(params, None) is params
    assert ttr.gather_gnn_params(params, None) is params


# --------------------------------------------------------------------- #
# entry()
# --------------------------------------------------------------------- #
def test_entry_matches_jax_entry_with_the_same_parameters():
    """The port's step on the JAX entry's inputs (bf16) against the JAX
    step, within ``BF16_TOL`` of the largest output (the chip smoke's
    bound for the bf16 slice: both round each layer to bf16); then the
    port's own ``entry(device="cpu")`` runs at the same shapes."""
    jfn, jargs = jax_entry.entry()
    want = np.asarray(jax.jit(jfn)(*jargs), np.float32)
    jparams, jh, jsrc, jdst, jmask = jargs
    tparams = params_from_numpy(
        [{k: np.asarray(v, np.float32) for k, v in layer.items()} for layer in jparams],
        torch.bfloat16, device="cpu")
    fn, args = entry(device="cpu")
    got = fn(tparams, torch.from_numpy(np.asarray(jh, np.float32)).to(torch.bfloat16),
             *(torch.from_numpy(np.array(a)) for a in (jsrc, jdst, jmask)))
    assert got.dtype == torch.bfloat16 and got.shape == want.shape == (256, 64)
    err = np.abs(got.float().numpy() - want).max()
    assert err <= BF16_TOL * np.abs(want).max(), err
    params, h, src, dst, mask = args
    assert [tuple(p["w_self"].shape) for p in params] == [(64, 128), (128, 64)]
    assert h.dtype == torch.bfloat16 and tuple(h.shape) == (256, 64)
    assert src.shape == dst.shape == mask.shape == (1024,)
    out = fn(*args)
    assert out.shape == (256, 64) and bool(torch.isfinite(out.float()).all())


def test_entry_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves")
    from gelly_streaming_tpu_torch.resilience.errors import DeviceUnavailable

    with pytest.raises(DeviceUnavailable):
        entry()
