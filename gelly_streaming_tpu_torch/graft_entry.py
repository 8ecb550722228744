"""Entry points that drive the flagship path of the PyTorch port (the
counterpart of the repository's ``__graft_entry__.py``).

- :func:`entry` — the single-device forward step of the flagship model: a
  streaming GraphSAGE encoder step over one edge window (BASELINE config
  #5; two dense paths through ``fused_sage_matmul`` and the scatter mean).
- :func:`dryrun_multichip` — one step of every sharded path on a mesh of
  ``n_devices`` ranks: the GraphSAGE and GCN training steps (data parallel
  over the edge axis, tensor parallel over the weights' output features),
  the streaming-CC aggregation (per-shard fold, butterfly combine, the
  sharded degree sum), the forest carry under the mesh, the sharded window
  triangles, the sharded ``reduce_on_edges``, and the edge-sharded
  streaming PageRank and GraphSAGE forward, each held to the reference's
  asserts.

The reference runs its dry run from one controller over virtual devices;
the port is SPMD, one process a rank: every rank of an initialised world
(:func:`~.parallel.multihost.initialize`) calls :func:`dryrun_multichip`
with the same arguments.
"""

from __future__ import annotations

import numpy as np
import torch

from .core.device import DEFAULT_DEVICE, resolve_device


def entry(device=DEFAULT_DEVICE):
    """Return ``(fn, example_args)``: the flagship forward step and its
    inputs (V = 256, E = 1024, F = 64, dims [64, 128, 64], bf16) on
    ``device``, drawn from a seeded ``torch.Generator``."""
    from .models.graphsage import init_graphsage, sage_forward

    device = resolve_device(device)
    V, E, F = 256, 1024, 64
    gen = torch.Generator().manual_seed(0)
    params = init_graphsage([F, 128, 64], torch.bfloat16, generator=gen, device=device)
    h = torch.randn((V, F), generator=gen).to(device=device, dtype=torch.bfloat16)
    src = torch.randint(0, V, (E,), generator=gen, dtype=torch.int32).to(device)
    dst = torch.randint(0, V, (E,), generator=gen, dtype=torch.int32).to(device)
    mask = torch.ones(E, dtype=torch.bool, device=device)

    def step(params, h, src, dst, mask):
        return sage_forward(params, h, src, dst, mask)

    return step, (params, h, src, dst, mask)


def _union_find_sets(edges):
    parent: dict = {}

    def find(x):
        parent.setdefault(x, x)
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for a, b, _ in edges:
        ra, rb = find(a), find(b)
        if ra != rb:
            parent[max(ra, rb)] = min(ra, rb)
    comps: dict = {}
    for v in parent:
        comps.setdefault(find(v), set()).add(v)
    return {frozenset(m) for m in comps.values()}


def dryrun_multichip(n_devices: int, device=DEFAULT_DEVICE) -> None:
    """One step of every sharded path over an ``n_devices`` mesh, on tiny
    shapes; raises AssertionError where a result is wrong. Called by every
    rank of an initialised world of ``n_devices`` ranks, whose tensors live
    on ``device``."""
    import torch.distributed as dist

    from .core.stream import SimpleEdgeStream, StreamContext
    from .core.window import CountWindow
    from .library import ConnectedComponents, IncrementalPageRank
    from .models.gcn import gcn_forward, init_gcn
    from .models.graphsage import (
        StreamingGraphSAGE,
        TableFeatureSource,
        init_graphsage,
        make_sharded_train_step,
    )
    from .models.training import make_sharded_train_step as make_generic
    from .ops.triangles import window_triangle_count, window_triangle_count_sharded
    from .parallel import comm
    from .parallel.mesh import EDGE_AXIS, P, make_mesh
    from .summaries.labels import cc_fold, init_labels, label_combine

    device = resolve_device(device)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != n_devices:
        raise ValueError(f"dryrun_multichip({n_devices}) runs on every rank of a "
                         f"{n_devices}-rank world; this world has {world}")
    n_model = 2 if n_devices % 2 == 0 else 1
    n_edge = n_devices // n_model
    mesh = make_mesh(n_edge, n_model, device=device)
    gen = torch.Generator().manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen).to(device)

    def randint(hi, n):
        return torch.randint(0, hi, (n,), generator=gen, dtype=torch.int32).to(device)

    # ---- 1. GraphSAGE sharded training step (DP edges x TP features) ---- #
    V, E, F = 16, 8 * n_edge, 8
    params = init_graphsage([F, 16, F], torch.float32, generator=gen, device=device)
    step, shard_params = make_sharded_train_step(mesh, lr=0.05)
    params = shard_params(params)
    h = randn(V, F)
    src, dst = randint(V, E), randint(V, E)
    mask = torch.ones(E, dtype=torch.bool, device=device)
    targets = randn(V, F)
    params, loss0 = step(params, h, src, dst, mask, targets)
    params, loss1 = step(params, h, src, dst, mask, targets)
    assert float(loss1) < float(loss0), "training step did not descend"

    # ---- 1b. GCN family through the generic step (with per-layer remat) -- #
    gp = init_gcn([F, 16, F], torch.float32, generator=gen, device=device)
    gstep, gshard, _ = make_generic(mesh, gcn_forward, lr=0.05, remat=True)
    gp = gshard(gp)
    gp, _, gl0 = gstep(gp, None, h, src, dst, mask, targets)
    gp, _, gl1 = gstep(gp, None, h, src, dst, mask, targets)
    assert float(gl1) < float(gl0), "GCN training step did not descend"

    # ---- 2. Streaming-CC aggregation over the full mesh edge axis ------- #
    cc_mesh = make_mesh(n_devices, device=device)
    vcap = 32
    ecap = 16 * n_devices
    rng = np.random.default_rng(1)
    csrc = torch.from_numpy(rng.integers(0, vcap, ecap).astype(np.int32)).to(device)
    cdst = torch.from_numpy(rng.integers(0, vcap, ecap).astype(np.int32)).to(device)
    cmask = torch.ones(ecap, dtype=torch.bool, device=device)
    summary = init_labels(vcap, device)

    # per-shard fold + butterfly combine, then the merge into the
    # replicated running summary; the sharded degree sum
    def shard_fn(src, dst, mask):
        part = cc_fold(init_labels(vcap, device), src, dst, mask)
        return comm.tree_all_reduce(part, EDGE_AXIS, label_combine, n_devices)

    window = comm.shard_map(shard_fn, cc_mesh, (P(EDGE_AXIS),) * 3, P())(csrc, cdst, cmask)
    new_summary = label_combine(summary, window)

    def deg_fn(src, mask):
        local = torch.zeros(vcap, dtype=torch.int32, device=device)
        return comm.all_reduce(local.index_add_(0, src, mask.int()), EDGE_AXIS)

    degrees = comm.shard_map(deg_fn, cc_mesh, (P(EDGE_AXIS), P(EDGE_AXIS)), P())(csrc, cmask)
    lab = new_summary["labels"].cpu().numpy()
    assert (lab[lab] == lab).all(), "label table not a fixpoint"
    assert int(degrees.sum()) == ecap

    # ---- 2b. The window-local forest carry UNDER the mesh ---------------- #
    f_edges = [(int(a), int(b), 0.0)
               for a, b in rng.integers(0, vcap, size=(4 * n_devices, 2))]
    fstream = SimpleEdgeStream(f_edges, window=CountWindow(2 * n_devices),
                               context=StreamContext(device=device, mesh=cc_mesh))
    fagg = ConnectedComponents(carry="forest")
    flast = None
    for flast in fagg.run(fstream):
        pass
    assert fagg._cc_mode == "forest"
    # set equality: frozensets are incomparable under sorted()'s <
    assert set(flast.component_sets()) == _union_find_sets(f_edges)

    # ---- 3. Edge-sharded window-triangle membership pass ----------------- #
    total, per_vertex = window_triangle_count_sharded(
        csrc, cdst, cmask, vcap, 16, cc_mesh, edge_chunk=16)
    ref_total, ref_pv = window_triangle_count(csrc, cdst, cmask, vcap, 16)
    assert int(total) == int(ref_total), "sharded triangle total diverged"
    assert torch.equal(per_vertex.cpu(), ref_pv.cpu())

    # ---- 4. Sharded snapshot reduce_on_edges ----------------------------- #
    edges = [(int(a), int(b), float(w)) for a, b, w in zip(
        rng.integers(0, 8, 64), rng.integers(0, 8, 64), rng.random(64))]
    ctx = StreamContext(device=device, mesh=cc_mesh)
    stream = SimpleEdgeStream(edges, window=CountWindow(16), context=ctx)
    sharded_out = {int(v): float(x) for v, x in stream.slice().reduce_on_edges("sum")}
    stream1 = SimpleEdgeStream(edges, window=CountWindow(16), device=device)
    single_out = {int(v): float(x) for v, x in stream1.slice().reduce_on_edges("sum")}
    assert set(sharded_out) == set(single_out)
    for v in single_out:
        assert abs(sharded_out[v] - single_out[v]) < 1e-4, v

    # ---- 5. Edge-sharded streaming PageRank + streaming SAGE forward ---- #
    pr_edges = [(int(a), int(b), 0.0)
                for a, b in zip(rng.integers(0, 16, 64), rng.integers(0, 16, 64))]

    def pr_stream():
        return SimpleEdgeStream(pr_edges, window=CountWindow(16), device=device)

    pr = IncrementalPageRank(tol=1e-8, max_iter=100, mesh=cc_mesh)
    for _ in pr.run(pr_stream()):
        pass
    ranks = pr.ranks()
    assert abs(sum(ranks.values()) - 1.0) < 1e-4, "sharded ranks not a distribution"
    pr1 = IncrementalPageRank(tol=1e-8, max_iter=100)
    for _ in pr1.run(pr_stream()):
        pass
    ranks1 = pr1.ranks()
    assert all(abs(ranks[v] - ranks1[v]) < 1e-5 for v in ranks1), (
        "sharded PageRank diverged from single-device")

    sage_params = init_graphsage([F, 16, F], torch.float32, generator=gen, device=device)
    table = TableFeatureSource(torch.randn((32, F), generator=gen), device=device)
    out = out1 = None
    for out in StreamingGraphSAGE(sage_params, feature_dim=F, mesh=cc_mesh).run(
            pr_stream(), table):
        pass
    for out1 in StreamingGraphSAGE(sage_params, feature_dim=F).run(pr_stream(), table):
        pass
    np.testing.assert_allclose(
        out.cpu().numpy(), out1.cpu().numpy(), rtol=2e-4, atol=2e-5,
        err_msg="sharded streaming SAGE diverged from single-device")
