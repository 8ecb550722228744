"""Streaming GraphSAGE's carried CSR by destination and its segment mean
(``ops/sage_aggregate.py``), on the CPU.

- ``MessageCSR`` after every window of a multi-window stream (bucket
  growths and rows that grow included) equals a stable sort of the held
  prefix by destination made from scratch, and its ``row_ptr``
  differences are the exact in-degrees.
- ``segment_mean``'s plain version equals ``mean_aggregate`` bit for bit
  (both sum each row's messages in stream order on the CPU), with rows that
  receive nothing left zero; a numpy model of the card kernel's merge-path
  split and fix-up, with a hub that spans many workers' runs, stores every
  row exactly once and stays within float32 summation rounding of the exact
  mean.
- ``StreamingGraphSAGE`` on the CSR path matches the benchmark's plain
  reference (``graphbench/reference/sage.py``) every window and the
  edge-list forward bit for bit as the dictionary grows; a ``state_dict``
  round trip gives the same next window; the ``sage.csr`` span fires once a
  window; the mean's ``MESSAGES_PULLED`` equals ``MESSAGES_AGGREGATED`` on
  one device and stays 0 under a mesh; the wrapper refuses what the kernel
  does not take.
"""

import numpy as np
import pytest
import torch

import gelly_streaming_tpu_torch as gt
from gelly_streaming_tpu_torch import datasets
from gelly_streaming_tpu_torch.models import graphsage as tsage
from gelly_streaming_tpu_torch.obs import trace
from gelly_streaming_tpu_torch.ops import sage_aggregate as sa
from graphbench.reference import sage as ref

V, HUB = 1 << 10, 5


def _messages(seed, e, v=V, hub_share=0.15, empty_share=0.3):
    """``e`` messages over ``v`` ids: ``hub_share`` of them into ``HUB``,
    none into the top ``empty_share`` of the ids."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, v, e).astype(np.int32)
    dst = rng.integers(0, int(v * (1 - empty_share)), e).astype(np.int32)
    dst[rng.random(e) < hub_share] = HUB
    return torch.from_numpy(src), torch.from_numpy(dst)


def _fresh(src, dst, n_rows):
    """The CSR of ``src -> dst`` made from scratch: a stable sort by
    destination and the rows' offsets."""
    order = torch.sort(dst, stable=True).indices
    counts = torch.bincount(dst.long(), minlength=n_rows)
    row_ptr = torch.zeros(n_rows + 1, dtype=torch.int64)
    row_ptr[1:] = torch.cumsum(counts, 0)
    return src[order], dst[order], row_ptr


# windows of each stream, and the rows each window's block declares
SCHEDULES = {
    "even": ([1000] * 4, [V] * 4),
    "growing buckets": ([3, 5, 1, 120, 7, 900, 2048, 1], [V] * 8),
    "empty window": ([64, 0, 64], [V] * 3),
    "growing rows": ([100, 300, 700], [256, 512, V]),
}


@pytest.mark.parametrize("merge_slice", [None, 7, 1000])
@pytest.mark.parametrize("schedule", SCHEDULES, ids=str)
def test_carried_csr_is_a_fresh_stable_sort_after_every_window(schedule, merge_slice,
                                                              monkeypatch):
    """Every window's merge, its carried messages in one slice or in many
    (``MERGE_SLICE`` of 7 or 1000)."""
    if merge_slice is not None:
        monkeypatch.setattr(sa, "MERGE_SLICE", merge_slice)
    sizes, rows = SCHEDULES[schedule]
    src, dst = _messages(7, sum(sizes))
    for w, r in enumerate(rows):  # ids of window w below its rows
        a, b = sum(sizes[:w]), sum(sizes[: w + 1])
        dst[a:b] %= r
        src[a:b] %= r
    csr = sa.MessageCSR(device="cpu")
    caps = set()
    for w, (n, r) in enumerate(zip(sizes, rows)):
        a = sum(sizes[:w])
        csr.append(src[a:a + n], dst[a:a + n], r)
        held = a + n
        want_src, want_dst, want_ptr = _fresh(src[:held], dst[:held], r)
        assert csr.n == held and csr.n_rows == r
        assert torch.equal(csr.src[:held], want_src) and torch.equal(csr.dst[:held], want_dst)
        assert torch.equal(csr.row_ptr, want_ptr)
        assert csr.src.shape[0] >= held and csr.src.dtype == torch.int32
        caps.add(csr.src.shape[0])
    if schedule == "growing buckets":
        assert len(caps) >= 4


@pytest.mark.parametrize("masked", [False, True], ids=["all", "masked"])
def test_row_ptr_differences_are_the_in_degrees(masked):
    """Over held messages, or the lanes a mask keeps (the CSR holds just
    those), the offsets' differences equal ``in_degrees`` exactly."""
    src, dst = _messages(8, 5000)
    mask = torch.from_numpy(np.random.default_rng(9).random(5000) < 0.7) if masked else None
    csr = sa.MessageCSR(device="cpu")
    for a in range(0, 5000, 1024):
        keep = slice(a, min(a + 1024, 5000))
        s, d = src[keep], dst[keep]
        if masked:
            s, d = s[mask[keep]], d[mask[keep]]
        csr.append(s, d, V)
    counts = tsage.in_degrees(dst, mask, V)
    assert torch.equal(csr.row_ptr[1:] - csr.row_ptr[:-1], counts)


def _path_split(row_ptr, d, n, v):
    """The kernel's merge-path split at diagonal ``d``."""
    lo, hi = max(0, d - n), min(d, v)
    while lo < hi:
        mid = (lo + hi) // 2
        if row_ptr[mid + 1] <= d - mid - 1:
            lo = mid + 1
        else:
            hi = mid
    return lo, d - lo


def _kernel_model(h, src, row_ptr, n, workers):
    """``csrc/sage_aggregate.cu``'s arithmetic in numpy: each worker's run
    of the merge path summed in message order in float32, rows cut by a
    run's end stored as partials and added in worker order, the mean
    divided in float32. Returns the float32 means and how often each row
    was stored."""
    v, f = h.shape
    total = v + n
    per = -(-total // workers)
    out = np.zeros((v, f), np.float32)
    stores = np.zeros(v, np.int64)
    head_part = np.zeros((workers, f), np.float32)
    tail_part = np.zeros((workers, f), np.float32)
    head_row = np.full(workers, -1)
    tail_row = np.full(workers, -1)

    def store(i, acc):
        out[i] = acc / np.float32(max(row_ptr[i + 1] - row_ptr[i], 1))
        stores[i] += 1

    for w in range(workers):
        d0 = min(w * per, total)
        d1 = min(d0 + per, total)
        i0, j0 = _path_split(row_ptr, d0, n, v)
        i1, j1 = _path_split(row_ptr, d1, n, v)
        first_start = row_ptr[i0] if i0 < v else n
        head = i0 < i1 and first_start < j0
        tail_start = row_ptr[i1] if i1 < v else n
        tail = i1 < v and j1 > max(tail_start, j0)
        acc = np.zeros(f, np.float32)
        i = i0
        row_end = row_ptr[i + 1] if i < i1 else j1

        def close(i, acc):
            if i == i0 and head:
                head_part[w] = acc
            else:
                store(i, acc)

        for j in range(j0, j1):
            while j >= row_end:
                close(i, acc)
                acc = np.zeros(f, np.float32)
                i += 1
                row_end = row_ptr[i + 1] if i < i1 else j1
            acc = acc + h[src[j]]
        while i < i1:
            close(i, acc)
            acc = np.zeros(f, np.float32)
            i += 1
        if tail:
            tail_part[w] = acc
        head_row[w] = i0 if head else -1
        tail_row[w] = i1 if tail else -1
    for w in range(workers):
        r = head_row[w]
        if r < 0:
            continue
        first = w
        while first > 0 and tail_row[first - 1] == r:
            first -= 1
        acc = np.zeros(f, np.float32)
        for q in range(first, w):
            acc = acc + tail_part[q]
        store(r, acc + head_part[w])
    return out, stores


@pytest.mark.parametrize("workers", [1, 7, 96, 50_000])
@pytest.mark.parametrize("f", [48, 104, 256])
def test_csr_mean_equals_mean_aggregate_and_the_kernel_model(f, workers):
    """Bfloat16 features, 6000 messages of which ~900 into one hub (over
    ten workers' runs at 96 workers), 30 % of the ids receiving none."""
    src, dst = _messages(f + workers, 6000)
    h = torch.from_numpy(np.random.default_rng(f).normal(size=(V, f)).astype(np.float32))
    h = h.to(torch.bfloat16)
    csr = sa.MessageCSR(device="cpu")
    csr.append(src[:2500], dst[:2500], V)
    csr.append(src[2500:], dst[2500:], V)
    got = sa.segment_mean(h, csr.src, csr.row_ptr, csr.n)
    want = tsage.mean_aggregate(h, src, dst, None, V)
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)
    counts = (csr.row_ptr[1:] - csr.row_ptr[:-1]).numpy()
    assert counts[HUB] > 800 and (counts == 0).mean() > 0.25
    assert not got[torch.from_numpy(counts == 0)].any()

    ptr, hs = csr.row_ptr.numpy(), h.float().numpy()
    model, stores = _kernel_model(hs, csr.src[: csr.n].numpy(), ptr, csr.n, workers)
    assert (stores == 1).all()
    if workers == 96:
        per = -(-(V + csr.n) // workers)
        assert counts[HUB] > 2 * per
    # within recursive float32 summation's bound of the exact mean
    rows = np.repeat(np.arange(V), counts)
    terms = hs[csr.src[: csr.n].numpy()].astype(np.float64)
    exact = np.zeros((V, f))
    np.add.at(exact, rows, terms)
    mass = np.zeros((V, f))
    np.add.at(mass, rows, np.abs(terms))
    c = np.maximum(counts, 1)[:, None]
    bound = (counts[:, None] * 2.0 ** -24 * mass + 1e-30) / c + 2.0 ** -24 * np.abs(exact) / c
    assert (np.abs(model - exact / c) <= bound).all()
    # the model's means round to the plain version's bfloat16 but at ties
    gap = np.abs(torch.from_numpy(model).to(torch.bfloat16).float().numpy() - got.float().numpy())
    assert (gap <= np.abs(got.float().numpy()) * 2.0 ** -7 + 1e-30).all()


@pytest.mark.parametrize("slice_messages", [1, 7, 1000])
def test_plain_mean_is_the_same_in_any_slice(slice_messages, monkeypatch):
    """The plain version's ``index_add_`` in slices of any size gives the
    one-slice mean bit for bit."""
    src, dst = _messages(17, 3000)
    h = torch.from_numpy(np.random.default_rng(17).normal(size=(V, 16)).astype(np.float32))
    csr = sa.MessageCSR(device="cpu")
    csr.append(src, dst, V)
    want = sa.segment_mean(h, csr.src, csr.row_ptr, csr.n)
    monkeypatch.setattr(sa, "SLICE", slice_messages)
    assert torch.equal(sa.segment_mean(h, csr.src, csr.row_ptr, csr.n), want)


def _stream(path, window, cols, v=V):
    datasets.write_binary(path, *cols)
    return datasets.stream_file(path, window=gt.CountWindow(window),
                                vertex_dict=datasets.IdentityDict(v), device="cpu")


def _params(dims, dtype, seed=3):
    g = torch.Generator().manual_seed(seed)
    params = tsage.init_graphsage(dims, dtype, generator=g, device="cpu")
    for p in params:
        p["b"] = (0.1 * torch.randn(p["b"].shape, generator=g)).to(dtype)
    return params, torch.randn((V, dims[0]), generator=g).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_csr_path_matches_the_plain_reference_every_window(dtype, tmp_path):
    """ogbn-products' widths over 5 windows of 1500 messages (buckets grow
    from 2048 to 8192): float32 within 1e-5 of the reference, bfloat16
    within 0.01 (one rounding of each layer's output), and every message
    read once a layer through the CSR."""
    dims = [100, 256, 256, 47]
    params, table = _params(dims, dtype)
    src, dst = _messages(12, 7500)
    stream = _stream(str(tmp_path / "s.gbin"), 1500, (src.numpy(), dst.numpy()))
    sage = tsage.StreamingGraphSAGE(params, dims[0])
    pulled, aggregated = sa.MESSAGES_PULLED, tsage.MESSAGES_AGGREGATED
    outs = [o.clone() for o in sage.run(stream, tsage.TableFeatureSource(table, device="cpu"))]
    assert len(outs) == 5
    held = sum(1500 * (w + 1) for w in range(5))
    assert sa.MESSAGES_PULLED - pulled == tsage.MESSAGES_AGGREGATED - aggregated == 3 * held
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    for w, got in enumerate(outs):
        end = 1500 * (w + 1)
        want = ref.forward(table, params, src[:end], dst[:end])
        rel, hub = ref.gaps(got, want, ref.hubs(dst[:end], V, 64))
        assert rel <= tol and hub <= tol, (w, rel, hub)


def test_csr_path_equals_the_edge_list_forward_as_the_dictionary_grows():
    """A growing vertex dictionary with dict features (rows added every
    window): each window's embedding is the edge-list forward over the
    held messages, bit for bit."""
    rng = np.random.default_rng(13)
    raw_src = rng.integers(0, 3000, 4096)
    raw_dst = rng.integers(0, 3000, 4096)
    raw_dst[rng.random(4096) < 0.1] = 17
    feats = {v: rng.normal(size=16).astype(np.float32) for v in range(0, 3000, 3)}
    g = torch.Generator().manual_seed(1)
    params = tsage.init_graphsage([16, 24, 8], torch.float32, generator=g, device="cpu")
    stream = gt.SimpleEdgeStream((raw_src, raw_dst), window=gt.CountWindow(1024), device="cpu")
    sage = tsage.StreamingGraphSAGE(params, 16)
    rows = []
    for out in sage.run(stream, feats):
        e, n = sage._edges, sage._edges.n_edges
        want = tsage.sage_forward(sage._params, sage._h, e.src[:n], e.dst[:n], None)
        assert torch.equal(out, want[: out.shape[0], :8])
        rows.append(sage._csr.n_rows)
    assert len(rows) == 4 and rows[0] < rows[-1]


def test_state_dict_round_trip_gives_the_same_next_window(tmp_path):
    """Two windows, a state taken and loaded into a fresh model (its CSR
    rebuilt from the restored edges), then the third window: the same
    embedding as the uninterrupted run, bit for bit."""
    dims = [16, 32, 8]
    params, table = _params(dims, torch.bfloat16)
    src, dst = _messages(14, 3000)
    feats = tsage.TableFeatureSource(table, device="cpu")
    whole = list(tsage.StreamingGraphSAGE(params, 16).run(
        _stream(str(tmp_path / "a.gbin"), 1000, (src.numpy(), dst.numpy())), feats))
    head = tsage.StreamingGraphSAGE(params, 16)
    list(head.run(_stream(str(tmp_path / "b.gbin"), 1000, (src[:2000].numpy(),
                                                           dst[:2000].numpy())), feats))
    resumed = tsage.StreamingGraphSAGE(params, 16)
    resumed.load_state_dict(head.state_dict())
    assert torch.equal(resumed._csr.row_ptr, head._csr.row_ptr)
    assert torch.equal(resumed._csr.src[:2000], head._csr.src[:2000])
    tail = list(resumed.run(_stream(str(tmp_path / "c.gbin"), 1000, (src[2000:].numpy(),
                                                                     dst[2000:].numpy())), feats))
    assert len(whole) == 3 and len(tail) == 1
    assert torch.equal(tail[0], whole[2])


class _Sink:
    def __init__(self):
        self.names = []

    def emit(self, event):
        self.names.append(event["name"])


def test_csr_span_fires_once_a_window(tmp_path):
    params, table = _params([16, 32, 8], torch.bfloat16)
    src, dst = _messages(15, 4000)
    sink = _Sink()
    trace.add_sink(sink)
    trace.enable()
    try:
        outs = list(tsage.StreamingGraphSAGE(params, 16).run(
            _stream(str(tmp_path / "s.gbin"), 1000, (src.numpy(), dst.numpy())),
            tsage.TableFeatureSource(table, device="cpu")))
    finally:
        trace.disable()
        trace.remove_sink(sink)
    assert len(outs) == 4
    assert sink.names.count("sage.csr") == 4
    assert sink.names.count("sage.aggregate") == 2 * 4


def test_mesh_path_pulls_nothing_through_the_csr():
    """Under a 1-wide mesh the forward aggregates the edge columns (no
    CSR, no message pulled); without one every aggregated message is
    pulled, and both give the same embeddings."""
    from test_torch_mesh import world_of_one

    params, table = _params([16, 32, 8], torch.float32)
    src, dst = _messages(16, 2048)

    def run(mesh):
        stream = gt.SimpleEdgeStream((src.numpy(), dst.numpy()), window=gt.CountWindow(512),
                                     vertex_dict=datasets.IdentityDict(V), device="cpu")
        sage = tsage.StreamingGraphSAGE(params, 16, mesh=mesh)
        pulled, aggregated = sa.MESSAGES_PULLED, tsage.MESSAGES_AGGREGATED
        outs = list(sage.run(stream, tsage.TableFeatureSource(table, device="cpu")))
        return outs, sa.MESSAGES_PULLED - pulled, tsage.MESSAGES_AGGREGATED - aggregated, sage

    with world_of_one() as mesh:
        mesh_outs, mesh_pulled, mesh_aggregated, mesh_sage = run(mesh)
    outs, pulled, aggregated, sage = run(None)
    assert mesh_sage._csr is None and mesh_pulled == 0 and mesh_aggregated > 0
    assert pulled == aggregated == 2 * sum(512 * (w + 1) for w in range(4))
    for a, b in zip(outs, mesh_outs):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("case", ["f", "dtype", "src", "row_ptr", "n", "strided", "device"])
def test_segment_mean_refuses_what_the_kernel_does_not_take(case):
    h = torch.zeros((4, 16), dtype=torch.bfloat16)
    src = torch.zeros(3, dtype=torch.int32)
    row_ptr = torch.tensor([0, 3, 3, 3, 3])
    n = 3
    if case == "f":
        h = torch.zeros((4, 12), dtype=torch.bfloat16)
    elif case == "dtype":
        h = torch.zeros((4, 16), dtype=torch.float16)
    elif case == "src":
        src = src.long()
    elif case == "row_ptr":
        row_ptr = row_ptr[:4]
    elif case == "n":
        n = 4
    elif case == "strided":
        h = torch.zeros((4, 32), dtype=torch.bfloat16)[:, ::2]
    else:
        src = src.to("meta")
    with pytest.raises(ValueError):
        sa.segment_mean(h, src, row_ptr, n)
