"""PageRank's window fixpoint kernel: its arithmetic against the JAX package.

The kernel (``csrc/pagerank.cu``, behind ``ops/pagerank_kernels.py:fixpoint``)
runs only on the card. Here a numpy model of its loop in float32 (the warm
start, the out-degrees, then iterations that stop at the converged one, no
chunks) is held against the JAX package's one-window step
(``library/pagerank.py:_make_pr_window_body(None, chunk, max_chunks)``,
jitted on the CPU), which stops by a freeze flag at chunk granularity; and
the port's plain version (``fixpoint_plain``) is held against the model.
The same seeded windows go through each, every window from the reference's
ranks of the window before: ranks within 1e-6 and within 1e-4 of
themselves, iterations equal at tol 1e-4 and 1e-5, and ``l1_delta <= tol``
wherever the reference converged. Cases: skewed ids, dangling vertices,
fewer seen vertices than rank slots, windows of one edge, windows of no
new edges, and the cap reached (tol 0).

Also: the wrapper sends CPU tensors to the plain version (one host read a
chunk, no launch); its card path, with the library replaced by a numpy
stand-in that reads and writes the operands through their pointers, makes
one counted launch into new tensors and leaves the input ranks as they
were; a refused launch raises uncounted; deterministic algorithms make the
card path raise (warn under ``warn_only``) before any launch; and malformed
operands raise before any launch.

Mirrors ``tests/test_pagerank_sage.py:38-75`` (the reference's PageRank
cases: the dense reference, the warm start, the dangling mass) at the level
of one window's fixpoint.
"""

import contextlib
import ctypes
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gelly_streaming_tpu.library.pagerank import _make_pr_window_body
from gelly_streaming_tpu_torch.ops import cuda_build, pagerank_kernels as pk

NV = 256  # rank slots
ECAP = 2048  # the carry's edge capacity
BCAP = 256  # a window's padded block
CHUNK, MAX_CHUNKS = 10, 5
DAMPING = 0.85
RANK_TOL = 1e-6
# each rank also within RANK_RTOL of itself, plus RANK_FLOOR
RANK_RTOL, RANK_FLOOR = 1e-4, 1e-10
SUM_TOL = 1e-5
CASES = ("skewed", "dangling", "partial_seen", "one_edge", "no_new_edges", "piece_rows")
# the pull model's split, small so that rows split at NV = 256: a row of at
# most ROW_THREAD entries is one thread's, a longer one is cut into pieces
# of at most PIECE entries, a warp each
ROW_THREAD, PIECE = 2, 8
# csrc/pagerank.cu's kRowThread, kPiece, kMaxGrid
KERNEL_ROW_THREAD, KERNEL_PIECE, KERNEL_MAX_GRID = 32, 1024, 2048
# "piece_rows": the targets of rows of exactly these lengths
PIECE_ROWS = {10: PIECE, 11: PIECE + 1, 12: 3 * PIECE + 1, 13: ROW_THREAD, 14: ROW_THREAD + 1}


@functools.lru_cache(maxsize=None)
def _jax_step(chunk, max_chunks):
    return jax.jit(_make_pr_window_body(None, chunk, max_chunks))


def push_model(src, dst, ranks, n_seen, damping, tol, max_iters):
    """An independent model of the fixpoint in numpy float32, as a push
    (each iteration scatters every edge's contribution into its target):
    warm start, out-degrees, then iterations until the L1 change is at most
    ``tol`` (that iteration included) or ``max_iters``. Returns ``(ranks,
    l1, iterations)``. It is the arithmetic of the first card design, a
    push kernel that the pull replaced; it holds the JAX step and
    ``fixpoint_plain`` to a model written apart from the pull's."""
    f = np.float32
    nv = len(ranks)
    n = f(max(n_seen, 1))
    d = f(damping)
    active = np.arange(nv) < n_seen
    r = np.where(active & (ranks == 0), f(1) / n, ranks).astype(f)
    r = (r / max(r.sum(dtype=f), f(1e-30))).astype(f)
    deg = np.bincount(src, minlength=nv).astype(f)
    dangling = active & (deg == 0)
    teleport = (f(1) - d) / n
    delta, it = f(np.inf), 0
    while it < max_iters:
        contrib = (r / np.maximum(deg, f(1))).astype(f)
        acc = np.zeros(nv, f)
        np.add.at(acc, dst, contrib[src])
        dm = r[dangling].sum(dtype=f)
        new = teleport + d * (acc + dm / n)
        new = np.where(active, new, f(0)).astype(f)
        delta = np.abs(new - r).sum(dtype=f)
        r = new
        it += 1
        if delta <= f(tol):
            break
    return r, float(delta), it


def pull_layout(src, dst, nv, n_seen, row_thread, piece):
    """The pull kernel's set-up in a fixed order: ``(row_ptr, col, pieces,
    first)``: the CSR by target (each row's sources in edge order; the
    kernel's order changes from run to run), the pieces in vertex order as
    ``(vertex, first entry)`` and each piece's row's first piece. A seen
    vertex's row longer than ``row_thread`` has a piece for each ``piece``
    entries or part of them; other rows have none."""
    indeg = np.bincount(dst, minlength=nv)
    row_ptr = np.zeros(nv + 1, np.int64)
    row_ptr[1:] = np.cumsum(indeg)
    col = src[np.argsort(dst, kind="stable")]
    count = np.where((np.arange(nv) < n_seen) & (indeg > row_thread), -(-indeg // piece), 0)
    vertex = np.repeat(np.arange(nv), count)
    first = np.repeat(np.cumsum(count) - count, count)
    start = row_ptr[vertex] + (np.arange(len(vertex)) - first) * piece
    return row_ptr, col, list(zip(vertex.tolist(), start.tolist())), first


def _warp_sum(x):
    """A warp's sum of ``x`` in float32: lane l adds entries l, l + 32, ...
    in order, then the shuffle tree (offsets 16 to 1) into lane 0."""
    lanes = np.zeros(32, np.float32)
    for i in range(0, len(x), 32):
        part = x[i:i + 32]
        lanes[:len(part)] += part
    for o in (16, 8, 4, 2, 1):
        lanes[:32 - o] = lanes[:32 - o] + lanes[o:]
    return lanes[0]


def pull_model(src, dst, ranks, n_seen, damping, tol, max_iters, row_thread=ROW_THREAD,
               piece=PIECE):
    """The pull kernel in numpy float32: the warm start, the out-degrees,
    :func:`pull_layout`, then iterations until the L1 change is at most
    ``tol`` (that iteration included) or ``max_iters``. An iteration
    gathers from one contribution buffer and writes the other; a thread
    sums a short row in order, a warp each piece of a long one
    (:func:`_warp_sum`), and a row's pieces add up in piece order. Returns
    ``(ranks, l1, iterations)``."""
    f = np.float32
    nv = len(ranks)
    n = f(max(n_seen, 1))
    d = f(damping)
    active = np.arange(nv) < n_seen
    r = np.where(active & (ranks == 0), f(1) / n, ranks).astype(f)
    r = (r / max(r.sum(dtype=f), f(1e-30))).astype(f)
    deg = np.maximum(np.bincount(src, minlength=nv), 1).astype(f)
    dangling = active & (np.bincount(src, minlength=nv) == 0)
    row_ptr, col, pieces, first = pull_layout(src, dst, nv, n_seen, row_thread, piece)
    lens = np.diff(row_ptr)
    by_thread = np.where(active & (lens <= row_thread), lens, 0)
    teleport = (f(1) - d) / n
    contrib = [(r / deg).astype(f), np.zeros(nv, f)]
    dm = r[dangling].sum(dtype=f)
    delta, it = f(np.inf), 0
    while it < max_iters:
        cur = contrib[it % 2]
        sums = np.zeros(nv, f)
        for k in range(by_thread.max(initial=0)):
            on = k < by_thread
            sums[on] += cur[col[row_ptr[:-1][on] + k]]
        partial = [_warp_sum(cur[col[s:min(s + piece, row_ptr[v + 1])]]) for v, s in pieces]
        for p, (v, _) in enumerate(pieces):
            if first[p] == p:  # the row's pieces, in order
                total = f(0)
                for q in range(p, p + -(-lens[v] // piece)):
                    total += partial[q]
                sums[v] = total
        new = np.where(active, teleport + d * (sums + dm / n), f(0)).astype(f)
        delta = np.abs(new - r).sum(dtype=f)
        contrib[(it + 1) % 2] = (new / deg).astype(f)
        dm = new[dangling].sum(dtype=f)
        r = new
        it += 1
        if delta <= f(tol):
            break
    return r, float(delta), it


def _windows(case, seed):
    """The case's windows as (src, dst) int32 blocks."""
    rng = np.random.default_rng(seed)

    def block(n, hi_src=NV, hi_dst=NV, skew=1.0):
        s = (rng.random(n) ** skew * hi_src).astype(np.int32)
        t = (rng.random(n) ** skew * hi_dst).astype(np.int32)
        return s, t

    if case == "skewed":
        return [block(200, skew=3.0) for _ in range(3)]
    if case == "dangling":  # ids 64 and above only receive
        return [block(200, hi_src=64, hi_dst=200) for _ in range(3)]
    if case == "partial_seen":  # ids below 90 of 256 slots
        return [block(150, hi_src=90, hi_dst=90) for _ in range(3)]
    if case == "piece_rows":  # PIECE_ROWS' lengths in window 0, other targets after
        s0 = rng.integers(0, NV, sum(PIECE_ROWS.values())).astype(np.int32)
        t0 = np.repeat(np.array(list(PIECE_ROWS), np.int32), list(PIECE_ROWS.values()))
        return [(s0, t0)] + [(rng.integers(0, NV, 150).astype(np.int32),
                              rng.integers(20, NV, 150).astype(np.int32)) for _ in range(2)]
    if case == "one_edge":
        return [block(1), block(150), block(1), block(1)]
    return [block(200), block(0), block(100), block(0)]  # no_new_edges


def _run_windows(case, seed, tol, chunk=CHUNK, max_chunks=MAX_CHUNKS):
    """Each window through the JAX step; returns per window the operands
    the port's fixpoint takes (the edges so far, the ranks before, n_seen)
    and the reference's (ranks, l1, iterations)."""
    step = _jax_step(chunk, max_chunks)
    csrc = np.zeros(ECAP, np.int32)
    cdst = np.zeros(ECAP, np.int32)
    ranks = np.zeros(NV, np.float32)
    n0 = n_seen = 0
    out = []
    for s, t in _windows(case, seed):
        k = len(s)
        if k:
            n_seen = max(n_seen, 1 + int(max(s.max(), t.max())))
        bsrc = np.zeros(BCAP, np.int32)
        bdst = np.zeros(BCAP, np.int32)
        bsrc[:k], bdst[:k] = s, t
        (jsrc, jdst, jr), delta, iters = step(
            (jnp.asarray(csrc), jnp.asarray(cdst), jnp.asarray(ranks)),
            jnp.asarray(bsrc), jnp.asarray(bdst), n0, k, n_seen, DAMPING, tol)
        csrc[n0:n0 + k], cdst[n0:n0 + k] = s, t
        n0 += k
        np.testing.assert_array_equal(np.asarray(jsrc)[:n0], csrc[:n0])
        operands = (csrc[:n0].copy(), cdst[:n0].copy(), ranks, n_seen)
        ranks = np.asarray(jr)
        out.append((operands, (ranks, float(delta), int(iters))))
    return out


def _assert_window(got, want, tol, max_iters, label):
    (r, delta, it), (wr, _wdelta, wit) = got, want
    diff = np.abs(np.asarray(r, np.float64) - wr)
    assert diff.max() <= RANK_TOL, (label, diff.max())
    assert np.all(diff <= RANK_RTOL * np.abs(wr) + RANK_FLOOR), label
    assert abs(float(np.sum(r, dtype=np.float64)) - 1) <= SUM_TOL, label
    assert it == wit, (label, it, wit)
    if wit < max_iters:  # the reference converged
        assert delta <= np.float32(tol), (label, delta)


def _torch_operands(operands):
    src, dst, ranks, n_seen = operands
    return torch.from_numpy(src), torch.from_numpy(dst), torch.from_numpy(ranks.copy()), n_seen


@pytest.mark.parametrize("tol", [1e-4, 1e-5])
@pytest.mark.parametrize("case", CASES)
def test_kernel_model_matches_the_jax_window_step(case, tol):
    for w, (operands, want) in enumerate(_run_windows(case, 3, tol)):
        src, dst, ranks, n_seen = operands
        got = push_model(src, dst, ranks, n_seen, DAMPING, tol, CHUNK * MAX_CHUNKS)
        _assert_window(got, want, tol, CHUNK * MAX_CHUNKS, f"{case} window {w}")


@pytest.mark.parametrize("tol", [1e-4, 1e-5])
@pytest.mark.parametrize("case", CASES)
def test_fixpoint_plain_matches_the_kernel_model(case, tol):
    for w, (operands, _) in enumerate(_run_windows(case, 4, tol)):
        src, dst, ranks, n_seen = operands
        want = push_model(src, dst, ranks, n_seen, DAMPING, tol, CHUNK * MAX_CHUNKS)
        ts, td, tr, _ = _torch_operands(operands)
        r, delta, it = pk.fixpoint_plain(ts, td, tr, n_seen, DAMPING, tol, CHUNK, MAX_CHUNKS)
        assert r.dtype == torch.float32 and delta.dtype == torch.float32
        assert it.dtype == torch.int32 and delta.dim() == it.dim() == 0
        assert np.array_equal(tr.numpy(), ranks), "the input ranks were written"
        _assert_window((r.numpy(), float(delta), int(it)), want, tol, CHUNK * MAX_CHUNKS,
                       f"{case} window {w}")


@pytest.mark.parametrize("tol", [1e-4, 1e-5])
@pytest.mark.parametrize("case", CASES)
def test_pull_model_matches_the_jax_window_step(case, tol):
    for w, (operands, want) in enumerate(_run_windows(case, 3, tol)):
        src, dst, ranks, n_seen = operands
        got = pull_model(src, dst, ranks, n_seen, DAMPING, tol, CHUNK * MAX_CHUNKS)
        _assert_window(got, want, tol, CHUNK * MAX_CHUNKS, f"{case} window {w}")


@pytest.mark.parametrize("tol", [1e-4, 1e-5])
@pytest.mark.parametrize("case", CASES)
def test_fixpoint_plain_matches_the_pull_model(case, tol):
    for w, (operands, _) in enumerate(_run_windows(case, 4, tol)):
        src, dst, ranks, n_seen = operands
        want = pull_model(src, dst, ranks, n_seen, DAMPING, tol, CHUNK * MAX_CHUNKS)
        r, delta, it = pk.fixpoint_plain(*_torch_operands(operands), DAMPING, tol, CHUNK,
                                         MAX_CHUNKS)
        _assert_window((r.numpy(), float(delta), int(it)), want, tol, CHUNK * MAX_CHUNKS,
                       f"{case} window {w}")


def test_pull_layout_cuts_long_rows_into_pieces():
    """Rows of ROW_THREAD entries or fewer have no piece; longer ones one
    for each PIECE entries or part of them (P, P + 1, 3P + 1 entries: 1, 2
    and 4 pieces), in vertex order, each inside its row and starting a
    PIECE apart; rows of vertices past ``n_seen`` have none; the CSR holds
    each row's sources; at the kernel's split no row here is cut."""
    src, dst, _, n_seen = _run_windows("piece_rows", 3, 1e-4)[-1][0]
    row_ptr, col, pieces, first = pull_layout(src, dst, NV, n_seen, ROW_THREAD, PIECE)
    lens = np.diff(row_ptr)
    assert all(lens[v] == k for v, k in PIECE_ROWS.items())
    count = np.bincount([v for v, _ in pieces], minlength=NV)
    assert [count[v] for v in PIECE_ROWS] == [1, 2, 4, 0, 1]
    assert np.array_equal(count, np.where(lens > ROW_THREAD, -(-lens // PIECE), 0))
    assert [v for v, _ in pieces] == sorted(v for v, _ in pieces)
    for p, (v, start) in enumerate(pieces):
        assert row_ptr[v] <= start < row_ptr[v + 1]
        assert start - row_ptr[v] == (p - first[p]) * PIECE
    for v in range(NV):
        assert sorted(col[row_ptr[v]:row_ptr[v + 1]]) == sorted(src[dst == v])
    assert all(v < 12 for v, _ in pull_layout(src, dst, NV, 12, ROW_THREAD, PIECE)[2])
    assert pull_layout(src, dst, NV, n_seen, KERNEL_ROW_THREAD, KERNEL_PIECE)[2] == []


@pytest.mark.parametrize("case", ["skewed", "dangling"])
def test_cap_reached_at_tol_zero(case):
    """tol 0: every window runs the cap, chunk * max_chunks iterations, in
    the reference, both models and the plain version."""
    chunk, max_chunks = 4, 3
    cap = chunk * max_chunks
    for w, (operands, want) in enumerate(_run_windows(case, 5, 0.0, chunk, max_chunks)):
        assert want[2] == cap
        src, dst, ranks, n_seen = operands
        got = push_model(src, dst, ranks, n_seen, DAMPING, 0.0, cap)
        _assert_window(got, want, 0.0, cap, f"{case} window {w} model")
        got = pull_model(src, dst, ranks, n_seen, DAMPING, 0.0, cap)
        _assert_window(got, want, 0.0, cap, f"{case} window {w} pull model")
        r, delta, it = pk.fixpoint_plain(*_torch_operands(operands), DAMPING, 0.0, chunk,
                                         max_chunks)
        _assert_window((r.numpy(), float(delta), int(it)), want, 0.0, cap,
                       f"{case} window {w} plain")


def test_wrapper_sends_cpu_tensors_to_the_plain_version():
    """On CPU tensors: the plain version's values, one host read a chunk,
    no launch."""
    launches = pk.LAUNCHES
    for operands, _ in _run_windows("skewed", 6, 1e-5):
        args = _torch_operands(operands)
        reads = pk.HOST_READS
        r, delta, it = pk.fixpoint(*args, DAMPING, 1e-5, CHUNK, MAX_CHUNKS)
        assert pk.HOST_READS - reads == -(-int(it) // CHUNK)
        pr, pdelta, pit = pk.fixpoint_plain(*args, DAMPING, 1e-5, CHUNK, MAX_CHUNKS)
        assert torch.equal(r, pr) and torch.equal(delta, pdelta) and torch.equal(it, pit)
    assert pk.LAUNCHES == launches


def _scratch_bytes(n_edges, nv):
    """``pagerank_scratch_bytes``: csrc/pagerank.cu's scratch_words, in bytes."""
    pieces = n_edges // (KERNEL_ROW_THREAD + 1) + n_edges // KERNEL_PIECE + 1
    return 4 * (5 * nv + 1 + 2 * n_edges + 4 * pieces + 7 * KERNEL_MAX_GRID)


class _StandIn:
    """The kernel library's C interface, computed by :func:`pull_model` at
    the kernel's split through the operands' pointers, as the kernel reads
    and writes them."""

    def __init__(self, code=0):
        self.code = code
        self.calls = []

    @staticmethod
    def _array(ptr, n, ctype):
        return np.ctypeslib.as_array((ctype * max(n, 1)).from_address(ptr))[:n]

    def _run(self, model, design, src, dst, ranks_in, ranks_out, delta, iters, n_edges, nv,
             n_seen, damping, tol, max_iters):
        self.calls.append(dict(design=design, n_edges=n_edges, nv=nv, n_seen=n_seen,
                               max_iters=max_iters))
        if self.code:
            return self.code
        s = self._array(src, n_edges, ctypes.c_int32)
        t = self._array(dst, n_edges, ctypes.c_int32)
        r_in = self._array(ranks_in, nv, ctypes.c_float)
        r, l1, it = model(s, t, r_in.copy(), n_seen, damping, tol, max_iters)
        self._array(ranks_out, nv, ctypes.c_float)[:] = r
        self._array(delta, 1, ctypes.c_float)[0] = l1
        self._array(iters, 1, ctypes.c_int32)[0] = it
        return 0

    def pagerank_fixpoint_launch(self, src, dst, ranks_in, ranks_out, scratch, delta, iters,
                                 n_edges, nv, n_seen, damping, tol, max_iters, device, stream):
        model = functools.partial(pull_model, row_thread=KERNEL_ROW_THREAD, piece=KERNEL_PIECE)
        return self._run(model, "pull", src, dst, ranks_in, ranks_out, delta, iters, n_edges,
                         nv, n_seen, damping, tol, max_iters)

    def pagerank_scratch_bytes(self, n_edges, nv):
        self.calls.append(dict(scratch=(n_edges, nv)))
        return _scratch_bytes(n_edges, nv)

    def launch_error_string(self, code):
        return b"a refused launch"


@pytest.fixture
def stand_in(monkeypatch):
    """The card path on CPU tensors: the library and the CUDA device and
    stream lookups replaced."""
    lib = _StandIn()
    monkeypatch.setattr(pk, "_library", lambda: lib)
    monkeypatch.setattr(cuda_build, "device_index", lambda device: 0)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: type("Stream", (), {"cuda_stream": 0})())
    return lib


def test_card_path_makes_one_launch_into_new_tensors(stand_in):
    for w, (operands, want) in enumerate(_run_windows("dangling", 7, 1e-5)):
        src, dst, ranks, n_seen = _torch_operands(operands)
        held = ranks.clone()
        before = pk.LAUNCHES
        r, delta, it = pk._fixpoint_kernel(src, dst, ranks, n_seen, DAMPING, 1e-5,
                                           CHUNK * MAX_CHUNKS)
        assert pk.LAUNCHES == before + 1
        assert stand_in.calls[-2] == dict(scratch=(src.shape[0], NV))
        call = stand_in.calls[-1]
        assert call["design"] == "pull"
        assert call["n_edges"] == src.shape[0] and call["nv"] == NV
        assert call["max_iters"] == CHUNK * MAX_CHUNKS and call["n_seen"] == n_seen
        assert r.data_ptr() != ranks.data_ptr() and torch.equal(ranks, held)
        assert r.shape == ranks.shape and r.dtype == torch.float32
        assert delta.dtype == torch.float32 and it.dtype == torch.int32
        assert delta.dim() == it.dim() == 0
        _assert_window((r.numpy(), float(delta), int(it)), want, 1e-5, CHUNK * MAX_CHUNKS,
                       f"window {w}")


def test_card_path_raises_on_a_refused_launch_uncounted(stand_in):
    stand_in.code = 720  # cudaErrorCooperativeLaunchTooLarge
    (operands, _), = _run_windows("skewed", 8, 1e-4)[:1]
    before = pk.LAUNCHES
    with pytest.raises(RuntimeError, match="a refused launch"):
        pk._fixpoint_kernel(*_torch_operands(operands), DAMPING, 1e-4, 50)
    assert pk.LAUNCHES == before
    assert [c.get("design") for c in stand_in.calls] == [None, "pull"]


@pytest.mark.parametrize("design", ["pull"])
def test_card_path_with_no_iteration_returns_the_warm_start(design, stand_in):
    """max_iters 0 (the set-up alone, which chip_smoke.py times): the warm
    start's ranks, l1 +inf, 0 iterations."""
    (operands, _), = _run_windows("partial_seen", 11, 1e-4)[1:2]
    src, dst, ranks, n_seen = _torch_operands(operands)
    r, delta, it = pk._fixpoint_kernel(src, dst, ranks, n_seen, DAMPING, 1e-4, 0)
    active = torch.arange(NV) < n_seen
    want = torch.where(active & (ranks == 0), 1.0 / torch.tensor(float(n_seen)), ranks)
    assert torch.allclose(r, want / want.sum(), rtol=1e-6, atol=0.0)
    assert float(delta) == float("inf") and int(it) == 0


@contextlib.contextmanager
def _deterministic(warn_only):
    torch.use_deterministic_algorithms(True, warn_only=warn_only)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)


def test_card_path_refuses_deterministic_algorithms(stand_in):
    """Strict mode raises before any launch, ``warn_only`` warns and
    launches; CPU tensors take the (deterministic) plain version."""
    (operands, _), = _run_windows("skewed", 9, 1e-4)[:1]
    args = _torch_operands(operands)
    before = pk.LAUNCHES
    with _deterministic(False):
        with pytest.raises(RuntimeError, match="deterministic"):
            pk._fixpoint_kernel(*args, DAMPING, 1e-4, 50)
        assert pk.LAUNCHES == before and not stand_in.calls
        pk.fixpoint(*args, DAMPING, 1e-4, CHUNK, MAX_CHUNKS)  # the CPU path
    with _deterministic(True):
        with pytest.warns(UserWarning, match="deterministic"):
            pk._fixpoint_kernel(*args, DAMPING, 1e-4, 50)
    assert pk.LAUNCHES == before + 1


def _malformed():
    src = torch.zeros(8, dtype=torch.int32)
    ranks = torch.zeros(4)
    meta = torch.zeros(8, dtype=torch.int32, device="meta")
    return {
        "int64 src": ((src.long(), src, ranks, 4, 10, 5), "int32"),
        "int64 dst": ((src, src.long(), ranks, 4, 10, 5), "int32"),
        "float64 ranks": ((src, src, ranks.double(), 4, 10, 5), "float32"),
        "strided src": ((torch.zeros(16, dtype=torch.int32)[::2], src, ranks, 4, 10, 5),
                        "contiguous"),
        "shapes": ((src, src[:7], ranks, 4, 10, 5), "shape"),
        "2-D ranks": ((src, src, ranks.view(2, 2), 4, 10, 5), "shape"),
        "two devices": ((meta, src, ranks, 4, 10, 5), "one device"),
        "meta device": ((meta, meta, torch.zeros(4, device="meta"), 4, 10, 5), "unsupported"),
        "2^31 edges": ((src[:1].expand(1 << 31), src[:1].expand(1 << 31), ranks, 4, 10, 5),
                       "2\\^31"),
        "negative n_seen": ((src, src, ranks, -1, 10, 5), "n_seen"),
        "chunk 0": ((src, src, ranks, 4, 0, 5), "chunk"),
        "max_chunks 0": ((src, src, ranks, 4, 10, 0), "chunk"),
    }


@pytest.mark.parametrize("name", sorted(_malformed()))
def test_malformed_operands_raise_before_a_launch(name, stand_in):
    (src, dst, ranks, n_seen, chunk, max_chunks), match = _malformed()[name]
    launches, reads = pk.LAUNCHES, pk.HOST_READS
    with pytest.raises(ValueError, match=match):
        pk.fixpoint(src, dst, ranks, n_seen, DAMPING, 1e-6, chunk, max_chunks)
    assert pk.LAUNCHES == launches and pk.HOST_READS == reads and not stand_in.calls


def _config4_like_ranks(seed=19):
    """A float32 rank vector of config #4's size (2^18 slots, sum 1): most
    ranks about 1e-6, a few hubs far above."""
    rng = np.random.default_rng(seed)
    r = rng.lognormal(0.0, 1.0, 1 << 18)
    r[rng.integers(0, 1 << 18, 64)] *= 1e3
    return torch.from_numpy((r / r.sum()).astype(np.float32))


def _wrong_kernels(p):
    """Outputs a wrong kernel could give, each within 1e-6 of ``p``: wrong
    on the ranks below 1e-4 (all but the hubs) or on two vertices."""
    low = p < torch.quantile(p, 0.25)
    small = p < 1e-4
    return {
        "zeros for the low ranks": torch.where(low, torch.zeros_like(p), p),
        "bf16 arithmetic": torch.where(small, p.to(torch.bfloat16).float(), p),
        "ranks 2e-4 too large": torch.where(small, p * (1 + 2e-4), p),
        "mass moved between two hubs": p.clone().index_add_(
            0, torch.tensor([int(p.argmax()), int(p.argmin())]), torch.tensor([-9e-7, 9e-7])),
    }


@pytest.mark.parametrize("case", sorted(_wrong_kernels(_config4_like_ranks())))
def test_smoke_rank_check_refuses_a_wrong_kernel(case):
    """``chip_smoke.py``'s kernel check holds each rank relative to itself:
    outputs within its 1e-6 absolute bound that are wrong are refused."""
    import chip_smoke

    p = _config4_like_ranks()
    r = _wrong_kernels(p)[case]
    err, rel, _, close = chip_smoke.pr_ranks_agree(r, p)
    assert err <= chip_smoke.PR_KERNEL_TOL and rel > 1.0 and not close


def test_smoke_rank_check_passes_float_atomics_noise():
    """A few ulps of reordering noise on every rank passes."""
    import chip_smoke

    p = _config4_like_ranks()
    noise = torch.from_numpy(np.random.default_rng(20).uniform(-8, 8, p.shape[0]).astype(
        np.float32)) * p * 2.0**-24
    err, rel, total, close = chip_smoke.pr_ranks_agree(p + noise, p)
    assert close and rel < 0.01 and abs(total - 1) <= 1e-5


def test_smoke_profile_adds_the_ctypes_kernel_by_name():
    """The trace's launches of a ctypes kernel from the pass's mark on go
    to its step, divided by the windows, beside the step's bound; other
    kernels, and launches before the mark, do not count."""
    from types import SimpleNamespace

    import chip_smoke

    def event(name, us, start=100.0, device="CUDA"):
        return SimpleNamespace(name=name, device_type=SimpleNamespace(name=device),
                               time_range=SimpleNamespace(start=start, elapsed_us=lambda: us))

    prof = SimpleNamespace(events=lambda: [
        event("(anonymous namespace)::pagerank_fixpoint(Args)", 300.0, start=10.0),
        event("(anonymous namespace)::pagerank_fixpoint(Args)", 400.0),
        event("(anonymous namespace)::pagerank_fixpoint(Args)", 500.0, start=200.0),
        event("pagerank_fixpoint_launch", 3.0, device="CPU"),
        event("void at::native::index_add_kernel", 70.0),
    ])
    foreign = chip_smoke.PR_FOREIGN
    assert chip_smoke._captured_kernels(prof, foreign) == {"pagerank.fixpoint": (3, 1200.0)}
    captured = chip_smoke._captured_kernels(prof, foreign, since=50.0)
    assert captured == {"pagerank.fixpoint": (2, 900.0)}
    table = {"pagerank.fixpoint": {"calls": 1.0, "launches": 0.0, "device_ms": 0.0,
                                   "bound_ms": 0.009}}
    chip_smoke._add_foreign_kernels(table, foreign, captured, 2)
    row = table["pagerank.fixpoint"]
    assert row["launches"] == 1.0 and row["device_ms"] == pytest.approx(0.45)
    assert row["pagerank_fixpoint_ms"] == pytest.approx(0.45)
    assert row["bound_share"] == pytest.approx(0.02)
    assert chip_smoke._foreign_launches(foreign) == {"pagerank.fixpoint": pk.LAUNCHES}


def test_smoke_busy_share_counts_the_pass_from_its_mark():
    """``profile_pass(since=...)``: the kernels from the mark on over the
    pass's wall time; the primer before the mark and the device copies of
    the spans' ranges are left out."""
    from types import SimpleNamespace

    import chip_smoke

    def event(name, us, start):
        return SimpleNamespace(name=name, device_type=SimpleNamespace(name="CUDA"),
                               time_range=SimpleNamespace(start=start, elapsed_us=lambda: us))

    prof = SimpleNamespace(events=lambda: [
        event("void at::native::vectorized_elementwise_kernel", 2.0, 5.0),  # the primer
        event("(anonymous namespace)::pagerank_fixpoint(Args)", 400.0, 120.0),
        event("void at::native::index_add_kernel", 100.0, 600.0),
        event("pagerank.window", 900.0, 110.0),
        event(chip_smoke.PROFILE_MARK, 5000.0, 100.0),
    ])
    busy = chip_smoke.profile_pass(None, None, 0.01, prof=prof, since=100.0)
    assert busy == pytest.approx(500e-6 / 0.01)


def test_smoke_pr_pass_counts_the_fixpoints_host_reads(monkeypatch):
    """``chip_smoke._pr_pass`` returns ``pagerank_kernels.HOST_READS`` over
    its pass, so phase 9's "no host read a window" checks can fail: on CPU
    tensors (the plain version) one read a chunk of each window."""
    import chip_smoke

    monkeypatch.setattr(chip_smoke, "PR_WINDOW", 256)
    monkeypatch.setattr(chip_smoke, "PR_VERTICES", 512)
    rng = np.random.default_rng(21)
    src, dst = (rng.integers(0, 512, 1024).astype(np.int32) for _ in range(2))
    pk.HOST_READS = 7
    pr, ems, _, reads = chip_smoke._pr_pass(chip_smoke._pr_stream(src, dst, device="cpu"))
    assert len(ems) == 4
    assert reads > 0 and reads == sum(-(-int(e.iterations) // pr.chunk) for e in ems)
    assert reads == pk.HOST_READS
