"""The sampling estimators' reservoir scan kernel (``csrc/reservoir_scan.cu``
behind ``ops/sampling_kernels.py``), without a card.

The kernel cannot run here, so a numpy model of its three phases stands in
for it: phase 1 over row slices and column tiles of the ``[n, k]`` coin
matrix (per slice and sample the last row whose coin came up and whether
a carried closing pair occurs, packed in one word as the kernel's scratch
holds it), the reduction of a sample's slices to its last replacement L,
then the third vertex from ``u_third[L, j]`` and the search for the new
closing pairs among the edges after L, chunk by chunk. It uses numpy
float32 scalars, each operation rounded as the kernel's intrinsics round
(``__fdiv_rn``, ``__ll2float_rn``, ``__int2float_rn``, ``__fmul_rn``,
``__float2int_rz``). The model must equal the JAX package's
``_window_scan`` fed its own uniforms (recomputed from its key, as
``tests/test_torch_sampling.py`` does, which mirrors
``tests/test_sampling.py``) and must equal ``reservoir_scan_plain``, also on
uniforms placed at the rounding edges of the threshold and of the third
vertex's product, and on batches built around each sample's last
replacement. The card path runs with the library replaced by a numpy
stand-in that reads and writes the operands through their pointers.
"""

import contextlib
import ctypes

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gelly_streaming_tpu.library import sampling as JS
from gelly_streaming_tpu_torch.library import sampling as TS
from gelly_streaming_tpu_torch.ops import cuda_build, sampling_kernels as sk

TILE_COLS = 128  # csrc/reservoir_scan.cu: 4 * kMaxGroups columns a tile
SLICE_ROWS = 64  # a slice at the least grid's lanes * kRows (8 * 8 at k >= 128)
CHUNK = 4096  # kChunk: tail edges a warp searches in one go
FIELDS = [name for name, _ in sk.FIELDS]


def _key(u, v):
    """The kernel's ``pair_key``: the pair as (min, max) in 64 bits."""
    return ((min(u, v) & 0xFFFFFFFF) << 32) | (max(u, v) & 0xFFFFFFFF)


def _third(a, b, ut, vertex_count):
    """Phase 2's third vertex of edge ``(a, b)`` from the draw ``ut``."""
    u1, u2 = min(a, b), max(a, b)
    nv = vertex_count - 1 - (u1 != u2)
    c = min(int(np.float32(ut) * np.float32(nv)), nv - 1)
    c += c >= u1
    c += (u1 != u2) and c >= u2
    return c


def _chunk_end(i, chunk):
    return (i // chunk + 1) * chunk


def kernel_model(state, m0, s, d, vertex_count, u_coin, u_third, slice_rows=SLICE_ROWS,
                 chunk=CHUNK):
    """The kernel's three phases in numpy: ``state`` a dict of numpy
    columns, ``s``, ``d`` int arrays, ``u_coin``, ``u_third`` float32
    ``[n, k]``. Returns the new state (new arrays)."""
    n, k = u_coin.shape
    s, d = [int(x) for x in s], [int(x) for x in d]
    old = {f: np.array(v, copy=True) for f, v in state.items()}
    out = {f: np.array(v, copy=True) for f, v in state.items()}
    thr = np.array([np.float32(1.0) / np.float32(m0 + i + 1) for i in range(n)], np.float32)
    key = np.array([_key(a, b) for a, b in zip(s, d)], np.uint64)
    close_src = np.array([_key(int(a), int(c)) for a, c in zip(old["src"], old["third"])],
                         np.uint64)
    close_trg = np.array([_key(int(b), int(c)) for b, c in zip(old["trg"], old["third"])],
                         np.uint64)
    # phase 1: one word a (slice, sample), each written by its (slice, tile) item
    slices = -(-n // slice_rows)
    word = np.zeros((slices, k), np.uint32)
    for sl in range(slices):
        row0 = sl * slice_rows
        rows = slice(row0, min(n, row0 + slice_rows))
        for col0 in range(0, k, TILE_COLS):
            cols = slice(col0, min(k, col0 + TILE_COLS))
            coin = u_coin[rows, cols] < thr[rows, None]
            local = np.where(coin.any(0), coin.shape[0] - 1 - np.argmax(coin[::-1], 0), -1)
            kk = key[rows, None]
            hits = ((kk == close_src[None, cols]).any(0).astype(np.uint32)
                    | ((kk == close_trg[None, cols]).any(0).astype(np.uint32) << 1))
            word[sl, cols] = ((local + 1).astype(np.uint32) << 2) | hits
    # phase 2: a sample's slices to L, then the fields and its first chunk
    last = np.full(k, -1)
    for j in range(k):
        hits = 0
        for sl in range(slices):
            w = int(word[sl, j])
            if w >> 2:
                last[j] = max(last[j], sl * slice_rows + (w >> 2) - 1)
            hits |= w & 3
        L = int(last[j])
        if L < 0:
            out["src_found"][j] = bool(old["src_found"][j]) | bool(hits & 1)
            out["trg_found"][j] = bool(old["trg_found"][j]) | bool(hits >> 1)
            continue
        c = _third(s[L], d[L], u_third[L, j], vertex_count)
        out["src"][j], out["trg"][j], out["third"][j] = s[L], d[L], c
        tail = key[L + 1:min(n, _chunk_end(L + 1, chunk))]
        out["src_found"][j] = bool((tail == _key(s[L], c)).any())
        out["trg_found"][j] = bool((tail == _key(d[L], c)).any())
    # phase 3, past one chunk: the later chunks of each tail
    if n > chunk:
        for j in range(k):
            for start in range(0, n, chunk):
                L = int(last[j])
                if L < 0 or start < _chunk_end(L + 1, chunk):
                    continue
                c = int(out["third"][j])
                part = key[start:min(n, start + chunk)]
                if (part == _key(int(out["src"][j]), c)).any():
                    out["src_found"][j] = True
                if (part == _key(int(out["trg"][j]), c)).any():
                    out["trg_found"][j] = True
    return out


def _init_np(k):
    return {f: v.numpy() for f, v in TS.init_sampler_state(k, "cpu").items()}


def _torch_state(st):
    return {f: torch.from_numpy(np.array(v, copy=True)) for f, v in st.items()}


def _uniform(key, k):
    return np.array(jax.random.uniform(key, (k,)))


def _scan_draws(key, k, n, cap):
    """The JAX scan's per-slot key splits over ``cap`` slots; the coin and
    third-vertex draws of the first ``n`` as ``[n, k]`` float32."""
    coins, thirds = [], []
    for i in range(cap):
        key, k_coin, k_third = jax.random.split(key, 3)
        if i < n:
            coins.append(_uniform(k_coin, k))
            thirds.append(_uniform(k_third, k))
    return key, np.stack(coins), np.stack(thirds)


def _edges(case, seed, n):
    """``n`` edges among 12 ids, so closing edges occur: with self-loops
    and repeats where asked; for the large id space a quarter of the
    sources come from its top."""
    rng = np.random.default_rng(seed)
    s = rng.integers(0, 12, n)
    d = rng.integers(0, 12, n)
    if case == "loops_repeats":
        d[::5] = s[::5]  # self-loops
        s[1::7], d[1::7] = s[0], d[0]  # one edge again and again
        s[3::11], d[3::11] = d[0], s[0]  # and reversed
    if case == "large_ids":
        s[::4] = (1 << 24) + 2 - rng.integers(0, 3, len(s[::4]))
    return s.astype(np.int32), d.astype(np.int32)


# (name, vertex_count, edge count before the batch, k, n, cap)
CASES = [
    ("loops_repeats", 1 << 16, 0, 96, 120, 128),
    ("loops_repeats", 14, 0, 64, 60, 64),
    ("across_2_24", 1 << 16, (1 << 24) - 8, 48, 32, 32),
    ("large_ids", (1 << 24) + 3, 0, 64, 60, 64),
]


@pytest.mark.parametrize("case, v, m0, k, n, cap", CASES, ids=[
    f"{c[0]}-V{c[1]}-m{c[2]}" for c in CASES])
def test_kernel_model_matches_jax_window_scan_and_the_plain_version(case, v, m0, k, n, cap):
    s, d = _edges(case, v + m0, cap)
    key = jax.random.PRNGKey(v % 1000 + k)
    st = _init_np(k)
    # a carried state that already holds edges, so the batch can close them
    pre_s, pre_d = _edges(case, 7, 8)
    _, pc, pt = _scan_draws(jax.random.PRNGKey(1), k, 8, 8)
    st = kernel_model(st, 0, pre_s, pre_d, v, np.zeros_like(pc), pt)  # every coin: 0 < 1/m
    jst = {f: jnp.asarray(x) for f, x in st.items()}
    _, coins, thirds = _scan_draws(key, k, n, cap)
    mask = np.arange(cap) < n
    jout, jn, _, jb = JS._window_scan(jst, jnp.int32(m0), key, (jnp.asarray(s), jnp.asarray(d)),
                                      jnp.asarray(mask), v)
    got = kernel_model(st, m0, s[:n], d[:n], v, coins, thirds, slice_rows=16, chunk=32)
    plain, m = sk.reservoir_scan_plain(_torch_state(st), m0, s[:n], d[:n], v,
                                       torch.from_numpy(coins), torch.from_numpy(thirds))
    assert int(jn) == m == m0 + n
    for f in FIELDS:
        np.testing.assert_array_equal(got[f], np.asarray(jout[f]), err_msg=f)
        np.testing.assert_array_equal(got[f], plain[f].numpy(), err_msg=f)
    assert int(jb) == int((got["src_found"] & got["trg_found"]).sum())
    if v == 14:
        assert (got["src_found"] & got["trg_found"]).any()


def _edge_uniforms(seed, m0, v, s, d, k):
    """Uniforms at the rounding edges: each coin at its threshold, one ulp
    below or above it, or random; the third draws random, the largest and
    least float32 uniforms in two columns, and in four more, for each edge,
    draws whose float32 product with float32(nv) truncates to another
    integer than the exact product does (their coins always come up, so the
    last edge's draws stay in the state)."""
    rng = np.random.default_rng(seed)
    n = len(s)
    m = np.arange(m0 + 1, m0 + n + 1)
    thr = (np.float32(1.0) / m.astype(np.float32)).astype(np.float32)[:, None]
    pick = rng.integers(0, 4, (n, k))
    coin = np.where(pick == 0, thr, np.where(
        pick == 1, np.nextafter(thr, np.float32(0)), np.where(
            pick == 2, np.nextafter(thr, np.float32(1)),
            rng.random((n, k), dtype=np.float32))))
    third = rng.random((n, k), dtype=np.float32)
    third[:, 0] = np.float32(1.0) - np.float32(2.0 ** -24)
    third[:, 1] = np.float32(2.0 ** -24)
    pool = rng.random(1 << 16, dtype=np.float32)
    for i in range(n):
        nv = v - 1 - int(s[i] != d[i])
        f32 = (pool * np.float32(nv)).astype(np.int64)
        exact = np.floor(pool.astype(np.float64) * nv).astype(np.int64)
        off = pool[f32 != exact][:4]
        third[i, 2:2 + len(off)] = off
    coin[:, 2:6] = np.nextafter(thr, np.float32(0))
    return coin.astype(np.float32), third


@pytest.mark.parametrize("v", [1 << 16, (1 << 24) + 3])
@pytest.mark.parametrize("m0", [0, (1 << 24) - 8, (1 << 31) + 5])
def test_kernel_model_matches_plain_at_the_rounding_edges(v, m0):
    """Across m = 2^24 float32(m) rounds; above 2^24 + 2 so does float32(nv):
    the model and the plain version take the same side of every edge, and
    coins land on the threshold exactly."""
    k, n = 40, 32
    s, d = _edges("large_ids" if v > 1 << 24 else "loops_repeats", 3, n)
    coin, third = _edge_uniforms(v + m0, m0, v, s, d, k)
    st = _init_np(k)
    got = kernel_model(st, m0, s, d, v, coin, third, slice_rows=8, chunk=8)
    plain, _ = sk.reservoir_scan_plain(_torch_state(st), m0, s, d, v,
                                       torch.from_numpy(coin), torch.from_numpy(third))
    for f in FIELDS:
        np.testing.assert_array_equal(got[f], plain[f].numpy(), err_msg=f)
    assert (got["src"] >= 0).any()  # some coins came up


def _last_coins(coins, m0):
    """Each sample's last edge whose coin came up (-1: none) and its count
    of coins, with the kernel's float32 thresholds."""
    n = coins.shape[0]
    thr = np.array([np.float32(1.0) / np.float32(m0 + i + 1) for i in range(n)], np.float32)
    up = coins < thr[:, None]
    return np.where(up.any(0), n - 1 - np.argmax(up[::-1], 0), -1), up.sum(0)


def _carried_state(k, v, seed):
    """A state whose every sample holds an edge among 12 ids: 8 edges with
    every coin up, random third draws."""
    pre_s, pre_d = _edges("loops_repeats", seed, 8)
    pt = np.random.default_rng(seed).random((8, k), dtype=np.float32)
    return kernel_model(_init_np(k), 0, pre_s, pre_d, v, np.zeros((8, k), np.float32), pt)


def _place_carried_pairs(st, s, d):
    """Write the carried pair {src, third} of samples 0-3 and {trg, third}
    of samples 4-7 into the batch (one each reversed); returns the edges
    and the flags they must set."""
    s, d = s.copy(), d.copy()
    want = {"src_found": {}, "trg_found": {}}
    for j in range(8):
        end = "src" if j < 4 else "trg"
        a, c = int(st[end][j]), int(st["third"][j])
        p = (3 * j + 1) % len(s)
        s[p], d[p] = (c, a) if j % 2 else (a, c)
        want[end + "_found"][j] = True
    return s, d, want


def _place_closing_pairs(case, s, d, last, thirds, v):
    """Write closing pairs of up to 4 samples around their last
    replacement L: before it only, after it only (both pairs), or before
    and after. Edges at any target's L stay, so its third does not change;
    returns the edges and the flags each target must end with."""
    n, k = thirds.shape
    s, d = s.copy(), d.copy()
    lo = 1 if case in ("closing_before_only", "closing_before_and_after") else 0
    hi = n - 2 if case in ("closing_after_only", "closing_before_and_after") else n - 1
    targets, seen = [], set()
    for j in range(k):
        if lo <= last[j] <= hi and last[j] not in seen and len(targets) < 4:
            targets.append(j)
            seen.add(int(last[j]))
    assert len(targets) == 4
    used = set(seen)
    want = {"src_found": {}, "trg_found": {}}

    def place(rows, a, c, flip):
        p = next(i for i in rows if i not in used)
        used.add(p)
        s[p], d[p] = (c, a) if flip else (a, c)

    for t, j in enumerate(targets):
        L = int(last[j])
        a, b = int(s[L]), int(d[L])
        c = _third(a, b, thirds[L, j], v)
        before, after = range(L - 1, -1, -1), range(n - 1, L, -1)
        if case == "closing_before_only":
            place(before, a, c, t % 2)
            want["src_found"][j] = False
        elif case == "closing_after_only":
            place(after, a, c, t % 2)
            place(after, b, c, 1 - t % 2)
            want["src_found"][j] = want["trg_found"][j] = True
        else:
            place(before, a, c, t % 2)
            place(after, a, c, 1 - t % 2)
            want["src_found"][j] = True
    return s, d, want


# (name, edge count before the batch, k, n, model slice rows, model chunk)
AROUND_L = [
    ("coin_last_at_0_and_at_n-1", 0, 64, 2, 64, 4096),
    ("several_coins", 0, 48, 40, 8, 16),
    ("no_coin", 1 << 30, 40, 24, 8, 8),
    ("every_sample_replaced", 0, 36, 30, 8, 8),
    ("closing_before_only", 0, 64, 48, 8, 8),
    ("closing_after_only", 0, 64, 48, 8, 8),
    ("closing_before_and_after", 0, 64, 48, 8, 8),
    ("k_not_multiple_of_4", 3, 37, 30, 8, 8),
    ("n_not_multiple_of_slice", 5, 40, 23, 5, 8),
    ("n_1", 7, 33, 1, 64, 4096),
]


@pytest.mark.parametrize("case, m0, k, n, rows, chunk", AROUND_L, ids=[c[0] for c in AROUND_L])
def test_kernel_model_matches_jax_and_plain_around_the_last_replacement(case, m0, k, n, rows,
                                                                          chunk):
    """Batches built around each sample's last replacement L (the JAX
    package's own uniforms, drawn from its key before the edges are set):
    the model, ``_window_scan`` and the plain version agree, and each case
    shows what it is about."""
    v = 1 << 16
    key = jax.random.PRNGKey(k + n)
    _, coins, thirds = _scan_draws(key, k, n, n)
    s, d = _edges("loops_repeats", n, n)
    st = _carried_state(k, v, seed=n)
    last, ups = _last_coins(coins, m0)
    want = {}
    if case.startswith("closing"):
        s, d, want = _place_closing_pairs(case, s, d, last, thirds, v)
    if case == "no_coin":
        s, d, want = _place_carried_pairs(st, s, d)
    got = kernel_model(st, m0, s, d, v, coins, thirds, slice_rows=rows, chunk=chunk)
    jst = {f: jnp.asarray(x) for f, x in st.items()}
    jout, jn, _, _ = JS._window_scan(jst, jnp.int32(m0), key, (jnp.asarray(s), jnp.asarray(d)),
                                     jnp.ones(n, bool), v)
    plain, m = sk.reservoir_scan_plain(_torch_state(st), m0, s, d, v, torch.from_numpy(coins),
                                       torch.from_numpy(thirds))
    assert int(jn) == m == m0 + n
    for f in FIELDS:
        np.testing.assert_array_equal(got[f], np.asarray(jout[f]), err_msg=f)
        np.testing.assert_array_equal(got[f], plain[f].numpy(), err_msg=f)
    for f, flags in want.items():
        assert {j: bool(got[f][j]) for j in flags} == flags, f
    kept = last < 0
    for f in ("src", "trg", "third"):
        np.testing.assert_array_equal(got[f][kept], st[f][kept], err_msg=f)
    if case == "coin_last_at_0_and_at_n-1":
        assert set(last.tolist()) == {0, n - 1}
    if case == "several_coins":
        assert (ups >= 2).any() and (ups == 1).any()
    if case == "no_coin":
        assert kept.all() and any(not st[f][j] for f in want for j in want[f])
    if case == "every_sample_replaced":
        assert (last >= 0).all() and (got["src"] >= 0).all()
    if case == "n_not_multiple_of_slice":
        assert n % rows and n > rows


def test_kernel_model_matches_plain_with_no_coin_past_int32():
    """No coin comes up at m0 above 2^31 (the JAX package counts edges in
    int32, so the plain version alone): the fields stay and the carried
    pairs set their flags."""
    k, n, v, m0 = 40, 24, 1 << 16, (1 << 31) + 5
    rng = np.random.default_rng(11)
    coins = rng.random((n, k), dtype=np.float32)
    thirds = rng.random((n, k), dtype=np.float32)
    st = _carried_state(k, v, seed=12)
    s, d, want = _place_carried_pairs(st, *_edges("loops_repeats", 13, n))
    got = kernel_model(st, m0, s, d, v, coins, thirds, slice_rows=8, chunk=8)
    plain, _ = sk.reservoir_scan_plain(_torch_state(st), m0, s, d, v, torch.from_numpy(coins),
                                       torch.from_numpy(thirds))
    for f in FIELDS:
        np.testing.assert_array_equal(got[f], plain[f].numpy(), err_msg=f)
    assert (_last_coins(coins, m0)[0] < 0).all()
    for f in ("src", "trg", "third"):
        np.testing.assert_array_equal(got[f], st[f], err_msg=f)
    for f, flags in want.items():
        assert all(got[f][j] for j in flags), f


def test_cpu_tensors_route_to_the_plain_version():
    k, n, v = 33, 50, 1 << 16
    s, d = _edges("loops_repeats", 4, n)
    rng = np.random.default_rng(4)
    coin = torch.from_numpy(rng.random((n, k), dtype=np.float32))
    third = torch.from_numpy(rng.random((n, k), dtype=np.float32))
    st = TS.init_sampler_state(k, "cpu")
    held = {f: x.clone() for f, x in st.items()}
    launches = sk.LAUNCHES
    got, m = sk.reservoir_scan(st, 3, torch.from_numpy(s), torch.from_numpy(d), v, coin, third)
    want, m_plain = sk.reservoir_scan_plain(st, 3, s, d, v, coin, third)
    assert sk.LAUNCHES == launches and m == m_plain == 3 + n
    for f in FIELDS:
        assert torch.equal(got[f], want[f]), f
        assert torch.equal(st[f], held[f]), f


def test_an_empty_batch_returns_the_state_unchanged():
    st = TS.init_sampler_state(8, "cpu")
    empty = torch.zeros(0, dtype=torch.int32)
    u = torch.zeros(0, 8)
    got, m = sk.reservoir_scan(st, 17, empty, empty, 1 << 16, u, u)
    assert m == 17 and all(got[f] is st[f] for f in FIELDS)


def _operands(k=8, n=4):
    st = TS.init_sampler_state(k, "cpu")
    ids = torch.arange(n, dtype=torch.int32)
    return st, ids, ids.clone(), torch.rand(n, k), torch.rand(n, k)


def _malformed():
    st, s, d, uc, ut = _operands()
    v = 1 << 16
    return {
        "missing column": ({f: x for f, x in st.items() if f != "third"}, 0, s, d, v, uc, ut),
        "int64 column": ({**st, "src": st["src"].long()}, 0, s, d, v, uc, ut),
        "bool as int": ({**st, "src_found": st["src_found"].int()}, 0, s, d, v, uc, ut),
        "ragged k": ({**st, "trg": st["trg"][:5]}, 0, s, d, v, uc, ut),
        "int64 ids": (st, 0, s.long(), d, v, uc, ut),
        "2-d ids": (st, 0, s[None], d[None], v, uc, ut),
        "ids of two lengths": (st, 0, s, d[:3], v, uc, ut),
        "negative id": (st, 0, s - 1, d, v, uc, ut),
        "float64 uniforms": (st, 0, s, d, v, uc.double(), ut),
        "uniforms of another k": (st, 0, s, d, v, uc[:, :7], ut),
        "uniforms of another n": (st, 0, s, d, v, uc, ut[:3]),
        "strided uniforms": (st, 0, s, d, v, torch.rand(8, 4).t(), ut),
        "strided column": ({**st, "src": torch.zeros(16, dtype=torch.int32)[::2]},
                           0, s, d, v, uc, ut),
        "vertex_count 2": (st, 0, s, d, 2, uc, ut),
        "vertex_count 2^31": (st, 0, s, d, 1 << 31, uc, ut),
        "negative edge_count": (st, -1, s, d, v, uc, ut),
    }


class _StandIn:
    """The kernel library's C interface, computed by :func:`kernel_model`
    through the operands' pointers, as the kernel reads and writes them."""

    def __init__(self, code=0):
        self.code = code
        self.calls = []

    @staticmethod
    def _array(ptr, n, ctype):
        return np.ctypeslib.as_array((ctype * max(n, 1)).from_address(ptr))[:n]

    @staticmethod
    def reservoir_scan_scratch_words(n, k, device):
        return (-(-n // SLICE_ROWS) + 1) * k

    def reservoir_scan_launch(self, src_in, trg_in, third_in, sf_in, tf_in, src_out, trg_out,
                              third_out, sf_out, tf_out, es, ed, u_coin, u_third, scratch,
                              scratch_words, m0, n, k, vertex_count, device, stream):
        self.calls.append(dict(m0=m0, n=n, k=k, vertex_count=vertex_count))
        if self.code:
            return self.code
        assert scratch_words == self.reservoir_scan_scratch_words(n, k, device)
        self._array(scratch, scratch_words, ctypes.c_int32)[:] = -1  # any contents
        i32, u8, f32 = ctypes.c_int32, ctypes.c_uint8, ctypes.c_float
        ins = dict(zip(FIELDS, (self._array(src_in, k, i32), self._array(trg_in, k, i32),
                                self._array(third_in, k, i32),
                                self._array(sf_in, k, u8).astype(bool),
                                self._array(tf_in, k, u8).astype(bool))))
        uc = self._array(u_coin, n * k, f32).reshape(n, k)
        ut = self._array(u_third, n * k, f32).reshape(n, k)
        out = kernel_model(ins, m0, self._array(es, n, i32), self._array(ed, n, i32),
                           vertex_count, uc, ut)
        for f, ptr, ctype in zip(FIELDS, (src_out, trg_out, third_out, sf_out, tf_out),
                                 (i32, i32, i32, u8, u8)):
            self._array(ptr, k, ctype)[:] = out[f]
        return 0

    def launch_error_string(self, code):
        return b"a refused launch"


@pytest.fixture
def stand_in(monkeypatch):
    """The card path on CPU tensors: the library and the CUDA device and
    stream lookups replaced."""
    lib = _StandIn()
    monkeypatch.setattr(sk, "_library", lambda: lib)
    monkeypatch.setattr(cuda_build, "device_index", lambda device: 0)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: type("Stream", (), {"cuda_stream": 0})())
    return lib


@pytest.mark.parametrize("name", sorted(_malformed()))
def test_malformed_operands_raise_before_a_launch(name, stand_in):
    launches = sk.LAUNCHES
    with pytest.raises(ValueError):
        sk.reservoir_scan(*_malformed()[name])
    assert sk.LAUNCHES == launches and not stand_in.calls


def test_card_path_makes_one_launch_into_new_tensors(stand_in):
    k, n, v, m0 = 40, 70, (1 << 24) + 3, 5
    s, d = _edges("large_ids", 5, n)
    coin, third = _edge_uniforms(9, m0, v, s, d, k)
    st = _torch_state(kernel_model(_init_np(k), 0, *_edges("loops_repeats", 6, 8), v,
                                   np.zeros((8, k), np.float32), np.full((8, k), 0.5, np.float32)))
    held = {f: x.clone() for f, x in st.items()}
    before = sk.LAUNCHES
    got, m = sk._scan_kernel(st, m0, torch.from_numpy(s), torch.from_numpy(d), v,
                             torch.from_numpy(coin), torch.from_numpy(third))
    assert sk.LAUNCHES == before + 1 and m == m0 + n
    assert stand_in.calls == [dict(m0=m0, n=n, k=k, vertex_count=v)]
    want, _ = sk.reservoir_scan_plain(held, m0, s, d, v, torch.from_numpy(coin),
                                      torch.from_numpy(third))
    for f in FIELDS:
        assert got[f].data_ptr() != st[f].data_ptr() and torch.equal(st[f], held[f]), f
        assert got[f].dtype == st[f].dtype and torch.equal(got[f], want[f]), f


def test_card_path_raises_on_a_refused_launch_uncounted(stand_in):
    stand_in.code = 1  # cudaErrorInvalidValue
    st, s, d, uc, ut = _operands()
    before = sk.LAUNCHES
    with pytest.raises(RuntimeError, match="a refused launch"):
        sk._scan_kernel(st, 0, s, d, 1 << 16, uc, ut)
    assert sk.LAUNCHES == before and len(stand_in.calls) == 1


def test_estimator_uploads_ids_once_a_window_and_scans_once_a_draw_batch(monkeypatch):
    """The scan route: each window's raw ids go up once as int32, then one
    scan a draw batch of ``_SCAN_DRAW_ELEMS // k`` edges."""
    k = 16
    monkeypatch.setattr(TS, "_SCAN_DRAW_ELEMS", 10 * k)
    uploads, scans = [], []
    real_upload, real_scan = TS._upload_ids, TS.reservoir_scan

    def upload(src, dst, device):
        uploads.append(len(src))
        return real_upload(src, dst, device)

    def scan(state, m, src, dst, *rest):
        assert src.dtype == torch.int32 and src.is_contiguous()
        scans.append(src.shape[0])
        return real_scan(state, m, src, dst, *rest)

    monkeypatch.setattr(TS, "_upload_ids", upload)
    monkeypatch.setattr(TS, "reservoir_scan", scan)
    rng = np.random.default_rng(8)
    edges = [(int(a), int(b), 0.0) for a, b in rng.integers(0, 30, (90, 2))]
    est = TS.BroadcastTriangleCount(vertex_count=60_000, samples=k,
                                    window=TS.CountWindow(32), seed=3, device="cpu")
    list(est.run(edges))
    assert uploads == [32, 32, 26]
    assert scans == [10, 10, 10, 2, 10, 10, 10, 2, 10, 10, 6]
    assert est._edge_count == 90


@pytest.mark.parametrize("bad", [-1, 1 << 31])
def test_estimator_refuses_ids_outside_int32_before_a_scan(bad, monkeypatch):
    scans = []
    monkeypatch.setattr(TS, "reservoir_scan", lambda *a: scans.append(a))
    est = TS.BroadcastTriangleCount(vertex_count=60_000, samples=4, device="cpu")
    with pytest.raises(ValueError, match=r"\[0, 2\^31\)"):
        list(est.run([(0, 1, 0.0), (bad, 2, 0.0)]))
    assert not scans


def test_smoke_scan_bytes_read_the_uniforms_edges_and_state_once():
    import chip_smoke

    e, k = 1677, 10_000
    assert chip_smoke.sampling_scan_bytes(e, k) == 8 * e * k + 8 * e + 28 * k
    assert abs(chip_smoke.sampling_scan_bytes(e, k) / chip_smoke.HBM_BYTES_PER_S * 1e3
               - 0.040) < 0.001


def test_smoke_scan_closed_bytes_read_the_coins_once_and_a_third_draw_a_sample():
    import chip_smoke

    e, k = 1677, 10_000
    assert chip_smoke.sampling_scan_closed_bytes(e, k) == 4 * e * k + 8 * e + 32 * k
    assert abs(chip_smoke.sampling_scan_closed_bytes(e, k) / chip_smoke.HBM_BYTES_PER_S * 1e3
               - 0.0201) < 0.0005
    assert chip_smoke.sampling_scan_closed_bytes(e, k) < chip_smoke.sampling_scan_bytes(e, k)
