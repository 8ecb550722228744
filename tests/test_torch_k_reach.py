"""The k >= 3 spanner's k-hop search: the port against the JAX package.

The same inputs, made with numpy from a seed, go through the JAX package's
``library/spanner.py:_k_reach_cnt`` (called directly, jitted on the CPU)
and the port's (plain torch on the CPU), which must agree bit for bit:
batches of 32, 64 and 1024 queries over 1 to 4096 vertices, 1 to 4 hops,
none, some or all of the spanner's columns live, with masked queries,
duplicate edges, self-loops, ``u == v`` queries and vertices without
incoming edges. Also: ``DeviceSpanner._batch_cap`` equals the reference's
(``:366-374``) over a grid of its inputs; a path graph pins the synchronous
hop; the k = 3 and k = 4 device spanners with a budget small enough for
several batches a window equal the JAX package's emissions window by
window; the card path with its one launch replaced by a numpy model of the
whole search (seed, bitmaps of changed and non-zero rows, gathers from
changed sources only, read-out, clearing) equals the plain version over
two searches on one scratch, which it leaves zero, and equals the JAX
package on a target of in-degree 5,000, a path and a cycle at k = 0..5
and self-loops; and the CSR by target and the wrapper's operand checks.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gelly_streaming_tpu as gj
import gelly_streaming_tpu_torch as gt
from gelly_streaming_tpu.library.spanner import DeviceSpanner as JaxDS
from gelly_streaming_tpu.library.spanner import _k_reach_cnt as jax_k_reach_cnt
from gelly_streaming_tpu_torch.library import spanner as tsp
from gelly_streaming_tpu_torch.library.spanner import DeviceSpanner as TorchDS
from gelly_streaming_tpu_torch.ops import reach_kernels as rk

#: spanner columns a vertex count: sparse enough that some queries miss
EDGES_OF = {1: 6, 7: 12, 90: 120, 4096: 6144}


def _spanner(rng, nv, s):
    """``s`` edge columns among vertices ``0 .. V - 2`` (vertex V - 1 gets
    no edge when V > 1), an eighth of them self-loops and an eighth
    repeating earlier edges."""
    hi = max(nv - 1, 1)
    sp = rng.integers(0, hi, s)
    sq = rng.integers(0, hi, s)
    e = s // 8
    sq[:e] = sp[:e]
    sp[e:2 * e], sq[e:2 * e] = sp[2 * e:3 * e], sq[2 * e:3 * e]
    return sp.astype(np.int32), sq.astype(np.int32)


def _queries(rng, b, nv, sp, sq, k):
    """``b`` queries: half end a random walk of 1 to k + 1 steps from ``u``
    over all the columns (so live and dead edges both lead there), the rest
    random ends or ``u`` itself; a fifth are masked."""
    adj = [[] for _ in range(nv)]
    for a, c in zip(sp.tolist(), sq.tolist()):
        adj[a].append(c)
        adj[c].append(a)
    u = rng.integers(0, nv, b)
    v = rng.integers(0, nv, b)
    for i in range(b):
        r = rng.random()
        if r < 0.5:
            x = int(u[i])
            for _ in range(int(rng.integers(1, k + 2))):
                if adj[x]:
                    x = adj[x][int(rng.integers(len(adj[x])))]
            v[i] = x
        elif r < 0.6:
            v[i] = u[i]
    m = rng.random(b) >= 0.2
    return u.astype(np.int32), v.astype(np.int32), m


def _torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _both(sp, sq, cnt, u, v, m, nv, k):
    want = np.asarray(jax_k_reach_cnt(jnp.asarray(sp), jnp.asarray(sq), jnp.int32(cnt),
                                      jnp.asarray(u), jnp.asarray(v), jnp.asarray(m), nv, k))
    tsp_, tsq, tu, tv, tm = _torch(sp, sq, u, v, m)
    got = tsp._k_reach_cnt(tsp_, tsq, torch.tensor(cnt, dtype=torch.int32), tu, tv, tm, nv, k)
    return want, got


@pytest.mark.parametrize("cnt", ["none", "partial", "full"])
@pytest.mark.parametrize("k", [1, 2, 3, 4])
@pytest.mark.parametrize("nv", [1, 7, 90, 4096])
@pytest.mark.parametrize("b", [32, 64, 1024])
def test_k_reach_cnt_matches_jax_bit_for_bit(b, nv, k, cnt):
    rng = np.random.default_rng(1000 * b + 10 * nv + k)
    s = EDGES_OF[nv]
    sp, sq = _spanner(rng, nv, s)
    u, v, m = _queries(rng, b, nv, sp, sq, k)
    c = {"none": 0, "partial": s // 2 + 1, "full": s}[cnt]
    want, got = _both(sp, sq, c, u, v, m, nv, k)
    assert got.dtype == torch.bool and got.shape == (b,)
    np.testing.assert_array_equal(got.numpy(), want)
    # the wrapper on CPU tensors is the plain version over the same CSR
    tsp_, tsq, tu, tv, tm = _torch(sp, sq, u, v, m)
    csr = rk.target_csr(tsp_, tsq, torch.tensor(c, dtype=torch.int32), nv)
    np.testing.assert_array_equal(rk.k_reach(csr, tu, tv, tm, nv, k).numpy(), want)
    if cnt == "none":  # no edge: only unmasked u == v queries reach
        np.testing.assert_array_equal(want, m & (u == v))


@pytest.mark.parametrize("budget", [1 << 9, 1 << 12, 1 << 20, 1 << 28])
@pytest.mark.parametrize("query_chunk", [32, 100, 1024, 4096])
def test_batch_cap_matches_jax(query_chunk, budget):
    port = TorchDS(k=3, query_chunk=query_chunk, mem_budget_entries=budget)
    ref = JaxDS(k=3, query_chunk=query_chunk, mem_budget_entries=budget)
    for vcap in (1, 7, 100, 128, 4096, 1 << 18, 1 << 23):
        b = port._batch_cap(vcap)
        assert b == ref._batch_cap(vcap), vcap
        assert b % 32 == 0 and b & (b - 1) == 0


def test_path_graph_hop_is_synchronous():
    """On the path 0-1-2-3-4 with k = 2, 0 reaches 2 and not 3: a hop that
    wrote into the frontier it reads would carry the query two edges and
    report 0 -> 3 (and 4 -> 1) reachable."""
    sp = np.array([0, 1, 2, 3], np.int32)
    sq = np.array([1, 2, 3, 4], np.int32)
    pairs = [(0, 3), (0, 2), (4, 2), (4, 1), (2, 2), (0, 4)]
    u = np.zeros(32, np.int32)
    v = np.zeros(32, np.int32)
    m = np.zeros(32, bool)
    u[:6], v[:6] = zip(*pairs)
    m[:6] = True
    for k, reach in ((2, [False, True, True, False, True, False]),
                     (3, [True, True, True, True, True, False]),
                     (4, [True] * 6)):
        want, got = _both(sp, sq, 4, u, v, m, 5, k)
        assert got[:6].tolist() == reach == want[:6].tolist(), k
        assert not got[6:].any()


@pytest.mark.parametrize("k", [3, 4])
def test_multi_batch_device_spanner_matches_jax(k, monkeypatch):
    """A budget of 2^9 bytes over 128 vertices gives batches of 32, so a
    window of 200 edges searches in several batches, all against the one
    CSR of the window-start spanner."""
    rng = np.random.default_rng(40 + k)
    raw = [(int(a), int(b), 0.0) for a, b in rng.integers(0, 90, size=(800, 2))]
    calls = []

    def counted(csr, *args):
        calls.append(id(csr))
        return rk.k_reach(csr, *args)

    monkeypatch.setattr(tsp, "k_reach", counted)
    jds = JaxDS(k=k, mem_budget_entries=1 << 9)
    tds = TorchDS(k=k, mem_budget_entries=1 << 9)
    jout = [set(e) for e in jds.run(gj.SimpleEdgeStream(raw, window=gj.CountWindow(200)))]
    tout = [set(e) for e in tds.run(gt.SimpleEdgeStream(raw, window=gt.CountWindow(200),
                                                        device="cpu"))]
    assert tout == jout and len(tout) == 4
    assert tds.edges() == jds.edges()
    assert tds._batch_cap(128) == 32
    # windows 1-3 search in several batches, each window's batches one CSR
    assert len(calls) > 3 * 2 and len(set(calls)) <= 3


def _bits(words, n):
    """The first ``n`` bits of an int32 bitmap as a bool array."""
    return np.unpackbits(words.view(np.uint8), bitorder="little")[:n].astype(bool)


def _pack(rows, nwords):
    """A bool array as the words of an int32 bitmap of ``nwords`` words."""
    out = np.zeros(nwords * 32, np.uint8)
    out[:len(rows)] = rows
    return np.packbits(out, bitorder="little").view(np.int32)


def _search_on_the_cpu(row_ptr, src, u, v, m, fronts, bitmaps, out, nv, w, k):
    """What one launch of ``csrc/k_reach.cu``'s search kernel computes, in
    numpy and in place on the scratch: the seed (bits added, the seeded
    vertices set in changed and non-zero slot 0), k hops between the two
    frontiers that gather only the sources set in the last changed bitmap,
    read a target's own row only where its non-zero bit is set, write only
    non-zero words and OR their bits into slot ``h % 3`` (zeroed by the hop
    before, which clears slot ``(h + 1) % 3``), then the read-out and the
    clearing of the rows set in the last two non-zero bitmaps and of all
    six bitmaps."""
    f = fronts.numpy().reshape(2, nv, w)
    bits = bitmaps.numpy()
    changed, nonzero = bits[0:3], bits[3:6]
    nwords = bits.shape[1]
    un, vn, mn = u.numpy(), v.numpy(), m.numpy()
    rp, sr = row_ptr.numpy(), src.numpy()
    dst = np.repeat(np.arange(nv), np.diff(rp[:nv + 1]))
    srcs = sr[:rp[nv]]
    for i in np.flatnonzero(mn):
        f[0, un[i], i // 32] += np.uint32(1 << (i % 32)).view(np.int32)
    seeded = np.zeros(nv, bool)
    seeded[un[mn]] = True
    changed[0] |= _pack(seeded, nwords)
    nonzero[0] |= _pack(seeded, nwords)
    for h in range(1, k + 1):
        prev, nxt = f[(h - 1) & 1], f[h & 1]
        own = np.where(_bits(nonzero[(h - 1) % 3], nv)[:, None], prev, 0)
        acc = own.copy()
        hot = _bits(changed[(h - 1) % 3], nv)[srcs]
        np.bitwise_or.at(acc, dst[hot], prev[srcs[hot]])
        changed[(h + 1) % 3] = 0
        nonzero[(h + 1) % 3] = 0
        write = acc != 0
        nxt[write] = acc[write]
        changed[h % 3] |= _pack((acc != own).any(axis=1), nwords)
        nonzero[h % 3] |= _pack(write.any(axis=1), nwords)
    fin, other = f[k & 1], f[(k + 1) & 1]
    i = np.arange(len(un))
    word = fin[vn, i // 32].view(np.uint32)
    out.copy_(torch.from_numpy(mn & (((word >> (i % 32).astype(np.uint32)) & 1) != 0)))
    fin[_bits(nonzero[k % 3], nv)] = 0
    if k:
        other[_bits(nonzero[(k - 1) % 3], nv)] = 0
    bits[:] = 0
    rk.LAUNCHES += 1


def _layout_search(monkeypatch, csr, u, v, m, nv, k):
    """One search through the card path with its launch modelled on the
    CPU: asserts one launch, and the scratch all zero afterwards."""
    monkeypatch.setattr(rk, "_launch", _search_on_the_cpu)
    before = rk.LAUNCHES
    got = rk._k_reach_search(csr, u, v, m, nv, k)
    assert rk.LAUNCHES == before + 1
    fronts, bitmaps = rk._scratch(u.device, nv, u.shape[0] // 32)
    assert not fronts.any() and not bitmaps.any()
    return got


@pytest.mark.parametrize("k", [0, 1, 3])
@pytest.mark.parametrize("nv", [1, 7, 90])
@pytest.mark.parametrize("b", [32, 96, 1024])
def test_card_path_layout_matches_plain(b, nv, k, monkeypatch):
    """The card path around the kernel (the scratch, the vertex-major
    ``[V, W]`` frontiers and the bitmaps of changed and non-zero rows) with
    its launch replaced by the kernel's search computed on the CPU equals
    the plain version; one launch a search, and two searches with
    different queries on one scratch, which each leaves all zero."""
    rng = np.random.default_rng(b + nv + k)
    s = EDGES_OF[nv]
    sp, sq = _spanner(rng, nv, s)
    tsp_, tsq = _torch(sp, sq)
    csr = rk.target_csr(tsp_, tsq, torch.tensor(s - 1, dtype=torch.int32), nv)
    for _ in range(2):
        tu, tv, tm = _torch(*_queries(rng, b, nv, sp, sq, k))
        got = _layout_search(monkeypatch, csr, tu, tv, tm, nv, k)
        assert torch.equal(got, rk.k_reach_plain(csr, tu, tv, tm, nv, k))


def _all_paths(monkeypatch, sp, sq, cnt, u, v, m, nv, k):
    """The JAX package's answers, asserted equal to the port's plain
    version and to its card path with the launch modelled on the CPU."""
    want, got = _both(sp, sq, cnt, u, v, m, nv, k)
    np.testing.assert_array_equal(got.numpy(), want)
    tsp_, tsq, tu, tv, tm = _torch(sp, sq, u, v, m)
    csr = rk.target_csr(tsp_, tsq, torch.tensor(cnt, dtype=torch.int32), nv)
    np.testing.assert_array_equal(_layout_search(monkeypatch, csr, tu, tv, tm, nv, k).numpy(),
                                  want)
    return want


def test_card_path_hub_of_in_degree_5000_matches_jax(monkeypatch):
    """A target with 5,000 sources (more than a warp's load of 32 a hop
    takes, many times over), reached from each of them and from
    vertices two hops out."""
    rng = np.random.default_rng(77)
    nv, hub = 6000, 0
    sp = np.arange(1, 5001, dtype=np.int32)
    sq = np.full(5000, hub, np.int32)
    tail = rng.integers(5001, nv, 500).astype(np.int32)
    sp, sq = np.concatenate([sp, tail]), np.concatenate([sq, sp[tail % 5000]])
    b = 64
    u = rng.integers(0, nv, b).astype(np.int32)
    v = np.full(b, hub, np.int32)
    v[::2] = rng.integers(0, nv, b // 2)
    m = rng.random(b) >= 0.1
    for k in (1, 2, 3):
        want = _all_paths(monkeypatch, sp, sq, len(sp), u, v, m, nv, k)
        assert want[m & (u >= 1) & (u <= 5000) & (v == hub)].all()


@pytest.mark.parametrize("shape", ["path", "cycle"])
def test_card_path_path_and_cycle_match_jax_at_k_0_to_5(shape, monkeypatch):
    """On a path 0-1-...-11 and a 12-cycle every pair at each k = 0..5:
    reached exactly when the distance is at most k."""
    nv = 12
    sp = np.arange(nv - 1 if shape == "path" else nv, dtype=np.int32)
    sq = ((sp + 1) % nv).astype(np.int32)
    pairs = [(a, c) for a in range(nv) for c in range(nv)][:128]
    u = np.array([a for a, _ in pairs], np.int32)
    v = np.array([c for _, c in pairs], np.int32)
    m = np.ones(len(pairs), bool)
    m[5::17] = False
    dist = np.abs(u - v) if shape == "path" else np.minimum(np.abs(u - v), nv - np.abs(u - v))
    for k in range(6):
        want = _all_paths(monkeypatch, sp, sq, len(sp), u, v, m, nv, k)
        np.testing.assert_array_equal(want, m & (dist <= k))


def test_card_path_self_loops_match_jax(monkeypatch):
    """A spanner of self-loops and a few edges: a self-loop carries a query
    nowhere, so each reaches only ``u`` and its true neighbours."""
    rng = np.random.default_rng(3)
    nv = 40
    loops = np.arange(0, nv, 2, dtype=np.int32)
    sp = np.concatenate([loops, np.array([1, 3, 5], np.int32)])
    sq = np.concatenate([loops, np.array([3, 5, 7], np.int32)])
    u = rng.integers(0, nv, 96).astype(np.int32)
    v = np.where(rng.random(96) < 0.5, u, rng.integers(0, nv, 96)).astype(np.int32)
    v[:4] = [3, 5, 7, 7]
    u[:4] = [1, 1, 1, 5]
    m = rng.random(96) >= 0.2
    m[:4] = True
    for k in (1, 2, 3):
        want = _all_paths(monkeypatch, sp, sq, len(sp), u, v, m, nv, k)
        assert want[:4].tolist() == [True, k >= 2, k >= 3, True]


def test_target_csr_rows_hold_the_live_entries():
    rng = np.random.default_rng(5)
    nv, s, cnt = 50, 200, 77
    sp, sq = _spanner(rng, nv, s)
    tsp_, tsq = _torch(sp, sq)
    csr = rk.target_csr(tsp_, tsq, torch.tensor(cnt, dtype=torch.int32), nv)
    row_ptr, src, dst = (t.numpy() for t in csr)
    assert row_ptr.dtype == src.dtype == dst.dtype == np.int32
    assert row_ptr[0] == 0 and row_ptr[-1] == 2 * cnt and np.all(np.diff(dst) >= 0)
    assert np.all(dst[2 * cnt:] == nv)
    for t in range(nv):
        got = sorted(src[row_ptr[t]:row_ptr[t + 1]].tolist())
        want = sorted(sp[:cnt][sq[:cnt] == t].tolist() + sq[:cnt][sp[:cnt] == t].tolist())
        assert got == want, t


def test_k_reach_rejects_malformed_operands():
    sp, sq = _torch(np.array([0, 1], np.int32), np.array([1, 2], np.int32))
    csr = rk.target_csr(sp, sq, torch.tensor(2, dtype=torch.int32), 3)
    u = torch.zeros(32, dtype=torch.int32)
    m = torch.ones(32, dtype=torch.bool)
    assert rk.k_reach(csr, u, u, m, 3, 2).all()
    bad = [
        (csr._replace(row_ptr=csr.row_ptr[:-1]), u, u, m, 3),  # row_ptr not [V + 1]
        (csr, u[:16], u[:16], m[:16], 3),  # B not a multiple of 32
        (csr, u.long(), u, m, 3),  # u not int32
        (csr._replace(src=csr.src[:-1]), u, u, m, 3),  # src and dst differ
        (csr, u, u, m.int(), 3),  # m not bool
    ]
    for args in bad:
        with pytest.raises(ValueError, match="k_reach"):
            rk.k_reach(*args, 2)
