"""The dense CC carry's window fold: the union-find kernel's design against
the torch composition it replaces.

The kernel (``csrc/cc_fold.cu``, behind ``ops/cc_kernels.py:fold_window``)
runs only on the card. Here a model of it (the copy with the min-rooted
check; every unmasked lane's flags, path-halving finds and CAS hooks; the
compress pass, four labels an owner, with CAS halving) runs the lanes as
coroutines that yield at every load, store and atomic, interleaved in a
seeded random order, so the races of the real grid (a hook that loses its
CAS, a halving store over a newer parent, an owner's store over a halving)
happen here too. The model's table and flags must equal, bit for bit, those
of ``label_combine(state, cc_fold(init_labels(V), src, dst, mask))``, both the
port's (the plain version) and the JAX package's (``gelly_streaming_tpu/
summaries/labels.py``, which runs this step as an XLA fixpoint), window after
window, on the cases of the card tests at a small scale: R-MAT
windows, stars onto the first and the last vertex, a path fed in reverse,
self-loops and repeats, masked lanes, a carried table that is min-rooted
and not flat, and a table grown between windows.

Also: the wrapper on CPU tensors is that composition; the CC
aggregation's dense window step on the CPU still runs ``update`` +
``combine``; the wrapper's card path, with the library replaced by a stand-in
that runs the model through the operands' pointers, makes one counted
launch into new tensors and leaves its inputs as they were; a refused launch
raises uncounted; and malformed operands raise before any launch.
"""

import contextlib
import ctypes

import numpy as np
import pytest
import torch

from gelly_streaming_tpu_torch.ops import cuda_build, cc_kernels
from gelly_streaming_tpu_torch.summaries import labels as L

CASES = ("rmat", "star_first", "star_last", "reverse_path", "self_loops", "half_masked",
         "not_flat", "grown")
CPU_SCALE = 7  # V = 128 here; the card tests run scale 16
RMAT_ABC = (0.57, 0.19, 0.19)
RMAT_WINDOWS = 8


# --------------------------------------------------------------------- #
# The cases, shared with the card tests
# --------------------------------------------------------------------- #
def rmat(rng, scale, n):
    """``n`` R-MAT edges over ``2^scale`` ids (A/B/C 0.57/0.19/0.19)."""
    a, b, c = RMAT_ABC
    src = np.zeros(n, np.int64)
    dst = np.zeros(n, np.int64)
    for _ in range(scale):
        q = rng.random(n)
        down = q >= a + b  # quadrants C and D: the source's bit
        right = ((q >= a) & (q < a + b)) | (q >= a + b + c)  # B and D: the target's
        src = 2 * src + down
        dst = 2 * dst + right
    return src.astype(np.int32), dst.astype(np.int32)


def _window(src, dst, mask=None, pad=0):
    """One window's columns, ``pad`` masked lanes of zeros at the end."""
    src = np.concatenate([np.asarray(src, np.int32), np.zeros(pad, np.int32)])
    dst = np.concatenate([np.asarray(dst, np.int32), np.zeros(pad, np.int32)])
    if mask is None:
        mask = np.ones(len(src) - pad, bool)
    mask = np.concatenate([np.asarray(mask, bool), np.zeros(pad, bool)])
    return src, dst, mask


def case_stream(case, scale, seed):
    """``(labels0, touched0, windows)``: the carried table before the
    first window (int32 and bool ``[V0]``) and the windows as ``(vcap,
    src, dst, mask)``, the table grown to ``vcap`` before the window."""
    rng = np.random.default_rng(seed)
    v = 1 << scale
    lab0 = np.arange(v, dtype=np.int32)
    touched0 = np.zeros(v, bool)
    wins = []
    if case == "rmat":
        for _ in range(RMAT_WINDOWS):
            s, d = rmat(rng, scale, 2 * v)
            wins.append(_window(s, d, pad=v // 8))
    elif case in ("star_first", "star_last"):
        hub = 0 if case == "star_first" else v - 1
        leaves = rng.permutation(v).astype(np.int32)
        for part in np.array_split(leaves, 2):
            hubs = np.full(len(part), hub, np.int32)
            wins.append(_window(*(part, hubs) if seed % 2 else (hubs, part)))
    elif case == "reverse_path":
        i = np.arange(v - 2, -1, -1, dtype=np.int32)
        wins.append(_window(i, i + 1))
        wins.append(_window(i[: v // 2], i[: v // 2] + 1))
    elif case == "self_loops":
        for _ in range(3):
            s = rng.integers(0, v, v).astype(np.int32)
            d = np.where(rng.random(v) < 0.5, s, rng.integers(0, v, v)).astype(np.int32)
            rep = rng.integers(0, v, v // 2)
            wins.append(_window(np.concatenate([s, s[rep]]), np.concatenate([d, d[rep]])))
    elif case == "half_masked":
        for _ in range(3):
            s = rng.integers(0, v, 2 * v).astype(np.int32)
            d = rng.integers(0, v, 2 * v).astype(np.int32)
            wins.append(_window(s, d, rng.random(2 * v) < 0.5))
    elif case == "not_flat":
        # a min-rooted forest: each vertex under a random smaller one, some roots
        up = rng.integers(0, np.arange(v) + 1)
        lab0 = np.where(rng.random(v) < 0.7, up, np.arange(v)).astype(np.int32)
        touched0 = rng.random(v) < 0.5
        for _ in range(2):
            s, d = rng.integers(0, v, v // 2), rng.integers(0, v, v // 2)
            wins.append(_window(s, d))
    elif case == "grown":
        for vcap in (v // 4, v // 2, v // 2, v):
            s, d = rng.integers(0, vcap, vcap), rng.integers(0, vcap, vcap)
            wins.append((vcap,) + _window(s, d, pad=3))
        return lab0[: v // 4], touched0[: v // 4], wins
    else:
        raise ValueError(case)
    return lab0, touched0, [(v,) + w for w in wins]


# --------------------------------------------------------------------- #
# The kernel's model: coroutines that yield at each memory operation
# --------------------------------------------------------------------- #
def _find_root(parent, v):
    yield
    p = parent[v]
    while p != v:
        yield
        g = parent[p]
        if g == p:
            return p
        yield
        parent[v] = g  # a halving store, over whatever v holds by now
        v = g
        yield
        p = parent[v]
    return v


def _lane(parent, touched, u, w):
    yield
    touched[u] = True
    touched[w] = True
    if u == w:
        return
    ra = yield from _find_root(parent, u)
    rb = yield from _find_root(parent, w)
    while ra != rb:
        hi, lo = max(ra, rb), min(ra, rb)
        yield
        seen = parent[hi]  # atomicCAS(parent + hi, hi, lo)
        if seen == hi:
            parent[hi] = lo
            return
        r = yield from _find_root(parent, seen)
        if ra == hi:
            ra = r
        else:
            rb = r


def _chase_root(parent, p):
    yield
    q = parent[p]
    while q != p:
        yield
        g = parent[q]
        if g == q:
            return q
        yield
        if parent[p] == q:  # atomicCAS(parent + p, q, g)
            parent[p] = g
        p = g
        yield
        q = parent[p]
    return p


def _owner(parent, first, count):
    """The compress of labels ``first .. first + count - 1``: one load of
    them all, a chase each, one store of them all where one changed."""
    yield
    r = [int(parent[first + j]) for j in range(count)]
    changed = False
    for j in range(count):
        if r[j] == first + j:
            continue
        p = yield from _chase_root(parent, r[j])
        changed |= p != r[j]
        r[j] = p
    if changed:
        yield
        parent[first:first + count] = r


def _interleave(coroutines, rng):
    live = list(coroutines)
    while live:
        i = int(rng.integers(len(live)))
        try:
            next(live[i])
        except StopIteration:
            live[i] = live[-1]
            live.pop()


def kernel_model(labels_in, touched_in, src, dst, mask, seed):
    """What the launch leaves in its outputs, the grid's races drawn from
    ``seed``; raises where the kernel traps."""
    nv = len(labels_in)
    iota = np.arange(nv)
    if np.any(labels_in < 0) or np.any(labels_in > iota):
        raise ValueError("trap: the carried table is not min-rooted")
    parent = np.array(labels_in, np.int64)
    touched = np.array(touched_in, bool)
    rng = np.random.default_rng(seed)
    lanes = []
    for u, w, m in zip(src.tolist(), dst.tolist(), mask.tolist()):
        if not m:
            continue
        if not (0 <= u < nv and 0 <= w < nv):
            raise ValueError("trap: an id outside the table")
        lanes.append(_lane(parent, touched, u, w))
    _interleave(lanes, rng)
    owners = [_owner(parent, i, 4) for i in range(0, nv - nv % 4, 4)]
    owners += [_owner(parent, i, 1) for i in range(nv - nv % 4, nv)]
    _interleave(owners, rng)
    return parent.astype(np.int32), touched


def _plain(lab, tch, s, d, m):
    got = cc_kernels.fold_window_plain(*(torch.from_numpy(np.ascontiguousarray(x))
                                         for x in (lab, tch, s, d, m)))
    return got[0].numpy(), got[1].numpy()


def _jax(lab, tch, s, d, m):
    """The JAX package's composition of the same step. Imported here: the
    card tests import this module's cases where JAX is not installed."""
    import jax.numpy as jnp

    from gelly_streaming_tpu.summaries import labels as jax_labels

    part = jax_labels.cc_fold(jax_labels.init_labels(len(lab)), jnp.asarray(s), jnp.asarray(d),
                              jnp.asarray(m))
    out = jax_labels.label_combine({"labels": jnp.asarray(lab), "touched": jnp.asarray(tch)},
                                   part)
    return np.asarray(out["labels"]), np.asarray(out["touched"])


def _grow(lab, tch, vcap):
    st = L.grow_labels({"labels": torch.from_numpy(lab), "touched": torch.from_numpy(tch)},
                       vcap)
    return st["labels"].numpy(), st["touched"].numpy()


@pytest.mark.parametrize("seed", [1, 2])
@pytest.mark.parametrize("case", CASES)
def test_kernel_model_equals_the_plain_composition(case, seed):
    lab, tch, wins = case_stream(case, CPU_SCALE, seed)
    for i, (vcap, s, d, m) in enumerate(wins):
        lab, tch = _grow(lab, tch, vcap)
        want = _plain(lab, tch, s, d, m)
        got = kernel_model(lab, tch, s, d, m, seed=100 * seed + i)
        jax_want = _jax(lab, tch, s, d, m)
        for k in range(2):
            assert np.array_equal(got[k], want[k]), (case, i)
            assert np.array_equal(got[k], jax_want[k]), (case, i)
        # flat: each label is the least id of its component
        assert np.array_equal(got[0][got[0]], got[0])
        lab, tch = want


def test_compress_halving_never_overwrites_an_owners_root():
    """On the chain 0 <- 1 <- 2 <- 3 <- 4, the owner of 3 stores its root
    while the chase from 4 holds 3's old parent: the chase's halving CAS
    must then fail, and the table end flat."""
    parent = np.array([0, 0, 1, 2, 3])
    chase = _owner(parent, 4, 1)
    for _ in range(4):  # the load of 4, then 3's parent and grandparent read
        next(chase)
    _interleave([_owner(parent, 3, 1)], np.random.default_rng(0))
    assert parent[3] == 0
    _interleave([chase, _owner(parent, 1, 1), _owner(parent, 2, 1)], np.random.default_rng(0))
    assert parent.tolist() == [0, 0, 0, 0, 0]


def test_kernel_model_traps_on_a_table_that_is_not_min_rooted():
    lab = np.arange(8, dtype=np.int32)
    lab[3] = 5
    with pytest.raises(ValueError, match="min-rooted"):
        kernel_model(lab, np.zeros(8, bool), *_window([1], [2]), seed=0)


# --------------------------------------------------------------------- #
# The routing on CPU tensors
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("seed", [3, 4, 5])
def test_fold_window_on_cpu_is_the_composition(seed):
    rng = np.random.default_rng(seed)
    v = 200
    state = L.init_labels(v, "cpu")
    launches = cc_kernels.LAUNCHES
    for _ in range(4):
        n = 150
        src = torch.from_numpy(rng.integers(0, v, n).astype(np.int32))
        dst = torch.from_numpy(rng.integers(0, v, n).astype(np.int32))
        mask = torch.from_numpy(rng.random(n) < 0.7)
        want = L.label_combine(state, L.cc_fold(L.init_labels(v, "cpu"), src, dst, mask))
        reads = L.HOST_READS
        got = cc_kernels.fold_window(state["labels"], state["touched"], src, dst, mask)
        assert L.HOST_READS > reads  # the torch fixpoints' reads
        for key, t in zip(("labels", "touched"), got):
            assert torch.equal(t, want[key]), key
        state = dict(zip(("labels", "touched"), got))
    assert cc_kernels.LAUNCHES == launches


def test_cc_dense_window_step_on_cpu_goes_through_update_and_combine(monkeypatch):
    import gelly_streaming_tpu_torch as gt
    from gelly_streaming_tpu_torch.library import ConnectedComponents

    calls = {"update": 0, "combine": 0}

    class Counted(ConnectedComponents):
        def update(self, *args):
            calls["update"] += 1
            return super().update(*args)

        def combine(self, a, b):
            calls["combine"] += 1
            return super().combine(a, b)

    def refuse(*args):
        raise AssertionError("the kernel's route on CPU tensors")

    monkeypatch.setattr(cc_kernels, "fold_window", refuse)
    rng = np.random.default_rng(6)
    edges = list(zip(rng.integers(0, 50, 60).tolist(), rng.integers(0, 50, 60).tolist()))
    stream = gt.SimpleEdgeStream(edges, window=gt.CountWindow(20), device="cpu")
    out = [str(c) for c in stream.aggregate(Counted(carry="dense"))]
    assert calls == {"update": 3, "combine": 3}
    want = [str(c) for c in gt.SimpleEdgeStream(edges, window=gt.CountWindow(20), device="cpu")
            .aggregate(ConnectedComponents(carry="host"))]
    assert out == want


# --------------------------------------------------------------------- #
# The card path, with the library replaced
# --------------------------------------------------------------------- #
class _StandIn:
    """The kernel library's C interface, computed by :func:`kernel_model`
    through the operands' pointers, as the kernel reads and writes them."""

    def __init__(self, code=0):
        self.code = code
        self.calls = []

    @staticmethod
    def _array(ptr, n, ctype):
        return np.ctypeslib.as_array((ctype * max(n, 1)).from_address(ptr))[:n]

    def cc_fold_launch(self, labels_in, touched_in, src, dst, mask, labels_out, touched_out,
                       n_edges, nv, device, stream):
        self.calls.append(dict(n_edges=n_edges, nv=nv))
        if self.code:
            return self.code
        e = [self._array(p, n_edges, c) for p, c in ((src, ctypes.c_int32),
                                                     (dst, ctypes.c_int32),
                                                     (mask, ctypes.c_bool))]
        lab, tch = kernel_model(self._array(labels_in, nv, ctypes.c_int32),
                                self._array(touched_in, nv, ctypes.c_bool), *e, seed=n_edges)
        self._array(labels_out, nv, ctypes.c_int32)[:] = lab
        self._array(touched_out, nv, ctypes.c_bool)[:] = tch
        return 0

    def launch_error_string(self, code):
        return b"a refused launch"


@pytest.fixture
def stand_in(monkeypatch):
    """The card path on CPU tensors: the library and the CUDA device and
    stream lookups replaced."""
    lib = _StandIn()
    monkeypatch.setattr(cc_kernels, "_library", lambda: lib)
    monkeypatch.setattr(cuda_build, "device_index", lambda device: 0)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: type("Stream", (), {"cuda_stream": 0})())
    return lib


def _tensors(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def test_card_path_makes_one_launch_into_new_tensors(stand_in):
    lab, tch, wins = case_stream("not_flat", CPU_SCALE, 7)
    for vcap, s, d, m in wins:
        args = _tensors(lab, tch, s, d, m)
        held = [a.clone() for a in args]
        before = cc_kernels.LAUNCHES
        got = cc_kernels._fold_kernel(*args)
        assert cc_kernels.LAUNCHES == before + 1
        assert stand_in.calls[-1] == dict(n_edges=len(s), nv=len(lab))
        assert all(torch.equal(a, h) for a, h in zip(args, held))
        assert got[0].data_ptr() != args[0].data_ptr() and got[1].data_ptr() != args[1].data_ptr()
        assert got[0].dtype == torch.int32 and got[1].dtype == torch.bool
        want = _plain(lab, tch, s, d, m)
        assert np.array_equal(got[0].numpy(), want[0]) and np.array_equal(got[1].numpy(), want[1])
        lab, tch = want


def test_card_path_raises_on_a_refused_launch_uncounted(stand_in):
    stand_in.code = 720  # cudaErrorCooperativeLaunchTooLarge
    lab, tch, wins = case_stream("rmat", 4, 8)
    before = cc_kernels.LAUNCHES
    with pytest.raises(RuntimeError, match="a refused launch"):
        cc_kernels._fold_kernel(*_tensors(lab, tch, *wins[0][1:]))
    assert cc_kernels.LAUNCHES == before and len(stand_in.calls) == 1


def _malformed():
    lab = torch.arange(8, dtype=torch.int32)
    tch = torch.zeros(8, dtype=torch.bool)
    ids = torch.zeros(6, dtype=torch.int32)
    mask = torch.ones(6, dtype=torch.bool)
    meta = torch.zeros(6, dtype=torch.int32, device="meta")
    return {
        "int64 src": ((lab, tch, ids.long(), ids, mask), "int32"),
        "int64 dst": ((lab, tch, ids, ids.long(), mask), "int32"),
        "int64 labels": ((lab.long(), tch, ids, ids, mask), "int32"),
        "uint8 touched": ((lab, tch.to(torch.uint8), ids, ids, mask), "bool"),
        "int32 mask": ((lab, tch, ids, ids, mask.int()), "bool"),
        "strided src": ((lab, tch, torch.zeros(12, dtype=torch.int32)[::2], ids, mask),
                        "contiguous"),
        "mask shape": ((lab, tch, ids, ids, mask[:5]), "shape"),
        "dst shape": ((lab, tch, ids, ids[:5], mask), "shape"),
        "touched shape": ((lab, tch[:7], ids, ids, mask), "shape"),
        "2-D labels": ((lab.view(2, 4), tch.view(2, 4), ids, ids, mask), "shape"),
        "no labels": ((lab[:0], tch[:0], ids, ids, mask), "labels"),
        "two devices": ((lab, tch, meta, ids, mask), "one device"),
        "meta device": ((lab.to("meta"), tch.to("meta"), meta, meta, mask.to("meta")),
                        "unsupported"),
    }


@pytest.mark.parametrize("name", sorted(_malformed()))
def test_malformed_operands_raise_before_a_launch(name, stand_in):
    args, match = _malformed()[name]
    launches, reads = cc_kernels.LAUNCHES, L.HOST_READS
    with pytest.raises(ValueError, match=match):
        cc_kernels.fold_window(*args)
    assert cc_kernels.LAUNCHES == launches and L.HOST_READS == reads and not stand_in.calls
