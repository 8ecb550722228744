"""The device vertex dictionary and ``stream_file(device_encode=True)``:
the port against the JAX package and the host ``VertexDict``.

The same seeded batches go through the port's ``encode_batch`` /
``encode_pair_batch`` (on the CPU) and the JAX package's: every state
field (keys, ids, reverse table, count, probe) and every output id must be
equal, on batches of known ids, new ids, repeats, ids next to
``INT32_MAX``, across a re-pad, and through an overflow. The stream path
must give the JAX package's components in both forms (a declared id bound,
growth from host novelty tracking).

Mirrors ``tests/test_device_dict.py:10-116`` and ``:169-230`` (the sharded
engine case, ``:117``, waits on slice 6 and the checkpoint case, ``:150``,
on slice 7).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gelly_streaming_tpu import datasets as jax_datasets
from gelly_streaming_tpu.core.window import CountWindow as JaxCountWindow
from gelly_streaming_tpu.library import ConnectedComponents as JaxCC
from gelly_streaming_tpu.ops import device_dict as jdd
from gelly_streaming_tpu_torch import CountWindow, EventTimeWindow, datasets, native
from gelly_streaming_tpu_torch.core.vertexdict import VertexDict
from gelly_streaming_tpu_torch.core.window import ProcessingTimeWindow
from gelly_streaming_tpu_torch.library import ConnectedComponents
from gelly_streaming_tpu_torch.ops import device_dict as tdd
from gelly_streaming_tpu_torch.ops.device_dict import DeviceVertexDict

_BIG = int(np.iinfo(np.int32).max)


def _dev(**kw):
    return DeviceVertexDict(device="cpu", **kw)


def _states_equal(js, ts):
    for k in ("keys", "idx", "rev", "count", "probe"):
        np.testing.assert_array_equal(np.asarray(js[k]), ts[k].numpy(), err_msg=k)


# --------------------------------------------------------------------- #
# encode_batch / encode_pair_batch against the JAX package, field by field
# --------------------------------------------------------------------- #
_ADVERSARIAL = {
    "all_new": [np.arange(40, 0, -1)],
    "all_known": [np.arange(30), np.arange(29, -1, -1)],
    "repeats_in_a_batch": [np.array([7, 7, 3, 7, 3, 9, 9, 9, 0, 0])],
    "int32_max_minus_one": [np.array([_BIG - 1, 0, _BIG - 1, 5, _BIG - 2])],
    "mixed_batches": [np.array([5, 1, 5, 8]), np.array([8, 2, 1, 9, 2, 2]),
                      np.array([100, 9, 3, 100])],
    "overflow": [np.arange(10), np.arange(5, 25), np.array([1, 2, 3])],
}


@pytest.mark.parametrize("name", sorted(_ADVERSARIAL))
def test_encode_batch_state_equals_jax(name):
    """Every output id and every state field after every batch; the
    ``overflow`` case fills a 16-key table past its capacity: the probe
    turns negative and stays so, the truncated table equal to JAX's."""
    js = jdd.init_table(16)
    ts = tdd.init_table(16, "cpu")
    for batch in _ADVERSARIAL[name]:
        b = np.asarray(batch, np.int32)
        js, jo = jdd.encode_batch(js, jnp.asarray(b))
        ts, to = tdd.encode_batch(ts, torch.from_numpy(b))
        np.testing.assert_array_equal(np.asarray(jo), to.numpy())
        _states_equal(js, ts)
    if name == "overflow":
        assert int(ts["probe"]) < 0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_encode_pair_batch_equals_jax_across_a_repad(seed):
    """Random pair batches into a table that is re-padded between batches
    (growth is appending INT32_MAX keys), the same growth on both sides."""
    rng = np.random.default_rng(seed)
    js = jdd.init_table(16)
    ts = tdd.init_table(16, "cpu")
    jd = jdd.DeviceVertexDict(min_capacity=16)
    td = _dev(min_capacity=16)
    for _ in range(5):
        n = int(rng.integers(1, 60))
        s = rng.integers(0, 200, n).astype(np.int32)
        d = rng.integers(0, 200, n).astype(np.int32)
        jd._state, td._state = js, ts
        jd.ensure_capacity_host(int(js["count"]) + 2 * n)
        td.ensure_capacity_host(int(ts["count"]) + 2 * n)
        js, ts = jd._state, td._state
        _states_equal(js, ts)
        js, jsi, jdi = jdd.encode_pair_batch(js, jnp.asarray(s), jnp.asarray(d))
        ts, tsi, tdi = tdd.encode_pair_batch(ts, torch.from_numpy(s), torch.from_numpy(d))
        np.testing.assert_array_equal(np.asarray(jsi), tsi.numpy())
        np.testing.assert_array_equal(np.asarray(jdi), tdi.numpy())
        _states_equal(js, ts)
    assert ts["keys"].shape[0] > 16


def test_overflow_is_caught_at_the_next_read():
    dev = _dev(min_capacity=16)
    dev.encode_pair_spec(np.arange(10), np.arange(10, 20))  # 20 ids, 16 slots
    with pytest.raises(RuntimeError, match="overflowed"):
        len(dev)


# --------------------------------------------------------------------- #
# the dict against the host VertexDict (tests/test_device_dict.py:10-65)
# --------------------------------------------------------------------- #
def test_encode_matches_host_dict_first_seen_order():
    rng = np.random.default_rng(4)
    host = VertexDict()
    dev = _dev(min_capacity=16)  # grows along the way
    jdev = jdd.DeviceVertexDict(min_capacity=16)
    for _ in range(6):
        batch = rng.integers(0, 800, rng.integers(3, 500))
        a = host.encode(batch)
        np.testing.assert_array_equal(a, dev.encode(batch))
        np.testing.assert_array_equal(a, jdev.encode(batch))
    assert len(host) == len(dev) == len(jdev)
    np.testing.assert_array_equal(host.raw_ids(), dev.raw_ids())
    assert dev.capacity == jdev.capacity


def test_encode_pair_matches_host_pair():
    rng = np.random.default_rng(5)
    host = VertexDict()
    dev = _dev(min_capacity=16)
    for _ in range(4):
        n = int(rng.integers(5, 300))
        s = rng.integers(0, 500, n)
        d = rng.integers(0, 500, n)
        hs, hd = host.encode_pair(s, d)
        ds, dd = dev.encode_pair(s, d)
        np.testing.assert_array_equal(hs, ds.numpy())
        np.testing.assert_array_equal(hd, dd.numpy())
    np.testing.assert_array_equal(host.raw_ids(), dev.raw_ids())


def test_decode_and_lookup():
    dev = _dev(min_capacity=16)
    out = dev.encode(np.array([42, 7, 42, 99], np.int64))
    assert out.tolist() == [0, 1, 0, 2]
    assert dev.decode(np.array([0, 1, 2])).tolist() == [42, 7, 99]
    assert dev.decode_one(1) == 7
    assert dev.lookup(7) == 1
    assert dev.lookup(12345) is None
    assert len(dev) == 3
    assert dev.raw_table("cpu")[:4].tolist() == [42, 7, 99, 0]


def test_adversarial_collisions_single_batch():
    dev = _dev(min_capacity=16)
    host = VertexDict()
    batch = np.concatenate([np.arange(200), np.arange(200), [5, 5, 5]])
    np.testing.assert_array_equal(host.encode(batch), dev.encode(batch))


def test_id_bound_violation_raises():
    dev = _dev(min_capacity=16, id_bound=16)
    with pytest.raises(ValueError, match="dense-id"):
        dev.encode(np.arange(40))
    with pytest.raises(ValueError, match="dense-id"):
        dev.encode_pair(np.array([3]), np.array([99]))


# --------------------------------------------------------------------- #
# stream_file(device_encode=True) into CC (tests/test_device_dict.py:66-116,
# :169-230)
# --------------------------------------------------------------------- #
def _components(stream, agg):
    last = None
    for last in stream.aggregate(agg):
        pass
    return sorted(last.component_sets())


@pytest.mark.parametrize("form", ["bound", "growth", "bound_prefetch", "binary"])
def test_stream_file_device_encode_cc_matches_jax(tmp_path, form):
    rng = np.random.default_rng(6)
    src = rng.integers(0, 400, 5000)
    dst = rng.integers(0, 400, 5000)
    p = str(tmp_path / "g.txt")
    native.write_edge_file(p, src, dst)
    kw = {"bound": dict(min_vertex_capacity=512),
          "growth": dict(dense_ids=False, min_vertex_capacity=16),
          "bound_prefetch": dict(min_vertex_capacity=512, prefetch_depth=2),
          "binary": dict(min_vertex_capacity=512)}[form]
    path = datasets.binary_cache(p) if form == "binary" else p
    agg = ConnectedComponents()
    got = _components(datasets.stream_file(
        path, window=CountWindow(700), device_encode=True, device="cpu", **kw), agg)
    jkw = {k: v for k, v in kw.items() if k != "prefetch_depth"}
    want = _components(jax_datasets.stream_file(
        path, window=JaxCountWindow(700), device_encode=True, **jkw), JaxCC())
    host = _components(datasets.stream_file(p, window=CountWindow(700), device="cpu"),
                       ConnectedComponents())
    assert got == want == host
    # device-encoded blocks carry no host columns: the dense carry, as in
    # the reference
    assert agg._cc_mode == "dense"


def test_stream_file_device_encode_window0_ids_equal_host_dict(tmp_path):
    """Window 0's compact ids on the device equal the host VertexDict's
    first-seen ids of the same columns."""
    rng = np.random.default_rng(7)
    src = rng.integers(0, 3000, 900)
    dst = rng.integers(0, 3000, 900)
    p = str(tmp_path / "g.txt")
    native.write_edge_file(p, src, dst)
    s = datasets.stream_file(p, window=CountWindow(512), device_encode=True,
                             min_vertex_capacity=4096, device="cpu")
    b = next(iter(s.blocks()))
    hs, hd = VertexDict().encode_pair(src[:512], dst[:512])
    np.testing.assert_array_equal(b.src[:512].numpy(), hs)
    np.testing.assert_array_equal(b.dst[:512].numpy(), hd)
    assert b.capacity == 512 and b.n_vertices == 4096


def test_stream_file_device_encode_guards(tmp_path):
    p = tmp_path / "g.txt"
    p.write_text("1 2\n")
    with pytest.raises(ValueError, match="vertex_dict"):
        datasets.stream_file(str(p), window=CountWindow(4), device_encode=True,
                             vertex_dict=VertexDict(), device="cpu")
    with pytest.raises(ValueError, match="CountWindow / EventTimeWindow"):
        datasets.stream_file(str(p), window=ProcessingTimeWindow(seconds=1.0),
                             device_encode=True, device="cpu")
    # weighted streams carry their value column through the device path
    pw = tmp_path / "w.txt"
    pw.write_text("1 2 0.5\n3 4 1.5\n")
    s = datasets.stream_file(str(pw), window=CountWindow(4), device_encode=True,
                             device="cpu")
    edges = sorted((e.src, e.dst, e.val) for e in s.get_edges())
    assert edges == [(1, 2, 0.5), (3, 4, 1.5)]


@pytest.mark.parametrize("distinct", [3, 300, 70000])
def test_packed_values_equal_jax_and_pads_decode_to_zero(tmp_path, distinct):
    """The value column through the packer: uint8 codes (3 distinct),
    uint16 (300), raw float32 past 65535 distinct; every slot, pads
    included, equal to the JAX package's block (pads are 0.0)."""
    rng = np.random.default_rng(distinct)
    n = 1500 if distinct < 70000 else 70500
    vals = rng.integers(0, distinct, n) * 0.25 if distinct < 70000 \
        else np.arange(n) * 0.5
    p = tmp_path / "w.txt"
    with open(p, "w") as f:
        for i, v in enumerate(vals.tolist()):
            f.write(f"{i % 97} {(i * 7) % 89} {v}\n")
    kw = dict(window=None, device_encode=True, min_vertex_capacity=128)
    got = [b.val.numpy() for b in datasets.stream_file(
        str(p), device="cpu", **{**kw, "window": CountWindow(1000)}).blocks()]
    want = [np.asarray(b.val) for b in jax_datasets.stream_file(
        str(p), **{**kw, "window": JaxCountWindow(1000)}).blocks()]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert got[-1][-1] == 0.0  # a pad slot


def test_event_time_windows_on_the_device_path(tmp_path):
    """EventTimeWindow over the device path: the same window boundaries
    and decoded edges as the host dict's path."""
    p = tmp_path / "t.txt"
    rows = [(i % 13 + 100, (i * 5) % 17 + 200, float(i // 4)) for i in range(40)]
    p.write_text("".join(f"{a} {b} {t}\n" for a, b, t in rows))

    def windows(**kw):
        s = datasets.stream_file(
            str(p), window=EventTimeWindow(2.0, timestamp_fn=lambda c: c[2]),
            device="cpu", **kw)
        vd = s.vertex_dict
        return [(vd.decode(b.to_host()[0]).tolist(), vd.decode(b.to_host()[1]).tolist())
                for b in s.blocks()]

    assert windows(device_encode=True, dense_ids=False) == windows()


def test_growth_mode_matches_host_dict(tmp_path):
    """Arbitrary sparse ids, a 16-entry hint: the table grows by padding
    from host novelty tracking; components and the first-seen mapping
    equal the host dict's and the JAX package's."""
    rng = np.random.default_rng(11)
    ids = rng.choice(np.arange(1, 2**30, 7919, dtype=np.int64), 300)
    s = ids[rng.integers(0, len(ids), 400)]
    d = ids[rng.integers(0, len(ids), 400)]
    p = tmp_path / "sparse.txt"
    p.write_text("".join(f"{a}\t{b}\n" for a, b in zip(s.tolist(), d.tolist())))

    host_stream = datasets.stream_file(p.as_posix(), window=CountWindow(64),
                                       vertex_dict=VertexDict(), device="cpu")
    want = _components(host_stream, ConnectedComponents())
    dev_stream = datasets.stream_file(p.as_posix(), window=CountWindow(64),
                                      device_encode=True, dense_ids=False,
                                      min_vertex_capacity=16, device="cpu")
    got = _components(dev_stream, ConnectedComponents())
    jax_stream = jax_datasets.stream_file(p.as_posix(), window=JaxCountWindow(64),
                                          device_encode=True, dense_ids=False,
                                          min_vertex_capacity=16)
    assert got == want == _components(jax_stream, JaxCC())
    assert dev_stream.vertex_dict.capacity >= len(np.unique(np.concatenate([s, d])))
    assert dev_stream.vertex_dict.capacity == jax_stream.vertex_dict.capacity
    np.testing.assert_array_equal(host_stream.vertex_dict.raw_ids(),
                                  dev_stream.vertex_dict.raw_ids())


def test_growth_block_stream_decoded_edges_match(tmp_path):
    """Every yielded block (across table growth) decodes to the exact input
    edge sequence, in order."""
    rng = np.random.default_rng(12)
    s = rng.integers(0, 2**28, 500, dtype=np.int64)
    d = rng.integers(0, 2**28, 500, dtype=np.int64)
    p = tmp_path / "arb.txt"
    p.write_text("".join(f"{a} {b}\n" for a, b in zip(s.tolist(), d.tolist())))
    stream = datasets.stream_file(p.as_posix(), window=CountWindow(97),
                                  device_encode=True, dense_ids=False,
                                  min_vertex_capacity=16, device="cpu")
    vd = stream.vertex_dict
    out_s, out_d = [], []
    for b in stream.blocks():
        bs, bd, _ = b.to_host()
        out_s.append(vd.decode(bs))
        out_d.append(vd.decode(bd))
    np.testing.assert_array_equal(np.concatenate(out_s), s)
    np.testing.assert_array_equal(np.concatenate(out_d), d)
    assert int(vd._state["probe"]) >= 0
