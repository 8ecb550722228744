"""Sharded parallel ingest in the port (``core/ingest.py``) against the JAX
package: the GSEW wire format (v1 and v2), the partition rules, the
N-connection sharded source with its reconnects, dedup, backpressure and
lateness, and its merge into the block/superbatch path on the CPU.

The cross-package contracts pinned here:

- ``pack_edge_frame`` gives the JAX package's bytes, frame for frame
  (narrow, wide, values, event time);
- ``shard_of``, ``partition_edges``, ``vertex_owner``,
  ``partition_edges_by_vertex``, ``split_side`` and ``vertex_owner_epoch``
  give equal assignments;
- a JAX ``serve_blobs`` peer feeding the port's source, and the port's
  peer feeding the JAX source, deliver equal per-shard windows (the merged
  order interleaves shards nondeterministically, so windows are compared
  shard by shard, never merged);
- sharded CC on ``device="cpu"`` equals the JAX package's final
  components and the unsharded run's.

Mirrors ``tests/test_ingest.py:106-529``, ``tests/test_eventtime.py:125-176``
and ``:357``, and ``tests/test_sources.py``'s socket cases the port did not
pin yet (the CC run over a socket, the weighted chunk parse). No case
decides from the wall clock: the backpressure case waits for the stall
counter, it does not time the consumer.
"""

import json
import os
import socket
import struct
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

import gelly_streaming_tpu.core.ingest as jing
from gelly_streaming_tpu_torch import native, obs
from gelly_streaming_tpu_torch.core import ingest as ing
from gelly_streaming_tpu_torch.core.ingest import (
    F_TS,
    HEADER,
    MAGIC,
    MAX_FRAME_EDGES,
    VERSION,
    VERSION_TS,
    MalformedFrame,
    ShardedEdgeSource,
    decode_frame_payload,
    encode_shard_frames,
    encode_shard_text,
    frame_geometry,
    pack_edge_frame,
    partition_edges,
    serve_blobs,
    shard_of,
)
from gelly_streaming_tpu_torch.core.stream import SimpleEdgeStream
from gelly_streaming_tpu_torch.core.window import CountWindow, take_cols
from gelly_streaming_tpu_torch.library import ConnectedComponents
from gelly_streaming_tpu_torch.obs import timeline
from gelly_streaming_tpu_torch.resilience import faults
from gelly_streaming_tpu_torch.resilience.errors import TransientSourceError
from gelly_streaming_tpu_torch.resilience.faults import FaultPlan

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
I64_MAX = int(np.iinfo(np.int64).max)


@pytest.fixture(autouse=True)
def _hygiene():
    obs.reset()
    faults.clear()
    yield
    obs.reset()
    faults.clear()


def counter_value(name, **labels):
    for lab, inst in obs.get_registry().find(name):
        if all(lab.get(k) == v for k, v in labels.items()):
            return inst.value
    return 0.0


def make_edges(n=500, vmax=60, seed=11):
    rng = np.random.default_rng(seed)
    return (
        rng.integers(0, vmax, n).astype(np.int64),
        rng.integers(0, vmax, n).astype(np.int64),
    )


def oracle_windows(src, dst, nshards, window):
    """Per-shard count windows of the hash-partitioned stream, from the
    JAX package's partition rule — what a correct sharded ingest must
    deliver, shard by shard."""
    out = {}
    for i, (s, d, _v) in enumerate(jing.partition_edges(src, dst, None, nshards)):
        wins = [(s[a:a + window].tolist(), d[a:a + window].tolist())
                for a in range(0, len(s), window)]
        if wins:  # an empty shard delivers no windows at all
            out[i] = wins
    return out


def collected_windows(wins):
    got = {}
    for w in wins:
        got.setdefault(w[0], []).append((w[1].tolist(), w[2].tolist()))
    return got


def join_all(threads):
    for t in threads:
        t.join(10)


# --------------------------------------------------------------------- #
# Wire format + codec
# --------------------------------------------------------------------- #
def test_frame_codec_round_trips_narrow_wide_and_val():
    src = np.array([3, 1, 4], np.int64)
    dst = np.array([1, 5, 9], np.int64)
    frame = pack_edge_frame(src, dst, seq=7)
    magic, ver, flags, n, plen, seq = HEADER.unpack(frame[:HEADER.size])
    assert (magic, ver, seq) == (MAGIC, VERSION, 7)
    assert not flags & ing.F_WIDE and not flags & ing.F_VAL
    s, d, v = decode_frame_payload(frame[HEADER.size:], n, flags)
    assert s.tolist() == src.tolist() and d.tolist() == dst.tolist()
    assert v is None and s.dtype == np.int64

    big = np.array([1 << 40, -5], np.int64)
    val = np.array([0.5, -2.25])
    frame = pack_edge_frame(big, dst[:2], val, seq=8)
    _m, _v, flags, n, _p, _s = HEADER.unpack(frame[:HEADER.size])
    assert flags & ing.F_WIDE and flags & ing.F_VAL
    s, d, v = decode_frame_payload(frame[HEADER.size:], n, flags)
    assert s.tolist() == big.tolist() and v.tolist() == val.tolist()


_FRAME_CASES = {
    "narrow": dict(src=[3, 1, 4, 0], dst=[1, 5, 9, 2]),
    "wide": dict(src=[1 << 40, -5, 7, 2], dst=[1, 5, 9, -(1 << 33)]),
    "val": dict(src=[3, 1, 4, 0], dst=[1, 5, 9, 2], val=[0.5, -2.25, 1e300, 0.0]),
    "ts": dict(src=[3, 1, 4, 0], dst=[1, 5, 9, 2], ts=[10, 11, -5, I64_MAX - 1]),
    "wide_val_ts": dict(src=[1 << 40, 2, 3, 4], dst=[1, 2, 3, 4], val=[1.0, 2.0, 3.0, 4.0],
                        ts=[0, 1, 2, 3]),
}


@pytest.mark.parametrize("case", sorted(_FRAME_CASES))
def test_frames_are_byte_identical_to_the_jax_package(case):
    kw = _FRAME_CASES[case]
    cols = {k: np.array(v, np.float64 if k == "val" else np.int64) for k, v in kw.items()}
    for seq in (0, 1, 99):
        mine = pack_edge_frame(cols["src"], cols["dst"], cols.get("val"), seq=seq, ts=cols.get("ts"))
        ref = jing.pack_edge_frame(cols["src"], cols["dst"], cols.get("val"), seq=seq,
                                   ts=cols.get("ts"))
        assert mine == ref
    # and a whole shard stream, frame-sequenced, decodes to equal columns
    # in both packages
    blob = encode_shard_frames(cols["src"], cols["dst"], cols.get("val"), frame_edges=3,
                               ts=cols.get("ts"))
    assert blob == jing.encode_shard_frames(cols["src"], cols["dst"], cols.get("val"),
                                            frame_edges=3, ts=cols.get("ts"))
    _m, _v, flags, n, _p, _s = HEADER.unpack(blob[:HEADER.size])
    payload = blob[HEADER.size:HEADER.size + frame_geometry(n, flags)]
    for a, b in zip(decode_frame_payload(payload, n, flags),
                    jing.decode_frame_payload(payload, n, flags)):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a, b)


def test_text_encoding_is_identical_to_the_jax_package():
    src, dst = make_edges(50)
    assert encode_shard_text(src, dst) == jing.encode_shard_text(src, dst)


def test_decode_fallback_matches_native(monkeypatch):
    if not native.native_available():
        pytest.skip("no native toolchain: only the fallback exists")
    src = np.array([7, 1 << 34, 0], np.int64)
    dst = np.array([2, 4, 6], np.int64)
    val = np.array([1.5, 0.0, -3.0])
    frames = [
        pack_edge_frame(src % (1 << 20), dst, seq=1),          # narrow
        pack_edge_frame(src, dst, val, seq=2),                 # wide+val
    ]
    lines = b"1\t2\nbogus line\n# c\n3 4 0.25\n"

    def decode_all():
        out = []
        for f in frames:
            _m, _ver, flags, n, _p, _s = HEADER.unpack(f[:HEADER.size])
            out.append(decode_frame_payload(f[HEADER.size:], n, flags))
        return out, native.parse_edge_lines(lines)

    with_native, parsed_native = decode_all()
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_lib_failed", True)
    without, parsed_py = decode_all()
    for (s1, d1, v1), (s2, d2, v2) in zip(with_native, without):
        assert s1.tolist() == s2.tolist()
        assert d1.tolist() == d2.tolist()
        assert (v1 is None) == (v2 is None)
        if v1 is not None:
            assert v1.tolist() == v2.tolist()
    assert parsed_native[0].tolist() == parsed_py[0].tolist()
    assert parsed_native[1].tolist() == parsed_py[1].tolist()
    assert parsed_native[2].tolist() == parsed_py[2].tolist()
    assert parsed_native[3] == parsed_py[3] == 1


def test_native_decode_that_loaded_raises_on_bad_geometry():
    """A loaded library that rejects the payload raises; it never falls
    back to numpy (the fallback exists only without the toolchain)."""
    if not native.native_available():
        pytest.skip("no native toolchain: only the fallback exists")
    with pytest.raises(ValueError, match="geometry"):
        native.decode_edge_frame(b"\x00" * 12, 2, False, False)


def test_geometry_mismatch_raises_malformed():
    src, dst = make_edges(4)
    frame = pack_edge_frame(src, dst, seq=1)
    with pytest.raises(MalformedFrame) as ei:
        decode_frame_payload(frame[HEADER.size:][:-4], 4, 0)
    assert ei.value.kind == "columns"


def test_take_cols_slices_ts_in_lockstep_like_the_jax_package():
    from gelly_streaming_tpu.core.window import take_cols as jtake

    rng = np.random.default_rng(3)
    chunks = [(np.arange(a, a + n), np.arange(a, a + n) + 1,
               None if n % 2 else rng.random(n), np.arange(a, a + n) * 10)
              for a, n in ((0, 5), (5, 4), (9, 7))]
    mine, ref = list(chunks), list(chunks)  # take_cols mutates the list only
    for take in (4, 6, 5):
        a = take_cols(mine, take, np.float64)
        b = jtake(ref, take)
        assert len(a) == len(b) == 4
        for x, y in zip(a, b):
            assert (x is None) == (y is None)
            if x is not None:
                np.testing.assert_array_equal(x, y)
    with pytest.raises(ValueError, match="ts column"):
        take_cols([(np.arange(2), np.arange(2), None), (np.arange(2), np.arange(2), None,
                                                         np.arange(2))], 4)


# --------------------------------------------------------------------- #
# The partition rules: bit-identical assignments
# --------------------------------------------------------------------- #
def _ids(seed=7, n=3000):
    rng = np.random.default_rng(seed)
    return (np.concatenate([rng.integers(0, 1 << 20, n), rng.integers(-(1 << 40), 1 << 40, n)])
            .astype(np.int64),
            np.concatenate([rng.integers(0, 1 << 20, n), rng.integers(0, 1 << 62, n)])
            .astype(np.int64))


@pytest.mark.parametrize("nshards", [1, 2, 3, 4, 7])
def test_partition_rules_assign_like_the_jax_package(nshards):
    src, dst = _ids()
    np.testing.assert_array_equal(shard_of(src, dst, nshards), jing.shard_of(src, dst, nshards))
    np.testing.assert_array_equal(ing.vertex_owner(src, nshards), jing.vertex_owner(src, nshards))
    val = np.arange(len(src), dtype=np.float64)
    ts = np.arange(len(src), dtype=np.int64) // 3
    for mine, ref in zip(partition_edges(src, dst, val, nshards, ts=ts),
                         jing.partition_edges(src, dst, val, nshards, ts=ts)):
        for a, b in zip(mine, ref):
            np.testing.assert_array_equal(a, b)
    for mine, ref in zip(ing.partition_edges_by_vertex(src, dst, val, nshards),
                         jing.partition_edges_by_vertex(src, dst, val, nshards)):
        for a, b in zip(mine, ref):
            np.testing.assert_array_equal(a, b)


def test_split_rules_assign_like_the_jax_package():
    src, _ = _ids(seed=9)
    for salt in (0, 12345, (1 << 64) - 1, -7):
        np.testing.assert_array_equal(ing.split_side(src, salt), jing.split_side(src, salt))
    splits = ({"parent": 1, "child": 4, "salt": 99}, {"parent": 0, "child": 5, "salt": 7},
              {"parent": 4, "child": 6, "salt": 1 << 40})
    for k in range(len(splits) + 1):
        np.testing.assert_array_equal(ing.vertex_owner_epoch(src, 4, splits[:k]),
                                      jing.vertex_owner_epoch(src, 4, splits[:k]))


def test_shard_of_is_deterministic_and_total():
    src, dst = make_edges(2000)
    a = shard_of(src, dst, 4)
    b = shard_of(src, dst, 4)
    assert (a == b).all() and a.min() >= 0 and a.max() < 4
    assert len(np.unique(a)) == 4
    parts = partition_edges(src, dst, None, 4)
    assert sum(len(p[0]) for p in parts) == len(src)


# --------------------------------------------------------------------- #
# Fuzz: every malformed byte stream is counted + survived
# --------------------------------------------------------------------- #
def _serve_script(blobs_per_accept):
    """One port; accept N times, each sending its scripted bytes then
    closing (a reconnecting reader sees them in order)."""
    srv = socket.create_server(("127.0.0.1", 0))
    port = srv.getsockname()[1]

    def run():
        try:
            for blob in blobs_per_accept:
                conn, _ = srv.accept()
                try:
                    conn.sendall(blob)
                finally:
                    conn.close()
        finally:
            srv.close()

    t = threading.Thread(target=run, daemon=True)
    t.start()
    return port, t


GOOD_SRC, GOOD_DST = make_edges(64, vmax=40, seed=3)
GOOD_BLOB = encode_shard_frames(GOOD_SRC, GOOD_DST, frame_edges=16)
#: bytes of one complete 16-edge narrow frame in GOOD_BLOB
FRAME_BYTES = HEADER.size + 16 * 4 * 2
assert len(GOOD_BLOB) == 4 * FRAME_BYTES


@pytest.mark.parametrize("raw, kind", [
    (b"X" * 64, "magic"),
    (HEADER.pack(MAGIC, VERSION + 9, 0, 0, 0, 0), "version"),
    (HEADER.pack(MAGIC, VERSION, 0, MAX_FRAME_EDGES + 1, 0, 0), "oversized"),
    (HEADER.pack(MAGIC, VERSION, 0, 2, 99, 0), "columns"),
    (GOOD_BLOB[: HEADER.size + 20], "truncated"),
])
def test_malformed_streams_count_resync_and_never_kill_the_reader(raw, kind):
    port, t = _serve_script([raw, GOOD_BLOB])
    src = ShardedEdgeSource([("127.0.0.1", port)], window=16, reconnect=4,
                            reconnect_base_s=0.01)
    wins = list(src.windows())
    t.join(10)
    assert counter_value("source.malformed_frames", kind=kind) == 1
    assert counter_value("source.reconnects") >= 1
    assert collected_windows(wins) == oracle_windows(GOOD_SRC, GOOD_DST, 1, 16)


def test_reset_at_frame_boundary_reconnects_not_truncates():
    """A connection RESET between frames is a reconnectable failure —
    only the peer's orderly FIN may end a shard."""
    first = GOOD_BLOB[:FRAME_BYTES]  # exactly one COMPLETE frame
    srv = socket.create_server(("127.0.0.1", 0))
    port = srv.getsockname()[1]
    drained = threading.Event()

    def run():
        try:
            conn, _ = srv.accept()
            conn.sendall(first)
            drained.wait(10)  # the reader has taken frame 1 off the wire
            # SO_LINGER(on, 0): close() sends RST, not FIN
            conn.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER, struct.pack("ii", 1, 0))
            conn.close()
            conn2, _ = srv.accept()
            try:
                conn2.sendall(GOOD_BLOB)  # full replay (at-least-once)
            finally:
                conn2.close()
        finally:
            srv.close()

    t = threading.Thread(target=run, daemon=True)
    t.start()
    real_decode = ing.decode_frame_payload

    def decode_and_signal(*a):
        out = real_decode(*a)
        drained.set()
        return out

    ing.decode_frame_payload = decode_and_signal
    try:
        src = ShardedEdgeSource([("127.0.0.1", port)], window=16, reconnect=4,
                                reconnect_base_s=0.01)
        wins = list(src.windows())
    finally:
        ing.decode_frame_payload = real_decode
    t.join(10)
    assert counter_value("source.reconnects") >= 1
    assert collected_windows(wins) == oracle_windows(GOOD_SRC, GOOD_DST, 1, 16)


def test_deterministic_corruption_gives_up_instead_of_looping():
    corrupt = GOOD_BLOB[:FRAME_BYTES * 2] + b"\xff" * 40
    port, t = _serve_script([corrupt] * 8)
    src = ShardedEdgeSource([("127.0.0.1", port)], window=16, reconnect=2,
                            reconnect_base_s=0.01)
    with pytest.raises(TransientSourceError, match="malformed"):
        list(src.windows())
    assert counter_value("source.malformed_frames", kind="magic") >= 3


def test_pack_rejects_frames_every_reader_would_reject():
    n = ing.DEFAULT_MAX_FRAME // 24 + 1  # wide + val: 24 bytes/edge
    big = np.full(n, 1 << 40, np.int64)
    with pytest.raises(ValueError, match="frame_edges"):
        pack_edge_frame(big, big, np.zeros(n), seq=1)


def test_exhausted_reconnect_budget_raises_at_the_consumer():
    srv = socket.create_server(("127.0.0.1", 0))
    port = srv.getsockname()[1]
    srv.close()  # nothing listens: bounded attempts, then transient
    src = ShardedEdgeSource([("127.0.0.1", port)], window=8, reconnect=2,
                            reconnect_base_s=0.01)
    with pytest.raises(TransientSourceError):
        list(src.windows())
    assert counter_value("source.reader_errors") == 1


# --------------------------------------------------------------------- #
# Oracle identity, both ways across the packages
# --------------------------------------------------------------------- #
def test_sharded_windows_match_the_partitioned_oracle():
    src, dst = make_edges(700, seed=5)
    parts = partition_edges(src, dst, None, 3)
    blobs = [encode_shard_frames(s, d, frame_edges=37) for s, d, _ in parts]
    ports, threads, _stop = serve_blobs(blobs)
    source = ShardedEdgeSource([("127.0.0.1", p) for p in ports], window=16)
    got = collected_windows(source.windows())
    join_all(threads)
    assert got == oracle_windows(src, dst, 3, 16)


@pytest.mark.parametrize("fmt", ["binary", "text"])
def test_jax_peer_feeds_the_port_and_the_port_peer_feeds_jax(fmt):
    """The two packages interoperate on the wire: each package's
    serve-from-memory peer feeds the other's source, and the per-shard
    windows are equal to each other and to the partitioned oracle."""
    src, dst = make_edges(600, seed=41)
    enc = (lambda p, s, d: p.encode_shard_frames(s, d, frame_edges=29)) if fmt == "binary" \
        else (lambda p, s, d: p.encode_shard_text(s, d))
    jparts = jing.partition_edges(src, dst, None, 3)

    ports, threads, _ = jing.serve_blobs([enc(jing, s, d) for s, d, _ in jparts])
    mine = collected_windows(ShardedEdgeSource(
        [("127.0.0.1", p) for p in ports], window=24, fmt=fmt).windows())
    join_all(threads)

    ports, threads, _ = serve_blobs([enc(ing, s, d) for s, d, _ in partition_edges(src, dst, None, 3)])
    theirs = collected_windows(jing.ShardedEdgeSource(
        [("127.0.0.1", p) for p in ports], window=24, fmt=fmt).windows())
    join_all(threads)
    assert mine == theirs == oracle_windows(src, dst, 3, 24)


def test_sharded_text_mode_matches_oracle_and_counts_malformed():
    src, dst = make_edges(300, seed=9)
    parts = partition_edges(src, dst, None, 2)
    blobs = [b"# header\nnot an edge\n" + encode_shard_text(s, d) for s, d, _ in parts]
    ports, threads, _stop = serve_blobs(blobs)
    source = ShardedEdgeSource([("127.0.0.1", p) for p in ports], window=32, fmt="text")
    got = collected_windows(source.windows())
    join_all(threads)
    assert got == oracle_windows(src, dst, 2, 32)
    assert counter_value("source.malformed_lines") == 2


def test_weighted_binary_windows_carry_the_value_column():
    src, dst = make_edges(200, seed=43)
    val = np.random.default_rng(43).random(200)
    parts = partition_edges(src, dst, val, 2)
    ports, threads, _ = serve_blobs([encode_shard_frames(s, d, v, frame_edges=17)
                                     for s, d, v in parts])
    got = {}
    for sh, s, d, v in ShardedEdgeSource([("127.0.0.1", p) for p in ports], window=20,
                                         weighted=True).windows():
        got.setdefault(sh, []).append(v.tolist())
    join_all(threads)
    for i, (_s, _d, v) in enumerate(jing.partition_edges(src, dst, val, 2)):
        assert got[i] == [v[a:a + 20].tolist() for a in range(0, len(v), 20)]


def test_superbatch_groups_match_per_window_blocks():
    src, dst = make_edges(400, seed=13)
    parts = partition_edges(src, dst, None, 2)
    blobs = [encode_shard_frames(s, d) for s, d, _ in parts]

    def fresh_stream():
        ports, _threads, _stop = serve_blobs(blobs)
        return ShardedEdgeSource([("127.0.0.1", p) for p in ports], window=32).stream(
            device="cpu")

    blocks_stream = fresh_stream()
    block_raw = []
    for b in blocks_stream.blocks():
        s, d, _v = b._host_cache
        block_raw.append((blocks_stream.vertex_dict.decode(s).tolist(),
                          blocks_stream.vertex_dict.decode(d).tolist()))

    groups_stream = fresh_stream()
    group_raw = []
    for g in groups_stream.superbatches(4):
        assert g.cols is not None and g.device.type == "cpu"
        for s, d, _v in g.cols:
            group_raw.append((groups_stream.vertex_dict.decode(np.asarray(s)).tolist(),
                              groups_stream.vertex_dict.decode(np.asarray(d)).tolist()))
    assert sorted(block_raw) == sorted(group_raw)
    assert sum(len(s) for s, _ in group_raw) == 400


def test_stream_defaults_to_the_card_and_raises_without_one():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves")
    source = ShardedEdgeSource([("127.0.0.1", 1)], window=8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        source.stream()


@pytest.mark.parametrize("superbatch", [1, 4])
def test_sharded_cc_equals_the_unsharded_run_and_the_jax_package(superbatch):
    from gelly_streaming_tpu.core.stream import SimpleEdgeStream as JStream
    from gelly_streaming_tpu.core.window import CountWindow as JCount
    from gelly_streaming_tpu.library import ConnectedComponents as JCC

    src, dst = make_edges(600, vmax=80, seed=17)
    parts = partition_edges(src, dst, None, 3)
    blobs = [encode_shard_frames(s, d) for s, d, _ in parts]
    ports, threads, _stop = serve_blobs(blobs)
    stream = ShardedEdgeSource([("127.0.0.1", p) for p in ports], window=64).stream(device="cpu")
    agg = ConnectedComponents(superbatch=superbatch)
    sharded = None
    for sharded in stream.aggregate(agg):
        pass
    join_all(threads)
    ref = None
    for ref in SimpleEdgeStream((src, dst), window=CountWindow(64), device="cpu").aggregate(
            ConnectedComponents()):
        pass
    jref = None
    for jref in JStream((src, dst), window=JCount(64)).aggregate(JCC()):
        pass
    assert str(sharded) == str(ref) == str(jref)
    assert agg._cc_mode == "host"  # the CPU's carry; blocks kept their host columns


def test_serve_cli_peer_feeds_the_source():
    """``python -m gelly_streaming_tpu_torch.core.ingest --serve``: the
    load generator announces its ports, serves the partitioned R-MAT
    stream, and the windows equal the JAX package's partition of the same
    R-MAT edges."""
    from gelly_streaming_tpu.datasets import rmat_edges

    n, shards = 4096, 2
    proc = subprocess.Popen(
        [sys.executable, "-m", "gelly_streaming_tpu_torch.core.ingest", "--serve",
         "--shards", str(shards), "--edges", str(n), "--scale", "10", "--seed", "3",
         "--frame-edges", "512"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=REPO)
    try:
        doc = json.loads(proc.stdout.readline())
        assert doc["edges"] == n and doc["format"] == "binary"
        got = collected_windows(ShardedEdgeSource(
            [("127.0.0.1", p) for p in doc["ports"]], window=300).windows())
        assert proc.wait(60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.communicate()
    src, dst = rmat_edges(n, 10, seed=3)
    assert got == oracle_windows(src, dst, shards, 300)
    assert doc["per_shard"] == [len(p[0]) for p in jing.partition_edges(src, dst, None, shards)]


def test_serve_cli_without_serve_prints_usage():
    assert ing.main([]) == 2


# --------------------------------------------------------------------- #
# Backpressure: bounded queues, stall/resume evidence, intact windows
# --------------------------------------------------------------------- #
def test_slow_consumer_bounds_queue_depth_and_resumes():
    src, dst = make_edges(3000, seed=23)
    parts = partition_edges(src, dst, None, 2)
    blobs = [encode_shard_frames(s, d, frame_edges=64) for s, d, _ in parts]
    ports, threads, _stop = serve_blobs(blobs)
    source = ShardedEdgeSource([("127.0.0.1", p) for p in ports], window=32,
                               queue_windows=2, stall_event_s=0.05)
    max_depth = 0
    wins = []
    for i, w in enumerate(source.windows()):
        wins.append(w)
        max_depth = max(max_depth, *(sh.q.qsize() for sh in source._shards))
        if i == 0:
            # hold the consumer until a reader has counted a stall
            # episode (its full queue blocked it past stall_event_s): the
            # wait is for the event, not for a duration
            deadline = time.monotonic() + 30
            while (counter_value("source.backpressure_stalls") < 1
                   and time.monotonic() < deadline):
                time.sleep(0.01)
    join_all(threads)
    assert max_depth <= 2
    assert counter_value("source.backpressure_stalls") >= 1
    assert counter_value("source.backpressure_resumes") >= 1
    assert counter_value("source.backpressure_s") > 0
    assert collected_windows(wins) == oracle_windows(src, dst, 2, 32)


def test_mid_ingest_disconnect_replays_exactly_once():
    src, dst = make_edges(800, seed=29)
    parts = partition_edges(src, dst, None, 2)
    blobs = [encode_shard_frames(s, d, frame_edges=16) for s, d, _ in parts]
    ports, threads, _stop = serve_blobs(blobs, accepts=2)
    source = ShardedEdgeSource([("127.0.0.1", p) for p in ports], window=32, reconnect=4,
                               reconnect_base_s=0.01)
    with faults.injected(FaultPlan(disconnect_at_record=37)):
        got = collected_windows(source.windows())
    _stop.set()
    assert counter_value("resilience.fault_injected", site="source.record") == 1
    assert counter_value("source.reconnects") >= 1
    assert counter_value("source.replayed_frames") >= 1
    assert got == oracle_windows(src, dst, 2, 32)


def test_source_is_single_use_and_close_is_idempotent():
    src, dst = make_edges(60)
    ports, threads, _stop = serve_blobs([encode_shard_frames(src, dst)])
    source = ShardedEdgeSource([("127.0.0.1", p) for p in ports], window=16)
    list(source.windows())
    with pytest.raises(RuntimeError):
        next(iter(source.windows()))
    source.close()
    source.close()
    join_all(threads)


def test_source_argument_checks_match_the_jax_package():
    for kw in (dict(fmt="json"), dict(window=0), dict(fmt="text", timestamps=True),
               dict(allowed_lateness_s=-1)):
        args = dict(window=8)
        args.update(kw)
        with pytest.raises(ValueError):
            ShardedEdgeSource([("127.0.0.1", 1)], **args)
        with pytest.raises(ValueError):
            jing.ShardedEdgeSource([("127.0.0.1", 1)], **args)
    with pytest.raises(RuntimeError, match="timestamps=True"):
        next(ShardedEdgeSource([("127.0.0.1", 1)], window=8).windows_ts())


# --------------------------------------------------------------------- #
# Obs + timeline story
# --------------------------------------------------------------------- #
def test_timeline_renders_ingest_stall_resume_story():
    events = [
        {"kind": "counter", "name": "source.reconnects", "ts": 1.0, "shard": "p0", "v": 1},
        {"kind": "counter", "name": "source.malformed_frames", "ts": 2.0, "shard": "p0",
         "labels": {"kind": "magic"}, "v": 1},
        {"kind": "counter", "name": "source.backpressure_stalls", "ts": 3.0, "shard": "p0",
         "labels": {"shard": "1"}, "v": 1},
        {"kind": "counter", "name": "source.backpressure_resumes", "ts": 4.0, "shard": "p0",
         "labels": {"shard": "1"}, "v": 1},
    ]
    lines = timeline.render(events)
    from gelly_streaming_tpu.obs import timeline as jtimeline

    assert lines == jtimeline.render(events)
    assert len(lines) == 4
    assert "RECONNECT" in lines[0]
    assert "MALFORMED" in lines[1] and "kind=magic" in lines[1]
    assert "INGEST-STALL" in lines[2]
    assert "INGEST-RESUME" in lines[3]


def test_shard_depth_gauge_and_decode_span_fire_when_enabled():
    sink = obs.JsonlSink()
    obs.enable()
    obs.attach_sink(sink)
    try:
        src, dst = make_edges(200)
        ports, threads, _stop = serve_blobs([encode_shard_frames(src, dst, frame_edges=32)])
        source = ShardedEdgeSource([("127.0.0.1", p) for p in ports], window=16)
        list(source.windows())
        join_all(threads)
    finally:
        obs.detach_sink(sink)
        obs.disable()
    assert obs.get_registry().find("source.shard_depth")
    spans = [e for e in sink.events if e["kind"] == "span" and e["name"] == "ingest.decode"]
    assert len(spans) == 7 and all(e["attrs"]["shard"] == 0 for e in spans)


# --------------------------------------------------------------------- #
# Event time: GSEW v2 and the sharded socket path
# --------------------------------------------------------------------- #
def test_ts_less_frames_stay_version_1_and_decode_unchanged():
    src = np.array([1, 2, 3], np.int64)
    dst = np.array([4, 5, 6], np.int64)
    frame = pack_edge_frame(src, dst, seq=1)
    _, version, flags, n, plen, _ = HEADER.unpack(frame[: HEADER.size])
    assert version == VERSION and not (flags & F_TS)
    cols = decode_frame_payload(frame[HEADER.size:], n, flags)
    assert len(cols) == 3
    np.testing.assert_array_equal(cols[0], src)
    np.testing.assert_array_equal(cols[1], dst)


def test_v2_frame_round_trips_the_ts_column_exactly():
    src = np.array([1, 2, 3, 4], np.int64)
    dst = np.array([5, 6, 7, 8], np.int64)
    val = np.array([0.5, 1.5, 2.5, 3.5])
    ts = np.array([10, 11, -5, I64_MAX - 1], np.int64)
    frame = pack_edge_frame(src, dst, val, seq=1, ts=ts)
    _, version, flags, n, plen, _ = HEADER.unpack(frame[: HEADER.size])
    assert version == VERSION_TS and (flags & F_TS)
    assert plen == frame_geometry(n, flags)
    s, d, v, t = decode_frame_payload(frame[HEADER.size:], n, flags)
    np.testing.assert_array_equal(s, src)
    np.testing.assert_array_equal(d, dst)
    np.testing.assert_array_equal(v, val)
    np.testing.assert_array_equal(t, ts)


def test_ts_flag_on_a_v1_header_is_rejected():
    frame = bytearray(pack_edge_frame(np.array([1], np.int64), np.array([2], np.int64), seq=1,
                                      ts=np.array([7], np.int64)))
    frame[4] = VERSION  # lie: v1 header carrying the F_TS flag
    a, b = socket.socketpair()
    try:
        a.sendall(bytes(frame))
        with pytest.raises(MalformedFrame) as exc:
            ing.read_edge_frame(b)
        assert exc.value.kind == "version"
    finally:
        a.close()
        b.close()


def test_ts_reader_fed_a_v1_stream_counts_ts_missing_and_gives_up():
    src, dst = make_edges(64, seed=5)
    port, t = _serve_script([encode_shard_frames(src, dst, frame_edges=16)] * 8)
    source = ShardedEdgeSource([("127.0.0.1", port)], window=16, timestamps=True, reconnect=2,
                               reconnect_base_s=0.01)
    with pytest.raises(TransientSourceError, match="malformed"):
        list(source.windows_ts())
    assert counter_value("source.malformed_frames", kind="ts_missing") >= 3


def make_ts_stream(n, vmax, tmax, seed):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, vmax, n).astype(np.int64)
    dst = rng.integers(0, vmax, n).astype(np.int64)
    ts = np.sort(rng.integers(0, tmax, n)).astype(np.int64)
    return src, dst, ts


def test_late_records_drop_counted_and_watermarks_merge_like_the_jax_package():
    """Per-shard watermarks, the merged min over live shards, and the
    lateness policy: a record behind the allowance is dropped and counted
    in both packages alike, shard by shard."""
    ts0 = np.array([5, 6, 7, 2, 8, 9, 3, 10], np.int64)
    src = np.arange(8, dtype=np.int64)
    blobs = [pack_edge_frame(src[:4], src[:4] + 1, seq=1, ts=ts0[:4])
             + pack_edge_frame(src[4:], src[4:] + 1, seq=2, ts=ts0[4:])]
    results = []
    for pkg in (ing, jing):
        ports, threads, _ = pkg.serve_blobs(blobs)
        source = pkg.ShardedEdgeSource([("127.0.0.1", p) for p in ports], window=3,
                                       timestamps=True, allowed_lateness_s=1)
        wins = [(w[0], w[1].tolist(), w[4].tolist()) for w in source.windows_ts()]
        join_all(threads)
        results.append((wins, source.shard_watermarks(), source.watermark()))
    assert results[0] == results[1]
    assert results[0][1] == [10]
    # lateness is judged against the watermark BEFORE each frame: frame 1
    # (no watermark yet) keeps its 2; frame 2 drops 3 (< 7 - 1)
    assert counter_value("eventtime.late_dropped", shard="0") == 1
    assert [t for _sh, _s, ts in results[0][0] for t in ts] == [5, 6, 7, 2, 8, 9, 10]


def test_socket_ingest_to_sliding_aggregator_end_to_end():
    """Partitioned v2 frames over real sockets -> ShardedEdgeSource(
    timestamps=True) -> windows_ts -> drive_sliding on the port: every
    window equal to the from-scratch oracles on the surviving multiset,
    and the final one to the JAX package's aggregator over the same
    stream (the merged order is nondeterministic; the answers are not)."""
    from gelly_streaming_tpu import eventtime as jet
    from gelly_streaming_tpu.eventtime.stream import drive_sliding as jdrive
    from gelly_streaming_tpu_torch.eventtime import (
        SlidingGraphAggregator,
        drive_sliding,
        oracle_bipartite,
        oracle_degrees,
        oracle_labels,
    )

    src, dst, ts = make_ts_stream(n=1200, vmax=40, tmax=120, seed=31)
    blobs = [encode_shard_frames(s, d, ts=t, frame_edges=64)
             for s, d, _v, t in partition_edges(src, dst, None, 2, ts=ts)]
    ports, threads, _stop = serve_blobs(blobs)
    source = ShardedEdgeSource([("127.0.0.1", p) for p in ports], window=32, timestamps=True)
    results = drive_sliding(source.windows_ts(), SlidingGraphAggregator(30, 10, nshards=2,
                                                                       verify=True))
    join_all(threads)
    assert counter_value("eventtime.late_dropped") == 0
    for res in results:
        m = (ts >= res.start) & (ts < res.end)
        s, d = src[m], dst[m]
        assert res.n_edges == int(m.sum())
        np.testing.assert_array_equal(res.labels, oracle_labels(len(res.labels), s, d))
        np.testing.assert_array_equal(res.degrees, oracle_degrees(len(res.degrees), s, d))
        assert res.bipartite == oracle_bipartite(len(res.degrees), s, d)
    final = results[-1]
    assert final.event_ts == I64_MAX  # end of stream: total promise
    assert any(0 <= r.event_ts < I64_MAX for r in results)

    ports, threads, _ = jing.serve_blobs(blobs)
    jres = jdrive(jing.ShardedEdgeSource([("127.0.0.1", p) for p in ports], window=32,
                                         timestamps=True).windows_ts(),
                  jet.SlidingGraphAggregator(30, 10, nshards=2))
    join_all(threads)
    jfinal = jres[-1]
    assert (final.index, final.start, final.end, final.n_edges) == \
        (jfinal.index, jfinal.start, jfinal.end, jfinal.n_edges)
    np.testing.assert_array_equal(final.labels, jfinal.labels)
    np.testing.assert_array_equal(final.degrees, jfinal.degrees)
    assert final.bipartite == jfinal.bipartite and final.top == jfinal.top


# --------------------------------------------------------------------- #
# The single-connection socket source (tests/test_sources.py)
# --------------------------------------------------------------------- #
def _serve_lines(payloads):
    srv = socket.create_server(("127.0.0.1", 0))
    port = srv.getsockname()[1]

    def run():
        try:
            conn, _ = srv.accept()
            try:
                for p in payloads:
                    conn.sendall(p)
            finally:
                conn.close()
        finally:
            srv.close()

    t = threading.Thread(target=run, daemon=True)
    t.start()
    return port, t


def test_socket_source_cc_matches_array_run():
    """Line records over a socket in processing-time micro-batches into
    CC: the final components equal the array run's and the JAX package's
    (how many micro-batches the bursts make is the clock's business and
    is not asserted)."""
    from gelly_streaming_tpu.core.stream import SimpleEdgeStream as JStream
    from gelly_streaming_tpu.core.window import CountWindow as JCount
    from gelly_streaming_tpu.library import ConnectedComponents as JCC
    from gelly_streaming_tpu_torch.core.sources import SocketEdgeSource
    from gelly_streaming_tpu_torch.core.window import ProcessingTimeWindow

    rng = np.random.default_rng(5)
    edges = [(int(a), int(b), 0.0) for a, b in rng.integers(0, 30, size=(120, 2))]
    bursts = [("".join(f"{s}\t{d}\n" for s, d, _ in edges[i:i + 30])).encode()
              for i in range(0, 120, 30)]
    port, t = _serve_lines(bursts)
    stream = SimpleEdgeStream(SocketEdgeSource("127.0.0.1", port, tick_s=0.02),
                              window=ProcessingTimeWindow(seconds=0.05, max_count=64),
                              device="cpu")
    outs = list(stream.aggregate(ConnectedComponents()))
    t.join(30)
    ref = None
    for ref in SimpleEdgeStream(edges, window=CountWindow(64), device="cpu").aggregate(
            ConnectedComponents()):
        pass
    jref = None
    for jref in JStream(edges, window=JCount(64)).aggregate(JCC()):
        pass
    assert str(outs[-1]) == str(ref) == str(jref)


def test_socket_text_chunk_parse_weighted_and_malformed():
    from gelly_streaming_tpu_torch.core.sources import SocketEdgeSource

    payload = ("# header\n1\t2\t0.5\nnot-an-edge\n3 4 1.25\nx y\n5,6,2.0\n").encode()
    port, t = _serve_lines([payload])
    got = [r for r in SocketEdgeSource("127.0.0.1", port, tick_s=0.02, weighted=True)
           if r is not None]
    t.join(10)
    assert got == [(1, 2, 0.5), (3, 4, 1.25), (5, 6, 2.0)]
    assert obs.get_registry().counter("source.malformed_lines").value == 2
