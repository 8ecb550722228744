"""Corpus registry, loaders and surrogate synthesis (PyTorch port).

The counterpart of ``gelly_streaming_tpu/datasets.py``. The measurement
matrix names three corpora: the SNAP LiveJournal edge list (streaming CC
at scale), the SNAP twitter-ego combined edge list and MovieLens ratings.
:func:`ensure_corpus` returns the real file when it is present under
``$GELLY_DATA`` or ``./data``, and otherwise synthesizes (once, then
cached) an R-MAT surrogate of the same format and a documented scale, so
a benchmark always runs file-first: file -> native parse -> windows ->
vertex map -> device. The surrogate cache is ``gelly_data/`` under the
temporary directory (``tempfile.gettempdir()``, so ``$TMPDIR``).

Surrogates are R-MAT graphs (Graph500 parameters a=.57 b=.19 c=.19
d=.05); :func:`synthesize` writes the same bytes as the JAX package's for
the same spec and seed.

:func:`stream_file` is the file -> stream entry point, on the stream's
device (``"cuda"`` by default); ``device_encode=True`` moves vertex
compaction onto the device (``ops/device_dict.py``).
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
from typing import Optional, Tuple

import numpy as np
import torch

from . import native
from .core.device import DEFAULT_DEVICE
from .core.edgeblock import bucket_capacity, to_device
from .core.stream import SimpleEdgeStream, StreamContext
from .core.vertexdict import VertexDict
from .core.window import CountWindow, EventTimeWindow, WindowPolicy, Windower
from .obs import trace as _trace


@dataclasses.dataclass(frozen=True)
class CorpusSpec:
    name: str
    filename: str  # conventional filename under the data dir
    url: str  # provenance (documentation only; never fetched)
    n_edges: int  # published size of the real corpus
    n_vertices: int
    weighted: bool = False
    # surrogate scale: edges/vertices for the synthesized stand-in
    surrogate_edges: int = 1 << 24
    surrogate_vscale: int = 1 << 21


CORPORA = {
    "livejournal": CorpusSpec(
        name="livejournal",
        filename="soc-LiveJournal1.txt",
        url="https://snap.stanford.edu/data/soc-LiveJournal1.html",
        n_edges=68_993_773,
        n_vertices=4_847_571,
        surrogate_edges=1 << 24,
        surrogate_vscale=1 << 21,
    ),
    # north-star scale: a scale-23 R-MAT surrogate about 2x the real
    # LiveJournal's edge count; no real corpus by this name exists
    "livejournal-xl": CorpusSpec(
        name="livejournal-xl",
        filename="soc-LiveJournal1-xl.txt",
        url="https://snap.stanford.edu/data/soc-LiveJournal1.html",
        n_edges=1 << 27,
        n_vertices=1 << 23,
        surrogate_edges=1 << 27,
        surrogate_vscale=1 << 23,
    ),
    "twitter-ego": CorpusSpec(
        name="twitter-ego",
        filename="twitter_combined.txt",
        url="https://snap.stanford.edu/data/ego-Twitter.html",
        n_edges=2_420_766,
        n_vertices=81_306,
        surrogate_edges=1 << 21,
        surrogate_vscale=1 << 17,
    ),
    "movielens-100k": CorpusSpec(
        name="movielens-100k",
        filename="u.data",
        url="https://grouplens.org/datasets/movielens/100k/",
        n_edges=100_000,
        n_vertices=943 + 1682,
        weighted=True,
        surrogate_edges=100_000,
        surrogate_vscale=1 << 11,
    ),
}

#: MovieLens item ids are offset into a range disjoint from user ids
MOVIELENS_ITEM_OFFSET = 1 << 20


def cache_dir() -> str:
    """Where synthesized surrogates are cached."""
    return os.path.join(tempfile.gettempdir(), "gelly_data")


def data_dirs() -> list:
    dirs = []
    env = os.environ.get("GELLY_DATA")
    if env:
        dirs.append(env)
    dirs.append(os.path.join(os.getcwd(), "data"))
    dirs.append(cache_dir())
    return dirs


def locate(name: str) -> Optional[str]:
    """Path of the real corpus file if present under a data dir."""
    spec = CORPORA[name]
    for d in data_dirs():
        p = os.path.join(d, spec.filename)
        if os.path.exists(p):
            return p
    return None


def rmat_edges(
    n_edges: int,
    scale: int,
    seed: int = 0,
    a: float = 0.57,
    b: float = 0.19,
    c: float = 0.19,
) -> Tuple[np.ndarray, np.ndarray]:
    """Vectorized R-MAT: ``n_edges`` edges over ``2**scale`` vertices.

    One pass per address bit; each pass picks the quadrant for every edge
    at once (no per-edge recursion).
    """
    rng = np.random.default_rng(seed)
    src = np.zeros(n_edges, np.int64)
    dst = np.zeros(n_edges, np.int64)
    for _ in range(scale):
        r = rng.random(n_edges)
        src_bit = r >= (a + b)
        dst_bit = (r >= a) & (r < a + b) | (r >= a + b + c)
        src = (src << 1) | src_bit
        dst = (dst << 1) | dst_bit
    return src, dst


class IdentityDict:
    """VertexDict stand-in for corpora whose ids are already dense small
    integers: compact id == raw id, so the encode stage of ingest
    disappears. Emission correctness does not depend on this mapping:
    workloads track which vertices actually appeared.
    """

    def __init__(self, id_bound: int):
        self.id_bound = int(id_bound)
        self._observed = 0  # max encoded id + 1

    def __len__(self) -> int:
        """Number of ids actually observed (max + 1), NOT the declared
        bound."""
        return self._observed

    @property
    def capacity(self) -> int:
        return bucket_capacity(max(1, self.id_bound))

    def observe(self, max_id: int) -> None:
        """Advance the observed-id watermark."""
        if max_id >= self._observed:
            self._observed = max_id + 1

    def encode(self, raw):
        a = np.asarray(raw)
        if a.size:
            hi = int(a.max())
            if int(a.min()) < 0 or hi >= self.id_bound:
                raise ValueError(
                    f"raw id outside [0, {self.id_bound}) — not a dense-id "
                    "corpus; use VertexDict"
                )
            self.observe(hi)
        return a if a.dtype == np.int32 else a.astype(np.int32)

    def encode_pair(self, src, dst):
        return self.encode(src), self.encode(dst)

    def decode(self, idx):
        return np.asarray(idx, np.int64)

    def decode_one(self, idx: int) -> int:
        return int(idx)

    def lookup(self, raw: int):
        return int(raw) if 0 <= int(raw) < self.id_bound else None

    def lookup_batch(self, raw) -> np.ndarray:
        """Vectorized :meth:`lookup`: compact ids, -1 for ids outside the
        declared bound."""
        a = np.asarray(raw, np.int64).ravel()
        return np.where(
            (a >= 0) & (a < self.id_bound), a, -1
        ).astype(np.int32)

    def raw_ids(self) -> np.ndarray:
        """Ids observed so far (the checkpoint surface)."""
        return np.arange(self._observed, dtype=np.int64)

    def raw_table(self, device) -> torch.Tensor:
        """Device int32 table compact -> raw: the identity over the
        capacity, made on the device (no upload, no host sync)."""
        return torch.arange(self.capacity, dtype=torch.int32, device=device)


def synthesize(
    name: str, path: str, seed: int = 0, chunk: int = 1 << 22
) -> str:
    """Write the surrogate corpus for ``name`` to ``path`` (SNAP format:
    '#' header + tab-separated edges; MovieLens adds a rating column)."""
    spec = CORPORA[name]
    scale = int(spec.surrogate_vscale).bit_length() - 1
    with open(path, "w") as f:
        f.write(
            f"# surrogate for {spec.name} ({spec.url})\n"
            f"# R-MAT scale={scale} edges={spec.surrogate_edges}\n"
        )
    rng = np.random.default_rng(seed + 1)
    for start in range(0, spec.surrogate_edges, chunk):
        n = min(chunk, spec.surrogate_edges - start)
        src, dst = rmat_edges(n, scale, seed=seed + start)
        if spec.weighted:
            # raw (user, item, rating) rows like the real u.data
            w = rng.integers(1, 6, n)
            with open(path, "a") as f:
                for s, d, r in zip(src.tolist(), dst.tolist(), w.tolist()):
                    f.write(f"{s}\t{d}\t{r}\n")
        else:
            native.write_edge_file(path, src, dst, append=True)
    return path


def surrogate_path(name: str) -> str:
    """Where :func:`ensure_corpus` keeps the surrogate text of ``name``
    (its binary cache is this path plus ``.gbin``)."""
    spec = CORPORA[name]
    return os.path.join(cache_dir(), f"surrogate_{name}_{spec.surrogate_edges}.txt")


def ensure_corpus(name: str) -> Tuple[str, bool]:
    """``(path, is_real)``: the real corpus if present, else the cached
    surrogate (synthesized on first use, written under a temporary name
    and renamed, so a run cut short leaves no partial corpus behind)."""
    real = locate(name)
    if real is not None:
        return real, True
    os.makedirs(cache_dir(), exist_ok=True)
    path = surrogate_path(name)
    if not os.path.exists(path):
        tmp = f"{path}.{os.getpid()}.tmp"
        synthesize(name, tmp)
        os.replace(tmp, path)
    return path, False


# --------------------------------------------------------------------- #
# Binary edge cache (the Arrow/Kafka-style ingest format)
# --------------------------------------------------------------------- #
_BIN_MAGIC = b"GELLYB1\x00"


def binary_cache(path: str, bin_path: Optional[str] = None, arrays=None) -> str:
    """Convert a text edge list to the packed binary format (one-time);
    returns the binary path. Layout: magic, int64 n, uint8 has_val, then
    src int32[n], dst int32[n], and val float32[n] when present.
    ``arrays=(src, dst, val|None)`` skips re-parsing. Freshness is keyed
    by the source's size and mtime in a sidecar file."""
    if bin_path is None:
        bin_path = path + ".gbin"
    st = os.stat(path)
    stamp = f"{st.st_size}:{int(st.st_mtime_ns)}"
    sidecar = bin_path + ".src"
    if os.path.exists(bin_path):
        try:
            with open(sidecar) as f:
                if f.read().strip() == stamp:
                    return bin_path
        except OSError:
            pass
    src, dst, val = arrays if arrays is not None else native.parse_edge_file(path)
    write_binary(bin_path, src, dst, val)
    with open(sidecar, "w") as f:
        f.write(stamp)
    return bin_path


def write_binary(bin_path: str, src, dst, val=None) -> str:
    """Write edge columns in the :func:`binary_cache` layout, under a
    temporary name renamed into place (a run cut short leaves no partial
    file behind). Ids must be non-negative int32; ``val`` is stored as
    float32 when given."""
    src, dst = np.asarray(src), np.asarray(dst)
    if src.size and (
        max(src.max(), dst.max()) > np.iinfo(np.int32).max
        or min(src.min(), dst.min()) < 0
    ):
        raise ValueError("binary cache requires non-negative int32 ids")
    with open(bin_path + ".tmp", "wb") as f:
        f.write(_BIN_MAGIC)
        np.asarray([len(src)], np.int64).tofile(f)
        np.asarray([0 if val is None else 1], np.uint8).tofile(f)
        src.astype(np.int32).tofile(f)
        dst.astype(np.int32).tofile(f)
        if val is not None:
            np.asarray(val).astype(np.float32).tofile(f)
    os.replace(bin_path + ".tmp", bin_path)
    return bin_path


def iter_binary_chunks(bin_path: str, chunk_edges: int = 1 << 21):
    """Yield (src, dst, val|None) int32/float32 column chunks from a
    :func:`binary_cache` file through memmap views (no copy)."""
    with open(bin_path, "rb") as f:
        if f.read(8) != _BIN_MAGIC:
            raise IOError(f"{bin_path}: not a gelly binary edge file")
        n = int(np.fromfile(f, np.int64, 1)[0])
        has_val = bool(np.fromfile(f, np.uint8, 1)[0])
        base = f.tell()
    mm = np.memmap(bin_path, mode="r", dtype=np.uint8)
    src = mm[base : base + 4 * n].view(np.int32)
    dst = mm[base + 4 * n : base + 8 * n].view(np.int32)
    val = mm[base + 8 * n : base + 12 * n].view(np.float32) if has_val else None
    for a in range(0, n, chunk_edges):
        b = min(a + chunk_edges, n)
        yield src[a:b], dst[a:b], None if val is None else val[a:b]


# --------------------------------------------------------------------- #
# File -> stream
# --------------------------------------------------------------------- #
def _parse_spans(chunks):
    """``chunks`` with the read and parse of each chunk timed as one
    ``ingest.parse`` span (nothing is timed while tracing is off)."""
    it = iter(chunks)
    while True:
        with _trace.span("ingest.parse"):
            chunk = next(it, None)
        if chunk is None:
            return
        yield chunk


class _ValuePacker:
    """Packed value columns for the device-encode path: a value-consuming
    workload would otherwise pay a float32 upload per edge (4 B, a third of
    the upload on top of the 8 B of id columns).

    Real weighted corpora mostly carry few distinct values (MovieLens
    ratings: 10; small integer weights), so the host keeps a sorted
    dictionary of distinct float32 values and ships uint8 codes (uint16
    above 255 distinct) plus a small table that uploads again only when it
    changes; the device widens with one gather. The TOP code of each width
    (255 / 65535) is reserved and decodes to 0.0, keeping the padded-slot
    ``val == 0`` invariant of every other ingest path (aggregations that
    scatter-add values without re-masking rely on it). Lossless: a window
    that would exceed 65535 distinct values, or holds a NaN (the sorted
    probe cannot code it), moves the stream to raw float32 for good."""

    __slots__ = ("table", "mode", "_lut_dev", "_lut_stale", "device")

    def __init__(self, device):
        self.table = np.zeros(0, np.float32)
        self.mode = "u8"  # "u8" | "u16" | "f32"
        self._lut_dev = None
        self._lut_stale = True
        self.device = device

    def _probe(self, v):
        codes = np.searchsorted(self.table, v)
        np.minimum(codes, max(len(self.table) - 1, 0), out=codes)
        if len(self.table) == 0:
            return codes, np.ones(len(v), bool)
        return codes, self.table[codes] != v

    def pack(self, v: np.ndarray):
        """-> ``(codes uint8/uint16, device lut)``, or None once the stream
        moved to raw float32."""
        if self.mode == "f32":
            return None
        v = np.ascontiguousarray(v, np.float32)
        codes, miss = self._probe(v)
        if miss.any():
            if np.isnan(v).any():
                self.mode = "f32"
                return None
            self.table = np.union1d(self.table, np.unique(v[miss])).astype(np.float32)
            if len(self.table) > 65535:  # the top u16 code is the pads'
                self.mode = "f32"
                return None
            if len(self.table) > 255 and self.mode == "u8":
                self.mode = "u16"
            self._lut_stale = True
            codes, miss = self._probe(v)
        dt = np.uint8 if self.mode == "u8" else np.uint16
        if self._lut_stale:
            lut = np.zeros(256 if self.mode == "u8" else 65536, np.float32)
            lut[: len(self.table)] = self.table
            self._lut_dev = to_device(lut, self.device)
            self._lut_stale = False
        return codes.astype(dt), self._lut_dev


def _decode_vals(lut: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """Widen packed value codes on the device. uint16 codes travel as
    int16 (their bits) and are read back as unsigned here."""
    if codes.dtype == torch.int16:
        idx = codes.to(torch.int32) & 0xFFFF
    else:
        idx = codes
    return lut[idx.long()]


def _device_encoded_blocks(path, is_binary, policy, vdict, chunk_edges,
                           drop_values=False):
    """Window blocks whose vertex mapping runs ON the device: the host
    slices raw columns and uploads them; the compaction is the device
    dictionary (``ops/device_dict.py``). ``policy`` is a CountWindow
    (fixed ``size`` slices) or an EventTimeWindow (ascending timestamps
    from ``timestamp_fn``, windows cut by the shared slot-run splitter).

    With a declared ``id_bound`` the table covers the id space and every
    window is one unconditional encode. Without one (arbitrary int32 ids)
    the host counts the exact distinct ids of the raw stream as it parses
    (``native.NoveltyBitmap``: first-seen distinctness is the device
    table's count) and grows the table by padding before any window could
    overflow it. Either way the window loop reads nothing from the device;
    the sticky ``probe`` catches an overflow at the next natural read.

    The encode runs on whatever thread iterates this generator (the
    prefetch producer, which has the stream's device as its current
    device) on the device's default stream, the stream the consumer's work
    runs on, so the order of the two needs no event. Raw columns go up
    through ``to_device``: a copy into fresh pinned memory, so the host
    may reuse its parser buffers at once."""
    from .core.edgeblock import EdgeBlock, _cached_mask, _cached_zeros

    device = vdict.device
    growth = vdict.id_bound == 0
    if growth and getattr(vdict, "_novelty", None) is None:
        # owned by the dict: the novelty state lives exactly as long as
        # the table it bounds (a re-iterated stream reuses both)
        vdict._novelty = native.NoveltyBitmap()
        vdict._novel_seen = 0

    packer = _ValuePacker(device)

    def build(si, di, v, n):
        cap = bucket_capacity(n)
        if cap != n:
            si = torch.nn.functional.pad(si, (0, cap - n))
            di = torch.nn.functional.pad(di, (0, cap - n))
        if v is None or drop_values:
            # value-ignoring workloads skip the value upload; the cached
            # zero column is one device constant
            val = _cached_zeros(cap, device)
        else:
            packed = packer.pack(v)
            if packed is None:  # many distinct values / NaN: raw float32
                vp = np.zeros(cap, np.float32)
                vp[:n] = v
                val = to_device(vp, device)
            else:
                codes, lut = packed
                # pads take the reserved top code, which decodes to 0.0
                # (code 0 would decode to the smallest distinct value and
                # weight vertex 0)
                cp = np.full(cap, np.iinfo(codes.dtype).max, codes.dtype)
                cp[:n] = codes
                if cp.dtype == np.uint16:
                    cp = cp.view(np.int16)
                val = _decode_vals(lut, to_device(cp, device))
        return EdgeBlock(
            src=si, dst=di, val=val, mask=_cached_mask(cap, n, device),
            n_vertices=vdict.capacity, cut_ns=_trace.stamp(),
        )

    def emit(s, d, v):
        if growth:
            vdict.ensure_capacity_host(vdict._novel_seen)
            si, di = vdict.encode_pair_spec(s, d)
        else:
            si, di = vdict.encode_pair(s, d)
        return build(si, di, v, len(s))

    def tracked(chunks):
        for s, d, v in chunks:
            s, d = np.asarray(s), np.asarray(d)
            if growth:
                vdict._novel_seen += vdict._novelty.novel2(s, d)
            yield s, d, v

    count = isinstance(policy, CountWindow)
    read_chunk = policy.size if count else chunk_edges
    src = _parse_spans(
        iter_binary_chunks(path, read_chunk)
        if is_binary
        else native.iter_edge_chunks_i32(path, chunk_edges, id_bound=vdict.id_bound)
    )
    if not count:
        from .core.window import iter_time_slot_runs

        for _slot, s, d, v in iter_time_slot_runs(
            tracked(src), policy, val_dtype=np.float32
        ):
            yield emit(s, d, v)
        return
    size = policy.size

    def joined(pend):
        if len(pend) == 1:
            return pend[0]
        cv = None
        if any(p[2] is not None for p in pend):
            cv = np.concatenate([
                np.zeros(len(p[0]), np.float32) if p[2] is None
                else np.asarray(p[2], np.float32)
                for p in pend
            ])
        return (np.concatenate([p[0] for p in pend]),
                np.concatenate([p[1] for p in pend]), cv)

    pend, have = [], 0
    for s, d, v in tracked(src):
        pend.append((s, d, v))
        have += len(s)
        while have >= size:
            cs, cd, cv = joined(pend)
            yield emit(cs[:size], cd[:size], None if cv is None else cv[:size])
            pend = [(cs[size:], cd[size:], None if cv is None else cv[size:])]
            have -= size
    if have:
        cs, cd, cv = joined(pend)
        if len(cs):
            yield emit(cs, cd, cv)


def stream_file(
    path: str,
    window: Optional[WindowPolicy] = None,
    *,
    vertex_dict: Optional[VertexDict] = None,
    chunk_edges: int = 1 << 21,
    prefetch_depth: int = 0,
    min_vertex_capacity: int = 0,
    device_encode: bool = False,
    dense_ids: bool = True,
    drop_values: bool = False,
    device=DEFAULT_DEVICE,
) -> SimpleEdgeStream:
    """A :class:`SimpleEdgeStream` on ``device`` over an edge file,
    chunk-parsed natively.

    The stream re-reads the file on every iteration. ``prefetch_depth >
    0`` overlaps parse, windowing and upload with device compute on a
    background thread pinned to ``device``; the shared vertex dict
    (including ``IdentityDict``'s observed-id watermark) may then run up
    to ``depth`` windows ahead of the consumer. ``min_vertex_capacity``
    pre-sizes a fresh ``VertexDict``.

    The host path is picked by the vertex dict and the file: a ``.gbin``
    binary cache; ``IdentityDict`` (the int32 parser bound-checks the ids,
    which pass through as compact ids); a ``VertexDict`` with the native
    encoder (parse and encode fused in one C pass per chunk); otherwise
    the parser followed by the dict's encode.

    ``device_encode=True`` moves vertex compaction onto the device
    (``ops/device_dict.py``; count and event-time windows). With
    ``dense_ids=True`` (default) ``min_vertex_capacity`` is also the
    declared raw-id bound: the table covers the id space and never grows.
    ``dense_ids=False`` is the general arbitrary-id path: ids may be any
    non-negative int32, the table grows ahead of need from exact host-side
    novelty tracking, and ``min_vertex_capacity`` is only a pre-sizing
    hint. ``drop_values=True`` skips the value upload for value-ignoring
    workloads on weighted corpora. Device-encoded blocks carry no host
    columns, so the workloads take their device paths on them (streaming
    CC: the dense carry)."""
    context = StreamContext(device)
    policy = window or CountWindow(1 << 20)
    is_binary = path.endswith(".gbin")
    if device_encode:
        if not isinstance(policy, (CountWindow, EventTimeWindow)):
            raise ValueError("device_encode supports CountWindow / EventTimeWindow")
        if vertex_dict is not None:
            raise ValueError(
                "device_encode builds its own DeviceVertexDict; a supplied "
                "vertex_dict would be silently ignored"
            )
        from .ops.device_dict import DeviceVertexDict

        vd = DeviceVertexDict(
            min_capacity=max(min_vertex_capacity, 1 << 10),
            id_bound=min_vertex_capacity if dense_ids else 0,
            device=context.device,
        )

        def device_source():
            it = _device_encoded_blocks(
                path, is_binary, policy, vd, chunk_edges, drop_values=drop_values,
            )
            if prefetch_depth > 0:
                from .core.pipeline import prefetch

                return prefetch(it, prefetch_depth, device=context.device)
            return it

        return SimpleEdgeStream(context=context, _blocks=device_source, _vdict=vd)
    if vertex_dict is None and min_vertex_capacity > 0:
        vertex_dict = VertexDict(min_capacity=min_vertex_capacity)
    windower = Windower(policy, vertex_dict, device=context.device)

    def block_source():
        vd = windower.vertex_dict
        identity = isinstance(vd, IdentityDict)
        if is_binary:
            raw_chunks = _parse_spans(iter_binary_chunks(path, chunk_edges))
            if identity:
                chunks = (
                    (vd.encode(s), vd.encode(d), v) for s, d, v in raw_chunks
                )
            else:
                chunks = ((*vd.encode_pair(s, d), v) for s, d, v in raw_chunks)
            pairs = windower.blocks_from_chunks(chunks, encoded=True)
        elif identity:
            # the i32 parser already bound-checks against the id space;
            # only the observed-id watermark (len(vdict)) needs updating
            def _tracked(chunks, vd=vd):
                for s, d, v in chunks:
                    if len(s):
                        vd.observe(int(max(int(s.max()), int(d.max()))))
                    yield s, d, v

            chunks = _tracked(_parse_spans(native.iter_edge_chunks_i32(
                path, chunk_edges, id_bound=vd.id_bound
            )))
            pairs = windower.blocks_from_chunks(chunks, encoded=True)
        elif getattr(vd, "_native", None) is not None:
            pairs = windower.blocks_from_chunks(
                _parse_spans(vd.iter_encode_file(path, chunk_edges)), encoded=True
            )
        else:
            pairs = windower.blocks_from_chunks(
                _parse_spans(native.iter_edge_chunks(path, chunk_edges))
            )
        it = (info_block[1] for info_block in pairs)
        if prefetch_depth > 0:
            from .core.pipeline import prefetch

            return prefetch(it, prefetch_depth, device=context.device)
        return it

    return SimpleEdgeStream(
        context=context, _blocks=block_source, _vdict=windower.vertex_dict
    )


def load_movielens(path: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(user, item, rating) columns from a MovieLens ``u.data``-format file
    (user \\t item \\t rating \\t timestamp); item ids offset into a
    disjoint range (:data:`MOVIELENS_ITEM_OFFSET`)."""
    src, dst, val = native.parse_edge_file(path)
    if val is None:
        val = np.ones(len(src))
    return src, dst + MOVIELENS_ITEM_OFFSET, val
