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
device (``"cuda"`` by default). Its ``device_encode=True`` path (vertex
compaction on the device) comes with ROADMAP Queue 1, slice 5b.
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
from .core.edgeblock import bucket_capacity
from .core.stream import SimpleEdgeStream, StreamContext
from .core.vertexdict import VertexDict
from .core.window import CountWindow, WindowPolicy, Windower
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


def ensure_corpus(name: str) -> Tuple[str, bool]:
    """``(path, is_real)``: the real corpus if present, else the cached
    surrogate (synthesized on first use, written under a temporary name
    and renamed, so a run cut short leaves no partial corpus behind)."""
    real = locate(name)
    if real is not None:
        return real, True
    os.makedirs(cache_dir(), exist_ok=True)
    spec = CORPORA[name]
    path = os.path.join(
        cache_dir(), f"surrogate_{name}_{spec.surrogate_edges}.txt"
    )
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
            val.astype(np.float32).tofile(f)
    os.replace(bin_path + ".tmp", bin_path)
    with open(sidecar, "w") as f:
        f.write(stamp)
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


def stream_file(
    path: str,
    window: Optional[WindowPolicy] = None,
    *,
    vertex_dict: Optional[VertexDict] = None,
    chunk_edges: int = 1 << 21,
    prefetch_depth: int = 0,
    min_vertex_capacity: int = 0,
    device_encode: bool = False,
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
    the parser followed by the dict's encode. ``device_encode=True`` is
    ported in ROADMAP Queue 1, slice 5b, and raises here."""
    if device_encode:
        raise NotImplementedError(
            "device_encode (vertex compaction on the device) is ported in "
            "ROADMAP Queue 1, slice 5b (ops/device_dict.py)"
        )
    context = StreamContext(device)
    policy = window or CountWindow(1 << 20)
    is_binary = path.endswith(".gbin")
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
