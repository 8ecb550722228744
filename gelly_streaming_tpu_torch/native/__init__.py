"""Native host runtime of the port (C++ via ctypes, no pybind11).

The port's own copy of ``native/ingest.cpp`` (file parser, first-seen id
encoder, window prep, compact union-find, corpus writer, compiled CC
baseline) and the loader for it. The device path is PyTorch; the host
around it is native where it matters: parsing a large edge list in
Python is some 50x slower than the device consumes it.

The shared library is built with ``g++ -O3`` (``-march=native`` where the
compiler takes it) at first use, never at import, into the git-ignored
``_build/`` directory of this package. Its file name carries a hash of
the source and of the host's instruction set: an edited source builds
anew, and a library built for another CPU (``-march=native``) is never
loaded, since an illegal instruction kills the process before any
handler runs. Nothing outside this package is read or built.

Every entry point keeps the numpy fallback of the JAX package for a host
without a compiler; :func:`native_available` says which path runs.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import platform
import subprocess
import threading
from typing import Iterator, Optional, Tuple

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "ingest.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
_lock = threading.Lock()
_lib = None
_lib_failed = False
#: the g++ output of a failed build (None when the build succeeded or
#: has not run)
BUILD_ERROR: Optional[str] = None


def _host_isa() -> str:
    """Fingerprint of the host ISA the library must match (the build uses
    ``-march=native``)."""
    flags = ""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("flags"):
                    flags = " ".join(sorted(line.split(":", 1)[1].split()))
                    break
    except OSError:
        pass
    return hashlib.sha256(
        (platform.machine() + "|" + flags).encode()
    ).hexdigest()[:16]


def library_path() -> str:
    """Where the library for this source and this host lives in ``_build/``."""
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"ingest-{digest}-{_host_isa()}.so")


def _build(so: str) -> None:
    """Compile the library to ``so`` unless another process already has:
    concurrent processes (test workers) wait on one lock file and build
    once, instead of each running its own compiler."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, "ingest.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(so):
            return
        tmp = f"{so}.{os.getpid()}.tmp"
        base = ["g++", "-O3", "-shared", "-fPIC", "-pthread", "-o", tmp, _SRC]
        r = subprocess.run(base[:1] + ["-march=native"] + base[1:],
                           capture_output=True, text=True)
        if r.returncode != 0:
            r = subprocess.run(base, capture_output=True, text=True)
            if r.returncode != 0:
                raise RuntimeError(f"g++ failed to build {_SRC}:\n{r.stderr}")
        os.replace(tmp, so)


def _declare(lib: ctypes.CDLL) -> None:
    """``argtypes``/``restype`` of every entry point this module calls."""
    i64 = ctypes.c_int64
    i32 = ctypes.c_int32
    vp = ctypes.c_void_p
    p64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    pf64 = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    pi32a = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    pi32 = ctypes.POINTER(i32)
    sigs = {
        "write_edge_file": (i64, [ctypes.c_char_p, p64, p64, i64, i32, i32]),
        "cc_baseline_run": (i64, [p64, p64, i64, i64, i32, ctypes.POINTER(i64)]),
        "encoder_create": (vp, []),
        "encoder_destroy": (None, [vp]),
        "encoder_encode": (i64, [vp, p64, i64, pi32a, p64]),
        "encoder_encode2": (i64, [vp, p64, p64, i64, pi32a, pi32a, p64]),
        "encoder_lookup": (i32, [vp, i64]),
        "encoder_lookup_batch": (None, [vp, p64, i64, pi32a]),
        "encoder_size": (i64, [vp]),
        "reader_open": (vp, [ctypes.c_char_p, i64]),
        "reader_close": (None, [vp]),
        "reader_offset": (i64, [vp]),
        "reader_next_span": (i64, [vp, p64, p64, pf64, i64, pi32, pi32, i32]),
        "reader_next_encoded": (
            i64, [vp, vp, pi32a, pi32a, pf64, i64, p64, ctypes.POINTER(i64),
                  pi32, pi32],
        ),
        "reader_next_span_i32": (
            i64, [vp, pi32a, pi32a, pf64, i64, i64, pi32, pi32,
                  ctypes.POINTER(i64)],
        ),
        "cuf_create": (vp, []),
        "cuf_destroy": (None, [vp]),
        "cuf_fold_window": (
            i64, [vp, pi32a, pi32a, i64, i64, pi32a, pi32a, pi32a, pi32a,
                  ctypes.POINTER(i64)],
        ),
        "cuf_fold_group": (
            i64, [vp, pi32a, pi32a, p64, i64, i64, pi32a, pi32a, pi32a,
                  pi32a, p64, p64, pi32a, pi32a, p64, ctypes.POINTER(i64)],
        ),
        "cuf_flatten": (None, [vp, pi32a, i64]),
        "cuf_load": (i64, [vp, pi32a, i64]),
        "wprep_create": (vp, []),
        "wprep_destroy": (None, [vp]),
        "wprep_run": (i64, [vp, pi32a, pi32a, i64, i64, pi32a, pi32a, pi32a]),
        "vbitmap_create": (vp, []),
        "vbitmap_destroy": (None, [vp]),
        "vbitmap_novel2": (i64, [vp, pi32a, pi32a, i64]),
        "parse_edge_lines": (i64, [ctypes.c_char_p, i64, p64, p64, pf64, i64, pi32,
                                   ctypes.POINTER(i64)]),
        "decode_edge_frame": (i64, [ctypes.c_char_p, i64, i64, i32, i32, p64, p64, pf64]),
    }
    for name, (restype, argtypes) in sigs.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes


def _load() -> Optional[ctypes.CDLL]:
    """Build (once) and load the library; None where it cannot be built
    (:data:`BUILD_ERROR` says why)."""
    global _lib, _lib_failed, BUILD_ERROR
    if _lib is not None or _lib_failed:
        return _lib
    with _lock:
        if _lib is not None or _lib_failed:
            return _lib
        try:
            so = library_path()
            if not os.path.exists(so):
                _build(so)
            lib = ctypes.CDLL(so)
            _declare(lib)
            _lib = lib
        except (OSError, RuntimeError, AttributeError) as e:
            BUILD_ERROR = str(e)
            _lib_failed = True
    return _lib


def native_available() -> bool:
    """True when the native library built and loaded."""
    return _load() is not None


def parse_edge_file(path: str) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]:
    """Parse a whole edge-list file into ``(src, dst, val|None)`` columns.

    A third column (value, timestamp, or a ``+``/``-`` flag as +-1.0) is
    returned when present."""
    lib = _load()
    if lib is None:
        return _parse_python(path)
    srcs, dsts, vals = [], [], []
    any_val = False
    for s, d, v in iter_edge_chunks(path, chunk_edges=1 << 22):
        srcs.append(s)
        dsts.append(d)
        vals.append(v)
        any_val = any_val or v is not None
    if not srcs:
        return np.zeros(0, np.int64), np.zeros(0, np.int64), None
    src = np.concatenate(srcs)
    dst = np.concatenate(dsts)
    if not any_val:
        return src, dst, None
    val = np.concatenate(
        [np.zeros(len(s), np.float64) if v is None else v
         for s, v in zip(srcs, vals)]
    )
    return src, dst, val


def _spans(lib, path: str, chunk_edges: int, next_span):
    """The chunked read loop shared by the parsers: ``next_span(handle,
    cap, at_eof)`` parses one byte-budgeted span, sets ``at_eof`` at the end
    of the file and returns ``(got, chunk)``."""
    budget = min(max(chunk_edges * 20, 4096), 1 << 28)
    cap = budget // 4 + 64
    handle = lib.reader_open(path.encode(), budget)
    if not handle:
        raise IOError(f"cannot read {path}")
    try:
        at_eof = ctypes.c_int32(0)
        while True:
            prev = lib.reader_offset(handle)
            got, chunk = next_span(handle, cap, at_eof)
            if got < 0:
                raise IOError(f"cannot read {path}")
            if got:
                yield chunk
            if at_eof.value:
                return
            # a span of comments/blanks moves the offset; no progress
            # means one line longer than the byte budget
            if got == 0 and lib.reader_offset(handle) == prev:
                raise IOError(
                    f"{path}: line at byte {prev} exceeds the span read budget"
                )
    finally:
        lib.reader_close(handle)


def iter_edge_chunks(
    path: str, chunk_edges: int = 1 << 20, threads: Optional[int] = None
) -> Iterator[Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]]:
    """Stream ``(src, dst, val|None)`` int64 column chunks from a file.

    Chunk boundaries are byte-budgeted (``chunk_edges`` times an average
    line length), so a chunk holds about ``chunk_edges`` edges; windows
    are cut downstream. Each span is parsed by ``threads`` workers
    (default: every core)."""
    lib = _load()
    if lib is None:
        src, dst, val = _parse_python(path)
        for a in range(0, len(src), chunk_edges):
            b = a + chunk_edges
            yield src[a:b], dst[a:b], None if val is None else val[a:b]
        return
    if threads is None:
        threads = os.cpu_count() or 1
    bufs = {}
    has_val = ctypes.c_int32(0)

    def next_span(handle, cap, at_eof):
        if not bufs:
            bufs.update(src=np.empty(cap, np.int64), dst=np.empty(cap, np.int64),
                        val=np.empty(cap, np.float64))
        got = lib.reader_next_span(
            handle, bufs["src"], bufs["dst"], bufs["val"], cap,
            ctypes.byref(has_val), ctypes.byref(at_eof), threads,
        )
        return got, (
            bufs["src"][:got].copy(), bufs["dst"][:got].copy(),
            bufs["val"][:got].copy() if has_val.value else None,
        )

    yield from _spans(lib, path, chunk_edges, next_span)


def iter_edge_chunks_i32(
    path: str, chunk_edges: int = 1 << 20, id_bound: int = 0
) -> Iterator[Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]]:
    """Like :func:`iter_edge_chunks` with int32 endpoint columns (dense-id
    corpora). Raises ValueError when an id falls outside ``[0,
    id_bound)`` (outside int32 when ``id_bound`` is 0)."""
    lib = _load()
    hi = id_bound if id_bound else np.iinfo(np.int32).max
    if lib is None:
        for s, d, v in iter_edge_chunks(path, chunk_edges):
            if len(s) and (
                int(s.min()) < 0 or int(s.max()) >= hi
                or int(d.min()) < 0 or int(d.max()) >= hi
            ):
                raise ValueError(
                    f"{path}: raw id outside [0, {hi}) — not a dense-id corpus"
                )
            yield s.astype(np.int32), d.astype(np.int32), v
        return
    bufs = {}
    has_val = ctypes.c_int32(0)
    oob = ctypes.c_int64(0)

    def next_span(handle, cap, at_eof):
        if not bufs:
            bufs.update(src=np.empty(cap, np.int32), dst=np.empty(cap, np.int32),
                        val=np.empty(cap, np.float64))
        got = lib.reader_next_span_i32(
            handle, bufs["src"], bufs["dst"], bufs["val"], cap, id_bound,
            ctypes.byref(has_val), ctypes.byref(at_eof), ctypes.byref(oob),
        )
        if oob.value:
            raise ValueError(
                f"{path}: {oob.value} ids outside [0, {hi}) — not a dense-id "
                "corpus"
            )
        return got, (
            bufs["src"][:got].copy(), bufs["dst"][:got].copy(),
            bufs["val"][:got].copy() if has_val.value else None,
        )

    yield from _spans(lib, path, chunk_edges, next_span)


def write_edge_file(
    path: str,
    src: np.ndarray,
    dst: np.ndarray,
    append: bool = False,
    threads: Optional[int] = None,
) -> None:
    """Write a tab-separated edge list (corpus synthesis at scale);
    non-negative ids only."""
    src = np.ascontiguousarray(src, np.int64)
    dst = np.ascontiguousarray(dst, np.int64)
    lib = _load()
    if lib is None:
        with open(path, "a" if append else "w") as f:
            for s, d in zip(src.tolist(), dst.tolist()):
                f.write(f"{s}\t{d}\n")
        return
    if threads is None:
        threads = os.cpu_count() or 1
    rc = lib.write_edge_file(
        path.encode(), src, dst, src.size, 1 if append else 0, threads
    )
    if rc != 0:
        raise IOError(f"cannot write {path}")


def cc_baseline(
    src: np.ndarray,
    dst: np.ndarray,
    window: int,
    partitions: Optional[int] = None,
) -> Tuple[float, int]:
    """Run the compiled streaming-CC baseline (per-partition window folds
    into hash-map union-find plus a sequential merge, the reference
    system's execution model in native code). Returns ``(seconds,
    component_count)``; raises without the native library."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native library unavailable: {BUILD_ERROR}")
    src = np.ascontiguousarray(src, np.int64)
    dst = np.ascontiguousarray(dst, np.int64)
    if partitions is None:
        partitions = min(8, os.cpu_count() or 1)
    comps = ctypes.c_int64(0)
    ns = lib.cc_baseline_run(
        src, dst, src.size, window, partitions, ctypes.byref(comps)
    )
    return ns / 1e9, int(comps.value)


_I64_MAX = 2**63 - 1
_LINE_RE = None


def _saturate_i64(token: str) -> int:
    """Signed decimal with the C parser's saturation: |value| clamps to
    INT64_MAX before the sign is applied."""
    neg = token.startswith("-")
    mag = min(int(token.lstrip("+-")), _I64_MAX)
    return -mag if neg else mag


def _parse_text_lines(lines):
    """The numpy-fallback line grammar, shared by the file and the socket
    paths; mirrors the C grammar: two integers separated by space/tab/comma
    runs, trailing junk after a number tolerated, an unparseable third
    column leaves the edge valid with value 0. Returns ``(src, dst,
    val|None, malformed)``, ``malformed`` counting non-blank, non-comment
    lines the grammar rejected."""
    global _LINE_RE
    import re

    if _LINE_RE is None:
        _LINE_RE = (
            re.compile(r"^[ \t,\r]*([+-]?\d+)[ \t,\r]+([+-]?\d+)(.*)$"),
            re.compile(r"^[+-]?(?:\d+\.?\d*|\.\d+)(?:[eE][+-]?\d+)?"),
        )
    line_re, float_re = _LINE_RE
    srcs, dsts, vals = [], [], []
    any_val = False
    malformed = 0
    for line in lines:
        stripped = line.lstrip(" \t,\r")
        if not stripped or stripped[0] in "#%\n":
            continue
        m = line_re.match(line.rstrip("\n"))
        if not m:
            malformed += 1
            continue
        srcs.append(_saturate_i64(m.group(1)))
        dsts.append(_saturate_i64(m.group(2)))
        rest = m.group(3).lstrip(" \t,\r")
        v = 0.0
        if rest:
            c0, follows = rest[0], rest[1:2]
            if c0 in "+-" and follows in ("", " ", "\t", "\r"):
                v = 1.0 if c0 == "+" else -1.0
                any_val = True
            else:
                fm = float_re.match(rest)
                if fm:
                    v = float(fm.group(0))
                    any_val = True
        vals.append(v)
    return (
        np.asarray(srcs, np.int64),
        np.asarray(dsts, np.int64),
        np.asarray(vals, np.float64) if any_val else None,
        malformed,
    )


def _parse_python(path: str):
    """Numpy fallback of the file parser without a compiler."""
    with open(path) as f:
        src, dst, val, _ = _parse_text_lines(f)
    return src, dst, val


def parse_edge_lines(data: bytes) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray], int]:
    """Parse a buffer of COMPLETE text edge lines into ``(src, dst,
    val|None, malformed)``: the socket source's one call per ``recv``. The
    grammar is the file parser's, so a socket stream and the same bytes on
    disk parse identically; ``malformed`` counts non-blank, non-comment
    lines the grammar rejected. ``data`` need not end with a newline."""
    lib = _load()
    if lib is None:
        return _parse_text_lines(data.decode("latin-1").split("\n"))
    cap = data.count(b"\n") + 2
    src = np.empty(cap, np.int64)
    dst = np.empty(cap, np.int64)
    val = np.empty(cap, np.float64)
    has_val = ctypes.c_int32(0)
    malformed = ctypes.c_int64(0)
    # newline-terminate the final line + zero padding for the word loads
    buf = data + b"\n" + bytes(64)
    got = lib.parse_edge_lines(buf, len(data) + 1, src, dst, val, cap,
                               ctypes.byref(has_val), ctypes.byref(malformed))
    return (src[:got].copy(), dst[:got].copy(),
            val[:got].copy() if has_val.value else None, int(malformed.value))


def decode_edge_frame(
    payload: bytes, n_edges: int, wide: bool, has_val: bool
) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]:
    """Decode one GSEW frame payload (``core/ingest.py``) into ``(src i64,
    dst i64, val f64|None)``: one native call per frame (geometry check,
    int32 widen, copy into fresh buffers). The numpy ``frombuffer``
    fallback runs only where the library could not be built. Raises
    ``ValueError`` when the payload size disagrees with the declared
    geometry (the caller counts a malformed frame)."""
    n = int(n_edges)
    isz = 8 if wide else 4
    want = n * isz * 2 + (8 * n if has_val else 0)
    lib = _load()
    if lib is None or n == 0:
        if len(payload) != want:
            raise ValueError(
                f"frame payload is {len(payload)} bytes; declared geometry "
                f"(n={n}, wide={bool(wide)}, val={bool(has_val)}) wants {want}")
        dt = np.int64 if wide else np.int32
        src = np.frombuffer(payload, dt, n, 0).astype(np.int64)
        dst = np.frombuffer(payload, dt, n, n * isz).astype(np.int64)
        val = np.frombuffer(payload, np.float64, n, 2 * n * isz).copy() if has_val else None
        return src, dst, val
    src = np.empty(n, np.int64)
    dst = np.empty(n, np.int64)
    val = np.empty(n if has_val else 0, np.float64)
    rc = lib.decode_edge_frame(payload, len(payload), n, 1 if wide else 0,
                               1 if has_val else 0, src, dst, val)
    if rc != 0:
        raise ValueError(
            f"frame payload is {len(payload)} bytes; declared geometry "
            f"(n={n}, wide={bool(wide)}, val={bool(has_val)}) wants {want}")
    return src, dst, (val if has_val else None)


class _Handle:
    """A native object owned by one Python object: created with
    ``<prefix>_create`` and destroyed with ``<prefix>_destroy``."""

    _prefix = ""

    def __init__(self):
        lib = _load()
        if lib is None:
            raise RuntimeError(f"native library unavailable: {BUILD_ERROR}")
        self._lib = lib
        self._h = getattr(lib, self._prefix + "_create")()
        if not self._h:
            raise RuntimeError(f"{self._prefix}_create failed")

    def __del__(self):
        lib = getattr(self, "_lib", None)
        h = getattr(self, "_h", None)
        if lib is not None and h:
            getattr(lib, self._prefix + "_destroy")(h)


class CompactUnionFind(_Handle):
    """Incremental union-find over compact int32 ids: the host CC carry
    (``ingest.cpp: cuf_*``).

    ``fold(src, dst, vcap)`` unions one window and returns ``(touched,
    roots, changed, changed_roots)``: the window's distinct endpoints with
    their post-window roots, plus every root this window demoted with its
    post-window root, which is the scatter a pointer-forest mirror needs.
    Raises RuntimeError at construction without the native library."""

    _prefix = "cuf"

    def __init__(self):
        super().__init__()
        self._tbuf = np.zeros(1024, np.int32)
        self._rbuf = np.zeros(1024, np.int32)
        self._cbuf = np.zeros(1024, np.int32)
        self._crbuf = np.zeros(1024, np.int32)

    def fold(self, src: np.ndarray, dst: np.ndarray, vcap: int):
        src = np.ascontiguousarray(src, np.int32)
        dst = np.ascontiguousarray(dst, np.int32)
        n = src.size
        if self._tbuf.size < 2 * n:
            self._tbuf = np.zeros(2 * n, np.int32)
            self._rbuf = np.zeros(2 * n, np.int32)
        if self._cbuf.size < max(n, 1):
            self._cbuf = np.zeros(n, np.int32)
            self._crbuf = np.zeros(n, np.int32)
        nc = ctypes.c_int64(0)
        nt = self._lib.cuf_fold_window(
            self._h, src, dst, n, int(vcap),
            self._tbuf, self._rbuf, self._cbuf, self._crbuf,
            ctypes.byref(nc),
        )
        if nt < 0:
            raise ValueError("edge ids out of range for vcap")
        nc = nc.value
        return (
            self._tbuf[:nt].copy(), self._rbuf[:nt].copy(),
            self._cbuf[:nc].copy(), self._crbuf[:nc].copy(),
        )

    def fold_group(self, cols, vcap: int):
        """Union K windows in ONE native call (``cuf_fold_group``): the
        host carry's superbatch. ``cols`` is a list of per-window column
        tuples ``(src, dst, ...)``.

        Returns ``(windows, group_ids, group_roots, gt_counts)``:
        ``windows`` holds per-window ``(touched, roots, changed,
        changed_roots)`` views into fresh group buffers;
        ``group_ids``/``group_roots`` is the deduplicated union of every id
        the group re-rooted with its post-group root, group-unique touched
        ids first (window first-seen order, per-window counts in
        ``gt_counts``) and the demoted roots after."""
        k = len(cols)
        offsets = np.zeros(k + 1, np.int64)
        for i, c in enumerate(cols):
            offsets[i + 1] = offsets[i] + len(c[0])
        n = int(offsets[-1])
        src = np.empty(n, np.int32)
        dst = np.empty(n, np.int32)
        for i, c in enumerate(cols):
            src[offsets[i]:offsets[i + 1]] = c[0]
            dst[offsets[i]:offsets[i + 1]] = c[1]
        tbuf = np.empty(2 * n, np.int32)
        rbuf = np.empty(2 * n, np.int32)
        cbuf = np.empty(max(n, 1), np.int32)
        crbuf = np.empty(max(n, 1), np.int32)
        gid = np.empty(max(3 * n, 1), np.int32)
        grt = np.empty(max(3 * n, 1), np.int32)
        tcnt = np.zeros(k, np.int64)
        ccnt = np.zeros(k, np.int64)
        gtcnt = np.zeros(k, np.int64)
        ngrp = ctypes.c_int64(0)
        tt = self._lib.cuf_fold_group(
            self._h, src, dst, offsets, k, int(vcap),
            tbuf, rbuf, cbuf, crbuf, tcnt, ccnt, gid, grt, gtcnt,
            ctypes.byref(ngrp),
        )
        if tt < 0:
            raise ValueError("edge ids out of range for vcap")
        wins = []
        t0 = c0 = 0
        for w in range(k):
            t1 = t0 + int(tcnt[w])
            c1 = c0 + int(ccnt[w])
            wins.append((tbuf[t0:t1], rbuf[t0:t1], cbuf[c0:c1], crbuf[c0:c1]))
            t0, c0 = t1, c1
        ng = ngrp.value
        return wins, gid[:ng], grt[:ng], gtcnt

    def flatten(self, vcap: int) -> np.ndarray:
        out = np.zeros(vcap, np.int32)
        self._lib.cuf_flatten(self._h, out, vcap)
        return out

    def load(self, labels: np.ndarray) -> None:
        labels = np.ascontiguousarray(labels, np.int32)
        if self._lib.cuf_load(self._h, labels, labels.size) != 0:
            raise ValueError("labels are not a min-rooted forest")


class NativeWindowPrep(_Handle):
    """Single-pass touched set and local renumbering for the forest CC
    carry (``ingest.cpp: wprep_*``): epoch-stamped, no clearing, its cost
    scales with the window alone. ``run(src, dst, vcap)`` returns
    ``(tids, lu, lv)`` with the touched ids in arrival order. Raises
    RuntimeError at construction without the native library."""

    _prefix = "wprep"

    def __init__(self):
        super().__init__()
        self._tbuf = np.zeros(1024, np.int32)
        self._lu = np.zeros(512, np.int32)
        self._lv = np.zeros(512, np.int32)

    def run(self, src: np.ndarray, dst: np.ndarray, vcap: int):
        src = np.ascontiguousarray(src, np.int32)
        dst = np.ascontiguousarray(dst, np.int32)
        n = src.size
        if self._tbuf.size < 2 * n:
            self._tbuf = np.zeros(max(2 * n, 1024), np.int32)
        if self._lu.size < max(n, 1):
            self._lu = np.zeros(n, np.int32)
            self._lv = np.zeros(n, np.int32)
        t = self._lib.wprep_run(
            self._h, src, dst, n, int(vcap), self._tbuf, self._lu, self._lv,
        )
        if t < 0:
            raise ValueError("edge ids out of range for vcap")
        return self._tbuf[:t].copy(), self._lu[:n].copy(), self._lv[:n].copy()


class NativeEncoder(_Handle):
    """C++ first-seen id compactor (the ``VertexDict.encode`` hot path).

    ``encode(raw)`` returns ``(idx[i32], novel_raw[i64])``: compact ids for
    every input and the raw ids never seen before, in first-appearance
    order. ``VertexDict`` keeps its numpy path where this raises."""

    _prefix = "encoder"

    def __init__(self):
        super().__init__()
        # ctypes calls release the GIL; without this lock an encode on a
        # prefetch thread could rehash the table under a concurrent lookup
        self._mu = threading.Lock()

    def encode(self, raw: np.ndarray):
        raw = np.ascontiguousarray(raw, np.int64)
        idx = np.empty(raw.size, np.int32)
        novel = np.empty(raw.size, np.int64)
        with self._mu:
            n_novel = self._lib.encoder_encode(self._h, raw, raw.size, idx, novel)
        return idx, novel[:n_novel]

    def encode_pair(self, a: np.ndarray, b: np.ndarray):
        """Encode edge columns as the interleaved a0, b0, a1, b1, ...
        sequence (first-seen order by edge arrival) without the copy."""
        a = np.ascontiguousarray(a, np.int64)
        b = np.ascontiguousarray(b, np.int64)
        ia = np.empty(a.size, np.int32)
        ib = np.empty(b.size, np.int32)
        novel = np.empty(a.size + b.size, np.int64)
        with self._mu:
            n_novel = self._lib.encoder_encode2(
                self._h, a, b, a.size, ia, ib, novel
            )
        return ia, ib, novel[:n_novel]

    def parse_encode_chunks(self, path: str, chunk_edges: int = 1 << 20):
        """Fused file ingest: yield ``(src_idx, dst_idx, val|None,
        novel_raw)`` chunks whose endpoints are already compact ids; the
        bytes are parsed and hashed in one C pass."""
        lib = self._lib
        bufs = {}
        n_novel = ctypes.c_int64(0)
        has_val = ctypes.c_int32(0)

        def next_span(handle, cap, at_eof):
            if not bufs:
                bufs.update(
                    src=np.empty(cap, np.int32), dst=np.empty(cap, np.int32),
                    val=np.empty(cap, np.float64),
                    novel=np.empty(2 * cap, np.int64),
                )
            with self._mu:
                got = lib.reader_next_encoded(
                    handle, self._h, bufs["src"], bufs["dst"], bufs["val"],
                    cap, bufs["novel"], ctypes.byref(n_novel),
                    ctypes.byref(has_val), ctypes.byref(at_eof),
                )
            return got, (
                bufs["src"][:got].copy(), bufs["dst"][:got].copy(),
                bufs["val"][:got].copy() if has_val.value else None,
                bufs["novel"][: n_novel.value].copy(),
            )

        yield from _spans(lib, path, chunk_edges, next_span)

    def lookup(self, k: int):
        with self._mu:
            v = self._lib.encoder_lookup(self._h, int(k))
        return None if v < 0 else int(v)

    def lookup_batch(self, ks: np.ndarray) -> np.ndarray:
        """Batched query without insert: int32 compact ids, -1 for unseen."""
        ks = np.ascontiguousarray(ks, np.int64)
        out = np.empty(ks.size, np.int32)
        with self._mu:
            self._lib.encoder_lookup_batch(self._h, ks, ks.size, out)
        return out

    def __len__(self) -> int:
        return int(self._lib.encoder_size(self._h))


class NoveltyBitmap:
    """First-seen counter over the non-negative int32 id space
    (``ingest.cpp: vbitmap_*``).

    ``novel2(src, dst)`` records both endpoint columns (interleaved arrival
    order) and returns how many ids were never seen before: EXACT
    distinctness, which lets the device-encode ingest grow its on-device
    dictionary from host knowledge alone instead of reading a count back
    from the card. Native: a lazily committed 2^31-bit anonymous mmap.
    Without the native library: a bit-packed numpy map grown to the
    observed id range."""

    def __init__(self):
        self._lib = _load()
        self._h = self._lib.vbitmap_create() if self._lib is not None else None
        if self._lib is not None and not self._h:
            self._lib = None  # mmap failed: the numpy map
        self._bits: Optional[np.ndarray] = None

    def novel2(self, src: np.ndarray, dst: np.ndarray) -> int:
        src = np.ascontiguousarray(src, np.int32)
        dst = np.ascontiguousarray(dst, np.int32)
        if self._lib is not None:
            return int(self._lib.vbitmap_novel2(self._h, src, dst, src.size))
        ids = np.stack([src, dst], axis=1).ravel()
        ids = ids[ids >= 0]
        if ids.size == 0:
            return 0
        uniq = np.unique(ids).astype(np.int64)
        hi = (int(uniq[-1]) >> 3) + 1
        if self._bits is None or self._bits.size < hi:
            grown = np.zeros(max(hi, 1024), np.uint8)
            if self._bits is not None:
                grown[: self._bits.size] = self._bits
            self._bits = grown
        cell = uniq >> 3
        mask = np.uint8(1) << (uniq & 7).astype(np.uint8)
        fresh = (self._bits[cell] & mask) == 0
        np.bitwise_or.at(self._bits, cell[fresh], mask[fresh])
        return int(fresh.sum())

    def __del__(self):
        lib = getattr(self, "_lib", None)
        h = getattr(self, "_h", None)
        if lib is not None and h:
            lib.vbitmap_destroy(h)
