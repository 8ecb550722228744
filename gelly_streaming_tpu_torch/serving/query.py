"""Typed point queries + the batched vectorized query engine (the port's
copy of ``gelly_streaming_tpu/serving/query.py``).

A serving tier dies by per-query host loops: 10k concurrent
``connected(u, v)`` queries must not become 10k pointer chases in Python
or 10k device dispatches. The :class:`QueryEngine` answers a whole batch
per query class with ONE vectorized lookup:

- CC queries gather the batch's endpoints out of the published pointer
  forest and chase ONLY those lanes to their roots (a batch-sized loop of
  gathers, the same shape as ``summaries/forest.py:chase_and_group``,
  sized by the batch, not the vertex capacity). Flat labels are a valid
  (depth-1) forest, so the one step serves every CC carry and restored
  checkpoints alike.
- Degree / rank queries are one table gather.
- Component-size queries canonicalize the forest once per snapshot
  version (cached) and count members per root, then answer any number
  of batches from the cached size table.

The reference's four jitted device steps (``_batch_roots``, ``_gather``,
``_gather_sizes``, ``_component_size_table``) are torch operations here,
by the translation rules of ``summaries/forest.py``: the root chase's
``lax.while_loop`` is a host read per turn (counted in
:data:`HOST_READS`, with each download of a batch's answers), the
members-per-root ``.at[lab].add(1)`` is an ``index_add`` (no
``bincount`` on a card), and the canonicalization is the port's
``resolve_flat``. The reference pads batches to power-of-two buckets only
to bound its jit signatures; the port does not pad (the answers are
equal).

Two execution paths, picked per TABLE (``prefer_host="auto"``):

- **device** (a CUDA tensor): the batch steps run where the payload
  lives; only the batch-sized ids go up and the batch-sized result comes
  back.
- **host** (numpy, or a CPU tensor): the engine materializes ONE host
  copy of the payload table per snapshot version and answers with the
  same whole-batch vectorized chase in numpy — never per-query loops.

``prefer_host=True`` pins the host path (a CUDA table is downloaded once
per version: ``.cpu()`` on the current stream waits for every window
queued ahead of it); ``prefer_host=False`` pins the torch steps, on the
table's own device (CPU tensors included, which is how the CPU tests run
them).

Query ids are RAW vertex ids (what a client knows); the engine maps them
through the payload's vertex dictionary without inserting — unseen
vertices answer like the reference's ``DisjointSet`` would for a vertex
it never saw: connected only to itself, degree 0, rank 0.0, component
size 0.
"""

from __future__ import annotations

import base64
import binascii
import pickle
import threading
from collections import deque
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..obs.registry import get_registry
from ..summaries.forest import resolve_flat, resolve_flat_host
from .snapshot_store import PublishedSnapshot

#: device -> host reads made by the engine's torch steps: each turn of the
#: batch root chase and of the size table's canonicalization, and each
#: download of a batch's answers; callers zero it and read it. Only the
#: engine adds to it (under ``_READS_LOCK``: a server's query worker and
#: direct callers may answer at once), never the ingest thread's fold.
HOST_READS = 0
_READS_LOCK = threading.Lock()


# --------------------------------------------------------------------- #
# Query + answer records
# --------------------------------------------------------------------- #
class Query:
    """Marker base for point queries (raw vertex ids)."""

    __slots__ = ()


@dataclass(frozen=True)
class ConnectedQuery(Query):
    """Are ``u`` and ``v`` in one component? (``connected(u, v)``)."""

    u: int
    v: int


@dataclass(frozen=True)
class DegreeQuery(Query):
    """Current degree of ``v``."""

    v: int


@dataclass(frozen=True)
class RankQuery(Query):
    """Current PageRank mass of ``v``."""

    v: int


@dataclass(frozen=True)
class ComponentSizeQuery(Query):
    """Size of ``v``'s component (0 for a never-seen vertex)."""

    v: int


@dataclass(frozen=True)
class SummaryPullQuery(Query):
    """Pull this snapshot's CC forest as a mergeable summary (the
    sharded-serving router's cross-shard union input): per seen slot,
    the RAW vertex id and its component root's RAW id, as packed
    little-endian int64 columns (base64 in the JSON answer value).
    RAW-id space is the join key — per-shard compact ids never leave
    their shard. O(vcap) per snapshot version, cached by the engine, so
    any number of pulls per version cost one canonicalization.

    ``since_version`` is the pull protocol's v2 field: a puller that
    already holds this shard's table at that version asks for only the
    rows whose ROOT assignment changed since then (a ``kind="delta"``
    reply, O(changed rows) on the wire). ``-1`` (the v1 shape — old
    peers never set the field) always answers the full table; a
    ``since_version`` older than the engine's bounded delta ring
    degrades HONESTLY to a full reply tagged with why."""

    since_version: int = -1


@dataclass(frozen=True)
class BipartiteQuery(Query):
    """Is the streamed graph (still) bipartite? Graph-global, like
    :class:`SummaryPullQuery`. The answer value is a typed dict::

        {"bipartite": bool, "witness": raw_id | None}

    ``witness`` is the smallest RAW vertex id whose two signed-cover
    nodes share a component — a vertex on an odd cycle, the conflict
    witness — when the graph is non-bipartite, else None. Answered from
    the published cover forest (``summaries/candidates.py`` layout:
    cover node (v,+) = v, (v,-) = v + vcap in a 2*vcap table), so the
    verdict recomputes from the structural truth rather than trusting a
    carried latch. O(vcap) per snapshot version, cached by the engine.
    """

    __slots__ = ()


@dataclass(frozen=True)
class Answer:
    """One query's result, stamped with the snapshot it was answered
    from: ``window`` is that snapshot's window index, ``staleness`` the
    windows-behind-head gap at answer time (0 = answered at the head),
    ``version`` the snapshot's publish version — the monotone counter a
    routing tier keys its cache invalidation on (reply frames carry it,
    so a router learns of shard progress from ordinary answers).
    ``event_ts`` is the snapshot's EVENT-TIME watermark (``-1`` when
    the pipeline carries no event time): next to ``staleness``'s
    windows-behind-head, it answers "how far behind the world" — the
    data's own clock at the moment the served summaries were true.
    ``shard`` and ``boot`` complete the stamp a
    snapshot-pinned transaction needs: which shard answered (``-1``
    for an unsharded replica; the router re-stamps its fan-outs) and
    the answering store's lineage nonce — together with ``version``
    they are the ``(shard, version, boot)`` triple a
    :class:`~gelly_streaming_tpu_torch.serving.txn.TxnContext` pins from
    ordinary replies, with no extra round trip."""

    value: Any
    window: int
    watermark: int
    staleness: int
    version: int = 0
    event_ts: int = -1
    shard: int = -1
    boot: str = ""


# --------------------------------------------------------------------- #
# Pull-doc wire codec (protocol v2: full | delta reply frames)
# --------------------------------------------------------------------- #
#: how many version-to-version delta segments the engine retains; a
#: ``since_version`` older than the ring reaches degrades to a full
#: reply (tagged ``why="stale"``) — the bounded-memory honesty rule
DELTA_RING = 8


class MalformedPull(ValueError):
    """A pull doc that fails decode, carrying WHICH geometry rule broke
    (``kind`` in {type, missing, b64, geometry, tag, base}) so the
    router can count malformed pulls by failure class instead of
    folding them into a generic pull error."""

    def __init__(self, kind: str, msg: str):
        super().__init__(msg)
        self.kind = kind


def _b64_cols(raws: np.ndarray, roots: np.ndarray) -> Tuple[str, str]:
    return (
        base64.b64encode(
            np.ascontiguousarray(raws, np.int64).tobytes()).decode("ascii"),
        base64.b64encode(
            np.ascontiguousarray(roots, np.int64).tobytes()).decode("ascii"),
    )


def encode_pull_doc(
    raws: np.ndarray,
    roots: np.ndarray,
    *,
    kind: str = "full",
    base: Optional[int] = None,
    why: Optional[str] = None,
) -> dict:
    """Pack ``(vertex, root)`` RAW-id columns as a pull reply doc.

    ``kind="full"`` is the whole-table frame (v1 peers decode it
    unchanged: the tag rides an extra dict key they never read);
    ``kind="delta"`` carries only changed rows plus ``base`` — the
    version the rows are a diff AGAINST, which the puller must already
    hold. ``why`` tags a full reply that a delta request degraded into
    (stale ring, no chain yet, puller ahead). Every key written here is
    read back in :func:`decode_pull_doc` (symmetry)."""
    u64, r64 = _b64_cols(raws, roots)
    doc = {"kind": kind, "n": int(len(raws)), "u64": u64, "r64": r64}
    if kind == "delta":
        if base is None:
            raise ValueError("delta pull docs must carry base")
        doc["base"] = int(base)
    if why is not None:
        doc["why"] = str(why)
    return doc


def decode_pull_doc(doc) -> dict:
    """Decode a pull reply into host columns::

        {"kind": "full"|"delta", "n": int,
         "u": int64[n], "r": int64[n], "base": int|None, "why": str|None}

    A doc with NO ``kind`` tag decodes as a full frame — that is the v1
    wire shape, so a v2 puller interops with an old shard by treating
    its replies as full tables and resetting its delta baseline.
    Raises :class:`MalformedPull` (kind-tagged) on any geometry
    mismatch; a decoded frame is safe to merge as-is."""
    if not isinstance(doc, dict):
        raise MalformedPull(
            "type", f"pull answer must be a dict, got {type(doc).__name__}"
        )
    kind = doc.get("kind", "full")
    if kind not in ("full", "delta"):
        raise MalformedPull("tag", f"unknown pull frame kind {kind!r}")
    for k in ("n", "u64", "r64"):
        if k not in doc:
            raise MalformedPull("missing", f"pull doc lacks {k!r}")
    n = doc["n"]
    if not isinstance(n, int) or isinstance(n, bool) or n < 0:
        raise MalformedPull("type", f"pull doc n must be an int >= 0, got {n!r}")
    if not isinstance(doc["u64"], str) or not isinstance(doc["r64"], str):
        raise MalformedPull("type", "pull doc u64/r64 must be base64 strings")
    try:
        ub = base64.b64decode(doc["u64"], validate=True)
        rb = base64.b64decode(doc["r64"], validate=True)
    except (binascii.Error, ValueError) as e:
        raise MalformedPull("b64", f"pull doc columns are not base64: {e}")
    if len(ub) != 8 * n or len(rb) != 8 * n:
        raise MalformedPull(
            "geometry",
            f"pull doc geometry mismatch: n={n} but columns carry "
            f"{len(ub)}/{len(rb)} bytes (want {8 * n})",
        )
    base = doc.get("base")
    if kind == "delta":
        if not isinstance(base, int) or isinstance(base, bool):
            raise MalformedPull(
                "base", f"delta pull doc must carry an int base, got {base!r}"
            )
    why = doc.get("why")
    return {
        "kind": kind,
        "n": n,
        "u": np.frombuffer(ub, np.int64),
        "r": np.frombuffer(rb, np.int64),
        "base": base if kind == "delta" else None,
        "why": str(why) if why is not None else None,
    }


# --------------------------------------------------------------------- #
# The device steps (batch-sized, payload-table-gathering torch operations)
# --------------------------------------------------------------------- #
def _count_read() -> None:
    global HOST_READS
    with _READS_LOCK:
        HOST_READS += 1


def _any_on_host(flags: torch.Tensor) -> bool:
    """A loop condition read to the host (one counted read)."""
    _count_read()
    return bool(flags.any())


def _download(t: torch.Tensor) -> np.ndarray:
    """A batch's answers to the host (one counted read on a card)."""
    if t.is_cuda:
        _count_read()
    return t.cpu().numpy()


def _batch_roots(canon: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Chase a BATCH of start ids to their forest roots. Read-only on
    ``canon``; terminates by the min-root invariant (chains strictly
    decrease). One host read per turn (the reference's
    ``lax.while_loop(jnp.any(canon[r] != r))``)."""
    r = canon[ids.long()]
    while True:
        nxt = canon[r.long()]
        if not _any_on_host(nxt != r):
            return r
        r = nxt


def _gather(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    return table[ids.long()]


def _gather_sizes(lab: torch.Tensor, sizes: torch.Tensor,
                  ids: torch.Tensor) -> torch.Tensor:
    """Fused root-resolve + size lookup over a canonical table: only the
    batch-sized result crosses the link."""
    return sizes[lab[ids.long()].long()]


def _component_size_table(canon: torch.Tensor):
    """Canonicalize the whole forest once and count members per root.
    O(vcap) — run once per snapshot version, cached by the engine. The
    canonicalization IS ``summaries/forest.py:resolve_flat`` (its turns
    count here, through its ``read_flags``); the count is an
    ``index_add`` (the reference's ``.at[lab].add(1)``)."""
    lab = resolve_flat(canon, read_flags=_any_on_host)
    sizes = torch.zeros(canon.shape[0], dtype=torch.int32,
                        device=canon.device)
    sizes.index_add_(0, lab.long(), torch.ones_like(lab))
    return lab, sizes


def _to_numpy(x) -> np.ndarray:
    """A payload array as host numpy (a tensor is downloaded: on a card
    ``.cpu()`` waits on the current stream)."""
    if isinstance(x, torch.Tensor):
        return _download(x.detach())
    return np.asarray(x)


def _as_tensor(x) -> torch.Tensor:
    """A payload array as a tensor on its own device (numpy tables become
    CPU tensors sharing their memory)."""
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(
        np.asarray(x))


def _lookup_batch(vdict, raw: np.ndarray) -> np.ndarray:
    """Raw -> compact ids WITHOUT inserting; -1 marks unseen vertices.
    Uses the dict's vectorized ``lookup_batch`` when it exists, else the
    per-id ``lookup``."""
    raw = np.asarray(raw, np.int64)
    batch = getattr(vdict, "lookup_batch", None)
    if batch is not None:
        return batch(raw)
    lookup = getattr(vdict, "lookup", None)
    if lookup is None:
        raise TypeError(
            f"payload vertex dict {type(vdict).__name__} supports neither "
            "lookup_batch nor lookup"
        )
    out = np.empty(len(raw), np.int32)
    for i, r in enumerate(raw.tolist()):
        c = lookup(r)
        out[i] = -1 if c is None else c
    return out


def _host_batch_roots(lab: np.ndarray, ids: np.ndarray) -> np.ndarray:
    """Whole-batch vectorized root chase on a host table (the CPU-backend
    fast path; same contract as :func:`_batch_roots`). The host path
    keeps the reference's numpy steps rather than the torch steps on CPU
    tensors: ``chip_smoke.py:_host_query_forms`` times both, and the torch
    chase takes several times as long."""
    r = lab[ids]
    while True:
        nxt = lab[r]
        if np.array_equal(nxt, r):
            return r
        r = nxt


class QueryEngine:
    """Answers homogeneous query batches against one snapshot.

    Stateless except for per-snapshot-version caches: the derived
    component-size table, and (host path) one host materialization of
    each payload table — the O(vcap) costs; everything else is
    batch-sized. One engine instance per server.

    ``prefer_host='auto'`` (default) picks the host path for host tables
    (numpy, CPU tensors) and the torch steps for CUDA tables, per payload
    table (rationale in the module docstring); pass True/False to
    pin."""

    #: payload key each query class reads (also the capability probe:
    #: a snapshot serves a query class iff the key is present)
    PAYLOAD_KEYS = {
        ConnectedQuery: "labels",
        ComponentSizeQuery: "labels",
        SummaryPullQuery: "labels",
        DegreeQuery: "deg",
        RankQuery: "ranks",
        BipartiteQuery: "cover",
    }

    def __init__(self, prefer_host="auto"):
        if prefer_host != "auto":
            prefer_host = bool(prefer_host)
        self.prefer_host = prefer_host
        self._size_cache: Tuple[Optional[tuple], Any, Any] = (
            None, None, None,
        )
        self._host_cache: dict = {}  # (epoch, version, payload key) -> np
        # pull docs cache: one dict per (epoch, version), keyed by the
        # effective since_version (-1 = full) — several routers at
        # different baselines share one engine without thrashing
        self._pull_key: Optional[tuple] = None
        self._pull_docs: dict = {}
        # historical (pinned) pull docs: a bounded side cache so
        # transactional merges never thrash the live head's cache
        self._hist_docs: dict = {}
        self._bp_cache: Tuple[Optional[tuple], Optional[dict]] = (
            None, None,
        )
        # delta chain: the canonical table at the last pulled version
        # plus a bounded ring of version-to-version changed-row segments
        self._chain_epoch: Optional[int] = None
        self._chain_version: int = -1
        self._chain_lab: Optional[np.ndarray] = None
        self._chain_n: int = 0
        self._ring: deque = deque(maxlen=DELTA_RING)
        # the chain is touched from the server worker (summary_pull)
        # AND, when a PullRingMirror is attached, from the ingest
        # thread's publish listener (chain_sync) — hence the lock
        self._chain_lock = threading.Lock()

    # -- table access (per-version host cache on the host path) -------- #
    def _on_host(self, table) -> bool:
        """The path for one payload table: pinned, or (``"auto"``) the
        host path unless the table is a CUDA tensor."""
        if self.prefer_host == "auto":
            return not (isinstance(table, torch.Tensor) and table.is_cuda)
        return self.prefer_host

    def _host_table(self, snap: PublishedSnapshot, key: str) -> np.ndarray:
        """The payload table as host numpy, cached per snapshot
        ``(epoch, version)`` — only the newest version is hot."""
        ck = (snap.epoch, snap.version, key)
        cached = self._host_cache.get(ck)
        if cached is None:
            cached = _to_numpy(snap.payload[key])
            self._host_cache.clear()
            self._host_cache[ck] = cached
        return cached

    def _table(self, snap: PublishedSnapshot, key: str):
        """The payload table, as a host array (host path, cached per
        snapshot (epoch, version)) or a tensor on its own device (the
        torch steps)."""
        table = snap.payload[key]
        if self._on_host(table):
            return self._host_table(snap, key)
        return _as_tensor(table)

    def _roots(self, table, ids: np.ndarray) -> np.ndarray:
        if isinstance(table, np.ndarray):
            return _host_batch_roots(table, ids)
        return _download(_batch_roots(
            table, torch.as_tensor(ids, device=table.device)))

    # -- per-class batch kernels --------------------------------------- #
    def connected(
        self, snap: PublishedSnapshot, us: np.ndarray, vs: np.ndarray
    ) -> np.ndarray:
        """bool[n]: same component per (u, v) pair, one batched chase for
        all 2n endpoints."""
        canon = self._table(snap, "labels")
        vdict = snap.payload["vdict"]
        # ONE lookup for all 2n endpoints: the batched native lookup
        # takes the encoder mutex once per call, so separate u/v calls
        # would double lock contention with the ingest thread
        both = _lookup_batch(
            vdict, np.concatenate([np.asarray(us), np.asarray(vs)])
        )
        vcap = int(canon.shape[0])
        valid = (both >= 0) & (both < vcap)
        roots = self._roots(canon, np.where(valid, both, 0))
        n = len(us)
        ru, rv = roots[:n], roots[n:]
        ok = valid[:n] & valid[n:]
        # an unseen vertex is its own singleton: connected only to itself
        return np.where(ok, ru == rv, np.asarray(us) == np.asarray(vs))

    def component_size(
        self, snap: PublishedSnapshot, vs: np.ndarray
    ) -> np.ndarray:
        """int[n] component sizes; the size table derives once per
        snapshot version. Sizes count COMPACT ids sharing the root —
        vertices the stream has actually seen (plus the queried vertex's
        own singleton when it is seen but never merged)."""
        canon = self._table(snap, "labels")
        host = isinstance(canon, np.ndarray)
        vdict = snap.payload["vdict"]
        cv = _lookup_batch(vdict, vs)
        key = (snap.epoch, snap.version, id(snap.payload["labels"]), host)
        cached_key, lab, sizes = self._size_cache
        if cached_key != key:
            if host:
                lab = resolve_flat_host(canon)
                sizes = np.bincount(lab, minlength=len(canon))
            else:
                lab, sizes = _component_size_table(canon)
            # vcap-sized slots past the seen count are self-rooted
            # singletons; they root themselves, never a seen component,
            # so seen roots count only seen members
            self._size_cache = (key, lab, sizes)
        vcap = int(canon.shape[0])
        valid = (cv >= 0) & (cv < vcap)
        # the cached table is FULLY canonical: every vertex's root is one
        # gather away — no per-batch chase needed here
        safe = np.where(valid, cv, 0)
        if host:
            out = sizes[lab[safe]]
        else:
            out = _download(_gather_sizes(
                lab, sizes, torch.as_tensor(safe, device=canon.device)))
        return np.where(valid, out, 0).astype(np.int64)

    def summary_pull(
        self, snap: PublishedSnapshot, since_version: int = -1
    ) -> dict:
        """The snapshot's CC forest as a mergeable raw-id summary (the
        :class:`SummaryPullQuery` answer value; wire shape in
        :func:`encode_pull_doc`).

        ``since_version < 0`` answers the FULL table — slot coverage is
        what the payload's vertex dict can decode (``len(vdict)``
        slots): the shard's SEEN keyspace. Deployments that want
        untouched in-bound ids to count as singletons (the
        ``IdentityDict`` single-host semantics) observe their bound up
        front, like the serving demos do.

        ``since_version >= 0`` asks for only the rows whose root
        assignment changed since that version. The engine maintains a
        delta CHAIN: per pulled version it diffs the canonical table
        against the previous one over the TouchLog-seen candidate set
        (root changes only ever land on vertices some edge touched) and
        keeps the last :data:`DELTA_RING` segments. A covered
        ``since_version`` answers the deduped union of the covering
        segments (newest root per raw id); an uncovered one degrades
        honestly to a full reply tagged ``why`` (stale ring, no chain,
        or a puller ahead of this store — the restarted-shard case).
        Stale rows across segments stay sound to merge because the
        stream is add-only: a ``(vertex, root)`` pair once true is a
        connectivity fact forever. Docs are cached per
        ``(epoch, version, since)`` — the O(vcap) canonicalize + decode
        runs once however many routers pull.

        A pull against a snapshot BEHIND the chain head (a pinned
        transactional read from the retention ring) takes a
        read-only historical path: advancing the chain to an older
        version would CLEAR the ring (the backward-version reset), so
        the live chain is never touched — the historical version is
        served from the covering ring segments when they reach it,
        else from a full canonicalization of that snapshot's own
        payload (the ring retains payloads, so the table is right
        there)."""
        with self._chain_lock:
            key = (snap.epoch, snap.version)
            if (
                self._chain_lab is not None
                and self._chain_epoch == snap.epoch
                and snap.version < self._chain_version
            ):
                return self._historical_pull_locked(
                    snap, int(since_version))
            if self._pull_key != key:
                self._advance_chain_locked(snap)
                self._pull_key = key
                self._pull_docs = {}
            since = int(since_version)
            eff = since if since >= 0 else -1
            cached = self._pull_docs.get(eff)
            if cached is None:
                cached = self._build_pull_doc(snap, eff)
                self._pull_docs[eff] = cached
            return cached

    def chain_sync(self, snap: PublishedSnapshot) -> None:
        """Advance the delta chain to ``snap`` without answering a
        pull — the :class:`PullRingMirror` hook.  Runs on the ingest
        thread (publish listener); idempotent per (epoch, version), so
        a later ``summary_pull`` at the same snapshot reuses the
        already-advanced chain."""
        with self._chain_lock:
            key = (snap.epoch, snap.version)
            if self._pull_key != key:
                self._advance_chain_locked(snap)
                self._pull_key = key
                self._pull_docs = {}

    def _advance_chain_locked(self, snap: PublishedSnapshot) -> None:
        """Canonicalize this snapshot's forest and record the changed
        rows since the previous pulled version as one ring segment.
        Resets the chain (no segment) on a store swap — a new epoch or
        a version that went BACKWARD means the diff base is gone."""
        canon = self._host_table(snap, "labels")
        vdict = snap.payload["vdict"]
        lab = resolve_flat_host(canon)
        n = min(int(lab.shape[0]), len(vdict))
        if (
            self._chain_lab is None
            or self._chain_epoch != snap.epoch
            or snap.version < self._chain_version
        ):
            self._ring.clear()
        else:
            n_old = self._chain_n
            old = self._chain_lab
            if "tids" in snap.payload:
                # the TouchLog novelty shadow bounds the diff: a root
                # can only change on a vertex some edge ever touched
                cand = np.asarray(
                    snap.payload["tids"][: snap.payload["tcount"]],
                    np.int64,
                )
                cand = cand[cand < n_old]
            else:
                cand = np.arange(n_old, dtype=np.int64)
            changed = cand[lab[cand] != old[cand]]
            if n > n_old:
                changed = np.concatenate(
                    [changed, np.arange(n_old, n, dtype=np.int64)]
                )
            changed = np.unique(changed)
            raws = np.asarray(vdict.decode(changed), np.int64)
            roots = np.asarray(
                vdict.decode(lab[changed].astype(np.int64)), np.int64
            )
            self._ring.append(
                {"base": self._chain_version, "to": snap.version,
                 "u": raws, "r": roots}
            )
        self._chain_epoch = snap.epoch
        self._chain_version = snap.version
        self._chain_lab = np.array(lab, copy=True)
        self._chain_n = n

    def _historical_pull_locked(
        self, snap: PublishedSnapshot, since: int
    ) -> dict:
        """Serve a pull pinned at a version BEHIND the chain head
        without touching the live chain (see :meth:`summary_pull`).
        Delta when the ring's consecutive segments span exactly
        ``(since, snap.version]``; else a full table canonicalized
        from the historical snapshot's own payload, tagged
        ``why="pinned"`` (or ``"ahead"`` for a baseline past the pin).
        Cached per ``(epoch, version, since)`` in a small side cache so
        a transaction's repeated merges cost one canonicalization."""
        eff = since if since >= 0 else -1
        hkey = (snap.epoch, snap.version, eff)
        cached = self._hist_docs.get(hkey)
        if cached is not None:
            return cached
        doc = None
        why = "pinned"
        if eff == snap.version:
            empty = np.zeros(0, np.int64)
            doc = encode_pull_doc(empty, empty, kind="delta", base=eff)
        elif eff > snap.version:
            why = "ahead"
        elif eff >= 0:
            segs = [s for s in self._ring
                    if eff < s["to"] <= snap.version]
            if (segs and segs[0]["base"] <= eff
                    and segs[-1]["to"] == snap.version):
                ru = np.concatenate([s["u"] for s in reversed(segs)])
                rr = np.concatenate([s["r"] for s in reversed(segs)])
                _, idx = np.unique(ru, return_index=True)
                doc = encode_pull_doc(
                    ru[idx], rr[idx], kind="delta", base=eff)
        if doc is None:
            # straight off the historical payload — NOT via _table's
            # single-slot host cache, which must stay hot for the head
            canon = _to_numpy(snap.payload["labels"])
            vdict = snap.payload["vdict"]
            lab = resolve_flat_host(canon)
            n = min(int(lab.shape[0]), len(vdict))
            slots = np.arange(n, dtype=np.int64)
            raws = np.asarray(vdict.decode(slots), np.int64)
            roots = np.asarray(
                vdict.decode(lab[:n].astype(np.int64)), np.int64)
            doc = encode_pull_doc(raws, roots, kind="full", why=why)
        while len(self._hist_docs) >= 8:
            self._hist_docs.pop(next(iter(self._hist_docs)))
        self._hist_docs[hkey] = doc
        return doc

    def _build_pull_doc(self, snap: PublishedSnapshot, since: int) -> dict:
        vdict = snap.payload["vdict"]
        lab = self._chain_lab
        n = self._chain_n
        why = None
        if since >= 0:
            if since > snap.version:
                why = "ahead"
            elif since == snap.version:
                empty = np.zeros(0, np.int64)
                return encode_pull_doc(
                    empty, empty, kind="delta", base=since
                )
            else:
                segs = [s for s in self._ring if s["to"] > since]
                if segs and segs[0]["base"] <= since:
                    # newest-first concat + unique keeps the NEWEST
                    # root per raw id (unique returns first occurrence)
                    ru = np.concatenate(
                        [s["u"] for s in reversed(segs)])
                    rr = np.concatenate(
                        [s["r"] for s in reversed(segs)])
                    _, idx = np.unique(ru, return_index=True)
                    return encode_pull_doc(
                        ru[idx], rr[idx], kind="delta", base=since
                    )
                why = "stale" if self._ring else "no_chain"
        slots = np.arange(n, dtype=np.int64)
        raws = np.asarray(vdict.decode(slots), np.int64)
        # min-rooted invariant: lab[i] <= i, so every root of the first
        # n slots is itself within the first n slots
        roots = np.asarray(vdict.decode(lab[:n].astype(np.int64)),
                           np.int64)
        return encode_pull_doc(raws, roots, kind="full", why=why)

    # -- delta-ring persistence --- #
    def chain_state(self) -> dict:
        """A picklable copy of the delta chain: the canonical table at
        the last pulled version plus the ring segments.  Empty dict
        before the chain exists.  The copy is what
        :class:`PullRingMirror` persists so a RESTARTED shard can keep
        serving delta pulls instead of always paying one full pull."""
        with self._chain_lock:
            if self._chain_lab is None:
                return {}
            return {
                "version": int(self._chain_version),
                "n": int(self._chain_n),
                "lab": np.array(self._chain_lab, copy=True),
                "ring": [
                    {"base": int(s["base"]), "to": int(s["to"]),
                     "u": np.array(s["u"], copy=True),
                     "r": np.array(s["r"], copy=True)}
                    for s in self._ring
                ],
            }

    def restore_chain(self, state: dict, epoch: int,
                      boot_version: int) -> bool:
        """Adopt a persisted chain after a restart.

        Accepted ONLY when the persisted chain head equals
        ``boot_version`` — the version the restarted store republished
        at boot (snapshot-mirror adoption with the version override).
        Any mismatch means the ring and the served state diverged
        (snapshot newer than the ring, or vice versa) and a delta
        built on it could claim coverage it does not have; the engine
        then keeps its empty chain and the next pull degrades to the
        existing full fallback, counted
        (``serving.pullring_rejected{reason}``)."""
        reason = None
        if not state or "lab" not in state:
            reason = "empty"
        elif int(state.get("version", -2)) != int(boot_version):
            reason = "version"
        if reason is not None:
            get_registry().counter(
                "serving.pullring_rejected", reason=reason).inc()
            return False
        with self._chain_lock:
            self._chain_epoch = int(epoch)
            self._chain_version = int(state["version"])
            self._chain_lab = np.asarray(state["lab"]).copy()
            self._chain_n = int(state["n"])
            self._ring.clear()
            for s in state.get("ring", []):
                self._ring.append(
                    {"base": int(s["base"]), "to": int(s["to"]),
                     "u": np.asarray(s["u"], np.int64),
                     "r": np.asarray(s["r"], np.int64)}
                )
            # the boot snapshot IS the restored chain head: mark it
            # current so the first pull serves from the ring instead
            # of appending a degenerate (V -> V) segment
            self._pull_key = (int(epoch), int(boot_version))
            self._pull_docs = {}
        return True

    def bipartite(self, snap: PublishedSnapshot) -> dict:
        """The :class:`BipartiteQuery` answer value (see its docstring).

        Seen base vertices come from the payload's touch evidence —
        either the append-only log view (``tids``/``tcount``, the
        forest-carry publish shape: the first ``tcount`` entries of an
        append-only log never change, so the published ref is a valid
        snapshot) or a ``touched`` bool table (the dense carry /
        restored-checkpoint shape). Cached per snapshot version: the
        O(vcap) canonicalize + conflict scan runs once however many
        clients ask."""
        bkey = (snap.epoch, snap.version)
        ver, cached = self._bp_cache
        if ver == bkey and cached is not None:
            return cached
        cover = self._host_table(snap, "cover")
        vdict = snap.payload["vdict"]
        vcap = cover.shape[0] // 2
        lab = resolve_flat_host(cover)
        if "tids" in snap.payload:
            tids = np.asarray(
                snap.payload["tids"][: snap.payload["tcount"]], np.int64
            )
            tids = tids[tids < vcap]
        else:
            touched = _to_numpy(snap.payload["touched"])
            tids = np.nonzero(touched[:vcap])[0]
        conflicted = tids[lab[tids] == lab[tids + vcap]]
        if len(conflicted):
            witness = int(
                np.min(np.asarray(vdict.decode(conflicted), np.int64))
            )
            doc = {"bipartite": False, "witness": witness}
        else:
            doc = {"bipartite": True, "witness": None}
        self._bp_cache = (bkey, doc)
        return doc

    def degree(self, snap: PublishedSnapshot, vs: np.ndarray) -> np.ndarray:
        return self._table_gather(snap, "deg", vs, fill=0)

    def rank(self, snap: PublishedSnapshot, vs: np.ndarray) -> np.ndarray:
        return self._table_gather(snap, "ranks", vs, fill=0.0)

    def _table_gather(
        self, snap: PublishedSnapshot, key: str, vs: np.ndarray, fill
    ) -> np.ndarray:
        table = self._table(snap, key)
        vdict = snap.payload["vdict"]
        cv = _lookup_batch(vdict, vs)
        vcap = int(table.shape[0])
        valid = (cv >= 0) & (cv < vcap)
        safe = np.where(valid, cv, 0)
        if isinstance(table, np.ndarray):
            got = table[safe]
        else:
            got = _download(_gather(
                table, torch.as_tensor(safe, device=table.device)))
        return np.where(valid, got, fill)

    # -- heterogeneous batch ------------------------------------------- #
    def answer_batch(
        self,
        snap: PublishedSnapshot,
        queries: Sequence[Query],
        head_window: Optional[int] = None,
    ) -> List[Answer]:
        """Answer a mixed batch: group by query class, one vectorized
        kernel per class present, answers re-ordered to match the input.
        ``head_window`` (default: this snapshot's window) stamps each
        answer's staleness gauge."""
        head = snap.window if head_window is None else head_window
        staleness = max(0, head - snap.window)
        out: List[Optional[Answer]] = [None] * len(queries)
        groups: Dict[type, List[int]] = {}
        for i, q in enumerate(queries):
            groups.setdefault(type(q), []).append(i)
        for qcls, idxs in groups.items():
            key = self.PAYLOAD_KEYS.get(qcls)
            if key is None or key not in snap.payload:
                raise TypeError(
                    f"snapshot payload (keys {sorted(snap.payload)}) does "
                    f"not serve {qcls.__name__}"
                )
            if qcls in (SummaryPullQuery, BipartiteQuery):
                # cached docs answer the whole group (dict-valued, so
                # they bypass the ndarray tail below); pulls key the
                # cache per since_version, so mixed baselines in one
                # batch still cost one canonicalization
                for i in idxs:
                    doc = (
                        self.summary_pull(
                            snap, queries[i].since_version)
                        if qcls is SummaryPullQuery
                        else self.bipartite(snap)
                    )
                    out[i] = Answer(
                        value=doc, window=snap.window,
                        watermark=snap.watermark, staleness=staleness,
                        version=snap.version, event_ts=snap.event_ts,
                        boot=getattr(snap, "boot", ""),
                    )
                continue
            if qcls is ConnectedQuery:
                us = np.asarray([queries[i].u for i in idxs], np.int64)
                vs = np.asarray([queries[i].v for i in idxs], np.int64)
                vals = self.connected(snap, us, vs)
            else:
                vs = np.asarray([queries[i].v for i in idxs], np.int64)
                if qcls is DegreeQuery:
                    vals = self.degree(snap, vs)
                elif qcls is RankQuery:
                    vals = self.rank(snap, vs)
                else:
                    vals = self.component_size(snap, vs)
            for i, v in zip(idxs, vals.tolist()):
                out[i] = Answer(
                    value=v, window=snap.window,
                    watermark=snap.watermark, staleness=staleness,
                    version=snap.version, event_ts=snap.event_ts,
                    boot=getattr(snap, "boot", ""),
                )
        return out  # type: ignore[return-value]


# --------------------------------------------------------------------- #
# Pull-ring persistence: checkpoint the delta
# chain alongside the snapshot mirror so a RESTARTED shard bridges
# routers with a delta pull instead of always paying one full pull.
# --------------------------------------------------------------------- #

PULL_RING_TAG = "pullring.bin"


class PullRingMirror:
    """Snapshot-store listener that keeps an engine's delta chain
    advancing with every publish and persists it next to the snapshot
    mirror (CRC-framed, overwrite — only the newest chain matters).

    ``every`` throttles the O(n) persist the same way
    ``SnapshotMirror(every=...)`` throttles snapshot writes; the chain
    itself advances on EVERY publish (ring segments are per-version,
    skipping one would tear the chain).  A failed persist is counted
    (``serving.swallowed{site=pullring_write}``) and retried on the
    next publish — the in-memory chain is still intact, only restart
    bridging is at stake."""

    def __init__(self, engine: QueryEngine, dirpath: str, *,
                 every: int = 1) -> None:
        self.engine = engine
        self.dirpath = dirpath
        self.every = max(1, int(every))
        self._published = 0

    def __call__(self, snap: PublishedSnapshot) -> None:
        from ..fabric import as_transport

        self.engine.chain_sync(snap)
        self._published += 1
        if self._published % self.every:
            return
        try:
            blob = pickle.dumps(self.engine.chain_state(), protocol=4)
            as_transport(self.dirpath).put_framed(
                PULL_RING_TAG, blob, overwrite=True)
        except Exception:
            get_registry().counter(
                "serving.swallowed", site="pullring_write").inc()


def load_pull_ring(dirpath: str) -> dict:
    """The persisted delta chain from ``dirpath`` (empty dict when
    absent, torn, or undecodable — torn/undecodable are recorded, and
    :meth:`QueryEngine.restore_chain` turns an empty dict into the
    counted full-fallback degrade)."""
    from ..fabric import as_transport
    from ..resilience.integrity import record_rejection

    tr = as_transport(dirpath)
    data = tr.get_framed(PULL_RING_TAG)
    if data is None:
        return {}
    try:
        state = pickle.loads(data)
    except Exception as e:
        record_rejection(tr.describe(PULL_RING_TAG),
                         f"undecodable pull ring: {e!r}")
        return {}
    return state if isinstance(state, dict) else {}
