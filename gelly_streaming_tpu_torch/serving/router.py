"""Sharded serving: multi-shard query fan-out with scatter-gather merge
(the port's copy of ``gelly_streaming_tpu/serving/router.py``).

Until now every replica answered from ONE whole snapshot: a keyspace
bigger than one host's memory was unservable and query throughput was
capped by a single serving worker. This module is the routing tier in
front of N shard servers:

- **One partition rule.** The vertex-id space is partitioned by
  :func:`~gelly_streaming_tpu_torch.core.ingest.vertex_owner` — derived from
  ``shard_of``, the SAME endpoint hash the sharded-ingest wire uses —
  and each shard ingests the edges incident to the vertices it owns
  (:func:`~gelly_streaming_tpu_torch.core.ingest.partition_edges_by_vertex`:
  every edge reaches the owner of each endpoint, so per-vertex answers
  are owner-complete and every edge lives in at least one shard).
- **Scatter-gather fan-out.** :class:`ShardRouter` drains concurrent
  submissions in sweeps (the serving worker's coalescing discipline),
  splits each sweep's degree/rank queries into per-owner sub-batches,
  fans them to the owning shards in parallel over the existing GSRP
  wire (one :class:`~.client.RpcClient` per shard — idempotent batch
  ids, reconnect-and-resubmit, per-shard failover all inherited), and
  merges the partial answer lists back into submission order. Each
  query spends ONE deadline end-to-end: the budget is pinned at
  admission and every shard call ships only what REMAINS.
- **Cross-shard union for CC.** Connectivity queries cannot be answered
  by any single shard (a component may span shards through boundary
  vertices), so the router pulls each shard's forest summary
  (:class:`~.query.SummaryPullQuery` — raw-id ``(vertex, root)``
  columns) and merges them with the group-fold union step
  (:func:`~gelly_streaming_tpu_torch.summaries.forest.fold_edges_host`): the
  union of per-shard spanning forests has exactly the components of the
  union of per-shard edge sets, so ``connected``/``component size``
  answers are byte-identical to a single host folding the whole
  stream. Pulls are per shard snapshot VERSION (lazy, cached), not per
  query.
- **Hot-key answer cache.** A bounded LRU keyed on
  ``(query class, vertex key)`` and STAMPED with the shard snapshot
  versions the answer was computed from. Reply frames carry each
  shard's snapshot version; a version bump observed in any reply
  lazily invalidates stale entries at their next lookup (counted).
  Power-law traffic — millions of users hammering a small hot set —
  short-circuits the fan-out entirely on the hit path.
  ``cache_ttl_s`` optionally bounds hit age for deployments whose
  traffic could go 100% hot (no misses means no version observations).

Observability: ``router.cache_hits`` / ``router.cache_misses`` /
``router.cache_invalidations``, ``router.fanouts``, ``router.pulls`` /
``router.pull_errors{shard}``, ``router.stale_merges``, and — with
tracing on — one ``serving.router.fanout`` span per traced wire batch,
parented under the client's batch root, with every shard sub-batch's
spans parented under IT: one trace joins client, router, and every
shard that answered.

``python -m gelly_streaming_tpu_torch.serving.router --router '<json cfg>'``
runs the router as a standalone binary (an :class:`~.rpc.RpcServer`
front end over the fan-out), the shape the sharded scenarios deploy.

Device placement: a router holds NO device state. Its merges, cache and
pull decoding are numpy on the host, exactly the reference's, so pulled
bytes, merged tables and cache decisions are equal across the packages;
:func:`spawn_router` starts its process with ``CUDA_VISIBLE_DEVICES=""``
and :class:`ShardRouter` never creates a CUDA context. The shard
replicas behind it keep their tables on the card
(:func:`shard_demo_payloads` ``device=``, default ``"cuda"``) and answer
their query steps there.
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time
from collections import OrderedDict, deque
from concurrent.futures import Future, InvalidStateError
from functools import partial
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..core.ingest import vertex_owner_epoch
from ..obs import trace as _trace
from ..obs.registry import get_registry
from .client import RpcClient
from .query import (
    Answer,
    ComponentSizeQuery,
    ConnectedQuery,
    DegreeQuery,
    MalformedPull,
    Query,
    RankQuery,
    SummaryPullQuery,
    decode_pull_doc,
)
from .server import Overloaded
from .txn import TxnSnapshotExpired

#: hot-key LRU capacity default (answers, not bytes: each entry is one
#: Answer + a version stamp)
DEFAULT_CACHE_CAP = 8192

#: pinned merged-forest LRU: one carried cross-shard forest
#: per distinct transaction pin vector — transactions are short-lived,
#: so a handful of concurrently-pinned vectors covers the working set
PINNED_MERGED_CAP = 4

#: fallback wall bound for a pinned CC gather when every requester is
#: deadline-less — the worker must never block forever on a dead shard
PINNED_PULL_TIMEOUT_S = 30.0

#: query classes the router serves (fan-out or merged-forest path)
ROUTED_CLASSES = (
    ConnectedQuery, ComponentSizeQuery, DegreeQuery, RankQuery,
)

#: wire bytes per pulled (vertex, root) row — two packed int64 columns
PULL_ROW_BYTES = 16

#: how many delta refreshes the selective-invalidation history spans; a
#: cache entry stamped further back than the ring reaches invalidates
#: the old blanket way instead of revalidating
DELTA_HIST = 64


def decode_pull(doc: dict) -> dict:
    """Decode a :meth:`~.query.QueryEngine.summary_pull` answer value
    (see :func:`~.query.decode_pull_doc` for the decoded shape). Raises
    :class:`~.query.MalformedPull` (a ``ValueError``) on a malformed
    doc — a torn summary must never silently merge as empty — and
    counts the rejection under ``router.pull_malformed{kind}`` so a
    misbehaving shard's failure CLASS (geometry vs base64 vs missing
    keys...) is visible, not just a generic pull error."""
    try:
        return decode_pull_doc(doc)
    except MalformedPull as e:
        get_registry().counter("router.pull_malformed", kind=e.kind).inc()
        raise


class _Entry:
    """One admitted query riding the router's pending queue. ``txn``
    is the decoded transaction dict (``{"id", "pin", "vec"}``) the
    entry rides under, None outside a transaction; ``pin`` is the
    ``(version, boot)`` the fan-out resolved for the entry's routed
    shard (split-ancestry walk included), None for unpinned."""

    __slots__ = ("q", "f", "t0", "dl", "ctx", "grp", "key", "done",
                 "txn", "pin")

    def __init__(self, q, f, t0, dl, ctx, txn=None):
        self.q = q
        self.f = f
        self.t0 = t0
        self.dl = dl
        self.ctx = ctx
        self.grp = None
        self.key = None
        self.done = False
        self.txn = txn
        self.pin = None


class _Group:
    """Per-(traced wire batch, sweep) fan-out accounting: the
    ``serving.router.fanout`` span is emitted when the LAST entry of
    the group settles, so its duration covers the whole scatter-gather
    including the slowest shard."""

    __slots__ = ("ctx", "sid", "t0", "left", "hits", "misses",
                 "shards", "lock")

    def __init__(self, ctx, sid: int, t0: float, left: int):
        self.ctx = ctx
        self.sid = sid
        self.t0 = t0
        self.left = left
        self.hits = 0
        self.misses = 0
        self.shards: set = set()
        self.lock = threading.Lock()

    def done_one(self) -> bool:
        with self.lock:
            self.left -= 1
            return self.left == 0


class _CacheEntry:
    """``owner`` is the key's owning shard for owner-routed classes
    (so validity checks one version slot without re-hashing), None for
    router-merged classes (validity checks the whole vector).
    ``roots`` (merged-CC entries only) records the RAW root ids the
    answer depended on — the selective-invalidation key: a delta
    refresh whose touched-component set misses every root PROVES the
    cached answer still holds at the new version vector."""

    __slots__ = ("ans", "vers", "ts", "owner", "roots")

    def __init__(self, ans: Answer, vers: tuple, ts: float,
                 owner: Optional[int], roots: Optional[frozenset] = None):
        self.ans = ans
        self.vers = vers
        self.ts = ts
        self.owner = owner
        self.roots = roots


class _MergedCC:
    """The router's carried cross-shard merged forest.

    Built by a full rebuild
    (:func:`~gelly_streaming_tpu_torch.summaries.forest.merge_forest_tables_host`
    over the per-shard tables) and then kept CURRENT by
    :func:`~gelly_streaming_tpu_torch.summaries.forest.apply_forest_delta_host`
    over delta-pull rows — O(changed) per refresh. Dense ids are the
    sorted position in ``uniq`` (the raw-id union at rebuild time);
    raw ids first seen in a later delta append PAST the base (``extra``
    maps them, ``raw_of`` inverts) with amortized-doubling growth, so
    between rebuilds nothing is re-sorted. ``lab`` stays min-rooted
    (``lab[v] <= v`` — sorted raw order preserves the invariant) but
    not necessarily flat between rebuilds: readers chase roots.
    All access is under the router's ``_mlock``."""

    __slots__ = ("uniq", "extra", "lab", "sizes", "raw_of", "n",
                 "meta", "stamp")

    def __init__(self, uniq: np.ndarray, lab: np.ndarray,
                 sizes: np.ndarray, meta: tuple, stamp: tuple):
        self.uniq = uniq
        self.extra: dict = {}
        self.lab = np.asarray(lab, np.int64)
        self.sizes = np.asarray(sizes, np.int64)
        self.raw_of = np.asarray(uniq, np.int64).copy()
        self.n = len(uniq)
        self.meta = meta
        self.stamp = stamp

    def lookup(self, raw: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """(dense index, found mask); consults the post-rebuild extras
        for ids the sorted base predates."""
        i, f = ShardRouter._lookup(self.uniq, raw)
        if self.extra:
            for j in np.nonzero(~f)[0].tolist():
                d = self.extra.get(int(raw[j]))
                if d is not None:
                    i[j] = d
                    f[j] = True
        return i, f

    def ensure_ids(self, raw: np.ndarray) -> np.ndarray:
        """Dense ids for ``raw``, allocating self-rooted singleton slots
        for ids never seen before (a delta's brand-new vertices)."""
        i, f = self.lookup(raw)
        for j in np.nonzero(~f)[0].tolist():
            rid = int(raw[j])
            d = self.extra.get(rid)
            if d is None:
                d = self.n
                self._grow(d + 1)
                self.lab[d] = d
                self.sizes[d] = 1
                self.raw_of[d] = rid
                self.extra[rid] = d
                self.n = d + 1
            i[j] = d
        return i

    def roots(self, idx: np.ndarray) -> np.ndarray:
        """Batch root chase (the table may be non-flat between full
        rebuilds; chains stay short via the delta path's halving)."""
        r = self.lab[idx]
        while True:
            nxt = self.lab[r]
            if np.array_equal(nxt, r):
                return r
            r = nxt

    def _grow(self, need: int) -> None:
        cap = len(self.lab)
        if need <= cap:
            return
        new = max(need, 2 * cap, 8)
        lab2 = np.arange(new, dtype=np.int64)
        lab2[:cap] = self.lab
        sizes2 = np.ones(new, np.int64)
        sizes2[:cap] = self.sizes
        raw2 = np.full(new, -1, np.int64)
        raw2[:cap] = self.raw_of
        self.lab, self.sizes, self.raw_of = lab2, sizes2, raw2


class ShardRouter:
    """Scatter-gather query router over N shard serving replicas.

    ``shard_addrs`` is one address LIST per shard (give each shard's
    primary AND standby; the per-shard :class:`~.client.RpcClient`
    cycles them, so each shard fails over independently without the
    router noticing beyond a latency blip). The router has the same
    ``submit``/``ask`` surface as a ``StreamServer`` — put it behind an
    :class:`~.rpc.RpcServer` and clients cannot tell it from a single
    replica.

    Merge semantics per query class (the contract README documents):

    - ``DegreeQuery`` / ``RankQuery``: routed to the key's OWNER shard,
      whose partial is the whole answer (the delivery rule hands every
      incident edge to the owner); the router's merge re-interleaves
      per-shard sub-batch answers into submission order. Rank is exact
      only as far as the shard's local summary is (an edge-subset
      PageRank is the shard's declared partial).
    - ``ConnectedQuery`` / ``ComponentSizeQuery``: answered at the
      router from the merged cross-shard forest (see module docstring);
      ``window`` is the MINIMUM shard window merged (the conservative
      progress claim), ``watermark`` the sum, ``staleness`` the max,
      ``version`` the sum of shard versions (monotone under any bump).

    A cache hit re-serves the answer computed at its stamped snapshot
    versions; the invalidation contract bounds how stale a hit can be:
    any reply frame observing a newer shard version invalidates the
    entry at its next lookup, and ``cache_ttl_s`` (optional) bounds the
    window in which NO reply was observed at all.
    """

    def __init__(
        self,
        shard_addrs: Sequence,
        *,
        max_pending: int = 1 << 14,
        cache: bool = True,
        cache_cap: int = DEFAULT_CACHE_CAP,
        cache_ttl_s: Optional[float] = None,
        client_factory=None,
        seed: int = 0,
        autotune: bool = False,
        target_wait_s: Optional[float] = None,
        delta: bool = True,
        reshard=None,
    ):
        if not shard_addrs:
            raise ValueError("at least one shard address is required")
        factory = client_factory or (
            lambda addrs, i: RpcClient(addrs, seed=seed + i)
        )
        self._factory = factory
        self._clients: List[RpcClient] = [
            factory(a if isinstance(a, (list, tuple)) and not (
                isinstance(a, tuple) and len(a) == 2
                and isinstance(a[1], int)
            ) else [a], i)
            for i, a in enumerate(shard_addrs)
        ]
        self.nshards = len(self._clients)
        #: elastic resharding: the BOOT shard count is the
        #: hash base forever — splits compose on top of it
        #: (``core.ingest.vertex_owner_epoch``), so adopting a split
        #: never moves keys that did not split. ``reshard`` is the
        #: coordination store (dir/transport) split plans are read
        #: from; adoption triggers off reply-frame epoch stamps.
        self._hash_shards = len(self._clients)
        self._reshard = reshard
        self._splits: list = []   # adopted plan dicts, epoch order
        self._epoch = 0           # == len(self._splits)
        self.max_pending = int(max_pending)
        #: load-aware admission: same contract as
        #: ``StreamServer(autotune=True)`` — the router's drain sweep
        #: taps its oldest queue wait vs the tightest deadline budget,
        #: and the tuner moves ``max_pending`` inside the configured
        #: ceiling with hysteresis + bounded steps (the router has no
        #: class shedding, so only the admission limit moves)
        self.admission = None
        if autotune:
            from ..control import AdmissionTuner

            self.admission = AdmissionTuner(
                max_pending=self.max_pending,
                target_wait_s=target_wait_s,
            )
        self.cache_enabled = bool(cache)
        self.cache_cap = int(cache_cap)
        self.cache_ttl_s = cache_ttl_s
        self._cache: "OrderedDict[tuple, _CacheEntry]" = OrderedDict()
        self._lock = threading.Lock()       # pending/admission/cache
        self._pending: deque = deque()
        self._inflight = 0
        self._wake = threading.Event()
        self._closing = False
        #: pull protocol v2: send ``since_version`` once a
        #: baseline exists, apply delta replies incrementally, and
        #: retain provably-untouched cache entries across refreshes;
        #: False pins the v1 full-re-pull behavior (the churn baseline)
        self.delta = bool(delta)
        # merged cross-shard CC state (all under _mlock)
        self._mlock = threading.Lock()
        self._vers = [0] * self.nshards       # newest observed version
        self._pulled_vers = [-1] * self.nshards
        self._pairs: list = [None] * self.nshards   # (u_raw, r_raw)
        self._rows: list = [None] * self.nshards    # raw -> root carry
        self._pull_meta: list = [None] * self.nshards  # (win, wm, stale)
        self._pulls: dict = {}                # shard -> in-flight pull
        self._pull_err: list = [None] * self.nshards
        self._cc_waiting: list = []           # jobs parked on pulls
        self._merged: Optional[_MergedCC] = None
        # delta rows accepted since the last merged refresh, and
        # whether any full reply forces the next refresh to rebuild
        self._delta_pending: list = []        # (u_raw, r_raw) batches
        self._full_pending = False
        # (from_stamp, to_stamp, touched raw roots) per delta refresh —
        # the chain a stale cache entry revalidates against
        self._delta_hist: deque = deque(maxlen=DELTA_HIST)
        # pinned merged forests: one carried cross-shard
        # forest per transaction pin vector, LRU-bounded (under _mlock)
        self._pinned_merged: "OrderedDict[tuple, _MergedCC]" = \
            OrderedDict()
        # hot-path instruments resolved once (a cache hit should cost
        # a dict probe + a counter bump, not two registry lookups)
        reg = get_registry()
        self._c_hits = reg.counter("router.cache_hits")
        self._c_misses = reg.counter("router.cache_misses")
        self._c_inval = reg.counter("router.cache_invalidations")
        self._c_retained = reg.counter("router.cache_retained")
        self._worker = threading.Thread(
            target=self._run, name="shard-router", daemon=True
        )
        self._worker.start()

    # ------------------------------------------------------------------ #
    # Submission surface (StreamServer.submit contract)
    # ------------------------------------------------------------------ #
    def submit(
        self,
        query: Query,
        *,
        deadline_s: Optional[float] = None,
        ctx=None,
        txn=None,
    ) -> "Future[Answer]":
        """Admit one query; resolves to a merged :class:`Answer`.
        Raises :class:`~.server.Overloaded` at the admission limit and
        ``TypeError`` for classes the router cannot merge. The deadline
        is a TOTAL budget pinned here: cache lookup, fan-out, shard
        retries, and merge all spend the one clock. ``txn``
        is the decoded transaction dict whose ``vec`` pins per-shard
        reads — owner-routed classes are answered at the pinned
        shard snapshot, CC classes from a pinned merged forest."""
        if not isinstance(query, ROUTED_CLASSES):
            raise TypeError(
                f"ShardRouter routes "
                f"{[c.__name__ for c in ROUTED_CLASSES]}, not "
                f"{type(query).__name__}"
            )
        t0 = time.perf_counter()
        dl = None if deadline_s is None else t0 + float(deadline_s)
        if ctx is None and _trace.on():
            ctx = _trace.current_context()
        e = _Entry(query, Future(), t0, dl, ctx, txn=txn)
        with self._lock:
            if self._closing:
                raise RuntimeError("router is closed")
            admitted = len(self._pending) + self._inflight
            if admitted >= self.max_pending:
                get_registry().counter("router.rejected").inc()
                raise Overloaded(
                    f"{admitted} queries in flight at the router "
                    f"(max_pending={self.max_pending})"
                )
            self._pending.append(e)
        self._wake.set()
        return e.f

    def submit_many(
        self,
        queries,
        *,
        deadline_s: Optional[float] = None,
        ctx=None,
        txn=None,
    ) -> list:
        """Admit a whole wire batch under ONE lock acquisition (the
        RPC front end's fast path; all-or-nothing admission, like
        ``StreamServer.submit_many``)."""
        for q in queries:
            if not isinstance(q, ROUTED_CLASSES):
                raise TypeError(
                    f"ShardRouter routes "
                    f"{[c.__name__ for c in ROUTED_CLASSES]}, not "
                    f"{type(q).__name__}"
                )
        t0 = time.perf_counter()
        dl = None if deadline_s is None else t0 + float(deadline_s)
        if ctx is None and _trace.on():
            ctx = _trace.current_context()
        entries = [
            _Entry(q, Future(), t0, dl, ctx, txn=txn) for q in queries
        ]
        with self._lock:
            if self._closing:
                raise RuntimeError("router is closed")
            admitted = len(self._pending) + self._inflight
            if admitted + len(queries) > self.max_pending:
                get_registry().counter("router.rejected").inc()
                raise Overloaded(
                    f"{admitted} queries in flight at the router "
                    f"(max_pending={self.max_pending})"
                )
            self._pending.extend(entries)
        self._wake.set()
        return [e.f for e in entries]

    def ask(self, query: Query, timeout: Optional[float] = None,
            deadline_s: Optional[float] = None) -> Answer:
        return self.submit(query, deadline_s=deadline_s).result(timeout)

    def ask_batch(
        self,
        queries: Sequence[Query],
        *,
        deadline_s: Optional[float] = None,
        timeout: Optional[float] = None,
    ) -> List[Answer]:
        futures = [
            self.submit(q, deadline_s=deadline_s) for q in queries
        ]
        # one budget across the whole wait
        deadline = None if timeout is None \
            else time.monotonic() + float(timeout)
        return [
            f.result(
                None if deadline is None
                else max(0.0, deadline - time.monotonic())
            )
            for f in futures
        ]

    def pending(self) -> int:
        with self._lock:
            return len(self._pending) + self._inflight

    def health(self) -> dict:
        with self._lock:
            cache_n = len(self._cache)
            pending = len(self._pending) + self._inflight
        return {
            "shards": self.nshards,
            "epoch": self._epoch,
            "pending": pending,
            "cache_entries": cache_n,
            "shard_versions": list(self._vers),
            "ok": self._worker.is_alive(),
        }

    def stats_snapshot(self) -> dict:
        """Router counters as a plain dict (cache hit/miss/invalidation
        and full-vs-delta refresh evidence the sharded scenario reports)."""
        reg = get_registry()

        def _count(name: str, **labels) -> float:
            return float(sum(
                i.value for l, i in reg.find(name)
                if all(l.get(k) == v for k, v in labels.items())
            ))

        return {
            "pending": self.pending(),
            "epoch": self._epoch,
            "shards": self.nshards,
            "reshard_adopts":
                int(_count("reshard.adopt", site="router")),
            "cache_hits": int(_count("router.cache_hits")),
            "cache_misses": int(_count("router.cache_misses")),
            "cache_invalidations":
                int(_count("router.cache_invalidations")),
            "cache_retained": int(_count("router.cache_retained")),
            "fanouts": int(_count("router.fanouts")),
            "pulls": int(_count("router.pulls")),
            "pull_errors": int(_count("router.pull_errors")),
            "pull_malformed": int(_count("router.pull_malformed")),
            "stale_merges": int(_count("router.stale_merges")),
            "rejected": int(_count("router.rejected")),
            # protocol v2 evidence: reply-frame mix, pulled volume, and
            # the router-side merge-refresh cost split by kind
            "delta_pulls": int(_count("router.delta_pulls")),
            "delta_rows": int(_count("router.delta_rows")),
            "full_fallbacks": int(_count("router.full_fallbacks")),
            "pull_bytes_full":
                int(_count("router.pull_bytes", kind="full")),
            "pull_bytes_delta":
                int(_count("router.pull_bytes", kind="delta")),
            "merges_full": int(_count("router.merges", kind="full")),
            "merges_delta": int(_count("router.merges", kind="delta")),
            "merge_s_full": _count("router.merge_s", kind="full"),
            "merge_s_delta": _count("router.merge_s", kind="delta"),
        }

    # ------------------------------------------------------------------ #
    # Worker (drain-and-coalesce, like the serving worker)
    # ------------------------------------------------------------------ #
    def _run(self) -> None:
        while True:
            with self._lock:
                batch = list(self._pending)
                self._pending.clear()
                self._inflight += len(batch)
                closing = self._closing
            if batch:
                try:
                    self._sweep(batch)
                except BaseException as e:
                    # the router worker must survive any sweep error —
                    # a dead worker hangs every future forever
                    get_registry().counter(
                        "router.swallowed", site="sweep"
                    ).inc()
                    for e_ in batch:
                        self._settle(e_, exc=e)
                continue
            if closing:
                return
            self._wake.wait(0.05)
            self._wake.clear()

    def _sweep(self, batch: List[_Entry]) -> None:
        if self._reshard is not None:
            self._maybe_adopt_epoch()
        reg = get_registry()
        now = time.perf_counter()
        t_sweep = now
        live: List[_Entry] = []
        groups: dict = {}
        tracing = _trace.on()
        for e in batch:
            if e.dl is not None and now > e.dl:
                self._expire(e)
                continue
            e.key = self._cache_key(e.q)
            if tracing and e.ctx is not None:
                g = groups.get(id(e.ctx))
                if g is None:
                    g = _Group(e.ctx, _trace.next_sid(), t_sweep, 0)
                    groups[id(e.ctx)] = g
                g.left += 1
                e.grp = g
            live.append(e)
        if not live:
            return
        if self.admission is not None:
            # admission tap (once per sweep): oldest queue wait — the
            # batch drains in submission order — vs the sweep's
            # tightest deadline budget
            if self.admission.tap_entries(
                t_sweep - live[0].t0, ((e.t0, e.dl) for e in live)
            ):
                with self._lock:
                    self.max_pending = self.admission.max_pending
        # ---- cache pass (counters aggregated per sweep: a hot sweep
        # must cost probes, not one event emission per query) --------- #
        misses: List[_Entry] = []
        n_hits = 0
        for e in live:
            hit = None
            if self.cache_enabled:
                vec = None if e.txn is None else e.txn.get("vec")
                if vec:
                    # pinned lookup: the cache is consulted with a
                    # VERSION COMPARE against the pin, not bypassed —
                    # a hit re-serves the answer only when it was
                    # computed at exactly the pinned snapshot
                    pin = None
                    if isinstance(e.q, (DegreeQuery, RankQuery)):
                        s = int(vertex_owner_epoch(
                            np.asarray([e.q.v], np.int64),
                            self._hash_shards, self._splits,
                        )[0])
                        _rs, pin = self._pin_route(vec, s)
                    if pin is not None:
                        hit = self._cache_get(e.key, pin=pin)
                else:
                    hit = self._cache_get(e.key)
            if hit is not None:
                if e.grp is not None:
                    e.grp.hits += 1
                n_hits += 1
                self._settle(e, ans=hit)
            else:
                if e.grp is not None:
                    e.grp.misses += 1
                misses.append(e)
        if n_hits:
            self._c_hits.inc(n_hits)
        if not misses:
            return
        if self.cache_enabled:
            self._c_misses.inc(len(misses))
        reg.counter("router.fanouts").inc()
        # ---- split by path ------------------------------------------- #
        dr: List[_Entry] = []      # owner fan-out classes
        cc: List[_Entry] = []      # merged-forest classes (fresh)
        ccp: List[_Entry] = []     # merged-forest classes, PINNED
        for e in misses:
            if isinstance(e.q, (DegreeQuery, RankQuery)):
                dr.append(e)
            elif e.txn is not None and e.txn.get("vec"):
                ccp.append(e)
            else:
                cc.append(e)
        if dr:
            self._fan_out(dr)
        if cc:
            self._route_cc(cc)
        if ccp:
            self._route_cc_pinned(ccp)

    # ------------------------------------------------------------------ #
    # Elastic resharding: epoch adoption (worker thread only)
    # ------------------------------------------------------------------ #
    def _maybe_adopt_epoch(self) -> None:
        """Adopt newly actionable split plans once any shard's reply
        frames stamp an epoch ahead of ours.

        Runs on the router worker (the only thread that reads
        ``_clients`` by index for fan-out), so appending a child
        client is race-free for routing; the merged-CC arrays grow
        under ``_mlock`` where every other reader holds it. A stamp
        ahead of the store's ACTIONABLE prefix just retries next sweep
        (the child's address commit is what we are waiting on).
        Adoption never rolls back — splits are monotone history."""
        observed = max(c.epoch_observed for c in self._clients)
        if observed <= self._epoch:
            return
        from .reshard import actionable_plans

        try:
            plans = actionable_plans(self._reshard)
        except Exception:
            # a flaky store read must not take the sweep down; the
            # reply frames keep stamping, the next sweep retries
            get_registry().counter(
                "router.swallowed", site="reshard_read").inc()
            return
        reg = get_registry()
        for p in plans[self._epoch:]:
            if int(p["child"]) != len(self._clients):
                # a plan whose child index does not extend the client
                # list would mis-route every moved key; refuse it (and
                # everything after — plans compose in order)
                reg.counter(
                    "router.swallowed", site="reshard_geometry").inc()
                return
            cl = self._factory([p["addr"]], len(self._clients))
            with self._mlock:
                self._clients.append(cl)
                self._vers.append(0)
                self._pulled_vers.append(-1)
                self._pairs.append(None)
                self._rows.append(None)
                self._pull_meta.append(None)
                self._pull_err.append(None)
                self._splits.append(
                    {k: int(p[k])
                     for k in ("epoch", "parent", "child", "salt")})
                self.nshards = len(self._clients)
                self._epoch = len(self._splits)
                # the merged forest must now cover the child's pull
                # before answering: drop the merge so the next CC
                # query refreshes against ALL shards including the
                # child (its first pull is a full, since=-1)
                self._merged = None
            reg.counter(
                "reshard.adopt", epoch=str(p["epoch"]), site="router",
            ).inc()

    # ------------------------------------------------------------------ #
    # Degree / rank: owner fan-out
    # ------------------------------------------------------------------ #
    def _pin_route(self, vec: dict, shard: int):
        """``(route_shard, pin)`` for an owner-routed key under a
        transaction vector. A pin on the owner itself routes there; an
        unpinned CHILD of a live split walks the ancestry child→parent
        looking for a pinned ancestor — a parent-version pin predates
        the split, and the parent's snapshot (a superset table) is the
        only replica that HOLDS it, so the pinned read routes to the
        ancestor shard. No pin anywhere on the chain: unpinned."""
        pin = vec.get(shard)
        if pin is not None:
            return shard, pin
        cur = shard
        for p in reversed(self._splits):
            if p["child"] == cur:
                cur = p["parent"]
                pin = vec.get(cur)
                if pin is not None:
                    return cur, pin
        return shard, None

    def _fan_out(self, entries: List[_Entry]) -> None:
        # ownership = boot hash + adopted split generations: the hash
        # base NEVER changes (self._hash_shards), splits move only the
        # split-off half of the split shard's keys
        owners = vertex_owner_epoch(
            np.asarray([e.q.v for e in entries], np.int64),
            self._hash_shards, self._splits,
        )
        # sub-batch per (shard, trace group, has-deadline, pin):
        # untraced entries coalesce per shard; traced ones split per
        # group so every shard batch stays on exactly one trace;
        # deadline-less entries ride their own sub-batch so they
        # neither STRIP the wire deadline from bounded peers (which
        # would let a wedged shard hang them past their budget) nor
        # inherit one; pinned entries sub-batch per pin so
        # one wire txn field speaks for the whole sub-batch
        subs: dict = {}
        for e, s in zip(entries, owners.tolist()):
            vec = None if e.txn is None else e.txn.get("vec")
            if vec:
                s, e.pin = self._pin_route(vec, s)
            subs.setdefault(
                (s, id(e.grp) if e.grp else None, e.dl is None,
                 e.pin),
                []).append(e)
        for (s, _gk, dl_free, pin), es in subs.items():
            grp = es[0].grp
            if grp is not None:
                grp.shards.add(s)
            now = time.perf_counter()
            remaining = None
            if not dl_free:
                # the LOOSEST member deadline bounds the wire call; each
                # entry still re-checks its own budget at settle
                remaining = max(
                    0.001, max(e.dl for e in es) - now)
            ctx2 = None
            if grp is not None:
                ctx2 = _trace.TraceContext(
                    trace_id=grp.ctx.trace_id, parent_sid=grp.sid
                )
            txn_doc = None
            if pin is not None:
                # the per-owner wire form: ONE pin the shard must
                # honor or expire honestly (serving/txn.py codec)
                txn_doc = {
                    "id": es[0].txn.get("id", ""),
                    "pin": [int(pin[0]), str(pin[1])],
                }
            try:
                futs = self._clients[s].submit_batch(
                    [e.q for e in es], deadline_s=remaining, ctx=ctx2,
                    txn=txn_doc,
                )
            except BaseException as exc:
                # a synchronously-failing shard client (closed mid-
                # sweep): the error reaches the callers, but it must
                # ALSO leave fan-out evidence — an uncounted shard
                # failure would make a partial outage invisible
                get_registry().counter(
                    "router.shard_errors", shard=str(s)
                ).inc()
                for e in es:
                    self._settle(e, exc=exc)
                continue
            for e, f in zip(es, futs):
                f.add_done_callback(partial(self._shard_done, e, s))

    def _shard_done(self, e: _Entry, shard: int, fut) -> None:
        """Shard answer callback (the shard client's io thread): settle
        ONE entry — per-entry settling keeps a slow shard from holding
        up answers that already arrived from faster shards."""
        exc = fut.exception()
        if exc is not None:
            if not isinstance(exc, TxnSnapshotExpired):
                # a typed pin expiry is the transaction's honest
                # outcome (already counted at its raise/detect site),
                # not a shard failure
                get_registry().counter(
                    "router.shard_errors", shard=str(shard)
                ).inc()
            self._settle(e, exc=exc)
            return
        ans = fut.result()
        if ans.shard < 0:
            # stamp the routed shard so the client's TxnContext pins
            # (and its monotonic floor tracks) per shard, even when
            # the replica did not know its own index
            ans = dataclasses.replace(ans, shard=shard)
        if e.pin is not None:
            # a pinned answer is deliberately OLD: it must neither
            # seed the hot-key cache (a fresh lookup would re-serve
            # the pinned past) nor drive _observe_version (its low
            # version would read as a shard restart and reset the
            # router's high-water adoption state)
            self._settle(e, ans=ans)
            return
        self._observe_version(shard, ans.version)
        if self.cache_enabled:
            self._cache_put(e.key, ans, (int(ans.version),),
                            owner=shard)
        self._settle(e, ans=ans)

    # ------------------------------------------------------------------ #
    # Connected / component size: merged cross-shard forest
    # ------------------------------------------------------------------ #
    def _route_cc(self, entries: List[_Entry]) -> None:
        to_pull: list = []
        ready = False
        with self._mlock:
            stale = [
                s for s in range(self.nshards)
                if self._pulled_vers[s] < max(1, self._vers[s])
            ]
            if not stale and self._merged is not None:
                ready = True
            else:
                self._cc_waiting.append(entries)
                for s in stale:
                    if s not in self._pulls:
                        # protocol v2: once a baseline table is carried
                        # for the shard, ask for only the rows changed
                        # since it; -1 (v1 shape) pulls the full table
                        since = (
                            self._pulled_vers[s]
                            if self.delta and self._pulled_vers[s] >= 0
                            and self._rows[s] is not None else -1
                        )
                        self._pulls[s] = {"since": since, "t0": 0.0,
                                          "grp": None}
                        to_pull.append((s, since))
        if ready:
            self._answer_cc(entries)
            return
        # fire pulls OUTSIDE the lock (socket sends must never run
        # under router state locks)
        now = time.perf_counter()
        dls = [e.dl for e in entries if e.dl is not None]
        # bound the pull by the LOOSEST bounded requester: a
        # deadline-less co-swept entry must not make the pull (and the
        # bounded entries parked on it) unexpirable against a wedged
        # shard. Entries without a deadline accept the pull's outcome
        # either way — a failed pull fails them visibly, and the next
        # CC miss re-triggers a fresh pull.
        remaining = max(0.001, max(dls) - now) if dls else None
        # pulls serve EVERY parked group; attribute their spans to the
        # first TRACED entry's group (a shared refresh has one causal
        # home, and an untraced head entry must not orphan the join)
        grp = next((e.grp for e in entries if e.grp is not None), None)
        for s, since in to_pull:
            get_registry().counter("router.pulls").inc()
            ctx2 = None
            if grp is not None:
                grp.shards.add(s)
                ctx2 = _trace.TraceContext(
                    trace_id=grp.ctx.trace_id, parent_sid=grp.sid
                )
            # the reply callback reads this to attribute the pull span
            # and detect full-reply fallbacks (assignment is atomic;
            # the placeholder above already holds the pull slot)
            self._pulls[s] = {"since": since,
                              "t0": time.perf_counter(), "grp": grp}
            try:
                fut = self._clients[s].submit(
                    SummaryPullQuery(since_version=since),
                    deadline_s=remaining, ctx=ctx2,
                )
            except BaseException as exc:
                self._pull_done(s, _FailedFuture(exc))
                continue
            fut.add_done_callback(partial(self._pull_done, s))

    def _pull_done(self, shard: int, fut) -> None:
        jobs: list = []
        reg = get_registry()
        span = None   # (grp, t0, kind, rows, since)
        never: list = []
        with self._mlock:
            info = self._pulls.pop(shard, None) or {}
            since = int(info.get("since", -1))
            exc = fut.exception()
            if exc is None:
                try:
                    ans = fut.result()
                    dec = decode_pull(ans.value)
                    v = int(ans.version)
                    if dec["kind"] == "delta":
                        if (self._rows[shard] is None
                                or dec["base"] !=
                                self._pulled_vers[shard]):
                            # a delta against a baseline this router no
                            # longer holds (restart adoption raced the
                            # reply) cannot be applied
                            raise MalformedPull(
                                "base",
                                f"delta pull base {dec['base']} does "
                                f"not match the carried baseline "
                                f"{self._pulled_vers[shard]}",
                            )
                        reg.counter("router.delta_pulls").inc()
                        reg.counter("router.delta_rows").inc(dec["n"])
                        reg.counter("router.pull_bytes",
                                    kind="delta").inc(
                            PULL_ROW_BYTES * dec["n"])
                        # the delta lists EVERY row whose root changed,
                        # so a plain update keeps the carried table
                        # exact (not merely approximate)
                        self._rows[shard].update(
                            zip(dec["u"].tolist(), dec["r"].tolist()))
                        self._delta_pending.append((dec["u"], dec["r"]))
                    else:
                        reg.counter("router.pull_bytes",
                                    kind="full").inc(
                            PULL_ROW_BYTES * dec["n"])
                        if since >= 0:
                            # we asked for a delta and got the whole
                            # table: an honest degrade (stale ring, no
                            # chain, restarted store) or a v1 peer
                            # that never read the field — either way
                            # the baseline resets to this full table
                            reg.counter(
                                "router.full_fallbacks",
                                reason=dec["why"] or "peer_full",
                            ).inc()
                        self._pairs[shard] = (dec["u"], dec["r"])
                        if self.delta:
                            self._rows[shard] = dict(
                                zip(dec["u"].tolist(),
                                    dec["r"].tolist()))
                        self._full_pending = True
                    self._pulled_vers[shard] = v
                    self._pull_meta[shard] = (
                        int(ans.window), int(ans.watermark),
                        int(ans.staleness), int(ans.event_ts),
                    )
                    self._pull_err[shard] = None
                    cur = self._vers[shard]
                    if v > cur:
                        self._vers[shard] = v
                    elif v + self.VERSION_RESTART_SLACK < cur:
                        # the pull itself met a restarted sequence
                        # (promoted standby): adopt it — pulled_vers
                        # already records the new sequence's version
                        reg.counter(
                            "router.shard_restarts", shard=str(shard)
                        ).inc()
                        self._vers[shard] = v
                    if info.get("grp") is not None:
                        span = (info["grp"], float(info.get("t0", 0.0)),
                                dec["kind"], int(dec["n"]), since)
                except (ValueError, KeyError, TypeError) as e:
                    exc = e
            if exc is not None:
                reg.counter(
                    "router.pull_errors", shard=str(shard)
                ).inc()
                self._pull_err[shard] = exc
                if self._shard_cols(shard) is not None:
                    # a previous pull exists: the merge proceeds on the
                    # stale summary (bounded-staleness availability)
                    reg.counter("router.stale_merges").inc()
            pending_more = bool(self._pulls)
            if not pending_more:
                never = [
                    s for s in range(self.nshards)
                    if self._shard_cols(s) is None
                ]
                if not never:
                    t0m = time.perf_counter()
                    if (self.delta and self._merged is not None
                            and not self._full_pending):
                        self._apply_deltas_locked()
                        kind = "delta"
                    else:
                        self._rebuild_merged_locked()
                        kind = "full"
                    reg.counter("router.merges", kind=kind).inc()
                    reg.counter("router.merge_s", kind=kind).inc(
                        time.perf_counter() - t0m)
                jobs = self._cc_waiting
                self._cc_waiting = []
        if span is not None:
            grp, t0, kind, rows, since = span
            _trace.record_span(
                "serving.router.pull",
                time.perf_counter() - t0,
                trace_id=grp.ctx.trace_id,
                parent=grp.sid,
                sid=_trace.next_sid(),
                attrs={"shard": shard, "kind": kind, "rows": rows,
                       "since": since},
            )
        if pending_more:
            return  # later pulls complete the rendezvous
        if never:
            # a shard that never delivered ANY summary cannot be merged
            # around: exactness over availability at boot — fail these
            # entries with the shard's own error
            err = next(
                (self._pull_err[s] for s in never
                 if self._pull_err[s] is not None),
                RuntimeError(f"shards {never} never delivered a "
                             "summary pull"),
            )
            for entries in jobs:
                for e in entries:
                    self._settle(e, exc=err)
            return
        for entries in jobs:
            self._answer_cc(entries)

    def _shard_cols(self, s: int):
        """This shard's current (raw, root) columns — the delta-carried
        row table when present (always current: full replies replace
        it, delta replies patch it exactly), else the last full pull's
        columns; None when the shard never delivered."""
        d = self._rows[s]
        if d is not None:
            u = np.fromiter(d.keys(), np.int64, len(d))
            r = np.fromiter(d.values(), np.int64, len(d))
            return u, r
        return self._pairs[s]

    def _meta_locked(self) -> tuple:
        """Merged answer meta from the newest per-shard pulls (caller
        holds ``_mlock``): MIN window (conservative progress), summed
        watermark, MAX staleness, summed versions, MIN event-time
        watermark (the cross-shard merge rule
        :func:`gelly_streaming_tpu_torch.eventtime.watermark.merge_watermarks`
        applies: a merged answer is only as current as its
        laggiest shard; shards without event time (-1) are left out,
        -1 when none carries it)."""
        metas = [m for m in self._pull_meta if m is not None]
        stamped = [
            m[3] for m in metas if len(m) > 3 and m[3] >= 0
        ]
        return (
            min(m[0] for m in metas) if metas else -1,
            sum(m[1] for m in metas),
            max(m[2] for m in metas) if metas else 0,
            sum(max(0, v) for v in self._pulled_vers),
            min(stamped) if stamped else -1,
        )

    def _rebuild_merged_locked(self) -> None:
        """Rebuild the merged forest from the carried per-shard tables.
        Caller holds ``_mlock``. Each shard's raw-id pairs densify into
        a forest table over the UNION id space (sorted raw order
        preserves the min-rooted invariant), and one
        :func:`~gelly_streaming_tpu_torch.summaries.forest.merge_forest_tables_host`
        call — THE cross-shard union step — merges them all. Resets the
        delta bookkeeping: pending rows are already folded into the
        carried tables, and the selective-invalidation history cannot
        chain across a rebuild."""
        from ..summaries.forest import merge_forest_tables_host

        cols = [self._shard_cols(s) for s in range(self.nshards)]
        us = [c[0] for c in cols]
        uniq = np.unique(np.concatenate(us)) if us else \
            np.zeros(0, np.int64)
        n = len(uniq)
        tables = []
        for u, r in cols:
            t = np.arange(n, dtype=np.int64)
            t[np.searchsorted(uniq, u)] = np.searchsorted(uniq, r)
            tables.append(t)
        lab = merge_forest_tables_host(tables)
        sizes = np.bincount(lab, minlength=n) if n else \
            np.zeros(0, np.int64)
        self._merged = _MergedCC(
            uniq, lab, sizes, self._meta_locked(),
            tuple(self._pulled_vers),
        )
        self._delta_pending = []
        self._delta_hist.clear()
        self._full_pending = False

    def _apply_deltas_locked(self) -> None:
        """Fold the delta rows accepted since the last refresh into the
        carried merged forest — O(changed rows), the refresh cost the
        delta protocol buys — and record which components they touched
        so provably-untouched cache entries survive the version bump.
        Caller holds ``_mlock``; requires ``self._merged``."""
        from ..summaries.forest import apply_forest_delta_host

        m = self._merged
        from_stamp = m.stamp
        touched: set = set()
        for u, r in self._delta_pending:
            if not len(u):
                continue
            iu = m.ensure_ids(u)
            ir = m.ensure_ids(r)
            t = apply_forest_delta_host(m.lab, m.sizes, iu, ir)
            if len(t):
                touched.update(m.raw_of[t].tolist())
        self._delta_pending = []
        m.meta = self._meta_locked()
        stamp = tuple(self._pulled_vers)
        if stamp != from_stamp:
            self._delta_hist.append(
                (from_stamp, stamp, frozenset(touched)))
        m.stamp = stamp

    def _answer_cc(self, entries: List[_Entry]) -> None:
        qs = [e.q for e in entries]
        conn_idx = [i for i, q in enumerate(qs)
                    if isinstance(q, ConnectedQuery)]
        size_idx = [i for i, q in enumerate(qs)
                    if isinstance(q, ComponentSizeQuery)]
        vals: dict = {}
        roots_of: dict = {}
        # compute under _mlock: the carried forest mutates IN PLACE on
        # delta refreshes (unlike the old swap-a-tuple rebuild), so
        # reads must not interleave with an apply
        with self._mlock:
            m = self._merged
            meta, stamp = m.meta, m.stamp
            if conn_idx:
                us = np.asarray([qs[i].u for i in conn_idx], np.int64)
                vs = np.asarray([qs[i].v for i in conn_idx], np.int64)
                iu, fu = m.lookup(us)
                iv, fv = m.lookup(vs)
                ok = fu & fv
                ru = m.roots(np.where(fu, iu, 0))
                rv = m.roots(np.where(fv, iv, 0))
                # an unseen vertex is its own singleton — connected
                # only to itself (the single-host engine's semantics)
                got = np.where(ok, ru == rv, us == vs)
                rud, rvd = m.raw_of[ru], m.raw_of[rv]
                for k, i in enumerate(conn_idx):
                    vals[i] = bool(got[k])
                    # the RAW roots this answer depends on; an unseen
                    # endpoint's own id stands in (if it ever appears
                    # and merges, it shows up in a touched set)
                    roots_of[i] = frozenset((
                        int(rud[k]) if fu[k] else int(us[k]),
                        int(rvd[k]) if fv[k] else int(vs[k]),
                    ))
            if size_idx:
                vs = np.asarray([qs[i].v for i in size_idx], np.int64)
                iv, fv = m.lookup(vs)
                rv = m.roots(np.where(fv, iv, 0))
                got = np.where(fv, m.sizes[rv], 0)
                rvd = m.raw_of[rv]
                for k, i in enumerate(size_idx):
                    vals[i] = int(got[k])
                    roots_of[i] = frozenset(
                        (int(rvd[k]) if fv[k] else int(vs[k]),))
        window, watermark, staleness, version, event_ts = meta
        for i, e in enumerate(entries):
            ans = Answer(
                value=vals[i], window=window, watermark=watermark,
                staleness=staleness, version=version, event_ts=event_ts,
            )
            if self.cache_enabled:
                self._cache_put(e.key, ans, stamp,
                                roots=roots_of.get(i))
            self._settle(e, ans=ans)

    # ------------------------------------------------------------------ #
    # Connected / component size under a transaction vector
    # ------------------------------------------------------------------ #
    def _route_cc_pinned(self, entries: List[_Entry]) -> None:
        """Merged-forest classes pinned by a transaction vector.

        The shared carried forest (:meth:`_route_cc`) is always-fresh
        by design, so pinned requests build their OWN merged forest
        from per-shard pulls issued AT the pinned versions (the pin
        rides the pull as the per-shard wire form), kept in a small
        LRU keyed by the vector — a repeated read inside one
        transaction reuses the same forest object and is byte-identical
        by construction. Shards the vector does not pin are pulled
        fresh ONCE and baked into that forest (partial pins stay
        self-consistent across repeats while the LRU holds the entry —
        the documented best-effort residual). Any shard that cannot
        serve its pin fails the whole group with the shard's own typed
        :class:`~.txn.TxnSnapshotExpired` — never a fresher merge."""
        groups: "OrderedDict[tuple, List[_Entry]]" = OrderedDict()
        for e in entries:
            vec = e.txn.get("vec") or {}
            key = tuple(sorted(
                (int(s), int(p[0]), str(p[1])) for s, p in vec.items()
            ))
            groups.setdefault(key, []).append(e)
        for _key, es in groups.items():
            vec = es[0].txn.get("vec") or {}
            now = time.perf_counter()
            dls = [e.dl for e in es if e.dl is not None]
            remaining = max(0.001, max(dls) - now) if dls else None
            try:
                m = self._pinned_forest(
                    vec, es[0].txn.get("id", ""), remaining)
            except BaseException as exc:
                if not isinstance(exc, TxnSnapshotExpired):
                    get_registry().counter(
                        "router.pinned_pull_errors").inc()
                for e in es:
                    self._settle(e, exc=exc)
                continue
            self._answer_cc_pinned(es, m)

    def _pinned_forest(self, vec: dict, txn_id: str,
                       remaining: Optional[float]) -> _MergedCC:
        """The merged forest at one transaction vector (LRU-cached,
        cap ``PINNED_MERGED_CAP``). Pulls run SYNCHRONOUSLY on the
        router worker bounded by the requesters' deadlines (else
        ``PINNED_PULL_TIMEOUT_S``) — the client io threads complete
        the futures, so the wait cannot deadlock; a pinned refresh
        deliberately does not share the fresh path's rendezvous
        machinery (its state is per-vector, not per-router)."""
        from ..summaries.forest import merge_forest_tables_host

        key = tuple(sorted(
            (int(s), int(p[0]), str(p[1])) for s, p in vec.items()
        ))
        with self._mlock:
            m = self._pinned_merged.get(key)
            if m is not None:
                self._pinned_merged.move_to_end(key)
                return m
        reg = get_registry()
        # target shards: every current shard EXCEPT a split child
        # whose pinned ancestor is being pulled — a parent-version
        # pin predates the split, so the parent's pinned table is a
        # superset of the rows the child held at that version
        targets: List[tuple] = []
        for s in range(self.nshards):
            rs, _pin = self._pin_route(vec, s)
            if rs != s:
                continue
            targets.append((s, vec.get(s)))
        if remaining is None:
            remaining = PINNED_PULL_TIMEOUT_S
        futs: List[tuple] = []
        for s, pin in targets:
            since, base = -1, None
            if pin is not None and self.delta:
                with self._mlock:
                    pulled = self._pulled_vers[s]
                    if (0 <= pulled < int(pin[0])
                            and self._rows[s] is not None):
                        # the fresh path's carried baseline PRECEDES
                        # the pin: ask for only the rows changed since
                        # it (the shard's ring-backed delta chain
                        # serves historical ``since``); copy the rows NOW,
                        # under the lock, before the fresh path can
                        # advance them past the baseline we claim
                        since = pulled
                        base = dict(self._rows[s])
            tdoc = None
            if pin is not None:
                tdoc = {"id": str(txn_id),
                        "pin": [int(pin[0]), str(pin[1])]}
            reg.counter("router.pinned_pulls").inc()
            try:
                fut = self._clients[s].submit(
                    SummaryPullQuery(since_version=since),
                    deadline_s=remaining, txn=tdoc,
                )
            except BaseException as exc:
                # deferred, not swallowed: the gather below re-raises
                # it for the whole group (counted here so a dead
                # client still leaves wire-side evidence)
                reg.counter("router.swallowed",
                            site="pinned_pull_submit").inc()
                fut = _FailedFuture(exc)
            futs.append((s, pin, since, base, fut))
        cols: List[tuple] = []
        metas: List[tuple] = []
        vers_sum = 0
        deadline = time.perf_counter() + remaining
        for s, pin, since, base, fut in futs:
            ans = fut.result(max(0.001, deadline - time.perf_counter()))
            dec = decode_pull(ans.value)
            if dec["kind"] == "delta":
                if base is None or dec["base"] != since:
                    raise MalformedPull(
                        "base",
                        f"pinned delta pull base {dec['base']} does "
                        f"not match the carried baseline {since}",
                    )
                rows = base
                rows.update(
                    zip(dec["u"].tolist(), dec["r"].tolist()))
            else:
                rows = dict(
                    zip(dec["u"].tolist(), dec["r"].tolist()))
            u = np.fromiter(rows.keys(), np.int64, len(rows))
            r = np.fromiter(rows.values(), np.int64, len(rows))
            cols.append((u, r))
            metas.append((int(ans.window), int(ans.watermark),
                          int(ans.staleness), int(ans.event_ts)))
            vers_sum += int(pin[0]) if pin is not None \
                else max(0, int(ans.version))
        uniq = np.unique(np.concatenate([c[0] for c in cols])) \
            if cols else np.zeros(0, np.int64)
        n = len(uniq)
        tables = []
        for u, r in cols:
            t = np.arange(n, dtype=np.int64)
            t[np.searchsorted(uniq, u)] = np.searchsorted(uniq, r)
            tables.append(t)
        lab = merge_forest_tables_host(tables)
        sizes = np.bincount(lab, minlength=n) if n else \
            np.zeros(0, np.int64)
        stamped = [m[3] for m in metas if m[3] >= 0]
        meta = (
            min(m[0] for m in metas) if metas else -1,
            sum(m[1] for m in metas),
            max(m[2] for m in metas) if metas else 0,
            vers_sum,
            min(stamped) if stamped else -1,
        )
        m = _MergedCC(uniq, lab, sizes, meta, key)
        with self._mlock:
            self._pinned_merged[key] = m
            self._pinned_merged.move_to_end(key)
            while len(self._pinned_merged) > PINNED_MERGED_CAP:
                self._pinned_merged.popitem(last=False)
        reg.counter("router.pinned_merges").inc()
        return m

    def _answer_cc_pinned(self, entries: List[_Entry],
                          m: _MergedCC) -> None:
        """Answer merged-forest entries from one PINNED forest — the
        :meth:`_answer_cc` lookup semantics, minus the cache (the
        pinned-forest LRU is the reuse path; the router cache serves
        fresh readers) and minus ``_mlock`` (a pinned forest is
        immutable once built — deltas never apply to it)."""
        window, watermark, staleness, version, event_ts = m.meta
        for e in entries:
            q = e.q
            if isinstance(q, ConnectedQuery):
                iu, fu = m.lookup(np.asarray([q.u], np.int64))
                iv, fv = m.lookup(np.asarray([q.v], np.int64))
                if fu[0] and fv[0]:
                    val: object = bool(
                        m.roots(iu)[0] == m.roots(iv)[0])
                else:
                    val = bool(int(q.u) == int(q.v))
            else:
                iv, fv = m.lookup(np.asarray([q.v], np.int64))
                val = int(m.sizes[m.roots(iv)[0]]) if fv[0] else 0
            self._settle(e, ans=Answer(
                value=val, window=window, watermark=watermark,
                staleness=staleness, version=version,
                event_ts=event_ts,
            ))

    @staticmethod
    def _lookup(uniq: np.ndarray, raw: np.ndarray
                ) -> Tuple[np.ndarray, np.ndarray]:
        """(dense index, found mask) of raw ids in the merged id table;
        missing ids index slot 0 with found=False."""
        if len(uniq) == 0:
            z = np.zeros(len(raw), np.int64)
            return z, np.zeros(len(raw), bool)
        i = np.searchsorted(uniq, raw)
        i = np.minimum(i, len(uniq) - 1)
        return i, uniq[i] == raw

    # ------------------------------------------------------------------ #
    # Cache
    # ------------------------------------------------------------------ #
    @staticmethod
    def _cache_key(q: Query) -> tuple:
        if isinstance(q, ConnectedQuery):
            u, v = int(q.u), int(q.v)
            # connectivity is symmetric; one entry serves both orders
            return ("C", min(u, v), max(u, v))
        tag = {DegreeQuery: "D", RankQuery: "R",
               ComponentSizeQuery: "S"}[type(q)]
        return (tag, int(q.v))

    def _cache_get(self, key: tuple,
                   pin: Optional[tuple] = None) -> Optional[Answer]:
        with self._lock:
            entry = self._cache.get(key)
            if entry is None:
                return None
            if pin is not None:
                # pinned lookup: serve the entry ONLY when
                # it was computed at exactly the pinned snapshot — an
                # exact (version, boot) compare, never the freshness
                # rules (a pinned hit is deliberately old and must not
                # be invalidated for it; a mismatch is a plain miss,
                # the fan-out answers at the pin)
                if (entry.owner is not None
                        and (entry.ans.version, entry.ans.boot)
                        == (int(pin[0]), str(pin[1]))):
                    self._cache.move_to_end(key)
                    return entry.ans
                return None
            if self.cache_ttl_s is not None and \
                    time.monotonic() - entry.ts > self.cache_ttl_s:
                del self._cache[key]
                self._c_inval.inc()
                return None
        expected = (
            (self._vers[entry.owner],) if entry.owner is not None
            else tuple(self._vers)
        )
        if entry.vers != expected:
            if (entry.owner is None and entry.roots is not None
                    and self.delta and self._revalidate(entry)):
                # the delta history proves every component this answer
                # depends on was untouched by the intervening refreshes
                self._c_retained.inc()
            else:
                # a reply frame observed a newer shard version than
                # this answer was computed from: lazily invalidate
                # (counted) — the next miss re-fans-out / re-pulls at
                # the new version
                with self._lock:
                    self._cache.pop(key, None)
                self._c_inval.inc()
                return None
        with self._lock:
            if key in self._cache:
                self._cache.move_to_end(key)
        return entry.ans

    def _revalidate(self, entry: _CacheEntry) -> bool:
        """Selective invalidation: walk the delta-refresh history from
        the entry's stamp to the carried forest's current stamp. If no
        hop's touched-component set intersects the entry's roots, the
        answer provably still holds — re-stamp it and keep it."""
        with self._mlock:
            m = self._merged
            if m is None or tuple(self._vers) != m.stamp:
                return False   # a refresh is in flight; stay lazy
            v = entry.vers
            hops = 0
            while v != m.stamp:
                nxt = None
                for h in self._delta_hist:
                    if h[0] == v:
                        nxt = h
                        break
                if nxt is None or entry.roots & nxt[2]:
                    return False
                v = nxt[1]
                hops += 1
                if hops > len(self._delta_hist):
                    return False   # defensive: broken chain
            entry.vers = m.stamp
            return True

    def _cache_put(self, key: tuple, ans: Answer, vers: tuple,
                   owner: Optional[int] = None,
                   roots: Optional[frozenset] = None) -> None:
        with self._lock:
            self._cache[key] = _CacheEntry(
                ans, vers, time.monotonic(), owner, roots
            )
            self._cache.move_to_end(key)
            while len(self._cache) > self.cache_cap:
                self._cache.popitem(last=False)

    #: how far BELOW the observed high-water a reply's version may sit
    #: before it reads as a RESTARTED sequence rather than ordinary
    #: answer skew (prefer_ready serves up to READY_LOOKBACK=3 windows
    #: behind head; sweeps add a little more)
    VERSION_RESTART_SLACK = 8

    def _observe_version(self, shard: int, version: int) -> None:
        version = int(version)
        if not version or version == self._vers[shard]:
            return
        with self._mlock:
            cur = self._vers[shard]
            if version > cur:
                self._vers[shard] = version
            elif version + self.VERSION_RESTART_SLACK < cur:
                # a version sequence far below this shard's observed
                # high-water: a promoted standby publishes from a FRESH
                # store whose counter restarts at 1, so monotone
                # ratcheting would pin the old primary's answers in the
                # cache forever. Adopt the new sequence: the version
                # vector changes, so every entry stamped against the
                # old sequence lazily invalidates, and the merged CC
                # forest re-pulls at the new shard's state.
                get_registry().counter(
                    "router.shard_restarts", shard=str(shard)
                ).inc()
                self._vers[shard] = version
                self._pulled_vers[shard] = -1

    # ------------------------------------------------------------------ #
    # Settling
    # ------------------------------------------------------------------ #
    def _expire(self, e: _Entry) -> None:
        from ..resilience.errors import DeadlineExceeded

        get_registry().counter("serving.deadline_expired").inc()
        self._set_exc(e.f, DeadlineExceeded(
            f"{type(e.q).__name__} unanswered after its "
            f"{(e.dl - e.t0):.3f}s deadline"
        ))
        self._finish(e)

    def _settle(self, e: _Entry, ans: Optional[Answer] = None,
                exc: Optional[BaseException] = None) -> None:
        if ans is not None:
            now = time.perf_counter()
            if e.dl is not None and now > e.dl:
                # answered late: honor the deadline over a stale answer
                self._expire(e)
                return
            self._set_res(e.f, ans)
        else:
            self._set_exc(e.f, exc)
        self._finish(e)

    def _finish(self, e: _Entry) -> None:
        with self._lock:
            if e.done:
                return  # the sweep guard may re-settle an entry a
                # callback already answered; account it exactly once
            e.done = True
            self._inflight -= 1
        g = e.grp
        if g is not None and g.done_one():
            _trace.record_span(
                "serving.router.fanout",
                time.perf_counter() - g.t0,
                trace_id=g.ctx.trace_id,
                parent=g.ctx.parent_sid,
                sid=g.sid,
                attrs={
                    "n": g.hits + g.misses,
                    "hits": g.hits,
                    "misses": g.misses,
                    "shards": len(g.shards),
                },
            )

    @staticmethod
    def _set_res(f: Future, ans: Answer) -> None:
        if not f.done():
            try:
                f.set_result(ans)
            except InvalidStateError:
                get_registry().counter(
                    "router.swallowed", site="settle_race"
                ).inc()

    @staticmethod
    def _set_exc(f: Future, exc: BaseException) -> None:
        if not f.done():
            try:
                f.set_exception(exc)
            except InvalidStateError:
                get_registry().counter(
                    "router.swallowed", site="settle_race"
                ).inc()

    # ------------------------------------------------------------------ #
    def close(self, timeout: float = 30.0) -> None:
        """Stop the worker, fail leftovers, close every shard client.
        One budget across all the joins/closes."""
        with self._lock:
            if self._closing:
                return
            self._closing = True
        deadline = time.monotonic() + float(timeout)
        self._wake.set()
        self._worker.join(max(0.0, deadline - time.monotonic()))
        with self._lock:
            leftovers = list(self._pending)
            self._pending.clear()
        err = RuntimeError("router closed with the query pending")
        for e in leftovers:
            self._set_exc(e.f, err)
        for c in self._clients:
            c.close()


class _FailedFuture:
    """Minimal already-failed future (submit raised synchronously)."""

    __slots__ = ("_exc",)

    def __init__(self, exc: BaseException):
        self._exc = exc

    def exception(self):
        return self._exc

    def result(self, timeout: Optional[float] = None):
        raise self._exc


# --------------------------------------------------------------------- #
# Shard demo servable (real CC + degrees over a partitioned stream)
# --------------------------------------------------------------------- #
def demo_shard_edges(n_vertices: int, n_edges: int, seed: int
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """The sharded scenario/test stream: deterministic uniform edges, the
    SAME columns in every process that passes the same arguments — the
    property the cross-process oracle identity rests on."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n_vertices, n_edges, dtype=np.int64)
    dst = rng.integers(0, n_vertices, n_edges, dtype=np.int64)
    return src, dst


def shard_demo_payloads(
    *,
    n_vertices: int,
    n_edges: int,
    seed: int = 7,
    window: int = 1024,
    shard: int = 0,
    nshards: int = 1,
    pace_s: float = 0.0,
    churn_bumps: int = 0,
    churn_edges: int = 0,
    churn_seed: int = 1000,
    churn_pace_s: float = 0.0,
    churn_gate: Optional[str] = None,
    device="cuda",
):
    """One shard's servable: fold the edges this shard OWNS
    (:func:`~gelly_streaming_tpu_torch.core.ingest.partition_edges_by_vertex`)
    into a live min-rooted CC forest + degree table, one snapshot per
    count window. ``nshards=1`` is the single-host oracle — the same
    code folding the WHOLE stream, which is what the identity tests and
    the single-shard baseline serve from.

    After the main stream, ``churn_bumps`` extra versions each fold
    this shard's slice of ``churn_edges`` global edges drawn from
    ``churn_seed`` — a low-rate live-ingest tail the delta-pull churn
    cell measures against. The k-th bump folds global slice
    ``[k*churn_edges, (k+1)*churn_edges)``, so a caller can rebuild the
    identical stream for an oracle check. ``churn_gate`` (a path) holds
    the churn tail until the file EXISTS: the measuring scenario touches
    it once its routers are up, so the paced bumps overlap live query
    traffic instead of racing the routers' boot (bounded wait — a
    caller that never touches the gate releases the tail after 120s
    rather than wedging the shard).

    ``device`` (the port's addition, default ``"cuda"``; raises without
    a card unless ``"cpu"``) is where each version's tables live: the
    fold stays the reference's host numpy, so forests and pulled bytes
    equal the JAX package's, and each version's ``labels`` (int32) and
    ``deg`` (int64) are uploaded as FRESH tensors on ``device`` — a
    published snapshot is never written again — so the replica's query
    steps run on the card. The device is resolved when this is called,
    before the generator is returned."""
    from ..core.device import resolve_device

    return _shard_versions(
        n_vertices, n_edges, seed, window, shard, nshards, pace_s,
        churn_bumps, churn_edges, churn_seed, churn_pace_s, churn_gate,
        resolve_device(device),
    )


def _shard_versions(n_vertices, n_edges, seed, window, shard, nshards,
                    pace_s, churn_bumps, churn_edges, churn_seed,
                    churn_pace_s, churn_gate, device):
    """The generator behind :func:`shard_demo_payloads`."""
    import torch

    from ..datasets import IdentityDict
    from ..core.ingest import partition_edges_by_vertex
    from ..summaries.forest import fold_edges_host

    def version(lab, deg):
        return {"labels": torch.tensor(lab, device=device),
                "deg": torch.tensor(deg, device=device), "vdict": vd}

    src, dst = demo_shard_edges(n_vertices, n_edges, seed)
    s, d, _v = partition_edges_by_vertex(src, dst, None, nshards)[shard]
    vd = IdentityDict(n_vertices)
    vd.observe(n_vertices - 1)  # full-keyspace parity (see summary_pull)
    lab = np.arange(n_vertices, dtype=np.int32)
    deg = np.zeros(n_vertices, np.int64)
    done = 0
    for a in range(0, max(1, len(s)), window):
        b = min(a + window, len(s))
        if b > a:
            lab = fold_edges_host(lab, s[a:b], d[a:b])
            deg += np.bincount(s[a:b], minlength=n_vertices)
            deg += np.bincount(d[a:b], minlength=n_vertices)
            done += b - a
        yield version(lab, deg), done
        if pace_s:
            time.sleep(pace_s)
    if churn_bumps and churn_edges:
        if churn_gate:
            gate_dl = time.monotonic() + 120.0
            while (not os.path.exists(churn_gate)
                   and time.monotonic() < gate_dl):
                time.sleep(0.02)
        csrc, cdst = demo_shard_edges(
            n_vertices, churn_bumps * churn_edges, churn_seed)
        for k in range(churn_bumps):
            a, b = k * churn_edges, (k + 1) * churn_edges
            cs, cd, _cv = partition_edges_by_vertex(
                csrc[a:b], cdst[a:b], None, nshards)[shard]
            if len(cs):
                lab = fold_edges_host(lab, cs, cd)
                deg += np.bincount(cs, minlength=n_vertices)
                deg += np.bincount(cd, minlength=n_vertices)
                done += len(cs)
            yield version(lab, deg), done
            if churn_pace_s:
                time.sleep(churn_pace_s)


# --------------------------------------------------------------------- #
# Router binary (subprocess entry, mirrors rpc.replica_main)
# --------------------------------------------------------------------- #
def router_main(cfg: dict) -> None:
    """The router as a real process. ``cfg`` keys: ``shards`` (one
    address list per shard), ``portfile``, optional ``events`` (ShardSink
    path + ``shard`` label), ``cache``/``cache_cap``/``cache_ttl_s``,
    ``delta`` (pull protocol v2 on/off), ``run_s``, ``meta``.

    Also ``autotune``/``target_wait_s`` (load-aware admission),
    ``reshard`` (split-plan store dir — live ownership
    epoch adoption; the router's own reply frames re-stamp the adopted
    epoch, so clients of a router FLEET converge too)."""
    import json
    import signal

    from ..obs import trace as obs_trace
    from ..obs.cluster import ShardSink
    from .rpc import RpcServer

    sink = None
    if cfg.get("events"):
        sink = ShardSink(cfg["events"], shard=cfg.get("shard"))
        get_registry().add_sink(sink)
        obs_trace.add_sink(sink)
        obs_trace.enable(registry_spans=False)
    kw = {}
    if cfg.get("autotune"):
        kw["autotune"] = True
        if cfg.get("target_wait_s") is not None:
            kw["target_wait_s"] = float(cfg["target_wait_s"])
    if cfg.get("reshard"):
        kw["reshard"] = cfg["reshard"]
    router = ShardRouter(
        cfg["shards"],
        cache=bool(cfg.get("cache", True)),
        cache_cap=int(cfg.get("cache_cap", DEFAULT_CACHE_CAP)),
        cache_ttl_s=cfg.get("cache_ttl_s"),
        max_pending=int(cfg.get("max_pending", 1 << 14)),
        delta=bool(cfg.get("delta", True)),
        **kw,
    )
    rpc = RpcServer(router, epoch=lambda: router._epoch,
                    txn_narrow=False).start()
    if cfg.get("portfile"):
        from ..resilience import integrity

        tmp = cfg["portfile"] + ".tmp"
        with open(tmp, "w") as f:
            f.write(str(rpc.port))
        integrity.replace_atomic(tmp, cfg["portfile"])
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    deadline = time.monotonic() + float(cfg.get("run_s", 600.0))
    while not stop.is_set() and time.monotonic() < deadline:
        stop.wait(0.05)
    meta = dict(router.stats_snapshot(), port=rpc.port)
    rpc.close()
    router.close()
    if cfg.get("meta"):
        with open(cfg["meta"], "w") as f:
            json.dump(meta, f)
    if sink is not None:
        sink.close()
        get_registry().remove_sink(sink)


def spawn_router(cfg: dict):
    """Launch the router binary detached, logging next to its portfile
    (same discipline as :func:`~.rpc.spawn_replica`). The child sees no
    card (``CUDA_VISIBLE_DEVICES=""``): a router holds no device state."""
    import json
    import os
    import subprocess
    import sys as _sys

    from .rpc import REPO_ROOT

    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    log_path = (cfg.get("portfile") or "router") + ".log"
    code = (
        "import sys, json; "
        f"sys.path.insert(0, {REPO_ROOT!r}); "
        "from gelly_streaming_tpu_torch.serving import router; "
        "router.router_main(json.loads(sys.argv[1]))"
    )
    logf = open(log_path, "wb")
    try:
        p = subprocess.Popen(
            [_sys.executable, "-c", code, json.dumps(cfg)],
            stdout=logf, stderr=subprocess.STDOUT, env=env,
        )
    finally:
        logf.close()  # the child holds its own dup of the fd
    p.log_path = log_path
    return p


if __name__ == "__main__":
    import json
    import sys

    if "--router" in sys.argv:
        router_main(json.loads(
            sys.argv[sys.argv.index("--router") + 1]
        ))
        sys.exit(0)
    print(
        "usage: python -m gelly_streaming_tpu_torch.serving.router "
        "--router '<json cfg>'",
        file=sys.stderr,
    )
    sys.exit(2)
