"""Live query serving over streaming summaries (the read path; the port's
copy of ``gelly_streaming_tpu/serving/``).

Point queries (``connected(u, v)``, ``degree(v)``, ``rank(v)``, component
size, bipartiteness) answered from the most recent published summary with
bounded staleness, without stalling ingestion:

- :mod:`snapshot_store` — a wait-free publish/read split: the ingest
  loop publishes an immutable :class:`PublishedSnapshot` (summary payload
  + window index + watermark) after each window; readers grab the latest
  by one atomic reference read, never a lock shared with the writer.
- :mod:`query` — typed point queries plus a :class:`QueryEngine` that
  answers a whole concurrent batch with ONE vectorized lookup per query
  class (a batch root chase for CC, a table gather for degrees/ranks),
  as torch steps on the card or numpy on the host.
- :mod:`server` — :class:`StreamServer`: runs any emission iterator on a
  background thread, publishes snapshots, exposes ``submit(query) ->
  Future`` and a synchronous ``ask()``, rejects with :class:`Overloaded`
  past the admission limit, and drains cleanly on ``close()``.
- :mod:`failover` — :class:`FailoverServer`: a standby ``StreamServer``
  attached to the shared snapshot store, promoted when the primary's
  query worker dies.
- :mod:`stats` — per-query-class latency histograms + staleness gauges,
  exported as plain dict snapshots.
- :mod:`txn` — snapshot-pinned read transactions: a
  :class:`~.txn.TxnContext` pins ``{shard: (version, boot)}`` from
  ordinary reply stamps; a later read is answered AT the pinned snapshot
  or raises the typed :class:`~.txn.TxnSnapshotExpired`.
- :mod:`rpc` / :mod:`client` — the wire: :class:`RpcServer`,
  :class:`ReplicaServer` (a cross-process primary/standby pair on a
  shared snapshot directory with a heartbeat lease) and
  :class:`RpcClient` (retries, resubmit under the same batch id, deadline
  budgets, trace context). Frames are the reference's, byte for byte.
- :mod:`router` — :class:`ShardRouter`: the sharded-serving tier —
  vertex-ownership partition over N shard servers, scatter-gather
  fan-out with per-class merges (cross-shard CC union via summary
  pulls + the group-fold merge), a version-stamped hot-key answer
  cache, and per-shard failover through each shard's address list. A
  router holds no device state: its merges are host numpy.
- :mod:`reshard` — elastic resharding: one-winner split plans elected
  over the fabric, child-address publication, the dense
  actionable-prefix rule that defines the live ownership epoch, and the
  :class:`~.reshard.ReshardWatcher` replicas and routers adopt it
  through.

Workloads opt in via a small ``servable()`` adapter
(``library/connected_components.py``, ``library/degrees.py``,
``library/pagerank.py``, ``library/bipartiteness.py``) mapping their
carry to a snapshot payload; ``aggregate/checkpoint.py:restore_server``
boots a server from a checkpoint so it serves the restored summary while
catching up.
"""

from .query import (
    Answer,
    BipartiteQuery,
    ComponentSizeQuery,
    ConnectedQuery,
    DegreeQuery,
    Query,
    QueryEngine,
    RankQuery,
    SummaryPullQuery,
)
from ..resilience.errors import DeadlineExceeded
from ..resilience.retry import RetryPolicy
from .failover import FailoverServer
from .server import Overloaded, Servable, Shed, StreamServer
from .snapshot_store import (
    PublishedSnapshot,
    SnapshotMirror,
    SnapshotStore,
    follow_snapshots,
)
from .stats import ServingStats
from .txn import TxnContext, TxnSnapshotExpired

#: PEP 562 lazy exports: the RPC modules are runnable CLIs
#: (``python -m gelly_streaming_tpu_torch.serving.rpc --smoke``), and an
#: eager package-level import would double-import them under runpy
_LAZY = {
    "HeartbeatLease": ".rpc",
    "ReplicaServer": ".rpc",
    "RpcServer": ".rpc",
    "RpcClient": ".client",
    "RpcError": ".client",
    "ShardRouter": ".router",
    "ReshardWatcher": ".reshard",
}


def __getattr__(name):
    rel = _LAZY.get(name)
    if rel is None:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}"
        )
    from importlib import import_module

    return getattr(import_module(rel, __name__), name)


__all__ = [
    "Answer",
    "BipartiteQuery",
    "ComponentSizeQuery",
    "ConnectedQuery",
    "DeadlineExceeded",
    "DegreeQuery",
    "FailoverServer",
    "HeartbeatLease",
    "Overloaded",
    "PublishedSnapshot",
    "Query",
    "QueryEngine",
    "RankQuery",
    "ReplicaServer",
    "RetryPolicy",
    "RpcClient",
    "ReshardWatcher",
    "RpcError",
    "RpcServer",
    "Servable",
    "ServingStats",
    "ShardRouter",
    "Shed",
    "SnapshotMirror",
    "SnapshotStore",
    "StreamServer",
    "SummaryPullQuery",
    "TxnContext",
    "TxnSnapshotExpired",
    "follow_snapshots",
]
