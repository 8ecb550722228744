"""Cluster observability: per-shard event shipping + one merged registry
(the port's copy of ``gelly_streaming_tpu/obs/cluster.py``).

A multi-process run's telemetry is process-local: each worker's
registry/span stream dies with its process. This module is the
framework-owns-the-global-view analog for telemetry (operators keep
distributed summaries, the framework merges them):

- :class:`ShardSink` is the per-worker event shipper: a drop-in
  replacement for :class:`~gelly_streaming_tpu_torch.obs.export.JsonlSink`
  that APPENDS each event to its shard's JSONL file the moment it is
  emitted (flushed through the Python buffer, so everything emitted
  before an ``os._exit`` kill survives in the OS page cache — the
  pre-crash evidence the chaos harness reads). Each event is stamped
  with a wall-clock ``ts`` (metric mutations previously carried none)
  so shard streams can be merged into one causal order.
- :class:`ClusterAggregator` tails any number of shard files into ONE
  merged, shard-labeled registry. Merging IS replay: each shard's
  metric events are fed through
  :func:`~gelly_streaming_tpu_torch.obs.export.replay` with ``shard=<id>``
  folded into the labels, so the merged snapshot equals, by
  construction AND by test, the union of per-worker ``replay()``
  results with the shard label attached. Tailing is incremental
  (byte offsets per file, partial trailing lines left for the next
  poll), so one aggregator can follow a LIVE cluster.
- :func:`iter_shard_events` is the batch form: every shard event under
  a directory, shard-stamped and time-ordered — what the chaos sweep's
  merged obs log and the timeline tool
  (:mod:`~gelly_streaming_tpu_torch.obs.timeline`) both consume.

The merged registry is what the scrape endpoint
(:mod:`~gelly_streaming_tpu_torch.obs.endpoint`) renders for a cluster.
"""

from __future__ import annotations

import glob as _glob
import json
import os
import re
import threading
import time
from typing import Dict, Iterator, List, Optional, Tuple

from .export import replay
from .registry import MetricRegistry

#: shard event file shape: ``events.jsonl`` (single shard, shard "p0")
#: or ``events.p<N>.jsonl``
SHARD_FILE_RE = re.compile(r"^events(?:\.p(\d+))?\.jsonl$")


def shard_events_path(directory: str, shard: int) -> str:
    """The canonical per-shard event file name the chaos workers and
    the aggregator agree on."""
    return os.path.join(directory, f"events.p{int(shard)}.jsonl")


def shard_of(path: str) -> Optional[str]:
    """Shard id for a shard event file name (``"p0"``, ``"p1"``, ...);
    None when the name is not a shard event file."""
    m = SHARD_FILE_RE.match(os.path.basename(path))
    if m is None:
        return None
    return f"p{m.group(1) or 0}"


class ShardSink:
    """Streaming JSONL event sink for one worker/shard.

    Unlike :class:`~gelly_streaming_tpu_torch.obs.export.JsonlSink` (an
    in-memory buffer written on clean exit), every ``emit`` appends one
    line to ``path`` and flushes it — a worker killed with ``os._exit``
    keeps every event it emitted before the kill, which is exactly the
    evidence a crash post-mortem needs. Events are stamped with
    ``ts`` (wall clock, only when absent — span events already carry
    one) and, when ``shard`` is given, a ``shard`` id, so downstream
    merging needs no out-of-band bookkeeping.

    The file opens lazily on the first event and is append-mode: a
    restarted worker pointed at the same path CONTINUES its shard's
    stream rather than truncating its own pre-crash history.
    """

    def __init__(self, path: str, *, shard: Optional[int] = None):
        self.path = path
        self.shard = None if shard is None else f"p{int(shard)}"
        self._lock = threading.Lock()
        self._f = None
        self._count = 0
        self._broken = False

    def emit(self, event: dict) -> None:
        if self._broken:
            return
        e = dict(event)
        if "ts" not in e:
            e["ts"] = time.time()
        if self.shard is not None and "shard" not in e:
            e["shard"] = self.shard
        line = json.dumps(e) + "\n"
        failed = False
        with self._lock:
            if self._broken:
                return
            try:
                if self._f is None:
                    d = os.path.dirname(self.path)
                    if d:
                        os.makedirs(d, exist_ok=True)
                    # this lock is the shard file's single-writer
                    # serializer: interleaved emits cannot tear a line
                    self._f = open(self.path, "a")
                self._f.write(line)
                self._f.flush()
                self._count += 1
            except OSError:
                # telemetry must never take the pipeline down: a full
                # disk / revoked fd stops THIS sink (latched, so the
                # failure is one-shot), not the worker emitting into it
                self._broken = True
                failed = True
        if failed:
            from .registry import get_registry

            # counted OUTSIDE the sink lock: the counter's own _emit
            # re-enters every attached sink (including this one, now
            # latched broken) and self._lock is not reentrant
            # one-shot cold path: the sink is latched broken above
            get_registry().counter(
                "obs.swallowed", site="shard_sink"
            ).inc()

    def __len__(self) -> int:
        with self._lock:
            return self._count

    def write(self, path: Optional[str] = None) -> str:
        """JsonlSink-compatible no-op: events are already on disk.
        Returns the path (ignores the override — the stream has one
        home by design)."""
        return self.path

    def close(self) -> None:
        with self._lock:
            if self._f is not None:
                self._f.close()
                self._f = None


# --------------------------------------------------------------------- #
# Reading shard streams back
# --------------------------------------------------------------------- #
def _split_complete_lines(data: str) -> Tuple[List[str], str]:
    """Split buffered data into complete lines plus the partial trailing
    line (a worker killed mid-write, or a tail race with a live writer)
    to carry into the next poll."""
    end = data.rfind("\n")
    if end < 0:
        return [], data
    return data[: end + 1].splitlines(), data[end + 1:]


def discover_shard_files(root: str, recursive: bool = True) -> Dict[str, str]:
    """Map shard id -> path for every shard event file under ``root``.

    Shard ids are the ``p<N>`` from the file name; when ``root`` holds
    several runs (the chaos sweep's per-point directories) the relative
    directory is folded in (``kill_003/p0``) so shards never collide
    across runs.
    """
    if os.path.isfile(root):
        sid = shard_of(root) or "p0"
        return {sid: root}
    pattern = os.path.join(root, "**" if recursive else "", "events*.jsonl")
    out: Dict[str, str] = {}
    for path in sorted(_glob.glob(pattern, recursive=recursive)):
        sid = shard_of(path)
        if sid is None:
            continue
        rel = os.path.relpath(os.path.dirname(path), root)
        if rel not in (".", ""):
            sid = f"{rel.replace(os.sep, '/')}/{sid}"
        out[sid] = path
    return out


def label_shard(event: dict, shard: str) -> dict:
    """The ONE transformation merging applies to a metric event: fold
    the shard id into its labels (span/meta events get a top-level
    ``shard`` tag instead — they are evidence, not registry state).

    ``shard`` is the file-derived id. When it is a run-prefixed form of
    the event's own stamp (``kill_003/p0`` vs a :class:`ShardSink`'s
    ``p0``) the prefixed id wins — that prefix is exactly what keeps
    same-numbered shards from colliding across the runs of a sweep
    directory (:func:`discover_shard_files`'s no-collision promise).
    An event whose stamp names a DIFFERENT shard keeps its own id: the
    input is an already-merged stream, and the per-event stamps are the
    only true ids it has."""
    e = dict(event)
    es = e.get("shard")
    if not es or shard == es or shard.endswith(f"/{es}"):
        sid = shard
    else:
        sid = es
    if e.get("kind") in ("counter", "gauge", "hist"):
        labels = dict(e.get("labels") or {})
        labels.setdefault("shard", sid)
        e["labels"] = labels
    e["shard"] = sid
    return e


class ClusterAggregator:
    """Tail per-shard event streams into one merged, shard-labeled
    registry.

    ``source`` is a directory (shard files discovered by name, re-
    globbed every poll so late-joining workers are picked up), a single
    shard file, or an explicit ``{shard_id: path}`` mapping. Each
    :meth:`poll` consumes newly-appended COMPLETE lines from every
    shard file and replays the metric events into :attr:`registry`
    with ``shard=<id>`` folded into the labels — per-shard event order
    is preserved (replay determinism needs nothing more: shards never
    share an instrument, their label sets differ by construction).

    The merged snapshot therefore equals the union of per-worker
    ``replay()`` results with the shard label attached — the identity
    the parity tests pin against the replay implementation itself.
    """

    def __init__(
        self,
        source,
        *,
        registry: Optional[MetricRegistry] = None,
        keep_events: int = 4096,
    ):
        self._source = source
        self.registry = registry if registry is not None else MetricRegistry()
        self._offsets: Dict[str, int] = {}
        self._tails: Dict[str, str] = {}
        self._lock = threading.Lock()
        self._events: List[dict] = []
        self._keep_events = int(keep_events)
        self._consumed = 0

    # ------------------------------------------------------------------ #
    def _shard_files(self) -> Dict[str, str]:
        if isinstance(self._source, dict):
            return {str(k): v for k, v in self._source.items()}
        return discover_shard_files(self._source)

    def poll(self) -> int:
        """Consume newly-appended events from every shard file; returns
        how many events were merged this poll. Safe against a live
        writer: only complete lines are consumed, and a line that fails
        to parse (a torn write racing the reader) is retried on the
        next poll rather than dropped."""
        merged = 0
        with self._lock:
            for sid, path in sorted(self._shard_files().items()):
                try:
                    # the aggregator lock serializes the per-file cursors
                    # with the reads that advance them
                    with open(path) as f:
                        f.seek(self._offsets.get(path, 0))
                        data = self._tails.get(path, "") + f.read()
                        self._offsets[path] = f.tell()
                except OSError:
                    continue  # not born yet / raced a cleanup: next poll
                lines, self._tails[path] = _split_complete_lines(data)
                batch = []
                for line in lines:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        batch.append(label_shard(json.loads(line), sid))
                    except ValueError:
                        # a torn line mid-file cannot heal (only the
                        # TAIL races a writer); skip it but keep count
                        self._events.append({
                            "kind": "meta", "name": "aggregator.torn_line",
                            "shard": sid,
                        })
                replay(batch, self.registry)
                self._events.extend(batch)
                merged += len(batch)
            self._consumed += merged
            if len(self._events) > self._keep_events:
                del self._events[: len(self._events) - self._keep_events]
        return merged

    # ------------------------------------------------------------------ #
    def snapshot(self) -> dict:
        """Poll, then return the merged registry's snapshot."""
        self.poll()
        return self.registry.snapshot()

    def events(self, last: Optional[int] = None) -> List[dict]:
        """The merged, shard-stamped event stream (bounded by
        ``keep_events``); ``last`` trims to the newest N (0 means
        none — not all; ``evs[-0:]`` would invert the bound)."""
        with self._lock:
            evs = list(self._events)
        if last is None:
            return evs
        return evs[-last:] if last > 0 else []

    @property
    def consumed(self) -> int:
        with self._lock:
            return self._consumed


def iter_shard_events(root, *, order: bool = True) -> Iterator[dict]:
    """Every shard event under ``root`` (directory / file / mapping),
    shard-stamped via :func:`label_shard`. With ``order=True`` events
    are globally sorted by ``ts`` (events without one inherit the last
    seen timestamp in their shard file, preserving in-shard order) —
    the merged stream the chaos sweep writes and the timeline tool
    renders."""
    files = (
        {str(k): v for k, v in root.items()} if isinstance(root, dict)
        else discover_shard_files(root)
    )
    out: List[Tuple[float, int, dict]] = []
    seq = 0
    for sid in sorted(files):
        last_ts = 0.0
        try:
            with open(files[sid]) as f:
                raw = f.read()
        except OSError:
            continue
        for line in raw.splitlines():
            line = line.strip()
            if not line:
                continue
            try:
                e = label_shard(json.loads(line), sid)
            except ValueError:
                continue  # torn final line of a killed worker
            ts = e.get("ts")
            if isinstance(ts, (int, float)):
                last_ts = float(ts)
            else:
                e["ts"] = last_ts
            out.append((float(e["ts"]), seq, e))
            seq += 1
    if order:
        out.sort(key=lambda t: (t[0], t[1]))
    for _, _, e in out:
        yield e


def iter_trace_events(root, trace_id: str,
                      *, order: bool = True) -> Iterator[dict]:
    """One trace's events across every shard under ``root`` — the
    span/metric events stamped with ``trace == trace_id``, shard-
    stamped and ``ts``-ordered. This is the cross-process join the
    trace surface stands on: a client process's batch span, a dead
    primary's partial decode/admit spans, and the promoted standby's
    answer spans all carry the same trace id, so this filter over the
    merged stream IS the causal story (rendered by
    ``obs.timeline --trace <id>``, served by the endpoint's
    ``/trace/<id>``)."""
    for e in iter_shard_events(root, order=order):
        if e.get("trace") == trace_id:
            yield e
