"""Causal timeline: merge shard event logs into one ordered story (the
port's copy of ``gelly_streaming_tpu/obs/timeline.py``).

A distributed chaos run leaves N per-worker event files plus flight
dumps in a directory; reconstructing "what actually happened" — who was
killed when, which epochs committed, where the rendezvous fell back,
when the standby was promoted — has so far meant hand-interleaving
JSONL files. This tool does the interleave::

    python -m gelly_streaming_tpu_torch.obs.timeline <dir>        # the story
    python -m gelly_streaming_tpu_torch.obs.timeline <dir> --all  # every event

It merges every shard event stream under the directory (via
:func:`~gelly_streaming_tpu_torch.obs.cluster.iter_shard_events` — shard-
stamped, ``ts``-ordered) plus any flight-recorder dumps, and renders
one line per event of interest with a run-relative timestamp::

    +0.412s  [kill_003/p1] KILL     resilience.fault_injected{site=chaos.window}
    +0.907s  [kill_003/p0] COMMIT   resilience.coord_commits
    ...

The default view filters to the COORDINATION story (kills, restarts,
epoch commits / selections / fallbacks / torn epochs, checkpoint
rejections, promotions, worker deaths, flight dumps); ``--all`` renders
every event including spans and plain metric mutations.

``--trace <id>`` renders ONE query's causal path instead:
every event stamped with that trace id — the client's batch root +
retry/resubmit spans and each replica's decode/admit/dispatch/reply
spans, across processes, in one ``ts``-ordered story. Trace ids come
from latency-histogram exemplars, the ``/trace/<id>`` endpoint, or any
span line in ``--all`` output.

``--since <ts>`` / ``--until <ts>`` window the merged stream before
rendering (the chaos OBS logs run to thousands of events; a kill
point's neighborhood should not need grep). Values are absolute unix
timestamps, or run-relative seconds when prefixed with ``+``
(``--since +12 --until +14`` shows the two seconds after +12s, in the
same clock the rendered ``+...s`` column uses).

An event is placed at its start where it carries one (a span's ``t0_ns``,
on the tracer's shared clock) and at its ``ts`` otherwise, so a span sits
where it began, beside what ran meanwhile. A device span's
``<name>.device`` event renders as a line of its own (tag ``DEVICE``): the
card's time for the stage, placed among the host spans open at its start,
so a device gap shows beside the host span that left it.
"""

from __future__ import annotations

import os
import sys
from typing import Iterable, List, Optional

from .cluster import iter_shard_events

#: event name -> the tag the story renders it under; this is the
#: vocabulary of the repo's coordination/failure events (resilience +
#: serving layers — all always-on, so every run has them)
STORY = {
    "resilience.fault_injected": "KILL",
    "resilience.restarts": "RESTART",
    "resilience.cluster_restarts": "RESTART*",
    "resilience.recovery_seconds": "RECOVERED",
    "resilience.coord_commits": "COMMIT",
    "resilience.epoch_selected": "SELECT",
    "resilience.epoch_fallbacks": "FALLBACK",
    "resilience.epoch_torn": "TORN",
    "resilience.epoch_incomplete": "INCOMPLETE",
    "resilience.ckpt_rejected": "REJECTED",
    "resilience.deduped_windows": "DEDUP",
    "resilience.poison_windows": "POISON",
    "serving.failover": "PROMOTE",
    "serving.failover_requeued": "REQUEUE",
    "serving.failover_expired": "EXPIRED",
    "serving.worker_deaths": "DEATH",
    "serving.promotion_seconds": "PROMOTED",
    # the RPC story: connection lifecycle + heartbeat-lease
    # failover, so a cross-process serving kill renders as one causal
    # line sequence — CONNECT, DISCONNECT (the kill), LEASE-LAPSE,
    # PROMOTE/PROMOTED — alongside the black-box and death lines above
    "rpc.connects": "CONNECT",
    "rpc.disconnects": "DISCONNECT",
    "rpc.malformed": "MALFORMED",
    "serving.lease_lapse": "LEASE-LAPSE",
    # the sharded-ingest story: reconnects, malformed wire
    # frames, and the backpressure lifecycle — a reader blocked past
    # the stall threshold on a full shard queue (recv stopped, TCP
    # pushing back on the producer) and its later resume render as an
    # INGEST-STALL / INGEST-RESUME pair alongside the rest
    "source.reconnects": "RECONNECT",
    "source.malformed_frames": "MALFORMED",
    "source.backpressure_stalls": "INGEST-STALL",
    "source.backpressure_resumes": "INGEST-RESUME",
    # the sharded-serving story: the router's cross-shard
    # merge refreshes (one per shard snapshot-version bump, not per
    # query), merge failures, per-shard fan-out errors (the signal a
    # single shard's outage leaves while the other shards keep
    # answering), and hot-key cache invalidations — so a shard kill
    # under a router renders as DISCONNECT / SHARD-ERROR / LEASE-LAPSE
    # / PROMOTE with the router's own lines interleaved
    "router.pulls": "CC-PULL",
    "router.pull_errors": "PULL-ERROR",
    "router.shard_errors": "SHARD-ERROR",
    "router.cache_invalidations": "CACHE-INVAL",
    # the delta-pull story: pull protocol v2 — each
    # incremental refresh (DELTA-PULL, O(changed rows) over the wire),
    # each honest degrade to a full table (FULL-FALLBACK{reason}: stale
    # ring, restarted store, v1 peer), and each malformed pull frame
    # the router rejected — so a churn run renders the protocol's
    # actual full/delta cadence next to the CC-PULL lines above
    "router.delta_pulls": "DELTA-PULL",
    "router.full_fallbacks": "FULL-FALLBACK",
    "router.pull_malformed": "PULL-MALFORMED",
    # the self-tuning story: every control-plane decision —
    # superbatch K, prefetch depth, admission limit — logs one
    # control.retune{knob,from,to,signal} event, so a knob move renders
    # in causal order next to the COMMIT/PROMOTE lines it reacted to
    "control.retune": "RETUNE",
    # the transport-fabric story: every cross-process
    # exchange (fabric.exchange{backend,tag}), every election proposal
    # (fabric.elect{backend,tag,won}) and every cadence agreement the
    # coordinated layer acts on (fabric.agree{backend,epoch,k}) renders
    # labeled with its backend + tag, in causal order next to the
    # COMMIT/SELECT/RETUNE lines it synchronizes
    "fabric.exchange": "EXCHANGE",
    "fabric.elect": "ELECT",
    "fabric.agree": "AGREE",
    # the event-time story: the merged watermark's advances,
    # each pane the clock closed, each retraction of an expired pane
    # out of the live summaries, and every record dropped past the
    # lateness allowance — so a sliding-window chaos run renders as
    # WATERMARK / PANE-CLOSE / KILL / RESTART / PANE-CLOSE (the replay)
    # / RETRACT in causal order, late drops counted, never silent
    # the elastic-resharding story: the split plan's
    # one-winner agreement (AGREE-SPLIT), the parent shard observing a
    # plan that names it (SPLIT), and every epoch adoption — routers
    # growing a shard client, replicas re-stamping their reply frames
    # (ADOPT) — so a storm run renders KILL / PROMOTE / SPLIT / ADOPT /
    # RETUNE in the causal order the proof claims
    "reshard.agree": "AGREE-SPLIT",
    "reshard.split": "SPLIT",
    "reshard.adopt": "ADOPT",
    "eventtime.watermark_advance": "WATERMARK",
    "eventtime.pane_close": "PANE-CLOSE",
    "eventtime.retract": "RETRACT",
    "eventtime.late_dropped": "LATE-DROP",
    # the transaction story: each snapshot-pinned
    # transaction's begin, every read answered AT a pinned version,
    # and every honest expiry — the ring slid
    # (txn.snapshot_expired{reason}), a promoted standby's mirror
    # missing the pin (txn.failover_expired), or a txn-unaware peer
    # detected from its reply stamp — so a storm run renders
    # TXN-BEGIN / TXN-READ / KILL / PROMOTE / TXN-READ (the survivor
    # answering the same pin) or TXN-EXPIRED, never a silently
    # fresher answer
    "txn.begin": "TXN-BEGIN",
    "txn.pinned_reads": "TXN-READ",
    "txn.snapshot_expired": "TXN-EXPIRED",
    "txn.failover_expired": "TXN-EXPIRED",
    "txn.unaware_peer": "TXN-EXPIRED",
    "flight": "BLACKBOX",
}


def load_run(root: str) -> List[dict]:
    """Every shard event under ``root`` plus one synthetic event per
    flight dump (kind ``flight``, carrying the dump's reason/shard),
    globally ``ts``-ordered."""
    from . import flight as _flight

    events = list(iter_shard_events(root))
    if os.path.isdir(root):
        dump_paths = []
        for dirpath, _dirnames, _filenames in os.walk(root):
            dump_paths.extend(_flight.find_dumps(dirpath))
        for p in sorted(set(dump_paths)):
            try:
                doc = _flight.read_dump(p)
            except Exception:
                # a torn dump is itself evidence; surface it as such
                events.append({
                    "kind": "flight", "name": "flight",
                    "ts": os.path.getmtime(p),
                    "attrs": {"path": os.path.relpath(p, root),
                              "unreadable": True},
                })
                continue
            events.append({
                "kind": "flight",
                "name": "flight",
                "ts": doc.get("ts", os.path.getmtime(p)),
                "shard": (
                    f"p{doc['shard']}" if doc.get("shard") is not None
                    else None
                ),
                "attrs": {
                    "reason": doc.get("reason"),
                    "n_events": doc.get("n_events"),
                    # the dying worker's pid joins the BLACKBOX line to
                    # the supervisor's restart/kill lines for the same
                    # process — and the dump's own attrs (error reprs,
                    # kill sites) ride along instead of staying buried
                    # in the container
                    "pid": doc.get("pid"),
                    "path": os.path.relpath(p, root),
                    **(doc.get("attrs") or {}),
                },
            })
    events.sort(key=when)
    return events


def when(e: dict) -> float:
    """Where an event is placed, in Unix seconds: its start (``t0_ns``)
    where it carries one, else its ``ts``; 0.0 for neither."""
    t0_ns = e.get("t0_ns")
    if isinstance(t0_ns, int) and t0_ns:
        return t0_ns / 1e9
    ts = e.get("ts")
    return float(ts) if isinstance(ts, (int, float)) else 0.0


def run_t0(events: Iterable[dict]) -> float:
    """The run's earliest real timestamp (0.0 when none) — the zero
    point of the rendered ``+...s`` column and of relative ``--since``/
    ``--until`` values."""
    stamps = [t for t in map(when, events) if t]
    return min(stamps) if stamps else 0.0


def filter_events(
    events: Iterable[dict],
    *,
    since: Optional[float] = None,
    until: Optional[float] = None,
    trace: Optional[str] = None,
) -> List[dict]:
    """Window/trace filter over a merged event stream (the pure core of
    the ``--since``/``--until``/``--trace`` CLI flags). ``since``/
    ``until`` are ABSOLUTE timestamps (the CLI resolves ``+N``
    relative forms against :func:`run_t0` first); bounds are inclusive.
    ``trace`` keeps only events stamped with that trace id."""
    out = []
    for e in events:
        if trace is not None and e.get("trace") != trace:
            continue
        ts = when(e)
        if since is not None and ts < since:
            continue
        if until is not None and ts > until:
            continue
        out.append(e)
    return out


def _fmt_labels(e: dict) -> str:
    labels = dict(e.get("labels") or {})
    labels.pop("shard", None)  # already the line's [shard] column
    body = ",".join(f"{k}={v}" for k, v in sorted(labels.items()))
    return f"{{{body}}}" if body else ""


def render(events: Iterable[dict], *, all_events: bool = False,
           t0: Optional[float] = None) -> List[str]:
    """Format merged events as timeline lines (the CLI's output, and
    the programmatic surface tests pin)."""
    events = list(events)
    if t0 is None:
        t0 = run_t0(events)
    lines = []
    for e in events:
        name = e.get("name", "")
        kind = e.get("kind", "")
        tag = STORY.get(name) or (STORY.get("flight") if kind == "flight"
                                  else None)
        if tag is None and not all_events:
            continue
        if kind == "span" and name.endswith(".device"):
            tag = "DEVICE"
        ts = when(e)
        shard = e.get("shard") or "-"
        head = f"+{max(0.0, ts - t0):8.3f}s  [{shard:>12}] " \
               f"{tag or kind.upper():<10} {name}{_fmt_labels(e)}"
        detail = []
        if kind == "hist" and "v" in e:
            detail.append(f"v={e['v']:.4g}")
        elif kind in ("counter", "gauge") and "v" in e:
            detail.append(f"v={e['v']:g}")
        elif kind == "span":
            detail.append(f"dur={e.get('dur_s', 0):.4g}s")
        attrs = e.get("attrs")
        if attrs:
            detail.append(
                " ".join(f"{k}={v}" for k, v in sorted(attrs.items()))
            )
        if detail:
            head += "  " + " ".join(detail)
        lines.append(head)
    return lines


def _take_value(argv: List[str], flag: str) -> Optional[str]:
    """Pop ``--flag value`` (or ``--flag=value``) out of argv."""
    for i, a in enumerate(argv):
        if a == flag:
            if i + 1 >= len(argv):
                raise SystemExit(f"{flag} needs a value")
            value = argv[i + 1]
            del argv[i:i + 2]
            return value
        if a.startswith(flag + "="):
            del argv[i]
            return a[len(flag) + 1:]
    return None


def _resolve_ts(raw: Optional[str], t0: float, flag: str
                ) -> Optional[float]:
    """``+N`` is run-relative seconds; anything else an absolute
    timestamp."""
    if raw is None:
        return None
    try:
        if raw.startswith("+"):
            return t0 + float(raw[1:])
        return float(raw)
    except ValueError:
        raise SystemExit(f"{flag} wants a number, got {raw!r}") from None


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    trace = _take_value(argv, "--trace")
    since_raw = _take_value(argv, "--since")
    until_raw = _take_value(argv, "--until")
    all_events = "--all" in argv
    roots = [a for a in argv if not a.startswith("--")]
    if not roots:
        print(
            "usage: python -m gelly_streaming_tpu_torch.obs.timeline "
            "<run-dir|events.jsonl> [--all] [--trace <id>] "
            "[--since <ts|+s>] [--until <ts|+s>]",
            file=sys.stderr,
        )
        return 2
    rc = 0
    for root in roots:
        events = load_run(root)
        # offsets stay anchored to the RUN's start even when a window
        # or trace filter narrows the view — the +N column must mean
        # the same instant with and without filters
        t0 = run_t0(events)
        shown_events = filter_events(
            events,
            since=_resolve_ts(since_raw, t0, "--since"),
            until=_resolve_ts(until_raw, t0, "--until"),
            trace=trace,
        )
        # a trace view IS the story: render every one of its events
        lines = render(shown_events, all_events=all_events or
                       trace is not None, t0=t0)
        if not lines:
            print(f"{root}: no events", file=sys.stderr)
            rc = 1
            continue
        shown = (f"trace {trace}" if trace is not None
                 else "all" if all_events else "story")
        print(f"# {root}: {len(events)} events, {len(lines)} shown "
              f"({shown})")
        for line in lines:
            print(line)
    return rc


if __name__ == "__main__":
    try:
        sys.exit(main())
    except BrokenPipeError:
        # `... | head` closed the pipe: normal CLI lifecycle, not an
        # error (devnull dup avoids the interpreter's own flush noise)
        os.dup2(os.open(os.devnull, os.O_WRONLY), sys.stdout.fileno())
        sys.exit(0)
