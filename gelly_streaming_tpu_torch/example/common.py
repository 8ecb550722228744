"""Shared CLI plumbing for the port's example programs.

A copy of the parts of ``gelly_streaming_tpu/example/common.py`` the
port's examples use (the checkpoint flags and the supervised run among
them), and their shared ``--cpu`` flag. Mirrors the reference examples'
conventions (e.g. ``example/ConnectedComponentsExample.java:81-102``):
positional args, no args -> built-in default data plus a usage message,
results written to a file when an output path is given, printed otherwise.
"""

from __future__ import annotations

import os
import sys
from typing import Iterable, List, Optional, Tuple

from ..core.device import DEFAULT_DEVICE


def read_edges(path: str, n_fields: int = 2, val_fn=float) -> List[Tuple]:
    """Parse a whitespace-separated edge file (the reference's
    ``s.split("\\s")`` mappers). ``n_fields=3`` keeps a value/timestamp
    column parsed with ``val_fn``."""
    rows = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            if n_fields == 2:
                rows.append((int(parts[0]), int(parts[1]), 0.0))
            else:
                rows.append((int(parts[0]), int(parts[1]), val_fn(parts[2])))
    return rows


def write_lines(output_path: Optional[str], lines: Iterable[str]) -> None:
    """Write one result per line to the path, or print (reference
    ``writeAsText`` / ``print()`` split)."""
    if output_path is None:
        for line in lines:
            print(line)
    else:
        with open(output_path, "w") as f:
            for line in lines:
                f.write(line + "\n")


def usage(name: str, params: str) -> None:
    print(f"Executing {name} example with default parameters and built-in default data.")
    print("  Provide parameters to read input data from files.")
    print(f"  Usage: {name} {params}")


def default_chain_edges(n: int = 100) -> List[Tuple]:
    """The reference examples' built-in data: edges (k, k+2) for k=1..n
    (``ConnectedComponentsExample.java:120-130``) — two odd/even chains."""
    return [(k, k + 2, float(k * 100)) for k in range(1, n + 1)]


def split_cpu_flag(args: List[str]):
    """``(args without "--cpu", device)``: the examples run on the card
    unless ``--cpu`` asks for the CPU."""
    args = list(args)
    if "--cpu" in args:
        args.remove("--cpu")
        return args, "cpu"
    return args, DEFAULT_DEVICE


def parse_checkpoint_flags(args: List[str]):
    """Extract the shared fault-tolerance flags from an example CLI's
    argument list:

    ``--checkpoint <path>``      barrier file path
    ``--checkpoint-dir <dir>``   barriers under ``<dir>/<name>.ckpt``
    ``--every <n|auto>``         barrier cadence (``auto`` tunes from
                                 measured barrier cost, at most 5% of wall
                                 time)
    ``--resume``                 resume from an existing barrier — the
                                 DEFAULT (re-running the same command after
                                 a crash continues where it died); the flag
                                 makes scripts explicit
    ``--fresh``                  start over: discard any barrier already at
                                 the path instead of resuming it

    Returns ``(remaining_args, spec)`` where ``spec`` is None when no
    checkpoint flag was given, else a dict with ``path``/``dir``/``every``/
    ``resume``; ``path`` is None for ``--checkpoint-dir`` until the caller
    names it via :func:`checkpoint_path_in`.
    """
    args = list(args)
    spec = {"path": None, "dir": None, "every": 64, "resume": True}
    seen = False
    for flag, key in (("--checkpoint", "path"), ("--checkpoint-dir", "dir")):
        if flag in args:
            i = args.index(flag)
            if i + 1 >= len(args):
                raise ValueError(f"{flag} requires a value")
            spec[key] = args[i + 1]
            del args[i:i + 2]
            seen = True
    modifier = None
    if "--every" in args:
        i = args.index("--every")
        if i + 1 >= len(args):
            raise ValueError("--every requires a value")
        val = args[i + 1]
        spec["every"] = "auto" if val == "auto" else int(val)
        del args[i:i + 2]
        modifier = "--every"
    if "--resume" in args:
        spec["resume"] = True
        args.remove("--resume")
        modifier = "--resume"
    if "--fresh" in args:
        spec["resume"] = False
        args.remove("--fresh")
        modifier = "--fresh"
    if modifier is not None and not seen:
        # consuming the modifier while dropping the spec would silently
        # run WITHOUT the fault tolerance the user asked to configure
        raise ValueError(f"{modifier} requires --checkpoint or --checkpoint-dir")
    return args, (spec if seen else None)


def checkpoint_path_in(spec: dict, name: str) -> str:
    """Resolve the barrier path for one example from a parsed spec
    (``--checkpoint`` wins; ``--checkpoint-dir`` appends ``name``)."""
    if spec["path"] is not None:
        return spec["path"]
    os.makedirs(spec["dir"], exist_ok=True)
    return os.path.join(spec["dir"], name)


def supervised_emissions(path: str, every, make_stream, work,
                         resume: bool = True, keep: int = 2):
    """Run a checkpointed workload under the resilience layer's
    ``Supervisor``: barriers every ``every`` windows (``"auto"`` tunes the
    cadence from measured barrier cost), the last ``keep`` kept, transparent
    restore from the newest valid barrier, restart-with-backoff on
    transient faults, replayed windows deduped — re-running the same
    command after a kill finishes with identical output. Returns
    ``(emissions_iterator, checkpoint)``; ``checkpoint.restored_vdict`` /
    ``restored_emission`` serve the resumed-past-the-end case.

    ``resume=False`` discards any barrier already at ``path`` (and its
    rotation slots) so a fresh run never silently continues a stale one."""
    from ..aggregate.autockpt import AutoCheckpoint
    from ..resilience import Supervisor

    parent = os.path.dirname(path)
    if parent:
        # a missing directory would otherwise surface as a poison-window
        # loop (every barrier write fails identically)
        os.makedirs(parent, exist_ok=True)
    ac = AutoCheckpoint(path, every=every, keep=keep)
    if not resume:
        ac.discard()
    sup = Supervisor(ac)
    return sup.run(make_stream, work), ac


def run_main(main_fn):
    """python -m entry point."""
    main_fn(sys.argv[1:])
