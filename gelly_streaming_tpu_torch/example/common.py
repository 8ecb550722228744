"""Shared CLI plumbing for the port's example programs.

A copy of the parts of ``gelly_streaming_tpu/example/common.py`` the
streaming GraphSAGE example uses. Mirrors the reference examples'
conventions (e.g. ``example/ConnectedComponentsExample.java:81-102``):
positional args, no args -> built-in default data plus a usage message,
results written to a file when an output path is given, printed otherwise.
"""

from __future__ import annotations

import sys
from typing import Iterable, List, Optional, Tuple


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


def run_main(main_fn):
    """python -m entry point."""
    main_fn(sys.argv[1:])
