"""k-Spanner CLI (``example/SpannerExample.java:49-166``; default k=3 from
``:80``), PyTorch port. Output: the last spanner's edges, ``u v`` per line.

``--device`` runs the batched :class:`DeviceSpanner` (per-window
reachability on the device) instead of the host-exact sequential fold: the
same k-spanner guarantee, possibly more edges. The stream runs on the card;
``--cpu`` runs it on the CPU instead::

    python -m gelly_streaming_tpu_torch.example.spanner [--cpu] [--device] \\
        <input edges path> <merge window size (edges)> <k> [output path]
"""

from __future__ import annotations

from typing import List, Optional

from ..core.device import DEFAULT_DEVICE
from ..core.stream import SimpleEdgeStream
from ..core.window import CountWindow
from ..library import Spanner
from .common import (
    default_chain_edges,
    read_edges,
    run_main,
    split_cpu_flag,
    usage,
    write_lines,
)


def run(edges, window_size: int, k: int = 3, output_path: Optional[str] = None,
        device_spanner: bool = False, device=DEFAULT_DEVICE):
    stream = SimpleEdgeStream(edges, window=CountWindow(window_size), device=device)
    if device_spanner:
        from ..library.spanner import DeviceSpanner

        sp = DeviceSpanner(k=k)
        for _ in sp.run(stream):
            pass
        write_lines(output_path, sorted(f"{u} {v}" for u, v in sp.edges()))
        return sp
    last = None
    for spanner in stream.aggregate(Spanner(k=k)):
        last = spanner
    lines = sorted(f"{u} {v}" for u, v in last.edges()) if last is not None else []
    write_lines(output_path, lines)
    return last


def main(args: List[str]) -> None:
    args, device = split_cpu_flag(args)
    if args:
        device_spanner = "--device" in args
        args = [a for a in args if a != "--device"]
        if len(args) not in (3, 4):
            print(
                "Usage: spanner [--cpu] [--device] <input edges path> "
                "<merge window size (edges)> <k> [output path]"
            )
            return
        run(read_edges(args[0]), int(args[1]), int(args[2]),
            args[3] if len(args) > 3 else None, device_spanner=device_spanner, device=device)
    else:
        usage(
            "spanner",
            "[--cpu] [--device] <input edges path> <merge window size (edges)> <k> "
            "[output path]",
        )
        run(default_chain_edges(), 100, 3, device=device)


if __name__ == "__main__":
    run_main(main)
