"""Streaming Connected Components CLI
(``example/ConnectedComponentsExample.java:49-169``), PyTorch port.

Each window emits the running :class:`Components` summary; the last one
is written, one component per line (``root=[members]``, the
DisjointSet ``toString`` format its test parses).

Runs on the card; ``--cpu`` runs it on the CPU instead::

    python -m gelly_streaming_tpu_torch.example.connected_components \\
        [--cpu] <input edges path> <merge window size (edges)> [output path]
    python -m gelly_streaming_tpu_torch.example.connected_components \\
        [--cpu] --corpus <name|path> [window] [--carry auto|forest|host|dense] \\
        [--device-encode <id bound>]

``--device-encode`` moves the vertex mapping onto the device
(``stream_file(device_encode=True)``): with an id bound the table covers
the dense id space, with ``0`` it grows from host novelty tracking (any
non-negative int32 ids). The checkpoint and supervisor flags of the
reference CLI (``--checkpoint``, ``--checkpoint-dir``, ``--every``,
``--resume``, ``--fresh``) raise: they are ported in ROADMAP Queue 1,
slice 7.
"""

from __future__ import annotations

import time
from typing import List, Optional

from ..core.device import DEFAULT_DEVICE
from ..core.stream import SimpleEdgeStream
from ..core.window import CountWindow
from ..library import ConnectedComponents
from .common import (
    default_chain_edges,
    read_edges,
    run_main,
    split_cpu_flag,
    usage,
    write_lines,
)

_SLICE7 = "ROADMAP Queue 1, slice 7 (durability, control and ingest)"
_LATER_FLAGS = dict.fromkeys(
    ("--checkpoint", "--checkpoint-dir", "--every", "--resume", "--fresh"), _SLICE7
)


def _emit(last, output_path: Optional[str], runtime_ms: float):
    lines = [
        f"{root}={members}" for root, members in sorted(last.components.items())
    ] if last else []
    write_lines(output_path, lines)
    print(f"Runtime: {runtime_ms:.1f}")
    return last


def _drain(stream, agg, output_path: Optional[str] = None):
    last = None
    t0 = time.perf_counter()
    for last in stream.aggregate(agg):
        pass
    agg.sync()
    return _emit(last, output_path, (time.perf_counter() - t0) * 1000)


def run(edges, window_size: int, output_path: Optional[str] = None,
        device=DEFAULT_DEVICE):
    stream = SimpleEdgeStream(edges, window=CountWindow(window_size), device=device)
    return _drain(stream, ConnectedComponents(), output_path)


def run_corpus(name_or_path: str, window_size: int = 1 << 20,
               carry: str = "auto", device=DEFAULT_DEVICE,
               device_encode: bool = False, id_bound: int = 0):
    """Stream a corpus (by registry name or file path) through streaming CC:
    the measured end-to-end path as a CLI. ``carry`` pins the CC carry
    (auto/forest/host/dense); ``device_encode`` maps the vertices on the
    device (``id_bound`` the dense id bound, 0 for growth mode), and the
    blocks then run the dense carry."""
    from .. import datasets

    if name_or_path in datasets.CORPORA:
        path, is_real = datasets.ensure_corpus(name_or_path)
        print(f"corpus: {path} ({'real' if is_real else 'surrogate'})")
    else:
        path = name_or_path
    kw = dict(device_encode=True, min_vertex_capacity=id_bound) if device_encode else {}
    stream = datasets.stream_file(path, window=CountWindow(window_size), device=device, **kw)
    agg = ConnectedComponents(carry=carry)
    last = _drain(stream, agg)
    if last is not None:
        print(f"components: {len(last.components)} (carry: {agg._cc_mode})")
    return last


def main(args: List[str]) -> None:
    args, device = split_cpu_flag(args)
    for flag, where in _LATER_FLAGS.items():
        if flag in args:
            raise NotImplementedError(f"{flag} is ported in {where}")
    if args and args[0] == "--corpus":
        rest = args[1:]
        carry = "auto"
        if "--carry" in rest:
            i = rest.index("--carry")
            carry = rest[i + 1]
            del rest[i:i + 2]
        dev_encode = "--device-encode" in rest
        bound = 0
        if dev_encode:
            i = rest.index("--device-encode")
            bound = int(rest[i + 1])
            del rest[i:i + 2]
        name = rest[0] if rest else "livejournal"
        window = int(rest[1]) if len(rest) > 1 else 1 << 20
        run_corpus(name, window, carry=carry, device=device,
                   device_encode=dev_encode, id_bound=bound)
        return
    if args:
        if len(args) not in (2, 3):
            print(
                "Usage: connected_components [--cpu] [--corpus <name|path> "
                "[window] [--carry auto|forest|host|dense] [--device-encode "
                "<id bound>]] | <input edges path> <merge window size "
                "(edges)> [output path]"
            )
            return
        run(read_edges(args[0]), int(args[1]),
            args[2] if len(args) > 2 else None, device=device)
    else:
        usage(
            "connected_components",
            "[--cpu] [--corpus <name|path> [window]] | <input edges path> "
            "<merge window size (edges)> [output path]",
        )
        run(default_chain_edges(), 100, device=device)


if __name__ == "__main__":
    run_main(main)
