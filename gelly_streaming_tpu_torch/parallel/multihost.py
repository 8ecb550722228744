"""Multi-host execution support, its host half (the port's copy of
``gelly_streaming_tpu/parallel/multihost.py``).

Ingest contract (the keyBy analog across hosts): every host windows ITS
OWN shard of the edge stream, and the per-host raw->compact mappings must
agree globally. The **dict exchange** (:func:`dict_exchange_encode`) does
it: per window, hosts allgather their windows' first-occurrence raw ids
and every host feeds the union into its VertexDict in (process rank,
arrival) order — compaction is deterministic given identical id streams,
so all dictionaries stay byte-identical with no coordinator.

The exchange rides a store-backed :class:`~gelly_streaming_tpu_torch.fabric.Transport`
(``FileExchangeTransport``, which is ``SharedDirTransport``, or a
``SocketTransport``) with the JAX package's int32 hi/lo planes and tags, so
a JAX rank and a port rank can share one exchange directory. The
multi-controller runtime (``initialize``, ``is_coordinator``), the
globally-sharded blocks (``global_edge_block``, ``global_block``,
``globalize_stream``) and the collective allgather come with ROADMAP
Queue 1, slice 6 (multiple devices): they raise ``NotImplementedError``
naming it.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..fabric import CollectiveTransport, SharedDirTransport

_SLICE6 = "ROADMAP Queue 1, slice 6 (multiple devices)"

# the historical names of the exchange transports (the reference keeps
# them importable here as the ingest-facing aliases)
JaxAllgatherTransport = CollectiveTransport
FileExchangeTransport = SharedDirTransport


def _not_ported(what: str):
    raise NotImplementedError(f"{what} is ported in {_SLICE6}")


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Join this process into the multi-controller runtime: not ported
    yet (raises)."""
    _not_ported("the multi-controller runtime (initialize)")


def global_edge_block(mesh, local_arrays):
    """Globally-sharded device columns from per-host columns: not ported
    yet (raises)."""
    _not_ported("global_edge_block")


def global_block(mesh, local_block):
    """A globally-sharded EdgeBlock from each host's local block: not
    ported yet (raises)."""
    _not_ported("global_block")


def globalize_stream(stream, mesh):
    """A stream of globally assembled windows: not ported yet (raises)."""
    _not_ported("globalize_stream")


def is_coordinator() -> bool:
    """The process that owns singleton side effects: not ported yet
    (raises; it reads the multi-controller runtime)."""
    _not_ported("is_coordinator")


def dict_exchange_encode(
    mesh, vdict, src_raw: np.ndarray, dst_raw: np.ndarray,
    *, transport=None, window=None,
):
    """Encode one window's raw columns under a GLOBALLY-AGREED dictionary.

    Each host proposes its window's raw ids in first-occurrence order; two
    allgathers (counts, then bucket-padded id arrays as two int32 planes,
    hi and lo) give every host the same proposal matrix, and each host
    folds the union into its own ``vdict`` in (process rank, arrival
    order). Returns the compact ``(src, dst)`` columns. ``mesh`` is
    accepted for call-site symmetry and unused.

    ``transport`` is a store-backed
    :class:`~gelly_streaming_tpu_torch.fabric.Transport` (the collective
    default of the reference comes with slice 6: without one this raises).
    ``window`` is the window ordinal that tags the exchange; it is
    required, since a persisted store keyed on a constant tag would re-read
    the FIRST window's proposals for every later window."""
    from ..core.edgeblock import bucket_capacity

    if transport is None:
        _not_ported("dict_exchange_encode without a transport (the collective allgather)")
    tr = transport
    if window is None and getattr(tr, "persistent", True):
        raise ValueError(
            "dict_exchange_encode: `window` is required when the "
            "transport persists exchanges by tag (it disambiguates "
            "windows)"
        )
    tag = "x" if window is None else f"w{int(window):08d}"
    ids = np.concatenate([src_raw.astype(np.int64), dst_raw.astype(np.int64)])
    # first-occurrence order, matching single-host VertexDict semantics
    _, first = np.unique(ids, return_index=True)
    proposal = ids[np.sort(first)]
    n = np.int32(len(proposal))
    counts = np.concatenate([
        np.asarray(c).reshape(-1)
        for c in tr.allgather(tag + ".n", np.array([n], np.int32))
    ])
    cap = bucket_capacity(int(counts.max()) if counts.size else 1, minimum=8)
    # int64 raw ids as two int32 planes: the JAX package's layout, so
    # ranks of both packages read each other's proposals
    padded = np.zeros((2, cap), np.int32)
    padded[0, : len(proposal)] = (proposal >> 32).astype(np.int32)
    padded[1, : len(proposal)] = (proposal & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
    gathered = [np.asarray(g) for g in tr.allgather(tag + ".ids", padded)]
    for p, plane in enumerate(gathered):
        hi = plane[0, : int(counts[p])].astype(np.int64)
        lo = plane[1, : int(counts[p])].view(np.uint32).astype(np.int64)
        vdict.encode((hi << 32) | lo)
    return vdict.encode(src_raw), vdict.encode(dst_raw)
