"""VertexDict: incremental raw-id -> compact-id dictionary (the host keyBy).

The counterpart of ``gelly_streaming_tpu/core/vertexdict.py``. Per-key
state on the device is a dense table indexed by a *compact* vertex id;
this host-side dictionary owns the mapping:

- ``encode(raw_ids)`` maps raw (arbitrary, possibly 64-bit) vertex ids to
  compact int32 indices, assigning fresh indices first-seen-first.
- ``decode(idx)`` maps back for emission.
- ``capacity`` is power-of-two bucketed so device-side vertex tables
  reallocate only O(log V) times as the stream grows.

The encode runs in the port's native C++ encoder
(``native.NativeEncoder``) when the native library builds, and in the
vectorized numpy encoder otherwise (a host without a compiler); both
assign the same ids. :meth:`VertexDict.iter_encode_file` is the fused
native parse + encode of file ingest.
"""

from __future__ import annotations

from typing import Iterable

import numpy as np
import torch

from .edgeblock import bucket_capacity, to_device


class VertexDict:
    """Incremental bidirectional mapping raw id <-> compact int32 index."""

    def __init__(self, min_capacity: int = 8):
        self._idx_to_raw: list[int] = []
        # batch-lookup index: (sorted raw ids, aligned compact ids) as ONE
        # tuple, replaced by a single reference assignment so a concurrent
        # reader always sees a mutually consistent pair
        self._index = (np.empty(0, np.int64), np.empty(0, np.int32))
        self._min_capacity = min_capacity
        self._rev_cache = None
        self._raw_table_cache: dict = {}
        from .. import native

        try:
            self._native = native.NativeEncoder()
        except RuntimeError:  # no native library: the numpy encoder
            self._native = None

    def __len__(self) -> int:
        return len(self._idx_to_raw)

    @property
    def capacity(self) -> int:
        """Power-of-two bucketed size for device vertex tables."""
        return bucket_capacity(max(1, len(self._idx_to_raw)), self._min_capacity)

    def encode(self, raw: np.ndarray) -> np.ndarray:
        """Map raw ids to compact indices, assigning new ones first-seen-first.

        Fully vectorized: known ids resolve by binary search into the sorted
        index; novel ids get sequential compact ids in first-appearance
        order and are merged in.
        """
        raw = np.asarray(raw, np.int64).ravel()
        n = raw.shape[0]
        if n == 0:
            return np.empty(0, dtype=np.int32)
        if self._native is not None:
            out, novel = self._native.encode(raw)
            if novel.size:
                self._idx_to_raw.extend(novel.tolist())
            return out
        out = np.empty(n, dtype=np.int32)
        sorted_raw, sorted_idx = self._index
        if sorted_raw.size:
            pos = np.searchsorted(sorted_raw, raw)
            pos_c = np.minimum(pos, sorted_raw.size - 1)
            known = sorted_raw[pos_c] == raw
            out[known] = sorted_idx[pos_c[known]]
        else:
            known = np.zeros(n, bool)
        novel = ~known
        if novel.any():
            vals = raw[novel]
            uniq, first_pos = np.unique(vals, return_index=True)
            order = np.argsort(first_pos, kind="stable")
            base = len(self._idx_to_raw)
            id_of_uniq = np.empty(uniq.size, np.int32)
            id_of_uniq[order] = base + np.arange(uniq.size, dtype=np.int32)
            out[novel] = id_of_uniq[np.searchsorted(uniq, vals)]
            self._idx_to_raw.extend(uniq[order].tolist())
            merged_raw = np.concatenate([sorted_raw, uniq])
            merged_idx = np.concatenate([sorted_idx, id_of_uniq])
            o = np.argsort(merged_raw, kind="stable")
            self._index = (merged_raw[o], merged_idx[o])  # one atomic swap
        return out

    def encode_pair(self, src: np.ndarray, dst: np.ndarray):
        """Encode edge endpoint columns in arrival order (src before dst per
        edge — the order the reference's per-record processing would see).
        Returns (src_idx, dst_idx) int32 arrays."""
        if self._native is not None:
            ia, ib, novel = self._native.encode_pair(
                np.asarray(src, np.int64).ravel(),
                np.asarray(dst, np.int64).ravel(),
            )
            if novel.size:
                self._idx_to_raw.extend(novel.tolist())
            return ia, ib
        both = np.stack(
            [np.asarray(src, np.int64), np.asarray(dst, np.int64)], axis=1
        ).ravel()
        enc = self.encode(both)
        return enc[0::2], enc[1::2]

    def iter_encode_file(self, path: str, chunk_edges: int = 1 << 20):
        """Fused file ingest (native only): yield already-encoded
        ``(src_idx, dst_idx, val|None)`` int32 column chunks, keeping this
        dict's reverse table in sync. Raises RuntimeError without the
        native encoder (callers then parse and :meth:`encode_pair`)."""
        if self._native is None:
            raise RuntimeError("native encoder unavailable")
        for src, dst, val, novel in self._native.parse_encode_chunks(
            path, chunk_edges
        ):
            if novel.size:
                self._idx_to_raw.extend(novel.tolist())
            yield src, dst, val

    def encode_one(self, raw: int) -> int:
        return int(self.encode(np.asarray([raw]))[0])

    def lookup(self, raw: int) -> int | None:
        """Query without inserting; None if unseen."""
        if self._native is not None:
            return self._native.lookup(raw)
        sorted_raw, sorted_idx = self._index
        pos = int(np.searchsorted(sorted_raw, raw))
        if pos < sorted_raw.size and sorted_raw[pos] == raw:
            return int(sorted_idx[pos])
        return None

    def lookup_batch(self, raw: np.ndarray) -> np.ndarray:
        """Vectorized :meth:`lookup`: compact ids aligned with ``raw``, -1
        marking unseen ids. Never inserts."""
        raw = np.asarray(raw, np.int64).ravel()
        if self._native is not None:
            return self._native.lookup_batch(raw)
        out = np.full(raw.size, -1, np.int32)
        sorted_raw, sorted_idx = self._index  # consistent snapshot
        if raw.size and sorted_raw.size:
            pos = np.searchsorted(sorted_raw, raw)
            pos_c = np.minimum(pos, sorted_raw.size - 1)
            known = sorted_raw[pos_c] == raw
            out[known] = sorted_idx[pos_c[known]]
        return out

    def decode(self, idx: Iterable[int] | np.ndarray) -> np.ndarray:
        return self._rev_array()[np.asarray(idx, dtype=np.int64)]

    def decode_one(self, idx: int) -> int:
        return self._idx_to_raw[int(idx)]

    def _rev_array(self) -> np.ndarray:
        """Reverse table as numpy, cached by dict size."""
        n = len(self._idx_to_raw)
        if self._rev_cache is None or self._rev_cache.shape[0] != n:
            self._rev_cache = np.asarray(self._idx_to_raw, dtype=np.int64)
        return self._rev_cache

    def raw_ids(self) -> np.ndarray:
        """All raw ids in compact-index order."""
        return np.asarray(self._idx_to_raw, dtype=np.int64)

    def raw_table(self, device) -> torch.Tensor:
        """Device int32 lookup table, compact index -> raw vertex id, padded
        to :attr:`capacity` with zeros. Raw ids must fit int32; larger ids
        raise. Cached per dict size and device."""
        device = torch.device(device)
        n = len(self._idx_to_raw)
        cached = self._raw_table_cache.get(device)
        if cached is not None and cached[0] == n:
            return cached[1]
        raw = self.raw_ids()
        if raw.size and (
            raw.max() > np.iinfo(np.int32).max or raw.min() < np.iinfo(np.int32).min
        ):
            raise ValueError(
                "raw vertex ids exceed int32; re-map ids host-side before streaming"
            )
        padded = np.zeros(self.capacity, dtype=np.int32)
        padded[: raw.size] = raw.astype(np.int32)
        table = to_device(padded, device)
        self._raw_table_cache[device] = (n, table)
        return table
