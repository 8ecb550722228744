"""Sorted-run key set: a cheap host shadow for growing key sets.

The port's copy of ``gelly_streaming_tpu/utils/keyruns.py`` (host-only
numpy). An exact host-side set of canonical int64 keys kept beside the
stream as a single sorted array updated by ``np.insert`` costs O(total)
copying per window, quadratic over the stream. This LSM-style variant
(used by ``SimpleEdgeStream.distinct`` without the native encoder) keeps
O(log N) sorted runs with geometric merging: amortized O(N log N) total
insertion, O(log N) binary-search probes per lookup batch.
"""

from __future__ import annotations

import numpy as np


class SortedRunSet:
    """Set of int64 keys stored as O(log N) sorted runs."""

    __slots__ = ("_runs", "_n")

    def __init__(self, initial: np.ndarray | None = None):
        self._runs: list = []
        self._n = 0
        if initial is not None and len(initial):
            arr = np.unique(np.asarray(initial, np.int64))
            self._runs.append(arr)
            self._n = len(arr)

    def __len__(self) -> int:
        return self._n

    def contains(self, keys: np.ndarray) -> np.ndarray:
        """Membership mask for ``keys`` (any order, int64)."""
        dup = np.zeros(len(keys), bool)
        for run in self._runs:
            pos = np.searchsorted(run, keys)
            pos = np.minimum(pos, len(run) - 1)
            dup |= run[pos] == keys
        return dup

    def filter_new(self, keys: np.ndarray) -> np.ndarray:
        """``keys`` must be sorted-unique; returns the subset NOT in the
        set (the per-window novelty probe)."""
        if not self._runs or not len(keys):
            return keys
        return keys[~self.contains(keys)]

    def add(self, new_keys: np.ndarray) -> None:
        """Insert sorted-unique keys disjoint from the current content.
        Geometric merge: collapse the newest runs while the last is at
        least half its neighbor — every key is re-merged O(log N) times
        total."""
        if not len(new_keys):
            return
        self._runs.append(np.asarray(new_keys, np.int64))
        self._n += len(new_keys)
        while (
            len(self._runs) >= 2
            and len(self._runs[-1]) * 2 >= len(self._runs[-2])
        ):
            b = self._runs.pop()
            a = self._runs.pop()
            self._runs.append(_merge_disjoint(a, b))

    def to_array(self) -> np.ndarray:
        """All keys, sorted (checkpoint/debug surface)."""
        if not self._runs:
            return np.zeros(0, np.int64)
        out = self._runs[0]
        for run in self._runs[1:]:
            out = _merge_disjoint(out, run)
        return out


def _merge_disjoint(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Two-way merge of DISJOINT sorted int64 runs (searchsorted placement
    + boolean scatter — one O(n) pass, no re-sort)."""
    pos = np.searchsorted(a, b)
    idx_b = pos + np.arange(len(b))
    merged = np.empty(len(a) + len(b), np.int64)
    mask = np.zeros(len(merged), bool)
    mask[idx_b] = True
    merged[mask] = b
    merged[~mask] = a
    return merged
