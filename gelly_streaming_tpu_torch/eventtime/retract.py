"""Decremental summaries: results that stay correct as panes expire (the
port's copy of ``gelly_streaming_tpu/eventtime/retract.py``).

The add-only single-pass model excludes retraction: a degree count can
decrement, but a union-find cannot un-union. Each summary here picks the
cheapest exact decremental strategy, and each ships its from-scratch
oracle, so the contract is testable as byte identity on the surviving
edge multiset at every pane boundary. Like the reference, all of it is
host numpy: the card has no work on this path.

- **Degree / heavy hitters** (:class:`DecDegree`): per-vertex counts are a
  sum, so expiry subtracts the pane's contribution. Heavy hitters are the
  exact top-k with deterministic ties (degree desc, vertex id asc).
- **Connected components** (:class:`DecForest`): expiry goes through the
  forest REPAIR
  (:func:`~gelly_streaming_tpu_torch.summaries.forest.repair_forest_host`):
  only the components the expired edges touched are reset and re-folded
  from the surviving panes' edges.
- **Bipartiteness** (:class:`DecBipartite`): the signed double cover over
  ``2 * vcap`` cover ids. The odd-cycle verdict latches while adding, but
  expiry can dissolve the odd cycle, so on retraction the cover forest is
  repaired and the latch RE-RESOLVED from it (conflict iff some vertex's
  (+) and (-) cover nodes share a component).

All three grow their vertex capacity on demand; labels of existing
vertices are kept exactly across growth (new rows are singletons, which is
what a from-scratch fold over the same multiset gives unseen ids).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from ..summaries.forest import (
    fold_edges_host,
    fold_into_forest_host,
    repair_forest_host,
    resolve_flat_host,
)


# --------------------------------------------------------------------- #
# From-scratch oracles (the byte-identity reference for every summary)
# --------------------------------------------------------------------- #
def oracle_labels(vcap: int, src, dst) -> np.ndarray:
    """CC labels of the given edge multiset, from scratch: one fold over an
    identity table."""
    return fold_edges_host(
        np.arange(vcap, dtype=np.int64),
        np.asarray(src, np.int64), np.asarray(dst, np.int64),
    )


def oracle_degrees(vcap: int, src, dst) -> np.ndarray:
    """Degrees of the given edge multiset, from scratch (both endpoints
    count; a self-loop counts twice)."""
    deg = np.zeros(vcap, np.int64)
    np.add.at(deg, np.asarray(src, np.int64), 1)
    np.add.at(deg, np.asarray(dst, np.int64), 1)
    return deg


def oracle_bipartite(vcap: int, src, dst) -> bool:
    """Bipartiteness of the given edge multiset, from scratch: CC over the
    signed double cover; bipartite iff no vertex's (+)/(-) cover nodes
    share a component."""
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    cs, cd = _cover_cols(src, dst, vcap)
    lab = fold_edges_host(np.arange(2 * vcap, dtype=np.int64), cs, cd)
    return not bool(np.any(lab[:vcap] == lab[vcap:]))


def _cover_cols(src: np.ndarray, dst: np.ndarray,
                vcap: int) -> Tuple[np.ndarray, np.ndarray]:
    """One edge column pair expanded to the signed-cover pair
    ((u,+)~(v,-) and (u,-)~(v,+)) over ``2 * vcap`` cover ids."""
    return (
        np.concatenate([src, src + vcap]),
        np.concatenate([dst + vcap, dst]),
    )


# --------------------------------------------------------------------- #
# Degree / heavy hitters
# --------------------------------------------------------------------- #
class DecDegree:
    """Exact decremental degree table + exact top-k heavy hitters."""

    def __init__(self, vcap: int = 0):
        self.deg = np.zeros(int(vcap), np.int64)

    @property
    def vcap(self) -> int:
        return len(self.deg)

    def grow(self, vcap: int) -> None:
        if vcap > len(self.deg):
            self.deg = np.concatenate(
                [self.deg, np.zeros(vcap - len(self.deg), np.int64)]
            )

    def add(self, src, dst) -> None:
        np.add.at(self.deg, np.asarray(src, np.int64), 1)
        np.add.at(self.deg, np.asarray(dst, np.int64), 1)

    def retract(self, src, dst) -> None:
        """Subtract one expired pane's contribution: exact, never clamped
        (a negative degree would be a caller bug, not data)."""
        np.subtract.at(self.deg, np.asarray(src, np.int64), 1)
        np.subtract.at(self.deg, np.asarray(dst, np.int64), 1)

    def top_k(self, k: int) -> list:
        """``[(vertex, degree), ...]`` by degree desc then vertex id asc,
        zero-degree vertices excluded."""
        nz = np.nonzero(self.deg)[0]
        if len(nz) == 0 or k < 1:
            return []
        # sort by (-degree, id): lexsort's LAST key is primary
        order = np.lexsort((nz, -self.deg[nz]))[:k]
        picked = nz[order]
        return [(int(v), int(self.deg[v])) for v in picked]

    def state_dict(self) -> dict:
        return {"deg": self.deg.copy()}

    def load_state_dict(self, state: dict) -> None:
        self.deg = np.asarray(state["deg"], np.int64).copy()


# --------------------------------------------------------------------- #
# Connected components
# --------------------------------------------------------------------- #
class DecForest:
    """CC over the live multiset: incremental union on pane close, bounded
    repair on pane expiry. The carried table is the canonical min-rooted
    host forest, so between retractions it is byte-identical to a
    from-scratch fold; a retraction's repair re-establishes that over the
    surviving multiset and reports its stats."""

    def __init__(self, vcap: int = 0):
        self.lab = np.arange(int(vcap), dtype=np.int64)
        self.last_repair: Dict[str, int] = {}

    @property
    def vcap(self) -> int:
        return len(self.lab)

    def grow(self, vcap: int) -> None:
        if vcap > len(self.lab):
            self.lab = np.concatenate([
                self.lab,
                np.arange(len(self.lab), vcap, dtype=np.int64),
            ])

    def add(self, src, dst) -> None:
        self.lab = fold_into_forest_host(self.lab, src, dst)

    def retract(self, expired_src, expired_dst,
                surviving_src, surviving_dst) -> Dict[str, int]:
        self.lab, stats = repair_forest_host(
            self.lab, expired_src, expired_dst,
            surviving_src, surviving_dst,
        )
        self.last_repair = stats
        return stats

    def labels(self) -> np.ndarray:
        return resolve_flat_host(self.lab)

    def state_dict(self) -> dict:
        return {"lab": self.lab.copy()}

    def load_state_dict(self, state: dict) -> None:
        self.lab = np.asarray(state["lab"], np.int64).copy()


# --------------------------------------------------------------------- #
# Bipartiteness
# --------------------------------------------------------------------- #
class DecBipartite:
    """Bipartiteness over the live multiset via the signed double cover,
    with the odd-cycle latch RE-RESOLVED on every expiry: :meth:`retract`
    repairs the cover forest (the same bounded repair as CC, over cover
    ids and cover-expanded columns) and the verdict is read from the
    repaired structure, never carried across an expiry."""

    def __init__(self, vcap: int = 0):
        self.vcap = int(vcap)
        self.cover = np.arange(2 * self.vcap, dtype=np.int64)

    def grow(self, vcap: int) -> None:
        """Grow the COVER table keeping labels: cover ids are ``v`` and
        ``v + vcap``, so growth re-homes the (-) half to the new offset
        (labels that pointed into the old (-) half shift with it)."""
        vcap = int(vcap)
        if vcap <= self.vcap:
            return
        old = self.vcap
        lab = resolve_flat_host(self.cover)
        grown = np.arange(2 * vcap, dtype=np.int64)
        shift = np.where(lab >= old, lab + (vcap - old), lab)
        grown[:old] = shift[:old]
        grown[vcap:vcap + old] = shift[old:]
        self.vcap = vcap
        self.cover = resolve_flat_host(grown)

    def add(self, src, dst) -> None:
        cs, cd = _cover_cols(np.asarray(src, np.int64),
                             np.asarray(dst, np.int64), self.vcap)
        self.cover = fold_into_forest_host(self.cover, cs, cd)

    def retract(self, expired_src, expired_dst,
                surviving_src, surviving_dst) -> Dict[str, int]:
        es, ed = _cover_cols(
            np.asarray(expired_src, np.int64),
            np.asarray(expired_dst, np.int64), self.vcap,
        )
        ss, sd = _cover_cols(
            np.asarray(surviving_src, np.int64),
            np.asarray(surviving_dst, np.int64), self.vcap,
        )
        self.cover, stats = repair_forest_host(self.cover, es, ed, ss, sd)
        return stats

    def is_bipartite(self) -> bool:
        """The verdict, resolved from the cover structure."""
        lab = resolve_flat_host(self.cover)
        return not bool(np.any(lab[:self.vcap] == lab[self.vcap:]))

    def conflict_witness(self) -> Optional[int]:
        """The smallest vertex whose (+)/(-) cover nodes share a component,
        None when bipartite."""
        lab = resolve_flat_host(self.cover)
        hit = np.nonzero(lab[:self.vcap] == lab[self.vcap:])[0]
        return int(hit[0]) if len(hit) else None

    def state_dict(self) -> dict:
        return {"vcap": self.vcap, "cover": self.cover.copy()}

    def load_state_dict(self, state: dict) -> None:
        self.vcap = int(state["vcap"])
        self.cover = np.asarray(state["cover"], np.int64).copy()
