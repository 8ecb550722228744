"""Dense label propagation: the device-side union-find (PyTorch port).

The counterpart of ``gelly_streaming_tpu/summaries/labels.py``. The
reference's ``DisjointSet`` pointer chasing densifies into an int32
``labels[V]`` table where ``labels[v]`` is the compact index of the
smallest vertex known reachable from ``v``. Per window, min-label
propagation with pointer jumping runs to a fixpoint: hook (scatter-min)
and shortcut (gather) as dense tensor operations.

- :func:`cc_fold` folds one window's edges into a label table (the
  ``UpdateCC`` analog).
- :func:`label_combine` merges two tables. Elementwise min is NOT enough
  (a link recorded in only one table can be dropped); the merge treats
  both tables as pointer graphs and re-runs the fixpoint (the
  ``CombineCC``/``DisjointSet.merge`` analog).
- :func:`grow_labels` extends a table when the vertex dictionary grows.

States are dicts of tensors on one device, ``{"labels": int32[V],
"touched": bool[V]}``; ``touched`` marks the vertices that appeared in an
edge, so emission skips never-seen singletons as the reference does.
Every function returns new tensors and never writes into its inputs: an
emitted window holds its state, and a later window must not change it.

The reference's ``lax.while_loop`` on ``jnp.any(...)`` is a Python loop
here that reads its condition to the host on every turn; the turns and
the reads are counted (:data:`FIXPOINT_TURNS`, :data:`HOST_READS`).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from ..obs import trace as _trace

I32_MAX = int(np.iinfo(np.int32).max)

#: device -> host reads made by the CC fold path (each loop condition of a
#: fixpoint, each download of a carry); callers zero it and read it
HOST_READS = 0
#: turns of the device fixpoints (root chase, min-label propagation,
#: pointer-jumping resolve)
FIXPOINT_TURNS = 0


def any_on_host(flags: torch.Tensor) -> bool:
    """``flags.any()`` read to the host: the loop condition of a fixpoint,
    one counted turn and one counted host read."""
    global HOST_READS, FIXPOINT_TURNS
    HOST_READS += 1
    FIXPOINT_TURNS += 1
    return bool(flags.any())


def count_host_read() -> None:
    """Count a device -> host download made outside a fixpoint."""
    global HOST_READS
    HOST_READS += 1


def init_labels(vcap: int, device) -> Dict[str, torch.Tensor]:
    """Fresh state: every vertex its own component, nothing touched."""
    return {
        "labels": torch.arange(vcap, dtype=torch.int32, device=device),
        "touched": torch.zeros(vcap, dtype=torch.bool, device=device),
    }


def _propagate(labels: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
               mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Min-label fixpoint over the constraint edges ``u[i] ~ v[i]`` (where
    ``mask``; None means every edge).

    Each turn hooks (scatter-min of ``min(label_u, label_v)`` onto both
    endpoints) and shortcuts (one pointer jump ``labels[labels]``), until
    no label changes; at least one turn runs, as in the reference. Masked
    rows carry +inf, a no-op under min. ``labels`` is not written."""
    with _trace.span("cc.propagate"):
        ul = u.long()
        vl = v.long()
        lab = labels
        while True:
            m = torch.minimum(lab[ul], lab[vl])
            if mask is not None:
                m = torch.where(mask, m, I32_MAX)
            new = lab.clone()
            new.scatter_reduce_(0, ul, m, "amin")
            new.scatter_reduce_(0, vl, m, "amin")
            new = new[new.long()]  # shortcut: one round of pointer jumping
            changed = new != lab
            lab = new
            if not any_on_host(changed):
                return lab


def cc_fold(state: Dict[str, torch.Tensor], src: torch.Tensor,
            dst: torch.Tensor, mask: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Fold one window's edges into the label table (per-shard update)."""
    labels = _propagate(state["labels"], src, dst, mask)
    vcap = labels.shape[0]
    # touched[src] |= mask, touched[dst] |= mask: masked lanes write into
    # a sentinel slot at vcap (the reference's scatter mode="drop")
    touched = torch.cat([state["touched"], state["touched"].new_zeros(1)])
    sentinel = torch.full_like(src, vcap)
    touched[torch.where(mask, src, sentinel).long()] = True
    touched[torch.where(mask, dst, sentinel).long()] = True
    return {"labels": labels, "touched": touched[:vcap]}


def label_combine(a: Dict[str, torch.Tensor],
                  b: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Merge two label tables into the labels of the union graph.

    The union's constraints are exactly the pointer edges ``(v,
    a.labels[v])`` and ``(v, b.labels[v])``; the fixpoint over those 2V
    edges is CC of the union. (Elementwise min would lose links: with
    a = [.., 5~3] and b = [.., 5~1], min drops the 3~5 link.)"""
    la, lb = a["labels"], b["labels"]
    iota = torch.arange(la.shape[0], dtype=torch.int32, device=la.device)
    u = torch.cat([iota, iota])
    w = torch.cat([la, lb])
    labels = _propagate(torch.minimum(la, lb), u, w, None)
    return {"labels": labels, "touched": a["touched"] | b["touched"]}


def grow_labels(state: Dict[str, torch.Tensor],
                new_vcap: int) -> Dict[str, torch.Tensor]:
    """Extend the table when the vertex dictionary bucket grows."""
    lab = state["labels"]
    old = lab.shape[0]
    if new_vcap <= old:
        return state
    ext = torch.arange(old, new_vcap, dtype=torch.int32, device=lab.device)
    return {
        "labels": torch.cat([lab, ext]),
        "touched": torch.cat([
            state["touched"],
            torch.zeros(new_vcap - old, dtype=torch.bool, device=lab.device),
        ]),
    }


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A host copy of a carry tensor (a counted host read on a card)."""
    if t.device.type != "cpu":
        count_host_read()
    return t.cpu().numpy()


# --------------------------------------------------------------------------- #
# Host-side emission
# --------------------------------------------------------------------------- #
class Components:
    """Host view of a label table: the stand-in for the emitted
    ``DisjointSet`` (``library/ConnectedComponents.java:41``).

    ``components`` maps the component's representative (min *raw* vertex
    id) to the sorted raw member list. ``__str__`` matches the Java map
    format the reference's test parser reads (``DisjointSet.java:139-153``).
    """

    def __init__(self, components: Optional[Dict[int, List[int]]] = None, *,
                 _lazy=None, _lazy_forest=None, _lazy_replay=None):
        self._components = components
        self._lazy = _lazy  # (labels_dev, touched_dev, n, vdict)
        # (canon_dev, touch_log, count, vdict): forest-carry emission —
        # chains resolve on the host at materialization; the touched set
        # is the first `count` entries of the append-only host log
        self._lazy_forest = _lazy_forest
        # (replay, window_index, touch_log, count, vdict): superbatch
        # emission — the mid-group canon rebuilds from the group's delta
        # stack on first read (forest.ForestReplay / MirrorReplay)
        self._lazy_replay = _lazy_replay

    def labels(self):
        """``(ids, labels)``: the compact ids of the vertices seen so far,
        ascending, and the canonical label of each (the least compact id of
        its component). Two views are the same partition exactly when these
        arrays are equal; no per-component host work is done."""
        from .forest import resolve_flat_host

        if self._lazy_replay is not None:
            replay, win, log, count, _vdict = self._lazy_replay
            table = resolve_flat_host(replay.canon_np(win))
            idx = np.sort(log.ids[:count])
        elif self._lazy_forest is not None:
            canon_dev, log, count, _vdict = self._lazy_forest
            table = resolve_flat_host(to_numpy(canon_dev))
            idx = np.sort(log.ids[:count])
        else:
            labels_dev, touched_dev, n, vdict = self._lazy
            table = to_numpy(labels_dev)
            touched = to_numpy(touched_dev)
            if n is None:
                # the dict size is read at materialization; `touched` was
                # snapshotted with the labels, so vertices first seen later
                # are False there and a larger n admits nothing extra
                n = len(vdict)
            idx = np.nonzero(touched[: min(n, touched.shape[0])])[0]
        return idx, table[idx]

    @property
    def components(self) -> Dict[int, List[int]]:
        """Materialized (root -> sorted members) map; the download and the
        host grouping happen on first access, so emissions nobody reads
        cost nothing."""
        if self._components is None:
            lazy = self._lazy_replay or self._lazy_forest or self._lazy
            vdict = lazy[-1]
            idx, lab = self.labels()
            raw = vdict.decode(idx)
            # one (label, raw) lexsort: every component's member slice comes
            # out ascending, so its root is its first element
            order = np.lexsort((raw, lab))
            lab_s = lab[order]
            raw_s = raw[order]
            _, starts = np.unique(lab_s, return_index=True)
            self._components = {}
            for members in np.split(raw_s, starts[1:]):
                ms = members.tolist()
                self._components[ms[0]] = ms
        return self._components

    @staticmethod
    def from_labels(state: Dict[str, torch.Tensor], vdict) -> "Components":
        """Lazy view over a dense label table."""
        return Components(
            _lazy=(state["labels"], state["touched"], None, vdict)
        )

    @staticmethod
    def from_forest(canon, log, vdict) -> "Components":
        """Lazy view over a forest carry (``summaries/forest.py``): the
        canon is this window's own tensor, which no later window writes;
        the touched set snapshots as a COUNT into the append-only log."""
        return Components(_lazy_forest=(canon, log, log.count, vdict))

    @staticmethod
    def from_forest_replay(replay, win: int, log, count: int,
                           vdict) -> "Components":
        """Lazy view over window ``win`` of a superbatch group: the
        mid-group canon exists only as the group's delta stack and is
        rebuilt on first read; the touched set is the caller-recorded
        per-window COUNT into the append-only log."""
        return Components(_lazy_replay=(replay, win, log, count, vdict))

    def num_components(self) -> int:
        return len(self.components)

    def component_sets(self) -> List[frozenset]:
        return [frozenset(m) for m in self.components.values()]

    def __eq__(self, other) -> bool:
        return isinstance(other, Components) and self.components == other.components

    def __str__(self) -> str:
        inner = ", ".join(
            f"{root}={members}" for root, members in sorted(self.components.items())
        )
        return "{" + inner + "}"

    __repr__ = __str__
