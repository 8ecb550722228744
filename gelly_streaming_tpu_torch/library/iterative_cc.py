"""Iterative (label-emitting) connected components (PyTorch port of
``gelly_streaming_tpu/library/iterative_cc.py``).

The reference's feedback-loop CC variant
(``example/IterativeConnectedComponents.java:56-168``): a streaming
iteration whose keyed state maps component-id -> member set, emitting
corrected ``(vertex, componentId)`` pairs as labels shrink (componentId =
min raw vertex id in the component, ``:116-121``).

Two paths produce that corrected-label stream:

- **Incremental host path** (blocks that carry their host columns): the
  reference's own state shape, an incremental union-find (the native
  ``CompactUnionFind``) plus component member lists, run beside the
  parser. Every member of a component carries the same label (the
  component's raw min), so a window's emissions reduce to per-SIDE scalar
  tests: a constituent side of a merged component re-emits its members iff
  its window-start label differs from the final min, and new vertices
  always emit. Each window yields a LAZY batch.
- **Summary-diff path** (blocks without host columns: device-transformed
  or device-encoded streams): the shared CC aggregation on the device,
  then a label diff per window (vectorized over the emission's label
  arrays) with identical output.

Unlike the reference, the choice never hides a failure: when the blocks
carry host columns the incremental path needs the native library, and a
library that does not build or load raises instead of switching to the
diff path. The mesh of the reference comes with ROADMAP Queue 1, slice 6.
"""

from __future__ import annotations

from typing import Dict, Iterator

import numpy as np

from ..obs import trace as _trace
from .connected_components import ConnectedComponents

_I64_MAX = np.iinfo(np.int64).max


class LabelBatch:
    """One window's corrected ``(vertex, component_id)`` pairs, LAZY:
    held as two aligned arrays (ascending by vertex); python tuples
    materialize on first read (iteration / indexing), so unread windows
    cost nothing. List-like: len/iter/getitem/eq all behave like the
    summary-diff path's plain pair lists."""

    __slots__ = ("_v", "_c", "_items")

    def __init__(self, v: np.ndarray, c: np.ndarray):
        self._v = v
        self._c = c
        self._items = None

    def _list(self) -> list:
        if self._items is None:
            self._items = list(zip(self._v.tolist(), self._c.tolist()))
        return self._items

    def __iter__(self):
        return iter(self._list())

    def __len__(self) -> int:
        return len(self._v)

    def __getitem__(self, i):
        return self._list()[i]

    def __eq__(self, other):
        try:
            return self._list() == list(other)
        except TypeError:
            return NotImplemented

    def __repr__(self) -> str:
        return repr(self._list())


_EMPTY = LabelBatch(np.zeros(0, np.int64), np.zeros(0, np.int64))


class IterativeConnectedComponents:
    """``run(stream)`` yields, per window, the changed ``(vertex,
    component_id)`` pairs; ``labels()`` returns the full current mapping."""

    def __init__(self, mesh=None):
        if mesh is not None:
            raise NotImplementedError(
                "a sharded mesh is ported in ROADMAP Queue 1, slice 6 "
                "(multiple devices)"
            )
        self._agg = ConnectedComponents()
        # summary-diff state: the emitted labels as raw ids ascending and
        # their component ids
        self._diff_v = np.zeros(0, np.int64)
        self._diff_c = np.zeros(0, np.int64)
        # incremental host state: compact root -> list of member-id array
        # chunks (compact ids); per-root raw-min label; per-vertex last
        # emitted label; the touched bitmap
        self._uf = None
        self._members: Dict[int, list] = {}
        self._rmin_arr = np.zeros(0, np.int64)
        self._label_arr = np.zeros(0, np.int64)
        self._seen = np.zeros(0, bool)
        self._vdict = None
        self._mode = None  # None | "incremental" | "diff"

    # ------------------------------------------------------------------ #
    def _start_incremental(self) -> None:
        """The native union-find of the incremental path; raises
        RuntimeError when the native library does not build or load."""
        from .. import native

        self._uf = native.CompactUnionFind()

    def _grow(self, vcap: int) -> None:
        if len(self._seen) >= vcap:
            return
        grown = np.zeros(vcap, bool)
        grown[: len(self._seen)] = self._seen
        self._seen = grown
        # sentinel must be unreachable as a LABEL: labels are raw vertex
        # ids and raw ids may be negative, so -1 would collide; no real
        # component can have min raw id I64_MAX
        glab = np.full(vcap, _I64_MAX, np.int64)
        glab[: len(self._label_arr)] = self._label_arr
        self._label_arr = glab
        grmin = np.full(vcap, _I64_MAX, np.int64)
        grmin[: len(self._rmin_arr)] = self._rmin_arr
        self._rmin_arr = grmin

    def _incremental_window(self, src, dst, vcap, vdict) -> LabelBatch:
        tids, roots, changed, chroots = self._uf.fold(src, dst, vcap)
        self._grow(vcap)
        new_mask = ~self._seen[tids]
        self._seen[tids] = True
        nids = tids[new_mask].astype(np.int64)
        nroots = roots[new_mask]
        rmin = self._rmin_arr
        # affected FINAL roots: merge targets + new vertices' homes.
        # (A demoted root never coincides with a final root — chroots are
        # post-window finds — so pre-window side snapshots are exact.)
        afr = np.unique(np.concatenate([chroots, nroots])).astype(np.int64)
        old_afr = rmin[afr].copy()       # +inf where fr had no pre-window side
        old_side = rmin[changed].copy()  # demoted sides' window-start labels
        pre_sides = {
            int(fr): self._members.get(int(fr)) for fr in afr.tolist()
        }
        # final minima: two vectorized scatter-mins
        if len(nids):
            nraw = vdict.decode(nids).astype(np.int64)
            np.minimum.at(rmin, nroots, nraw)
        if len(changed):
            np.minimum.at(rmin, chroots, old_side)
        out_ids: list = []
        out_lab: list = []
        # 1. surviving pre-window sides that lost the min
        for fr, old in zip(afr.tolist(), old_afr.tolist()):
            chunks = pre_sides[fr]
            if chunks and old != rmin[fr]:
                ids_arr = np.concatenate(chunks)
                out_ids.append(ids_arr)
                out_lab.append(np.full(len(ids_arr), rmin[fr], np.int64))
        # 2. demoted sides: emit iff their label lost; move the chunks
        for i, (r, fr) in enumerate(zip(changed.tolist(), chroots.tolist())):
            chunks = self._members.pop(r, None)
            if chunks is None:
                continue  # never a carried component (fresh this window)
            if old_side[i] != rmin[fr]:
                ids_arr = np.concatenate(chunks)
                out_ids.append(ids_arr)
                out_lab.append(np.full(len(ids_arr), rmin[fr], np.int64))
            home = self._members.get(fr)
            if home is None:
                self._members[fr] = chunks
            else:
                home.extend(chunks)
        # 3. new vertices: always emit; register one chunk per root group
        if len(nids):
            out_ids.append(nids)
            out_lab.append(rmin[nroots])
            order = np.argsort(nroots, kind="stable")
            uniq, starts = np.unique(nroots[order], return_index=True)
            for r, grp in zip(
                uniq.tolist(), np.split(nids[order], starts[1:])
            ):
                home = self._members.get(int(r))
                if home is None:
                    self._members[int(r)] = [grp]
                else:
                    home.append(grp)
        if not out_ids:
            return _EMPTY
        vs = np.concatenate(out_ids)
        ls = np.concatenate(out_lab)
        # last-wins dedupe (a side can move and re-label in one window):
        # unique over the REVERSED array keeps the final assignment
        _, ridx = np.unique(vs[::-1], return_index=True)
        last = len(vs) - 1 - ridx
        vs_u = vs[last]
        ls_u = ls[last]
        keep = self._label_arr[vs_u] != ls_u
        vs_k = vs_u[keep]
        ls_k = ls_u[keep]
        if len(vs_k) == 0:
            return _EMPTY
        self._label_arr[vs_k] = ls_k
        raw_vs = vdict.decode(vs_k).astype(np.int64)
        order = np.argsort(raw_vs, kind="stable")
        return LabelBatch(raw_vs[order], ls_k[order])

    # ------------------------------------------------------------------ #
    def _downgrade_to_diff(self) -> None:
        """Convert the union-find state into the summary-diff path's
        carry (a cache-less block arrived mid-stream): canonical flat
        compact labels restore into the shared CC aggregation, and the
        emitted-label map materializes into the diff dict."""
        vcap = len(self._seen)
        if vcap and self._uf is not None:
            self._agg.restore_state(
                {
                    "labels": self._uf.flatten(vcap).astype(np.int32),
                    "touched": self._seen.copy(),
                },
                vcap=vcap,
            )
            idx = np.nonzero(self._seen)[0]
            raws = self._vdict.decode(idx).astype(np.int64)
            order = np.argsort(raws, kind="stable")
            self._diff_v = raws[order]
            self._diff_c = self._label_arr[idx][order]
        self._mode = "diff"

    def run(self, stream) -> Iterator[LabelBatch]:
        vdict = stream.vertex_dict
        self._vdict = vdict
        blocks = stream.blocks()
        pending = None
        if self._mode != "diff":
            for block in blocks:
                cache = getattr(block, "_host_cache", None)
                if self._mode is None:
                    if cache is None:
                        self._mode = "diff"
                        pending = block
                        break
                    self._start_incremental()
                    self._mode = "incremental"
                if cache is None:
                    # device-transformed continuation: hand the carried
                    # state to the summary-diff path and keep streaming
                    self._downgrade_to_diff()
                    pending = block
                    break
                with _trace.span("icc.incremental"):
                    batch = self._incremental_window(
                        cache[0], cache[1], block.n_vertices, vdict
                    )
                yield batch
            else:
                return
        from itertools import chain

        from ..core.stream import SimpleEdgeStream

        rest = chain([pending], blocks) if pending is not None else blocks
        shim = SimpleEdgeStream(
            _blocks=lambda: rest, _vdict=vdict, context=stream.get_context(),
        )
        for comps in self._agg.run(shim):
            with _trace.span("icc.diff"):
                batch = self._diff_window(comps, vdict)
            yield batch

    def _diff_window(self, comps, vdict) -> LabelBatch:
        """The changed ``(vertex, component_id)`` pairs of one emission,
        against the labels emitted so far, ascending by raw id."""
        ids, lab = comps.labels()
        raw = vdict.decode(ids).astype(np.int64)
        # component id: the least raw id among the members of each label
        uniq, inv = np.unique(lab, return_inverse=True)
        least = np.full(len(uniq), _I64_MAX, np.int64)
        np.minimum.at(least, inv, raw)
        order = np.argsort(raw, kind="stable")
        v = raw[order]
        c = least[inv][order]
        same = np.zeros(len(v), bool)
        if len(self._diff_v):
            pos = np.minimum(np.searchsorted(self._diff_v, v), len(self._diff_v) - 1)
            same = (self._diff_v[pos] == v) & (self._diff_c[pos] == c)
        self._diff_v, self._diff_c = v, c
        return LabelBatch(v[~same], c[~same])

    def labels(self) -> Dict[int, int]:
        if self._mode == "incremental":
            idx = np.nonzero(self._seen)[0]
            if len(idx) == 0:
                return {}
            raws = self._vdict.decode(idx).astype(np.int64)
            labs = self._label_arr[idx]
            return {int(v): int(c) for v, c in zip(raws, labs)}
        return dict(zip(self._diff_v.tolist(), self._diff_c.tolist()))
