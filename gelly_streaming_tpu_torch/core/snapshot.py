"""SnapshotStream: discretized graph snapshots and neighborhood aggregations
(PyTorch port).

The counterpart of ``gelly_streaming_tpu/core/snapshot.py``
(``SnapshotStream.java``): the result of ``SimpleEdgeStream.slice()``, a
stream of discrete graphs, one per tumbling window, on which per-vertex
neighborhood aggregations run. The reference folds, reduces and applies
per key over Flink windows (``SnapshotStream.java:61-181``); here each
window is a few batched tensor steps over its EdgeBlock:

- :meth:`fold_neighbors`  -> ``ops.segment.segmented_fold``: arrival-order
  fold, in lockstep across vertices (the ``EdgesFold`` analog);
- :meth:`reduce_on_edges` -> ``"sum"/"min"/"max"/"prod"`` as one scatter,
  an associative callable as the log-depth segmented scan (the
  ``EdgesReduce`` analog);
- :meth:`apply_on_neighbors` / :meth:`flat_apply_on_neighbors` -> dense
  padded neighborhoods per degree class and a UDF lifted with
  :func:`torch.func.vmap` (the ``EdgesApply`` analog).

User functions are written with torch operations for ONE vertex (or one
edge, for a fold; a reduce's ``combine`` works elementwise on batches).
Under ``vmap`` they may not branch on data (use ``torch.where``), call
``.item()``/``.tolist()`` or write in place into their inputs; they may
build index tensors from static shapes (``torch.triu_indices(D, D, 1)``).

Direction semantics follow ``slice(Time, EdgeDirection)``
(``SimpleEdgeStream.java:135-167``): OUT keys by src (neighbor = dst), IN
by dst (neighbor = src), ALL both ways. The degree-class planner reads the
host columns of windower blocks, never the device.
"""

from __future__ import annotations

from typing import Any, Callable, Iterator, Optional, Tuple

import numpy as np
import torch
from torch.func import vmap
from torch.utils import _pytree as pytree

from .edgeblock import EdgeBlock, bucket_capacity, to_device
from .emission import host_array
from .types import EdgeDirection
from .vertexdict import VertexDict

_SLICE6 = "ROADMAP Queue 1, slice 6 (multiple devices)"


def expand_direction(
    block: EdgeBlock, direction: EdgeDirection
) -> Tuple[torch.Tensor, torch.Tensor, Any, torch.Tensor]:
    """Return (key, neighbor, val, mask) tensors for the given direction."""
    if direction == EdgeDirection.OUT:
        return block.src, block.dst, block.val, block.mask
    if direction == EdgeDirection.IN:
        return block.dst, block.src, block.val, block.mask
    key = torch.cat([block.src, block.dst])
    nbr = torch.cat([block.dst, block.src])
    val = pytree.tree_map(lambda v: torch.cat([v, v]), block.val)
    mask = torch.cat([block.mask, block.mask])
    return key, nbr, val, mask


def _item(a):
    return a.item() if a.ndim == 0 else a


class SnapshotStream:
    """A stream of discrete graph snapshots (``SnapshotStream.java:46``)."""

    def __init__(
        self,
        block_iter_fn: Callable[[], Iterator[EdgeBlock]],
        direction: EdgeDirection,
        vdict: VertexDict,
        context,
    ):
        self._block_iter_fn = block_iter_fn
        self.direction = direction
        self._vdict = vdict
        self.context = context

    def _raw32(self, device) -> torch.Tensor:
        return self._vdict.raw_table(device)

    def _mesh(self):
        """The context's mesh; sharded snapshot reductions are ported with
        the multi-device slice, so a context with a mesh raises."""
        mesh = getattr(self.context, "mesh", None)
        if mesh is not None:
            raise NotImplementedError(
                f"a slice() reduce over a mesh is ported in {_SLICE6}"
            )
        return None

    def _emit(self, result, nonempty):
        """Yield (raw_vertex_id, record) for each nonempty vertex: one
        decode and one download per result leaf a window."""
        idxs = np.nonzero(host_array(nonempty))[0]
        if idxs.size == 0:
            return
        sel = torch.from_numpy(idxs).to(nonempty.device)
        yield from self._emit_pairs(
            idxs, pytree.tree_map(lambda a: host_array(a[sel]), result)
        )

    def _emit_pairs(self, vids: np.ndarray, result_h):
        """Yield (raw_vertex_id, record) for vertices ``vids`` whose results
        are host arrays aligned with them."""
        raws = self._vdict.decode(vids).tolist()
        if isinstance(result_h, np.ndarray):
            scalar = result_h.ndim == 1
            for i, raw in enumerate(raws):
                v = result_h[i]
                yield int(raw), (v.item() if scalar else v)
            return
        for i, raw in enumerate(raws):
            yield int(raw), pytree.tree_map(lambda a: _item(a[i]), result_h)

    def _window_degrees(self, b: EdgeBlock, degree: torch.Tensor) -> np.ndarray:
        """Per-vertex degrees for the planners, from the block's host
        columns when it has them (a direction-aware host bincount) and
        never from the device then; device-transformed blocks read
        ``degree`` back once (:meth:`_degree_readback`)."""
        cache = getattr(b, "_host_cache", None)
        if cache is None:
            return self._degree_readback(degree)
        src, dst = cache[0], cache[1]
        n = b.n_vertices
        if self.direction == EdgeDirection.OUT:
            return np.bincount(src, minlength=n)
        if self.direction == EdgeDirection.IN:
            return np.bincount(dst, minlength=n)
        return np.bincount(src, minlength=n) + np.bincount(dst, minlength=n)

    def _degree_readback(self, degree: torch.Tensor) -> np.ndarray:
        """The one read per window for blocks without host columns; a hook
        of its own so a test can show the cached path never lands here."""
        return host_array(degree)

    # ------------------------------------------------------------------ #
    def fold_neighbors(self, initial_value: Any, fold_fn: Callable) -> Iterator[Tuple[int, Any]]:
        """Per-vertex arrival-order fold over the windowed neighborhood
        (``SnapshotStream.java:61-86``).

        ``fold_fn(accum, vertex_id, neighbor_id, edge_value) -> accum`` is
        written with torch operations for ONE edge and lifted with
        :func:`torch.func.vmap` over the vertices of a lockstep turn (see
        ``ops.segment.segmented_fold``). Ids presented to it are raw ids;
        Python numbers in ``initial_value`` become int32/float32 tensors."""
        from ..ops.segment import segment_count, segmented_fold

        for b in self._block_iter_fn():
            key, nbr, val, mask = expand_direction(b, self.direction)
            raw = self._raw32(b.src.device)
            counts = self._window_degrees(
                b, segment_count(key, mask, b.n_vertices)
            )
            result, nonempty = segmented_fold(
                initial_value, fold_fn, key, nbr, val, mask,
                num_segments=b.n_vertices, id_of_segment=raw,
                id_of_neighbor=raw, counts_host=counts,
            )
            yield from self._emit(result, nonempty)

    def reduce_on_edges(self, reduce_fn) -> Iterator[Tuple[int, Any]]:
        """Per-vertex associative reduction of edge values
        (``SnapshotStream.java:100-120``).

        ``reduce_fn`` is one of ``"sum" | "min" | "max" | "prod"`` (one
        scatter, no sort) or an associative ``combine(a, b) -> c`` written
        with elementwise torch operations (the segmented scan)."""
        from ..ops.segment import segment_count, segment_reduce, segmented_reduce_generic

        if isinstance(reduce_fn, str):
            self._mesh()

            def window(b: EdgeBlock):
                key, _nbr, val, mask = expand_direction(b, self.direction)
                out = segment_reduce(val, key, mask, b.n_vertices, op=reduce_fn)
                return out, segment_count(key, mask, b.n_vertices) > 0
        else:
            def window(b: EdgeBlock):
                key, _nbr, val, mask = expand_direction(b, self.direction)
                return segmented_reduce_generic(
                    val, key, mask, b.n_vertices, combine=reduce_fn
                )

        for b in self._block_iter_fn():
            yield from self._emit(*window(b))

    def _class_plan(self, b: EdgeBlock, csr, max_degree: Optional[int]):
        """Active vertices grouped by degree class: ``[(D, vids)]`` in
        ascending D, each class's row width ``D`` the power-of-two bucket
        of its degrees (at least 4), or ``max_degree`` for all."""
        deg = self._window_degrees(b, csr.degree)
        active = np.nonzero(deg > 0)[0]
        if active.size == 0:
            return []
        if max_degree is not None:
            buckets = np.full(active.size, max_degree, np.int64)
        else:
            buckets = np.int64(1) << np.ceil(
                np.log2(np.maximum(deg[active], 1))
            ).astype(np.int64)
            buckets = np.maximum(buckets, 4)
        return [(int(c), active[buckets == c]) for c in np.unique(buckets)]

    def _class_rows(self, csr, raw, vids: np.ndarray, D: int, apply_fn):
        """Run ``apply_fn`` lifted over one class's vertices (padded to a
        power-of-two count, as the reference pads its jit shapes)."""
        from ..ops.csr import dense_neighbors_subset

        t = len(vids)
        tcap = bucket_capacity(t, 4)
        vids_p = np.concatenate([vids, np.full(tcap - t, vids[0], vids.dtype)]).astype(np.int32)
        vd = to_device(vids_p, raw.device).long()
        nbr_mat, val_mat, valid = dense_neighbors_subset(csr, vd, D)
        out = vmap(apply_fn)(raw[vd], raw[nbr_mat.long()], val_mat, valid)
        return pytree.tree_map(lambda a: a[:t], out)

    def _csr(self, b: EdgeBlock):
        from ..ops.csr import build_csr

        key, nbr, val, mask = expand_direction(b, self.direction)
        return build_csr(key, nbr, val, mask, b.n_vertices)

    def apply_on_neighbors(
        self, apply_fn: Callable, max_degree: Optional[int] = None
    ) -> Iterator[Tuple[int, Any]]:
        """Apply a UDF to each vertex's whole windowed neighborhood
        (``SnapshotStream.java:129-181``).

        ``apply_fn(vertex_id, neighbor_ids[D], edge_values[D], valid[D]) ->
        record`` is lifted with :func:`torch.func.vmap` over vertices.
        Vertices run in DEGREE CLASSES (power-of-two buckets): each class
        builds rows only as wide as its own bucket, so one hub does not
        size the rows of every vertex (total work ~sum_v bucket(deg v) <=
        ~4E). ``max_degree`` caps the row width instead (wider
        neighborhoods are cut off). The UDF sees raw ids and a validity
        mask; emission is ascending by vertex."""
        from ..ops.csr import dense_neighbors

        for b in self._block_iter_fn():
            csr = self._csr(b)
            raw = self._raw32(b.src.device)
            if max_degree is not None:
                nbr_mat, val_mat, valid = dense_neighbors(csr, max_degree)
                vids = raw[: csr.num_vertices]
                out = vmap(apply_fn)(vids, raw[nbr_mat.long()], val_mat, valid)
                yield from self._emit(out, csr.degree > 0)
                continue
            pieces = [
                (vids, pytree.tree_map(host_array, self._class_rows(csr, raw, vids, D, apply_fn)))
                for D, vids in self._class_plan(b, csr, None)
            ]
            if not pieces:
                continue
            # merge the classes back into ascending-vertex order
            all_vids = np.concatenate([p[0] for p in pieces])
            merged = pytree.tree_map(lambda *leaves: np.concatenate(leaves),
                                     *[p[1] for p in pieces])
            order = np.argsort(all_vids, kind="stable")
            yield from self._emit_pairs(
                all_vids[order], pytree.tree_map(lambda a: a[order], merged)
            )

    def flat_apply_on_neighbors(
        self,
        apply_fn: Callable,
        max_out,
        max_degree: Optional[int] = None,
    ) -> Iterator[Any]:
        """Apply a 0..n-emission UDF to each vertex's windowed neighborhood,
        the reference's ``Collector``-based ``EdgesApply``
        (``EdgesApply.java:35-47``).

        ``apply_fn(vertex_id, neighbor_ids[D], edge_values[D], valid[D]) ->
        (records, emit[K])``: ``records`` any pytree of tensors with leading
        dim ``K = max_out(D)`` (or a constant ``max_out``), where ``D`` is
        the vertex's degree-class width, static under vmap. Records whose
        ``emit`` is False are dropped. Yields the records in windows'
        order, then ascending vertex, then ascending slot; degree classes
        and the ``max_degree`` cap behave as in :meth:`apply_on_neighbors`.
        """
        kfor = max_out if callable(max_out) else (lambda D: int(max_out))

        for b in self._block_iter_fn():
            csr = self._csr(b)
            raw = self._raw32(b.src.device)
            pieces = []  # (vids, records, emit) per class, on the host
            for D, vids in self._class_plan(b, csr, max_degree):
                records, emit = self._class_rows(csr, raw, vids, D, apply_fn)
                k_want = kfor(D)
                for leaf in pytree.tree_leaves(records):
                    got = leaf.shape[1] if leaf.dim() >= 2 else None
                    if got != k_want:
                        raise ValueError(
                            f"apply_fn emitted leading dim {got} for degree "
                            f"class {D}, but max_out({D}) = {k_want}; every "
                            "record leaf must be [K, ...] with K = max_out(D)"
                        )
                if emit.dim() != 2 or emit.shape[1] != k_want:
                    raise ValueError(
                        f"emit mask shape {tuple(emit.shape[1:])} != "
                        f"max_out({D}) = {k_want}"
                    )
                pieces.append((vids, pytree.tree_map(host_array, records), host_array(emit)))
            if not pieces:
                continue
            all_vids = np.concatenate([p[0] for p in pieces])
            offsets = np.cumsum([0] + [len(p[0]) for p in pieces])
            for o in np.argsort(all_vids, kind="stable"):
                pi = int(np.searchsorted(offsets, o, side="right") - 1)
                row = o - offsets[pi]
                _vids, rec_h, emit_h = pieces[pi]
                for k in np.nonzero(emit_h[row])[0]:
                    yield pytree.tree_map(lambda a: _item(a[row, k]), rec_h)
