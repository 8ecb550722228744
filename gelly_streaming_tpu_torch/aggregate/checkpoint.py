"""Checkpoint / resume for carried aggregation state (PyTorch port of
``gelly_streaming_tpu/aggregate/checkpoint.py``).

The reference's only fault-tolerance hook is ``Merger implements
ListCheckpointed<S>`` — the running global summary is snapshotted/restored
by Flink checkpointing (``SummaryAggregation.java:93,127-135``). This
module serializes that surface with numpy only: a pytree of arrays goes to
``.npz`` plus a JSON sidecar; the vertex dictionary saves its raw-id table
(compact ids are first-seen ordinal, so the table alone reconstructs it).

ONE ON-DISK FORMAT FOR BOTH PACKAGES. The JAX package numbers its arrays
``leaf_i`` in ``jax.tree.flatten`` order and writes each leaf's key path
as ``jax.tree_util.keystr`` spells it; its loader rejects a file whose key
paths differ from the template's. So this module flattens as JAX does
(:func:`flatten_with_keys`), not as the engine's ``tree_map`` walks: dict
keys sorted (``OrderedDict`` in insertion order), ``None`` an empty
subtree rather than a leaf, named tuples by field (``.name``). Leaves keep
their dtypes (the content checksum hashes raw bytes). The ``treedef``
string is informational: neither loader reads it when ``keypaths`` is
present.
"""

from __future__ import annotations

import collections
import glob
import json
import os
import pickle
import re
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from ..core.vertexdict import VertexDict
from ..obs import trace as _trace
from ..resilience import integrity as _integrity
from ..resilience.errors import CheckpointCorrupt


# --------------------------------------------------------------------- #
# The JAX package's pytree order and key-path spelling
# --------------------------------------------------------------------- #
def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(type(x), "_fields")


def _children(node) -> Optional[List[Tuple[str, Any]]]:
    """``(key string, child)`` pairs of a container node in JAX's order, or
    None for a leaf."""
    if isinstance(node, dict):
        keys = list(node) if isinstance(node, collections.OrderedDict) else sorted(node)
        return [(f"[{k!r}]", node[k]) for k in keys]
    if _is_namedtuple(node):
        return [(f".{f}", getattr(node, f)) for f in node._fields]
    if isinstance(node, (list, tuple)):
        return [(f"[{i}]", c) for i, c in enumerate(node)]
    return None


def flatten_with_keys(tree: Any) -> List[Tuple[str, Any]]:
    """``(keystr, leaf)`` for every leaf of ``tree``, in the order and with
    the spelling of ``jax.tree_util.tree_flatten_with_path`` +
    ``keystr``. ``None`` has no leaves."""
    out: List[Tuple[str, Any]] = []

    def walk(node, prefix):
        if node is None:
            return
        kids = _children(node)
        if kids is None:
            out.append((prefix, node))
            return
        for key, child in kids:
            walk(child, prefix + key)

    walk(tree, "")
    return out


def _treedef_str(tree: Any) -> str:
    """A ``PyTreeDef(...)``-style description of the structure (leaves as
    ``*``); informational only."""
    def rep(node):
        if node is None:
            return "None"
        if isinstance(node, dict):
            keys = list(node) if isinstance(node, collections.OrderedDict) else sorted(node)
            return "{" + ", ".join(f"{k!r}: {rep(node[k])}" for k in keys) + "}"
        if _is_namedtuple(node):
            return (type(node).__name__ + "("
                    + ", ".join(f"{f}={rep(getattr(node, f))}" for f in node._fields) + ")")
        if isinstance(node, list):
            return "[" + ", ".join(rep(c) for c in node) + "]"
        if isinstance(node, tuple):
            inner = ", ".join(rep(c) for c in node)
            return "(" + inner + ("," if len(node) == 1 else "") + ")"
        return "*"

    return f"PyTreeDef({rep(tree)})"


def unflatten_like(like: Any, leaves: List[Any]) -> Any:
    """``like``'s structure with its leaves replaced, in
    :func:`flatten_with_keys` order, by ``leaves``."""
    it = iter(leaves)

    def build(node):
        if node is None:
            return None
        if isinstance(node, dict):
            keys = list(node) if isinstance(node, collections.OrderedDict) else sorted(node)
            rebuilt = {k: build(node[k]) for k in keys}
            cls = collections.OrderedDict if isinstance(node, collections.OrderedDict) else dict
            return cls((k, rebuilt[k]) for k in node)
        if _is_namedtuple(node):
            return type(node)(*(build(getattr(node, f)) for f in node._fields))
        if isinstance(node, (list, tuple)):
            return type(node)(build(c) for c in node)
        return next(it)

    return build(like)


def _host(leaf) -> np.ndarray:
    """A leaf as a numpy array; a device tensor is downloaded (the
    snapshot's device wait)."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def host_tree(tree: Any) -> Any:
    """``tree`` with every leaf as a numpy array (device tensors
    downloaded); the structure, ``None`` included, unchanged."""
    return unflatten_like(tree, [_host(leaf) for _, leaf in flatten_with_keys(tree)])


def _shape(leaf) -> tuple:
    return tuple(leaf.shape) if isinstance(leaf, torch.Tensor) else np.shape(leaf)


def _dtype_kind(leaf) -> str:
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype.is_floating_point:
            return "f"
        return torch.empty(0, dtype=leaf.dtype).numpy().dtype.kind
    return np.asarray(leaf).dtype.kind


# --------------------------------------------------------------------- #
# Pytree checkpoints (.g<N>.npz + .json sidecar)
# --------------------------------------------------------------------- #
def _generation_files(path: str) -> list:
    """Every on-disk generation-named array file for ``path``."""
    return sorted(glob.glob(glob.escape(path) + ".g*.npz"))


def _next_generation(path: str) -> int:
    """One past the highest array-file generation on disk for ``path``
    (crash leftovers included, so a new save never overwrites a file any
    sidecar — committed or torn — might reference)."""
    best = -1
    for p in _generation_files(path):
        m = re.search(r"\.g(\d+)\.npz$", p)
        if m:
            best = max(best, int(m.group(1)))
    return best + 1


def _npz_path(path: str, info: dict) -> str:
    """The array file a sidecar references: generation-named for
    checkpoints with integrity, the legacy fixed ``path.npz`` before."""
    name = info.get("npz")
    if name is None:
        return path + ".npz"
    return os.path.join(os.path.dirname(path) or ".", name)


def save_pytree(path: str, tree: Any, meta: Optional[dict] = None) -> None:
    """Write a pytree of arrays (numpy or tensors on any device) to
    ``path.g<N>.npz`` + ``path.json``.

    ATOMIC COMMIT: the arrays land under a GENERATION-UNIQUE name (never
    overwriting the file the committed sidecar references), then the JSON
    sidecar — naming that file and carrying a CRC32 over the leaf content —
    commits via temp + ``os.replace``. A kill at any byte leaves the
    previous pair intact (at worst plus one orphaned new-generation array
    file, swept by the next successful save); :func:`load_pytree`
    validates the named file against the sidecar's leaf count and
    checksum.
    """
    flat = flatten_with_keys(tree)
    # barrier_wait: the download of device leaves waits on the work that
    # produces them — the snapshot's device barrier
    with _trace.span(
        "checkpoint.barrier_wait",
        {"leaves": len(flat)} if _trace.on() else None,
    ):
        arrays = {f"leaf_{i}": _host(leaf) for i, (_, leaf) in enumerate(flat)}
    with _trace.span(
        "checkpoint.serialize",
        {"leaves": len(flat)} if _trace.on() else None,
    ):
        gen = _next_generation(path)
        npz = f"{path}.g{gen}.npz"
        npz_tmp = npz + ".tmp"
        # savez appends .npz to names without it; write with the real
        # suffix inside the temp name, then rename
        with open(npz_tmp, "wb") as f:
            np.savez(f, **arrays)
        os.replace(npz_tmp, npz)
        # content checksum over the in-memory leaves (leaf order), not a
        # re-read of the file just written
        crc = _integrity.arrays_crc32(arrays[f"leaf_{i}"] for i in range(len(flat)))
        doc = {"treedef": _treedef_str(tree), "keypaths": [k for k, _ in flat],
               "n_leaves": len(flat), "meta": meta or {},
               "npz": os.path.basename(npz), "leaves_crc32": crc}
        json_tmp = path + ".json.tmp"
        with open(json_tmp, "w") as f:
            json.dump(doc, f)
        _integrity.replace_atomic(json_tmp, path + ".json")  # commit
        # sweep superseded generations (and the legacy fixed name) only
        # AFTER the new sidecar committed; leftovers are orphans, never
        # referenced
        for stale in _generation_files(path) + [path + ".npz"]:
            if stale != npz and os.path.exists(stale):
                try:
                    os.remove(stale)
                except OSError:
                    pass


def load_pytree(path: str, like: Any) -> Tuple[Any, dict]:
    """Read arrays back into the structure of ``like`` (numpy leaves).

    Returns ``(tree, meta)``. Rejects a checkpoint whose stored key paths,
    leaf count, leaf shapes or leaf dtype kinds disagree with ``like``.
    Before any structural comparison the ``.npz`` is checked against its
    sidecar — leaf count, then the content checksum when the sidecar
    carries one — and a failure raises :class:`CheckpointCorrupt`, recorded
    as ``resilience.ckpt_rejected``.
    """
    with open(path + ".json") as f:
        info = json.load(f)
    npz = _npz_path(path, info)
    try:
        data = np.load(npz)
        stored = {k for k in data.files if k.startswith("leaf_")}
    except Exception as e:
        _integrity.record_rejection(npz, f"unreadable: {e!r}")
        raise CheckpointCorrupt(
            f"checkpoint array file {npz} is unreadable ({e!r}); the "
            "sidecar committed but the array file is torn, corrupt, or "
            "missing"
        ) from e
    if len(stored) != info["n_leaves"]:
        _integrity.record_rejection(
            npz, f"{len(stored)} leaf arrays vs sidecar n_leaves={info['n_leaves']}",
        )
        raise CheckpointCorrupt(
            f"checkpoint array file {npz} holds {len(stored)} leaf arrays "
            f"but its sidecar committed n_leaves={info['n_leaves']}; the "
            "pair is torn (mismatched save generations)"
        )
    try:
        leaves = [data[f"leaf_{i}"] for i in range(info["n_leaves"])]
    except Exception as e:
        _integrity.record_rejection(npz, f"torn archive: {e!r}")
        raise CheckpointCorrupt(
            f"checkpoint array file {npz} failed to decompress its leaf "
            f"arrays ({e!r}); the file is torn or corrupt"
        ) from e
    want_crc = info.get("leaves_crc32")
    if want_crc is not None:
        got_crc = _integrity.arrays_crc32(leaves)
        if got_crc != want_crc:
            _integrity.record_rejection(
                npz, f"content crc32 {got_crc:#x} != sidecar {want_crc:#x}",
            )
            raise CheckpointCorrupt(
                f"checkpoint array file {npz} leaf content checksum "
                f"{got_crc:#x} does not match its sidecar's {want_crc:#x} "
                "(torn pair or bit rot)"
            )
    like_flat = flatten_with_keys(like)
    if len(like_flat) != len(leaves):
        raise ValueError(
            f"checkpoint has {len(leaves)} leaves but template has {len(like_flat)}"
        )
    if info.get("keypaths") is not None:
        want_paths = [k for k, _ in like_flat]
        if info["keypaths"] != want_paths:
            raise ValueError(
                f"checkpoint structure {info['keypaths']} does not match "
                f"template structure {want_paths}"
            )
    for i, (stored_leaf, (_, want)) in enumerate(zip(leaves, like_flat)):
        if _shape(want) != stored_leaf.shape:
            raise ValueError(
                f"checkpoint leaf {i} has shape {stored_leaf.shape} but "
                f"template expects {_shape(want)}"
            )
        want_kind = _dtype_kind(want)
        if stored_leaf.dtype.kind != want_kind:
            raise ValueError(
                f"checkpoint leaf {i} has dtype {stored_leaf.dtype} but "
                f"template expects kind {want_kind!r}"
            )
    return unflatten_like(like, leaves), info.get("meta", {})


def load_meta(path: str) -> dict:
    """Read just the sidecar metadata (e.g. ``vcap``) without the arrays."""
    with open(path + ".json") as f:
        return json.load(f).get("meta", {})


# --------------------------------------------------------------------- #
# Vertex dictionary, aggregations, workloads
# --------------------------------------------------------------------- #
def save_vertex_dict(path: str, vdict) -> None:
    """The raw-id table in first-seen order (any dict with ``raw_ids()``:
    the host ``VertexDict``, ``DeviceVertexDict``)."""
    np.save(path + ".vdict.npy", vdict.raw_ids())


def load_vertex_dict(path: str) -> VertexDict:
    raw = np.load(path + ".vdict.npy")
    d = VertexDict()
    d.encode(raw)
    return d


def _commit_pickle_bytes(path: str, payload: bytes) -> None:
    """Atomically commit pickled state: the CRC-framed container written to
    a tmp sibling, then ``os.replace``d into place."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(_integrity.wrap_checksummed(payload))
    _integrity.replace_atomic(tmp, path)


def _load_pickle_bytes(path: str) -> bytes:
    """Read back a :func:`_commit_pickle_bytes` artifact. Un-framed pickles
    pass through unchanged; a torn/corrupt frame raises
    :class:`CheckpointCorrupt` and is recorded."""
    with open(path, "rb") as f:
        data = f.read()
    try:
        return _integrity.unwrap_checksummed(data, origin=path)
    except CheckpointCorrupt as e:
        _integrity.record_rejection(path, str(e))
        raise


def save_aggregation(path: str, aggregation, vdict=None) -> None:
    """Checkpoint an aggregation's running summary (+ optional dict).

    Device-state aggregations serialize as array pytrees; host-state
    aggregations (``host_state = True``, the spanner's adjacency map)
    pickle their summary object instead.
    """
    if not aggregation.host_state:
        save_pytree(path, aggregation.snapshot_state(), meta={"vcap": int(aggregation._vcap)})
    else:
        _commit_pickle_bytes(path + ".pkl", pickle.dumps(aggregation._summary))
    if vdict is not None:
        save_vertex_dict(path, vdict)


def restore_aggregation(path: str, aggregation, template: Any = None) -> Optional[VertexDict]:
    """Restore a checkpointed summary into ``aggregation``.

    For device-state aggregations the template defaults to
    ``aggregation.initial_state(vcap)`` with ``vcap`` read from the sidecar
    metadata. The state lands where ``restore_state`` puts it: on the
    aggregation's device once a run has set it, else on the CPU until the
    next run moves it to its stream's device. Returns the restored
    VertexDict if one was saved alongside, else None.
    """
    if not aggregation.host_state:
        if template is None:
            vcap = load_meta(path).get("vcap")
            if vcap is None:
                raise ValueError(f"checkpoint {path} has no vcap metadata; pass template=")
            template = aggregation.initial_state(vcap)
        state, meta = load_pytree(path, template)
        aggregation.restore_state(state, vcap=meta.get("vcap"))
    else:
        aggregation._summary = pickle.loads(_load_pickle_bytes(path + ".pkl"))
    vd_path = path + ".vdict.npy"
    return load_vertex_dict(path) if os.path.exists(vd_path) else None


def save_workload(path: str, workload, vdict=None) -> None:
    """Checkpoint any carried-state workload exposing ``state_dict()``
    (triangles, PageRank, degree distribution, spanner, samplers, SAGE,
    matching). The state is a plain dict of numpy arrays and scalars,
    pickled inside the checksummed container."""
    _commit_pickle_bytes(path + ".workload.pkl", pickle.dumps(workload.state_dict()))
    if vdict is not None:
        save_vertex_dict(path, vdict)


def restore_workload(path: str, workload) -> Optional[VertexDict]:
    """Restore a :func:`save_workload` checkpoint into ``workload``.
    Returns the restored VertexDict when one was saved alongside."""
    workload.load_state_dict(pickle.loads(_load_pickle_bytes(path + ".workload.pkl")))
    vd_path = path + ".vdict.npy"
    return load_vertex_dict(path) if os.path.exists(vd_path) else None


def restore_server(
    path: str,
    workload,
    source,
    *,
    template: Any = None,
    start: bool = True,
    **server_kwargs,
):
    """Boot a live query server from a checkpoint: restore ``workload``'s
    carried state (aggregation or ``state_dict`` workload checkpoints are
    both recognized by their sidecar files, written by either package),
    publish the restored summary as the server's BOOT snapshot (window
    ``-1``), then serve while the ``source`` stream catches up — queries
    answer from the restored state immediately, before the first live
    window folds.

    ``source`` must be built against the same compact-id space as the
    checkpoint (pass the restored VertexDict into the stream, the
    existing resume contract); the boot payload resolves raw ids through
    the restored dict when one was saved alongside, else the source's.
    Returns the (started, unless ``start=False``) ``StreamServer``.
    """
    from ..serving import StreamServer

    if os.path.exists(path + ".workload.pkl"):
        vdict = restore_workload(path, workload)
    else:
        vdict = restore_aggregation(path, workload, template)
    if vdict is None:
        vdict = getattr(source, "vertex_dict", None)
    servable = workload.servable(vdict=vdict)
    server = StreamServer(servable, source, **server_kwargs)
    boot = servable.boot_payload()
    if boot is not None:
        payload, watermark = boot
        server.publish_boot(payload, watermark)
    return server.start() if start else server
