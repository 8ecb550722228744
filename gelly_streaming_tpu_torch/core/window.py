"""Host-side window discretization: unbounded edge stream -> EdgeBlocks.

The counterpart of ``gelly_streaming_tpu/core/window.py``. A ``Windower``
consumes host edge records or numpy columns, runs them through the
:class:`~gelly_streaming_tpu_torch.core.vertexdict.VertexDict` (the keyBy
analog), and emits padded, capacity-bucketed
:class:`~gelly_streaming_tpu_torch.core.edgeblock.EdgeBlock` batches on the
stream's device — one per tumbling window.

``CountWindow(n)`` — every ``n`` edges is a window — is the policy of this
slice, on the record path and on the numpy column path. Time windows
(``ProcessingTimeWindow``, ``EventTimeWindow``) are declared so that
callers can name them, and the Windower raises ``NotImplementedError`` for
them; so do superbatches and chunked ingest.

Blocks carry *compact* int32 ids; raw ids stay host-side in the dict.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterable, Iterator, Optional, Sequence, Tuple

import numpy as np

from ..obs import trace as _trace
from .edgeblock import VAL_DTYPE, EdgeBlock
from .vertexdict import VertexDict

_TIME_WINDOWS = "ROADMAP Queue 1, slice 4 (the window and neighborhood layer)"
_CC_SLICE = "ROADMAP Queue 1, slice 2 (streaming Connected Components)"


def is_column_input(edges) -> bool:
    """True when ``edges`` is vectorized column input: an ``[N, k]``
    ndarray or a ``(src, dst[, val][, ts])`` tuple/list of 1-D arrays.
    THE shared fast-path predicate of the windower and the stream."""
    if isinstance(edges, np.ndarray):
        return True
    return (
        isinstance(edges, (tuple, list))
        and len(edges) >= 2
        and all(isinstance(c, np.ndarray) and c.ndim == 1 for c in edges)
    )


@dataclasses.dataclass
class WindowPolicy:
    """Base class for window assignment policies."""


@dataclasses.dataclass(frozen=True)
class WindowInfo:
    """Host-side metadata for one emitted window (the ``TimeWindow`` analog).

    ``start``/``end`` are event-time bounds (end exclusive) for event-time
    windows, None for count windows; ``index`` counts emitted windows from 0.
    """

    index: int
    start: Optional[float]
    end: Optional[float]


@dataclasses.dataclass
class CountWindow(WindowPolicy):
    """Tumbling window of a fixed number of edges."""

    size: int


@dataclasses.dataclass
class ProcessingTimeWindow(WindowPolicy):
    """Tumbling wall-clock window (not yet ported: the Windower raises)."""

    seconds: float
    max_count: int = 1 << 20


@dataclasses.dataclass
class EventTimeWindow(WindowPolicy):
    """Tumbling event-time window (not yet ported: the Windower raises)."""

    size: float
    timestamp_fn: Callable[[Tuple], float] = None  # type: ignore[assignment]


class Windower:
    """Discretize host edge records into EdgeBlocks on ``device``.

    Edge records are ``(src, dst)`` or ``(src, dst, val)`` tuples (raw ids).
    The windower owns the stream's VertexDict so compact ids are stable
    across windows — carried device state indexed by compact id stays valid
    as new vertices appear (vertex capacity only grows, in power-of-two
    buckets).
    """

    def __init__(
        self,
        policy: WindowPolicy,
        vertex_dict: Optional[VertexDict] = None,
        *,
        device,
    ):
        self.policy = policy
        self.vertex_dict = vertex_dict if vertex_dict is not None else VertexDict()
        self.device = device

    def _rows_to_cols(self, rows: Sequence[Tuple]) -> Tuple:
        """One window's record tuples -> raw ``(src, dst, val|None)``
        columns (val presence decided by the window's first record)."""
        n = len(rows)
        raw_src = np.fromiter((r[0] for r in rows), dtype=np.int64, count=n)
        raw_dst = np.fromiter((r[1] for r in rows), dtype=np.int64, count=n)
        if n and len(rows[0]) > 2 and rows[0][2] is not None:
            val = np.asarray([r[2] for r in rows], dtype=VAL_DTYPE)
        else:
            val = None
        return raw_src, raw_dst, val

    def _make_block(self, rows: Sequence[Tuple]) -> EdgeBlock:
        return self._block_from_arrays(*self._rows_to_cols(rows))

    def _block_from_arrays(
        self, raw_src: np.ndarray, raw_dst: np.ndarray, val: Optional[np.ndarray]
    ) -> EdgeBlock:
        """Encode one window's raw columns and upload the padded block to
        the stream's device."""
        n = raw_src.shape[0]
        # the span covers the whole host pack: encode + pad + upload
        with _trace.span(
            "window.pack",
            {"edges": int(n)} if _trace.on() else None,
        ):
            # Paired encode keeps first-seen order by edge arrival (src
            # before dst per edge), matching the reference's per-record
            # processing.
            src, dst = self.vertex_dict.encode_pair(raw_src, raw_dst)
            block = EdgeBlock.from_arrays(
                src, dst, val, n_vertices=self.vertex_dict.capacity,
                device=self.device,
            )
            host_val = (
                np.zeros(n, dtype=VAL_DTYPE)
                if val is None
                else np.asarray(val, VAL_DTYPE)
            )
            return block.with_host_cache(src, dst, host_val)

    def blocks(self, edges: Iterable[Tuple]) -> Iterator[EdgeBlock]:
        """Yield one EdgeBlock per tumbling window."""
        for _, block in self.blocks_with_info(edges):
            yield block

    def blocks_with_info(
        self, edges: Iterable[Tuple]
    ) -> Iterator[Tuple[WindowInfo, EdgeBlock]]:
        """Like :meth:`blocks` but paired with host-side window metadata."""
        policy = self.policy
        if not isinstance(policy, CountWindow):
            if isinstance(policy, (ProcessingTimeWindow, EventTimeWindow)):
                raise NotImplementedError(
                    f"{type(policy).__name__} is ported in {_TIME_WINDOWS}"
                )
            raise TypeError(f"unknown window policy {policy!r}")
        if is_column_input(edges):
            yield from self._array_windows(edges)
            return
        if callable(getattr(edges, "iter_chunks", None)):
            raise NotImplementedError(
                f"chunk-capable sources are ported in {_CC_SLICE}"
            )
        index = 0
        buf: list[Tuple] = []
        for e in edges:
            if e is None:  # live-source time tick; count windows ignore
                continue
            buf.append(e)
            if len(buf) >= policy.size:
                yield WindowInfo(index, None, None), self._make_block(buf)
                index += 1
                buf = []
        if buf:
            yield WindowInfo(index, None, None), self._make_block(buf)

    def _array_windows(self, edges) -> Iterator[Tuple[WindowInfo, EdgeBlock]]:
        """Array fast path: ``edges`` is an [N,2|3] ndarray or a
        (src, dst[, val]) tuple/list of 1-D arrays. Window boundaries are
        computed with numpy (no per-record Python)."""
        if isinstance(edges, np.ndarray):
            if edges.ndim != 2 or not 2 <= edges.shape[1] <= 3:
                raise ValueError("edge array must be [N, 2] or [N, 3]")
            cols = [edges[:, i] for i in range(edges.shape[1])]
        else:
            cols = [np.asarray(c) for c in edges]
        src = cols[0].astype(np.int64)
        dst = cols[1].astype(np.int64)
        val = cols[2].astype(VAL_DTYPE) if len(cols) > 2 else None
        size = self.policy.size
        for index, start in enumerate(range(0, src.shape[0], size)):
            end = start + size
            yield WindowInfo(index, None, None), self._block_from_arrays(
                src[start:end], dst[start:end],
                None if val is None else val[start:end],
            )

    def superbatches(self, edges, k: int):
        raise NotImplementedError(f"superbatches are ported in {_CC_SLICE}")

    def blocks_from_chunks(self, chunks, encoded: bool = False):
        raise NotImplementedError(f"chunked ingest is ported in {_CC_SLICE}")
