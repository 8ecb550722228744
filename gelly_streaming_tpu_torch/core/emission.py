"""EmissionStream: the shared output-side wrapper of the workloads (PyTorch port).

The counterpart of ``gelly_streaming_tpu/core/emission.py``. The reference's
outputs are per-record, continuously improving streams
(``README.md:26-32``, ``SimpleEdgeStream.java:562-576``); here the emission
unit is the *window batch*: one device step produces a whole window's
records at once.

- iterating an :class:`EmissionStream` yields per-record emissions;
- :meth:`EmissionStream.batches` yields the per-window groups (whatever
  batch the producer built) and feeds each window's wall time to an
  optional profiler (any object with ``record(WindowStats)``).

The lazy batch types hold device tensors and read them to the host only on
first read, so a producer loop makes no device-to-host read per window.
Producers never update in place a tensor an emitted batch still holds.
"""

from __future__ import annotations

import time
from typing import Callable, Iterable, Iterator, NamedTuple, Optional, TypeVar

import numpy as np
import torch

T = TypeVar("T")


def host_array(x) -> np.ndarray:
    """A tensor (on any device) or array-like as a numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _as_list(c):
    return c.tolist() if hasattr(c, "tolist") else c


class ColumnBatch:
    """One window's emissions backed by column arrays. Iterating yields
    per-record tuples; bulk consumers read ``.columns``."""

    __slots__ = ("columns",)

    def __init__(self, *columns):
        self.columns = columns

    def __len__(self) -> int:
        return len(self.columns[0])

    def __iter__(self):
        return zip(*(_as_list(c) for c in self.columns))


class RecordColumnBatch:
    """Column-backed batch whose per-record view builds typed records
    (``Edge``/``Vertex``) on demand; bulk consumers read ``.columns``."""

    __slots__ = ("ctor", "columns")

    def __init__(self, ctor, *columns):
        self.ctor = ctor
        self.columns = columns

    def __len__(self) -> int:
        return len(self.columns[0])

    def __iter__(self):
        cols = [_as_list(c) for c in self.columns]
        return (self.ctor(*t) for t in zip(*cols))


class DeviceColumnBatch:
    """A :class:`ColumnBatch` whose columns stay ON THE DEVICE until first
    read: ``thunk()`` downloads and decodes them once. The producer's loop
    stays free of device-to-host reads; only consumers that read records
    pay the transfer."""

    __slots__ = ("_thunk", "_cols")

    def __init__(self, thunk: Callable[[], tuple]):
        self._thunk = thunk
        self._cols = None

    @property
    def columns(self) -> tuple:
        if self._cols is None:
            self._cols = tuple(self._thunk())
        return self._cols

    def __len__(self) -> int:
        return len(self.columns[0])

    def __iter__(self):
        return zip(*(_as_list(c) for c in self.columns))


class LazyListBatch:
    """Base of the lazy list-like window emissions: subclasses set
    ``self._items = None`` in ``__init__`` and implement ``_compute() ->
    list``; iteration, length, indexing, comparison and repr materialize
    once."""

    def _materialize(self) -> list:
        if self._items is None:
            self._items = self._compute()
        return self._items

    def __iter__(self):
        return iter(self._materialize())

    def __len__(self) -> int:
        return len(self._materialize())

    def __getitem__(self, i):
        return self._materialize()[i]

    def __eq__(self, other):
        return self._materialize() == other

    def __repr__(self) -> str:
        return repr(self._materialize())


class LazyRecordBatch:
    """A :class:`RecordColumnBatch` whose columns come from a thunk run on
    first read (the typed-record analog of :class:`DeviceColumnBatch`)."""

    __slots__ = ("ctor", "_thunk", "_cols")

    def __init__(self, ctor, thunk: Callable[[], tuple]):
        self.ctor = ctor
        self._thunk = thunk
        self._cols = None

    @property
    def columns(self) -> tuple:
        if self._cols is None:
            self._cols = tuple(self._thunk())
        return self._cols

    def __len__(self) -> int:
        return len(self.columns[0])

    def __iter__(self):
        cols = [_as_list(c) for c in self.columns]
        return (self.ctor(*t) for t in zip(*cols))


class LazyCountRange:
    """``range(start+1, start+n+1)`` where ``start``/``n`` may be device
    scalars, materialized on first read: ``number_of_edges`` chains its
    running total on the device, and only consumers that read a window's
    counts pay its read."""

    __slots__ = ("_start", "_n", "_range")

    def __init__(self, start, n):
        self._start = start
        self._n = n
        self._range = None

    def _materialize(self) -> range:
        if self._range is None:
            s, n = int(self._start), int(self._n)
            self._range = range(s + 1, s + n + 1)
        return self._range

    def __len__(self) -> int:
        return len(self._materialize())

    def __iter__(self):
        return iter(self._materialize())

    def __eq__(self, other):
        r = self._materialize()
        if isinstance(other, range):
            return r == other
        if isinstance(other, LazyCountRange):
            return r == other._materialize()
        try:
            return list(r) == list(other)
        except TypeError:
            return NotImplemented  # like a builtin range: False, not raise

    def __hash__(self):
        return hash(self._materialize())

    def __repr__(self) -> str:
        return repr(self._materialize())


def iter_unstacked(stacked: dict, n: int):
    """Unstack a superbatch's ``[K, ...]`` per-window states (a dict of
    tensors) into K per-window dicts. Each is a view of row ``i`` of the
    stacked tensors: no copy and no host read, and the stacked buffers
    stay alive as long as some window's emission holds a row."""
    for i in range(n):
        yield {key: value[i] for key, value in stacked.items()}


class WindowStats(NamedTuple):
    """One window's measurement, as :meth:`EmissionStream.batches` records
    it."""

    index: int
    wall_seconds: float
    edges: Optional[int]


class EmissionStream:
    """Re-iterable stream of emissions with a per-window batch view."""

    def __init__(self, batch_fn: Callable[[], Iterator[Iterable[T]]], profiler=None):
        self._batch_fn = batch_fn
        self.profiler = profiler

    def batches(self) -> Iterator[Iterable[T]]:
        """Per-window emission groups. With a profiler attached, each
        window's wall time (the producer's work, not the consumer's) is
        recorded as a :class:`WindowStats`."""
        it = self._batch_fn()
        index = 0
        while True:
            t0 = time.perf_counter()
            try:
                batch = next(it)
            except StopIteration:
                return
            if self.profiler is not None:
                edges = len(batch) if hasattr(batch, "__len__") else None
                self.profiler.record(
                    WindowStats(index, time.perf_counter() - t0, edges)
                )
            index += 1
            yield batch

    def __iter__(self) -> Iterator[T]:
        for batch in self.batches():
            yield from batch

    def with_profiler(self, profiler) -> "EmissionStream":
        return EmissionStream(self._batch_fn, profiler)
