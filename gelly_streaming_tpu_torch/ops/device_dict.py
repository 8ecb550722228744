"""Device-resident vertex dictionary: the keyBy ON the card (PyTorch port
of ``gelly_streaming_tpu/ops/device_dict.py``).

Reference analog: the raw-id keyed state behind every ``keyBy(vertex)``
(``SimpleEdgeStream.java:119,303,537``; ``summaries/DisjointSet.java:30``
keys HashMaps by raw ``Long`` directly). The device form needs dense
compact ids; this module produces them without host hashing: the raw-id
-> compact-id mapping is device state, and a whole window encodes in one
fixed-shape step, so the host's only ingest work is handing raw columns
to the device.

Design, sort-based as in the reference:

- State: ``keys[Kcap]`` sorted ascending (``INT32_MAX`` padding) with
  aligned ``idx[Kcap]``, the reverse table ``rev[Kcap]``, the assigned
  ``count`` and the sticky overflow ``probe`` (0-d tensors).
- Per batch: ``torch.searchsorted`` of every id against the sorted table
  (known ids resolve at once); one stable ``torch.sort`` of the unknown
  ids, so each novel key is one run whose head is its FIRST arrival (the
  reference's two-key ``lax.sort((nr, arange))`` is a stable sort of
  ``nr`` alone: ``arange`` is already ascending); run heads ranked by
  arrival to assign ``count + rank``, bit-identical to the host
  ``VertexDict``'s first-seen order; each run's id spread to its members;
  the novel keys merged into the table by concat and a stable sort.
- Growth is appending ``INT32_MAX`` padding to the sorted table: the host
  re-pads to the next capacity bucket, with no rehash.

What differs from the XLA reference, and why:

- The rank of the run heads is an inverse-permutation scatter plus a
  cumulative sum (heads flagged in arrival order, counted), where the
  reference ranks by an argsort of an argsort because its runtime
  degraded on large scatters. Both give each head the number of heads
  that arrived before it. The map back from sorted to arrival order is the
  same kind of scatter through the sort's permutation.
- A run's id reaches its members through the run's number (a cumulative
  sum of the heads), where the reference spreads the head's position with
  ``lax.cummax``: torch's ``cummax`` of one long row took 5.1 of the
  encode's 6.0 ms a window on the card (``PERF.md``, §3).
- ``rev.at[...].set(sk, mode="drop")`` writes into a buffer of ``Kcap + 1``
  slots whose last slot is a sentinel (the translation rule of
  ``summaries/forest.py``); an id past the capacity (an overflow) lands
  there.
- Nothing reads the device in an encode: ``count`` and ``probe`` stay
  device scalars. On overflow the merge truncates (``mk[:kcap]``) and
  ``probe`` turns negative for good; the check runs at the next natural
  sync (:meth:`DeviceVertexDict._sync`).

Raw ids must be non-negative int32 below ``INT32_MAX`` (the raw-table
contract; ``VertexDict`` stays the general path for 64-bit id spaces).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..core.device import DEFAULT_DEVICE, resolve_device
from ..core.edgeblock import bucket_capacity, to_device
from ..obs import trace as _trace

_BIG = int(np.iinfo(np.int32).max)

#: encode steps launched (one per :func:`encode_batch` call, the pair form
#: included); callers zero it and read it
ENCODES = 0


def init_table(cap: int, device) -> dict:
    """Fresh device dictionary state (``cap`` keys capacity) on ``device``.

    ``probe`` is the sticky overflow telltale: ``count`` while every batch
    so far fit the table, ``-(count)-1`` forever after the first one that
    did not (its state and outputs are then poisoned). It lives inside the
    state so that the encode step has no extra output to read."""
    return {
        "keys": torch.full((cap,), _BIG, dtype=torch.int32, device=device),
        "idx": torch.zeros(cap, dtype=torch.int32, device=device),
        "rev": torch.full((cap,), -1, dtype=torch.int32, device=device),
        "count": torch.zeros((), dtype=torch.int32, device=device),
        "probe": torch.zeros((), dtype=torch.int32, device=device),
    }


def encode_pair_batch(state: dict, src: torch.Tensor, dst: torch.Tensor):
    """Edge-column encode: interleave (src before dst per edge), encode,
    split. Returns ``(state, src_idx, dst_idx)``."""
    n = src.shape[0]
    raw = torch.stack([src, dst], dim=1).reshape(-1)
    state, out = encode_batch(state, raw)
    pair = out.reshape(n, 2)
    return state, pair[:, 0].contiguous(), pair[:, 1].contiguous()


def encode_batch(state: dict, raw: torch.Tensor):
    """Map a batch of raw int32 ids (arrival order) to compact ids,
    inserting novel ids first-seen-first. Returns ``(new_state, out_idx)``;
    ``state`` is not written.

    The caller guarantees capacity: ``count`` plus the batch's distinct new
    ids must fit ``keys.shape[0]``, or ``probe`` records the overflow."""
    global ENCODES
    ENCODES += 1
    with _trace.span("dict.encode"):
        keys, idxv, rev, count = (
            state["keys"], state["idx"], state["rev"], state["count"],
        )
        kcap = keys.shape[0]
        n = raw.shape[0]
        device = raw.device

        # 1. resolve known ids by binary search
        pos = torch.searchsorted(keys, raw).clamp_(0, kcap - 1)
        found = keys[pos] == raw
        out = torch.where(found, idxv[pos], -1)

        # 2. group unknown ids into runs ordered by (key, arrival)
        nr = torch.where(found, _BIG, raw)
        sk, sa = torch.sort(nr, stable=True)
        real = sk != _BIG
        first = real.clone()
        first[1:] &= sk[1:] != sk[:-1]

        # 3. run heads get ids by global first-arrival order: flag the heads
        # in arrival order (sa is a permutation, so every slot is written
        # once) and count the heads that arrived before each
        head_in_arrival = torch.empty(n, dtype=torch.int32, device=device)
        head_in_arrival.scatter_(0, sa, first.to(torch.int32))
        rank_arrival = torch.cumsum(head_in_arrival, 0, dtype=torch.int32) - 1
        head_id = count + rank_arrival[sa]  # valid where `first`

        # 4. spread each run's id to its members: number the runs by a
        # cumulative sum of the heads, write each head's id at its run's
        # number (pads past the last run into a sentinel slot), and gather
        # by run number; then map back to arrival slots through sa
        run = torch.cumsum(first, 0, dtype=torch.int32) - 1
        run_id = torch.empty(n + 1, dtype=torch.int32, device=device)
        run_id.scatter_(0, torch.where(first, run, n).long(), head_id)
        ids_sorted = run_id[run.clamp(min=0).long()]
        arrival_vals = torch.empty(n, dtype=torch.int32, device=device)
        arrival_vals.scatter_(0, sa, torch.where(real, ids_sorted, -1))
        out = torch.maximum(out, arrival_vals)
        n_new = first.sum(dtype=torch.int32)

        # 5. merge the novel (key, id) pairs into the sorted table; pads of
        # both halves carry id 0, so the stable sort gives the reference's
        # table exactly
        nk = torch.where(first, sk, _BIG)
        nv = torch.where(first, ids_sorted, 0)
        mk, order = torch.sort(torch.cat([keys, nk]), stable=True)
        mv = torch.cat([idxv, nv])[order]
        new_count = count + n_new
        still_ok = (state["probe"] >= 0) & (new_count <= kcap)
        rev_buf = torch.cat([rev, rev.new_full((1,), -1)])
        rev_buf.scatter_(
            0, torch.where(first & (head_id < kcap), head_id, kcap).long(), sk
        )
        new_state = {
            "keys": mk[:kcap],
            "idx": mv[:kcap],
            "rev": rev_buf[:kcap],
            "count": new_count,
            "probe": torch.where(still_ok, new_count, -new_count - 1),
        }
        return new_state, out


class DeviceVertexDict:
    """VertexDict-compatible facade over the device sorted table.

    ``encode_pair`` runs ON the device and returns device index columns
    (unlike the host dict's numpy): the device-encode ingest feeds them
    straight into EdgeBlocks with no host hash work. ``decode`` and
    ``__len__`` read the device (emission time only).

    ``id_bound``: when the raw id space is known to be below the bound,
    the table allocates for it once and never grows or reads the device;
    otherwise growth decisions need a host-known bound on the count
    (:meth:`ensure_capacity_host` from host novelty tracking, or
    :meth:`_ensure`'s read near a capacity boundary)."""

    def __init__(self, min_capacity: int = 1 << 10, id_bound: int = 0,
                 device=DEFAULT_DEVICE):
        self.device = resolve_device(device)
        self.id_bound = int(id_bound)
        cap = bucket_capacity(max(min_capacity, self.id_bound, 16))
        self._state = init_table(cap, self.device)
        self._synced_count = 0  # host-known lower bound
        self._pending = 0  # ids encoded since the last count read
        self._rev_cache = None

    # ------------------------------------------------------------------ #
    @property
    def capacity(self) -> int:
        return int(self._state["keys"].shape[0])

    def __len__(self) -> int:
        self._sync()
        return self._synced_count

    def _sync(self) -> None:
        """Read ``probe`` (one device read) and check for an overflow."""
        probe = int(self._state["probe"])
        if probe < 0:
            raise RuntimeError(
                "device dictionary overflowed its table: the host-side "
                "novelty bound failed to grow it in time; compact ids since "
                "the overflow are unreliable"
            )
        self._synced_count = probe
        self._pending = 0

    def _ensure(self, incoming: int) -> None:
        """Grow (by re-padding) so the worst case ``count + incoming``
        fits; reads the device only near a capacity boundary."""
        if self.id_bound:  # the capacity covers the whole id space
            return
        cap = self.capacity
        if self._synced_count + self._pending + incoming <= cap:
            return
        self._sync()
        need = self._synced_count + incoming
        if need > cap:
            self._repad(bucket_capacity(need))

    def _repad(self, new_cap: int) -> None:
        """Growth is appending ``INT32_MAX`` padding to the sorted table."""
        grow = new_cap - self.capacity
        if grow <= 0:
            return
        st = self._state
        self._state = {
            "keys": torch.cat([st["keys"], st["keys"].new_full((grow,), _BIG)]),
            "idx": torch.cat([st["idx"], st["idx"].new_zeros(grow)]),
            "rev": torch.cat([st["rev"], st["rev"].new_full((grow,), -1)]),
            "count": st["count"],
            "probe": st["probe"],
        }

    def _validate(self, *arrays) -> None:
        """With ``id_bound`` set, out-of-range raw ids would silently
        corrupt the fixed-capacity table (the merge truncates): reject them
        as ``IdentityDict.encode`` does. Host arrays only; device columns
        come from the ingest paths, whose parser checks the bound."""
        if not self.id_bound:
            return
        for a in arrays:
            if isinstance(a, np.ndarray) and a.size and (
                int(a.min()) < 0 or int(a.max()) >= self.id_bound
            ):
                raise ValueError(
                    f"raw id outside [0, {self.id_bound}) — not a dense-id "
                    "corpus; drop id_bound (growth mode) or use VertexDict"
                )

    def _column(self, a) -> torch.Tensor:
        if isinstance(a, torch.Tensor):
            return a.to(self.device, torch.int32)
        return to_device(np.ascontiguousarray(a, np.int32), self.device)

    # ------------------------------------------------------------------ #
    # Growth mode driven by host-side novelty tracking: the ingest keeps an
    # exact host bound on the table count (``native.NoveltyBitmap`` over
    # the raw id stream counts first-seen ids, the quantity the table
    # counts) and calls ensure_capacity_host before each window. Growth is
    # pure padding, so the window loop reads nothing from the device; the
    # sticky ``probe`` is checked at the next natural read.
    # ------------------------------------------------------------------ #
    def ensure_capacity_host(self, count_bound: int) -> None:
        """Grow (no device read: pure padding) so ``count_bound`` entries
        fit."""
        if count_bound > self.capacity:
            self._repad(bucket_capacity(max(count_bound, 2 * self.capacity)))

    def encode_pair_spec(self, src, dst) -> Tuple[torch.Tensor, torch.Tensor]:
        """Growth-mode device encode: one step, no device read, no
        validation. The caller guarantees capacity through
        :meth:`ensure_capacity_host`."""
        src, dst = self._column(src), self._column(dst)
        self._state, si, di = encode_pair_batch(self._state, src, dst)
        self._pending += 2 * int(src.shape[0])
        return si, di

    def encode_pair(self, src, dst) -> Tuple[torch.Tensor, torch.Tensor]:
        """Device-encode edge columns in arrival order (src before dst per
        edge). Takes numpy or device int32 columns; returns device index
        columns."""
        self._validate(src, dst)
        src, dst = self._column(src), self._column(dst)
        self._ensure(2 * int(src.shape[0]))
        self._state, si, di = encode_pair_batch(self._state, src, dst)
        self._pending += 2 * int(src.shape[0])
        return si, di

    def encode(self, raw) -> np.ndarray:
        """Encode a batch of raw ids; returns host compact ids."""
        host = np.asarray(raw, np.int64).ravel()
        self._validate(host)
        self._ensure(int(host.size))
        self._state, out = encode_batch(self._state, self._column(host))
        self._pending += int(host.size)
        return out.cpu().numpy()

    def _rev_array(self) -> np.ndarray:
        """Host copy of the reverse table, cached by the read count (a full
        download per decode would move the whole table every emission)."""
        self._sync()
        cached = self._rev_cache
        if cached is not None and cached[0] == self._synced_count:
            return cached[1]
        rev = self._state["rev"].cpu().numpy()
        self._rev_cache = (self._synced_count, rev)
        return rev

    def decode(self, idx) -> np.ndarray:
        return self._rev_array()[np.asarray(idx, np.int64)].astype(np.int64)

    def decode_one(self, idx: int) -> int:
        return int(self.decode(np.asarray([idx]))[0])

    def lookup(self, raw: int):
        """Query without inserting (host binary search: the emission/API
        path, not the ingest hot path)."""
        keys = self._state["keys"].cpu().numpy()
        pos = int(np.searchsorted(keys, np.int32(raw)))
        if pos < keys.shape[0] and keys[pos] == int(raw):
            return int(self._state["idx"][pos])
        return None

    def raw_ids(self) -> np.ndarray:
        """All raw ids in compact-index order."""
        n = len(self)
        return self._state["rev"][:n].cpu().numpy().astype(np.int64)

    def raw_table(self, device) -> torch.Tensor:
        """Device int32 table compact -> raw (0 where unassigned), made on
        the device (no upload, no device read)."""
        rev = self._state["rev"]
        return torch.where(rev == -1, 0, rev).to(torch.device(device))
