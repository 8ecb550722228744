"""Sampling-based streaming triangle estimators, Buriol et al. style
(PyTorch port of ``gelly_streaming_tpu/library/sampling.py``).

The reference's two estimator examples:

- ``example/BroadcastTriangleCount.java:62-174``: every subtask holds
  ``samples/parallelism`` reservoir states; each state keeps one sampled
  edge (coin-flip 1/i replacement), a uniformly drawn third vertex, and
  found-flags for the two closing edges; the estimate is
  ``(1/samples) * sum(beta) * edgeCount * (V-2)``.
- ``example/IncidenceSamplingTriangleCount.java:61-242``: the same
  estimator; a parallelism-1 mapper owns the coin flips and routes only
  sampled/incident edges to the keyed samplers.

The two differ only in Flink routing, which has no device meaning: the
sample states are ``[k]`` tensors either way. Two window updates share
them:

- :func:`_window_vectorized` (``vertex_count <= _PACK_LIMIT``, so that the
  canonical pair key ``u * V + v`` fits int32) draws each sample's final
  edge directly: it keeps its edge with probability m/N, else takes a
  uniform window position, and draws a uniform third vertex; the
  closing-edge flags are last-occurrence queries, answered by a binary
  search over the window's sorted canonical pairs.
- :func:`_window_scan` (larger id spaces) folds the window edge by edge,
  with vector operations over the ``k`` samples: on the card it is bound
  by its launches, about twenty an edge.

Both take their uniforms as arguments: ``u_coin``/``u_third`` per edge for
the scan, ``u_keep``/``r_sel``/``r_third`` per window for the vectorized
form. Given the same uniforms the states, ``edge_count`` and ``beta_sum``
equal the JAX package's exactly: the arithmetic stays float32 as there
(``u < 1/m``, ``u < m0/max(N, 1)``, ``(r * n).to(int32)``), the thresholds
computed in float32 on the host. The estimators draw the uniforms from an
explicit, seeded ``torch.Generator`` on the stream's device where the
reference carries a ``jax.random`` key: deterministic per seed, but a
different generator family, so the two packages' runs agree only when the
uniforms are passed in.

What differs from the XLA reference, and why:

- The edge count before a window and the window's edge count are host
  integers (the blocks carry their host columns), so the thresholds need
  no device read; the scan visits only the window's valid edges (the
  reference's scan also steps over the padding, which changes nothing but
  its key).
- The two-key ``lax.sort((ck, pos))`` is one stable sort of ``ck``:
  ``pos`` rises with the slot among the valid slots, and every pad has
  the same key and ``pos``.
- The only device read per window is ``beta_sum``, which the change-only
  emission needs.

Estimates use RAW vertex ids: like the reference, the third vertex is
drawn from a caller-supplied id space ``[0, vertex_count)``.
"""

from __future__ import annotations

from typing import Iterable, Iterator, Optional, Tuple

import numpy as np
import torch

from ..core.device import DEFAULT_DEVICE, resolve_device
from ..core.window import CountWindow, WindowPolicy, Windower
from ..obs import trace as _trace

_BIG = int(np.iinfo(np.int32).max)

#: largest vertex_count whose canonical pair key (u*V+v) fits int32
_PACK_LIMIT = 46340

#: edges per batch of scan uniforms (``[edges, k]`` float32 twice), so a
#: window of many edges over many samples does not hold all its draws
_SCAN_DRAW_ELEMS = 1 << 24


def init_sampler_state(n_samples: int, device) -> dict:
    return {
        "src": torch.full((n_samples,), -1, dtype=torch.int32, device=device),
        "trg": torch.full((n_samples,), -1, dtype=torch.int32, device=device),
        "third": torch.full((n_samples,), -1, dtype=torch.int32, device=device),
        "src_found": torch.zeros(n_samples, dtype=torch.bool, device=device),
        "trg_found": torch.zeros(n_samples, dtype=torch.bool, device=device),
    }


def _f32(x) -> float:
    """``x`` rounded to float32, as a Python float (exact in float32)."""
    return float(np.float32(x))


def _window_scan(state: dict, edge_count: int, src: np.ndarray, dst: np.ndarray,
                 vertex_count: int, u_coin: torch.Tensor, u_third: torch.Tensor):
    """Fold a window's valid edges, one by one, through all reservoir
    states.

    ``src``/``dst``: the window's raw ids (host int arrays, valid edges
    only); ``u_coin``/``u_third``: ``[len(src), k]`` float32 uniforms on
    the state's device, one row per edge (the coin flip and the
    third-vertex draw). Returns ``(state, new_edge_count)``; ``state`` is
    not written."""
    with _trace.span("sampling.scan"):
        st = dict(state)
        m = int(edge_count)
        for i, (s, d) in enumerate(zip(src.tolist(), dst.tolist())):
            m += 1
            # coin-flip 1/m per sample: replace the reservoir edge
            coin = u_coin[i] < _f32(np.float32(1.0) / np.float32(m))
            # third vertex uniform over [0, V) \ {s, d}
            u1, u2 = min(s, d), max(s, d)
            distinct = u1 != u2
            n_valid = vertex_count - 1 - int(distinct)
            c0 = torch.clamp_max((u_third[i] * _f32(n_valid)).to(torch.int32), n_valid - 1)
            c = c0 + (c0 >= u1).to(torch.int32)
            if distinct:
                c = c + (c >= u2).to(torch.int32)
            st["src"] = torch.where(coin, s, st["src"])
            st["trg"] = torch.where(coin, d, st["trg"])
            st["third"] = torch.where(coin, c, st["third"])
            # closing-edge checks (undirected match, reference :108-121)
            hit_src = ((st["src"] == s) & (st["third"] == d)) | (
                (st["third"] == s) & (st["src"] == d))
            hit_trg = ((st["trg"] == s) & (st["third"] == d)) | (
                (st["third"] == s) & (st["trg"] == d))
            st["src_found"] = (st["src_found"] & ~coin) | hit_src
            st["trg_found"] = (st["trg_found"] & ~coin) | hit_trg
        return st, m


def _window_vectorized(state: dict, edge_count: int, src: torch.Tensor,
                       dst: torch.Tensor, mask: torch.Tensor, n_valid: int,
                       vertex_count: int, u_keep: torch.Tensor,
                       r_sel: torch.Tensor, r_third: torch.Tensor, table=None):
    """Distribution-equivalent window update without a per-edge loop.

    After the window each sample kept its carried edge with probability
    m/N (m edges before the window, N after), else it holds a uniformly
    selected window edge; a closing-edge flag sets iff the (endpoint,
    third) pair occurs in the window strictly after the sample's selection
    (anywhere, for a kept sample). ``src``/``dst``/``mask``: the window's
    padded device columns (compact ids mapped to raw ids through
    ``table`` on the device when given); ``n_valid``: its valid edges
    (a prefix of the slots); ``u_keep``/``r_sel``/``r_third``: ``[k]``
    float32 uniforms. Returns ``(state, new_edge_count, beta_sum)`` with
    ``beta_sum`` a device scalar; ``state`` is not written."""
    with _trace.span("sampling.window"):
        s, d = src, dst
        if table is not None:
            s = table[s.long()]
            d = table[d.long()]
        e = s.shape[0]
        m0 = int(edge_count)
        n_total = m0 + int(n_valid)
        keep = u_keep < _f32(np.float32(m0) / np.float32(max(n_total, 1)))
        if n_valid == 0:
            keep = torch.ones_like(keep)
        # selected window position, uniform over [0, n_valid)
        p = torch.clamp_max((r_sel * _f32(n_valid)).to(torch.int32), max(n_valid - 1, 0))
        cum = torch.cumsum(mask, 0, dtype=torch.int32) - 1  # position of each valid slot
        slot = torch.searchsorted(cum, p).clamp_(0, e - 1)
        es, ed = s[slot], d[slot]
        # third vertex uniform over [0, V) \ {es, ed} (the scan's formula)
        u1 = torch.minimum(es, ed)
        u2 = torch.maximum(es, ed)
        distinct = u1 != u2
        nv = vertex_count - 1 - distinct.to(torch.int32)
        c0 = torch.minimum((r_third * nv.to(torch.float32)).to(torch.int32), nv - 1)
        c1 = c0 + (c0 >= u1).to(torch.int32)
        c = c1 + ((c1 >= u2) & distinct).to(torch.int32)
        st = {
            "src": torch.where(keep, state["src"], es),
            "trg": torch.where(keep, state["trg"], ed),
            "third": torch.where(keep, state["third"], c),
            "src_found": state["src_found"] & keep,
            "trg_found": state["trg_found"] & keep,
        }
        sel_pos = torch.where(keep, -1, p)
        # last-occurrence window position per canonical pair
        ck = torch.where(mask, torch.minimum(s, d) * vertex_count + torch.maximum(s, d), _BIG)
        pos = torch.where(mask, cum, -1)
        sk, order = torch.sort(ck, stable=True)
        sp = pos[order]

        def last_pos_of(a, b):
            q = torch.minimum(a, b) * vertex_count + torch.maximum(a, b)
            right = torch.searchsorted(sk, q, right=True) - 1
            rc = right.clamp(0, e - 1)
            ok = (right >= 0) & (sk[rc] == q)
            return torch.where(ok, sp[rc], -1)

        st["src_found"] = st["src_found"] | (last_pos_of(st["src"], st["third"]) > sel_pos)
        st["trg_found"] = st["trg_found"] | (last_pos_of(st["trg"], st["third"]) > sel_pos)
        beta_sum = (st["src_found"] & st["trg_found"]).sum()
        return st, n_total, beta_sum


class BroadcastTriangleCount:
    """Global triangle-count estimate from k reservoir samples.

    ``run(edges)`` yields ``(edge_count, estimate)`` per window when the
    estimate changed (the reference's change-only emission,
    ``BroadcastTriangleCount.java:163-170``). Defaults mirror the
    reference's CLI defaults (``:216-217``). The samples live on
    ``device``; ``seed`` seeds the ``torch.Generator`` the uniforms come
    from.
    """

    def __init__(
        self,
        vertex_count: int = 1000,
        samples: int = 10000,
        window: Optional[WindowPolicy] = None,
        seed: int = 0,
        device=DEFAULT_DEVICE,
    ):
        if vertex_count < 3:
            raise ValueError("need at least 3 vertices to form a triangle")
        self.device = resolve_device(device)
        self.vertex_count = vertex_count
        self.samples = samples
        self.window = window or CountWindow(1 << 14)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(seed)
        self._state = init_sampler_state(samples, self.device)
        self._edge_count = 0
        self._previous = 0  # the reference never emits the initial 0
        self._last_beta = 0

    def _draw(self, *shape: int) -> torch.Tensor:
        """Uniform float32 draws in [0, 1) from the estimator's generator."""
        return torch.rand(shape, generator=self._gen, device=self.device)

    def state_dict(self) -> dict:
        """Checkpoint surface: the sample columns, the edge count and the
        last emitted estimate (the JAX package's keys), and the generator's
        state, which only this package reads."""
        return {
            "state": {k: v.cpu().numpy() for k, v in self._state.items()},
            "edge_count": int(self._edge_count),
            "previous": self._previous,
            # numpy, not a tensor: a checkpoint holds numpy and builtins only
            "generator": self._gen.get_state().numpy(),
        }

    def load_state_dict(self, d: dict) -> None:
        """Restore a checkpoint of either package; the generator state is
        restored only from this package's (a JAX key does not carry over)."""
        self._state = {
            k: torch.as_tensor(np.array(v)).to(self.device)
            for k, v in d["state"].items()
        }
        self._edge_count = int(d["edge_count"])
        self._previous = d["previous"]
        if "generator" in d:
            self._gen.set_state(torch.as_tensor(np.asarray(d["generator"], np.uint8)))

    def _window(self, block, vdict) -> int:
        """Fold one window block; returns its edge count. The vectorized
        form when the canonical pair key fits int32, else the scan."""
        cache = block._host_cache
        n = len(cache[0])
        k = self.samples
        if self.vertex_count <= _PACK_LIMIT:
            u_keep, r_sel, r_third = self._draw(k), self._draw(k), self._draw(k)
            self._state, self._edge_count, beta_sum = _window_vectorized(
                self._state, self._edge_count, block.src, block.dst, block.mask,
                n, self.vertex_count, u_keep, r_sel, r_third,
                table=vdict.raw_table(self.device),
            )
            self._last_beta = int(beta_sum)
        else:
            s = vdict.decode(cache[0]).astype(np.int64)
            d = vdict.decode(cache[1]).astype(np.int64)
            step = max(1, _SCAN_DRAW_ELEMS // max(k, 1))
            for a in range(0, n, step):
                b = min(a + step, n)
                u_coin, u_third = self._draw(b - a, k), self._draw(b - a, k)
                self._state, self._edge_count = _window_scan(
                    self._state, self._edge_count, s[a:b], d[a:b],
                    self.vertex_count, u_coin, u_third,
                )
            self._last_beta = int((self._state["src_found"] & self._state["trg_found"]).sum())
        return n

    def run(self, edges: Iterable[Tuple]) -> Iterator[Tuple[int, int]]:
        windower = Windower(self.window, device=self.device)
        for block in windower.blocks(edges):
            self._window(block, windower.vertex_dict)
            estimate = int(
                (1.0 / self.samples)
                * self._last_beta
                * self._edge_count
                * (self.vertex_count - 2)
            )
            if estimate != self._previous:
                self._previous = estimate
                yield self._edge_count, estimate

    def run_estimates(self, edges: Iterable[Tuple]):
        """``run()`` with typed emissions: the
        :class:`~gelly_streaming_tpu_torch.utils.types.TriangleEstimate`
        partial behind each change-only emission (``util/TriangleEstimate.java``,
        ``BroadcastTriangleCount.java:150-170``). ``source`` is 0: the
        vectorized estimator is one logical subtask."""
        from ..utils.types import TriangleEstimate

        for edge_count, _ in self.run(edges):
            yield TriangleEstimate(source=0, edge_count=edge_count, beta=self._last_beta)

    def sampled_edges(self) -> list:
        """The current reservoir as typed
        :class:`~gelly_streaming_tpu_torch.utils.types.SampledEdge` records
        (``util/SampledEdge.java``): one per occupied sample. ``resample``
        is False: the reservoir replaces edges in place rather than routing
        resample messages between subtasks."""
        from ..core.types import Edge
        from ..utils.types import SampledEdge

        src = self._state["src"].cpu().numpy()
        trg = self._state["trg"].cpu().numpy()
        n = int(self._edge_count)
        return [
            SampledEdge(
                subtask=0, instance=int(i), edge=Edge(int(s), int(t), None),
                edge_count=n, resample=False,
            )
            for i, (s, t) in enumerate(zip(src.tolist(), trg.tolist()))
            if s >= 0
        ]


class IncidenceSamplingTriangleCount(BroadcastTriangleCount):
    """Incidence-routed flavor (``IncidenceSamplingTriangleCount.java``).

    The reference version differs from the broadcast one only in HOW edges
    reach the sample states (centralized coin flips + keyed routing of
    sampled/incident edges instead of broadcast), a Flink network
    optimization with no device analog; the estimator itself, and hence
    this implementation, is identical.
    """
