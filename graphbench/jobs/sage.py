"""Streaming GraphSAGE inference: ``StreamingGraphSAGE(params, F).run(
stream, TableFeatureSource(table))`` over ``datasets.stream_file`` on the
cell's ``.gbin`` with an ``IdentityDict``, a fresh job each pass. Each
window re-embeds every id over every message so far.

Features (N(0, 1)) and weights (:func:`draw_params`, plain torch: He
scaled, small biases that are not zero) are drawn on the device, in the
configuration's dtype, from a generator seeded by a digest of the stream's
first edges, so the run's seed fixes them (the job is handed the stream,
not the seed). The program and the reference get the same tensors, and
neither made them.

A kept window is its emitted ``[ids, O]`` table; after the measured window
it is compared with ``reference.sage.forward`` in float32 over the same
prefix, features and weights: ``emb_rel_l2`` over the whole table and
``hub_rel_gap`` over the ``HUBS`` ids of highest in-degree in the prefix.
"""

from __future__ import annotations

import hashlib
import math

import numpy as np
import torch

from graphbench import generate
from graphbench.reference import sage as ref

#: the ids of highest in-degree whose rows ``hub_rel_gap`` compares
HUBS = 4096
#: the biases' standard deviation
BIAS_STD = 0.1


def stream_digest(data) -> int:
    """A 63-bit number fixed by the stream's first 4096 edges."""
    h = hashlib.blake2b(digest_size=8)
    h.update(np.ascontiguousarray(data.src[:4096]).tobytes())
    h.update(np.ascontiguousarray(data.dst[:4096]).tobytes())
    return int.from_bytes(h.digest(), "little") >> 1


def draw_params(dims, dtype, generator, device):
    """A layer ``F -> O`` at a time: ``w_self`` and ``w_nbr`` each
    ``N(0, 1) * sqrt(2 / F)`` of shape ``[F, O]``, ``b`` ``N(0, 1) *
    BIAS_STD`` of shape ``[O]``, drawn in float32 in that order and cast to
    ``dtype``."""
    params = []
    for f, o in zip(dims[:-1], dims[1:]):
        layer = {k: (torch.randn((f, o), generator=generator, device=device)
                     * math.sqrt(2.0 / f)).to(dtype) for k in ("w_self", "w_nbr")}
        layer["b"] = (torch.randn(o, generator=generator, device=device) * BIAS_STD).to(dtype)
        params.append(layer)
    return params


class Job:
    def __init__(self, cell: dict, config: dict, data, device):
        self.cell, self.config, self.data, self.device = cell, config, data, device
        self.window = int(cell["window_edges"])
        self.windows_per_pass = -(-data.n_edges // self.window)
        self.p = config["program"]
        self.dims = [int(d) for d in self.p["dims"]]
        dtype = getattr(torch, self.p["dtype"])
        g = generate.generator(stream_digest(data), device)
        self.params = draw_params(self.dims, dtype, g, device)
        self.table = torch.randn((int(self.p["id_bound"]), self.dims[0]), generator=g,
                                 device=device).to(dtype)
        #: kernel launches by variant of each window emitted, in order
        self.launches = []

    def window_edges(self, pos: int) -> int:
        return min(self.window, self.data.n_edges - pos * self.window)

    def _end(self, pos: int) -> int:
        return min((pos + 1) * self.window, self.data.n_edges)

    def run_pass(self, keep_at):
        from gelly_streaming_tpu_torch import CountWindow, datasets
        from gelly_streaming_tpu_torch.models import StreamingGraphSAGE, TableFeatureSource
        from gelly_streaming_tpu_torch.ops import sage_kernels

        stream = datasets.stream_file(
            self.data.path, window=CountWindow(self.window),
            vertex_dict=datasets.IdentityDict(int(self.p["id_bound"])),
            prefetch_depth=int(self.p["prefetch_depth"]), device=self.device)
        sage = StreamingGraphSAGE(self.params, self.dims[0])
        it = sage.run(stream, TableFeatureSource(self.table, device=self.device))
        counts = sage_kernels.LAUNCHES_BY_VARIANT
        try:
            before = dict(counts)
            for pos, out in enumerate(it):
                now = dict(counts)
                self.launches.append({k: now[k] - before.get(k, 0) for k in now})
                before = now
                kept = (pos, out) if keep_at(pos) else None
                yield self.window_edges(pos), kept
        finally:
            it.close()

    def collect(self, kept):
        pos, out = kept
        return pos, out.detach().to("cpu")

    def _numbers(self, pairs, accumulate_got=None):
        """The compared numbers of each ``(position, table)``; with
        ``accumulate_got`` the table is the reference's own in that dtype."""
        src, dst = self.data.device_columns(self.device)
        n = self.table.shape[0]
        out = {}
        for end in sorted({self._end(pos) for pos, _ in pairs}):
            s, d = src[:end], dst[:end]
            want = ref.forward(self.table, self.params, s, d)
            hub_ids = ref.hubs(d, n, HUBS)
            control = (None if accumulate_got is None
                       else ref.forward(self.table, self.params, s, d, accumulate_got))
            for i, (pos, got) in enumerate(pairs):
                if self._end(pos) == end:
                    got = control if control is not None else got.to(want.device)
                    rel, hub = ref.gaps(got, want, hub_ids)
                    out[i] = {"emb_rel_l2": rel, "hub_rel_gap": hub}
            del want, control
        return [out[i] for i in range(len(pairs))]

    def check(self, answers):
        return self._numbers(answers)

    def control(self, positions):
        """The compared numbers of the control: the reference's forward
        with bfloat16 sums and counts (the arithmetic that stops a count at
        256) in the program's place."""
        return self._numbers([(q, None) for q in positions], torch.bfloat16)

    def sizes(self, positions):
        """Held messages, ids and dims of each traced window, and the
        kernel launches by variant over them."""
        traced = self.launches[len(self.launches) - len(positions):] if positions else []
        return {
            "window_edges": [self.window_edges(q) for q in positions],
            "held_edges": [self._end(q) for q in positions],
            "vertices": int(self.table.shape[0]),
            "dims": self.dims,
            "launches": {k: sum(w.get(k, 0) for w in traced) for k in ("tc", "simt")},
        }
