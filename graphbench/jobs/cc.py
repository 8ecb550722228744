"""Streaming connected components: ``datasets.stream_file(...)
.aggregate(ConnectedComponents())`` over the cell's ``.gbin``, a fresh job
each pass.

A kept window is its emitted ``Components`` with the pass's vertex
dictionary; after the measured window they are read (``labels()``, the
dictionary's ``decode``) and compared, as raw ids and the least raw id of
each one's component, with ``reference.cc`` on the same columns.
"""

from __future__ import annotations

import torch

from graphbench.reference import cc as ref


class Job:
    def __init__(self, cell: dict, config: dict, data, device):
        self.cell, self.config, self.data, self.device = cell, config, data, device
        self.window = int(cell["window_edges"])
        self.windows_per_pass = -(-data.n_edges // self.window)

    def window_edges(self, pos: int) -> int:
        return min(self.window, self.data.n_edges - pos * self.window)

    def run_pass(self, keep_at):
        """Yield ``(edges, kept)`` a window; ``kept`` is the window's output
        where ``keep_at(position)`` is true, else None."""
        from gelly_streaming_tpu_torch import CountWindow, datasets
        from gelly_streaming_tpu_torch.library import ConnectedComponents

        p = self.config["program"]
        stream = datasets.stream_file(
            self.data.path, window=CountWindow(self.window),
            device_encode=bool(p["device_encode"]),
            min_vertex_capacity=int(p["min_vertex_capacity"]),
            prefetch_depth=int(p["prefetch_depth"]), device=self.device)
        it = stream.aggregate(ConnectedComponents())
        try:
            for pos, comps in enumerate(it):
                kept = (pos, comps, stream.vertex_dict) if keep_at(pos) else None
                yield self.window_edges(pos), kept
        finally:
            it.close()

    def collect(self, kept):
        """The program's answer of a kept window, on the host."""
        pos, comps, vdict = kept
        ids, lab = comps.labels()
        return pos, ref.least_of_components(vdict.decode(ids), lab)

    def _ends(self, positions):
        return [min((p + 1) * self.window, self.data.n_edges) for p in positions]

    def _numbers(self, positions, got):
        src, dst = self.data.device_columns(self.device)
        want = ref.prefix_components(src, dst, self.data.id_bound, self._ends(positions))
        out = []
        for g, w in zip(got, want):
            d, m = ref.compare(g, w)
            out.append({"seen_ids_differ": d, "vertices_mislabeled": m})
        return out

    def check(self, answers):
        """The compared numbers of each kept answer."""
        return self._numbers([p for p, _ in answers], [a for _, a in answers])

    def control(self, positions):
        """The compared numbers of the control (``capped_window_labels``
        put in the program's place) at ``positions``."""
        src, dst = self.data.device_columns(self.device)
        got = ref.capped_window_labels(src, dst, self.data.id_bound, self.window,
                                       self._ends(positions))
        return self._numbers(positions, got)

    def sizes(self, positions):
        """What the metric readers need of the traced windows' sizes: the
        edges of each, and the ids each one sees first."""
        src, dst = self.data.device_columns(self.device)
        first = torch.full((self.data.id_bound,), self.data.n_edges, dtype=torch.int64,
                           device=src.device)
        order = torch.arange(src.shape[0], device=src.device)
        first.scatter_reduce_(0, src.long(), order, "amin")
        first.scatter_reduce_(0, dst.long(), order, "amin")
        seen_first = torch.bincount(first[first < self.data.n_edges] // self.window,
                                    minlength=self.windows_per_pass).cpu().numpy()
        return {
            "window_edges": [self.window_edges(p) for p in positions],
            "new_ids": [int(seen_first[p]) for p in positions],
            "id_bound": self.data.id_bound,
        }
