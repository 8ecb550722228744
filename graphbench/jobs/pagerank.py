"""Incremental PageRank: ``IncrementalPageRank(...).run(stream)`` over
``datasets.stream_file`` on the cell's ``.gbin`` with an ``IdentityDict``,
a fresh job each pass. The ranks of each window are read through the
workload's serving surface (``servable().payloads``, which drives ``run``
and hands over each window's rank vector and the edges it holds).

A kept window is its rank vector and held-edge count; after the measured
window they are compared with ``reference.pagerank.windowed_ranks`` in
float64: the configuration's procedure (warm start, tolerance stop, at
most ``max_iter`` iterations a window) from the first window on. It is
not the exact fixpoint: a pass's first windows start from uniform ranks
and stop at ``max_iter`` short of the tolerance.
"""

from __future__ import annotations

import torch

from graphbench.reference import pagerank as ref


class Job:
    def __init__(self, cell: dict, config: dict, data, device):
        self.cell, self.config, self.data, self.device = cell, config, data, device
        self.window = int(cell["window_edges"])
        self.windows_per_pass = -(-data.n_edges // self.window)
        self.p = config["program"]

    def window_edges(self, pos: int) -> int:
        return min(self.window, self.data.n_edges - pos * self.window)

    def _end(self, pos: int) -> int:
        return min((pos + 1) * self.window, self.data.n_edges)

    def run_pass(self, keep_at):
        from gelly_streaming_tpu_torch import CountWindow, datasets
        from gelly_streaming_tpu_torch.library import IncrementalPageRank

        p = self.p
        stream = datasets.stream_file(
            self.data.path, window=CountWindow(self.window),
            vertex_dict=datasets.IdentityDict(int(p["id_bound"])),
            prefetch_depth=int(p["prefetch_depth"]), device=self.device)
        pr = IncrementalPageRank(damping=float(p["damping"]), tol=float(p["tol"]),
                                 max_iter=int(p["max_iter"]))
        it = pr.servable().payloads(stream)
        try:
            for pos, (payload, held) in enumerate(it):
                kept = (pos, payload["ranks"], held) if keep_at(pos) else None
                yield self.window_edges(pos), kept
        finally:
            it.close()

    def collect(self, kept):
        pos, ranks, held = kept
        return pos, (ranks.detach().to("cpu", torch.float64), int(held))

    def _ranks(self, positions, dtype):
        src, dst = self.data.device_columns(self.device)
        p = self.p
        return ref.windowed_ranks(src, dst, self.window, [self._end(q) for q in positions],
                                  float(p["damping"]), float(p["tol"]), int(p["max_iter"]),
                                  dtype)

    def _numbers(self, pairs):
        """The compared numbers of each ``(position, (ranks, held))``."""
        want = self._ranks([pos for pos, _ in pairs], torch.float64)
        out = []
        for (pos, (ranks, held)), w in zip(pairs, want):
            l1, rel = ref.gaps(ranks.to(w.device), w)
            out.append({"edges_held_differ": abs(held - self._end(pos)), "rank_l1_gap": l1,
                        "rank_rel_gap": rel})
        return out

    def check(self, answers):
        return self._numbers(answers)

    def control(self, positions):
        """The compared numbers of the control: the same procedure in
        bfloat16 in the program's place."""
        ranks = self._ranks(positions, torch.bfloat16)
        return self._numbers([(q, (r, self._end(q))) for q, r in zip(positions, ranks)])

    def sizes(self, positions):
        """Held edges and vertices of each traced window."""
        src, dst = self.data.device_columns(self.device)
        ends = torch.tensor([self._end(q) - 1 for q in positions], device=src.device)
        top = torch.cummax(torch.maximum(src, dst), 0).values[ends]
        return {
            "window_edges": [self.window_edges(q) for q in positions],
            "held_edges": [self._end(q) for q in positions],
            "vertices": [int(v) + 1 for v in top.tolist()],
        }
