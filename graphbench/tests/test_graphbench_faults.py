"""A run with the timed path broken underneath comes out not correct: the
look for a card is skipped (the cells run on the CPU at a tiny size), the
rest of the run is the benchmark's own. The faults a cell can have:

- a step that returns its state unchanged;
- half of a window's edges left out;
- an answer altered where it is produced.

Both cells run on one chip, so there is no exchange between chips to
leave out.
"""

import dataclasses
import time

import numpy as np
import pytest
import torch

from gelly_streaming_tpu_torch.aggregate.summary import SummaryBulkAggregation
from gelly_streaming_tpu_torch.library import pagerank as pr_lib
from gelly_streaming_tpu_torch.ops import pagerank_kernels
from gelly_streaming_tpu_torch.summaries.labels import Components
from graphbench import harness


def _run(cell, tiny, tmp_path):
    result, _ = harness.run_cell(cell, 2**31 + 29, 0.3, False, "cpu", time.perf_counter(),
                                 overrides=tiny[cell], data_dir=str(tmp_path))
    return result


def test_sound_runs_are_correct(tiny, tmp_path):
    assert _run("cc_s23_w1m", tiny, tmp_path)["correct"] is True
    assert _run("pr_s22_w1m", tiny, tmp_path)["correct"] is True


def _cc_unchanged(self, summary, block, vcap, mesh=None):
    return summary


def _cc_half(real):
    def step(self, summary, block, vcap, mesh=None):
        keep = torch.arange(block.mask.shape[0], device=block.mask.device) < int(
            block.mask.sum()) // 2
        return real(self, summary, dataclasses.replace(block, mask=block.mask & keep), vcap, mesh)
    return step


def _cc_altered(real):
    def labels(self):
        ids, lab = real(self)
        lab = lab.copy()
        _, inv, counts = np.unique(lab, return_inverse=True, return_counts=True)
        i = int(np.flatnonzero(counts[inv] >= 2)[0])  # a vertex with company
        lab[i] = -1
        return ids, lab
    return labels


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_cc_fault_is_caught(fault, tiny, tmp_path, monkeypatch):
    if fault == "unchanged":
        monkeypatch.setattr(SummaryBulkAggregation, "_window_step", _cc_unchanged)
    elif fault == "half":
        monkeypatch.setattr(SummaryBulkAggregation, "_window_step",
                            _cc_half(SummaryBulkAggregation._window_step))
    else:
        monkeypatch.setattr(Components, "labels", _cc_altered(Components.labels))
    assert _run("cc_s23_w1m", tiny, tmp_path)["correct"] is False


def _pr_unchanged(src, dst, ranks, n_seen, *args):
    zero = torch.zeros((), dtype=ranks.dtype)
    return ranks, zero, torch.zeros((), dtype=torch.int32)


def _pr_altered(real):
    def fixpoint(*args):
        r, delta, iters = real(*args)
        r = r.clone()
        r[int(torch.argmax(r))] *= 2
        return r, delta, iters
    return fixpoint


def _pr_half(real):
    def step(self, bsrc, bdst, n_new, n_seen, vcap):
        return real(self, bsrc, bdst, n_new // 2, n_seen, vcap)
    return step


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_pagerank_fault_is_caught(fault, tiny, tmp_path, monkeypatch):
    if fault == "unchanged":
        monkeypatch.setattr(pagerank_kernels, "fixpoint", _pr_unchanged)
    elif fault == "half":
        monkeypatch.setattr(pr_lib.IncrementalPageRank, "_step",
                            _pr_half(pr_lib.IncrementalPageRank._step))
    else:
        monkeypatch.setattr(pagerank_kernels, "fixpoint", _pr_altered(pagerank_kernels.fixpoint))
    assert _run("pr_s22_w1m", tiny, tmp_path)["correct"] is False
