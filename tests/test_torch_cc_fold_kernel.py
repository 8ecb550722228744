"""The dense CC carry's window fold kernel (``csrc/cc_fold.cu``) on the card.

Every test needs an NVIDIA card and skips without one. The kernel's table
and flags must equal, bit for bit, those of the plain composition
(``cc_kernels.fold_window_plain``: ``label_combine(state,
cc_fold(init_labels(V), ...))``) run on the same card, window after window,
on the cases of ``tests/test_torch_cc_fold.py`` at scale 16: eight carried
R-MAT windows, stars onto the first and the last vertex, a path fed in
reverse, self-loops and repeats, half the lanes masked, a carried table that
is min-rooted and not flat, and a table grown between windows. And in a
device-encoded CC pass: one launch a window, no host read while it folds, an
emitted table unchanged by later windows, no host sync in the whole window
loop, and the CPU's components.

Run on the card: ``python -m pytest --noconftest -p no:cacheprovider
tests/test_torch_cc_fold_kernel.py``.
"""

import numpy as np
import pytest
import torch

from test_torch_cc_fold import CASES, case_stream
from test_torch_cuda import _syncs

import gelly_streaming_tpu_torch as gt
from gelly_streaming_tpu_torch.ops import cc_kernels
from gelly_streaming_tpu_torch.summaries import labels as L

pytestmark = pytest.mark.cuda

CARD_SCALE = 16


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.parametrize("case", CASES)
def test_kernel_equals_the_plain_composition_on_card(card, case):
    lab, tch, wins = case_stream(case, CARD_SCALE, seed=11)
    state = {"labels": torch.from_numpy(lab).to(card), "touched": torch.from_numpy(tch).to(card)}
    for i, (vcap, s, d, m) in enumerate(wins):
        state = L.grow_labels(state, vcap)
        s, d, m = (torch.from_numpy(x).to(card) for x in (s, d, m))
        held = {k: t.clone() for k, t in state.items()}
        before = cc_kernels.LAUNCHES
        got = cc_kernels.fold_window(state["labels"], state["touched"], s, d, m)
        torch.cuda.synchronize()
        assert cc_kernels.LAUNCHES == before + 1
        want = cc_kernels.fold_window_plain(state["labels"], state["touched"], s, d, m)
        assert torch.equal(got[0], want[0]), (case, i)
        assert torch.equal(got[1], want[1]), (case, i)
        assert all(torch.equal(state[k], held[k]) for k in state)  # inputs untouched
        state = {"labels": got[0], "touched": got[1]}


def _gbin(tmp_path, seed=17, v=1 << 15, n=1 << 17):
    rng = np.random.default_rng(seed)
    src, dst = rng.integers(0, v, n), rng.integers(0, v, n)
    path = str(tmp_path / "cc.gbin")
    gt.datasets.write_binary(path, src.astype(np.int32), dst.astype(np.int32))
    return path, v


def _stream(path, v, device):
    return gt.datasets.stream_file(path, window=gt.CountWindow(1 << 14), device_encode=True,
                                   min_vertex_capacity=v, prefetch_depth=2, device=device)


def test_device_encoded_pass_launches_once_a_window_and_reads_nothing(card, tmp_path):
    from gelly_streaming_tpu_torch.library import ConnectedComponents

    path, v = _gbin(tmp_path)
    list(_stream(path, v, card).aggregate(ConnectedComponents()))  # warm
    torch.cuda.synchronize()
    launches, reads = cc_kernels.LAUNCHES, L.HOST_READS
    kept = []
    for comps in _stream(path, v, card).aggregate(ConnectedComponents()):
        labels, touched = comps._lazy[0], comps._lazy[1]
        kept.append((labels, touched, labels.clone(), touched.clone()))
    assert cc_kernels.LAUNCHES - launches == len(kept) == 8
    assert L.HOST_READS == reads
    torch.cuda.synchronize()
    # a table emitted for an earlier window is never written again
    for labels, touched, lab0, tch0 in kept:
        assert torch.equal(labels, lab0) and torch.equal(touched, tch0)
    assert len({t[0].data_ptr() for t in kept}) == len(kept)


def test_device_encoded_cc_window_loop_makes_no_host_sync_and_matches_cpu(card, tmp_path):
    from gelly_streaming_tpu_torch.library import ConnectedComponents

    path, v = _gbin(tmp_path, seed=19)
    list(_stream(path, v, card).aggregate(ConnectedComponents()))  # warm
    torch.cuda.synchronize()
    agg = ConnectedComponents()
    out = _syncs(lambda: list(_stream(path, v, card).aggregate(agg)))
    assert agg._cc_mode == "dense" and len(out) == 8
    want = list(_stream(path, v, "cpu").aggregate(ConnectedComponents()))
    assert len(want) == 8
    for got, w in zip(out, want):
        assert got.components == w.components
