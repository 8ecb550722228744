"""Emission helpers of the PyTorch port (``core/emission.py``).

Only :func:`iter_unstacked` so far, which the dense superbatch path of the
aggregation engine needs; the emission streams of the reference module
come with ROADMAP Queue 1, slice 4.
"""

from __future__ import annotations


def iter_unstacked(stacked: dict, n: int):
    """Unstack a superbatch's ``[K, ...]`` per-window states (a dict of
    tensors) into K per-window dicts. Each is a view of row ``i`` of the
    stacked tensors: no copy and no host read, and the stacked buffers
    stay alive as long as some window's emission holds a row."""
    for i in range(n):
        yield {key: value[i] for key, value in stacked.items()}
