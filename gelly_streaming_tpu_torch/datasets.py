"""Datasets for the PyTorch port: the identity vertex mapping and R-MAT.

The counterpart of ``gelly_streaming_tpu/datasets.py`` as far as the
streaming GraphSAGE slice needs it. ``stream_file`` (native chunked
parse of corpus files) comes with the native-ingest work of the streaming
Connected Components slice (ROADMAP Queue 1, slice 2) and raises until
then.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .core.edgeblock import bucket_capacity


def rmat_edges(
    n_edges: int,
    scale: int,
    seed: int = 0,
    a: float = 0.57,
    b: float = 0.19,
    c: float = 0.19,
) -> Tuple[np.ndarray, np.ndarray]:
    """Vectorized R-MAT: ``n_edges`` edges over ``2**scale`` vertices.

    One pass per address bit; each pass picks the quadrant for every edge
    at once (no per-edge recursion).
    """
    rng = np.random.default_rng(seed)
    src = np.zeros(n_edges, np.int64)
    dst = np.zeros(n_edges, np.int64)
    for _ in range(scale):
        r = rng.random(n_edges)
        src_bit = r >= (a + b)
        dst_bit = (r >= a) & (r < a + b) | (r >= a + b + c)
        src = (src << 1) | src_bit
        dst = (dst << 1) | dst_bit
    return src, dst


def stream_file(*args, **kwargs):
    raise NotImplementedError(
        "datasets.stream_file is ported with the native ingest in ROADMAP "
        "Queue 1, slice 2 (streaming Connected Components)"
    )


class IdentityDict:
    """VertexDict stand-in for corpora whose ids are already dense small
    integers: compact id == raw id, so the encode stage of ingest
    disappears. Emission correctness does not depend on this mapping:
    workloads track which vertices actually appeared.
    """

    def __init__(self, id_bound: int):
        self.id_bound = int(id_bound)
        self._observed = 0  # max encoded id + 1

    def __len__(self) -> int:
        """Number of ids actually observed (max + 1), NOT the declared
        bound."""
        return self._observed

    @property
    def capacity(self) -> int:
        return bucket_capacity(max(1, self.id_bound))

    def observe(self, max_id: int) -> None:
        """Advance the observed-id watermark."""
        if max_id >= self._observed:
            self._observed = max_id + 1

    def encode(self, raw):
        a = np.asarray(raw)
        if a.size:
            hi = int(a.max())
            if int(a.min()) < 0 or hi >= self.id_bound:
                raise ValueError(
                    f"raw id outside [0, {self.id_bound}) — not a dense-id "
                    "corpus; use VertexDict"
                )
            self.observe(hi)
        return a if a.dtype == np.int32 else a.astype(np.int32)

    def encode_pair(self, src, dst):
        return self.encode(src), self.encode(dst)

    def decode(self, idx):
        return np.asarray(idx, np.int64)

    def lookup(self, raw: int):
        return int(raw) if 0 <= int(raw) < self.id_bound else None

    def lookup_batch(self, raw) -> np.ndarray:
        """Vectorized :meth:`lookup`: compact ids, -1 for ids outside the
        declared bound."""
        a = np.asarray(raw, np.int64).ravel()
        return np.where(
            (a >= 0) & (a < self.id_bound), a, -1
        ).astype(np.int32)

    def raw_ids(self) -> np.ndarray:
        """Ids observed so far (the checkpoint surface)."""
        return np.arange(self._observed, dtype=np.int64)

    def raw_table(self, device) -> torch.Tensor:
        """Device int32 table compact -> raw: the identity over the
        capacity, made on the device (no upload, no host sync)."""
        return torch.arange(self.capacity, dtype=torch.int32, device=device)
