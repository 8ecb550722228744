"""Incidence-sampling triangle-count estimate CLI
(``example/IncidenceSamplingTriangleCount.java:38-60``), PyTorch port; the
arguments and output of ``broadcast_triangle_count``::

    python -m gelly_streaming_tpu_torch.example.incidence_sampling_triangle_count \\
        [--cpu] <input edges path> <vertex count> <samples> [output path]
"""

from __future__ import annotations

from typing import List

from ..core.device import DEFAULT_DEVICE
from ..library.sampling import IncidenceSamplingTriangleCount
from . import broadcast_triangle_count
from .common import run_main


def run(edges, vertex_count, samples, output_path=None, device=DEFAULT_DEVICE):
    return broadcast_triangle_count.run(
        edges, vertex_count, samples, output_path,
        estimator_cls=IncidenceSamplingTriangleCount, device=device,
    )


def main(args: List[str]) -> None:
    broadcast_triangle_count.main(
        args, estimator_cls=IncidenceSamplingTriangleCount,
        name="incidence_sampling_triangle_count",
    )


if __name__ == "__main__":
    run_main(main)
