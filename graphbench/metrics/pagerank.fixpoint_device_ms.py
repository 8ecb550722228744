"""Device ms a window of PageRank's fixpoint, from the program's own device
span (``pagerank.fixpoint.device``: a pair of CUDA events around the ctypes
``pagerank_fixpoint`` launch, ``obs/trace.py``), with no profiler. It runs
from the span's first device work to its last: on an idle stream it also
holds the launch latency. Moves ``edges_per_s``."""

UNIT = "ms"
SPAN = "pagerank.fixpoint.device"


def read(t):
    row = t["spans"].get(SPAN)
    if row is None or not t["windows"]:
        return None
    return row[1] * 1e3 / t["windows"]
