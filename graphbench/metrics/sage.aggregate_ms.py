"""Device ms a window of the model's aggregation, from the program's own
device span (``sage.aggregate.device``: CUDA events at the first and last
launch of each layer's mean, ``models/graphsage.py:sage_layer``). It runs
from the span's first device work to its last, so it holds any gap between
the mean's launches and any work another thread puts on the stream
meanwhile (the producer's pinned upload). Read from the span and not from
the kernels under the profiler range: in a traced pass of this cell the
profiler links some device records to more than one operation, and the
range read about 1.4 times its kernels' time. Moves ``edges_per_s``."""

UNIT = "ms"
SPAN = "sage.aggregate.device"


def read(t):
    row = t["spans"].get(SPAN)
    if row is None or not t["windows"]:
        return None
    return row[1] * 1e3 / t["windows"]
