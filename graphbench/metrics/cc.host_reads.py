"""Device-to-host reads a window of the CC fold path
(``summaries/labels.py:HOST_READS``: one a fixpoint turn, one a carry
download). A count that repeats exactly for the same stream. Moves
``edges_per_s``."""

UNIT = "reads/window"
COUNTERS = {"labels.HOST_READS": ("gelly_streaming_tpu_torch.summaries.labels", "HOST_READS")}


def read(t):
    n = t["counters"].get("labels.HOST_READS")
    if n is None or not t["windows"]:
        return None
    return n / t["windows"]
