"""Host ms a window that the CC carry spends blocked in its counted host
reads (spans ``cc.host_read``, one a read of ``summaries/labels.py``: a
fixpoint turn's condition, a carry download), while the card finishes the
work before each read. Moves ``edges_per_s``."""

UNIT = "ms"
SPAN = "cc.host_read"


def read(t):
    row = t["spans"].get(SPAN)
    if row is None or not t["windows"]:
        return None
    return row[1] * 1e3 / t["windows"]
