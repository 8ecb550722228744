"""Host ms a window of the upload's host side (spans ``window.upload``,
one a ``core/edgeblock.py:to_device`` call: the copy into pinned memory and
the enqueue of the copy to the card), on whichever thread builds the
window (the prefetch producer's). Moves ``edges_per_s``."""

UNIT = "ms"
SPAN = "window.upload"


def read(t):
    row = t["spans"].get(SPAN)
    if row is None or not t["windows"]:
        return None
    return row[1] * 1e3 / t["windows"]
