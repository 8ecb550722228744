"""Mean ms from a window's cut (the program has read its last edge) to its
fold's completion on the card, both on the tracer's shared clock (events
``window.latency``, one a window, ``obs/trace.py:window_done``). A mean,
since the span sink keeps totals. Moves ``edges_per_s``."""

UNIT = "ms"
SPAN = "window.latency"


def read(t):
    row = t["spans"].get(SPAN)
    if row is None or not row[0]:
        return None
    return row[1] * 1e3 / row[0]
