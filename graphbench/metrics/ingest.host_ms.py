"""Host ms a window of the program's spans on the ingest side: the read of
each chunk (``ingest.parse``; on the ``.gbin`` path a memmap slice) and,
on the host-windowed paths, the window packing (``window.pack``). Spans
of every thread count (the prefetch producer's). Moves ``edges_per_s``."""

UNIT = "ms"
SPANS = ("ingest.parse", "window.pack")


def read(t):
    rows = [t["spans"][s] for s in SPANS if s in t["spans"]]
    if not rows or not t["windows"]:
        return None
    return sum(sec for _, sec in rows) * 1e3 / t["windows"]
