"""The share of the traced window in which no kernel, copy or set ran on
the card: 1 - ``busy_s`` / ``window_s``. Moves ``edges_per_s``."""

UNIT = "ratio"


def read(t):
    if not t["busy_s"] or not t["window_s"]:
        return None
    return 1.0 - t["busy_s"] / t["window_s"]
