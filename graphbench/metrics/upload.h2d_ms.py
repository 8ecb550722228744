"""Device ms a window of host-to-device copies (the profiler's ``Memcpy
HtoD`` records): the upload of each window's columns. Moves
``edges_per_s``."""

UNIT = "ms"


def read(t):
    if not t["windows"] or not t["h2d_ms"]:
        return None
    return t["h2d_ms"] / t["windows"]
