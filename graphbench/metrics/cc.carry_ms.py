"""Device ms a window of the kernels launched under the program's
``engine.dispatch`` range: the dense carry's fold and combine
(``aggregate/summary.py``, ``summaries/labels.py``). Moves
``edges_per_s``."""

UNIT = "ms"
RANGES = ("engine.dispatch",)


def read(t):
    ms = t["ranges_ms"].get("engine.dispatch")
    if not ms or not t["windows"]:
        return None
    return ms / t["windows"]
