"""Device ms a window of the kernels launched under the program's
``dict.encode`` range (``ops/device_dict.py:encode_batch``, run on the
prefetch thread; read only where the profiler sees every thread). Moves
``edges_per_s``."""

UNIT = "ms"
RANGES = ("dict.encode",)


def read(t):
    ms = t["ranges_ms"].get("dict.encode")
    if not ms or not t["windows"]:
        return None
    return ms / t["windows"]
