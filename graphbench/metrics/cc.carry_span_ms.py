"""Stream ms a window of the CC carry, from the program's own device span
(``engine.dispatch.device``: CUDA events at the dense carry's first and
last launch, ``obs/trace.py``). Unlike ``cc.carry_ms`` (the kernels under
the range) it holds the card's idle time inside the carry, after each host
read returns and before the next launch, and any encode the prefetch
producer puts on the same stream meanwhile. Moves ``edges_per_s``."""

UNIT = "ms"
SPAN = "engine.dispatch.device"


def read(t):
    row = t["spans"].get(SPAN)
    if row is None or not t["windows"]:
        return None
    return row[1] * 1e3 / t["windows"]
