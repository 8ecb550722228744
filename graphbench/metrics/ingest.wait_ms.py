"""Host ms a window that the consuming thread waited for the prefetch
producer (the registry's ``pipeline.consumer_idle_s``, counted while
tracing is on): the time the ingest side held the job up. Moves
``edges_per_s``; read only where the cell's stream is prefetched."""

UNIT = "ms"
REGISTRY = ("pipeline.consumer_idle_s",)


def read(t):
    idle = t["registry"].get("pipeline.consumer_idle_s")
    if idle is None or not t["windows"]:
        return None
    return idle * 1e3 / t["windows"]
