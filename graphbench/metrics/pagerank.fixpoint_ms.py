"""Device ms a window of the hand-written fixpoint kernel
(``csrc/pagerank.cu:pagerank_fixpoint``), taken by the kernel's name: its
ctypes launch sits under no PyTorch range. Moves ``edges_per_s``."""

UNIT = "ms"
KERNELS = ("pagerank_fixpoint",)


def read(t):
    n, ms = t["kernels_ms"].get("pagerank_fixpoint", (0, 0.0))
    if not n or not t["windows"]:
        return None
    return ms / t["windows"]
