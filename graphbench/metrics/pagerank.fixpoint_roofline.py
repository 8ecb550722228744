"""The fixpoint kernel's share of its roofline, in %: the least time the
traced windows' fixpoints could take, over their kernel time.

Byte rule (a bound by memory): a window's fixpoint reads each held edge
once (two int32 ids, ``8 E`` bytes over the ``E`` edges held after the
window) and reads and writes each rank once (float32, ``8 V`` bytes over
the ``V`` vertices below one more than the largest id held). The
iterations re-read the edges; the bound counts them once. At one H100
SXM's 3.35 TB/s (700 W; the run's card and power limit stand beside it in
PERF.md).
"""

UNIT = "%"
KERNELS = ("pagerank_fixpoint",)
HBM_BYTES_PER_S = 3.35e12


def read(t):
    n, ms = t["kernels_ms"].get("pagerank_fixpoint", (0, 0.0))
    sizes = t["sizes"]
    if not n or "held_edges" not in sizes:
        return None
    nbytes = sum(8 * e + 8 * v for e, v in zip(sizes["held_edges"], sizes["vertices"]))
    return 100.0 * (nbytes / HBM_BYTES_PER_S * 1e3) / ms
