"""The dense half's share of its roofline, in %: the least time the traced
windows' ``fused_sage_matmul`` launches could take, over their kernel time
(``csrc/fused_sage_matmul.cu``, both kernels taken by name: the ctypes
launch sits under no PyTorch range).

Rule a layer (``V`` ids, ``F`` in, ``O`` out, the configuration's published
widths, not the kernel's padded ones): bfloat16 ``h`` and ``agg`` read once,
the two weight matrices and the bias read once, the output written once,
``2 (2 V F + 2 F O + O + V O)`` bytes at 3.35 TB/s; ``4 V F O``
operations at 989 TFLOP/s (bf16, dense); the larger of the two. One H100
SXM at 700 W; the run's card and power limit stand beside it in PERF.md.
"""

UNIT = "%"
KERNELS = ("fused_sage_matmul_tc_kernel", "fused_sage_matmul_kernel")
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12


def layer_bytes(v: int, f: int, o: int) -> int:
    return 2 * (2 * v * f + 2 * f * o + o + v * o)


def layer_flops(v: int, f: int, o: int) -> int:
    return 4 * v * f * o


def bound_s(v: int, dims) -> float:
    """The least seconds of one window's launches, a layer at a time."""
    return sum(max(layer_bytes(v, f, o) / HBM_BYTES_PER_S,
                   layer_flops(v, f, o) / BF16_FLOP_PER_S)
               for f, o in zip(dims[:-1], dims[1:]))


def read(t):
    sizes = t["sizes"]
    if "dims" not in sizes or not sizes.get("held_edges"):
        return None
    runs = [t["kernels_ms"].get(k, (0, 0.0)) for k in KERNELS]
    n, ms = sum(r[0] for r in runs), sum(r[1] for r in runs)
    if not n or not ms:
        return None
    windows = len(sizes["held_edges"])
    return 100.0 * bound_s(sizes["vertices"], sizes["dims"]) * windows * 1e3 / ms
