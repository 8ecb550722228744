"""The whole step's model FLOP/s over the card's peak, in %: the traced
windows' model operations over the traced window's length times 989
TFLOP/s (one H100 SXM, bf16, dense, 700 W).

Model operations of a window over ``V`` ids, a layer of widths ``F -> O``
at a time (the configuration's published widths): ``4 V F O`` for the two
products, and ``F`` adds for each message the layer aggregates. The
messages are the program's counter ``models/graphsage.MESSAGES_AGGREGATED``
over the traced pass: every layer aggregates the same messages, so each
counts its layers' mean input width. Moves ``edges_per_s``.
"""

UNIT = "%"
BF16_FLOP_PER_S = 989e12
COUNTERS = {"graphsage.MESSAGES_AGGREGATED": (
    "gelly_streaming_tpu_torch.models.graphsage", "MESSAGES_AGGREGATED")}


def step_flops(windows: int, v: int, messages: int, dims) -> float:
    """Model operations of ``windows`` windows over ``v`` ids whose layers
    aggregated ``messages`` messages in all."""
    products = windows * sum(4 * v * f * o for f, o in zip(dims[:-1], dims[1:]))
    return products + messages * sum(dims[:-1]) / (len(dims) - 1)


def read(t):
    sizes = t["sizes"]
    messages = t["counters"].get("graphsage.MESSAGES_AGGREGATED")
    if "dims" not in sizes or not messages or not t["windows"] or not t["window_s"]:
        return None
    flops = step_flops(t["windows"], sizes["vertices"], messages, sizes["dims"])
    return 100.0 * flops / (t["window_s"] * BF16_FLOP_PER_S)
