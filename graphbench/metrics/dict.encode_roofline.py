"""The device dictionary's share of its roofline, in %: the least time
any encode of the traced windows could take, over ``dict.encode_ms``.

Byte rule (a bound by memory; an encode does no arithmetic to speak of):
a window of ``E`` edges reads its ``2 E`` raw int32 ids and writes ``2 E``
compact int32 ids (``16 E`` bytes), and the ids it sees first enter the
table as a key, an id and a reverse entry (``12`` bytes each). At one
H100 SXM's 3.35 TB/s (700 W; the run's card and power limit stand beside
it in PERF.md). The table's capacity is left out: a lookup need not read
the whole table, so counting it would bound one design and not the work.
"""

UNIT = "%"
RANGES = ("dict.encode",)
HBM_BYTES_PER_S = 3.35e12


def read(t):
    ms = t["ranges_ms"].get("dict.encode")
    sizes = t["sizes"]
    if not ms or "new_ids" not in sizes:
        return None
    nbytes = sum(16 * e for e in sizes["window_edges"]) + 12 * sum(sizes["new_ids"])
    return 100.0 * (nbytes / HBM_BYTES_PER_S * 1e3) / ms
