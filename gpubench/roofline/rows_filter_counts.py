"""rows_filter_counts: popcount(rows[r, s] & filt[s]), (R, S, W) &
(S, W) → (R, S)."""

KERNEL = "rows_filter_counts"
SYMBOLS = ("rows_filter_counts_kernel",)


def cost(rows, filt):
    r, s, w = rows.shape
    return {"bytes": (r + 1) * s * w * 4 + r * s * 4, "ops": 3 * r * s * w}


WRAPPERS = {"rows_filter_counts": cost}
