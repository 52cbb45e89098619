"""popcount_rows: (N, W) words → (N,) counts."""

KERNEL = "popcount_rows"
SYMBOLS = ("popcount_rows_kernel",)


def cost(x):
    n, w = x.shape
    # rows read once, a count written; an AND-free popcount and an add
    # a word
    return {"bytes": n * w * 4 + n * 4, "ops": 2 * n * w}


WRAPPERS = {"popcount_rows": cost}
