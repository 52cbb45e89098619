"""pair_popcount: popcount(a & b) a row, (N, W) x 2 → (N,)."""

KERNEL = "pair_popcount"
SYMBOLS = ("pair_popcount_kernel",)


def cost(a, b):
    n, w = a.shape
    return {"bytes": 2 * n * w * 4 + n * 4, "ops": 3 * n * w}


WRAPPERS = {"pair_popcount": cost}
