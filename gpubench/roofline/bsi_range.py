"""bsi_range: the columns whose BSI value satisfies a comparison,
(S, 2+d, W) → (S, W) words."""

from gpubench.roofline import shards_read

KERNEL = "bsi_range"
SYMBOLS = ("bsi_range_kernel",)


def cost(planes, op, p, q=None, p_neg=False, q_neg=False):
    s, pl, w = planes.shape
    npred = 2 if op == "between" else 1
    # every plane read once, the row written once; ~6 operations a
    # plane a word a predicate, and the final combination
    return {"bytes": shards_read(planes) * pl * w * 4 + s * w * 4,
            "ops": (6 * (pl - 2) * npred + 6) * s * w}


WRAPPERS = {"bsi_range": cost}
