"""bsi_sum_counts: a filtered count and sign-split per-plane popcounts of
a BSI stack (S, 2+d, W); at shard stride 0, one shard's planes against S
filters on the tensor cores."""

from gpubench.roofline import shards_read

KERNEL = "bsi_sum_counts"
SYMBOLS = ("bsi_sum_counts_kernel",)


def cost(planes, filt=None):
    s, p, w = planes.shape
    d = p - 2
    out = s * (1 + 2 * d) * 4
    if planes.stride(0) == 0:
        # mma .b1 .and.popc: an AND and an add a bit product, of each
        # filter's positive and negative masks with the d planes and the
        # count's all-ones column; ~4 bit operations a word build them
        return {"bytes": p * w * 4 + (s * w * 4 if filt is not None else 0)
                + out,
                "ops": 4 * s * w,
                "tensor_ops": 2 * s * w * 32 * 2 * (d + 1)}
    if filt is None:
        return {"bytes": p * s * w * 4 + out, "ops": (4 + 6 * d) * s * w,
                "popcs": (1 + 2 * d) * s * w}
    return {"bytes": (p + 1) * shards_read(planes) * w * 4 + out,
            "ops": (5 + 6 * d) * s * w, "popcs": (1 + 2 * d) * s * w}


WRAPPERS = {"bsi_sum_counts": cost}
