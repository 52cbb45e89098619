"""segment_count: popcounts of a bucket's lanes summed by segment."""

KERNEL = "segment_count"
SYMBOLS = ("segment_count_kernel",)


def _nbytes(t, n: int) -> int:
    return t.numel() * t.element_size() if hasattr(t, "element_size") \
        else n * 8


def cost(pages, lane_idx, seg_ids, nseg, table=None):
    w = int(pages[0].shape[1])
    n = len(lane_idx)
    return {"bytes": n * w * 4 + _nbytes(lane_idx, n) + _nbytes(seg_ids, n)
            + int(nseg) * 8,
            "ops": 2 * n * w, "popcs": n * w}


WRAPPERS = {"segment_count": cost}
