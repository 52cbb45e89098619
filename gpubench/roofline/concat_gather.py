"""concat_gather: lanes of a bucket of dense pages, gathered into an
(L, W) stack."""

KERNEL = "concat_gather"
SYMBOLS = ("concat_gather_kernel",)


def cost(pages, lane_idx, table=None):
    w = int(pages[0].shape[1])
    n = len(lane_idx)
    idx = lane_idx.numel() * lane_idx.element_size() \
        if hasattr(lane_idx, "element_size") else n * 8
    return {"bytes": 2 * n * w * 4 + idx}


WRAPPERS = {"concat_gather": cost}
