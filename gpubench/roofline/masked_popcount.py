"""masked_popcount: one filter for every row of one shard, or one launch
over every shard's row tiles (the per-shard TopN/TopK)."""

KERNEL = "masked_popcount"
SYMBOLS = ("masked_popcount_kernel",)


def cost_rows(x, mask):
    n, w = x.shape
    return {"bytes": (n + 1) * w * 4 + n * 4, "ops": 3 * n * w}


def cost_shards(tiles, masks, n_rows, words, device):
    # every tile and filter read once, the address table (8 bytes an
    # entry and a shard's filter slot), the int64 counts; bit operations
    # a row and word: the views' OR, the AND where filtered, the
    # popcount's add, and a popcount each
    s = len(tiles)
    v = len(tiles[0]) if s else 0
    held = sum(1 for shard in tiles for view in shard if view is not None)
    filters = 0 if masks is None else sum(m is not None for m in masks)
    rows = held * n_rows
    return {"bytes": (rows + filters) * words * 4 + (s * v * n_rows + s) * 8
            + n_rows * 8,
            "ops": (v + (1 if filters else 0) + 1) * rows * words
            if rows else 0,
            "popcs": rows * words}


WRAPPERS = {"masked_popcount": cost_rows,
            "masked_popcount_shards": cost_shards}
