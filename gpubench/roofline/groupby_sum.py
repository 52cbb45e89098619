"""groupby_sum: per-combo GroupBy counts and Sum partials over
nf stacks (R_f, S, W) and a BSI stack (S, 2+d, W)."""

KERNEL = "groupby_sum"
SYMBOLS = ("groupby_sum_kernel",)


def cost(stacks, sel, planes=None, signed=True):
    stacks = list(stacks)
    _, s, w = stacks[0].shape
    c = sel.shape[0]
    d = 0 if planes is None else planes.shape[1] - 2
    # each stack row that sel names is read once; which rows it names is
    # on the device, so the least, one row a field, is counted
    rows = len(stacks) + ((1 + d + int(bool(signed))) if d else 0)
    out = c * (2 + 2 * d) * 4 if d else c * 4
    # bit operations a combo and word: the rows' AND, the exists AND
    # and a magnitude AND a plane (the sign split when signed);
    # popcounts: count, nn and one a plane a side
    ops = c * ((4 + 2 * d) if signed else (2 + d)) * s * w
    popcs = c * ((2 + 2 * d) if signed else (2 + d)) * s * w
    return {"bytes": rows * s * w * 4 + out, "ops": ops, "popcs": popcs}


WRAPPERS = {"groupby_sum": cost}
