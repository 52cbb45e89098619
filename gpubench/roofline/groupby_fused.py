"""groupby_fused: the one-pass GroupBy histogram over a dense code space
(and, through it, bsi_value_hist)."""

from gpubench.roofline import shards_read

KERNEL = "groupby_fused"
SYMBOLS = ("groupby_joint_kernel", "groupby_table_kernel")


def hist_cost(code_planes, valid, planes=None, n_codes=1, signed=True,
              minmax=False):
    # code planes, the valid plane and the BSI stack (its exists and
    # magnitude planes, the sign plane only when signed) read once, the
    # (2 + d or 2 + 2d, G) table written once, and the (4, G) Min/Max
    # table; one operation a word read.  The histogram's increments,
    # one an operation, depend on the data and are left out: the byte
    # term binds the bound by far at these widths
    s, cb, w = code_planes.shape
    d = 0 if planes is None else planes.shape[1] - 2
    rows = shards_read(code_planes) * cb + shards_read(valid)
    if d:
        rows += shards_read(planes) * (1 + d + int(bool(signed)))
        table = 2 + d if not signed else 2 + 2 * d
    else:
        table = 1
    nbytes = rows * w * 4 + table * int(n_codes) * 4
    if minmax:
        nbytes += 4 * int(n_codes) * 4
    return {"bytes": nbytes, "ops": rows * w}


WRAPPERS = {"groupby_fused": hist_cost}
