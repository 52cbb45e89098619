"""groupby_onehot: groupby_fused's histogram on the int8 tensor cores.
It computes the same function, so its bound is groupby_fused's."""

from gpubench.roofline.groupby_fused import hist_cost

KERNEL = "groupby_onehot"
SYMBOLS = ("groupby_onehot_kernel",)


def cost(code_planes, valid, planes=None, n_codes=1, signed=True):
    return hist_cost(code_planes, valid, planes, n_codes, signed)


WRAPPERS = {"groupby_onehot": cost}
