"""The share of the port kernels' device time that ``kernels.roofline``
covers, in %: below 100 where a kernel's launches and its records in
the trace do not match one for one and it is left out."""

from gpubench.metrics import roofline_terms


def read(b):
    _least, matched, every, _out = roofline_terms(b)
    return 100.0 * matched / every if every > 0 else None
