"""The port kernels' share of their roofline over the window: the sum of
every launch's least time (``roofline/``: bytes at 3.35 TB/s against
its operations at their published rates) over the summed device time
of those launches (``torch.profiler``), in %.

A kernel whose launches the trace does not hold one for one is left out
of both sums (``metrics.roofline_terms``); ``kernels.roofline_cover``
gives the share of the port kernels' device time that stays in, and the
run's standard error names what was left out.  With none left there is
nothing to read."""

from gpubench.metrics import roofline_terms


def read(b):
    least, matched, _every, _out = roofline_terms(b)
    return 100.0 * least / matched if matched > 0 else None
