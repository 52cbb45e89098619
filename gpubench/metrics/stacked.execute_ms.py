"""Mean milliseconds of a query's stacked dispatch, launch to
``torch.cuda.synchronize`` (the flight phase ``execute``)."""

from gpubench.metrics import phase_mean_ms


def read(b):
    return phase_mean_ms(b, ("execute",))
