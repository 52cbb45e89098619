"""Mean milliseconds a query spent building its stacked plan (the
flight phase ``plan_build``)."""

from gpubench.metrics import phase_mean_ms


def read(b):
    return phase_mean_ms(b, ("plan_build",))
