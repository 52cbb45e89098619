"""Mean milliseconds a query spent getting its stacks (the flight
phases ``stack_hit``, ``stack_patch``, ``stack_rebuild``,
``stack_wait``)."""

from gpubench.metrics import phase_mean_ms


def read(b):
    return phase_mean_ms(b, ("stack_hit", "stack_patch", "stack_rebuild",
                             "stack_wait"))
