"""The share of the window in which no operation ran on the device:
1 minus the union of the profiler's device intervals over the window,
in %."""


def read(b):
    if not b.device:
        return None
    return 100.0 * (1.0 - b.busy_s / b.window_s)
