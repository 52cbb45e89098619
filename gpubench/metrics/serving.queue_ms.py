"""Mean milliseconds a query sat in the serving batcher not covered by
a device phase of its batch (the flight phase ``wait``: the batch
window and the queue before the dispatch), over the window's flight
records."""

from gpubench.metrics import phase_mean_ms


def read(b):
    return phase_mean_ms(b, ("wait",))
