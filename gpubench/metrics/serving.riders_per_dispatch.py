"""Queries answered through a serving batch (flight route ``fused``),
a serving-path device dispatch (``pilosa_serving_dispatch_total``)."""


def read(b):
    n = b.counters["dispatches"]
    return b.counters["served"]["fused"] / n if n else None
