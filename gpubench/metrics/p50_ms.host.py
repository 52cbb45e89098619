"""The median latency of the traced window's requests, send to answer on
the client's thread, in ms (``loop.percentile``: a failed request ranks
above every answered one, and none is read where the median falls on
one): a cell whose card idles most of the window keeps its latencies
here, host-bound, with qps.host beside them."""

import math

from gpubench import loop


def read(b):
    v = loop.percentile(b.window, 0.50) * 1e3
    return v if b.window.requests and math.isfinite(v) else None
