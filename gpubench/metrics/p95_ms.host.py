"""The 95th percentile (nearest rank) of the traced window's request
latencies, in ms; see p50_ms.host."""

import math

from gpubench import loop


def read(b):
    v = loop.percentile(b.window, 0.95) * 1e3
    return v if b.window.requests and math.isfinite(v) else None
