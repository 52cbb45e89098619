"""Milliseconds the serving batch leaders worked inside the window, a
query answered: the union of the ``serving.batch`` spans (queue flip to
the riders' release, on the leader's client thread) inside the window,
over the queries answered in it."""

from gpubench.trace import _union


def read(b):
    w = b.window
    spans = [[max(s, w.begin), min(e, w.end)] for name, s, e in b.spans
             if name == "serving.batch" and e > w.begin and s < w.end]
    if not spans or not b.answered:
        return None
    return sum(e - s for s, e in _union(spans)) * 1e3 / b.answered
