"""The share of the window's device-idle time in which the interpreter's
garbage collector ran, in %: the passes the program's collector hook
keeps in its ring (``obs/runtime.py``, on ``perf_counter``) laid over
the complement of the profiler's device intervals.  A pass stops every
Python thread, so the card idles through it unless work was already
queued."""

from gpubench.trace import _union


def read(b):
    try:
        from pilosa_tpu_torch.obs import runtime
    except ImportError:
        return None
    w = b.window
    if not b.device or not runtime.installed():
        return None
    passes = runtime.passes(w.begin)
    if passes is None:
        return None
    busy = _union([[max(s, w.begin), min(e, w.end)]
                   for _, s, e in b.device if e > w.begin and s < w.end])
    idle, t = [], w.begin
    for s, e in busy:
        if s > t:
            idle.append((t, s))
        t = max(t, e)
    if t < w.end:
        idle.append((t, w.end))
    idle_s = sum(e - s for s, e in idle)
    if idle_s <= 0:
        return None
    gc = _union([[max(s, w.begin), min(e, w.end)] for s, e, _g in passes
                 if e > w.begin and s < w.end])
    covered = 0.0
    i = 0
    for s, e in gc:
        while i < len(idle) and idle[i][1] <= s:
            i += 1
        j = i
        while j < len(idle) and idle[j][0] < e:
            covered += max(0.0, min(e, idle[j][1]) - max(s, idle[j][0]))
            j += 1
    return 100.0 * covered / idle_s
