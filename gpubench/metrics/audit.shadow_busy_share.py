"""The share of the window in which the audit plane ran a shadow
execution, in %, from the program's own count
(``obs/audit.py``'s ``shadow_seconds``: finished shadows' seconds and
the running ones' up to a given time) read at the window's ends; the
benchmark-side timing of the same thing is ``audit.shadow_share``."""


def read(b):
    try:
        from pilosa_tpu_torch.obs.audit import shadow_seconds
    except ImportError:
        return None
    w = b.window
    if w.seconds <= 0:
        return None
    return 100.0 * (shadow_seconds(w.end) - shadow_seconds(w.begin)) \
        / w.seconds
