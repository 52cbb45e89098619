"""The share of the window in which the audit plane ran a shadow
execution (``obs/audit.py``: a sampled read re-run on the per-shard
engine), in %: the host and device time the node's default audit takes
beside the clients' requests.  0 where the audit ran none."""


def read(b):
    return 100.0 * b.audit_s / b.window_s if b.window_s > 0 else None
