"""Resource leak auditor — the testhook/ analog (testhook/hook.go,
registry.go, auditor.go: opened/closed resource tracking consulted by
tests, e.g. executor.go:144).

Opt-in via ``PILOSA_TPU_TESTHOOK=1`` (the reference gates its hooks
behind build tags the same way): when disabled, ``opened``/``closed``
are no-ops costing one attribute read.  When enabled, every tracked
resource kind keeps a live table of (id, description, stack-summary);
``audit()`` returns what is still open, and the test suite's session
teardown asserts it is empty.

Tracked kinds (wired at the resource's open/close sites):
``rbf.DB``, ``http.Server``, ``spill.SpillSet``.
"""

from __future__ import annotations

import os
import threading
import traceback

ENABLED = os.environ.get("PILOSA_TPU_TESTHOOK") == "1"

_lock = threading.Lock()
# kind -> id(obj) -> (obj, description, opening stack summary).  The
# object itself is kept (strong ref) so a leaked resource cannot be
# garbage-collected and have its id() reused by a later open —
# which would overwrite the leaked entry and mask the leak.
_live: dict[str, dict[int, tuple[object, str, str]]] = {}


def opened(kind: str, obj, description: str = "") -> None:
    if not ENABLED:
        return
    # innermost few non-testhook frames: enough to find the leak site
    stack = "".join(traceback.format_stack(limit=6)[:-1])
    with _lock:
        _live.setdefault(kind, {})[id(obj)] = (
            obj, description or repr(obj), stack)


def closed(kind: str, obj) -> None:
    if not ENABLED:
        return
    with _lock:
        _live.get(kind, {}).pop(id(obj), None)


def audit() -> dict[str, list[str]]:
    """kind -> descriptions of still-open resources."""
    with _lock:
        return {k: [d for _o, d, _s in v.values()]
                for k, v in _live.items() if v}


def audit_stacks() -> dict[str, list[str]]:
    """kind -> opening stacks of still-open resources (diagnosis)."""
    with _lock:
        return {k: [s for _o, _d, s in v.values()]
                for k, v in _live.items() if v}


def reset() -> None:
    with _lock:
        _live.clear()
