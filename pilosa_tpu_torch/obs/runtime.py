"""The interpreter's garbage collector, seen from the node.

A collection stops every Python thread of the process while it runs: a
full pass over a holder of a billion records' objects takes tenths of a
second, and the card idles through it.  ``install()`` (run when the
node's planes are configured, ``Config.apply_all``) hooks
``gc.callbacks`` once and keeps, for every pass:

- ``pilosa_gc_pause_seconds_total{generation}`` and
  ``pilosa_gc_passes_total{generation}``: two ``perf_counter`` reads
  and a float add a pass, with no lock (a lock taken inside a
  collection could be the one the collecting thread already holds);
- the pass's interval in a bounded ring (``passes``), so a reader can
  lay the passes of a past window against the device trace (both on
  ``perf_counter``).
"""

from __future__ import annotations

import gc
import time
from array import array

from pilosa_tpu_torch.obs import metrics

# the ring of recent passes: minutes of a busy serving node's collections
# (some hundreds a second)
RING = 1 << 17

_pause = [0.0, 0.0, 0.0]
_passes = [0, 0, 0]
_t0 = 0.0
_starts = array("d", bytes(8 * RING))
_ends = array("d", bytes(8 * RING))
_gens = bytearray(RING)
_n = 0                        # passes ever put in the ring


def _on_gc(phase: str, info: dict) -> None:
    global _t0, _n
    if phase == "start":
        _t0 = time.perf_counter()
        return
    t1 = time.perf_counter()
    g = info["generation"]
    _pause[g] += t1 - _t0
    _passes[g] += 1
    i = _n & (RING - 1)
    _starts[i] = _t0
    _ends[i] = t1
    _gens[i] = g
    _n += 1


def install() -> None:
    """Hook the collector (idempotent)."""
    if _on_gc not in gc.callbacks:
        gc.callbacks.append(_on_gc)


def installed() -> bool:
    return _on_gc in gc.callbacks


def pause_seconds() -> float:
    """Seconds the collector has run since the hook went in."""
    return sum(_pause)


def pass_count() -> int:
    return sum(_passes)


def passes(since: float) -> list | None:
    """(start, end, generation) of every pass that ended at or after
    ``since`` (``perf_counter``), oldest first; None when the ring no
    longer reaches back that far."""
    n = _n
    kept = min(n, RING)
    out = []
    for k in range(n - 1, n - kept - 1, -1):
        i = k & (RING - 1)
        if _ends[i] < since:
            return out[::-1]
        out.append((_starts[i], _ends[i], _gens[i]))
    return out[::-1] if n <= RING else None


def _read(values: list) -> dict:
    return {(("generation", str(g)),): float(v)
            for g, v in enumerate(values) if v}


metrics.GC_PAUSE.bind(lambda: _read(_pause))
metrics.GC_PASSES.bind(lambda: _read(_passes))
