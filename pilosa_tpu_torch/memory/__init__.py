"""Device residency: one budget for every owner of device bytes.

The port of ``pilosa_tpu/memory``.  The card's memory is shared by
every cache of the process; each cache registers as a *client* of one
process-wide :class:`~pilosa_tpu_torch.memory.ledger.Ledger` and
reserves and releases its device bytes through it, so pressure in one
cache reclaims cold bytes in another through the clients' reclaim
callbacks.  The clients are the stacked engine's ``StackCache``
(``"stack_cache"``) and the per-shard engine's tiles (``"tile_cache"``).

Pieces:

- ``ledger.py``   — the budget ledger (accounting, cross-client reclaim)
- ``pages.py``    — paged stacks: fixed-size lane-block pages, evicted,
  rebuilt and patched each on its own, and assembled into a query's
  operand by one ``assemble_pages`` launch
- ``encode.py``   — sparse page encodings (packed coordinates, runs)
- ``policy.py``   — cost-aware eviction scoring and the prefetcher fed by
  the flight recorder
- ``pressure.py`` — the OOM ladder: relief sweep, one retry, then the
  plan on the host
- ``placement.py`` — the serving mesh's shard-to-slot placement, which
  gives paged stacks their device axis

The settings go through :func:`configure` only; the port reads no
environment variable for them (the JAX package's
``PILOSA_TPU_MEMORY_*`` twins do not reach it).
"""

from __future__ import annotations

import threading

from pilosa_tpu_torch.memory.ledger import Ledger

_DEFAULT_PAGE_BYTES = 4 << 20

_lock = threading.Lock()
_global: Ledger | None = None
_paged_default = True
_page_bytes_default = _DEFAULT_PAGE_BYTES


def ledger() -> Ledger:
    """The process-wide budget ledger (created on first use)."""
    global _global
    with _lock:
        if _global is None:
            _global = Ledger()
        return _global


def configure(budget_bytes: int | None = None,
              headroom_frac: float | None = None,
              page_bytes: int | None = None,
              paged: bool | None = None,
              oom_retry: bool | None = None,
              host_fallback: bool | None = None) -> Ledger:
    """Set the memory switches; None leaves a switch as it is.
    ``budget_bytes=0`` means detect the budget from the card."""
    global _paged_default, _page_bytes_default
    led = ledger()
    if headroom_frac is not None:
        led.headroom_frac = float(headroom_frac)
    if budget_bytes is not None:
        led.set_budget(int(budget_bytes) if budget_bytes else None)
    if page_bytes is not None and int(page_bytes) > 0:
        _page_bytes_default = int(page_bytes)
    if paged is not None:
        _paged_default = bool(paged)
    if oom_retry is not None or host_fallback is not None:
        from pilosa_tpu_torch.memory import pressure
        if oom_retry is not None:
            pressure.OOM_RETRY = bool(oom_retry)
        if host_fallback is not None:
            pressure.HOST_FALLBACK = bool(host_fallback)
    return led


def paged_enabled() -> bool:
    """Paged stack-cache entries on or off (off keeps whole stacks)."""
    return _paged_default


def page_bytes() -> int:
    """The page size in bytes.  A page spans whole lanes of a stack's
    flattened leading axes."""
    return _page_bytes_default
