"""Eviction scoring and the prefetcher fed by the flight recorder.

Eviction is cost-aware, not pure LRU: a page that is cheap to build
again (one fragment row read, one page upload) leaves before a
group-code page of the same age (its lanes OR many rows a word).  The
score is age / (rebuild weight x frequency segment); the highest score
is evicted first.  The frequency term is segmented: pages touched once
are fair game, pages with repeated hits get a bounded boost.

The prefetcher closes the loop with the flight recorder
(obs/flight.py): every stack access that is not a hit stamps its key's
fingerprint and outcome into the query's record, so "keys that keep
getting rebuilt" is a scan of the ring.  ``step()`` warms those keys'
missing pages off the query path, and only while the ledger has real
headroom (warming under pressure would evict the pages queries use)."""

from __future__ import annotations

import math
import threading
import time

from pilosa_tpu_torch.obs import metrics

# prefetch only while this share of the budget is free
MIN_FREE_FRAC = 0.25
# outcomes that mark a key the cache keeps losing
_WARM_OUTCOMES = ("rebuild", "page_rebuild", "patch")


def evict_score(age_s: float, weight: float, hits: int) -> float:
    """Higher is evicted sooner.  ``weight`` is the rebuild cost per
    byte against a plain row stack; ``hits`` feeds the bounded,
    log-damped frequency segment."""
    freq = 1.0 + min(math.log1p(hits), 3.0)
    return max(age_s, 1e-9) / (max(weight, 1e-6) * freq)


def victim_order(candidates: list, now: float | None = None) -> list:
    """(last_access, weight, hits, payload) tuples, most evictable
    first."""
    now = time.time() if now is None else now
    return sorted(candidates,
                  key=lambda c: evict_score(now - c[0], c[1], c[2]),
                  reverse=True)


class Prefetcher:
    """Warms predicted stack pages from the flight recorder's history.

    ``step()`` is one synchronous pass; ``start()`` runs it on a daemon
    thread every ``interval_s``.  The cache side is
    ``StackCache.prewarm(fp)``, which replays the recorded recipe of a
    key fingerprint when its entry is missing pages.  A ``prewarm`` that
    raises is counted as ``outcome="error"`` and the pass goes on."""

    def __init__(self, cache, recorder=None, ledger=None,
                 interval_s: float = 0.5, max_warm: int = 4,
                 window: int = 256):
        from pilosa_tpu_torch import memory
        from pilosa_tpu_torch.obs import flight
        self.cache = cache
        self.recorder = flight.recorder if recorder is None else recorder
        self.ledger = memory.ledger() if ledger is None else ledger
        self.interval_s = float(interval_s)
        self.max_warm = int(max_warm)
        self.window = int(window)
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def step(self) -> int:
        """One prediction and warm pass; returns the keys warmed."""
        budget = self.ledger.budget()
        counts: dict[str, int] = {}
        for rec in self.recorder.recent(self.window):
            for fp, outcome in rec.get("stack_keys", ()):
                if outcome in _WARM_OUTCOMES:
                    counts[fp] = counts.get(fp, 0) + 1
        warmed = 0
        for fp, _n in sorted(counts.items(), key=lambda kv: -kv[1]):
            if warmed >= self.max_warm:
                break
            if self.ledger.free_bytes() < MIN_FREE_FRAC * budget:
                metrics.PREFETCH_TOTAL.inc(outcome="skipped_pressure")
                break
            try:
                hit = self.cache.prewarm(fp)
            except Exception:
                metrics.PREFETCH_TOTAL.inc(outcome="error")
                continue
            if hit:
                warmed += 1
                metrics.PREFETCH_TOTAL.inc(outcome="warmed")
            else:
                metrics.PREFETCH_TOTAL.inc(outcome="noop")
        return warmed

    def start(self):
        if self._thread is not None:
            return self
        self._stop.clear()

        def loop():
            while not self._stop.wait(self.interval_s):
                try:
                    self.step()
                except Exception:
                    pass  # speculative work never ends the loop

        self._thread = threading.Thread(
            target=loop, name="pilosa-prefetch", daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=2.0)
