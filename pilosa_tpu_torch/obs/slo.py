"""SLO burn-rate plane — multi-window error-budget math over the
metrics the engine already exports.

Two config-defined SLOs ([slo] in config.py):

- **latency**: fraction of queries answering under ``latency-ms``
  must stay >= ``latency-objective``.  Good/total derive from the
  ``pilosa_query_duration_seconds`` histogram (bucket-interpolated
  count-at-threshold — the histogram is observed on both the solo and
  serving paths).
- **availability**: fraction of requests NOT failing with a typed
  serving error must stay >= ``availability-objective``.  Bad events
  sum the typed-error counters the earlier PRs planted: 503 sheds
  (``pilosa_serving_admission_total{outcome=shed}``, cluster
  ``load_shed``, ingest backpressure), 504 deadlines
  (``outcome=expired``), and served-partial cluster results
  (``pilosa_cluster_events_total{event=partial}`` — degraded answers
  spend error budget too).

Burn rate follows the SRE-workbook convention: over each window W,
``burn = bad_fraction / (1 - objective)`` — 1.0 means spending budget
exactly at the sustainable rate, 14.4 on a 5 m window is the classic
page-now threshold.  The tracker keeps a ring of cumulative-counter
samples (the maintenance ticker feeds it; ``/debug/slo`` and
``/metrics`` renders sample on demand too) and diffs the newest
sample against the oldest one inside each window, so the cumulative
counters never need to reset.

Exported at ``/debug/slo`` (JSON payload below) and as gauges
``pilosa_slo_burn_rate{slo,window}`` /
``pilosa_slo_error_budget_remaining{slo}`` (longest window).
"""

from __future__ import annotations

import threading
import time
from collections import deque

_UNITS = {"s": 1.0, "m": 60.0, "h": 3600.0, "d": 86400.0}


def parse_windows(spec: str) -> list[tuple[str, float]]:
    """'5m,1h,6h' (or bare seconds '300,3600') -> [(label, s), ...],
    sorted ascending; junk entries are dropped rather than raising —
    a typo'd window must not take the server down."""
    out = []
    for part in (spec or "").split(","):
        part = part.strip()
        if not part:
            continue
        unit = 1.0
        if part[-1].lower() in _UNITS:
            unit = _UNITS[part[-1].lower()]
            num = part[:-1]
        else:
            num = part
        try:
            secs = float(num) * unit
        except ValueError:
            continue
        if secs > 0:
            out.append((part, secs))
    out.sort(key=lambda p: p[1])
    return out or [("5m", 300.0), ("1h", 3600.0), ("6h", 21600.0)]


class SloTracker:
    """Ring of cumulative samples + multi-window burn-rate math."""

    def __init__(self, latency_ms: float = 250.0,
                 latency_objective: float = 0.99,
                 availability_objective: float = 0.999,
                 windows: str = "5m,1h,6h"):
        self.latency_ms = float(latency_ms)
        self.latency_objective = float(latency_objective)
        self.availability_objective = float(availability_objective)
        self.windows = parse_windows(windows)
        # (t, total, lat_good, raised, degraded) cumulative readings,
        # oldest first
        self._samples: deque[tuple] = deque(maxlen=8192)
        self._lock = threading.Lock()
        self._t0 = time.time()

    # -- cumulative readings -------------------------------------------

    def _read(self) -> tuple[float, float, float, float, float]:
        """One cumulative reading of (now, total requests, requests
        under the latency threshold, RAISED typed errors, DEGRADED
        served answers).  Raised errors (sheds, expired deadlines)
        abort before the latency histogram observes, so they extend
        the request denominator; degraded answers (partial results)
        complete normally and are already inside ``total`` — keeping
        the two separate stops a partial from double-counting in the
        denominator.  Overridable test seam."""
        from pilosa_tpu_torch.obs import metrics
        h = metrics.QUERY_DURATION
        total = float(h.count())
        good = h.count_le(self.latency_ms / 1e3)
        raised = (metrics.ADMISSION_TOTAL.total(outcome="shed")
                  + metrics.ADMISSION_TOTAL.total(outcome="expired")
                  + metrics.CLUSTER_EVENTS.value(event="load_shed")
                  + metrics.INGEST_SHED.total())
        degraded = metrics.CLUSTER_EVENTS.value(event="partial")
        return time.time(), total, good, raised, degraded

    def sample(self):
        """Record one cumulative reading (maintenance ticker +
        on-demand before every evaluation)."""
        s = self._read()
        with self._lock:
            self._samples.append(s)

    # -- burn-rate evaluation ------------------------------------------

    def _window_delta(self, now: float, secs: float):
        """Delta vs the OLDEST sample inside the window.  ``covered``
        is derived from the BASE SAMPLE'S AGE (>=90% of the window),
        not tracker uptime: ring eviction under a fast poller can
        leave only recent samples, and a burn rate computed over a
        silently shorter span must say so."""
        with self._lock:
            base = None
            for s in self._samples:
                if s[0] >= now - secs:
                    base = s
                    break
            newest = self._samples[-1] if self._samples else None
        if base is None or newest is None:
            return None, False
        covered = (now - base[0]) >= 0.9 * secs
        return tuple(n - b for n, b in zip(newest[1:], base[1:])), covered

    def evaluate(self) -> dict:
        """Sample + compute burn rates; updates the SLO gauges and
        returns the /debug/slo payload."""
        from pilosa_tpu_torch.obs import metrics
        self.sample()
        now = time.time()
        budgets = {
            "latency": max(1.0 - self.latency_objective, 1e-9),
            "availability": max(1.0 - self.availability_objective,
                                1e-9),
        }
        slos: dict[str, dict] = {
            "latency": {"objective": self.latency_objective,
                        "threshold_ms": self.latency_ms,
                        "windows": {}},
            "availability": {"objective": self.availability_objective,
                             "windows": {}},
        }
        for label, secs in self.windows:
            delta, covered = self._window_delta(now, secs)
            if delta is None:
                continue
            d_total, d_good, d_raised, d_degraded = delta
            # latency: of the queries that completed, how many blew
            # the threshold
            lat_bad = max(d_total - d_good, 0.0)
            lat_frac = lat_bad / d_total if d_total > 0 else 0.0
            # availability: raised errors never reached the latency
            # histogram, so they extend the denominator; degraded
            # (partial) answers completed and already sit inside
            # d_total — they add only to the numerator
            d_bad = d_raised + d_degraded
            denom = d_total + d_raised
            avail_frac = d_bad / denom if denom > 0 else 0.0
            for name, frac, bad, total in (
                    ("latency", lat_frac, lat_bad, d_total),
                    ("availability", avail_frac, d_bad, denom)):
                burn = frac / budgets[name]
                slos[name]["windows"][label] = {
                    "burn_rate": round(burn, 4),
                    "bad": round(bad, 1),
                    "total": round(total, 1),
                    "window_covered": covered,
                }
                metrics.SLO_BURN_RATE.set(burn, slo=name, window=label)
        # budget remaining over the LONGEST window
        longest = self.windows[-1][0]
        for name in ("latency", "availability"):
            w = slos[name]["windows"].get(longest)
            if w is not None:
                remaining = max(0.0, 1.0 - w["burn_rate"])
                slos[name]["budget_remaining"] = round(remaining, 4)
                metrics.SLO_BUDGET_REMAINING.set(remaining, slo=name)
        payload = {"slos": slos,
                   "windows": [label for label, _ in self.windows],
                   "samples": len(self._samples),
                   "uptime_s": round(now - self._t0, 1)}
        # incident trigger (obs/incidents.py): a burn rate at/over
        # the configured threshold on a COVERED window captures one
        # rate-limited black-box bundle — detection becomes evidence
        from pilosa_tpu_torch.obs import incidents
        incidents.note_slo(payload)
        return payload


# process-global tracker; config.apply_slo_settings() rebuilds it
tracker: SloTracker | None = None
_lock = threading.Lock()


def configure(latency_ms: float = 250.0, latency_objective: float = 0.99,
              availability_objective: float = 0.999,
              windows: str = "5m,1h,6h") -> SloTracker:
    global tracker
    with _lock:
        tracker = SloTracker(latency_ms, latency_objective,
                             availability_objective, windows)
    return tracker


def get() -> SloTracker:
    global tracker
    with _lock:
        if tracker is None:
            tracker = SloTracker()
        return tracker


def tick():
    """Maintenance-ticker hook (server/http.py): sample + refresh the
    burn-rate gauges."""
    try:
        get().evaluate()
    except Exception:
        pass  # the SLO plane must never take the ticker down
