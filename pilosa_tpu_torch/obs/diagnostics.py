"""Diagnostics + performance counters.

Reference: diagnostics.go:20,49 — a periodic collector of anonymized
runtime/host stats with a version check against a release endpoint
(phone-home is OFF unless a reporting URL is configured, matching the
reference's opt-out semantics under this build's zero-egress default);
performancecounters.go — named monotonic counters snapshotted for
operators; gopsutil/ — platform stats (psutil is unavailable, so the
collector reads /proc and the stdlib).
"""

from __future__ import annotations

import json
import os
import platform
import sys
import threading
import time


class Diagnostics:
    """diagnostics.Diagnostics: set/collect/flush cycle."""

    def __init__(self, version: str = "", interval: float = 3600.0,
                 send=None):
        self.version = version
        self.interval = interval
        # send(payload: dict) — None disables reporting entirely
        self._send = send
        self._info: dict = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.last_payload: dict | None = None

    def set(self, key: str, value):
        with self._lock:
            self._info[key] = value

    def platform_info(self) -> dict:
        """Host stats (gopsutil analog via stdlib + /proc)."""
        info = {
            "os": platform.system(),
            "arch": platform.machine(),
            "python": sys.version.split()[0],
            "num_cpu": os.cpu_count(),
        }
        try:
            with open("/proc/meminfo") as f:
                for line in f:
                    if line.startswith("MemTotal:"):
                        info["mem_total_kb"] = int(line.split()[1])
                        break
        except OSError:
            pass
        try:
            info["load_avg"] = os.getloadavg()[0]
        except OSError:
            pass
        return info

    def payload(self) -> dict:
        with self._lock:
            return {"version": self.version, "time": time.time(),
                    **self.platform_info(), **self._info}

    def flush(self):
        self.last_payload = self.payload()
        if self._send is not None:
            try:
                self._send(self.last_payload)
            except Exception:
                pass  # diagnostics must never break the server

    def start(self):
        if self._send is None:
            return self  # reporting disabled: no ticker either
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        return self

    def _loop(self):
        while not self._stop.wait(self.interval):
            self.flush()

    def close(self):
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=2)

    @staticmethod
    def check_version(current: str, latest: str) -> str | None:
        """verchk.go semantics: a human-readable nudge when a newer
        release exists, else None."""
        def parse(v):
            return tuple(int(p) for p in
                         v.lstrip("v").split("-")[0].split("."))
        try:
            if parse(latest) > parse(current):
                return (f"version {latest} is available "
                        f"(running {current})")
        except ValueError:
            return None
        return None


class PerformanceCounters:
    """performancecounters.go: named monotonic counters + gauges with
    a consistent snapshot for operator tooling."""

    def __init__(self):
        self._counters: dict[str, int] = {}
        self._lock = threading.Lock()

    def add(self, name: str, delta: int = 1):
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + delta

    def set_gauge(self, name: str, value: int):
        with self._lock:
            self._counters[name] = int(value)

    def snapshot(self) -> dict[str, int]:
        with self._lock:
            return dict(self._counters)

    def dump_json(self) -> str:
        return json.dumps(self.snapshot(), sort_keys=True)


performance_counters = PerformanceCounters()

# process-global collector: the server maintenance ticker refreshes
# it (server/http.py) so incident bundles carry a host snapshot that
# predates the anomaly — phone-home stays OFF (send=None means no
# reporting thread and no egress; only the in-process payload is kept)
collector = Diagnostics()


def collect() -> dict:
    """One collection pass (ticker hook): refresh and return the
    host/runtime payload.  Never raises — a broken /proc read must
    not take the ticker down."""
    try:
        collector.flush()
        return collector.last_payload or {}
    except Exception:
        return {}


def host_snapshot() -> dict:
    """The newest collected host payload (incident bundles attach
    this); collects on demand when the ticker has not run yet."""
    if collector.last_payload is not None:
        return collector.last_payload
    return collect()
