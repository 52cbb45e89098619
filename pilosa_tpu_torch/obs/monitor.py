"""Error monitor — Sentry-style capture hook.

Reference: monitor/monitor.go:26 — an error/panic reporter with a
global nop default; the server calls CaptureException at recover
points.  Here the sink is pluggable (a real Sentry SDK drops in as
``sink``); the default in-memory ring is what tests and the /debug
surface read.
"""

from __future__ import annotations

import threading
import time
import traceback


class Monitor:
    def __init__(self, sink=None, keep: int = 100):
        self.sink = sink          # callable(event: dict) or None
        self.keep = keep
        self.events: list[dict] = []
        self._lock = threading.Lock()
        self.enabled = True

    def capture_exception(self, exc: BaseException, **context):
        if not self.enabled:
            return
        event = {
            "time": time.time(),
            "type": type(exc).__name__,
            "message": str(exc),
            "traceback": "".join(traceback.format_exception(
                type(exc), exc, exc.__traceback__))[-4000:],
            **context,
        }
        with self._lock:
            self.events.append(event)
            if len(self.events) > self.keep:
                self.events.pop(0)
        if self.sink is not None:
            try:
                self.sink(event)
            except Exception:
                pass  # the monitor must never take the server down

    def capture_message(self, msg: str, **context):
        with self._lock:
            self.events.append({"time": time.time(), "type": "message",
                                "message": msg, **context})
            if len(self.events) > self.keep:
                self.events.pop(0)

    def recent(self) -> list[dict]:
        with self._lock:
            return list(self.events)


# global monitor with nop-ish default (monitor.go global pattern)
global_monitor = Monitor()


def capture_exception(exc: BaseException, **context):
    global_monitor.capture_exception(exc, **context)
