"""Leveled logger with a nop default (reference: logger/logger.go —
``Logger`` interface with Printf-style Debugf/Infof/Warnf/Errorf and a
``NopLogger``; we keep the same four levels and the nop), plus a
bounded in-memory ring of recent emitted lines — the black-box log
tail incident bundles attach (obs/incidents.py) and
``/debug/logs?limit=`` serves.  Lines keep their ``trace=`` stamps,
so a bundle's tail greps straight to its flight records."""

from __future__ import annotations

import sys
import threading
import time
from collections import deque
from typing import IO

DEBUG, INFO, WARN, ERROR = 10, 20, 30, 40
_LEVEL_NAMES = {DEBUG: "DEBUG", INFO: "INFO", WARN: "WARN", ERROR: "ERROR"}


class LogRing:
    """Bounded ring of recently emitted log lines.  The append is
    lock-free (deque with maxlen is GIL-atomic) — same budget class
    as the flight recorder's record ring."""

    def __init__(self, keep: int = 512):
        self._ring: deque[str] = deque(maxlen=keep)

    def record(self, line: str) -> None:
        self._ring.append(line)

    def recent(self, limit: int = 200) -> list[str]:
        """Newest-last lines (reads retry across a concurrent
        append, like flight.FlightRecorder.recent)."""
        while True:
            try:
                items = list(self._ring)
                break
            except RuntimeError:
                continue
        return items[-max(0, int(limit)):]

    def configure(self, keep: int) -> None:
        if keep != self._ring.maxlen:
            self._ring = deque(self._ring, maxlen=int(keep))

    def clear(self) -> None:
        self._ring.clear()

    def __len__(self) -> int:
        return len(self._ring)


# process-global ring: every Logger instance feeds it (the nop logger
# emits nothing, so it records nothing); [incidents] log-ring sizes it
ring = LogRing()


def _active_trace_id() -> str | None:
    """This thread's flight trace id (function-level import: logger
    must stay importable before/without the obs.flight module)."""
    try:
        from pilosa_tpu_torch.obs import flight
        return flight.current_trace_id()
    except Exception:
        return None


class Logger:
    """Leveled, %-formatted logger writing one line per call."""

    def __init__(self, stream: IO[str] | None = None, level: int = INFO,
                 name: str = ""):
        self.stream = stream if stream is not None else sys.stderr
        self.level = level
        self.name = name
        self._lock = threading.Lock()

    def _log(self, level: int, fmt: str, *args):
        if level < self.level:
            return
        msg = (fmt % args) if args else fmt
        ts = time.strftime("%Y-%m-%dT%H:%M:%S")
        prefix = f"{ts} {_LEVEL_NAMES[level]:5s}"
        if self.name:
            prefix += f" [{self.name}]"
        # log/trace correlation: a line emitted while a
        # flight record (or an inherited RPC trace id) is active on
        # this thread carries that id, so logs grep straight to the
        # matching /debug/queries record and Perfetto lane
        trace = _active_trace_id()
        if trace:
            prefix += f" trace={trace}"
        line = f"{prefix} {msg}"
        ring.record(line)
        with self._lock:
            self.stream.write(line + "\n")

    def debug(self, fmt: str, *args):
        self._log(DEBUG, fmt, *args)

    def info(self, fmt: str, *args):
        self._log(INFO, fmt, *args)

    def warn(self, fmt: str, *args):
        self._log(WARN, fmt, *args)

    def error(self, fmt: str, *args):
        self._log(ERROR, fmt, *args)

    def with_prefix(self, name: str) -> "Logger":
        child = Logger(self.stream, self.level, name)
        child._lock = self._lock
        return child


class NopLogger(Logger):
    """Discards everything (logger.NopLogger analog)."""

    def __init__(self):
        super().__init__(stream=sys.stderr, level=ERROR + 1)

    def _log(self, level: int, fmt: str, *args):
        pass


def StderrLogger(level: int = INFO) -> Logger:
    return Logger(sys.stderr, level)


def new_logger(verbose: bool = False, path: str | None = None) -> Logger:
    """Build the server logger from config (server.go log-path wiring)."""
    level = DEBUG if verbose else INFO
    if path:
        return Logger(open(path, "a", buffering=1), level)
    return Logger(sys.stderr, level)
