"""Stall watchdogs — progress-stamped deadlines on long-running loops.

Every long-running loop in the engine (serving batch leader, ingest
window drain, rebalance controller, maintenance ticker, cluster
heartbeat) registers a :class:`LoopWatch` and *stamps* it as it makes
progress, naming the phase it is entering.  A background monitor
thread scans the registry: an ARMED watch whose last stamp is older
than its deadline is a wedged loop — the monitor counts it
(``pilosa_watchdog_stalls_total{loop}``), grabs the stuck thread's
live stack via ``sys._current_frames``, and raises an incident
(``obs/incidents.py`` trigger ``watchdog-stall``) naming the loop and
the stuck phase.

The hot-path contract is the stamp: four attribute writes and one
``time.monotonic()`` call, no lock, no allocation — measured well
under the 8 µs budget check.sh's incident smoke gates (the same
budget class as the flight recorder's disabled path).  ``idle()``
disarms the watch while the loop is legitimately parked waiting for
work, so an empty queue never reads as a stall.

One stall fires ONCE per episode: the monitor remembers the stamp it
reported against and stays quiet until the loop stamps again (a new
episode).  Incident-side rate limiting bounds bundle volume on top.
"""

from __future__ import annotations

import sys
import threading
import time

# on by default; configure(enabled=False) turns the plane off (the port
# reads no environment for it)
_enabled = True
_interval_s = 1.0
_default_deadline_s = 10.0

_lock = threading.Lock()
_watches: dict[str, "LoopWatch"] = {}
_monitor: threading.Thread | None = None
_monitor_wake = threading.Event()


class LoopWatch:
    """One loop's progress stamp.

    Two usage models:

    - **single-owner loops** (ingest drain, rebalance controller,
      ticker, heartbeat): ``stamp(phase)`` / ``idle()`` — mutated
      only by the owning thread, read by the monitor.  Plain
      attributes, writes GIL-atomic; the monitor reads ``armed``
      BEFORE ``t`` (the reverse of stamp's write order, which sets
      ``t`` before ``armed``) so a stamp landing mid-snapshot can
      never pair a fresh ``armed`` with a stale ``t`` — the false
      "stalled the instant it woke up" race.
    - **overlapping dispatchers** (the serving batch leader: under
      load a full batch dispatches while another is still in
      flight): ``begin(phase)`` → token → ``end(token)``.  Tokens
      track EVERY in-flight dispatch, and staleness is judged
      against the OLDEST one — a healthy leader finishing cannot
      disarm or re-stamp away a wedged sibling.  The token lock is
      per-begin/end (per *batch*, not per query), far under the
      stamp budget's traffic.
    """

    __slots__ = ("name", "deadline_s", "phase", "t", "armed",
                 "thread_id", "stalls", "_reported_t",
                 "_tokens", "_tok_lock")

    def __init__(self, name: str, deadline_s: float):
        self.name = name
        self.deadline_s = float(deadline_s)
        self.phase = ""
        self.t = time.monotonic()
        self.armed = False
        self.thread_id = 0
        self.stalls = 0
        self._reported_t = -1.0
        self._tokens: dict[tuple, None] = {}
        self._tok_lock = threading.Lock()

    def stamp(self, phase: str) -> None:
        """Progress mark: the loop is alive and entering ``phase``.
        HOT PATH — keep to attribute writes + one monotonic read.
        ``armed`` is written LAST (see class docstring)."""
        self.phase = phase
        self.thread_id = threading.get_ident()
        self.t = time.monotonic()
        self.armed = True

    def idle(self) -> None:
        """The loop is parked waiting for work — not a stall."""
        self.armed = False

    def begin(self, phase: str) -> tuple:
        """Arm one IN-FLIGHT dispatch (overlapping-dispatcher model);
        pair with :meth:`end`.  Returns the token."""
        tok = (time.monotonic(), phase, threading.get_ident())
        with self._tok_lock:
            self._tokens[tok] = None
        return tok

    def end(self, tok: tuple) -> None:
        with self._tok_lock:
            self._tokens.pop(tok, None)

    def _oldest(self) -> tuple | None:
        """(t, phase, thread_id) of the oldest in-flight token."""
        with self._tok_lock:
            if not self._tokens:
                return None
            return min(self._tokens)

    def _observe(self) -> tuple | None:
        """Monitor-side snapshot: ``(t, phase, thread_id)`` of the
        staleness-relevant mark, or None when disarmed.  Token model
        wins when tokens are in flight; else the stamp model (armed
        read FIRST — see class docstring)."""
        oldest = self._oldest()
        if oldest is not None:
            return oldest
        if not self.armed:
            return None
        return (self.t, self.phase, self.thread_id)

    def to_dict(self) -> dict:
        obs = self._observe()
        now = time.monotonic()
        age = now - (obs[0] if obs is not None else self.t)
        return {"loop": self.name,
                "phase": obs[1] if obs is not None else self.phase,
                "armed": obs is not None,
                "deadline_s": self.deadline_s,
                "age_s": round(age, 3),
                "stalled": bool(obs is not None
                                and age > self.deadline_s),
                "stalls": self.stalls}


def register(name: str, deadline_s: float | None = None) -> LoopWatch:
    """Register (or fetch) the watch for a named loop.  Idempotent by
    name: servers are rebuilt freely in-process and the loop identity
    is the name, so re-registration returns the live watch (updating
    its deadline when one is given)."""
    with _lock:
        w = _watches.get(name)
        if w is None:
            w = _watches[name] = LoopWatch(
                name, deadline_s if deadline_s is not None
                else _default_deadline_s)
        elif deadline_s is not None:
            w.deadline_s = float(deadline_s)
    _ensure_monitor()
    return w


def deregister(name: str) -> None:
    with _lock:
        _watches.pop(name, None)


def watches() -> list[dict]:
    """Registry state (the /debug/incidents ``watchdog`` payload)."""
    with _lock:
        ws = list(_watches.values())
    return [w.to_dict() for w in sorted(ws, key=lambda w: w.name)]


def configure(enabled: bool | None = None,
              interval_s: float | None = None,
              deadline_s: float | None = None) -> None:
    """Apply the [watchdog] config knobs.  ``enabled=None`` leaves
    the switch as it is."""
    global _enabled, _interval_s, _default_deadline_s
    if enabled is not None:
        _enabled = bool(enabled)
    if interval_s is not None and interval_s > 0:
        _interval_s = float(interval_s)
        _monitor_wake.set()  # re-pace the monitor promptly
    if deadline_s is not None and deadline_s > 0:
        _default_deadline_s = float(deadline_s)
    if _enabled:
        _ensure_monitor()


def enabled() -> bool:
    return _enabled


def _thread_stack(thread_id: int) -> str:
    """The live stack of one thread (best effort — it may have exited
    between the overdue check and this read)."""
    frame = sys._current_frames().get(thread_id)
    if frame is None:
        return ""
    from pilosa_tpu_torch.obs.incidents import format_stack
    return format_stack(frame)


def scan(now: float | None = None) -> list[dict]:
    """One monitor pass over the registry; returns the stalls
    detected THIS pass (tests drive this directly for determinism —
    the background thread just calls it on a timer)."""
    if now is None:
        now = time.monotonic()
    with _lock:
        ws = list(_watches.values())
    fired = []
    for w in ws:
        obs = w._observe()
        if obs is None:
            continue
        t, phase, thread_id = obs
        if now - t <= w.deadline_s:
            continue
        if w._reported_t == t:
            continue  # this episode already reported; wait for progress
        w._reported_t = t
        w.stalls += 1
        from pilosa_tpu_torch.obs import metrics
        metrics.WATCHDOG_STALLS.inc(loop=w.name)
        stall = {"loop": w.name, "phase": phase,
                 "overdue_s": round(now - t, 3),
                 "deadline_s": w.deadline_s,
                 "thread_id": thread_id,
                 "stack": _thread_stack(thread_id)}
        fired.append(stall)
        try:
            from pilosa_tpu_torch.obs import incidents
            incidents.report(
                "watchdog-stall", detail=f"{w.name}:{w.phase}",
                context=stall)
        except Exception:
            pass  # the watchdog must never take the monitor down
    return fired


def _ensure_monitor() -> None:
    global _monitor
    if not _enabled or (_monitor is not None and _monitor.is_alive()):
        return
    with _lock:
        if _monitor is not None and _monitor.is_alive():
            return
        stop_ev = threading.Event()
        _monitor = threading.Thread(target=_monitor_loop, args=(stop_ev,),
                                    name="pilosa-watchdog",
                                    daemon=True)
        _monitor.stop_ev = stop_ev
        _monitor.start()


def stop(timeout: float = 5.0) -> bool:
    """End the monitor thread (a later register() starts it again);
    True when it ended within ``timeout``."""
    global _monitor
    with _lock:
        t, _monitor = _monitor, None
    if t is None:
        return True
    t.stop_ev.set()
    _monitor_wake.set()
    t.join(timeout)
    return not t.is_alive()


def _monitor_loop(stop_ev: threading.Event) -> None:
    while not stop_ev.is_set():
        _monitor_wake.wait(_interval_s)
        _monitor_wake.clear()
        if stop_ev.is_set():
            return
        if _enabled:
            try:
                scan()
            except Exception:
                pass
