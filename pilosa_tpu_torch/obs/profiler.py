"""Process profiling — the pprof/fgprof endpoint backends plus an
always-on continuous profiler.

The reference exposes Go pprof + fgprof at /debug/pprof and
/debug/fgprof (http_handler.go:493-494).  The Python analogs here:

- :func:`sample_stacks` — a wall-clock stack sampler over ALL threads
  (fgprof's model: samples blocked time too, not just on-CPU), built
  on ``sys._current_frames``.  Output is folded-stack lines rooted at
  the THREAD NAME (``thread:name;file:fn;... N``) — the flamegraph
  interchange ("collapsed") format, consumable directly by
  flamegraph.pl / speedscope / inferno.
- :class:`ContinuousProfiler` — the same sampler running always-on at
  low rate on a daemon thread, folding samples into a ring of recent
  fixed-length windows.  Incident bundles (obs/incidents.py) attach
  the ring, so a 3am stall ships with the minutes of profile that led
  up to it; ``/debug/profile?ring=1`` serves it live.
- :func:`heap_snapshot` — tracemalloc top allocation sites (the heap
  profile analog).  tracemalloc is started on first use and left
  running so successive snapshots can be compared.
"""

from __future__ import annotations

import sys
import threading
import time
import tracemalloc
from collections import Counter


def _thread_names() -> dict[int, str]:
    return {t.ident: t.name for t in threading.enumerate()}


def _fold_frame(top, thread_name: str, max_frames: int) -> tuple:
    """One thread's stack as a folded tuple rooted at the thread
    name (outermost caller first)."""
    stack = []
    f = top
    while f is not None and len(stack) < max_frames:
        code = f.f_code
        stack.append(f"{code.co_filename.rsplit('/', 1)[-1]}"
                     f":{code.co_name}")
        f = f.f_back
    stack.append(f"thread:{thread_name}")
    return tuple(reversed(stack))


def _sample_round(counts: Counter, skip: set[int],
                  max_frames: int) -> None:
    names = _thread_names()
    for tid, top in sys._current_frames().items():
        if tid in skip:
            continue
        counts[_fold_frame(top, names.get(tid, f"tid-{tid}"),
                           max_frames)] += 1


def folded_lines(counts: Counter) -> list[str]:
    return [f"{';'.join(stack)} {n}"
            for stack, n in counts.most_common()]


def sample_stacks(seconds: float = 2.0, hz: int = 100,
                  max_frames: int = 64,
                  collapsed: bool = False) -> str:
    """Sample every live thread's stack for `seconds` at `hz`.

    Returns folded-stack lines sorted by count (descending), one per
    distinct stack, each rooted at the sampled thread's name:
    ``thread:name;file:func;... count``.  The sampling thread itself
    is excluded.  ``collapsed=True`` drops the header comment — the
    body is then pure collapsed format for flamegraph tooling.
    """
    me = threading.get_ident()
    counts: Counter[tuple] = Counter()
    interval = 1.0 / max(1, hz)
    deadline = time.monotonic() + max(0.0, seconds)
    n_samples = 0
    while time.monotonic() < deadline:
        _sample_round(counts, {me}, max_frames)
        n_samples += 1
        time.sleep(interval)
    lines = folded_lines(counts)
    if collapsed:
        return "\n".join(lines) + "\n"
    header = (f"# wall-clock stack samples: {n_samples} rounds @ {hz}Hz "
              f"over {seconds}s ({len(counts)} distinct stacks)")
    return "\n".join([header] + lines) + "\n"


class ContinuousProfiler:
    """Always-on low-rate sampler into a ring of recent windows.

    Each window is ``window_s`` of wall clock folded into one stack
    Counter; the ring keeps the newest ``keep`` windows.  At the
    default 7 Hz a sample round walks every thread's frames once —
    measured micro-seconds per round, invisible next to a device
    dispatch — which is what makes it safe to leave on in production
    (the continuous-profiling premise: the profile you need is the
    one that was already running)."""

    def __init__(self, hz: float = 7.0, window_s: float = 10.0,
                 keep: int = 6, max_frames: int = 48,
                 top_stacks: int = 64):
        self.hz = float(hz)
        self.window_s = float(window_s)
        self.max_frames = int(max_frames)
        self.top_stacks = int(top_stacks)
        self._ring: "list[tuple]" = []  # (start, end, n, Counter)
        self.keep = int(keep)
        self._cur = Counter()
        self._cur_start = time.time()
        self._cur_n = 0
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.samples_total = 0

    def start(self) -> "ContinuousProfiler":
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, name="pilosa-continuous-profiler",
                daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
            self._thread = None

    def _loop(self) -> None:
        me = threading.get_ident()
        # interval derives from self.hz INSIDE the loop so a live
        # configure_continuous(hz=...) re-paces sampling without a
        # profiler restart (window_s/keep already behave that way)
        while not self._stop.wait(1.0 / max(0.1, self.hz)):
            counts: Counter = Counter()
            try:
                _sample_round(counts, {me}, self.max_frames)
            except Exception:
                continue  # a torn frame walk skips one sample
            with self._lock:
                self._cur.update(counts)
                self._cur_n += 1
                self.samples_total += 1
                if time.time() - self._cur_start >= self.window_s:
                    self._rotate_locked()

    def _rotate_locked(self) -> None:
        if self._cur_n:
            self._ring.append((self._cur_start, time.time(),
                               self._cur_n, self._cur))
            del self._ring[: max(0, len(self._ring) - self.keep)]
        self._cur = Counter()
        self._cur_start = time.time()
        self._cur_n = 0

    def windows(self) -> list[dict]:
        """Newest-first windows (the in-progress one included when it
        holds samples), each as top folded-stack lines — the shape
        incident bundles attach and ``?ring=1`` serves."""
        with self._lock:
            ring = list(self._ring)
            if self._cur_n:
                ring.append((self._cur_start, time.time(),
                             self._cur_n, Counter(self._cur)))
        out = []
        for start, end, n, counts in reversed(ring):
            top = Counter(dict(counts.most_common(self.top_stacks)))
            out.append({"start": round(start, 3),
                        "end": round(end, 3),
                        "samples": n,
                        "folded": folded_lines(top)})
        return out

    def folded(self) -> str:
        """The whole ring merged as one collapsed-format profile."""
        merged: Counter = Counter()
        with self._lock:
            for _s, _e, _n, counts in self._ring:
                merged.update(counts)
            merged.update(self._cur)
        return "\n".join(folded_lines(merged)) + "\n"


# process-global continuous profiler; config.apply_incident_settings
# starts/stops it ([incidents] profile / profile-hz / ...)
continuous: ContinuousProfiler | None = None
_lock = threading.Lock()


def configure_continuous(enabled: bool = True, hz: float = 7.0,
                         window_s: float = 10.0,
                         keep: int = 6) -> ContinuousProfiler | None:
    global continuous
    with _lock:
        if not enabled:
            if continuous is not None:
                continuous.stop()
                continuous = None
            return None
        if continuous is None:
            continuous = ContinuousProfiler(hz=hz, window_s=window_s,
                                            keep=keep).start()
        else:
            continuous.hz = float(hz)
            continuous.window_s = float(window_s)
            continuous.keep = int(keep)
            continuous.start()  # idempotent revive
        return continuous


def profile_windows() -> list[dict]:
    """The continuous ring for incident bundles ([] when off)."""
    c = continuous
    return c.windows() if c is not None else []


def heap_snapshot(top: int = 25) -> str:
    """Top allocation sites by current size (tracemalloc)."""
    if not tracemalloc.is_tracing():
        tracemalloc.start()
        return ("# tracemalloc just started — call again after some "
                "work to see allocations\n")
    snap = tracemalloc.take_snapshot()
    stats = snap.statistics("lineno")[:top]
    total = sum(s.size for s in snap.statistics("filename"))
    lines = [f"# heap: {total / (1 << 20):.1f} MiB traced, "
             f"top {len(stats)} sites"]
    for s in stats:
        fr = s.traceback[0]
        lines.append(f"{fr.filename.rsplit('/', 1)[-1]}:{fr.lineno} "
                     f"size={s.size >> 10}KiB count={s.count}")
    return "\n".join(lines) + "\n"
