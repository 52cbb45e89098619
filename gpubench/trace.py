"""The traced run: what the per-layer readers (``metrics/``) read.

Around the same closed-loop window as an untraced run it records

- every port-kernel launch with its least time (``roofline/``), by
  wrapping ``ops/kernels.py``'s launching wrappers from this side;
- the device's operations (``DeviceClock``, in every run);
- every span of every client's requests (a ``RecordingTracer`` a
  client thread), the flight records of the window, and the deltas of
  the program's counters;
- the audit plane's shadow executions (``ShadowClock``, in every run):
  their time, and the launches and flight records that are theirs and
  not a client's.

The readers get a ``Bundle``; the run's ``busy_s``, ``window_s`` and
``breakdown`` come from it too.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field

import torch

from gpubench import peaks, roofline


@dataclass
class Bundle:
    window: object                     # loop.Window: every request
    answered: int                      # requests answered in the window
    flight: list                       # clients' flight records of the window
    counters: dict                     # deltas of the program's counters
    launches: dict                     # LAUNCHES deltas by kernel
    costs: dict                        # kernel -> [least seconds, launches]
    device: list                       # (name, start, end) on the host clock
    spans: list = field(default_factory=list)   # (name, start, end)
    busy_s: float = 0.0
    audit_s: float = 0.0               # shadow executions inside the window
    audit_launches: int = 0            # launches made by shadow executions

    @property
    def window_s(self) -> float:
        return self.window.seconds


class ShadowClock:
    """Times the audit plane's shadow executions (``obs/audit.py``,
    ``AuditPlane._shadow_exec``) from this side: each one's interval on
    the host clock, and whether the calling thread is inside one."""

    def __init__(self):
        self.spans: list = []       # (perf start, perf end, wall start, wall end)
        self.open: dict = {}        # thread id -> (perf start, wall start)
        self._tls = threading.local()
        self._orig = None

    def install(self):
        from pilosa_tpu_torch.obs.audit import AuditPlane
        orig = AuditPlane._shadow_exec
        clock = self

        def timed(plane, sample):
            clock._tls.on = True
            me = threading.get_ident()
            p0, w0 = time.perf_counter(), time.time()
            clock.open[me] = (p0, w0)
            try:
                return orig(plane, sample)
            finally:
                clock._tls.on = False
                clock.spans.append((p0, time.perf_counter(), w0, time.time()))
                clock.open.pop(me, None)
        self._orig = orig
        AuditPlane._shadow_exec = timed

    def uninstall(self):
        if self._orig is not None:
            from pilosa_tpu_torch.obs.audit import AuditPlane
            AuditPlane._shadow_exec = self._orig
            self._orig = None

    def active(self) -> bool:
        """Whether this thread is inside a shadow execution."""
        return getattr(self._tls, "on", False)

    def _all(self) -> list:
        """Every shadow execution so far, one still running up to now."""
        now, wall = time.perf_counter(), time.time()
        return list(self.spans) + [(p0, now, w0, wall)
                                   for p0, w0 in list(self.open.values())]

    def seconds(self, begin: float, end: float) -> float:
        """Shadow execution inside [begin, end) (perf_counter)."""
        return sum(max(0.0, min(e, end) - max(s, begin))
                   for s, e, _, _ in self._all())

    def count(self, begin: float, end: float) -> int:
        return sum(1 for s, e, _, _ in self._all() if e > begin and s < end)

    def owns(self, record: dict) -> bool:
        """A flight record a shadow execution opened: the oracle's
        ``Executor.execute`` commits route ``solo``, which no served
        request of a node with its serving layer on does."""
        t = record.get("start", 0.0)
        return record.get("route") == "solo" and any(
            w0 <= t <= w1 for _, _, w0, w1 in self._all())


def _counters() -> dict:
    from pilosa_tpu_torch.obs import metrics
    return {
        "served": {r: metrics.SERVING_BATCHED.value(route=r)
                   for r in ("fused", "direct", "cached", "standing")},
        "dispatches": metrics.SERVING_DISPATCH.total(),
        "cache": {o: metrics.RESULT_CACHE.value(outcome=o)
                  for o in ("hit", "miss", "bypass")},
        "sql_plan_ms_sum": metrics.SQL_PLAN_COST.sum(),
        "sql_plan_count": metrics.SQL_PLAN_COST.count(),
    }


def _delta(a, b):
    if isinstance(a, dict):
        return {k: _delta(a[k], b[k]) for k in a}
    return b - a


def _union(intervals: list) -> list:
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class DeviceClock:
    """The card's operations over a window, from ``torch.profiler`` (CUDA
    activity only), placed on the host's clock by a marker kernel
    launched at a known time.  Every run keeps one: ``busy_s`` is the
    end-to-end ``device_ms_per_query``'s numerator.  Nothing is traced
    on a CPU."""

    def __init__(self, device):
        self.device = device
        self.prof = None

    def start(self):
        if self.device.type != "cuda":
            return
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        torch.cuda.synchronize(self.device)
        self.mark_host = time.perf_counter()
        torch.cuda._sleep(1000)       # the marker: spin_kernel
        torch.cuda.synchronize(self.device)

    def stop(self) -> list:
        """(name, start, end) of every device operation, on the host's
        perf_counter clock."""
        if self.prof is None:
            return []
        torch.cuda.synchronize(self.device)
        self.prof.__exit__(None, None, None)
        from torch.autograd import DeviceType
        evs = [e for e in self.prof.events()
               if e.device_type == DeviceType.CUDA]
        self.prof = None
        mark = next((e for e in evs if "spin_kernel" in e.name), None)
        if mark is None:
            mark = min(evs, key=lambda e: e.time_range.start, default=None)
        if mark is None:
            return []
        off = self.mark_host - mark.time_range.start / 1e6
        return [(e.name, e.time_range.start / 1e6 + off,
                 e.time_range.end / 1e6 + off) for e in evs if e is not mark]


def busy_s(device: list, win) -> float:
    """Seconds of the window in which an operation ran on the device:
    the union of their intervals inside it."""
    busy = _union([[max(s, win.begin), min(e, win.end)]
                   for _, s, e in device if e > win.begin and s < win.end])
    return sum(e - s for s, e in busy)


class Recorder:
    """Records one window; ``start()`` before it, ``stop()`` after."""

    def __init__(self, device, shadow: ShadowClock):
        self.device = device
        self.clock = DeviceClock(device)
        self.shadow = shadow
        self.audit_launches = 0
        self.costs: dict = {}
        self.tracers: list = []
        self._orig: dict = {}
        self.popc_rate = (peaks.popc_per_s(device.index or 0)
                          if device.type == "cuda" else 1e12)

    # -- launches ---------------------------------------------------------

    def _wrap(self, kernel: str, name: str, cost_fn):
        K = self.kernels
        orig = getattr(K, name)
        rate = self.popc_rate
        costs = self.costs
        rec = self

        def wrapped(*args, **kwargs):
            before = K.LAUNCHES[kernel]
            out = orig(*args, **kwargs)
            n = K.LAUNCHES[kernel] - before
            if n and rec.shadow.active():
                rec.audit_launches += n
            if n:
                least = peaks.least_s(cost_fn(*args, **kwargs), rate)
                slot = costs.setdefault(kernel, [0.0, 0])
                slot[0] += least
                slot[1] += n
            return out
        self._orig[name] = orig
        setattr(K, name, wrapped)

    def install(self):
        from pilosa_tpu_torch.ops import kernels
        self.kernels = kernels
        for kernel, mod in roofline.load_all().items():
            for name, fn in mod.WRAPPERS.items():
                self._wrap(kernel, name, fn)

    def uninstall(self):
        for name, fn in self._orig.items():
            setattr(self.kernels, name, fn)
        self._orig.clear()

    # -- spans --------------------------------------------------------------

    def on_client(self, _i: int):
        from pilosa_tpu_torch.obs import tracing
        t = tracing.RecordingTracer(keep=1 << 20)
        self.tracers.append(t)
        tracing.push_thread_tracer(t)

    def _spans(self) -> list:
        seen = set()
        out = []

        def walk(sp):
            key = (sp.name, sp.start, sp.end)
            if sp.end is not None and key not in seen:
                seen.add(key)
                out.append(key)
            for c in sp.children:
                walk(c)
        for t in self.tracers:
            for root in list(t.roots):
                walk(root)
        return out

    # -- the window -------------------------------------------------------------

    def start(self):
        # the profiler runs before the launches are counted and after
        # they stop being counted: every launch counted is in the trace
        from pilosa_tpu_torch.obs import flight
        from pilosa_tpu_torch.ops import kernels
        flight.recorder.configure(keep=1 << 20)
        flight.recorder.clear()
        self.c0 = _counters()
        self.l0 = dict(kernels.LAUNCHES)
        self.clock.start()
        self.install()

    def stop(self, win, answered: int) -> Bundle:
        from pilosa_tpu_torch.obs import flight
        from pilosa_tpu_torch.ops import kernels
        self.uninstall()
        launches = _delta(self.l0, dict(kernels.LAUNCHES))
        device = self.clock.stop()
        t_wall = time.time() - (time.perf_counter() - win.begin)
        recs = [r for r in flight.recorder.recent(1 << 20)
                if t_wall <= r["start"] <= t_wall + win.seconds
                and not self.shadow.owns(r)]
        b = Bundle(window=win, answered=answered, flight=recs,
                   counters=_delta(self.c0, _counters()),
                   launches=launches, costs=self.costs, device=device,
                   spans=self._spans(),
                   audit_s=self.shadow.seconds(win.begin, win.end),
                   audit_launches=self.audit_launches)
        b.busy_s = busy_s(device, win)
        return b


def breakdown(b: Bundle, win) -> dict:
    """The device operations that took most time, and the longest idle
    gaps named by the innermost host span open across each."""
    by: dict = {}
    for name, s, e in b.device:
        if e > win.begin and s < win.end:
            by[name] = by.get(name, 0.0) + (min(e, win.end) - max(s, win.begin))
    ops = sorted(by.items(), key=lambda kv: -kv[1])[:10]
    busy = _union([[max(s, win.begin), min(e, win.end)]
                   for _, s, e in b.device if e > win.begin and s < win.end])
    gaps, t = [], win.begin
    for s, e in busy:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if t < win.end:
        gaps.append((t, win.end))
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
    named = []
    for s, e in gaps:
        mid = (s + e) / 2
        open_ = [sp for sp in b.spans if sp[1] <= mid <= sp[2]]
        name = (min(open_, key=lambda sp: sp[2] - sp[1])[0] if open_
                else "no request span open")
        named.append([name, e - s])
    return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": named}
