"""Incident forensics — anomaly-triggered black-box bundles.

The earlier observability PRs *detect* trouble (SLO burn rates, the
perf-regression sentinel, typed sheds, watchdog stalls) but keep no
evidence: by the time an operator looks at a 3am page, the flight
ring has rotated and the stacks are gone.  This module is the
reaction — when an anomaly fires, capture ONE rate-limited,
size-bounded *incident bundle* of everything a post-mortem needs,
persisted under the data dir:

====================  ====================================================
``stacks``            every live thread's stack (``sys._current_frames``)
                      with thread names
``flight``            flight-ring snapshot (newest records)
``trace``             Chrome trace_event excerpt (Perfetto-loadable)
``metrics``           full /metrics.json dump
``stats``             statistics-catalog excerpt (profiles, regressions)
``faults``            armed fault-point rules
``config``            the server's config snapshot (secrets dropped)
``host``              host/runtime stats (obs/diagnostics.py collector)
``log_tail``          recent log lines (obs/logger.py ring, trace= stamps)
``profile``           continuous-profiler windows (folded stacks)
====================  ====================================================

Triggers wired through the stack (``report(trigger, ...)``):

- ``slo-burn``              — burn rate over threshold on a covered
  window (obs/slo.py evaluate)
- ``perf-regression``       — the statistics catalog's sentinel fires
  (obs/stats.py)
- ``watchdog-stall``        — a progress-stamped loop wedged past its
  deadline (obs/watchdog.py)
- ``device-oom``            — the OOM recovery ladder trips
  (memory/pressure.py)
- ``batch-leader-exception`` — an unhandled serving batch-leader
  error (executor/serving.py)
- ``ingest-crash``          — the streaming write plane dies
  (ingest/stream.py)

Capture runs on a dedicated daemon thread — ``report()`` is the hot
path and costs one rate-limit check + a queue append; serving never
waits on a bundle.  Rate limiting dedupes per trigger inside
``min_interval_s`` (suppressed reports are counted, not captured).
Bundles persist tmp+fsync+rename (never a half file — the
``incident-write`` fault seam proves it) with a bounded on-disk
retention, and a bounded in-memory ring serves ``/debug/incidents``
even without a data dir.
"""

from __future__ import annotations

import itertools
import json
import os
import sys
import threading
import time
import traceback
import uuid
from collections import deque

# on by default; configure(enabled=False) turns the plane off (the port
# reads no environment for it)
_enabled = True

# capture-section list caps BEFORE the byte bound (the bound then
# halves the biggest sections until the bundle fits)
_FLIGHT_RECORDS = 64
_TRACE_RECORDS = 32
_LOG_LINES = 200
_STATS_PROFILES = 16

TRIGGERS = ("slo-burn", "perf-regression", "watchdog-stall",
            "device-oom", "batch-leader-exception", "ingest-crash",
            "audit-mismatch", "dax-scale-out", "dax-scale-in",
            "manual")


def format_stack(frame, max_frames: int = 64) -> str:
    """One frame's stack as bounded text — the single formatting
    idiom every stack-capture surface shares (thread_dump here, the
    watchdog's stuck-thread evidence), so truncation/caps cannot
    drift between them."""
    return "".join(traceback.format_stack(frame)[-max_frames:])[-8000:]


def thread_dump(max_frames: int = 64) -> list[dict]:
    """Every live thread's stack with its name — the bundle's core
    evidence, also useful standalone."""
    names = {t.ident: t.name for t in threading.enumerate()}
    out = []
    for tid, top in sys._current_frames().items():
        out.append({"thread_id": tid,
                    "name": names.get(tid, f"tid-{tid}"),
                    "stack": format_stack(top, max_frames)})
    out.sort(key=lambda d: d["name"])
    return out


class IncidentManager:
    """Rate-limited capture queue + bounded bundle store."""

    def __init__(self, dir: str | None = None,
                 min_interval_s: float = 60.0,
                 max_bundles: int = 32,
                 max_bundle_bytes: int = 1 << 20,
                 slo_burn_threshold: float = 8.0):
        self.dir = dir
        self.min_interval_s = float(min_interval_s)
        self.max_bundles = int(max_bundles)
        self.max_bundle_bytes = int(max_bundle_bytes)
        self.slo_burn_threshold = float(slo_burn_threshold)
        self.config_snapshot: dict | None = None
        self._ids = itertools.count(1)
        # per-process discriminator: bundle ids must stay unique
        # across a CLUSTER (the federated merge keys on them) — two
        # nodes tripping the same trigger in the same epoch second
        # with the same sequence must not collide
        self.token = uuid.uuid4().hex[:6]
        self._lock = threading.Lock()
        self._last: dict[str, float] = {}   # trigger -> last capture
        self.suppressed: dict[str, int] = {}
        # full bundles (newest last) — /debug/incidents fetch works
        # without a data dir; metadata ring is wider than the bundle
        # ring so the listing survives bundle eviction
        self._bundles: deque[dict] = deque(maxlen=8)
        self._meta: deque[dict] = deque(maxlen=64)
        self._q: deque[tuple] = deque()
        self._q_event = threading.Event()
        self._inflight = 0
        self._idle = threading.Condition(self._lock)
        self._thread: threading.Thread | None = None

    # -- hot-path entry ------------------------------------------------

    def report(self, trigger: str, detail: str = "",
               context: dict | None = None) -> bool:
        """Request a bundle for ``trigger``.  Returns False when rate
        limiting suppressed it.  Cheap by contract: one lock for the
        rate map, one queue append — capture happens on the worker."""
        now = time.monotonic()
        with self._lock:
            last = self._last.get(trigger)
            if last is not None and now - last < self.min_interval_s:
                self.suppressed[trigger] = \
                    self.suppressed.get(trigger, 0) + 1
                from pilosa_tpu_torch.obs import metrics
                metrics.INCIDENTS_TOTAL.inc(trigger=trigger,
                                            outcome="suppressed")
                return False
            self._last[trigger] = now
            self._inflight += 1
            self._q.append((trigger, detail, context, time.time()))
        self._q_event.set()
        self._ensure_worker()
        return True

    # -- capture worker ------------------------------------------------

    def _ensure_worker(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            return
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return
            self._stop = False
            self._thread = threading.Thread(
                target=self._worker, name="pilosa-incident-capture",
                daemon=True)
            self._thread.start()

    def stop(self, timeout: float = 5.0) -> bool:
        """End the capture thread after the queued captures (a later
        report starts it again); True when it ended within
        ``timeout``."""
        with self._lock:
            t, self._thread = self._thread, None
            self._stop = True
        if t is None:
            return True
        self._q_event.set()
        t.join(timeout)
        return not t.is_alive()

    def _worker(self) -> None:
        while True:
            self._q_event.wait(1.0)
            self._q_event.clear()
            if getattr(self, "_stop", False) and not self._q:
                return
            while True:
                try:
                    item = self._q.popleft()
                except IndexError:
                    break
                try:
                    self._capture(*item)
                except Exception as e:
                    from pilosa_tpu_torch.obs import metrics
                    from pilosa_tpu_torch.obs.monitor import capture_exception
                    metrics.INCIDENTS_TOTAL.inc(trigger=item[0],
                                                outcome="error")
                    capture_exception(e, where="incidents.capture",
                                      trigger=item[0])
                finally:
                    with self._lock:
                        self._inflight -= 1
                        self._idle.notify_all()

    def wait_idle(self, timeout: float = 5.0) -> bool:
        """Block until every queued capture landed (tests + clean
        shutdown)."""
        deadline = time.monotonic() + timeout
        with self._lock:
            while self._inflight > 0:
                rem = deadline - time.monotonic()
                if rem <= 0:
                    return False
                self._idle.wait(rem)
        return True

    # -- bundle assembly -----------------------------------------------

    def _capture(self, trigger: str, detail: str,
                 context: dict | None, t: float) -> None:
        iid = f"inc-{int(t)}-{next(self._ids)}-{self.token}-{trigger}"
        bundle = {"id": iid, "time": t, "trigger": trigger,
                  "detail": str(detail)[:500]}
        if context:
            bundle["context"] = _jsonable(context)
        # every section guarded: a broken collector degrades its
        # section to an error string, never the whole bundle
        for key, fn in (
                ("stacks", thread_dump),
                ("flight", self._flight_snapshot),
                ("trace", self._trace_excerpt),
                ("metrics", self._metrics_dump),
                ("stats", self._stats_excerpt),
                ("faults", self._armed_faults),
                ("host", self._host_stats),
                ("log_tail", self._log_tail),
                ("profile", self._profile_windows)):
            try:
                bundle[key] = fn()
            except Exception as e:
                bundle[key] = {"error": f"{type(e).__name__}: {e}"}
        if self.config_snapshot is not None:
            bundle["config"] = self.config_snapshot
        nbytes = self._bound(bundle)
        bundle["bundle_bytes"] = nbytes
        meta = {"id": iid, "time": t, "trigger": trigger,
                "detail": bundle["detail"], "bytes": nbytes,
                "persisted": False}
        if self.dir:
            try:
                self._persist(iid, bundle)
                meta["persisted"] = True
            except Exception as e:
                from pilosa_tpu_torch.obs.monitor import capture_exception
                capture_exception(e, where="incidents.persist", id=iid)
        with self._lock:
            self._bundles.append(bundle)
            self._meta.append(meta)
        from pilosa_tpu_torch.obs import metrics
        metrics.INCIDENTS_TOTAL.inc(trigger=trigger,
                                    outcome="captured")

    @staticmethod
    def _flight_snapshot() -> list[dict]:
        from pilosa_tpu_torch.obs import flight
        return _jsonable(flight.recorder.recent(_FLIGHT_RECORDS))

    @staticmethod
    def _trace_excerpt() -> dict:
        from pilosa_tpu_torch.obs import flight
        return flight.recorder.chrome_trace(_TRACE_RECORDS)

    @staticmethod
    def _metrics_dump() -> dict:
        from pilosa_tpu_torch.obs import flight, metrics
        flight.flush_metrics()
        return metrics.registry.render_json()

    @staticmethod
    def _stats_excerpt() -> dict:
        from pilosa_tpu_torch.obs import stats
        return _jsonable(stats.get().payload(limit=_STATS_PROFILES))

    @staticmethod
    def _armed_faults() -> list[dict]:
        from pilosa_tpu_torch.obs import faults
        return faults.active()

    @staticmethod
    def _host_stats() -> dict:
        from pilosa_tpu_torch.obs import diagnostics
        return diagnostics.host_snapshot()

    @staticmethod
    def _log_tail() -> list[str]:
        from pilosa_tpu_torch.obs import logger
        return logger.ring.recent(_LOG_LINES)

    @staticmethod
    def _profile_windows() -> list[dict]:
        from pilosa_tpu_torch.obs import profiler
        return profiler.profile_windows()

    # size bound: halve the biggest list-valued sections until the
    # serialized bundle fits — a forensics bundle that OOMs the node
    # it's diagnosing would be its own incident
    _SHRINKABLE = ("trace", "flight", "log_tail", "profile", "stacks")

    def _bound(self, bundle: dict) -> int:
        nbytes = len(json.dumps(bundle, default=str))
        for _ in range(24):
            if nbytes <= self.max_bundle_bytes:
                break
            sizes = {}
            for key in self._SHRINKABLE:
                v = bundle.get(key)
                if isinstance(v, dict):  # chrome trace {traceEvents}
                    v = v.get("traceEvents")
                if isinstance(v, list) and v:
                    sizes[key] = len(json.dumps(
                        bundle[key], default=str))
            if not sizes:
                break
            key = max(sizes, key=sizes.get)
            v = bundle[key]
            if isinstance(v, dict):
                ev = v.get("traceEvents", [])
                if len(ev) <= 1:
                    bundle[key] = {"truncated": True}
                else:
                    v["traceEvents"] = ev[: len(ev) // 2]
                    v["truncated"] = True
            elif len(v) <= 1:
                bundle[key] = [{"truncated": True}] \
                    if key == "stacks" else ["<truncated>"]
            else:
                bundle[key] = v[: len(v) // 2]
            bundle["truncated"] = True
            nbytes = len(json.dumps(bundle, default=str))
        return nbytes

    # -- persistence ---------------------------------------------------

    def _persist(self, iid: str, bundle: dict) -> None:
        """tmp + fsync + rename under ``dir`` — a bundle file is
        either absent or complete.  The ``incident-write`` fault seam
        mimics a crash mid-write: half the tmp file lands, the
        'process dies', the rename never happens — the listing serves
        no half bundle (same contract as storage/stats_store.py)."""
        from pilosa_tpu_torch.obs import faults
        os.makedirs(self.dir, exist_ok=True)
        path = os.path.join(self.dir, iid + ".json")
        tmp = path + ".tmp"
        payload = json.dumps(bundle, default=str)
        if faults.armed("incident-write"):
            with open(tmp, "w") as f:
                f.write(payload[: max(1, len(payload) // 2)])
            faults.fire("incident-write", path)
        with open(tmp, "w") as f:
            f.write(payload)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        self._prune()

    def _prune(self) -> None:
        """Keep the newest ``max_bundles`` files on disk, and sweep
        torn ``.tmp`` debris (the single capture worker is the only
        writer and prune runs after its own rename, so any tmp seen
        here is a dead crash leftover)."""
        try:
            names = os.listdir(self.dir)
        except OSError:
            return
        files = sorted(f for f in names if f.startswith("inc-")
                       and f.endswith(".json"))
        doomed = files[: max(0, len(files) - self.max_bundles)]
        doomed += [f for f in names
                   if f.startswith("inc-") and f.endswith(".tmp")]
        for f in doomed:
            try:
                os.remove(os.path.join(self.dir, f))
            except OSError:
                pass

    # -- read surface --------------------------------------------------

    def list(self, limit: int = 50) -> list[dict]:
        """Newest-first bundle metadata — in-memory ring merged with
        the on-disk listing (a restarted node still serves the
        bundles its predecessor captured)."""
        with self._lock:
            out = {m["id"]: dict(m) for m in self._meta}
        if self.dir and os.path.isdir(self.dir):
            for f in os.listdir(self.dir):
                # .tmp files are torn writes — never listed
                if not f.startswith("inc-") or not f.endswith(".json"):
                    continue
                iid = f[:-5]
                if iid in out:
                    out[iid]["persisted"] = True
                    continue
                p = os.path.join(self.dir, f)
                try:
                    st = os.stat(p)
                    # id shape: inc-<ts>-<seq>-<token>-<trigger>;
                    # only the trigger may itself contain dashes
                    out[iid] = {"id": iid,
                                "time": st.st_mtime,
                                "trigger": iid.split("-", 4)[-1],
                                "detail": "",
                                "bytes": st.st_size,
                                "persisted": True}
                except OSError:
                    continue
        items = sorted(out.values(), key=lambda m: -m["time"])
        return items[: max(0, int(limit))]

    def fetch(self, iid: str) -> dict | None:
        """One full bundle by id — memory first, then disk."""
        with self._lock:
            for b in reversed(self._bundles):
                if b["id"] == iid:
                    return b
        if self.dir and "/" not in iid and os.sep not in iid:
            p = os.path.join(self.dir, iid + ".json")
            try:
                with open(p) as f:
                    return json.load(f)
            except (OSError, ValueError):
                return None
        return None

    def payload(self, limit: int = 50) -> dict:
        """The /debug/incidents listing payload (watchdog registry
        state rides along — stalls and bundles are one story)."""
        from pilosa_tpu_torch.obs import watchdog
        return {"enabled": _enabled,
                "incidents": self.list(limit),
                "suppressed": dict(self.suppressed),
                "watchdog": watchdog.watches(),
                "dir": self.dir}

    def clear(self) -> None:
        """Test seam: forget in-memory state (disk untouched) and
        reset the rate limiter."""
        with self._lock:
            self._bundles.clear()
            self._meta.clear()
            self._last.clear()
            self.suppressed.clear()


def _jsonable(v, depth: int = 0):
    """Defensive JSON coercion for operator-supplied context dicts
    and cross-module payloads."""
    if depth > 6:
        return str(v)
    if isinstance(v, dict):
        return {str(k): _jsonable(x, depth + 1) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_jsonable(x, depth + 1) for x in v]
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    return str(v)


# ---------------------------------------------------------------------------
# process-global manager + module-level trigger entries
# ---------------------------------------------------------------------------

_manager: IncidentManager | None = None
_mgr_lock = threading.Lock()


def get() -> IncidentManager:
    global _manager
    m = _manager
    if m is not None:
        return m
    with _mgr_lock:
        if _manager is None:
            _manager = IncidentManager()
        return _manager


def swap(manager: IncidentManager | None) -> IncidentManager | None:
    """Test seam: replace the process manager, returning the prior
    one so fixtures restore exactly what they found."""
    global _manager
    with _mgr_lock:
        prev, _manager = _manager, manager
    return prev


def enabled() -> bool:
    return _enabled


def configure(enabled: bool | None = None, dir: str | None = None,
              min_interval_s: float | None = None,
              max_bundles: int | None = None,
              max_bundle_bytes: int | None = None,
              slo_burn_threshold: float | None = None,
              config_snapshot: dict | None = None) -> IncidentManager:
    """Apply the [incidents] config knobs.  ``enabled=None`` leaves
    the switch as it is.  A dir change
    just points persistence at the new data dir (the in-memory ring
    carries over — bundles already captured stay fetchable)."""
    global _enabled
    if enabled is not None:
        _enabled = bool(enabled)
    m = get()
    if dir is not None:
        m.dir = dir or None
    if min_interval_s is not None:
        m.min_interval_s = float(min_interval_s)
    if max_bundles is not None:
        m.max_bundles = int(max_bundles)
    if max_bundle_bytes is not None:
        m.max_bundle_bytes = int(max_bundle_bytes)
    if slo_burn_threshold is not None:
        m.slo_burn_threshold = float(slo_burn_threshold)
    if config_snapshot is not None:
        m.config_snapshot = _jsonable(config_snapshot)
    return m


def report(trigger: str, detail: str = "",
           context: dict | None = None) -> bool:
    """The trigger hot path: no-op when the plane is off; otherwise
    one rate-limit check + a queue append (capture is async)."""
    if not _enabled:
        return False
    try:
        return get().report(trigger, detail, context)
    except Exception:
        return False  # forensics must never fail the caller


def note_slo(payload: dict) -> None:
    """SLO-plane hook (obs/slo.py evaluate): a burn rate at/over the
    threshold on a COVERED window is an incident — uncovered windows
    (short uptime, ring eviction) stay advisory."""
    if not _enabled:
        return
    try:
        thr = get().slo_burn_threshold
        if thr <= 0:
            return
        for name, slo in (payload.get("slos") or {}).items():
            for label, w in (slo.get("windows") or {}).items():
                if not w.get("window_covered"):
                    continue
                burn = float(w.get("burn_rate", 0.0))
                if burn >= thr:
                    report("slo-burn", detail=f"{name}:{label}",
                           context={"slo": name, "window": label,
                                    "burn_rate": burn,
                                    "threshold": thr,
                                    "bad": w.get("bad"),
                                    "total": w.get("total")})
                    return  # one bundle covers the whole evaluation
    except Exception:
        pass
