"""Query flight recorder — always-on per-query phase attribution.

The serving hot path made a query's execution opaque from
the outside: it may be fused into a leader's multi-program, served
from the versioned result cache, satisfied by a patched device stack,
or trigger a jit recompile — and ``/metrics`` aggregates can't say
which happened to WHICH query.  This module keeps a bounded ring of
per-query *flight records* (trace id, route, phase durations, cache
outcomes, batch occupancy, bytes moved) cheap enough to leave on in
production, feeding:

- ``/debug/queries``  — recent records as JSON (server/http.py)
- ``/debug/trace``    — the same records exported as Chrome
  ``trace_event`` JSON, loadable in Perfetto / chrome://tracing
- ``pilosa_query_phase_seconds`` histograms with exemplar trace ids
  (obs/metrics.py)

Attribution flows through thread-local :class:`Acc` accumulators: the
serving layer pushes one per query, the deep layers (TileStackCache,
the stacked dispatch) call :func:`note_phase`/:func:`note_stack`,
which no-op in a few ns when no accumulator is active.  Work a batch
LEADER performs for a follower is accumulated into a per-request Acc
on the leader's thread and merged into the follower's record when its
event fires (executor/serving.py) — the same cross-thread shape as
``obs.tracing.TraceContext``.
"""

from __future__ import annotations

import itertools
import json
import os
import threading
import time
from collections import deque
from contextlib import contextmanager

# the parts of ``execute`` that a dispatch notes besides it: ``launch``
# (the host enqueueing the work), ``sync`` (the host waiting for the
# card) and, for a fused batch, ``to_host`` (the copy of its outputs)
IN_EXECUTE = frozenset(("launch", "sync", "to_host"))
# phases a record's derived ``wait`` does not subtract from ``batch``:
# those outside the batch (``admit``, the heavy-slot gate before the
# record opened), those inside ``execute``, and itself
NOT_IN_BATCH = frozenset(("admit", "batch", "cache_lookup",
                          "wait")) | IN_EXECUTE

_tls = threading.local()


class Acc:
    """Per-query phase accumulator (seconds + stack-cache outcomes).
    Plain mutable object — only ever touched by one thread at a time
    (the owning request thread, or the leader while it serves the
    request)."""

    __slots__ = ("phases", "stack", "bytes_moved", "keys", "attempts",
                 "t0", "node_spans", "ops", "pages", "intervals")

    # per-record stack-key cap: a pathological query touching hundreds
    # of stacks must not bloat the ring
    _MAX_KEYS = 32
    # per-record attempt cap (cluster fan-out: one entry per per-node
    # RPC attempt incl. hedges — a 100-node fan-out must not bloat
    # the ring either)
    _MAX_ATTEMPTS = 32
    # per-record cap on per-node span-tree payloads (cluster trace
    # propagation): legs past the cap keep their timings in
    # `attempts` but drop the span detail
    _MAX_NODE_SPANS = 16
    # per-record cap on phase intervals (where each phase happened):
    # past it a phase keeps its total but is not drawn
    _MAX_INTERVALS = 64

    def __init__(self):
        self.phases: dict[str, float] = {}
        self.stack: dict[str, int] = {}
        self.bytes_moved = 0
        # (key fingerprint, outcome) per NON-HIT stack access — the
        # prefetcher's prediction signal (memory/policy.py): keys
        # that keep rebuilding are keys worth warming
        self.keys: list[tuple[str, str]] = []
        # per-node RPC attempt timings from the cluster fan-out
        # (node, ms, outcome, start-offset ms) incl. hedge attempts —
        # what makes hedge delays debuggable at /debug/queries, and
        # what renders hedges as parallel spans in /debug/trace
        self.attempts: list[tuple[str, float, str, float]] = []
        # this record's perf_counter origin: attempt/node-span offsets
        # are relative to it so /debug/trace can lay legs out in time
        self.t0 = time.perf_counter()
        # per-node serialized span trees returned in RPC trailers
        # (obs.tracing.span_to_wire): [{"node", "anchor_off_us",
        # "spans"}] — the coordinator's one-timeline-with-node-lanes
        # Perfetto view
        self.node_spans: list[dict] = []
        # op-family roofline shares: op -> [bytes touched, execute s]
        # (obs/roofline.py note() feeds this per device dispatch)
        self.ops: dict[str, list] = {}
        # page-encoding mix of the stack operands this query touched
        # (encoding -> page count; memory/encode.py container kinds) —
        # how a record shows which arm served it, packed or dense
        self.pages: dict[str, int] = {}
        # (phase, perf_counter start, seconds) of each phase noted, on
        # the clock the device trace is placed on
        self.intervals: list[tuple[str, float, float]] = []

    def add_pages(self, mix: dict):
        for k, v in mix.items():
            self.pages[k] = self.pages.get(k, 0) + int(v)

    def add_phase(self, name: str, dt: float, start: float | None = None):
        """Add ``dt`` seconds to a phase that started at ``start``
        (``perf_counter``; by default ``dt`` before now)."""
        self.phases[name] = self.phases.get(name, 0.0) + dt
        if len(self.intervals) < self._MAX_INTERVALS:
            self.intervals.append(
                (name, time.perf_counter() - dt if start is None else start,
                 dt))

    def add_stack(self, outcome: str, nbytes: int, dt: float,
                  key_fp: str | None = None):
        self.stack[outcome] = self.stack.get(outcome, 0) + 1
        self.bytes_moved += int(nbytes)
        self.add_phase("stack_" + outcome, dt)
        if key_fp is not None and len(self.keys) < self._MAX_KEYS:
            self.keys.append((key_fp, outcome))

    def add_attempt(self, node: str, dt: float, outcome: str):
        if len(self.attempts) < self._MAX_ATTEMPTS:
            off = max(time.perf_counter() - self.t0 - dt, 0.0)
            self.attempts.append((node, round(dt * 1e3, 3), outcome,
                                  round(off * 1e3, 3)))

    def add_node_spans(self, node: str, spans: list,
                       anchor_perf: float):
        if spans and len(self.node_spans) < self._MAX_NODE_SPANS:
            self.node_spans.append({
                "node": node,
                "anchor_off_us": max(
                    int((anchor_perf - self.t0) * 1e6), 0),
                "spans": spans,
            })

    def add_op(self, op: str, nbytes: int, dt: float):
        st = self.ops.get(op)
        if st is None:
            st = self.ops[op] = [0, 0.0]
        st[0] += int(nbytes)
        st[1] += dt

    def merge(self, other: "Acc"):
        for k, v in other.phases.items():
            self.phases[k] = self.phases.get(k, 0.0) + v
        for k, v in other.stack.items():
            self.stack[k] = self.stack.get(k, 0) + v
        self.bytes_moved += other.bytes_moved
        room = self._MAX_KEYS - len(self.keys)
        if room > 0 and other.keys:
            self.keys.extend(other.keys[:room])
        room = self._MAX_ATTEMPTS - len(self.attempts)
        if room > 0 and other.attempts:
            self.attempts.extend(other.attempts[:room])
        room = self._MAX_NODE_SPANS - len(self.node_spans)
        if room > 0 and other.node_spans:
            self.node_spans.extend(other.node_spans[:room])
        room = self._MAX_INTERVALS - len(self.intervals)
        if room > 0 and other.intervals:
            self.intervals.extend(other.intervals[:room])
        for op, (b, s) in other.ops.items():
            st = self.ops.get(op)
            if st is None:
                self.ops[op] = [b, s]
            else:
                st[0] += b
                st[1] += s
        self.add_pages(other.pages)


def push_acc(acc: Acc):
    """Install `acc` as this thread's active accumulator; returns the
    previous one to restore via pop_acc."""
    prev = getattr(_tls, "acc", None)
    _tls.acc = acc
    return prev


def pop_acc(prev):
    _tls.acc = prev


def active_acc() -> Acc | None:
    return getattr(_tls, "acc", None)


def note_phase(name: str, dt: float, start: float | None = None):
    acc = getattr(_tls, "acc", None)
    if acc is not None:
        acc.add_phase(name, dt, start)


def note_route(route: str, cap: int = 32):
    """Record a nested serving-path route (fused/cached/direct) into
    the thread's ACTIVE record's ``serving_routes`` list — how a SQL
    statement record (route "sql") shows which of its inner PQL
    dispatches rode the fused plane.  No-op without an open record;
    capped so a many-call statement cannot grow a record without
    bound."""
    rec = getattr(_tls, "rec", None)
    if rec is not None:
        routes = rec.setdefault("serving_routes", [])
        if len(routes) < cap:
            routes.append(route)


def note_stack(outcome: str, nbytes: int, dt: float,
               key_fp: str | None = None):
    acc = getattr(_tls, "acc", None)
    if acc is not None:
        acc.add_stack(outcome, nbytes, dt, key_fp=key_fp)


def note_attempt(node: str, dt: float, outcome: str):
    """Record one cluster per-node RPC attempt (incl. hedges) into
    the active record's ``attempts`` field."""
    acc = getattr(_tls, "acc", None)
    if acc is not None:
        acc.add_attempt(node, dt, outcome)


def note_node_spans(node: str, spans: list, anchor_perf: float):
    """Record a remote (or local-leg) serialized span tree returned
    in an RPC trailer, anchored at the caller-clock instant the
    attempt left (cluster/coordinator.py)."""
    acc = getattr(_tls, "acc", None)
    if acc is not None:
        acc.add_node_spans(node, spans, anchor_perf)


def note_pages(mix: dict):
    """Record the page-encoding mix of one stack operand fetch
    (executor/stacked.py _assemble) into the active record."""
    acc = getattr(_tls, "acc", None)
    if acc is not None:
        acc.add_pages(mix)


def note_op(op: str, nbytes: int, dt: float):
    """Record one device dispatch's roofline share (bytes touched +
    execute seconds) by op family (obs/roofline.py calls this)."""
    acc = getattr(_tls, "acc", None)
    if acc is not None:
        acc.add_op(op, nbytes, dt)


def inherit_trace(trace_id: str | None):
    """Adopt a REMOTE caller's trace id for the next record this
    thread opens (RPC trace propagation: the X-Pilosa-Trace-Id header
    / gRPC trace-id metadata land here, so a remote leg's flight
    record joins the coordinator's under one cluster-wide id).
    Returns the previous value to restore via pop_inherit."""
    prev = getattr(_tls, "inherit", None)
    _tls.inherit = trace_id
    return prev


def pop_inherit(prev):
    _tls.inherit = prev


def current_trace_id() -> str | None:
    """The trace id of this thread's active (or inherited) flight
    record, or None — the log-correlation stamp (obs/logger.py)."""
    rec = getattr(_tls, "rec", None)
    if rec is not None:
        return rec["trace_id"]
    return getattr(_tls, "inherit", None)


@contextmanager
def remote_leg(trace_id: str, keep: int = 8):
    """The remote-leg scaffold every trace-propagating RPC surface
    shares (server/http.py, cluster/coordinator.py's local leg, the
    overhead probe): inherit the caller's trace id so this thread's
    flight record joins it, record the leg's spans on a thread-local
    tracer, and on exit serialize the roots to wire form.  Yields
    ``(tracer, spans)`` — ``spans`` fills AFTER the body exits (wire
    dicts for the response trailer); ``tracer.roots`` keeps the live
    Span objects for callers that need absolute anchors.  One
    implementation so a fix to the pop-ordering or wire shape cannot
    drift between surfaces."""
    from pilosa_tpu_torch.obs import tracing as _tr
    spans: list[dict] = []
    prev_inh = inherit_trace(trace_id)
    tracer = _tr.RecordingTracer(keep=keep)
    prev = _tr.push_thread_tracer(tracer)
    try:
        yield tracer, spans
    finally:
        _tr.pop_thread_tracer(prev)
        pop_inherit(prev_inh)
        spans.extend(_tr.span_to_wire(s) for s in tracer.roots)


class FlightRecorder:
    """Bounded ring of finished per-query flight records."""

    def __init__(self, keep: int = 512, enabled: bool | None = None):
        if enabled is None:
            enabled = os.environ.get("PILOSA_TPU_FLIGHT", "1") != "0"
        self.enabled = enabled
        self._ring: deque[dict] = deque(maxlen=keep)
        self._ids = itertools.count(1)
        self._lock = threading.Lock()

    def configure(self, enabled: bool | None = None,
                  keep: int | None = None):
        """Apply config knobs ([flight] in config.py).  Resizing
        keeps the newest records."""
        if enabled is not None:
            self.enabled = bool(enabled)
        if keep is not None and keep != self._ring.maxlen:
            with self._lock:
                self._ring = deque(self._ring, maxlen=int(keep))

    def next_id(self) -> str:
        return f"q{next(self._ids):x}"  # itertools.count: atomic

    def record(self, rec: dict):
        # LOCK-FREE hot path: deque.append with maxlen is atomic under
        # the GIL, and a contended threading.Lock costs ~20us of GIL
        # ping-pong per acquisition — measured to dominate the whole
        # recorder at serving qps.  Readers snapshot with retry.
        self._ring.append(rec)

    def recent(self, n: int = 100) -> list[dict]:
        """Newest-first records (the /debug/queries payload)."""
        while True:
            try:
                items = list(self._ring)
                break
            except RuntimeError:
                continue  # deque mutated mid-iteration: retry
        return list(reversed(items))[: max(0, int(n))]

    def clear(self):
        self._ring.clear()

    def __len__(self) -> int:
        return len(self._ring)

    # -- Chrome trace_event export -------------------------------------

    def chrome_trace(self, n: int = 100) -> dict:
        """Recent records as the Chrome ``trace_event`` JSON object
        format (loadable in Perfetto / chrome://tracing): one complete
        ("ph": "X") event per query plus one per phase, on a per-query
        virtual thread so concurrent queries render as parallel
        tracks.  Cluster fan-out records additionally render one
        PROCESS LANE per node (``pid`` + a process_name metadata
        event): per-node RPC attempts — hedges as parallel spans —
        and the span trees each node returned in its response
        trailer, all under the query's one trace id."""
        events = []
        # pid 1 is the serving process itself; cluster legs get one
        # pid per node so Perfetto renders per-node lanes
        node_pids: dict[str, int] = {}

        def pid_for(node: str) -> int:
            p = node_pids.get(node)
            if p is None:
                p = node_pids[node] = len(node_pids) + 2
                events.append({"name": "process_name", "ph": "M",
                               "pid": p,
                               "args": {"name": f"node:{node}"}})
            return p

        for rec in self.recent(n):
            ts = rec["start"] * 1e6          # epoch microseconds
            dur = rec["duration_ms"] * 1e3
            tid = rec["trace_id"]
            args = {"index": rec.get("index", ""),
                    "query": rec.get("query", ""),
                    "route": rec.get("route", ""),
                    "batch": rec.get("batch", 1)}
            if rec.get("stack"):
                args["stack"] = rec["stack"]
            if rec.get("bytes_moved"):
                args["bytes_moved"] = rec["bytes_moved"]
            events.append({
                "name": f"query:{rec.get('route', '?')}",
                "cat": "query", "ph": "X", "pid": 1, "tid": tid,
                "ts": ts, "dur": max(dur, 1.0), "args": args,
            })
            # each phase where it happened: its recorded offset from
            # the record's start (a derived ``wait`` has none)
            for name, off_ms, ms in rec.get("intervals", ()):
                events.append({
                    "name": name, "cat": "phase", "ph": "X",
                    "pid": 1, "tid": tid, "ts": ts + off_ms * 1e3,
                    "dur": max(ms * 1e3, 0.5),
                    "args": {"ms": ms},
                })
            # cluster fan-out: per-node attempt slices (true start
            # offsets — a hedge renders in parallel with the primary
            # attempt it raced) ...
            for a in rec.get("attempts", ()):
                events.append({
                    "name": f"attempt:{a.get('outcome', '?')}",
                    "cat": "attempt", "ph": "X",
                    "pid": pid_for(str(a.get("node", "?"))),
                    "tid": tid,
                    "ts": ts + a.get("t_off_ms", 0.0) * 1e3,
                    "dur": max(a.get("ms", 0.0) * 1e3, 0.5),
                    "args": {"trace_id": tid,
                             "node": a.get("node"),
                             "outcome": a.get("outcome")},
                })
            # ... and the span trees each leg returned in its
            # response trailer, re-anchored on the coordinator clock
            for ent in rec.get("node_spans", ()):
                pid = pid_for(str(ent.get("node", "?")))
                base = ts + ent.get("anchor_off_us", 0)
                stack = list(ent.get("spans", ()))
                while stack:
                    w = stack.pop()
                    ev = {"name": str(w.get("name", "span")),
                          "cat": "node", "ph": "X", "pid": pid,
                          "tid": tid,
                          "ts": base + w.get("off_us", 0),
                          "dur": max(w.get("dur_us", 0), 0.5),
                          "args": {"trace_id": tid,
                                   "node": ent.get("node")}}
                    if w.get("tags"):
                        ev["args"]["tags"] = w["tags"]
                    events.append(ev)
                    stack.extend(w.get("children", ()))
        return {"traceEvents": events, "displayTimeUnit": "ms",
                "otherData": {"source": "pilosa-tpu flight recorder"}}

    def chrome_trace_json(self, n: int = 100) -> str:
        return json.dumps(self.chrome_trace(n))


# process-global recorder (the /debug surface and metrics exemplars
# read this one); config.apply_flight_settings() reconfigures it
recorder = FlightRecorder()


def begin(index: str, query) -> dict | None:
    """Open a flight record for this thread's query, or None when the
    recorder is off or a record is already active (nested execute calls
    — e.g. the serving layer's direct fallback re-entering
    Executor.execute — must not double-record)."""
    if not recorder.enabled or getattr(_tls, "rec", None) is not None:
        return None
    inherited = getattr(_tls, "inherit", None)
    rec = {
        "trace_id": inherited or recorder.next_id(),
        "index": index,
        "query": str(query)[:200],
        "start": time.time(),
        "acc": Acc(),
    }
    # the record's origin on perf_counter, the clock of spans and of the
    # device trace; phase intervals are offsets from it
    rec["t0"] = rec["acc"].t0
    if inherited:
        # a remote leg of a cluster fan-out: same id as the
        # coordinator's record so /debug/cluster/queries merges them
        rec["inherited"] = True
    _tls.rec = rec
    rec["prev_acc"] = push_acc(rec["acc"])
    return rec


def commit(rec: dict | None, duration_s: float, route: str = "solo",
           batch: int = 1, error: str | None = None,
           fingerprint: str | None = None,
           extra_acc: Acc | None = None, batch_id: str | None = None):
    """Finish and ring-buffer a record opened by begin(); exports the
    per-phase histograms with this record's trace id as exemplar.
    With no record of its own (a read nested in a SQL statement's
    record), ``extra_acc``, the leader's work for the read, merges into
    the thread's active accumulator, the statement's.  ``batch_id``
    names the serving batch the query rode (the ``serving.batch``
    span's tag)."""
    if rec is None:
        if extra_acc is not None:
            acc = getattr(_tls, "acc", None)
            if acc is not None:
                acc.merge(extra_acc)
        return
    acc: Acc = rec.pop("acc")
    pop_acc(rec.pop("prev_acc"))
    _tls.rec = None
    if extra_acc is not None:
        acc.merge(extra_acc)
    # wait = time parked in the batcher not accounted to a device
    # phase (admission window + other requests' share of the batch).
    # Derived INTO acc.phases so it reaches the phase histogram, not
    # just the record dict.
    if "batch" in acc.phases:
        accounted = sum(v for k, v in acc.phases.items()
                        if k not in NOT_IN_BATCH)
        acc.phases["wait"] = max(acc.phases["batch"] - accounted, 0.0)
    phases = {k: round(v * 1e3, 4) for k, v in acc.phases.items()}
    rec.update({
        "duration_ms": round(duration_s * 1e3, 4),
        "route": route,
        "batch": int(batch),
        "phases": phases,
        "stack": dict(acc.stack),
        "bytes_moved": acc.bytes_moved,
        # non-hit stack-key fingerprints feeding the prefetcher's
        # prediction scan (memory/policy.py Prefetcher.step)
        "stack_keys": list(acc.keys),
    })
    if acc.intervals:
        # [phase, start offset ms from t0, ms]: where each phase
        # happened, for /debug/trace and for joining the device trace
        t0 = rec["t0"]
        rec["intervals"] = [[k, round((s - t0) * 1e3, 4),
                             round(d * 1e3, 4)]
                            for k, s, d in acc.intervals]
    if batch_id is not None:
        rec["batch_id"] = batch_id
    if acc.attempts:
        # per-node cluster attempt timings (hedges included) — only
        # fan-out queries carry the field, so solo records stay small.
        # t_off_ms = start offset inside the query, so /debug/trace
        # renders hedges as genuinely PARALLEL spans
        rec["attempts"] = [
            {"node": n, "ms": ms, "outcome": o, "t_off_ms": off}
            for n, ms, o, off in acc.attempts]
    if acc.node_spans:
        # per-node span trees from RPC trailers (+ the local leg) —
        # the /debug/trace node lanes
        rec["node_spans"] = list(acc.node_spans)
    if acc.pages:
        # page-encoding mix of the stack operands touched (sparse
        # device format, memory/encode.py): packed vs dense served
        rec["page_mix"] = dict(acc.pages)
    if acc.ops:
        # roofline share: bytes touched / execute time per op family,
        # with achieved GB/s (and the fraction once the peak is known)
        from pilosa_tpu_torch.obs import roofline
        peak = roofline.peak_or_none()
        rl = {}
        for op, (b, s) in acc.ops.items():
            if s <= 0:
                continue
            ent = {"bytes": b, "ms": round(s * 1e3, 4),
                   "gbps": round(b / s / 1e9, 4)}
            if peak:
                ent["fraction"] = round((b / s) / peak, 5)
            rl[op] = ent
        if rl:
            rec["roofline"] = rl
    if error is not None:
        rec["error"] = error[:200]
    if fingerprint is not None:
        rec["fingerprint"] = fingerprint
    recorder.record(rec)
    _buffer_phase_samples(acc, rec["trace_id"])
    # statistics catalog (obs/stats.py): one enabled check + a
    # lock-free pending append; folding is amortized off the hot path
    from pilosa_tpu_torch.obs import stats as _stats
    _stats.note_flight(rec)


# -- buffered phase-histogram export ----------------------------------------
# A contended threading.Lock costs ~20us of GIL ping-pong per
# acquisition; observing every phase of every query directly into the
# shared histogram would convoy the serving threads.  Samples append
# to a GLOBAL lock-free pending list (list.append is GIL-atomic) and
# drain in one observe_batch() every _FLUSH_N samples — amortizing the
# histogram lock ~64x.  Not per-thread: ThreadingHTTPServer spawns a
# thread per connection, and thread-local buffers would die (samples
# and all) with their threads.  /metrics rendering calls
# flush_metrics() first, so a scrape always sees current samples; the
# tiny race where a concurrent flush orphans an in-flight append loses
# at most a sample or two — acceptable for a latency histogram, never
# for the flight ring (which appends records directly).

_FLUSH_N = 64
_pending: list = []


def flush_metrics():
    """Drain the pending phase samples into the shared
    pilosa_query_phase_seconds histogram (called on /metrics render
    and by tests for determinism)."""
    global _pending
    buf, _pending = _pending, []
    if buf:
        from pilosa_tpu_torch.obs import metrics
        metrics.PHASE_DURATION.observe_batch(buf)


def _buffer_phase_samples(acc: Acc, trace_id: str):
    pend = _pending
    for name, dt in acc.phases.items():
        pend.append((dt, {"phase": name}, trace_id))
    if len(pend) >= _FLUSH_N:
        flush_metrics()
