"""Continuous correctness auditing: the serving plane's shadow.

Every answer the port serves comes from a path that can go silently
wrong (delta-patched device stacks, sparse re-encodings, the fused and
ragged programs, write-through standing results, the version-guarded
result cache).  This module keeps sampled, budgeted verifiers running
against served traffic:

- **Shadow execution**: the serving layer samples a fraction of
  completed reads a route (``configure(sample_rate=, route_rates=)``).
  A sampled serve records the query, its shard set, the
  fragment-version snapshot that provably covers the served answer,
  and a digest of the result; a background worker re-executes it on
  an independent oracle arm (a private ``Executor`` on the same device
  with ``use_stacked`` off: the per-shard engine, no serving layer, no
  fused or ragged program, no result cache) and compares digests.  If
  writes advanced past the snapshot (checked before and after the
  shadow run) the sample is skipped and counted (``stale_skip``),
  never a false positive.  Shadow runs take the scheduler's
  lowest-priority ``audit`` class (executor/sched.py), whose own
  concurrency cap keeps them off the serving threads; a full queue or
  a busy cap sheds the audit (counted), never the query.

- **Scrubbers** (``scrub``, on a maintenance tick): a ResultCache
  audit (sampled cached entries recomputed on the oracle under the
  entry's own snapshot guard) and a standing-query drift audit
  (maintained results against one cold execution at quiesce points),
  and on a cluster node the replica scrub: ``replica_scrub``, which
  ``ClusterNode`` sets to its ``audit_scrub`` (block checksums of its
  fragments against a live co-owner; a divergence is counted as a
  detection, then repaired through the rejoin's block pull).

- **Time**: the seconds of every shadow execution count into
  ``pilosa_audit_shadow_seconds_total`` when it ends;
  ``shadow_seconds()`` adds the ones still running, so a window that
  ends inside a 20-50 s shadow counts the part inside it.

- **Evidence**: every outcome counts into
  ``pilosa_audit_total{kind,outcome}``; a mismatch lands in a bounded
  quarantine ring and reports a rate-limited ``audit-mismatch``
  incident (obs/incidents.py) with both digests, the plan fingerprint
  and the live arm's evidence.

``corrupt_results`` is the ``audit-corrupt`` fault point's payload,
the injection that proves the auditor detects.  The knobs go through
``configure()`` only; the port reads no environment for them.
"""

from __future__ import annotations

import hashlib
import json
import random
import threading
import time
import weakref
from collections import OrderedDict, deque

from pilosa_tpu_torch.obs import faults, incidents, metrics
from pilosa_tpu_torch.obs.monitor import capture_exception

# -- module config (the [audit] knobs, set through configure()) --------

_ENABLED = True
_SAMPLE_RATE = 0.01
_ROUTE_RATES: dict[str, float] = {}
_QUEUE_MAX = 64
_CONCURRENCY = 1
_SCRUB_CACHE_N = 4
_SCRUB_STANDING_N = 2
_SCRUB_REPLICA_N = 2
_QUARANTINE = 32
_RECENT = 64
# bounded key->query side-table: the result cache's key carries only a
# canonical call repr (not re-parseable), so the cache scrubber can
# only recompute entries whose query it has seen served
_KEYS_MAX = 512


def configure(enabled: bool | None = None, sample_rate=None,
              route_rates=None, queue_max=None, concurrency=None,
              scrub_cache_n=None, scrub_standing_n=None,
              scrub_replica_n=None, quarantine=None) -> None:
    global _ENABLED, _SAMPLE_RATE, _ROUTE_RATES, _QUEUE_MAX, \
        _CONCURRENCY, _SCRUB_CACHE_N, _SCRUB_STANDING_N, \
        _SCRUB_REPLICA_N, _QUARANTINE
    if enabled is not None:
        _ENABLED = bool(enabled)
    if sample_rate is not None:
        _SAMPLE_RATE = max(0.0, min(1.0, float(sample_rate)))
    if route_rates is not None:
        _ROUTE_RATES = (dict(route_rates)
                        if isinstance(route_rates, dict)
                        else parse_route_rates(route_rates))
    if queue_max is not None:
        _QUEUE_MAX = max(1, int(queue_max))
    if concurrency is not None:
        _CONCURRENCY = max(1, int(concurrency))
    if scrub_cache_n is not None:
        _SCRUB_CACHE_N = max(0, int(scrub_cache_n))
    if scrub_standing_n is not None:
        _SCRUB_STANDING_N = max(0, int(scrub_standing_n))
    if scrub_replica_n is not None:
        _SCRUB_REPLICA_N = max(0, int(scrub_replica_n))
    if quarantine is not None:
        _QUARANTINE = max(1, int(quarantine))


def enabled() -> bool:
    return _ENABLED


def parse_route_rates(spec: str | None) -> dict[str, float]:
    """"cached=0.05,fused=0.01" -> {"cached": 0.05, ...}; malformed
    entries are ignored (an operator typo must not kill serving)."""
    out: dict[str, float] = {}
    for part in (spec or "").split(","):
        part = part.strip()
        if not part or "=" not in part:
            continue
        name, _, v = part.partition("=")
        try:
            rate = float(v)
        except ValueError:
            continue
        if name.strip():
            out[name.strip()] = max(0.0, min(1.0, rate))
    return out


# -- digests and the corruption seam ----------------------------------

def result_digest(results) -> str:
    """Short stable digest of a result list: the canonical wire
    serialization (api.serialize_result), so host/device/NumPy scalar
    type differences never alias as mismatches, except that a row
    result hashes its shards' raw words and its keys (a dense row's
    column list would cost far more than the query)."""
    from pilosa_tpu_torch.executor.results import RowResult
    if isinstance(results, list) and any(isinstance(r, RowResult)
                                         for r in results):
        import numpy as np
        h = hashlib.blake2b(digest_size=8)
        for r in results:
            if isinstance(r, RowResult):
                for s in sorted(r.segments):
                    h.update(f"|{s}:".encode())
                    h.update(np.ascontiguousarray(
                        r.segments[s], dtype=np.uint32).tobytes())
                h.update(repr(r.keys).encode())
            else:
                h.update(f"|{result_digest([r])}".encode())
        return h.hexdigest()
    try:
        from pilosa_tpu_torch import api as _api
        if isinstance(results, list):
            payload = json.dumps(
                [_api.serialize_result(r) for r in results],
                sort_keys=True, default=str)
        else:  # standing SQL results (SQLResult) and friends
            payload = repr(results)
    except Exception:
        payload = repr(results)
    return hashlib.blake2b(payload.encode(),
                           digest_size=8).hexdigest()


def corrupt_results(results):
    """The ``audit-corrupt`` drill payload: a copy of ``results`` with
    one bit flipped in the first result — the injection that PROVES
    the auditor detects (obs/faults.py table).  Never mutates the
    input (the caller decides whether the corrupt copy replaces a
    served answer, a cached entry, or a maintained result)."""
    if isinstance(results, list) and results:
        return [_flip_bit(results[0])] + list(results[1:])
    return _flip_bit(results)


def _flip_bit(r):
    from pilosa_tpu_torch.executor.results import (
        Pair,
        RowResult,
        ValCount,
    )
    import numpy as np
    if isinstance(r, bool):
        return not r
    if isinstance(r, (int, np.integer)):
        return int(r) ^ 1
    if isinstance(r, float):
        return -r if r else 1.0
    if isinstance(r, ValCount):
        return ValCount(value=(int(r.value) ^ 1
                               if r.value is not None else 1),
                        count=r.count)
    if isinstance(r, Pair):
        return Pair(id=r.id, count=int(r.count) ^ 1, key=r.key)
    if isinstance(r, RowResult):
        out = RowResult()
        out.segments = dict(r.segments)
        out.keys = r.keys
        for shard, words in out.segments.items():
            w = np.array(words, copy=True)
            if w.size:
                w.flat[0] = int(w.flat[0]) ^ 1
                out.segments[shard] = w
                return out
        # empty row: invent one bit in shard 0
        w = np.zeros(16, dtype=np.uint64)
        w[0] = 1
        out.segments[0] = w
        return out
    if isinstance(r, list) and r:
        return [_flip_bit(r[0])] + list(r[1:])
    if isinstance(r, tuple) and r:
        return (_flip_bit(r[0]),) + tuple(r[1:])
    return 1 if r is None else r


# -- samples ----------------------------------------------------------

class _Sample:
    __slots__ = ("kind", "index", "q", "sql", "shards", "key",
                 "fields", "snapshot", "digest", "route", "fp", "rec",
                 "t")

    def __init__(self, kind, index, q, shards, key, fields, snapshot,
                 digest, route, fp=None, rec=None, sql=None):
        self.kind = kind          # shadow | cache | standing
        self.index = index
        self.q = q                # pql.ast.Query (None for SQL)
        self.sql = sql            # SQL text for standing SQL audits
        self.shards = shards
        self.key = key
        self.fields = fields
        self.snapshot = snapshot  # proven to cover ``digest``
        self.digest = digest
        self.route = route
        self.fp = fp
        self.rec = rec            # live flight record (ring dict)
        self.t = time.time()


class AuditPlane:
    """One per ServingLayer: the bounded sampler queue, the shadow
    worker(s), the scrub cursors, and the evidence rings."""

    def __init__(self, serving):
        _PLANES.add(self)
        self.serving = serving
        self._cv = threading.Condition()
        self._queue: deque[_Sample] = deque()
        self._workers: list[threading.Thread] = []
        self._inflight = 0
        self._stop = False
        self._rng = random.Random(0xA0D17)
        self.recent: deque[dict] = deque(maxlen=_RECENT)
        self.quarantine: deque[dict] = deque(maxlen=max(1, _QUARANTINE))
        self.counts: dict[tuple, int] = {}
        self._seq = 0
        self._oracle = None
        self._oracle_lock = threading.Lock()
        self._sql_oracle = None
        # serve-time key -> (index, q, shards, fields) so the cache
        # scrubber can recompute entries (bounded; see _KEYS_MAX)
        self._keys: OrderedDict[tuple, tuple] = OrderedDict()
        self._keys_lock = threading.Lock()
        self._cache_cursor = 0
        self._standing_cursor = 0
        # set by ClusterNode: the replica scrub (this module stays
        # cluster-agnostic; the coordinator owns placement and repair)
        self.replica_scrub = None
        self.scrub_stats = {"ticks": 0, "cache_scanned": 0,
                            "standing_scanned": 0,
                            "replica_scanned": 0}

    # -- hot sampler ---------------------------------------------------

    def seed(self, seed: int) -> None:
        """Deterministic sampling for the seeded property tests."""
        self._rng = random.Random(seed)

    def maybe_sample(self, index, idx, q, shards, key, fields, snap,
                     route, results, fl) -> None:
        """The serve-time sampling decision.  The not-sampled path —
        one rate lookup + one RNG draw — is the fixed cost every
        served read pays."""
        rate = _ROUTE_RATES.get(route, _SAMPLE_RATE)
        if rate <= 0.0 or self._rng.random() >= rate:
            return
        if fields is None or snap is None:
            # Uncacheable read set / registry gap: no snapshot can
            # prove what state the answer reflects, so a shadow
            # comparison could false-positive — never sample these
            self._count("shadow", "unguarded")
            return
        s = _Sample("shadow", index, q, shards, key, fields, snap,
                    result_digest(results), route,
                    fp=_fp(key), rec=fl)
        with self._keys_lock:
            self._keys[key] = (index, q, shards, fields)
            self._keys.move_to_end(key)
            while len(self._keys) > _KEYS_MAX:
                self._keys.popitem(last=False)
        if fl is not None:
            # pre-commit stamp: flight.commit() update()s the same
            # dict it stores, so the flag survives into the ring and
            # /debug/queries?audited=1 can find the record
            fl["audited"] = True
        self._enqueue(s)

    def _enqueue(self, s: _Sample) -> None:
        with self._cv:
            if len(self._queue) >= _QUEUE_MAX:
                # backpressure sheds the AUDIT, never the query
                self._count(s.kind, "shed")
                if s.rec is not None:
                    s.rec["audit_outcome"] = "shed"
                return
            self._queue.append(s)
            self._ensure_workers_locked()
            self._cv.notify()
        self._count(s.kind, "sampled")

    # -- worker --------------------------------------------------------

    def _ensure_workers_locked(self) -> None:
        want = max(1, _CONCURRENCY)
        self._workers = [w for w in self._workers if w.is_alive()]
        while len(self._workers) < want:
            t = threading.Thread(target=self._run, daemon=True,
                                 name=f"audit-worker-"
                                      f"{len(self._workers)}")
            self._workers.append(t)
            t.start()

    def _run(self) -> None:
        while True:
            with self._cv:
                while not self._queue and not self._stop:
                    self._cv.wait(0.25)
                if self._stop and not self._queue:
                    return
                s = self._queue.popleft()
                self._inflight += 1
            try:
                self._verify(s)
            except Exception as e:
                capture_exception(e, where="audit.worker",
                                  kind=s.kind, index=s.index)
                self._finish(s, "error", None, f"{type(e).__name__}: {e}")
            finally:
                with self._cv:
                    self._inflight -= 1
                    self._cv.notify_all()

    def wait_idle(self, timeout: float = 5.0) -> bool:
        """Test/bench seam: block until every queued sample has been
        verified (or the timeout passes)."""
        deadline = time.monotonic() + timeout
        with self._cv:
            while self._queue or self._inflight:
                rem = deadline - time.monotonic()
                if rem <= 0:
                    return False
                self._cv.notify_all()
                self._cv.wait(min(rem, 0.05))
        return True

    def close(self) -> None:
        with self._cv:
            self._stop = True
            self._cv.notify_all()

    def stop(self, timeout: float = 5.0) -> bool:
        """Stop the workers after the queue drains and join them;
        True when every worker ended within ``timeout``."""
        self.close()
        deadline = time.monotonic() + timeout
        for w in list(self._workers):
            w.join(max(0.0, deadline - time.monotonic()))
        alive = any(w.is_alive() for w in self._workers)
        with self._cv:
            self._workers = [w for w in self._workers if w.is_alive()]
            if not alive:
                self._stop = False
        return not alive

    # -- the shadow run ------------------------------------------------

    def _verify(self, s: _Sample) -> None:
        from pilosa_tpu_torch.executor.serving import _shard_set, field_snapshot
        srv = self.serving
        ex = srv.executor
        idx = ex.holder.index(s.index)
        if idx is None:
            self._finish(s, "stale_skip", None, "index dropped")
            return
        sset = _shard_set(s.shards)
        if field_snapshot(idx, s.fields, sset) != s.snapshot:
            # writes advanced past the recorded snapshot before the
            # shadow could run: skipped-and-counted, by design
            self._finish(s, "stale_skip", None,
                         "writes advanced before shadow run")
            return
        # dedicated lowest-priority admission: the audit class has its
        # own concurrency cap on the serving scheduler — a busy cap
        # sheds the audit, it never waits on (or steals) serving slots
        sched = srv.sched
        slot = sched.audit_slot() if sched is not None else None
        if sched is not None and slot is None:
            self._finish(s, "shed", None, "audit slots busy")
            return
        t0 = time.perf_counter()
        me = object()
        with _shadow_lock:
            _shadow_open[me] = t0
        try:
            got = self._shadow_exec(s)
        finally:
            _shadow_ended(me, t0, time.perf_counter())
            if slot is not None:
                slot.release()
        if field_snapshot(idx, s.fields, sset) != s.snapshot:
            # a write raced the shadow run itself: the oracle answer
            # may span versions — skip, never a false positive
            self._finish(s, "stale_skip", None,
                         "writes raced the shadow run")
            return
        d = result_digest(got)
        if d == s.digest:
            self._finish(s, "match", d)
        else:
            self._mismatch(s, d, got)

    def _shadow_exec(self, s: _Sample):
        if s.sql is not None:
            return self._sql_oracle_engine().query_one(s.sql)
        return self.oracle().execute(s.index, s.q, s.shards)

    def oracle(self):
        """The independent verification arm: a private Executor on the
        serving executor's device with ``use_stacked`` off (the
        per-shard engine, its own tile cache).  No serving layer, no
        fused or ragged program, no result cache."""
        with self._oracle_lock:
            if self._oracle is None:
                from pilosa_tpu_torch.executor.executor import Executor
                live = self.serving.executor
                o = Executor(live.holder, device=live.device)
                o.use_stacked = False
                self._oracle = o
            return self._oracle

    def _sql_oracle_engine(self):
        with self._oracle_lock:
            if self._sql_oracle is None:
                from pilosa_tpu_torch.sql.engine import SQLEngine
                holder = self.serving.executor.holder
                # engine over the oracle arm: its inner PQL dispatch
                # rides the per-shard engine, never the serving plane
                self._sql_oracle = SQLEngine(holder, self.oracle())
            return self._sql_oracle

    # -- outcomes ------------------------------------------------------

    def _count(self, kind: str, outcome: str) -> None:
        metrics.AUDIT_TOTAL.inc(kind=kind, outcome=outcome)
        k = (kind, outcome)
        with self._cv:
            self.counts[k] = self.counts.get(k, 0) + 1

    def _finish(self, s: _Sample, outcome: str, shadow_digest,
                note: str = "") -> None:
        self._count(s.kind, outcome)
        if s.rec is not None:
            s.rec["audit_outcome"] = outcome
        ent = {"time": round(s.t, 3), "kind": s.kind,
               "outcome": outcome, "index": s.index,
               "query": _qtext(s), "route": s.route,
               "fingerprint": s.fp}
        if note:
            ent["note"] = note
        self.recent.append(ent)

    def _mismatch(self, s: _Sample, shadow_digest: str, got) -> None:
        with self._cv:
            self._seq += 1
            seq = self._seq
        ent = {
            "id": f"aud-{int(s.t)}-{seq}",
            "time": round(s.t, 3),
            "kind": s.kind,
            "index": s.index,
            "query": _qtext(s),
            "route": s.route,
            "fingerprint": s.fp,
            "shards": (sorted(s.shards)
                       if s.shards is not None else None),
            "live_digest": s.digest,
            "shadow_digest": shadow_digest,
            "live_arm": self._live_arm(s),
            "shadow_arm": {"arm": "per-shard", "use_stacked": False,
                           "serving": False, "cache": False},
        }
        self.quarantine.append(ent)
        self._finish(s, "mismatch", shadow_digest,
                     f"live {s.digest} != shadow {shadow_digest}")
        incidents.report(
            "audit-mismatch",
            detail=(f"{s.kind} audit mismatch on {s.index} "
                    f"[{s.route}]: live {s.digest} != shadow "
                    f"{shadow_digest}"),
            context=ent)

    def _live_arm(self, s: _Sample) -> dict:
        """Which arm produced the live answer: the serve route plus
        the flight record's stack and encoding evidence, and the width
        of the mesh it ran on (``mesh_devices``: the engine's mesh arm or
        the serving mesh), where one runs (the record is
        the same ring dict: by verify time commit() has filled the
        device-side fields in)."""
        arm = {"route": s.route, "use_stacked": bool(
            getattr(self.serving.executor, "use_stacked", False))}
        rec = s.rec
        if isinstance(rec, dict):
            for k in ("stack", "stack_keys", "page_mix",
                      "bytes_moved", "batch", "trace_id"):
                if k in rec:
                    arm[k] = rec[k]
        eng = getattr(self.serving.executor, "stacked", None)
        mesh = getattr(eng, "mesh", None)
        if mesh is not None:
            arm["mesh_devices"] = mesh.size
        else:
            from pilosa_tpu_torch.memory import placement
            if placement.mesh_devices() > 1:
                arm["mesh_devices"] = placement.mesh_devices()
        return arm

    # -- maintenance-ticker scrubbers ----------------------------------

    def scrub(self) -> None:
        """One maintenance pass: cache audit, standing drift audit and
        (on a cluster node) the replica scrub, each budgeted by its
        scrub_*_n knob."""
        if not enabled():
            return
        self.scrub_stats["ticks"] += 1
        try:
            self._scrub_cache(_SCRUB_CACHE_N)
        except Exception as e:
            capture_exception(e, where="audit.scrub_cache")
        try:
            self._scrub_standing(_SCRUB_STANDING_N)
        except Exception as e:
            capture_exception(e, where="audit.scrub_standing")
        if self.replica_scrub is not None and _SCRUB_REPLICA_N > 0:
            try:
                self.scrub_stats["replica_scanned"] += int(
                    self.replica_scrub(_SCRUB_REPLICA_N) or 0)
            except Exception as e:
                capture_exception(e, where="audit.scrub_replica")

    def _scrub_cache(self, budget: int) -> None:
        cache = self.serving.cache
        if cache is None or budget <= 0:
            return
        with self._keys_lock:
            known = list(self._keys.items())
        if not known:
            return
        picked = 0
        n = len(known)
        for i in range(n):
            if picked >= budget:
                break
            key, (index, q, shards, fields) = known[
                (self._cache_cursor + i) % n]
            with cache._lock:
                ent = cache._entries.get(key)
            if ent is None or q is None:
                continue
            picked += 1
            # the entry's OWN snapshot is the guard: the worker
            # re-executes on the oracle and compares only if the
            # fragment versions still match what the entry recorded
            s = _Sample("cache", index, q, shards, key, ent[0],
                        ent[1], result_digest(ent[2]), "cache_scrub",
                        fp=_fp(key))
            self._enqueue(s)
        self._cache_cursor = (self._cache_cursor + picked) % max(1, n)
        self.scrub_stats["cache_scanned"] += picked

    def _scrub_standing(self, budget: int) -> None:
        reg = getattr(self.serving, "standing", None)
        if reg is None or budget <= 0:
            return
        with reg._lock:
            sqs = sorted(reg._by_id.values(), key=lambda s: s.sid)
        if not sqs:
            return
        n = len(sqs)
        picked = 0
        for i in range(n):
            if picked >= budget:
                break
            sq = sqs[(self._standing_cursor + i) % n]
            with sq.lock:
                if sq.error is not None or sq.results is None:
                    continue
                snap = sq.snapshot
                digest = result_digest(sq.results)
            picked += 1
            # drift audit at quiesce: the worker's pre/post snapshot
            # guard IS the quiesce check — a registration mid-write
            # stream skips-and-counts instead of false-positiving
            s = _Sample("standing", sq.index, sq.q, None, sq.key,
                        sq.fields, snap, digest, "standing_scrub",
                        fp=sq.fp,
                        sql=getattr(sq, "sql_text", None)
                        if sq.q is None else None)
            self._enqueue(s)
        self._standing_cursor = (self._standing_cursor + picked) \
            % max(1, n)
        self.scrub_stats["standing_scanned"] += picked

    # -- introspection -------------------------------------------------

    def queue_depth(self) -> int:
        with self._cv:
            return len(self._queue) + self._inflight

    def describe(self) -> dict:
        with self._cv:
            counts = {f"{k}:{o}": v
                      for (k, o), v in sorted(self.counts.items())}
            depth = len(self._queue) + self._inflight
        return {
            "queue_depth": depth,
            "queue_max": _QUEUE_MAX,
            "concurrency": _CONCURRENCY,
            "counts": counts,
            "recent": list(self.recent),
            "quarantine": list(self.quarantine),
            "scrub": dict(self.scrub_stats),
            "tracked_keys": len(self._keys),
        }


# every live plane, so stop_all() can end their workers
_PLANES: "weakref.WeakSet[AuditPlane]" = weakref.WeakSet()

# the process's shadow executions besides the finished ones' seconds
# (AUDIT_SHADOW_SECONDS): the (start, end) of the recent ones and the
# start of each running one, on perf_counter (a few a minute: one lock
# is no cost)
_shadow_lock = threading.Lock()
_shadow_recent: deque = deque(maxlen=1024)
_shadow_open: dict = {}


def _shadow_ended(key, t0: float, t1: float) -> None:
    with _shadow_lock:
        _shadow_open.pop(key, None)
        _shadow_recent.append((t0, t1))
        metrics.AUDIT_SHADOW_SECONDS.inc(t1 - t0)


def shadow_seconds(at: float | None = None) -> float:
    """Seconds of shadow execution in this process up to ``at``
    (``perf_counter``, by default now), the ones still running
    included up to then: the difference of two readings is the shadow
    time between them, however long each shadow runs."""
    now = time.perf_counter()
    t = now if at is None else min(at, now)
    with _shadow_lock:
        total = metrics.AUDIT_SHADOW_SECONDS.value()
        # finished after t: take back their part past t
        total -= sum(e - max(s, t) for s, e in _shadow_recent if e > t)
        total += sum(max(0.0, t - s) for s in _shadow_open.values())
    return total


def stop_all(timeout: float = 5.0) -> bool:
    """Stop every live plane's workers; True when all ended."""
    return all([p.stop(timeout) for p in list(_PLANES)])


def _fp(key) -> str:
    return hashlib.blake2b(repr(key).encode(),
                           digest_size=8).hexdigest()


def _qtext(s: _Sample) -> str:
    if s.sql is not None:
        return s.sql
    try:
        return repr(s.q)
    except Exception:
        return "<query>"


# -- the serve-time tap (called by executor/serving.py) ---------------

def tap(plane: AuditPlane | None, index, idx, q, shards, key, fields,
        snap, route, results, fl):
    """Per-serve audit hook: corruption drill seam + sampling
    decision.  ``snap`` must be the snapshot PROVEN to cover
    ``results`` on this route (cache guard / batch post-pass / solo
    store protocol) — a hook-time snapshot could postdate a racing
    write and turn the shadow comparison into a false positive.
    Returns the results to serve (a corrupted COPY while the
    ``audit-corrupt`` drill is armed; the underlying entry is never
    touched on the serve seam)."""
    if plane is None or not enabled():
        return results
    if faults.armed("audit-corrupt") and faults.take(
            "audit-corrupt", f"serve:{route}:{index}"):
        results = corrupt_results(results)
    plane.maybe_sample(index, idx, q, shards, key, fields, snap,
                       route, results, fl)
    return results


def tick(serving) -> None:
    """Maintenance entry point: one scrub pass of the layer's plane."""
    plane = getattr(serving, "audit", None)
    if plane is not None:
        plane.scrub()


def payload(plane: AuditPlane | None) -> dict:
    """The audit plane's state (the JAX package's /debug/audit)."""
    out = {
        "enabled": enabled(),
        "sample_rate": _SAMPLE_RATE,
        "route_rates": dict(_ROUTE_RATES),
        "scrub_budgets": {"cache": _SCRUB_CACHE_N,
                          "standing": _SCRUB_STANDING_N,
                          "replica": _SCRUB_REPLICA_N},
        "active": plane is not None,
    }
    if plane is not None:
        out.update(plane.describe())
    else:
        out.update({"queue_depth": 0, "counts": {}, "recent": [],
                    "quarantine": [], "scrub": {}})
    return out
