"""QoS admission for the serving path — classes, fairness, shedding.

The ragged batcher (executor/ragged.py) removes the *dispatch* penalty
of heterogeneous traffic; this module removes the *queueing* penalty.
Real mixed load is a few expensive queries (240-combo GroupBys, broad
Extracts) amid a stream of point reads, and FIFO admission lets one
heavy burst occupy every handler thread so point reads wait behind
device-seconds of scan work.  Three mechanisms, all in front of the
batcher:

- **Admission classes** — every read classifies as ``point`` (cheap
  bitmap/aggregate shapes: the batcher can fuse them, and their device
  cost is microseconds) or ``heavy`` (GroupBy/Extract/Sort/TopN/...).
  Point reads are never queued: they go straight to the cache/batcher.
  Heavy reads pass a bounded concurrency gate (``heavy_slots``), so a
  GroupBy storm saturates at most that many engine threads and the
  device stays responsive for point traffic.  An explicit
  ``X-Pilosa-Priority`` header overrides the classifier.

- **Weighted per-tenant fair queueing** — queued heavy requests drain
  by stride scheduling: each tenant advances a virtual pass by
  1/weight per grant, and the gate always grants the tenant with the
  smallest pass (FIFO within a tenant).  A tenant with weight 4 gets
  4x the grant rate of a weight-1 tenant under contention and exactly
  its demand otherwise.  Weights come from ``[serving]
  tenant-weights`` ("analytics:4,adhoc:1"); unknown tenants get 1.

- **Backpressure** — a bounded total queue (``queue_max``).  Overflow
  sheds with :class:`ServingShedError`, a typed 503 carrying
  Retry-After (a transport renders it on the wire); a request whose deadline (``X-Pilosa-Deadline-Ms``) expires
  while queued — or already arrived dead — sheds with
  :class:`ServingDeadlineExceeded`, a typed 504.  Both count into
  ``pilosa_serving_admission_total{class,outcome}``.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass

from pilosa_tpu_torch.obs import metrics
from pilosa_tpu_torch.pql.ast import Query

CLASS_POINT = "point"
CLASS_HEAVY = "heavy"
# the correctness-audit plane's dedicated lowest-priority class
# (obs/audit.py): its own concurrency cap, non-blocking acquisition —
# audits shed when the cap is busy, they never queue against (or
# steal) serving slots
CLASS_AUDIT = "audit"

# calls whose per-query device/host cost is orders beyond a point
# read: combo enumeration (GroupBy), whole-table materialization
# (Extract/Sort), candidate-row scans (TopN/TopK/Rows), cross-shard
# value walks (Distinct/Percentile).  Everything else — Count, Row
# trees, Sum/Min/Max, IncludesColumn — is a point read.
_HEAVY_CALLS = {"GroupBy", "Extract", "Sort", "Percentile", "TopN",
                "TopK", "Rows", "UnionRows", "Distinct", "Limit"}


class ServingShedError(Exception):
    """Admission queue over budget — typed 503 with Retry-After (the
    HTTP/gRPC layers render ``status`` and ``retry_after_s``)."""

    status = 503

    def __init__(self, msg: str, retry_after_s: float = 1.0):
        super().__init__(msg)
        self.retry_after_s = retry_after_s


class ServingDeadlineExceeded(Exception):
    """The request's deadline passed before it could be admitted."""

    status = 504


@dataclass
class QoS:
    """Per-request quality-of-service intent, parsed from transport
    headers (server/http.py, server/grpc.py).  ``deadline_ms`` is the
    client's total budget; ``deadline_s`` the derived absolute
    monotonic deadline."""

    tenant: str = "default"
    priority: str | None = None     # explicit class override
    deadline_ms: float | None = None
    deadline_s: float | None = None

    @classmethod
    def make(cls, tenant=None, priority=None, deadline_ms=None):
        dl = None
        if deadline_ms is not None and deadline_ms > 0:
            dl = time.monotonic() + float(deadline_ms) / 1e3
        return cls(tenant=str(tenant) if tenant else "default",
                   priority=priority or None,
                   deadline_ms=float(deadline_ms)
                   if deadline_ms is not None else None,
                   deadline_s=dl)


def classify(q: Query, qos: QoS | None,
             fingerprint: str | None = None) -> str:
    """Admission class of a read query.  Explicit priority wins.
    Next, MEASURED cost: when the statistics catalog (obs/stats.py)
    holds a warm profile for this plan fingerprint, the class is the
    estimated cost against ``[stats] heavy-cost-ms`` — a GroupBy that
    measures cheap (tiny combo space, or always cache-served) rides
    the point lane; a Count that measures expensive gates like the
    heavy query it is.  Query KIND is the cold-start fallback: any
    heavy call in the tree makes the query heavy.  Class choice only
    affects scheduling, never results.

    Known tradeoff: the estimate folds in batches, so after a cache
    invalidation a BURST of a cached-cheap-but-expensive-to-compute
    fingerprint (up to one fold batch, ~32 records, per wave) can
    ride the point lane before the estimate re-adapts — bounded, and
    accepted in exchange for not burning heavy slots on sub-ms
    cache-served queries (the measured misclassification win)."""
    if qos is not None and qos.priority in (CLASS_POINT, CLASS_HEAVY):
        return qos.priority
    if fingerprint is not None:
        from pilosa_tpu_torch.obs import stats
        est = stats.est_cost_ms(fingerprint)
        if est is not None:
            cls = (CLASS_HEAVY if est >= stats.heavy_cost_ms()
                   else CLASS_POINT)
            metrics.STATS_ADMISSION.inc(**{"source": "profile",
                                           "class": cls})
            return cls

    def heavy(call) -> bool:
        if call.name in _HEAVY_CALLS:
            return True
        return any(heavy(c) for c in call.children) or any(
            heavy(v) for v in call.args.values()
            if hasattr(v, "children"))

    cls = CLASS_HEAVY if any(heavy(c) for c in q.calls) \
        else CLASS_POINT
    if fingerprint is not None:
        # the catalog was consulted but had no warm profile — count
        # the fallback so the misclassification A/B is attributable
        metrics.STATS_ADMISSION.inc(**{"source": "static",
                                       "class": cls})
    return cls


def classify_sql(stmt, qos: QoS | None,
                 fingerprint: str | None = None) -> str:
    """Per-statement admission class for the SQL serving path:
    explicit priority wins, then the statement
    fingerprint's MEASURED cost from the statistics catalog (same
    ``[stats] heavy-cost-ms`` threshold as PQL classify), and the
    statement SHAPE as the cold-start fallback — joins, GROUP BY,
    aggregates, DISTINCT, and unbounded extracts are heavy; bounded
    single-table projections ride the point lane.  Class choice only
    affects scheduling, never results."""
    if qos is not None and qos.priority in (CLASS_POINT, CLASS_HEAVY):
        return qos.priority
    if fingerprint is not None:
        from pilosa_tpu_torch.obs import stats
        est = stats.est_cost_ms(fingerprint)
        if est is not None:
            cls = (CLASS_HEAVY if est >= stats.heavy_cost_ms()
                   else CLASS_POINT)
            metrics.STATS_ADMISSION.inc(**{"source": "profile",
                                           "class": cls})
            return cls
    from pilosa_tpu_torch.sql import ast as _ast
    point_where = (isinstance(stmt.where, _ast.BinOp)
                   and stmt.where.op == "="
                   and isinstance(stmt.where.left, _ast.Col)
                   and stmt.where.left.name == "_id")
    heavy = bool(
        stmt.joins or stmt.group_by or stmt.having is not None
        or stmt.distinct or stmt.from_select is not None
        or any(isinstance(it.expr, _ast.Agg) for it in stmt.items)
        or (stmt.limit is None and stmt.table and not point_where))
    cls = CLASS_HEAVY if heavy else CLASS_POINT
    if fingerprint is not None:
        metrics.STATS_ADMISSION.inc(**{"source": "static",
                                       "class": cls})
    return cls


class _Ticket:
    __slots__ = ("granted", "abandoned")

    def __init__(self):
        self.granted = False
        self.abandoned = False


def parse_weights(spec: str | None) -> dict[str, float]:
    """"tenantA:4,tenantB:1" -> {"tenantA": 4.0, ...}; malformed
    entries are ignored (an operator typo must not kill serving)."""
    out: dict[str, float] = {}
    for part in (spec or "").split(","):
        part = part.strip()
        if not part or ":" not in part:
            continue
        name, _, w = part.rpartition(":")
        try:
            wf = float(w)
        except ValueError:
            continue
        if name and wf > 0:
            out[name.strip()] = wf
    return out


class AdmissionScheduler:
    """The serving admission plane: class gate + weighted fair queue +
    shed.  One per ServingLayer."""

    def __init__(self, heavy_slots: int = 2, queue_max: int = 128,
                 tenant_weights: dict[str, float] | None = None,
                 audit_slots: int = 1):
        self.heavy_slots = max(1, int(heavy_slots))
        self.queue_max = max(1, int(queue_max))
        self.audit_slots = max(1, int(audit_slots))
        self._audit_running = 0
        self.weights = dict(tenant_weights or {})
        self._cond = threading.Condition()
        # per-tenant state is DROPPED when a tenant's queue drains:
        # X-Pilosa-Tenant is client-controlled, and retaining an
        # entry (plus a stride pass and a metrics label series) per
        # tenant ever seen would leak without bound on a long-lived
        # server — occupancy is therefore bounded by queue_max.  The
        # stride pass resets to the global pass on re-entry, which
        # only forgives a drained tenant its history, never starves.
        self._queues: dict[str, deque[_Ticket]] = {}
        self._passes: dict[str, float] = {}   # stride pass per tenant
        self._global_pass = 0.0
        self._running = 0
        self._queued = 0

    def _gauge_tenant(self, tenant: str) -> str:
        """Metrics label for a tenant: configured tenants get their
        own series, everything else aggregates under "(other)" so a
        client-controlled header can't grow label cardinality."""
        return tenant if tenant in self.weights else "(other)"

    def _drop_if_empty_locked(self, tenant: str):
        q = self._queues.get(tenant)
        if q is not None and not q:
            del self._queues[tenant]
            self._passes.pop(tenant, None)

    # -- introspection --------------------------------------------------

    def queued(self, tenant: str | None = None) -> int:
        with self._cond:
            if tenant is None:
                return self._queued
            return len(self._queues.get(tenant, ()))

    # -- the audit gate -------------------------------------------------

    def audit_slot(self):
        """Non-blocking admission for the correctness-audit class:
        returns a slot handle (call ``release()`` when done) or None
        when the cap is busy — the caller sheds the AUDIT, never a
        serving query.  Audit slots are accounted separately from
        heavy slots by construction, so a saturated audit plane can
        never occupy serving concurrency."""
        with self._cond:
            if self._audit_running >= self.audit_slots:
                metrics.ADMISSION_TOTAL.inc(**{"class": CLASS_AUDIT,
                                               "outcome": "shed"})
                return None
            self._audit_running += 1
        metrics.ADMISSION_TOTAL.inc(**{"class": CLASS_AUDIT,
                                       "outcome": "admitted"})
        return _AuditSlot(self)

    def _audit_release(self):
        with self._cond:
            self._audit_running = max(0, self._audit_running - 1)

    # -- the heavy gate -------------------------------------------------

    def heavy_slot(self, qos: QoS | None):
        """Context manager bounding heavy-class concurrency.  Raises
        ServingShedError / ServingDeadlineExceeded instead of
        entering."""
        return _HeavySlot(self, qos)

    def _retry_after(self) -> float:
        # rough drain estimate: assume ~250 ms per queued heavy query
        # per slot; clamp to a sane Retry-After window
        return round(min(max(
            0.25 * self._queued / self.heavy_slots, 0.5), 30.0), 3)

    def _acquire(self, qos: QoS | None):
        tenant = qos.tenant if qos is not None else "default"
        deadline = qos.deadline_s if qos is not None else None
        with self._cond:
            if deadline is not None and time.monotonic() > deadline:
                metrics.ADMISSION_TOTAL.inc(**{"class": CLASS_HEAVY,
                                            "outcome": "expired"})
                raise ServingDeadlineExceeded(
                    "deadline expired before admission")
            if self._running < self.heavy_slots and self._queued == 0:
                self._running += 1
                metrics.ADMISSION_TOTAL.inc(**{"class": CLASS_HEAVY,
                                            "outcome": "admitted"})
                return
            if self._queued >= self.queue_max:
                metrics.ADMISSION_TOTAL.inc(**{"class": CLASS_HEAVY,
                                            "outcome": "shed"})
                raise ServingShedError(
                    f"serving admission queue full "
                    f"({self._queued} heavy queries waiting)",
                    retry_after_s=self._retry_after())
            tck = _Ticket()
            self._queues.setdefault(tenant, deque()).append(tck)
            self._queued += 1
            metrics.TENANT_QUEUE_DEPTH.set(
                len(self._queues[tenant]),
                tenant=self._gauge_tenant(tenant))
            while not tck.granted:
                if deadline is not None:
                    rem = deadline - time.monotonic()
                    if rem <= 0:
                        tck.abandoned = True
                        self._reap_locked(tenant)
                        metrics.ADMISSION_TOTAL.inc(**{
                            "class": CLASS_HEAVY, "outcome": "expired"})
                        raise ServingDeadlineExceeded(
                            "deadline expired while queued")
                    self._cond.wait(rem)
                else:
                    self._cond.wait()
            metrics.ADMISSION_TOTAL.inc(**{"class": CLASS_HEAVY,
                                        "outcome": "admitted"})

    def _release(self):
        with self._cond:
            self._running -= 1
            self._grant_locked()
            self._cond.notify_all()

    def _reap_locked(self, tenant: str):
        """Drop abandoned tickets from a tenant's queue."""
        q = self._queues.get(tenant)
        if not q:
            self._drop_if_empty_locked(tenant)
            return
        alive = deque(t for t in q if not t.abandoned)
        dropped = len(q) - len(alive)
        if dropped:
            self._queues[tenant] = alive
            self._queued -= dropped
            metrics.TENANT_QUEUE_DEPTH.set(
                len(alive), tenant=self._gauge_tenant(tenant))
        self._drop_if_empty_locked(tenant)

    def _grant_locked(self):
        """Stride scheduling: grant free slots to the tenant with the
        smallest pass value (pass += 1/weight per grant), FIFO within
        a tenant."""
        while self._running < self.heavy_slots and self._queued > 0:
            best = None
            for tenant in list(self._queues):
                q = self._queues[tenant]
                while q and q[0].abandoned:
                    q.popleft()
                    self._queued -= 1
                if not q:
                    self._drop_if_empty_locked(tenant)
                    continue
                p = self._passes.get(tenant, self._global_pass)
                if best is None or p < best[1]:
                    best = (tenant, p)
            if best is None:
                break
            tenant, p = best
            q = self._queues[tenant]
            tck = q.popleft()
            self._queued -= 1
            w = self.weights.get(tenant, 1.0)
            self._passes[tenant] = max(p, self._global_pass) + 1.0 / w
            self._global_pass = max(self._global_pass, p)
            self._running += 1
            tck.granted = True
            metrics.TENANT_QUEUE_DEPTH.set(
                len(q), tenant=self._gauge_tenant(tenant))
            self._drop_if_empty_locked(tenant)
        self._cond.notify_all()


class _AuditSlot:
    __slots__ = ("sched", "_done")

    def __init__(self, sched: AdmissionScheduler):
        self.sched = sched
        self._done = False

    def release(self):
        if not self._done:
            self._done = True
            self.sched._audit_release()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.release()
        return False


class _HeavySlot:
    def __init__(self, sched: AdmissionScheduler, qos: QoS | None):
        self.sched = sched
        self.qos = qos

    def __enter__(self):
        self.sched._acquire(self.qos)
        return self

    def __exit__(self, *exc):
        self.sched._release()
        return False
