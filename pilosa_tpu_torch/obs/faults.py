"""Fault-injection registry — named, armable failure points.

The reference proves its failure story with container-level chaos
(internal/clustertests drives pumba to pause/kill nodes); this build's
cluster is in-process, so the equivalent seam is a *registry of named
fault points* the production code consults at the exact places real
faults strike.  An out-of-memory injection seam with one counter and one
fault was the prototype; this module generalizes it —
any number of named points, armed by tests, by config
(``[faults] spec``), or by env (``PILOSA_TPU_FAULT_SPEC``), each with
an optional match substring, an activation budget, and a delay.

Fault points wired through the stack (the point name is the contract;
``detail`` is what ``match`` substring-tests against):

========================  ====================================================
``rpc-drop``              InternalClient: raise a connection error before the
                          request (detail: ``{uri}{path}``)
``rpc-delay``             InternalClient: sleep ``delay`` ms before the
                          request (same detail) — the slow-replica fault
``node-crash``            ClusterNode heartbeat loop: ``pause()`` the node
                          (detail: node id) — kill mid-traffic
``heartbeat-stall``       ClusterNode heartbeat loop: skip beats so the lease
                          expires while the node still serves (detail: node id)
``torn-write``            TranslateStore append: write half the record and
                          stop, simulating a crash mid-append (detail: path)
``device-oom``            memory/pressure.guarded dispatch (the inject_oom
                          seam, now registry-backed)
``serving-dispatch``      serving fused dispatch: fail the multi-program so
                          every rider takes the per-caller direct fallback
``dax-rpc``               DAX queryer worker fan-out (detail: worker uri)
``crash-post-append``     Fragment delta log: die right after the in-memory
                          delta entry landed (detail:
                          ``index/field/view/shard``) — the window between
                          append and any durability
``wal-torn``              IndexStorage WAL sync: commit, then truncate the
                          shard WAL mid-frame and drop the handle — a crash
                          while the commit's frames were partially on disk
                          (detail: shard file path); native recovery drops
                          the torn transaction on reopen
``crash-pre-checkpoint``  IndexStorage WAL sync: die after the WAL fsync but
                          before the checkpoint (same detail) — durable yet
                          unacked, so replay must be idempotent
``device-patch``          TileStackCache patcher (whole-entry + paged delta
                          fn): fail the in-place device patch; the cache
                          falls back to a rebuild from live rows
``crash-pre-commit``      StreamSource.commit: die after the batch landed but
                          before the consumer offsets commit (detail:
                          ``topic@group``) — the exactly-once replay window
``ingest-window-stall``   StreamWriter window loop: delay rules stall the
                          admission window (backpressure drills); error
                          rules crash the whole window pre-apply (detail:
                          comma-joined index names)
``transfer-interrupted``  Rebalance SNAPSHOT-COPY / DELTA-CHASE: the
                          transfer dies between block/row pushes (detail:
                          ``index/field/view/shard->recipient``) — proves
                          a crashed migration resumes or rolls back with
                          the donor still the one write owner
``recipient-died``        Rebalance block push: the recipient vanishes
                          mid-copy (detail: ``uri index/field/...``) —
                          same rollback contract as transfer-interrupted
``fence-crash``           RebalanceController: die after the donor fences
                          (writes blocked) but BEFORE the ownership flip
                          (detail: ``partition=N``) — rollback must lift
                          the fences so blocked writers proceed on the
                          donor, and no epoch has zero or two owners
``audit-corrupt``         Correctness-audit drill (obs/audit.py): flip one
                          bit in a served result (detail:
                          ``serve:{route}:{index}``), a stored ResultCache
                          entry (detail: ``cache:{index}``), or a maintained
                          standing result (detail: ``standing:{sid}``) —
                          the injection that PROVES the shadow/cache/
                          standing verifiers detect; armed only via the
                          test/config API like every other point
``blob-unavailable``      Blob shard store (storage/blob.py): every backend
                          op raises (detail: ``op:key``) — the tier
                          degrades to typed 503s at the worker surface,
                          never silent partial results
``blob-torn-upload``      Blob put dies after writing HALF the object and
                          BEFORE the manifest flip (detail: object key) —
                          proves a torn upload is never visible to readers
``worker-hydrate-crash``  ComputeNode hydration (dax/worker.py): die at
                          the start of a shard hydrate (detail:
                          ``addr:table/shard``) — no partial residency;
                          the next touch restarts from the manifest
``scale-event-interrupted``  Autoscaler migration (dax/controller.py):
                          die between migration phases (detail:
                          ``table/shard->addr:phase``) — an interrupted
                          scale event rolls back its fence and the next
                          reconcile resumes or completes the move
========================  ====================================================

Arming:

- tests: ``faults.inject("rpc-drop", match="10101", times=3)``;
  delay-only rules via ``delay_s`` with ``error=False`` (implied when
  a delay is given without ``error=True``).
- config/env: a spec string, rules separated by ``;``, params by
  ``,``: ``rpc-delay@10101,delay=200;node-crash@node2,times=1``.
  ``delay`` is milliseconds; ``times`` defaults to 1 (``times=0`` or
  ``times=-1`` = unlimited); a rule with a delay and no explicit
  ``error=1`` only delays.

``fire(point, detail)`` (raising/sleeping) and ``take(point, detail)``
(non-raising consume, for seams that enact the fault themselves) are
the two hot-path entries; with no rules armed for a point they cost
one dict lookup, so the points stay compiled into production paths.
"""

from __future__ import annotations

import os
import threading
import time


class InjectedFault(ConnectionError):
    """Raised by an armed error-mode fault point.  Subclasses
    ConnectionError so network-shaped injections ride the exact
    failover/retry paths a real connection failure would."""

    def __init__(self, point: str, detail: str = ""):
        super().__init__(f"injected fault {point!r}"
                         + (f" at {detail!r}" if detail else ""))
        self.point = point
        self.detail = detail


class _Rule:
    __slots__ = ("point", "match", "remaining", "delay_s", "error",
                 "source", "fired")

    def __init__(self, point: str, match: str | None, times: int,
                 delay_s: float, error: bool, source: str):
        self.point = point
        self.match = match
        self.remaining = times  # <= 0 means unlimited
        self.delay_s = delay_s
        self.error = error
        self.source = source
        self.fired = 0

    def to_dict(self) -> dict:
        return {"point": self.point, "match": self.match,
                "remaining": self.remaining, "delay_ms":
                round(self.delay_s * 1e3, 3), "error": self.error,
                "source": self.source, "fired": self.fired}


_lock = threading.Lock()
# point -> list[_Rule]; empty dict = the common no-faults fast path
_rules: dict[str, list[_Rule]] = {}
# source -> last spec string armed via configure(); an UNCHANGED spec
# re-applied (every Server/node construction re-runs config) must not
# clear-and-re-arm, or consumed budgets reset — a times=1 node-crash
# drill would re-kill the freshly rejoined node forever
_last_spec: dict[str, str] = {}


def inject(point: str, match: str | None = None, times: int = 1,
           delay_s: float = 0.0, error: bool | None = None,
           source: str = "test") -> None:
    """Arm a fault point.  ``times`` activations (<=0 unlimited);
    ``delay_s`` sleeps before acting; ``error`` None means "raise
    unless this is a delay-only rule"."""
    if error is None:
        error = delay_s <= 0
    rule = _Rule(point, match, times, delay_s, error, source)
    with _lock:
        _rules.setdefault(point, []).append(rule)


def clear(point: str | None = None, source: str | None = None) -> None:
    """Disarm rules — all of them, one point's, or one source's."""
    with _lock:
        if point is None and source is None:
            _rules.clear()
            _last_spec.clear()
            return
        if source is not None:
            _last_spec.pop(source, None)
        for p in list(_rules):
            if point is not None and p != point:
                continue
            kept = [r for r in _rules[p]
                    if source is not None and r.source != source]
            if kept:
                _rules[p] = kept
            else:
                del _rules[p]


def active() -> list[dict]:
    """Armed rules as dicts (the /debug/faults payload)."""
    with _lock:
        return [r.to_dict() for rules in _rules.values()
                for r in rules]


def _consume(point: str, detail: str) -> _Rule | None:
    """Match + consume one activation; None when nothing is armed."""
    if point not in _rules:  # lock-free fast path (GIL-atomic lookup)
        return None
    with _lock:
        rules = _rules.get(point)
        if not rules:
            return None
        for r in rules:
            if r.match is not None and r.match not in detail:
                continue
            r.fired += 1
            if r.remaining > 0:
                r.remaining -= 1
                if r.remaining == 0:
                    rules.remove(r)
                    if not rules:
                        del _rules[point]
            return r
    return None


def armed(point: str) -> bool:
    """Lock-free check whether ANY rule is armed at a point (the
    GIL-atomic dict lookup `_consume` fast-paths on).  For hot-path
    seams whose fire() detail string is itself costly to build —
    guard the construction, then fire normally."""
    return point in _rules


def take(point: str, detail: str = "") -> bool:
    """Consume an activation WITHOUT raising — for seams that enact
    the fault themselves (skip a heartbeat, tear a write, fake an
    OOM).  Applies the rule's delay; returns True when armed."""
    r = _consume(point, detail)
    if r is None:
        return False
    from pilosa_tpu_torch.obs import metrics
    metrics.FAULTS_TOTAL.inc(point=point)
    if r.delay_s > 0:
        time.sleep(r.delay_s)
    return True


def fire(point: str, detail: str = "") -> None:
    """Consult a fault point: sleep on delay rules, raise
    InjectedFault on error rules, no-op when nothing matches."""
    r = _consume(point, detail)
    if r is None:
        return
    from pilosa_tpu_torch.obs import metrics
    metrics.FAULTS_TOTAL.inc(point=point)
    if r.delay_s > 0:
        time.sleep(r.delay_s)
    if r.error:
        raise InjectedFault(point, detail)


def configure(spec: str, source: str = "config") -> int:
    """(Re)arm fault points from a spec string (see module docstring);
    replaces any rules previously armed from the same source, leaving
    test-armed rules alone.  An UNCHANGED spec is a no-op so repeated
    config application (one per node/server construction) preserves
    already-consumed budgets.  Returns the rule count armed."""
    spec = spec or ""
    with _lock:
        if _last_spec.get(source) == spec:
            return 0
    clear(source=source)
    n = 0
    for entry in (spec or "").split(";"):
        entry = entry.strip()
        if not entry:
            continue
        head, *params = [p.strip() for p in entry.split(",")]
        point, _, match = head.partition("@")
        times, delay_s, error = 1, 0.0, None
        for p in params:
            k, _, v = p.partition("=")
            k = k.strip()
            v = v.strip()
            if k == "times":
                times = int(v)
            elif k == "delay":
                delay_s = float(v) / 1e3
            elif k == "error":
                error = v in ("1", "true", "yes", "on")
            else:
                raise ValueError(f"unknown fault param {k!r} in "
                                 f"{entry!r}")
        inject(point.strip(), match=match or None, times=times,
               delay_s=delay_s, error=error, source=source)
        n += 1
    with _lock:
        _last_spec[source] = spec
    return n


# env-armed faults apply as soon as any fault point is consulted —
# a spec exported before process start needs no config file
_env_spec = os.environ.get("PILOSA_TPU_FAULT_SPEC", "")
if _env_spec:
    configure(_env_spec, source="env")
