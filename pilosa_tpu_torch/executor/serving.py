"""Cross-query dispatch coalescing: the serving path.

A point read's wall time on the card is dominated by what surrounds its
kernel (plan building, stack fetches, launches, the synchronise and the
pull-back), one round of each a query.  This module amortises that the
way inference serving does (continuous batching):

- ``QueryBatcher``: concurrent in-flight queries are admitted for a
  short window (default 1 ms, or until ``max_batch``), their plans fused
  into ONE program (stacked.py's "multi" plan kind over a shared
  ``PlanBuilder``, leaves deduplicated across queries), or with
  ``ragged`` one page-table program over every index and shard set of
  the batch (executor/ragged.py), run by one leader thread and
  demultiplexed back to the waiting threads.  The admission lock is held
  only for queue flips; the card runs while the next batch accumulates.

- ``ResultCache``: a versioned whole-query result cache keyed by the
  plan fingerprint (index, canonical call repr, shard set) and guarded
  by the write-versions of every fragment the query can read: any host
  write bumps its fragment's version (models/fragment.py), so a stale
  entry misses, and ``sweep()`` after serving-path writes evicts exactly
  the entries whose snapshot no longer matches.  Byte-bounded, and a
  client of the process's memory ledger (``"result_cache"``).

- QoS admission (executor/sched.py) in front, the standing-query
  registry (executor/standing.py) and the audit plane (obs/audit.py)
  beside the cache.

Consistency bar: a query admitted before a write either executes
against a fragment-version snapshot that is still intact when its batch
completes, or it is re-executed solo.  Anything the batcher cannot
express falls back to ``Executor.execute``; results are bit-exact by
construction because candidate selection (TopN) and plan building are
shared with the solo path.

Threads and the card: one batch leader runs every rider's device work
on the current (default) stream, synchronises once, and hands results
to the waiting threads as host values.  An error in the leader becomes
each rider's ``error``; no waiter is ever stranded.

The switches (``ragged``, ``admission``) are constructor arguments; the
port reads no environment for them.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from collections import OrderedDict

import numpy as np
import torch

# the executor's own write-call table: one source of truth so the
# serving layer's write routing can never drift from dispatch
from pilosa_tpu_torch.executor.executor import _WRITE_CALLS
from pilosa_tpu_torch.executor.results import Pair, RowResult, ValCount
from pilosa_tpu_torch.executor.stacked import (
    PlanBuilder,
    Unstackable,
    _plan_run,
    leaf_bytes,
)
from pilosa_tpu_torch.models.index import EXISTENCE_FIELD
from pilosa_tpu_torch.obs import audit as _audit
from pilosa_tpu_torch.obs import faults as _faults
from pilosa_tpu_torch.obs import flight, metrics
from pilosa_tpu_torch.obs import stats as _stats
from pilosa_tpu_torch.obs.monitor import capture_exception
from pilosa_tpu_torch.obs.tracing import (
    Span,
    capture_context,
    span_into,
    start_span,
)
from pilosa_tpu_torch.ops import bsi as bsi_ops
from pilosa_tpu_torch.pql import parse
from pilosa_tpu_torch.pql.ast import Call, Query

# bitmap-producing calls the stacked PlanBuilder can express without
# per-query precompute (no Distinct/UnionRows/ConstRow leaves)
_PURE_BITMAP = {"Row", "Range", "Union", "Intersect", "Difference",
                "Xor", "Not", "All", "Shift"}

# read calls whose results depend only on fragment contents (plus
# append-only key translation) — the cacheable dispatch surface of
# Executor._execute_call
_READ_CALLS = _PURE_BITMAP | {
    "Count", "Sum", "Min", "Max", "MinRow", "MaxRow", "Distinct",
    "Rows", "UnionRows", "TopN", "TopK", "GroupBy", "Percentile",
    "Sort", "Extract", "Limit", "IncludesColumn", "FieldValue",
    "ConstRow",
}


class Uncacheable(Exception):
    """Raised when a query's read set cannot be proven version-stable."""


def _fingerprint(key) -> str:
    """Stable short plan fingerprint of a cache key (index, canonical
    call repr, shard set) — correlates flight records across runs,
    unlike the salted builtin hash()."""
    import hashlib
    return hashlib.blake2b(repr(key).encode(),
                           digest_size=8).hexdigest()


# ---------------------------------------------------------------------------
# dependency tracking
# ---------------------------------------------------------------------------

def _dep_fields(idx, call: Call, out: set) -> None:
    """Collect the field names a call tree can read, conservatively
    (over-inclusion only widens invalidation; under-inclusion would be
    a stale-read bug).  Raises Uncacheable for calls whose results
    depend on state outside fragment versions."""
    name = call.name
    if name in _WRITE_CALLS or name not in _READ_CALLS:
        raise Uncacheable(f"not a cacheable call: {name}")
    if name == "Distinct":
        iname = call.arg("index")
        if iname is not None and iname != idx.name:
            raise Uncacheable("cross-index Distinct")
    if name == "ConstRow":
        # keyed columns resolve through the index translator, whose
        # key set can grow without any fragment version bump
        if any(isinstance(c, str) for c in call.arg("columns", []) or []):
            raise Uncacheable("ConstRow with string keys")
    if name in ("Not", "All"):
        out.add(EXISTENCE_FIELD)
    k, cond = call.condition_field()
    if k is not None:
        out.add(k)
        if cond is not None and cond.value is None:
            out.add(EXISTENCE_FIELD)  # null predicates read existence
    for key in ("_field", "field"):
        v = call.args.get(key)
        if isinstance(v, str):
            out.add(v)
    fk, _ = call.field_arg()
    if fk is not None and idx.field(fk) is not None:
        out.add(fk)
    for v in call.args.values():
        if isinstance(v, Call):
            _dep_fields(idx, v, out)
    for c in call.children:
        _dep_fields(idx, c, out)


def _write_targets(idx, q: Query) -> tuple[set | None, set | None]:
    """(fields, shards) a write query touches — the targeted cache
    sweep.  fields None: reach unbounded (Delete removes columns from
    every field; unknown shapes likewise).  shards None: every shard
    of the fields (Store/ClearRow span the whole row; keyed columns
    resolve through the translator).  A point Set/Clear with integer
    columns names exactly the (field, shard) slices its delta
    dirtied — the sweep then compares only those fragments' stamps
    instead of re-walking each entry's whole read set."""
    fields: set = set()
    shards: set | None = set()
    for c in q.calls:
        if c.name not in _WRITE_CALLS or c.name == "Delete":
            return None, None
        fk, _ = c.field_arg()
        if fk is not None:
            fields.add(fk)
        v = c.args.get("_field")
        if isinstance(v, str):
            fields.add(v)
        col = c.args.get("_col")
        if (shards is not None and idx is not None
                and c.name in ("Set", "Clear")
                and isinstance(col, int)
                and not isinstance(col, bool)):
            shards.add(col // idx.width)
        else:
            shards = None
    # Set marks column existence; Store may create the target field —
    # both can stale existence-reading entries
    fields.add(EXISTENCE_FIELD)
    return fields, shards


def _slices_stale(idx, ent_fields: frozenset, snap: tuple,
                  fields: set, shards: set) -> bool:
    """Exact staleness of one cache entry against a POINT write:
    compare only the written (field, shard) fragments' (gen, version)
    stamps with the entry's snapshot — O(written slices), not
    O(entry read set x views x shards).  Sound because the caller
    knows the write touched nothing outside (fields x shards); every
    other write path still hits the full-snapshot comparison at
    get()-time."""
    smap: dict = {}
    absent: set = set()
    for e in snap:
        if len(e) == 2:
            absent.add(e[0])
        else:
            smap[(e[0], e[1], e[2])] = (e[3], e[4])
    for fname in fields & ent_fields:
        f = idx.fields.get(fname)
        if f is None:
            if fname not in absent:
                return True  # field vanished since the snapshot
            continue
        if fname in absent:
            return True  # snapshotted as absent, exists now
        for vname in list(f.views):
            v = f.views.get(vname)
            if v is None:
                continue
            for s in shards:
                fr = v.fragments.get(s)
                cur = None if fr is None else (fr.gen, fr.version)
                if smap.get((fname, vname, s)) != cur:
                    return True
    return False


def query_fields(idx, q: Query) -> frozenset:
    """The field read-set of a whole query (Uncacheable if any call
    escapes version tracking)."""
    out: set = set()
    for c in q.calls:
        _dep_fields(idx, c, out)
    return frozenset(out)


def _shard_set(shards) -> frozenset | None:
    """An explicit-shards query arg as the snapshot restriction; None
    (all shards) stays None."""
    return None if shards is None else frozenset(
        int(s) for s in shards)


def field_snapshot(idx, fields: frozenset, shards=None) -> tuple:
    """Version snapshot of every fragment the fields currently hold:
    ((fname, vname, shard, frag.gen, version), ...).  A write bumps a
    version; a new fragment/view/field changes the tuple's shape; a
    deleted-and-recreated field gets fresh generation stamps (a
    process-global monotonic counter — id() would be unsound, CPython
    reuses freed addresses) — all compare unequal, so comparison-to-
    snapshot is the staleness test.

    ``shards`` (a set) restricts the walk to those shards' fragments:
    a query executed over an explicit shard subset reads nothing
    outside it, so its cache entry must survive writes to OTHER
    shards of the same fields — the (field, shard)-granular
    invalidation bulk imports rely on."""
    snap = []
    for fname in sorted(fields):
        f = idx.fields.get(fname)
        if f is None:
            snap.append((fname, None))
            continue
        for vname in sorted(f.views):
            # .get, skipping None: a concurrent view/field deletion
            # between the key listing and the lookup must produce a
            # (correct) snapshot mismatch, not a KeyError in a read
            v = f.views.get(vname)
            if v is None:
                continue
            for shard in sorted(v.fragments):
                if shards is not None and shard not in shards:
                    continue
                fr = v.fragments.get(shard)
                if fr is None:
                    continue
                snap.append((fname, vname, shard, fr.gen, fr.version))
    return tuple(snap)


def _result_nbytes(r) -> int:
    """Rough byte estimate of one result for LRU accounting.  Every
    container result type gets a size-proportional estimate — a flat
    default would let large Extract/Distinct results slip under the
    byte bound and grow the cache past its budget."""
    from pilosa_tpu_torch.executor.results import (
        DistinctValues,
        ExtractedTable,
        GroupCount,
        SortedRow,
    )
    if isinstance(r, RowResult):
        return 64 + sum(int(w.nbytes) for w in r.segments.values()) + \
            (len(r.keys) * 24 if r.keys else 0)
    if isinstance(r, (list, tuple)):
        return 48 + sum(_result_nbytes(x) for x in r)
    if isinstance(r, dict):
        return 64 + sum(48 + _result_nbytes(v) for v in r.values())
    if isinstance(r, np.ndarray):
        return int(r.nbytes)
    if isinstance(r, DistinctValues):
        return 48 + 24 * len(r.values)
    if isinstance(r, SortedRow):
        return 48 + 16 * (len(r.columns) + len(r.values))
    if isinstance(r, GroupCount):
        return 96 + 64 * len(r.group)
    if isinstance(r, ExtractedTable):
        return 96 + 48 * len(r.fields) + sum(
            64 + 24 * len(c.get("rows", ()))
            if isinstance(c, dict) else 64 for c in r.columns)
    if hasattr(r, "schema") and hasattr(r, "rows"):
        # SQLResult (duck-typed: serving must not import the sql
        # layer) — cached SQL statements size by their row payload
        return 96 + 48 * len(r.schema) + sum(
            48 + 24 * len(row) for row in r.rows)
    return 64


# ---------------------------------------------------------------------------
# versioned result cache
# ---------------------------------------------------------------------------

_MISS = object()


class ResultCache:
    """LRU byte-bounded whole-query result cache, recompute-cost
    aware: entries carry the measured/estimated cost of recomputing
    them (statistics catalog, obs/stats.py), and eviction drops the
    cheapest-to-recompute entry among the LRU window — a hot
    expensive GroupBy survives pressure that flushes point Counts.
    With the catalog disabled every cost is None and eviction is
    pure LRU.

    Entry: key -> (fields, snapshot, results, nbytes, cost_ms).  A
    lookup
    recomputes the fields' current snapshot and misses (evicting the
    entry) on any mismatch — so writes invalidate lazily, exactly the
    entries whose read set they touched; ``sweep()`` performs the same
    eviction eagerly after serving-path writes.

    Bytes also account through the process device-memory ledger
    (pilosa_tpu_torch/memory): the local ``max_bytes`` stays as this cache's
    own cap, and under cross-cache pressure the ledger's reclaim
    callback sheds the LRU tail here too — result bytes can no longer
    silently stack on top of a full stack-cache budget."""

    def __init__(self, max_bytes: int = 64 << 20, ledger=None):
        from pilosa_tpu_torch import memory
        self.max_bytes = max_bytes
        self._entries: OrderedDict[tuple, tuple] = OrderedDict()
        self._bytes = 0
        self._lock = threading.Lock()
        self._client = (memory.ledger() if ledger is None
                        else ledger).register(
            "result_cache", reclaim=self._reclaim)
        self.hits = 0
        self.misses = 0
        # write-through entry keys owned by the standing-query
        # registry (executor/standing.py): maintenance ADVANCES their
        # snapshot in place, so sweeps/eviction must not drop them —
        # a stale get() still misses (no wrong answers) but leaves
        # the entry for the registry's catch_up to advance
        self._standing: set = set()

    # cost-aware eviction scans this many LRU-end entries for the
    # cheapest recompute; small so eviction stays O(1)-ish
    _EVICT_WINDOW = 8

    def _evict_one_locked(self, exclude=None) -> int:
        """Drop one entry (caller holds the lock): the cheapest
        recompute cost among the _EVICT_WINDOW oldest (None cost =
        no evidence = first out; all-None degrades to LRU).
        ``exclude`` protects the entry a put() just inserted — a
        cheap newcomer must not evict ITSELF (it would pin expensive
        entries forever and give the hottest cheap query a 0% hit
        rate).  Returns the freed bytes (0 = nothing evictable)."""
        window = [(k, e) for k, e in itertools.islice(
            self._entries.items(), self._EVICT_WINDOW)
            if k != exclude and k not in self._standing]
        if not window:
            return 0
        best = min(range(len(window)),
                   key=lambda i: (window[i][1][4]
                                  if window[i][1][4] is not None
                                  else -1.0, i))
        key, ent = window[best]
        self._entries.pop(key)
        self._bytes -= ent[3]
        return ent[3]

    def _reclaim(self, need: int) -> int:
        freed = 0
        with self._lock:
            while self._entries and freed < need:
                got = self._evict_one_locked()
                if not got:
                    break  # only standing entries left: not evictable
                freed += got
        if freed:
            self._client.release(freed)
        return freed

    def get(self, idx, key, cur_snap: tuple | None = None):
        """`cur_snap`, when given, must be field_snapshot() of the
        entry's read set taken just now — callers that already walked
        the fragments pass it to avoid a second walk."""
        with self._lock:
            ent = self._entries.get(key)
        if ent is None:
            with self._lock:
                self.misses += 1
            return _MISS
        fields, snap, results, _nb, _cost = ent
        # snapshot outside the lock: touches only holder structures;
        # narrowed to the entry's explicit shard subset (key[2]) so a
        # write to another shard cannot stale it
        if (field_snapshot(idx, fields, _shard_set(key[2]))
                if cur_snap is None else cur_snap) != snap:
            dropped = 0
            with self._lock:
                cur = self._entries.get(key)
                # standing entries stay put on staleness: the
                # registry advances them instead of re-executing
                if cur is ent and key not in self._standing:
                    self._entries.pop(key)
                    self._bytes -= ent[3]
                    dropped = ent[3]
                self.misses += 1
            if dropped:
                self._client.release(dropped)
            return _MISS
        with self._lock:
            if key in self._entries:
                self._entries.move_to_end(key)
            self.hits += 1
        return results

    def put(self, key, fields: frozenset, snapshot: tuple, results,
            cost_ms: float | None = None):
        """``cost_ms`` is the entry's recompute cost (fingerprint
        profile estimate, or the duration just measured) — the
        cost-aware eviction's ranking signal; None with the stats
        catalog disabled keeps pure LRU semantics."""
        if _faults.armed("audit-corrupt") and _faults.take(
                "audit-corrupt", f"cache:{key[0]}"):
            # corruption drill (obs/audit.py): the STORED entry gets a
            # flipped bit while the serve in flight stays clean — the
            # injection the cache-audit scrubber must catch
            results = _audit.corrupt_results(results)
        nbytes = _result_nbytes(results)
        if nbytes > self.max_bytes:
            return
        # ledger reservation OUTSIDE our lock (reclaim may call back
        # into _reclaim); denial = serve uncached, exactly like an
        # entry over the local cap
        if not self._client.reserve(nbytes):
            return
        released = 0
        with self._lock:
            old = self._entries.pop(key, None)
            if old is not None:
                self._bytes -= old[3]
                released += old[3]
            self._entries[key] = (fields, snapshot, results, nbytes,
                                  cost_ms)
            self._bytes += nbytes
            while self._bytes > self.max_bytes and self._entries:
                freed = self._evict_one_locked(exclude=key)
                if not freed:  # only the new entry left: it fits
                    break      # (nbytes <= max_bytes guard above)
                released += freed
        if released:
            self._client.release(released)

    def mark_standing(self, key) -> None:
        with self._lock:
            self._standing.add(key)

    def unmark_standing(self, key) -> None:
        """Return a key to normal swept-entry lifecycle (and drop the
        now-unmaintained entry so it cannot serve stale)."""
        dropped = 0
        with self._lock:
            self._standing.discard(key)
            ent = self._entries.pop(key, None)
            if ent is not None:
                self._bytes -= ent[3]
                dropped = ent[3]
        if dropped:
            self._client.release(dropped)

    def advance(self, key, fields: frozenset, snapshot: tuple,
                results, cost_ms: float | None = None) -> None:
        """Write-through maintenance: replace a standing entry's
        snapshot+results in place.  put() already replaces in place
        and its eviction excludes standing keys; a ledger denial just
        drops the entry — the registry's catch_up still serves."""
        self.put(key, fields, snapshot, results, cost_ms)

    def sweep(self, holder, touched: set | None = None,
              shards: set | None = None) -> int:
        """Evict exactly the entries whose snapshot is stale (called
        after serving-path writes).  `touched` narrows the scan to
        entries whose read set intersects the written fields; `shards`
        (a point write's delta naming exactly the (field, shard)
        slices it dirtied) further narrows the staleness test to those
        fragments' stamps — entries a write cannot have staled are not
        re-snapshotted, so per-Set sweep cost tracks relevance, not
        cache occupancy (lazy get-time validation still covers every
        other write path).  Returns the eviction count."""
        with self._lock:
            items = list(self._entries.items())
        evicted = 0
        for key, ent in items:
            if key in self._standing:
                continue  # maintained, not swept
            if touched is not None and not (ent[0] & touched):
                continue
            eshards = shards
            if shards is not None and key[2] is not None:
                # an explicit-shard entry can only be staled by the
                # written shards it actually reads
                eshards = shards & set(key[2])
                if not eshards:
                    continue  # entirely outside the write
            idx = holder.index(key[0])
            if idx is None:
                stale = True
            elif eshards is not None and touched is not None:
                stale = _slices_stale(idx, ent[0], ent[1], touched,
                                      eshards)
            else:
                stale = field_snapshot(idx, ent[0],
                                       _shard_set(key[2])) != ent[1]
            if stale:
                dropped = 0
                with self._lock:
                    cur = self._entries.get(key)
                    if cur is ent:
                        self._entries.pop(key)
                        self._bytes -= ent[3]
                        dropped = ent[3]
                        evicted += 1
                if dropped:
                    self._client.release(dropped)
        return evicted

    def sweep_shards(self, index: str, shards: set[int]) -> int:
        """Online-resharding FENCE/RELEASE sweep: evict exactly the
        entries of ``index`` whose read set can touch the moved
        shards — an explicit-shard entry only when its shard subset
        intersects them, a whole-index entry always (it could have
        read the moved shard).  Unconditional on snapshot equality:
        the donor's fragments are about to leave, and a cached result
        covering the shard would otherwise keep serving answers that
        miss the recipient's new writes.  Entries over OTHER shards
        (and other indexes) survive — a rebalance must never flush
        the whole cache (test-pinned)."""
        with self._lock:
            items = list(self._entries.items())
        evicted = 0
        for key, ent in items:
            if key[0] != index:
                continue
            if key in self._standing:
                continue  # registry fallback re-seeds from the move
            if key[2] is not None and not (set(key[2]) & shards):
                continue
            dropped = 0
            with self._lock:
                cur = self._entries.get(key)
                if cur is ent:
                    self._entries.pop(key)
                    self._bytes -= ent[3]
                    dropped = ent[3]
                    evicted += 1
            if dropped:
                self._client.release(dropped)
        return evicted

    def clear(self):
        with self._lock:
            total = self._bytes
            self._entries.clear()
            self._bytes = 0
        if total:
            self._client.release(total)

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, key) -> bool:
        return key in self._entries

    @property
    def nbytes(self) -> int:
        return self._bytes


# ---------------------------------------------------------------------------
# micro-batcher
# ---------------------------------------------------------------------------

class _Req:
    """One in-flight batchable query."""

    __slots__ = ("index", "idx", "q", "call", "kind", "shards", "skey",
                 "fields", "key", "snapshot", "result", "error",
                 "direct", "event", "ctx", "trace_id", "acc",
                 "batch_size", "batch_id")

    def __init__(self, index, idx, q, call, kind, shards, skey,
                 fields, key, snapshot):
        self.index = index
        self.idx = idx
        self.q = q
        self.call = call
        self.kind = kind
        self.shards = shards          # caller's shards arg (may be None)
        self.skey = skey              # resolved shard tuple
        self.fields = fields          # frozenset | None (uncacheable)
        self.key = key
        self.snapshot = snapshot      # admission-time version snapshot
        self.result = None            # list of results when served
        self.error = None
        self.direct = False           # fall back to Executor.execute
        self.event = threading.Event()
        # flight-recorder / tracing plumbing: the follower's captured
        # trace context (obs.tracing.TraceContext — the leader records
        # spans INTO it), its flight trace id, the leader-side phase
        # accumulator merged back at commit, and the batch occupancy
        # the leader stamped
        self.ctx = None
        self.trace_id = None
        self.acc = None
        self.batch_size = 1
        self.batch_id = None


class QueryBatcher:
    """Leader/follower continuous batching.

    The first thread to arrive while no leader is active becomes the
    leader: it waits out the admission window (or until ``max_batch``
    requests queue), flips the queue, and executes the fused batch
    while the NEXT batch accumulates behind a new leader.  Followers
    park on a per-request event.

    Spans on the calling threads: a follower's park and the leader's
    window are ``serving.batch_wait`` (tag ``wait``); the leader's work
    from the queue flip to the riders' release is ``serving.batch``
    (tags ``riders``, ``batch_id``, ``trace_ids``), the batch id also
    stamped on each rider's flight record.
    """

    _TRACE_IDS = 32   # trace ids a serving.batch span names at most

    def __init__(self, serving: "ServingLayer", window_s: float,
                 max_batch: int):
        self.serving = serving
        self.window_s = window_s
        self.max_batch = max_batch
        self._cond = threading.Condition()
        self._pending: list[_Req] = []
        self._leader = False
        self._inflight = 0  # batches currently executing
        self._ids = itertools.count(1)
        # serialize=True (the ragged canonical program, set by
        # ServingLayer): at most ONE batch executes at a time and the
        # next leader waits for it rather than for a wall-clock
        # window.  The canonical program computes every canonical
        # slot per dispatch, so overlapping batches would multiply
        # that fixed cost for ~no extra riders — serializing maximizes
        # occupancy per dispatch, which is the whole amortization.
        self.serialize = False

    def run(self, req: _Req) -> None:
        """Serve one request through the batch path; on return the
        request carries ``result`` or ``error``."""
        with self._cond:
            self._pending.append(req)
            metrics.SERVING_QUEUE_DEPTH.set(len(self._pending))
            if self._leader:
                if len(self._pending) >= self.max_batch:
                    self._cond.notify_all()  # leader stops waiting
                follower = True
            else:
                self._leader = True
                follower = False
        if follower:
            with start_span("serving.batch_wait", wait=True):
                req.event.wait()
            return
        t_lead = time.perf_counter()
        deadline = t_lead + self.window_s
        with start_span("serving.batch_wait", wait=True, leader=True), \
                self._cond:
            # continuous batching: dispatch IMMEDIATELY when the
            # device is idle (a lone request must not eat the window
            # as pure latency); wait out the admission window only
            # while another batch is executing — that is exactly when
            # requests naturally accumulate
            while (self._inflight > 0
                   and len(self._pending) < self.max_batch):
                if self.serialize:
                    # wait out the in-flight batch itself (notified on
                    # completion), not a wall-clock window — arrivals
                    # during the dispatch become the next full batch
                    self._cond.wait(0.05)
                    continue
                rem = deadline - time.perf_counter()
                if rem <= 0:
                    break
                self._cond.wait(rem)
            batch = self._pending
            self._pending = []
            self._leader = False
            self._inflight += 1
            metrics.SERVING_QUEUE_DEPTH.set(0)
        bid = f"b{next(self._ids):x}"
        for r in batch:
            r.batch_id = bid
        with start_span("serving.batch", riders=len(batch), batch_id=bid,
                        trace_ids=[r.trace_id for r in batch
                                   if r.trace_id][:self._TRACE_IDS]):
            self._lead(batch, t_lead)

    def _lead(self, batch: list[_Req], t_lead: float) -> None:
        """Run a flipped batch and release its riders."""
        metrics.SERVING_BATCH_WAIT.observe(time.perf_counter() - t_lead)
        metrics.SERVING_BATCH_SIZE.observe(len(batch))
        # watchdog arming (obs/watchdog.py): the leader is entering
        # the fused dispatch — a dispatch wedged past the deadline is
        # a named stall ("serving-batcher"/"dispatch"), not a silent
        # latency cliff.  begin/end TOKENS, not stamp/idle: under
        # load a full batch dispatches while another is still in
        # flight (the wait loop exits at max_batch even with
        # inflight > 0), and a healthy leader finishing must not
        # disarm or re-stamp away a wedged sibling — staleness is
        # judged against the OLDEST in-flight dispatch.
        wd_tok = self.serving.watch.begin("dispatch")
        try:
            self.serving._run_batch(batch)
        except Exception as e:  # belt-and-braces: never strand a waiter
            # leader-thread failures are otherwise invisible to the
            # followers' own monitoring — capture with the BATCH's
            # trace ids so /debug/errors points at every affected query
            capture_exception(
                e, where="serving.batch", batch=len(batch),
                trace_ids=[r.trace_id for r in batch if r.trace_id])
            # incident trigger (obs/incidents.py): an unhandled batch-
            # leader exception strands no waiter (the loop below fails
            # them typed) but is a serving-plane fault worth a bundle
            from pilosa_tpu_torch.obs import incidents
            incidents.report(
                "batch-leader-exception", detail=type(e).__name__,
                context={"message": str(e)[:300], "batch": len(batch),
                         "trace_ids": [r.trace_id for r in batch
                                       if r.trace_id][:16]})
            for r in batch:
                if r.result is None and r.error is None:
                    r.error = e
        finally:
            self.serving.watch.end(wd_tok)
            with self._cond:
                self._inflight -= 1
                self._cond.notify_all()  # wake a window-waiting leader
            for r in batch:
                r.event.set()


# ---------------------------------------------------------------------------
# serving layer
# ---------------------------------------------------------------------------

def to_host(out):
    """A fused program's output as host values, after the leader's one
    synchronise: every tensor (or tuple of tensors) becomes numpy
    memory of its own, which a demux reads and a result may keep (a
    CPU tensor can share memory with a cached stack, so it is copied;
    a card's tensor comes off the card into fresh memory)."""
    if isinstance(out, torch.Tensor):
        if out.device.type == "cpu":
            return np.array(out.detach().numpy())
        return out.detach().cpu().numpy()
    if isinstance(out, tuple):
        return tuple(to_host(o) for o in out)
    return out


def sync_device(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def heavy_gate(sched, qos, cls: str):
    """Hold a heavy slot of ``sched`` for the body.  The wait at the
    gate is a ``serving.admit`` span (tags ``wait``, ``class``); yields
    (perf_counter start, seconds waited) for the flight record that
    follows, whose ``admit`` phase it is."""
    with contextlib.ExitStack() as held:
        with start_span("serving.admit", wait=True, **{"class": cls}):
            t0 = time.perf_counter()
            held.enter_context(sched.heavy_slot(qos))
        yield t0, time.perf_counter() - t0


class ServingLayer:
    """Front of Executor for the serving path: QoS admission first
    (executor/sched.py), result cache second, micro-batcher (per-group
    or ragged cross-index fused dispatch) third, ``Executor.execute``
    fallback always."""

    def __init__(self, executor, window_s: float = 0.001,
                 max_batch: int = 32, cache_bytes: int = 64 << 20,
                 batching: bool = True, ragged: bool = True,
                 admission: bool = True, heavy_slots: int = 2,
                 queue_max: int = 128, tenant_weights=None,
                 default_deadline_ms: float = 0.0):
        from pilosa_tpu_torch.executor import sched as _sched
        self.executor = executor
        self.batching = batching and max_batch > 1
        self.cache = ResultCache(cache_bytes) if cache_bytes > 0 else None
        self.batcher = QueryBatcher(self, window_s, max_batch)
        self.prefetcher = None
        # ragged cross-index page-table dispatch (executor/ragged.py):
        # one fused program a batch instead of one an (index, shards)
        # group
        self.ragged = bool(ragged)
        # QoS admission (executor/sched.py): point reads bypass, heavy
        # reads pass a bounded weighted-fair gate, overflow sheds 503
        weights = (tenant_weights
                   if isinstance(tenant_weights, dict)
                   else _sched.parse_weights(tenant_weights))
        self.sched = _sched.AdmissionScheduler(
            heavy_slots=heavy_slots, queue_max=queue_max,
            tenant_weights=weights) if admission else None
        self.default_deadline_ms = float(default_deadline_ms or 0.0)
        # one canonical dispatch at a time (see QueryBatcher)
        self.batcher.serialize = self.ragged
        # stall watchdog on the batch leader's dispatch (obs/watchdog.py;
        # registration is idempotent by name)
        from pilosa_tpu_torch.obs import watchdog
        self.watch = watchdog.register("serving-batcher")
        # standing-query registry (executor/standing.py): maintained
        # write-through entries over this cache
        from pilosa_tpu_torch.executor.standing import StandingRegistry
        self.standing = StandingRegistry(self)
        # continuous correctness auditing (obs/audit.py): the shadow
        # sampler taps every successful read route; workers start
        # lazily on the first sampled serve
        self.audit = _audit.AuditPlane(self)

    def start_prefetcher(self, interval_s: float = 0.5):
        """Warm predicted stack pages off the serving hot path
        (memory/policy.py Prefetcher over the flight recorder's
        per-query stack-outcome records).  Idempotent."""
        if self.prefetcher is None:
            from pilosa_tpu_torch.memory.policy import Prefetcher
            self.prefetcher = Prefetcher(
                self.executor.stacked.cache,
                interval_s=interval_s).start()
        return self.prefetcher

    def stop_prefetcher(self):
        if self.prefetcher is not None:
            self.prefetcher.stop()
            self.prefetcher = None

    def close(self):
        """Stop every thread the layer started (prefetcher, audit
        workers)."""
        self.stop_prefetcher()
        self.audit.stop()

    # -- entry point ---------------------------------------------------

    def execute(self, index: str, query, shards=None,
                remote: bool = False, qos=None) -> list:
        from pilosa_tpu_torch.executor import sched as _sched
        ex = self.executor
        if remote:
            # a node-to-node leg carries the _REMOTE context variable,
            # which a batch leader's thread would not inherit: it runs
            # solo
            return ex.execute(index, query, shards, remote=True)
        q = parse(query) if isinstance(query, str) else query
        if any(c.name in _WRITE_CALLS for c in q.calls):
            try:
                return ex.execute(index, q, shards)
            finally:
                if self.cache is not None:
                    wf, ws = _write_targets(ex.holder.index(index), q)
                    self.cache.sweep(ex.holder, wf, ws)
                    metrics.RESULT_CACHE.inc(outcome="write")
                    # push the landed delta through the standing
                    # registrations this write can have touched
                    self.standing.on_write(index, wf, ws)
        # default deadline: applies to every request that carried none
        if self.default_deadline_ms > 0:
            if qos is None:
                qos = _sched.QoS.make(
                    deadline_ms=self.default_deadline_ms)
            elif qos.deadline_s is None:
                dflt = _sched.QoS.make(
                    deadline_ms=self.default_deadline_ms)
                qos.deadline_ms = dflt.deadline_ms
                qos.deadline_s = dflt.deadline_s
        # cost-based admission (obs/stats.py): classify by the plan
        # fingerprint's measured cost profile when the catalog is warm
        # (query kind is the cold-start fallback inside classify); an
        # explicit priority skips the hash
        key = None
        fp = None
        if _stats.enabled() and not (
                qos is not None and qos.priority in (
                    _sched.CLASS_POINT, _sched.CLASS_HEAVY)):
            key = (index, repr(q.calls),
                   None if shards is None else tuple(sorted(shards)))
            fp = _fingerprint(key)
        cls = _sched.classify(q, qos, fingerprint=fp)
        # a dead-on-arrival deadline sheds regardless of class
        if (qos is not None and qos.deadline_s is not None
                and time.monotonic() > qos.deadline_s):
            metrics.ADMISSION_TOTAL.inc(**{"class": cls,
                                           "outcome": "expired"})
            raise _sched.ServingDeadlineExceeded(
                "deadline expired before execution")
        if cls == _sched.CLASS_HEAVY and self.sched is not None:
            # bounded heavy concurrency + weighted per-tenant fair
            # queueing: a GroupBy storm cannot occupy every thread
            with heavy_gate(self.sched, qos, cls) as admit:
                with start_span("executor.Execute", index=index) as root:
                    return self._execute_read(ex, index, q, shards,
                                              root, qos=qos, cls=cls,
                                              key=key, fp=fp,
                                              admit=admit)
        metrics.ADMISSION_TOTAL.inc(**{"class": cls,
                                       "outcome": "admitted"})
        with start_span("executor.Execute", index=index) as root:
            return self._execute_read(ex, index, q, shards, root,
                                      qos=qos, cls=cls, key=key, fp=fp)

    def _execute_read(self, ex, index, q, shards, root=None, qos=None,
                      cls=None, key=None, fp=None, admit=None):
        """``admit`` (start, seconds) is the heavy-slot wait before this
        call, the record's ``admit`` phase; ``duration_ms`` starts here,
        after it (the statistics catalog's cost classes read it)."""
        t0 = time.perf_counter()
        route = "direct"
        fl = flight.begin(index, q)
        if fl is not None:
            if admit is not None:
                flight.note_phase("admit", admit[1], admit[0])
            fl["tenant"] = qos.tenant if qos is not None else "default"
            fl["priority"] = cls or "point"
            if qos is not None and qos.deadline_ms is not None:
                fl["deadline_ms"] = round(float(qos.deadline_ms), 1)
        if fl is not None and root is not None:
            root.set_tag("trace_id", fl["trace_id"])
        req = None
        err = None
        try:
            idx = ex.holder.index(index)
            if idx is None:  # the executor's "index not found" error
                return ex.execute(index, q, shards)
            if key is None:  # stats off: execute() skipped it
                key = (index, repr(q.calls),
                       None if shards is None else tuple(sorted(shards)))
            # the read set drives both the cache guard and the
            # batcher's mid-flight consistency re-check
            fields = None
            tc = time.perf_counter()
            with start_span("serving.cache_lookup"):
                try:
                    fields = query_fields(idx, q)
                except Uncacheable:
                    if self.cache is not None:
                        metrics.RESULT_CACHE.inc(outcome="bypass")
                # one snapshot walk serves the cache guard, batch
                # admission and the miss path's store protocol
                sset = _shard_set(shards)
                snap = (field_snapshot(idx, fields, sset)
                        if fields is not None else None)
                cache_res = _MISS
                if self.cache is not None and fields is not None:
                    cache_res = self.cache.get(idx, key, cur_snap=snap)
            flight.note_phase("cache_lookup", time.perf_counter() - tc, tc)
            if cache_res is not _MISS:
                route = "cached"
                metrics.RESULT_CACHE.inc(outcome="hit")
                metrics.QUERY_TOTAL.inc(index=index, status="ok")
                metrics.QUERY_DURATION.observe(time.perf_counter() - t0)
                return _audit.tap(self.audit, index, idx, q, shards,
                                  key, fields, snap, "cached",
                                  cache_res, fl)
            if self.cache is not None and fields is not None:
                metrics.RESULT_CACHE.inc(outcome="miss")
            # a registry-owned key pulls maintenance instead of
            # re-executing
            if self.standing.owns(key):
                got = self.standing.catch_up(key)
                if got is not _MISS:
                    route = "standing"
                    metrics.QUERY_TOTAL.inc(index=index, status="ok")
                    metrics.QUERY_DURATION.observe(
                        time.perf_counter() - t0)
                    sq = self.standing._by_key.get(key)
                    return _audit.tap(
                        self.audit, index, idx, q, shards, key, fields,
                        sq.snapshot if sq is not None else None,
                        "standing", got, fl)
            req = (self._classify(index, idx, q, shards, fields, key,
                                  snap)
                   if self.batching else None)
            if req is not None:
                # the leader records this request's device phases into
                # the captured context (None when nothing traces)
                req.ctx = capture_context()
                if fl is not None:
                    req.trace_id = fl["trace_id"]
                tb = time.perf_counter()
                self.batcher.run(req)
                flight.note_phase("batch", time.perf_counter() - tb, tb)
                if req.error is not None:
                    raise req.error
                if req.result is not None and not req.direct:
                    route = "fused"
                    metrics.QUERY_TOTAL.inc(index=index, status="ok")
                    metrics.QUERY_DURATION.observe(
                        time.perf_counter() - t0)
                    # req.snapshot survived the post-batch re-check
                    return _audit.tap(self.audit, index, idx, q,
                                      shards, key, fields,
                                      req.snapshot, "fused",
                                      req.result, fl)
                # fallback on THIS thread: failed or stale fused serves
                # re-execute in parallel across their callers
                snap = None
            return self._exec_and_cache(index, idx, q, shards, fields,
                                        key, snap, fl=fl)
        except Exception as e:
            err = f"{type(e).__name__}: {e}"
            raise
        finally:
            metrics.SERVING_BATCHED.inc(route=route)
            if fl is None:
                # nested under an open record (a SQL statement's inner
                # PQL dispatch): stamp this serve's route into it
                flight.note_route(route)
            dur = time.perf_counter() - t0
            metrics.SERVING_LATENCY.observe(dur)
            flight.commit(
                fl, dur, route=route,
                batch=req.batch_size if req is not None else 1,
                error=err,
                fingerprint=(fp if fp is not None else
                             (_fingerprint(key)
                              if fl is not None and key else None)),
                extra_acc=req.acc if req is not None else None,
                batch_id=req.batch_id if req is not None else None)

    # -- classification ------------------------------------------------

    def _classify(self, index, idx, q: Query, shards, fields, key,
                  snapshot=None):
        """A _Req when the query can ride a fused batch, else None.  Under
        the engine's mesh arm (Executor.set_mesh) every read goes solo,
        through the arm: a fused plan runs on one device."""
        if len(q.calls) != 1 or not getattr(self.executor,
                                            "use_stacked", False):
            return None
        if getattr(self.executor.stacked, "mesh", None) is not None:
            return None
        call = q.calls[0]
        name = call.name
        if name == "Count":
            if len(call.children) != 1:
                return None
            kind, tree_call = "count", call.children[0]
        elif name == "Sum":
            kind = "sum"
            tree_call = call.children[0] if call.children else None
        elif name in ("TopN", "TopK"):
            kind = "topn"
            tree_call = call.children[0] if call.children else None
        elif name == "GroupBy":
            # the batchable subset: Rows children over plain fields, an
            # optional pure filter tree, an optional Sum aggregate (the
            # shapes the one-pass "gb_hist" subplan expresses)
            if any(call.arg(k) is not None
                   for k in ("previous", "having", "limit")):
                return None
            if not call.children or any(
                    c.name != "Rows" or c.children
                    or set(c.args) - {"_field"}
                    for c in call.children):
                return None
            agg = call.arg("aggregate")
            if agg is not None and (
                    not isinstance(agg, Call) or agg.name != "Sum"
                    or agg.children or agg.arg("_field") is None):
                return None
            kind, tree_call = "groupby", call.arg("filter")
        elif name in _PURE_BITMAP:
            kind, tree_call = "words", call
        else:
            return None
        if tree_call is not None and not _pure_tree(tree_call):
            return None
        skey = tuple(self.executor._shard_list(idx, shards))
        if snapshot is None and fields is not None:
            snapshot = field_snapshot(idx, fields, _shard_set(shards))
        return _Req(index, idx, q, call, kind, shards, skey, fields,
                    key, snapshot)

    # -- batch execution (leader thread) -------------------------------

    def _run_batch(self, batch: list[_Req]) -> None:
        # group by index identity, not name: two requests straddling a
        # drop-and-recreate of one index name must not share a builder
        groups: dict[tuple, list[_Req]] = {}
        for r in batch:
            r.batch_size = len(batch)  # flight-record occupancy
            groups.setdefault((id(r.idx), r.skey), []).append(r)
        # ragged cross-index dispatch: ONE fused page-table program
        # serves every group (executor/ragged.py); a planning failure
        # degrades to the per-group path, a dispatch failure marks the
        # riders direct
        ragged_done = False
        if self.ragged and groups:
            try:
                from pilosa_tpu_torch.executor import ragged as _ragged
                _ragged.run_ragged(self, groups)
                ragged_done = True
            except Exception as e:
                capture_exception(e, where="serving.ragged_plan",
                                  batch=len(batch))
        if not ragged_done:
            for reqs in groups.values():
                self._run_group(reqs)
        # post-pass: snapshot re-check.  A rider whose snapshot moved is
        # marked direct and re-executes on its own thread.
        with start_span("serving.snapshot"):
            for r in batch:
                if (not r.direct and r.error is None
                        and r.result is not None and r.fields is not None
                        and field_snapshot(r.idx, r.fields,
                                           _shard_set(r.shards))
                        != r.snapshot):
                    r.direct = True
                    r.result = None
        if self.cache is None:
            return
        with start_span("serving.cache_put"):
            for r in batch:
                if r.result is not None and not r.direct and \
                        r.error is None and r.fields is not None:
                    self.cache.put(r.key, r.fields, r.snapshot, r.result,
                                   cost_ms=self._recompute_cost(r.key,
                                                                r.acc))

    def build_rider(self, b: PlanBuilder, r, shards):
        """Build one request's subplan on the leader with its flight
        attribution (stack fetches inside the build accumulate into the
        request's Acc) and its ``serving.plan`` span; returns
        ``_build_sub``'s value, or raises."""
        acc = r.acc
        prev = flight.push_acc(acc)
        t0 = time.perf_counter()
        try:
            with span_into(r.ctx, "serving.plan", kind=r.kind):
                return self._build_sub(b, r, shards)
        finally:
            flight.pop_acc(prev)
            stack_t = sum(v for k, v in acc.phases.items()
                          if k.startswith("stack_"))
            acc.add_phase("plan_build", max(
                time.perf_counter() - t0 - stack_t, 0.0))

    def _run_group(self, reqs: list[_Req]) -> None:
        ex = self.executor
        idx = reqs[0].idx
        shards = list(reqs[0].skey)
        b = PlanBuilder(ex.stacked, idx, shards, {})
        subs, demuxes, pend = [], [], []
        # canonical build order: the same query set builds one plan
        for r in sorted(reqs, key=lambda r: repr(r.call)):
            if r.result is not None or r.error is not None:
                continue
            r.acc = flight.Acc()
            try:
                built = self.build_rider(b, r, shards)
            except Exception:
                r.direct = True
                continue
            if built is None:
                continue  # constant result already set on r
            sub, demux = built
            subs.append(sub)
            demuxes.append(demux)
            pend.append(r)
        if not subs:
            return
        plan = ("multi", tuple(subs))
        outs = dispatch(self, plan, b.leaves, b.params, pend,
                        where="serving.fused_dispatch",
                        tags={"subqueries": len(subs)}, kind="group")
        if outs is None:
            return
        for r, demux, out in zip(pend, demuxes, outs):
            demux_into(r, demux, out)

    def _build_sub(self, b: PlanBuilder, r: _Req, shards: list[int]):
        """(subplan, demux) for one request, or None after setting a
        constant result.  Any exception sends the request to its solo
        fallback (which also reproduces the user-visible error).  Every
        reducible subplan sums over its shards on the device in int64,
        and a demux reads host values (``to_host``)."""
        ex = self.executor
        eng = ex.stacked
        idx = r.idx
        call = r.call
        if r.kind == "count":
            tree = b.build(call.children[0])
            if tree == ("zeros",):
                r.result = [0]
                return None

            def demux_count(out):
                return [int(out)]
            return ("count", tree, True), demux_count
        if r.kind == "words":
            tree = b.build(call)
            if tree == ("zeros",):
                r.result = [self._row_result(idx, shards, None)]
                return None

            def demux_words(out):
                w = np.asarray(out).view(np.uint32)[: len(shards)]
                return [self._row_result(idx, shards, w)]
            return ("words", tree), demux_words
        if r.kind == "sum":
            fname = call.arg("_field")
            if fname is None:
                raise Unstackable("sum_field", "Sum without field")
            f = ex._bsi_field(idx, fname)
            planes_i = b._planes_leaf(f)
            tree = None
            if call.children:
                tree = b.build(call.children[0])
                if tree == ("zeros",):
                    r.result = [ValCount(value=f.int_to_value(0), count=0)]
                    return None

            def demux_sum(out):
                cnt, pos, neg = (torch.from_numpy(np.asarray(x))
                                 for x in out)
                total, count = bsi_ops.host_sum(cnt, pos, neg)
                return [ValCount(value=f.int_to_value(total),
                                 count=count)]
            return ("bsi_sum", planes_i, tree, True), demux_sum
        if r.kind == "topn":
            n_key = "n" if call.name == "TopN" else "k"
            prep = ex._topnk_prepare(idx, call, r.shards, n_key)
            if prep[0] == "done":
                r.result = [prep[1]]
                return None
            _, f, views, row_ids, filter_call, n, ids = prep
            est = len(row_ids) * max(len(shards), 1) * (idx.width // 8)
            if est > ex._ROWS_STACK_BUDGET:
                raise Unstackable("topn_budget",
                                  "TopN row stack over the batch budget")
            stack = eng.rows_stack_for(idx, f, tuple(views), row_ids,
                                       tuple(shards))
            rows_i = b._add_leaf(stack)
            tree = (b.build(filter_call)
                    if filter_call is not None else None)
            if tree == ("zeros",):
                pairs = ([Pair(id=rr, count=0) for rr in row_ids]
                         if ids is not None else [])
                r.result = [ex._finish_topn(f, pairs, n)]
                return None

            def demux_topn(out):
                c = np.asarray(out, dtype=np.int64)
                pairs = [Pair(id=rr, count=int(cc))
                         for rr, cc in zip(row_ids, c)
                         if cc > 0 or ids is not None]
                return [ex._finish_topn(f, pairs, n)]
            return ("row_counts", rows_i, tree, True), demux_topn
        if r.kind == "groupby":
            return self._build_groupby_sub(b, r, shards)
        raise Unstackable("batch_kind", f"unbatchable kind {r.kind}")

    def _build_groupby_sub(self, b: PlanBuilder, r: _Req,
                           shards: list[int]):
        """One-pass GroupBy as a batched subplan: the group-code stack
        and BSI planes become shared leaves (PageView pages under the
        ragged program) and the histogram kernel runs inside the fused
        program: a GroupBy rider costs the batch one pass over its
        stacks, not its own dispatch."""
        from pilosa_tpu_torch.executor.stacked import _code_space, _combo_codes
        from pilosa_tpu_torch.obs.metrics import GROUPBY_FUSED, GROUPBY_ONEPASS
        from pilosa_tpu_torch.ops import kernels

        ex = self.executor
        eng = ex.stacked
        idx = r.idx
        call = r.call
        fields, row_lists = [], []
        for rc in call.children:
            fname = rc.arg("_field")
            f = idx.field(fname) if fname else None
            if f is None:
                raise Unstackable("groupby_field",
                                  "Rows requires a valid field")
            fields.append(f)
            row_lists.append(ex._rows_ids(idx, rc, r.shards))
        if any(not rl for rl in row_lists):
            r.result = [[]]
            return None
        agg_call = call.arg("aggregate")
        agg_field = (ex._bsi_field(idx, agg_call.arg("_field"))
                     if agg_call is not None else None)
        depth = agg_field.bit_depth if agg_field is not None else 0
        fields_rows = list(zip(fields, row_lists))
        combos = np.indices([len(rl) for rl in row_lists]) \
            .reshape(len(row_lists), -1).T.astype(np.int64)
        skey = tuple(shards)
        if not eng._groupby_onepass_fits(idx, fields_rows, skey):
            raise Unstackable("groupby_batch",
                              "groupby shape not one-pass batchable")
        _bits, shifts, n_codes = _code_space(fields_rows)
        codes = _combo_codes(shifts, combos)
        gb = eng._onepass_kernel(n_codes, depth, minmax=False)
        arm = "onehot" if gb is kernels.groupby_onehot else "fused"
        signed = False
        if agg_field is not None:
            frags = eng._frags(agg_field, agg_field.bsi_view, list(skey))
            signed = any(fr is not None and 1 in fr.row_ids
                         for fr in frags)
        filter_call = call.arg("filter")
        tree = None
        if filter_call is not None:
            tree = b.build(filter_call)
            if tree == ("zeros",):
                r.result = [[]]
                return None
        cg_i = b._groupcode_leaf(fields_rows)
        planes_i = (b._planes_leaf(agg_field)
                    if agg_field is not None else None)
        GROUPBY_ONEPASS.inc()
        if arm == "fused":
            GROUPBY_FUSED.inc(path="batched")

        def demux_groupby(out):
            flat = np.asarray(out).astype(np.int64)
            g = n_codes
            agg = None
            if agg_field is not None:
                nn = flat[g:2 * g]
                pos = flat[2 * g:2 * g + g * depth].reshape(g, depth)
                neg = flat[2 * g + g * depth:].reshape(g, depth)
                agg = (nn[codes], pos[codes], neg[codes])
            return [ex._assemble_groupby(
                fields, row_lists, combos, flat[:g][codes], agg_field,
                "sum", agg, None, None, None)]
        return (("gb_hist", cg_i, tree, planes_i, n_codes, signed, arm),
                demux_groupby)

    def _row_result(self, idx, shards: list[int], words) -> RowResult:
        """Executor._bitmap_result plus the key attachment of
        Executor.execute, for a fused bitmap query."""
        out = RowResult(idx.width)
        if words is not None:
            for i, shard in enumerate(shards):
                if words[i].any():
                    out.segments[shard] = words[i]
        if idx.keys:
            out.keys = idx.column_translator.translate_ids(out.columns())
        return out

    # -- solo path with cache store ------------------------------------

    def _exec_and_cache(self, index, idx, q, shards, fields, key,
                        snap=None, fl=None):
        """Solo execution with the store protocol: snapshot before,
        execute, store only if the snapshot held.  ``snap``, when given,
        must have been taken before the execution on this path."""
        ex = self.executor
        if self.cache is None or fields is None:
            return ex.execute(index, q, shards)
        sset = _shard_set(shards)
        if snap is None:
            snap = field_snapshot(idx, fields, sset)
        t0 = time.perf_counter()
        results = ex.execute(index, q, shards)
        cost = None
        if _stats.enabled():
            cost = _stats.est_recompute_ms(_fingerprint(key))
            if cost is None:  # cold fingerprint: the run just paid
                cost = (time.perf_counter() - t0) * 1e3
        # store only if no write raced the execution
        if field_snapshot(idx, fields, sset) == snap:
            self.cache.put(key, fields, snap, results, cost_ms=cost)
            # audit tap only on held snapshots: a raced execution has no
            # provable provenance
            results = _audit.tap(self.audit, index, idx, q, shards,
                                 key, fields, snap, "solo", results, fl)
        return results

    @staticmethod
    def _recompute_cost(key, acc) -> float | None:
        """Recompute-cost hint for a cache entry: the fingerprint
        profile's non-cached estimate, else the leader-attributed phase
        time of the serve that produced it; None (pure LRU) with the
        statistics catalog off."""
        if not _stats.enabled():
            return None
        cost = _stats.est_recompute_ms(_fingerprint(key))
        if cost is None and acc is not None:
            cost = sum(v for k, v in acc.phases.items()
                       if k not in flight.IN_EXECUTE) * 1e3
        return cost


def dispatch(layer, plan, leaves, params, riders, where: str,
             tags: dict, kind: str, note=None, needed=None, devices=None):
    """Run one fused plan on the leader for ``riders`` (objects with
    ``acc``, ``ctx``, ``trace_id`` and ``direct``): the
    ``serving-dispatch`` fault point, the OOM ladder (memory/pressure.py;
    no host fallback: a rider that fails here re-executes solo, with its
    own ladder), one synchronise, the execute phase and a
    ``serving.dispatch`` span copy on every rider, the roofline note of
    a clean dispatch (``note(leaves, seconds)``, by default the plan
    kind's op family over its operands' bytes),
    ``pilosa_serving_dispatch_total{kind}``, and the outputs as host
    values (``to_host``; only the outputs in ``needed`` when given, the
    others None: a canonical program's absent slots stay on the card).
    A failure marks every rider direct and returns None.  ``devices``
    (the serving mesh's slots) are every device the plan runs on; each
    is synchronised.  Of the attempt that returned, ``execute`` splits
    into ``launch``, until the plan has been enqueued, ``sync``, the
    wait for the card, and ``to_host``, the copy of the outputs to the
    host (a ``serving.to_host`` span on the leader); a failed attempt
    and the OOM ladder's relief sweep after it are in ``execute``
    alone."""
    from pilosa_tpu_torch.memory import pressure
    from pilosa_tpu_torch.obs import roofline
    from pilosa_tpu_torch.executor.stacked import ROOF_OPS

    device = layer.executor.device
    sp = Span("serving.dispatch")
    sp.tags.update(batch=len(riders), **tags)
    bid = getattr(riders[0], "batch_id", None) if riders else None
    if bid is not None:
        sp.tags["batch_id"] = bid
    oom0 = metrics.OOM_TOTAL.total(outcome="caught")
    t0 = time.perf_counter()
    ran = []
    try:
        # chaos seam: an armed fault fails the fused program exactly
        # like a device error, sending every rider to its solo path
        _faults.fire("serving-dispatch")
        run = _plan_run(plan)

        def go():
            ta = time.perf_counter()
            out = run(leaves, params)
            tl = time.perf_counter()
            for dev in devices or (device,):
                sync_device(dev)
            ran.append((ta, tl, time.perf_counter()))
            return out
        outs = pressure.guarded(go)
        with start_span("serving.to_host"):
            outs = tuple(to_host(o) if needed is None or i in needed
                         else None for i, o in enumerate(outs))
    except Exception as e:
        capture_exception(
            e, where=where, batch=len(riders),
            trace_ids=[r.trace_id for r in riders
                       if getattr(r, "trace_id", None)])
        for r in riders:
            r.direct = True
        return None
    finally:
        sp.finish()
    metrics.SERVING_DISPATCH.inc(kind=kind)
    dt = time.perf_counter() - t0
    clean = metrics.OOM_TOTAL.total(outcome="caught") == oom0
    if clean:
        if note is not None:
            note(leaves, dt)
        else:
            roofline.note(ROOF_OPS.get(plan[0], plan[0]),
                          leaf_bytes(leaves), dt)
    (ta, tl, ts), = ran
    ta = t0 if clean else ta
    for r in riders:
        r.acc.add_phase("execute", dt, t0)
        r.acc.add_phase("launch", tl - ta, ta)
        r.acc.add_phase("sync", ts - tl, tl)
        r.acc.add_phase("to_host", t0 + dt - ts, ts)
        if r.ctx is not None:
            r.ctx.attach(sp.copy())
    return outs


def demux_into(r, demux, out) -> None:
    """One rider's result from its host output, in a ``serving.demux``
    span; a demux that raises sends the rider to its solo path."""
    t1 = time.perf_counter()
    try:
        with span_into(r.ctx, "serving.demux"):
            r.result = demux(out)
    except Exception:
        r.direct = True
        r.result = None
    r.acc.add_phase("demux", time.perf_counter() - t1)


def _pure_tree(call: Call) -> bool:
    """True when a bitmap tree uses only calls the PlanBuilder can
    express without per-query precompute or key-dependent leaves."""
    if call.name not in _PURE_BITMAP:
        return False
    if any(isinstance(v, Call) for v in call.args.values()):
        return False
    return all(_pure_tree(c) for c in call.children)
