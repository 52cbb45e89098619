"""Standing queries — write-through serving-cache maintenance.

The serving ResultCache (executor/serving.py) invalidates on write:
under sustained ingest every poll of a subscribed analytics query
pays a full restack + recompute.  This module makes subscribed reads
O(delta) instead — the registry holds each standing query's
materialized per-shard state, and the write plane pushes landed
per-fragment delta-log spans (models/fragment.py) through a
maintenance function: counts adjust by patched-span popcount deltas,
TopN/GroupBy re-rank only touched rows/groups, and the cache entry's
version snapshot is ADVANCED in place instead of swept.  The same
move Roaring makes spatially (touch only the containers that
changed) applied temporally.

Maintenance is bit-exact by construction: every state transition
recomputes the touched slice from CURRENT fragment contents and
diffs against the STORED materialization (never an assumed-old
value), so replays are idempotent and a write racing the snapshot
walk is re-covered by the next pass.  Anything structural — a view
entering or leaving the quantum cover (TTL expiry, rollup, a new
quantum's first write), a gen retire, a delta-log overflow, a Rows
row-set change — falls back to ONE full host re-seed, declared as
outcome="fallback" in metrics and flight records.

Supported registrations: Count over a pure bitmap tree, TopN over a
plain field (optional pure filter, windowed from/to), count-only
GroupBy over plain Rows children, and SQL ``SELECT COUNT(*) FROM t
[WHERE pushable]``.  Everything else raises StandingUnsupported at
registration time (typed 400 at the HTTP surface).  Each registered
result is validated against one cold execution before it is
accepted — the maintained path can never silently diverge.

``configure(enabled=False)`` turns the plane off (the port reads no
environment for it): registration rejects, on_write/catch_up no-op, and
the normal sweep-on-write serving behavior is untouched.
"""

from __future__ import annotations

import itertools
import threading
import time

import numpy as np

from pilosa_tpu_torch.executor.results import Pair
from pilosa_tpu_torch.executor.serving import (
    _MISS,
    Uncacheable,
    _fingerprint,
    field_snapshot,
    query_fields,
)
from pilosa_tpu_torch.models.index import EXISTENCE_FIELD
from pilosa_tpu_torch.models.schema import CACHE_TYPE_NONE
from pilosa_tpu_torch.models.view import VIEW_STANDARD
from pilosa_tpu_torch.obs import faults, flight, metrics
from pilosa_tpu_torch.pql import parse
from pilosa_tpu_torch.pql.ast import Call, Query

# the [standing] knobs, set through configure()
_ENABLED = True
_MAX = 256


def configure(enabled: bool | None = None,
              max_registrations: int | None = None) -> None:
    global _ENABLED, _MAX
    if enabled is not None:
        _ENABLED = bool(enabled)
    if max_registrations is not None:
        _MAX = int(max_registrations)


def enabled() -> bool:
    return _ENABLED


class StandingUnsupported(Exception):
    """A query shape the maintenance functions cannot express (typed
    registration rejection — HTTP 400)."""


# bitmap calls the host slice evaluator expresses
_TREE_CALLS = {"Row", "Range", "Union", "Intersect", "Difference",
               "Xor", "Not", "All"}


def _popcount(arr: np.ndarray) -> int:
    return int(np.bitwise_count(arr).sum())


class StandingQuery:
    """One registration: the query, its serving-cache key, and the
    materialized per-shard state the maintenance functions patch."""

    def __init__(self, sid: int, index: str, idx, q: Query | None,
                 kind: str, key: tuple, fields: frozenset):
        self.sid = sid
        self.index = index
        self.idx = idx          # identity-pinned: recreate = drop
        self.q = q              # None for SQL registrations
        self.kind = kind        # count | topn | groupby | sql
        self.key = key
        self.fields = fields
        self.fp = _fingerprint(key)
        self.lock = threading.Lock()
        self.snapshot: tuple = ()
        self.cover: tuple = ()
        self.state: dict = {}
        self.results = None     # the cached-results object
        self.error: str | None = None
        self.stats = {"incremental": 0, "fallback": 0, "noop": 0}
        # kind-specific plumbing (set by the registry)
        self.tree: Call | None = None       # count/sql filter tree
        self.field = None                   # topn field
        self.filter_call: Call | None = None
        self.n = None
        self.ids = None
        self.window = (None, None)          # topn from/to
        self.gb_fields: list = []           # groupby Rows fields
        self.gb_filter: Call | None = None
        self.row_lists: list = []
        self.combos = None
        self.sql_stmt = None                # sql canonical statement
        self.sql_text = None                # registration SQL text
        self.sql_schema = None              # cold schema template
        self.sql_row_type = tuple           # cold row container type

    def describe(self) -> dict:
        return {
            "id": self.sid,
            "index": self.index,
            "kind": self.kind,
            "query": ("".join(c.to_pql() for c in self.q.calls)
                      if self.q is not None else self.sql_text),
            "fields": sorted(self.fields),
            "fingerprint": self.fp,
            "maintains": dict(self.stats),
            "error": self.error,
        }


class StandingRegistry:
    """The standing-query plane attached to a ServingLayer."""

    def __init__(self, serving):
        self.serving = serving
        self.ex = serving.executor
        self.holder = serving.executor.holder
        self._lock = threading.Lock()
        self._by_id: dict[int, StandingQuery] = {}
        self._by_key: dict[tuple, StandingQuery] = {}
        self._ids = itertools.count(1)

    # -- registration ---------------------------------------------------

    def register(self, index: str, query) -> dict:
        """Register a PQL standing query (Count/TopN/GroupBy over a
        maintainable shape).  Seeds the materialized state, validates
        the seeded result against one cold execution, and plants the
        write-through cache entry."""
        self._check_admission()
        idx = self.holder.index(index)
        if idx is None:
            raise StandingUnsupported(f"index not found: {index}")
        q = parse(query) if isinstance(query, str) else query
        if len(q.calls) != 1:
            raise StandingUnsupported(
                "standing queries take exactly one call")
        call = q.calls[0]
        kind = {"Count": "count", "TopN": "topn",
                "GroupBy": "groupby"}.get(call.name)
        if kind is None:
            raise StandingUnsupported(
                f"not a standing-maintainable call: {call.name}")
        key = (index, repr(q.calls), None)
        try:
            fields = query_fields(idx, q)
        except Uncacheable as e:
            # the read set must be version-trackable to be maintained
            raise StandingUnsupported(str(e)) from e
        sq = StandingQuery(next(self._ids), index, idx, q, kind, key,
                           fields)
        getattr(self, f"_prep_{kind}")(sq, idx, call)
        return self._seed_and_admit(sq, idx)

    def register_sql(self, engine, sql: str) -> dict:
        """Register a SQL standing query: SELECT COUNT(*) FROM t
        [WHERE <pushable>].  The cache entry rides the SQL serving
        key, so /sql polls hit it like any cached statement."""
        from pilosa_tpu_torch.sql import ast as sast
        from pilosa_tpu_torch.sql import costplan
        from pilosa_tpu_torch.sql import wherec
        from pilosa_tpu_torch.sql.parser import parse_sql

        self._check_admission()
        stmts = parse_sql(sql)
        if len(stmts) != 1 or not isinstance(stmts[0], sast.Select):
            raise StandingUnsupported(
                "standing SQL takes exactly one SELECT")
        stmt = stmts[0]
        if (stmt.joins or stmt.group_by or stmt.having
                or stmt.order_by or stmt.limit is not None
                or stmt.offset is not None or stmt.distinct
                or stmt.from_select is not None):
            raise StandingUnsupported(
                "standing SQL supports SELECT COUNT(*) FROM t "
                "[WHERE ...] only")
        if len(stmt.items) != 1:
            raise StandingUnsupported("standing SQL selects COUNT(*)")
        expr = stmt.items[0].expr
        if not (isinstance(expr, sast.Agg) and expr.func == "count"
                and expr.arg is None and not expr.distinct):
            raise StandingUnsupported("standing SQL selects COUNT(*)")
        idx = self.holder.index(stmt.table)
        if idx is None:
            raise StandingUnsupported(f"table not found: {stmt.table}")
        if stmt.where is not None and (
                wherec.has_subquery(stmt.where)
                or not wherec.is_pushable(stmt.where)):
            raise StandingUnsupported(
                "standing SQL WHERE must be fully pushable")
        tree = (wherec.WhereCompiler(engine).compile_where(
            idx, stmt.where) if stmt.where is not None
            else Call("All"))
        canon = costplan.canonical(stmt)
        fields = costplan.stmt_read_fields(engine, idx, stmt)
        if fields is None:
            raise StandingUnsupported(
                "statement read set is not version-trackable")
        key = (idx.name, "sql\x00" + canon, None)
        sq = StandingQuery(next(self._ids), idx.name, idx, None,
                           "sql", key, fields)
        self._validate_tree(idx, tree)
        sq.tree = tree
        # cold shape template: the maintained SQLResult must compare
        # bit-exact with what the engine's own SELECT path returns
        cold = engine.query_one(sql)
        sq.sql_stmt = canon
        sq.sql_text = sql
        sq.sql_schema = list(cold.schema)
        if cold.rows:
            sq.sql_row_type = type(cold.rows[0])
        return self._seed_and_admit(sq, idx, cold=cold)

    def _check_admission(self):
        if not enabled():
            raise StandingUnsupported(
                "standing queries are disabled "
                "([standing] enabled=false)")
        if self.serving.cache is None:
            raise StandingUnsupported(
                "standing queries require the serving result cache")
        with self._lock:
            if len(self._by_id) >= _MAX:
                raise StandingUnsupported(
                    f"standing registration limit reached ({_MAX})")

    def _seed_and_admit(self, sq: StandingQuery, idx,
                        cold=None) -> dict:
        sq.snapshot = field_snapshot(idx, sq.fields, None)
        sq.cover = self._cover(sq, idx)
        self._reseed(sq, idx)
        self._assemble(sq, idx)
        # the registration gate: maintained-vs-cold bit-exactness,
        # proven once on the seeded state before any write lands
        if cold is None and sq.q is not None:
            cold = self.ex.execute(sq.index, sq.q, None)
        if cold is not None and sq.results != cold:
            raise StandingUnsupported(
                "maintained result diverges from cold execution")
        cache = self.serving.cache
        with self._lock:
            if sq.key in self._by_key:
                raise StandingUnsupported(
                    "query is already registered "
                    f"(id {self._by_key[sq.key].sid})")
            self._by_id[sq.sid] = sq
            self._by_key[sq.key] = sq
            metrics.STANDING_REGISTERED.set(len(self._by_id))
        cache.mark_standing(sq.key)
        cache.put(sq.key, sq.fields, sq.snapshot, sq.results)
        return sq.describe()

    def unregister(self, sid: int) -> bool:
        with self._lock:
            sq = self._by_id.pop(int(sid), None)
            if sq is None:
                return False
            self._by_key.pop(sq.key, None)
            metrics.STANDING_REGISTERED.set(len(self._by_id))
        if self.serving.cache is not None:
            self.serving.cache.unmark_standing(sq.key)
        return True

    def owns(self, key: tuple) -> bool:
        return key in self._by_key

    def list_info(self) -> list[dict]:
        with self._lock:
            return [sq.describe()
                    for sq in sorted(self._by_id.values(),
                                     key=lambda s: s.sid)]

    # -- the write-plane push / poll-time pull --------------------------

    def on_write(self, index: str | None = None, fields=None,
                 shards=None) -> None:
        """Maintain every registration a landed write can have
        touched.  ``fields`` narrows by read-set intersection (the
        same narrowing the cache sweep uses); ``index`` None means a
        cross-index event (SQL batch, TTL/rollup tick)."""
        if not enabled():
            return
        with self._lock:
            sqs = list(self._by_id.values())
        for sq in sqs:
            if index is not None and sq.index != index:
                continue
            if fields is not None and not (sq.fields & set(fields)):
                continue
            self.maintain(sq)

    def catch_up(self, key: tuple):
        """Poll-time pull: a cache miss on a registry-owned key runs
        maintenance synchronously and serves the advanced result —
        the poll never pays a full recompute outside declared
        fallbacks.  Returns _MISS when the registry cannot serve."""
        if not enabled():
            return _MISS
        sq = self._by_key.get(key)
        if sq is None:
            return _MISS
        self.maintain(sq)
        if sq.error is not None or sq.results is None:
            return _MISS
        return sq.results

    # -- maintenance ----------------------------------------------------

    def maintain(self, sq: StandingQuery) -> str:
        with sq.lock:
            return self._maintain_locked(sq)

    def _maintain_locked(self, sq: StandingQuery) -> str:
        t0 = time.perf_counter()
        idx = self.holder.index(sq.index)
        if idx is None or idx is not sq.idx:
            # drop/recreate retires the registration — a fresh index
            # of the same name is a different dataset
            sq.error = "index dropped"
            self.unregister(sq.sid)
            return "dropped"
        snap = field_snapshot(idx, sq.fields, None)
        if snap == sq.snapshot and sq.error is None:
            metrics.STANDING_MAINTAIN.inc(outcome="noop")
            sq.stats["noop"] += 1
            return "noop"
        outcome = "incremental"
        try:
            cover = self._cover(sq, idx)
            deltas = (self._diff(sq, idx) if cover == sq.cover
                      else None)
            if deltas is None:
                # structural: cover shift (TTL expiry, rollup, new
                # quantum), gen retire, log overflow, shape change —
                # ONE declared full re-seed
                sq.cover = cover
                self._reseed(sq, idx)
                outcome = "fallback"
            else:
                try:
                    self._apply(sq, idx, deltas)
                except _Restructure:
                    self._reseed(sq, idx)
                    outcome = "fallback"
            self._assemble(sq, idx)
            sq.snapshot = snap
            sq.error = None
            if faults.armed("audit-corrupt") and faults.take(
                    "audit-corrupt", f"standing:{sq.sid}"):
                # corruption drill (obs/audit.py): flip a bit in the
                # maintained result — the standing drift audit must
                # catch it at the next quiesce-point scrub
                from pilosa_tpu_torch.obs import audit as _audit
                sq.results = _audit.corrupt_results(sq.results)
        except StandingUnsupported as e:
            # the query drifted out of the maintainable shape (e.g. a
            # Rows row set the groupby path cannot follow): retire it
            sq.error = str(e)
            self.unregister(sq.sid)
            return "dropped"
        cache = self.serving.cache
        if cache is not None:
            cache.advance(sq.key, sq.fields, snap, sq.results)
        dur = time.perf_counter() - t0
        metrics.STANDING_MAINTAIN.inc(outcome=outcome)
        metrics.STANDING_MAINTAIN_SECONDS.observe(dur)
        sq.stats[outcome] += 1
        fl = flight.begin(sq.index,
                          sq.q if sq.q is not None else sq.key[1])
        if fl is not None:
            fl["maintain"] = outcome
            flight.commit(fl, dur, route="standing",
                          fingerprint=sq.fp)
        return outcome

    def _diff(self, sq: StandingQuery, idx):
        """Per-fragment delta spans between sq.snapshot and now, or
        None when incremental coverage cannot be proven (gen retire,
        log overflow, fragment set change)."""
        old_frags: dict = {}
        old_absent: set = set()
        for e in sq.snapshot:
            if len(e) == 2:
                old_absent.add(e[0])
            else:
                old_frags[(e[0], e[1], e[2])] = (e[3], e[4])
        out = []
        seen = set()
        for fname in sorted(sq.fields):
            f = idx.fields.get(fname)
            if f is None:
                if fname not in old_absent:
                    return None
                continue
            if fname in old_absent:
                return None
            for vname in sorted(f.views):
                v = f.views.get(vname)
                if v is None:
                    continue
                for shard in sorted(v.fragments):
                    fr = v.fragments.get(shard)
                    if fr is None:
                        continue
                    k = (fname, vname, shard)
                    seen.add(k)
                    old = old_frags.get(k)
                    if old is None:
                        return None  # new fragment: structural
                    gen, ver = old
                    if fr.gen != gen:
                        return None  # retired incarnation
                    if fr.version == ver:
                        continue
                    spans = fr.deltas_since(ver)
                    if spans is None:
                        return None  # log overflow / contention
                    out.append((fname, vname, shard, spans))
        if seen != set(old_frags):
            return None  # a fragment left (view expiry without gen?)
        return out

    def _cover(self, sq: StandingQuery, idx) -> tuple:
        """The quantum covers every windowed Row/TopN in the query
        currently reads — compared each maintenance so a cover shift
        (expiry/rollup/new quantum) declares a structural fallback."""
        out = []

        def walk(call: Call):
            if call.name in ("Row", "Range"):
                fname, _ = call.field_arg()
                f = idx.field(fname) if fname else None
                if f is not None and (call.arg("from") is not None
                                      or call.arg("to") is not None):
                    out.append((fname, tuple(f.views_for_range(
                        call.arg("from"), call.arg("to")))))
            for v in call.args.values():
                if isinstance(v, Call):
                    walk(v)
            for c in call.children:
                walk(c)

        if sq.q is not None:
            for c in sq.q.calls:
                walk(c)
        if sq.tree is not None:
            walk(sq.tree)
        if sq.kind == "topn" and sq.field is not None:
            out.append((sq.field.name,
                        tuple(self._topn_views(sq, idx))))
        return tuple(out)

    # -- host slice evaluation ------------------------------------------

    def _validate_tree(self, idx, call: Call) -> None:
        name = call.name
        if name not in _TREE_CALLS:
            raise StandingUnsupported(
                f"not a maintainable bitmap call: {name}")
        if name in ("Row", "Range"):
            fname, cond = call.condition_field()
            if cond is not None:
                raise StandingUnsupported(
                    "BSI conditions are not delta-maintainable")
            fname, _ = call.field_arg()
            f = idx.field(fname) if fname else None
            if f is None:
                raise StandingUnsupported(f"field not found: {fname}")
            if f.options.type.is_bsi:
                raise StandingUnsupported(
                    "BSI rows are not delta-maintainable")
            return
        if name == "Not" and len(call.children) != 1:
            raise StandingUnsupported("Not() takes one subquery")
        if name == "Difference" and not call.children:
            raise StandingUnsupported("Difference() takes subqueries")
        for c in call.children:
            self._validate_tree(idx, c)

    def _exist_slice(self, idx, shard: int, lo: int, hi: int):
        w = idx.existence_row(shard)
        if w is None:
            return np.zeros(hi - lo, dtype=np.uint32)
        return np.array(np.asarray(w, dtype=np.uint32)[lo:hi])

    def _tree_slice(self, idx, call: Call, shard: int, lo: int,
                    hi: int) -> np.ndarray:
        """Evaluate a validated bitmap tree over ONE shard's word
        span [lo, hi) from current fragment contents — the host twin
        of Executor._bitmap_call_shard, restricted to the patched
        slice so maintenance cost tracks the delta, not the shard."""
        name = call.name
        if name in ("Row", "Range"):
            fname, row_val = call.field_arg()
            f = idx.field(fname)
            acc = np.zeros(hi - lo, dtype=np.uint32)
            row_id = self.ex._row_id_for_value(f, row_val)
            if row_id is None:
                return acc
            for vn in f.views_for_range(call.arg("from"),
                                        call.arg("to")):
                v = f.views.get(vn)
                frag = v.fragments.get(shard) if v else None
                if frag is not None:
                    acc |= np.asarray(frag.row_words(row_id),
                                      dtype=np.uint32)[lo:hi]
            return acc
        if name == "All":
            return self._exist_slice(idx, shard, lo, hi)
        if name == "Not":
            sub = self._tree_slice(idx, call.children[0], shard, lo,
                                   hi)
            return self._exist_slice(idx, shard, lo, hi) & ~sub
        if not call.children:
            return np.zeros(hi - lo, dtype=np.uint32)
        acc = np.array(self._tree_slice(idx, call.children[0], shard,
                                        lo, hi))
        for c in call.children[1:]:
            sub = self._tree_slice(idx, c, shard, lo, hi)
            if name == "Union":
                acc |= sub
            elif name == "Intersect":
                acc &= sub
            elif name == "Xor":
                acc ^= sub
            else:  # Difference
                acc &= ~sub
        return acc

    def _row_slice(self, sq: StandingQuery, idx, shard: int,
                   row_id: int, views, lo: int, hi: int) -> np.ndarray:
        acc = np.zeros(hi - lo, dtype=np.uint32)
        for vn in views:
            v = sq.field.views.get(vn)
            frag = v.fragments.get(shard) if v else None
            if frag is not None:
                acc |= np.asarray(frag.row_words(row_id),
                                  dtype=np.uint32)[lo:hi]
        return acc

    # -- count / sql ----------------------------------------------------

    def _prep_count(self, sq: StandingQuery, idx, call: Call) -> None:
        if len(call.children) != 1:
            raise StandingUnsupported("Count() takes one subquery")
        self._validate_tree(idx, call.children[0])
        sq.tree = call.children[0]

    def _reseed_count(self, sq: StandingQuery, idx) -> None:
        words = idx.width // 32
        state = {"words": {}, "counts": {}}
        for shard in self.ex._shard_list(idx, None):
            w = self._tree_slice(idx, sq.tree, shard, 0, words)
            state["words"][shard] = w
            state["counts"][shard] = _popcount(w)
        sq.state = state

    def _apply_count(self, sq: StandingQuery, idx, deltas) -> None:
        words = idx.width // 32
        spans: dict[int, tuple[int, int]] = {}
        for _fname, _vname, shard, sp in deltas:
            for _row, lo, hi in sp:
                cur = spans.get(shard)
                spans[shard] = ((lo, hi) if cur is None
                                else (min(cur[0], lo),
                                      max(cur[1], hi)))
        for shard, (lo, hi) in spans.items():
            hi = min(hi, words)
            stored = sq.state["words"].get(shard)
            if stored is None:
                stored = np.zeros(words, dtype=np.uint32)
                sq.state["words"][shard] = stored
                sq.state["counts"][shard] = 0
            new = self._tree_slice(idx, sq.tree, shard, lo, hi)
            sq.state["counts"][shard] += (
                _popcount(new) - _popcount(stored[lo:hi]))
            stored[lo:hi] = new

    def _assemble_count(self, sq: StandingQuery, idx) -> None:
        total = int(sum(sq.state["counts"].values()))
        sq.results = [total]

    # sql shares count's tree state; only the result shape differs
    _reseed_sql = _reseed_count
    _apply_sql = _apply_count

    def _assemble_sql(self, sq: StandingQuery, idx) -> None:
        from pilosa_tpu_torch.sql.common import SQLResult
        total = int(sum(sq.state["counts"].values()))
        row = sq.sql_row_type((total,))
        sq.results = SQLResult(schema=list(sq.sql_schema), rows=[row])

    # -- topn -----------------------------------------------------------

    def _prep_topn(self, sq: StandingQuery, idx, call: Call) -> None:
        fname = call.arg("_field")
        f = idx.field(fname) if fname else None
        if f is None:
            raise StandingUnsupported("TopN requires a field")
        if f.options.type.is_bsi:
            raise StandingUnsupported("TopN over BSI fields")
        sq.field = f
        sq.n = call.arg("n")
        sq.ids = ([int(r) for r in call.arg("ids")]
                  if call.arg("ids") is not None else None)
        sq.window = (call.arg("from"), call.arg("to"))
        sq.filter_call = (call.children[0] if call.children else None)
        if sq.filter_call is not None:
            self._validate_tree(idx, sq.filter_call)
        if (sq.window == (None, None) and sq.filter_call is None
                and sq.ids is None
                and f.options.cache_type != CACHE_TYPE_NONE):
            # the cold path would serve the APPROXIMATE rank-cache
            # merge (fragment.top) — a maintained exact result could
            # not stay bit-exact against it
            raise StandingUnsupported(
                "unfiltered TopN over a rank-cached field serves the "
                "approximate cache path; use cache_type=none or a "
                "windowed/filtered registration")

    def _topn_views(self, sq: StandingQuery, idx) -> list[str]:
        return self.ex._field_views(sq.field, sq.window[0],
                                    sq.window[1])

    def _topn_filter_fields(self, sq: StandingQuery) -> set:
        if sq.filter_call is None:
            return set()
        out: set = set()

        def walk(c: Call):
            if c.name in ("Not", "All"):
                out.add(EXISTENCE_FIELD)
            fname, _ = c.field_arg()
            if fname is not None:
                out.add(fname)
            for ch in c.children:
                walk(ch)

        walk(sq.filter_call)
        return out

    def _reseed_topn(self, sq: StandingQuery, idx) -> None:
        words = idx.width // 32
        views = self._topn_views(sq, idx)
        state = {"filt": {}, "counts": {}}
        v = sq.field.views.get(VIEW_STANDARD)
        for shard in self.ex._shard_list(idx, None):
            filt = (self._tree_slice(idx, sq.filter_call, shard, 0,
                                     words)
                    if sq.filter_call is not None else None)
            state["filt"][shard] = filt
            frag = v.fragments.get(shard) if v else None
            if sq.ids is not None:
                rows = sq.ids
            else:
                rows = list(frag.row_ids) if frag is not None else []
            counts: dict[int, int] = {}
            for r in rows:
                rw = self._row_slice(sq, idx, shard, r, views, 0,
                                     words)
                counts[r] = _popcount(rw if filt is None
                                      else rw & filt)
            state["counts"][shard] = counts
        sq.state = state

    def _apply_topn(self, sq: StandingQuery, idx, deltas) -> None:
        words = idx.width // 32
        views = self._topn_views(sq, idx)
        ffields = self._topn_filter_fields(sq)
        touched: dict[int, set[int]] = {}
        fspans: dict[int, tuple[int, int]] = {}
        for fname, _vname, shard, sp in deltas:
            if fname == sq.field.name:
                touched.setdefault(shard, set()).update(
                    r for r, _lo, _hi in sp)
            if fname in ffields:
                for _row, lo, hi in sp:
                    cur = fspans.get(shard)
                    fspans[shard] = ((lo, hi) if cur is None
                                     else (min(cur[0], lo),
                                           max(cur[1], hi)))
        # filter patches first: adjust every candidate row by the
        # span's popcount difference against the STORED filter words
        for shard, (lo, hi) in fspans.items():
            hi = min(hi, words)
            filt = sq.state["filt"].get(shard)
            if filt is None:
                filt = np.zeros(words, dtype=np.uint32)
                sq.state["filt"][shard] = filt
                sq.state["counts"].setdefault(shard, {})
            new = self._tree_slice(idx, sq.filter_call, shard, lo, hi)
            old = filt[lo:hi]
            if np.array_equal(new, old):
                continue
            counts = sq.state["counts"].setdefault(shard, {})
            for r in counts:
                rw = self._row_slice(sq, idx, shard, r, views, lo, hi)
                counts[r] += (_popcount(rw & new)
                              - _popcount(rw & old))
            filt[lo:hi] = new
        # then touched candidate rows: full recount against the
        # current filter (delta rows only — O(delta rows x width))
        for shard, rows in touched.items():
            filt = sq.state["filt"].get(shard)
            counts = sq.state["counts"].setdefault(shard, {})
            for r in rows:
                r = int(r)
                if sq.ids is not None and r not in sq.ids:
                    continue
                rw = self._row_slice(sq, idx, shard, r, views, 0,
                                     words)
                counts[r] = _popcount(rw if filt is None
                                      else rw & filt)

    def _assemble_topn(self, sq: StandingQuery, idx) -> None:
        total: dict[int, int] = {}
        for counts in sq.state["counts"].values():
            for r, c in counts.items():
                total[r] = total.get(r, 0) + c
        pairs = [Pair(id=r, count=c) for r, c in total.items()
                 if c > 0 or sq.ids is not None]
        sq.results = [self.ex._finish_topn(sq.field, pairs, sq.n)]

    # -- groupby --------------------------------------------------------

    def _prep_groupby(self, sq: StandingQuery, idx,
                      call: Call) -> None:
        if any(call.arg(k) is not None
               for k in ("aggregate", "having", "limit", "previous")):
            raise StandingUnsupported(
                "standing GroupBy is count-only (no aggregate/"
                "having/limit/previous)")
        if not call.children or any(
                c.name != "Rows" or c.children
                or set(c.args) - {"_field"}
                for c in call.children):
            raise StandingUnsupported(
                "standing GroupBy takes plain Rows(field) children")
        for rc in call.children:
            f = idx.field(rc.arg("_field") or "")
            if f is None or f.options.type.is_bsi:
                raise StandingUnsupported(
                    "Rows requires a plain set-like field")
            sq.gb_fields.append(f)
        sq.gb_filter = call.arg("filter")
        if sq.gb_filter is not None:
            self._validate_tree(idx, sq.gb_filter)

    def _gb_row_lists(self, sq: StandingQuery, idx) -> list:
        call = sq.q.calls[0]
        return [self.ex._rows_ids(idx, rc, None)
                for rc in call.children]

    def _gb_shard_counts(self, sq: StandingQuery, idx,
                         shard: int) -> np.ndarray:
        words = idx.width // 32
        filt = (self._tree_slice(idx, sq.gb_filter, shard, 0, words)
                if sq.gb_filter is not None else None)
        rows_words = []
        for f, rl in zip(sq.gb_fields, sq.row_lists):
            v = f.views.get(VIEW_STANDARD)
            frag = v.fragments.get(shard) if v else None
            rw = {}
            for r in rl:
                rw[r] = (np.asarray(frag.row_words(r),
                                    dtype=np.uint32)
                         if frag is not None
                         else np.zeros(words, dtype=np.uint32))
            rows_words.append(rw)
        counts = np.zeros(len(sq.combos), dtype=np.int64)
        for ci, combo in enumerate(sq.combos):
            acc = None
            for fi, gi in enumerate(combo):
                w = rows_words[fi][sq.row_lists[fi][int(gi)]]
                acc = w if acc is None else acc & w
            if filt is not None:
                acc = acc & filt
            counts[ci] = _popcount(acc)
        return counts

    def _reseed_groupby(self, sq: StandingQuery, idx) -> None:
        sq.row_lists = self._gb_row_lists(sq, idx)
        sq.combos = (np.indices([len(rl) for rl in sq.row_lists])
                     .reshape(len(sq.row_lists), -1).T
                     .astype(np.int64)
                     if all(sq.row_lists) else np.zeros((0, 0)))
        state = {"counts": {}}
        if all(sq.row_lists):
            for shard in self.ex._shard_list(idx, None):
                state["counts"][shard] = self._gb_shard_counts(
                    sq, idx, shard)
        sq.state = state

    def _apply_groupby(self, sq: StandingQuery, idx, deltas) -> None:
        if self._gb_row_lists(sq, idx) != sq.row_lists:
            # the Rows row sets moved (new row id): structural
            raise _Restructure()
        gnames = ({f.name for f in sq.gb_fields}
                  | self._gb_filter_fields(sq))
        shards = {shard for fname, _vn, shard, _sp in deltas
                  if fname in gnames}
        for shard in shards:
            sq.state["counts"][shard] = self._gb_shard_counts(
                sq, idx, shard)

    def _gb_filter_fields(self, sq: StandingQuery) -> set:
        if sq.gb_filter is None:
            return set()
        out: set = set()

        def walk(c: Call):
            if c.name in ("Not", "All"):
                out.add(EXISTENCE_FIELD)
            fname, _ = c.field_arg()
            if fname is not None:
                out.add(fname)
            for ch in c.children:
                walk(ch)

        walk(sq.gb_filter)
        return out

    def _assemble_groupby(self, sq: StandingQuery, idx) -> None:
        if not all(sq.row_lists):
            sq.results = [[]]
            return
        counts = np.zeros(len(sq.combos), dtype=np.int64)
        for c in sq.state["counts"].values():
            counts += c
        sq.results = [self.ex._assemble_groupby(
            sq.gb_fields, sq.row_lists, sq.combos, counts, None,
            "sum", None, None, None, None)]

    # -- dispatch -------------------------------------------------------

    def _reseed(self, sq: StandingQuery, idx) -> None:
        getattr(self, f"_reseed_{sq.kind}")(sq, idx)

    def _apply(self, sq: StandingQuery, idx, deltas) -> None:
        getattr(self, f"_apply_{sq.kind}")(sq, idx, deltas)

    def _assemble(self, sq: StandingQuery, idx) -> None:
        getattr(self, f"_assemble_{sq.kind}")(sq, idx)


class _Restructure(Exception):
    """Internal: an incremental apply discovered a structural change
    mid-flight (Rows row-set growth) — re-seed instead."""
