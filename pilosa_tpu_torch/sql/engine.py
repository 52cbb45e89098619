"""SQL engine facade: parse → authorize → dispatch.

The planner mirrors sql3/planner's central idea — push WHERE filters
and aggregates down into per-shard PQL ops (PlanOpPQLTableScan /
PlanOpPQLAggregate / PlanOpPQLGroupBy, sql3/planner/planoptimizer.go)
— without a fan-out operator: the executor's shard loop or stacked
engine already spans the data.

The modules (sql3 separates parser/planner/ops for the same
reason):
  common.py       result shape, SQL types, ORDER BY/LIMIT helpers
  wherec.py       WHERE → PQL compiler + host residue fold-back
  statements.py   DDL / DML / COPY / CREATE FUNCTION execution
  plan.py         the SELECT plan-op layer (EXPLAIN prints these ops)
  select_exec.py  the strategy bodies the plan ops run
  engine.py       this facade: parse, authz, statement dispatch, UDF
                  registry, schema lookups shared by the modules

Supported surface: CREATE/DROP/ALTER TABLE, SHOW, INSERT [OR
REPLACE], BULK INSERT, DELETE ... WHERE, COPY, CREATE FUNCTION/VIEW,
EXPLAIN, SELECT with projections, aggregates (COUNT[ DISTINCT]/SUM/
MIN/MAX/AVG/PERCENTILE/VAR/CORR), WHERE (=, !=, <, <=, >, >=, IN,
LIKE, BETWEEN, IS [NOT] NULL, AND/OR/NOT, subqueries), GROUP BY +
HAVING, ORDER BY (multi-key), LIMIT/OFFSET, DISTINCT, JOIN.

Optimizer rewrites (the planoptimizer.go analogs) bake into
compilation as one-line decisions instead of tree transforms: filter
pushdown (wherec), aggregate/GROUP BY/Sort/LIMIT/DISTINCT pushdown
(plan.py dispatch), join hash refinement (select_exec.select_join),
subquery materialization (wherec.fold_subqueries).

With a serving layer on its executor (``Executor.enable_serving``) a
SELECT takes the serving arm: statement-level admission
(``sched.classify_sql``), the serving ResultCache keyed by the
canonical statement and guarded by its read set's snapshot, standing
SQL registrations, a route-"sql" flight record, and every pushed call
through ``ServingLayer.execute`` (so fused batching, the ragged program
and the PQL result cache apply to SQL's operators); writes sweep the
cache.  Without one, or with ``costplan.configure(enabled=False)``,
every SELECT runs ``op.run()`` on the host path and every pushed call
goes to ``Executor._execute_call``: bit-exact either way, because the
serving path's fallback is the solo path.  ``SQLEngine(holder)``
builds ``Executor(holder, device)``, which runs on the CUDA card
unless ``device="cpu"``.
"""

from __future__ import annotations

import threading
import time

from pilosa_tpu_torch.executor.executor import ExecError, Executor
from pilosa_tpu_torch.models import Holder
from pilosa_tpu_torch.obs import flight, metrics
from pilosa_tpu_torch.obs import stats as _stats
from pilosa_tpu_torch.obs.tracing import start_span
from pilosa_tpu_torch.sql import ast, costplan, plan
from pilosa_tpu_torch.sql.common import SQLResult
from pilosa_tpu_torch.sql.lexer import SQLError
from pilosa_tpu_torch.sql.parser import parse_sql
from pilosa_tpu_torch.sql.select_exec import SelectExec
from pilosa_tpu_torch.sql.statements import StatementExec
from pilosa_tpu_torch.sql.wherec import WhereCompiler

__all__ = ["SQLEngine", "SQLError", "SQLResult"]


class SQLEngine:
    def __init__(self, holder: Holder, executor: Executor | None = None,
                 device=None):
        self.holder = holder
        # share the API's executor when one is given: SQL and PQL then
        # see the same device stacks
        self.executor = executor if executor is not None \
            else Executor(holder, device)
        # per-thread serving state: the statement's derived QoS for
        # inner calls, and a reentrancy flag so nested selects (views,
        # derived tables, subqueries) skip the statement-level
        # admission, cache and flight wrapper
        self._tls = threading.local()
        # name -> stored Select (sql3 CREATE VIEW); views re-execute
        # on read
        self._views: dict[str, ast.Select] = {}
        # UPPER name -> (ast.CreateFunction, captured snapshot)
        # (scalar-expression UDFs; the reference parses CREATE
        # FUNCTION but disables execution because its bodies ran
        # external code — these bodies are pure SQL expressions, so
        # evaluation is safe)
        self._functions: dict[str, tuple] = {}
        self.wherec = WhereCompiler(self)
        self.stmts = StatementExec(self)
        self.select = SelectExec(self)

    # -- authz ----------------------------------------------------------

    def _stmt_access(self, stmt) -> tuple[str | None, str]:
        """(table, needed-permission) for one statement."""
        if isinstance(stmt, (ast.Select, ast.ShowColumns,
                             ast.ShowCreateTable)):
            # a view's access rides its underlying table
            v = self._views.get(stmt.table) if isinstance(
                stmt, ast.Select) else None
            return (v.table if v is not None else stmt.table), "read"
        if isinstance(stmt, ast.AlterTable):
            return stmt.table, "write"
        if isinstance(stmt, ast.AlterView):
            return stmt.select.table, "read"
        if isinstance(stmt, ast.CreateView):
            return stmt.select.table, "read"
        if isinstance(stmt, (ast.DropView, ast.ShowViews,
                             ast.ShowFunctions, ast.ShowDatabases)):
            return None, "read"
        if isinstance(stmt, (ast.CreateFunction, ast.DropFunction)):
            return None, "write"
        if isinstance(stmt, ast.ShowTables):
            return None, "read"
        if isinstance(stmt, (ast.CreateTable, ast.DropTable,
                             ast.Insert, ast.Delete)):
            return stmt.name if hasattr(stmt, "name") else stmt.table, \
                "write"
        return None, "write"

    def _stmt_accesses(self, stmt) -> list[tuple[str | None, str]]:
        """All (table, permission) checks for one statement —
        statements touching two tables need both."""
        if isinstance(stmt, ast.Copy):
            # reading src into a writable dst must not bypass src's
            # read permission (exfiltration via COPY)
            return [(stmt.src, "read"), (stmt.dst, "write")]
        return [self._stmt_access(stmt)]

    @staticmethod
    def _can_read(auth_check, table: str) -> bool:
        try:
            auth_check(table, "read")
            return True
        except Exception:
            return False

    # -- entry points ---------------------------------------------------

    def query(self, sql: str, auth_check=None,
              write_guard=None, qos=None) -> list[SQLResult]:
        """Execute statements.

        auth_check(table_or_None, "read"|"write") raises on denial —
        the SQL-side authz hook (the reference resolves table names
        during planning and consults authz per table).  write_guard()
        is called once when any statement writes (the exclusive-
        transaction read-only gate).  ``qos`` (executor/sched.py QoS)
        carries the request's admission intent to the serving arm.
        """
        try:
            stmts = parse_sql(sql)
            writes = any(perm == "write"
                         for s in stmts
                         for _t, perm in self._stmt_accesses(s))
            if write_guard is not None and writes:
                write_guard()
            if auth_check is not None:
                for stmt in stmts:
                    for table, perm in self._stmt_accesses(stmt):
                        auth_check(table, perm)
            try:
                return [self._execute(stmt, auth_check, qos=qos)
                        for stmt in stmts]
            finally:
                if writes:
                    # eager sweep after SQL writes, narrowed to the
                    # written tables' fields; the cache's get-time
                    # snapshot check still backstops correctness
                    serving = getattr(self.executor, "serving", None)
                    if serving is not None and serving.cache is not None:
                        wf = self._written_fields(stmts)
                        serving.cache.sweep(self.holder, wf)
                        serving.standing.on_write(None, wf)
        except ExecError as e:  # surface executor errors as SQL errors
            raise SQLError(str(e)) from e

    def query_one(self, sql: str, auth_check=None,
                  write_guard=None, qos=None) -> SQLResult:
        return self.query(sql, auth_check, write_guard, qos=qos)[-1]

    def _written_fields(self, stmts) -> set | None:
        """Field names the batch's write statements can touch (every
        field of each written table, plus existence): the cache
        sweep's narrowing.  None (sweep everything) when a written
        table cannot be resolved (DDL that dropped it, schema
        statements)."""
        from pilosa_tpu_torch.models.index import EXISTENCE_FIELD
        out: set = set()
        for s in stmts:
            for table, perm in self._stmt_accesses(s):
                if perm != "write":
                    continue
                if table is None:
                    return None
                idx = self.holder.index(table)
                if idx is None:
                    return None
                out.update(idx.fields)
        out.add(EXISTENCE_FIELD)
        return out

    # -- statement dispatch ---------------------------------------------

    def _execute(self, stmt, auth_check=None, qos=None) -> SQLResult:
        st = self.stmts
        if isinstance(stmt, ast.CreateTable):
            return st.create_table(stmt)
        if isinstance(stmt, ast.DropTable):
            return st.drop_table(stmt)
        if isinstance(stmt, ast.ShowTables):
            # the reference's 9-column table listing
            # (sql3/planner/compileshow.go; defs_sql1 show tables).
            # No per-table audit metadata is tracked: _id/owner/
            # updated_by/description are empty and timestamps are the
            # epoch, as the reference emits for untracked fields.
            names = sorted(self.holder.indexes)
            if auth_check is not None:
                names = [n for n in names
                         if self._can_read(auth_check, n)]
            epoch = "1970-01-01T00:00:00Z"
            return SQLResult(
                schema=[("_id", "string"), ("name", "string"),
                        ("owner", "string"), ("updated_by", "string"),
                        ("created_at", "timestamp"),
                        ("updated_at", "timestamp"), ("keys", "bool"),
                        ("space_used", "int"),
                        ("description", "string")],
                rows=[(None, n, "", "", epoch, epoch,
                       bool(self.holder.index(n).keys), 0, "")
                      for n in names])
        if isinstance(stmt, ast.ShowColumns):
            return st.show_columns(stmt)
        if isinstance(stmt, ast.ShowCreateTable):
            return st.show_create_table(stmt)
        if isinstance(stmt, ast.AlterTable):
            return st.alter_table(stmt)
        if isinstance(stmt, ast.CreateView):
            if stmt.name in self._views or \
                    self.holder.index(stmt.name) is not None:
                if stmt.if_not_exists and stmt.name in self._views:
                    return SQLResult()
                raise SQLError(f"view or table exists: {stmt.name}")
            if stmt.select.table in self._views:
                raise SQLError("views over views are not supported")
            self._views[stmt.name] = stmt.select
            return SQLResult()
        if isinstance(stmt, ast.DropView):
            if stmt.name not in self._views:
                if stmt.if_exists:
                    return SQLResult()
                raise SQLError(f"view not found: {stmt.name}")
            del self._views[stmt.name]
            return SQLResult()
        if isinstance(stmt, ast.ShowViews):
            return SQLResult(schema=[("name", "string")],
                             rows=[(n,) for n in sorted(self._views)])
        if isinstance(stmt, ast.CreateFunction):
            return st.create_function(stmt)
        if isinstance(stmt, ast.DropFunction):
            name = stmt.name.upper()
            if name not in self._functions:
                if stmt.if_exists:
                    return SQLResult()
                raise SQLError(f"function not found: {stmt.name}")
            del self._functions[name]
            return SQLResult()
        if isinstance(stmt, ast.Explain):
            return plan.explain(self, stmt.stmt)
        if isinstance(stmt, ast.Copy):
            return st.copy(stmt)
        if isinstance(stmt, ast.AlterView):
            if stmt.name not in self._views:
                raise SQLError(f"view not found: {stmt.name}")
            if stmt.select.table in self._views:
                raise SQLError("views over views are not supported")
            self._views[stmt.name] = stmt.select
            return SQLResult()
        if isinstance(stmt, ast.ShowDatabases):
            return SQLResult(schema=[("name", "string")], rows=[])
        if isinstance(stmt, ast.ShowFunctions):
            rows = [(fd.name,
                     "(" + ", ".join(f"@{p} {t}" for p, t in fd.params)
                     + f") returns {fd.returns}")
                    for _n, (fd, _cap)
                    in sorted(self._functions.items())]
            return SQLResult(schema=[("name", "string"),
                                     ("signature", "string")],
                             rows=rows)
        if isinstance(stmt, ast.Insert):
            return st.insert(stmt)
        if isinstance(stmt, ast.BulkInsert):
            return st.bulk_insert(stmt)
        if isinstance(stmt, ast.Delete):
            return st.delete(stmt)
        if isinstance(stmt, ast.Select):
            return self._select(stmt, qos=qos)
        raise SQLError(f"unsupported statement {type(stmt).__name__}")

    # -- SELECT ---------------------------------------------------------

    def _select(self, stmt: ast.Select, qos=None) -> SQLResult:
        """Plan (timed into SQL_PLAN_COST), then the serving arm, or the
        host path: without a serving layer, with pushdown off, and for
        nested selects (the outer statement owns admission, cache and
        the flight record), counting the planner's pushdown decisions
        with outcome "host".  Spans: ``sql.statement`` over ``sql.plan``
        and ``sql.run``."""
        serving = getattr(self.executor, "serving", None)
        with start_span("sql.statement", table=stmt.table or ""):
            with start_span("sql.plan"):
                t0 = time.perf_counter()
                op = plan.plan_select(self, stmt)
                metrics.SQL_PLAN_COST.observe(
                    (time.perf_counter() - t0) * 1e3)
            with start_span("sql.run"):
                nested = getattr(self._tls, "active", False)
                if serving is None or not costplan.enabled() or nested:
                    if not nested:
                        for opname, _outcome in op.decisions():
                            metrics.SQL_PUSHDOWN.inc(op=opname,
                                                     outcome="host")
                    return op.run()
                return self._select_serving(serving, op, stmt, qos)

    def _select_serving(self, serving, op, stmt, qos) -> SQLResult:
        """SELECT on the serving arm: per-statement cost-classed
        admission (executor/sched.py), then _run_select."""
        from pilosa_tpu_torch.executor import sched as _sched
        from pilosa_tpu_torch.executor.serving import heavy_gate
        canon = costplan.canonical(stmt)
        fp = costplan.fingerprint(stmt.table or "", canon)
        cls = _sched.classify_sql(stmt, qos, fingerprint=fp)
        if (qos is not None and qos.deadline_s is not None
                and time.monotonic() > qos.deadline_s):
            metrics.ADMISSION_TOTAL.inc(**{"class": cls,
                                           "outcome": "expired"})
            raise _sched.ServingDeadlineExceeded(
                "deadline expired before SQL execution")
        if cls == _sched.CLASS_HEAVY and serving.sched is not None:
            with heavy_gate(serving.sched, qos, cls) as admit:
                return self._run_select(serving, op, stmt, qos, canon,
                                        fp, cls, admit=admit)
        metrics.ADMISSION_TOTAL.inc(**{"class": cls,
                                       "outcome": "admitted"})
        return self._run_select(serving, op, stmt, qos, canon, fp, cls)

    def _run_select(self, serving, op, stmt, qos, canon: str,
                    fp: str, cls: str, admit=None) -> SQLResult:
        """A single-table statement's result in the serving ResultCache
        (keyed by the canonical statement, guarded by its read set's
        snapshot, so writes invalidate SQL results as they do PQL ones),
        a standing registration's maintained result, or a run whose
        inner calls ride the point lane of the serving layer, with a
        route-"sql" flight record of the plan fingerprint and the
        planner's pushdown decisions.  ``admit`` (start, seconds) is the
        heavy-slot wait before it, the record's ``admit`` phase; the
        inner reads' phases, the batch leader's work for them included,
        land in the same record."""
        from pilosa_tpu_torch.executor import sched as _sched
        from pilosa_tpu_torch.executor.serving import _MISS, field_snapshot
        t0 = time.perf_counter()
        decisions = op.decisions()
        idx = getattr(op, "idx", None)
        key = fields = snap = None
        if idx is not None and serving.cache is not None:
            fields = costplan.stmt_read_fields(self, idx, stmt)
            if fields is not None:
                key = (idx.name, "sql\x00" + canon, None)
                snap = field_snapshot(idx, fields)
                hit = serving.cache.get(idx, key, cur_snap=snap)
                if hit is not _MISS:
                    metrics.RESULT_CACHE.inc(outcome="hit")
                    self._commit_sql_flight(
                        stmt, canon, fp, cls, qos, decisions,
                        time.perf_counter() - t0, routes=["cached"],
                        admit=admit)
                    return hit
                # a standing SQL registration: a stale poll pulls
                # maintenance instead of planning the SELECT again
                if serving.standing.owns(key):
                    got = serving.standing.catch_up(key)
                    if got is not _MISS:
                        self._commit_sql_flight(
                            stmt, canon, fp, cls, qos, decisions,
                            time.perf_counter() - t0,
                            routes=["standing"], admit=admit)
                        return got
                metrics.RESULT_CACHE.inc(outcome="miss")
        fl = flight.begin(stmt.table or "", canon)
        if fl is not None and admit is not None:
            flight.note_phase("admit", admit[1], admit[0])
        inner = _sched.QoS(
            tenant=qos.tenant if qos is not None else "default",
            priority=_sched.CLASS_POINT,
            deadline_ms=qos.deadline_ms if qos is not None else None,
            deadline_s=qos.deadline_s if qos is not None else None)
        self._tls.qos = inner
        self._tls.active = True
        err = None
        try:
            res = op.run()
        except Exception as e:
            err = f"{type(e).__name__}: {e}"
            raise
        finally:
            self._tls.active = False
            self._tls.qos = None
            dur = time.perf_counter() - t0
            if fl is not None:
                fl["tenant"] = qos.tenant if qos is not None \
                    else "default"
                fl["priority"] = cls
                fl["pushdown"] = [{"op": o, "outcome": oc}
                                  for o, oc in decisions]
                flight.commit(fl, dur, route="sql", fingerprint=fp,
                              error=err)
            for o, oc in decisions:
                metrics.SQL_PUSHDOWN.inc(op=o, outcome=oc)
        if key is not None and field_snapshot(idx, fields) == snap:
            # store only if no write raced the execution
            cost = None
            if _stats.enabled():
                cost = _stats.est_recompute_ms(fp)
                if cost is None:
                    cost = dur * 1e3
            serving.cache.put(key, fields, snap, res, cost_ms=cost)
        return res

    def _commit_sql_flight(self, stmt, canon, fp, cls, qos, decisions,
                           dur: float, routes=None, admit=None):
        """A route-"sql" flight record for a serve that ran no inner
        call (a cache hit or a standing result), marked cached so the
        catalog's recompute-cost estimate ignores it."""
        fl = flight.begin(stmt.table or "", canon)
        if fl is None:
            return
        if admit is not None:
            flight.note_phase("admit", admit[1], admit[0])
        fl["tenant"] = qos.tenant if qos is not None else "default"
        fl["priority"] = cls
        fl["pushdown"] = [{"op": o, "outcome": oc} for o, oc in decisions]
        if routes:
            fl["serving_routes"] = list(routes)
        fl["cached"] = True
        flight.commit(fl, dur, route="sql", fingerprint=fp)

    def run_call(self, idx, call):
        """One pushed read call: through the serving layer (point lane,
        the statement owns admission) when the executor has one and
        pushdown is on, else the executor's solo path."""
        serving = getattr(self.executor, "serving", None)
        if serving is None or not costplan.enabled():
            return self.executor._execute_call(idx, call, None)
        from pilosa_tpu_torch.pql.ast import Query
        qos = getattr(self._tls, "qos", None)
        return serving.execute(idx.name, Query(calls=[call]), None,
                               qos=qos)[0]

    # -- schema lookups shared by the modules ---------------------------

    def _index(self, name: str):
        idx = self.holder.index(name)
        if idx is None:
            raise SQLError(f"table not found: {name}")
        return idx

    def _field(self, idx, name: str):
        f = idx.field(name)
        if f is None:
            raise SQLError(f"column not found: {name}")
        return f

    def _col_id(self, idx, v, create=True):
        if isinstance(v, str):
            tr = idx.column_translator
            if tr is None:
                raise SQLError(f"table {idx.name} has integer _id")
            return tr.create_keys(v)[v] if create else \
                tr.find_keys(v).get(v)
        if idx.keys:
            raise SQLError(
                f"table {idx.name} has string _id; got {v!r}")
        return int(v)

    # -- UDF registry ---------------------------------------------------

    def _udf_callables(self) -> dict:
        return {name: self._make_udf(defn)
                for name, defn in self._functions.items()}

    def _udf_types(self) -> dict:
        return {name: stmt.returns
                for name, (stmt, _cap) in self._functions.items()}

    def _make_udf(self, defn):
        """Callable for one UDF.  Callees come from the `captured`
        snapshot bound at CREATE time, so later DROP + recreate can
        never splice a cycle into an existing body, and the child
        closures build once per definition, not once per row."""
        from pilosa_tpu_torch.sql.funcs import Evaluator
        stmt, captured = defn
        child = {n: self._make_udf(d) for n, d in captured.items()}
        ev = Evaluator(udfs=child)

        def call(args):
            if len(args) != len(stmt.params):
                raise SQLError(
                    f"{stmt.name} expects {len(stmt.params)} "
                    f"arguments, got {len(args)}")
            env = {"@" + p: v for (p, _t), v in zip(stmt.params, args)}
            return ev.eval(stmt.body, env)
        return call
