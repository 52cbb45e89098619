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

The port's engine takes the JAX package's solo arm, the one its
engine takes without a serving layer: every SELECT runs ``op.run()``
on the host path and every pushed call goes to
``Executor._execute_call``.  The serving plane's methods
(``_select_serving``, ``_run_select``, the serving branch of
``run_call``, the statement result cache and the write-path sweep)
are left out until the port has a serving layer.
``SQLEngine(holder)`` builds ``Executor(holder, device)``, which runs
on the CUDA card unless ``device="cpu"``.
"""

from __future__ import annotations

import time

from pilosa_tpu_torch.executor.executor import ExecError, Executor
from pilosa_tpu_torch.models import Holder
from pilosa_tpu_torch.obs import metrics
from pilosa_tpu_torch.sql import ast, plan
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
              write_guard=None) -> list[SQLResult]:
        """Execute statements.

        auth_check(table_or_None, "read"|"write") raises on denial —
        the SQL-side authz hook (the reference resolves table names
        during planning and consults authz per table).  write_guard()
        is called once when any statement writes (the exclusive-
        transaction read-only gate).
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
            return [self._execute(stmt, auth_check) for stmt in stmts]
        except ExecError as e:  # surface executor errors as SQL errors
            raise SQLError(str(e)) from e

    def query_one(self, sql: str, auth_check=None,
                  write_guard=None) -> SQLResult:
        return self.query(sql, auth_check, write_guard)[-1]

    # -- statement dispatch ---------------------------------------------

    def _execute(self, stmt, auth_check=None) -> SQLResult:
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
            return self._select(stmt)
        raise SQLError(f"unsupported statement {type(stmt).__name__}")

    # -- SELECT ---------------------------------------------------------

    def _select(self, stmt: ast.Select) -> SQLResult:
        """Plan (timed into SQL_PLAN_COST) and run on the host path,
        counting the planner's pushdown decisions with outcome
        "host", as the JAX engine does without a serving layer."""
        t0 = time.perf_counter()
        op = plan.plan_select(self, stmt)
        metrics.SQL_PLAN_COST.observe((time.perf_counter() - t0) * 1e3)
        for opname, _outcome in op.decisions():
            metrics.SQL_PUSHDOWN.inc(op=opname, outcome="host")
        return op.run()

    def run_call(self, idx, call):
        """Run one pushed read call on the executor's solo path."""
        return self.executor._execute_call(idx, call, None)

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
