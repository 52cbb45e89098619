"""The SELECT plan-op layer: one dispatch decision, two consumers.

``plan_select`` inspects a parsed SELECT plus the schema — executing
nothing — and returns the plan operator that will serve it.  Each op
renders itself for EXPLAIN (``lines()``) and executes on demand
(``run()``), so the strategy EXPLAIN prints is by construction the
strategy execution takes (the reference builds the same PlanOperator
tree for both, sql3/planner/executionplanner.go; EXPLAIN is
PlanOperator.Plan(), sql3/planner/explain rendering).

Operator set (the sql3/planner analogs):
  ConstProjectOp    FROM-less projection
  ViewExpandOp      stored-view re-execution
  NestedLoopJoinOp  opnestedloops.go (hashed right side)
  PQLGroupByOp      PlanOpPQLGroupBy pushdown / generic hashed
  PQLAggregateOp    PlanOpPQLAggregate pushdown
  DistinctScanOp    PlanOpPQLDistinctScan
  ExtractScanOp     PlanOpPQLTableScan + sort/limit pushdown
"""

from __future__ import annotations

from pilosa_tpu_torch.pql.ast import Call
from pilosa_tpu_torch.sql import ast
from pilosa_tpu_torch.sql.common import SQLResult
from pilosa_tpu_torch.sql.common import declared_fields as _declared_fields
from pilosa_tpu_torch.sql.lexer import SQLError
from pilosa_tpu_torch.sql.wherec import has_subquery, split_where

_FILTER_PREFIX = "filter pushdown (PQL, shard-parallel device scan): "


def _filter_lines(eng, idx, where) -> list[str]:
    """EXPLAIN rendering of the WHERE pushdown WITHOUT executing —
    subqueries fold at execution time, so a filter containing one
    cannot be rendered without running it."""
    if where is not None and has_subquery(where):
        return [_FILTER_PREFIX
                + "(contains subqueries — evaluated at execution time)"]
    push = residue = None
    if where is not None:
        push, residue = split_where(where)
    filt = eng.wherec.where_call(idx, push) if push is not None \
        else Call("All")
    out = [_FILTER_PREFIX + filt.to_pql()]
    if residue is not None:
        out.append("host residue filter: row-wise expression over the "
                   "pushed result (ConstRow fold-back)")
    return out


class PlanOp:
    """One SELECT strategy: EXPLAIN rendering + execution +
    pushdown accounting."""

    def lines(self) -> list[str]:
        raise NotImplementedError

    def run(self) -> SQLResult:
        raise NotImplementedError

    def decisions(self) -> list[tuple[str, str]]:
        """(operator, outcome) planner decisions for the flight
        record and ``pilosa_sql_pushdown_total``: outcome "pushdown"
        = the operator rides PQL on the fused serving plane, "host" =
        it executes host-side over materialized rows."""
        return []


class ConstProjectOp(PlanOp):
    def __init__(self, eng, stmt):
        self.eng, self.stmt = eng, stmt

    def lines(self):
        return ["constant projection (no table)"]

    def decisions(self):
        return [("const", "host")]

    def run(self):
        return self.eng.select.select_const(self.stmt)


class ViewExpandOp(PlanOp):
    def __init__(self, eng, stmt):
        self.eng, self.stmt = eng, stmt

    def lines(self):
        return [f"view expansion: {self.stmt.table}"]

    def decisions(self):
        return [("view", "host")]

    def run(self):
        return self.eng.select.select_view(self.stmt)


class DerivedTableOp(PlanOp):
    """FROM (SELECT ...): the inner select materializes, the outer
    runs over its rows (sql3 tableOrSubquery; defs_subquery)."""

    def __init__(self, eng, stmt):
        self.eng, self.stmt = eng, stmt

    def lines(self):
        inner = plan_select(self.eng, self.stmt.from_select).lines()
        return [f"derived table (FROM subquery): {line}"
                for line in inner] + ["outer projection over the "
                                      "materialized rows"]

    def run(self):
        return self.eng.select.select_derived(self.stmt)

    def decisions(self):
        return [("derived", "host")]


class NestedLoopJoinOp(PlanOp):
    def __init__(self, eng, stmt, order_note: str | None = None):
        self.eng, self.stmt = eng, stmt
        # the cost planner's join-order decision (sql/costplan.py):
        # non-None when catalog cardinalities reordered the joins
        self.order_note = order_note

    def decisions(self):
        out = [("join", "host")]
        out.append(("join_order",
                    "catalog" if self.order_note else "static"))
        return out

    def lines(self):
        out = []
        if self.order_note:
            out.append(f"join order ({self.order_note})")
        for j in self.stmt.joins:
            src = j.table if j.subquery is None else "(subquery)"
            if j.left is None:  # comma join: condition lives in WHERE
                out.append(
                    f"comma join {self.stmt.table} x {src} "
                    "(WHERE-equality hashed, else cross product)")
                continue
            kind = "left outer" if j.outer else "inner"
            out.append(
                f"nested-loop {kind} join {self.stmt.table} x "
                f"{src} on {j.left.name} = {j.right.name} "
                "(hashed right side)")
        return out

    def run(self):
        return self.eng.select.select_join(self.stmt)


class _FilteredOp(PlanOp):
    """Base for ops that compile the WHERE pushdown at run time."""

    def __init__(self, eng, stmt, idx, items):
        self.eng, self.stmt, self.idx, self.items = eng, stmt, idx, items

    def _filt(self):
        return self.eng.wherec.compile_where(self.idx, self.stmt.where)


class PQLGroupByOp(_FilteredOp):
    def __init__(self, eng, stmt, idx, items, generic: bool):
        super().__init__(eng, stmt, idx, items)
        self.generic = generic

    def lines(self):
        out = _filter_lines(self.eng, self.idx, self.stmt.where)
        if self.generic:
            out.append("generic hashed GROUP BY (BSI group column)")
        else:
            out.append(
                "PQL GroupBy pushdown (stacked device program): "
                + ", ".join(f"Rows({g})" for g in self.stmt.group_by))
        return out

    def run(self):
        sel = self.eng.select
        fn = sel.select_grouped_generic if self.generic \
            else sel.select_grouped
        return fn(self.idx, self.stmt, self.items, self._filt())

    def decisions(self):
        return [("groupby", "host" if self.generic else "pushdown")]


class PQLAggregateOp(_FilteredOp):
    def decisions(self):
        sel = self.eng.select
        out = []
        for it in self.items:
            e = it.expr
            if isinstance(e, ast.Agg):
                out.append((f"agg_{e.func}",
                            "pushdown" if sel._agg_pushable(self.idx, e)
                            else "host"))
            else:
                out.append(("agg_expr", "host"))
        return out

    def lines(self):
        out = _filter_lines(self.eng, self.idx, self.stmt.where)
        for it in self.items:
            a = it.expr
            inner = a.arg.name if a.arg else "*"
            out.append(f"aggregate pushdown: {a.func}({inner})")
        return out

    def run(self):
        return self.eng.select.select_aggregates(
            self.idx, self.stmt, self.items, self._filt())


class DistinctScanOp(_FilteredOp):
    def lines(self):
        out = _filter_lines(self.eng, self.idx, self.stmt.where)
        name = self.items[0].expr.name
        f = self.idx.field(name)
        if f is not None and f.options.type.is_bsi:
            out.append(f"PQL Distinct scan: {name} "
                       "(fused bsi_value_hist single-pass)")
        else:
            out.append(f"PQL Distinct scan: {name}")
        return out

    def decisions(self):
        return [("distinct", "pushdown")]

    def run(self):
        return self.eng.select.select_distinct(
            self.idx, self.stmt, self.items[0], self._filt())


class ExtractScanOp(_FilteredOp):
    def lines(self):
        stmt, idx = self.stmt, self.idx
        out = _filter_lines(self.eng, idx, stmt.where)
        ob = stmt.order_by[0] if len(stmt.order_by) == 1 else None
        if ob is not None and isinstance(ob.expr, ast.Col) and \
                ob.expr.name != "_id" and \
                idx.field(ob.expr.name) is not None and \
                self.eng._field(idx, ob.expr.name).options.type.is_bsi:
            d = " desc" if ob.desc else ""
            out.append(f"Sort pushdown (device BSI sort): "
                       f"{ob.expr.name}{d}, NULLS LAST")
        elif stmt.order_by:
            out.append("host sort")
        if stmt.limit is not None:
            out.append(f"limit {stmt.limit}"
                       + (f" offset {stmt.offset}" if stmt.offset
                          else ""))
        out.append("Extract scan (device row materialization)")
        return out

    def decisions(self):
        out = [("extract", "pushdown")]
        stmt, idx = self.stmt, self.idx
        if stmt.order_by:
            ob = stmt.order_by[0] if len(stmt.order_by) == 1 else None
            bsi_sort = (ob is not None and isinstance(ob.expr, ast.Col)
                        and ob.expr.name != "_id"
                        and idx.field(ob.expr.name) is not None
                        and idx.field(ob.expr.name)
                        .options.type.is_bsi)
            out.append(("sort", "pushdown" if bsi_sort else "host"))
        if stmt.distinct:
            out.append(("distinct", "host"))
        return out

    def run(self):
        return self.eng.select.select_rows(
            self.idx, self.stmt, self.items, self._filt())


def _rewrite_alias(e, alias: str, table: str):
    """Replace Col qualifiers naming the FROM alias with the real
    table, without descending into subqueries (they resolve their own
    aliases when planned)."""
    if isinstance(e, ast.Col):
        if e.table == alias:
            e.table = table
        return
    if e is None or isinstance(e, (ast.Lit, ast.Var, ast.SubQuery)):
        return
    if isinstance(e, ast.Func):
        for x in e.args:
            _rewrite_alias(x, alias, table)
        return
    if isinstance(e, ast.InSelect):
        _rewrite_alias(e.col, alias, table)
        return
    for attr in ("left", "right", "expr", "col", "arg", "lo", "hi",
                 "extra"):
        sub = getattr(e, attr, None)
        if sub is not None and not isinstance(sub, (str, int, float,
                                                    bool)):
            _rewrite_alias(sub, alias, table)


def _normalize_alias(stmt: ast.Select):
    """FROM t AS x on a single-table select: fold x.col -> t.col so
    downstream validation and compilation see real table names."""
    a, t = stmt.table_alias, stmt.table
    for it in stmt.items:
        _rewrite_alias(it.expr, a, t)
    _rewrite_alias(stmt.where, a, t)
    _rewrite_alias(stmt.having, a, t)
    for ob in stmt.order_by:
        _rewrite_alias(ob.expr, a, t)
    stmt.group_by = [g[len(a) + 1:] if g.startswith(a + ".") else g
                     for g in stmt.group_by]


def plan_select(eng, stmt: ast.Select) -> PlanOp:
    """The single SELECT dispatch decision (executes nothing)."""
    from pilosa_tpu_torch.sql.typecheck import check_select
    if stmt.from_select is not None:
        return DerivedTableOp(eng, stmt)
    if not stmt.table:
        check_select(eng, None, stmt, stmt.items)
        return ConstProjectOp(eng, stmt)
    if stmt.table in eng._views:
        return ViewExpandOp(eng, stmt)
    idx = eng._index(stmt.table)
    if stmt.group_by:
        for it in stmt.items:
            a = it.expr
            if isinstance(a, ast.Agg) and a.func in (
                    "min", "max", "percentile", "var", "corr"):
                # defs_groupby.go analysis errors — applies to joined
                # selects too
                raise SQLError(f"aggregate '{a.func.upper()}()' "
                               "not allowed in GROUP BY")
    if stmt.joins:
        # cost-based join order (sql/costplan.py): catalog
        # cardinalities reorder safe star-shaped inner joins so the
        # smallest hash sides build first; cold catalog / unsafe
        # shapes keep the written order (the static plan)
        from pilosa_tpu_torch.sql import costplan
        note = costplan.order_joins(eng, stmt)
        return NestedLoopJoinOp(eng, stmt, order_note=note)
    if stmt.table_alias:
        _normalize_alias(stmt)
    eng.select.reject_foreign_quals(stmt)
    # single-table GROUP BY entries may still carry the table
    # qualifier (group by t.col)
    stmt.group_by = [g[len(stmt.table) + 1:]
                     if g.startswith(stmt.table + ".") else g
                     for g in stmt.group_by]
    check_select(eng, idx, stmt, stmt.items)

    # expand * into _id + all columns
    items: list[ast.SelectItem] = []
    for it in stmt.items:
        if isinstance(it.expr, ast.Col) and it.expr.name == "*":
            items.append(ast.SelectItem(ast.Col("_id"), "_id"))
            items += [ast.SelectItem(ast.Col(f.name), f.name)
                      for f in _declared_fields(idx)]
        else:
            items.append(it)

    if stmt.having is not None and not stmt.group_by:
        raise SQLError("HAVING requires GROUP BY")
    agg_items = [it for it in items if _contains_agg(it.expr)]
    if stmt.group_by:
        return PQLGroupByOp(eng, stmt, idx, items,
                            _needs_generic_group(eng, idx, stmt,
                                                 items))
    if agg_items:
        if len(agg_items) != len(items):
            raise SQLError(
                "mixing aggregates and columns requires GROUP BY")
        return PQLAggregateOp(eng, stmt, idx, items)
    for fcol in stmt.flatten:
        eng._field(idx, fcol)  # column 'foo' not found
    if stmt.distinct and len(items) == 1 and \
            isinstance(items[0].expr, ast.Col) and \
            items[0].expr.name != "_id" and \
            (items[0].expr.name in stmt.flatten or
             not _is_setlike(eng, idx, items[0].expr.name)):
        return DistinctScanOp(eng, stmt, idx, items)
    return ExtractScanOp(eng, stmt, idx, items)


def _contains_agg(e) -> bool:
    if isinstance(e, ast.Agg):
        return True
    if isinstance(e, ast.BinOp):
        return _contains_agg(e.left) or _contains_agg(e.right)
    if isinstance(e, ast.Not):
        return _contains_agg(e.expr)
    if isinstance(e, ast.Func):
        return any(_contains_agg(x) for x in e.args)
    return False


def _is_setlike(eng, idx, name: str) -> bool:
    """SET/TIME columns hold multi-value cells: SQL DISTINCT and
    GROUP BY treat the FULL set as the value (defs_groupby
    groupBySetDistinctTests), so they cannot ride the member-wise
    PQL Distinct/GroupBy pushdowns."""
    from pilosa_tpu_torch.models import FieldType
    f = idx.field(name)
    return f is not None and f.options.type in (FieldType.SET,
                                                FieldType.TIME)


def _needs_generic_group(eng, idx, stmt, items) -> bool:
    """PQL GroupBy pushdown serves single-valued group columns
    (mutex/bool) with count(*)/sum/avg aggregates; BSI group columns
    (hashed groups), set-like group columns (full-set keys), and
    other aggregate shapes take the generic hashed path (sql3's
    non-pushdown PlanOpGroupBy)."""
    from pilosa_tpu_torch.models import FieldType
    for g in stmt.group_by:
        f = eng._field(idx, g)
        if f.options.type in (FieldType.SET, FieldType.TIME) and \
                g in stmt.flatten:
            continue  # flattened sets group member-wise (pushdown)
        if f.options.type not in (FieldType.MUTEX, FieldType.BOOL):
            return True
    for it in items:
        e = it.expr
        if isinstance(e, ast.Agg):
            if e.func == "count" and e.arg is None:
                continue
            if e.func in ("sum", "avg") and \
                    isinstance(e.arg, ast.Col) and \
                    e.arg.name != "_id":
                continue
            return True
    return False


def explain(eng, stmt) -> SQLResult:
    """EXPLAIN: the plan ops as rows, without executing (sql3
    parseExplain + PlanOperator.Plan())."""
    if isinstance(stmt, ast.Select):
        rows = [(line,) for line in plan_select(eng, stmt).lines()]
    else:
        rows = [(type(stmt).__name__.lower(),)]
    return SQLResult(schema=[("plan", "string")], rows=rows)
