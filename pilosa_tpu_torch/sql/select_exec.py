"""SELECT execution strategies: each method here is the `run` body of
one plan operator (sql/plan.py) — aggregates, GROUP BY
(PQL pushdown + generic hashed), DISTINCT scan, row extraction with
sort/limit pushdown, nested-loop JOIN, views, and constant selects.

Split out of engine.py.  The strategy split mirrors
sql3/planner's operator set (PlanOpPQLAggregate / PlanOpPQLGroupBy /
PlanOpPQLDistinctScan / PlanOpPQLTableScan / opnestedloops.go) with
the fan-out collapsed into the stacked device executor.
"""

from __future__ import annotations

import re

from pilosa_tpu_torch.executor.results import DistinctValues
from pilosa_tpu_torch.models import FieldType
from pilosa_tpu_torch.pql.ast import Call, Condition
from pilosa_tpu_torch.sql import ast
from pilosa_tpu_torch.sql.common import (
    SQLResult,
    declared_fields,
    distinct_key,
    is_ordinal,
    limit_rows,
    name_of,
    order_rows,
    ordinal_index,
    sorted_nulls_last,
    sql_type_of,
    to_env_value,
    to_sql_value,
)
from pilosa_tpu_torch.sql.lexer import SQLError
from pilosa_tpu_torch.sql.wherec import has_filter


class SelectExec:
    """SELECT strategy bodies bound to one SQLEngine."""

    def __init__(self, engine):
        self.eng = engine

    # -- validation -----------------------------------------------------

    def reject_foreign_quals(self, stmt: ast.Select):
        """Non-join selects must not reference other tables: a bogus
        qualifier would otherwise silently resolve to the bare
        name."""
        def walk(e):
            if isinstance(e, ast.Col):
                if e.table is not None and e.table != stmt.table:
                    raise SQLError(f"unknown table {e.table!r}")
                return
            if e is None or isinstance(e, (str, int, float, bool)):
                return
            for attr in ("left", "right", "expr", "col", "arg"):
                sub = getattr(e, attr, None)
                if sub is not None:
                    walk(sub)
        for it in stmt.items:
            walk(it.expr)
        walk(stmt.where)
        walk(stmt.having)
        for ob in stmt.order_by:
            walk(ob.expr)

    # -- type resolution ------------------------------------------------

    def expr_type(self, idx, e) -> str:
        """Result SQL type of a scalar expression (the reference sets
        ResultDataType during analysis,
        expressionanalyzercall.go)."""
        from pilosa_tpu_torch.sql.funcs import FUNC_TYPES
        eng = self.eng
        if isinstance(e, ast.Lit):
            v = e.value
            if isinstance(v, bool):
                return "bool"
            if isinstance(v, int):
                return "int"
            if v is None or isinstance(v, str):
                return "string"
            return "decimal"
        if isinstance(e, ast.Col):
            if e.name == "_id":
                return "string" if idx.keys else "id"
            return sql_type_of(eng._field(idx, e.name))
        if isinstance(e, ast.Func):
            if e.name == "CAST" and len(e.args) == 3 and \
                    isinstance(e.args[1], ast.Lit):
                return e.args[1].value
            if e.name in eng._udf_types():
                return eng._udf_types()[e.name]
            return FUNC_TYPES.get(e.name, "string")
        if isinstance(e, ast.BinOp):
            if e.op == "||":
                return "string"
            if e.op in ("+", "-", "*", "/", "%"):
                lt = self.expr_type(idx, e.left)
                rt = self.expr_type(idx, e.right)
                return "decimal" if "decimal" in (lt, rt) else "int"
            return "bool"
        return "bool"  # Not/IsNull/InList/Between

    def agg_type(self, idx, a: ast.Agg) -> str:
        if a.func == "count":
            return "int"
        if a.func in ("avg", "var", "corr"):
            return "decimal"
        if isinstance(a.arg, ast.Col):
            if a.arg.name == "_id":
                return "id"
            f = self.eng._field(idx, a.arg.name)
            return sql_type_of(f)
        return self.expr_type(idx, a.arg) if a.arg is not None \
            else "int"

    # -- aggregates -----------------------------------------------------

    def select_aggregates(self, idx, stmt, items, filt) -> SQLResult:
        """Aggregate projections — plain aggregates AND aggregate
        expressions (COUNT(*) + 10, defs_aggregate countTests): the
        contained aggregates evaluate first, then the scalar
        expression folds over their values."""
        row_vals, schema = [], []
        for it in items:
            e = it.expr
            if isinstance(e, ast.Agg):
                schema.append((name_of(it), self.agg_type(idx, e)))
                row_vals.append(to_sql_value(
                    self.eval_agg(idx, e, filt)))
                continue
            folded = self._fold_agg_values(idx, e, filt)
            from pilosa_tpu_torch.sql.funcs import Evaluator
            ev = Evaluator(udfs=self.eng._udf_callables())
            row_vals.append(to_sql_value(ev.eval(folded, {})))
            schema.append((name_of(it), self.expr_type(idx, folded)))
        return SQLResult(schema=schema, rows=[tuple(row_vals)])

    def _fold_agg_values(self, idx, e, filt):
        """Deep-copy an expression with every Agg node replaced by its
        evaluated literal."""
        if isinstance(e, ast.Agg):
            return ast.Lit(self.eval_agg(idx, e, filt))
        if isinstance(e, ast.BinOp):
            return ast.BinOp(e.op, self._fold_agg_values(idx, e.left,
                                                         filt),
                             self._fold_agg_values(idx, e.right, filt))
        if isinstance(e, ast.Not):
            return ast.Not(self._fold_agg_values(idx, e.expr, filt))
        if isinstance(e, ast.Func):
            return ast.Func(e.name, [self._fold_agg_values(idx, x, filt)
                                     for x in e.args])
        return e

    @staticmethod
    def _avg_quantize(total, n):
        """AVG returns a scale-4 decimal (defs_aggregate avgTests:
        avg(i1) -> 11.3333)."""
        from decimal import ROUND_HALF_EVEN, Decimal
        if n == 0:
            return None
        t = total if isinstance(total, Decimal) else Decimal(total)
        return (t / n).quantize(Decimal("0.0001"),
                                rounding=ROUND_HALF_EVEN)

    def _agg_reduce(self, a: ast.Agg, vals):
        """Reduce already-evaluated NON-NULL values for one
        count/sum/avg/min/max aggregate — the single implementation
        behind grouped, HAVING, and derived-table aggregation."""
        if a.func == "count":
            if a.distinct:
                return len({tuple(sorted(map(str, v)))
                            if isinstance(v, list) else v
                            for v in vals})
            return len(vals)
        if not vals:
            return None
        if a.func == "sum":
            return sum(vals)
        if a.func == "avg":
            return self._avg_quantize(sum(vals), len(vals))
        if a.func == "min":
            return min(vals)
        if a.func == "max":
            return max(vals)
        raise SQLError(f"unsupported aggregate {a.func}")

    def _agg_pushable(self, idx, a: ast.Agg) -> bool:
        """True when the aggregate rides a single PQL call: plain
        column args on matching field types.  Everything else — agg
        over an expression, sum/avg/min/max on non-BSI fields, string
        min/max — aggregates host-side over an Extract."""
        if a.func == "count" and a.arg is None:
            return True
        if a.func in ("var", "corr"):
            return True  # eval_var_corr takes arbitrary expressions
        if not isinstance(a.arg, ast.Col):
            return False
        name = a.arg.name
        if name == "_id":
            return a.func == "count" and not a.distinct
        f = idx.field(name)
        if f is None:
            raise SQLError(f"column not found: {name}")
        if a.func == "count":
            return True
        if a.func in ("sum", "min", "max", "avg", "percentile"):
            return f.options.type.is_bsi
        return a.func in ("var", "corr")

    def eval_agg(self, idx, a: ast.Agg, filt: Call):
        eng = self.eng
        hasf = has_filter(filt)
        fchildren = [filt] if hasf else []
        if not self._agg_pushable(idx, a):
            return self._agg_generic(idx, a, filt)
        if a.func == "count" and (
                a.arg is None or (isinstance(a.arg, ast.Col)
                                  and a.arg.name == "_id")):
            # COUNT(_id) counts records — _id is never NULL
            # (defs_aggregate countTests_2)
            return eng.run_call(idx, Call(
                "Count", children=[filt]))
        if a.func == "count" and a.distinct:
            res = eng.run_call(idx, Call(
                "Distinct", args={"_field": a.arg.name},
                children=fchildren))
            return len(res.values) if isinstance(res, DistinctValues) \
                else res.count()
        if a.func == "count":
            # non-null count of the column
            f = eng._field(idx, a.arg.name)
            if f.options.type.is_bsi:
                nn = Call("Row",
                          args={a.arg.name: Condition("!=", None)})
            else:
                nn = Call("UnionRows", children=[
                    Call("Rows", args={"_field": a.arg.name})])
            tree = Call("Intersect", children=[filt, nn]) if hasf else nn
            return eng.run_call(idx, Call("Count",
                                          children=[tree]))
        if a.func in ("sum", "min", "max", "avg"):
            call_name = {"sum": "Sum", "min": "Min", "max": "Max",
                         "avg": "Sum"}[a.func]
            res = eng.run_call(idx, Call(
                call_name, args={"_field": a.arg.name},
                children=fchildren))
            if a.func == "avg":
                return self._avg_quantize(res.value, res.count)
            return res.value
        if a.func == "percentile":
            args = {"_field": a.arg.name, "nth": a.extra}
            if hasf:
                args["filter"] = filt
            res = eng.run_call(idx, Call("Percentile",
                                         args=args))
            return res.value if res is not None else None
        if a.func in ("var", "corr"):
            return self.eval_var_corr(idx, a, filt)
        raise SQLError(f"unsupported aggregate {a.func}")

    def _agg_generic(self, idx, a: ast.Agg, filt: Call):
        """Host-side aggregation over an Extract: aggregates on
        expressions (sum(d1 + 5), avg(len(s1))), literals (sum(1)),
        and non-BSI columns (min(s1) lexicographic, avg(id1))."""
        from pilosa_tpu_torch.sql.funcs import Evaluator, columns_in
        eng = self.eng
        if a.arg is None:
            raise SQLError(f"{a.func}: column reference expected")
        cols = sorted(n for n in columns_in(a.arg) if n != "_id")
        for n in cols:
            eng._field(idx, n)
        c = Call("Extract", children=[filt] + [
            Call("Rows", args={"_field": n}) for n in cols])
        table = eng.run_call(idx, c)
        ev = Evaluator(udfs=eng._udf_callables())
        vals = []
        for entry in table.columns:
            env = {n: to_env_value(entry["rows"][i])
                   for i, n in enumerate(cols)}
            env["_id"] = entry.get("column_key", entry["column"])
            v = ev.eval(a.arg, env)
            if v is not None:
                vals.append(v)
        if a.func == "count":
            if a.distinct:
                return len({repr(tuple(sorted(v))
                                 if isinstance(v, list) else v)
                            for v in vals})
            return len(vals)
        if a.func in ("min", "max"):
            # sets are not min/max-able; strings compare
            # lexicographically (defs_aggregate minmaxTests_4)
            vals = [v for v in vals if not isinstance(v, list)]
            if not vals:
                return None
            return min(vals) if a.func == "min" else max(vals)
        nums = [v for v in vals
                if isinstance(v, (int, float)) or
                type(v).__name__ == "Decimal"]
        if a.func == "sum":
            return sum(nums) if nums else None
        if a.func == "avg":
            return self._avg_quantize(sum(nums), len(nums)) \
                if nums else None
        raise SQLError(f"unsupported aggregate {a.func}")

    def eval_var_corr(self, idx, a: ast.Agg, filt: Call):
        """VAR(x): population variance; CORR(x, y): Pearson
        correlation — both buffer the matching values like the
        reference's aggregateVar/aggregateCorr (expressionagg.go:949,
        1197) and return decimals at scale 6.  Args may be arbitrary
        numeric expressions (var(len(s1)), defs_aggregate
        varTests_6)."""
        from decimal import Decimal

        from pilosa_tpu_torch.sql.funcs import Evaluator, columns_in
        eng = self.eng
        if a.arg is None:
            raise SQLError(f"{a.func} requires a column argument")
        exprs = [a.arg]
        if a.func == "corr":
            exprs.append(a.extra)
        ref_cols = sorted({n for e in exprs for n in columns_in(e)
                           if n != "_id"})
        for n in ref_cols:
            eng._field(idx, n)
        c = Call("Extract", children=[filt] + [
            Call("Rows", args={"_field": n}) for n in ref_cols])
        table = eng.run_call(idx, c)
        ev = Evaluator(udfs=eng._udf_callables())
        cols = [[], []]
        for entry in table.columns:
            env = {n: to_env_value(entry["rows"][i])
                   for i, n in enumerate(ref_cols)}
            env["_id"] = entry.get("column_key", entry["column"])
            vals = [ev.eval(e, env) for e in exprs]
            if any(v is None for v in vals):
                continue  # reference skips nil rows
            for i, v in enumerate(vals):
                if isinstance(v, bool) or not isinstance(
                        v, (int, float, Decimal)):
                    raise SQLError(
                        f"{a.func} requires a numeric column")
                cols[i].append(float(v))
        def dec6(v: float) -> Decimal:
            # pql.FromFloat64WithScale: int64(v * 10^6) TRUNCATES
            # toward zero (var(id1) -> 2.916666, not .916667)
            return Decimal(int(v * 10**6)).scaleb(-6)

        xs = cols[0]
        n = len(xs)
        if n == 0:
            return None
        if a.func == "var":
            # same accumulation order as aggregateVar.Eval
            mean = sum(xs) / n
            var = 0.0
            for v in xs:
                var += (v - mean) * (v - mean)
            return dec6(var / n)
        ys = cols[1]
        sx, sy = sum(xs), sum(ys)
        sxy = sum(x * y for x, y in zip(xs, ys))
        sxx, syy = sum(x * x for x in xs), sum(y * y for y in ys)
        # aggregateCorr.Eval's exact expression shape: one sqrt over
        # the product; clamp slightly-negative variance terms so the
        # sqrt stays real (float noise on near-constant data)
        prod = max((n * sxx - sx * sx) * (n * syy - sy * sy), 0.0)
        denom = prod ** 0.5
        if denom == 0:
            return None
        return dec6((n * sxy - sx * sy) / denom)

    # -- GROUP BY -------------------------------------------------------

    def select_grouped(self, idx, stmt, items, filt) -> SQLResult:
        eng = self.eng
        group_cols = stmt.group_by
        # validate items: group cols or aggregates
        schema, getters = [], []
        sum_field = None
        for it in items:
            e = it.expr
            if isinstance(e, ast.Col):
                if e.name not in group_cols:
                    raise SQLError(
                        f"column {e.name} must appear in GROUP BY")
                gi = group_cols.index(e.name)
                f = eng._field(idx, e.name)
                schema.append((name_of(it),
                               "string" if f.options.keys else "id"))
                getters.append(("group", gi))
            elif isinstance(e, ast.Agg):
                if e.func == "count" and e.arg is None:
                    schema.append((name_of(it), "int"))
                    getters.append(("count", None))
                elif e.func in ("sum", "avg"):
                    if sum_field is None:
                        sum_field = e.arg.name
                    elif sum_field != e.arg.name:
                        raise SQLError(
                            "only one SUM column per grouped query")
                    schema.append((name_of(it), self.agg_type(idx, e)))
                    getters.append((e.func, None))
                else:
                    raise SQLError(
                        f"aggregate {e.func} not supported with "
                        "GROUP BY")
            else:
                raise SQLError("invalid GROUP BY projection")
        args = {}
        if has_filter(filt):
            args["filter"] = filt
        if sum_field is not None:
            args["aggregate"] = Call("Sum", args={"_field": sum_field})
        having = stmt.having
        if having is not None:
            args["having"] = self.compile_having(having)
        call = Call("GroupBy", args=args, children=[
            Call("Rows", args={"_field": g}) for g in group_cols])
        groups = eng.run_call(idx, call)
        rows = []
        for g in groups:
            if sum_field is not None and not g.agg_count:
                # a SUM/AVG aggregate drops groups with no aggregate
                # rows (defs_groupby groupByTests_6; executor.go
                # GroupBy aggregate filtering)
                continue
            vals = []
            for kind, gi in getters:
                if kind == "group":
                    ge = g.group[gi]
                    gv = ge.get("row_key", ge["row_id"])
                    gf = eng._field(idx, group_cols[gi])
                    if gf.options.type in (FieldType.SET,
                                           FieldType.TIME):
                        # member-wise (flattened) set group keys
                        # project as single-member sets
                        gv = [gv]
                    vals.append(gv)
                elif kind == "count":
                    vals.append(g.count)
                elif kind == "sum":
                    vals.append(g.agg)
                elif kind == "avg":
                    vals.append(self._avg_quantize(g.agg, g.agg_count))
            rows.append(tuple(vals))
        rows = order_rows(stmt, schema, rows,
                          self._group_srcmap(stmt, items))
        rows = limit_rows(stmt, rows)
        return SQLResult(schema=schema, rows=rows)

    @staticmethod
    def _group_srcmap(stmt, items) -> dict:
        """source column name -> projection index for aliased group
        columns (ORDER BY i1 when projected as `i1 AS c`)."""
        out = {}
        for i, it in enumerate(items):
            if isinstance(it.expr, ast.Col) and it.alias and \
                    it.alias != it.expr.name:
                out.setdefault(it.expr.name, i)
        return out

    def select_grouped_generic(self, idx, stmt, items,
                               filt) -> SQLResult:
        """Hashed GROUP BY over materialized record values — the
        fallback when a group column is BSI (sql3 planner's generic
        PlanOpGroupBy instead of the PQL GroupBy pushdown)."""
        eng = self.eng
        group_cols = stmt.group_by
        # bulk column maps through the executor, bounded by the WHERE
        # filter: one Extract per referenced column, so the path also
        # serves the DAX queryer (schema-only holder, cells on the
        # compute workers)
        cells = self.cell_reader(idx, filt)
        schema, getters = [], []
        agg_specs = []  # (func, col or None)
        for it in items:
            e = it.expr
            if isinstance(e, ast.Col):
                if e.name not in group_cols:
                    raise SQLError(
                        f"column {e.name} must appear in GROUP BY")
                f = eng._field(idx, e.name)
                schema.append((name_of(it), sql_type_of(f)))
                getters.append(("group", group_cols.index(e.name)))
            elif isinstance(e, ast.Agg):
                if e.func == "count" and e.arg is None:
                    schema.append((name_of(it), "int"))
                    getters.append(("agg", len(agg_specs)))
                    agg_specs.append(("count*", None, False))
                elif e.func in ("count", "sum", "avg"):
                    if not isinstance(e.arg, ast.Col):
                        raise SQLError(
                            "GROUP BY aggregates take a column "
                            "reference")
                    schema.append((name_of(it), self.agg_type(idx, e)))
                    getters.append(("agg", len(agg_specs)))
                    agg_specs.append((e.func, e.arg.name, e.distinct))
                else:
                    raise SQLError(
                        f"aggregate '{e.func.upper()}()' not allowed "
                        "in GROUP BY")
            else:
                raise SQLError("invalid GROUP BY projection")

        groups: dict[tuple, list] = {}
        for rid in self.table_ids(idx, filt):
            key = tuple(self.group_key(idx, g, rid, cells=cells)
                        for g in group_cols)
            if any(k is None for k in key):
                # records NULL in a group column form no group
                # (defs_sql1 grouper: the NULL-color row is absent
                # from `group by age, color`; matches the PQL
                # GroupBy's member-based semantics)
                continue
            groups.setdefault(key, []).append(rid)

        rows = []
        for key, rids in groups.items():
            agg_vals = []
            for func, col, distinct in agg_specs:
                if func == "count*":
                    agg_vals.append(len(rids))
                    continue
                vals = [cells.get(col, r) for r in rids]
                vals = [v for v in vals if v is not None]
                agg_vals.append(self._agg_reduce(
                    ast.Agg(func, ast.Col(col), distinct=distinct),
                    vals))
            if stmt.having is not None:
                cache = {spec: agg_vals[i]
                         for i, spec in enumerate(agg_specs)}
                if not self.generic_having_ok(idx, stmt.having, rids,
                                              cache, cells=cells):
                    continue
            if agg_specs and all(
                    func in ("sum", "avg")
                    for func, _c, _d in agg_specs) and all(
                    v is None for v in agg_vals):
                # a group whose ONLY aggregates are SUM/AVG with no
                # rows is dropped (defs_groupby groupByTests_6); any
                # count aggregate keeps it (groupByTests_8 keeps
                # (0, None) groups)
                continue
            out = []
            for kind, i in getters:
                if kind == "group":
                    # set group keys canonicalized to tuples for
                    # hashing; project back as lists
                    out.append(list(key[i])
                               if isinstance(key[i], tuple)
                               else key[i])
                else:
                    out.append(agg_vals[i])
            rows.append(tuple(out))
        rows = order_rows(stmt, schema, rows,
                          self._group_srcmap(stmt, items))
        rows = limit_rows(stmt, rows)
        return SQLResult(schema=schema, rows=rows)

    def group_key(self, idx, col: str, rid: int, cells=None):
        v = cells.get(col, rid) if cells is not None \
            else self.cell_value(idx, col, rid)
        if isinstance(v, list):
            return tuple(sorted(v))
        if v is not None and col != "_id":
            f = idx.field(col)
            if f is not None and f.options.type in (FieldType.SET,
                                                    FieldType.TIME):
                # single-member sets decode as scalars; group keys
                # stay sets (defs_groupby: ['b'] is a group of its
                # own, not scalar 'b')
                return (v,)
        return v

    def _group_agg_value(self, idx, a: ast.Agg, rids, cache=None,
                         cells=None):
        """One aggregate over a group's record ids (HAVING — the
        aggregate need not appear in the projection, defs_having);
        projected aggregates come from the caller's cache instead of
        re-reading every record's cells."""
        if a.func == "count" and a.arg is None:
            return len(rids)
        if not isinstance(a.arg, ast.Col):
            raise SQLError(
                "HAVING aggregates take a column reference")
        if cache is not None:
            key = (a.func, a.arg.name, a.distinct)
            if key in cache:
                return cache[key]
        if cells is not None:
            vals = [cells.get(a.arg.name, r) for r in rids]
        else:
            vals = [self.cell_value(idx, a.arg.name, r)
                    for r in rids]
        vals = [v for v in vals if v is not None]
        return self._agg_reduce(a, vals)

    def generic_having_ok(self, idx, having, rids,
                          cache=None, cells=None) -> bool:
        """Evaluate a HAVING expression for one group: aggregates
        compute over the group (projected or not), with comparisons,
        BETWEEN, and AND/OR/NOT (defs_having, defs_sql1
        `having count(*) between 1 and 3`)."""
        import operator
        ops = {"=": operator.eq, "!=": operator.ne, "<": operator.lt,
               "<=": operator.le, ">": operator.gt,
               ">=": operator.ge}

        def ev(e):
            if isinstance(e, ast.Agg):
                return self._group_agg_value(idx, e, rids, cache,
                                             cells=cells)
            if isinstance(e, ast.Lit):
                return e.value
            if isinstance(e, ast.Not):
                v = ev(e.expr)
                return None if v is None else not v
            if isinstance(e, ast.Between):
                v, lo, hi = ev(e.col), ev(e.lo), ev(e.hi)
                if None in (v, lo, hi):
                    return None
                hit = lo <= v <= hi
                return (not hit) if e.negated else hit
            if isinstance(e, ast.BinOp):
                if e.op in ("and", "or"):
                    l, r = ev(e.left), ev(e.right)
                    if e.op == "and":
                        return bool(l) and bool(r)
                    return bool(l) or bool(r)
                l, r = ev(e.left), ev(e.right)
                if l is None or r is None:
                    return None
                if e.op not in ops:
                    raise SQLError(
                        f"HAVING operator {e.op!r} unsupported")
                return ops[e.op](l, r)
            raise SQLError(
                "HAVING supports aggregate comparisons")
        v = ev(having)
        return v is not None and bool(v)

    def compile_having(self, having) -> Call:
        # HAVING COUNT(*) > n / SUM(col) > n → Condition(count/sum OP n)
        if isinstance(having, ast.BinOp) and \
                isinstance(having.left, ast.Agg):
            a = having.left
            key = "count" if a.func == "count" else "sum"
            if not isinstance(having.right, ast.Lit):
                raise SQLError("HAVING requires a literal bound")
            op = {"=": "=="}.get(having.op, having.op)
            return Call("Condition",
                        args={key: Condition(op, having.right.value)})
        raise SQLError("HAVING supports COUNT(*)/SUM(col) comparisons")

    # -- DISTINCT scan --------------------------------------------------

    def select_distinct(self, idx, stmt, item, filt) -> SQLResult:
        eng = self.eng
        name = item.expr.name
        f = eng._field(idx, name)
        res = eng.run_call(idx, Call(
            "Distinct", args={"_field": name},
            children=[filt] if has_filter(filt) else []))
        if isinstance(res, DistinctValues):
            values = res.values
        else:
            values = res.columns().tolist()
            if f.options.keys:
                values = f.row_translator.translate_ids(values)
            elif f.options.type == FieldType.BOOL:
                # bool rows are row-ids 0/1; project as real bools
                # (defs_distinct distinctTests_2)
                values = [bool(v) for v in values]
        if name in stmt.flatten and f.options.type in (
                FieldType.SET, FieldType.TIME):
            # flattened distinct members stay single-member SETS
            # (defs_groupby groupBySetDistinctTests_4: [1], [2], ...)
            rows = [([to_sql_value(v)],) for v in values]
        else:
            rows = [(to_sql_value(v),) for v in values]
        schema = [(name_of(item), sql_type_of(f))]
        rows = order_rows(stmt, schema, rows)
        rows = limit_rows(stmt, rows)
        return SQLResult(schema=schema, rows=rows)

    # -- row extraction -------------------------------------------------

    def select_rows(self, idx, stmt, items, filt) -> SQLResult:
        from pilosa_tpu_torch.sql.funcs import Evaluator, columns_in
        eng = self.eng
        wc = eng.wherec
        items = [ast.SelectItem(wc.fold_subqueries(it.expr), it.alias)
                 for it in items]
        # classify projections: plain columns ride the Extract
        # directly; scalar expressions evaluate row-wise over it
        plans = []   # ("id",) | ("col", name) | ("expr", e)
        ref_cols: set[str] = set()
        for it in items:
            e = it.expr
            if isinstance(e, ast.Col):
                if e.name == "_id":
                    plans.append(("id",))
                else:
                    eng._field(idx, e.name)
                    ref_cols.add(e.name)
                    plans.append(("col", e.name))
            else:
                for n in columns_in(e):
                    if n != "_id":
                        eng._field(idx, n)
                        ref_cols.add(n)
                plans.append(("expr", e))
        non_id = sorted(ref_cols)
        names = [name_of(it) for it in items]
        order_col = None
        order_expr = None  # non-column ORDER BY key (host-evaluated)
        multi_order = stmt.order_by and len(stmt.order_by) > 1
        if multi_order:
            # multi-key: materialize unordered, then host-sort with
            # every key.  Keys need not be projected (defs_orderby's
            # `order by foo asc, a_decimal asc`): unprojected sort
            # columns ride the Extract, and exprs/ordinals/aliases
            # evaluate per row.  LIMIT stays host-side (after sort).
            for ob in stmt.order_by:
                e = ob.expr
                if isinstance(e, ast.Col) and e.name != "_id" and \
                        idx.field(e.name) is not None:
                    ref_cols.add(e.name)
                elif not isinstance(e, (ast.Col, ast.Lit)):
                    for n2 in columns_in(wc.fold_subqueries(e)):
                        if n2 != "_id":
                            eng._field(idx, n2)
                            ref_cols.add(n2)
            non_id = sorted(ref_cols)
        order_ordinal = None  # ORDER BY <n> (1-based projection index)
        if not multi_order and stmt.order_by:
            ob = stmt.order_by[0]
            if isinstance(ob.expr, ast.Col):
                order_col = ob.expr.name
            elif is_ordinal(ob.expr):
                order_ordinal = ordinal_index(ob.expr.value, len(items))
            else:
                order_expr = wc.fold_subqueries(ob.expr)
                for n in columns_in(order_expr):
                    if n != "_id":
                        eng._field(idx, n)
                        ref_cols.add(n)
                non_id = sorted(ref_cols)
        # pushdown: ORDER BY on BSI column → Sort; plain LIMIT →
        # Limit.  LIMIT must stay host-side under DISTINCT (dedup
        # shrinks the row set, so a pushed limit would under-return).
        inner = filt
        host_sort = False
        order_alias = None  # ORDER BY a projected alias / output name
        null_tail = None  # rows where the BSI sort column is NULL
        if order_expr is not None:
            host_sort = True
        elif order_ordinal is not None:
            order_alias = order_ordinal
            host_sort = True
        elif order_col is not None and order_col != "_id" and \
                idx.field(order_col) is None and order_col in names:
            order_alias = names.index(order_col)
            host_sort = True
        elif order_col is not None and order_col != "_id":
            f = eng._field(idx, order_col)
            if f.options.type.is_bsi:
                args = {"_field": order_col}
                if stmt.order_by[0].desc:
                    args["sort-desc"] = True
                if stmt.limit is not None and not stmt.distinct:
                    args["limit"] = stmt.limit + (stmt.offset or 0)
                inner = Call("Sort", args=args, children=[filt])
                # Sort yields only rows holding a value; NULL-valued
                # rows are appended after (NULLS LAST)
                nf = Call("Row",
                          args={order_col: Condition("==", None)})
                null_tail = Call("Intersect", children=[filt, nf]) \
                    if has_filter(filt) else nf
            else:
                host_sort = True
        elif order_col == "_id":
            host_sort = stmt.order_by[0].desc  # asc is natural order
        if not host_sort and not multi_order and order_col is None \
                and stmt.limit is not None and not stmt.distinct:
            inner = Call("Limit", args={
                "limit": stmt.limit + (stmt.offset or 0)},
                children=[filt])

        extract_cols = list(non_id)
        if host_sort and order_expr is None and order_alias is None \
                and order_col != "_id" and order_col not in extract_cols:
            extract_cols.append(order_col)  # fetched for sorting only
        # multi-key ORDER BY: resolve every key to a per-row getter
        # BEFORE executing anything, so a bad reference errors without
        # paying for the scan.  Plans: ("ord" projection index | "id"
        # | "col" extracted name | "alias" projection index | "expr"
        # folded scalar)
        mord = []
        if multi_order:
            for ob in stmt.order_by:
                e = ob.expr
                if is_ordinal(e):
                    mord.append(
                        ("ord", ordinal_index(e.value, len(items))))
                elif isinstance(e, ast.Col) and e.name == "_id":
                    mord.append(("id", None))
                elif isinstance(e, ast.Col) and \
                        idx.field(e.name) is not None:
                    mord.append(("col", e.name))
                elif isinstance(e, ast.Col):
                    if e.name not in names:
                        raise SQLError(
                            f"ORDER BY column {e.name!r} not found")
                    mord.append(("alias", names.index(e.name)))
                else:
                    mord.append(("expr", wc.fold_subqueries(e)))

        def run_extract(src):
            c = Call("Extract", children=[src] + [
                Call("Rows", args={"_field": n}) for n in extract_cols])
            return eng.run_call(idx, c)

        table = run_extract(inner)
        need_nulls = null_tail is not None and (
            stmt.limit is None or stmt.distinct or
            len(table.columns) < stmt.limit + (stmt.offset or 0))
        if need_nulls:
            table.columns.extend(run_extract(null_tail).columns)

        schema = []
        for it, plan in zip(items, plans):
            if plan[0] == "id":
                schema.append((name_of(it),
                               "string" if idx.keys else "id"))
            elif plan[0] == "col":
                schema.append((name_of(it),
                               sql_type_of(eng._field(idx, plan[1]))))
            else:
                schema.append((name_of(it),
                               self.expr_type(idx, plan[1])))
        ev = Evaluator(udfs=eng._udf_callables())
        need_env = (order_expr is not None
                    or any(p[0] == "expr" for p in plans)
                    or any(k == "expr" for k, _a in mord))
        rows = []
        sort_keys = []
        mkeys = []
        for entry in table.columns:
            env = None
            if need_env:
                env = {n: to_env_value(entry["rows"][i])
                       for i, n in enumerate(extract_cols)}
                env["_id"] = entry.get("column_key", entry["column"])
            vals = []
            for plan in plans:
                if plan[0] == "id":
                    vals.append(entry.get("column_key",
                                          entry["column"]))
                elif plan[0] == "col":
                    vals.append(to_sql_value(
                        entry["rows"][extract_cols.index(plan[1])]))
                else:
                    vals.append(to_sql_value(ev.eval(plan[1], env)))
            rows.append(tuple(vals))
            if host_sort:
                if order_expr is not None:
                    k = ev.eval(order_expr, env)
                elif order_alias is not None:
                    k = vals[order_alias]
                elif order_col == "_id":
                    k = entry.get("column_key", entry["column"])
                else:
                    k = entry["rows"][extract_cols.index(order_col)]
                if isinstance(k, list):  # set column: sort by first
                    k = sorted(k)[0] if k else None
                sort_keys.append(k)
            if multi_order:
                mk = []
                for kind, arg in mord:
                    if kind == "ord" or kind == "alias":
                        k = vals[arg]
                    elif kind == "id":
                        k = entry.get("column_key", entry["column"])
                    elif kind == "col":
                        k = entry["rows"][extract_cols.index(arg)]
                    else:
                        k = ev.eval(arg, env)
                    if isinstance(k, list):
                        k = sorted(k)[0] if k else None
                    mk.append(k)
                mkeys.append(mk)
        if host_sort:
            order = sorted_nulls_last(
                range(len(rows)), lambda i: sort_keys[i],
                stmt.order_by[0].desc)
            rows = [rows[i] for i in order]
        if multi_order:
            # stable sorts applied last-key-first, NULLS LAST per key
            order = list(range(len(rows)))
            for ki in reversed(range(len(mord))):
                order = sorted_nulls_last(
                    order, lambda i: mkeys[i][ki],
                    stmt.order_by[ki].desc)
            rows = [rows[i] for i in order]
        if stmt.distinct:
            # single-BSI-column DISTINCT dedups in memory: the value
            # space is the bsi_value_hist's (bounded by 2^depth), so
            # the distinct set can never outgrow what the fused
            # histogram already answers — spilling those to the
            # on-disk extendible hash bought durability nothing needs
            # (DistinctScanOp serves the shape directly when the
            # planner can prove it)
            single_bsi = (len(plans) == 1 and plans[0][0] == "col"
                          and eng._field(idx, plans[0][1])
                          .options.type.is_bsi)
            if single_bsi:
                seen: set = set()
                deduped = []
                for r in rows:
                    k = distinct_key(r)
                    if k not in seen:
                        seen.add(k)
                        deduped.append(r)
                rows = deduped
            else:
                # spill-backed dedup: in-memory set until the
                # threshold, then the on-disk extendible hash (sql3
                # opdistinct over bufferpool/extendiblehash)
                import os
                import tempfile
                from pilosa_tpu_torch.storage.extendiblehash import SpillSet
                fd, spill_path = tempfile.mkstemp(suffix=".distinct")
                os.close(fd)  # mkstemp, not mktemp: no name TOCTOU
                spill = SpillSet(spill_path)
                try:
                    deduped = []
                    for r in rows:
                        if spill.add(distinct_key(r)):
                            deduped.append(r)
                    rows = deduped
                finally:
                    spill.close()
        rows = limit_rows(stmt, rows)
        return SQLResult(schema=schema, rows=rows)

    # -- FROM-less / views ----------------------------------------------

    def select_const(self, stmt: ast.Select) -> SQLResult:
        """FROM-less constant SELECT (sql3 allows e.g.
        `select cast(1 as bool)`): items evaluate once, no table."""
        from pilosa_tpu_torch.sql.funcs import Evaluator
        eng = self.eng
        if stmt.where is not None or stmt.group_by or stmt.joins or \
                stmt.having is not None:
            raise SQLError("constant SELECT takes projections only")
        ev = Evaluator(udfs=eng._udf_callables())
        schema, vals = [], []
        for it in stmt.items:
            e = eng.wherec.fold_subqueries(it.expr)
            # eval first: a Col reference errors here, so expr_type
            # (which only needs idx for Col lookups) runs idx-less
            vals.append(to_sql_value(ev.eval(e, {})))
            schema.append((name_of(it), self.expr_type(None, e)))
        rows = limit_rows(stmt, [tuple(vals)])
        return SQLResult(schema=schema, rows=rows)

    def select_derived(self, stmt: ast.Select) -> SQLResult:
        """FROM (SELECT ...) [alias]: materialize the inner select,
        then evaluate the outer WHERE / projections / aggregates /
        DISTINCT / ORDER BY / LIMIT over its rows host-side (sql3
        tableOrSubquery; defs_subquery's sum-over-grouped shape).
        Qualified refs resolve by column name — the evaluator ignores
        the alias qualifier."""
        from pilosa_tpu_torch.sql.funcs import Evaluator, _truthy
        eng = self.eng
        inner = eng._select(stmt.from_select)
        names = [s[0] for s in inner.schema]
        types = dict(inner.schema)
        ev = Evaluator(udfs=eng._udf_callables())
        envs = [dict(zip(names, r)) for r in inner.rows]
        if stmt.where is not None:
            w = eng.wherec.fold_subqueries(stmt.where)
            keep = []
            for env in envs:
                v = ev.eval(w, env)
                if v is not None and _truthy(v):
                    keep.append(env)
            envs = keep
        if stmt.group_by or stmt.having is not None:
            raise SQLError(
                "GROUP BY over a FROM subquery is not supported")
        # expand * to the inner columns
        items = []
        for it in stmt.items:
            if isinstance(it.expr, ast.Col) and it.expr.name == "*":
                items += [ast.SelectItem(ast.Col(n), n)
                          for n in names]
            else:
                items.append(it)

        def agg_eval(a: ast.Agg):
            if a.func == "count" and a.arg is None:
                return len(envs)
            vals = [ev.eval(a.arg, env) for env in envs]
            return self._agg_reduce(a, [v for v in vals
                                        if v is not None])

        def out_type(e) -> str:
            if isinstance(e, ast.Col):
                return types.get(e.name, "string")
            if isinstance(e, ast.Agg):
                if e.func == "count":
                    return "int"
                if e.func == "avg":
                    return "decimal"
                if isinstance(e.arg, ast.Col):
                    return types.get(e.arg.name, "int")
                return "int"
            return "string"

        aggish = [it for it in items
                  if isinstance(it.expr, ast.Agg)]
        if aggish:
            if len(aggish) != len(items):
                raise SQLError(
                    "mixing aggregates and columns requires GROUP BY")
            schema = [(name_of(it), out_type(it.expr))
                      for it in items]
            rows = limit_rows(stmt,
                              [tuple(agg_eval(it.expr)
                                     for it in items)])
            return SQLResult(schema=schema, rows=rows)
        schema = []
        rows = []
        for it in items:
            e = it.expr
            if isinstance(e, ast.Col) and e.name not in names:
                raise SQLError(f"column not found: {e.name}")
            schema.append((name_of(it), out_type(e)))
        for env in envs:
            rows.append(tuple(
                to_sql_value(ev.eval(it.expr, env)) for it in items))
        if stmt.distinct:
            seen, dedup = set(), []
            for r in rows:
                k = distinct_key(r)
                if k not in seen:
                    seen.add(k)
                    dedup.append(r)
            rows = dedup
        rows = order_rows(stmt, schema, rows)
        rows = limit_rows(stmt, rows)
        return SQLResult(schema=schema, rows=rows)

    def select_view(self, stmt: ast.Select) -> SQLResult:
        """Query a stored view: re-execute its select, then apply the
        outer projection / ORDER BY / LIMIT by result-column name.
        Outer WHERE/GROUP BY/aggregates over views are not supported
        (the reference's planner expands views generally; this subset
        is documented)."""
        eng = self.eng
        if stmt.where is not None or stmt.group_by or stmt.joins or \
                stmt.having is not None or stmt.distinct:
            raise SQLError(
                "views support projection/ORDER BY/LIMIT only")
        inner = eng._views[stmt.table]
        res = eng._select(inner)
        names = [s[0] for s in res.schema]
        cols: list[int] = []
        for it in stmt.items:
            e = it.expr
            if isinstance(e, ast.Col) and e.name == "*":
                cols.extend(range(len(names)))
                continue
            if not isinstance(e, ast.Col):
                raise SQLError("view projections must be columns")
            if e.name not in names:
                raise SQLError(
                    f"column {e.name!r} not in view {stmt.table}")
            cols.append(names.index(e.name))
        schema = [res.schema[i] for i in cols]
        rows = [tuple(r[i] for i in cols) for r in res.rows]
        rows = order_rows(stmt, schema, rows)
        rows = limit_rows(stmt, rows)
        return SQLResult(schema=schema, rows=rows)

    # -- cell materialization (joins, generic GROUP BY) -----------------

    def column_map(self, idx, name: str, filt: Call | None = None) \
            -> dict:
        """rid -> value for a column via one Extract through the
        executor — the bulk, remote-capable form of cell_value (the
        reference's DAX orchestrator likewise iterates Extract scans
        over the compute nodes rather than reading cells,
        dax/queryer/orchestrator.go:83,109).  `filt` bounds the scan
        to the matching records (a selective WHERE must not decode
        the whole column).  Values match cell_value: BSI
        typed-or-None, bool True/False/None, single-member sets
        collapse to scalars, keyed sets sort."""
        eng = self.eng
        filt = filt if filt is not None else Call("All")
        if name == "_id":
            c = Call("Extract", children=[filt])
            table = eng.run_call(idx, c)
            return {int(e["column"]): e.get("column_key",
                                            e["column"])
                    for e in table.columns}
        f = eng._field(idx, name)
        c = Call("Extract", children=[
            filt, Call("Rows", args={"_field": name})])
        table = eng.run_call(idx, c)
        setlike = f.options.type in (FieldType.SET, FieldType.TIME,
                                     FieldType.MUTEX)
        out = {}
        for e in table.columns:
            v = e["rows"][0]
            if setlike and isinstance(v, list):
                if not v:
                    v = None
                elif len(v) == 1:
                    v = v[0]
                elif f.options.keys:
                    v = sorted(v)
            out[int(e["column"])] = v
        return out

    class _CellReader:
        """Per-statement cache of column maps for one table."""

        def __init__(self, ops, idx, filt=None):
            self.ops, self.idx, self.filt = ops, idx, filt
            self.maps: dict = {}

        def get(self, name: str, rid):
            m = self.maps.get(name)
            if m is None:
                m = self.ops.column_map(self.idx, name, self.filt)
                self.maps[name] = m
            return m.get(rid)

    def cell_reader(self, idx, filt=None) -> "_CellReader":
        return self._CellReader(self, idx, filt)

    def cell_value(self, idx, name: str, col_id: int):
        """One column's value for one record id (join
        materialization).  BSI fields -> typed value or None;
        set-like -> row key/id (or sorted list when multiple); _id ->
        the key (keyed tables) or the id, matching what SELECT
        projects."""
        eng = self.eng
        if name == "_id":
            if idx.keys and idx.column_translator is not None:
                k = idx.column_translator.translate_ids([col_id])[0]
                return k if k is not None else col_id
            return col_id
        f = eng._field(idx, name)
        shard, scol = divmod(col_id, f.width)
        if f.options.type.is_bsi:
            v = f.views.get(f.bsi_view)
            frag = v.fragment(shard) if v else None
            if frag is None or not frag.contains(0, scol):
                return None
            mag = sum(1 << i for i in range(f.bit_depth)
                      if frag.contains(2 + i, scol))
            return f.int_to_value(
                -mag if frag.contains(1, scol) else mag)
        from pilosa_tpu_torch.models.view import VIEW_STANDARD
        view = f.views.get(VIEW_STANDARD)
        frag = view.fragment(shard) if view else None
        if frag is None:
            return None
        rows = [r for r in frag.row_ids if frag.contains(r, scol)]
        if not rows:
            return None
        if f.options.type == FieldType.BOOL:
            return rows[-1] == 1
        if f.options.keys:
            keys = f.row_translator.translate_ids(rows)
            return keys[0] if len(keys) == 1 else sorted(keys)
        return rows[0] if len(rows) == 1 else rows

    def table_ids(self, idx, filt) -> list:
        res = self.eng.run_call(idx, filt)
        return [int(c) for c in res.columns()]

    # -- JOIN (sql3 opnestedloops.go nested-loop join) ------------------

    def select_join(self, stmt: ast.Select) -> SQLResult:
        """N-way nested-loop INNER / LEFT OUTER JOIN on column
        equality, with table aliases, aggregates, GROUP BY, and
        DISTINCT over the joined rows.

        Each JOIN hashes its new side by join-key value and probes
        the tuples built so far (the hashed refinement of
        opnestedloops.go; LEFT JOIN per its outer variant: an
        unmatched tuple survives once with a NULL new side, and WHERE
        evaluates AFTER the join).  Sides are addressed by alias or —
        when unambiguous — by real table name; unqualified columns
        default to the left table (the first FROM entry)."""
        eng = self.eng
        if stmt.having is not None and not stmt.group_by:
            raise SQLError("HAVING requires GROUP BY")

        # -- side registry ---------------------------------------------
        # (key, table, idx, derived); derived = (rows, names, types)
        # for a materialized (SELECT ...) side, else None
        sides: list[tuple] = []

        def add_side(table, alias, subquery=None):
            if subquery is not None:
                if not alias:
                    raise SQLError(
                        "a derived table in a join requires an alias")
                inner = eng._select(subquery)
                names = [s[0] for s in inner.schema]
                types = dict(inner.schema)
                derived = (inner.rows, names, types)
                idx = None
                key = alias
            else:
                idx = eng._index(table)
                derived = None
                key = alias or table
            if any(s[0] == key for s in sides):
                raise SQLError(
                    f"duplicate table name or alias {key!r} "
                    "(alias the table)")
            sides.append((key, table, idx, derived))
        add_side(stmt.table, stmt.table_alias)
        for j in stmt.joins:
            add_side(j.table, j.alias, j.subquery)
        keymap = {s[0]: i for i, s in enumerate(sides)}
        by_table: dict[str, list[int]] = {}
        for i, s in enumerate(sides):
            if s[1] is not None:
                by_table.setdefault(s[1], []).append(i)

        def side_index(qual: str, ctx: str) -> int:
            if qual in keymap:
                return keymap[qual]
            hits = by_table.get(qual, [])
            if len(hits) == 1:
                return hits[0]
            if hits:
                raise SQLError(f"ambiguous table reference {qual!r}")
            raise SQLError(f"unknown table {qual!r} in {ctx}")

        def col_side(c: ast.Col, ctx: str) -> int:
            return side_index(c.table, ctx) if c.table is not None \
                else 0

        def side_field_tinfo(si: int, name: str):
            from pilosa_tpu_torch.sql.typecheck import TInfo, field_tinfo
            _k, _t, idx, derived = sides[si]
            if derived is not None:
                _rows, names, types = derived
                if name not in types:
                    raise SQLError(f"column not found: {name}")
                kind = types[name]
                if kind.startswith("decimal"):
                    # schema types may carry scale ("decimal(3)")
                    m = re.match(r"decimal\((\d+)\)", kind)
                    return TInfo("decimal",
                                 scale=int(m.group(1)) if m else 2)
                return TInfo(kind)
            if name == "_id":
                return TInfo("string" if idx.keys else "id")
            f = idx.field(name)
            if f is None:
                raise SQLError(f"column not found: {name}")
            return field_tinfo(f)

        # per-side bulk column maps (one Extract per referenced
        # column through the executor, so joins also serve the DAX
        # queryer — the orchestrator shape, not per-cell reads)
        readers: dict[int, object] = {}

        def cell(si: int, col: str, rid):
            if rid is None:  # unmatched LEFT JOIN side
                return None
            _k, _t, idx, derived = sides[si]
            if derived is not None:
                rows, names, _types = derived
                if col not in names:
                    raise SQLError(f"column not found: {col}")
                return rows[rid][names.index(col)]
            rd = readers.get(si)
            if rd is None:
                rd = readers[si] = self.cell_reader(idx)
            return rd.get(col, rid)

        all_call = Call("All")

        def side_ids(si: int):
            _k, _t, idx, derived = sides[si]
            if derived is not None:
                return range(len(derived[0]))
            return self.table_ids(idx, all_call)

        def where_equality_for(new_si: int):
            """Find a top-level AND-tree conjunct col = col in WHERE
            relating side new_si to an earlier side, so a comma join
            can hash-join instead of building the cross product (the
            conjunct stays in WHERE; re-evaluating it is harmless)."""
            def conjuncts(e):
                if isinstance(e, ast.BinOp) and e.op == "and":
                    yield from conjuncts(e.left)
                    yield from conjuncts(e.right)
                else:
                    yield e
            if stmt.where is None:
                return None
            for c in conjuncts(stmt.where):
                if not (isinstance(c, ast.BinOp) and c.op == "="
                        and isinstance(c.left, ast.Col)
                        and isinstance(c.right, ast.Col)
                        and c.left.table is not None
                        and c.right.table is not None):
                    continue
                try:
                    lsi = side_index(c.left.table, "WHERE")
                    rsi = side_index(c.right.table, "WHERE")
                    kinds = {side_field_tinfo(lsi, c.left.name).kind,
                             side_field_tinfo(rsi, c.right.name).kind}
                except SQLError:
                    continue  # validated later by the WHERE walk
                if kinds & {"idset", "stringset"}:
                    # sets hash by membership but WHERE re-evaluates
                    # as equality — leave those to the cross product
                    continue
                if rsi == new_si and lsi < new_si:
                    return c.left, c.right, lsi
                if lsi == new_si and rsi < new_si:
                    return c.right, c.left, rsi
            return None

        # -- build joined tuples (one record id per side) --------------
        tuples: list[tuple] = [(rid,) for rid in side_ids(0)]
        for ji, j in enumerate(stmt.joins):
            new_si = ji + 1
            if j.left is None:  # comma join
                eq = where_equality_for(new_si)
                if eq is not None:
                    jl, jr, lsi = eq
                    rmap: dict = {}
                    for rid in side_ids(new_si):
                        v = cell(new_si, jr.name, rid)
                        if v is None:
                            continue
                        for key in (v if isinstance(v, list)
                                    else [v]):
                            rmap.setdefault(key, []).append(rid)
                    out = []
                    for t in tuples:
                        lv = cell(lsi, jl.name, t[lsi])
                        if lv is None:
                            continue
                        for key in (lv if isinstance(lv, list)
                                    else [lv]):
                            for rid in rmap.get(key, ()):
                                out.append(t + (rid,))
                    tuples = out
                    continue
                new_ids = list(side_ids(new_si))  # cross product;
                tuples = [t + (rid,) for t in tuples  # WHERE filters
                          for rid in new_ids]
                continue
            jl, jr = j.left, j.right
            for c in (jl, jr):
                if not isinstance(c, ast.Col) or c.table is None:
                    raise SQLError("JOIN ON columns must be "
                                   "qualified (table.column)")
            lsi = side_index(jl.table, "ON")
            rsi = side_index(jr.table, "ON")
            if rsi != new_si:
                jl, jr, lsi, rsi = jr, jl, rsi, lsi
            if rsi != new_si or lsi >= new_si:
                raise SQLError("JOIN ON must relate the joined table "
                               "to an earlier table")
            # analysis: join keys must be equatable (defs_join.go
            # Unmatched-columns case)
            from pilosa_tpu_torch.sql.typecheck import TypeChecker
            tc = TypeChecker(eng)
            tc._equatable(side_field_tinfo(lsi, jl.name),
                          side_field_tinfo(rsi, jr.name))
            rmap: dict = {}
            for rid in side_ids(rsi):
                v = cell(rsi, jr.name, rid)
                if v is None:
                    continue
                for key in (v if isinstance(v, list) else [v]):
                    rmap.setdefault(key, []).append(rid)
            out = []
            for t in tuples:
                lv = cell(lsi, jl.name, t[lsi])
                matched = False
                if lv is not None:
                    for key in (lv if isinstance(lv, list) else [lv]):
                        for rid in rmap.get(key, ()):
                            matched = True
                            out.append(t + (rid,))
                if j.outer and not matched:
                    out.append(t + (None,))
            tuples = out

        # -- WHERE over joined tuples ----------------------------------
        def jeval(e, tup):
            if isinstance(e, ast.Lit):
                return e.value
            if isinstance(e, ast.Col):
                si = col_side(e, "WHERE")
                return cell(si, e.name, tup[si])
            if isinstance(e, ast.Func):
                from pilosa_tpu_torch.sql.funcs import call_builtin
                args = [jeval(x, tup) for x in e.args]
                udf = eng._udf_callables().get(e.name)
                return udf(args) if udf is not None \
                    else call_builtin(e.name, args)
            if isinstance(e, ast.Not):
                v = jeval(e.expr, tup)
                return None if v is None else not v
            if isinstance(e, ast.IsNull):
                return (jeval(e.col, tup) is None) != e.negated
            if isinstance(e, ast.InList):
                v = jeval(e.col, tup)
                if v is None:
                    return None
                hit = v in e.items
                return (not hit) if e.negated else hit
            if isinstance(e, ast.Between):
                v = jeval(e.col, tup)
                lo, hi = jeval(e.lo, tup), jeval(e.hi, tup)
                if None in (v, lo, hi):
                    return None
                hit = lo <= v <= hi
                return (not hit) if e.negated else hit
            if isinstance(e, ast.BinOp):
                if e.op == "and":
                    l, r = jeval(e.left, tup), jeval(e.right, tup)
                    return bool(l) and bool(r)
                if e.op == "or":
                    l, r = jeval(e.left, tup), jeval(e.right, tup)
                    return bool(l) or bool(r)
                l, r = jeval(e.left, tup), jeval(e.right, tup)
                if l is None or r is None:
                    return False
                try:
                    if e.op == "=":
                        return l == r
                    if e.op in ("!=", "<>"):
                        return l != r
                    return {"<": l < r, "<=": l <= r, ">": l > r,
                            ">=": l >= r}[e.op]
                except (TypeError, KeyError):
                    raise SQLError(
                        f"JOIN WHERE operator {e.op!r} unsupported "
                        f"for {type(l).__name__}/{type(r).__name__}")
            raise SQLError(f"unsupported WHERE form in JOIN: {e!r}")

        if stmt.where is not None:
            # uncorrelated subqueries fold to literals/IN lists first
            # (defs_in: join WHERE with an IN-subquery)
            folded_where = eng.wherec.fold_subqueries(stmt.where)
            tuples = [t for t in tuples if jeval(folded_where, t)]

        # -- projections -----------------------------------------------
        # plans: ("col", si, name, out, type) | ("agg", Agg, out)
        plans = []

        def add_col(si, name, out):
            t = side_field_tinfo(si, name)
            derived = sides[si][3]
            plans.append(("col", si, name, out,
                          "decimal" if t.kind == "decimal"
                          else t.kind if name != "_id" or derived
                          else ("string" if sides[si][2].keys
                                else "id")))

        def star_side(si, qualify):
            _k, _t, idx, derived = sides[si]
            pre = f"{sides[si][0]}." if qualify else ""
            if derived is not None:
                for n in derived[1]:
                    add_col(si, n, pre + n)
                return
            add_col(si, "_id", pre + "_id")
            for f in declared_fields(idx):
                add_col(si, f.name, pre + f.name)

        for it in stmt.items:
            e = it.expr
            if isinstance(e, ast.Agg):
                plans.append(("agg", e, name_of(it)))
            elif isinstance(e, ast.Col) and e.name == "*":
                if e.table is not None:  # u.* — one side, plain names
                    star_side(side_index(e.table, "projection"), False)
                else:
                    for si in range(len(sides)):
                        star_side(si, si > 0)
            elif isinstance(e, ast.Col):
                si = col_side(e, "projection")
                out = it.alias or (e.name if e.table is None
                                   else f"{e.table}.{e.name}")
                add_col(si, e.name, out)
            else:
                raise SQLError(
                    "JOIN projections must be columns or aggregates")

        aggs = [p for p in plans if p[0] == "agg"]
        group_cols: list[tuple[int, str]] = []
        for g in stmt.group_by:
            if "." in g:
                qual, _, nm = g.partition(".")
                group_cols.append((side_index(qual, "GROUP BY"), nm))
            else:
                group_cols.append((0, g))
        for si, nm in group_cols:
            side_field_tinfo(si, nm)  # validate

        def agg_value(a: ast.Agg, tups):
            if a.func == "count" and a.arg is None:
                return len(tups)
            if a.arg is None:
                raise SQLError(f"{a.func} requires a column argument")
            si = col_side(a.arg, "aggregate")
            vals = [cell(si, a.arg.name, t[si]) for t in tups]
            vals = [v for v in vals if v is not None]
            if a.func == "count":
                if a.distinct:
                    return len({v if not isinstance(v, list)
                                else tuple(sorted(v)) for v in vals})
                return len(vals)
            if not vals:
                return None
            if a.func == "sum":
                return sum(vals)
            if a.func == "avg":
                return self._avg_quantize(sum(vals), len(vals))
            if a.func == "min":
                return min(vals)
            if a.func == "max":
                return max(vals)
            raise SQLError(
                f"aggregate {a.func} not supported in JOIN")

        def agg_sql_type(a: ast.Agg) -> str:
            if a.func == "count":
                return "int"
            if a.func == "avg":
                return "decimal"
            si = col_side(a.arg, "aggregate")
            return side_field_tinfo(si, a.arg.name).render().split(
                "(")[0]

        if aggs and not stmt.group_by:
            if len(aggs) != len(plans):
                raise SQLError(
                    "mixing aggregates and columns requires GROUP BY")
            schema = [(p[2], agg_sql_type(p[1])) for p in aggs]
            rows = [tuple(agg_value(p[1], tuples) for p in aggs)]
            return SQLResult(schema=schema, rows=rows)

        if stmt.group_by:
            groups: dict[tuple, list] = {}
            for t in tuples:
                key = tuple(self._canon_group(cell(si, nm, t[si]))
                            for si, nm in group_cols)
                groups.setdefault(key, []).append(t)
            schema, rows = [], []
            for p in plans:
                if p[0] == "col":
                    if (p[1], p[2]) not in group_cols:
                        raise SQLError(
                            f"column {p[3]} must appear in GROUP BY")
                    schema.append((p[3], p[4]))
                else:
                    schema.append((p[2], agg_sql_type(p[1])))
            for key, tups in groups.items():
                vals = []
                for p in plans:
                    if p[0] == "col":
                        kv = key[group_cols.index((p[1], p[2]))]
                        # set group keys canonicalized to tuples for
                        # hashing; project back as lists
                        vals.append(list(kv) if isinstance(kv, tuple)
                                    else kv)
                    else:
                        vals.append(agg_value(p[1], tups))
                rows.append(tuple(vals))
            rows = order_rows(stmt, schema, rows)
            rows = limit_rows(stmt, rows)
            return SQLResult(schema=schema, rows=rows)

        schema = [(p[3], p[4]) for p in plans]
        rows = [tuple(cell(p[1], p[2], t[p[1]]) for p in plans)
                for t in tuples]
        if stmt.distinct:
            seen, deduped = set(), []
            for r in rows:
                k = distinct_key(r)
                if k not in seen:
                    seen.add(k)
                    deduped.append(r)
            rows = deduped
        rows = order_rows(stmt, schema, rows)
        rows = limit_rows(stmt, rows)
        return SQLResult(schema=schema, rows=rows)

    @staticmethod
    def _canon_group(v):
        return tuple(sorted(v)) if isinstance(v, list) else v
