"""WHERE → PQL compiler: the filter-pushdown half of the planner.

Conjuncts that compile to PQL ops push down to the shard-parallel
device scan (the PlanOpPQLTableScan filter push of
sql3/planner/planoptimizer.go); the rest — scalar functions,
arithmetic — evaluate row-wise over the pushed result and fold back
as a ConstRow of matching ids (the reference evaluates non-pushable
filters row-wise in PlanOpFilter, sql3/planner/opfilter.go).

Split out of engine.py.  The compiler holds a backref to
the engine for schema lookup (fields, _id translation), subquery
execution, and UDF resolution.
"""

from __future__ import annotations

from pilosa_tpu_torch.models import FieldType
from pilosa_tpu_torch.pql.ast import Call, Condition
from pilosa_tpu_torch.sql import ast
from pilosa_tpu_torch.sql.common import to_env_value
from pilosa_tpu_torch.sql.lexer import SQLError

_CMP_OPS = ("=", "!=", "<", "<=", ">", ">=", "like")


def has_filter(filt: Call) -> bool:
    """True unless filt is the no-op match-everything All()."""
    return not (filt.name == "All" and not filt.args)


def has_subquery(e) -> bool:
    if isinstance(e, (ast.SubQuery, ast.InSelect)):
        return True
    if isinstance(e, ast.BinOp):
        return has_subquery(e.left) or has_subquery(e.right)
    if isinstance(e, ast.Not):
        return has_subquery(e.expr)
    if isinstance(e, ast.Func):
        return any(has_subquery(x) for x in e.args)
    if isinstance(e, ast.Between):
        return any(has_subquery(x) for x in (e.col, e.lo, e.hi))
    return False


def is_pushable(e) -> bool:
    """True when `where_call` can compile e to a PQL tree directly."""
    if isinstance(e, ast.BinOp):
        if e.op in ("and", "or"):
            return is_pushable(e.left) and is_pushable(e.right)
        if e.op not in _CMP_OPS:
            return False  # arithmetic / concat
        sides = (e.left, e.right)
        return any(isinstance(s, ast.Col) for s in sides) and \
            any(isinstance(s, ast.Lit) for s in sides)
    if isinstance(e, ast.Not):
        return is_pushable(e.expr)
    if isinstance(e, (ast.InList, ast.InSelect, ast.IsNull)):
        return isinstance(e.col, ast.Col)
    if isinstance(e, ast.Between):
        return isinstance(e.col, ast.Col) and \
            isinstance(e.lo, ast.Lit) and isinstance(e.hi, ast.Lit)
    if isinstance(e, ast.Func):
        # SETCONTAINS* over (column, literal) become Row filters
        if e.name == "RANGEQ":
            return len(e.args) == 3 and \
                isinstance(e.args[0], ast.Col) and \
                all(isinstance(x, ast.Lit) for x in e.args[1:])
        return e.name in ("SETCONTAINS", "SETCONTAINSANY",
                          "SETCONTAINSALL") and len(e.args) == 2 \
            and isinstance(e.args[0], ast.Col) \
            and isinstance(e.args[1], ast.Lit)
    return False


def split_where(e):
    """(pushable, residue) — split at top-level ANDs only."""
    if is_pushable(e):
        return e, None
    if isinstance(e, ast.BinOp) and e.op == "and":
        lp, lr = split_where(e.left)
        rp, rr = split_where(e.right)
        push = lp if rp is None else rp if lp is None else \
            ast.BinOp("and", lp, rp)
        res = lr if rr is None else rr if lr is None else \
            ast.BinOp("and", lr, rr)
        return push, res
    return None, e


def col_name(e) -> str:
    if not isinstance(e, ast.Col):
        raise SQLError(f"expected column, got {e!r}")
    return e.name


class WhereCompiler:
    """Bound to one SQLEngine; see module docstring."""

    def __init__(self, engine):
        self.eng = engine

    # -- entry points ---------------------------------------------------

    def compile_where(self, idx, where) -> Call:
        if where is None:
            return Call("All")
        where = self.fold_subqueries(where)
        push, residue = split_where(where)
        filt = self.where_call(idx, push) if push is not None \
            else Call("All")
        if residue is None:
            return filt
        ids = self.residue_ids(idx, filt, residue)
        return Call("ConstRow", args={"columns": ids})

    def fold_subqueries(self, e):
        """Replace scalar SubQuery nodes with their evaluated literal
        and IN-subqueries with materialized IN lists (uncorrelated —
        they run once at compile time)."""
        if isinstance(e, ast.SubQuery):
            return ast.Lit(self.scalar_subquery(e.select))
        if isinstance(e, ast.InSelect):
            return ast.InList(e.col, self.subquery_column(e.select),
                              negated=e.negated)
        if isinstance(e, ast.BinOp):
            return ast.BinOp(e.op, self.fold_subqueries(e.left),
                             self.fold_subqueries(e.right))
        if isinstance(e, ast.Not):
            return ast.Not(self.fold_subqueries(e.expr))
        if isinstance(e, ast.Func):
            return ast.Func(e.name,
                            [self.fold_subqueries(x) for x in e.args])
        if isinstance(e, ast.Between):
            return ast.Between(self.fold_subqueries(e.col),
                               self.fold_subqueries(e.lo),
                               self.fold_subqueries(e.hi),
                               negated=e.negated)
        return e

    def residue_ids(self, idx, filt: Call, residue) -> list[int]:
        """Evaluate a host-only predicate over the rows matching the
        pushed filter; return the surviving column ids."""
        from pilosa_tpu_torch.sql.funcs import Evaluator, _truthy, columns_in
        eng = self.eng
        cols = sorted(n for n in columns_in(residue) if n != "_id")
        for n in cols:
            eng._field(idx, n)  # validate
        c = Call("Extract", children=[filt] + [
            Call("Rows", args={"_field": n}) for n in cols])
        table = eng.run_call(idx, c)
        ev = Evaluator(udfs=eng._udf_callables())
        out = []
        for entry in table.columns:
            env = {n: to_env_value(entry["rows"][i])
                   for i, n in enumerate(cols)}
            env["_id"] = entry.get("column_key", entry["column"])
            v = ev.eval(residue, env)
            # strict boolean context (funcs._truthy): a non-boolean
            # predicate (WHERE region) is a type error, not truthiness
            if v is not None and _truthy(v):
                out.append(int(entry["column"]))
        return out

    # -- subqueries -----------------------------------------------------

    def subquery_column(self, sub: ast.Select) -> list:
        """Execute an uncorrelated subquery; must yield one column."""
        res = self.eng._select(sub)
        if len(res.schema) != 1:
            raise SQLError("subquery must select exactly one column")
        return [r[0] for r in res.rows]

    def scalar_subquery(self, sub: ast.Select):
        """Scalar subquery: one column, at most one row (NULL if
        none)."""
        vals = self.subquery_column(sub)
        if len(vals) > 1:
            raise SQLError("scalar subquery returned more than one row")
        return vals[0] if vals else None

    # -- expression → PQL -----------------------------------------------

    def where_call(self, idx, e) -> Call:
        if isinstance(e, ast.BinOp):
            if e.op == "and":
                return Call("Intersect", children=[
                    self.where_call(idx, e.left),
                    self.where_call(idx, e.right)])
            if e.op == "or":
                return Call("Union", children=[
                    self.where_call(idx, e.left),
                    self.where_call(idx, e.right)])
            return self.comparison(idx, e)
        if isinstance(e, ast.Not):
            return Call("Not", children=[self.where_call(idx, e.expr)])
        if isinstance(e, ast.InList):
            return self.in_list(idx, e)
        if isinstance(e, ast.InSelect):
            # uncorrelated IN-subquery: materialize the subquery's
            # single column, then compile as an IN list (the semi-join
            # shape of sql3/planner subquery compilation)
            vals = self.subquery_column(e.select)
            if e.negated and any(v is None for v in vals):
                # strict SQL: NOT IN against a list containing NULL is
                # never TRUE (UNKNOWN for non-matches) -> empty result
                return Call("ConstRow", args={"columns": []})
            return self.in_list(idx, ast.InList(
                e.col, [v for v in vals if v is not None],
                negated=e.negated))
        if isinstance(e, ast.Between):
            name = col_name(e.col)
            lo = e.lo.value if isinstance(e.lo, ast.Lit) else e.lo
            hi = e.hi.value if isinstance(e.hi, ast.Lit) else e.hi
            if e.negated:
                # strict SQL: NULL NOT BETWEEN x AND y is UNKNOWN ->
                # excluded.  The range union stays within not-null
                # rows, unlike Not() which would admit NULLs.
                return Call("Union", children=[
                    Call("Row", args={name: Condition("<", lo)}),
                    Call("Row", args={name: Condition(">", hi)})])
            return Call("Row", args={name: Condition("><", [lo, hi])})
        if isinstance(e, ast.IsNull):
            return self.is_null(idx, e)
        if isinstance(e, ast.Func) and e.name == "RANGEQ":
            # RANGEQ(tq_col, from, to) -> time-ranged Rows filter
            # (expressionpql.go:99; push-down only, like the
            # reference — EvaluateRangeQ always errors)
            name = col_name(e.args[0])
            f = self.eng._field(idx, name)
            if f.options.type != FieldType.TIME:
                raise SQLError("RANGEQ requires a timequantum column")
            frm, to = e.args[1].value, e.args[2].value
            if frm is None and to is None:
                raise SQLError(
                    "RANGEQ from and to cannot both be NULL")
            args = {"_field": name}
            if frm is not None:
                args["from"] = frm
            if to is not None:
                args["to"] = to
            return Call("UnionRows",
                        children=[Call("Rows", args=args)])
        if isinstance(e, ast.Func) and e.name.startswith("SETCONTAINS"):
            # membership pushdown (inbuiltfunctionsset.go →
            # expressionpql.go): SETCONTAINS(col, v) is Row(col=v);
            # ANY unions, ALL intersects
            name = col_name(e.args[0])
            f = self.eng._field(idx, name)
            if f.options.type.is_bsi:
                raise SQLError(f"{e.name} requires a set column")
            val = e.args[1].value
            if e.name == "SETCONTAINS":
                vals = [val]
            else:
                vals = val if isinstance(val, list) else [val]
            rows = [Call("Row", args={name: v}) for v in vals]
            if not rows:
                return Call("All") if e.name == "SETCONTAINSALL" \
                    else Call("ConstRow", args={"columns": []})
            if len(rows) == 1:
                return rows[0]
            return Call("Union" if e.name == "SETCONTAINSANY"
                        else "Intersect", children=rows)
        raise SQLError(f"unsupported WHERE expression {e!r}")

    def comparison(self, idx, e: ast.BinOp) -> Call:
        eng = self.eng
        # normalize literal-on-left (scalar subqueries were already
        # folded to literals by compile_where's fold_subqueries pass)
        left, right, op = e.left, e.right, e.op
        if isinstance(left, ast.Lit) and isinstance(right, ast.Col):
            left, right = right, left
            op = {"<": ">", "<=": ">=", ">": "<", ">=": "<="}.get(op, op)
        name = col_name(left)
        if not isinstance(right, ast.Lit):
            raise SQLError("comparison requires a literal")
        val = right.value
        if val is None:
            # strict SQL: comparison with NULL is UNKNOWN -> matches
            # nothing (use IS NULL for null tests)
            return Call("ConstRow", args={"columns": []})
        if name == "_id":
            if op in ("<", "<=", ">", ">="):
                # range predicates on _id (defs_delete: `where _id >
                # 4`): materialize existing ids and filter — _id is
                # not a BSI field, so there is no device range scan
                if idx.keys:
                    raise SQLError(
                        "_id range predicates require an integer _id")
                if isinstance(val, str):
                    try:
                        val = int(val)
                    except ValueError:
                        raise SQLError(
                            f"_id bound must be numeric, got {val!r}")
                import operator
                cmp = {"<": operator.lt, "<=": operator.le,
                       ">": operator.gt, ">=": operator.ge}[op]
                res = eng.run_call(idx, Call("All"))
                cols = [int(c) for c in res.columns()
                        if cmp(int(c), val)]
                return Call("ConstRow", args={"columns": cols})
            cid = eng._col_id(idx, val, create=False)
            cols = [cid] if cid is not None else []
            # intersect with existence: a ConstRow bit for a missing
            # record must not count
            node = Call("Intersect", children=[
                Call("ConstRow", args={"columns": cols}), Call("All")])
            if op in ("=",):
                return node
            if op == "!=":
                return Call("Not", children=[node])
            raise SQLError("_id supports =, != and IN")
        f = eng._field(idx, name)
        t = f.options.type
        if op == "like":
            if f.row_translator is None:
                raise SQLError("LIKE requires a string column")
            # _like_sql: SQL WHERE uses the sql3 scalar regex
            # semantics (case-insensitive, '_' = one or more chars),
            # not the PQL key matcher — the reference never pushes
            # LIKE into PQL (no LIKE in sql3/planner/expressionpql.go)
            return Call("UnionRows", children=[
                Call("Rows", args={"_field": name, "like": val,
                                   "_like_sql": True})])
        if t.is_bsi:
            pql_op = {"=": "==", "!=": "!="}.get(op, op)
            return Call("Row", args={name: Condition(pql_op, val)})
        if t == FieldType.BOOL:
            if op not in ("=", "!="):
                raise SQLError("bool columns support = and !=")
            node = Call("Row", args={name: bool(val)})
            return Call("Not", children=[node]) if op == "!=" else node
        # set / mutex / time: row membership
        if op == "=":
            return Call("Row", args={name: val})
        if op == "!=":
            return Call("Not", children=[Call("Row", args={name: val})])
        if op in ("<", "<=", ">", ">=") and t == FieldType.MUTEX \
                and not f.options.keys:
            # id-column range predicates (defs_filterpredicates
            # `where id1 > 5`): enumerate the field's row ids and
            # union the matching memberships — id values ARE row ids.
            # Bounds compare EXACTLY (a 5.5 bound must not truncate
            # to 5)
            import operator
            from decimal import Decimal, InvalidOperation
            cmp = {"<": operator.lt, "<=": operator.le,
                   ">": operator.gt, ">=": operator.ge}[op]
            try:
                bound = Decimal(str(val))
            except (InvalidOperation, ValueError):
                raise SQLError(
                    f"id bound must be numeric, got {val!r}")
            rows = [r for r in f.row_ids() if cmp(r, bound)]
            if not rows:
                return Call("ConstRow", args={"columns": []})
            if len(rows) == 1:
                return Call("Row", args={name: rows[0]})
            return Call("Union", children=[
                Call("Row", args={name: r}) for r in rows])
        raise SQLError(
            f"operator {op} not supported on {t.value} columns")

    def in_list(self, idx, e: ast.InList) -> Call:
        eng = self.eng
        # strict SQL NULL handling: NULL list members never match;
        # NOT IN against a list containing NULL is never TRUE
        # (UNKNOWN for non-matches) -> empty result
        if any(v is None for v in e.items):
            if e.negated:
                return Call("ConstRow", args={"columns": []})
            e = ast.InList(e.col, [v for v in e.items
                                   if v is not None],
                           negated=False)
        name = col_name(e.col)
        if name == "_id":
            cols = []
            for v in e.items:
                cid = eng._col_id(idx, v, create=False)
                if cid is not None:
                    cols.append(cid)
            node = Call("Intersect", children=[
                Call("ConstRow", args={"columns": cols}), Call("All")])
        else:
            f = eng._field(idx, name)
            if f.options.type.is_bsi:
                children = [Call("Row", args={name: Condition("==", v)})
                            for v in e.items]
                node = Call("Union", children=children)
                if e.negated:
                    # strict SQL: NULL NOT IN (...) is UNKNOWN ->
                    # excluded, so gate the complement on not-null
                    return Call("Intersect", children=[
                        Call("Row", args={name: Condition("!=", None)}),
                        Call("Not", children=[node])])
                return node
            children = [Call("Row", args={name: v}) for v in e.items]
            node = Call("Union", children=children)
        return Call("Not", children=[node]) if e.negated else node

    def is_null(self, idx, e: ast.IsNull) -> Call:
        name = col_name(e.col)
        if name == "_id":
            # _id is a real column in NULL predicates and is never
            # null (reference: sql3/planner handles _id directly;
            # defs_null.go nullFilterTests expects no rows / all rows)
            if e.negated:
                return Call("All")
            return Call("Difference", children=[Call("All"),
                                                Call("All")])
        f = self.eng._field(idx, name)
        if f.options.type.is_bsi:
            return Call("Row", args={name: Condition(
                "!=" if e.negated else "==", None)})
        # set-like: null = exists but no row in this field
        union = Call("UnionRows", children=[
            Call("Rows", args={"_field": name})])
        if e.negated:
            return union
        return Call("Not", children=[union])
