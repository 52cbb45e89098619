"""Static expression type analysis — the
sql3/planner/expressionanalyzer.go analog.

Walks scalar expressions against the table schema BEFORE execution
and raises the reference's analysis errors (defs_binops.go semantics,
verified case-by-case against the conformance corpus):

- ``= !=``  operand type families must match ("types 'int' and
  'bool' are not equatable"); numerics (int/id/decimal) mix freely;
  a STRING LITERAL compares against a timestamp column (coerced).
- ``< <= > >=``  operands must each be orderable (numeric or
  timestamp): the first non-orderable operand is reported
  ("operator '<' incompatible with type 'bool'"); orderable but
  mismatched families fall back to the not-equatable error.
- ``& | << >>``  int/id only.
- ``+ - * /``  numerics; result is decimal(max scale) when either
  side is decimal, else int.
- ``%``  int/id only (decimal excluded).
- ``||``  strings only.

NULL literals type-check against anything (comparisons yield UNKNOWN
at runtime).
"""

from __future__ import annotations

from dataclasses import dataclass
from decimal import Decimal

from pilosa_tpu_torch.models import FieldType
from pilosa_tpu_torch.sql import ast
from pilosa_tpu_torch.sql.lexer import SQLError

NUMERIC = ("int", "id", "decimal")
ORDERABLE = NUMERIC + ("timestamp",)


@dataclass
class TInfo:
    kind: str          # int|id|decimal|bool|string|timestamp|idset|
    #                    stringset|null|any
    scale: int = 0     # decimal scale
    literal: bool = False

    def render(self) -> str:
        if self.kind == "decimal":
            return f"decimal({self.scale})"
        return self.kind


_FIELD_KIND = {
    FieldType.INT: "int",
    FieldType.DECIMAL: "decimal",
    FieldType.TIMESTAMP: "timestamp",
    FieldType.BOOL: "bool",
}


def field_tinfo(f) -> TInfo:
    t = f.options.type
    if t in _FIELD_KIND:
        return TInfo(_FIELD_KIND[t], scale=f.options.scale or 0)
    if t == FieldType.MUTEX:
        return TInfo("string" if f.options.keys else "id")
    return TInfo("stringset" if f.options.keys else "idset")


_FUNC_KIND = None  # lazy: FUNC_TYPES from funcs.py


def _func_tinfo(name: str, cast_args=None) -> TInfo:
    global _FUNC_KIND
    if _FUNC_KIND is None:
        from pilosa_tpu_torch.sql.funcs import FUNC_TYPES
        _FUNC_KIND = FUNC_TYPES
    if name == "CAST" and cast_args:
        t = cast_args[1].value if isinstance(cast_args[1], ast.Lit) \
            else "string"
        s = cast_args[2].value if isinstance(cast_args[2], ast.Lit) \
            else 0
        return TInfo(t if t != "decimal" else "decimal", scale=s or 0)
    return TInfo(_FUNC_KIND.get(name, "any"))


class TypeChecker:
    """Bound to one engine + optional index (None for FROM-less
    selects)."""

    def __init__(self, engine, idx=None, extra_cols: dict | None = None):
        self.eng = engine
        self.idx = idx
        # name -> TInfo overrides (join envs, view columns)
        self.extra = extra_cols or {}

    def check(self, e) -> TInfo:
        if e is None:
            return TInfo("null")
        if isinstance(e, ast.Lit):
            return self._lit(e.value)
        if isinstance(e, ast.Var):
            return TInfo("any")
        if isinstance(e, ast.SubQuery):
            return TInfo("any")  # folded at execution time
        if isinstance(e, ast.Col):
            return self._col(e)
        if isinstance(e, ast.Agg):
            return self._check_agg(e)
        if isinstance(e, ast.Func):
            arg_ts = [self.check(x) for x in e.args]
            if e.name.startswith("SETCONTAINS"):
                self._check_setcontains(e, arg_ts)
            elif e.name == "CAST":
                self._check_cast(e, arg_ts)
            elif e.name == "BITNOT":
                # unary ! takes integers (defs_unops: "operator '!'
                # incompatible with type 'decimal(2)'" etc.)
                self._require("!", arg_ts, ("int", "id"))
            udf = self.eng._udf_types().get(e.name) \
                if self.eng is not None else None
            if udf is not None:
                return TInfo(udf if udf != "decimal" else "decimal")
            return _func_tinfo(e.name, e.args if e.name == "CAST"
                               else None)
        if isinstance(e, ast.Not):
            self.check(e.expr)
            return TInfo("bool")
        if isinstance(e, ast.IsNull):
            self.check(e.col)
            return TInfo("bool")
        if isinstance(e, ast.InSelect):
            col_t = self.check(e.col)
            sub = e.select
            # uncorrelated single-column subquery: its output type
            # must be equatable with the probe column (defs_in
            # notInTests_9: id IN (select string-col) errors)
            if self.eng is not None and len(sub.items) == 1 and \
                    isinstance(sub.items[0].expr, ast.Col) and \
                    sub.items[0].expr.name not in ("*",):
                inner_idx = self.eng.holder.index(sub.table)
                if inner_idx is not None:
                    c = sub.items[0].expr
                    inner = TypeChecker(self.eng, inner_idx)
                    self._equatable(
                        col_t, inner._col(ast.Col(c.name)))
            return TInfo("bool")
        if isinstance(e, ast.InList):
            self.check(e.col)
            return TInfo("bool")
        if isinstance(e, ast.Between):
            col = self.check(e.col)
            if col.kind not in ORDERABLE + ("null", "any"):
                # defs_between.go error shape
                raise SQLError(f"type '{col.render()}' cannot be "
                               "used as a range subscript")
            for side in (e.lo, e.hi):
                s = self.check(side)
                self._equatable(col, s)
            return TInfo("bool")
        if isinstance(e, ast.BinOp):
            return self._binop(e)
        return TInfo("any")

    def _check_agg(self, e: ast.Agg) -> TInfo:
        """Aggregate argument analysis (defs_aggregate): COUNT takes
        '*' or a column reference only; _id is barred from
        sum/avg/min/max; sum/avg need a numeric expression."""
        if e.func == "count":
            if e.arg is not None and not isinstance(e.arg, ast.Col):
                raise SQLError("count: column reference expected")
            if isinstance(e.arg, ast.Col) and e.arg.name != "_id":
                self._col(e.arg)
            return TInfo("int")
        argt = self.check(e.arg) if e.arg is not None else TInfo("any")
        if isinstance(e.arg, ast.Col) and e.arg.name == "_id" and \
                e.func in ("sum", "avg", "min", "max", "percentile",
                           "var", "corr"):
            raise SQLError("_id column cannot be used in aggregate "
                           f"function '{e.func}'")
        if e.func == "corr" and isinstance(e.extra, ast.Col) and \
                e.extra.name == "_id":
            raise SQLError("_id column cannot be used in aggregate "
                           "function 'corr'")
        if e.func in ("sum", "avg", "var", "corr") and \
                argt.kind not in NUMERIC + ("null", "any"):
            raise SQLError("integer or decimal expression expected")
        if e.func == "corr" and isinstance(e.extra, ast.Col):
            xt = self._col(e.extra)
            if xt.kind not in NUMERIC + ("null", "any"):
                raise SQLError(
                    "integer or decimal expression expected")
        if e.func in ("avg", "var", "corr"):
            return TInfo("decimal", scale=6 if e.func != "avg" else 4)
        if e.func in ("sum", "min", "max", "percentile"):
            return argt
        return TInfo("any")

    _CASTABLE = {
        # target -> allowed source kinds (defs_cast.go matrix)
        "int": ("int", "id", "bool", "string", "timestamp"),
        "id": ("id", "int", "string"),
        "bool": ("bool", "int", "id", "string"),
        "decimal": ("decimal", "int", "id", "string"),
        "string": ("string", "int", "id", "bool", "decimal",
                   "timestamp", "idset", "stringset"),
        "timestamp": ("timestamp", "int", "string"),
        "idset": ("idset",),
        "stringset": ("stringset",),
    }

    def _check_cast(self, e, arg_ts) -> None:
        if len(arg_ts) != 3 or not isinstance(e.args[1], ast.Lit):
            return
        src, tgt = arg_ts[0], e.args[1].value
        if src.kind in ("null", "any"):
            return
        allowed = self._CASTABLE.get(tgt)
        if allowed is not None and src.kind not in allowed:
            tgt_r = tgt
            if tgt == "decimal" and isinstance(e.args[2], ast.Lit):
                tgt_r = f"decimal({e.args[2].value or 0})"
            raise SQLError(
                f"'{src.render()}' cannot be cast to '{tgt_r}'")

    def _check_setcontains(self, e, arg_ts) -> None:
        """SETCONTAINS* analysis (defs_set_functions
        setParameterTests): arg0 must be a set; SETCONTAINS compares
        a member scalar, ANY/ALL compare a set; element families
        must match."""
        if len(arg_ts) != 2:
            return  # arity handled at evaluation
        s, v = arg_ts
        # set literals validate their members
        for i, x in enumerate(e.args):
            if isinstance(x, ast.Lit) and isinstance(x.value, list):
                vals = x.value
                if any(m is None for m in vals) or not (
                        all(isinstance(m, str) for m in vals) or
                        all(isinstance(m, int) and
                            not isinstance(m, bool) for m in vals)):
                    raise SQLError(
                        "set literal must contain ints or strings")
        if s.kind in ("null", "any"):
            if s.kind == "null":
                raise SQLError("set expression expected")
            return
        if s.kind not in ("idset", "stringset"):
            raise SQLError("set expression expected")
        elem = "string" if s.kind == "stringset" else "id"
        if v.kind in ("any",):
            return
        if e.name == "SETCONTAINS":
            if v.kind == "null":
                raise SQLError(f"types '{s.render()}' and 'void' "
                               "are not equatable")
            if v.kind in ("idset", "stringset") or \
                    self._family(v) != self._family(TInfo(elem)):
                raise SQLError(f"types '{s.render()}' and "
                               f"'{v.render()}' are not equatable")
        else:  # ANY / ALL take a set argument
            if v.kind not in ("idset", "stringset"):
                raise SQLError("set expression expected")
            if isinstance(e.args[1], ast.Lit) and \
                    e.args[1].value == []:
                return  # the empty set matches either family
            velem = "string" if v.kind == "stringset" else "id"
            if self._family(TInfo(elem)) != self._family(TInfo(velem)):
                raise SQLError(f"types '{elem}' and '{velem}' "
                               "are not equatable")

    # -- leaves ---------------------------------------------------------

    def _lit(self, v) -> TInfo:
        import datetime as dtm
        if v is None:
            return TInfo("null", literal=True)
        if isinstance(v, bool):
            return TInfo("bool", literal=True)
        if isinstance(v, int):
            return TInfo("int", literal=True)
        if isinstance(v, Decimal):
            return TInfo("decimal", scale=max(-v.as_tuple().exponent, 0),
                         literal=True)
        if isinstance(v, float):
            return TInfo("decimal", scale=2, literal=True)
        if isinstance(v, str):
            return TInfo("string", literal=True)
        if isinstance(v, dtm.datetime):
            return TInfo("timestamp", literal=True)
        if isinstance(v, list):
            if all(isinstance(x, str) for x in v) and v:
                return TInfo("stringset", literal=True)
            return TInfo("idset", literal=True)
        return TInfo("any", literal=True)

    def _col(self, e: ast.Col) -> TInfo:
        if e.name in self.extra:
            return self.extra[e.name]
        if e.name == "_id":
            if self.idx is None:
                raise SQLError("column not found: _id")
            return TInfo("string" if self.idx.keys else "id")
        if e.name == "*":
            return TInfo("any")
        if self.idx is None:
            raise SQLError(f"column not found: {e.name}")
        f = self.idx.field(e.name)
        if f is None:
            raise SQLError(f"column not found: {e.name}")
        return field_tinfo(f)

    # -- operators ------------------------------------------------------

    @staticmethod
    def _family(t: TInfo) -> str:
        if t.kind in NUMERIC:
            return "num"
        return t.kind

    def _coerced(self, l: TInfo, r: TInfo):
        """Literal coercions before compatibility checks: a LITERAL
        on one side adopts the other side's family where the engine
        coerces at compile time — time strings / epoch ints against
        timestamps (reference coerceValue), numeric strings against
        BSI columns (this engine's documented extension), and
        member scalars against set columns (membership equality)."""
        def adjust(a: TInfo, b: TInfo) -> TInfo:
            if not a.literal:
                return a
            bf = self._family(b)
            if a.kind == "string" and bf in ("timestamp", "num",
                                             "stringset"):
                return TInfo(b.kind, scale=b.scale, literal=True)
            if a.kind == "int" and bf in ("timestamp", "idset"):
                return TInfo(b.kind, literal=True)
            # a bracket/tuple set literal matches either set family
            if a.kind in ("idset", "stringset") and \
                    bf in ("idset", "stringset"):
                return TInfo(b.kind, literal=True)
            return a
        return adjust(l, r), adjust(r, l)

    def _equatable(self, l: TInfo, r: TInfo):
        if "null" in (l.kind, r.kind) or "any" in (l.kind, r.kind):
            return
        l, r = self._coerced(l, r)
        if self._family(l) == self._family(r):
            return
        raise SQLError(f"types '{l.render()}' and '{r.render()}' "
                       "are not equatable")

    def _require(self, op: str, sides: list[TInfo], kinds: tuple):
        for s in sides:
            if s.kind in ("null", "any"):
                continue
            if s.kind not in kinds:
                raise SQLError(f"operator '{op}' incompatible "
                               f"with type '{s.render()}'")

    def _binop(self, e: ast.BinOp) -> TInfo:
        op = e.op
        l, r = self.check(e.left), self.check(e.right)
        OPS = op.upper() if op in ("and", "or") else op
        if op in ("and", "or"):
            self._require(OPS, [l, r], ("bool",))
            return TInfo("bool")
        if op in ("=", "!="):
            self._equatable(l, r)
            return TInfo("bool")
        if op in ("<", "<=", ">", ">="):
            lc, rc = self._coerced(l, r)
            self._require(op, [lc, rc], ORDERABLE)
            self._equatable(lc, rc)
            return TInfo("bool")
        if op in ("&", "|", "<<", ">>"):
            self._require(op, [l, r], ("int", "id"))
            return TInfo("int")
        if op == "%":
            self._require(op, [l, r], ("int", "id"))
            return TInfo("int")
        if op in ("+", "-", "*", "/"):
            self._require(op, [l, r], NUMERIC)
            if "decimal" in (l.kind, r.kind):
                return TInfo("decimal", scale=max(l.scale, r.scale))
            return TInfo("int")
        if op == "||":
            self._require(op, [l, r], ("string",))
            return TInfo("string")
        if op == "like":
            self._require("LIKE", [l, r], ("string",))
            return TInfo("bool")
        return TInfo("any")


def check_select(eng, idx, stmt, items) -> None:
    """Type-check a SELECT's expressions against the schema (the
    analyze pass the reference runs before planning)."""
    tc = TypeChecker(eng, idx)
    for it in items:
        tc.check(it.expr)
    if stmt.where is not None:
        tc.check(stmt.where)
    for ob in stmt.order_by:
        e = ob.expr
        if isinstance(e, ast.Lit):
            continue  # projection ordinal
        if isinstance(e, ast.Col) and (
                idx is None or (e.name != "_id"
                                and idx.field(e.name) is None)):
            continue  # projection alias — resolved against outputs
        t = tc.check(e)
        if t.kind in ("idset", "stringset"):
            # defs_orderby: sets are not orderable
            raise SQLError("unable to sort a column of type "
                           f"'{t.render()}'")
