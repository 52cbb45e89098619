"""Shared SQL-layer primitives: the result shape, SQL type mapping,
row canonicalization for DISTINCT, and the host-side ORDER BY /
LIMIT helpers every execution path funnels through.

Split out of engine.py: these are pure functions with no
engine state, used by the where-compiler, the statement executor,
and every SELECT strategy.
"""

from __future__ import annotations

import datetime as dt
import math
from dataclasses import dataclass, field as _f

from pilosa_tpu_torch.models import FieldType
from pilosa_tpu_torch.sql import ast
from pilosa_tpu_torch.sql.lexer import SQLError


@dataclass
class SQLResult:
    schema: list = _f(default_factory=list)   # [(name, sql_type)]
    rows: list = _f(default_factory=list)


_SQL_TYPE_FOR_FIELD = {
    FieldType.INT: "int",
    FieldType.DECIMAL: "decimal",
    FieldType.TIMESTAMP: "timestamp",
    FieldType.BOOL: "bool",
}


def declared_fields(idx) -> list:
    """Public fields in CREATE TABLE declaration order (the fields
    dict preserves insertion order) — SQL's `*` expansion and SHOW
    COLUMNS order (defs_keyed select-all; Index.public_fields sorts
    by name instead)."""
    from pilosa_tpu_torch.models.index import EXISTENCE_FIELD
    return [f for n, f in idx.fields.items() if n != EXISTENCE_FIELD]


def sql_type_of(f) -> str:
    """SQL type name for a field (sql3's WireQueryField data types)."""
    t = f.options.type
    if t in _SQL_TYPE_FOR_FIELD:
        return _SQL_TYPE_FOR_FIELD[t]
    if t == FieldType.MUTEX:
        return "string" if f.options.keys else "id"
    # set / time
    return "stringset" if f.options.keys else "idset"


def canon_value(v):
    """Canonical structural form preserving Python equality semantics
    (1 == 1.0 == True must stay ONE distinct row, as a set-of-tuples
    dedup would treat them): numerics canonicalize through Fraction,
    which is exact for ints, bools, floats, and Decimals."""
    from fractions import Fraction
    if isinstance(v, list):
        return ("l", tuple(sorted((canon_value(x) for x in v),
                                  key=repr)))
    if v is None:
        return ("z",)
    if isinstance(v, float) and not math.isfinite(v):
        return ("f", repr(v))  # nan/inf have no Fraction
    if isinstance(v, (bool, int, float)) or \
            type(v).__name__ == "Decimal":
        return ("n", str(Fraction(v)))
    return ("s", str(v))


def distinct_key(row) -> bytes:
    # repr of a nested tuple of tagged values is unambiguous (strings
    # are quoted/escaped), so no delimiter collisions are possible
    return repr(tuple(canon_value(v) for v in row)).encode()


def sorted_nulls_last(indices, key, desc: bool) -> list[int]:
    """Stable sort of index list by key(i), NULLS LAST either
    direction (the Sort pushdown's convention)."""
    nn = [i for i in indices if key(i) is not None]
    nulls = [i for i in indices if key(i) is None]
    nn.sort(key=key, reverse=desc)
    return nn + nulls


def ordinal_index(value: int, n: int) -> int:
    """1-based ORDER BY projection ordinal -> 0-based index."""
    i = value - 1
    if not (0 <= i < n):
        raise SQLError(f"ORDER BY position {value} out of range")
    return i


def is_ordinal(e) -> bool:
    return (isinstance(e, ast.Lit) and isinstance(e.value, int)
            and not isinstance(e.value, bool))


def name_of(it: ast.SelectItem) -> str:
    """Output column name for one projection item."""
    if it.alias:
        return it.alias
    e = it.expr
    if isinstance(e, ast.Col):
        return e.name
    if isinstance(e, ast.Agg):
        inner = e.arg.name if e.arg else "*"
        d = "distinct " if e.distinct else ""
        return f"{e.func}({d}{inner})"
    if isinstance(e, ast.Func):
        return e.name.lower()
    return "expr"


def order_rows(stmt, schema, rows, srcmap=None):
    """Multi-key ORDER BY over materialized rows: stable sorts applied
    last-key-first, NULLS LAST within each key's direction.  `srcmap`
    maps SOURCE column names to projection indexes for outputs
    projected under an alias (`i1 AS c ... ORDER BY i1`,
    defs_groupby)."""
    if not stmt.order_by:
        return rows
    names = [s[0] for s in schema]
    types = [s[1] for s in schema]

    def keyfn(i):
        # timestamp columns may already be RENDERED as RFC3339-Z
        # strings whose lexicographic order diverges from the
        # chronological one once fractions appear ('...41.5Z' sorts
        # before '...41Z'); sort them by instant, not by string
        if types[i] == "timestamp":
            def k(j):
                v = rows[j][i]
                if isinstance(v, str):
                    from pilosa_tpu_torch.models.timeq import (
                        ns_of,
                        parse_time_ns,
                    )
                    try:
                        d = parse_time_ns(v)
                    except ValueError:
                        return v
                    return (d.replace(microsecond=0), ns_of(d))
                if isinstance(v, dt.datetime):
                    from pilosa_tpu_torch.models.timeq import ns_of
                    return (v.replace(microsecond=0), ns_of(v))
                return v
            return k
        return lambda j: rows[j][i]

    rows = list(rows)
    for ob in reversed(stmt.order_by):
        if is_ordinal(ob.expr):
            i = ordinal_index(ob.expr.value, len(names))
            order = sorted_nulls_last(
                range(len(rows)), keyfn(i), ob.desc)
            rows = [rows[j] for j in order]
            continue
        if isinstance(ob.expr, ast.Col) and ob.expr.table:
            name = f"{ob.expr.table}.{ob.expr.name}"
        elif isinstance(ob.expr, ast.Col):
            name = ob.expr.name
        else:
            name = name_of(ast.SelectItem(ob.expr))
        # unqualified names also match a unique qualified projection
        matches = [i for i, n in enumerate(names)
                   if n == name or ("." not in name
                                    and n.split(".")[-1] == name)]
        if not matches and srcmap and name in srcmap:
            matches = [srcmap[name]]
        if len(matches) != 1:
            raise SQLError(
                f"ORDER BY column {name!r} not in projection "
                "(column reference, alias reference or column "
                "position expected)"
                if not matches else
                f"ORDER BY column {name!r} is ambiguous")
        i = matches[0]
        order = sorted_nulls_last(
            range(len(rows)), keyfn(i), ob.desc)
        rows = [rows[j] for j in order]
    return rows


def limit_rows(stmt, rows):
    off = stmt.offset or 0
    if stmt.limit is not None:
        return rows[off:off + stmt.limit]
    return rows[off:] if off else rows


def rfc3339(d: dt.datetime) -> str:
    """RFC3339 with a Z suffix — the reference's timestamp rendering
    (naive datetimes are UTC throughout the engine; Go RFC3339Nano
    trims trailing fraction zeros, so sub-microsecond values render
    their full 9-digit fraction trimmed)."""
    from pilosa_tpu_torch.models.timeq import ns_of
    ns = ns_of(d)
    if d.tzinfo is not None:
        d = d.astimezone(dt.timezone.utc).replace(tzinfo=None)
    if ns % 1000:
        base = d.replace(microsecond=0).isoformat()
        return base + (".%09d" % ns).rstrip("0") + "Z"
    return d.isoformat() + "Z"


def to_sql_value(v):
    """Output rendering: timestamps as RFC3339-Z strings, empty sets
    as NULL."""
    if isinstance(v, dt.datetime):
        return rfc3339(v)
    if isinstance(v, list) and not v:
        # a set column with no members IS NULL (defs_null: `ids1 is
        # null` is true for an empty set; defs_set: setcontains on it
        # yields NULL)
        return None
    return v


def to_env_value(v):
    """Evaluator-environment value: empty sets are NULL, but
    timestamps STAY datetimes so CAST/date functions see the typed
    value, not its rendering."""
    if isinstance(v, list) and not v:
        return None
    return v
