"""SQL scalar functions + row-wise expression evaluator.

Implements the reference's built-in function surface — the case list
in sql3/planner/expressionanalyzercall.go with semantics from
sql3/planner/inbuiltfunctionsstring.go, inbuiltfunctionsdate.go and
inbuiltfunctionsset.go — over Python values, evaluated host-side per
row.  The engine pushes what it can into PQL (SETCONTAINS* become Row
filters; see engine._where) and routes the rest here.

NULL propagates through every function and arithmetic operator
(evaluating to Python None), matching the reference's early
`if argEval == nil return nil` pattern.
"""

from __future__ import annotations

import datetime as dt
from decimal import Decimal

from pilosa_tpu_torch.sql import ast
from pilosa_tpu_torch.sql.lexer import SQLError

# interval codes shared by DATETIMEPART/DATETIMENAME/DATETIMEADD/
# DATETIMEDIFF/DATE_TRUNC (inbuiltfunctionsdate.go:13-24)
_IV_YEAR, _IV_YEARDAY, _IV_MONTH, _IV_DAY = "YY", "YD", "M", "D"
_IV_WEEKDAY, _IV_WEEK, _IV_HOUR, _IV_MIN = "W", "WK", "HH", "MI"
_IV_SEC, _IV_MS, _IV_US, _IV_NS = "S", "MS", "US", "NS"


def _s(v, fn):
    if not isinstance(v, str):
        raise SQLError(f"{fn} expects a string, got {type(v).__name__}")
    return v


def _i(v, fn):
    if isinstance(v, bool) or not isinstance(v, int):
        raise SQLError(f"{fn} expects an integer, got {type(v).__name__}")
    return v


def _ts(v, fn) -> dt.datetime:
    if isinstance(v, dt.datetime):
        return v
    if isinstance(v, int) and not isinstance(v, bool):
        # epoch-seconds coercion (defs_date_functions
        # DateTimePartImplicitIntConversion)
        return dt.datetime(1970, 1, 1) + dt.timedelta(seconds=v)
    if isinstance(v, str):
        try:
            from pilosa_tpu_torch.models.timeq import parse_time_ns
            return parse_time_ns(v)
        except ValueError:
            pass
    raise SQLError(f"{fn} expects a timestamp, got {v!r}")


def _ns_of(d: dt.datetime) -> int:
    from pilosa_tpu_torch.models.timeq import ns_of
    return ns_of(d)


def _with_frac(base: dt.datetime, ns: int) -> dt.datetime:
    """Rebuild a timestamp from a seconds-level base + fractional
    ns."""
    from pilosa_tpu_torch.models.timeq import NsDatetime
    base = base.replace(microsecond=0)
    if ns % 1000:
        return NsDatetime.wrap(base, ns)
    return base.replace(microsecond=ns // 1000)


def _weekday(d: dt.datetime) -> int:
    # Go time.Weekday(): Sunday = 0 (inbuiltfunctionsdate.go uses it)
    return (d.weekday() + 1) % 7


def _part(interval: str, d: dt.datetime):
    iv = interval.upper()
    if iv == _IV_YEAR:
        return d.year
    if iv == _IV_YEARDAY:
        return d.timetuple().tm_yday
    if iv == _IV_MONTH:
        return d.month
    if iv == _IV_DAY:
        return d.day
    if iv == _IV_WEEKDAY:
        return _weekday(d)
    if iv == _IV_WEEK:
        return d.isocalendar()[1]
    if iv == _IV_HOUR:
        return d.hour
    if iv == _IV_MIN:
        return d.minute
    if iv == _IV_SEC:
        return d.second
    if iv == _IV_MS:
        return _ns_of(d) // 10**6
    if iv == _IV_US:
        return _ns_of(d) // 1000
    if iv == _IV_NS:
        return _ns_of(d)
    raise SQLError(f"invalid interval {interval!r}")


def _trunc(interval: str, d: dt.datetime) -> dt.datetime:
    iv = interval.upper()
    if iv == _IV_YEAR:
        return d.replace(month=1, day=1, hour=0, minute=0, second=0,
                         microsecond=0)
    if iv == _IV_MONTH:
        return d.replace(day=1, hour=0, minute=0, second=0, microsecond=0)
    if iv == _IV_DAY:
        return d.replace(hour=0, minute=0, second=0, microsecond=0)
    if iv == _IV_HOUR:
        return d.replace(minute=0, second=0, microsecond=0)
    if iv == _IV_MIN:
        return d.replace(second=0, microsecond=0)
    if iv == _IV_SEC:
        return d.replace(microsecond=0)
    if iv == _IV_MS:
        return _with_frac(d, _ns_of(d) // 10**6 * 10**6)
    if iv == _IV_US:
        return _with_frac(d, _ns_of(d) // 1000 * 1000)
    if iv == _IV_NS:
        return d
    raise SQLError(f"invalid interval {interval!r} for DATE_TRUNC")


def _go_adddate(d: dt.datetime, years: int, months: int) -> dt.datetime:
    """Go time.AddDate semantics: overflow days NORMALIZE into the
    next month (Feb 29 + 1y -> Mar 1), they do not clamp."""
    import calendar
    y = d.year + years
    m = d.month - 1 + months
    y, m = y + m // 12, m % 12 + 1
    day = d.day
    dim = calendar.monthrange(y, m)[1]
    while day > dim:
        day -= dim
        m += 1
        if m > 12:
            m, y = 1, y + 1
        dim = calendar.monthrange(y, m)[1]
    return d.replace(year=y, month=m, day=day)


def _add(interval: str, n: int, d: dt.datetime) -> dt.datetime:
    iv = interval.upper()
    frac = _ns_of(d)
    if iv == _IV_YEAR:
        return _with_frac(_go_adddate(d, n, 0), frac)
    if iv == _IV_MONTH:
        return _with_frac(_go_adddate(d, 0, n), frac)
    unit_ns = {_IV_DAY: 86_400 * 10**9,
               _IV_WEEK: 7 * 86_400 * 10**9,
               _IV_HOUR: 3_600 * 10**9,
               _IV_MIN: 60 * 10**9,
               _IV_SEC: 10**9,
               _IV_MS: 10**6,
               _IV_US: 10**3,
               _IV_NS: 1}.get(iv)
    if unit_ns is None:
        raise SQLError(f"invalid interval {interval!r} for DATETIMEADD")
    # integer ns arithmetic so sub-microsecond precision survives
    # (Go time.Time is ns-precise; defs_date_functions datetimeadd
    # NS cases)
    carry, frac = divmod(frac + n * unit_ns, 10**9)
    return _with_frac(d.replace(microsecond=0)
                      + dt.timedelta(seconds=carry), frac)


def _diff(interval: str, a: dt.datetime, b: dt.datetime) -> int:
    iv = interval.upper()
    if iv == _IV_YEAR:
        return b.year - a.year
    if iv == _IV_MONTH:
        return (b.year - a.year) * 12 + (b.month - a.month)
    td = b - a
    us = (td.days * 86_400_000_000 + td.seconds * 1_000_000
          + td.microseconds)
    div = {_IV_DAY: 86_400_000_000, _IV_WEEK: 7 * 86_400_000_000,
           _IV_HOUR: 3_600_000_000, _IV_MIN: 60_000_000,
           _IV_SEC: 1_000_000, _IV_MS: 1_000, _IV_US: 1}.get(iv)
    if div is None:
        if iv == _IV_NS:
            # exact: include each side's sub-microsecond remainder
            return (us * 1000 + (_ns_of(b) - b.microsecond * 1000)
                    - (_ns_of(a) - a.microsecond * 1000))
        raise SQLError(f"invalid interval {interval!r} for DATETIMEDIFF")
    return int(us // div)


def _as_set(v, fn) -> list:
    if isinstance(v, list):
        return v
    if v is None:
        return []
    return [v]  # single-member set column decoded as a scalar


_TIME_UNITS = {"s": 1, "ms": 1000, "us": 1_000_000, "µs": 1_000_000,
               "ns": 1_000_000_000}


# arity bounds per builtin (lo, hi) — validated BEFORE NULL
# propagation so a bad call errors even when a row supplies NULLs
# (the reference validates arity at analysis time,
# expressionanalyzercall.go)
_ARITY = {
    "UPPER": (1, 1), "LOWER": (1, 1), "REVERSE": (1, 1),
    "TRIM": (1, 1), "LTRIM": (1, 1), "RTRIM": (1, 1), "LEN": (1, 1),
    "ASCII": (1, 1), "CHAR": (1, 1), "SPACE": (1, 1),
    "REPLICATE": (2, 2), "REPLACEALL": (3, 3), "PREFIX": (2, 2),
    "SUFFIX": (2, 2), "SUBSTRING": (2, 3), "CHARINDEX": (2, 3),
    "STRINGSPLIT": (2, 3), "FORMAT": (1, 64), "STR": (1, 3),
    "DATETIMEPART": (2, 2), "DATETIMENAME": (2, 2),
    "DATE_TRUNC": (2, 2), "DATETIMEADD": (3, 3),
    "DATETIMEDIFF": (3, 3), "DATETIMEFROMPARTS": (7, 7),
    "TOTIMESTAMP": (1, 2),
    "SETCONTAINS": (2, 2), "SETCONTAINSANY": (2, 2),
    "SETCONTAINSALL": (2, 2),
    "BITNOT": (1, 1),  # unary ! (defs_unops), ints only
    "CAST": (3, 3),  # (expr, type, scale) — built by the parser
}


def _cast(v, t: str, scale: int):
    """CAST(v AS t) — sql3 castOperand coercions (defs_cast.go
    semantics: numeric/bool/string/timestamp interconvert; set types
    are not castable)."""
    from decimal import ROUND_HALF_EVEN, Decimal

    def no(msg=None):
        raise SQLError(
            msg or f"{type(v).__name__!s} cannot be cast to {t!r}")
    if t in ("idset", "stringset"):
        # identity casts only (defs_cast: sets cast to themselves and
        # to string; static analysis rejects the rest)
        if isinstance(v, list):
            return v
        no()
    if t in ("int", "id"):
        if isinstance(v, bool):
            out = int(v)
        elif isinstance(v, int):
            out = v
        elif isinstance(v, dt.datetime):
            # timestamp -> epoch seconds (defs_cast castTimestamp_0)
            epoch = dt.datetime(1970, 1, 1, tzinfo=v.tzinfo)
            out = int((v - epoch).total_seconds())
        elif isinstance(v, (float, Decimal)):
            out = int(v)  # truncate toward zero
        elif isinstance(v, str):
            try:
                out = int(v)
            except ValueError:
                no(f"cannot cast {v!r} to {t!r}")
        else:
            no()
        if t == "id" and out < 0:
            no("id cannot be negative")
        return out
    if t == "bool":
        if isinstance(v, bool):
            return v
        if isinstance(v, int):
            # any non-zero int is true (defs_cast castInt_1)
            return v != 0
        if isinstance(v, str):
            if v.lower() in ("true", "false"):
                return v.lower() == "true"
            no(f"cannot cast {v!r} to 'bool'")
        no()
    if t == "decimal":
        if isinstance(v, bool):
            v = int(v)
        if isinstance(v, (int, float, str, Decimal)):
            try:
                d = Decimal(str(v))
            except ArithmeticError:
                no(f"cannot cast {v!r} to 'decimal'")
            q = Decimal(1).scaleb(-int(scale))
            return d.quantize(q, rounding=ROUND_HALF_EVEN)
        no()
    if t == "string":
        if isinstance(v, bool):
            return "true" if v else "false"
        if isinstance(v, dt.datetime):
            from pilosa_tpu_torch.sql.common import rfc3339
            return rfc3339(v)
        if isinstance(v, list):
            # idsets render Go-%v style '[101 102]'; stringsets render
            # as a JSON-style quoted list '["a","b"]' (defs_cast
            # castIDSet_5 / castStringSet_5)
            if all(isinstance(m, int) and not isinstance(m, bool)
                   for m in v):
                return "[" + " ".join(str(m) for m in v) + "]"
            return "[" + ",".join(f'"{m}"' for m in v) + "]"
        if isinstance(v, (int, float, Decimal, str)):
            return str(v)
        no()
    if t == "timestamp":
        if isinstance(v, dt.datetime):
            return v
        if isinstance(v, str):
            return _ts(v, "CAST")
        if isinstance(v, int) and not isinstance(v, bool):
            return dt.datetime(1970, 1, 1) + dt.timedelta(seconds=v)
        no()
    raise SQLError(f"unknown cast type {t!r}")


def call_builtin(name: str, args: list):
    """Evaluate one built-in; args are already-evaluated Python values.
    Returns the SQL value (None = NULL)."""
    a = args
    if name == "RANGEQ":
        # push-down only, like the reference (EvaluateRangeQ errors)
        raise SQLError(
            "RANGEQ is only valid as a WHERE filter on a "
            "timequantum column")
    bounds = _ARITY.get(name)
    if bounds is None:
        raise SQLError(f"unknown function {name}")
    lo, hi = bounds
    if not (lo <= len(a) <= hi):
        raise SQLError(
            f"{name} expects {lo}{'' if hi == lo else f'..{hi}'} "
            f"arguments, got {len(a)}")

    # NULL propagation (reference: every Evaluate* returns nil on a
    # nil arg) — for SET* a NULL SET argument is NULL (defs_set
    # setLiteralTests: setcontains(null-set, v) is NULL, not false),
    # while a NULL member argument still probes the set
    if name.startswith("SETCONTAINS"):
        if a and a[0] is None:
            return None
    elif name in ("FORMAT", "STR"):
        # FORMAT/STR: a NULL FIRST argument yields NULL, a NULL in
        # any later argument is an error (defs_string_functions
        # FormatNullString/StrNull vs FormatNullArgument/StrNullArg)
        if a and a[0] is None:
            return None
        if any(x is None for x in a[1:]):
            raise SQLError("null literal not allowed")
    elif any(x is None for x in a):
        return None

    try:
        return _dispatch(name, a)
    except (ValueError, OverflowError) as exc:
        # chr() out of range, %-format with bad spec, calendar
        # overflow, ... — surface as SQL errors, not Python crashes
        raise SQLError(f"{name}: {exc}")


def _dispatch(name: str, a: list):
    # -- string (inbuiltfunctionsstring.go) ---------------------------
    if name == "UPPER":
        return _s(a[0], name).upper()
    if name == "LOWER":
        return _s(a[0], name).lower()
    if name == "REVERSE":
        return _s(a[0], name)[::-1]
    if name == "TRIM":
        return _s(a[0], name).strip()
    if name == "LTRIM":
        return _s(a[0], name).lstrip()
    if name == "RTRIM":
        return _s(a[0], name).rstrip()
    if name == "LEN":
        return len(_s(a[0], name))
    if name == "ASCII":
        s = _s(a[0], name)
        # byte-length semantics (inbuiltfunctionsstring.go): a
        # non-ASCII char is multi-byte in UTF-8 and rejected
        if len(s) != 1 or ord(s) > 127:
            raise SQLError(f"value {s!r} should be of the length 1")
        return ord(s)
    if name == "CHAR":
        v = _i(a[0], name)
        if not (0 <= v <= 255):
            # inbuiltfunctionsstring.go: CHAR is a single byte
            raise SQLError(f"value '{v}' out of range")
        return chr(v)
    if name == "SPACE":
        return " " * _i(a[0], name)
    if name == "REPLICATE":
        n = _i(a[1], name)
        if n < 0:
            raise SQLError("REPLICATE count out of range")
        return _s(a[0], name) * n
    if name == "REPLACEALL":
        return _s(a[0], name).replace(_s(a[1], name), _s(a[2], name))
    if name == "PREFIX":
        s, n = _s(a[0], name), _i(a[1], name)
        if n < 0 or n > len(s):
            raise SQLError("PREFIX length out of range")
        return s[:n]
    if name == "SUFFIX":
        s, n = _s(a[0], name), _i(a[1], name)
        if n < 0 or n > len(s):
            raise SQLError("SUFFIX length out of range")
        return s[len(s) - n:]
    if name == "SUBSTRING":
        s, start = _s(a[0], name), _i(a[1], name)
        if start < 0 or start >= len(s):
            raise SQLError("SUBSTRING start out of range")
        end = start + _i(a[2], name) if len(a) > 2 else len(s)
        if end < start or end > len(s):
            raise SQLError("SUBSTRING length out of range")
        return s[start:end]
    if name == "CHARINDEX":
        # CHARINDEX(substr, str[, pos]) -> 0-based index or -1
        sub, s = _s(a[0], name), _s(a[1], name)
        pos = _i(a[2], name) if len(a) > 2 else 0
        if pos < 0 or (len(a) > 2 and pos >= len(s)):
            raise SQLError("CHARINDEX position out of range")
        r = s.find(sub, pos)
        return r
    if name == "STRINGSPLIT":
        parts = _s(a[0], name).split(_s(a[1], name))
        pos = _i(a[2], name) if len(a) > 2 else 0
        if pos <= 0:
            return parts[0]
        return parts[pos] if pos < len(parts) else ""
    if name == "FORMAT":
        # Go fmt.Sprintf-style; %d/%s/%f/%v/%t subset via
        # %-formatting
        fmt = _s(a[0], name)
        try:
            return fmt.replace("%v", "%s").replace("%t", "%s") % tuple(
                ("true" if x else "false") if isinstance(x, bool)
                else x for x in a[1:])
        except (TypeError, ValueError) as exc:
            raise SQLError(f"FORMAT: {exc}")
    if name == "STR":
        # STR(num[, length[, decimals]]): right-aligned fixed-point;
        # overflow renders as '*' * length (inbuiltfunctionsstring.go
        # EvaluateStr)
        if not isinstance(a[0], (int, float, Decimal)) or \
                isinstance(a[0], bool):
            raise SQLError("STR expects a number")
        length = _i(a[1], name) if len(a) > 1 else 10
        decimals = _i(a[2], name) if len(a) > 2 else 0
        out = f"%{length}.{decimals}f" % float(a[0])
        return "*" * length if len(out) > length else out

    # -- datetime (inbuiltfunctionsdate.go) ---------------------------
    if name == "DATETIMEPART":
        return _part(_s(a[0], name), _ts(a[1], name))
    if name == "DATETIMENAME":
        v = _part(_s(a[0], name), _ts(a[1], name))
        iv = a[0].upper()
        if iv == _IV_MONTH:
            return _ts(a[1], name).strftime("%B")
        if iv == _IV_WEEKDAY:
            d = _ts(a[1], name)
            return ["Sunday", "Monday", "Tuesday", "Wednesday",
                    "Thursday", "Friday", "Saturday"][_weekday(d)]
        return str(v)
    if name == "DATE_TRUNC":
        # returns the truncated PREFIX STRING, not a timestamp
        # ('yy' -> '2012', 'mi' -> '2012-11-01T22:08';
        # defs_date_functions dateTruncTests)
        d = _ts(a[1], name)
        iv = _s(a[0], name).upper()
        fmt = {_IV_YEAR: "%Y", _IV_MONTH: "%Y-%m",
               _IV_DAY: "%Y-%m-%d", _IV_HOUR: "%Y-%m-%dT%H",
               _IV_MIN: "%Y-%m-%dT%H:%M",
               _IV_SEC: "%Y-%m-%dT%H:%M:%S"}.get(iv)
        if fmt is not None:
            return d.strftime(fmt)
        if iv == _IV_MS:
            return d.strftime("%Y-%m-%dT%H:%M:%S.") + \
                f"{d.microsecond // 1000:03d}"
        if iv == _IV_US:
            return d.strftime("%Y-%m-%dT%H:%M:%S.") + \
                f"{d.microsecond:06d}"
        if iv == _IV_NS:
            return d.strftime("%Y-%m-%dT%H:%M:%S.") + \
                f"{_ns_of(d):09d}"
        raise SQLError(f"invalid interval {a[0]!r} for DATE_TRUNC")
    if name == "DATETIMEADD":
        return _add(_s(a[0], name), _i(a[1], name), _ts(a[2], name))
    if name == "DATETIMEDIFF":
        return _diff(_s(a[0], name), _ts(a[1], name), _ts(a[2], name))
    if name == "DATETIMEFROMPARTS":
        y, mo, d, h, mi, s, ms = (_i(x, name) for x in a)
        try:
            return dt.datetime(y, mo, d, h, mi, s, ms * 1000)
        except ValueError as exc:
            raise SQLError(f"DATETIMEFROMPARTS: {exc}")
    if name == "TOTIMESTAMP":
        unit = _s(a[1], name) if len(a) > 1 else "s"
        unit = {"µs": "us"}.get(unit, unit)  # Go's Microsecond alias
        if unit not in _TIME_UNITS:
            raise SQLError(f"invalid time unit {unit!r}")
        # integer math so ns-unit epochs stay exact
        whole, rem = divmod(_i(a[0], name), _TIME_UNITS[unit])
        ns = rem * (10**9 // _TIME_UNITS[unit])
        return _with_frac(dt.datetime(1970, 1, 1)
                          + dt.timedelta(seconds=whole), ns)

    if name == "BITNOT":
        return ~_i(a[0], "!")
    if name == "CAST":
        return _cast(a[0], a[1], a[2])

    # -- set (inbuiltfunctionsset.go) ---------------------------------
    if name == "SETCONTAINS":
        if len(a) != 2:
            raise SQLError("SETCONTAINS expects 2 arguments")
        return a[1] in _as_set(a[0], name)
    if name == "SETCONTAINSANY":
        if len(a) != 2:
            raise SQLError("SETCONTAINSANY expects 2 arguments")
        s = set(_as_set(a[0], name))
        return any(v in s for v in _as_set(a[1], name))
    if name == "SETCONTAINSALL":
        if len(a) != 2:
            raise SQLError("SETCONTAINSALL expects 2 arguments")
        s = set(_as_set(a[0], name))
        return all(v in s for v in _as_set(a[1], name))

    raise SQLError(f"unknown function {name}")


# result SQL type per function (schema typing; expressionanalyzercall.go
# sets ResultDataType the same way)
FUNC_TYPES = {
    "UPPER": "string", "LOWER": "string", "REVERSE": "string",
    "TRIM": "string", "LTRIM": "string", "RTRIM": "string",
    "CHAR": "string", "SPACE": "string", "REPLICATE": "string",
    "REPLACEALL": "string", "PREFIX": "string", "SUFFIX": "string",
    "SUBSTRING": "string", "STRINGSPLIT": "string", "FORMAT": "string",
    "STR": "string", "DATETIMENAME": "string",
    "LEN": "int", "ASCII": "int", "CHARINDEX": "int",
    "DATETIMEPART": "int", "DATETIMEDIFF": "int",
    "DATE_TRUNC": "string", "DATETIMEADD": "timestamp",
    "DATETIMEFROMPARTS": "timestamp", "TOTIMESTAMP": "timestamp",
    "SETCONTAINS": "bool", "SETCONTAINSANY": "bool",
    "SETCONTAINSALL": "bool", "BITNOT": "int",
}


class Evaluator:
    """Row-wise scalar expression evaluator.  `env` maps column name →
    SQL value for the current row; `udfs` maps upper-case name → a
    callable(args)->value (user-defined functions)."""

    def __init__(self, udfs: dict | None = None):
        self.udfs = udfs or {}

    def eval(self, e, env: dict):
        if isinstance(e, ast.Lit):
            return e.value
        if isinstance(e, ast.Col):
            if e.name not in env:
                raise SQLError(f"column not found: {e.name}")
            return env[e.name]
        if isinstance(e, ast.Var):
            key = "@" + e.name
            if key not in env:
                raise SQLError(f"unknown parameter @{e.name}")
            return env[key]
        if isinstance(e, ast.Func):
            args = [self.eval(x, env) for x in e.args]
            udf = self.udfs.get(e.name)
            if udf is not None:
                return udf(args)
            return call_builtin(e.name, args)
        if isinstance(e, ast.BinOp):
            return self._binop(e, env)
        if isinstance(e, ast.Not):
            v = self.eval(e.expr, env)
            return None if v is None else not _truthy(v)
        if isinstance(e, ast.IsNull):
            return (self.eval(e.col, env) is None) != e.negated
        if isinstance(e, ast.InList):
            v = self.eval(e.col, env)
            if v is None:
                return None
            items = e.items
            if isinstance(v, dt.datetime):
                # timestamp IN ('2012-...Z', ...): coerce the list
                items = [_ts(x, "IN") if isinstance(x, str) else x
                         for x in items]
            elif isinstance(v, str) and any(
                    isinstance(x, dt.datetime) for x in items):
                v = _ts(v, "IN")
            hit = v in items
            if not hit and any(x is None for x in items):
                return None  # strict SQL: x IN (..., NULL) is UNKNOWN
            return (not hit) if e.negated else hit
        if isinstance(e, ast.Between):
            v = self.eval(e.col, env)
            lo, hi = self.eval(e.lo, env), self.eval(e.hi, env)
            if v is None or lo is None or hi is None:
                return None
            if isinstance(v, dt.datetime):
                # timestamp BETWEEN string/epoch-int bounds
                # (defs_between); _ts coerces both
                lo = _ts(lo, "BETWEEN") \
                    if not isinstance(lo, dt.datetime) else lo
                hi = _ts(hi, "BETWEEN") \
                    if not isinstance(hi, dt.datetime) else hi
                if v.tzinfo is None:
                    v = v.replace(tzinfo=dt.timezone.utc)
                if lo.tzinfo is None:
                    lo = lo.replace(tzinfo=dt.timezone.utc)
                if hi.tzinfo is None:
                    hi = hi.replace(tzinfo=dt.timezone.utc)
            hit = lo <= v <= hi
            return (not hit) if e.negated else hit
        raise SQLError(f"unsupported expression {e!r}")

    def _binop(self, e: ast.BinOp, env: dict):
        op = e.op
        if op == "and":
            l = self.eval(e.left, env)
            # 3-valued logic: False AND x = False even when x is NULL
            if l is not None and not _truthy(l):
                return False
            r = self.eval(e.right, env)
            if r is not None and not _truthy(r):
                return False
            return None if l is None or r is None else True
        if op == "or":
            l = self.eval(e.left, env)
            if l is not None and _truthy(l):
                return True
            r = self.eval(e.right, env)
            if r is not None and _truthy(r):
                return True
            return None if l is None or r is None else False
        l, r = self.eval(e.left, env), self.eval(e.right, env)
        if l is None or r is None:
            return None
        if op == "||":
            return _s(l, "||") + _s(r, "||")
        if op in ("&", "|", "<<", ">>"):
            li, ri = _i(l, op), _i(r, op)
            if op == "&":
                return li & ri
            if op == "|":
                return li | ri
            if op in ("<<", ">>") and ri < 0:
                raise SQLError(
                    f"operator '{op}': negative shift count {ri}")
            if op == "<<":
                return li << ri
            return li >> ri
        if op in ("+", "-", "*", "/", "%"):
            return _arith(op, l, r)
        if op == "like":
            return _like(l, r)
        # timestamp/string coercion: function results are datetimes,
        # column/literal timestamps are ISO strings — comparisons see
        # both (the reference coerces to timestamp, coerceValue).
        # Naive datetimes are UTC (the engine stores timestamps UTC).
        if isinstance(l, dt.datetime) and isinstance(r, str):
            r = _ts(r, op)
        elif isinstance(r, dt.datetime) and isinstance(l, str):
            l = _ts(l, op)
        if isinstance(l, dt.datetime) and isinstance(r, dt.datetime) \
                and (l.tzinfo is None) != (r.tzinfo is None):
            if l.tzinfo is None:
                l = l.replace(tzinfo=dt.timezone.utc)
            else:
                r = r.replace(tzinfo=dt.timezone.utc)
        if op in ("=", "!="):
            # set columns compare as sets (defs_binops IDSet/StringSet
            # equality); a scalar-decoded single-member set still
            # equals its bracket-literal form
            if isinstance(l, list) or isinstance(r, list):
                ls = set(l) if isinstance(l, list) else {l}
                rs = set(r) if isinstance(r, list) else {r}
                return (ls == rs) if op == "=" else (ls != rs)
            return (l == r) if op == "=" else (l != r)
        try:
            if op == "<":
                return l < r
            if op == "<=":
                return l <= r
            if op == ">":
                return l > r
            return l >= r
        except TypeError:
            raise SQLError(
                f"cannot compare {type(l).__name__} with "
                f"{type(r).__name__}")


def _truthy(v) -> bool:
    if isinstance(v, bool):
        return v
    if isinstance(v, (int, float, Decimal)):
        return v != 0
    raise SQLError(f"expression is not a boolean: {v!r}")


def _num(v, op):
    if isinstance(v, bool) or not isinstance(v, (int, float, Decimal)):
        raise SQLError(f"operator {op} expects numbers, "
                       f"got {type(v).__name__}")
    return v


def _dec_scale(v) -> int:
    return max(-v.as_tuple().exponent, 0) if isinstance(v, Decimal) \
        else 0


def _arith(op, l, r):
    """Arithmetic with the reference's semantics (defs_binops.go):
    int/int division truncates toward zero; any-decimal results
    quantize to the max operand scale (20 / 12.34 -> 1.62 at
    scale 2); zero divisors are analysis-style errors."""
    from decimal import ROUND_DOWN
    l, r = _num(l, op), _num(r, op)
    if r == 0 and op in ("/", "%"):
        raise SQLError("divisor is equal to zero")
    dec = isinstance(l, Decimal) or isinstance(r, Decimal)
    if dec:
        scale = max(_dec_scale(l), _dec_scale(r))
        ld = l if isinstance(l, Decimal) else Decimal(l)
        rd = r if isinstance(r, Decimal) else Decimal(r)
        if op == "+":
            out = ld + rd
        elif op == "-":
            out = ld - rd
        elif op == "*":
            out = ld * rd
        elif op == "/":
            out = ld / rd
        else:
            raise SQLError(
                f"operator '%' incompatible with type "
                f"'decimal({scale})'")
        return out.quantize(Decimal(1).scaleb(-scale),
                            rounding=ROUND_DOWN)
    if op == "+":
        return l + r
    if op == "-":
        return l - r
    if op == "*":
        return l * r
    if op == "/":
        if isinstance(l, int) and isinstance(r, int):
            q = abs(l) // abs(r)  # Go-style trunc-toward-zero
            return q if (l >= 0) == (r >= 0) else -q
        return l / r
    # %
    if isinstance(l, int) and isinstance(r, int):
        return l - r * (abs(l) // abs(r) if (l >= 0) == (r >= 0)
                        else -(abs(l) // abs(r)))
    raise SQLError("operator % expects integers")


def _like(v, pattern) -> bool:
    # SQL scalar LIKE follows the sql3 planner's regex semantics, not
    # the key-filter matcher (sql3/planner/expression.go:2991)
    from pilosa_tpu_torch.pql.like import sql_like_match
    return sql_like_match(_s(v, "LIKE"), _s(pattern, "LIKE"))


def columns_in(e, out: set | None = None) -> set:
    """Collect referenced column names from a scalar expression."""
    if out is None:
        out = set()
    if isinstance(e, ast.Col):
        out.add(e.name)
    elif isinstance(e, ast.Func):
        for x in e.args:
            columns_in(x, out)
    elif isinstance(e, ast.BinOp):
        columns_in(e.left, out)
        columns_in(e.right, out)
    elif isinstance(e, ast.Not):
        columns_in(e.expr, out)
    elif isinstance(e, (ast.IsNull, ast.InList)):
        columns_in(e.col, out)
    elif isinstance(e, ast.Between):
        columns_in(e.col, out)
        columns_in(e.lo, out)
        columns_in(e.hi, out)
    return out
