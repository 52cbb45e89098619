"""Time-quantum view naming (behavioural port of time.go:75-271).

A time field materialises one view per quantum unit per written
timestamp (``standard_2006``, ``standard_200601``, ...).  Range queries
cover [start, end) with a minimal view set: walk up from the smallest
unit until aligned to the next larger one, cover the middle with the
largest units, then walk back down.
"""

from __future__ import annotations

import datetime as dt
import re as _re

from pilosa_tpu_torch.models.schema import TimeQuantum

_FMT = {"Y": "%Y", "M": "%Y%m", "D": "%Y%m%d", "H": "%Y%m%d%H"}
_UNIT_BY_LEN = {4: "Y", 6: "M", 8: "D", 10: "H"}
_UNIT_ORDER = "YMDH"  # coarse -> fine

TIME_FORMAT = "%Y-%m-%dT%H:%M"  # pql time literal format (time.go TimeFormat)

# The [timeq] switches, with the JAX package's defaults.  They are set
# through configure() only: the port reads no environment variable for
# them, as its other engine switches (Executor.use_stacked,
# StackedEngine.onepass_arm) are attributes.
#
# write-finest: a TIME write lands in the standard view and the finest
# quantum unit only, plus any coarser view of its time that already
# exists; the coarse views fold from the fine ones at rollup
# (Field.rollup_views).  Off: every unit is written.
_WRITE_FINEST = False
# qcover: a time range over more than one view plans as a ("qcover",
# ...) node of single-view stack leaves, unioned in the program, so a
# rolling window builds only the view that entered and a write at the
# live edge dirties one leaf.  Off: one multi-view leaf, ORed on the
# host, for the whole cover.
_QCOVER = True
# rollup: whether the maintenance tick folds completed fine views into
# their coarser parents (Holder.rollup_views).
_ROLLUP = False


def configure(write_finest: bool | None = None,
              rollup: bool | None = None,
              qcover: bool | None = None) -> None:
    """Set the [timeq] switches; None leaves a switch as it is."""
    global _WRITE_FINEST, _ROLLUP, _QCOVER
    if write_finest is not None:
        _WRITE_FINEST = bool(write_finest)
    if rollup is not None:
        _ROLLUP = bool(rollup)
    if qcover is not None:
        _QCOVER = bool(qcover)


def write_finest() -> bool:
    return _WRITE_FINEST


def rollup_enabled() -> bool:
    return _ROLLUP


def qcover() -> bool:
    return _QCOVER


def view_unit(view_name: str) -> str | None:
    """Quantum unit ("Y"/"M"/"D"/"H") of a time view name, None for
    other views (the suffix-length twin of view_time_range)."""
    _, _, suffix = view_name.rpartition("_")
    if not suffix.isdigit():
        return None
    return _UNIT_BY_LEN.get(len(suffix))


def finer_units(quantum: str, unit: str) -> str:
    """The units of ``quantum`` strictly finer than ``unit``, coarse
    first: a suffix of a valid quantum, hence valid itself."""
    i = _UNIT_ORDER.index(unit)
    return "".join(u for u in str(quantum) if _UNIT_ORDER.index(u) > i)


def view_by_time_unit(name: str, t: dt.datetime, unit: str) -> str:
    return f"{name}_{t.strftime(_FMT[unit])}"


def views_by_time(name: str, t: dt.datetime, q: TimeQuantum) -> list[str]:
    """All quantum views a write at time t lands in (time.go viewsByTime)."""
    return [view_by_time_unit(name, t, unit) for unit in q]


def _add_month(t: dt.datetime) -> dt.datetime:
    # time.go addMonth: avoid Jan 31 + 1mo = Mar 2 normalization.
    if t.day > 28:
        t = t.replace(day=1, minute=0, second=0, microsecond=0)
    y, m = (t.year + 1, 1) if t.month == 12 else (t.year, t.month + 1)
    try:
        return t.replace(year=y, month=m)
    except ValueError:  # e.g. Feb 30 — Go normalizes; days<=28 never hit this
        return t.replace(year=y, month=m, day=28)


def _add_year(t: dt.datetime) -> dt.datetime:
    try:
        return t.replace(year=t.year + 1)
    except ValueError:  # Feb 29 on a leap year (Go normalizes to Mar 1)
        return t.replace(year=t.year + 1, month=3, day=1)


def _next_year_gte(t: dt.datetime, end: dt.datetime) -> bool:
    nxt = _add_year(t)
    return nxt.year == end.year or end > nxt


def _next_month_gte(t: dt.datetime, end: dt.datetime) -> bool:
    nxt = _add_month(t)
    return (nxt.year, nxt.month) == (end.year, end.month) or end > nxt


def _next_day_gte(t: dt.datetime, end: dt.datetime) -> bool:
    nxt = t + dt.timedelta(days=1)
    return (nxt.year, nxt.month, nxt.day) == (end.year, end.month, end.day) \
        or end > nxt


def views_by_time_range(name: str, start: dt.datetime, end: dt.datetime,
                        q: TimeQuantum) -> list[str]:
    """Minimal view set covering [start, end) (time.go viewsByTimeRange)."""
    t = start
    results: list[str] = []

    # Walk up from smallest units to largest units.
    if q.has_hour or q.has_day or q.has_month:
        while t < end:
            if q.has_hour:
                if not _next_day_gte(t, end):
                    break
                elif t.hour != 0:
                    results.append(view_by_time_unit(name, t, "H"))
                    t += dt.timedelta(hours=1)
                    continue
            if q.has_day:
                if not _next_month_gte(t, end):
                    break
                elif t.day != 1:
                    results.append(view_by_time_unit(name, t, "D"))
                    t += dt.timedelta(days=1)
                    continue
            if q.has_month:
                if not _next_year_gte(t, end):
                    break
                elif t.month != 1:
                    results.append(view_by_time_unit(name, t, "M"))
                    t = _add_month(t)
                    continue
            break

    # Walk back down from largest units to smallest units.
    while t < end:
        if q.has_year and _next_year_gte(t, end):
            results.append(view_by_time_unit(name, t, "Y"))
            t = _add_year(t)
        elif q.has_month and _next_month_gte(t, end):
            results.append(view_by_time_unit(name, t, "M"))
            t = _add_month(t)
        elif q.has_day and _next_day_gte(t, end):
            results.append(view_by_time_unit(name, t, "D"))
            t += dt.timedelta(days=1)
        elif q.has_hour:
            results.append(view_by_time_unit(name, t, "H"))
            t += dt.timedelta(hours=1)
        else:
            break

    return results


class NsDatetime(dt.datetime):
    """datetime subclass carrying the full nanosecond fraction in
    ``nsec`` (0..999_999_999).  ``microsecond`` holds the truncated
    value so datetime behavior is unchanged; the extra precision
    exists for timeunit-'ns' columns (the reference stores epoch
    nanoseconds; Go time.Time is ns-precise throughout).

    Comparisons are ns-exact when an NsDatetime is on the LEFT (or
    both sides); a plain datetime on the left compares at its own
    microsecond precision — Python only consults the right operand
    when the left returns NotImplemented."""

    nsec = 0

    @classmethod
    def wrap(cls, d: dt.datetime, nsec: int) -> "NsDatetime":
        nd = cls(d.year, d.month, d.day, d.hour, d.minute, d.second,
                 nsec // 1000, tzinfo=d.tzinfo)
        nd.nsec = nsec
        return nd

    @staticmethod
    def _key(d: dt.datetime):
        # a PLAIN datetime base — replace() would keep the subclass
        # and recurse through these very comparison methods
        base = dt.datetime(d.year, d.month, d.day, d.hour, d.minute,
                           d.second, 0, tzinfo=d.tzinfo)
        return (base, ns_of(d))

    def __eq__(self, other):
        if not isinstance(other, dt.datetime):
            return NotImplemented
        return self._key(self) == self._key(other)

    def __ne__(self, other):
        eq = self.__eq__(other)
        return NotImplemented if eq is NotImplemented else not eq

    def __lt__(self, other):
        if not isinstance(other, dt.datetime):
            return NotImplemented
        return self._key(self) < self._key(other)

    def __le__(self, other):
        if not isinstance(other, dt.datetime):
            return NotImplemented
        return self._key(self) <= self._key(other)

    def __gt__(self, other):
        if not isinstance(other, dt.datetime):
            return NotImplemented
        return self._key(self) > self._key(other)

    def __ge__(self, other):
        if not isinstance(other, dt.datetime):
            return NotImplemented
        return self._key(self) >= self._key(other)

    # µs-level hash so an NsDatetime with a whole-µs fraction hashes
    # like the plain datetime it equals
    __hash__ = dt.datetime.__hash__


def ns_of(d: dt.datetime) -> int:
    """Full fractional nanoseconds of a datetime (exact for
    NsDatetime, microsecond-derived otherwise — including NsDatetime
    copies from .replace()/arithmetic, which drop the instance
    attribute back to the class default of 0)."""
    ns = getattr(d, "nsec", 0)
    return ns if ns else d.microsecond * 1000


def parse_time_ns(v) -> dt.datetime:
    """parse_time plus full fractional precision: 7-9 fractional
    digits survive into an NsDatetime (fromisoformat truncates them
    to microseconds)."""
    import re as _re
    d = parse_time(v)
    if isinstance(v, str):
        m = _re.search(r"\.(\d{7,9})(?=Z|[+-]\d\d:?\d\d|$)", v)
        if m:
            frac = (m.group(1) + "000000000")[:9]
            return NsDatetime.wrap(d, int(frac))
    return d


def parse_time(v) -> dt.datetime:
    """Parse a PQL time literal (time.go parseTime/parsePartialTime).

    Accepts "2006-01-02T15:04", partial forms ("2006", "2006-01",
    "2006-01-02", "2006-01-02T15"), and unix seconds as int.
    """
    if isinstance(v, dt.datetime):
        return v
    if isinstance(v, (int, float)):
        return dt.datetime.fromtimestamp(int(v), tz=dt.timezone.utc).replace(
            tzinfo=None)
    s = str(v)
    # RFC3339 forms: trailing Z / ±hh:mm offsets and fractional
    # seconds normalize to naive UTC (time.go parses RFC3339; all
    # engine timestamps are UTC-naive internally)
    if "T" in s and (s.endswith("Z") or "+" in s[10:]
                     or "-" in s[10:] or "." in s):
        try:
            iso = s.replace("Z", "+00:00")
            # pre-3.11 fromisoformat demands exactly 3 or 6
            # fractional digits; normalize to 6 (sub-microsecond
            # digits carry via parse_time_ns's NsDatetime wrapper)
            iso = _re.sub(
                r"\.(\d+)",
                lambda m: "." + (m.group(1) + "000000")[:6], iso,
                count=1)
            d = dt.datetime.fromisoformat(iso)
            if d.tzinfo is not None:
                d = d.astimezone(dt.timezone.utc).replace(tzinfo=None)
            return d
        except ValueError:
            pass
    for fmt in (TIME_FORMAT, "%Y-%m-%dT%H:%M:%S", "%Y-%m-%dT%H",
                "%Y-%m-%d", "%Y-%m", "%Y"):
        try:
            return dt.datetime.strptime(s, fmt)
        except ValueError:
            continue
    raise ValueError(f"cannot parse time {v!r}")


def view_time_range(view_name: str) -> tuple[dt.datetime, dt.datetime] | None:
    """(start, end) span of a quantum view name, None for non-time
    views (time.go timeOfView): ``standard_2006`` covers the year,
    ``standard_20060102`` the day, etc."""
    _, _, suffix = view_name.rpartition("_")
    if not suffix.isdigit():
        return None
    fmts = {4: "%Y", 6: "%Y%m", 8: "%Y%m%d", 10: "%Y%m%d%H"}
    fmt = fmts.get(len(suffix))
    if fmt is None:
        return None
    try:
        start = dt.datetime.strptime(suffix, fmt)
    except ValueError:
        return None
    if len(suffix) == 4:
        end = start.replace(year=start.year + 1)
    elif len(suffix) == 6:
        end = _add_month(start)
    elif len(suffix) == 8:
        end = start + dt.timedelta(days=1)
    else:
        end = start + dt.timedelta(hours=1)
    return start, end
