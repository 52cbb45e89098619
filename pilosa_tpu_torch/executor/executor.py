"""Executor — PQL call dispatch (executor.go:634-843).

``Executor(holder).execute(index, pql)`` parses the query and runs each
call on the stacked engine (``stacked.py``): bitmap calls (Row, Range,
Union, Intersect, Difference, Xor, Not, All, Shift and BSI conditions)
return RowResults; Count, Sum and TopN/TopK reduce per-shard device
partials into exact Python ints; GroupBy runs the one-pass histogram or
the per-combo kernel; Min, Max and BSI Distinct read the value
histogram.  Other calls, and the shapes the JAX package hands to its
host loops, are not ported yet and raise ExecError; nothing falls back
to another engine or to the CPU.

The executor runs on the CUDA card by default and raises when there
is none; ``device="cpu"`` runs the kernels' plain versions on the CPU
(the tests do so).
"""

from __future__ import annotations

import datetime as dt
from decimal import Decimal
from fractions import Fraction
from math import ceil, floor

import numpy as np
import torch

from pilosa_tpu_torch.executor.advanced import AdvancedOps
from pilosa_tpu_torch.executor.results import DistinctValues, RowResult, ValCount
from pilosa_tpu_torch.executor.stacked import ExecError, StackedEngine
from pilosa_tpu_torch.models import timeq
from pilosa_tpu_torch.models.field import FALSE_ROW, TRUE_ROW, Field
from pilosa_tpu_torch.models.holder import Holder
from pilosa_tpu_torch.models.index import Index
from pilosa_tpu_torch.models.schema import FieldType
from pilosa_tpu_torch.ops import kernels
from pilosa_tpu_torch.pql import parse
from pilosa_tpu_torch.pql.ast import Call, Query

__all__ = ["Executor", "ExecError", "resolve_device"]

_BITMAP_CALLS = {"Row", "Range", "Union", "Intersect", "Difference", "Xor",
                 "Not", "All", "Shift"}


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA card, which must exist; anything else
    is taken as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pilosa_tpu_torch runs on the card; pass "
                "device='cpu' to run the kernels' plain versions instead")
        return torch.device("cuda")
    return torch.device(device)


class Executor(AdvancedOps):
    def __init__(self, holder: Holder, device=None):
        self.holder = holder
        self.device = resolve_device(device)
        self.stacked = StackedEngine(self, self.device)

    # -- entry point (executor.Execute analog) -------------------------------

    def execute(self, index_name: str, query: str | Query,
                shards: list[int] | None = None) -> list:
        idx = self.holder.index(index_name)
        if idx is None:
            raise ExecError(f"index not found: {index_name}")
        if idx.keys:
            raise ExecError("keyed indexes are not ported yet")
        q = parse(query) if isinstance(query, str) else query
        return [self._execute_call(idx, c, shards) for c in q.calls]

    def _execute_call(self, idx: Index, call: Call, shards):
        name = call.name
        if name == "Count":
            return self._reduce_count(idx, self._only_child(call), shards)
        if name == "Sum":
            return self._execute_sum(idx, call, shards)
        if name == "TopN":
            return self._execute_topnk(idx, call, shards, "n")
        if name == "TopK":
            return self._execute_topnk(idx, call, shards, "k")
        if name in ("Min", "Max"):
            return self._execute_minmax(idx, call, shards, name == "Min")
        if name == "Distinct":
            return self._execute_distinct(idx, call, shards)
        if name == "GroupBy":
            return self._execute_groupby(idx, call, shards)
        if name in _BITMAP_CALLS:
            return self._bitmap_result(idx, call, shards)
        raise ExecError(f"{name} is not ported yet")

    def _only_child(self, call: Call) -> Call:
        if len(call.children) != 1:
            raise ExecError(f"{call.name} requires exactly one subquery")
        return call.children[0]

    def _shard_list(self, idx: Index, shards) -> list[int]:
        if shards is not None:
            return sorted(shards)
        return sorted(idx.available_shards) or [0]

    # -- bitmap calls --------------------------------------------------------

    def _bitmap_result(self, idx: Index, call: Call, shards) -> RowResult:
        out = RowResult(idx.width)
        shard_list = self._shard_list(idx, shards)
        words = self.stacked.words(idx, call, shard_list)
        if words is not None:
            for i, shard in enumerate(shard_list):
                if words[i].any():
                    out.segments[shard] = words[i]
        return out

    def _row_id_for_value(self, f: Field, val) -> int:
        if isinstance(val, bool):
            if f.options.type != FieldType.BOOL:
                raise ExecError(f"bool row value on non-bool field {f.name}")
            return TRUE_ROW if val else FALSE_ROW
        if isinstance(val, str) or f.options.keys:
            raise ExecError("string row keys are not ported yet")
        if val is None:
            raise ExecError("null row value")
        return int(val)

    # -- BSI predicates ------------------------------------------------------

    def _bsi_field(self, idx: Index, fname: str) -> Field:
        f = idx.field(fname)
        if f is None:
            raise ExecError(f"field not found: {fname}")
        if not f.options.type.is_bsi:
            raise ExecError(f"field {fname} is not an int-like field")
        return f

    def _scaled_bound(self, f: Field, v, round_up: bool) -> int:
        """A predicate bound in stored units, rounded outward per the
        comparison (exact rational arithmetic).  String bounds coerce
        by column type: timestamps on timestamp columns, numbers
        elsewhere."""
        if isinstance(v, str):
            if f.options.type == FieldType.TIMESTAMP:
                try:
                    v = timeq.parse_time_ns(v)
                except ValueError as e:
                    raise ExecError(str(e)) from None
            else:
                try:
                    v = Decimal(v)
                except ArithmeticError:
                    raise ExecError(
                        f"cannot parse numeric bound {v!r}") from None
                if not v.is_finite():
                    raise ExecError(f"numeric bound must be finite: {v!r}")
        if isinstance(v, dt.datetime):
            if f.options.type != FieldType.TIMESTAMP:
                raise ExecError(
                    f"time predicate on {f.options.type.value} field")
            return f.options.timestamp_to_int(v)
        if isinstance(v, bool):
            raise ExecError("bool predicate on int field")
        scale = f.options.scale if f.options.type == FieldType.DECIMAL else 0
        frac = (Fraction(str(v)) if isinstance(v, float)
                else Fraction(v)) * (10 ** scale)
        return ceil(frac) if round_up else floor(frac)

    # -- aggregates ----------------------------------------------------------

    def _reduce_count(self, idx: Index, call: Call, shards) -> int:
        return self.stacked.count(idx, call, self._shard_list(idx, shards))

    def _execute_sum(self, idx: Index, call: Call, shards) -> ValCount:
        fname = call.arg("_field")
        if fname is None:
            raise ExecError("Sum requires field=")
        f = self._bsi_field(idx, fname)
        filter_call = call.children[0] if call.children else None
        total, count = self.stacked.bsi_sum(
            idx, f, filter_call, self._shard_list(idx, shards))
        return ValCount(value=f.int_to_value(total), count=count)

    def _execute_minmax(self, idx: Index, call: Call, shards,
                        is_min: bool) -> ValCount:
        """Min/Max and the count of columns holding it, read off the
        value histogram (one groupby_fused pass over the planes)."""
        fname = call.arg("_field")
        if fname is None:
            raise ExecError(f"{call.name} requires field=")
        f = self._bsi_field(idx, fname)
        filter_call = call.children[0] if call.children else None
        pos, neg = self.stacked.bsi_value_hist(
            idx, f, filter_call, self._shard_list(idx, shards))
        return self._minmax_from_hist(f, pos, neg, is_min)

    @staticmethod
    def _minmax_from_hist(f: Field, pos, neg, is_min: bool) -> ValCount:
        """The extreme nonzero code of the value histogram: negatives
        first for Min, non-negatives first for Max (fragment.min/max
        semantics)."""
        pnz, nnz = np.nonzero(pos)[0], np.nonzero(neg)[0]
        if is_min:
            if nnz.size:
                mag = int(nnz[-1])
                return ValCount(value=f.int_to_value(-mag),
                                count=int(neg[mag]))
            if pnz.size:
                mag = int(pnz[0])
                return ValCount(value=f.int_to_value(mag),
                                count=int(pos[mag]))
        else:
            if pnz.size:
                mag = int(pnz[-1])
                return ValCount(value=f.int_to_value(mag),
                                count=int(pos[mag]))
            if nnz.size:
                mag = int(nnz[0])
                return ValCount(value=f.int_to_value(-mag),
                                count=int(neg[mag]))
        return ValCount(value=None, count=0)

    # -- Distinct / Rows -----------------------------------------------------

    def _execute_distinct(self, idx: Index, call: Call,
                          shards) -> DistinctValues:
        """Distinct over a BSI field: the nonzero codes of the value
        histogram.  Set fields are not ported yet."""
        fname = call.arg("_field")
        if fname is None:
            raise ExecError("Distinct requires field=")
        f = idx.field(fname)
        if f is None:
            raise ExecError(f"field not found: {fname}")
        if not f.options.type.is_bsi:
            raise ExecError("Distinct on a set field is not ported yet")
        pos, neg = self.stacked.bsi_value_hist(
            idx, f, call.children[0] if call.children else None,
            self._shard_list(idx, shards))
        return DistinctValues(values=sorted(
            f.int_to_value(v) for v in kernels.distinct_from_hist(pos, neg)))

    def _rows_ids(self, idx: Index, call: Call, shards) -> list[int]:
        """Row ids of Rows(field) (executeRowsShard basics): column=,
        previous=, limit=, and from=/to= on time fields."""
        fname = call.arg("_field")
        f = idx.field(fname) if fname else None
        if f is None:
            raise ExecError("Rows requires a field")
        if f.options.keys or call.arg("like") is not None:
            raise ExecError("keyed Rows(like=...) and row keys are not "
                            "ported yet")
        column = call.arg("column")
        if column is not None:
            if isinstance(column, str):
                raise ExecError("column keys are not ported yet")
            column = int(column)
        try:
            views = f.views_for_range(call.arg("from"), call.arg("to"))
        except ValueError as e:
            raise ExecError(str(e)) from None
        ids: set[int] = set()
        for shard in self._shard_list(idx, shards):
            if column is not None and column // idx.width != shard:
                continue
            for vn in views:
                v = f.views.get(vn)
                frag = v.fragment(shard) if v else None
                if frag is None:
                    continue
                if column is None:
                    ids.update(frag.row_ids)
                    continue
                c = column % idx.width
                ids.update(r for r in frag.row_ids
                           if (int(frag.row_words(r)[c >> 5]) >> (c & 31)) & 1)
        out = sorted(ids)
        previous = call.arg("previous")
        if previous is not None:
            if isinstance(previous, str):
                raise ExecError("row keys are not ported yet")
            out = [r for r in out if r > int(previous)]
        limit = call.arg("limit")
        if limit is not None:
            out = out[:int(limit)]
        return out
