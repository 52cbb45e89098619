"""Query result types: RowResult (row.go:15, per-shard segments),
ValCount (executor.go:8345), DistinctValues, Pair (cache.go:374, TopN
entries), GroupCount (GroupBy groups), SortedRow (Sort) and
ExtractedTable (Extract).  The dataclasses keep the JAX package's field
names and order, so ``dataclasses.asdict`` of a result equals its."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import numpy as np

from pilosa_tpu_torch.ops import bitmap as bm
from pilosa_tpu_torch.shardwidth import SHARD_WIDTH


class RowResult:
    """A set of columns, held as per-shard packed uint32 segments.  On a
    keyed index the executor sets ``keys``, the column keys in column
    order (None for a column with no key); a set-field Distinct's row
    ids are no columns (``is_row_ids``) and get none."""

    def __init__(self, width: int = SHARD_WIDTH):
        self.width = width
        self.segments: dict[int, np.ndarray] = {}
        self.keys: list[str | None] | None = None
        self.is_row_ids = False

    @classmethod
    def from_columns(cls, cols, width: int = SHARD_WIDTH) -> "RowResult":
        """The RowResult holding the given absolute column ids."""
        r = cls(width)
        cols = np.asarray(sorted(int(c) for c in cols), dtype=np.int64)
        if cols.size:
            shards = cols // width
            for s in np.unique(shards):
                r.segments[int(s)] = bm.from_columns(
                    cols[shards == s] % width, width)
        return r

    def columns(self) -> np.ndarray:
        """Absolute column ids (shard*width + col), ascending."""
        parts = [bm.to_columns(self.segments[s]).astype(np.int64)
                 + s * self.width for s in sorted(self.segments)]
        return (np.concatenate(parts) if parts
                else np.array([], dtype=np.int64))

    def count(self) -> int:
        return int(sum(np.bitwise_count(w).sum()
                       for w in self.segments.values()))

    def shard_words(self, shard: int) -> np.ndarray:
        """One shard's packed words (zeros where it holds no column)."""
        w = self.segments.get(shard)
        return w if w is not None else bm.empty(self.width)

    def __eq__(self, other):
        if not isinstance(other, RowResult):
            return NotImplemented
        return np.array_equal(self.columns(), other.columns())

    def __repr__(self):
        cols = self.columns()
        suffix = "..." if cols.size > 10 else ""
        return f"RowResult({cols[:10].tolist()}{suffix}, n={cols.size})"


@dataclass
class ValCount:
    """Sum result: the value in field units plus the count of columns
    contributing."""
    value: Any = None
    count: int = 0


@dataclass
class Pair:
    """TopN/TopK entry: row id, row key (None on an unkeyed field) and
    count, in the JAX package's field order."""
    id: int = 0
    key: str | None = None
    count: int = 0


@dataclass
class DistinctValues:
    """Distinct over a BSI field: the sorted distinct values."""
    values: list = field(default_factory=list)


@dataclass
class GroupCount:
    """One GroupBy group: [{"field": ..., "row_id": ...}, ...] (with
    "row_key" on a keyed field), its column count, and the aggregate
    with the count of columns feeding it (non-null values)."""
    group: list[dict]
    count: int = 0
    agg: Any = None
    agg_count: Any = None


@dataclass
class SortedRow:
    """Sort result: columns ordered by a BSI field's value, with the
    values alongside."""
    columns: list = field(default_factory=list)
    values: list = field(default_factory=list)


@dataclass
class ExtractedTable:
    """Extract result: the field names and, per column,
    {"column": id, "rows": [one entry per field]} (with "column_key" on
    a keyed index)."""
    fields: list = field(default_factory=list)
    columns: list = field(default_factory=list)


def deserialize_result(call, data, width: int = SHARD_WIDTH):
    """The inverse of ``api.serialize_result`` for one call's JSON form:
    the result object a remote node serialized, so that code expecting
    the rich result types can take a wire result (the JAX package's
    ``executor/results.deserialize_result``)."""
    name = call.name
    if name in ("Count", "IncludesColumn") or isinstance(data, (int, bool)):
        return data
    if name in ("Sum", "Min", "Max"):
        return ValCount(value=data.get("value"), count=data.get("count", 0))
    if name in ("TopN", "TopK"):
        return [Pair(id=p.get("id", 0), count=p.get("count", 0),
                     key=p.get("key")) for p in data]
    if name == "GroupBy":
        return [GroupCount(group=g.get("group", []),
                           count=g.get("count", 0), agg=g.get("agg"),
                           agg_count=g.get("agg_count"))
                for g in data]
    if name == "Distinct":
        if isinstance(data, dict) and "values" in data:
            return DistinctValues(values=list(data["values"]))
        r = RowResult.from_columns(data.get("columns", []), width)
        r.is_row_ids = True
        return r
    if name == "Rows":
        return list(data)
    if name == "Extract":
        return ExtractedTable(fields=list(data.get("fields", [])),
                              columns=list(data.get("columns", [])))
    if name == "Sort":
        return SortedRow(columns=list(data.get("columns", [])),
                         values=list(data.get("values", [])))
    if isinstance(data, dict) and "columns" in data:
        r = RowResult.from_columns(data["columns"], width)
        if data.get("keys") is not None:
            r.keys = list(data["keys"])
        return r
    return data
