"""Batch — the client-side columnar batcher.

The reference's batch/batch.go (``RecordBatch`` :55, ``Batch.Add``
:459, ``Import`` :753, ``doTranslation`` :860): gather up to ``size``
records, translate every unresolved key in one call a store, then group
by field and send one import a field.  A missing or None value sets no
bit; a set field takes a scalar or a list; int, decimal and timestamp
fields take values; a time field takes each record's timestamp; mutex
and bool fields keep one row a column, as the engine's field type
does.  ``add_columns`` takes whole numpy columns instead of records.
"""

from __future__ import annotations

from dataclasses import dataclass, field as _f
from typing import Any


@dataclass
class Record:
    """One ingested record: an id (int or string key) + field values."""
    id: Any
    values: dict[str, Any] = _f(default_factory=dict)
    time: Any = None  # per-record timestamp for time fields


class Batch:
    """Accumulates records and imports them per field on flush."""

    def __init__(self, importer, index: str, schema: dict,
                 size: int = 1 << 16, index_keys: bool = False):
        """schema: {field_name: {"type": ..., "keys": bool}} — the
        subset of the index's fields this batch feeds."""
        self.importer = importer
        self.index = index
        self.schema = schema
        self.size = size
        self.index_keys = index_keys
        self._records: list[Record] = []
        self.imported = 0

    def __len__(self):
        return len(self._records)

    # -- columnar fast path --------------------------------------------

    def add_columns(self, ids, columns: dict) -> None:
        """Columnar bulk add: `ids` is an array of record ids and
        `columns` maps field name -> aligned value array (None cells
        = NULL).  The whole chunk stays numpy end-to-end — no
        per-record dicts — which is what sustains the reference's
        1B-row able ingest rate (batch.go:459's row-major loop is
        amortized by Go; in Python the columnar form is the only way
        to keep up).  Flushes immediately, independent of the
        row-major buffer."""
        import numpy as np
        ids = np.asarray(ids)
        if self.index_keys:
            keys = [str(k) for k in ids.tolist()]
            uniq = sorted(set(keys))
            mapping = self.importer.create_keys(self.index, None, uniq)
            cols = np.array([mapping[k] for k in keys],
                            dtype=np.int64)
        else:
            cols = ids.astype(np.int64)
        for fname, vals in columns.items():
            fopts = self.schema.get(fname)
            if fopts is None:
                raise KeyError(f"unknown field {fname!r}")
            ftype = fopts.get("type", "set")
            if ftype in ("int", "decimal", "timestamp"):
                arr = np.asarray(vals)
                if arr.dtype.kind in "iuf" and ftype == "int":
                    # numeric arrays ride through untouched
                    self.imported += self.importer.import_values(
                        self.index, fname, cols,
                        arr.astype(np.int64), mark_exists=False)
                    continue
                arr = np.asarray(vals, dtype=object)
                valid = np.array([v is not None for v in arr],
                                 dtype=bool)
                if valid.any():
                    self.imported += self.importer.import_values(
                        self.index, fname, cols[valid].tolist(),
                        arr[valid].tolist(), mark_exists=False)
                continue
            if fopts.get("keys"):
                arr = np.asarray(vals, dtype=object)
                valid = np.array([v is not None for v in arr],
                                 dtype=bool)
                svals = [str(v) for v in arr[valid].tolist()]
                uniq = sorted(set(svals))
                mapping = self.importer.create_keys(
                    self.index, fname, uniq)
                # vectorized key -> id mapping via sorted lookup
                uk = np.array(uniq)
                uv = np.array([mapping[k] for k in uniq],
                              dtype=np.int64)
                rows = uv[np.searchsorted(uk, np.array(svals))]
                self.imported += self.importer.import_bits(
                    self.index, fname, rows.tolist(),
                    cols[valid].tolist(), mark_exists=False)
                continue
            arr = np.asarray(vals)
            if arr.dtype == object:
                valid = np.array([v is not None for v in arr],
                                 dtype=bool)
                rows = arr[valid].astype(np.int64)
                ccols = cols[valid]
            else:
                rows, ccols = arr.astype(np.int64), cols
            if rows.size:
                self.imported += self.importer.import_bits(
                    self.index, fname, rows, ccols,
                    mark_exists=False)
        # existence marked ONCE for the chunk, not once per field
        self.importer.mark_columns_exist(self.index, cols)

    def add(self, rec: Record) -> bool:
        """Add one record; returns True when the batch is now full
        (caller should flush — ErrBatchNowFull behavior batch.go:459)."""
        self._records.append(rec)
        return len(self._records) >= self.size

    def flush(self):
        """Translate keys then import per field (batch.Import :753)."""
        if not self._records:
            return
        recs = self._records
        self._records = []
        ids = self._resolve_ids(recs)
        for fname, fopts in self.schema.items():
            ftype = fopts.get("type", "set")
            if ftype in ("int", "decimal", "timestamp"):
                self._flush_values(fname, recs, ids)
            else:
                self._flush_bits(fname, fopts, recs, ids)

    def _resolve_ids(self, recs) -> list[int]:
        """Record ids → column ids, translating string keys in ONE
        batched call (doTranslation batch.go:860)."""
        if not self.index_keys:
            return [int(r.id) for r in recs]
        keys = sorted({str(r.id) for r in recs})
        mapping = self.importer.create_keys(self.index, None, keys)
        return [mapping[str(r.id)] for r in recs]

    def _flush_bits(self, fname, fopts, recs, ids):
        rows: list[Any] = []
        cols: list[int] = []
        times: list[Any] = []
        has_time = fopts.get("type") == "time"
        for r, col in zip(recs, ids):
            if fname not in r.values or r.values[fname] is None:
                continue
            v = r.values[fname]
            vs = v if isinstance(v, (list, tuple, set)) else [v]
            for one in vs:
                rows.append(one)
                cols.append(col)
                if has_time:
                    times.append(r.time)
        if not cols:
            return
        if fopts.get("keys"):
            mapping = self.importer.create_keys(
                self.index, fname, sorted({str(x) for x in rows}))
            rows = [mapping[str(x)] for x in rows]
        else:
            rows = [_row_id(x) for x in rows]
        self.imported += self.importer.import_bits(
            self.index, fname, rows, cols,
            timestamps=times if has_time else None)

    def _flush_values(self, fname, recs, ids):
        cols = []
        values = []
        for r, col in zip(recs, ids):
            v = r.values.get(fname)
            if v is None:
                continue
            cols.append(col)
            values.append(v)
        if cols:
            self.imported += self.importer.import_values(
                self.index, fname, cols, values)


def _row_id(v) -> int:
    if isinstance(v, bool):
        return 1 if v else 0
    return int(v)
