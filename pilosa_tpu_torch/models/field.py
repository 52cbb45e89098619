"""Field — a typed column of the index (field.go:73).

Types: set, int, time, mutex, bool, decimal, timestamp (field.go:43-49).
Set-like types write rows into the standard view (plus time-quantum
views for time fields); BSI types (int, decimal, timestamp) write
sign-magnitude bit-planes into a ``bsig_<field>`` view.  Mutex keeps one
row per column; bool is a two-row mutex (false=0, true=1).

A ``keys=True`` field translates string row keys to row ids through its
own sequential ``TranslateStore`` (``row_translator``), whose log is
``<path>/keys.jsonl`` when the field has a path.  Given the index's
``storage``, the field's fragments load from and sync to its RBF files.
"""

from __future__ import annotations

import datetime as dt
import os
import threading

import numpy as np

from pilosa_tpu_torch.models import timeq
from pilosa_tpu_torch.models.schema import FieldOptions, FieldType
from pilosa_tpu_torch.models.view import (
    VIEW_BSI_PREFIX,
    VIEW_STANDARD,
    View,
    bsi_view_name,
)
from pilosa_tpu_torch.ops.bsi import depth_for_range
from pilosa_tpu_torch.shardwidth import SHARD_WIDTH
from pilosa_tpu_torch.storage.translate import TranslateStore

FALSE_ROW, TRUE_ROW = 0, 1  # bool field rows (field.go falseRowID/trueRowID)


def _shard_groups(shards: np.ndarray):
    """(shard, lo, hi) runs of a stable sort by shard id; returns the
    sort order too."""
    order = np.argsort(shards, kind="stable")
    sh = shards[order]
    starts = np.flatnonzero(np.r_[True, sh[1:] != sh[:-1]]) if sh.size \
        else np.array([], dtype=np.int64)
    bounds = np.append(starts[1:], sh.size)
    return order, zip(sh[starts].tolist(), starts.tolist(), bounds.tolist())


class Field:
    def __init__(self, index: str, name: str,
                 options: FieldOptions | None = None,
                 width: int = SHARD_WIDTH, path: str | None = None,
                 storage=None):
        self.index_name = index
        self.name = name
        self.options = options or FieldOptions()
        self.width = width
        self.path = path
        self.storage = storage
        self.views: dict[str, View] = {}
        self._row_translator: TranslateStore | None = None
        self._lock = threading.RLock()
        # BSI depth grows with observed magnitudes (bsiGroup, field.go:2394)
        if self.options.type.is_bsi:
            lo, hi = self.options.min, self.options.max
            self.bit_depth = (depth_for_range(lo, hi)
                              if lo is not None and hi is not None else 1)
        else:
            self.bit_depth = 0

    # -- views -------------------------------------------------------------

    def view(self, name: str, create: bool = False) -> View | None:
        with self._lock:
            v = self.views.get(name)
            if v is None and create:
                # TopN caches attach to row views of set-like fields only
                cache_type = self.options.cache_type
                if (name.startswith(VIEW_BSI_PREFIX)
                        or self.options.type == FieldType.BOOL):
                    cache_type = "none"
                v = View(self.index_name, self.name, name, self.width,
                         storage=self.storage, cache_type=cache_type,
                         cache_size=self.options.cache_size)
                self.views[name] = v
            return v

    def delete_view(self, name: str) -> bool:
        """Drop a view and its bitmaps on disk; True if it existed."""
        with self._lock:
            if self.views.pop(name, None) is None:
                return False
            if self.storage is not None:
                self.storage.delete_view_bitmaps(self.name, name)
            return True

    @property
    def bsi_view(self) -> str:
        return bsi_view_name(self.name)

    @property
    def row_translator(self) -> TranslateStore | None:
        """The row-key store of a keys=True field (field.go's per-field
        TranslateStore), made at first use; None on an unkeyed field."""
        if not self.options.keys:
            return None
        with self._lock:
            if self._row_translator is None:
                tpath = (os.path.join(self.path, "keys.jsonl")
                         if self.path else None)
                self._row_translator = TranslateStore(
                    tpath, index=self.index_name, partition_id=-1)
            return self._row_translator

    def close(self) -> None:
        if self._row_translator is not None:
            self._row_translator.close()
            self._row_translator = None

    def to_dict(self) -> dict:
        return {"name": self.name, "options": self.options.to_dict()}

    @property
    def available_shards(self) -> set[int]:
        s: set[int] = set()
        for v in self.views.values():
            s.update(v.fragments)
        return s

    # -- typed values --------------------------------------------------------

    def value_to_int(self, value) -> int:
        """A user value as the stored BSI integer."""
        t = self.options.type
        if t == FieldType.DECIMAL:
            from decimal import Decimal
            from fractions import Fraction
            if isinstance(value, (str, float)):
                value = Decimal(str(value))
            # exact scaling; finer inputs round half-even
            return round(Fraction(value) * (10 ** self.options.scale))
        if t == FieldType.TIMESTAMP:
            if isinstance(value, str):
                value = timeq.parse_time_ns(value)
            elif isinstance(value, (int, float)) and \
                    not isinstance(value, bool):
                # integer literals are epoch seconds whatever the unit
                value = timeq.parse_time(int(value))
            if isinstance(value, dt.datetime):
                return self.options.timestamp_to_int(value)
        return int(value)

    def int_to_value(self, v: int):
        t = self.options.type
        if t == FieldType.DECIMAL:
            from decimal import Decimal
            return Decimal(int(v)).scaleb(-self.options.scale)
        if t == FieldType.TIMESTAMP:
            return self.options.int_to_timestamp(v)
        return v

    def _grow_depth(self, magnitude: int):
        self.bit_depth = max(self.bit_depth,
                             max(1, int(magnitude).bit_length()))

    # -- writes --------------------------------------------------------------

    def set_bit(self, row: int, col: int,
                timestamp: dt.datetime | None = None) -> bool:
        """Set (row, col) in the standard view and, for a time field
        with a timestamp, in each of its quantum views."""
        t = self.options.type
        if t == FieldType.BOOL and row not in (FALSE_ROW, TRUE_ROW):
            raise ValueError("bool field rows must be 0 or 1")
        shard, shard_col = divmod(col, self.width)
        view_names = [VIEW_STANDARD]
        if t == FieldType.TIME and timestamp is not None:
            view_names += timeq.views_by_time(
                VIEW_STANDARD, timestamp, self.options.time_quantum)
        changed = False
        for vn in view_names:
            frag = self.view(vn, create=True).fragment(shard, create=True)
            if t in (FieldType.MUTEX, FieldType.BOOL):
                for other in frag.row_ids:
                    if other != row:
                        frag.clear_bit(other, shard_col)
            changed |= frag.set_bit(row, shard_col)
        return changed

    def clear_bit(self, row: int, col: int) -> bool:
        shard, shard_col = divmod(col, self.width)
        changed = False
        for v in self.views.values():
            frag = v.fragment(shard)
            if frag is not None:
                changed |= frag.clear_bit(row, shard_col)
        return changed

    def set_value(self, col: int, value) -> bool:
        iv = self.value_to_int(value)
        self._grow_depth(abs(iv))
        shard, shard_col = divmod(col, self.width)
        frag = self.view(self.bsi_view, create=True).fragment(
            shard, create=True)
        return frag.set_value(shard_col, self.bit_depth, iv)

    def clear_value(self, col: int) -> bool:
        """Drop a column's BSI value (every plane); True if it held one
        bit or more."""
        shard, shard_col = divmod(col, self.width)
        v = self.view(self.bsi_view)
        frag = v.fragment(shard) if v else None
        return frag.clear_value(shard_col, self.bit_depth) if frag else False

    def import_values(self, cols, values, clear: bool = False) -> None:
        """Bulk BSI import, grouped by shard.  ``clear`` drops the values
        at the given columns instead (the bulk clear_value; values are
        ignored)."""
        cols = np.asarray(cols, dtype=np.int64)
        if clear:
            v = self.view(self.bsi_view)
            if v is None or cols.size == 0:
                return
            order, groups = _shard_groups(cols // self.width)
            cols_s = cols[order]
            for shard, lo, hi in groups:
                frag = v.fragment(int(shard))
                if frag is not None:
                    frag.import_values(cols_s[lo:hi] % self.width, None,
                                       self.bit_depth, clear=True)
            return
        va = np.asarray(values)
        if va.dtype.kind in "iu" and self.options.type == FieldType.INT:
            ivs = va.astype(np.int64)
        else:
            ivs = np.asarray([self.value_to_int(v) for v in values],
                             dtype=np.int64)
        if cols.size == 0:
            return
        mags = np.where(ivs < 0, np.negative(ivs), ivs).view(np.uint64)
        self._grow_depth(int(mags.max()))
        view = self.view(self.bsi_view, create=True)
        order, groups = _shard_groups(cols // self.width)
        cols_s, ivs_s = cols[order], ivs[order]
        for shard, lo, hi in groups:
            view.fragment(int(shard), create=True).import_values(
                cols_s[lo:hi] % self.width, ivs_s[lo:hi], self.bit_depth)

    def import_bits(self, rows, cols, timestamps=None,
                    clear: bool = False) -> None:
        """Bulk set-bit import, grouped by shard (plus time views).
        ``clear`` clears the (row, col) pairs in every view instead (the
        bulk clear_bit)."""
        rows = np.asarray(rows, dtype=np.int64)
        cols = np.asarray(cols, dtype=np.int64)
        if clear:
            order, groups = _shard_groups(cols // self.width)
            rows_s, cols_s = rows[order], cols[order]
            for shard, lo, hi in groups:
                for v in self.views.values():
                    frag = v.fragment(int(shard))
                    if frag is not None:
                        frag.import_bits(rows_s[lo:hi],
                                         cols_s[lo:hi] % self.width,
                                         clear=True)
            return
        mutexish = self.options.type in (FieldType.MUTEX, FieldType.BOOL)
        order, groups = _shard_groups(cols // self.width)
        rows_s, cols_s = rows[order], cols[order]
        view = self.view(VIEW_STANDARD, create=True)
        for shard, lo, hi in groups:
            frag = view.fragment(int(shard), create=True)
            imp = frag.import_mutex if mutexish else frag.import_bits
            imp(rows_s[lo:hi], cols_s[lo:hi] % self.width)
        if self.options.type == FieldType.TIME and timestamps is not None:
            for r, c, ts in zip(rows, cols, timestamps):
                if ts is not None:
                    self.set_bit(int(r), int(c),
                                 timestamp=timeq.parse_time(ts))

    # -- reads ---------------------------------------------------------------

    def views_for_range(self, from_=None, to=None) -> list[str]:
        """Existing views to union for Row(field=x, from=..., to=...)."""
        if from_ is None and to is None:
            return [VIEW_STANDARD]
        if self.options.type != FieldType.TIME:
            raise ValueError(f"field {self.name} is not a time field; "
                             "from/to not supported")
        spans = [s for v in self.views
                 if v.startswith(VIEW_STANDARD + "_")
                 and (s := timeq.view_time_range(v)) is not None]
        if not spans:
            return []
        # open bounds clamp to the span of the existing quantum views
        start = (timeq.parse_time(from_) if from_ is not None
                 else min(s[0] for s in spans))
        end = (timeq.parse_time(to) if to is not None
               else max(s[1] for s in spans))
        return [v for v in timeq.views_by_time_range(
            VIEW_STANDARD, start, end, self.options.time_quantum)
            if v in self.views]
