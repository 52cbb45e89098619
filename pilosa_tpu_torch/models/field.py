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

A time field's quantum views have a lifecycle (time.go:158): views
whose span ended more than ``options.ttl`` seconds ago are removed
(``remove_expired_views``), and under ``timeq.configure(
write_finest=True)`` a write lands in the finest unit only, the coarser
views folding from it at rollup (``rollup_views``); a range over a
coarse view that was never rolled up reads its finer views
(``_refine_cover``).
"""

from __future__ import annotations

import datetime as dt
import itertools
import os
import threading

import numpy as np

from pilosa_tpu_torch.models import timeq
from pilosa_tpu_torch.models.fragment import bump_mutation_epoch
from pilosa_tpu_torch.models.schema import FieldOptions, FieldType, TimeQuantum
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
    starts = np.flatnonzero(np.concatenate(([True], sh[1:] != sh[:-1]))) \
        if sh.size else np.array([], dtype=np.int64)
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
        # (child_view, parent_view) pairs rollup_views already folded:
        # an OR fold is idempotent, the set only spares the copy a tick
        self._rolled: set[tuple[str, str]] = set()
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

    def remove_expired_views(self, now: dt.datetime | None = None,
                             epoch_latch: list | None = None) -> list[str]:
        """Drop the quantum views whose span ended more than
        options.ttl seconds before ``now`` (UTC, naive; the current
        time by default), time.go:158; returns their names.  Every
        fragment of a dropped view bumps its gen, so no device stack or
        tile built from it compares fresh again, and the view's bitmaps
        leave the index's storage, so a reopen does not bring it back.

        ``epoch_latch`` is a one-element latch that a holder's sweep
        shares across fields, so the mutation epoch moves once a sweep,
        before the first gen moves."""
        if self.options.ttl <= 0:
            return []
        now = now or dt.datetime.now(dt.timezone.utc).replace(tzinfo=None)
        removed = []
        latch = epoch_latch if epoch_latch is not None else [False]
        with self._lock:
            for name in list(self.views):
                span = timeq.view_time_range(name)
                if span is None:
                    continue
                if (now - span[1]).total_seconds() > self.options.ttl:
                    v = self.views.pop(name)
                    removed.append(name)
                    if not latch[0]:
                        latch[0] = True
                        bump_mutation_epoch()
                    for fr in v.fragments.values():
                        fr.bump_gen(bump_epoch=False)
                    if self.storage is not None:
                        self.storage.delete_view_bitmaps(self.name, name)
        return removed

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
        if t == FieldType.TIME and timestamp is not None:
            with self._lock:
                # the views are chosen and written under the lock, so a
                # rollup cannot make a parent between the two
                return self._set_bit_views(
                    [VIEW_STANDARD] + self._time_views(timestamp), row,
                    shard, shard_col)
        return self._set_bit_views([VIEW_STANDARD], row, shard, shard_col)

    def _time_views(self, timestamp: dt.datetime) -> list[str]:
        """The quantum views a write at ``timestamp`` lands in: every
        unit of the quantum, or under write-finest the finest unit and
        each coarser view of the time that already exists (rolled up,
        or written before the switch), which must follow late writes
        into its span.  The caller holds the lock."""
        q = self.options.time_quantum
        if not (timeq.write_finest() and len(q) > 1):
            return timeq.views_by_time(VIEW_STANDARD, timestamp, q)
        return [timeq.view_by_time_unit(VIEW_STANDARD, timestamp, q[-1])] + [
            vn for u in q[:-1]
            if (vn := timeq.view_by_time_unit(VIEW_STANDARD, timestamp, u))
            in self.views]

    def _set_bit_views(self, view_names, row: int, shard: int,
                       shard_col: int) -> bool:
        t = self.options.type
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
            self._import_time_views(rows, cols, timestamps)

    def _import_time_views(self, rows, cols, timestamps) -> None:
        """The quantum views of the timestamped pairs, as set_bit routes
        each of them (None: no time): the pairs group by their distinct
        times, each view gathers the pairs of every time it serves, and
        imports them a shard at a time.  A write-finest import makes no
        coarser view, so the views that exist before it are the parents
        every pair sees."""
        # pairs past the end of `timestamps` have no time, and times
        # past the pairs are ignored (the JAX package zips the three)
        times_in = itertools.chain(itertools.islice(timestamps, rows.size),
                                   itertools.repeat(None))
        codes_of: dict = {}
        codes = np.fromiter((codes_of.setdefault(ts, len(codes_of))
                             for ts in times_in), dtype=np.int64,
                            count=rows.size)
        order = np.argsort(codes, kind="stable")
        starts = np.flatnonzero(np.concatenate(
            ([True], np.diff(codes[order]) != 0))) if order.size \
            else np.array([], dtype=np.int64)
        bounds = np.append(starts[1:], order.size)
        times = list(codes_of)
        with self._lock:
            per_view: dict[str, list] = {}
            for lo, hi in zip(starts.tolist(), bounds.tolist()):
                ts = times[int(codes[order[lo]])]
                if ts is None:
                    continue
                for vn in self._time_views(timeq.parse_time(ts)):
                    per_view.setdefault(vn, []).append(order[lo:hi])
            for vn, parts in per_view.items():
                sel = np.sort(np.concatenate(parts))
                grp, groups = _shard_groups(cols[sel] // self.width)
                rows_s, cols_s = rows[sel][grp], cols[sel][grp]
                view = self.view(vn, create=True)
                for shard, lo, hi in groups:
                    view.fragment(int(shard), create=True).import_bits(
                        rows_s[lo:hi], cols_s[lo:hi] % self.width)

    # -- reads ---------------------------------------------------------------

    def row_ids(self) -> list[int]:
        """The row ids set in the standard view in any shard, sorted."""
        v = self.views.get(VIEW_STANDARD)
        if v is None:
            return []
        ids: set[int] = set()
        for frag in v.fragments.values():
            ids.update(frag.row_ids)
        return sorted(ids)

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
        views = timeq.views_by_time_range(
            VIEW_STANDARD, start, end, self.options.time_quantum)
        return self._refine_cover(views, str(self.options.time_quantum))

    def _refine_cover(self, views: list[str], quantum: str) -> list[str]:
        """A quantum cover resolved against the views that exist: a
        missing cover view refines into the next finer units of the
        quantum over its span, recursively.  Under write-finest the
        coarse views exist only after a rollup, so a cover naming an
        unrolled day reads its hours instead of dropping the span; when
        every unit is written this keeps the existing views only."""
        out: list[str] = []
        for v in views:
            if v in self.views:
                out.append(v)
                continue
            span = timeq.view_time_range(v)
            unit = timeq.view_unit(v)
            finer = timeq.finer_units(quantum, unit) if unit else ""
            if span is None or not finer:
                continue  # nothing written there, or not a time view
            sub = timeq.views_by_time_range(
                VIEW_STANDARD, span[0], span[1], TimeQuantum(finer))
            out.extend(self._refine_cover(sub, finer))
        return out

    def rollup_views(self, now: dt.datetime | None = None
                     ) -> list[tuple[str, str]]:
        """Fold completed fine-unit quantum views into their coarser
        parents (the [timeq] rollup): each child view whose span ended
        by ``now`` (UTC, naive; the current time by default) ORs into
        the parent view of the next coarser unit, finest unit first, so
        an hour -> day -> month -> year cascade lands in one pass.
        Returns the (child, parent) pairs folded; a pair folds once."""
        if self.options.type != FieldType.TIME:
            return []
        q = str(self.options.time_quantum)
        if len(q) < 2:
            return []
        now = now or dt.datetime.now(dt.timezone.utc).replace(tzinfo=None)
        folded: list[tuple[str, str]] = []
        with self._lock:
            for child_unit, parent_unit in zip(q[::-1], q[::-1][1:]):
                for vn in sorted(self.views):
                    if timeq.view_unit(vn) != child_unit:
                        continue
                    span = timeq.view_time_range(vn)
                    if span is None or span[1] > now:
                        continue  # the quantum is still open for writes
                    parent = timeq.view_by_time_unit(
                        VIEW_STANDARD, span[0], parent_unit)
                    if (vn, parent) in self._rolled:
                        continue
                    self._fold_view(vn, parent)
                    self._rolled.add((vn, parent))
                    folded.append((vn, parent))
        return folded

    def _fold_view(self, child: str, parent: str) -> None:
        """OR every row of every shard of ``child`` into ``parent``
        (made if missing) through the fragment's bulk import, so
        versions, delta logs and dirty rows follow: the parent's rows
        come out as the JAX package's whole-row OR leaves them.  The
        caller holds the lock."""
        pv = self.view(parent, create=True)
        for shard, cfrag in sorted(self.views[child].fragments.items()):
            pfrag = pv.fragment(shard, create=True)
            parts = [(row, cfrag.row_columns(row)) for row in cfrag.row_ids]
            if parts:
                pfrag.import_bits(
                    np.concatenate([np.full(c.size, r, np.int64)
                                    for r, c in parts]),
                    np.concatenate([c for _r, c in parts]))
