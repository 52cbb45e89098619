"""TopN/TopK (executor.go:2357-2777, fragment.go:1317-1497), GroupBy
(executor.go:3918, 8617), Percentile (executor.go:1310), Sort
(executor.go:9321) and Extract (executor.go:4758), on both engines.

Unfiltered TopN over the standard view of a cached field reads counts
straight off the per-fragment rank caches (the reference's
fragment.top path).  Everything else counts candidate rows exactly on
the device: on the stacked engine as (R, S, W) candidate blocks
against an optional filter tree (``StackedEngine.row_counts``); on the
per-shard engine in one ``masked_popcount_shards`` launch over every
shard's row tiles, against each shard's filter words or without one.

GroupBy enumerates its combos on the host and hands them to
``StackedEngine.groupby`` (one-pass histogram or per-combo kernel).
The per-shard engine's ``_groupby_loop`` serves ``use_stacked =
False``; ``_groupby_minmax_loop`` serves GroupBy Min/Max that the
stacked engine refuses (overlapping rows, depth past 16) and
``_groupby_count_distinct`` the aggregate Count(Distinct(...)); those
two are host loops over fragment ``row_words``, as in the JAX package.

Percentile is the reference's binary search over Counts of Range rows,
bounded by Min and Max.  Sort decodes the field's values on the device
(the stacked engine's decode stream, or one fragment's tile at a time
on the per-shard engine) and sorts each chunk of shards there, keeping
its first offset+limit; the host merges the chunks.  Extract reads the
filter's columns: BSI values from the decode stream over the shards
the filter touches, set, mutex, bool and time rows off the fragments on
the host.

On a keyed field TopN/TopK pairs carry their row keys, GroupBy groups
a "row_key" beside each row id (previous= takes keys), and Extract
gives a keyed set field's row keys and a keyed mutex's key; on a keyed
index Extract gives each column's "column_key".  Delete clears the
columns of its child, evaluated once, from every field and view.
"""

from __future__ import annotations

import operator
from fractions import Fraction

import numpy as np
import torch

from pilosa_tpu_torch.executor.results import (
    ExtractedTable,
    GroupCount,
    Pair,
    RowResult,
    SortedRow,
    ValCount,
)
from pilosa_tpu_torch.executor.stacked import ExecError, Unstackable
from pilosa_tpu_torch.models.field import FALSE_ROW, TRUE_ROW
from pilosa_tpu_torch.models.schema import FieldType
from pilosa_tpu_torch.models.view import VIEW_STANDARD
from pilosa_tpu_torch.ops import bitmap as bm
from pilosa_tpu_torch.ops import bsi as bsi_ops
from pilosa_tpu_torch.ops import kernels
from pilosa_tpu_torch.pql import ast as past
from pilosa_tpu_torch.pql.ast import Call, Condition

# combos per device batch of the per-shard GroupBy; its kernels never
# materialise a (C, planes, W) product, so aggregates take the same
# chunk as counts
_ROW_CHUNK = 256

_HAVING_OPS = {"==": operator.eq, "!=": operator.ne, "<": operator.lt,
               "<=": operator.le, ">": operator.gt, ">=": operator.ge}


def _trunc_div(a: int, b: int) -> int:
    """Go-style truncating integer division (rounds toward zero)."""
    q = a // b
    if q < 0 and q * b != a:
        q += 1
    return q


def _sorted_prefix(sel: torch.Tensor, vals: torch.Tensor, shard_ids,
                   width: int, desc: bool, keep):
    """One chunk of Sort on the device: the present columns of sel
    (S_c, N) with their values vals (S_c, N) int64, in (value, column)
    order (value descending under desc), the first ``keep`` of them
    (all when keep is None).  Returns host (values, columns) int64."""
    n = sel.shape[-1]
    pos = torch.nonzero(sel.reshape(-1)).squeeze(1)  # column order
    v = vals.reshape(-1)[pos]
    if keep is not None and pos.numel() > keep:
        # a stable sort keeps equal values in column order
        order = torch.sort(-v if desc else v, stable=True).indices[:keep]
        pos, v = pos[order], v[order]
    base = torch.as_tensor(list(shard_ids), dtype=torch.int64,
                           device=pos.device) * width
    cols = base[pos // n] + pos % n
    return v.cpu().numpy(), cols.cpu().numpy()


class AdvancedOps:
    """Mixin for Executor: TopN/TopK and GroupBy."""

    # candidate rows per device pass: (rows x shards x 128 KiB) per
    # chunk stays near 2 GiB, one pass for the design-scale TopN
    _ROWS_STACK_BUDGET = 1 << 31

    def _field_views(self, f, from_=None, to=None) -> list[str]:
        if from_ is None and to is None:
            return [VIEW_STANDARD]
        try:
            return f.views_for_range(from_, to)
        except ValueError as e:
            raise ExecError(str(e)) from None

    def _row_tiles(self, f, shard: int, row_ids, views) -> torch.Tensor:
        """(R, W) device tiles of row_ids on one shard, unioned across
        views (the per-shard engine's TileCache)."""
        acc = None
        for vn in views:
            v = f.views.get(vn)
            frag = v.fragment(shard) if v else None
            if frag is None:
                continue
            tiles = torch.stack([self.tiles.row(frag, int(r))
                                 for r in row_ids])
            acc = tiles if acc is None else acc | tiles
        if acc is None:
            acc = torch.zeros((len(row_ids), f.width // 32),
                              dtype=torch.int32, device=self.device)
        return acc

    def _all_row_ids(self, idx, f, shards) -> list[int]:
        ids: set[int] = set()
        v = f.views.get(VIEW_STANDARD)
        if v is None:
            return []
        for shard in self._shard_list(idx, shards):
            frag = v.fragment(shard)
            if frag is not None:
                ids.update(frag.row_ids)
        return sorted(ids)

    def _topnk_prepare(self, idx, call: Call, shards, n_key: str):
        """Host half of TopN/TopK: field and views, the rank-cache fast
        path and the candidate rows.  Returns ("done", result) or
        ("scan", f, views, row_ids, filter_call, n, ids)."""
        fname = call.arg("_field")
        f = idx.field(fname) if fname else None
        if f is None:
            raise ExecError(f"{call.name} requires a field")
        n = call.arg(n_key)
        ids = call.arg("ids")
        views = self._field_views(f, call.arg("from"), call.arg("to"))
        filter_call = call.children[0] if call.children else None
        plain_topn = (ids is None and call.name == "TopN"
                      and views == [VIEW_STANDARD])
        if plain_topn and filter_call is None:
            pairs = self._topn_from_caches(idx, f, shards)
            if pairs is not None:
                return ("done", self._finish_topn(f, pairs, n))
        row_ids = ([int(r) for r in ids] if ids is not None
                   else self._all_row_ids(idx, f, shards))
        if plain_topn:
            # ranked caches bound the filtered scan to their top rows
            # (fragment.top iterates cache candidates, cache.go:130)
            cand = self._candidate_rows_from_caches(idx, f, shards)
            if cand is not None and len(cand) < len(row_ids):
                row_ids = cand
        if not row_ids:
            return ("done", [])
        return ("scan", f, views, row_ids, filter_call, n, ids)

    def _execute_topnk(self, idx, call: Call, shards, pre: dict, n_key: str):
        prep = self._topnk_prepare(idx, call, shards, n_key)
        if prep[0] == "done":
            return prep[1]
        _, f, views, row_ids, filter_call, n, ids = prep
        done, pairs = self._try_stacked(
            call.name, lambda: self._topnk_stacked(
                idx, f, row_ids, views, filter_call, shards, pre, ids))
        if not done:
            pairs = self._topnk_loop(idx, f, row_ids, views, filter_call,
                                     shards, pre, ids)
        return self._finish_topn(f, pairs, n)

    def _topnk_loop(self, idx, f, row_ids, views, filter_call, shards, pre,
                    ids):
        """The per-shard candidate scan in two passes: on the host, per
        shard, the filter tree's words and each view's candidate row
        tiles (TileCache hits when warm); then one masked_popcount_shards
        launch counts every shard's rows against its filter (the rows'
        own popcount without one), summed in int64 on the device and
        fetched once.  What a launch holds (each shard's row tiles of
        every view and its filter words) stays within _ROWS_STACK_BUDGET:
        past it, one launch a batch of shards, and when one shard's rows
        alone pass it, a chunk of rows at a time (the filter evaluated
        again for each chunk)."""
        words = idx.width // 32
        vs = [f.views.get(vn) for vn in views]
        row_bytes = max(1, len(vs)) * words * 4     # a row of every view
        per_chunk = max(1, self._ROWS_STACK_BUDGET // row_bytes - 1)
        shard_list = self._shard_list(idx, shards)
        got = []
        for lo in range(0, len(row_ids), per_chunk):
            rows = row_ids[lo:lo + per_chunk]
            batch = max(1, self._ROWS_STACK_BUDGET
                        // (len(rows) * row_bytes + words * 4))
            part = None
            for i in range(0, len(shard_list), batch):
                tiles, masks = [], []
                for shard in shard_list[i:i + batch]:
                    if filter_call is not None:
                        masks.append(self._bitmap_call_shard(
                            idx, filter_call, shard, pre))
                    tiles.append([self._shard_rows(v, shard, rows)
                                  for v in vs])
                n = kernels.masked_popcount_shards(
                    tiles, masks if filter_call is not None else None,
                    len(rows), words, self.device)
                part = n if part is None else part + n
            if part is not None:
                got.extend(part.cpu().tolist())
        counts = {r: 0 for r in row_ids}
        for r, c in zip(row_ids, got):
            counts[r] += c
        return [Pair(id=r, count=c) for r, c in counts.items()
                if c > 0 or ids is not None]

    def _shard_rows(self, view, shard: int, row_ids):
        """A view's row tiles on one shard (TileCache), or None when the
        shard has no fragment there."""
        frag = view.fragment(shard) if view else None
        if frag is None:
            return None
        return self.tiles.rows(frag, row_ids)

    def _topnk_stacked(self, idx, f, row_ids, views, filter_call, shards, pre,
                       ids):
        """Candidate scan: per chunk of rows, one (R, S, W) device pass
        with the filter tree inlined; under a mesh (StackedEngine.set_mesh)
        the rows split over its "rows" axis and the shards over its
        "shards" axis."""
        eng = self.stacked
        skey = tuple(self._shard_list(idx, shards))
        chunk = max(1, self._ROWS_STACK_BUDGET
                    // (max(len(skey), 1) * (idx.width // 32) * 4))
        counts: dict[int, int] = {}
        for i in range(0, len(row_ids), chunk):
            rows = row_ids[i:i + chunk]
            got = eng.row_counts(idx, f, views, rows, filter_call, skey, pre)
            for r, c in zip(rows, got.tolist()):
                counts[r] = int(c)
        return [Pair(id=r, count=c) for r, c in counts.items()
                if c > 0 or ids is not None]

    def _topn_from_caches(self, idx, f, shards) -> list | None:
        """Merged per-fragment cache counts; None when a fragment has
        no cache (the exact scan runs instead)."""
        v = f.views.get(VIEW_STANDARD)
        if v is None:
            return []
        counts: dict[int, int] = {}
        for shard in self._shard_list(idx, shards):
            frag = v.fragment(shard)
            if frag is None:
                continue
            cache = frag.row_cache()
            if cache is None:
                return None
            for r, c in cache.top():
                counts[r] = counts.get(r, 0) + c
        return [Pair(id=r, count=c) for r, c in counts.items() if c > 0]

    def _candidate_rows_from_caches(self, idx, f, shards) -> list | None:
        """Union of every shard cache's ranked rows, ascending; None
        when any fragment lacks a cache."""
        v = f.views.get(VIEW_STANDARD)
        if v is None:
            return []
        out: set[int] = set()
        for shard in self._shard_list(idx, shards):
            frag = v.fragment(shard)
            if frag is None:
                continue
            cache = frag.row_cache()
            if cache is None:
                return None
            out.update(r for r, _c in cache.top())
        return sorted(out)

    @staticmethod
    def _finish_topn(f, pairs, n):
        """The pairs by count (ties by id), the first n, and on a keyed
        field each pair's row key."""
        pairs.sort(key=lambda p: (-p.count, p.id))
        if n is not None:
            pairs = pairs[:int(n)]
        if f.options.keys:
            keys = f.row_translator.translate_ids([p.id for p in pairs])
            for p, k in zip(pairs, keys):
                p.key = k
        return pairs

    # -- GroupBy ---------------------------------------------------------

    def _execute_groupby(self, idx, call: Call, shards,
                         pre: dict) -> list[GroupCount]:
        """GroupBy(Rows(...), ..., filter=, aggregate=Sum|Min|Max(field=)
        or Count(Distinct(field=)), having=, limit=, previous=) over the
        cartesian product of the Rows' row ids, in product order; a
        keyed field's groups carry their row keys, and its previous=
        entry may be a key."""
        rows_calls = [c for c in call.children if c.name == "Rows"]
        if not rows_calls:
            raise ExecError("GroupBy requires at least one Rows() child")
        fields, row_lists = [], []
        for rc in rows_calls:
            fname = rc.arg("_field")
            f = idx.field(fname) if fname else None
            if f is None:
                raise ExecError("Rows requires a valid field")
            fields.append(f)
            row_lists.append(self._rows_ids(idx, rc, shards))
        if any(not rl for rl in row_lists):
            return []

        filter_call = call.arg("filter")
        agg_call = call.arg("aggregate")
        agg_field = distinct_field = distinct_inner = None
        agg_op = "sum"
        if agg_call is not None:
            if not isinstance(agg_call, Call) or agg_call.name not in (
                    "Sum", "Count", "Min", "Max"):
                raise ExecError("GroupBy aggregate must be Sum(...), "
                                "Min(...), Max(...) or Count(Distinct(...))")
            if agg_call.name == "Count":
                dc = agg_call.children[0] if agg_call.children else None
                if (not isinstance(dc, Call) or dc.name != "Distinct"
                        or dc.arg("_field") is None):
                    raise ExecError("GroupBy Count aggregate requires "
                                    "Count(Distinct(field=...))")
                distinct_field = idx.field(dc.arg("_field"))
                if distinct_field is None:
                    raise ExecError(f"field not found: {dc.arg('_field')}")
                distinct_inner = dc.children[0] if dc.children else None
            else:
                agg_field = self._bsi_field(idx, agg_call.arg("_field"))
                agg_op = agg_call.name.lower()

        # the full cartesian product as one (C, nf) index matrix in
        # product order; it maps 1:1 onto the one-pass dense code space
        combos = np.indices([len(rl) for rl in row_lists]) \
            .reshape(len(row_lists), -1).T.astype(np.int64)

        # previous= (executor.go:8617 groupByIterator seek): resume
        # strictly after the given group, resolved before any device work
        previous = call.arg("previous")
        if previous is not None:
            if len(previous) != len(fields):
                raise ExecError(
                    "previous= must have one entry per Rows() child")
            previous = [
                self._row_key_id(f, pv,
                                 "string previous= entry on unkeyed field")
                if isinstance(pv, str) else pv
                for f, pv in zip(fields, previous)]
            gt = np.zeros(len(combos), dtype=bool)
            eq = np.ones(len(combos), dtype=bool)
            for fi, (rl, pv) in enumerate(zip(row_lists, previous)):
                ids = np.asarray(rl, dtype=np.int64)[combos[:, fi]]
                gt |= eq & (ids > int(pv))
                eq &= ids == int(pv)
            if not gt.any():
                return []
            combos = combos[int(np.argmax(gt)):]

        shard_list = self._shard_list(idx, shards)
        done = False
        if distinct_field is None:
            done, out = self._try_stacked("GroupBy", lambda: self.stacked.groupby(
                idx, list(zip(fields, row_lists)), filter_call, agg_field,
                shard_list, combos, pre, agg_op=agg_op))
        else:
            # the JAX package counts these groups on its loop too
            self.paths[("GroupBy", "count_distinct")] += 1
        if done:
            counts, agg = out
        elif agg_op in ("min", "max"):
            counts, agg = self._groupby_minmax_loop(
                idx, fields, row_lists, combos, filter_call, agg_field,
                shard_list, pre, agg_op)
        else:
            counts, agg = self._groupby_loop(
                idx, fields, row_lists, combos, filter_call, agg_field,
                shard_list, pre)
        distinct_counts = None
        if distinct_field is not None:
            distinct_counts = self._groupby_count_distinct(
                idx, fields, row_lists, combos, counts, filter_call,
                distinct_inner, distinct_field, shard_list, pre)
        return self._assemble_groupby(
            fields, row_lists, combos, counts, agg_field, agg_op, agg,
            distinct_counts, call.arg("having"), call.arg("limit"))

    def _groupby_loop(self, idx, fields, row_lists, combos, filter_call,
                      agg_field, shard_list, pre):
        """GroupBy counts and Sum partials on the per-shard engine: per
        shard, each chunk of combos ANDs its rows' tiles (and the filter)
        into masks, counted by popcount_rows, and the Sum partials come
        from one bsi_sum_counts over the shard's planes held against
        every mask (a stride-0 view).  Sums stay on the device in int64
        until one fetch.  Returns (counts, None | (nn, pos, neg))."""
        dev = self.device
        n = len(combos)
        counts = torch.zeros(n, dtype=torch.int64, device=dev)
        agg = None
        if agg_field is not None:
            depth = agg_field.bit_depth
            agg = (torch.zeros(n, dtype=torch.int64, device=dev),
                   torch.zeros((n, depth), dtype=torch.int64, device=dev),
                   torch.zeros((n, depth), dtype=torch.int64, device=dev))
        combo_idx = torch.as_tensor(np.asarray(combos, dtype=np.int64)
                                    .reshape(n, len(fields)), device=dev)
        for shard in shard_list:
            filt = (self._bitmap_call_shard(idx, filter_call, shard, pre)
                    if filter_call is not None else None)
            tiles = [self._row_tiles(f, shard, rl, [VIEW_STANDARD])
                     for f, rl in zip(fields, row_lists)]
            planes = None
            if agg_field is not None:
                frag = self._bsi_frag(agg_field, shard)
                if frag is not None:
                    planes = self.tiles.planes(frag, agg_field.bit_depth)
            for i in range(0, n, _ROW_CHUNK):
                sel = combo_idx[i:i + _ROW_CHUNK]
                mask = tiles[0][sel[:, 0]]
                for fi in range(1, len(fields)):
                    mask = mask & tiles[fi][sel[:, fi]]
                if filt is not None:
                    mask = mask & filt
                counts[i:i + len(sel)] += kernels.popcount_rows(mask)
                if planes is not None:
                    parts = kernels.bsi_sum_counts(
                        planes.unsqueeze(0).expand(len(sel), -1, -1), mask)
                    for acc, part in zip(agg, parts):
                        acc[i:i + len(sel)] += part
        return (counts.cpu().numpy(),
                None if agg is None else tuple(a.cpu().numpy() for a in agg))

    def _groupby_minmax_loop(self, idx, fields, row_lists, combos,
                             filter_call, agg_field, shard_list, pre,
                             agg_op: str):
        """GroupBy Min/Max in full generality (overlapping rows, any
        depth, any filter): a host loop, as in the JAX package, that per
        shard reads the rows' and the planes' row_words, decodes the
        values once (bsi.decode_np) and reduces each combo's member
        columns in numpy.  Returns (counts, (nn, values))."""
        n = len(combos)
        counts = np.zeros(n, dtype=np.int64)
        agg_nn = np.zeros(n, dtype=np.int64)
        agg_vals = np.zeros(n, dtype=np.int64)
        reduce_ = np.minimum if agg_op == "min" else np.maximum
        combo_idx = np.asarray(combos, dtype=np.int64).reshape(n, len(fields))
        depth = agg_field.bit_depth
        if depth > 63:
            # int64 holds magnitudes below 2^63 (bsi.decode_np)
            raise ExecError(f"GroupBy Min/Max unsupported for depth {depth}"
                            " > 63")
        for shard in shard_list:
            filt_bits = None
            if filter_call is not None:
                filt_bits = bsi_ops.unpack_bits_np(bm.to_numpy(
                    self._bitmap_call_shard(idx, filter_call, shard, pre)))
            tile_bits = [bsi_ops.unpack_bits_np(self._row_words(f, shard, rl))
                         for f, rl in zip(fields, row_lists)]
            frag = self._bsi_frag(agg_field, shard)
            ex = vals = None
            if frag is not None:
                ex, vals = bsi_ops.decode_np(np.stack(
                    [frag.row_words(r) for r in range(2 + depth)]))
            for ci in range(n):
                sel = tile_bits[0][combo_idx[ci, 0]]
                for fi in range(1, len(fields)):
                    sel = sel & tile_bits[fi][combo_idx[ci, fi]]
                if filt_bits is not None:
                    sel = sel & filt_bits
                counts[ci] += int(np.count_nonzero(sel))
                if ex is None:
                    continue
                sele = sel & ex
                k = int(np.count_nonzero(sele))
                if not k:
                    continue
                best = int(reduce_.reduce(vals[sele]))
                agg_vals[ci] = (best if agg_nn[ci] == 0
                                else int(reduce_(agg_vals[ci], best)))
                agg_nn[ci] += k
        return counts, (agg_nn, agg_vals)

    @staticmethod
    def _row_words(f, shard: int, row_ids) -> np.ndarray:
        """(R, W) host words of row_ids on one shard (zeros where the
        fragment or the row is absent)."""
        v = f.views.get(VIEW_STANDARD)
        frag = v.fragment(shard) if v else None
        if frag is None:
            return np.zeros((len(row_ids), f.width // 32), dtype=np.uint32)
        return np.stack([frag.row_words(int(r)) for r in row_ids])

    def _groupby_count_distinct(self, idx, fields, row_lists, combos,
                                counts, filter_call, inner_filter, dfield,
                                shard_list, pre):
        """Count(Distinct(field=D)) per group: the distinct BSI values, or
        the distinct set rows, of D among the group's columns under the
        GroupBy filter and the Distinct's own filter.  A host loop over
        fragment row_words, as in the JAX package, with BSI values from
        the stacked engine's decode stream, one chunk of shards at a
        time; the sets union across shards."""
        nonzero = [ci for ci in range(len(combos)) if counts[ci] > 0]
        sets: dict[int, set] = {ci: set() for ci in nonzero}
        is_bsi = dfield.options.type.is_bsi
        if is_bsi and dfield.bit_depth > 62:
            raise ExecError("Count(Distinct) unsupported for depth > 62")

        def shard_groups():
            if not is_bsi:
                for s in shard_list:
                    yield s, None, None
                return
            for chunk, ex, vals in self.stacked.decode_stream(
                    idx, dfield, tuple(shard_list)):
                ex, vals = ex.cpu().numpy(), vals.cpu().numpy()
                for i, s in enumerate(chunk):
                    yield s, ex[i], vals[i]

        def host_words(call, shard):
            return bm.to_numpy(self._bitmap_call_shard(idx, call, shard, pre))

        for shard, ex, vals in shard_groups():
            filt = None
            if filter_call is not None:
                filt = host_words(filter_call, shard)
            if inner_filter is not None:
                inner = host_words(inner_filter, shard)
                filt = inner if filt is None else filt & inner
            tiles = [self._row_words(f, shard, rl)
                     for f, rl in zip(fields, row_lists)]
            if not is_bsi:
                v = dfield.views.get(VIEW_STANDARD)
                dfrag = v.fragment(shard) if v else None
                if dfrag is None:
                    continue
                drows = dfrag.row_ids
                if not drows:
                    continue
                dwords = np.stack([dfrag.row_words(r) for r in drows])
            for ci in nonzero:
                combo = combos[ci]
                mask = tiles[0][combo[0]].copy()
                for fi in range(1, len(fields)):
                    mask &= tiles[fi][combo[fi]]
                if filt is not None:
                    mask &= filt
                if not mask.any():
                    continue
                if is_bsi:
                    bits = bsi_ops.unpack_bits_np(mask) & ex
                    if bits.any():
                        sets[ci].update(np.unique(vals[bits]).tolist())
                else:
                    hit = (dwords & mask[None]).any(axis=1)
                    sets[ci].update(r for r, h in zip(drows, hit) if h)
        out = np.zeros(len(combos), dtype=np.int64)
        for ci, vals_ in sets.items():
            out[ci] = len(vals_)
        return out

    def _assemble_groupby(self, fields, row_lists, combos, counts,
                          agg_field, agg_op: str, agg, distinct_counts,
                          having, limit) -> list[GroupCount]:
        """GroupCounts in combo order: zero-count combos drop, Sum
        combines its sign-split plane partials in exact ints, Min/Max
        take the per-group value (None for a group with no value),
        Count(Distinct) its own counts, then having= and limit=
        apply."""
        out = []
        for ci, combo in enumerate(combos):
            cnt = int(counts[ci])
            if cnt == 0:
                continue
            group = []
            for f, rl, gi in zip(fields, row_lists, combo):
                entry = {"field": f.name, "row_id": rl[gi]}
                if f.options.keys:
                    entry["row_key"] = f.row_translator.translate_id(rl[gi])
                group.append(entry)
            value = agg_count = None
            if agg_field is not None and agg_op in ("min", "max"):
                nn, vals = agg
                agg_count = int(nn[ci])
                value = (agg_field.int_to_value(int(vals[ci]))
                         if agg_count else None)
            elif agg_field is not None:
                nn, pos, neg = agg
                total = sum((int(p) - int(g)) << b
                            for b, (p, g) in enumerate(zip(pos[ci], neg[ci])))
                value = agg_field.int_to_value(total)
                agg_count = int(nn[ci])
            elif distinct_counts is not None:
                value = agg_count = int(distinct_counts[ci])
            gc = GroupCount(group=group, count=cnt, agg=value,
                            agg_count=agg_count)
            if having is not None and not self._having_ok(gc, having):
                continue
            out.append(gc)
            if limit is not None and len(out) >= int(limit):
                break
        return out

    @staticmethod
    def _having_ok(gc: GroupCount, having) -> bool:
        """having=Condition(count|sum <op> value)."""
        if not isinstance(having, Call) or having.name != "Condition":
            raise ExecError("having must be Condition(...)")
        key, cond = having.condition_field()
        if key not in ("count", "sum"):
            raise ExecError(f"having supports count/sum, got {key}")
        val = gc.count if key == "count" else gc.agg
        if val is None:
            raise ExecError("having on sum requires aggregate=Sum(field=...)")
        if past.is_between(cond):
            lo, hi = past.between_bounds_inclusive(cond)
            return lo <= val <= hi
        return _HAVING_OPS[cond.op](val, cond.value)

    # -- Percentile ------------------------------------------------------

    def _execute_percentile(self, idx, call: Call, shards, pre):
        """Percentile(field=f, nth=p, filter=...): the value with
        desired_less values below it and desired_greater above, by the
        reference's binary search over stored values, each step a Count
        of Row(f < x) and one of Row(f > x) under the filter; Min and
        Max bound it and answer nth 0 and 100.  None where no column
        holds a value.  Where the search converges with neither count
        condition met, the converged bound is the answer (the JAX
        package's one divergence from the reference's stale midpoint)."""
        nth = call.arg("nth")
        if nth is None:
            raise ExecError("Percentile(): nth required")
        nth = float(nth)
        if not 0 <= nth <= 100:
            raise ExecError("Percentile(): nth must be in [0, 100]")
        fname = call.arg("_field")
        f = self._bsi_field(idx, fname) if fname else None
        if f is None:
            raise ExecError("Percentile(): field required")
        filter_call = call.arg("filter")
        scale = 10 ** (f.options.scale
                       if f.options.type == FieldType.DECIMAL else 0)

        def count_cond(op, stored: int) -> int:
            row = Call("Row", args={f.name: Condition(
                op, Fraction(stored, scale))})
            tree = (Call("Intersect", children=[row, filter_call])
                    if filter_call is not None else row)
            return self._reduce_count(idx, tree, shards, pre)

        def extreme(name: str):
            mm = Call(name, args={"_field": f.name},
                      children=[filter_call] if filter_call else [])
            vc = self._execute_minmax(idx, mm, shards, name == "Min", pre)
            return vc, (vc.value if isinstance(vc.value, int)
                        else f.value_to_int(vc.value))

        nn_row = Call("Row", args={f.name: Condition(past.OP_NEQ, None)})
        total = self._reduce_count(
            idx, Call("Intersect", children=[filter_call, nn_row])
            if filter_call is not None else nn_row, shards, pre)
        if total == 0:
            return None
        desired_less = int(total * nth / 100.0)
        desired_greater = int(total * (100.0 - nth) / 100.0)
        lo_vc, lo = extreme("Min")
        if desired_greater != 0 and desired_less == 0:
            return lo_vc
        hi_vc, hi = extreme("Max")
        if desired_greater == 0:
            return hi_vc
        while lo < hi:
            # Go's overflow-free midpoint: min/2 + max/2 + (min%2 +
            # max%2)/2, truncated division and remainder
            lo_rem = lo - _trunc_div(lo, 2) * 2
            hi_rem = hi - _trunc_div(hi, 2) * 2
            possible = (_trunc_div(lo, 2) + _trunc_div(hi, 2)
                        + _trunc_div(lo_rem + hi_rem, 2))
            if count_cond(past.OP_LT, possible) > desired_less:
                hi = possible - 1
            elif count_cond(past.OP_GT, possible) > desired_greater:
                lo = possible + 1
            else:
                return ValCount(value=f.int_to_value(possible), count=1)
        return ValCount(value=f.int_to_value(lo), count=1)

    # -- Sort --------------------------------------------------------------

    def _execute_sort(self, idx, call: Call, shards, pre) -> SortedRow:
        """Sort(filter, field=f, sort-desc=, offset=, limit=): the
        filter's columns that hold a value, ordered by value (descending
        under sort-desc), equal values in column order.  Each chunk of
        shards is sorted on the device and keeps its first offset+limit
        (_sorted_prefix) where both are >= 0; the host merges the chunks
        with a stable sort and takes Python's slice [offset:offset+limit],
        the JAX package's, whatever their signs.  Past depth 63 a value
        may not fit int64: the per-shard engine then decodes on the host
        in Python ints (_sort_host), as the JAX loop does."""
        fname = call.arg("_field") or call.arg("field")
        f = self._bsi_field(idx, fname) if fname else None
        if f is None:
            raise ExecError("Sort requires a BSI field")
        desc = bool(call.arg("sort-desc", False))
        filter_call = call.children[0] if call.children else None
        offset = int(call.arg("offset", 0))
        limit = call.arg("limit")
        keep = None if limit is None else offset + int(limit)
        # a chunk may drop what follows its first `keep` only when the
        # slice counts from the front: a negative bound counts from the
        # end of the whole merged order
        chunk_keep = keep if offset >= 0 and (keep is None or keep >= 0) \
            else None
        shard_list = self._shard_list(idx, shards)

        def stacked():
            if f.bit_depth > 62:
                raise Unstackable("decode_depth", f"Sort of {f.name}: "
                                  f"depth {f.bit_depth} > 62")
            return self._sort_stacked(idx, f, filter_call, shard_list, pre,
                                      desc, chunk_keep)

        done, runs = self._try_stacked("Sort", stacked)
        if not done and f.bit_depth > 63:
            return self._sort_host(idx, f, filter_call, shard_list, pre,
                                   desc, offset, keep)
        if not done:
            runs = self._sort_loop(idx, f, filter_call, shard_list, pre,
                                   desc, chunk_keep)
        if not runs:
            return SortedRow(columns=[], values=[])
        vals = np.concatenate([v for v, _ in runs])
        cols = np.concatenate([c for _, c in runs])
        order = np.lexsort((cols, -vals if desc else vals))[offset:keep]
        return SortedRow(columns=cols[order].tolist(),
                         values=[f.int_to_value(int(x)) for x in vals[order]])

    def _sort_stacked(self, idx, f, filter_call, shard_list, pre, desc,
                      keep) -> list:
        """Sort's chunks on the stacked engine: the decode stream, the
        filter tree evaluated per chunk of shards."""
        runs = []
        for chunk, ex, vals in self.stacked.decode_stream(
                idx, f, tuple(shard_list)):
            sel = ex
            if filter_call is not None:
                filt = self.stacked.filter_stack(idx, filter_call,
                                                 tuple(chunk), pre)
                if filt is None:
                    return []
                sel = sel & (bm.unpack_bits(filt) == 1)
            runs.append(_sorted_prefix(sel, vals, chunk, idx.width, desc,
                                       keep))
        return runs

    def _sort_loop(self, idx, f, filter_call, shard_list, pre, desc,
                   keep) -> list:
        """Sort's chunks on the per-shard engine: one fragment's plane
        tile at a time (TileCache), decoded on the device."""
        runs = []
        for shard in shard_list:
            frag = self._bsi_frag(f, shard)
            if frag is None:
                continue
            ex, vals = bsi_ops.decode_device(
                self.tiles.planes(frag, f.bit_depth).unsqueeze(0))
            if filter_call is not None:
                filt = self._bitmap_call_shard(idx, filter_call, shard, pre)
                ex = ex & (bm.unpack_bits(filt) == 1)
            runs.append(_sorted_prefix(ex, vals, [shard], idx.width, desc,
                                       keep))
        return runs

    def _sort_host(self, idx, f, filter_call, shard_list, pre, desc,
                   offset: int, keep) -> SortedRow:
        """Sort of a field past depth 63: each fragment's planes decoded
        on the host in exact Python ints, the filter's words brought
        back a shard, and one sort by (value, column)."""
        cols, vals = [], []
        for shard in shard_list:
            frag = self._bsi_frag(f, shard)
            if frag is None:
                continue
            c, v = bsi_ops.decode(np.stack(
                [frag.row_words(r) for r in range(2 + f.bit_depth)]))
            if filter_call is not None:
                filt = bm.to_numpy(self._bitmap_call_shard(
                    idx, filter_call, shard, pre))
                sel = np.nonzero(bsi_ops.unpack_bits_np(filt)[c])[0]
                c, v = c[sel], [v[i] for i in sel]
            base = shard * idx.width
            cols.extend(int(x) + base for x in c)
            vals.extend(v)
        order = sorted(range(len(cols)), key=lambda i: (
            -vals[i] if desc else vals[i], cols[i]))[offset:keep]
        return SortedRow(columns=[cols[i] for i in order],
                         values=[f.int_to_value(vals[i]) for i in order])

    # -- Extract -----------------------------------------------------------

    def _execute_extract(self, idx, call: Call, shards,
                         pre) -> ExtractedTable:
        """Extract(filter, Rows(f), ...): per column of the filter (a
        Sort keeps its order), each field's entry: a BSI value or None,
        a bool field's True/False/None, a mutex field's row id or None,
        a set or time field's row ids."""
        if not call.children:
            raise ExecError("Extract requires a filter call")
        filter_call = call.children[0]
        bad = [c.name for c in call.children[1:] if c.name != "Rows"]
        if bad:
            raise ExecError("Extract children after the filter must be "
                            f"Rows(), got {bad}")
        fields = []
        for rc in call.children[1:]:
            fname = rc.arg("_field")
            f = idx.field(fname) if fname is not None else None
            if f is None:
                raise ExecError("Extract Rows() requires a valid field")
            fields.append(f)
        if filter_call.name == "Sort":
            columns = self._execute_sort(idx, filter_call, shards,
                                         pre).columns
        else:
            row = self._execute_call(idx, filter_call, shards, pre)
            if not isinstance(row, RowResult):
                raise ExecError("Extract filter must produce a row, got "
                                f"{filter_call.name}")
            columns = row.columns().tolist()
        by_shard: dict[int, list[int]] = {}
        for c in columns:
            by_shard.setdefault(c // idx.width, []).append(c)
        bsi_fields = [f for f in fields if f.options.type.is_bsi]
        values = {}
        if bsi_fields:
            def stacked():
                if any(f.bit_depth > 62 for f in bsi_fields):
                    raise Unstackable("decode_depth", "Extract past depth 62")
                return {f.name: self._extract_decoded(idx, f, by_shard)
                        for f in bsi_fields}

            done, values = self._try_stacked("Extract", stacked)
            if not done:
                values = {f.name: self._extract_host(f, by_shard, idx.width)
                          for f in bsi_fields}
        else:
            self.paths[("Extract", "only_route")] += 1
        table = {c: [] for c in columns}
        for f in fields:
            if f.options.type.is_bsi:
                got = values[f.name]
                for c in columns:
                    table[c].append(got.get(c))
                continue
            member = self._extract_members(f, by_shard, idx.width)
            t = f.options.type
            tr = f.row_translator
            for c in columns:
                rows = member.get(c, [])
                if t == FieldType.BOOL:
                    table[c].append(True if TRUE_ROW in rows else
                                    False if FALSE_ROW in rows else None)
                elif t == FieldType.MUTEX:
                    r = rows[0] if rows else None
                    table[c].append(r if tr is None or r is None
                                    else tr.translate_id(r))
                else:
                    table[c].append(rows if tr is None
                                    else tr.translate_ids(rows))
        out = [{"column": c, "rows": table[c]} for c in columns]
        if idx.keys:
            for entry, key in zip(out, idx.column_translator.translate_ids(
                    columns)):
                entry["column_key"] = key
        return ExtractedTable(fields=[f.name for f in fields], columns=out)

    def _extract_decoded(self, idx, f, by_shard) -> dict:
        """{column: value or None} of a BSI field at the filter's columns,
        from the decode stream over the shards they lie in."""
        out = {}
        for chunk, ex, vals in self.stacked.decode_stream(
                idx, f, tuple(sorted(by_shard))):
            for i, s in enumerate(chunk):
                cs = by_shard[s]
                local = torch.as_tensor([c % idx.width for c in cs],
                                        device=ex.device)
                present = ex[i][local].cpu().tolist()
                got = vals[i][local].cpu().tolist()
                out.update((c, f.int_to_value(x) if p else None)
                           for c, p, x in zip(cs, present, got))
        return out

    def _extract_host(self, f, by_shard, width: int) -> dict:
        """{column: value or None} read off the fragments' plane words on
        the host, in exact ints at any depth."""
        out = {}
        for shard, cs in by_shard.items():
            frag = self._bsi_frag(f, shard)
            if frag is None:
                continue
            local = np.asarray(cs, dtype=np.int64) % width
            w_i, b_i = local >> 5, (local & 31).astype(np.uint32)

            def bits(row):
                return (frag.row_words(row)[w_i] >> b_i) & 1

            mags = np.zeros(len(cs), dtype=object)
            for i in range(f.bit_depth):
                mags += bits(2 + i).astype(object) << i
            for c, e, neg, m in zip(cs, bits(0), bits(1), mags):
                if e:
                    out[c] = f.int_to_value(-int(m) if neg else int(m))
        return out

    @staticmethod
    def _extract_members(f, by_shard, width: int) -> dict:
        """{column: [row ids holding it, ascending]} of a set-like field's
        standard view at the filter's columns, off the fragments on the
        host."""
        member: dict[int, list[int]] = {}
        v = f.views.get(VIEW_STANDARD)
        for shard, cs in by_shard.items():
            frag = v.fragment(shard) if v else None
            if frag is None:
                continue
            local = np.asarray(cs, dtype=np.int64) % width
            w_i, b_i = local >> 5, (local & 31).astype(np.uint32)
            for r in frag.row_ids:
                hits = (frag.row_words(r)[w_i] >> b_i) & 1
                for c, h in zip(cs, hits):
                    if h:
                        member.setdefault(c, []).append(r)
        return member

    # -- Delete ------------------------------------------------------------

    def _execute_delete(self, idx, call: Call, pre) -> bool:
        """Delete(child): the child's columns cleared from every field
        and view of each shard they lie in (executor.go:9050
        delete-records).  The child is evaluated once, over the index's
        shards, on the engine that would count it."""
        child = self._only_child(call)
        shard_list = self._shard_list(idx, None)
        done, words = self._try_stacked(
            "Delete", lambda: self.stacked.words(idx, child, shard_list, pre))
        if not done:
            words = bm.to_numpy(self._tree_stack(idx, child, shard_list, pre))
        changed = False
        for i, shard in enumerate(shard_list):
            if words is None or not words[i].any():
                continue
            for f in idx.fields.values():
                for v in f.views.values():
                    frag = v.fragment(shard)
                    if frag is not None:
                        changed |= frag.clear_columns(words[i])
        return changed
