"""TopN/TopK (executor.go:2357-2777, fragment.go:1317-1497) and GroupBy
(executor.go:3918, 8617), on both engines.

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
"""

from __future__ import annotations

import operator

import numpy as np
import torch

from pilosa_tpu_torch.executor.results import GroupCount, Pair
from pilosa_tpu_torch.executor.stacked import ExecError
from pilosa_tpu_torch.models.view import VIEW_STANDARD
from pilosa_tpu_torch.ops import bitmap as bm
from pilosa_tpu_torch.ops import bsi as bsi_ops
from pilosa_tpu_torch.ops import kernels
from pilosa_tpu_torch.pql import ast as past
from pilosa_tpu_torch.pql.ast import Call

# combos per device batch of the per-shard GroupBy; its kernels never
# materialise a (C, planes, W) product, so aggregates take the same
# chunk as counts
_ROW_CHUNK = 256

_HAVING_OPS = {"==": operator.eq, "!=": operator.ne, "<": operator.lt,
               "<=": operator.le, ">": operator.gt, ">=": operator.ge}


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
                return ("done", self._finish_topn(pairs, n))
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

    def _execute_topnk(self, idx, call: Call, shards, n_key: str):
        prep = self._topnk_prepare(idx, call, shards, n_key)
        if prep[0] == "done":
            return prep[1]
        _, f, views, row_ids, filter_call, n, ids = prep
        done, pairs = self._try_stacked(
            call.name, lambda: self._topnk_stacked(
                idx, f, row_ids, views, filter_call, shards, ids))
        if not done:
            pairs = self._topnk_loop(idx, f, row_ids, views, filter_call,
                                     shards, ids)
        return self._finish_topn(pairs, n)

    def _topnk_loop(self, idx, f, row_ids, views, filter_call, shards, ids):
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
                        masks.append(
                            self._bitmap_call_shard(idx, filter_call, shard))
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

    def _topnk_stacked(self, idx, f, row_ids, views, filter_call, shards,
                       ids):
        """Candidate scan: per chunk of rows, one (R, S, W) device pass
        with the filter tree inlined."""
        eng = self.stacked
        skey = tuple(self._shard_list(idx, shards))
        chunk = max(1, self._ROWS_STACK_BUDGET
                    // (len(skey) * (idx.width // 32) * 4))
        counts: dict[int, int] = {}
        for i in range(0, len(row_ids), chunk):
            rows = row_ids[i:i + chunk]
            stack = eng.rows_stack_for(idx, f, tuple(views), rows, skey)
            got = eng.row_counts(idx, stack, filter_call, list(skey))
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
    def _finish_topn(pairs, n):
        pairs.sort(key=lambda p: (-p.count, p.id))
        return pairs if n is None else pairs[:int(n)]

    # -- GroupBy ---------------------------------------------------------

    def _execute_groupby(self, idx, call: Call, shards) -> list[GroupCount]:
        """GroupBy(Rows(...), ..., filter=, aggregate=Sum|Min|Max(field=)
        or Count(Distinct(field=)), having=, limit=, previous=) over the
        cartesian product of the Rows' row ids, in product order.  Keyed
        fields are not ported yet."""
        rows_calls = [c for c in call.children if c.name == "Rows"]
        if not rows_calls:
            raise ExecError("GroupBy requires at least one Rows() child")
        fields, row_lists = [], []
        for rc in rows_calls:
            fname = rc.arg("_field")
            f = idx.field(fname) if fname else None
            if f is None:
                raise ExecError("Rows requires a valid field")
            if f.options.keys:
                raise ExecError("GroupBy over keyed fields is not ported yet")
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
            if any(isinstance(p, str) for p in previous):
                raise ExecError("row keys are not ported yet")
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
                shard_list, combos, agg_op=agg_op))
        else:
            # the JAX package counts these groups on its loop too
            self.paths[("GroupBy", "count_distinct")] += 1
        if done:
            counts, agg = out
        elif agg_op in ("min", "max"):
            counts, agg = self._groupby_minmax_loop(
                idx, fields, row_lists, combos, filter_call, agg_field,
                shard_list, agg_op)
        else:
            counts, agg = self._groupby_loop(
                idx, fields, row_lists, combos, filter_call, agg_field,
                shard_list)
        distinct_counts = None
        if distinct_field is not None:
            distinct_counts = self._groupby_count_distinct(
                idx, fields, row_lists, combos, counts, filter_call,
                distinct_inner, distinct_field, shard_list)
        return self._assemble_groupby(
            fields, row_lists, combos, counts, agg_field, agg_op, agg,
            distinct_counts, call.arg("having"), call.arg("limit"))

    def _groupby_loop(self, idx, fields, row_lists, combos, filter_call,
                      agg_field, shard_list):
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
            filt = (self._bitmap_call_shard(idx, filter_call, shard)
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
                             filter_call, agg_field, shard_list, agg_op: str):
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
                    self._bitmap_call_shard(idx, filter_call, shard)))
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
                                shard_list):
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
            return bm.to_numpy(self._bitmap_call_shard(idx, call, shard))

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
            group = [{"field": f.name, "row_id": rl[gi]}
                     for f, rl, gi in zip(fields, row_lists, combo)]
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
