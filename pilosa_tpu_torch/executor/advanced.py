"""TopN/TopK (executor.go:2357-2777, fragment.go:1317-1497) and GroupBy
(executor.go:3918, 8617).

Unfiltered TopN over the standard view of a cached field reads counts
straight off the per-fragment rank caches (the reference's
fragment.top path).  Everything else counts candidate rows exactly on
the device: (R, S, W) candidate blocks against an optional filter tree
(``StackedEngine.row_counts``), summed across shards as exact ints.
GroupBy enumerates its combos on the host and hands them to
``StackedEngine.groupby`` (one-pass histogram or per-combo kernel).
"""

from __future__ import annotations

import operator

import numpy as np

from pilosa_tpu_torch.executor.results import GroupCount, Pair
from pilosa_tpu_torch.executor.stacked import ExecError
from pilosa_tpu_torch.models.view import VIEW_STANDARD
from pilosa_tpu_torch.pql import ast as past
from pilosa_tpu_torch.pql.ast import Call

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
        pairs = self._topnk_stacked(idx, f, row_ids, views, filter_call,
                                    shards, ids)
        return self._finish_topn(pairs, n)

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
        """GroupBy(Rows(...), ..., filter=, aggregate=Sum|Min|Max(field=),
        having=, limit=, previous=) over the cartesian product of the
        Rows' row ids, in product order.  The aggregate
        Count(Distinct(...)) and keyed fields are not ported yet."""
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

        agg_call = call.arg("aggregate")
        agg_field = None
        agg_op = "sum"
        if agg_call is not None:
            if not isinstance(agg_call, Call) or agg_call.name not in (
                    "Sum", "Count", "Min", "Max"):
                raise ExecError("GroupBy aggregate must be Sum(...), "
                                "Min(...), Max(...) or Count(Distinct(...))")
            if agg_call.name == "Count":
                raise ExecError("GroupBy aggregate Count(Distinct(...)) is "
                                "not ported yet")
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

        counts, agg = self.stacked.groupby(
            idx, list(zip(fields, row_lists)), call.arg("filter"), agg_field,
            self._shard_list(idx, shards), combos, agg_op=agg_op)
        return self._assemble_groupby(
            fields, row_lists, combos, counts, agg_field, agg_op, agg,
            call.arg("having"), call.arg("limit"))

    def _assemble_groupby(self, fields, row_lists, combos, counts,
                          agg_field, agg_op: str, agg, having,
                          limit) -> list[GroupCount]:
        """GroupCounts in combo order: zero-count combos drop, Sum
        combines its sign-split plane partials in exact ints, Min/Max
        take the per-group value (None for a group with no value), then
        having= and limit= apply."""
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
