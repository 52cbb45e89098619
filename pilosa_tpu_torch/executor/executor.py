"""Executor — PQL call dispatch (executor.go:634-843).

``Executor(holder).execute(index, pql)`` parses the query and runs each
call on one of two engines, both on the executor's device:

- the **stacked engine** (``stacked.py``), by default: a call's bitmap
  tree runs over ``(S, W)`` shard stacks, Count/Sum/TopN reduce
  per-shard partials, GroupBy runs the one-pass histogram or the
  per-combo kernel, and Min, Max and BSI Distinct read the value
  histogram;
- the **per-shard engine** (this module and ``advanced.py``), which
  walks the shards one at a time over ``(W,)`` row tiles and
  ``(2+d, W)`` plane tiles from its own device cache (``TileCache``),
  as the JAX package's loop does.

The per-shard engine runs in two cases only: the caller sets
``use_stacked = False`` (the JAX package's oracle mode), or the stacked
engine refuses a shape with ``Unstackable`` under the JAX package's
named conditions (Min/Max past the value histogram's depth, GroupBy
Min/Max over overlapping rows or past depth 16).  MinRow/MaxRow,
set-field Distinct without a filter and the GroupBy aggregate
Count(Distinct(...)) run on it always, as in the JAX package; BSI
Distinct past the value histogram's depth takes the stacked engine's
decode stream.  Every route is counted in ``Executor.paths[(call,
route)]`` (route "stacked", "asked", the refusal's reason, or
"only_route" for calls answered on the host, Rows and FieldValue).
Nothing else falls back: a failed build or launch raises.  On the card
every popcount of either engine goes through a kernel.

A query's cross-shard operands (Distinct, UnionRows and Limit nested
in a bitmap tree, and ConstRow's columns) are evaluated once, before
the call runs, into ``pre`` (``_precompute_nested``), and enter either
engine's tree as leaves; a tree walks the shards a nested result sets
bits in as well (``_tree_shards``).

String keys translate as in the JAX package: a column key through the
index's ``column_translator``, a row key through the field's
``row_translator``; a read finds a key (an unknown key matches
nothing), a write creates it.  A row result of a keyed index carries
its column keys (``RowResult.keys``).  The write calls Set, Clear,
Store, ClearRow and Delete change the host fragments; the next query
patches the device stacks and tiles those writes touched
(``StackCache``).  Store and Delete evaluate their child once, on the
engine that would count it.

The executor runs on the CUDA card by default and raises when there
is none; ``device="cpu"`` runs the kernels' plain versions on the CPU
(the tests do so).

``execute`` carries the JAX package's solo-path seams: a flight record
(route "solo"), the ``executor.Execute`` span with one
``executor.execute<Call>`` span a call, ``pilosa_query_total`` by index
and status, ``pilosa_query_duration_seconds``, and
``pilosa_stacked_queries_total`` by path ("stacked", or "loop" where
the stacked engine refused a shape).
"""

from __future__ import annotations

import contextvars
import datetime as dt
import time
from collections import Counter
from decimal import Decimal
from fractions import Fraction
from math import ceil, floor

import numpy as np
import torch

from pilosa_tpu_torch.executor.advanced import AdvancedOps
from pilosa_tpu_torch.executor.results import (
    DistinctValues,
    Pair,
    RowResult,
    ValCount,
)
from pilosa_tpu_torch.executor.stacked import (
    NESTED_CALLS,
    ExecError,
    StackCache,
    StackedEngine,
    Unstackable,
    FragRowsLayout,
)
from pilosa_tpu_torch.models import timeq
from pilosa_tpu_torch.models.field import FALSE_ROW, TRUE_ROW, Field
from pilosa_tpu_torch.models.holder import Holder
from pilosa_tpu_torch.models.index import EXISTENCE_FIELD, Index
from pilosa_tpu_torch.models.schema import FieldType
from pilosa_tpu_torch.models.view import VIEW_STANDARD
from pilosa_tpu_torch.obs import flight, metrics
from pilosa_tpu_torch.obs.tracing import start_span
from pilosa_tpu_torch.ops import bitmap as bm
from pilosa_tpu_torch.ops import bsi as bsi_ops
from pilosa_tpu_torch.ops import kernels
from pilosa_tpu_torch.pql import ast as past
from pilosa_tpu_torch.pql import parse
from pilosa_tpu_torch.pql.ast import Call, Condition, Query
from pilosa_tpu_torch.pql.like import like_regex, sql_like_regex

__all__ = ["Executor", "ExecError", "resolve_device"]

_BITMAP_CALLS = {"Row", "Range", "Union", "Intersect", "Difference", "Xor",
                 "Not", "All", "Shift", "ConstRow"}

# the write calls (pql.Call.IsWrite)
_WRITE_CALLS = {"Set", "Clear", "Store", "ClearRow", "Delete"}

# rows per device batch in the per-shard engine's row scans
_ROW_CHUNK = 256

# true while serving a node-to-node (remote) leg, whose column ids the
# coordinator already translated (executor.go opt.Remote): a keyed index
# then takes raw column ids
_REMOTE = contextvars.ContextVar("pilosa_tpu_torch_remote", default=False)


def resolve_device(device=None) -> torch.device:
    """``None`` means the current CUDA card, which must exist; anything
    else is taken as given.  A card is named with its index, as its
    tensors name it."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pilosa_tpu_torch runs on the card; pass "
                "device='cpu' to run the kernels' plain versions instead")
        device = "cuda"
    return kernels.device_of(device)


class TileCache:
    """The per-shard engine's device tiles: a fragment row as a (W,)
    tensor, a BSI fragment's planes as a (2+d, W) tensor, keyed by the
    fragment's gen and the row (or the plane depth) and tagged with its
    stamp.  After a write a tile is patched in place (``StackCache``):
    a tile whose row no logged write touched adopts the new version, a
    touched row takes only its dirty words, a planes tile only its
    dirty planes' words.  Its own cache, apart from the stacked engine's
    stacks (the two engines share no device state), of whole tiles, and
    the budget ledger's client ``"tile_cache"`` (memory/ledger.py): one
    budget covers both engines' device bytes, and the coldest tiles go
    first under pressure.  ``max_bytes`` is an explicit local cap."""

    def __init__(self, device: torch.device, max_bytes: int | None = None):
        self.device = device
        self.cache = StackCache(max_bytes, client="tile_cache",
                                device=device)

    def row(self, frag, row: int) -> torch.Tensor:
        return self.cache.get((frag.gen, row), [frag],
                              lambda: self._upload_row(frag, row),
                              lambda: FragRowsLayout(frag, [row]))

    def _upload_row(self, frag, row: int) -> torch.Tensor:
        t = self.cache.upload(frag.row_words(row))
        if t.device.type == "cpu":
            # to_tensor shared the host row's memory: the tile must not
            # follow a write, nor a patch land in the row
            t = t.clone()
        kernels.check_tile(t, frag.width // 32, self.device)
        return t

    def rows(self, frag, row_ids) -> kernels.RowTiles:
        """The (W,) tiles of row_ids for masked_popcount_shards, each
        checked where this cache uploaded it."""
        return kernels.RowTiles([self.row(frag, r) for r in row_ids],
                                frag.width // 32, self.device, checked=True)

    def planes(self, frag, depth: int) -> torch.Tensor:
        return self.cache.get(
            (frag.gen, "planes", depth), [frag],
            lambda: self.cache.upload(np.stack(
                [frag.row_words(r) for r in range(2 + depth)])),
            lambda: FragRowsLayout(frag, range(2 + depth)))


class Executor(AdvancedOps):
    def __init__(self, holder: Holder, device=None):
        self.holder = holder
        self.device = resolve_device(device)
        self.stacked = StackedEngine(self, self.device)
        # False runs every call on the per-shard engine (the oracle the
        # JAX package holds its stacked engine to)
        self.use_stacked = True
        self.tiles = TileCache(self.device)
        # (call, route) -> calls: "stacked", "asked" (use_stacked is
        # False), or why the per-shard engine took it
        self.paths: Counter = Counter()
        # the serving front (executor/serving.py): None until a caller
        # opts in with enable_serving()
        self.serving = None

    def set_mesh(self, mesh):
        """Run the stacked engine over a mesh (parallel.make_mesh), or on
        the executor's device again with None: every stacked call splits
        its shards over the mesh's slots and combines on the lead slot
        (executor/mesh_arm.py).  The per-shard engine stays on the
        executor's device."""
        self.stacked.set_mesh(mesh)

    def enable_serving(self, window_s: float = 0.001, max_batch: int = 32,
                       cache_bytes: int = 64 << 20, batching: bool = True,
                       **qos_kwargs):
        """Attach the serving layer (executor/serving.py): concurrent
        reads coalesce into one fused program a batch (the ragged
        cross-index page-table program where it can,
        executor/ragged.py) and repeated reads serve from the
        write-version-guarded result cache.  ``qos_kwargs`` go to the
        layer (ragged, admission, heavy_slots, queue_max,
        tenant_weights, default_deadline_ms).  A layer already attached
        is closed first.  Returns the layer."""
        from pilosa_tpu_torch.executor.serving import ServingLayer
        if self.serving is not None:
            self.serving.close()
        self.serving = ServingLayer(self, window_s=window_s,
                                    max_batch=max_batch,
                                    cache_bytes=cache_bytes,
                                    batching=batching, **qos_kwargs)
        return self.serving

    def execute_serving(self, index_name: str, query: str | Query,
                        shards: list[int] | None = None,
                        remote: bool = False, qos=None) -> list:
        """The serving entry: admission, the micro-batcher and the
        result cache when the layer is on, else ``execute``.  ``qos``
        (executor/sched.py QoS) carries the request's tenant, priority
        and deadline; ``remote`` marks a coordinator's leg (see
        ``execute``)."""
        if self.serving is None:
            return self.execute(index_name, query, shards, remote=remote)
        return self.serving.execute(index_name, query, shards,
                                    remote=remote, qos=qos)

    # -- entry point (executor.Execute analog) -------------------------------

    def execute(self, index_name: str, query: str | Query,
                shards: list[int] | None = None,
                remote: bool = False) -> list:
        """Run a query's calls over ``shards`` (every shard when None).
        ``remote`` marks a node-to-node leg whose column ids the
        coordinator translated (executor.go opt.Remote): a keyed index
        then takes raw column ids."""
        tok = _REMOTE.set(remote)
        try:
            return self._execute(index_name, query, shards)
        finally:
            _REMOTE.reset(tok)

    def _execute(self, index_name: str, query: str | Query,
                 shards: list[int] | None) -> list:
        t0 = time.perf_counter()
        status = "error"
        idx = self.holder.index(index_name)
        # only real index names label the metric: client strings would
        # grow its label set without bound
        known = idx is not None
        # None when a record is already open on this thread
        fl = flight.begin(index_name, query)
        try:
            if idx is None:
                raise ExecError(f"index not found: {index_name}")
            q = parse(query) if isinstance(query, str) else query
            out = []
            with start_span("executor.Execute", index=index_name) as sp:
                if fl is not None:
                    sp.set_tag("trace_id", fl["trace_id"])
                for c in q.calls:
                    with start_span(f"executor.execute{c.name}"):
                        res = self._execute_call(idx, c, shards)
                    # translateResults (executor.go:7519): a row result
                    # of a keyed index carries its column keys
                    if (isinstance(res, RowResult) and idx.keys
                            and not res.is_row_ids):
                        res.keys = idx.column_translator.translate_ids(
                            res.columns())
                    out.append(res)
            status = "ok"
            return out
        finally:
            metrics.QUERY_TOTAL.inc(
                index=index_name if known else "(unknown)", status=status)
            dur = time.perf_counter() - t0
            metrics.QUERY_DURATION.observe(dur)
            flight.commit(fl, dur, route="solo",
                          error=None if status == "ok" else status)

    def _execute_call(self, idx: Index, call: Call, shards, pre=None):
        """One call.  ``pre`` holds the query's nested cross-shard results
        (``_precompute_nested``); a top-level call computes its own."""
        name = call.name
        if pre is None:
            pre = self._precompute_nested(idx, call, shards)
        if name == "Options":
            return self._execute_options(idx, call, shards)
        if name in _WRITE_CALLS:
            return self._execute_write(idx, call, pre)
        if name == "Count":
            return self._reduce_count(idx, self._only_child(call), shards,
                                      pre)
        if name == "Sum":
            return self._execute_sum(idx, call, shards, pre)
        if name == "TopN":
            return self._execute_topnk(idx, call, shards, pre, "n")
        if name == "TopK":
            return self._execute_topnk(idx, call, shards, pre, "k")
        if name in ("Min", "Max"):
            return self._execute_minmax(idx, call, shards, name == "Min", pre)
        if name in ("MinRow", "MaxRow"):
            return self._execute_minmax_row(idx, call, shards,
                                            name == "MinRow", pre)
        if name == "FieldValue":
            return self._execute_field_value(idx, call)
        if name == "Distinct":
            return self._execute_distinct(idx, call, shards, pre)
        if name == "Rows":
            return self._execute_rows(idx, call, shards)
        if name == "UnionRows":
            return self._execute_union_rows(idx, call, shards)
        if name == "IncludesColumn":
            return self._execute_includes_column(idx, call, shards, pre)
        if name == "Limit":
            # an Extract filter's Limit was evaluated as a nested call
            if id(call) in pre:
                return pre[id(call)]
            return self._execute_limit(idx, call, shards, pre)
        if name == "GroupBy":
            return self._execute_groupby(idx, call, shards, pre)
        if name == "Percentile":
            return self._execute_percentile(idx, call, shards, pre)
        if name == "Sort":
            return self._execute_sort(idx, call, shards, pre)
        if name == "Extract":
            return self._execute_extract(idx, call, shards, pre)
        if name in _BITMAP_CALLS:
            return self._bitmap_result(idx, call, shards, pre)
        raise ExecError(f"unknown or non-bitmap call: {name}")

    def _only_child(self, call: Call) -> Call:
        if len(call.children) != 1:
            raise ExecError(f"{call.name} requires exactly one subquery")
        return call.children[0]

    def _shard_list(self, idx: Index, shards) -> list[int]:
        if shards is not None:
            return sorted(shards)
        return sorted(idx.available_shards) or [0]

    def _tree_shards(self, idx: Index, shards, pre: dict) -> list[int]:
        """The shards a bitmap tree walks: the query's, plus, when the
        query names none, every shard a nested result or a ConstRow sets
        a bit in (a nested Distinct's row ids can lie past the data)."""
        out = set(self._shard_list(idx, shards))
        if shards is None:
            for key, res in pre.items():
                if isinstance(key, tuple):          # ("constrow", id)
                    out.update(c // idx.width for c in res)
                else:
                    out.update(res.segments)
        return sorted(out)

    def _precompute_nested(self, idx: Index, call: Call, shards) -> dict:
        """The query's cross-shard operands, evaluated once: each
        Distinct, UnionRows and Limit nested below the root as a
        RowResult keyed by ``id(call)``, and each ConstRow's columns
        under ("constrow", id(call)).  A nested Distinct with ``index=``
        is the cross-index join: the other index's unkeyed INT values
        that are >= 0 become column ids.  A GroupBy's
        aggregate=Count(Distinct(...)) is no operand; only its filter
        is walked.  The JAX package nests Distinct and UnionRows; a
        nested Limit is this port's own (the JAX executor raises)."""
        pre: dict = {}

        def walk(c: Call, is_root: bool):
            for ch in c.children:
                walk(ch, False)
            for k, v in c.args.items():
                if not isinstance(v, Call):
                    continue
                if (c.name == "GroupBy" and k == "aggregate"
                        and v.name == "Count" and v.children
                        and v.children[0].name == "Distinct"):
                    for ch in v.children[0].children:
                        walk(ch, False)
                    continue
                walk(v, False)
            if not is_root and c.name == "Distinct":
                pre[id(c)] = self._nested_distinct(idx, c, shards, pre)
            elif not is_root and c.name == "UnionRows":
                pre[id(c)] = self._execute_union_rows(idx, c, shards)
            elif not is_root and c.name == "Limit":
                pre[id(c)] = self._execute_limit(idx, c, shards, pre)
            elif c.name == "ConstRow":
                pre[("constrow", id(c))] = self._constrow_cols(idx, c, {})

        walk(call, True)
        return pre

    def _nested_distinct(self, idx: Index, call: Call, shards,
                         pre: dict) -> RowResult:
        """A Distinct as a bitmap operand: a set field's row ids as
        columns, or, with index=, the cross-index join."""
        didx, dshards, dpre = idx, shards, pre
        iname = call.arg("index")
        if iname and iname != idx.name:
            didx = self.holder.index(iname)
            if didx is None:
                raise ExecError(f"index not found: {iname}")
            df = didx.field(call.arg("_field") or "")
            if (df is None or df.options.type != FieldType.INT
                    or df.options.keys):
                raise ExecError(
                    "cross-index Distinct requires an unkeyed int field")
            dshards, dpre = None, {}
        res = self._execute_distinct(didx, call, dshards, dpre, raw=True)
        if isinstance(res, DistinctValues):
            if didx is idx:
                raise ExecError("BSI Distinct cannot be nested as a bitmap "
                                "call")
            res = RowResult.from_columns(
                [v for v in res.values if isinstance(v, int) and v >= 0],
                idx.width)
        return res

    def _try_stacked(self, name: str, run):
        """(True, run()) when the stacked engine answers; (False, None)
        when the per-shard engine must, because use_stacked is False or
        the stacked engine refused the shape (Unstackable, raised before
        any device work).  Counts the route either way."""
        if not self.use_stacked:
            self.paths[(name, "asked")] += 1
            return False, None
        try:
            out = run()
        except Unstackable as e:
            self.paths[(name, e.reason)] += 1
            metrics.STACKED_QUERIES.inc(path="loop")
            return False, None
        self.paths[(name, "stacked")] += 1
        metrics.STACKED_QUERIES.inc(path="stacked")
        return True, out

    # -- bitmap calls --------------------------------------------------------

    def _bitmap_result(self, idx: Index, call: Call, shards,
                       pre: dict) -> RowResult:
        out = RowResult(idx.width)
        shard_list = self._tree_shards(idx, shards, pre)
        done, words = self._try_stacked(
            call.name, lambda: self.stacked.words(idx, call, shard_list, pre))
        if not done:
            words = bm.to_numpy(self._tree_stack(idx, call, shard_list, pre))
        if words is not None:
            for i, shard in enumerate(shard_list):
                if words[i].any():
                    out.segments[shard] = words[i]
        return out

    # -- the per-shard engine: bitmap calls on one shard ---------------------

    def _zeros(self, idx: Index) -> torch.Tensor:
        return torch.zeros(idx.width // 32, dtype=torch.int32,
                           device=self.device)

    def _tree_stack(self, idx: Index, call: Call, shard_list,
                    pre: dict) -> torch.Tensor:
        """(S, W) device words of a bitmap tree, one shard at a time
        ((0, W) for no shard)."""
        if not shard_list:
            return torch.zeros((0, idx.width // 32), dtype=torch.int32,
                               device=self.device)
        return torch.stack([self._bitmap_call_shard(idx, call, s, pre)
                            for s in shard_list])

    def _bitmap_call_shard(self, idx: Index, call: Call, shard: int,
                           pre: dict):
        """A bitmap call on one shard → (W,) device words
        (executeBitmapCallShard)."""
        name = call.name
        if name in ("Row", "Range"):
            return self._row_shard(idx, call, shard)
        if name in ("Union", "Xor"):
            return self._nary(idx, call, shard, pre,
                              bm.union if name == "Union" else bm.xor)
        if name in ("Intersect", "Difference"):
            if not call.children:
                raise ExecError(f"{name} requires at least one subquery")
            return self._nary(idx, call, shard, pre, bm.intersect
                              if name == "Intersect" else bm.difference)
        if name == "Not":
            return bm.difference(
                self._existence_shard(idx, shard),
                self._bitmap_call_shard(idx, self._only_child(call), shard,
                                        pre))
        if name == "All":
            return self._existence_shard(idx, shard)
        if name == "Shift":
            n = int(call.arg("n", 1))
            return bm.shift(self._bitmap_call_shard(
                idx, self._only_child(call), shard, pre), n)
        if name == "ConstRow":
            cols = self._constrow_cols(idx, call, pre)
            return bm.to_tensor(bm.from_columns(
                [c % idx.width for c in cols if c // idx.width == shard],
                idx.width), self.device)
        if name in NESTED_CALLS:
            res = pre.get(id(call))
            if res is None:
                raise ExecError(f"{name} has no precomputed result")
            return bm.to_tensor(res.shard_words(shard), self.device)
        raise ExecError(f"unknown or non-bitmap call: {name}")

    def _nary(self, idx, call: Call, shard: int, pre: dict, op):
        if not call.children:
            return self._zeros(idx)  # Union() and Xor() of nothing
        acc = self._bitmap_call_shard(idx, call.children[0], shard, pre)
        for c in call.children[1:]:
            acc = op(acc, self._bitmap_call_shard(idx, c, shard, pre))
        return acc

    def _existence_shard(self, idx: Index, shard: int):
        if not idx.track_existence:
            raise ExecError(
                "All()/Not() require existence tracking on the index")
        v = idx.fields[EXISTENCE_FIELD].views.get(VIEW_STANDARD)
        frag = v.fragment(shard) if v else None
        if frag is None:
            return self._zeros(idx)
        return self.tiles.row(frag, 0)

    def _row_shard(self, idx: Index, call: Call, shard: int):
        fname, cond = call.condition_field()
        if cond is not None:
            return self._bsi_condition_shard(idx, fname, cond, shard)
        fname, row_val = call.field_arg()
        if fname is None:
            raise ExecError("Row() requires a field argument")
        f = idx.field(fname)
        if f is None:
            raise ExecError(f"field not found: {fname}")
        if f.options.type.is_bsi:
            return self._bsi_condition_shard(
                idx, fname, Condition(past.OP_EQ, row_val), shard)
        row_id = self._row_id_for_value(f, row_val)
        if row_id is None:                  # an unknown row key
            return self._zeros(idx)
        try:
            views = f.views_for_range(call.arg("from"), call.arg("to"))
        except ValueError as e:
            raise ExecError(str(e)) from None
        acc = self._zeros(idx)
        for vn in views:
            v = f.views.get(vn)
            frag = v.fragment(shard) if v else None
            if frag is not None:
                acc = bm.union(acc, self.tiles.row(frag, row_id))
        return acc

    def _filter_words(self, idx: Index, call: Call, shard: int, pre: dict):
        """The optional filter child of Sum/Min/Max/Distinct on a shard."""
        if call.children:
            return self._bitmap_call_shard(idx, call.children[0], shard, pre)
        return None

    def _bsi_frag(self, f: Field, shard: int):
        v = f.views.get(f.bsi_view)
        return v.fragment(shard) if v else None

    def _row_id_for_value(self, f: Field, val, create: bool = False):
        """A row value as a row id: a string key through the field's
        row translator, found on a read (None for an unknown key: the
        row is empty) and created on a write."""
        if isinstance(val, bool):
            if f.options.type != FieldType.BOOL:
                raise ExecError(f"bool row value on non-bool field {f.name}")
            return TRUE_ROW if val else FALSE_ROW
        if isinstance(val, str):
            tr = f.row_translator
            if tr is None:
                raise ExecError(f"field {f.name} does not use string keys")
            if create:
                return tr.create_keys(val)[val]
            return tr.find_keys(val).get(val)
        if val is None:
            raise ExecError("null row value")
        if f.options.keys:
            raise ExecError(f"field {f.name} uses row keys; got id {val!r}")
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

    def _bsi_predicate(self, f: Field, cond: Condition):
        """A BSI condition planned on the host with the reference's
        plan-time scaling and out-of-range short cuts (executor.go
        Row(x > n)), for both engines: ("null",), ("notnull",),
        ("zeros",), or ("range", op, p, q, p_neg, q_neg), the arguments
        of kernels.bsi_range (unsigned magnitudes; q None but for
        "between")."""
        if cond.value is None:
            if cond.op == past.OP_EQ:
                return ("null",)
            if cond.op == past.OP_NEQ:
                return ("notnull",)
            raise ExecError(f"invalid null comparison {cond.op}")
        max_mag = (1 << f.bit_depth) - 1
        if past.is_between(cond):
            lo_raw, hi_raw = cond.value
            lo = self._scaled_bound(f, lo_raw, round_up=True)
            hi = self._scaled_bound(f, hi_raw, round_up=False)
            if cond.op in (past.OP_BTWN_LT_LT, past.OP_BTWN_LT_LTE):
                lo = max(lo, self._scaled_bound(f, lo_raw, round_up=False) + 1)
            if cond.op in (past.OP_BTWN_LT_LT, past.OP_BTWN_LTE_LT):
                hi = min(hi, self._scaled_bound(f, hi_raw, round_up=True) - 1)
            lo, hi = max(lo, -max_mag), min(hi, max_mag)
            if lo > hi:
                return ("zeros",)
            return ("range", "between", abs(lo), abs(hi), lo < 0, hi < 0)
        op = cond.op
        if op in (past.OP_EQ, past.OP_NEQ):
            p_lo = self._scaled_bound(f, cond.value, round_up=False)
            p_hi = self._scaled_bound(f, cond.value, round_up=True)
            if p_lo != p_hi or abs(p_lo) > max_mag:
                return ("zeros",) if op == past.OP_EQ else ("notnull",)
            return ("range", "eq" if op == past.OP_EQ else "neq", abs(p_lo),
                    None, p_lo < 0, False)
        if op in (past.OP_LT, past.OP_LTE):
            allow_eq = op == past.OP_LTE
            p = self._scaled_bound(f, cond.value, round_up=not allow_eq)
            if p > max_mag:
                return ("notnull",)
            if p < -max_mag:
                return ("zeros",)
            return ("range", "lte" if allow_eq else "lt", abs(p), None, p < 0,
                    False)
        if op in (past.OP_GT, past.OP_GTE):
            allow_eq = op == past.OP_GTE
            p = self._scaled_bound(f, cond.value, round_up=allow_eq)
            if p < -max_mag:
                return ("notnull",)
            if p > max_mag:
                return ("zeros",)
            return ("range", "gte" if allow_eq else "gt", abs(p), None, p < 0,
                    False)
        raise ExecError(f"unsupported condition op {op}")

    def _bsi_condition_shard(self, idx: Index, fname: str, cond: Condition,
                             shard: int):
        """A BSI predicate on one shard's plane tile, through bsi_range."""
        f = self._bsi_field(idx, fname)
        frag = self._bsi_frag(f, shard)
        if frag is None:
            if cond.value is None and cond.op == past.OP_EQ:
                return self._existence_shard(idx, shard)
            return self._zeros(idx)
        pred = self._bsi_predicate(f, cond)
        if pred[0] == "zeros":
            return self._zeros(idx)
        planes = self.tiles.planes(frag, f.bit_depth)
        if pred[0] == "null":
            return bm.difference(self._existence_shard(idx, shard),
                                 bsi_ops.not_null(planes))
        if pred[0] == "notnull":
            return bsi_ops.not_null(planes)
        return kernels.bsi_range(planes.unsqueeze(0), *pred[1:])[0]

    # -- aggregates ----------------------------------------------------------

    def _reduce_count(self, idx: Index, call: Call, shards, pre: dict) -> int:
        shard_list = self._tree_shards(idx, shards, pre)
        done, n = self._try_stacked(
            "Count", lambda: self.stacked.count(idx, call, shard_list, pre))
        if done:
            return n
        if not shard_list:
            return 0
        words = self._tree_stack(idx, call, shard_list, pre)
        return int(kernels.popcount_rows(words).sum(dtype=torch.int64))

    def _execute_sum(self, idx: Index, call: Call, shards,
                     pre: dict) -> ValCount:
        fname = call.arg("_field")
        if fname is None:
            raise ExecError("Sum requires field=")
        f = self._bsi_field(idx, fname)
        filter_call = call.children[0] if call.children else None
        shard_list = self._shard_list(idx, shards)
        done, out = self._try_stacked("Sum", lambda: self.stacked.bsi_sum(
            idx, f, filter_call, shard_list, pre))
        if done:
            total, count = out
            return ValCount(value=f.int_to_value(total), count=count)
        # one bsi_sum_counts launch per shard, fetched in one sync
        parts = []
        for shard in shard_list:
            frag = self._bsi_frag(f, shard)
            if frag is None:
                continue
            filt = self._filter_words(idx, call, shard, pre)
            parts.append(kernels.bsi_sum_counts(
                self.tiles.planes(frag, f.bit_depth).unsqueeze(0),
                None if filt is None else filt.unsqueeze(0)))
        total, count = 0, 0
        if parts:
            total, count = bsi_ops.host_sum(
                torch.cat([p[0] for p in parts]).sum(dtype=torch.int64).cpu(),
                torch.cat([p[1] for p in parts]).sum(
                    dim=0, dtype=torch.int64).cpu(),
                torch.cat([p[2] for p in parts]).sum(
                    dim=0, dtype=torch.int64).cpu())
        return ValCount(value=f.int_to_value(total), count=count)

    def _execute_minmax(self, idx: Index, call: Call, shards,
                        is_min: bool, pre: dict) -> ValCount:
        """Min/Max and the count of columns holding it: on the stacked
        engine read off the value histogram (one pass over the planes);
        on the per-shard engine each shard's branch-free plane walk
        (bsi.min_op/max_op), every shard queued before one fetch."""
        fname = call.arg("_field")
        if fname is None:
            raise ExecError(f"{call.name} requires field=")
        f = self._bsi_field(idx, fname)
        filter_call = call.children[0] if call.children else None
        shard_list = self._shard_list(idx, shards)
        done, hist = self._try_stacked(
            call.name, lambda: self.stacked.bsi_value_hist(
                idx, f, filter_call, shard_list, pre))
        if done:
            return self._minmax_from_hist(f, *hist, is_min)
        op = bsi_ops.min_op if is_min else bsi_ops.max_op
        outs = []
        for shard in shard_list:
            frag = self._bsi_frag(f, shard)
            if frag is None:
                continue
            outs.append(op(self.tiles.planes(frag, f.bit_depth),
                           self._filter_words(idx, call, shard, pre)))
        best, count = None, 0
        if not outs:
            return ValCount(value=None, count=0)
        is_neg, bits, counts, nonempty = (
            torch.stack([o[i] for o in outs]).cpu().numpy() for i in range(4))
        for i in range(len(outs)):
            val, c = bsi_ops.host_minmax(is_neg[i], bits[i], counts[i],
                                         nonempty[i])
            if c == 0:
                continue
            if best is None or (val < best if is_min else val > best):
                best, count = val, c
            elif val == best:
                count += c
        if best is None:
            return ValCount(value=None, count=0)
        return ValCount(value=f.int_to_value(best), count=count)

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

    def _execute_minmax_row(self, idx: Index, call: Call, shards,
                            is_min: bool, pre: dict) -> Pair:
        """MinRow/MaxRow (fragment.minRow/maxRow), on the per-shard engine
        only, as in the JAX package: per shard the lowest (highest) row
        with a bit, under the filter its count there (pair_popcount,
        rows in chunks, stopping at the first chunk with a hit), else
        count 1; shards reduce by row id and never sum counts
        (executor.go:1620)."""
        fname = call.arg("_field")
        f = idx.field(fname) if fname else None
        if f is None:
            raise ExecError(f"{call.name} requires a field")
        self.paths[(call.name, "only_route")] += 1
        filter_call = call.children[0] if call.children else None
        best: Pair | None = None
        for shard in self._shard_list(idx, shards):
            v = f.views.get(VIEW_STANDARD)
            frag = v.fragment(shard) if v else None
            rows = sorted(frag.row_ids) if frag is not None else []
            if not rows:
                continue
            if not is_min:
                rows = rows[::-1]
            if filter_call is None:
                cand = Pair(id=rows[0], count=1)
            else:
                filt = self._bitmap_call_shard(idx, filter_call, shard, pre)
                cand = None
                for i in range(0, len(rows), _ROW_CHUNK):
                    chunk = rows[i:i + _ROW_CHUNK]
                    got = self._pair_counts(f, shard, chunk, filt).tolist()
                    hit = next((j for j, c in enumerate(got) if c > 0), None)
                    if hit is not None:
                        cand = Pair(id=chunk[hit], count=got[hit])
                        break
                if cand is None:
                    continue
            if best is None or (cand.id < best.id if is_min
                                else cand.id > best.id):
                best = cand
        return best if best is not None else Pair(id=0, count=0)

    def _pair_counts(self, f: Field, shard: int, rows, filt) -> torch.Tensor:
        """popcount(row & filt) of each of a field's rows on one shard
        (pair_popcount, the filter repeated per row)."""
        return kernels.pair_popcount(
            self._row_tiles(f, shard, rows, [VIEW_STANDARD]),
            filt.unsqueeze(0).expand(len(rows), -1).contiguous())

    # -- Distinct / Rows -----------------------------------------------------

    def _execute_distinct(self, idx: Index, call: Call, shards, pre: dict,
                          raw: bool = False):
        """Distinct over a BSI field (DistinctValues) or a set field (a
        RowResult of the row ids with a bit under the filter; on a keyed
        field the row keys, sorted, as DistinctValues).  ``raw`` (a
        nested Distinct) takes the row ids as they are."""
        fname = call.arg("_field")
        if fname is None:
            raise ExecError("Distinct requires field=")
        f = idx.field(fname)
        if f is None:
            raise ExecError(f"field not found: {fname}")
        if f.options.type.is_bsi:
            return self._distinct_bsi(idx, f, call, shards, pre)
        res = self._distinct_set(idx, f, call, shards, pre)
        if f.options.keys and not raw:
            return DistinctValues(values=sorted(
                k for k in f.row_translator.translate_ids(res.columns())
                if k is not None))
        return res

    def _distinct_bsi(self, idx: Index, f: Field, call: Call, shards,
                      pre: dict) -> DistinctValues:
        """The nonzero codes of the value histogram; past its depth the
        stacked engine's decode stream; on the per-shard engine (or past
        depth 62) the host loop."""
        if self.use_stacked and f.bit_depth > 62:
            self.paths[("Distinct", "decode_depth")] += 1
            return self._distinct_bsi_loop(idx, f, call, shards, pre)
        filter_call = call.children[0] if call.children else None
        shard_list = self._shard_list(idx, shards)
        done, hist = self._try_stacked(
            "Distinct", lambda: self.stacked.bsi_value_hist(
                idx, f, filter_call, shard_list, pre))
        if done:
            vals = kernels.distinct_from_hist(*hist)
        elif not self.use_stacked:
            return self._distinct_bsi_loop(idx, f, call, shards, pre)
        else:
            vals = self._distinct_decode_stream(idx, f, filter_call,
                                                shard_list, pre)
        return DistinctValues(values=sorted(f.int_to_value(v) for v in vals))

    def _distinct_decode_stream(self, idx: Index, f: Field, filter_call,
                                shard_list, pre: dict) -> list[int]:
        """BSI Distinct past the value histogram's depth: the stacked
        engine's decode stream, the filter tree evaluated per chunk of
        shards, unique values taken on the device."""
        uniq = []
        for chunk, ex, vals in self.stacked.decode_stream(
                idx, f, tuple(shard_list)):
            sel = ex
            if filter_call is not None:
                filt = self.stacked.filter_stack(idx, filter_call,
                                                 tuple(chunk), pre)
                if filt is None:
                    return []
                sel = sel & (bm.unpack_bits(filt) == 1)
            uniq.append(torch.unique(vals[sel]))
        if not uniq:
            return []
        return torch.unique(torch.cat(uniq)).cpu().tolist()

    def _distinct_bsi_loop(self, idx: Index, f: Field, call: Call, shards,
                           pre: dict) -> DistinctValues:
        """BSI Distinct on the per-shard engine: a host loop that decodes
        each fragment's row_words in exact ints (bsi.decode), as the JAX
        package's loop does."""
        vals: set[int] = set()
        for shard in self._shard_list(idx, shards):
            frag = self._bsi_frag(f, shard)
            if frag is None:
                continue
            filt = self._filter_words(idx, call, shard, pre)
            cols, values = bsi_ops.decode(np.stack(
                [frag.row_words(r) for r in range(2 + f.bit_depth)]))
            if filt is not None:
                fbits = bsi_ops.unpack_bits_np(bm.to_numpy(filt))
                values = [v for c, v in zip(cols, values) if fbits[int(c)]]
            vals.update(values)
        return DistinctValues(values=sorted(f.int_to_value(v) for v in vals))

    def _distinct_set(self, idx: Index, f: Field, call: Call, shards,
                      pre: dict) -> RowResult:
        """Set-field Distinct: the row ids with a bit in the filter.  With
        a filter on the stacked engine, the TopN candidate scan; without
        one a walk over the fragments' row ids (no device work), on the
        per-shard engine pair_popcount per shard, fetched in one sync."""
        filter_call = call.children[0] if call.children else None
        present: set[int] = set()
        done = False
        if filter_call is not None:
            def run():
                row_ids = self._all_row_ids(idx, f, shards)
                return [p.id for p in self._topnk_stacked(
                    idx, f, row_ids, [VIEW_STANDARD], filter_call, shards,
                    pre, None)] if row_ids else []
            done, got = self._try_stacked("Distinct", run)
            if done:
                present = set(got)
        else:
            self.paths[("Distinct", "unfiltered_set" if self.use_stacked
                        else "asked")] += 1
        if not done:
            found = []
            for shard in self._shard_list(idx, shards):
                v = f.views.get(VIEW_STANDARD)
                frag = v.fragment(shard) if v else None
                if frag is None:
                    continue
                rows = frag.row_ids
                if filter_call is None:
                    present.update(rows)
                    continue
                filt = self._bitmap_call_shard(idx, filter_call, shard, pre)
                for i in range(0, len(rows), _ROW_CHUNK):
                    chunk = rows[i:i + _ROW_CHUNK]
                    found.append((chunk,
                                  self._pair_counts(f, shard, chunk, filt)))
            if found:
                counts = torch.cat([c for _, c in found]).cpu().tolist()
                ids = [r for chunk, _ in found for r in chunk]
                present.update(r for r, c in zip(ids, counts) if c > 0)
        res = RowResult.from_columns(present, idx.width)
        res.is_row_ids = True
        return res

    def _rows_field(self, idx: Index, call: Call) -> Field:
        """The field of a Rows() call."""
        fname = call.arg("_field")
        f = idx.field(fname) if fname else None
        if f is None:
            raise ExecError("Rows requires a field")
        return f

    def _rows_ids(self, idx: Index, call: Call, shards) -> list[int]:
        """Row ids of Rows(field) (executeRowsShard basics): column= (an
        id or a column key), like= on a keyed field, previous= (a row id
        or, on a keyed field, a key), limit=, and from=/to= on time
        fields."""
        f = self._rows_field(idx, call)
        column = call.arg("column")
        if column is not None:
            column = self._col_id(idx, column)
            if column is None:
                return []             # an unknown column key matches none
        views = self._field_views(f, call.arg("from"), call.arg("to"))
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
        like = call.arg("like")
        if like is not None:
            tr = f.row_translator
            if tr is None:
                raise ExecError("Rows(like=) requires a keyed field")
            # PQL's key-filter matcher (like.go); _like_sql asks for the
            # SQL scalar operator's
            pat = (sql_like_regex(like) if call.arg("_like_sql")
                   else like_regex(like))
            ids &= set(tr.match(lambda k: pat.match(k) is not None))
        out = sorted(ids)
        previous = call.arg("previous")
        if previous is not None:
            if isinstance(previous, str):
                previous = self._row_key_id(f, previous)
            out = [r for r in out if r > int(previous)]
        limit = call.arg("limit")
        if limit is not None:
            out = out[:int(limit)]
        return out

    def _row_key_id(self, f: Field, key: str,
                    unkeyed: str = "string previous= requires a keyed "
                                   "field") -> int:
        """The id of an existing row key named by previous= (``unkeyed``,
        the error on an unkeyed field)."""
        tr = f.row_translator
        if tr is None:
            raise ExecError(unkeyed)
        found = tr.find_keys(key)
        if key not in found:
            raise ExecError(f"previous= key not found: {key!r}")
        return found[key]

    def _execute_rows(self, idx: Index, call: Call, shards) -> list:
        """Rows(field): the row ids, read off the fragments on the host;
        on a keyed field their keys (an id with no key stays an id)."""
        self.paths[("Rows", "only_route")] += 1
        out = self._rows_ids(idx, call, shards)
        f = self._rows_field(idx, call)
        if f.options.keys:
            keys = f.row_translator.translate_ids(out)
            return [k if k is not None else r for k, r in zip(keys, out)]
        return out

    def _execute_union_rows(self, idx: Index, call: Call,
                            shards) -> RowResult:
        """UnionRows(Rows(...), ...): the union of the rows each Rows()
        names, over its from=/to= views.  On the stacked engine an OR
        over the rows' (R, S, W) stack on the device (the stack the
        TopN scan builds); on the per-shard engine an OR of each shard's
        row tiles."""
        specs = []
        for child in call.children:
            if child.name != "Rows":
                raise ExecError("UnionRows expects Rows() arguments")
            f = self._rows_field(idx, child)
            row_ids = self._rows_ids(idx, child, shards)
            views = self._field_views(f, child.arg("from"), child.arg("to"))
            if row_ids and views:
                specs.append((f, views, row_ids))
        shard_list = self._shard_list(idx, shards)
        done, words = self._try_stacked(
            "UnionRows", lambda: self._union_rows_stacked(idx, specs,
                                                          shard_list))
        if not done:
            acc = torch.zeros((len(shard_list), idx.width // 32),
                              dtype=torch.int32, device=self.device)
            for i, shard in enumerate(shard_list):
                for f, views, row_ids in specs:
                    acc[i] |= bm.union_rows(
                        self._row_tiles(f, shard, row_ids, views))
            words = acc
        out = RowResult(idx.width)
        if words is not None:
            host = np.array(bm.to_numpy(words))
            for i, shard in enumerate(shard_list):
                if host[i].any():
                    out.segments[shard] = host[i]
        return out

    def _union_rows_stacked(self, idx: Index, specs, shard_list):
        """(S, W) device union of the specs' rows, or None for none."""
        eng = self.stacked
        skey = tuple(shard_list)
        chunk = max(1, self._ROWS_STACK_BUDGET
                    // (len(skey) * (idx.width // 32) * 4))
        acc = None
        for f, views, row_ids in specs:
            for i in range(0, len(row_ids), chunk):
                rows = eng.rows_stack_for(idx, f, tuple(views),
                                          row_ids[i:i + chunk], skey)
                part = bm.union_rows(rows)
                acc = part if acc is None else acc | part
        return acc

    def _execute_limit(self, idx: Index, call: Call, shards,
                       pre: dict) -> RowResult:
        """Limit(child, limit=, offset=): the child's columns from the
        offset-th on, at most limit of them, in column order.  The
        child's (S, W) words are counted per shard (popcount_rows); a
        prefix sum on the host finds the shards that hold [offset,
        offset + limit), and only those come back to the host.  A
        negative limit or offset takes Python's slice of the child's
        columns [offset:offset + limit], as the JAX package does."""
        child = self._only_child(call)
        limit = call.arg("limit")
        offset = int(call.arg("offset", 0))
        shard_list = self._tree_shards(idx, shards, pre)
        done, words = self._try_stacked(
            "Limit", lambda: self.stacked.filter_stack(
                idx, child, tuple(shard_list), pre))
        if not done:
            words = self._tree_stack(idx, child, shard_list, pre)
        if words is None:
            return RowResult(idx.width)
        if offset < 0 or (limit is not None and int(limit) < 0):
            host = bm.to_numpy(words)
            row = RowResult(idx.width)
            row.segments = {s: host[i] for i, s in enumerate(shard_list)}
            end = None if limit is None else offset + int(limit)
            return RowResult.from_columns(row.columns()[offset:end],
                                          idx.width)
        ends = np.cumsum(kernels.popcount_rows(words).cpu().numpy(),
                         dtype=np.int64)
        stop = int(ends[-1])
        if limit is not None:
            stop = min(stop, offset + int(limit))
        if offset >= stop:
            return RowResult(idx.width)
        lo = int(np.searchsorted(ends, offset, side="right"))
        hi = int(np.searchsorted(ends, stop, side="left"))
        # in the pulled shards' words, a prefix sum of word popcounts
        # finds the words that hold the wanted bits: only those unpack
        host = bm.to_numpy(words[lo:hi + 1]).reshape(-1)
        wends = np.cumsum(np.bitwise_count(host), dtype=np.int64)
        first = offset - (int(ends[lo - 1]) if lo else 0)
        last = first + stop - offset
        w0 = int(np.searchsorted(wends, first, side="right"))
        w1 = int(np.searchsorted(wends, last, side="left"))
        bits = bm.to_columns(host[w0:w1 + 1]).astype(np.int64) + w0 * 32
        skip = first - (int(wends[w0 - 1]) if w0 else 0)
        bits = bits[skip:skip + stop - offset]
        shard_of = np.asarray(shard_list[lo:hi + 1], dtype=np.int64)
        return RowResult.from_columns(
            shard_of[bits // idx.width] * idx.width + bits % idx.width,
            idx.width)

    def _execute_includes_column(self, idx: Index, call: Call, shards,
                                 pre: dict) -> bool:
        """Whether the child's row holds column=: the child's tree on the
        column's shard alone."""
        col = call.arg("column")
        if col is None:
            raise ExecError("IncludesColumn requires column=")
        col = self._col_id(idx, col)
        if col is None:
            return False
        shard, c = divmod(col, idx.width)
        if shards is not None and shard not in set(shards):
            return False
        child = self._only_child(call)
        done, words = self._try_stacked(
            "IncludesColumn", lambda: self.stacked.words(idx, child, [shard],
                                                         pre))
        if not done:
            words = bm.to_numpy(
                self._bitmap_call_shard(idx, child, shard, pre))[None]
        return words is not None and bool((int(words[0][c >> 5])
                                           >> (c & 31)) & 1)

    def _execute_options(self, idx: Index, call: Call, shards):
        """Options(child, shards=[...]): the child on that shard list."""
        child = self._only_child(call)
        opt = call.arg("shards")
        if opt is not None:
            shards = [int(s) for s in opt]
        return self._execute_call(idx, child, shards)

    def _execute_field_value(self, idx: Index, call: Call) -> ValCount:
        """FieldValue(field=f, column=c): the column's BSI value, read
        off the fragment's planes on the host, with count 1; (None, 0)
        when the column holds none."""
        fname = call.arg("_field") or call.arg("field")
        f = idx.field(fname) if fname else None
        if f is None:
            raise ExecError("FieldValue requires a field")
        if not f.options.type.is_bsi:
            raise ExecError(
                "FieldValue requires an int/decimal/timestamp field")
        col = call.arg("column")
        if col is None:
            raise ExecError("FieldValue requires a column")
        self.paths[("FieldValue", "only_route")] += 1
        col = self._col_id(idx, col)
        if col is None:
            return ValCount(value=None, count=0)
        shard, c = divmod(col, idx.width)
        frag = self._bsi_frag(f, shard)

        def bit(row: int) -> int:
            return (int(frag.row_words(row)[c >> 5]) >> (c & 31)) & 1

        if frag is None or not bit(0):
            return ValCount(value=None, count=0)
        mag = sum(1 << i for i in range(f.bit_depth) if bit(2 + i))
        return ValCount(value=f.int_to_value(-mag if bit(1) else mag),
                        count=1)

    def _constrow_cols(self, idx: Index, call: Call, pre: dict) -> list[int]:
        """ConstRow(columns=[...])'s column ids, keys translated (computed
        once a query into ``pre``, the preTranslate of executor.go:6814);
        an unknown key matches nothing.  An int is a column id, on a
        keyed index too (SQL's ``WHERE _id = 'key'`` sends the id it
        found), as in the JAX package."""
        cols = pre.get(("constrow", id(call)))
        if cols is None:
            cols = [c for c in (self._col_id(idx, c) if isinstance(c, str)
                                else int(c)
                                for c in call.arg("columns", []) or [])
                    if c is not None]
        return cols

    def _col_id(self, idx: Index, col, create: bool = False):
        """A column value as a column id: a string key through the index's
        column translator, found on a read (None for an unknown key) and
        created on a write.  A keyed index takes keys only, except on a
        remote leg (``_REMOTE``)."""
        if isinstance(col, str):
            tr = idx.column_translator
            if tr is None:
                raise ExecError(f"index {idx.name} does not use column keys")
            if create:
                return tr.create_keys(col)[col]
            return tr.find_keys(col).get(col)
        if idx.keys and not _REMOTE.get():
            raise ExecError(f"index {idx.name} uses column keys; got id "
                            f"{col!r}")
        return int(col)

    # -- writes (executeSet, executeClear, ... analogs) ----------------------

    def _execute_write(self, idx: Index, call: Call, pre: dict):
        name = call.name
        if name == "Store":
            return self._execute_store(idx, call, pre)
        if name == "Delete":
            return self._execute_delete(idx, call, pre)
        self.paths[(name, "only_route")] += 1
        if name == "Set":
            return self._execute_set(idx, call)
        if name == "Clear":
            return self._execute_clear(idx, call)
        return self._execute_clear_row(idx, call)

    def _write_field(self, idx: Index, call: Call, what: str = "value"):
        fname, val = call.field_arg()
        if fname is None:
            raise ExecError(f"{call.name} requires field={what}")
        f = idx.field(fname)
        if f is None:
            raise ExecError(f"field not found: {fname}")
        return f, val

    def _write_col(self, idx: Index, call: Call, create: bool):
        col = call.arg("_col")
        if col is None:
            raise ExecError(f"{call.name} requires a column")
        return self._col_id(idx, col, create)

    def _execute_set(self, idx: Index, call: Call) -> bool:
        """Set(col, f=row) or Set(col, f=value): the bit (in the time
        views too, given a timestamp) or the BSI value; keys are created;
        the column is marked as existing."""
        col = self._write_col(idx, call, create=True)
        f, val = self._write_field(idx, call)
        if f.options.type.is_bsi:
            changed = f.set_value(col, val)
        else:
            ts = call.arg("_timestamp")
            changed = f.set_bit(
                self._row_id_for_value(f, val, create=True), col,
                timestamp=timeq.parse_time(ts) if ts else None)
        idx.mark_columns_exist([col])
        return changed

    def _execute_clear(self, idx: Index, call: Call) -> bool:
        """Clear(col, f=row): the bit in every view; on a BSI field the
        column's value.  An unknown key clears nothing."""
        col = self._write_col(idx, call, create=False)
        if col is None:
            return False
        f, val = self._write_field(idx, call)
        if f.options.type.is_bsi:
            return f.clear_value(col)
        row_id = self._row_id_for_value(f, val)
        return False if row_id is None else f.clear_bit(row_id, col)

    def _execute_store(self, idx: Index, call: Call, pre: dict) -> bool:
        """Store(child, f=row): the child's columns become the row, shard
        by shard over the index's shards (a missing field is created as
        a set field).  The child is evaluated once."""
        child = self._only_child(call)
        fname, val = call.field_arg()
        if fname is None:
            raise ExecError("Store requires field=row")
        f = idx.field(fname)
        if f is None:
            f = idx.create_field(fname)
        row_id = self._row_id_for_value(f, val, create=True)
        shard_list = self._shard_list(idx, None)
        done, words = self._try_stacked(
            "Store", lambda: self.stacked.words(idx, child, shard_list, pre))
        if not done:
            words = bm.to_numpy(self._tree_stack(idx, child, shard_list, pre))
        view = f.view(VIEW_STANDARD, create=True)
        for i, shard in enumerate(shard_list):
            view.fragment(shard, create=True).set_row_words(
                row_id, 0 if words is None else words[i])
        return True

    def _execute_clear_row(self, idx: Index, call: Call) -> bool:
        """ClearRow(f=row): the row emptied in every view and shard."""
        f, val = self._write_field(idx, call, "row")
        row_id = self._row_id_for_value(f, val)
        if row_id is None:
            return False
        changed = False
        for v in f.views.values():
            for frag in v.fragments.values():
                if frag.row_count(row_id):
                    frag.set_row_words(row_id, 0)
                    changed = True
        return changed
