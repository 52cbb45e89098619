"""The stacked engine: PQL bitmap trees over (S, W) shard stacks.

A query's bitmap tree compiles to a small static IR whose leaves are
device-resident shard stacks — one ``(S, W)`` int32 tensor per row,
``(S, 2+depth, W)`` per BSI field, ``(R, S, W)`` per TopN candidate
block — gathered from the fragments' host rows and kept on the
engine's device in a cache keyed by the fragments' ``(gen, version)``
stamps (``StackCache``: paged and held in the process's device budget,
``memory/``).  The IR is evaluated eagerly with torch bitwise ops
(``_eval``); every popcount goes through one of the four kernels of
``ops/kernels.py``, so on the card the plan kinds below run on CUDA
kernels end to end:

- ``words``      — the (S, W) result of a bitmap tree (ConstRow and the
  nested Distinct, UnionRows and Limit enter it as uploaded leaves)
- ``count``      — per-shard popcounts of a tree: ``popcount_rows`` on a
  leaf or an evaluated tree, ``pair_popcount`` on Intersect(leaf, leaf)
- ``bsi_sum``    — ``bsi_sum_counts`` over a plane stack and an optional
  filter tree
- ``row_counts`` — TopN candidate counts: ``popcount_rows`` unfiltered,
  ``rows_filter_counts`` under a filter tree

GroupBy and the BSI value histogram run beside the plan kinds: the
one-pass group-code histogram for disjoint fields, the per-combo kernel
(``groupby_sum``) for overlapping rows or past the histogram's bounds,
and ``bsi_value_hist`` (the one-pass histogram over the plane stack)
for Min, Max and BSI Distinct.  The one-pass histogram is
``groupby_fused``, or ``groupby_onehot`` where ``onepass_arm`` is
``"onehot"`` and the shape is within its bounds (no Min/Max table, at
most 4096 codes and depth 16).  ``decode_stream`` decodes BSI values
per column in chunks of shards, for BSI Distinct past the value
histogram's depth.

Shapes the JAX package hands to its host loops raise ``Unstackable``
with a reason; the executor routes them to its per-shard engine (or to
``decode_stream``) and counts the route.

A time range over more than one quantum view plans, under
``timeq.qcover()`` (the default), as a ``("qcover", (leaf, ...))`` node:
one single-view row leaf a cover member, unioned in ``_eval``.  Each
leaf is cached under its own view, so a rolling window builds only the
view that entered the cover, a write at the live edge patches one
leaf, and overlapping covers and one-view rows share leaves.  With
qcover off the cover is one multi-view leaf, ORed on the host.

The engine carries the JAX package's seams: the ``stacked.plan_build``,
``stacked.stack`` (every access that is not a hit) and
``stacked.dispatch`` spans, the flight recorder's phases and stack
outcomes, the ``pilosa_stack_cache_total`` outcomes and
``pilosa_stack_maintenance_bytes_total``, and the ``device-patch``
fault point, whose injected fault is answered by a rebuild counted
under the reason "fault".

Two meshes reach the engine.  ``set_mesh`` (executor/mesh_arm.py) runs
each engine method on the slots of a ``parallel.Mesh``, each over its
slice of the shards, and combines on the lead slot.  The serving mesh
(memory/placement.py) keeps the single-device methods but gives every
paged stack a device axis: its lanes page by their shard's owner slot,
each page on its owner's device; a fetch assembles such a stack on the
engine's device (``_assemble_placed``), and the serving layer's ragged
program runs on the owners (``_ragged_mesh_run``).  An empty shard list
answers without a stack or a kernel.

Per-shard partials are int32 (counts < 2^20 per shard); cross-shard
totals are summed as int64 on the device and combined as Python ints.
Histogram and per-combo totals are int32 on the device, exact below
``_REDUCE_MAX_SHARDS`` shards; past it the shards go in chunks whose
totals are summed as int64 on the host.
"""

from __future__ import annotations

import contextlib
import hashlib
import logging
import threading
import time
from collections import Counter, OrderedDict

import numpy as np
import torch

from pilosa_tpu_torch import memory
from pilosa_tpu_torch.executor.mesh_arm import (MeshArm, cat_on,
                                                minmax_table_on, sum_on)
from pilosa_tpu_torch.memory import encode, placement, policy, pressure
from pilosa_tpu_torch.memory.pages import PagedStack, StackRecipe, page_lanes_for
from pilosa_tpu_torch.models import timeq
from pilosa_tpu_torch.models.schema import FieldType
from pilosa_tpu_torch.models.view import VIEW_STANDARD
from pilosa_tpu_torch.obs import faults, flight, metrics, roofline, stats
from pilosa_tpu_torch.obs.tracing import start_span
from pilosa_tpu_torch.ops import bitmap as bm
from pilosa_tpu_torch.ops import bsi as bsi_ops
from pilosa_tpu_torch.ops import kernels
from pilosa_tpu_torch.pql import ast as past
from pilosa_tpu_torch.pql.ast import Call, Condition


class ExecError(Exception):
    pass


class Unstackable(ExecError):
    """A shape the stacked engine refuses, under the JAX package's own
    conditions: the executor takes the per-shard engine (or, for BSI
    Distinct, the decode stream) instead and counts ``reason``.  Raised
    before any device work, never for a failed build or launch."""

    def __init__(self, reason: str, message: str):
        super().__init__(message)
        self.reason = reason


# cross-shard calls that enter a bitmap tree as operands, evaluated
# once a query (Executor._precompute_nested)
NESTED_CALLS = ("Distinct", "UnionRows", "Limit")

_NARY_OPS = {
    "union": bm.union,
    "intersect": bm.intersect,
    "difference": bm.difference,
    "xor": bm.xor,
}

# admission cap: one paged entry retains at most this share of the
# budget; its other pages serve the query and are not kept, so a broad
# scan streams its tail instead of evicting the hot set
_ENTRY_RESIDENT_FRAC = 0.5

# a patch dirtying more than this share of a stack's words rebuilds it
# instead (the JAX package's default; its environment knob and
# stats-calibrated break-even are not carried over)
_PATCH_MAX_FRAC = 0.5

# int32 device totals over S shards of 2^20 columns stay exact while
# S * 2^20 < 2^31
_REDUCE_MAX_SHARDS = 2000

# one-pass GroupBy: the dense code space is 2^sum(digit bits) codes;
# Min/Max over it keeps the reference's depth bound
_ONEPASS_MAX_CODES = 1 << 20
_ONEPASS_MINMAX_MAX_DEPTH = 16

# value histogram: 2^(depth+1) signed-value codes, within the code bound
_VALUEHIST_MAX_DEPTH = 19

# bytes of (R, S, W) row stacks one per-combo kernel call may gather
_GROUPBY_STACK_BUDGET = 1 << 31

# shards per decode_stream step: a (64, 2^20) int64 value block is 512 MiB
_DECODE_CHUNK = 64

ONEPASS_ARMS = ("fused", "onehot")

_log = logging.getLogger("pilosa_tpu_torch.stacked")


# ---------------------------------------------------------------------------
# GroupBy code space
# ---------------------------------------------------------------------------

def _code_space(fields_rows):
    """Power-of-two digit layout of the dense group-code space:
    (bits_per_field, shift_per_field, n_codes).  Field f's digit (its
    row-list index) occupies bits [shift_f, shift_f + bits_f) of the
    code; codes with a digit >= R_f never occur."""
    bits = [bm.digit_bits(len(rl)) for _, rl in fields_rows]
    shifts, acc = [], 0
    for b in bits:
        shifts.append(acc)
        acc += b
    return bits, shifts, 1 << acc


def _combo_codes(shifts, combos_arr: np.ndarray) -> np.ndarray:
    """Combo index tuples (C, nf) → dense group codes (C,)."""
    codes = np.zeros(combos_arr.shape[0], dtype=np.int64)
    for fi, sh in enumerate(shifts):
        codes |= combos_arr[:, fi].astype(np.int64) << sh
    return codes


def _zero_groupby_result(n_combos: int, depth: int, agg_field,
                         agg_op: str = "sum"):
    """(counts, agg) zeros for a statically empty filter."""
    zeros = np.zeros(n_combos, dtype=np.int64)
    if agg_field is None:
        return zeros, None
    if agg_op in ("min", "max"):
        return zeros, (zeros.copy(), zeros.copy())
    return zeros, (zeros.copy(), np.zeros((n_combos, depth), np.int64),
                   np.zeros((n_combos, depth), np.int64))


# ---------------------------------------------------------------------------
# IR evaluation and plan kinds
# ---------------------------------------------------------------------------

def _eval(node, leaves, params):
    """Evaluate a static IR node to an int32 word tensor."""
    k = node[0]
    if k == "leaf":
        return leaves[node[1]]
    if k == "zeros":
        return 0  # broadcasts through every bitwise op
    if k == "nary":
        op = _NARY_OPS[node[1]]
        acc = _eval(node[2][0], leaves, params)
        for c in node[2][1:]:
            acc = op(acc, _eval(c, leaves, params))
        return acc
    if k == "not":
        return bm.difference(leaves[node[1]], _eval(node[2], leaves, params))
    if k == "qcover":
        # a time range's cover: the union of its single-view leaves,
        # ORed into the first union's fresh tensor
        acc = bm.union(leaves[node[1][0]], leaves[node[1][1]])
        for i in node[1][2:]:
            acc |= leaves[i]
        return acc
    if k == "shift":
        return bm.shift(_eval(node[2], leaves, params), node[1])
    if k == "bsi_range":
        return kernels.bsi_range(leaves[node[1]], node[2],
                                 *(params[i] for i in node[3:]))
    if k == "bsi_notnull":
        return bsi_ops.not_null(leaves[node[1]])
    if k == "bsi_null":
        return bm.difference(leaves[node[2]],
                             bsi_ops.not_null(leaves[node[1]]))
    raise AssertionError(f"bad IR node {k}")


def _as_stack(tree, leaves, params) -> torch.Tensor:
    """A tree evaluated to a contiguous (S, W) stack.  The builder folds
    ("zeros",) away below the root, so a scalar here is an IR bug."""
    out = _eval(tree, leaves, params)
    if not isinstance(out, torch.Tensor) or out.ndim != 2:
        raise AssertionError("stacked IR did not produce an (S, W) stack")
    return out.contiguous()


# plan kind -> roofline op family (obs/roofline.py): the op labels of
# pilosa_device_bandwidth_{gbps,fraction}
ROOF_OPS = {"count": "count", "words": "row", "row_counts": "topn",
            "bsi_sum": "sum", "multi": "multi"}


def leaf_bytes(leaves) -> int:
    """Bytes of a plan's tensor operands, each read once."""
    return sum(t.numel() * t.element_size() for t in leaves
               if isinstance(t, torch.Tensor))


def _count_partials(tree, leaves, params) -> torch.Tensor:
    """(S,) per-shard popcounts of a tree, always through a kernel."""
    if tree[0] == "leaf":
        return kernels.popcount_rows(leaves[tree[1]])
    if (tree[0] == "nary" and tree[1] == "intersect" and len(tree[2]) == 2
            and all(c[0] == "leaf" for c in tree[2])):
        return kernels.pair_popcount(leaves[tree[2][0][1]],
                                     leaves[tree[2][1][1]])
    return kernels.popcount_rows(_as_stack(tree, leaves, params))


def _plan_run(plan):
    """``run(leaves, params)`` for one plan:
    ("words", tree) | ("count", tree[, reduce]) | ("bsi_sum", planes_i,
    tree|None[, reduce]) | ("row_counts", rows_i, tree|None[, reduce])
    | ("gb_hist", ...) | ("multi", subplans) | ("ragged", ...) |
    ("ragged_mesh", ...).  With
    ``reduce`` true a per-shard output is summed over the shards as
    int64 on the device (the serving layer's fused subplans)."""
    kind = plan[0]
    if kind == "multi":
        # the micro-batcher's fused batch (executor/serving.py): every
        # subplan over one shared leaf/param space, one output each
        runs = tuple(_plan_run(p) for p in plan[1])

        def run(leaves, params):
            return tuple(r(leaves, params) for r in runs)
        return run
    if kind == "ragged":
        return _ragged_run(plan)
    if kind == "ragged_mesh":
        return _ragged_mesh_run(plan)
    if kind == "gb_hist":
        return _gb_hist_run(plan)
    n = _REDUCIBLE.get(kind)
    if n is not None and len(plan) > n:
        inner = _plan_run(plan[:n])
        if not plan[n]:
            return inner

        def run(leaves, params):
            out = inner(leaves, params)
            if kind == "bsi_sum":
                return tuple(x.sum(dim=0, dtype=torch.int64) for x in out)
            if kind == "row_counts":
                return out.sum(dim=1, dtype=torch.int64)
            return out.sum(dtype=torch.int64)
        return run
    if kind == "words":
        tree = plan[1]

        def run(leaves, params):
            return _as_stack(tree, leaves, params)
    elif kind == "count":
        tree = plan[1]

        def run(leaves, params):
            return _count_partials(tree, leaves, params)      # (S,)
    elif kind == "bsi_sum":
        planes_i, tree = plan[1], plan[2]

        def run(leaves, params):
            filt = None if tree is None else (
                leaves[tree[1]] if tree[0] == "leaf"
                else _as_stack(tree, leaves, params))
            return kernels.bsi_sum_counts(leaves[planes_i], filt)
    elif kind == "row_counts":
        rows_i, tree = plan[1], plan[2]

        def run(leaves, params):
            rows = leaves[rows_i]                                # (R, S, W)
            if tree is None:
                r, s, w = rows.shape
                return kernels.popcount_rows(
                    rows.reshape(r * s, w)).reshape(r, s)
            filt = (leaves[tree[1]] if tree[0] == "leaf"
                    else _as_stack(tree, leaves, params))
            return kernels.rows_filter_counts(rows, filt)       # (R, S)
    else:
        raise AssertionError(kind)
    return run


# the plan kinds that take a trailing ``reduce`` flag: their length
# without it
_REDUCIBLE = {"count": 2, "bsi_sum": 3, "row_counts": 3}


def _gb_hist_run(plan):
    """("gb_hist", cg_i, tree|None, planes_i|None, n_codes, signed, arm):
    the one-pass group-code histogram as a batchable subplan (a GroupBy
    rider of a fused batch), the same kernel as the solo one-pass path
    (``arm`` "fused" or "onehot", StackedEngine._onepass_kernel).  The
    output is the kernel's tables flattened into one int32 vector:
    counts, then with planes nn, pos (G, d) and neg (G, d)."""
    cg_i, tree, planes_i, n_codes, signed, arm = plan[1:7]
    gb = kernels.groupby_onehot if arm == "onehot" else kernels.groupby_fused

    def run(leaves, params):
        cg = leaves[cg_i]                               # (S, CB+1, W)
        valid = cg[:, -1]
        if tree is not None:
            valid = valid & _as_stack(tree, leaves, params)
        planes = leaves[planes_i] if planes_i is not None else None
        out = gb(cg[:, :-1], valid, planes, n_codes, signed)
        if planes is None:
            return out[0]
        return torch.cat([x.reshape(-1) for x in out])
    return run


def _ragged_run(plan):
    """("ragged", buckets, vmeta, subs): the serving layer's cross-index
    page-table program (executor/ragged.py).  ``leaves`` holds every
    bucket's dense pages first, then the direct leaves; ``buckets`` is
    ((first leaf, pages, table param), ...), one a (page_lanes, W)
    shape, its table the pages' kernels.gather_table; ``vmeta`` is
    ((bucket, lane param, shape), ...), each virtual leaf one
    concat_gather launch out of its bucket.  ``subs`` evaluate over the
    virtual leaves then the direct ones, as under "multi", except a
    ("segcount", bucket, lane param, segment param, nseg) entry: a
    family of single-leaf Counts answered by one segment_count launch
    over the bucket's lanes, no operand built."""
    buckets, vmeta, subs = plan[1], plan[2], plan[3]
    ndirect = (buckets[-1][0] + buckets[-1][1]) if buckets else 0
    runs = tuple(None if s[0] == "segcount" else _plan_run(s) for s in subs)

    def run(leaves, params):
        pools = [(leaves[start:start + n], params[ti])
                 for start, n, ti in buckets]
        vl = []
        for b, gi, shape in vmeta:
            pages, table = pools[b]
            vl.append(bm.concat_gather(pages, params[gi], table=table)
                      .reshape(shape))
        all_leaves = vl + list(leaves[ndirect:])
        outs = []
        for s, r in zip(subs, runs):
            if r is None:
                _k, b, gi, si, nseg = s
                pages, table = pools[b]
                outs.append(bm.segment_count(pages, params[gi], params[si],
                                             nseg, table=table))
            else:
                outs.append(r(all_leaves, params))
        return tuple(outs)
    return run


def _ragged_mesh_run(plan):
    """("ragged_mesh", ndev, epoch, buckets, vmeta, subs, runs_on,
    combines, lead device): the ragged program over the serving mesh
    (executor/ragged.py ``_finalize_mesh``).  ``leaves`` holds each
    (bucket, slot)'s dense pages; ``buckets`` has a (first leaf, pages,
    table param) or None a slot; ``vmeta`` a (bucket, gather param,
    local shape) or None a slot for each virtual leaf, gathered by one
    concat_gather launch on that slot.  Each subplan (or ("segcount",
    bucket, per-slot (lane param, segment param), nseg) family) runs on
    the slots of ``runs_on`` over their local leaves; the slots' partials
    move to the lead slot's device (non_blocking) and combine there:
    ("sum",) by an int64 sum, ("scatter", per-slot shard positions, S)
    by index_copy_ into an (S, W) zeros (each shard has one owner).
    Every slot's launches are queued before anything waits."""
    ndev, _epoch, buckets, vmeta, subs, runs_on, combines, lead = plan[1:9]
    runs = tuple(None if s[0] == "segcount" else _plan_run(s) for s in subs)

    def combine(parts, comb, params, lead):
        if comb[0] == "sum":
            acc = None
            for _d, o in parts:
                o = (tuple(x.to(lead, non_blocking=True).to(torch.int64)
                           for x in o) if isinstance(o, tuple) else
                     o.to(lead, non_blocking=True).to(torch.int64))
                acc = o if acc is None else (
                    tuple(a + b for a, b in zip(acc, o))
                    if isinstance(o, tuple) else acc + o)
            return acc
        _c, spos, s = comb
        first = parts[0][1]
        out = torch.zeros((s,) + tuple(first.shape[1:]), dtype=first.dtype,
                          device=lead)
        for d, o in parts:
            out.index_copy_(0, params[spos[d]], o.to(lead, non_blocking=True))
        return out

    def run(leaves, params):
        pools = [[None if m is None else
                  (leaves[m[0]:m[0] + m[1]], params[m[2]]) for m in per]
                 for per in buckets]
        local = [[None] * len(vmeta) for _ in range(ndev)]
        for vi, per in enumerate(vmeta):
            for d, m in enumerate(per):
                if m is not None:
                    b, gi, shape = m
                    pages, table = pools[b][d]
                    local[d][vi] = bm.concat_gather(
                        pages, params[gi], table=table).reshape(shape)
        outs = []
        for s, r, devs, comb in zip(subs, runs, runs_on, combines):
            parts = []
            for d in devs:
                if r is None:
                    _k, b, per, nseg = s
                    pages, table = pools[b][d]
                    gi, si = per[d]
                    o = bm.segment_count(pages, params[gi], params[si],
                                         nseg, table=table)
                else:
                    o = r(local[d], params)
                parts.append((d, o))
            outs.append(combine(parts, comb, params, lead))
        return tuple(outs)
    return run


# ---------------------------------------------------------------------------
# plan builder
# ---------------------------------------------------------------------------

class PlanBuilder:
    """Walks a bitmap Call tree → IR + leaf tensors + host params.

    The dispatch set of executeBitmapCallShard (executor.go:1782):
    Row/Range (set rows, time ranges, BSI conditions),
    Union/Intersect/Difference/Xor, Not, All, Shift and ConstRow, and
    the cross-shard calls (Distinct, UnionRows, Limit) nested as
    operands, which the executor evaluates once a query into ``pre``
    (``Executor._precompute_nested``, keyed by ``id(call)``) and which
    enter the tree as uploaded (S, W) leaves.  Any other call raises
    ExecError, as in the JAX package."""

    def __init__(self, engine: "StackedEngine", idx, shards: list[int],
                 pre: dict):
        self.engine = engine
        self.ex = engine.executor
        self.idx = idx
        self.skey = tuple(shards)
        self.pre = pre
        self.leaves: list[torch.Tensor] = []
        self.params: list = []
        self._leaf_keys: dict = {}

    def _add_leaf(self, t: torch.Tensor) -> int:
        self.leaves.append(t)
        return len(self.leaves) - 1

    def _cached_leaf(self, key, fetch) -> int:
        i = self._leaf_keys.get(key)
        if i is None:
            i = self._add_leaf(fetch())
            self._leaf_keys[key] = i
        return i

    def _param(self, value) -> int:
        self.params.append(value)
        return len(self.params) - 1

    def _row_leaf(self, field, views: tuple[str, ...], row_id: int) -> int:
        return self._cached_leaf(
            ("row", field.name, views, row_id),
            lambda: self.engine.row_stack(self.idx, field, views, row_id,
                                          self.skey))

    def _planes_leaf(self, field) -> int:
        return self._cached_leaf(
            ("planes", field.name, field.bit_depth),
            lambda: self.engine.plane_stack(self.idx, field, self.skey))

    def _groupcode_leaf(self, fields_rows) -> int:
        return self._cached_leaf(
            ("groupcodes", tuple((f.name, tuple(int(r) for r in rl))
                                 for f, rl in fields_rows)),
            lambda: self.engine.groupcode_stack(self.idx, fields_rows,
                                                self.skey))

    def _existence_leaf(self) -> int:
        if not self.idx.track_existence:
            raise ExecError(
                "All()/Not() require existence tracking on the index")
        return self._cached_leaf(
            ("exists",),
            lambda: self.engine.existence_stack(self.idx, self.skey))

    def _segments_leaf(self, key, segments: dict) -> int:
        """An (S, W) leaf built per query from host words of some shards
        ({shard: (W,) uint32}): zeros on the device, the shards that
        hold words uploaded in one copy."""
        def build():
            pos = {s: i for i, s in enumerate(self.skey)}
            rows = [s for s in segments if s in pos]
            out = torch.zeros((len(self.skey), self.idx.width // 32),
                              dtype=torch.int32, device=self.engine.device)
            if rows:
                at = torch.as_tensor([pos[s] for s in rows],
                                     device=self.engine.device)
                out[at] = bm.to_tensor(np.stack([segments[s] for s in rows]),
                                       self.engine.device)
            return out
        return self._cached_leaf(key, build)

    def _pre_leaf(self, call: Call) -> int:
        res = self.pre.get(id(call))
        if res is None:
            raise ExecError(f"{call.name} has no precomputed result")
        return self._segments_leaf(("pre", id(call)), res.segments)

    def _constrow_leaf(self, call: Call) -> int:
        cols = self.ex._constrow_cols(self.idx, call, self.pre)
        width = self.idx.width
        per_shard: dict[int, list[int]] = {}
        for c in cols:
            per_shard.setdefault(c // width, []).append(c % width)
        return self._segments_leaf(
            ("constrow", id(call)),
            {s: bm.from_columns(cs, width) for s, cs in per_shard.items()})

    def build(self, call: Call):
        name = call.name
        if name in ("Row", "Range"):
            return self._build_row(call)
        if name == "ConstRow":
            return ("leaf", self._constrow_leaf(call))
        if name in NESTED_CALLS:
            return ("leaf", self._pre_leaf(call))
        if name in ("Union", "Intersect", "Difference", "Xor"):
            op = name.lower()
            if not call.children:
                if name in ("Union", "Xor"):
                    return ("zeros",)
                raise ExecError(f"{name} requires at least one subquery")
            children = [self.build(c) for c in call.children]
            # constant-fold zeros so ("zeros",) only ever survives at
            # the root: union/xor drop zero terms; a zero term empties
            # an intersect; a zero base empties a difference
            zero = ("zeros",)
            if op in ("union", "xor"):
                children = [c for c in children if c != zero]
                if not children:
                    return zero
            elif op == "intersect":
                if zero in children:
                    return zero
            else:
                if children[0] == zero:
                    return zero
                children = [children[0]] + [c for c in children[1:]
                                            if c != zero]
            if len(children) == 1:
                return children[0]
            return ("nary", op, tuple(children))
        if name == "Not":
            exist_i = self._existence_leaf()
            sub = self.build(self.ex._only_child(call))
            if sub == ("zeros",):
                return ("leaf", exist_i)
            return ("not", exist_i, sub)
        if name == "All":
            return ("leaf", self._existence_leaf())
        if name == "Shift":
            n = int(call.arg("n", 1))
            sub = self.build(self.ex._only_child(call))
            return sub if sub == ("zeros",) else ("shift", n, sub)
        raise ExecError(f"unknown or non-bitmap call: {name}")

    def _build_row(self, call: Call):
        fname, cond = call.condition_field()
        if cond is not None:
            return self._build_bsi(fname, cond)
        fname, row_val = call.field_arg()
        if fname is None:
            raise ExecError("Row() requires a field argument")
        f = self.idx.field(fname)
        if f is None:
            raise ExecError(f"field not found: {fname}")
        if f.options.type.is_bsi:
            return self._build_bsi(fname, Condition(past.OP_EQ, row_val))
        row_id = self.ex._row_id_for_value(f, row_val)
        if row_id is None:                  # an unknown row key
            return ("zeros",)
        try:
            views = tuple(f.views_for_range(call.arg("from"),
                                            call.arg("to")))
        except ValueError as e:
            raise ExecError(str(e)) from None
        if not views:
            return ("zeros",)
        if len(views) > 1 and timeq.qcover():
            metrics.TIMEQ_QCOVER_TOTAL.inc()
            return ("qcover", tuple(self._row_leaf(f, (vn,), row_id)
                                    for vn in views))
        return ("leaf", self._row_leaf(f, views, row_id))

    def _build_bsi(self, fname: str, cond: Condition):
        """BSI predicate → IR, planned by Executor._bsi_predicate: a
        ("bsi_range", planes, op, p, q, p_neg, q_neg) node whose
        predicate magnitudes and signs are params."""
        ex = self.ex
        f = ex._bsi_field(self.idx, fname)
        v = f.views.get(f.bsi_view)
        if v is None or not v.fragments:
            if cond.value is None and cond.op == past.OP_EQ:
                return ("leaf", self._existence_leaf())
            return ("zeros",)
        pred = ex._bsi_predicate(f, cond)
        if pred[0] == "zeros":
            return ("zeros",)
        planes_i = self._planes_leaf(f)
        if pred[0] == "null":
            return ("bsi_null", planes_i, self._existence_leaf())
        if pred[0] == "notnull":
            return ("bsi_notnull", planes_i)
        return ("bsi_range", planes_i, pred[1],
                *(self._param(x) for x in pred[2:]))


# ---------------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------------

def stamps(frags) -> tuple:
    """Per-slot (gen, version) stamps, -1 where a slot has no fragment.
    The version detects writes; the gen detects a retired fragment."""
    return tuple(-1 if fr is None else (fr.gen, fr.version) for fr in frags)


def _coalesce_runs(ranges, w: int) -> list[list[int]]:
    """Sorted, merged (lo, hi) word runs, clamped to [0, w)."""
    runs: list[list[int]] = []
    for lo, hi in sorted(ranges):
        lo, hi = max(0, lo), min(hi, w)
        if hi <= lo:
            continue
        if runs and lo <= runs[-1][1]:
            runs[-1][1] = max(runs[-1][1], hi)
        else:
            runs.append([lo, hi])
    return runs


class _Layout:
    """How a cached stack's lanes (its (..., W) rows, flattened over the
    leading axes) derive from its fragment slots: ``lanes(slot, row)``,
    the lanes a fragment row feeds; ``all_lanes(slot)``, every lane the
    slot feeds; ``words(lane)``, a lane's current host words."""

    def __init__(self, words_per_lane: int):
        self.w = words_per_lane

    def _zeros(self) -> np.ndarray:
        return np.zeros(self.w, dtype=np.uint32)


class FragRowsLayout(_Layout):
    """One fragment's rows, lane i = rows[i]: the per-shard engine's
    (W,) row tiles and (2+d, W) plane tiles."""

    def __init__(self, frag, rows):
        super().__init__(frag.width // 32)
        self.frag, self.rows = frag, rows

    def lanes(self, slot: int, row: int):
        return [i for i, r in enumerate(self.rows) if r == row]

    def all_lanes(self, slot: int):
        return range(len(self.rows))

    def words(self, lane: int) -> np.ndarray:
        return self.frag.row_words(self.rows[lane])


class _RowsLayout(_Layout):
    """The (R, S, W) rows stack: slot vi*S + si is view vi's fragment
    of shard si; lane ri*S + si, row row_key[ri] of shard si unioned
    over the views."""

    def __init__(self, per_view, row_key, n_shards: int, w: int):
        super().__init__(w)
        self.per_view, self.row_key, self.n = per_view, row_key, n_shards
        self._pos: dict | None = None

    def lanes(self, slot: int, row: int):
        if self._pos is None:
            self._pos = {}
            for ri, r in enumerate(self.row_key):
                self._pos.setdefault(r, []).append(ri)
        si = slot % self.n
        return [ri * self.n + si for ri in self._pos.get(row, ())]

    def all_lanes(self, slot: int):
        si = slot % self.n
        return [ri * self.n + si for ri in range(len(self.row_key))]

    def words(self, lane: int) -> np.ndarray:
        ri, si = divmod(lane, self.n)
        have = [frags[si] for frags in self.per_view if frags[si] is not None]
        if len(have) == 1:                  # read-only: the caller copies
            return have[0].row_words(self.row_key[ri])
        out = self._zeros()
        for fr in have:
            out |= fr.row_words(self.row_key[ri])
        return out


class _PlanesLayout(_Layout):
    """The (S, 2+d, W) plane stack: slot si, lane si*(2+d) + r."""

    def __init__(self, frags, depth: int, w: int):
        super().__init__(w)
        self.frags, self.p = frags, 2 + depth

    def lanes(self, slot: int, row: int):
        return [slot * self.p + row] if row < self.p else []

    def all_lanes(self, slot: int):
        return range(slot * self.p, (slot + 1) * self.p)

    def words(self, lane: int) -> np.ndarray:
        si, r = divmod(lane, self.p)
        fr = self.frags[si]
        return self._zeros() if fr is None else fr.row_words(r)


class _GroupcodeLayout(_Layout):
    """The (S, CB+1, W) group-code stack: slot fi*S + si is field fi's
    fragment of shard si; a row at digit di feeds the code planes of
    di's set bits at the field's shift, and the valid plane (lane CB of
    the shard), the AND of the fields' row unions."""

    def __init__(self, fields_rows, per_field, shifts, cb: int,
                 n_shards: int, w: int):
        super().__init__(w)
        self.rls = [[int(r) for r in rl] for _f, rl in fields_rows]
        self.per_field, self.shifts = per_field, shifts
        self.cb, self.n = cb, n_shards

    def lanes(self, slot: int, row: int):
        fi, si = divmod(slot, self.n)
        base = si * (self.cb + 1)
        out = []
        for di, r in enumerate(self.rls[fi]):
            if r == row:
                out += [base + self.shifts[fi] + b
                        for b in range(di.bit_length()) if (di >> b) & 1]
                out.append(base + self.cb)
        return out

    def all_lanes(self, slot: int):
        fi, si = divmod(slot, self.n)
        base = si * (self.cb + 1)
        bits = bm.digit_bits(len(self.rls[fi]))
        return [base + self.shifts[fi] + b for b in range(bits)] + [
            base + self.cb]

    def words(self, lane: int) -> np.ndarray:
        si, p = divmod(lane, self.cb + 1)
        if p == self.cb:
            out = np.full(self.w, 0xFFFFFFFF, dtype=np.uint32)
            for rl, frags in zip(self.rls, self.per_field):
                union = self._zeros()
                if frags[si] is not None:
                    for r in rl:
                        union |= frags[si].row_words(r)
                out &= union
            return out
        fi = max(i for i, sh in enumerate(self.shifts) if sh <= p)
        b = p - self.shifts[fi]
        out = self._zeros()
        fr = self.per_field[fi][si]
        if fr is not None:
            for di, r in enumerate(self.rls[fi]):
                if (di >> b) & 1:
                    out |= fr.row_words(r)
        return out


# Under raw_pages(), a fetch of a paged entry returns a PageView, a
# snapshot of the entry's pages, instead of the assembled operand: the
# engine's packed arms (Count, set-op Count, TopN row counts) answer
# from the encode-time popcounts and host coordinates of encoded pages
# with no device program, and every other plan expands the views
# (_expand_view), the same assembly the fetch would have made.

_RAW_TLS = threading.local()


class PageView:
    """The pages of one paged entry.  ``pages`` is a snapshot (its
    references keep the tensors alive against an eviction); the last
    page is zero-padded past ``lanes``.  Pages are dense tensors or
    memory/encode.py encoded pages.  ``source`` is the (PagedStack,
    version) the snapshot came from, whose kept page table its
    expansion reuses."""

    __slots__ = ("shape", "lanes", "page_lanes", "pages", "source",
                 "page_device", "lane_page", "lane_slot", "shard_axis",
                 "home")

    def __init__(self, shape: tuple, lanes: int, page_lanes: int,
                 pages: list, source=None, placed=None, home=None):
        self.shape = tuple(shape)
        self.lanes = int(lanes)
        self.page_lanes = int(page_lanes)
        self.pages = list(pages)
        self.source = source
        # the serving mesh's layout (``placed``, a device-partitioned
        # PagedStack): each page's owner slot, each lane's page and row,
        # and the shard axis; ``home`` is the device its operand
        # assembles on
        self.page_device = self.lane_page = self.lane_slot = None
        self.shard_axis = None
        self.home = home
        if placed is not None:
            self.page_device = placed.page_device
            self.lane_page = placed.lane_page
            self.lane_slot = placed.lane_slot
            self.shard_axis = placed.shard_axis

    def all_encoded(self) -> bool:
        return all(encode.is_encoded(p) for p in self.pages)

    def lead_dropped(self) -> "PageView":
        """The view of a (1, ...) stack as its one (...) slab, whose
        lanes are the same."""
        v = PageView(self.shape[1:], self.lanes, self.page_lanes,
                     self.pages, self.source, home=self.home)
        if self.page_device is not None:
            v.page_device, v.lane_page = self.page_device, self.lane_page
            v.lane_slot = self.lane_slot
            v.shard_axis = None if self.shard_axis is None else max(
                self.shard_axis - 1, 0)
        return v

    @property
    def width_words(self) -> int:
        return int(self.shape[-1])

    def dense_pages(self) -> list:
        """Every page as a dense (page_lanes, W) tensor: an encoded page
        expands (one assemble_pages launch on the card), a dense page
        passes through.  The ragged program's buckets hold these."""
        return [encode.to_dense(p) for p in self.pages]


def _assemble_operand(pages: list, shape: tuple, lanes: int,
                      page_lanes: int, table=None) -> torch.Tensor:
    """The dense operand of a paged entry: one dense page that holds
    every lane, reshaped as it is; anything else, one assemble_pages
    launch (which also expands encoded pages), over ``table`` when the
    caller kept the pages' device table."""
    if (len(pages) == 1 and lanes == page_lanes
            and not encode.is_encoded(pages[0])):
        return pages[0].reshape(shape)
    return bm.assemble_pages(pages, shape, page_lanes, table=table)


def _kept(ps: PagedStack, version):
    """The (version, page table, page mix) the entry kept for this
    snapshot's version, or None.  A slot change resets it, and a stale
    one never matches: no lock is needed to read or replace it."""
    made = ps.assembly
    if version is None or made is None or made[0] != version:
        return None
    return made


def _pages_mix(ps: PagedStack, pages: list, version) -> dict:
    made = _kept(ps, version)
    if made is not None:
        return made[2]
    mix = _page_mix(pages)
    if version is not None:
        ps.assembly = (version, None, mix)
    return mix


def _assemble_placed(ps: PagedStack, pages: list, shape, device):
    """The dense operand of a device-partitioned entry (the serving
    mesh's layout) on ``device``: its pages moved there, assembled in
    page order by one assemble_pages launch, and the placement
    permutation undone."""
    moved = [encode.moved(p, device) for p in pages]
    n = len(moved) * ps.page_lanes
    flat = _assemble_operand(moved, (n, ps.width_words), n, ps.page_lanes)
    inv = torch.from_numpy(ps.inv_perm()).to(device)
    return flat.index_select(0, inv).reshape(shape)


def _paged_operand(ps: PagedStack, pages: list, version, shape=None,
                   device=None):
    """The dense operand of a snapshot of ``ps``'s pages (in ``shape``,
    by default the entry's), over the page table kept for its version:
    a warm hit builds no table and walks no page.  A device-partitioned
    entry assembles on ``device``."""
    shape = ps.shape if shape is None else shape
    if ps.lane_device is not None:
        return _assemble_placed(ps, pages, shape, device)
    table = None
    if version is not None and len(pages) > 1:
        made = _kept(ps, version)
        table = None if made is None else made[1]
        if table is None:
            table = kernels.page_table(pages, ps.shape, ps.page_lanes)
            ps.assembly = (version, table, _page_mix(pages) if made is None
                           else made[2])
    return _assemble_operand(pages, shape, ps.lanes, ps.page_lanes, table)


def _expand_view(view):
    """A PageView's dense operand; anything else as it is."""
    if not isinstance(view, PageView):
        return view
    if view.source is not None:
        ps, version = view.source
        return _paged_operand(ps, view.pages, version, view.shape,
                              view.home)
    return _assemble_operand(view.pages, view.shape, view.lanes,
                             view.page_lanes)


def _same_lanes(a, b) -> bool:
    """Two lane_device maps (or None) describe the same layout."""
    if a is None or b is None:
        return a is None and b is None
    return np.array_equal(a, b)


def _page_mix(pages) -> dict:
    """{encoding: page count} of one entry's pages."""
    mix: dict[str, int] = {}
    for p in pages:
        k = encode.page_kind(p)
        mix[k] = mix.get(k, 0) + 1
    return mix


class raw_pages:
    """Context manager: stack fetches on this thread return PageViews
    for paged entries (whole entries still return tensors)."""

    def __enter__(self):
        self._prev = getattr(_RAW_TLS, "on", False)
        _RAW_TLS.on = True
        return self

    def __exit__(self, *exc):
        _RAW_TLS.on = self._prev
        return False


class StackCache:
    """Device stacks keyed by what they were built from, each tagged with
    its fragment slots' (gen, version) stamps, their bytes held in the
    process's budget ledger (memory/ledger.py) as one client.

    An entry is whole (one tensor) or paged (memory/pages.py).  With a
    recipe and ``memory.paged_enabled()`` (the default) the stack's lanes
    are cut into pages of ``memory.page_bytes()``, each dense, packed or
    run (memory/encode.py), reserved in the ledger at its true size,
    evicted by cost-aware scoring (memory/policy.py) and built again on
    its own; a hit assembles the operand from the pages in one
    ``assemble_pages`` launch (none where one dense page holds every
    lane).  An entry retains at most ``_ENTRY_RESIDENT_FRAC`` of the
    budget: the tail of a broad scan is served and not kept, so it
    cannot evict the hot set.

    A stale entry is patched in place: the slots' delta logs name the
    dirty (lane, word run) spans, each run is read from the live host
    rows and scattered with ``bm.patch_rows`` (into the page that holds
    the lane: an encoded page is built and encoded again, a page dirtier
    than _PATCH_MAX_FRAC is built again), and the entry adopts the new
    stamps.  A slot that gained or lost its fragment patches its whole
    lanes.  The cache rebuilds only where a patch cannot serve, each
    case counted in ``rebuilds`` by its reason:

    - "cold": no entry under the key, or one of the other kind (whole or
      paged); the key names the shard list, the rows and the bit depth,
      so a new shard, row set, depth or field is a new key;
    - "coverage": a delta log no longer reaches back to the entry's
      version;
    - "gen": a fragment's gen moved (a retired fragment);
    - "dirty_frac": the patch would write more than _PATCH_MAX_FRAC of
      the stack's words;
    - "fault": an armed ``device-patch`` fault point failed the patch
      (the JAX package's chaos seam, answered as its cache does).

    Any other patch that raises propagates, the entry out of the cache.
    Counters: ``hits``, ``misses`` (every other access), ``adopts`` (a
    stale entry no logged write touched, which takes the new stamps as
    it is), ``patches``, ``patched_bytes`` (the padded runs' words),
    ``full_rebuilds``, ``page_rebuilds`` (a fresh entry whose evicted
    pages were built again), ``rebuilt_bytes`` (every byte built and
    uploaded, encoded pages at their true size, cold builds included, as
    the JAX package's TileStackCache counts them) and ``too_big`` (a
    whole entry larger than the budget, served and never kept).
    ``max_bytes`` is an explicit local cap; None leaves the bound to the
    ledger.

    ``seams`` (the stacked engine's cache) adds the JAX TileStackCache's
    observability and chaos seams: a ``stacked.stack`` span (tags
    ``outcome`` and ``bytes``) around every access that is not a hit,
    the access's outcome, bytes and key fingerprint in the flight
    record, the ``device-patch`` fault point, and
    ``pilosa_stack_cache_total`` by outcome (hit = hits, miss = misses,
    patch = patches + adopts, rebuild = full_rebuilds, page_rebuild =
    page_rebuilds), beside ``pilosa_stack_maintenance_bytes_total``
    (patched, rebuilt) and ``pilosa_stack_pages_total``."""

    _MAX_RECIPES = 512
    _MAX_WARNED = 1024

    def __init__(self, max_bytes: int | None = None, seams: bool = False,
                 ledger=None, client: str = "stack_cache", device=None):
        self.max_bytes = max_bytes
        self.seams = seams
        self.device = torch.device("cpu") if device is None else device
        self._ledger = memory.ledger() if ledger is None else ledger
        self._client = self._ledger.register(
            client, reclaim=self._reclaim, cold_ts=self._cold_ts)
        # key -> (versions, tensor | PagedStack, accounted bytes, last use)
        self._entries: OrderedDict = OrderedDict()
        self._bytes = 0
        self._lock = threading.RLock()
        self._building: dict = {}        # key -> Event (single flight)
        # key fingerprint -> (key, recipe), for the prefetcher
        self._recipes: OrderedDict = OrderedDict()
        self._key_fps: dict = {}
        self._warned_big: set = set()
        self.hits = self.misses = self.adopts = 0
        self.patches = self.patched_bytes = 0
        self.full_rebuilds = self.page_rebuilds = self.rebuilt_bytes = 0
        self.too_big = 0
        self.rebuilds: Counter = Counter()
        # bytes of freed pages by owner slot (the serving mesh's
        # layout), drained into device-labelled releases (_release)
        self._freed_dev: Counter = Counter()

    def keys(self) -> list:
        """The keys of the resident stacks, least recently used first."""
        with self._lock:
            return list(self._entries)

    def counters(self) -> dict:
        return {"hits": self.hits, "misses": self.misses,
                "adopts": self.adopts, "patches": self.patches,
                "patched_bytes": self.patched_bytes,
                "full_rebuilds": self.full_rebuilds,
                "page_rebuilds": self.page_rebuilds,
                "rebuilt_bytes": self.rebuilt_bytes,
                "too_big": self.too_big,
                "rebuilds": dict(self.rebuilds)}

    @property
    def nbytes(self) -> int:
        return self._bytes

    # -- access ----------------------------------------------------------

    def get(self, key, frags, build, make_layout, make_recipe=None):
        """The stack under key, fresh for the fragment slots `frags`: a
        hit, a patch through the _Layout that make_layout() gives (called
        only for a stale entry), or a build.  ``make_recipe()``, called
        only on a miss, gives the StackRecipe that pages the entry."""
        t0 = time.perf_counter()
        versions = stamps(frags)
        while True:
            with self._lock:
                ent = self._entries.get(key)
                hit = self._hit_locked(key, ent, versions)
                if hit is None:
                    ev = self._building.get(key)
                    if ev is None:
                        ev = self._building[key] = threading.Event()
                        self.misses += 1
                        break
            if hit is not None:
                payload, snap = hit
                out = payload if snap is None else self._assemble(payload,
                                                                  *snap)
                if self.seams:
                    metrics.STACK_CACHE.inc(outcome="hit")
                    flight.note_stack("hit", 0, time.perf_counter() - t0)
                return out
            # single flight: another thread builds or patches this key
            ev.wait()
        try:
            recipe = (make_recipe() if make_recipe is not None
                      and memory.paged_enabled() else None)
            fp = self._remember_recipe(key, recipe) if recipe else None
            if not self.seams:
                return self._serve(key, frags, build, make_layout, versions,
                                   ent, recipe)[0]
            metrics.STACK_CACHE.inc(outcome="miss")
            with start_span("stacked.stack") as sp:
                t, outcome, moved = self._serve(key, frags, build,
                                                make_layout, versions, ent,
                                                recipe)
                sp.set_tag("outcome", outcome)
                if moved:
                    sp.set_tag("bytes", moved)
            metrics.STACK_CACHE.inc(outcome=outcome)
            flight.note_stack(outcome, moved, time.perf_counter() - t0,
                              key_fp=fp)
            return t
        finally:
            with self._lock:
                self._building.pop(key, None)
            ev.set()

    def _hit_locked(self, key, ent, versions: tuple):
        """(tensor, None) or (PagedStack, (page snapshot, its version))
        for a fresh, fully resident entry that no builder holds, else
        None."""
        if ent is None or ent[0] != versions or key in self._building:
            return None
        payload = ent[1]
        if isinstance(payload, PagedStack):
            if not payload.complete():
                return None
            hit = (payload, (list(payload.pages), payload.version))
        else:
            self._entries[key] = (ent[0], payload, ent[2], time.time())
            hit = (payload, None)
        self._entries.move_to_end(key)
        self.hits += 1
        fp = self._key_fps.get(key)
        if fp is not None and fp in self._recipes:
            self._recipes.move_to_end(fp)
        return hit

    def _serve(self, key, frags, build, make_layout, versions: tuple,
               stale, recipe):
        """A stale or missing entry: patched, or built.  Returns (stack,
        outcome "patch" | "rebuild" | "page_rebuild", bytes moved)."""
        if recipe is not None:
            return self._serve_paged(key, frags, versions, stale, recipe)
        return self._serve_whole(key, frags, build, make_layout, versions,
                                 stale)

    # -- counters ----------------------------------------------------------

    def _count_rebuild(self, reason: str, nbytes: int) -> None:
        with self._lock:
            self.full_rebuilds += 1
            self.rebuilt_bytes += nbytes
            self.rebuilds[reason] += 1
        if self.seams:
            metrics.STACK_MAINT_BYTES.inc(nbytes, kind="rebuilt")

    def _count_patch(self, dirty: bool, patched: int, rebuilt: int) -> None:
        with self._lock:
            if dirty:
                self.patches += 1
            else:
                self.adopts += 1
            self.patched_bytes += patched
            self.rebuilt_bytes += rebuilt
        if self.seams:
            metrics.STACK_MAINT_BYTES.inc(patched, kind="patched")
            if rebuilt:
                metrics.STACK_MAINT_BYTES.inc(rebuilt, kind="rebuilt")

    # -- patching ------------------------------------------------------------

    def _fault(self) -> bool:
        """The chaos seam: an armed ``device-patch`` fault fails the
        patch as a device-side error would, before any byte moves."""
        if not self.seams:
            return False
        try:
            faults.fire("device-patch")
        except faults.InjectedFault:
            return True
        return False

    @staticmethod
    def _dirty_lanes(frags, layout: _Layout, old: tuple, new: tuple):
        """{lane: [(lo, hi) runs] or None for the whole lane} written
        between the stamps (one a slot, in slot order: the key fixes the
        slots), or the reason a patch cannot serve."""
        dirty: dict = {}
        for slot, (fr, ov, nv) in enumerate(zip(frags, old, new)):
            if ov == nv:
                continue
            if ov == -1 or nv == -1:
                for ln in layout.all_lanes(slot):
                    dirty[ln] = None
                continue
            if ov[0] != nv[0]:
                return "gen"
            spans = fr.deltas_since(ov[1])
            if spans is None:
                return "coverage"
            for row, lo, hi in spans:
                for ln in layout.lanes(slot, row):
                    cur = dirty.get(ln, False)
                    if cur is None:
                        continue
                    if cur is False:
                        dirty[ln] = cur = []
                    cur.append((lo, hi))
        return dirty

    @staticmethod
    def _segments(dirty: dict, w: int) -> list:
        """(start, plen, lane) of each dirty run, padded to a power-of-two
        width (the content comes from the live rows, so widening is
        exact)."""
        segs = []
        for lane in sorted(dirty):
            runs = dirty[lane]
            runs = [(0, w)] if runs is None else _coalesce_runs(runs, w)
            for lo, hi in runs:
                plen = min(1 << (hi - lo - 1).bit_length(), w)
                segs.append((min(lo, w - plen), plen, lane))
        return segs

    @staticmethod
    def _scatter(flat: torch.Tensor, segs: list, words, row_of=None):
        """The segments' live words into flat (row ``row_of(lane)``, by
        default the lane), one patch_rows call a width."""
        cur: dict[int, np.ndarray] = {}
        by_len: dict[int, list] = {}
        for start, plen, lane in segs:
            by_len.setdefault(plen, []).append((lane, start))
        for plen, group in sorted(by_len.items()):
            data = np.empty((len(group), plen), dtype=np.uint32)
            for k, (lane, start) in enumerate(group):
                if lane not in cur:
                    cur[lane] = words(lane)
                data[k] = cur[lane][start:start + plen]
            bm.patch_rows(flat, [ln if row_of is None else row_of(ln)
                                 for ln, _s in group],
                          [s_ for _l, s_ in group], data)

    # -- whole entries ---------------------------------------------------------

    def _serve_whole(self, key, frags, build, make_layout, versions, stale):
        reason = "cold"
        if stale is not None:
            self._drop_entry(key, stale)
            if not isinstance(stale[1], PagedStack):
                reason = self._patch_whole(stale, frags, make_layout,
                                           versions)
                if not isinstance(reason, str):
                    t, moved = stale[1], reason
                    self._insert(key, versions, t)
                    return t, "patch", moved
        t = build()
        nbytes = t.numel() * t.element_size()
        self._count_rebuild(reason, nbytes)
        self._insert(key, versions, t)
        return t, "rebuild", nbytes

    def _patch_whole(self, stale, frags, make_layout, versions):
        """Patch a stale whole entry in place: the bytes written, or the
        reason it rebuilds."""
        if self._fault():
            return "fault"
        layout = make_layout()
        dirty = self._dirty_lanes(frags, layout, stale[0], versions)
        if isinstance(dirty, str):
            return dirty
        t = stale[1]
        w = t.shape[-1]
        segs = self._segments(dirty, w)
        words = sum(plen for _s, plen, _l in segs)
        if words > _PATCH_MAX_FRAC * t.numel():
            return "dirty_frac"
        self._scatter(t.view(-1, w), segs, layout.words)
        self._count_patch(bool(dirty), words * 4, 0)
        return words * 4

    def _insert(self, key, versions: tuple, t: torch.Tensor) -> None:
        """Retain a whole entry if the ledger admits it."""
        nbytes = t.numel() * t.element_size()
        cap = self._budget_cap()
        if nbytes > cap:
            self._note_too_big(key, nbytes, cap)
            return
        if not self._client.reserve(nbytes):
            metrics.STACK_CACHE.inc(outcome="denied")
            return
        with self._lock:
            self._entries[key] = (versions, t, nbytes, time.time())
            self._bytes += nbytes
            shed = self._enforce_local_cap_locked()
        if shed:
            self._release(shed)

    def _drop_entry(self, key, ent, payload=None) -> None:
        """Drop the entry ``ent`` (or whichever holds ``payload``) from
        under key, releasing its bytes."""
        with self._lock:
            if ent is None or self._entries.get(key) is not ent or (
                    payload is not None and ent[1] is not payload):
                return
            self._entries.pop(key)
            self._bytes -= ent[2]
            self._note_freed_locked(ent[1])
        if ent[2]:
            self._release(ent[2])

    def _note_freed_locked(self, payload, pi: int | None = None) -> None:
        """Tally the placed pages a drop frees (one page ``pi``, or every
        resident page of ``payload``) by owner slot."""
        if not isinstance(payload, PagedStack) or payload.page_device is None:
            return
        for i in (range(payload.n_pages) if pi is None else (pi,)):
            p = payload.pages[i]
            if p is not None:
                self._freed_dev[payload.page_device[i]] += \
                    encode.page_nbytes(p)

    def _release(self, nbytes: int) -> None:
        """Release ``nbytes`` to the ledger, labelled by owner slot as far
        as freed placed pages account for them."""
        with self._lock:
            labelled = dict(self._freed_dev)
            self._freed_dev.clear()
        for dev, b in labelled.items():
            b = min(b, nbytes)
            if b > 0:
                self._client.release(b, device=dev)
                nbytes -= b
        if nbytes > 0:
            self._client.release(nbytes)

    # -- paged entries -----------------------------------------------------

    def _serve_paged(self, key, frags, versions: tuple, stale,
                     recipe: StackRecipe):
        w = recipe.width_words
        shape = tuple(recipe.logical_lead) + (w,)
        pl = max(1, min(page_lanes_for(w), recipe.lanes))
        ps = old_versions = None
        if (stale is not None and isinstance(stale[1], PagedStack)
                and stale[1].shape == shape and stale[1].page_lanes == pl
                and _same_lanes(stale[1].lane_device, recipe.lane_device)):
            ps, old_versions = stale[1], stale[0]
        elif stale is not None:
            self._drop_entry(key, stale)
        reason, dirty = "cold", {}
        if ps is not None and old_versions != versions:
            dirty = "fault" if self._fault() else recipe.deltas_fn(
                old_versions)
            if not isinstance(dirty, str):
                words = sum(plen for _s, plen, _l
                            in self._segments(dirty, w))
                if words > _PATCH_MAX_FRAC * recipe.lanes * w:
                    dirty = "dirty_frac"
            if isinstance(dirty, str):
                reason, dirty = dirty, None
        # every page tensor this access touches: the final assembly is
        # immune to evictions meanwhile, and pages the ledger denied
        # residency still serve this query
        local: dict[int, object] = {}
        resident_cap = max(int(_ENTRY_RESIDENT_FRAC * self._budget_cap()),
                           pl * w * 4)
        patched_b = rebuilt_b = 0
        if ps is None or dirty is None:
            # a stale entry built again keeps its pages' encodings as
            # the hysteresis and flip attribution of the new ones
            prev = [None] if ps is None else list(ps.pages)
            if ps is not None:
                self._drop_pages(key, ps)
            ps = PagedStack(shape, pl, weight=recipe.weight,
                            lane_device=recipe.lane_device,
                            shard_axis=recipe.shard_axis)
            host = np.asarray(recipe.build_host(),
                              dtype=np.uint32).reshape(-1, w)
            retained = 0
            for pi in range(ps.n_pages):
                ids = ps.page_lane_ids(pi)
                block = (host[ids[0]:ids[-1] + 1] if ps.page_table is None
                         else host[ids])
                if block.shape[0] < pl:
                    block = np.concatenate(
                        [block, np.zeros((pl - block.shape[0], w),
                                         np.uint32)])
                was = prev[pi] if pi < len(prev) else None
                local[pi] = self._commit_page(
                    block, key, prev=was,
                    reason="build" if was is None else "drift",
                    slot=ps.device_of(pi))
                nb = encode.page_nbytes(local[pi])
                rebuilt_b += nb
                if (retained + nb <= resident_cap
                        and self._page_install(key, ps, pi, local[pi])):
                    retained += nb
            self._count_rebuild(reason, rebuilt_b)
            outcome = "rebuild"
        else:
            try:
                patched_b, rebuilt_b = self._refresh_pages(key, ps, dirty,
                                                           recipe, local)
            except BaseException:
                # nothing half-patched may be served: the entry goes
                self._drop_entry(key, self._entries.get(key), payload=ps)
                raise
            if old_versions != versions:
                outcome = "patch"
                self._count_patch(bool(dirty), patched_b, rebuilt_b)
            else:
                outcome = "page_rebuild"
                with self._lock:
                    self.page_rebuilds += 1
                    self.rebuilt_bytes += rebuilt_b
                if self.seams and rebuilt_b:
                    metrics.STACK_MAINT_BYTES.inc(rebuilt_b, kind="rebuilt")
        repl = None
        with self._lock:
            old = self._entries.get(key)
            old_nb = old[2] if old is not None and old[1] is ps else 0
            if old is not None and old[1] is not ps:
                self._entries.pop(key)
                self._bytes -= old[2]
                self._note_freed_locked(old[1])
                repl = old[2]
            nb = ps.resident_bytes()
            self._entries[key] = (versions, ps, nb, time.time())
            self._entries.move_to_end(key)
            self._bytes += nb - old_nb
            shed = self._enforce_local_cap_locked()
        if repl:
            self._release(repl)
        if shed:
            self._release(shed)
        arrs = [local[i] for i in range(ps.n_pages)]
        return self._assemble(ps, arrs), outcome, patched_b + rebuilt_b

    def _refresh_pages(self, key, ps: PagedStack, dirty: dict,
                       recipe: StackRecipe, local: dict):
        """A kept paged entry made fresh: its evicted pages built again
        from the live rows, its other dirty pages patched.  Fills
        ``local`` with every page; returns (patched, rebuilt) bytes."""
        pl, w = ps.page_lanes, ps.width_words
        patched_b = rebuilt_b = 0
        resident_cap = max(int(_ENTRY_RESIDENT_FRAC * self._budget_cap()),
                           pl * w * 4)
        with self._lock:
            local.update((pi, p) for pi, p in enumerate(ps.pages)
                         if p is not None)
        by_page: dict[int, dict] = {}
        for lane, runs in dirty.items():
            by_page.setdefault(ps.page_of(lane)[0], {})[lane] = runs
        fresh: set[int] = set()
        retained = ps.resident_bytes()
        for pi in range(ps.n_pages):
            if pi in local:
                continue
            block = ps.build_page_host(pi, recipe.lane_words)
            local[pi] = self._commit_page(block, key, slot=ps.device_of(pi))
            nb = encode.page_nbytes(local[pi])
            if (retained + nb <= resident_cap
                    and self._page_install(key, ps, pi, local[pi])):
                retained += nb
            rebuilt_b += nb
            fresh.add(pi)
        for pi, lanes_d in by_page.items():
            if pi not in fresh:  # a fresh page read the live rows
                pb, rb = self._patch_page(key, ps, pi, lanes_d, recipe,
                                          local)
                patched_b += pb
                rebuilt_b += rb
        return patched_b, rebuilt_b

    @staticmethod
    def _stats_ident(key):
        """(index, field) of a stack key that names one field (rows and
        planes stacks; a group-code key names several)."""
        if (len(key) >= 3 and isinstance(key[1], str)
                and isinstance(key[2], str)):
            return key[1], key[2]
        return None

    def upload(self, block: np.ndarray, device=None) -> torch.Tensor:
        """Host words to the device (the cache's, or ``device``) under
        the OOM ladder (no host fallback: a stack lives on the card)."""
        dev = self.device if device is None else device
        return pressure.guarded(lambda: bm.to_tensor(block, dev))

    def _commit_page(self, block: np.ndarray, key, prev=None,
                     reason: str = "build", slot: int | None = None):
        """One host page block on the device, encoded where that pays
        (memory/encode.py).  ``prev`` is the page's current payload
        (hysteresis); ``reason`` labels pilosa_page_encode_total; a
        placed page (``slot``) goes to its owner slot's device."""
        dev = self.device if slot is None else placement.device_of(slot)
        prev_kind = encode.page_kind(prev) if prev is not None else None
        enc = None
        if encode.enabled():
            ident = self._stats_ident(key)
            hint = (None if ident is None else stats.field_density(
                ident[0], ident[1], block.shape[1] * 32))
            enc = encode.encode_block(block, prev_kind=prev_kind,
                                      density_hint=hint)
            kind = "dense" if enc is None else enc.kind
            if enc is not None or prev_kind not in (None, "dense"):
                metrics.PAGE_ENCODE.inc(**{"from": prev_kind or "none",
                                           "to": kind, "reason": reason})
            if ident is not None:
                stats.note_page_encoding(ident[0], ident[1], kind)
        if enc is None:
            return self.upload(block, dev)
        return pressure.guarded(lambda: enc.to_device(dev))

    def _page_install(self, key, ps: PagedStack, pi: int, page) -> bool:
        """Retain one built page if the ledger admits it at its true
        size; a denied page serves this access and is built next time."""
        if not self._client.reserve(encode.page_nbytes(page),
                                    device=ps.device_of(pi)):
            metrics.STACK_CACHE.inc(outcome="denied")
            return False
        with self._lock:
            ps.set_page(pi, page)
            ps.last_access = time.time()
            self._sync_entry_locked(key, ps)
        metrics.STACK_PAGES.inc(event="build", encoding=encode.page_kind(page))
        return True

    def _patch_page(self, key, ps: PagedStack, pi: int, lanes_d: dict,
                    recipe: StackRecipe, local: dict):
        """The dirty runs of one resident page; returns (patched bytes,
        rebuilt bytes).  An encoded page has no word patch: it is built
        from the live rows and encoded again (where a filling page turns
        dense); so is a dense page dirtier than _PATCH_MAX_FRAC."""
        cur = local.get(pi)
        w = ps.width_words
        segs = self._segments(lanes_d, w)
        words = sum(plen for _s, plen, _l in segs)
        if encode.is_encoded(cur) or words > _PATCH_MAX_FRAC * ps.page_lanes * w:
            block = ps.build_page_host(pi, recipe.lane_words)
            page = self._commit_page(
                block, key, prev=cur,
                reason="patch" if encode.is_encoded(cur) else "drift",
                slot=ps.device_of(pi))
            local[pi] = page
            self._page_replace(key, ps, pi, page)
            metrics.STACK_PAGES.inc(event="patch",
                                    encoding=encode.page_kind(page))
            return 0, encode.page_nbytes(page)
        if not segs:
            return 0, 0
        self._scatter(cur, segs, recipe.lane_words,
                      row_of=lambda lane: ps.page_of(lane)[1])
        self._page_replace(key, ps, pi, cur)
        metrics.STACK_PAGES.inc(event="patch", encoding="dense")
        return words * 4, 0

    def _page_replace(self, key, ps: PagedStack, pi: int, page):
        """Put a patched or rebuilt page in its slot: the same size keeps
        the reservation; another size (an encoding flip) releases the old
        bytes and reserves the new; a slot evicted meanwhile is installed
        again."""
        nb_new = encode.page_nbytes(page)
        release = 0
        with self._lock:
            was = ps.pages[pi]
            if was is not None:
                nb_old = encode.page_nbytes(was)
                if nb_old == nb_new:
                    ps.set_page(pi, page)
                    ps.last_access = time.time()
                    return
                ps.set_page(pi, None)
                self._sync_entry_locked(key, ps)
                release = nb_old
        if release:
            self._client.release(release, device=ps.device_of(pi))
        self._page_install(key, ps, pi, page)

    def _assemble(self, ps: PagedStack, pages: list, version=None):
        """The entry's operand, or a PageView under raw_pages().  A hit
        passes its snapshot's version: the page table and page mix are
        built once a version and kept (_paged_operand)."""
        ps.touch()
        if flight.active_acc() is not None:
            flight.note_pages(_pages_mix(ps, pages, version))
        if getattr(_RAW_TLS, "on", False):
            return PageView(ps.shape, ps.lanes, ps.page_lanes, pages,
                            (ps, version), placed=(
                                ps if ps.lane_device is not None else None),
                            home=self.device)
        return _paged_operand(ps, pages, version, device=self.device)

    # -- budget and eviction ---------------------------------------------

    def _budget_cap(self) -> int:
        return (self.max_bytes if self.max_bytes is not None
                else self._ledger.budget())

    def _enforce_local_cap_locked(self) -> int:
        """Shed down to the local max_bytes cap (none: the ledger
        governs); returns the bytes to release to the ledger."""
        if self.max_bytes is None or self._bytes <= self.max_bytes:
            return 0
        return self._shed_locked(self._bytes - self.max_bytes)

    def _shed_locked(self, need: int) -> int:
        """Evict about ``need`` bytes, concentrated on entries: order
        them by cost-aware score (memory/policy.py), then drain the
        victim's pages in order, stopping in mid-entry once enough is
        freed; a fully drained entry is dropped.  Returns the bytes
        freed (the caller releases them)."""
        freed = 0
        cands = []
        for k, ent in self._entries.items():
            payload = ent[1]
            if isinstance(payload, PagedStack):
                if any(p is not None for p in payload.pages):
                    cands.append((payload.last_access, payload.weight,
                                  payload.hits, (k, payload)))
            elif ent[2]:
                cands.append((ent[3], 1.0, 1, (k, None)))
        for _la, _w, _h, (k, ps) in policy.victim_order(cands):
            if freed >= need:
                break
            if ps is None:
                ent = self._entries.pop(k)
                self._bytes -= ent[2]
                freed += ent[2]
                continue
            for pi, p in enumerate(ps.pages):
                if freed >= need:
                    break
                if p is None:
                    continue
                self._note_freed_locked(ps, pi)
                ps.set_page(pi, None)
                freed += encode.page_nbytes(p)
                metrics.STACK_PAGES.inc(event="evict",
                                        encoding=encode.page_kind(p))
            self._sync_entry_locked(k, ps)
            if not any(p is not None for p in ps.pages):
                ent = self._entries.pop(k, None)
                if ent is not None:
                    self._bytes -= ent[2]
        return freed

    def _reclaim(self, need: int) -> int:
        """The ledger's reclaim callback."""
        with self._lock:
            freed = self._shed_locked(int(need))
        if freed:
            self._release(freed)
        return freed

    def _cold_ts(self) -> float:
        """The coldest resident entry's last use."""
        with self._lock:
            ts = None
            for ent in self._entries.values():
                la = (ent[1].last_access if isinstance(ent[1], PagedStack)
                      else ent[3])
                if ent[2] and (ts is None or la < ts):
                    ts = la
            return ts or 0.0

    def _sync_entry_locked(self, key, ps: PagedStack):
        """An entry's accounted bytes from its resident pages."""
        ent = self._entries.get(key)
        if ent is not None and ent[1] is ps:
            nb = ps.resident_bytes()
            self._bytes += nb - ent[2]
            self._entries[key] = (ent[0], ps, nb, ent[3])

    def _drop_pages(self, key, ps: PagedStack):
        freed = 0
        with self._lock:
            self._note_freed_locked(ps)
            for pi, p in enumerate(ps.pages):
                if p is not None:
                    ps.set_page(pi, None)
                    freed += encode.page_nbytes(p)
            self._sync_entry_locked(key, ps)
        if freed:
            self._release(freed)

    def _note_too_big(self, key, nbytes: int, cap: int):
        with self._lock:
            self.too_big += 1
            warn = key not in self._warned_big
            if warn:
                self._warned_big.add(key)
                while len(self._warned_big) > self._MAX_WARNED:
                    self._warned_big.pop()
        metrics.STACK_CACHE.inc(outcome="too_big")
        if warn:
            _log.warning("stack %r (%d bytes) alone exceeds the device "
                         "budget (%d bytes); it is built and served "
                         "unretained on every access", key, nbytes, cap)

    # -- prefetch (memory/policy.py Prefetcher) ----------------------------

    def _remember_recipe(self, key, recipe: StackRecipe) -> str:
        with self._lock:
            fp = self._key_fps.get(key)
            if fp is None:
                fp = hashlib.blake2b(repr(key).encode(),
                                     digest_size=8).hexdigest()
                self._key_fps[key] = fp
            self._recipes[fp] = (key, recipe)
            self._recipes.move_to_end(fp)
            while len(self._recipes) > self._MAX_RECIPES:
                _ofp, (okey, _r) = self._recipes.popitem(last=False)
                self._key_fps.pop(okey, None)
        return fp

    def prewarm(self, fp: str) -> bool:
        """Build a key's missing pages again from its recorded recipe at
        the current fragment versions (the prefetcher's warm target).
        False for an unknown key, a fresh fully resident entry, or a
        recipe whose fields were dropped (the recipe goes too)."""
        with self._lock:
            rec = self._recipes.get(fp)
        if rec is None:
            return False
        key, recipe = rec
        if recipe.alive_fn is not None and not recipe.alive_fn():
            with self._lock:
                if self._recipes.get(fp) is rec:
                    self._recipes.pop(fp)
                    self._key_fps.pop(key, None)
            return False
        versions = recipe.versions_fn()
        with self._lock:
            ent = self._entries.get(key)
            if ent is not None and ent[0] == versions and not (
                    isinstance(ent[1], PagedStack)
                    and not ent[1].complete()):
                return False
        recipe.replay()
        return True

    def clear(self):
        with self._lock:
            total = self._bytes
            for ent in self._entries.values():
                self._note_freed_locked(ent[1])
            self._entries.clear()
            self._bytes = 0
        if total:
            self._release(total)


class StackedEngine(MeshArm):
    """Runs bitmap trees and their reductions over shard stacks on one
    device, or on the slots of a mesh (``set_mesh``, executor/
    mesh_arm.py); owned by the Executor.  ``paged`` False keeps every
    stack whole (a slot of a mesh of several slots).  An empty shard
    list answers without building a stack or reaching a kernel."""

    def __init__(self, executor, device: torch.device, paged: bool = True):
        self.executor = executor
        self.device = device
        self.paged = paged
        self.cache = StackCache(seams=True, device=device)
        self._disjoint_cache: OrderedDict = OrderedDict()
        # which kernel serves the one-pass histogram: "fused", or
        # "onehot" where its bounds hold (_onepass_kernel)
        self.onepass_arm = "fused"

    # -- stack builders (cached, patched on write) --------------------------

    def _stack(self, key, frags, build_host, make_layout, lead: tuple,
               replay, alive_fn, weight: float = 1.0, placed=None):
        """The cached stack under key: whole, or paged under a recipe
        (the builder's host words, its _Layout's lane words and delta
        map, and ``replay`` for the prefetcher).  ``placed`` is (index,
        shard tuple, shard axis) for the serving mesh's layout."""
        if not all(lead):
            # a stack of no lane: no page, no build, no kernel input
            return torch.zeros(tuple(lead) + (make_layout().w,),
                               dtype=torch.int32, device=self.device)

        def make_recipe():
            layout = make_layout()
            lane_device = shard_axis = None
            if placed is not None:
                shard_axis = placed[2]
                lane_device = self._lane_devices(*placed[:2], lead,
                                                 shard_axis)
            return StackRecipe(
                lane_device=lane_device, shard_axis=shard_axis,
                logical_lead=tuple(lead), width_words=layout.w,
                lane_words=layout.words, build_host=build_host,
                versions_fn=lambda: stamps(replay(fetch=False)),
                deltas_fn=lambda old: StackCache._dirty_lanes(
                    frags, layout, old, stamps(frags)),
                weight=weight, alive_fn=alive_fn,
                replay=lambda: replay())

        return self.cache.get(
            key, frags, lambda: self.cache.upload(build_host()),
            make_layout, make_recipe if self._pageable() else None)

    def _lane_devices(self, idx, skey, lead, shard_axis: int):
        """Each lane's serving-mesh owner slot (int32 (lanes,)) for a
        pageable stack, or None where the serving mesh is off: the
        owner of the lane's shard, which varies along ``shard_axis``."""
        if not self._pageable() or placement.mesh_devices() <= 1:
            return None
        own = placement.owners(idx.name, skey)
        shape = [1] * len(lead)
        shape[shard_axis] = len(skey)
        return np.ascontiguousarray(np.broadcast_to(
            own.reshape(shape), tuple(lead)).reshape(-1))

    def _pageable(self) -> bool:
        """Paged entries only for a single-device engine (or the one slot
        of a one-slot mesh); a slot of a wider mesh keeps whole stacks."""
        return self.mesh is None and self.paged

    def _mesh_key(self):
        """The mesh and topology token of stack cache keys: the engine's
        mesh identity, plus, where the serving mesh is on
        (memory/placement.py), its width and placement epoch, so a
        rebalance or a width flip never hits a stack of a dead
        placement."""
        mesh = self.mesh if self.mesh is not None else self._placed
        n = placement.mesh_devices() if self._pageable() else 1
        if n <= 1:
            return id(mesh)
        return (id(mesh), n, placement.epoch())

    def _frags(self, field, view: str, shards):
        v = field.views.get(view)
        return [v.fragment(s) if v else None for s in shards]

    def sparse_fast(self) -> bool:
        """The packed arms apply where pages can be encoded at all, on an
        executor on the CPU.  On the card an encoded page expands through
        assemble_pages and is counted by the kernels, as a dense one is."""
        return (self.device.type == "cpu" and encode.enabled()
                and memory.paged_enabled())

    def sparse_raw(self):
        """raw_pages() where the packed arms apply, else nothing."""
        return raw_pages() if self.sparse_fast() else contextlib.nullcontext()

    def rows_stack_for(self, idx, field, views: tuple[str, ...], row_ids,
                       skey: tuple, fetch: bool = True):
        """(R, S, W) stack of rows, each unioned across views (a PageView
        under raw_pages()).  ``fetch=False`` gives the fragment slots."""
        row_key = tuple(int(r) for r in row_ids)
        per_view = [self._frags(field, vn, skey) for vn in views]
        frags = [fr for fs in per_view for fr in fs]
        if not fetch:
            return frags

        def build_host():
            out = np.zeros((len(row_key), len(skey), idx.width // 32),
                           dtype=np.uint32)
            for fs in per_view:
                for si, fr in enumerate(fs):
                    if fr is not None:
                        for ri, r in enumerate(row_key):
                            out[ri, si] |= fr.row_words(r)
            return out

        return self._stack(
            ("rows", idx.name, field.name, views, row_key, skey,
             self._mesh_key()), frags,
            build_host,
            lambda: _RowsLayout(per_view, row_key, len(skey),
                                idx.width // 32),
            (len(row_key), len(skey)),
            lambda fetch=True: self.rows_stack_for(idx, field, views,
                                                   row_key, skey, fetch),
            lambda: idx.fields.get(field.name) is field,
            placed=(idx, skey, 1))

    def row_stack(self, idx, field, views: tuple[str, ...], row_id: int,
                  skey: tuple):
        """(S, W) stack of one row, unioned across views."""
        out = self.rows_stack_for(idx, field, views, (row_id,), skey)
        return out.lead_dropped() if isinstance(out, PageView) else out[0]

    def plane_stack(self, idx, field, skey: tuple, fetch: bool = True):
        """(S, 2+depth, W) stack of a BSI field's planes."""
        depth = field.bit_depth
        frags = self._frags(field, field.bsi_view, skey)
        if not fetch:
            return frags

        def build_host():
            out = np.zeros((len(skey), 2 + depth, idx.width // 32),
                           dtype=np.uint32)
            for si, fr in enumerate(frags):
                if fr is not None:
                    for r in range(2 + depth):
                        out[si, r] = fr.row_words(r)
            return out

        return self._stack(
            ("planes", idx.name, field.name, depth, skey, self._mesh_key()),
            frags,
            build_host,
            lambda: _PlanesLayout(frags, depth, idx.width // 32),
            (len(skey), 2 + depth),
            lambda fetch=True: self.plane_stack(idx, field, skey, fetch),
            lambda: idx.fields.get(field.name) is field,
            placed=(idx, skey, 0))

    def existence_stack(self, idx, skey: tuple):
        from pilosa_tpu_torch.models.index import EXISTENCE_FIELD
        return self.row_stack(idx, idx.fields[EXISTENCE_FIELD],
                              (VIEW_STANDARD,), 0, skey)

    # -- entry points --------------------------------------------------------

    def _run(self, plan, b: PlanBuilder, span: bool = True):
        """One plan on the device, in a ``stacked.dispatch`` span unless
        it only makes an operand of a later launch (a GroupBy's filter);
        see _dispatch.  On an executor on the CPU, a dispatched plan that
        stays out of memory after the OOM ladder's retry runs again as
        the host fallback (pressure.run_host_plan); on the card, and for
        an operand, the OOM is raised."""
        if not span:
            run = _plan_run(plan)
            return pressure.guarded(lambda: run(b.leaves, b.params))
        return self._run_plans([(plan, b)], lambda outs, _lead: outs[0])

    def _run_plans(self, legs, combine):
        """[(plan, builder)], one a leg, in one dispatch over the legs
        (_dispatch_legs), combined on the lead device.  On an executor
        on the CPU, plans that stay out of memory after the OOM ladder's
        retry run again as the host fallback (pressure.run_host_plan);
        on the card the OOM is raised."""
        runs = [lambda run=_plan_run(plan), b=b: run(b.leaves, b.params)
                for plan, b in legs]
        host = None
        if self.device.type == "cpu":
            def host():
                return combine([pressure.run_host_plan(plan, b.leaves,
                                                       b.params)
                                for plan, b in legs], self._lead())
        return self._dispatch_legs(
            legs[0][0][0], runs, combine, host=host,
            nbytes=sum(leaf_bytes(b.leaves) for _plan, b in legs))

    def _dispatch(self, kind: str, fn, host=None, nbytes: int = 0,
                  devices=None):
        """fn() in a ``stacked.dispatch`` span, under the OOM ladder
        (memory/pressure.py; ``host`` is its degraded-mode closure),
        timed into the flight record's execute phase; the clock stops
        when the card has finished (every caller pulls the result to the
        host next).  A clean dispatch (no OOM caught) notes ``nbytes``,
        its operands' bytes, over its time in the roofline attribution
        (obs/roofline.py) under the plan kind's op family.  ``devices``
        (a mesh dispatch) are every device the legs ran on.  Of the
        attempt that returned, the record's ``launch`` phase is the time
        until ``fn()`` returned (the host enqueueing the work), ``sync``
        the rest of ``execute`` (the host waiting for the card): their
        sum is ``execute`` unless the OOM ladder caught one, whose failed
        attempt and relief sweep are in ``execute`` alone.  A host
        fallback launched nothing and notes neither."""
        ran = []

        def run():
            ta = time.perf_counter()
            out = fn()
            tl = time.perf_counter()
            for dev in devices or (self.device,):
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
            ran.append((ta, tl))
            return out

        oom0 = metrics.OOM_TOTAL.total(outcome="caught")
        t0 = time.perf_counter()
        with start_span("stacked.dispatch", kind=kind):
            out = pressure.guarded(run, host_fallback=host)
        dt = time.perf_counter() - t0
        flight.note_phase("execute", dt, t0)
        clean = metrics.OOM_TOTAL.total(outcome="caught") == oom0
        if ran:
            (ta, tl), = ran
            ta = t0 if clean else ta
            flight.note_phase("launch", tl - ta, ta)
            flight.note_phase("sync", t0 + dt - tl, tl)
        if nbytes and clean:
            roofline.note(ROOF_OPS.get(kind, kind), nbytes, dt)
        return out

    @staticmethod
    def _build(b: PlanBuilder, call: Call):
        """PlanBuilder.build in a ``stacked.plan_build`` span.  The stack
        accesses inside it are timed by StackCache itself, so the flight
        record's plan_build phase is the walk alone."""
        acc = flight.active_acc()
        stack0 = (sum(v for k, v in acc.phases.items()
                      if k.startswith("stack_")) if acc else 0.0)
        t0 = time.perf_counter()
        with start_span("stacked.plan_build", call=call.name):
            tree = b.build(call)
        dt = time.perf_counter() - t0
        if acc is not None:
            dt -= sum(v for k, v in acc.phases.items()
                      if k.startswith("stack_")) - stack0
        flight.note_phase("plan_build", max(dt, 0.0))
        return tree

    def count(self, idx, call: Call, shards: list[int], pre: dict) -> int:
        """Exact Count of a bitmap tree.  Where the packed arms apply the
        tree is built over PageViews: a bare leaf of encoded pages, or a
        set op over leaves of packed pages, is counted on the host from
        what encoding took; any other tree expands its views to the
        operands the fetch would have assembled."""
        packed = self.mesh is None and self.sparse_fast()
        legs = []
        for eng, sl in self._legs(shards):
            b = PlanBuilder(eng, idx, sl, pre)
            with raw_pages() if packed else contextlib.nullcontext():
                tree = self._build(b, call)
            if tree == ("zeros",):
                return 0
            if packed:
                fast = self._count_packed_host(b, tree)
                if fast is None:
                    fast = self._count_setop_packed_host(b, tree)
                if fast is not None:
                    return fast
                b.leaves = [_expand_view(lf) for lf in b.leaves]
            legs.append((("count", tree, True), b))
        if not legs:
            return 0
        return int(self._run_plans(legs, sum_on))

    # -- the packed arms (no device program) ----------------------------------

    @staticmethod
    def _count_packed_host(b: PlanBuilder, tree):
        """Count of a bare leaf whose pages are all encoded: the sum of
        their encode-time popcounts.  None for anything else."""
        if tree[0] != "leaf":
            return None
        leaf = b.leaves[tree[1]]
        if not isinstance(leaf, PageView) or not leaf.all_encoded():
            return None
        t0 = time.perf_counter()
        total = sum(p.bit_count() for p in leaf.pages)
        flight.note_phase("execute", time.perf_counter() - t0)
        return int(total)

    @staticmethod
    def _leaf_positions(leaf):
        """(sorted distinct flat set-bit offsets, page partition) of a
        PageView whose pages are all packed, or None."""
        if not isinstance(leaf, PageView) or not leaf.pages:
            return None
        parts, off, sig = [], 0, []
        for p in leaf.pages:
            if not (encode.is_encoded(p) and p.kind == "packed"):
                return None
            pos = p.positions()
            parts.append(pos if off == 0 else pos + off)
            bits = p.page_lanes * p.width_words * 32
            sig.append(bits)
            off += bits
        pos = parts[0] if len(parts) == 1 else np.concatenate(parts)
        return pos, tuple(sig)

    @staticmethod
    def _member(a: np.ndarray, b: np.ndarray) -> np.ndarray:
        """Which elements of sorted distinct ``b`` are in sorted distinct
        ``a``."""
        if a.size == 0:
            return np.zeros(b.size, dtype=bool)
        idx = np.searchsorted(a, b)
        return (idx < a.size) & (a[np.minimum(idx, a.size - 1)] == b)

    def _count_setop_packed_host(self, b: PlanBuilder, tree):
        """Count of an n-ary set op over bare leaves of packed pages, by
        set algebra on their sorted coordinates.  None for anything
        else."""
        if tree[0] != "nary" or not all(c[0] == "leaf" for c in tree[2]):
            return None
        op = tree[1]
        t0 = time.perf_counter()
        leaves, sig = [], None
        for c in tree[2]:
            got = self._leaf_positions(b.leaves[c[1]])
            if got is None or (sig is not None and got[1] != sig):
                return None
            sig = got[1]
            leaves.append(got[0])
        if len(leaves) == 2:
            # both sides sorted distinct: the intersection size is the
            # count of adjacent duplicates in their merge
            x, y = leaves
            c = np.concatenate((x, y))
            c.sort(kind="stable")
            both = int((c[1:] == c[:-1]).sum())
            n = {"union": x.size + y.size - both, "intersect": both,
                 "difference": x.size - both,
                 "xor": x.size + y.size - 2 * both}[op]
        else:
            res = leaves[0]
            for p in leaves[1:]:
                if op == "union":
                    res = np.sort(np.concatenate(
                        (res, p[~self._member(res, p)])), kind="mergesort")
                elif op == "intersect":
                    res = res[self._member(p, res)]
                elif op == "difference":
                    res = res[~self._member(p, res)]
                else:
                    res = np.sort(np.concatenate(
                        (res[~self._member(p, res)],
                         p[~self._member(res, p)])), kind="mergesort")
            n = int(res.size)
        flight.note_phase("execute", time.perf_counter() - t0)
        return n

    @staticmethod
    def _row_counts_packed_host(view: PageView) -> np.ndarray:
        """(R,) counts of an unfiltered (R, S, W) candidate stack whose
        pages are all encoded, from their encode-time lane popcounts."""
        t0 = time.perf_counter()
        r, s, _w = view.shape
        flat = np.concatenate([np.asarray(p.lane_counts, dtype=np.int64)
                               for p in view.pages])
        out = flat[:r * s].reshape(r, s).sum(axis=1)
        flight.note_phase("execute", time.perf_counter() - t0)
        return out

    def words(self, idx, call: Call, shards: list[int], pre: dict):
        """(S, W) host uint32 result of a bitmap tree, or None for a
        statically empty tree (or an empty shard list)."""
        legs = []
        for eng, sl in self._legs(shards):
            b = PlanBuilder(eng, idx, sl, pre)
            tree = self._build(b, call)
            if tree == ("zeros",):
                return None
            legs.append((("words", tree), b))
        if not legs:
            return None
        return np.array(bm.to_numpy(self._run_plans(legs, cat_on)))

    def bsi_sum(self, idx, field, filter_call, shards: list[int], pre: dict):
        """(sum, count) over a BSI field under an optional filter tree;
        the plane-weighted total is combined in exact Python ints."""
        legs = []
        for eng, sl in self._legs(shards):
            b = PlanBuilder(eng, idx, sl, pre)
            planes_i = b._planes_leaf(field)
            tree = None
            if filter_call is not None:
                tree = b.build(filter_call)
                if tree == ("zeros",):
                    return 0, 0
            legs.append((("bsi_sum", planes_i, tree, True), b))
        if not legs:
            return 0, 0
        cnt, pos, neg = self._run_plans(legs, sum_on)
        return bsi_ops.host_sum(cnt.cpu(), pos.cpu(), neg.cpu())

    def row_counts(self, idx, field, views, row_ids, filter_call,
                   shards, pre: dict) -> np.ndarray:
        """(R,) exact counts of candidate rows of ``field`` (each unioned
        across ``views``) under an optional filter tree — the TopN/TopK
        scan (executor.go:2750 topKFilter) — over the legs of
        ``_grid_legs`` (on a mesh, rows split over "rows" and shards over
        "shards").  On one device the stack is fetched under
        sparse_raw(): a PageView of encoded pages answers an unfiltered
        scan from its lane popcounts; otherwise it expands to the
        operand the fetch would have assembled."""
        row_ids = [int(r) for r in row_ids]
        none = np.zeros(len(row_ids), dtype=np.int64)
        legs, starts = [], []
        for (rlo, rhi), eng, sl in self._grid_legs(len(row_ids), shards):
            with (self.sparse_raw() if self.mesh is None
                  else contextlib.nullcontext()):
                stack = eng.rows_stack_for(idx, field, tuple(views),
                                           row_ids[rlo:rhi], tuple(sl))
            if isinstance(stack, PageView):
                if filter_call is None and stack.all_encoded():
                    return self._row_counts_packed_host(stack)
                stack = _expand_view(stack)
            b = PlanBuilder(eng, idx, sl, pre)
            rows_i = b._add_leaf(stack)
            tree = b.build(filter_call) if filter_call is not None else None
            if tree == ("zeros",):
                return none
            legs.append((("row_counts", rows_i, tree, True), b))
            starts.append(rlo)
        if not legs:
            return none

        def combine(outs, lead):
            if len(outs) == 1:
                return outs[0]
            total = torch.zeros(len(row_ids), dtype=torch.int64, device=lead)
            for rlo, o in zip(starts, outs):
                total[rlo:rlo + o.shape[0]] += o.to(lead, non_blocking=True)
            return total
        return self._run_plans(legs, combine).cpu().numpy()

    # -- value histogram -----------------------------------------------------

    def filter_stack(self, idx, filter_call, skey: tuple, pre: dict,
                     timed: bool = False):
        """(S, W) device words of a bitmap tree, or None when the tree is
        statically empty.  ``timed`` (a bitmap call's words) puts the
        build in a stacked.plan_build span and the launch in a
        stacked.dispatch span, as the JAX package does; a filter, an
        operand of a later launch, opens neither.  None too for an empty
        shard list."""
        if not skey:
            return None
        b = PlanBuilder(self, idx, list(skey), pre)
        tree = self._build(b, filter_call) if timed else b.build(filter_call)
        if tree == ("zeros",):
            return None
        return self._run(("words", tree), b, span=timed)

    def bsi_value_hist(self, idx, field, filter_call, shards: list[int],
                       pre: dict):
        """Per-value histogram of a BSI field under an optional filter
        tree (kernels.bsi_value_hist, one groupby_fused pass per chunk of
        at most _REDUCE_MAX_SHARDS shards): returns (pos (2^d,), neg
        (2^d,)) int64, from which Min, Max and Distinct derive."""
        depth = field.bit_depth
        if not 1 <= depth <= _VALUEHIST_MAX_DEPTH:
            raise Unstackable(
                "value_hist_depth", f"value histogram of {field.name} at "
                f"depth {depth}: past depth {_VALUEHIST_MAX_DEPTH}")
        gb = self._onepass_kernel(2 << depth, 0, minmax=False)
        total = np.zeros(2 << depth, dtype=np.int64)
        for chunks in self._chunk_rounds(shards, _REDUCE_MAX_SHARDS):
            outs = []
            for eng, sc in chunks:
                filt = None
                if filter_call is not None:
                    filt = eng.filter_stack(idx, filter_call, sc, pre)
                    if filt is None:
                        continue
                outs.append(torch.cat(kernels.bsi_value_hist(
                    eng.plane_stack(idx, field, sc), filt, gb=gb)))
            if outs:
                total += sum_on(outs, self._lead()).cpu().numpy()
        return total[:1 << depth], total[1 << depth:]

    def decode_stream(self, idx, field, skey: tuple):
        """Decoded BSI values of ``field``, one device decode
        (bsi.decode_device) per chunk of at most _DECODE_CHUNK shards:
        yields (shard ids, exists (S_c, N) bool, values (S_c, N) int64)
        on the engine's device.  Shards with no fragment of the field
        hold no value and are skipped."""
        view = field.views.get(field.bsi_view)
        have = [s for s in skey
                if view is not None and view.fragment(s) is not None]
        for lo in range(0, len(have), _DECODE_CHUNK):
            sc = tuple(have[lo:lo + _DECODE_CHUNK])
            ex, vals = bsi_ops.decode_device(self.plane_stack(idx, field, sc))
            yield list(sc), ex, vals

    # -- GroupBy ---------------------------------------------------------------
    # The one-pass histogram reads every group-code and BSI plane word
    # once whatever the combo count; it needs each field's rows to be
    # disjoint in the data (mutex and bool fields always are; set fields
    # are checked and cached).  Overlapping rows, and shapes past the
    # histogram's code and shard bounds, go through the per-combo kernel.

    def _rows_disjoint(self, idx, f, row_ids, skey: tuple) -> bool:
        """True iff no column is set in two of `row_ids` of f: per
        fragment, the sum of the rows' popcounts equals the popcount of
        their union.  Cached per fragment under its stamp, so after a
        write only the written fragments are checked again, and none
        where an unwritten one already overlaps (None: not known)."""
        if f.options.type in (FieldType.MUTEX, FieldType.BOOL):
            return True
        row_key = tuple(int(r) for r in row_ids)
        if len(set(row_key)) != len(row_key):
            return False  # a duplicated row belongs to two combos
        key = (idx.name, f.name, row_key, skey)
        frags = self._frags(f, VIEW_STANDARD, skey)
        versions = stamps(frags)
        ent = self._disjoint_cache.get(key)
        # an entry holds None (not known) only beside a False
        if ent is not None and ent[0] == versions:
            self._disjoint_cache.move_to_end(key)
            return False not in ent[1]
        old = ent if ent is not None and len(ent[0]) == len(versions) \
            else (versions, [None] * len(frags))
        oks = [was if ov == nv else None
               for ov, nv, was in zip(old[0], versions, old[1])]
        for i, fr in enumerate(frags):
            if False in oks:
                break
            if oks[i] is None:
                oks[i] = fr is None or self._frag_disjoint(fr, row_key)
        self._disjoint_cache[key] = (versions, oks)
        self._disjoint_cache.move_to_end(key)
        while len(self._disjoint_cache) > 4096:
            self._disjoint_cache.popitem(last=False)
        return False not in oks

    @staticmethod
    def _frag_disjoint(fr, row_key) -> bool:
        acc, total = None, 0
        for r in row_key:
            wds = fr.row_words(r)
            total += int(np.bitwise_count(wds).sum())
            acc = wds.copy() if acc is None else acc | wds
        return total == int(np.bitwise_count(acc).sum())

    def groupcode_stack(self, idx, fields_rows, skey: tuple,
                        fetch: bool = True):
        """(S, CB+1, W) group-code stack: CB packed code bit-planes (each
        field's digit planes at its _code_space shift) and the valid
        plane last (the AND of the fields' row unions: the columns that
        belong to some combo).  Built on the host in one pass and cached
        by the fragments' version stamps."""
        fkey = tuple((f.name, tuple(int(r) for r in rl))
                     for f, rl in fields_rows)
        per_field = [self._frags(f, VIEW_STANDARD, skey)
                     for f, _ in fields_rows]
        frags = [fr for fs in per_field for fr in fs]
        if not fetch:
            return frags
        bits, shifts, _n_codes = _code_space(fields_rows)
        cb = sum(bits)

        def build_host():
            w = idx.width // 32
            out = np.zeros((len(skey), cb + 1, w), dtype=np.uint32)
            out[:, cb] = 0xFFFFFFFF
            for (_f, rl), frags, sh in zip(fields_rows, per_field, shifts):
                union = np.zeros((len(skey), w), np.uint32)
                for si, fr in enumerate(frags):
                    if fr is None:
                        continue
                    for di, r in enumerate(rl):
                        wds = fr.row_words(int(r))
                        union[si] |= wds
                        b = 0
                        while di >> b:
                            if (di >> b) & 1:
                                out[si, sh + b] |= wds
                            b += 1
                out[:, cb] &= union
            return out

        # group-code pages OR many rows a lane: eviction holds them longer
        return self._stack(
            ("groupcodes", idx.name, fkey, skey, self._mesh_key()), frags,
            build_host,
            lambda: _GroupcodeLayout(fields_rows, per_field, shifts, cb,
                                     len(skey), idx.width // 32),
            (len(skey), cb + 1),
            lambda fetch=True: self.groupcode_stack(idx, fields_rows, skey,
                                                    fetch),
            lambda: all(idx.fields.get(f.name) is f
                        for f, _rl in fields_rows),
            weight=4.0, placed=(idx, skey, 0))

    def _groupby_onepass_fits(self, idx, fields_rows, skey: tuple) -> bool:
        """The one-pass histogram's correctness bounds: a dense code space
        of at most 2^20 codes, int32-exact totals (at most
        _REDUCE_MAX_SHARDS shards), and disjoint rows in every field."""
        _bits, _shifts, n_codes = _code_space(fields_rows)
        if n_codes > _ONEPASS_MAX_CODES or len(skey) > _REDUCE_MAX_SHARDS:
            return False
        return all(self._rows_disjoint(idx, f, rl, skey)
                   for f, rl in fields_rows)

    def _onepass_kernel(self, n_codes: int, depth: int, minmax: bool):
        """The one-pass histogram kernel for a shape: groupby_onehot under
        the "onehot" arm within its bounds (no Min/Max table, at most
        ONEHOT_MAX_CODES codes, depth ONEHOT_MAX_DEPTH), else
        groupby_fused (the JAX package's _onepass_arm, with
        groupby_fused standing in for its "xla" arm)."""
        if self.onepass_arm not in ONEPASS_ARMS:
            raise ValueError(f"onepass_arm must be one of {ONEPASS_ARMS}, "
                             f"not {self.onepass_arm!r}")
        if (self.onepass_arm == "onehot" and not minmax
                and n_codes <= kernels.ONEHOT_MAX_CODES
                and depth <= kernels.ONEHOT_MAX_DEPTH):
            return kernels.groupby_onehot
        return kernels.groupby_fused

    def _groupby_onepass_path(self, idx, fields_rows, agg_field, skey: tuple,
                              combos, depth: int, signed: bool, filter_call,
                              pre: dict, agg_op: str = "sum"):
        """The one-pass histogram (_onepass_kernel) over the dense code
        space, gathered at the requested combos.  Returns (counts, None |
        (nn, pos, neg)) int64, or (counts, (nn, values)) for agg_op
        "min"/"max"."""
        minmax = agg_op in ("min", "max")
        _bits, shifts, n_codes = _code_space(fields_rows)
        codes = _combo_codes(shifts, np.asarray(combos, dtype=np.int64)
                             .reshape(len(combos), len(fields_rows)))
        gb = self._onepass_kernel(n_codes, depth, minmax)
        runs = []
        for eng, sl in self._legs(skey):
            sc = tuple(sl)
            cg = eng.groupcode_stack(idx, fields_rows, sc)
            valid = cg[:, -1]
            if filter_call is not None:
                filt = eng.filter_stack(idx, filter_call, sc, pre)
                if filt is None:
                    return _zero_groupby_result(len(combos), depth,
                                                agg_field, agg_op)
                valid = valid & filt
            planes = (eng.plane_stack(idx, agg_field, sc)
                      if agg_field is not None else None)
            runs.append(lambda cg=cg, v=valid, p=planes: (
                gb(cg[:, :-1], v, p, n_codes, signed, minmax=True)
                if minmax else gb(cg[:, :-1], v, p, n_codes, signed)))

        def combine(outs, lead):
            if len(outs) == 1:
                return outs[0]
            if outs[0][1] is None:
                return (sum_on([o[0] for o in outs], lead),)
            summed = sum_on([tuple(o[:4]) for o in outs], lead)
            if not minmax:
                return summed
            return summed + (minmax_table_on([o[4] for o in outs], lead),)
        out = self._dispatch_legs("groupby", runs, combine)
        if agg_field is None:
            counts = out[0].cpu().numpy().astype(np.int64)
            return counts[codes], None
        g = n_codes
        flat = torch.cat([x.reshape(-1) for x in out]).cpu().numpy() \
            .astype(np.int64)
        counts, nn = flat[:g], flat[g:2 * g]
        if minmax:
            vals, _has = kernels.minmax_from_table(
                flat[2 * g + 2 * g * depth:].reshape(4, g), depth, agg_op)
            return counts[codes], (nn[codes], vals[codes])
        pos = flat[2 * g:2 * g + g * depth].reshape(g, depth)
        neg = flat[2 * g + g * depth:2 * g + 2 * g * depth].reshape(g, depth)
        return counts[codes], (nn[codes], pos[codes], neg[codes])

    def _groupby_kernel_path(self, idx, fields_rows, agg_field, skey: tuple,
                             combos, depth: int, signed: bool, filter_call,
                             pre: dict):
        """The per-combo kernel (groupby_sum) over shard chunks whose
        gathered row stacks fit _GROUPBY_STACK_BUDGET and whose int32
        totals stay exact, one dispatch a round of the legs' chunks
        (_chunk_rounds); totals are summed as int64.  A filter is ANDed
        into the first field's stack: every term of the kernel includes
        the combo's AND, so one mask filters counts and aggregates
        alike.  None for a statically empty filter."""
        k, nf = len(combos), len(fields_rows)
        sel_host = np.ascontiguousarray(
            np.asarray(combos, dtype=np.int32).reshape(k, nf))
        per_shard = sum(len(rl) for _, rl in fields_rows) * idx.width // 8
        chunk = max(1, min(_REDUCE_MAX_SHARDS,
                           _GROUPBY_STACK_BUDGET // max(per_shard, 1)))
        flat = np.zeros(k * (1 if agg_field is None else 2 + 2 * depth),
                        dtype=np.int64)
        for chunks in self._chunk_rounds(skey, chunk):
            runs = []
            for eng, sc in chunks:
                stacks = [eng.rows_stack_for(idx, f, (VIEW_STANDARD,), rl, sc)
                          for f, rl in fields_rows]
                if filter_call is not None:
                    filt = eng.filter_stack(idx, filter_call, sc, pre)
                    if filt is None:
                        return None
                    stacks[0] = stacks[0] & filt.unsqueeze(0)
                planes = (eng.plane_stack(idx, agg_field, sc)
                          if agg_field is not None else None)
                sel = torch.from_numpy(sel_host).to(eng.device)

                def run(st=stacks, s=sel, p=planes):
                    out = kernels.groupby_sum(st, s, p, signed)
                    return torch.cat([x.reshape(-1) for x in out
                                      if x is not None])
                runs.append(run)
            flat += self._dispatch_legs("groupby", runs,
                                        sum_on).cpu().numpy()
        if agg_field is None:
            return flat, None
        return flat[:k], (flat[k:2 * k],
                          flat[2 * k:2 * k + k * depth].reshape(k, depth),
                          flat[2 * k + k * depth:].reshape(k, depth))

    def groupby(self, idx, fields_rows, filter_call, agg_field,
                shards: list[int], combos, pre: dict, agg_op: str = "sum"):
        """GroupBy of the given combos (index tuples into each field's row
        list, in product order): (counts (C,) int64, None | (nn (C,),
        pos (C, d), neg (C, d)) int64) for a Sum aggregate, or (counts,
        (nn, values)) for agg_op "min"/"max".  Min/Max run only on the
        one-pass histogram; the shapes it cannot take raise Unstackable
        (the per-shard engine's _groupby_minmax_loop serves them)."""
        skey = tuple(shards)
        n_combos = len(combos)
        depth = agg_field.bit_depth if agg_field is not None else 0
        if not skey:
            return _zero_groupby_result(n_combos, depth, agg_field, agg_op)
        # skip the sign split when no fragment holds a sign bit — checked
        # against the data, since value writes are not range-enforced
        signed = False
        if agg_field is not None:
            signed = any(fr is not None and 1 in fr.row_ids
                         for fr in self._frags(agg_field, agg_field.bsi_view,
                                               skey))
        if agg_op in ("min", "max"):
            if (depth > _ONEPASS_MINMAX_MAX_DEPTH
                    or not self._groupby_onepass_fits(idx, fields_rows, skey)):
                raise Unstackable(
                    "groupby_minmax", "GroupBy Min/Max over overlapping "
                    f"rows, past depth {_ONEPASS_MINMAX_MAX_DEPTH} or past "
                    "the one-pass bounds")
            return self._groupby_onepass_path(
                idx, fields_rows, agg_field, skey, combos, depth, signed,
                filter_call, pre, agg_op)
        if n_combos and self._groupby_onepass_fits(idx, fields_rows, skey):
            return self._groupby_onepass_path(
                idx, fields_rows, agg_field, skey, combos, depth, signed,
                filter_call, pre)
        out = self._groupby_kernel_path(idx, fields_rows, agg_field, skey,
                                        combos, depth, signed, filter_call,
                                        pre)
        if out is None:
            return _zero_groupby_result(n_combos, depth, agg_field)
        return out
