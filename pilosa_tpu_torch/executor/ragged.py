"""Ragged paged dispatch: ONE fused program for heterogeneous serving
traffic.

The per-group batcher fuses only queries over the same (index, shard
set): a mixed batch (point Counts next to TopNs over different indexes
and shard subsets) pays one "multi" dispatch a group.  Since device
stacks are fixed-size lane-block pages (memory/pages.py), the Ragged
Paged Attention layout applies directly: instead of one program a
group, one program over a page table:

- every group's plan is built as usual (a shared ``PlanBuilder`` a
  group), but under ``stacked.raw_pages()`` its stack leaves come back
  as :class:`PageView` handles (the cache's pages) instead of assembled
  operands;
- the pages of every query land in per-(page_lanes, width) buckets,
  encoded pages expanded to dense (``PageView.dense_pages``, one
  ``assemble_pages`` launch a page on the card); a lane-index array an
  operand gathers it out of its bucket with one ``concat_gather``
  launch, the bucket's concatenation never built;
- single-leaf Counts, the dominant point-read shape, skip operand
  materialisation entirely: their lanes form one segment family a
  bucket, reduced by one ``segment_count`` launch (popcount + segment
  sum, one pass over the lanes);
- every other subplan kind (tree counts, words, bsi_sum, row_counts,
  gb_hist) evaluates exactly as in the "multi" plan over the combined
  virtual + direct leaf space, so results are bit-exact by
  construction.

The plan is stacked.py's ``("ragged", buckets, vmeta, subs)``; lane and
segment indices ride as params, uploaded to the device once a built
program, and each bucket's page table (``kernels.gather_table``) is
built once a program too.  The port has no compile cache, so nothing is
padded to a power of two: a segment family's ids are exactly
0..nseg-1.

``CanonicalComposition`` keeps a canonical slot set of recurring
queries and caches the built canonical program against the slot set's
fingerprint and the process mutation epoch (models/fragment.py): a
read-heavy steady state replays it, skipping plan building and stack
fetches, and any write anywhere rebuilds.  One-off queries ride a
per-batch "extras" program.

Consistency is inherited from the serving layer: the post-batch
snapshot re-check (executor/serving.py ``_run_batch``) re-executes any
rider whose fragment-version snapshot moved while the program ran.
A program that fails to build or run sends its riders to their solo
paths, never to an error.

**The serving mesh** (``memory/placement.py``, on where its width is
above 1): every paged stack partitions its lanes by their shard's owner
slot and each page lives on its owner's device.  The program becomes
``("ragged_mesh", ...)``: each slot's buckets hold only its own pages
(``_add_mesh_leaf``), each virtual leaf is gathered on every slot out
of that slot's pool with its shard axis cut to the shards the slot owns
(``_finalize_mesh``), each subplan and segment family runs on every
slot that owns shards of its group, and the partials combine on the
lead slot's device: an int64 sum for the reduced outputs, and a copy to
the shard positions (``index_copy_``) for a bitmap's words.  A leaf
whose lane owner is not its group's owner (a rebalance between the
build and the program: "placement drift"), or a leaf that is not
paged, raises RaggedUnbuildable, and the batch takes its per-group
path.  The cached canonical program pins the mesh width and the
placement epoch it was built under; a change of either builds it
again.
"""

from __future__ import annotations

import threading
from collections import OrderedDict

import numpy as np
import torch

from pilosa_tpu_torch.executor.stacked import PageView, PlanBuilder, raw_pages
from pilosa_tpu_torch.memory import encode, placement
from pilosa_tpu_torch.obs import flight
from pilosa_tpu_torch.ops import kernels


class RaggedUnbuildable(Exception):
    """A subplan the ragged program cannot express (falls back to the
    per-group path)."""


# ---------------------------------------------------------------------------
# IR remapping (group-local leaf/param indices -> fused global space)
# ---------------------------------------------------------------------------

def _remap_tree(node, lmap, poff):
    k = node[0]
    if k == "leaf":
        return ("leaf", lmap[node[1]])
    if k == "zeros":
        return node
    if k == "nary":
        return ("nary", node[1],
                tuple(_remap_tree(c, lmap, poff) for c in node[2]))
    if k == "not":
        return ("not", lmap[node[1]], _remap_tree(node[2], lmap, poff))
    if k == "qcover":
        return ("qcover", tuple(lmap[i] for i in node[1]))
    if k == "shift":
        return ("shift", node[1], _remap_tree(node[2], lmap, poff))
    if k == "bsi_range":
        return ("bsi_range", lmap[node[1]], node[2],
                *(p + poff for p in node[3:]))
    if k == "bsi_notnull":
        return ("bsi_notnull", lmap[node[1]])
    if k == "bsi_null":
        return ("bsi_null", lmap[node[1]], lmap[node[2]])
    raise RaggedUnbuildable(f"unknown IR node {k}")


def _remap_sub(sub, lmap, poff):
    kind = sub[0]
    if kind == "count":
        return ("count", _remap_tree(sub[1], lmap, poff)) + sub[2:]
    if kind == "words":
        return ("words", _remap_tree(sub[1], lmap, poff))
    if kind in ("bsi_sum", "row_counts"):
        tree = None if sub[2] is None else _remap_tree(sub[2], lmap, poff)
        return (kind, lmap[sub[1]], tree) + sub[3:]
    if kind == "gb_hist":
        # the group-code stack and the BSI planes gather through the
        # same page table as every other operand
        tree = None if sub[2] is None else _remap_tree(sub[2], lmap, poff)
        planes = None if sub[3] is None else lmap[sub[3]]
        return ("gb_hist", lmap[sub[1]], tree, planes) + sub[4:]
    raise RaggedUnbuildable(f"unraggable sub kind {kind}")


def _tree_refs(node, out: set) -> None:
    k = node[0]
    if k == "leaf":
        out.add(node[1])
    elif k == "nary":
        for c in node[2]:
            _tree_refs(c, out)
    elif k == "not":
        out.add(node[1])
        _tree_refs(node[2], out)
    elif k == "qcover":
        out.update(node[1])
    elif k == "shift":
        _tree_refs(node[2], out)
    elif k in ("bsi_range", "bsi_notnull"):
        out.add(node[1])
    elif k == "bsi_null":
        out.update(node[1:3])


def _sub_refs(sub) -> set:
    """The local leaf indices a subplan reads."""
    out: set = set()
    if sub[0] in ("bsi_sum", "row_counts", "gb_hist"):
        out.add(sub[1])
        if sub[2] is not None:
            _tree_refs(sub[2], out)
        if sub[0] == "gb_hist" and sub[3] is not None:
            out.add(sub[3])
    else:
        _tree_refs(sub[1], out)
    return out


# ---------------------------------------------------------------------------
# program assembly
# ---------------------------------------------------------------------------

class RaggedProgram:
    """Accumulates per-group (PlanBuilder, subplans) contributions and
    finalizes them into ONE ``("ragged", ...)`` plan + leaves + params.
    Groups stay what they were (one PlanBuilder an (index identity,
    shard set)); the program is what fuses across them."""

    # a segment family below this size gains nothing over a plain count
    # subplan; at two or more it shares one segment_count launch
    _SEG_MIN = 2

    def __init__(self, ndev: int = 1):
        # the serving mesh's width; above 1 finalize() emits a
        # ("ragged_mesh", ...) plan and the buckets hold one page list
        # a slot
        self.ndev = int(ndev)
        self.mesh = self.ndev > 1
        self.group_owners: list = []
        self.dev_mix = [dict() for _ in range(self.ndev)]
        # (page_lanes, width_words) -> dense pages of the bucket
        self.buckets: OrderedDict[tuple, list] = OrderedDict()
        # (bucket key, lane_idx (L,) int32, shape)
        self.vleaves: list = []
        self.direct: list = []
        self.params: list = []
        # (entries, lmap, poff) a group; lmap: local leaf index ->
        # ("v", vleaf) | ("d", direct); an entry is (riders, subplan,
        # demux, slot_key) and riders may be empty for a canonical slot
        # absent from this batch (its sub still evaluates)
        self.groups: list = []
        self.device = None

    def add_group(self, builder: PlanBuilder, entries: list,
                  owners=None) -> None:
        """``entries``: [(riders, subplan, demux, slot_key), ...] built
        against ``builder``, whose leaves may be PageViews.  ``owners``:
        each shard's owner slot (int32, len(builder.skey)), required
        under the serving mesh, where a leaf that is not a placed
        PageView raises RaggedUnbuildable (nothing is added then)."""
        if self.mesh:
            for leaf in builder.leaves:
                if (not isinstance(leaf, PageView) or leaf.page_device is None
                        or leaf.shard_axis is None):
                    raise RaggedUnbuildable(
                        "a leaf with no placed pages under the mesh")
            if owners is None:
                raise RaggedUnbuildable("a mesh group without owners")
        poff = len(self.params)
        self.params.extend(builder.params)
        self.device = builder.engine.device
        gidx = len(self.groups)
        lmap: dict = {}
        for i, leaf in enumerate(builder.leaves):
            if self.mesh:
                lmap[i] = ("v", self._add_mesh_leaf(leaf, gidx))
                continue
            if isinstance(leaf, PageView):
                key = (leaf.page_lanes, leaf.width_words)
                pages = self.buckets.setdefault(key, [])
                base = len(pages) * leaf.page_lanes
                # the per-page decode-to-dense boundary: the bucket is a
                # homogeneous dense pool (page identity and lane
                # mapping unchanged)
                pages.extend(leaf.dense_pages())
                lane_idx = (base + np.arange(leaf.lanes)).astype(np.int32)
                lmap[i] = ("v", len(self.vleaves))
                self.vleaves.append((key, lane_idx, leaf.shape))
            else:
                lmap[i] = ("d", len(self.direct))
                self.direct.append(leaf)
        self.groups.append((entries, lmap, poff))
        self.group_owners.append(owners)

    def _add_mesh_leaf(self, leaf: PageView, gidx: int) -> int:
        """One placed PageView's pages into its slots' bucket pools
        (expanded to dense on their owner's device); returns the virtual
        leaf's index.  ``pool_row[lane]`` is the lane's row in its owner
        slot's pool of the bucket."""
        key = (leaf.page_lanes, leaf.width_words)
        per_dev = self.buckets.setdefault(key, [[] for _ in range(self.ndev)])
        slot = np.empty(len(leaf.pages), dtype=np.int64)
        for pi, page in enumerate(leaf.pages):
            d = int(leaf.page_device[pi])
            if not 0 <= d < self.ndev:
                raise RaggedUnbuildable("an owner slot outside the mesh")
            slot[pi] = len(per_dev[d])
            per_dev[d].append(encode.to_dense(page))
            mk = encode.page_kind(page)
            self.dev_mix[d][mk] = self.dev_mix[d].get(mk, 0) + 1
        lane_page = leaf.lane_page.astype(np.int64)
        pool_row = slot[lane_page] * leaf.page_lanes + leaf.lane_slot
        lane_dev = np.asarray(leaf.page_device, dtype=np.int32)[lane_page]
        self.vleaves.append((key, pool_row, lane_dev, leaf.shape,
                             leaf.shard_axis, gidx))
        return len(self.vleaves) - 1

    def _add_mesh_param(self, arr: np.ndarray, device,
                        dtype=torch.int32) -> int:
        """An index array on one slot's device (int32 for the kernels,
        int64 for index_copy_); returns its index."""
        self.params.append(torch.from_numpy(np.ascontiguousarray(arr))
                           .to(device=device, dtype=dtype))
        return len(self.params) - 1

    def _add_param(self, arr) -> int:
        """Append a param (an int32 index array goes to the device
        once); returns its index."""
        if isinstance(arr, np.ndarray):
            arr = torch.from_numpy(np.ascontiguousarray(
                arr, dtype=np.int32)).to(self.device)
        self.params.append(arr)
        return len(self.params) - 1

    def finalize(self):
        """(plan, leaves, params, served, table) or None when nothing
        was built.  ``served``: [(req, demux, extract), ...] where
        extract is ("plain", sub_i) or ("seg", sub_i, slot); ``table``:
        slot_key -> (demux, extract), the cross-batch program cache's
        rider map."""
        if not any(entries for entries, _l, _p in self.groups):
            return None
        # -- segment families: reduced single-leaf Counts whose leaf is
        # paged coalesce a bucket into one segment_count
        families: OrderedDict[tuple, list] = OrderedDict()
        for entries, lmap, _poff in self.groups:
            for ent in entries:
                sub = ent[1]
                if (sub[0] == "count" and len(sub) > 2 and sub[2]
                        and sub[1][0] == "leaf"
                        and lmap.get(sub[1][1], ("", 0))[0] == "v"):
                    v = self.vleaves[lmap[sub[1][1]][1]]
                    families.setdefault(v[0], []).append((ent, v))
        seg_entry: set = set()
        for vkey, members in list(families.items()):
            if len(members) < self._SEG_MIN:
                del families[vkey]
                continue
            seg_entry.update(id(ent) for ent, _v in members)
        # -- keep only the virtual leaves some non-segment subplan reads:
        # a leaf consumed only by a segment family is never gathered
        plain: list = []      # (ent, lmap, poff) in batch order
        kept: set[int] = set()
        for entries, lmap, poff in self.groups:
            for ent in entries:
                if id(ent) in seg_entry:
                    continue
                plain.append((ent, lmap, poff))
                for li in _sub_refs(ent[1]):
                    tag, i = lmap[li]
                    if tag == "v":
                        kept.add(i)
        vkeep = sorted(kept)
        vre = {vi: k for k, vi in enumerate(vkeep)}
        if self.mesh:
            return self._finalize_mesh(families, plain, vkeep, vre)
        # -- leaf layout: the pages of every bucket something reads,
        # then the direct leaves
        used = {self.vleaves[vi][0] for vi in vkeep} | set(families)
        bucket_meta: list = []
        bucket_id: dict = {}
        leaves: list = []
        for key, pages in self.buckets.items():
            if key not in used:
                continue
            ti = self._add_param(kernels.gather_table(pages))
            bucket_id[key] = len(bucket_meta)
            bucket_meta.append((len(leaves), len(pages), ti))
            leaves.extend(pages)
        nv = len(vkeep)
        leaves.extend(self.direct)
        vmeta = tuple((bucket_id[self.vleaves[vi][0]],
                       self._add_param(self.vleaves[vi][1]),
                       tuple(self.vleaves[vi][2])) for vi in vkeep)
        # -- subplans over the fused leaf space.  Identical remapped
        # subplans dedupe to one executed sub with several riders.
        subs: list = []
        served: list = []
        table: dict = {}
        sub_ix: dict = {}
        for ent, lmap, poff in plain:
            final = {li: (vre.get(i) if tag == "v" else nv + i)
                     for li, (tag, i) in lmap.items()}
            riders, sub, demux, slot_key = ent
            rsub = _remap_sub(sub, final, poff)
            i = sub_ix.get(rsub)
            if i is None:
                subs.append(rsub)
                i = sub_ix[rsub] = len(subs) - 1
            if slot_key is not None:
                table[slot_key] = (demux, ("plain", i))
            for r in riders:
                served.append((r, demux, ("plain", i)))
        for vkey, members in families.items():
            # duplicate calls share one leaf (PlanBuilder dedupe), so
            # their lane array is one object: one segment serves them
            slot_of: dict[int, int] = {}
            uniq: list = []
            member_slots: list = []
            for ent, v in members:
                li = v[1]
                s = slot_of.get(id(li))
                if s is None:
                    s = slot_of[id(li)] = len(uniq)
                    uniq.append(li)
                member_slots.append((ent, s))
            gi = self._add_param(np.concatenate(uniq))
            si = self._add_param(np.concatenate(
                [np.full(li.shape[0], slot, np.int32)
                 for slot, li in enumerate(uniq)]))
            subs.append(("segcount", bucket_id[vkey], gi, si, len(uniq)))
            for ent, slot in member_slots:
                riders, _sub, demux, slot_key = ent
                ext = ("seg", len(subs) - 1, slot)
                if slot_key is not None:
                    table[slot_key] = (demux, ext)
                for r in riders:
                    served.append((r, demux, ext))
        if not subs:
            return None
        plan = ("ragged", tuple(bucket_meta), vmeta, tuple(subs))
        return plan, leaves, self.params, served, table

    def _finalize_mesh(self, families, plain, vkeep, vre):
        """The ``("ragged_mesh", ndev, epoch, buckets, vmeta, subs,
        runs_on, combines, lead device)`` plan: one page list and gather table a
        (bucket, slot), one gather param a (virtual leaf, slot) over the
        shards the slot owns, and for each subplan the slots it runs on
        and how its partials combine (``("sum",)`` or ``("scatter",
        per-slot shard positions, S)``).  Returns what finalize() returns plus
        the per-slot bytes and page mix."""
        ndev = self.ndev
        devs = placement.devices()
        if len(devs) < ndev:
            raise RaggedUnbuildable("the mesh shrank below the plan's width")
        used = {self.vleaves[vi][0] for vi in vkeep} | set(families)
        leaves: list = []
        bucket_meta: list = []
        bucket_id: dict = {}
        dev_bytes = [0] * ndev
        for key, per_dev in self.buckets.items():
            if key not in used:
                continue
            metas = []
            for d in range(ndev):
                pages = per_dev[d]
                if not pages:
                    metas.append(None)
                    continue
                self.params.append(kernels.gather_table(pages))
                metas.append((len(leaves), len(pages), len(self.params) - 1))
                leaves.extend(pages)
                dev_bytes[d] += sum(int(p.nbytes) for p in pages)
            bucket_id[key] = len(bucket_meta)
            bucket_meta.append(tuple(metas))
        # each group's shards by owner slot
        geo: dict = {}

        def owned(gidx):
            g = geo.get(gidx)
            if g is None:
                own = self.group_owners[gidx]
                g = geo[gidx] = (int(own.shape[0]), [
                    np.flatnonzero(own == d) for d in range(ndev)])
            return g
        vmeta: list = []
        for vi in vkeep:
            key, pool_row, lane_dev, shape, sa, gidx = self.vleaves[vi]
            s, sel = owned(gidx)
            lead = tuple(shape[:-1])
            if lead[sa] != s:
                raise RaggedUnbuildable("a leaf's shard axis differs from "
                                        "its group's shards")
            grid = np.arange(pool_row.size, dtype=np.int64).reshape(lead)
            per = []
            for d in range(ndev):
                if not sel[d].size:
                    per.append(None)
                    continue
                lanes = np.take(grid, sel[d], axis=sa).reshape(-1)
                if np.any(lane_dev[lanes] != d):
                    raise RaggedUnbuildable("placement drift: a lane's "
                                            "owner is not its group's")
                local = list(lead)
                local[sa] = sel[d].size
                per.append((bucket_id[key],
                            self._add_mesh_param(pool_row[lanes], devs[d]),
                            tuple(local) + (shape[-1],)))
            vmeta.append(tuple(per))
        subs: list = []
        runs_on: list = []
        combines: list = []
        served: list = []
        table: dict = {}
        sub_ix: dict = {}
        spos: dict = {}

        def scatter_params(gidx):
            p = spos.get(gidx)
            if p is None:
                _s, sel = owned(gidx)
                p = spos[gidx] = tuple(
                    self._add_mesh_param(sel[d], devs[0], torch.int64)
                    if sel[d].size else None for d in range(ndev))
            return p

        group_of = {id(gl): gi for gi, (_e, gl, _p) in enumerate(self.groups)}
        for ent, lmap, poff in plain:
            gidx = group_of[id(lmap)]
            final = {li: vre[i] for li, (_tag, i) in lmap.items()
                     if i in vre}
            riders, sub, demux, slot_key = ent
            rsub = _remap_sub(sub, final, poff)
            i = sub_ix.get(rsub)
            if i is None:
                s, sel = owned(gidx)
                subs.append(rsub)
                runs_on.append(tuple(d for d in range(ndev) if sel[d].size))
                combines.append(self._combine_of(rsub, gidx, s,
                                                 scatter_params))
                i = sub_ix[rsub] = len(subs) - 1
            if slot_key is not None:
                table[slot_key] = (demux, ("plain", i))
            for r in riders:
                served.append((r, demux, ("plain", i)))
        for vkey, members in families.items():
            slot_of: dict[int, int] = {}
            uniq: list = []
            member_slots: list = []
            for ent, v in members:
                s_ = slot_of.get(id(v))
                if s_ is None:
                    s_ = slot_of[id(v)] = len(uniq)
                    uniq.append(v)
                member_slots.append((ent, s_))
            per = []
            for d in range(ndev):
                rows, segs = [], []
                for seg, v in enumerate(uniq):
                    _key, pool_row, lane_dev, _shape, _sa, _g = v
                    mine = lane_dev == d
                    rows.append(pool_row[mine])
                    segs.append(np.full(int(mine.sum()), seg, np.int32))
                rows = np.concatenate(rows)
                if not rows.size:
                    per.append(None)
                    continue
                per.append((self._add_mesh_param(rows, devs[d]),
                            self._add_mesh_param(np.concatenate(segs),
                                                 devs[d])))
            subs.append(("segcount", bucket_id[vkey], tuple(per), len(uniq)))
            runs_on.append(tuple(d for d in range(ndev) if per[d] is not None))
            combines.append(("sum",))
            for ent, slot in member_slots:
                riders, _sub, demux, slot_key = ent
                ext = ("seg", len(subs) - 1, slot)
                if slot_key is not None:
                    table[slot_key] = (demux, ext)
                for r in riders:
                    served.append((r, demux, ext))
        if not subs:
            return None
        plan = ("ragged_mesh", ndev, placement.epoch(), tuple(bucket_meta),
                tuple(vmeta), tuple(subs), tuple(runs_on), tuple(combines),
                devs[0])
        meshinfo = {"ndev": ndev, "dev_bytes": dev_bytes,
                    "dev_pages": [dict(m) for m in self.dev_mix]}
        return plan, leaves, self.params, served, table, meshinfo

    @staticmethod
    def _combine_of(sub, gidx: int, s: int, scatter_params):
        """How a subplan's slot partials combine: the reduced outputs
        (the serving layer reduces every count, Sum and TopN subplan on
        the device) and a GroupBy histogram by an int64 sum, a bitmap's
        (S, W) words by copying each slot's rows to their shard
        positions."""
        kind = sub[0]
        if kind == "words":
            return ("scatter", scatter_params(gidx), s)
        reduced = {"count": 2, "bsi_sum": 3, "row_counts": 3}.get(kind)
        if kind == "gb_hist" or (reduced and len(sub) > reduced
                                 and sub[reduced]):
            return ("sum",)
        raise RaggedUnbuildable(f"an unreduced {kind} under the mesh")


# ---------------------------------------------------------------------------
# canonical composition
# ---------------------------------------------------------------------------
# The layer keeps a canonical slot set of RECURRING (index, shards,
# query) items, LRU-bounded, and every batch dispatches the one
# canonical program: present riders demux their slots, absent slots
# still evaluate, so the built program (plan, leaves, params, tables)
# can be kept and replayed while the data is unchanged.  Probation keeps
# one-off queries out: a key joins the canonical set only on a second
# sighting within the probation window; the others ride an extras
# program built for their batch alone.

_CANON_MAX = 96        # max canonical slots (absent-slot work bound)
_CANON_IDLE = 64       # batches a slot may sit unused before aging out
_CANON_PROBATION = 32  # window (batches) for the second sighting
_SEEN_MAX = 512        # probation bookkeeping bound


def _slot_key(r) -> tuple:
    return (id(r.idx), r.skey, r.kind, repr(r.call))


class _Slot:
    __slots__ = ("idx", "index_name", "skey", "shards", "kind",
                 "call", "last_used")

    def __init__(self, r, batch_no):
        self.idx = r.idx
        self.index_name = r.index
        self.skey = r.skey
        self.shards = r.shards
        self.kind = r.kind
        self.call = r.call
        self.last_used = batch_no


class _ShimReq:
    """Stand-in for a canonical slot absent from this batch: enough of
    the request's surface for ServingLayer._build_sub."""

    __slots__ = ("idx", "call", "kind", "shards", "skey", "result",
                 "error", "direct", "ctx", "acc")

    def __init__(self, slot: _Slot):
        self.idx = slot.idx
        self.call = slot.call
        self.kind = slot.kind
        self.shards = slot.shards
        self.skey = slot.skey
        self.result = None
        self.error = None
        self.direct = False
        self.ctx = None
        self.acc = flight.Acc()


class CanonicalComposition:
    """The layer's slot set, probation bookkeeping, the cached canonical
    program and the lock guarding them."""

    def __init__(self):
        self.slots: OrderedDict[tuple, _Slot] = OrderedDict()
        self.seen: OrderedDict[tuple, int] = OrderedDict()
        self.batch_no = 0
        self.lock = threading.Lock()
        # (slot fingerprint, mutation epoch, plan, leaves, params,
        # table, consts): valid while the slot set and the process
        # mutation epoch are unchanged.  Holding ``leaves`` pins the
        # canonical working set's device pages between batches,
        # bounded by _CANON_MAX slots.
        self.cached = None
        # canonical programs built (the cache missed)
        self.builds = 0

    def fold(self, layer, groups: dict):
        """Register the batch's requests (promoting recurring keys out
        of probation), age out idle and dead slots, and return the
        stable-ordered slot list and the slot set's fingerprint."""
        holder = layer.executor.holder
        with self.lock:
            self.batch_no += 1
            for reqs in groups.values():
                for r in reqs:
                    key = _slot_key(r)
                    slot = self.slots.get(key)
                    if slot is not None:
                        slot.last_used = self.batch_no
                        continue
                    last = self.seen.get(key)
                    if (last is not None
                            and 0 < self.batch_no - last
                            <= _CANON_PROBATION):
                        # second sighting in a recent batch: promote
                        self.slots[key] = _Slot(r, self.batch_no)
                        self.seen.pop(key, None)
                    else:
                        self.seen[key] = self.batch_no
                        self.seen.move_to_end(key)
                        while len(self.seen) > _SEEN_MAX:
                            self.seen.popitem(last=False)
            for key, slot in list(self.slots.items()):
                if (self.batch_no - slot.last_used > _CANON_IDLE
                        or holder.index(slot.index_name) is not slot.idx):
                    del self.slots[key]
            while len(self.slots) > _CANON_MAX:
                key = min(self.slots,
                          key=lambda k: self.slots[k].last_used)
                del self.slots[key]
            # stable order: identical slot sets build identical plans
            slots = sorted(self.slots.values(),
                           key=lambda s: (s.index_name, s.skey, s.kind,
                                          repr(s.call)))
            return slots, tuple(sorted(self.slots))

    def drop(self, slot_keys):
        with self.lock:
            for key in slot_keys:
                self.slots.pop(key, None)
            self.cached = None


# ---------------------------------------------------------------------------
# batch execution (called by ServingLayer._run_batch on the leader)
# ---------------------------------------------------------------------------

def _mesh_width(eng) -> int:
    """The serving mesh's width for the fused program: above 1 only
    where the serving mesh is configured and the engine runs the paged
    single-device layout (not the engine's mesh arm)."""
    from pilosa_tpu_torch import memory
    if eng.mesh is not None or not eng._pageable() \
            or not memory.paged_enabled():
        return 1
    return placement.mesh_devices()


def _note_roofline(leaves, dt, meshinfo=None, served=()) -> None:
    """The fused program's bandwidth attribution: its operand pages'
    bytes over its time, under the "ragged" op family; under the mesh
    also each slot's pool bytes over the same time (the "ragged/dev<d>"
    series) and each slot's page mix on every rider's flight record."""
    from pilosa_tpu_torch.executor.stacked import leaf_bytes
    from pilosa_tpu_torch.obs import roofline
    roofline.note("ragged", leaf_bytes(leaves), dt)
    if not meshinfo:
        return
    for d, b in enumerate(meshinfo["dev_bytes"]):
        roofline.note("ragged", b, dt, device=d)
    mix = {f"d{d}:{k}": v for d, m in enumerate(meshinfo["dev_pages"])
           for k, v in m.items()}
    if mix:
        for r, _d, _e in served:
            r.acc.add_pages(mix)


def run_ragged(layer, groups: dict) -> None:
    """Plan, dispatch and demux EVERY group of the batch through the
    canonical fused program (and an extras program for probation
    riders).  Mirrors the per-group leader protocol: per-request build
    attribution, the serving-dispatch fault point, the OOM ladder, and
    a failed program sending its riders to their solo paths."""
    from pilosa_tpu_torch.models import fragment as _frag
    canon = getattr(layer, "_ragged_canon", None)
    if canon is None:
        canon = layer._ragged_canon = CanonicalComposition()
    slots, fp = canon.fold(layer, groups)
    # the epoch is read BEFORE any build: a write landing mid-build
    # leaves a stamp older than the live epoch, so the next batch
    # rebuilds (and the post-batch re-check covers this batch)
    epoch = _frag.mutation_epoch()
    by_key: OrderedDict[tuple, list] = OrderedDict()
    for reqs in groups.values():
        for r in reqs:
            if r.result is None and r.error is None:
                by_key.setdefault(_slot_key(r), []).append(r)
    width = _mesh_width(layer.executor.stacked)
    with canon.lock:
        cached = canon.cached
        if cached is not None and (cached[0] != fp or cached[1] != epoch):
            cached = None
        plan = None if cached is None else cached[2]
        if plan is not None and (
                (plan[0] == "ragged_mesh") != (width > 1)
                or (plan[0] == "ragged_mesh"
                    and (plan[1] != width
                         or plan[2] != placement.epoch()))):
            # a mesh plan pins the width and the placement epoch it was
            # built under: a rebalance or a width flip builds it again,
            # never replays pools of a dead placement (and a plan built
            # before the mesh came up is not one)
            cached = canon.cached = None
    if cached is not None:
        _serve_cached(layer, cached, by_key, len(groups))
    else:
        slot_groups: OrderedDict[tuple, list] = OrderedDict()
        for s in slots:
            slot_groups.setdefault((id(s.idx), s.skey), []).append(s)
        work = []
        for (_gid, skey), gslots in slot_groups.items():
            pairs = [(slot, by_key.pop(_slot_key(slot), []))
                     for slot in gslots]
            work.append((gslots[0].idx, skey, pairs))
        if work:
            with canon.lock:
                canon.builds += 1
            payload = _plan_and_dispatch(layer, work, len(groups),
                                         canon=canon, program="canonical")
            if payload is not None:
                with canon.lock:
                    # cache only if no slot died during the build
                    if tuple(sorted(canon.slots)) == fp:
                        canon.cached = (fp, epoch) + payload
    # extras: probation riders fuse into their own per-batch program
    if by_key:
        ework: OrderedDict[tuple, list] = OrderedDict()
        for riders in by_key.values():
            if riders:
                r0 = riders[0]
                ework.setdefault((id(r0.idx), r0.skey), []).append(
                    (_Slot(r0, 0), riders))
        work2 = [(pairs[0][1][0].idx, skey, pairs)
                 for (_gid, skey), pairs in ework.items()]
        if work2:
            _plan_and_dispatch(layer, work2, len(groups), canon=None,
                               program="extras")


def _plan_and_dispatch(layer, work, n_groups: int, canon=None,
                       program: str = "canonical"):
    """Build ONE ragged program over ``work`` ([(idx, skey, [(slot,
    riders), ...]), ...] in stable order), dispatch it and demux every
    rider.  With ``canon`` a build failure evicts the slot from the
    canonical set, and a successful build returns the (plan, leaves,
    params, table, consts) payload for the cross-batch cache."""
    eng = layer.executor.stacked
    ndev = _mesh_width(eng)
    prog = RaggedProgram(ndev)
    dead_keys: list = []
    consts: dict = {}
    for idx, skey, pairs in work:
        shards = list(skey)
        b = PlanBuilder(eng, idx, shards, {})
        entries = []
        for slot, riders in pairs:
            slot_key = _slot_key(slot) if canon is not None else None
            target = riders[0] if riders else _ShimReq(slot)
            for r in riders:
                r.acc = flight.Acc()
            try:
                with raw_pages():
                    built = layer.build_rider(b, target, shards)
            except Exception:
                # unbuildable now (data or schema drift): the slot leaves
                # the canonical set and its riders fall back
                for r in riders:
                    r.direct = True
                if slot_key is not None:
                    dead_keys.append(slot_key)
                continue
            if built is None:
                # a constant result, shared across the riders
                for r in riders[1:]:
                    r.result = target.result
                if slot_key is not None:
                    consts[slot_key] = target.result
                continue
            entries.append((riders, built[0], built[1], slot_key))
        if entries:
            owners = (placement.owners(idx.name, shards) if ndev > 1
                      else None)
            try:
                prog.add_group(b, entries, owners)
            except RaggedUnbuildable:
                # the group cannot enter the mesh program (an operand
                # with no placed pages): its riders go solo
                for riders, _sub, _demux, slot_key in entries:
                    for r in riders:
                        r.direct = True
                    if slot_key is not None:
                        dead_keys.append(slot_key)
    if canon is not None and dead_keys:
        canon.drop(dead_keys)
    cacheable = canon is not None and not dead_keys
    fin = prog.finalize()
    if fin is None:
        # a program of constants alone is still cacheable
        return ((None, None, None, {}, consts, None)
                if cacheable and consts else None)
    plan, leaves, params, served, table = fin[:5]
    meshinfo = fin[5] if len(fin) > 5 else None
    payload = ((plan, leaves, params, table, consts, meshinfo)
               if cacheable else None)
    if served:
        _dispatch_served(layer, plan, leaves, params, served, n_groups,
                         program, meshinfo)
    return payload


def _serve_cached(layer, cached, by_key, n_groups: int) -> None:
    """Serve this batch's canonical riders from the cached program: no
    plan building, no stack fetches; map each rider to its slot's demux
    and extract, run the one program, demux.  Keys the cache does not
    know stay in ``by_key`` for the extras program."""
    _fp, _epoch, plan, leaves, params, table, consts, meshinfo = cached
    served: list = []
    for key in list(by_key):
        if key in consts:
            for r in by_key.pop(key):
                r.acc = flight.Acc()
                r.result = consts[key]
        elif table and key in table:
            demux, ext = table[key]
            for r in by_key.pop(key):
                r.acc = flight.Acc()
                served.append((r, demux, ext))
    if served and plan is not None:
        _dispatch_served(layer, plan, leaves, params, served, n_groups,
                         "canonical-cached", meshinfo)


def _dispatch_served(layer, plan, leaves, params, served, n_groups: int,
                     program: str, meshinfo=None) -> None:
    from pilosa_tpu_torch.executor.serving import demux_into, dispatch
    riders = [r for r, _d, _e in served]
    mesh = plan[0] == "ragged_mesh"
    subs = plan[5] if mesh else plan[3]
    outs = dispatch(layer, plan, leaves, params, riders,
                    where="serving.ragged_dispatch",
                    tags={"subqueries": len(subs), "ragged": True,
                          "program": program, "groups": n_groups},
                    kind="ragged_mesh" if mesh else "ragged",
                    note=lambda lv, dt: _note_roofline(lv, dt, meshinfo,
                                                       served),
                    needed={ext[1] for _r, _d, ext in served},
                    devices=placement.devices() if mesh else None)
    if outs is None:
        return
    for r, demux, ext in served:
        out = outs[ext[1]] if ext[0] == "plain" else outs[ext[1]][ext[2]]
        demux_into(r, demux, out)
