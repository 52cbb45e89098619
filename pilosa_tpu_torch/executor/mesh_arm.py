"""The stacked engine's legs: one device, or the slots of a mesh
(``StackedEngine.set_mesh(mesh)``).

The port of the JAX engine's GSPMD placement arm (``set_mesh``,
``_mesh_key`` and the flat and 2-D placements of
``pilosa_tpu/executor/stacked.py``) and of its GroupBy ``shard_map``
programs (``_groupby_onepass_shard_map``, ``_groupby_kernel_shard_map``).

Every engine method runs one path over its legs (``_legs``): a leg is an
engine and its slice of the shard list.  On one device there is one
leg, the engine itself over every shard.  With a mesh set
(``parallel.make_mesh``) each slot with a non-empty slice is a leg: a
single-device ``StackedEngine`` of its own holding a contiguous slice on
its own device (``parallel.mesh.slices``, the ``place_flat`` layout),
whose stacks are built for its slice and kept whole in its own cache
(paging is off under this arm, as in the JAX package), under keys that
carry the mesh (``_mesh_key``).  A one-slot mesh keeps paging on: it is
the single-device layout and launches exactly what one device launches.

Every leg's stacks are fetched first; then one ``stacked.dispatch`` runs
every leg (each launch is queued before anything waits, so on several
cards the legs overlap) and combines on the lead device:

- counts, sums and histograms by int64 addition (a ``psum`` has no
  Pallas body, so plain torch ops do it);
- the GroupBy Min/Max table by max and min;
- words by concatenation in shard order.

A ``rows > 1`` mesh splits TopN/TopK candidate rows over its "rows"
axis and the shards over its "shards" axis (``row_counts``).  Kernels
launch inside every leg; the JAX mesh turns its Pallas kernels off
inside ``shard_map`` (a deliberate difference, listed in ROADMAP C).
"""

from __future__ import annotations

import torch

from pilosa_tpu_torch.parallel.mesh import slices


def _on(t, lead):
    return t.to(lead, non_blocking=True)


def sum_on(outs, lead):
    """Elementwise int64 sum of the legs' outputs (tensors or tuples of
    tensors) on ``lead``."""
    if isinstance(outs[0], tuple):
        return tuple(sum_on([o[i] for o in outs], lead)
                     for i in range(len(outs[0])))
    acc = _on(outs[0], lead).to(torch.int64)
    for o in outs[1:]:
        acc = acc + _on(o, lead).to(torch.int64)
    return acc


def cat_on(outs, lead):
    """The legs' (S_leg, ...) outputs concatenated in shard order on
    ``lead``."""
    if len(outs) == 1:
        return _on(outs[0], lead)
    return torch.cat([_on(o, lead) for o in outs])


def minmax_table_on(tables, lead):
    """The (4, G) Min/Max magnitude tables of the legs: rows
    [max_mag_pos, min_mag_pos, max_mag_neg, min_mag_neg] combine by
    max, min, max, min."""
    acc = _on(tables[0], lead).to(torch.int64)
    for t in tables[1:]:
        t = _on(t, lead).to(torch.int64)
        acc = torch.stack([torch.maximum(acc[0], t[0]),
                           torch.minimum(acc[1], t[1]),
                           torch.maximum(acc[2], t[2]),
                           torch.minimum(acc[3], t[3])])
    return acc


class MeshArm:
    """The legs half of StackedEngine (mixed in; see the module
    docstring).  ``mesh`` is the engine's mesh (None: one device);
    ``_slots`` its slot engines, one a flat slot."""

    mesh = None
    _slots = None
    # the mesh a slot engine serves (its cache keys carry it)
    _placed = None

    def set_mesh(self, mesh):
        """Set (or clear, with None) the mesh; the stack cache is
        cleared and the slots start with empty caches."""
        self.mesh = mesh
        self._slots = None
        if mesh is not None:
            paged = mesh.size == 1
            self._slots = []
            for dev in mesh.flat:
                eng = type(self)(self.executor, dev, paged=paged)
                eng._placed = mesh
                self._slots.append(eng)
        self.cache.clear()

    def _lead(self) -> torch.device:
        return self.device if self.mesh is None else self.mesh.lead

    def _legs(self, shards):
        """(engine, its shard slice) for every leg with shards, in shard
        order: the engine itself over every shard on one device, else
        each slot with a non-empty slice."""
        shards = list(shards)
        if self.mesh is None:
            return [(self, shards)] if shards else []
        return [(eng, shards[lo:hi]) for eng, (lo, hi) in zip(
            self._slots, slices(len(shards), len(self._slots))) if hi > lo]

    def _chunk_rounds(self, shards, chunk: int):
        """The legs' chunk loops side by side: per round, (engine, shard
        tuple) of at most ``chunk`` shards for every leg that has one."""
        legs = self._legs(shards)
        longest = max((len(sl) for _eng, sl in legs), default=0)
        for lo in range(0, longest, chunk):
            yield [(eng, tuple(sl[lo:lo + chunk])) for eng, sl in legs
                   if lo < len(sl)]

    def _grid_legs(self, n_rows_total: int, shards):
        """((row lo, row hi), engine, shard slice) over the mesh's
        (rows, shards) grid: candidate rows split over "rows", shards
        over "shards" (the JAX engine's 2-D placement of TopN/TopK
        candidate blocks); one leg over everything on one device."""
        shards = list(shards)
        if self.mesh is None:
            return [((0, n_rows_total), self, shards)] if shards else []
        n_rows, n_cols = self.mesh.shape["rows"], self.mesh.shape["shards"]
        out = []
        for r, (rlo, rhi) in enumerate(slices(n_rows_total, n_rows)):
            for c, (slo, shi) in enumerate(slices(len(shards), n_cols)):
                if rhi > rlo and shi > slo:
                    out.append(((rlo, rhi), self._slots[r * n_cols + c],
                                shards[slo:shi]))
        return out

    def _leg_devices(self):
        """Every device a dispatch over the legs waits for."""
        if self.mesh is None:
            return None
        seen = []
        for d in self.mesh.flat:
            if d not in seen:
                seen.append(d)
        return seen

    def _dispatch_legs(self, kind: str, runs, combine, host=None,
                       nbytes: int = 0):
        """One ``stacked.dispatch`` over every leg: each ``run()`` queues
        its leg's launches and returns its device outputs, then
        ``combine(outs, lead)`` merges them on the lead device."""
        lead = self._lead()
        return self._dispatch(kind, lambda: combine([r() for r in runs],
                                                    lead),
                              host=host, nbytes=nbytes,
                              devices=self._leg_devices())
