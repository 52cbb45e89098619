"""Device mesh and shard placement, over a list of torch devices.

The port of ``pilosa_tpu/parallel/mesh.py``.  A :class:`Mesh` is a
``(rows, shards)`` grid of slots, each a ``torch.device``; one process
drives every slot, as the JAX package drives its mesh from one process.
The shard axis is the data-parallel axis: slot ``k`` of the flattened
grid (or column ``k`` of the "shards" axis) holds a contiguous slice of
a stack's shard axis.  A second axis, "rows", splits batched candidate
rows (TopN/TopK) over its slots.

On a machine with several cards each slot gets a card of its own.  A
slot list may repeat a device (``[cuda:0] * 4`` on one card,
``[cpu] * 8`` in the tests): the slots then share it, which is the
port's counterpart of the JAX package's forced host devices.  This is
not ``torch.distributed``: there is no second process.

Placement gives each slot its contiguous slice, as ``NamedSharding``
does, but pads nothing: where S is not a multiple of the slot count the
last slots hold shorter slices, or none (``slices``).  A slot with an
empty slice launches nothing, and every combine (``parallel/dist.py``,
the stacked engine's mesh arm) sums what the others hold, so the totals
are those of the padded layout.

``shard_spec``, ``flat_spec`` and ``shard_map_nocheck`` have no torch
meaning (there is no partition spec and no SPMD program to map); nothing
replaces them.
"""

from __future__ import annotations

import torch


class Mesh:
    """A (rows, shards) grid of torch devices.  ``devices`` is the grid
    as a list of rows, ``shape`` is ``{"rows": r, "shards": s}`` and
    ``size`` is r * s.  ``flat`` lists the slots row-major: slot k of a
    flat placement is ``flat[k]``."""

    __slots__ = ("devices", "shape", "size", "flat")

    def __init__(self, devices, rows: int = 1):
        devs = [torch.device(d) for d in devices]
        if rows < 1 or not devs or len(devs) % rows:
            raise ValueError(f"{len(devs)} devices do not split into "
                             f"{rows} rows")
        n = len(devs) // rows
        self.devices = [devs[r * n:(r + 1) * n] for r in range(rows)]
        self.shape = {"rows": rows, "shards": n}
        self.size = len(devs)
        self.flat = devs

    @property
    def lead(self) -> torch.device:
        """The lead slot's device, where cross-slot combines run."""
        return self.flat[0]

    def __repr__(self) -> str:
        return (f"Mesh(rows={self.shape['rows']}, "
                f"shards={self.shape['shards']}, devices={self.flat})")


def make_mesh(n_devices: int | None = None, rows: int = 1,
              devices=None) -> Mesh:
    """A (rows, n_devices // rows) mesh over the first ``n_devices`` of
    ``devices`` (default: every visible CUDA card; raises where there is
    none).  ``devices`` may repeat a device; a list shorter than
    ``n_devices`` is an error."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: make_mesh defaults to the visible cards; "
                "pass devices=[...] (e.g. [torch.device('cpu')] * 8)")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = list(devices)
    if n_devices is None:
        n_devices = len(devices)
    if n_devices < 1 or n_devices > len(devices):
        raise ValueError(f"make_mesh: {n_devices} slots from "
                         f"{len(devices)} devices")
    if n_devices % rows:
        raise ValueError(f"make_mesh: {n_devices} slots do not split into "
                         f"{rows} rows")
    return Mesh(devices[:n_devices], rows=rows)


def slices(n: int, parts: int) -> list[tuple[int, int]]:
    """[lo, hi) of each of ``parts`` contiguous slices of ``n`` items:
    ceil(n / parts) each, as a zero-padded NamedSharding cuts them, so
    the last slots hold shorter slices or none."""
    per = -(-n // parts) if n else 0
    return [(min(k * per, n), min((k + 1) * per, n)) for k in range(parts)]


def _host(tiles) -> torch.Tensor:
    import numpy as np
    if isinstance(tiles, torch.Tensor):
        return tiles
    a = np.ascontiguousarray(tiles)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a)


def place_shards(mesh: Mesh, tiles, batch_axes: int = 0) -> list:
    """A (S, ..., W) stack on the mesh: one tensor a column of the
    "shards" axis, its contiguous slice of axis 0 on that column's
    first-row device (the other rows hold the same slice, as the JAX
    spec replicates the row axis).  Host uint32 words go as int32.
    ``batch_axes`` is accepted for the JAX signature; every axis past
    the shard axis goes whole."""
    del batch_axes
    t = _host(tiles)
    n = mesh.shape["shards"]
    return [t[lo:hi].to(mesh.devices[0][k])
            for k, (lo, hi) in enumerate(slices(t.shape[0], n))]


def place_flat(mesh: Mesh, tiles, shard_axis: int = 0) -> list:
    """``shard_axis`` split over every slot of the mesh (both axes
    flattened, row-major): one tensor a slot, its contiguous slice on
    the slot's device — the layout the GroupBy kernels' per-slot legs
    read."""
    t = _host(tiles)
    return [t.narrow(shard_axis, lo, hi - lo).contiguous().to(dev)
            for dev, (lo, hi) in zip(mesh.flat,
                                     slices(t.shape[shard_axis], mesh.size))]
