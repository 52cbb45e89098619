"""Reductions over mesh-placed shard stacks.

The port of ``pilosa_tpu/parallel/dist.py``.  Each function takes a
stack placed by ``place_shards`` or ``place_flat`` (one tensor a slot,
each a contiguous slice of the shard axis on its slot's device), runs
the single-device kernel of ``ops/kernels.py`` on every slot's slice,
and combines on the lead slot's device.  Every slot's launch is queued
before anything waits for one, and the partials move to the lead device
with ``non_blocking=True``, so on several cards the legs overlap.  A
slot with an empty slice launches nothing.

Exactness, as in the JAX package: per-shard popcounts are below 2^20
and int32; the per-shard partials come back in shard order and the
``host_*`` combiners sum them in exact Python ints.  ``dist_topk_counts``
sums its per-(row, shard) counts in int64 on the device (the JAX
function's int32 sum is exact only below 2^11 shards).
"""

from __future__ import annotations

import numpy as np
import torch

from pilosa_tpu_torch.ops import bsi as bsi_ops
from pilosa_tpu_torch.ops import kernels


def _lead(parts) -> torch.device:
    return parts[0].device


def _gather(outs, lead, dim: int = 0) -> torch.Tensor:
    """The slots' partials concatenated in slot order on ``lead``."""
    return torch.cat([o.to(lead, non_blocking=True) for o in outs], dim=dim)


def dist_count(tiles) -> torch.Tensor:
    """Per-shard Count over placed (S, W) tiles → (S,) int32 on the lead
    device."""
    outs = [kernels.popcount_rows(t) if t.shape[0]
            else torch.zeros(0, dtype=torch.int32, device=t.device)
            for t in tiles]
    return _gather(outs, _lead(tiles))


def dist_count_intersect(a, b) -> torch.Tensor:
    """Per-shard Count(Intersect(a, b)) over placed (S, W) stacks, the
    AND never built (``pair_popcount``) → (S,) int32."""
    outs = [kernels.pair_popcount(x, y) if x.shape[0]
            else torch.zeros(0, dtype=torch.int32, device=x.device)
            for x, y in zip(a, b)]
    return _gather(outs, _lead(a))


def host_count(partials) -> int:
    """Exact cross-shard total."""
    if isinstance(partials, torch.Tensor):
        partials = partials.cpu().numpy()
    return int(np.asarray(partials, dtype=np.int64).sum())


def dist_bsi_sum_counts(planes, filt):
    """Per-shard BSI Sum partials.  planes: placed (S, 2+depth, W);
    filt: placed (S, W) filter tiles (all ones for no filter).  Returns
    (count (S,), pos (S, depth), neg (S, depth)) int32 on the lead
    device; combine with ``host_bsi_sum``."""
    outs = []
    for p, f in zip(planes, filt):
        if p.shape[0]:
            outs.append(kernels.bsi_sum_counts(p, f))
        else:
            d = p.shape[1] - 2
            z = torch.zeros((0, d), dtype=torch.int32, device=p.device)
            outs.append((z[:, 0], z, z))
    lead = _lead(planes)
    return tuple(_gather([o[i] for o in outs], lead) for i in range(3))


def host_bsi_sum(count, pos_pc, neg_pc) -> tuple[int, int]:
    """Exact (sum, count) from per-shard sum partials."""
    def host(x):
        return x.cpu().numpy() if isinstance(x, torch.Tensor) else x
    pos = np.asarray(host(pos_pc), dtype=np.int64).sum(axis=0)
    neg = np.asarray(host(neg_pc), dtype=np.int64).sum(axis=0)
    return bsi_ops.host_sum(np.asarray(host(count), dtype=np.int64).sum(),
                            pos, neg)


def dist_topk_counts(rows, filt, k: int):
    """Per-row global counts and their top k (the row-batched TopN/TopK
    reduce).  rows: (R, S, W) placed along axis 1 (``place_flat(mesh,
    rows, shard_axis=1)``); filt: placed (S, W).  Each slot counts its
    rows under its filter slice (``rows_filter_counts``) and sums its
    shards in int64; the slots' (R,) sums add on the lead device.
    Returns (values (k,) int64, indices (k,) int64), largest first and,
    as ``jax.lax.top_k`` orders ties, the lower index first."""
    lead = _lead(rows)
    total = None
    for r, f in zip(rows, filt):
        if not r.shape[1]:
            continue
        part = kernels.rows_filter_counts(r, f).sum(
            dim=1, dtype=torch.int64).to(lead, non_blocking=True)
        total = part if total is None else total + part
    if total is None:
        total = torch.zeros(rows[0].shape[0], dtype=torch.int64, device=lead)
    # a stable sort of the negated counts: ties keep index order
    order = torch.sort(-total, stable=True).indices[:k]
    return total[order], order
