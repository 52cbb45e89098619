"""Mesh parallelism over a list of torch devices.

The port of ``pilosa_tpu/parallel``: a static shard-to-slot placement
(``mesh.py``) and reductions that run the single-device kernels on
every slot's slice and combine on the lead slot (``dist.py``).  The
JAX package's XLA collectives over ICI become int64 combines on the
lead device; one process drives every slot.
"""

from pilosa_tpu_torch.parallel.dist import (
    dist_bsi_sum_counts,
    dist_count,
    dist_count_intersect,
    dist_topk_counts,
    host_bsi_sum,
    host_count,
)
from pilosa_tpu_torch.parallel.mesh import make_mesh, place_flat, place_shards

__all__ = [
    "make_mesh", "place_shards", "place_flat",
    "dist_count", "dist_count_intersect", "dist_bsi_sum_counts",
    "dist_topk_counts", "host_bsi_sum", "host_count",
]
