"""Cluster and coordination: the multi-node plane (SURVEY §2.5).

Several nodes, each a ``Server`` with its own holder and executor on
its device, hold shards by jump-hash placement with ``replica_n``
replicas, and a coordinator fans each query out over them:

- ``hash.py``: jump consistent hashing (disco/hasher.go:16) and the
  placement diffs a rebalance moves;
- ``disco.py``: the ``DisCo`` registry (disco/disco.go: membership,
  schema, available shards, the placement roster and overlays,
  heartbeat leases), with ``InMemDisCo`` for an in-process cluster;
- ``snapshot.py``: ``ClusterSnapshot``, shard to fnv partition to
  jump-hash owners (disco/snapshot.go);
- ``client.py``: ``InternalClient``, the node-to-node HTTP transport
  with per-attempt deadlines;
- ``coordinator.py``: ``ClusterNode`` and ``ClusterExecutor`` (the
  fan-out with replica failover, hedged reads, deadlines, partial
  answers and load shedding; replicated writes and imports; rejoin
  repair; the replica scrub; the ``/debug/cluster/*`` views);
- ``rebalance.py``: online resharding (``FenceTable``,
  ``RebalanceController``);
- ``txn.py``: exclusive transactions (transaction.go).

The package is the JAX package's ``cluster/`` with the same exports.
"""

from pilosa_tpu_torch.cluster.hash import jump_hash, placement_diff, roster_diff
from pilosa_tpu_torch.cluster.disco import (
    DisCo,
    InMemDisCo,
    Node,
    NodeState,
)
from pilosa_tpu_torch.cluster.snapshot import ClusterSnapshot
from pilosa_tpu_torch.cluster.client import (
    Deadline,
    DeadlineExceeded,
    InternalClient,
    RemoteError,
    ShardMovedError,
)
from pilosa_tpu_torch.cluster.rebalance import (
    FenceTable,
    RebalanceController,
    RebalanceError,
    RebalancePlan,
)
from pilosa_tpu_torch.cluster.coordinator import (
    ClusterError,
    ClusterExecutor,
    ClusterNode,
    LoadShedError,
)
from pilosa_tpu_torch.cluster.txn import (
    Transaction,
    TransactionManager,
)

__all__ = [
    "jump_hash",
    "placement_diff",
    "roster_diff",
    "ShardMovedError",
    "FenceTable",
    "RebalanceController",
    "RebalanceError",
    "RebalancePlan",
    "DisCo",
    "InMemDisCo",
    "Node",
    "NodeState",
    "ClusterSnapshot",
    "InternalClient",
    "Deadline",
    "DeadlineExceeded",
    "RemoteError",
    "ClusterError",
    "ClusterExecutor",
    "ClusterNode",
    "LoadShedError",
    "Transaction",
    "TransactionManager",
]
