"""ClusterSnapshot — static shard/partition→node placement.

Reference: disco/snapshot.go (``ClusterSnapshot``, PartitionToNodes
:54, ShardToShardPartition :64, ``DefaultPartitionN = 256`` :15) and
cluster.go:107-230.  Placement is a pure function of (placement
roster, partitionN, replicaN): shard → fnv-hash partition → jump-hash
primary node, replicas on the following nodes in ring order.  The
executor takes ONE snapshot per query so a concurrent membership
change can't split a query across two placements.

Online resharding adds two inputs:

- ``roster``: the ORDERED bucket→node-id list placement runs over
  (disco-owned).  A joining node is live-but-unrostered until its
  shards migrated; jump-hash minimal movement holds because a join
  appends a bucket instead of re-sorting the mapping.  Without a
  roster the snapshot falls back to sorted live membership (the
  pre-resharding behavior, and the behavior of ad-hoc snapshots
  built straight from a node list).
- ``overlays``: per-partition ownership overrides a live migration
  installs.  Phase ``dual`` APPENDS the recipients to the jump-hash
  owners — donor stays primary, the recipient is one more replica, so
  hedged reads treat the mid-transfer shard as replicated on both and
  writes forward to both (the transition *adds* availability).  Phase
  ``moved`` is the fence flip: the overlay owners replace the jump
  owners outright.
"""

from __future__ import annotations

from pilosa_tpu_torch.cluster.disco import Node, NodeState
from pilosa_tpu_torch.cluster.hash import jump_hash
from pilosa_tpu_torch.storage.translate import (
    key_to_key_partition,
    shard_to_shard_partition,
)

DEFAULT_PARTITION_N = 256


class ClusterSnapshot:
    def __init__(self, nodes: list[Node], replica_n: int = 1,
                 partition_n: int = DEFAULT_PARTITION_N,
                 roster: list[str] | None = None,
                 overlays: dict[int, dict] | None = None):
        self.nodes = sorted(nodes, key=lambda n: n.id)
        self._by_id = {n.id: n for n in self.nodes}
        if roster:
            # roster entries for nodes that vanished from membership
            # are skipped: placement math must only ever name nodes a
            # query could actually reach
            self.order = [self._by_id[i] for i in roster
                          if i in self._by_id]
        else:
            self.order = list(self.nodes)
        self.replica_n = max(1, min(replica_n, len(self.order) or 1))
        self.partition_n = partition_n
        self.overlays = overlays or {}

    def shard_partition(self, index: str, shard: int) -> int:
        return shard_to_shard_partition(index, shard, self.partition_n)

    def key_partition(self, index: str, key: str) -> int:
        return key_to_key_partition(index, key, self.partition_n)

    def _base_nodes(self, partition: int) -> list[Node]:
        if not self.order:
            return []
        primary = jump_hash(partition, len(self.order))
        return [self.order[(primary + i) % len(self.order)]
                for i in range(self.replica_n)]

    def partition_nodes(self, partition: int) -> list[Node]:
        """Primary + replicas for a partition (PartitionToNodes),
        overlay-aware: a "moved" partition routes to its overlay
        owners outright; a "dual" one keeps the jump owners primary
        and appends the overlay recipients as extra replicas."""
        ov = self.overlays.get(partition)
        if ov is not None and ov.get("phase") == "moved":
            owners = [self._by_id[i] for i in ov.get("owners", ())
                      if i in self._by_id]
            if owners:
                return owners
            # every overlay owner left membership: fall through to
            # roster placement rather than returning "nobody"
        base = self._base_nodes(partition)
        if ov is not None and ov.get("phase") == "dual":
            have = {n.id for n in base}
            base = base + [self._by_id[i] for i in ov.get("owners", ())
                           if i in self._by_id and i not in have]
        return base

    def shard_nodes(self, index: str, shard: int) -> list[Node]:
        """Nodes owning a shard, primary first (ShardNodes)."""
        return self.partition_nodes(self.shard_partition(index, shard))

    def key_nodes(self, index: str, key: str) -> list[Node]:
        return self.partition_nodes(self.key_partition(index, key))

    def primary(self) -> Node | None:
        for n in self.nodes:
            if n.is_primary:
                return n
        return self.nodes[0] if self.nodes else None

    def shards_by_node(self, index: str, shards,
                       exclude=frozenset()) -> dict[str, list[int]]:
        """Group shards by PRIMARY owner (executor.go:6416
        shardsByNode) — the fan-out plan for one query.  ``exclude``
        is a query-local avoidance set (nodes that already failed an
        attempt THIS query, e.g. by timeout, without being globally
        DOWN): preferred-away-from, but still used when a shard has
        no other live owner."""
        out: dict[str, list[int]] = {}
        for s in shards:
            owners = self.shard_nodes(index, s)
            live = [n for n in owners if n.state == NodeState.STARTED]
            fresh = [n for n in live if n.id not in exclude]
            owner = (fresh or live or owners)[0]
            out.setdefault(owner.id, []).append(s)
        return out

    def node(self, node_id: str) -> Node | None:
        for n in self.nodes:
            if n.id == node_id:
                return n
        return None
