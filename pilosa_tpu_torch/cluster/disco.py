"""DisCo — distributed coordination abstractions.

Reference: disco/disco.go — ``DisCo`` (lifecycle/leader :35),
``Noder`` (node list :92), ``Schemator`` (schema KV), ``Sharder``
(available-shards KV :113), and the ``NodeState`` machine (:46-63).
The reference backs these with an embedded etcd server per node
(etcd/embed.go); the default backend here is an in-process registry
(``InMemDisCo``), which every node of an in-process cluster shares.  A
deployment of separate processes can implement the same interface over
a real etcd or k8s API.  The module is the JAX package's
``cluster/disco.py``, unchanged in behaviour.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field

from pilosa_tpu_torch.obs import metrics


class NodeState:
    UNKNOWN = "UNKNOWN"
    STARTING = "STARTING"
    STARTED = "STARTED"
    RESIZING = "RESIZING"
    DOWN = "DOWN"


@dataclass
class Node:
    id: str
    uri: str = ""           # host:port for the data-plane HTTP API
    grpc_uri: str = ""
    state: str = NodeState.STARTING
    is_primary: bool = False
    last_heartbeat: float = field(default_factory=time.time)

    def to_dict(self):
        return {"id": self.id, "uri": self.uri, "state": self.state,
                "is_primary": self.is_primary}


class DisCo:
    """Coordination backend interface: lifecycle + membership + schema
    + shard registry (disco.DisCo/Noder/Schemator/Sharder merged — in
    the reference they are four interfaces implemented by one etcd
    object; one Python class states that more directly)."""

    # lifecycle
    def start(self, node: Node, member: bool = True):
        """Register a node.  ``member=False`` registers it as a LIVE
        but placement-EXCLUDED node (it serves, heartbeats, and can
        receive transfers, but owns nothing until a rebalance commits
        it into the roster) — the join half of online resharding."""
        raise NotImplementedError

    def close(self, node_id: str):
        raise NotImplementedError

    def is_leader(self, node_id: str) -> bool:
        raise NotImplementedError

    # Noder
    def nodes(self) -> list[Node]:
        raise NotImplementedError

    def heartbeat(self, node_id: str) -> bool:
        """Refresh the node's lease.  Returns True when the beat
        REVIVED the node from DOWN — the caller owes a resync for the
        writes peers skipped while it was marked dead."""
        raise NotImplementedError

    def set_state(self, node_id: str, state: str):
        raise NotImplementedError

    # Schemator
    def schema(self) -> dict:
        raise NotImplementedError

    def set_schema(self, schema: dict):
        raise NotImplementedError

    # Sharder
    def shards(self, index: str, field: str) -> set[int]:
        raise NotImplementedError

    def add_shards(self, index: str, field: str, shards: set[int]):
        raise NotImplementedError

    # Placement (online resharding).  The ROSTER is the
    # ordered bucket->node list jump-hash placement runs over —
    # distinct from live membership so a joining node can serve
    # transfers before it owns anything.  OVERLAYS are per-partition
    # ownership overrides a live migration installs: phase "dual"
    # (donor + recipient both replicate — the transition ADDS
    # availability) and phase "moved" (the epoch-stamped ownership
    # flip).  Backends without resharding support return None/{} and
    # placement falls back to sorted live membership.
    def roster(self) -> list[str] | None:
        return None

    def placement(self) -> tuple[list[str] | None, dict[int, dict]]:
        """(roster, overlays) read ATOMICALLY — snapshots must never
        observe a committed roster with pre-commit overlays (or vice
        versa), or a moved shard transiently routes to its OLD owner.
        Backends override with one locked read."""
        return self.roster(), self.overlays()

    def set_roster(self, node_ids: list[str]):
        raise NotImplementedError

    def placement_epoch(self) -> int:
        return 0

    def overlays(self) -> dict[int, dict]:
        return {}

    def set_overlay(self, partition: int, owners: list[str],
                    phase: str, mut_epoch: int = 0) -> int:
        raise NotImplementedError

    def clear_overlay(self, partition: int):
        raise NotImplementedError


class InMemDisCo(DisCo):
    """Single-process registry shared by all nodes of an in-process
    cluster (the test.Cluster analog, test/cluster.go:31) and the
    default for single-controller deployments.

    Failure detection: nodes heartbeat; ``check_heartbeats`` marks
    nodes DOWN after ``lease_ttl`` without one (etcd lease analog,
    etcd/embed.go:458)."""

    def __init__(self, lease_ttl: float = 5.0):
        self._nodes: dict[str, Node] = {}
        self._schema: dict = {}
        self._shards: dict[tuple[str, str], set[int]] = {}
        self._lock = threading.RLock()
        self.lease_ttl = lease_ttl
        # placement roster: ordered bucket->node-id list (INSERTION
        # order, not sorted — jump-hash minimal movement requires a
        # join to append a NEW bucket, never to reshuffle the mapping
        # of surviving ones)
        self._roster: list[str] = []
        # partition -> {"owners": [...], "phase": "dual"|"moved",
        #               "epoch": int, "mut_epoch": int}
        self._overlays: dict[int, dict] = {}
        self._epoch = 0

    # lifecycle --------------------------------------------------------
    def start(self, node: Node, member: bool = True):
        with self._lock:
            node.state = NodeState.STARTED
            node.last_heartbeat = time.time()
            self._nodes[node.id] = node
            if member and node.id not in self._roster:
                self._roster.append(node.id)
            self._elect()

    def close(self, node_id: str):
        # the ROSTER entry survives a close: while the node is gone
        # the snapshot filters the unknown id and partitions
        # transiently remap — exactly what pre-roster sorted-
        # membership placement did — but a BOUNCE (close + re-open
        # with the same id) restores the original placement instead
        # of permanently reordering the roster.  Removal from
        # placement is the rebalance controller's job (drain commits
        # a roster without the node; its plans prune ghost entries).
        with self._lock:
            self._nodes.pop(node_id, None)
            self._elect()

    def _elect(self):
        """Leader = lowest node id among live nodes (the reference
        derives primary from etcd leadership; any stable rule works)."""
        live = [n for n in self._nodes.values()
                if n.state == NodeState.STARTED]
        leader = min(live, key=lambda n: n.id).id if live else None
        for n in self._nodes.values():
            n.is_primary = (n.id == leader)

    def is_leader(self, node_id: str) -> bool:
        with self._lock:
            n = self._nodes.get(node_id)
            return bool(n and n.is_primary)

    # Noder ------------------------------------------------------------
    def nodes(self) -> list[Node]:
        with self._lock:
            return sorted(self._nodes.values(), key=lambda n: n.id)

    def heartbeat(self, node_id: str) -> bool:
        with self._lock:
            n = self._nodes.get(node_id)
            if n:
                n.last_heartbeat = time.time()
                metrics.HEARTBEAT_AGE.set(0.0, node=node_id)
                if n.state == NodeState.DOWN:
                    # a beat from a DOWN node is a rejoin (the lease
                    # revival the etcd backend would observe)
                    n.state = NodeState.STARTED
                    metrics.CLUSTER_EVENTS.inc(event="node_rejoin")
                    self._elect()
                    return True
        return False

    def set_state(self, node_id: str, state: str):
        with self._lock:
            n = self._nodes.get(node_id)
            if n:
                if state != n.state:
                    if state == NodeState.DOWN:
                        metrics.CLUSTER_EVENTS.inc(event="node_down")
                    elif n.state == NodeState.DOWN and \
                            state == NodeState.STARTED:
                        metrics.CLUSTER_EVENTS.inc(event="node_rejoin")
                n.state = state
                self._elect()

    def check_heartbeats(self) -> list[str]:
        """Mark nodes DOWN whose lease expired; returns their ids.
        Also exports each node's heartbeat age — the early-warning
        gauge a dashboard watches before the lease actually expires."""
        now = time.time()
        downed = []
        with self._lock:
            for n in self._nodes.values():
                metrics.HEARTBEAT_AGE.set(now - n.last_heartbeat,
                                          node=n.id)
                if n.state == NodeState.STARTED and \
                        now - n.last_heartbeat > self.lease_ttl:
                    n.state = NodeState.DOWN
                    metrics.CLUSTER_EVENTS.inc(event="node_down")
                    downed.append(n.id)
            if downed:
                self._elect()
        return downed

    # Schemator --------------------------------------------------------
    def schema(self) -> dict:
        with self._lock:
            return dict(self._schema)

    def set_schema(self, schema: dict):
        with self._lock:
            self._schema = dict(schema)

    # Sharder ----------------------------------------------------------
    def shards(self, index: str, field: str) -> set[int]:
        with self._lock:
            return set(self._shards.get((index, field), set()))

    def add_shards(self, index: str, field: str, shards: set[int]):
        with self._lock:
            self._shards.setdefault((index, field), set()).update(shards)

    # Placement (online resharding) ------------------------------------
    def roster(self) -> list[str] | None:
        with self._lock:
            return list(self._roster)

    def placement(self) -> tuple[list[str] | None, dict[int, dict]]:
        with self._lock:
            return (list(self._roster),
                    {p: dict(ov) for p, ov in self._overlays.items()})

    def set_roster(self, node_ids: list[str]):
        """Commit a new placement roster — the rebalance epilogue.
        Clears the overlays atomically with the swap: the controller
        only commits once every moved partition's overlay owners EQUAL
        the new roster's jump placement, so routing is identical one
        instruction before and after (no epoch where a shard routes
        to zero or two disagreeing owners)."""
        with self._lock:
            self._roster = list(node_ids)
            self._overlays.clear()
            self._epoch += 1

    def placement_epoch(self) -> int:
        with self._lock:
            return self._epoch

    def overlays(self) -> dict[int, dict]:
        with self._lock:
            return {p: dict(ov) for p, ov in self._overlays.items()}

    def set_overlay(self, partition: int, owners: list[str],
                    phase: str, mut_epoch: int = 0) -> int:
        """Install/advance one partition's ownership overlay; the
        "moved" flip is what the mutation-epoch stamp records.
        Returns the placement epoch after the write."""
        with self._lock:
            self._epoch += 1
            self._overlays[int(partition)] = {
                "owners": list(owners), "phase": phase,
                "epoch": self._epoch, "mut_epoch": int(mut_epoch)}
            return self._epoch

    def clear_overlay(self, partition: int):
        """Roll a partition back to roster placement (a migration
        aborted before its flip)."""
        with self._lock:
            if self._overlays.pop(int(partition), None) is not None:
                self._epoch += 1
