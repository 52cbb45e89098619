"""Online resharding — epoch-fenced live shard migration.

The reference resizes clusters with etcd-coordinated resize jobs
(cluster.go ResizeJob: nodes stream whole-fragment diffs while the
cluster holds a RESIZING state).  This build migrates LIVE, in
process, using the decomposition the engine already has: fragment
row blocks are the bulk unit, the per-fragment delta log is the
incremental unit, and the jump-hash roster (cluster/hash.py) is
the placement authority.  Per moving shard the transfer runs an
explicit state machine:

``SNAPSHOT-COPY``
    checksum-diff block transfer donor→recipient while the donor
    keeps serving reads AND writes (every concurrent write lands in
    the donor's delta log).  Resumable by construction: re-running
    the diff skips blocks that already match.
``DELTA-CHASE``
    replay the donor's delta-log entries above the copied version
    (current row contents — idempotent, always-forward) until the lag
    is under ``chase_lag`` spans.  A delta-log overflow (writes
    outran the window) falls back to one more checksum-diff round.
``FENCE``
    the only write-blocked window: the donor's FenceTable blocks new
    writes to the shard (admitted writes drain first), the final
    delta tail replays, the key-translate partition ships, and ONE
    mutation-epoch-stamped ownership overlay lands in disco — phase
    ``dual``: donor and recipient both replicate, so hedged reads
    treat the mid-transfer shard as replicated on both and the
    transition ADDS availability.  Blocked writers then wake with a
    re-plan signal (ShardMovedError without an owner) and their
    coordinators re-route against the fresh placement.
``RELEASE``
    at finalize the overlay flips to ``moved`` (recipient-only), the
    donor's fence table answers 410 + ``X-Pilosa-New-Owner`` for
    stragglers, in-flight writes drain, the donor's serving-cache
    entries touching the shard are swept (scoped — never a full
    flush), and the donor frees the shard's fragments (their stack
    pages die with their retired gens through the memory ledger).

When every moving partition is ``moved``, the controller COMMITS the
new roster: disco swaps roster+overlays atomically, and because each
overlay's owners were computed FROM the new roster, routing is
bit-identical across the swap — there is no epoch in which a shard
has zero or two disagreeing write owners.

Crash story: every seam is an armed fault point
(``transfer-interrupted``, ``recipient-died``, ``fence-crash`` —
obs/faults.py).  A failure before the dual flip rolls the partition
back (fences lift, blocked writers proceed on the donor, overlay
untouched — donor stays the one owner); a failure after it leaves a
CONSISTENT dual/moved overlay that ``resume()`` completes forward.
"""

from __future__ import annotations

import threading
import time

from pilosa_tpu_torch.cluster.client import InternalClient, RemoteError, ShardMovedError
from pilosa_tpu_torch.cluster.disco import NodeState
from pilosa_tpu_torch.obs import faults, metrics

_NET_ERRORS = (ConnectionError, OSError, TimeoutError)


class RebalanceError(Exception):
    """A migration step failed; the plan records where.  The cluster
    is left consistent (rolled back or resumable) — this error is an
    operator signal, not a data-integrity one."""


# ---------------------------------------------------------------------------
# FenceTable — the donor-side write fence
# ---------------------------------------------------------------------------

class _Fence:
    __slots__ = ("state", "event", "resolution", "owner_id",
                 "owner_uri", "ts")

    def __init__(self):
        self.state = "fencing"
        self.event = threading.Event()
        self.resolution: str | None = None   # moved | replan | lift
        self.owner_id: str | None = None
        self.owner_uri: str | None = None
        self.ts = time.monotonic()


class FenceTable:
    """Per-node shard fence: the ownership half of the FENCE phase.

    States per (index, shard):

    - absent: this node serves the shard normally.
    - ``fencing``: a migration is flipping ownership — NEW writes to
      the shard block (bounded) until the fence resolves; reads still
      serve (the data is frozen and final).
    - ``moved``: ownership flipped away — reads AND writes raise
      :class:`ShardMovedError` (410 + X-Pilosa-New-Owner) so clients
      redirect / coordinators re-plan instead of reading a stale copy
      or writing into released storage.

    The table also counts in-flight PQL writes per index so the
    controller's drain ("every write admitted under the old epoch has
    finished on the donor") is a real barrier, not a sleep."""

    def __init__(self):
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._fences: dict[tuple[str, int], _Fence] = {}
        # in-flight writes keyed (index, shard); (index, None) is the
        # wildcard for writes whose shard set is unknown (whole-index
        # ops, ingest windows).  Shard-granular so the drain barrier
        # waits only on writes that can touch the fenced shards — a
        # storm on OTHER shards must not stall the fence.
        self._writes: dict[tuple[str, int | None], int] = {}
        # in-flight READS, same keying: RELEASE must drain readers
        # that passed the fence check before the flip, or popping the
        # fragments mid-scan silently under-counts their answer
        self._reads: dict[tuple[str, int | None], int] = {}

    # -- hot-path checks (no-ops while the table is empty) -------------

    def active(self) -> bool:
        return bool(self._fences)

    def _raise_if_moved_locked(self, index: str, shards) -> None:
        """Caller holds the lock: raise the typed redirect when any
        shard's fence says MOVED (one shared implementation for the
        check-only and check-and-register read paths).  The redirect
        target is attached ONLY when every moved shard names the SAME
        new owner — shards moved to different owners (a mid-roster
        drain remaps several buckets) must re-plan at the
        coordinator, not follow a one-hop redirect that would serve
        some shards from a node holding nothing for them."""
        moved: list[int] = []
        owners = set()
        owner = None
        for s in shards or ():
            f = self._fences.get((index, int(s)))
            if f is not None and f.state == "moved":
                moved.append(int(s))
                owners.add((f.owner_id, f.owner_uri))
                owner = f
        if moved:
            if len(owners) == 1:
                raise ShardMovedError(index, moved,
                                      owner_id=owner.owner_id,
                                      owner_uri=owner.owner_uri)
            raise ShardMovedError(index, moved)  # re-plan, no redirect

    def check_read(self, index: str, shards) -> None:
        """Raise for MOVED shards; FENCING shards still serve (their
        data is frozen at the final state the recipient received)."""
        if not self._fences:
            return
        with self._lock:
            self._raise_if_moved_locked(index, shards)

    def enter_read(self, index: str, shards) -> tuple:
        """check_read + in-flight registration, atomically: a flip
        landing right after admission still sees this read in the
        release drain, so the donor never frees fragments under a
        running scan.  Returns the token for :meth:`exit_read`."""
        keys = tuple(sorted({(index, int(s)) for s in shards or ()})) \
            or ((index, None),)
        with self._lock:
            self._raise_if_moved_locked(index, shards)
            for k in keys:
                self._reads[k] = self._reads.get(k, 0) + 1
        return keys

    def exit_read(self, token: tuple) -> None:
        with self._lock:
            for k in token:
                n = self._reads.get(k, 0) - 1
                if n <= 0:
                    self._reads.pop(k, None)
                else:
                    self._reads[k] = n
            self._cond.notify_all()

    def drain_reads(self, index: str, shards=None,
                    timeout_s: float = 10.0) -> bool:
        """Wait until no admitted read overlapping the shards is in
        flight (the pre-RELEASE barrier)."""
        want = (None if shards is None
                else {int(s) for s in shards})

        def busy() -> bool:
            for (ix, s), n in self._reads.items():
                if ix != index or n <= 0:
                    continue
                if s is None or want is None or s in want:
                    return True
            return False

        deadline = time.monotonic() + timeout_s
        with self._lock:
            while busy():
                rem = deadline - time.monotonic()
                if rem <= 0:
                    return False
                self._cond.wait(rem)
        return True

    def enter_write(self, index: str, shards=None,
                    timeout_s: float = 10.0) -> tuple:
        """Admit one write: raise for MOVED shards, wait out FENCING
        ones, then register the write in-flight (atomically with the
        check, so a fence beginning right after admission still sees
        it in the drain count).  Returns the registration token to
        pass to :meth:`exit_write`.  An empty/unknown shard set
        registers the index wildcard."""
        keys = tuple(sorted({(index, int(s)) for s in shards or ()})) \
            or ((index, None),)
        deadline = time.monotonic() + timeout_s
        while True:
            waiter: _Fence | None = None
            with self._lock:
                for s in shards or ():
                    f = self._fences.get((index, int(s)))
                    if f is None:
                        continue
                    if f.state == "moved":
                        raise ShardMovedError(index, [int(s)],
                                              owner_id=f.owner_id,
                                              owner_uri=f.owner_uri)
                    waiter = f
                    break
                if waiter is None:
                    for k in keys:
                        self._writes[k] = self._writes.get(k, 0) + 1
                    return keys
            # FENCING: wait outside the lock for the resolution
            if not waiter.event.wait(
                    max(0.0, deadline - time.monotonic())):
                raise ShardMovedError(index, shards or [])
            if waiter.resolution == "moved":
                raise ShardMovedError(index, shards or [],
                                      owner_id=waiter.owner_id,
                                      owner_uri=waiter.owner_uri)
            if waiter.resolution == "replan":
                # ownership settled elsewhere (dual/fresh placement):
                # the coordinator must re-route from a fresh snapshot
                raise ShardMovedError(index, shards or [])
            # "lift": migration rolled back — proceed here, re-check

    def exit_write(self, token: tuple) -> None:
        with self._lock:
            for k in token:
                n = self._writes.get(k, 0) - 1
                if n <= 0:
                    self._writes.pop(k, None)
                else:
                    self._writes[k] = n
            self._cond.notify_all()

    def await_writable(self, index: str, shards,
                       timeout_s: float = 10.0) -> None:
        """Wait out any FENCING state on the shards WITHOUT
        registering a write (the ingest plane's pre-lock check);
        MOVED shards do not raise here — the caller splits them off
        via :meth:`moved_map` and reroutes."""
        if not self._fences:
            return
        deadline = time.monotonic() + timeout_s
        while True:
            waiter = None
            with self._lock:
                for s in shards or ():
                    f = self._fences.get((index, int(s)))
                    if f is not None and f.state == "fencing":
                        waiter = f
                        break
            if waiter is None:
                return
            if not waiter.event.wait(
                    max(0.0, deadline - time.monotonic())):
                return  # bounded: fall through, the apply re-checks

    def moved_map(self, index: str) -> dict[int, tuple[str, str]]:
        """{shard: (owner_id, owner_uri)} for MOVED shards of one
        index — the ingest plane's reroute table."""
        if not self._fences:
            return {}
        with self._lock:
            return {s: (f.owner_id, f.owner_uri)
                    for (ix, s), f in self._fences.items()
                    if ix == index and f.state == "moved"}

    # -- controller-side transitions -----------------------------------

    def begin(self, index: str, shard: int) -> None:
        with self._lock:
            f = self._fences.get((index, int(shard)))
            if f is not None and f.state == "fencing":
                return  # idempotent (resume)
            self._fences[(index, int(shard))] = _Fence()

    def _resolve(self, index: str, shard: int, resolution: str,
                 owner_id: str | None = None,
                 owner_uri: str | None = None) -> None:
        with self._lock:
            f = self._fences.pop((index, int(shard)), None)
            if f is None:
                f = _Fence()
            f.owner_id, f.owner_uri = owner_id, owner_uri
            f.resolution = resolution
            if resolution == "moved":
                f.state = "moved"
                f.ts = time.monotonic()  # sweep grace from the flip
                self._fences[(index, int(shard))] = f
            f.event.set()

    def resolve_replan(self, index: str, shard: int) -> None:
        """Ownership settled into a dual overlay: blocked writers
        re-plan from a fresh snapshot; the fence entry clears (this
        node still replicates the shard)."""
        self._resolve(index, shard, "replan")

    def set_moved(self, index: str, shard: int, owner_id: str,
                  owner_uri: str) -> None:
        """The ownership flip: this node answers 410 + new owner
        until :meth:`sweep_moved` ages the entry out (the redirect
        only matters while a pre-flip snapshot can still route
        here — bounded by in-flight query lifetime)."""
        self._resolve(index, shard, "moved", owner_id, owner_uri)

    def sweep_moved(self, max_age_s: float = 30.0) -> int:
        """Drop MOVED entries older than ``max_age_s`` (called from
        the node's heartbeat loop).  Keeping them forever would pin
        ``active()`` true for the life of the process — every write
        then pays the armed-fence slow path (shard-precise PQL
        parse, ingest moved-map walks) long after any stale snapshot
        could possibly route here."""
        cutoff = time.monotonic() - max_age_s
        with self._lock:
            dead = [k for k, f in self._fences.items()
                    if f.state == "moved" and f.ts < cutoff]
            for k in dead:
                del self._fences[k]
        return len(dead)

    def lift(self, index: str, shard: int) -> None:
        """Rollback: the migration aborted pre-flip — blocked writers
        proceed on this node as if nothing happened."""
        self._resolve(index, shard, "lift")

    def clear(self, index: str, shard: int) -> None:
        """This node is (re)acquiring the shard (it is a transfer
        recipient): drop any stale MOVED entry from a past epoch."""
        with self._lock:
            self._fences.pop((index, int(shard)), None)

    def drain_writes(self, index: str, shards=None,
                     timeout_s: float = 10.0) -> bool:
        """Wait until no admitted write that can touch the given
        shards (all the index's, when None) is in flight — wildcard
        registrations always count.  Shard-granular so a write storm
        on shards that are NOT moving never stalls a fence."""
        want = (None if shards is None
                else {int(s) for s in shards})

        def busy() -> bool:
            for (ix, s), n in self._writes.items():
                if ix != index or n <= 0:
                    continue
                if s is None or want is None or s in want:
                    return True
            return False

        deadline = time.monotonic() + timeout_s
        with self._lock:
            while busy():
                rem = deadline - time.monotonic()
                if rem <= 0:
                    return False
                self._cond.wait(rem)
        return True

    def payload(self) -> list[dict]:
        """/debug/rebalance view of the live fences."""
        with self._lock:
            return [{"index": ix, "shard": s, "state": f.state,
                     "new_owner": f.owner_id,
                     "new_owner_uri": f.owner_uri}
                    for (ix, s), f in sorted(self._fences.items())]


# ---------------------------------------------------------------------------
# RebalancePlan — the placement diff, materialized
# ---------------------------------------------------------------------------

class RebalancePlan:
    def __init__(self, op: str, node_id: str, roster_old: list[str],
                 roster_new: list[str],
                 moving: dict[int, tuple[str, str]]):
        self.op = op                      # "join" | "drain"
        self.node_id = node_id
        self.roster_old = roster_old
        self.roster_new = roster_new
        # partition -> (old_primary_id, new_primary_id)
        self.moving = moving
        self.state = "planned"            # planned|running|failed|done
        self.error: str | None = None
        # partition -> phase: pending|copy|chase|fence|dual|moved
        self.phases: dict[int, str] = {p: "pending" for p in moving}
        self.bytes_copied = 0
        self.bytes_delta = 0
        self.chase_rounds = 0
        self.shards_moved = 0

    def to_dict(self) -> dict:
        return {"op": self.op, "node": self.node_id,
                "state": self.state, "error": self.error,
                "roster_old": self.roster_old,
                "roster_new": self.roster_new,
                "moving_partitions": len(self.moving),
                "shards_moved": self.shards_moved,
                "bytes_copied": self.bytes_copied,
                "bytes_delta_replayed": self.bytes_delta,
                "chase_rounds": self.chase_rounds,
                "phases": {str(p): ph
                           for p, ph in sorted(self.phases.items())}}


# ---------------------------------------------------------------------------
# RebalanceController
# ---------------------------------------------------------------------------

# [cluster] rebalance-chase-lag, -max-rounds and -fence-timeout-s: the
# controller's defaults where its caller passes none
_CHASE_LAG = 8
_MAX_ROUNDS = 12
_FENCE_TIMEOUT_S = 10.0


def configure(chase_lag: int | None = None, max_rounds: int | None = None,
              fence_timeout_s: float | None = None) -> None:
    """The rebalance tunables (read when a controller is made); None
    leaves a knob as it is."""
    global _CHASE_LAG, _MAX_ROUNDS, _FENCE_TIMEOUT_S
    if chase_lag is not None:
        _CHASE_LAG = int(chase_lag)
    if max_rounds is not None:
        _MAX_ROUNDS = int(max_rounds)
    if fence_timeout_s is not None:
        _FENCE_TIMEOUT_S = float(fence_timeout_s)


def settings() -> dict:
    return {"chase_lag": _CHASE_LAG, "max_rounds": _MAX_ROUNDS,
            "fence_timeout_s": _FENCE_TIMEOUT_S}


class RebalanceController:
    """Drives one join/drain rebalance from a coordinator node.  All
    donor/recipient interaction goes over the node-to-node HTTP data
    plane (the same paths a multi-host deployment would use); only
    the placement writes touch disco directly (the etcd analog)."""

    def __init__(self, node, chase_lag: int | None = None,
                 max_rounds: int | None = None,
                 fence_timeout_s: float | None = None):
        self.node = node
        self.chase_lag = int(chase_lag if chase_lag is not None
                             else _CHASE_LAG)
        self.max_rounds = int(max_rounds if max_rounds is not None
                              else _MAX_ROUNDS)
        self.fence_timeout_s = (fence_timeout_s
                                if fence_timeout_s is not None
                                else _FENCE_TIMEOUT_S)
        self.plan: RebalancePlan | None = None
        self._client: InternalClient = node._client()
        # node-id -> (uri, state), refreshed per partition (and on
        # miss) instead of rebuilding a full ClusterSnapshot — with
        # its locked roster/overlay copies — once per fragment per
        # chase round while a storm is also snapshotting per query
        self._nodes_view: dict[str, tuple[str, str]] = {}
        self.partition_n = node.snapshot().partition_n
        # stall watchdog (obs/watchdog.py): a migration wedged on a
        # dead recipient or a drain that never converges is a named
        # stall with the stuck phase, not a silently hung rebalance
        from pilosa_tpu_torch.obs import watchdog
        self.watch = watchdog.register("rebalance-controller")

    # -- planning ------------------------------------------------------

    def _roster(self) -> list[str]:
        r = self.node.disco.roster()
        if r is None:
            r = sorted(n.id for n in self.node.disco.nodes())
        # prune roster ids with no registered node (a closed node's
        # entry survives in disco so a BOUNCE restores its bucket
        # position; a rebalance, though, plans against the EFFECTIVE
        # placement — snapshots filter missing ids the same way — and
        # its commit garbage-collects the ghosts)
        known = {n.id for n in self.node.disco.nodes()}
        return [i for i in r if i in known] if known else r

    def _moving(self, roster_old: list[str],
                roster_new: list[str]) -> dict[int, tuple[str, str]]:
        """Partitions whose OWNER SET changes — primaries AND ring-
        order replicas.  roster_diff (primary-only) understates the
        move set when replica_n >= 2: growing the roster changes the
        ring modulus, so a partition can keep its primary while a
        replica swaps — that replica still needs the data copied in
        and the old one released."""
        replica_n = self.node.replica_n
        out: dict[int, tuple[str, str]] = {}
        for p in range(self.partition_n):
            old = self._owners(roster_old, p, replica_n)
            new = self._owners(roster_new, p, replica_n)
            if old != new:
                out[p] = (old[0], new[0])
        return out

    def plan_join(self, node_id: str) -> RebalancePlan:
        """Placement diff for appending ``node_id`` to the roster.
        The node must already be registered live (open(member=False))
        so it can receive transfers."""
        roster = self._roster()
        if node_id in roster:
            raise RebalanceError(f"{node_id} already in the roster")
        if self.node.disco.nodes() and not any(
                n.id == node_id for n in self.node.disco.nodes()):
            raise RebalanceError(
                f"{node_id} is not a registered live node")
        new = roster + [node_id]
        return RebalancePlan("join", node_id, roster, new,
                             self._moving(roster, new))

    def plan_drain(self, node_id: str) -> RebalancePlan:
        roster = self._roster()
        if node_id not in roster:
            raise RebalanceError(f"{node_id} not in the roster")
        if len(roster) < 2:
            raise RebalanceError("cannot drain the last node")
        new = [i for i in roster if i != node_id]
        return RebalancePlan("drain", node_id, roster, new,
                             self._moving(roster, new))

    # -- helpers -------------------------------------------------------

    def _owners(self, roster: list[str], partition: int,
                replica_n: int) -> list[str]:
        from pilosa_tpu_torch.cluster.hash import jump_hash
        n = len(roster)
        primary = jump_hash(partition, n)
        k = max(1, min(replica_n, n))
        return [roster[(primary + i) % n] for i in range(k)]

    def _refresh_nodes(self) -> None:
        self._nodes_view = {n.id: (n.uri, n.state)
                            for n in self.node.disco.nodes()}

    def _uri(self, node_id: str) -> str:
        v = self._nodes_view.get(node_id)
        if v is None:
            self._refresh_nodes()
            v = self._nodes_view.get(node_id)
        if v is None:
            raise RebalanceError(f"node {node_id} left the cluster")
        return v[0]

    def _live(self, node_id: str) -> bool:
        v = self._nodes_view.get(node_id)
        return v is not None and v[1] == NodeState.STARTED

    def _post(self, uri: str, path: str, body: dict):
        return self._client._request(uri, "POST", path, body)

    def _get(self, uri: str, path: str):
        return self._client.get_json(uri, path)

    def _pairs(self, partition: int) -> list[tuple[str, int]]:
        """Every registered (index, shard) placed in ``partition``
        (shard->partition is a pure fnv function — no snapshot)."""
        from pilosa_tpu_torch.storage.translate import shard_to_shard_partition
        out = []
        for index in sorted(self.node.api.holder.indexes):
            for shard in sorted(self.node.disco.shards(index, "")):
                if shard_to_shard_partition(
                        index, shard, self.partition_n) == partition:
                    out.append((index, shard))
        return out

    def _fields(self, index: str) -> list[str]:
        idx = self.node.api.holder.index(index)
        return sorted(idx.fields) if idx is not None else []

    # -- fragment transfer --------------------------------------------

    def _frag_path(self, index, field, view, shard) -> str:
        return f"/internal/fragment/{index}/{field}/{view}/{shard}"

    def _copy_fragment(self, src_uri: str, dst_uri: str, index, field,
                       view, shard, detail: str) -> tuple[int, int]:
        """Checksum-diff block copy; returns (gen, base_version) of
        the donor fragment as captured BEFORE the block reads, so the
        chase covers every write concurrent with the copy."""
        base = self._frag_path(index, field, view, shard)
        st = self._get(src_uri, base + "/state")
        if st.get("absent"):
            return -1, -1
        theirs = st.get("checksums", {})
        mine = self._get(dst_uri, base + "/checksums")
        diverged = sorted(b for b in set(theirs) | set(mine)
                          if theirs.get(b) != mine.get(b))
        for b in diverged:
            self.watch.stamp("copy")
            # chaos seams: the transfer dies mid-copy (controller or
            # network), or the recipient dies under the push — the
            # gauntlet proves either resumes or rolls back with the
            # donor still the one owner
            faults.fire("transfer-interrupted", detail)
            payload = self._get(src_uri, base + f"/block/{b}")
            faults.fire("recipient-died", f"{dst_uri} {detail}")
            self._post(dst_uri, base + f"/block/{b}", payload)
            nbytes = sum(len(v) for v in payload.values())
            if self.plan is not None:
                self.plan.bytes_copied += nbytes
            metrics.REBALANCE_BYTES.inc(nbytes, kind="copied")
        return int(st.get("gen", -1)), int(st.get("version", 0))

    def _chase_fragment(self, src_uri: str, dst_uri: str, index, field,
                        view, shard, gen: int, since: int,
                        detail: str) -> tuple[int, int, int]:
        """One DELTA-CHASE round: replay the donor's delta-log spans
        above ``since`` as current row contents.  Returns (new_gen,
        new_since, remaining_count); a gen flip or log overflow falls
        back to a fresh checksum-diff copy round."""
        base = self._frag_path(index, field, view, shard)
        self.watch.stamp("chase")
        d = self._get(src_uri, base + "/deltas?since=" + str(since))
        if d.get("absent"):
            return gen, since, 0
        if int(d.get("gen", -1)) != gen or not d.get("covered", False):
            # dropped/recreated fragment or the write rate outran the
            # delta window: one more resumable block-diff round
            g2, v2 = self._copy_fragment(src_uri, dst_uri, index,
                                         field, view, shard, detail)
            return g2, v2, self.chase_lag + 1
        rows = d.get("rows", {})
        if rows:
            faults.fire("transfer-interrupted", detail)
            self._post(dst_uri, base + "/rows", {"rows": rows})
            nbytes = sum(len(v) for v in rows.values())
            if self.plan is not None:
                self.plan.bytes_delta += nbytes
            metrics.REBALANCE_BYTES.inc(nbytes, kind="delta_replayed")
        return gen, int(d.get("version", since)), int(d.get("count", 0))

    # -- per-partition migration --------------------------------------

    def _migrate_partition(self, plan: RebalancePlan, p: int) -> None:
        self._refresh_nodes()
        replica_n = self.node.replica_n
        old = self._owners(plan.roster_old, p, replica_n)
        new = self._owners(plan.roster_new, p, replica_n)
        recipients = [i for i in new if i not in old]
        # ALL live old owners fence, not just the copy source: with
        # replica_n >= 2 a write racing the fence window could
        # otherwise be acked by an unfenced old replica alone and
        # vanish when that replica releases at finalize
        donors = [i for i in old if self._live(i)]
        if not donors:
            raise RebalanceError(
                f"partition {p}: no live donor among {old}")
        src_id = donors[0]
        if not all(self._live(r) for r in recipients):
            raise RebalanceError(
                f"partition {p}: recipient not live: {recipients}")
        src_uri = self._uri(src_id)
        pairs = self._pairs(p)
        plan.phases[p] = "copy"
        fenced: list[tuple[str, str, int]] = []  # (uri, index, shard)
        overlay_set = False
        views_of: dict[tuple[str, str], list] = {}

        def copy_pairs(copy_set, frags):
            """SNAPSHOT-COPY one pair set into ``frags`` (the donor
            serves throughout); views fetched once per (index,
            field), not per shard."""
            for (index, shard) in copy_set:
                for field in self._fields(index):
                    views = views_of.get((index, field))
                    if views is None:
                        try:
                            views = self._get(
                                src_uri, f"/internal/fragment/"
                                f"{index}/{field}/views")
                        except RemoteError:
                            views = []
                        views_of[(index, field)] = views
                    for view in views:
                        for rid in recipients:
                            detail = (f"{index}/{field}/{view}/"
                                      f"{shard}->{rid}")
                            gen, ver = self._copy_fragment(
                                src_uri, self._uri(rid), index,
                                field, view, shard, detail)
                            if gen >= 0:
                                frags[(index, field, view, shard,
                                       rid)] = (gen, ver)

        try:
            frags: dict[tuple, tuple[int, int]] = {}
            copy_pairs(pairs, frags)
            metrics.REBALANCE_TOTAL.inc(phase="copy", outcome="ok")
            plan.phases[p] = "chase"
            lagging = dict(frags)
            for _ in range(self.max_rounds):
                if not lagging:
                    break
                plan.chase_rounds += 1
                nxt: dict[tuple, tuple[int, int]] = {}
                for key, (gen, since) in lagging.items():
                    index, field, view, shard, rid = key
                    g2, v2, cnt = self._chase_fragment(
                        src_uri, self._uri(rid), index, field, view,
                        shard, gen, since,
                        f"{index}/{field}/{view}/{shard}->{rid}")
                    frags[key] = (g2, v2)
                    if cnt > self.chase_lag:
                        nxt[key] = (g2, v2)
                lagging = nxt
            metrics.REBALANCE_TOTAL.inc(phase="chase", outcome="ok")

            # FENCE: the only write-blocked window — on EVERY live
            # old owner (replicas included), so no old replica can
            # solely ack a racing write the chase will never see
            plan.phases[p] = "fence"
            self.watch.stamp("fence")
            donor_uris = [self._uri(d) for d in donors]
            for d_uri in donor_uris:
                for (index, shard) in pairs:
                    self._post(d_uri, "/internal/rebalance/fence",
                               {"index": index, "shard": shard,
                                "action": "begin"})
                    fenced.append((d_uri, index, shard))
            faults.fire("fence-crash", f"partition={p}")
            for d_uri in donor_uris:
                for index in sorted({ix for ix, _ in pairs}):
                    got = self._post(
                        d_uri, "/internal/rebalance/drain",
                        {"index": index,
                         "shards": [s for ix, s in pairs
                                    if ix == index],
                         "timeout_s": self.fence_timeout_s})
                    if not (got or {}).get("drained", False):
                        # a write admitted pre-fence is STILL running
                        # on a donor: flipping now could strand it in
                        # a delta log nobody replays — abort (rollback
                        # lifts the fences, donors keep ownership)
                        raise RebalanceError(
                            f"partition {p}: donor write drain timed "
                            f"out on {index!r}")
            # shards CREATED in this partition during copy/chase
            # routed to the donor and are in neither the copy set
            # nor the fence set — without this recompute, finalize
            # would fence-and-RELEASE them uncopied (data loss).
            # Fence + copy them now (write-quiet under their fresh
            # fence, so one pass is exact); bounded re-checks close
            # the recompute race itself.
            for _ in range(3):
                new_pairs = [pr for pr in self._pairs(p)
                             if pr not in pairs]
                if not new_pairs:
                    break
                for d_uri in donor_uris:
                    for (index, shard) in new_pairs:
                        self._post(d_uri,
                                   "/internal/rebalance/fence",
                                   {"index": index, "shard": shard,
                                    "action": "begin"})
                        fenced.append((d_uri, index, shard))
                    for index in sorted({ix for ix, _ in new_pairs}):
                        self._post(
                            d_uri, "/internal/rebalance/drain",
                            {"index": index,
                             "shards": [s for ix, s in new_pairs
                                        if ix == index],
                             "timeout_s": self.fence_timeout_s})
                copy_pairs(new_pairs, frags)
                pairs = pairs + new_pairs
            else:
                raise RebalanceError(
                    f"partition {p}: shards kept appearing during "
                    f"the fence window")
            # final chase: under the fence the donor is write-quiet,
            # so this converges to an exact tail in bounded rounds
            for _ in range(self.max_rounds):
                remaining = 0
                for key, (gen, since) in list(frags.items()):
                    index, field, view, shard, rid = key
                    g2, v2, cnt = self._chase_fragment(
                        src_uri, self._uri(rid), index, field, view,
                        shard, gen, since,
                        f"{index}/{field}/{view}/{shard}->{rid}")
                    frags[key] = (g2, v2)
                    remaining += cnt
                if remaining == 0:
                    break
            else:
                raise RebalanceError(
                    f"partition {p}: delta tail did not converge "
                    f"under the fence")
            # key-translate ownership moves with the partition
            idx_keys = [ix for ix, _ in pairs
                        if (self.node.api.holder.index(ix) is not None
                            and self.node.api.holder.index(ix).keys)]
            for index in sorted(set(idx_keys)):
                try:
                    s = self._get(
                        src_uri,
                        f"/internal/translate/{index}/partition/{p}"
                        f"/snapshot")
                except RemoteError:
                    continue
                for rid in recipients:
                    self._post(self._uri(rid),
                               f"/internal/translate/{index}"
                               f"/partition/{p}/restore", s)
            # a recipient RE-acquiring a shard it once donated still
            # holds a stale MOVED fence from that epoch.  Clear it
            # only NOW — as late as possible: during copy/chase the
            # stale fence is load-bearing, 410-ing any read that a
            # racing pre-commit snapshot routed to this node's
            # incomplete (or released) copy.  The transfer endpoints
            # themselves never consult fences, so the clear is not
            # needed any earlier.
            for (index, shard) in pairs:
                for rid in recipients:
                    self._post(self._uri(rid),
                               "/internal/rebalance/clear",
                               {"index": index, "shard": shard})
            # the mutation-epoch-STAMPED ownership flip: overlay
            # "dual" — donor + recipient both replicate from here.
            # Stamped, not bumped: the flip changes ROUTING, not any
            # node's local data (the chase already bumped the
            # recipient's fragments), and a global bump here would
            # invalidate every node's canonical fused program once
            # per partition — measured as the storm's p99 spike.
            from pilosa_tpu_torch.models import fragment as _frag
            self.node.disco.set_overlay(
                p, new, "dual", mut_epoch=_frag.mutation_epoch())
            overlay_set = True
            # wake blocked writers into a re-plan (fresh snapshots
            # route dual); the donors keep serving as replicas
            for (f_uri, index, shard) in fenced:
                self._post(f_uri, "/internal/rebalance/fence",
                           {"index": index, "shard": shard,
                            "action": "replan"})
            fenced = []
            plan.phases[p] = "dual"
            plan.shards_moved += len(pairs)
            metrics.REBALANCE_TOTAL.inc(phase="fence", outcome="ok")
        except BaseException as e:
            # rollback: pre-flip the old owners keep ownership —
            # lift every fence so blocked writers proceed, clear a
            # half-installed overlay, surface the failure
            for (f_uri, index, shard) in fenced:
                try:
                    self._post(f_uri, "/internal/rebalance/fence",
                               {"index": index, "shard": shard,
                                "action": "lift"})
                except Exception:
                    pass
            if overlay_set:
                # the flip landed: the partition is CONSISTENT in
                # dual — resume completes it forward, never backward
                plan.phases[p] = "dual"
            else:
                try:
                    self.node.disco.clear_overlay(p)
                except Exception:
                    pass
                plan.phases[p] = "rolled_back"
            metrics.REBALANCE_TOTAL.inc(
                phase=plan.phases[p] if overlay_set else "fence",
                outcome="rolled_back")
            raise RebalanceError(
                f"partition {p} migration failed: "
                f"{type(e).__name__}: {e}") from e

    def _finalize_partition(self, plan: RebalancePlan, p: int) -> None:
        """dual -> moved: recipient-only routing, donor fences answer
        410, donor drains and RELEASES the shard's pages."""
        self.watch.stamp("release")
        self._refresh_nodes()
        replica_n = self.node.replica_n
        old = self._owners(plan.roster_old, p, replica_n)
        new = self._owners(plan.roster_new, p, replica_n)
        releasers = [i for i in old if i not in new]
        if not all(self._live(r) for r in new):
            raise RebalanceError(
                f"partition {p}: new owner not live at finalize")
        pairs = self._pairs(p)
        ov = self.node.disco.overlays().get(p, {})
        if ov.get("phase") != "moved":
            from pilosa_tpu_torch.models import fragment as _frag
            self.node.disco.set_overlay(
                p, new, "moved", mut_epoch=_frag.mutation_epoch())
        new_uri = self._uri(new[0])
        live_rel = [r for r in releasers if self._live(r)]
        # dead releasers repair at their next rejoin; live ones fence
        # + drain FIRST (all of them), then one tail chase, then free
        for rel in live_rel:
            rel_uri = self._uri(rel)
            for (index, shard) in pairs:
                self._post(rel_uri, "/internal/rebalance/fence",
                           {"index": index, "shard": shard,
                            "action": "moved", "owner_id": new[0],
                            "owner_uri": new_uri})
            for index in sorted({ix for ix, _ in pairs}):
                got = self._post(rel_uri, "/internal/rebalance/drain",
                                 {"index": index,
                                  "shards": [s for ix, s in pairs
                                             if ix == index],
                                  "timeout_s": self.fence_timeout_s})
                if not (got or {}).get("drained", False):
                    raise RebalanceError(
                        f"partition {p}: releaser write drain timed "
                        f"out on {index!r} (ownership flipped — "
                        f"resume retries the release)")
        # NO tail chase here, deliberately: after the moved flip the
        # recipients take INDEPENDENT writes the donor never sees, so
        # a row-replace chase from the (frozen) donor could roll a
        # recipient row back over a re-planned write — a worse loss
        # than the one it would repair.  The cluster write path is
        # fully covered without it (fences + drains + the pre-dual
        # tail); the residual is the per-node STREAM plane applying
        # donor-locally during the dual window — a documented
        # limitation of that plane's node-local replication scope
        # (README Elasticity), not of the coordinator write path.
        for rel in live_rel:
            rel_uri = self._uri(rel)
            for (index, shard) in pairs:
                got = self._post(rel_uri, "/internal/rebalance/release",
                                 {"index": index, "shard": shard,
                                  "timeout_s": self.fence_timeout_s})
                if not (got or {}).get("drained", False):
                    # a pre-flip read is still scanning the donor's
                    # copy: the handler refused to free it — fail the
                    # plan so resume retries (the flip is durable;
                    # only the memory release is pending)
                    raise RebalanceError(
                        f"partition {p}: reader drain timed out "
                        f"releasing {index!r}/{shard}")
        plan.phases[p] = "moved"
        metrics.REBALANCE_TOTAL.inc(phase="release", outcome="ok")

    # -- join/drain entry points ---------------------------------------

    def _push_schema(self, node_id: str) -> None:
        """A joining node needs the schema and the (every-node
        replicated) field row-key stores before any transfer."""
        uri = self._uri(node_id)
        schema = self.node.api.schema()
        self._post(uri, "/schema", schema)
        for index in sorted(self.node.api.holder.indexes):
            idx = self.node.api.holder.index(index)
            for fname in sorted(idx.fields):
                f = idx.field(fname)
                if f is None or not f.options.keys:
                    continue
                snap = f.row_translator.snapshot()
                self._post(uri,
                           f"/internal/translate/{index}/field/"
                           f"{fname}/restore", snap)

    def run(self, plan: RebalancePlan) -> RebalancePlan:
        """Execute (or resume) a plan to completion.  Partitions that
        already reached dual/moved (a prior interrupted run) skip
        straight to finalize — ``resume`` is just ``run`` again."""
        self.plan = plan
        plan.state = "running"
        t0 = time.perf_counter()
        self.watch.stamp("plan")
        try:
            if plan.op == "join":
                self._push_schema(plan.node_id)
            overlays = self.node.disco.overlays()
            for p in sorted(plan.moving):
                ph = overlays.get(p, {}).get("phase")
                if ph in ("dual", "moved"):
                    plan.phases[p] = ph   # resume: flip already done
                    continue
                self._migrate_partition(plan, p)
            for p in sorted(plan.moving):
                # unconditional: finalize is idempotent (re-fence,
                # re-drain, release-of-released is a no-op), and a
                # resume after a release-drain timeout must retry the
                # RELEASE even though the overlay already says moved
                self._finalize_partition(plan, p)
            self.node.disco.set_roster(plan.roster_new)
            plan.state = "done"
            metrics.REBALANCE_TOTAL.inc(phase="commit", outcome="ok")
        except BaseException as e:
            plan.state = "failed"
            plan.error = f"{type(e).__name__}: {e}"
            metrics.REBALANCE_TOTAL.inc(phase="commit",
                                        outcome="error")
            raise
        finally:
            self.watch.idle()
            plan.duration_s = round(time.perf_counter() - t0, 3)
        return plan

    def resume(self, plan: RebalancePlan) -> RebalancePlan:
        """Retry a failed plan: completed flips stay, pre-flip
        partitions restart their (resumable) transfer."""
        return self.run(plan)
