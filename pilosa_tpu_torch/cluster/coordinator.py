"""ClusterNode + ClusterExecutor — multi-host fan-out with failover.

Reference: the node-distribution half of executor.mapReduce
(executor.go:6392-6812): group shards by owning node (shardsByNode
:6416), run local shards in-process, POST remote shard groups to
their owners, stream-reduce responses, and fail over to a replica on
connection errors (:6505-6518).  Writes forward synchronously to all
shard replicas (api.go:651-672).

This layer stays on the host: a node is one ``Server`` whose executor
runs its own shard group on its device through the hand-written
kernels (``ClusterNode(device=None)`` serves from the CUDA card and
raises without one; ``device="cpu"`` runs the kernels' plain
versions).  Cross-node reduces work on the serialized result forms
(the wire format), as the reference reduces decoded protobuf rows.
The module is the JAX package's ``cluster/coordinator.py``; its hedge
and deadline knobs come in through ``configure()`` (``[cluster]
hedge-ms`` and ``deadline-s``), never the environment.
"""

from __future__ import annotations

import http.client
import json
import threading
import time

from pilosa_tpu_torch.cluster.client import (
    Deadline,
    DeadlineExceeded,
    InternalClient,
    RemoteError,
    ShardMovedError,
)
from pilosa_tpu_torch.cluster.disco import DisCo, InMemDisCo, Node, NodeState
from pilosa_tpu_torch.cluster.rebalance import FenceTable
from pilosa_tpu_torch.cluster.snapshot import ClusterSnapshot
from pilosa_tpu_torch.obs import faults, flight, metrics
from pilosa_tpu_torch.pql import parse

# network failures that trigger replica failover (executor.go:6505
# matches on connection errors; IncompleteRead etc. are
# http.client.HTTPException, not OSError)
_NET_ERRORS = (ConnectionError, OSError, TimeoutError,
               http.client.HTTPException)

# threads that check a resync's fragments against their peers (the JAX
# coordinator checks them one after another; the repairs are the same)
_SYNC_WORKERS = 8

# pql.Call.IsWrite analog (mirrors executor._WRITE_CALLS)
_WRITE_CALLS = {"Set", "Clear", "Store", "ClearRow", "Delete"}

# calls whose cross-node reduce stays meaningful over a shard SUBSET —
# the partial-result surface (Count under-counts, TopN ranks the live
# subset; both are the standard degraded answers a serving tier ships)
_PARTIAL_OK_CALLS = {"Count", "TopN", "TopK"}

# (monotonic timestamp, seconds) memo for the auto-derived hedge delay
_HEDGE_CACHE: tuple[float, float] | None = None

# [cluster] hedge-ms (negative disables hedging, 0 derives the delay
# from the flight record, positive fixes it) and deadline-s (0: none)
_HEDGE_MS = 0.0
_DEADLINE_S = 0.0


def configure(hedge_ms: float | None = None,
              deadline_s: float | None = None) -> None:
    """The fan-out's knobs, read per query (a reconfigure applies live);
    None leaves a knob as it is."""
    global _HEDGE_MS, _DEADLINE_S, _HEDGE_CACHE
    if hedge_ms is not None:
        _HEDGE_MS = float(hedge_ms)
        _HEDGE_CACHE = None
    if deadline_s is not None:
        _DEADLINE_S = float(deadline_s)


def settings() -> dict:
    return {"hedge_ms": _HEDGE_MS, "deadline_s": _DEADLINE_S}


class ClusterError(Exception):
    pass


class LoadShedError(ClusterError):
    """Typed 503: a shard subset is durably down (no live replica) and
    the caller did not opt into partial results — shed the query
    instead of returning a silently wrong answer.  ``status`` rides to
    the HTTP layer; ``missing_shards`` names the dead subset."""

    status = 503
    # Retry-After hint for the HTTP layer: one heartbeat interval is
    # the soonest a dead replica's recovery (or a peer resync) can
    # change the routing answer
    retry_after_s = 1.0

    def __init__(self, msg: str, missing_shards=()):
        super().__init__(msg)
        self.missing_shards = sorted(missing_shards)


def derive_hedge_delay_s(factor: float = 3.0, lo_s: float = 0.005,
                         hi_s: float = 1.0, default_s: float = 0.05,
                         min_records: int = 32,
                         min_node_records: int = 8) -> float:
    """Hedge delay from the flight recorder: the FASTEST replica's
    p95 attempt time — "if a healthy replica's p95 would have
    answered by now, fire the hedge" (tail-at-scale's defer-to-p95
    rule, tracked per node the way Cassandra's speculative retry
    tracks per-replica latency), clamped to [lo, hi].

    Deriving from the POOLED attempt distribution is poisonable: one
    durably slow replica slows a third of all attempts, drags the
    pooled p95 (and eventually the median) up to the fault latency,
    and the hedge fires too late to rescue exactly the requests it
    exists for.  The per-node MINIMUM stays anchored to the
    healthiest replica no matter how many peers degrade; when ALL
    replicas are slow (systemic overload, not a replica fault) the
    delay rises with them and hedging stays rare.  Each node's score
    is ``min(p95, factor x median)`` rather than bare p95: on a
    host whose healthy latencies are themselves heavy-tailed (GC /
    GIL / scheduler pauses), bare p95 would defer every hedge into
    that noise tail — the median arm keeps the delay anchored to the
    node's typical latency.  Falls back to the same score over the
    pooled sample while per-node counts are thin, to whole-record
    durations before fan-out attempts exist, and to ``default_s``
    until enough samples accumulate.

    Sample source: the statistics catalog (obs/stats.py) when it
    holds enough per-node attempt history — the catalog PERSISTS
    those distributions, so a freshly restarted coordinator hedges
    with calibrated delays from its first query instead of sitting
    on ``default_s`` until the in-memory ring refills.  The flight
    ring scan stays as the stats-disabled fallback."""
    from pilosa_tpu_torch.obs import stats as _stats
    got = _stats.hedge_samples(min_records=min_records)
    if got is not None:
        by_node = {n: list(v) for n, v in got[0].items()}
        durs = list(got[1])
    else:
        by_node = {}
        durs = []
        for r in flight.recorder.recent(512):
            if r.get("error") is not None:
                continue
            # only CLUSTER records feed the derivation: under a mixed
            # workload the ring is dominated by sub-ms solo / serving
            # / dax records, and deriving from those would clamp the
            # delay to the floor and hedge nearly every healthy
            # fan-out
            if r.get("route") != "cluster":
                continue
            durs.append(r.get("duration_ms", 0.0))
            for a in r.get("attempts", ()):
                # "*ok-local" attempts (in-process api.query legs)
                # are excluded for the same reason: sub-ms locals
                # would floor-clamp the delay and hedge every
                # healthy fan-out
                if str(a.get("outcome", "")).endswith("ok"):
                    by_node.setdefault(str(a.get("node", "")), []) \
                        .append(a.get("ms", 0.0))
    atts = [ms for lst in by_node.values() for ms in lst]
    sample = atts if len(atts) >= min_records else durs
    if len(sample) < min_records:
        return default_s
    def score(lst: list[float]) -> float:
        lst.sort()
        p95 = lst[min(len(lst) - 1, int(len(lst) * 0.95))]
        return min(p95, factor * lst[len(lst) // 2])

    node_scores = [score(lst) for lst in by_node.values()
                   if len(lst) >= min_node_records]
    if node_scores and sample is atts:
        delay_ms = min(node_scores)
    else:
        delay_ms = score(sample)
    return min(max(delay_ms / 1e3, lo_s), hi_s)


class ClusterNode:
    """One cluster member: an HTTP Server + disco registration +
    heartbeat loop (server.go Open wiring).  ``device`` goes to the
    node's ``Server``: None serves from the CUDA card and raises
    without one."""

    def __init__(self, node_id: str, disco: DisCo, holder=None,
                 replica_n: int = 1, bind: str = "127.0.0.1",
                 heartbeat_interval: float = 1.0, auth=None,
                 auth_token: str | None = None, device=None,
                 config=None):
        from pilosa_tpu_torch.server import Server
        self.server = Server(holder=holder, bind=bind, auth=auth,
                             device=device, config=config)
        # bearer token attached to all node-to-node requests so peer
        # traffic passes the chkAuthZ middleware when auth is on
        self.auth_token = auth_token
        self.api = self.server.api
        self.api.name = node_id
        self.node_id = node_id
        self.disco = disco
        self.replica_n = replica_n
        # ONE manager per node, shared with the API's HTTP endpoints —
        # two would let an exclusive transaction and a write disagree
        self.txns = self.api.txns
        self.uri = f"127.0.0.1:{self.server.port}"
        self._hb_interval = heartbeat_interval
        self._hb_stop = threading.Event()
        self._hb_thread: threading.Thread | None = None
        self.warm_stats: dict | None = None  # set by open(warm=True)
        self.warm_seconds: dict | None = None
        self._bg_resync: threading.Thread | None = None
        self.executor = ClusterExecutor(self)
        # federated observability: coordinator-side views
        # that fan out to live peers with per-node timeouts and merge.
        # add_route defaults to admin_only, and /debug/* paths gate on
        # admin in _check_auth anyway — same contract as local /debug.
        self.server.add_route("GET", "/debug/cluster/queries",
                              self._debug_cluster_queries)
        self.server.add_route("GET", "/debug/cluster/metrics",
                              self._debug_cluster_metrics)
        self.server.add_route("GET", "/debug/cluster/stats",
                              self._debug_cluster_stats)
        # incident forensics federation: cluster-wide
        # bundle listing with node attribution — a coordinator-side
        # operator finds every node's black boxes from one curl
        self.server.add_route("GET", "/debug/cluster/incidents",
                              self._debug_cluster_incidents)
        # correctness-audit federation: cluster-wide
        # quarantine/scrub view, plus the replica anti-entropy scrub
        # hook — the audit plane (obs/audit.py) stays cluster-
        # agnostic, so the coordinator (which owns placement and the
        # block-repair machinery) registers itself as the scrubber
        self.server.add_route("GET", "/debug/cluster/audit",
                              self._debug_cluster_audit)
        self._audit_scrub_cursor = 0
        _srv = self.api.executor.serving
        if _srv is not None and getattr(_srv, "audit", None) is not None:
            _srv.audit.replica_scrub = self.audit_scrub
        # online resharding: the donor-side write fence
        # plus the control RPCs the RebalanceController drives over
        # the node-to-node data plane, and the per-shard transfer
        # state at /debug/rebalance
        self.api.fences = FenceTable()
        self.last_rebalance: dict | None = None
        self.server.add_route("POST", "/internal/rebalance/fence",
                              self._post_rebalance_fence)
        self.server.add_route("POST", "/internal/rebalance/drain",
                              self._post_rebalance_drain)
        self.server.add_route("POST", "/internal/rebalance/release",
                              self._post_rebalance_release)
        self.server.add_route("POST", "/internal/rebalance/clear",
                              self._post_rebalance_clear)
        self.server.add_route("GET", "/debug/rebalance",
                              self._get_debug_rebalance)

    # -- lifecycle -----------------------------------------------------

    def open(self, warm: bool = False, member: bool = True):
        """disCo.Start + serve + heartbeats (server.go:618).

        ``warm=True`` is the REJOIN protocol: serve
        infrastructure comes up first, then the node resyncs what it
        missed from live peers (translate snapshots + fragment
        block repair — repaired fragments append to their delta
        logs, so resident device stacks re-converge by O(delta)
        patches, not full rebuilds) and prefills its stack caches
        by replaying the flight recorder's hottest recent queries,
        and only THEN registers with disco and takes traffic.

        ``member=False`` is the live-JOIN protocol: the
        node registers live (serves, heartbeats, receives transfers)
        but stays OUT of the placement roster — it owns nothing until
        a RebalanceController migrates its share and commits the new
        roster.

        The heartbeats start as soon as the node registers, before the
        post-register resync (the JAX node starts them after it): at
        full width a resync takes longer than a lease, and a node whose
        beats wait for it is marked DOWN again, resyncs again from its
        heartbeat loop, and so on without end."""
        self.server.start()
        if warm:
            t0 = time.perf_counter()
            synced = self.sync_from_peers()
            t1 = time.perf_counter()
            self.warm_stats = {"sync": synced,
                               "prefilled": self._prefill_from_flight()}
            # seconds of each step of the rejoin (the port's addition)
            self.warm_seconds = {"sync": t1 - t0,
                                 "prefill": time.perf_counter() - t1}
            metrics.CLUSTER_EVENTS.inc(event="node_rejoin")
        self.disco.start(Node(id=self.node_id, uri=self.uri),
                         member=member)
        self._hb_thread = threading.Thread(target=self._hb_loop,
                                           daemon=True)
        self._hb_thread.start()
        if warm:
            # close the rejoin skip window: a replicated write landing
            # between the bulk resync above and the disco registration
            # saw this node DOWN and skipped it ("repaired at its next
            # resync") — and this IS that next resync; writes after
            # registration route here normally
            try:
                t0 = time.perf_counter()
                self.warm_stats["sync_post_register"] = \
                    self.sync_from_peers()
                self.warm_seconds["sync_post_register"] = \
                    time.perf_counter() - t0
            except Exception as e:
                self.server.logger.warn(
                    "post-register resync failed: %s", e)
        return self

    def _hb_loop(self):
        # stall watchdog (obs/watchdog.py): armed through each beat
        # body (a beat wedged inside sync_from_peers is a stall with
        # that phase named), idle across the inter-beat wait
        from pilosa_tpu_torch.obs import watchdog
        watch = watchdog.register(f"heartbeat:{self.node_id}")
        while not self._hb_stop.wait(self._hb_interval):
            watch.stamp("beat")
            # age out MOVED fences once no stale pre-flip snapshot
            # can still route here — keeping them forever would pin
            # the armed-fence slow path onto every write
            self.api.fences.sweep_moved()
            if faults.take("node-crash", self.node_id):
                # chaos: die mid-traffic — stop serving AND beating;
                # peers mark us DOWN and fail queries over (the dead
                # node's watch deregisters — a corpse is not a stall)
                watchdog.deregister(watch.name)
                self.pause()
                return
            if faults.take("heartbeat-stall", self.node_id):
                # chaos: the asymmetric failure — still serving, but
                # the lease ages out and peers route around us.
                # idle() — the skipped beat is an injected LEASE
                # fault, not a wedged loop; the watchdog covers the
                # loop body, peers' heartbeat-age gauge covers this
                watch.idle()
                continue
            was_down = any(
                nd.id == self.node_id and nd.state == NodeState.DOWN
                for nd in self.disco.nodes())
            if was_down:
                # peers marked us DOWN while we kept running (stalled
                # lease, transient refusal): replicated writes were
                # skipped past us meanwhile, so resync from live peers
                # BEFORE the beat revives us as a read owner
                watch.stamp("resync")
                try:
                    self.sync_from_peers()
                    metrics.CLUSTER_EVENTS.inc(event="resync")
                except Exception as e:
                    self.server.logger.warn(
                        "revival resync failed: %s", e)
            revived = self.disco.heartbeat(self.node_id)
            if isinstance(self.disco, InMemDisCo):
                self.disco.check_heartbeats()
            if was_down or revived:
                # close the revival skip window: a write landing
                # between the resync above and the reviving beat still
                # saw us DOWN and was skipped — pull it now that we
                # are a read owner again.  ``revived and not
                # was_down`` is the racing DOWN mark that landed
                # between the was_down check and the beat: the beat
                # revived us as a read owner with NO resync yet, so
                # this one repairs whatever the skip window missed.  It
                # runs beside the beats (the JAX loop runs it in their
                # place): a resync longer than the lease would otherwise
                # get us marked DOWN again
                self._resync_beside_beats()
            watch.idle()  # inter-beat wait is parked, not stalled

    def _resync_beside_beats(self):
        """sync_from_peers on its own thread, one at a time."""
        t = self._bg_resync
        if t is not None and t.is_alive():
            return

        def run():
            try:
                self.sync_from_peers()
            except Exception as e:
                self.server.logger.warn("revival resync failed: %s", e)
        self._bg_resync = threading.Thread(
            target=run, daemon=True, name=f"resync:{self.node_id}")
        self._bg_resync.start()

    def _prefill_from_flight(self, max_queries: int = 8) -> int:
        """Warm-start cache prefill: replay the hottest recent READ
        queries from the flight recorder against the local shards so
        the first real queries after rejoin hit warm device stacks
        instead of paying cold uploads."""
        counts: dict[tuple, int] = {}
        for rec in flight.recorder.recent(512):
            q, ix = rec.get("query", ""), rec.get("index", "")
            if rec.get("error") is not None or not q or not ix:
                continue
            if any(w + "(" in q for w in _WRITE_CALLS):
                continue
            counts[(ix, q)] = counts.get((ix, q), 0) + 1
        warmed = 0
        hot = sorted(counts.items(), key=lambda kv: -kv[1])
        for (ix, q), _n in hot[:max_queries]:
            if self.api.holder.index(ix) is None:
                continue
            try:
                self.api.query(ix, q)
                warmed += 1
            except Exception:
                pass  # prefill is speculative; never block the rejoin
        return warmed

    def pause(self):
        """Stop heartbeating AND serving (fault injection — the pumba
        container-pause analog, internal/clustertests).  server_close
        releases the listening socket so clients get an immediate
        connection-refused instead of hanging in the accept backlog
        until their timeout."""
        self._hb_stop.set()
        self.server.httpd.shutdown()
        self.server.httpd.server_close()
        # the listener is permanently gone: tell the leak auditor now
        # (a killed node's ClusterNode object is usually abandoned —
        # close() would deregister the node id from disco, which after
        # a same-id rejoin would deregister the REJOINED node)
        from pilosa_tpu_torch.obs import testhook
        testhook.closed("http.Server", self.server)

    def close(self):
        self._hb_stop.set()
        if self._hb_thread:
            self._hb_thread.join(timeout=2)
        if self._bg_resync is not None:
            self._bg_resync.join(timeout=30)
        from pilosa_tpu_torch.obs import watchdog
        watchdog.deregister(f"heartbeat:{self.node_id}")
        self.disco.close(self.node_id)
        self.server.close()

    # -- placement -----------------------------------------------------

    def snapshot(self) -> ClusterSnapshot:
        # roster + overlays in ONE atomic read: a commit swaps them
        # together, and observing one side pre-commit with the other
        # post-commit would route a moved shard to its old owner
        roster, overlays = self.disco.placement()
        return ClusterSnapshot(self.disco.nodes(), self.replica_n,
                               roster=roster, overlays=overlays)

    # -- online resharding ----------------------------------

    def rebalance_join(self, node_id: str, **kw) -> dict:
        """Live scale-out: migrate the joining node's jump-hash share
        to it (it must be open(member=False) already), then commit
        the grown roster.  Returns the plan summary."""
        from pilosa_tpu_torch.cluster.rebalance import RebalanceController
        ctl = RebalanceController(self, **kw)
        plan = ctl.run(ctl.plan_join(node_id))
        self.last_rebalance = plan.to_dict()
        return self.last_rebalance

    def rebalance_drain(self, node_id: str, **kw) -> dict:
        """Live scale-in: migrate everything off ``node_id`` and
        commit the shrunk roster; the node can then close with no
        data loss."""
        from pilosa_tpu_torch.cluster.rebalance import RebalanceController
        ctl = RebalanceController(self, **kw)
        plan = ctl.run(ctl.plan_drain(node_id))
        self.last_rebalance = plan.to_dict()
        return self.last_rebalance

    # donor-side control RPCs the RebalanceController drives --------------

    def _post_rebalance_fence(self, req):
        body = req.json() or {}
        index = body.get("index", "")
        shard = int(body.get("shard", -1))
        action = body.get("action", "")
        f = self.api.fences
        if action == "begin":
            f.begin(index, shard)
        elif action == "replan":
            f.resolve_replan(index, shard)
        elif action == "moved":
            f.set_moved(index, shard, body.get("owner_id", ""),
                        body.get("owner_uri", ""))
        elif action == "lift":
            f.lift(index, shard)
        else:
            from pilosa_tpu_torch.api import ApiError
            raise ApiError(f"unknown fence action {action!r}", 400)
        return {"index": index, "shard": shard, "action": action}

    def _post_rebalance_drain(self, req):
        """Block until every write admitted before the fence finished
        on this node: the in-flight PQL-write counter drains, then
        the index import lock round-trips (bulk imports + ingest
        windows hold it while applying)."""
        body = req.json() or {}
        index = body.get("index", "")
        timeout_s = float(body.get("timeout_s", 10.0))
        shards = body.get("shards")
        drained = self.api.fences.drain_writes(index, shards=shards,
                                               timeout_s=timeout_s)
        with self.api._import_lock(index):
            pass
        return {"index": index, "drained": bool(drained)}

    def _post_rebalance_clear(self, req):
        """This node is acquiring the shard (transfer recipient):
        drop any stale MOVED fence from a previous epoch."""
        body = req.json() or {}
        self.api.fences.clear(body.get("index", ""),
                              int(body.get("shard", -1)))
        return {}

    def _post_rebalance_release(self, req):
        """RELEASE: drop the moved shard's fragments — serving-cache
        entries touching the shard are swept (scoped, never a full
        flush), fragment gens retire so device stack pages die
        through the memory ledger, and the persisted shard file (when
        storage-backed) is deleted."""
        body = req.json() or {}
        index = body.get("index", "")
        shard = int(body.get("shard", -1))
        idx = self.api.holder.index(index)
        if idx is None:
            return {"released": 0, "drained": True}
        # readers that passed the fence check before the flip may
        # still be scanning these fragments — freeing them mid-scan
        # would silently under-count; the fence already 410s new
        # reads, so this drains in one bounded wait.  A timeout means
        # a scan is STILL running: refuse to free (the caller retries
        # the release; ownership already flipped, so keeping the
        # donor's copy a little longer is only memory, never wrongness)
        if not self.api.fences.drain_reads(
                index, [shard],
                timeout_s=float(body.get("timeout_s", 10.0))):
            return {"released": 0, "drained": False}
        serving = getattr(self.api.executor, "serving", None)
        if serving is not None and serving.cache is not None:
            serving.cache.sweep_shards(index, {shard})
        released = 0
        freed = 0
        with self.api._import_lock(index):
            for f in idx.fields.values():
                for v in f.views.values():
                    frag = v.fragments.get(shard)
                    if frag is None:
                        continue
                    freed += frag.memory_bytes()
                    # gen retires BEFORE the pop: every derived stamp
                    # (tile stacks, result snapshots, prefetch
                    # recipes) compares unequal from here on
                    frag.bump_gen()
                    v.fragments.pop(shard, None)
                    released += 1
            if idx.storage is not None:
                try:
                    idx.storage.drop_shard(shard)
                except Exception as e:
                    self.server.logger.warn(
                        "release: shard %s file drop failed: %s",
                        shard, e)
        metrics.REBALANCE_BYTES.inc(freed, kind="released")
        return {"released": released, "bytes": freed,
                "drained": True}

    def _get_debug_rebalance(self, req):
        """Per-shard transfer state: this node's live fences, the
        cluster's placement roster/epoch/overlays, and the last
        controller run this node drove."""
        return {
            "node": self.node_id,
            "fences": self.api.fences.payload(),
            "roster": self.disco.roster(),
            "placement_epoch": self.disco.placement_epoch(),
            "overlays": {str(p): ov for p, ov in
                         sorted(self.disco.overlays().items())},
            "controller": self.last_rebalance,
        }

    # -- rejoin resync (holder.go:1488-1715 + fragment.go checksums) ---

    def sync_from_peers(self) -> dict:
        """Pull what this node missed while dead: translate-store
        snapshots from partition owners (holder.go:1488-1715 translate
        syncer) and diverged fragment blocks from each shard's primary
        (fragment.go checksum-block repair).  Returns counters."""
        snap = self.snapshot()
        client = self._client()
        stats = {"partitions": 0, "fields": 0, "blocks": 0}
        peers = {n.id: n for n in snap.nodes
                 if n.id != self.node_id and n.state == NodeState.STARTED}
        if not peers:
            return stats
        for index in sorted(self.api.holder.indexes):
            idx = self.api.holder.index(index)
            # column-key partitions: restore from each partition's
            # primary owner when that owner is another live node
            if idx.keys:
                seen: set[int] = set()
                for peer in peers.values():
                    try:
                        parts = client.get_json(
                            peer.uri,
                            f"/internal/translate/{index}/partitions")
                    except _NET_ERRORS + (RemoteError,):
                        continue
                    for p in parts:
                        if p in seen:
                            continue
                        # pull from the first LIVE owner — even when
                        # we are the jump-hash primary for p, the
                        # replicas that stayed up hold the newer keys
                        owners = snap.partition_nodes(p)
                        owner = next((n for n in owners
                                      if n.id in peers), None)
                        if owner is None:
                            # no live replica owns p; fall back to the
                            # peer that reported it so rejoin still
                            # recovers the keys
                            owner = peer
                        try:
                            s = client.get_json(
                                owner.uri,
                                f"/internal/translate/{index}"
                                f"/partition/{p}/snapshot")
                        except _NET_ERRORS + (RemoteError,):
                            continue
                        idx.column_translator.restore_partition(p, s)
                        seen.add(p)
                        stats["partitions"] += 1
            # field row-key stores replicate on every node: pull from
            # ANY live peer (a rejoining cluster primary is the one
            # node guaranteed to be stale, so "primary only" would
            # skip exactly the case that needs the sync)
            src = (snap.primary() if snap.primary() is not None
                   and snap.primary().id in peers
                   else next(iter(peers.values())))
            for fname in sorted(idx.fields):
                f = idx.field(fname)
                if f is None or not f.options.keys:
                    continue
                try:
                    s = client.get_json(
                        src.uri,
                        f"/internal/translate/{index}/field/"
                        f"{fname}/snapshot")
                except _NET_ERRORS + (RemoteError,):
                    continue
                f.row_translator.restore_snapshot(s)
                stats["fields"] += 1
            # fragment repair: for every shard this node replicates,
            # diff block checksums against a live co-owner.  The shard
            # set merges every peer's view — shards created while this
            # node was down are unknown locally.
            all_shards = set(idx.available_shards)
            for peer in peers.values():
                try:
                    all_shards.update(client.get_json(
                        peer.uri, f"/internal/shards/{index}"))
                except _NET_ERRORS + (RemoteError,):
                    continue
            # one job a (peer, field): the peer's view list and its
            # block digests of every shard of the job come in one request
            # each (the JAX node asks a shard at a time)
            groups: dict = {}
            for fname in sorted(idx.fields):
                f = idx.field(fname)
                if f is None:
                    continue
                for shard in sorted(all_shards):
                    owners = snap.shard_nodes(index, shard)
                    if self.node_id not in (n.id for n in owners):
                        continue
                    # pull from the first LIVE co-owner — even when we
                    # are the jump-hash primary: after downtime the
                    # replicas that stayed up hold the newer data
                    src = next((n for n in owners if n.id in peers),
                               None)
                    if src is None:
                        continue  # no live peer holds this shard
                    groups.setdefault((src.id, fname), (src, []))[1] \
                        .append(shard)
            jobs = [(fname, src, shards) for (_sid, fname), (src, shards)
                    in sorted(groups.items())]

            def one(pool, job, index=index):
                fname, src, shards = job
                with pool.blocked():  # RPC waits: let the pool grow
                    return self._repair_shards(client, src, index, fname,
                                               shards)

            from pilosa_tpu_torch.taskpool import Pool, TaskFailure
            for out in Pool(size=_SYNC_WORKERS).map_settled(one, jobs):
                if isinstance(out, TaskFailure):
                    raise out.error
                stats["blocks"] += out
        return stats

    def _repair_fragment(self, client, primary, index, fname,
                         shard) -> int:
        """Diff + pull diverged blocks for every view of one
        (field, shard) from the primary."""
        return self._repair_shards(client, primary, index, fname, [shard])

    def _peer_checksums(self, client, peer, index, fname, view,
                        shards) -> dict:
        """shard -> the peer's block digests of (field, view, shard), in
        one request (``POST .../{view}/checksums``); empty if the peer
        could not answer."""
        try:
            got = client._request(
                peer.uri, "POST",
                f"/internal/fragment/{index}/{fname}/{view}/checksums",
                {"shards": [int(s) for s in shards]}, idempotent=True)
        except _NET_ERRORS + (RemoteError,):
            return {}
        return {int(s): d for s, d in got.items()}

    def _repair_shards(self, client, primary, index, fname,
                       shards) -> int:
        """Diff + pull diverged blocks for every view of (field, shard)
        over ``shards`` from the primary."""
        repaired = 0
        try:
            views = client.get_json(
                primary.uri, f"/internal/fragment/{index}/{fname}/views")
        except _NET_ERRORS + (RemoteError,):
            return 0
        for view in views:
            every = self._peer_checksums(client, primary, index, fname,
                                         view, shards)
            for shard in shards:
                theirs = every.get(shard)
                if theirs is None:
                    continue
                mine = self.api.fragment_checksums(index, fname, view,
                                                   shard)
                diverged = [b for b in set(theirs) | set(mine)
                            if theirs.get(b) != mine.get(b)]
                for b in diverged:
                    try:
                        payload = client.get_json(
                            primary.uri,
                            f"/internal/fragment/{index}/{fname}/{view}/"
                            f"{shard}/block/{b}")
                    except _NET_ERRORS + (RemoteError,):
                        continue
                    self.api.fragment_set_block(
                        index, fname, view, shard, int(b), payload)
                    repaired += 1
        return repaired

    # -- replica anti-entropy scrub -------------------------

    def audit_scrub(self, budget: int = 2) -> int:
        """Continuous replica scrub (obs/audit.py ticker hook):
        compare block checksums of up to ``budget`` locally-
        replicated fragments against a live co-owner.  Divergence is
        COUNTED as a detection first
        (``pilosa_audit_total{kind="replica",outcome="mismatch"}``,
        quarantine entry, rate-limited ``audit-mismatch`` incident) —
        then repaired through the same block-pull path
        ``sync_from_peers`` uses, never silently healed.  Returns the
        fragments scanned this pass (a rotating cursor spreads full
        coverage across ticks)."""
        if budget <= 0:
            return 0
        snap = self.snapshot()
        peers = {n.id: n for n in snap.nodes
                 if n.id != self.node_id
                 and n.state == NodeState.STARTED}
        if not peers:
            return 0
        client = self._client()
        frags: list[tuple] = []
        for index in sorted(self.api.holder.indexes):
            idx = self.api.holder.index(index)
            if idx is None:
                continue
            for shard in sorted(idx.available_shards):
                owners = snap.shard_nodes(index, shard)
                if self.node_id not in (n.id for n in owners):
                    continue
                src = next((n for n in owners if n.id in peers), None)
                if src is None:
                    continue  # no live co-owner to compare against
                for fname in sorted(idx.fields):
                    frags.append((index, fname, shard, src))
        if not frags:
            return 0
        n = len(frags)
        start = self._audit_scrub_cursor % n
        scanned = 0
        while scanned < min(budget, n):
            index, fname, shard, src = frags[(start + scanned) % n]
            scanned += 1
            try:
                self._audit_scrub_one(client, src, index, fname, shard)
            except Exception as e:
                self.server.logger.warn(
                    "replica scrub %s/%s/%s failed: %s",
                    index, fname, shard, e)
                metrics.AUDIT_TOTAL.inc(kind="replica",
                                        outcome="error")
        self._audit_scrub_cursor = (start + scanned) % n
        return scanned

    def _audit_scrub_one(self, client, src, index, fname, shard):
        from pilosa_tpu_torch.obs import incidents
        try:
            views = client.get_json(
                src.uri, f"/internal/fragment/{index}/{fname}/views")
        except _NET_ERRORS + (RemoteError,):
            return
        diverged: dict[str, list] = {}
        for view in views:
            try:
                theirs = client.get_json(
                    src.uri,
                    f"/internal/fragment/{index}/{fname}/{view}/"
                    f"{shard}/checksums")
            except _NET_ERRORS + (RemoteError,):
                continue
            mine = self.api.fragment_checksums(index, fname, view,
                                               shard)
            bad = sorted(b for b in set(theirs) | set(mine)
                         if theirs.get(b) != mine.get(b))
            if bad:
                diverged[view] = bad
        if not diverged:
            metrics.AUDIT_TOTAL.inc(kind="replica", outcome="match")
            return
        # detection FIRST, repair second: anti-entropy must surface
        # divergence, not silently heal it
        metrics.AUDIT_TOTAL.inc(kind="replica", outcome="mismatch")
        ent = {"id": f"aud-replica-{self.node_id}-"
                     f"{index}/{fname}/{shard}",
               "time": time.time(), "kind": "replica",
               "index": index,
               "fragment": f"{index}/{fname}/{shard}",
               "peer": src.id,
               "diverged": diverged}
        srv = self.api.executor.serving
        plane = getattr(srv, "audit", None) if srv is not None else None
        repaired = self._repair_fragment(client, src, index, fname,
                                         shard)
        ent["repaired_blocks"] = repaired
        if plane is not None:
            plane.quarantine.append(ent)
        incidents.report(
            "audit-mismatch",
            detail=(f"replica scrub divergence on "
                    f"{index}/{fname}/{shard} vs {src.id} "
                    f"({sum(len(v) for v in diverged.values())} "
                    f"blocks)"),
            context=ent)
        if repaired:
            metrics.AUDIT_TOTAL.inc(kind="replica", outcome="repaired")

    # -- federated observability ----------------------------

    def _federate(self, path: str, timeout_s: float):
        """GET ``path`` from every live PEER with a per-node deadline
        (``Deadline``); returns ({node_id: payload}, [unreachable]).
        A slow or dead peer costs its timeout, never the request —
        the caller flags the response partial instead."""
        snap = self.snapshot()
        peers = [n for n in snap.nodes
                 if n.state == NodeState.STARTED
                 and n.id != self.node_id]
        if not peers:
            return {}, []
        client = self._client()
        from pilosa_tpu_torch.taskpool import Pool, TaskFailure

        def one(pool, n):
            with pool.blocked():  # RPC wait: let the pool grow
                return client.get_json(n.uri, path,
                                       deadline=Deadline(timeout_s))

        outs = Pool(size=4).map_settled(one, peers)
        got, unreachable = {}, []
        for n, out in zip(peers, outs):
            if isinstance(out, TaskFailure):
                unreachable.append(n.id)
            else:
                got[n.id] = out
        return got, sorted(unreachable)

    def _debug_cluster_queries(self, req):
        """Cluster-wide flight view: fan out /debug/queries to live
        nodes, merge records keyed by trace id — one entry shows the
        coordinator's fan-out record (with per-node ``attempts``)
        next to every node's leg records under the same id.  Query
        params: ``limit``/``n``, ``timeout_ms`` (per-node),
        ``trace_id`` (single-trace filter), plus the per-node
        /debug/queries filters — ``route``/``tenant``/``since_ms``
        PASS THROUGH to every node and apply identically to the
        coordinator's own ring (server/http.py
        filter_flight_records, one implementation)."""
        from urllib.parse import urlencode

        from pilosa_tpu_torch.server.http import filter_flight_records
        q = req.query
        limit = int(q.get("limit", q.get("n", ["100"]))[0])
        timeout_s = float(q.get("timeout_ms", ["1000"])[0]) / 1e3
        want_tid = q.get("trace_id", [None])[0]
        route = q.get("route", [None])[0]
        tenant = q.get("tenant", [None])[0]
        since_ms = q.get("since_ms", [None])[0]
        # a single-trace lookup must search each node's WHOLE ring —
        # truncating to the newest `limit` first would hide any trace
        # older than the last N queries; same for the filters (the
        # per-node endpoint filters THEN truncates, and the local leg
        # must apply identically)
        filtered = (route is not None or tenant is not None
                    or since_ms is not None)
        fetch = 1 << 17 if (want_tid or filtered) else limit
        per_node = {self.node_id: filter_flight_records(
            flight.recorder.recent(fetch), route=route,
            tenant=tenant, since_ms=since_ms)}
        params = {"limit": fetch}
        for k, v in (("route", route), ("tenant", tenant),
                     ("since_ms", since_ms)):
            if v is not None:
                params[k] = v
        got, unreachable = self._federate(
            "/debug/queries?" + urlencode(params), timeout_s)
        for nid, payload in got.items():
            per_node[nid] = (payload or {}).get("queries", [])
        merged: dict[str, dict] = {}
        for nid in sorted(per_node):
            for rec in per_node[nid]:
                tid = rec.get("trace_id")
                if tid is None or (want_tid and tid != want_tid):
                    continue
                ent = merged.get(tid)
                if ent is None:
                    ent = merged[tid] = {"trace_id": tid, "nodes": {},
                                         "start": rec.get("start", 0)}
                ent["nodes"].setdefault(nid, []).append(rec)
                ent["start"] = min(ent["start"],
                                   rec.get("start", ent["start"]))
                if rec.get("route") == "cluster" and \
                        "coordinator" not in ent:
                    # the fan-out record IS the merged entry's spine:
                    # per-node attempts (hedges included) live here.
                    # First sighting wins — an in-process test cluster
                    # shares one ring, so every node reports it
                    ent["coordinator"] = nid
                    if rec.get("attempts"):
                        ent["attempts"] = rec["attempts"]
        entries = sorted(merged.values(),
                         key=lambda e: -e.get("start", 0))[:limit]
        return {"queries": entries,
                "nodes": sorted(per_node),
                "unreachable": unreachable,
                "partial": bool(unreachable)}

    def _debug_cluster_metrics(self, req):
        """Cluster-wide metrics: fan out /metrics.json to live nodes
        and sum series point-wise (counters/gauges add; histograms
        add count+sum) under ``aggregate``, with each node's raw
        payload under ``per_node``.  ``timeout_ms`` bounds each
        node's fetch; unreachable nodes flag the response partial."""
        timeout_s = float(
            req.query.get("timeout_ms", ["1000"])[0]) / 1e3
        flight.flush_metrics()  # local scrape sees current samples
        per_node = {self.node_id: metrics.registry.render_json()}
        got, unreachable = self._federate("/metrics.json", timeout_s)
        per_node.update(got)
        agg: dict = {}
        for doc in per_node.values():
            for name, series in (doc or {}).items():
                dst = agg.setdefault(name, {})
                for labels, val in series.items():
                    if isinstance(val, dict):  # histogram {count,sum}
                        cur = dst.setdefault(
                            labels, {"count": 0, "sum": 0.0})
                        cur["count"] += val.get("count", 0)
                        cur["sum"] += val.get("sum", 0.0)
                    else:
                        dst[labels] = dst.get(labels, 0.0) + val
        return {"aggregate": agg,
                "nodes": sorted(per_node),
                "per_node": per_node,
                "unreachable": unreachable,
                "partial": bool(unreachable)}

    def _debug_cluster_stats(self, req):
        """Cluster-wide statistics catalog: fan out /debug/stats to
        live nodes (filters ``index``/``fingerprint``/``limit`` PASS
        THROUGH to every node and apply to the local catalog — same
        contract as /debug/cluster/queries, from day one) and merge:
        per-fingerprint profiles aggregate n-weighted across nodes,
        regressions union with node attribution, each node's raw
        payload under ``per_node``.  ``timeout_ms`` bounds each
        node's fetch."""
        from urllib.parse import urlencode

        from pilosa_tpu_torch.obs import stats
        q = req.query
        timeout_s = float(q.get("timeout_ms", ["1000"])[0]) / 1e3
        index = q.get("index", [None])[0]
        fingerprint = q.get("fingerprint", [None])[0]
        limit = q.get("limit", [None])[0]
        per_node = {self.node_id: stats.get().payload(
            index=index, fingerprint=fingerprint,
            limit=int(limit) if limit is not None else None)}
        params = {k: v for k, v in (("index", index),
                                    ("fingerprint", fingerprint),
                                    ("limit", limit))
                  if v is not None}
        path = "/debug/stats" + ("?" + urlencode(params)
                                 if params else "")
        got, unreachable = self._federate(path, timeout_s)
        per_node.update(got)
        profiles: dict[str, dict] = {}
        regressions: list[dict] = []
        # an IN-PROCESS test cluster shares one process-global
        # catalog, so every node would report the identical payload
        # and the n-weighted merge would multiply each profile by the
        # node count — aggregate each distinct payload once (same
        # first-sighting-wins shape as the cluster-queries merge)
        seen_docs: set = set()
        for nid in sorted(per_node):
            doc = per_node[nid] or {}
            digest = json.dumps(doc, sort_keys=True, default=str)
            if digest in seen_docs:
                continue
            seen_docs.add(digest)
            for fp, p in (doc.get("runtime") or {}).items():
                agg = profiles.setdefault(
                    fp, {"n": 0, "ms": 0.0, "nodes": 0})
                n = int(p.get("n", 0))
                if agg["n"] + n > 0:
                    agg["ms"] = round(
                        (agg["ms"] * agg["n"]
                         + float(p.get("ms", 0.0)) * n)
                        / (agg["n"] + n), 4)
                agg["n"] += n
                agg["nodes"] += 1
            for reg in doc.get("regressions") or ():
                regressions.append({**reg, "node": nid})
        return {"aggregate": {"profiles": profiles,
                              "regressions": regressions},
                "nodes": sorted(per_node),
                "per_node": per_node,
                "unreachable": unreachable,
                "partial": bool(unreachable)}

    def _debug_cluster_incidents(self, req):
        """Cluster-wide incident listing: fan out /debug/incidents to
        live nodes (``limit`` passes through and applies to the local
        manager identically), merge bundle metadata with node
        attribution, newest first.  An in-process test cluster shares
        ONE process-global manager, so every node reports the same
        bundles — merge by bundle id, first sighting wins (same shape
        as the cluster-stats dedup).  ``timeout_ms`` bounds each
        node's fetch; full bundles stay a per-node fetch
        (``/debug/incidents?id=`` on the reporting node — the
        listing carries which node to ask)."""
        from pilosa_tpu_torch.obs import incidents
        q = req.query
        limit = int(q.get("limit", ["50"])[0])
        timeout_s = float(q.get("timeout_ms", ["1000"])[0]) / 1e3
        per_node = {self.node_id: incidents.get().payload(limit)}
        got, unreachable = self._federate(
            f"/debug/incidents?limit={limit}", timeout_s)
        per_node.update(got)
        merged: dict[str, dict] = {}
        stalls: list[dict] = []
        seen_watch: set = set()
        for nid in sorted(per_node):
            doc = per_node[nid] or {}
            for m in doc.get("incidents") or ():
                iid = m.get("id")
                if iid and iid not in merged:
                    merged[iid] = {**m, "node": nid}
            for w in doc.get("watchdog") or ():
                # dedupe IDENTICAL rows only — an in-process test
                # cluster shares one registry so every node reports
                # byte-equal entries; distinct per-node state in a
                # real multi-process cluster (different age/armed/
                # stalls for the same loop name) must all survive
                key = json.dumps(w, sort_keys=True, default=str)
                if key not in seen_watch:
                    seen_watch.add(key)
                    stalls.append({**w, "node": nid})
        entries = sorted(merged.values(),
                         key=lambda m: -m.get("time", 0))[:limit]
        return {"incidents": entries,
                "watchdog": stalls,
                "nodes": sorted(per_node),
                "unreachable": unreachable,
                "partial": bool(unreachable)}

    def _debug_cluster_audit(self, req):
        """Cluster-wide correctness-audit view: fan out /debug/audit
        to live nodes, merge quarantine entries by id (first sighting
        wins, node-attributed, newest first) and keep the per-node
        counter/config payloads verbatim so a divergent kill-switch or
        sample rate on one node is visible from any node."""
        from pilosa_tpu_torch.obs import audit
        q = req.query
        timeout_s = float(q.get("timeout_ms", ["1000"])[0]) / 1e3
        srv = self.api.executor.serving
        per_node = {self.node_id: audit.payload(
            getattr(srv, "audit", None) if srv is not None else None)}
        got, unreachable = self._federate("/debug/audit", timeout_s)
        per_node.update(got)
        merged: dict[str, dict] = {}
        for nid in sorted(per_node):
            doc = per_node[nid] or {}
            for m in doc.get("quarantine") or ():
                mid = m.get("id")
                if mid and mid not in merged:
                    merged[mid] = {**m, "node": nid}
        entries = sorted(merged.values(),
                         key=lambda m: -m.get("time", 0))
        return {"quarantine": entries,
                "per_node": per_node,
                "nodes": sorted(per_node),
                "unreachable": unreachable,
                "partial": bool(unreachable)}

    # -- writes (replicated) -------------------------------------------

    def _import_replicated(self, index: str, shard: int, owners,
                           send) -> int:
        """Forward one shard's import to every replica; a failing
        replica is marked DOWN and skipped as long as at least one
        owner acks (the write contract of _execute_col_write /
        api.go:651).  Returns the FIRST successful ack's changed
        count (replica acks are duplicates, not additional bits).

        WRITE failures mark DOWN for ANY network error, timeouts
        included — unlike the read fan-out's ConnectionError-only
        rule — because the skipped replica now DIVERGES and the DOWN
        mark is the repair trigger: a node that is in fact alive
        notices it on its own next heartbeat, runs sync_from_peers,
        and revives (coordinator._hb_loop), costing one beat of read
        traffic; a node that is dead repairs at warm rejoin.  Leaving
        a timed-out replica STARTED would leave it silently stale
        with no path that ever resyncs it."""
        n = None
        last_err = None
        moved = None
        for node in owners:
            try:
                n_ = send(node)
            except ShardMovedError as e:
                # a rebalance flipped this replica's ownership away
                # mid-import (the local-apply path raises it typed):
                # not a death — note it and keep going, then force a
                # RE-PLAN below even if another replica acked
                moved = e
                continue
            except RemoteError as e:
                if e.status == 410:
                    moved = e
                    continue
                raise
            except _NET_ERRORS as e:
                last_err = e
                self.disco.set_state(node.id, NodeState.DOWN)
                metrics.CLUSTER_EVENTS.inc(event="replica_skip")
                self.server.logger.warn(
                    "import %s/shard %s skipped replica %s (%s); "
                    "repaired at its next resync", index, shard,
                    node.id, type(e).__name__)
                continue
            if n is None:
                n = n_
        if moved is not None:
            # NEVER settle for a partial ack when a fence skipped a
            # replica: the fenced copy is the one the final chase
            # ships to the recipient, so a write applied only on the
            # other (not-yet-fenced) replica would silently miss the
            # new owner.  Re-planning re-sends to the settled owner
            # set — imports are idempotent, so replicas that already
            # applied just re-apply harmlessly.
            raise moved if isinstance(moved, ShardMovedError) \
                else ShardMovedError(index, [shard],
                                     owner_uri=moved.new_owner)
        if n is None:
            if owners:
                raise ClusterError(
                    f"no live replica accepted import for "
                    f"{index!r} shard {shard}: {last_err}")
            return 0
        return n

    def _import_shard_replan(self, index: str, shard: int, send,
                             snap_box: list | None = None,
                             tries: int = 4) -> int:
        """One shard's replicated import with moved-shard re-planning:
        an ownership flip that raced the routing snapshot re-resolves
        against a fresh one (the overlay/roster already names the new
        owner) instead of failing the import.  ``snap_box`` is the
        caller's shared single-element snapshot holder — the snapshot
        each group reads after its ack lands back in the box, so the
        caller's REMAINING groups plan against the settled placement
        instead of each re-discovering the flip with a doomed send
        plus a backoff sleep."""
        box = snap_box if snap_box is not None else [None]
        last: ShardMovedError | None = None
        sent: set[str] = set()
        n = None
        for attempt in range(tries + 1):
            if box[0] is None:
                box[0] = self.snapshot()
            owners = [o for o in box[0].shard_nodes(index, shard)
                      if o.id not in sent]
            if n is not None and not owners:
                return n
            if n is not None:
                metrics.CLUSTER_EVENTS.inc(event="late_owner")
            try:
                got = self._import_replicated(index, shard, owners, send)
            except ShardMovedError as e:
                last = e
                sent, n = set(), None
                box[0] = None  # re-plan against a fresh placement
                # FENCING resolutions settle within the fence window;
                # re-snapshot after a short beat
                time.sleep(0.01 * (attempt + 1))
                continue
            if n is None:
                n = got
            sent.update(o.id for o in owners)
            # the placement read AFTER the ack: a snapshot taken
            # before a partition's dual flip routes to the donor alone,
            # and a donor whose fence has already resolved admits the
            # write after the final chase, so no chase ships it and the
            # release drops it.  Any owner named now and not yet sent
            # to gets the (idempotent) write too; the fresh snapshot
            # then routes the caller's next group.
            box[0] = self.snapshot()
        if n is not None:
            return n
        raise last

    def import_bits(self, index: str, field: str, rows, cols,
                    timestamps=None) -> int:
        """Route bits to shard owners; forward to all replicas
        synchronously (api.go:651-672)."""
        groups: dict[int, list[int]] = {}
        width = self.api.holder.width
        for i, c in enumerate(cols):
            groups.setdefault(int(c) // width, []).append(i)
        n = 0
        snap_box = [self.snapshot()]  # shared; refreshed on 410
        shards_touched = set()
        for shard, idxs in groups.items():
            srows = [int(rows[i]) for i in idxs]
            scols = [int(cols[i]) for i in idxs]
            stimes = ([timestamps[i] for i in idxs]
                      if timestamps is not None else None)
            n += self._import_shard_replan(
                index, shard,
                lambda node, srows=srows, scols=scols, stimes=stimes:
                self._import_to(node, index, field, srows, scols,
                                stimes),
                snap_box=snap_box)
            shards_touched.add(shard)
        self.disco.add_shards(index, "", shards_touched)
        return n

    def import_values(self, index: str, field: str, cols, values) -> int:
        groups: dict[int, list[int]] = {}
        width = self.api.holder.width
        for i, c in enumerate(cols):
            groups.setdefault(int(c) // width, []).append(i)
        n = 0
        snap_box = [self.snapshot()]  # shared; refreshed on 410
        shards_touched = set()
        for shard, idxs in groups.items():
            scols = [int(cols[i]) for i in idxs]
            svals = [values[i] for i in idxs]

            def send(node, scols=scols, svals=svals):
                if node.id == self.node_id:
                    return self.api.import_values(
                        index, field, cols=scols, values=svals)
                return self._client().import_values(
                    node.uri, index, field, scols, svals)

            n += self._import_shard_replan(index, shard, send,
                                           snap_box=snap_box)
            shards_touched.add(shard)
        self.disco.add_shards(index, "", shards_touched)
        return n

    def _import_to(self, node, index, field, rows, cols, times):
        if node.id == self.node_id:
            return self.api.import_bits(index, field, rows=rows,
                                        cols=cols, timestamps=times)
        return self._client().import_bits(node.uri, index, field, rows,
                                          cols, timestamps=times)

    def _client(self) -> InternalClient:
        if self.auth_token:
            return InternalClient(
                headers={"Authorization": f"Bearer {self.auth_token}"})
        return InternalClient()

    def apply_schema(self, schema: dict):
        """Schema changes broadcast to every node (broadcast.go
        SendSync of schema messages)."""
        self.disco.set_schema(schema)
        for node in self.disco.nodes():
            if node.id == self.node_id:
                self.api.apply_schema(schema)
            else:
                self._client()._request(node.uri, "POST", "/schema",
                                        schema)

    # -- queries -------------------------------------------------------

    def query(self, index: str, pql: str,
              deadline_s: float | None = None,
              partial_ok: bool = False) -> dict:
        return self.executor.execute(index, pql, deadline_s=deadline_s,
                                     partial_ok=partial_ok)


class _TraceProp:
    """Per-query trace propagation bundle for the fan-out: the flight
    trace id + parent span name ride every node RPC as headers, and
    ``ctx`` (the caller's TraceContext, when tracing) receives the
    remote span trees so Profile=true cluster queries show per-node
    work in their own tree."""

    __slots__ = ("trace_id", "parent", "ctx")

    def __init__(self, trace_id, parent, ctx):
        self.trace_id = trace_id
        self.parent = parent
        self.ctx = ctx


class ClusterExecutor:
    """Shard fan-out over nodes + reduce over wire-format results.

    Failure plane: fan-out RPCs hedge to the next live
    replica once they outlast a delay derived from flight-recorder
    p99s (first response wins), an optional end-to-end deadline clamps
    every attempt's budget, and a durably-down shard subset either
    sheds the query with a typed 503 (:class:`LoadShedError`) or — for
    Count/TopN with ``partial_ok`` — serves the live subset with the
    missing shards flagged in the response."""

    def __init__(self, node: ClusterNode):
        self.node = node

    @staticmethod
    def _is_extract_of_sort(call) -> bool:
        return (call.name == "Extract" and call.children
                and call.children[0].name == "Sort")

    @staticmethod
    def _hedge_delay() -> float | None:
        """Seconds before a fan-out RPC hedges to the next replica,
        or None (disabled).  ``configure(hedge_ms=)``: negative
        disables, 0 auto-derives (derive_hedge_delay_s), positive
        fixes the delay.  The derived value is cached for 1 s — it
        moves slowly, and the 512-record ring scan + sort must not
        run on every fan-out (or per failover re-plan)."""
        global _HEDGE_CACHE
        v = _HEDGE_MS
        if v < 0:
            return None
        if v > 0:
            return v / 1e3
        now = time.monotonic()
        cached = _HEDGE_CACHE
        if cached is not None and now - cached[0] < 1.0:
            return cached[1]
        d = derive_hedge_delay_s()
        _HEDGE_CACHE = (now, d)
        return d

    @staticmethod
    def _default_deadline() -> Deadline | None:
        v = _DEADLINE_S
        return Deadline(v) if v > 0 else None

    @staticmethod
    def _trace_prop(fl) -> _TraceProp | None:
        """Build the fan-out's trace-propagation bundle: the flight
        trace id (this fan-out's record, or an enclosing one), plus
        the caller's open tracing context when Profile=true."""
        from pilosa_tpu_torch.obs import tracing as _tr
        tid = (fl["trace_id"] if fl is not None
               else flight.current_trace_id())
        ctx = _tr.capture_context()
        if tid is None and ctx is None:
            return None
        parent = (ctx.parent.name
                  if ctx is not None and ctx.parent is not None
                  else None)
        return _TraceProp(tid, parent, ctx)

    def _local_leg(self, index, pql, shards, tprop):
        """The coordinator's own shard group, executed like a remote
        leg observability-wise: the query inherits the fan-out's
        trace id (its flight record merges by id), and its span tree
        is captured and stored as this node's lane — symmetric with
        what remote nodes return in their response trailer."""
        if tprop is None or tprop.trace_id is None:
            return self.node.api.query(index, pql, shards=shards)
        with flight.remote_leg(tprop.trace_id) as (tracer, spans):
            out = self.node.api.query(index, pql, shards=shards)
        if spans:
            # anchor on the live root's absolute start (wire spans
            # carry only relative offsets)
            flight.note_node_spans(self.node.node_id, spans,
                                   tracer.roots[0].start)
        return out

    def _graft_remote_trace(self, out, node_id, tprop, t0):
        """Pop a remote response's "trace" trailer and graft it: into
        the flight record's node lanes always, and into the caller's
        span tree when one is open (Profile=true).  Anchored at the
        attempt's departure on the caller clock — the honest
        alignment without cross-host clock sync."""
        if not isinstance(out, dict):
            return
        tr = out.pop("trace", None)
        if not tr or tprop is None:
            return
        spans = tr.get("spans") or ()
        if not spans:
            return
        node = str(tr.get("node") or node_id)
        flight.note_node_spans(node, list(spans), t0)
        if tprop.ctx is not None:
            from pilosa_tpu_torch.obs import tracing as _tr
            for w in spans:
                tprop.ctx.attach(_tr.span_from_wire(w, t0))

    def execute(self, index: str, pql: str,
                deadline_s: float | None = None,
                partial_ok: bool = False) -> dict:
        """``deadline_s`` bounds the whole query end to end (every
        attempt/hedge/retry budgets from its remainder); ``partial_ok``
        opts Count/TopN/TopK queries into shard-subset answers when
        shards are durably down — the response then carries
        ``{"partial": {"missing_shards": [...]}}``."""
        q = parse(pql)
        deadline = (Deadline(deadline_s) if deadline_s
                    else self._default_deadline())
        if any(c.name in _WRITE_CALLS or self._is_extract_of_sort(c)
               or c.name == "Sort" for c in q.calls):
            # writes route per-call by placement (api.go:651-672);
            # Extract(Sort(...)) needs the order-preserving split and
            # Sort needs its offset hoisted to the merge — mixed
            # queries evaluate call-by-call in order
            return {"results": [self._execute_call(index, c, deadline)
                                for c in q.calls]}
        snap = self.node.snapshot()
        shards = sorted(self.node.disco.shards(index, ""))
        if not shards:
            # no data imported through the cluster path: run locally
            return self.node.api.query(index, pql)
        partial = partial_ok and all(c.name in _PARTIAL_OK_CALLS
                                     for c in q.calls)
        # flight record for the fan-out (begin() no-ops when nested
        # under a serving-layer record): per-node attempt timings land
        # in the record's `attempts` field for /debug/queries
        fl = flight.begin(index, pql)
        tprop = self._trace_prop(fl)
        t0 = time.perf_counter()
        err = None
        try:
            missing: set[int] = set()
            partials = self._fan_out(snap, index, pql, shards,
                                     deadline=deadline, partial=partial,
                                     missing=missing, tprop=tprop)
            # reduce call-by-call across nodes (streaming reduceFn);
            # partial mode with EVERY shard missing reduces to the
            # call's zero value, never a meaningless None
            results = []
            for ci in range(len(q.calls)):
                vals = [p[ci] for p in partials]
                results.append(_reduce(q.calls[ci], vals) if vals
                               else _empty_result(q.calls[ci]))
            out = {"results": results}
            if missing:
                # explicit degradation flag: the caller can tell a
                # partial Count from a complete one
                out["partial"] = {"missing_shards": sorted(missing)}
                metrics.CLUSTER_EVENTS.inc(event="partial")
            return out
        except Exception as e:
            err = f"{type(e).__name__}: {e}"
            raise
        finally:
            flight.commit(fl, time.perf_counter() - t0,
                          route="cluster", error=err)

    def _execute_call(self, index: str, call, deadline=None) -> object:
        """Execute ONE call with placement-aware routing."""
        if call.name not in _WRITE_CALLS:
            if self._is_extract_of_sort(call):
                return extract_of_sort_wire(
                    call, lambda c: self._execute_call(index, c,
                                                       deadline))
            shipped = call
            if call.name == "Sort":
                shipped = _sort_call_for_shipping(call)
            snap = self.node.snapshot()
            shards = sorted(self.node.disco.shards(index, ""))
            if not shards:
                return self.node.api.query(index, call.to_pql())["results"][0]
            partials = self._fan_out(snap, index, shipped.to_pql(),
                                     shards, deadline=deadline)
            return _reduce(call, [p[0] for p in partials])
        if call.name in ("Set", "Clear"):
            return self._execute_col_write(index, call,
                                           deadline=deadline)
        # Store/ClearRow/Delete touch every shard of the index: run on
        # every live node against its local shards, reduce with any().
        # Same failover contract as _execute_col_write: a node dying
        # mid-write is marked DOWN and skipped; its shards' replicas
        # on surviving nodes still apply the write.
        snap = self.node.snapshot()
        vals = []
        last_err = None
        for n in snap.nodes:
            if n.state != NodeState.STARTED:
                continue
            try:
                vals.append(self._run_on(snap, n.id, index,
                                         call.to_pql(),
                                         deadline=deadline))
            except _NET_ERRORS as e:
                if isinstance(e, DeadlineExceeded):
                    raise
                # write skip -> DOWN on ANY net error: the mark is the
                # resync trigger (see _import_replicated)
                last_err = e
                self.node.disco.set_state(n.id, NodeState.DOWN)
        if not vals:
            raise ClusterError(
                f"no live node accepted {call.name}: {last_err}")
        return _reduce(call, vals)

    def _execute_col_write(self, index: str, call,
                           deadline=None) -> object:
        """Set/Clear: route to the column's shard owner + replicas and
        register the shard (the write half of executor.mapReduce +
        api.ImportRoaringShard's replica forwarding)."""
        col = call.arg("_col")
        if isinstance(col, str):
            # String column keys translate on the key-partition OWNER
            # (translate.go:103 partitioned stores): every node routes
            # the same key to the same store, so key->id assignment is
            # consistent cluster-wide; the call then ships BY ID.
            col = self._translate_col_key(index, col,
                                          deadline=deadline)
            if col is None:
                return self.node.api.query(index, call.to_pql())["results"][0]
            call = type(call)(name=call.name,
                              args={**call.args, "_col": int(col)},
                              children=call.children)
        shard = int(col) // self.node.api.holder.width
        last_err = None
        moved_err = None
        written: set[str] = set()
        vals: list = []
        for attempt in range(5):
            snap = self.node.snapshot()
            owners = [n for n in snap.shard_nodes(index, shard)
                      if n.id not in written]
            if vals and not owners:
                self.node.disco.add_shards(index, "", {shard})
                return _reduce(call, vals)
            if vals:
                metrics.CLUSTER_EVENTS.inc(event="late_owner")
            got = []
            moved_err = None
            for n in owners:
                try:
                    got.append(self._run_on(snap, n.id, index,
                                            call.to_pql(),
                                            deadline=deadline))
                except ShardMovedError as e:
                    # ownership flipped under this replica mid-write:
                    # skip it — the other owners (dual/recipient)
                    # still carry the write, else re-plan below
                    moved_err = e
                except RemoteError as e:
                    if e.status == 410:
                        moved_err = e
                        continue
                    raise
                except _NET_ERRORS as e:
                    if isinstance(e, DeadlineExceeded):
                        raise
                    # a failing replica doesn't fail the write as
                    # long as one owner acks it; DOWN on ANY net
                    # error because the mark is the resync trigger
                    # (see _import_replicated)
                    last_err = e
                    self.node.disco.set_state(n.id, NodeState.DOWN)
            if moved_err is not None:
                # a fence skipped at least one routed owner: even with
                # another replica's ack in hand the write must RE-PLAN
                # against a fresh snapshot — the fenced (authoritative,
                # about-to-be-chased) copy missed it, so settling for
                # the partial ack would lose the write on the new
                # owner.  Set/Clear re-apply idempotently on replicas
                # that already took it.
                written, vals = set(), []
                time.sleep(0.01 * (attempt + 1))
                continue
            if not vals and not got:
                break
            # the answer is the routed owners' acks; owners that the
            # next snapshot adds (see _import_shard_replan) take the
            # same write, and their acks are duplicates
            vals = vals or got
            written.update(n.id for n in owners)
        if vals:
            self.node.disco.add_shards(index, "", {shard})
            return _reduce(call, vals)
        if moved_err is not None:
            raise moved_err
        raise ClusterError(
            f"no live replica accepted write for shard {shard}: "
            f"{last_err}")

    def _translate_col_key(self, index: str, key: str, deadline=None):
        """Create the key on its partition owner's store; returns the
        id, or None when the index has no column-key translation."""
        idx = self.node.api.holder.index(index)
        if idx is None or idx.column_translator is None:
            return None
        snap = self.node.snapshot()
        owners = snap.key_nodes(index, key)
        owner = next((n for n in owners
                      if n.state == NodeState.STARTED),
                     owners[0] if owners else None)
        if owner is None or owner.id == self.node.node_id:
            return idx.column_translator.create_keys(key)[key]
        # /internal/translate returns ids aligned with the keys list
        got = self.node._client().create_keys(owner.uri, index, None,
                                              [key], deadline=deadline)
        return got[0]

    def _run_on(self, snap, node_id: str, index: str, pql: str,
                deadline=None):
        # remote=True everywhere: routed calls carry pre-translated ids
        if node_id == self.node.node_id:
            return self.node.api.query(index, pql,
                                       remote=True)["results"][0]
        node = snap.node(node_id)
        return self.node._client().query_node(
            node.uri, index, pql, None,
            deadline=deadline)["results"][0]

    def _fan_out(self, snap, index, pql, shards, attempts: int = 3,
                 deadline=None, partial: bool = False,
                 missing: set | None = None,
                 avoid: set | None = None,
                 tprop: _TraceProp | None = None) -> list[list]:
        """Group shards by owner and execute; when a node fails,
        re-plan ONLY its shards against the remaining live replicas —
        per-shard failover, never running a shard on a node that
        doesn't own a replica of it (executor.go:6505-6518).  Remote
        groups hedge to the next replica past the hedge delay
        (``_remote``).

        DOWN marking is deliberately split from rerouting: only a
        DEFINITIVE connection failure (refused/reset — the node's
        socket is gone) marks the node DOWN cluster-wide; a timeout
        merely adds it to this query's ``avoid`` set and reroutes.  An
        overloaded-but-alive node must not be globally shot by one
        slow query — detecting hung nodes is the heartbeat lease's
        job, with better evidence.

        ``partial``: shards with no live replica land in ``missing``
        instead of failing the query; otherwise they raise a typed
        :class:`LoadShedError`."""
        avoid = set() if avoid is None else avoid
        by_node = snap.shards_by_node(index, shards, exclude=avoid)
        partials: list[list] = []
        failed_shards: list[int] = []
        last_err = None
        hedge_s = self._hedge_delay()
        # pool workers run on their own threads: carry the caller's
        # flight accumulator over so per-node attempt notes land in
        # THIS query's record
        acc = flight.active_acc()

        def one(pool, item):
            node_id, node_shards = item
            prev = flight.push_acc(acc)
            try:
                if node_id == self.node.node_id:
                    t0 = time.perf_counter()
                    out = self._local_leg(index, pql, node_shards,
                                          tprop)
                    flight.note_attempt(node_id,
                                        time.perf_counter() - t0,
                                        "ok-local")
                    return [out["results"]]
                with pool.blocked():  # RPC wait: let the pool grow
                    return self._remote(snap, index, pql, node_id,
                                        node_shards, hedge_s,
                                        deadline, avoid, tprop)
            finally:
                flight.pop_acc(prev)

        from pilosa_tpu_torch.taskpool import Pool, TaskFailure
        jobs = sorted(by_node.items())
        pool = Pool(size=2)  # task.Pool default size (executor.go:6714)
        outs = pool.map_settled(one, jobs)
        moved_shards: list[int] = []
        for (node_id, node_shards), out in zip(jobs, outs):
            if isinstance(out, TaskFailure):
                if isinstance(out.error, DeadlineExceeded):
                    # the CALLER's budget expired — failover re-plans
                    # can only re-expire it, and blaming replicas
                    # (503 + failover metrics) would send clients
                    # retrying a query that can never finish
                    raise out.error
                if isinstance(out.error, ShardMovedError) or (
                        isinstance(out.error, RemoteError)
                        and out.error.status == 410):
                    # a rebalance flipped ownership mid-query (the
                    # one-hop client redirect only covers fully-moved
                    # legs): the node is ALIVE and still owns its
                    # other shards — re-plan this leg from a fresh
                    # snapshot, no DOWN mark, no avoid entry.  This
                    # used to surface as a phantom no-live-replica
                    # 503.
                    moved_shards.extend(node_shards)
                    continue
                if not isinstance(out.error, _NET_ERRORS):
                    raise out.error
                last_err = out.error
                avoid.add(node_id)
                if isinstance(out.error, ConnectionError):
                    # definitive death (refused/reset): cluster-wide
                    self.node.disco.set_state(node_id, NodeState.DOWN)
                metrics.CLUSTER_EVENTS.inc(event="failover")
                failed_shards.extend(node_shards)
            else:
                partials.extend(out)
        if moved_shards:
            if attempts <= 1:
                raise LoadShedError(
                    "ownership still settling for shards "
                    f"{sorted(moved_shards)[:4]} after re-plans",
                    missing_shards=moved_shards)
            snap_m = self.node.snapshot()
            partials.extend(
                self._fan_out(snap_m, index, pql, moved_shards,
                              attempts - 1, deadline=deadline,
                              partial=partial, missing=missing,
                              avoid=avoid, tprop=tprop))
        if failed_shards:
            # shards_by_node consults node state, so the DOWN mark
            # reroutes each failed shard to its next live replica; a
            # shard with no live replica keeps its dead owner, and is
            # either shed (typed 503) or flagged missing (partial)
            snap2 = self.node.snapshot()
            dead = {n.id for n in snap2.nodes
                    if n.state != NodeState.STARTED}
            durably_down = set()
            for s in failed_shards:
                owners = {n.id for n in snap2.shard_nodes(index, s)}
                if owners <= dead:
                    durably_down.add(s)
            exhausted_live = (set(failed_shards) - durably_down
                              if attempts <= 1 else set())
            if durably_down or exhausted_live:
                if not partial:
                    # both shapes shed with a retryable 503, but the
                    # text must not misdirect: exhausted retries on
                    # LIVE replicas is overload, not replica death
                    metrics.CLUSTER_EVENTS.inc(event="load_shed")
                    shed = durably_down | exhausted_live
                    what = ("replicas exhausted (live but failing)"
                            if exhausted_live else "no live replica")
                    raise LoadShedError(
                        f"{what} for shards "
                        f"{sorted(shed)[:4]}: {last_err}",
                        missing_shards=shed)
                if exhausted_live:
                    # partial mode's contract covers DURABLY DOWN
                    # shards only: overloaded-but-live replicas must
                    # shed, not silently under-count a query an
                    # immediate retry could answer completely
                    metrics.CLUSTER_EVENTS.inc(event="load_shed")
                    raise LoadShedError(
                        "replicas exhausted (live but failing) for "
                        f"shards {sorted(exhausted_live)[:4]}: "
                        f"{last_err}",
                        missing_shards=exhausted_live)
                # served-partial (degraded-but-answered) counts as
                # event="partial" once per query at response assembly
                # in execute(), not per recursion level here
                missing.update(durably_down)
                failed_shards = [s for s in failed_shards
                                 if s not in durably_down]
            if failed_shards:
                partials.extend(
                    self._fan_out(snap2, index, pql, failed_shards,
                                  attempts - 1, deadline=deadline,
                                  partial=partial, missing=missing,
                                  avoid=avoid, tprop=tprop))
        return partials

    # -- hedged remote group RPC ---------------------------------------

    def _remote(self, snap, index, pql, node_id, node_shards,
                hedge_s, deadline, avoid=frozenset(),
                tprop: _TraceProp | None = None) -> list[list]:
        """One node-group RPC, hedged: if the primary attempt outlasts
        ``hedge_s``, fire the same shards at their next live replicas
        and take whichever side answers first (the loser's response is
        discarded and its short-lived connection dropped).  Returns a
        LIST of per-node results-lists — a hedge win may span several
        replicas when the group's shards fail over to different
        owners."""
        node = snap.node(node_id)
        client = self.node._client()
        # NO client-level retry on the read fan-out — not even the
        # refused-connect retry: replica failover + hedging ARE this
        # path's retry mechanism, and same-node backoff would only
        # delay the DOWN mark that reroutes traffic (and lose the
        # hedge race, deferring the mark past the query's return)
        client.retries = 0

        def attempt(n, shards_, note_gate=None):
            # note_gate: ONE attempt row per hedged primary RPC — the
            # non-blocking acquire is the atomic first-writer-wins
            # between the primary's own completion note and the
            # hedge-win path's "outstanding" note (either alone could
            # otherwise race the other into a duplicate row)
            t0 = time.perf_counter()

            def note(outcome):
                if note_gate is None or \
                        note_gate.acquire(blocking=False):
                    flight.note_attempt(
                        n.id, time.perf_counter() - t0, outcome)

            try:
                out = client.query_node(
                    n.uri, index, pql, shards_, deadline=deadline,
                    trace_id=(tprop.trace_id if tprop is not None
                              else None),
                    span_parent=(tprop.parent if tprop is not None
                                 else None))
                self._graft_remote_trace(out, n.id, tprop, t0)
                note("ok")
                return out
            except Exception:
                note("error")
                raise

        plain = hedge_s is None
        alts: dict[str, list[int]] | None = {}
        if not plain:
            # hedge plan: next live replica per shard, primary
            # excluded — and so are this query's already-failed nodes
            # (``avoid``): a hedge aimed at the node that just timed
            # out would stall on it again instead of rescuing.  Hedge
            # ONLY when alternates cover the whole group — a
            # half-covered hedge could win with a silently partial
            # answer.
            for s in node_shards:
                owner = next(
                    (n for n in snap.shard_nodes(index, s)
                     if n.id != node_id and n.id not in avoid
                     and n.state == NodeState.STARTED), None)
                if owner is None:
                    alts = None
                    break
                alts.setdefault(owner.id, []).append(s)
        if plain or not alts:
            return [attempt(node, node_shards)["results"]]

        # the flight accumulator is thread-local: capture it so the
        # primary/hedge worker threads' attempt notes land in the
        # query's own record
        acc = flight.active_acc()

        cv = threading.Condition()
        res: dict[str, tuple] = {}
        hedge_won = threading.Event()
        marked_down = threading.Lock()
        primary_note = threading.Lock()  # one attempt row, see attempt()

        def put(tag, val, err):
            with cv:
                res[tag] = (val, err)
                cv.notify_all()

        def mark_primary_down():
            # once per RPC: the main thread's hedge-won branch and
            # run_primary's late-failure branch can BOTH observe the
            # dead primary — one failover event, not two (the
            # non-blocking acquire is the atomic first-caller-wins)
            if not marked_down.acquire(blocking=False):
                return
            self.node.disco.set_state(node.id, NodeState.DOWN)
            metrics.CLUSTER_EVENTS.inc(event="failover")

        def run_primary():
            prev = flight.push_acc(acc)
            try:
                put("p", [attempt(node, node_shards,
                                  note_gate=primary_note)["results"]],
                    None)
            except Exception as e:
                put("p", None, e)
                if hedge_won.is_set() and isinstance(e,
                                                     ConnectionError):
                    # the hedge already answered the caller, so nobody
                    # will raise this error into the failover path —
                    # mark the DEFINITIVELY dead primary DOWN here or
                    # the next query would re-discover it the slow way
                    mark_primary_down()
            finally:
                flight.pop_acc(prev)

        def run_hedge():
            prev = flight.push_acc(acc)
            try:
                outs = []
                for aid, ashards in sorted(alts.items()):
                    if aid == self.node.node_id:
                        t0 = time.perf_counter()
                        outs.append(self._local_leg(
                            index, pql, ashards, tprop)["results"])
                        flight.note_attempt(
                            aid, time.perf_counter() - t0,
                            "hedge_ok-local")
                    else:
                        outs.append(
                            attempt(snap.node(aid),
                                    ashards)["results"])
                put("h", outs, None)
            except Exception as e:
                put("h", None, e)
            finally:
                flight.pop_acc(prev)

        t_p0 = time.perf_counter()
        threading.Thread(target=run_primary, daemon=True).start()
        with cv:
            cv.wait_for(lambda: "p" in res, timeout=hedge_s)
            primary_done = "p" in res
        if primary_done:
            val, err = res["p"]
            if err is None:
                return val
            raise err  # normal failover path handles it
        metrics.CLUSTER_EVENTS.inc(event="hedge_fired")
        threading.Thread(target=run_hedge, daemon=True).start()
        # first success wins; both-failed raises the PRIMARY error so
        # the caller's failover marks the right node DOWN
        limit = client.timeout + hedge_s + 1.0
        if deadline is not None:
            limit = min(limit, max(deadline.remaining(), 0.0) + 0.5)
        end = time.monotonic() + limit
        with cv:
            while True:
                if "p" in res and res["p"][1] is None:
                    winner = "p"
                    break
                if "h" in res and res["h"][1] is None:
                    winner = "h"
                    break
                if "p" in res and "h" in res:
                    raise res["p"][1]
                rem = end - time.monotonic()
                if rem <= 0:
                    raise TimeoutError(
                        f"hedged fan-out to {node_id} timed out")
                cv.wait(rem)
        if winner == "h":
            metrics.CLUSTER_EVENTS.inc(event="hedge_won")
            hedge_won.set()
            if "p" not in res and \
                    primary_note.acquire(blocking=False):
                # the primary is STILL in flight as the hedge answers
                # the caller — its own attempt note would land after
                # the record commits and be lost.  Note it now as
                # "outstanding" so /debug/trace shows the slow
                # primary racing the hedge in parallel (the picture
                # hedging exists to produce); the gate keeps this and
                # the primary's own eventual note to ONE row
                flight.note_attempt(
                    node.id, time.perf_counter() - t_p0,
                    "outstanding")
            if "p" in res and isinstance(res["p"][1], ConnectionError):
                # the primary DEFINITIVELY failed (not just slow):
                # mark it DOWN so the next snapshot routes around it
                mark_primary_down()
        return res[winner][0]


# ----------------------------------------------------------------------
# cross-node reducers over serialized results
# ----------------------------------------------------------------------

def _sort_call_for_shipping(call):
    """Rewrite a Sort for per-node execution: nodes must NOT apply the
    offset (each would drop its own head rows — wrong rows globally);
    they return the top (offset+limit) instead and the merge reduce
    applies the original offset/limit once (the same hoist the SQL
    layer does for its Sort pushdown, sql/engine.py)."""
    from pilosa_tpu_torch.pql.ast import Call

    offset = int(call.arg("offset", 0) or 0)
    limit = call.arg("limit")
    if not offset and limit is None:
        return call
    args = {k: v for k, v in call.args.items()
            if k not in ("offset", "limit")}
    if limit is not None:
        args["limit"] = int(limit) + offset
    return Call("Sort", args=args, children=list(call.children))


def extract_of_sort_wire(call, run):
    """Extract keeps its Sort child's ORDER (executor.go:4762).  A
    cross-node Extract reduce cannot reconstruct it, so merge the Sort
    first (order-preserving reduce), then Extract those columns and
    reorder the wire entries to the Sort order.  `run(call)` executes
    one call and returns its wire dict — shared by the cluster
    executor and the DAX remote executor."""
    from pilosa_tpu_torch.pql.ast import Call

    sorted_row = run(call.children[0])
    cols = list(sorted_row.get("columns", []))
    table = run(Call(
        "Extract",
        children=[Call("ConstRow", args={"columns": cols})]
        + list(call.children[1:])))
    by_col = {c.get("column"): c for c in table.get("columns", [])}
    table["columns"] = [by_col[c] for c in cols if c in by_col]
    return table


def _empty_result(call):
    """Zero-value for a call over zero shards — matches what a node
    returns for an empty index (single-node semantics)."""
    name = call.name
    if name == "Count":
        return 0
    if name in ("Sum", "Min", "Max"):
        return {"value": None if name != "Sum" else 0, "count": 0}
    if name in ("TopN", "TopK", "Rows", "GroupBy"):
        return []
    if name == "Distinct":
        return {"values": []}
    return {"columns": []}


def _reduce(call, vals: list):
    call_name = call.name
    if not vals:
        return None
    if len(vals) == 1:
        return vals[0]
    first = vals[0]
    if call_name == "Count":
        return sum(vals)
    if call_name in ("Set", "Clear", "ClearRow", "Store", "Delete"):
        return any(vals)
    if call_name == "Sum":
        return {"value": sum(v["value"] or 0 for v in vals),
                "count": sum(v["count"] for v in vals)}
    if call_name in ("Min", "Max"):
        pick = min if call_name == "Min" else max
        present = [v for v in vals if v["count"] > 0]
        if not present:
            return {"value": None, "count": 0}

        def instant_key(v):
            # timestamps cross the wire as RFC3339-Z strings whose
            # LEXICOGRAPHIC order diverges from the chronological one
            # once fractions appear ('...00Z' sorts after
            # '...00.5Z'); compare instants, not strings
            if isinstance(v, str):
                from pilosa_tpu_torch.models.timeq import (
                    NsDatetime,
                    parse_time_ns,
                )
                try:
                    d = parse_time_ns(v)
                except ValueError:
                    return v
                return NsDatetime._key(d)
            return v
        best = pick((v["value"] for v in present), key=instant_key)
        return {"value": best,
                "count": sum(v["count"] for v in present
                             if v["value"] == best)}
    if call_name in ("TopN", "TopK"):
        merged: dict = {}
        for v in vals:
            for p in v:
                k = p.get("key", p.get("id"))
                if k in merged:
                    merged[k]["count"] += p["count"]
                else:
                    merged[k] = dict(p)
        out = sorted(merged.values(),
                     key=lambda p: (-p["count"], p.get("id", 0)))
        # re-apply the requested limit after the cross-node merge —
        # per-node truncation alone would return up to n*nodes pairs
        n = call.arg("n") or call.arg("k")
        if n:
            out = out[:int(n)]
        return out
    if call_name == "Rows":
        out = set()
        for v in vals:
            out.update(v)
        return sorted(out)
    if call_name == "Distinct":
        out = set()
        for v in vals:
            out.update(v["values"])
        # chronological order for wire timestamps (see Min/Max note)
        def dkey(v):
            if isinstance(v, str) and "T" in v:
                from pilosa_tpu_torch.models.timeq import (
                    NsDatetime,
                    parse_time_ns,
                )
                try:
                    return NsDatetime._key(parse_time_ns(v))
                except ValueError:
                    return v
            return v
        try:
            return {"values": sorted(out, key=dkey)}
        except TypeError:
            return {"values": sorted(out, key=str)}
    if call_name == "GroupBy":
        # a Min or Max aggregate combines by min or max (the JAX
        # coordinator adds the nodes' extremes); Sum and the counts add
        agg_call = call.arg("aggregate")
        extreme = {"Min": min, "Max": max}.get(
            getattr(agg_call, "name", None))
        merged = {}
        for v in vals:
            for g in v:
                key = tuple(sorted(
                    (d.get("field", ""), d.get("row_id"),
                     str(d.get("value"))) for d in g["group"]))
                if key in merged:
                    merged[key]["count"] += g["count"]
                    if g.get("agg") is not None and extreme is not None:
                        have = merged[key].get("agg")
                        merged[key]["agg"] = (g["agg"] if have is None
                                              else extreme(have, g["agg"]))
                    elif g.get("agg") is not None:
                        merged[key]["agg"] = (merged[key].get("agg") or 0) \
                            + g["agg"]
                    if g.get("agg_count") is not None:
                        merged[key]["agg_count"] = \
                            (merged[key].get("agg_count") or 0) \
                            + g["agg_count"]
                else:
                    merged[key] = dict(g)
        return list(merged.values())
    if call_name == "Extract":
        # disjoint shards: concatenate per-column entries, column order
        out = {"fields": first.get("fields", []), "columns": []}
        for v in vals:
            out["columns"].extend(v.get("columns", []))
        out["columns"].sort(
            key=lambda c: c.get("column", c.get("column_key", 0)))
        return out
    if call_name == "Sort":
        # k-way merge by (value, column); values arrive pre-sorted per
        # node, and offset/limit re-applies after the merge.  Two
        # stable passes (column asc, then value in the requested
        # direction) keep DESC correct for ANY comparable value type —
        # timestamps cross the wire as ISO strings, not numbers.
        pairs = []
        for v in vals:
            pairs.extend(zip(v.get("values", []), v.get("columns", [])))
        desc = bool(call.arg("sort-desc", False))
        pairs.sort(key=lambda p: p[1])
        pairs.sort(key=lambda p: p[0], reverse=desc)
        offset = int(call.arg("offset", 0) or 0)
        limit = call.arg("limit")
        end = None if limit is None else offset + int(limit)
        pairs = pairs[offset:end]
        return {"columns": [c for _, c in pairs],
                "values": [x for x, _ in pairs]}
    if isinstance(first, dict) and "columns" in first:
        # Row-like: union of column sets (+ keys when present)
        cols = set()
        keys = set()
        has_keys = False
        for v in vals:
            cols.update(v["columns"])
            if "keys" in v:
                has_keys = True
                keys.update(v["keys"])
        out = {"columns": sorted(cols)}
        if has_keys:
            out["keys"] = sorted(keys)
        return out
    return first
