"""Controller — worker registry, shard-job balancer, health poller,
and the disaggregated tier's autoscaler.

Reference: dax/controller/ — RegisterNode/DeregisterNode, the
balancer spreading table-shard jobs across workers
(balancer/balancer.go), the schemar (schema store), and the Poller
that health-checks workers and triggers rebalancing when one dies
(poller/poller.go:14-60): dead worker -> its jobs reassign to
survivors -> new Directives pushed -> workers recover the shards from
snapshot + write-log.

The tier additions (this build's dax/worker.py + storage/blob.py):

- **Placement overlay**: a durable (table, shard) -> address map
  layered over jump-hash placement, so admitting or draining a worker
  moves shards ONE AT A TIME through the live-migration state
  machine instead of a big-bang directive flip.
- **Live migration** (``migrate_shard``): snapshot-copy (staged blob
  hydrate on the target, sourcing the blob manifest so a dead donor
  is a non-event) -> delta-chase (seal donor tail, chase on target,
  bounded rounds) -> fence (writers hold at the queryer) -> flip
  (overlay + directives) -> release (donor drops by reference).
- **Reconcile loop** (``reconcile_once``): watches SLO burn rate,
  per-worker ledger pressure (GET /dax/residency), and admission
  shed counts; past the scale-out threshold it admits a standby and
  migrates its jump-hash share live, past the scale-in threshold it
  drains the last-admitted worker back to standby.  Every decision
  leaves an incident-grade audit bundle (obs/incidents.py,
  dax-scale-out / dax-scale-in) with trigger signals, plan, and
  per-shard outcomes.
"""

from __future__ import annotations

import json
import threading
import time
import weakref

from pilosa_tpu_torch.cluster.client import InternalClient
from pilosa_tpu_torch.cluster.hash import jump_hash
from pilosa_tpu_torch.dax import settings
from pilosa_tpu_torch.dax.directive import Directive
from pilosa_tpu_torch.obs import faults, incidents, metrics
from pilosa_tpu_torch.storage.translate import shard_to_shard_partition

# /debug/dax roster: live controllers, weakly held
_controllers: "weakref.WeakSet[Controller]" = weakref.WeakSet()


def controller_payloads() -> list[dict]:
    return [c.debug_payload() for c in list(_controllers)]


class NoWorkersError(Exception):
    pass


def _place(table: str, shard: int, addrs: list[str]) -> str:
    """Stable shard-job placement: fnv partition -> jump hash onto the
    sorted worker list (balancer/balancer.go goal; same scheme as the
    cluster layer, disco/hasher.go:16).  Adding a shard or a worker
    moves only ~1/n of the jobs — no mass snapshot+replay churn."""
    p = shard_to_shard_partition(table, shard)
    return addrs[jump_hash(p, len(addrs))]


class Controller:
    def __init__(self, poll_interval: float = 1.0, schemar=None):
        self.workers: dict[str, str] = {}       # address -> uri
        self.standbys: dict[str, str] = {}      # warm, no assignments
        self.schema: dict = {}
        # bumped on every schema mutation (apply/drop/reload): cheap
        # cache token for schema-derived facts (queryer keyedness)
        self.schema_version = 0
        # table -> sorted shard ids registered for it
        self.tables: dict[str, set[int]] = {}
        self._versions: dict[str, int] = {}     # per-worker directive ver
        # per-worker fingerprint of the last ENACTED directive content
        # (schema + assignments): unchanged workers are skipped — the
        # api_directive.go:172 diff, lifted to the push side so a
        # rebalance only touches the workers whose jobs moved
        self._pushed: dict[str, str] = {}
        # placement overlay: (table, shard) -> address pins outranking
        # jump hash while a scale event migrates shards one at a time
        self.overlay: dict[tuple[str, int], str] = {}
        # autoscaler-admitted workers, admit order (scale-in drains
        # the most recent first)
        self._admitted: list[str] = []
        # worker mid-drain: a partial scale-in resumes THIS drain
        # instead of the generic pin-resume (which would move the
        # already-drained shards straight back)
        self._draining: str | None = None
        # write fences during migration FENCE phase: the queryer's
        # import fan-out holds on fence_wait until the flip lands
        self._fences: dict[tuple[str, int], threading.Event] = {}
        self.last_reconcile: dict = {}
        self._last_scale_ts = 0.0
        self._last_shed: float | None = None
        self._lock = threading.RLock()
        self._poll_interval = poll_interval
        self._poll_stop = threading.Event()
        self._poll_thread: threading.Thread | None = None
        self._recon_stop = threading.Event()
        self._recon_thread: threading.Thread | None = None
        self._client = InternalClient(timeout=5.0)
        # durable state (dax/controller/schemar + Transactor): every
        # registry mutation write-throughs; a restarted controller
        # reloads the world and its next rebalance is a DELTA (the
        # reloaded fingerprints skip workers whose jobs are unchanged)
        self._schemar = schemar
        if schemar is not None:
            st = schemar.load()
            self.workers = st["workers"]
            self.schema = st["schema"]
            self.schema_version += 1
            self.tables = st["tables"]
            self._versions = st["versions"]
            self._pushed = st["pushed"]
            for ix in self.schema.get("indexes", []):
                self.tables.setdefault(ix["name"], set())
            raw = schemar.load_kv("dax_overlay")
            if raw:
                self.overlay = {(t, int(s)): a
                                for t, s, a in json.loads(raw)}
            raw = schemar.load_kv("dax_standbys")
            if raw:
                self.standbys = json.loads(raw)
            raw = schemar.load_kv("dax_admitted")
            if raw:
                self._admitted = json.loads(raw)
            raw = schemar.load_kv("dax_draining")
            if raw:
                self._draining = json.loads(raw)
        _controllers.add(self)

    # -- registry ------------------------------------------------------

    def register_worker(self, address: str, uri: str):
        with self._lock:
            self.workers[address] = uri
            # a worker re-registering at the same address is FRESH
            # (restart): drop the fingerprint so the delta-push does
            # not skip its directive — atomically in the
            # schemar too, or a controller restart could reload the
            # stale fingerprint and skip the fresh worker forever
            self._pushed.pop(address, None)
            if self._schemar is not None:
                self._schemar.register_worker(
                    address, uri, self._versions.get(address, 0))
            self._rebalance_locked()

    def register_standby(self, address: str, uri: str):
        """A warm spare: health-polled, schema-less, holding nothing —
        the autoscaler's scale-out admits it into the roster."""
        with self._lock:
            self.standbys[address] = uri
            self._save_scale_state_locked()

    def deregister_worker(self, address: str):
        with self._lock:
            self._drop_worker_locked(address)
            self._rebalance_locked()

    def _drop_worker_locked(self, address: str):
        self.workers.pop(address, None)
        self._versions.pop(address, None)
        self._pushed.pop(address, None)
        if address in self._admitted:
            self._admitted.remove(address)
        # pins to a gone worker are meaningless: placement falls back
        # to jump hash over the survivors
        stale = [k for k, a in self.overlay.items() if a == address]
        for k in stale:
            del self.overlay[k]
        if self._schemar is not None:
            self._schemar.delete_worker(address)
            if stale:
                self._save_overlay_locked()
            self._save_scale_state_locked()

    def _save_overlay_locked(self):
        if self._schemar is not None:
            self._schemar.save_kv("dax_overlay", json.dumps(
                sorted([t, s, a]
                       for (t, s), a in self.overlay.items())))

    def _save_scale_state_locked(self):
        if self._schemar is not None:
            self._schemar.save_kv("dax_standbys",
                                  json.dumps(self.standbys))
            self._schemar.save_kv("dax_admitted",
                                  json.dumps(self._admitted))
            self._schemar.save_kv("dax_draining",
                                  json.dumps(self._draining))

    # -- schema (dax/controller schemar) -------------------------------

    def apply_schema(self, schema: dict):
        with self._lock:
            self.schema = schema
            self.schema_version += 1
            for ix in schema.get("indexes", []):
                self.tables.setdefault(ix["name"], set())
            if self._schemar is not None:
                self._schemar.save_schema(schema)
            self._push_directives_locked()

    def drop_table(self, table: str):
        """Remove a table fleet-wide: schema + shard jobs + fresh
        directives so workers drop their held shards."""
        with self._lock:
            self.tables.pop(table, None)
            self.schema_version += 1
            for k in [k for k in self.overlay if k[0] == table]:
                del self.overlay[k]
            if self.schema:
                self.schema = {
                    "indexes": [ix for ix in
                                self.schema.get("indexes", [])
                                if ix.get("name") != table]}
            if self._schemar is not None:
                self._schemar.drop_table(table)
                self._schemar.save_schema(self.schema)
                self._save_overlay_locked()
            self._push_directives_locked()

    def add_shards(self, table: str, shards):
        """New shards observed (ingest registers them before writing)."""
        with self._lock:
            have = self.tables.setdefault(table, set())
            new = set(map(int, shards)) - have
            if not new:
                return
            have |= new
            if self._schemar is not None:
                self._schemar.add_shards(table, new)
            self._push_directives_locked()

    def status(self) -> dict:
        """Locked snapshot for the queryer front's /dax/status."""
        with self._lock:
            return {
                "workers": sorted(self.workers),
                "standbys": sorted(self.standbys),
                "assignments": self._assignments_locked(),
                "tables": {t: sorted(s)
                           for t, s in self.tables.items()},
            }

    # -- balance (balancer/balancer.go + placement overlay) ------------

    def _owner_locked(self, table: str, shard: int,
                      addrs: list[str] | None = None) -> str:
        a = self.overlay.get((table, shard))
        if a is not None and a in self.workers:
            return a
        if addrs is None:
            addrs = sorted(self.workers)
        return _place(table, shard, addrs)

    def assignments(self) -> dict[str, dict[str, list[int]]]:
        """worker address -> {table: [shards]} under the current
        balance."""
        with self._lock:
            return self._assignments_locked()

    def _assignments_locked(self) -> dict[str, dict[str, list[int]]]:
        addrs = sorted(self.workers)
        out = {a: {} for a in addrs}
        if not addrs:
            return out
        for table, shards in sorted(self.tables.items()):
            for shard in sorted(shards):
                a = self._owner_locked(table, shard, addrs)
                out[a].setdefault(table, []).append(shard)
        return out

    def worker_for(self, table: str, shard: int) -> tuple[str, str]:
        """(address, uri) of the worker owning a shard job."""
        with self._lock:
            if not self.workers:
                raise NoWorkersError("no compute workers registered")
            a = self._owner_locked(table, shard)
            return a, self.workers[a]

    def _rebalance_locked(self):
        self._push_directives_locked()

    def _push_directives_locked(self):
        """Compute the plan under the lock, POST directives OUTSIDE it
        (a hung worker must not stall worker_for/add_shards for its
        whole HTTP timeout), then prune workers that refused."""
        import hashlib
        while True:
            plan = self._assignments_locked()
            targets = []
            for addr, asg in plan.items():
                content = hashlib.sha256(json.dumps(
                    [self.schema, asg],
                    sort_keys=True).encode()).hexdigest()
                if self._pushed.get(addr) == content:
                    continue  # nothing changed for this worker
                self._versions[addr] = self._versions.get(addr, 0) + 1
                targets.append((addr, self.workers[addr], Directive(
                    address=addr, version=self._versions[addr],
                    schema=self.schema, assignments=asg), content))
            self._lock.release()
            dead = []
            ok = []
            try:
                for addr, uri, d, content in targets:
                    try:
                        self._client._request(uri, "POST", "/directive",
                                              d.to_dict())
                        ok.append((addr, content))
                    except Exception:
                        dead.append(addr)
            finally:
                self._lock.acquire()
            for addr, content in ok:
                # the worker may have been deregistered during the
                # unlocked POST window — do not resurrect its entry
                if addr in self.workers:
                    self._pushed[addr] = content
                    if self._schemar is not None:
                        self._schemar.save_worker_state(
                            addr, self._versions.get(addr, 0),
                            content)
            if not dead:
                return
            for addr in dead:
                # a worker that can't take its directive is gone;
                # removing it reassigns its jobs to the survivors
                self._drop_worker_locked(addr)
            if not self.workers:
                return

    # -- live migration (the rebalance state machine, worker-pool form)

    def fence_wait(self, table: str, shard: int,
                   timeout: float = 10.0):
        """Writers hold here while a migration FENCE is up for the
        shard; returns immediately when no fence is set."""
        ev = self._fences.get((table, shard))
        if ev is not None:
            ev.wait(timeout)

    def _chase_round(self, table: str, shard: int, donor_uri,
                     to_uri) -> int:
        """One seal+hydrate round: the donor seals its live tail into
        a blob segment (no-op without a blob tier or a dead donor),
        the target chases it.  Returns entries the target replayed."""
        if donor_uri is not None:
            try:
                self._client._request(
                    donor_uri, "POST", "/dax/seal",
                    {"table": table, "shard": shard})
            except Exception:
                donor_uri = None  # dead donor: blob manifest suffices
        r = self._client._request(to_uri, "POST", "/dax/hydrate",
                                  {"table": table, "shard": shard})
        return int(r.get("replayed", 0))

    def migrate_shard(self, table: str, shard: int,
                      to_addr: str) -> str:
        """Move one shard job live: COPY -> DELTA-CHASE -> FENCE ->
        flip -> RELEASE.  The copy sources the blob manifest, so a
        gone donor degrades to a plain cold restore."""
        key = (table, shard)
        with self._lock:
            to_uri = self.workers.get(to_addr)
            donor = self._owner_locked(table, shard) \
                if self.workers else None
            donor_uri = self.workers.get(donor) if donor else None
        if to_uri is None:
            return "failed:unknown-target"
        if donor == to_addr:
            return "noop"
        detail = f"{table}/{shard}->{to_addr}"
        # COPY: staged hydrate on the target (snapshot + segments +
        # shared-log tail), then bounded DELTA-CHASE until the lag
        # per round is small enough to fence over
        faults.fire("scale-event-interrupted", f"{detail}:copy")
        lag = self._chase_round(table, shard, donor_uri, to_uri)
        for _ in range(settings.chase_rounds()):
            if lag <= settings.chase_lag():
                break
            faults.fire("scale-event-interrupted", f"{detail}:chase")
            lag = self._chase_round(table, shard, donor_uri, to_uri)
        faults.fire("scale-event-interrupted", f"{detail}:fence")
        ev = threading.Event()
        self._fences[key] = ev
        try:
            # pre-flip round bounds the post-flip catch-up; new
            # writers are already holding at the fence
            self._chase_round(table, shard, donor_uri, to_uri)
            faults.fire("scale-event-interrupted", f"{detail}:flip")
            # grant the recipient its post-flip assignment BEFORE the
            # overlay becomes visible to the read plane: worker_for
            # must never name an owner that has not applied the grant
            # yet, or the queryer's 409 retry loop spins against the
            # same address until the directive push lands (and can
            # exhaust its attempts under load).  The grant rides
            # OUTSIDE the lock — a hung recipient must not stall
            # worker_for — while the donor still owns and serves.
            import hashlib
            with self._lock:
                prev = self.overlay.get(key)
                self.overlay[key] = to_addr
                asg = self._assignments_locked().get(to_addr, {})
                if prev is None:
                    self.overlay.pop(key, None)
                else:
                    self.overlay[key] = prev
                content = hashlib.sha256(json.dumps(
                    [self.schema, asg],
                    sort_keys=True).encode()).hexdigest()
                self._versions[to_addr] = \
                    self._versions.get(to_addr, 0) + 1
                grant = Directive(
                    address=to_addr, version=self._versions[to_addr],
                    schema=self.schema, assignments=asg)
            self._client._request(to_uri, "POST", "/directive",
                                  grant.to_dict())
            with self._lock:
                self._pushed[to_addr] = content
                # the grant's version is durable like every push's: a
                # restarted controller that reloaded the one before it
                # would number its next directive at or below what the
                # recipient enacted, and the recipient would drop it
                # as stale (the JAX controller keeps it in memory only)
                if self._schemar is not None:
                    self._schemar.save_worker_state(
                        to_addr, self._versions[to_addr], content)
                self.overlay[key] = to_addr
                self._save_overlay_locked()
                self._push_directives_locked()
            # post-flip catch-up: any write that raced the fence
            # landed on the donor's log BEFORE its directive applied
            # (after, it 409s) — seal once more and chase it over;
            # the donor has already released the fragments, but
            # sealing reads the log, not the fragments
            self._chase_round(table, shard, donor_uri, to_uri)
        finally:
            self._fences.pop(key, None)
            ev.set()
        return "done"

    def _pending_moves_locked(self) -> list[tuple[tuple[str, int], str]]:
        """Overlay pins that disagree with jump-hash placement — the
        resumable remainder of an interrupted scale event."""
        addrs = sorted(self.workers)
        if not addrs:
            return []
        out = []
        for (t, s), a in sorted(self.overlay.items()):
            if a not in self.workers:
                continue
            want = _place(t, s, addrs)
            if want != a and s in self.tables.get(t, ()):
                out.append(((t, s), want))
        return out

    def _prune_overlay_locked(self):
        addrs = sorted(self.workers)
        done = [k for k, a in self.overlay.items()
                if addrs and _place(k[0], k[1], addrs) == a]
        for k in done:
            del self.overlay[k]
        if done:
            self._save_overlay_locked()

    # -- autoscaler (reconcile loop) -----------------------------------

    def signals(self) -> dict:
        """The reconcile inputs: worst SLO burn rate across windows,
        per-worker ledger pressure, cumulative admission/ingest shed
        count (+ delta since the last reconcile)."""
        burn = 0.0
        try:
            from pilosa_tpu_torch.obs import slo
            payload = slo.get().evaluate()
            for s in payload.get("slos", {}).values():
                for w in s.get("windows", {}).values():
                    burn = max(burn, float(w.get("burn_rate", 0.0)))
        except Exception:
            pass
        pressure = {}
        with self._lock:
            workers = dict(self.workers)
        for addr, uri in workers.items():
            try:
                r = self._client._request(uri, "GET",
                                          "/dax/residency")
                pressure[addr] = round(float(
                    r.get("pressure", 0.0)), 4)
            except Exception:
                pressure[addr] = 0.0
        shed = (metrics.ADMISSION_TOTAL.total(outcome="shed")
                + metrics.INGEST_SHED.total())
        delta = 0.0 if self._last_shed is None \
            else shed - self._last_shed
        self._last_shed = shed
        return {"burn": round(burn, 4), "pressure": pressure,
                "shed": shed, "shed_delta": delta}

    def reconcile_once(self) -> dict:
        """One autoscaler pass: resume any interrupted migration
        first, then weigh the scale thresholds.  Every decision that
        acts files a dax-scale-* incident bundle."""
        sig = self.signals()
        decision: dict = {"signals": sig, "action": "none",
                          "ts": time.time()}
        with self._lock:
            draining = self._draining
            if draining is not None and draining not in self.workers:
                self._draining = draining = None
                self._save_scale_state_locked()
            pending = [] if draining else self._pending_moves_locked()
        if draining:
            decision.update(self._scale_in(sig))
            decision["action"] = "resume-drain"
        elif pending:
            decision["action"] = "resume"
            decision["outcomes"] = self._run_moves(pending)
            with self._lock:
                self._prune_overlay_locked()
        else:
            now = time.monotonic()
            cooled = (now - self._last_scale_ts
                      >= settings.cooldown_s())
            worst_pressure = max(sig["pressure"].values(),
                                 default=0.0)
            with self._lock:
                n_workers = len(self.workers)
                has_standby = bool(self.standbys)
            if cooled and n_workers < settings.max_workers() \
                    and has_standby \
                    and (sig["burn"] >= settings.scale_out_burn()
                         or worst_pressure
                         >= settings.pressure_high()):
                decision.update(self._scale_out(sig))
                self._last_scale_ts = now
            elif cooled and n_workers > settings.min_workers() \
                    and self._admitted \
                    and sig["burn"] <= settings.scale_in_burn() \
                    and worst_pressure < settings.pressure_high():
                decision.update(self._scale_in(sig))
                self._last_scale_ts = now
        self.last_reconcile = decision
        return decision

    def _run_moves(self, moves) -> dict:
        outcomes = {}
        for (t, s), target in moves:
            try:
                outcomes[f"{t}/{s}"] = self.migrate_shard(t, s,
                                                          target)
            except Exception as e:
                outcomes[f"{t}/{s}"] = f"failed:{e}"
        return outcomes

    def admit_standby(self, address: str | None = None) -> str:
        """Move a standby (the first by name when None) into the roster
        owning nothing: every placed shard is pinned to its current
        owner FIRST, so admitting the worker moves nothing by itself —
        the moves then happen one at a time through migrate_shard's
        fenced state machine.  Returns the admitted address."""
        with self._lock:
            if address is None:
                address = sorted(self.standbys)[0]
            uri = self.standbys.pop(address)
            addrs = sorted(self.workers)
            for t, shards in self.tables.items():
                for s in shards:
                    self.overlay[(t, s)] = self._owner_locked(
                        t, s, addrs)
            self.workers[address] = uri
            self._pushed.pop(address, None)
            self._admitted.append(address)
            self._save_overlay_locked()
            self._save_scale_state_locked()
            if self._schemar is not None:
                self._schemar.register_worker(
                    address, uri, self._versions.get(address, 0))
            # the admitted worker's first directive: schema, no jobs
            self._push_directives_locked()
            return address

    def _scale_out(self, sig: dict) -> dict:
        with self._lock:
            address = self.admit_standby()
            plan = self._pending_moves_locked()
        outcomes = self._run_moves(plan)
        with self._lock:
            self._prune_overlay_locked()
        ok = all(v in ("done", "noop") for v in outcomes.values())
        outcome = "done" if ok else "partial"
        metrics.DAX_SCALE_EVENTS.inc(direction="out",
                                     outcome=outcome)
        incidents.report(
            "dax-scale-out", f"admitted {address}",
            context={"signals": sig, "admitted": address,
                     "plan": [f"{t}/{s}" for (t, s), _ in plan],
                     "outcomes": outcomes})
        return {"action": "scale-out", "worker": address,
                "outcome": outcome, "outcomes": outcomes}

    def _scale_in(self, sig: dict) -> dict:
        with self._lock:
            address = self._draining or self._admitted[-1]
            uri = self.workers.get(address)
            if uri is None:
                if address in self._admitted:
                    self._admitted.remove(address)
                self._draining = None
                self._save_scale_state_locked()
                return {"action": "scale-in",
                        "outcome": "skipped:gone"}
            self._draining = address
            self._save_scale_state_locked()
            survivors = sorted(a for a in self.workers
                               if a != address)
            moves = [((t, s), _place(t, s, survivors))
                     for t, shards in sorted(self.tables.items())
                     for s in sorted(shards)
                     if self._owner_locked(t, s) == address]
        outcomes = self._run_moves(moves)
        ok = all(v in ("done", "noop") for v in outcomes.values())
        if ok:
            with self._lock:
                self._drop_worker_locked(address)
                self.standbys[address] = uri   # back to the warm pool
                self._draining = None
                self._prune_overlay_locked()
                self._save_scale_state_locked()
                self._push_directives_locked()
        # a partial drain leaves the worker IN the roster still
        # owning the unmigrated shards — the next reconcile's
        # scale-in pass retries exactly those
        outcome = "done" if ok else "partial"
        metrics.DAX_SCALE_EVENTS.inc(direction="in", outcome=outcome)
        incidents.report(
            "dax-scale-in", f"drained {address}",
            context={"signals": sig, "drained": address,
                     "plan": [f"{t}/{s}" for (t, s), _ in moves],
                     "outcomes": outcomes})
        return {"action": "scale-in", "worker": address,
                "outcome": outcome, "outcomes": outcomes}

    def start_reconciler(self, interval: float | None = None):
        iv = settings.reconcile_interval_s() \
            if interval is None else interval
        self._recon_thread = threading.Thread(
            target=self._recon_loop, args=(iv,), daemon=True)
        self._recon_thread.start()
        return self

    def stop_reconciler(self):
        self._recon_stop.set()
        if self._recon_thread:
            self._recon_thread.join(timeout=7)

    def _recon_loop(self, interval: float):
        while not self._recon_stop.wait(interval):
            try:
                self.reconcile_once()
            except Exception:
                pass  # the reconciler must outlive one bad pass

    def debug_payload(self) -> dict:
        with self._lock:
            return {
                "workers": sorted(self.workers),
                "standbys": sorted(self.standbys),
                "admitted": list(self._admitted),
                "overlay": {f"{t}/{s}": a
                            for (t, s), a in
                            sorted(self.overlay.items())},
                "fenced": [f"{t}/{s}"
                           for t, s in sorted(self._fences)],
                "last_reconcile": self.last_reconcile,
            }

    # -- poller (dax/controller/poller/poller.go) ----------------------

    def start_poller(self):
        self._poll_thread = threading.Thread(target=self._poll_loop,
                                             daemon=True)
        self._poll_thread.start()
        return self

    def stop_poller(self):
        self._poll_stop.set()
        if self._poll_thread:
            # outlast the health-check HTTP timeout (5s): a caller
            # about to close the schemar DB must not race a poll
            # cycle still blocked on a dead worker
            self._poll_thread.join(timeout=7)

    def _poll_loop(self):
        while not self._poll_stop.wait(self._poll_interval):
            self.poll_once()

    def poll_once(self):
        """Health-check every worker (standbys included); rebalance
        away from dead ones."""
        with self._lock:
            workers = dict(self.workers)
            standbys = dict(self.standbys)
        dead = []
        dead_standbys = []
        for addr, uri in workers.items():
            try:
                self._client._request(uri, "GET", "/status")
            except Exception:
                dead.append(addr)
        for addr, uri in standbys.items():
            try:
                self._client._request(uri, "GET", "/status")
            except Exception:
                dead_standbys.append(addr)
        if dead or dead_standbys:
            with self._lock:
                for addr in dead:
                    self._drop_worker_locked(addr)
                for addr in dead_standbys:
                    self.standbys.pop(addr, None)
                if dead_standbys:
                    self._save_scale_state_locked()
                if dead:
                    self._rebalance_locked()
        return dead
