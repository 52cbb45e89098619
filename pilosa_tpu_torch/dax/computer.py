"""ComputeNode — a stateless worker serving assigned shard jobs.

Reference: dax/computer/ + api_directive.go.  A worker is an ordinary
engine node (holder + API + HTTP) whose data is entirely reconstructed
from shared storage: on receiving a Directive it diffs desired vs held
shard jobs, materializes newly assigned shards from the latest
snapshot plus the write-log tail (api_directive.go:559 loadShard), and
drops revoked ones.  All writes append to the WriteLogger BEFORE
applying locally, so worker loss never loses acknowledged writes.

The disaggregated tier generalizes loadShard into the ShardHydrator
(dax/worker.py): with a BlobStore attached the worker boots with an
EMPTY data dir and hydrates assigned shards lazily from blob manifests
on first touch, paging residency through a private device-budget ledger;
without one it keeps the seed's eager local-disk semantics bit-exact.

"Apply locally" lands the bits in host fragments (``set_row_words``
and the imports, each under the fragment's own lock, so a hydrate
beside a read never tears a row); the executor's device stacks see a
hydrated, released or re-hydrated fragment as a slot that gained or
lost its fragment and patch those lanes on the next query — recovery
is host-side log replay, the card just re-caches.  ``device`` and
``config`` go to the worker's ``Server``: None serves from the CUDA
card and raises without one, ``device="cpu"`` runs the kernels' plain
versions; the one ``config`` a ``DAXService`` hands every worker keeps
each boot's ``config.apply_all()`` from resetting the [dax] knobs.
"""

from __future__ import annotations

import threading
import time

from pilosa_tpu_torch.dax.directive import Directive
from pilosa_tpu_torch.dax.snapshotter import (
    Snapshotter,
    snapshot_fragment_rows,
)
from pilosa_tpu_torch.dax.worker import ShardHydrator
from pilosa_tpu_torch.dax.writelogger import WriteLogger
from pilosa_tpu_torch.storage.blob import BlobError


def _strip_keys(schema: dict) -> dict:
    """Worker-local schema with every keys flag cleared (ID-space
    compute; the queryer owns translation)."""
    out = {"indexes": []}
    for ix in schema.get("indexes", []):
        nix = dict(ix, keys=False)
        nix["fields"] = [
            dict(f, options=dict(f.get("options", {}), keys=False))
            for f in ix.get("fields", [])]
        out["indexes"].append(nix)
    return out


class ComputeNode:
    def __init__(self, address: str, writelogger: WriteLogger,
                 snapshotter: Snapshotter, bind: str = "127.0.0.1",
                 blob=None, lazy: bool | None = None,
                 budget_bytes: int | None = None, device=None,
                 config=None):
        from pilosa_tpu_torch.models.holder import Holder
        from pilosa_tpu_torch.server.http import Server
        self.address = address
        self.wl = writelogger
        self.snaps = snapshotter
        self.server = Server(holder=Holder(), bind=bind, device=device,
                             config=config)
        self.api = self.server.api
        self.directive_version = -1
        # table -> set of shards this worker currently serves
        self.held: dict[str, set[int]] = {}
        self._lock = threading.Lock()
        # in-flight read registration (the rebalance plane's RELEASE
        # discipline): non-paged queries execute OUTSIDE the node
        # lock, so a directive revoking a shard drains its registered
        # readers before freeing the fragments — an admitted read
        # always completes over intact data instead of racing the
        # release into a 409
        self._shard_readers: dict[tuple[str, int], int] = {}
        self._readers_cv = threading.Condition(self._lock)
        # bumped per directive-driven fragment release; a registered
        # reader seeing the epoch move under it (drain timeout only)
        # refuses its now-torn answer instead of returning it
        self._release_epoch: dict[tuple[str, int], int] = {}
        self.hyd = ShardHydrator(self, blob=blob,
                                 budget_bytes=budget_bytes, lazy=lazy)
        self.server.add_route("POST", "/directive", self._post_directive)
        self.server.add_route("POST", "/dax/import", self._post_import)
        self.server.add_route("GET", "/dax/held",
                              lambda req: {t: sorted(s) for t, s in
                                           self.held.items()})
        # the hydration plane: staged restore (migration COPY/CHASE),
        # tail seal (migration hand-off upload), residency snapshot
        # (autoscaler pressure signal + /debug/dax)
        self.server.add_route("POST", "/dax/hydrate", self._post_hydrate)
        self.server.add_route("POST", "/dax/seal", self._post_seal)
        self.server.add_route("GET", "/dax/residency",
                              lambda req: self.hyd.payload())
        # queries land on lazily-hydrated workers too: materialize the
        # touched shards before the standard handler executes
        self.server.add_route("POST", "/index/{index}/query",
                              self._post_query_hydrated,
                              admin_only=False, override=True)

    # -- lifecycle -----------------------------------------------------

    def open(self):
        self.server.start()
        self.uri = f"127.0.0.1:{self.server.port}"
        return self

    def close(self):
        self.server.close()

    # -- directive enactment (api_directive.go:19,172) -----------------

    def _post_directive(self, req):
        d = Directive.from_dict(req.json())
        self.apply_directive(d)
        return {"applied": d.version}

    def apply_directive(self, d: Directive):
        with self._lock:
            if d.version <= self.directive_version:
                return  # stale directive (api_directive.go version gate)
            if d.schema:
                # workers run in pure ID space: key translation is a
                # front-end (queryer) concern, exactly like the
                # reference's Remote=true queries shipping
                # pre-translated ids — so strip keys from the local
                # mirror and return raw row ids in results
                self.api.apply_schema(_strip_keys(d.schema))
            for table, want in d.assignments.items():
                want = set(want)
                have = self.held.get(table, set())
                self.held[table] = want
                for shard in sorted(want - have):
                    # lazy tier: record the assignment only — the
                    # shard hydrates from its blob manifest on first
                    # touch (or is already staged by a migration)
                    if not self.hyd.lazy:
                        self.hyd.ensure(table, shard, touch=False)
                for shard in sorted(have - want):
                    self._release_locked(table, shard)
            for table in list(self.held):
                if table not in d.assignments:
                    for shard in sorted(self.held[table]):
                        self._release_locked(table, shard)
                    del self.held[table]
            self.directive_version = d.version

    def _release_locked(self, table: str, shard: int):
        self._drain_readers_locked(table, shard)
        key = (table, shard)
        self._release_epoch[key] = self._release_epoch.get(key, 0) + 1
        self.hyd.release(table, shard)

    def _drain_readers_locked(self, table: str, shard: int,
                              timeout: float = 10.0):
        """Wait (bounded) for in-flight reads registered on a shard
        to finish before its fragments are freed.  `held` has already
        dropped the shard, so NEW reads 409 at entry and re-resolve;
        registered ones complete over intact data.  On timeout the
        release proceeds — the straggler's post-execution ownership
        check refuses the stale answer."""
        key = (table, shard)
        deadline = time.monotonic() + timeout
        while self._shard_readers.get(key, 0) > 0:
            left = deadline - time.monotonic()
            if left <= 0:
                break
            self._readers_cv.wait(left)

    def _load_shard(self, table: str, shard: int):
        """snapshot + write-log tail -> local fragments (kept as the
        seed's name for the eager path; the hydrator owns the logic)."""
        self.hyd.ensure(table, shard, touch=False)

    def _drop_shard(self, table: str, shard: int):
        self.hyd.release(table, shard)

    # -- hydration plane -----------------------------------------------

    def _blob_503(self, e: BlobError):
        from pilosa_tpu_torch.api import ApiError
        raise ApiError(f"blob tier unavailable: {e}",
                       getattr(e, "status", 503))

    def _post_hydrate(self, req):
        """Migration COPY/CHASE entry: materialize (or tail-replay) a
        shard, held or merely staged — returns the replay lag the
        controller's DELTA-CHASE loop watches."""
        e = req.json() or {}
        table, shard = e["table"], int(e["shard"])
        try:
            with self._lock:
                replayed = self.hyd.ensure(table, shard, touch=False,
                                           chase=True)
                version = self.wl.version(table, shard)
        except BlobError as err:
            self._blob_503(err)
        return {"replayed": replayed, "version": version,
                "resident": True}

    def _post_seal(self, req):
        e = req.json() or {}
        table, shard = e["table"], int(e["shard"])
        try:
            with self._lock:
                n = self.hyd.seal_tail(table, shard)
        except BlobError as err:
            self._blob_503(err)
        return {"sealed": n}

    def _post_query_hydrated(self, req):
        """Override of the standard PQL endpoint: hydrate the touched
        held shards first, then delegate (the request body is cached
        on the Request, so the standard handler re-reads it safely).
        Budget-bounded workers page instead: hydrating everything up
        front would let the ledger evict early shards while late ones
        load, and the query would execute over missing fragments."""
        table = req.vars.get("index", "")
        body = req.json_lenient() or {}
        shards = body.get("shards")
        held = self.held.get(table, set())
        if shards is not None:
            touch = sorted({int(s) for s in shards})
            missing = [s for s in touch if s not in held]
            if missing:
                # a migration flip can land between the queryer's
                # routing and this execution: answering with the
                # released (empty) fragments would be a silent wrong
                # partial — refuse like the write path does, and the
                # queryer re-resolves ownership and retries
                from pilosa_tpu_torch.api import ApiError
                raise ApiError(
                    f"worker {self.address} does not hold "
                    f"{table}/shards {missing}", 409)
        else:
            touch = sorted(held)
        if not touch:
            return self.server._post_query(req)
        keys = [(table, s) for s in touch]
        try:
            if self.hyd.budget_bytes > 0 and self.hyd.lazy:
                out = self._query_paged(req, table, touch, body)
                self.hyd.kick_warm()
                return out
            with self._lock:
                # re-check under the lock (a directive may have
                # landed since the fast-path check above), then
                # REGISTER the read: apply_directive drains
                # registered readers before freeing fragments, so
                # execution outside the lock still completes over
                # intact data even if ownership flips under it
                held = self.held.get(table, set())
                missing = [s for s in touch if s not in held]
                if missing:
                    from pilosa_tpu_torch.api import ApiError
                    raise ApiError(
                        f"worker {self.address} does not hold "
                        f"{table}/shards {missing}", 409)
                for s in touch:
                    self.hyd.ensure(table, s)
                epochs = {k: self._release_epoch.get(k, 0)
                          for k in keys}
                for k in keys:
                    self._shard_readers[k] = \
                        self._shard_readers.get(k, 0) + 1
        except BlobError as err:
            self._blob_503(err)
        self.hyd.kick_warm()
        try:
            out = self.server._post_query(req)
        finally:
            with self._lock:
                stale = [k for k in keys
                         if self._release_epoch.get(k, 0)
                         != epochs[k]]
                for k in keys:
                    n = self._shard_readers.get(k, 0) - 1
                    if n <= 0:
                        self._shard_readers.pop(k, None)
                    else:
                        self._shard_readers[k] = n
                self._readers_cv.notify_all()
        if stale:
            # drain-timeout backstop: the fragments were freed while
            # this read was still registered — the answer is a torn
            # partial, refuse it so the queryer re-resolves
            from pilosa_tpu_torch.api import ApiError
            gone = sorted(s for _, s in stale)
            raise ApiError(
                f"worker {self.address} does not hold {table}/shards "
                f"{gone} (released mid-query)", 409)
        return out

    def _query_paged(self, req, table: str, touch: list[int],
                     body: dict):
        """Execute the PQL over residency WINDOWS of shards — each
        window hydrated and PINNED (the ledger's reclaim skips pinned
        shards, so filling the window can only evict prior-window
        residue) — then reduce the per-window wire results with the
        same per-call reducers the queryer applies across workers.  A
        corpus 10x over the worker's budget serves bit-exact, just in
        more windows."""
        from pilosa_tpu_torch.cluster.coordinator import (
            _empty_result,
            _reduce,
        )
        from pilosa_tpu_torch.pql import parse
        from pilosa_tpu_torch.server.http import _qos_from_headers
        pql = body.get("query", "")
        remote = bool(body.get("remote"))
        qos = _qos_from_headers(req.headers)
        q = parse(pql)
        partials = []
        i = 0
        while i < len(touch):
            with self._lock:
                batch: list[int] = []
                try:
                    while i < len(touch):
                        s = touch[i]
                        self.hyd.ensure(table, s)
                        r = self.hyd._resident.get((table, s))
                        if batch and r is not None \
                                and r.get("transient"):
                            # s didn't fit alongside the pinned
                            # window: close it; s leads the next one
                            break
                        batch.append(s)
                        self.hyd.pin(table, s)
                        i += 1
                    # execute under the node lock: nothing can evict
                    # a window member mid-query
                    out = self.api.query(table, pql, batch, False,
                                         remote=remote, qos=qos)
                finally:
                    self.hyd.unpin_all()
            partials.append(out["results"])
        if not partials:
            return {"results": [_empty_result(c) for c in q.calls]}
        return {"results": [
            _reduce(q.calls[ci], [p[ci] for p in partials])
            for ci in range(len(q.calls))]}

    # -- writes: log first, then apply ---------------------------------

    def _post_import(self, req):
        e = req.json()
        table, shard = e["table"], int(e["shard"])
        with self._lock:
            if shard not in self.held.get(table, set()):
                from pilosa_tpu_torch.api import ApiError
                raise ApiError(
                    f"worker does not hold {table}/shard {shard}", 409)
            # hydrate BEFORE appending: the restore baseline must not
            # include the entry we are about to apply directly
            try:
                self.hyd.ensure(table, shard)
            except BlobError as err:
                self._blob_503(err)
            v = self.wl.append(table, shard, e)
            n = self._apply_entry(e)
            self.hyd.note_write(table, shard, v)
        return {"imported": n}

    def _apply_entry(self, e: dict) -> int:
        if e["op"] == "bits":
            return self.api.import_bits(
                e["table"], e["field"], rows=e["rows"], cols=e["cols"],
                timestamps=e.get("timestamps"))
        if e["op"] == "values":
            return self.api.import_values(
                e["table"], e["field"], cols=e["cols"],
                values=e["values"])
        if e["op"] == "clear":
            # record-level field clear (explicit NULL in an INSERT
            # tuple for bool/mutex) — logged like any write so
            # snapshot+tail recovery replays it in order
            return self.api.clear_field_columns(
                e["table"], e["field"], cols=e["cols"])
        raise ValueError(f"unknown write-log op {e['op']!r}")

    # -- snapshotting (dax/snapshotter; checkpoint = snapshot + trunc) --

    def snapshot_shard(self, table: str, shard: int):
        # under _lock vs concurrent _post_import: the recorded log
        # version must match the fragment rows exactly, or recovery
        # replays the wrong tail and drops an acknowledged write
        with self._lock:
            self._snapshot_shard_locked(table, shard)

    def _snapshot_shard_locked(self, table: str, shard: int):
        idx = self.api.holder.index(table)
        if idx is None:
            return
        version = self.wl.version(table, shard)
        rows = {}
        for f in idx.fields.values():
            for v in f.views.values():
                frag = v.fragment(shard)
                if frag is None:
                    continue
                for r in frag.row_ids:
                    rows[(f.name, v.name, r)] = frag.row_words(r)
        data = snapshot_fragment_rows(rows)
        self.snaps.write(table, shard, version, data)
        # the blob tier's upload point: the local snapshot + recorded
        # WAL version make this window crash-consistent
        self.hyd.upload_snapshot(table, shard, version, data)
