"""Stateless-worker hydration — blob restore, ledger paging, prefetch.

The seed's ComputeNode loaded every assigned shard EAGERLY from the
shared snapshot dir, so a worker's corpus was bounded by what its
directive could afford to materialize.  This module makes the worker
genuinely stateless and genuinely paged:

- **Lazy hydration**: a directive only records the assignment; the
  shard materializes on FIRST TOUCH (query fan-out, routed import, or
  an explicit ``/dax/hydrate`` during migration) — snapshot restore
  from the blob manifest, blob WAL-segment replay, then live
  write-log tail replay past the blob's covered version.  Repeated
  hydrates replay only the new tail (the migration DELTA-CHASE is
  just ``ensure`` in a loop).
- **Ledger paging**: each worker accounts resident shard bytes
  against a PRIVATE device-budget ledger (memory/ledger.py — the same
  accountant the serving caches use, one instance per worker so one
  worker's working set can't eat a sibling's budget).  Pressure
  evicts the coldest resident shards BY REFERENCE (fragments drop;
  the blob tier keeps the only durable copy), so a corpus 10x over
  budget serves with eviction instead of OOM.  A single shard larger
  than the whole budget hydrates *transiently*: served, never
  retained, dropped at the next touch of anything else.
- **Prefetch warming**: every query touch bumps a per-shard access
  count; after a demand hydrate, a background warmer pulls the
  hottest still-cold assigned shards in (bounded by [dax] prefetch
  and by the ledger — warming never evicts hotter residents).

``worker-hydrate-crash`` (obs/faults.py) fires inside the hydration
seam — a worker dying mid-hydrate leaves no partial residency (the
shard stays cold and the next touch restarts from the manifest).
"""

from __future__ import annotations

import threading
import time
import weakref

from pilosa_tpu_torch.dax import settings
from pilosa_tpu_torch.dax.snapshotter import load_fragment_rows
from pilosa_tpu_torch.obs import faults, metrics

# process registry for /debug/dax: every live hydrator (weakly held —
# a closed worker drops out with its state)
_hydrators: "weakref.WeakSet[ShardHydrator]" = weakref.WeakSet()


def hydrator_payloads() -> list[dict]:
    return sorted((h.payload() for h in list(_hydrators)),
                  key=lambda p: p.get("worker", ""))


class ShardHydrator:
    """Residency manager for one ComputeNode.  Every method that
    mutates residency runs under the NODE's lock (the node calls in
    with it held; the warmer thread takes it itself) — the ledger's
    reclaim callback re-enters on the same thread and therefore must
    not retake it."""

    def __init__(self, node, blob=None, budget_bytes: int | None = None,
                 lazy: bool | None = None):
        self.node = node
        self.blob = blob
        if lazy is None:
            # default: lazy only for blob-tier workers — the legacy
            # shared-dir DAXService keeps the seed's eager semantics
            lazy = blob is not None and settings.lazy_hydrate()
        self.lazy = bool(lazy)
        budget = (settings.worker_budget_bytes()
                  if budget_bytes is None else int(budget_bytes))
        self.budget_bytes = int(budget or 0)
        self._ledger = self._client = None
        if self.budget_bytes > 0:
            from pilosa_tpu_torch.memory.ledger import Ledger
            self._ledger = Ledger(budget_bytes=self.budget_bytes)
            self._client = self._ledger.register(
                f"dax-worker:{node.address}", reclaim=self._reclaim,
                cold_ts=self._cold_ts)
        # (table, shard) -> {bytes, version, last_touch, transient}
        self._resident: dict[tuple[str, int], dict] = {}
        self._touches: dict[tuple[str, int], int] = {}
        self._hydrating: tuple[str, int] | None = None
        # shards pinned by a paged-query residency window: reclaim
        # must not evict a window member to make room for the next
        # one, or the query would execute over missing fragments
        self._pinned: set[tuple[str, int]] = set()
        self._warm_thread: threading.Thread | None = None
        self.hydrations = 0
        self.evictions = 0
        _hydrators.add(self)

    # -- residency accounting ------------------------------------------

    def _cold_ts(self) -> float:
        tss = [r["last_touch"] for r in self._resident.values()
               if r["bytes"] > 0]
        return min(tss) if tss else 0.0

    def _reclaim(self, need: int) -> int:
        """Ledger pressure: drop the coldest resident shards (the one
        mid-hydrate excepted) until ``need`` bytes freed.  Runs on
        the reserving thread with the node lock already held."""
        freed = 0
        order = sorted(
            (k for k, r in self._resident.items()
             if k != self._hydrating and k not in self._pinned
             and r["bytes"] > 0),
            key=lambda k: self._resident[k]["last_touch"])
        for key in order:
            if freed >= need:
                break
            freed += self._evict_locked(key)
        return freed

    def _evict_locked(self, key: tuple[str, int]) -> int:
        r = self._resident.pop(key, None)
        if r is None:
            return 0
        table, shard = key
        idx = self.node.api.holder.index(table)
        if idx is not None:
            for f in idx.fields.values():
                for v in f.views.values():
                    v.fragments.pop(shard, None)
        if r["bytes"] > 0 and self._client is not None:
            self._client.release(r["bytes"])
        self.evictions += 1
        self._export()
        return r["bytes"]

    def _drop_transients_locked(self, but: tuple[str, int]):
        for key in [k for k, r in self._resident.items()
                    if r.get("transient") and k != but
                    and k not in self._pinned]:
            self._evict_locked(key)

    # -- residency windows (paged query execution) ----------------------

    def pin(self, table: str, shard: int):
        self._pinned.add((table, shard))

    def unpin_all(self):
        self._pinned.clear()

    def _export(self):
        metrics.DAX_RESIDENT_SHARDS.set(
            len(self._resident), worker=self.node.address)
        cold = sum(len(s) for s in self.node.held.values()) \
            - sum(1 for k in self._resident
                  if k[1] in self.node.held.get(k[0], ()))
        metrics.DAX_COLD_SHARDS.set(max(cold, 0),
                                    worker=self.node.address)

    # -- hydration ------------------------------------------------------

    def resident(self, table: str, shard: int) -> bool:
        return (table, shard) in self._resident

    def touch(self, table: str, shard: int):
        key = (table, shard)
        self._touches[key] = self._touches.get(key, 0) + 1

    def ensure(self, table: str, shard: int, touch: bool = True,
               chase: bool = False) -> int:
        """Make (table, shard) serveable; returns the number of
        entries replayed (the DELTA-CHASE lag signal).  Resident
        shards replay only the tail appended since their last applied
        version — from the local write-log always, and from freshly
        sealed blob segments too when ``chase`` is set (the migration
        path; query touches skip the manifest read).  Node lock held
        by the caller."""
        key = (table, shard)
        if touch:
            self.touch(table, shard)
        r = self._resident.get(key)
        if r is not None:
            r["last_touch"] = time.time()
            n = 0
            if chase and self.blob is not None \
                    and settings.blob_enabled():
                n = self._chase_blob_locked(key, r)
                r = self._resident.get(key)
                if r is None:
                    # coverage gap forced a restart from the manifest
                    return n + self._hydrate_locked(table, shard)
            gap = self.node.wl.replay(table, shard,
                                      from_version=r["version"])
            for e in gap:
                self.node._apply_entry(e)
            if gap:
                r["version"] += len(gap)
                metrics.DAX_HYDRATIONS.inc(outcome="replay")
            return n + len(gap)
        return self._hydrate_locked(table, shard)

    def _chase_blob_locked(self, key: tuple[str, int], r: dict) -> int:
        """Apply blob segments sealed past the resident shard's
        applied version (a migration target watching the donor's
        hand-off uploads).  A coverage gap — the donor snapshotted
        past us and retired the segments we need — evicts so the
        caller re-hydrates from the new snapshot."""
        table, shard = key
        covered = self.blob.covered_version(table, shard)
        if covered <= r["version"]:
            return 0
        restored = self.blob.restore(table, shard)
        if restored is None:
            return 0
        _v, _snap, segs = restored
        n, at = 0, r["version"]
        for fv, tv, data in segs:
            if tv <= at:
                continue
            if fv > at:
                self._evict_locked(key)
                return n
            for e in _decode_segment(data)[at - fv:]:
                self.node._apply_entry(e)
                n += 1
            at = tv
        if at == r["version"] and at < covered:
            self._evict_locked(key)  # snapshot-only advance
            return n
        r["version"] = at
        self.node.wl.fast_forward(table, shard, at)
        if n:
            metrics.DAX_HYDRATIONS.inc(outcome="replay")
        return n

    def _hydrate_locked(self, table: str, shard: int) -> int:
        key = (table, shard)
        idx = self.node.api.holder.index(table)
        if idx is None:
            return 0
        faults.fire("worker-hydrate-crash",
                    f"{self.node.address}:{table}/{shard}")
        self._hydrating = key
        try:
            version, est_bytes, applied = 0, 0, 0
            use_blob = (self.blob is not None
                        and settings.blob_enabled())
            restored = self.blob.restore(table, shard) \
                if use_blob else None
            if restored is not None:
                version, snap_data, segs = restored
                if snap_data is not None:
                    est_bytes += self._load_snapshot(idx, shard,
                                                     snap_data)
                for _fv, _tv, data in segs:
                    est_bytes += len(data)
                    for e in _decode_segment(data):
                        self.node._apply_entry(e)
                        applied += 1
                # a fresh private write-log continues the blob's
                # absolute numbering, or the next seal would regress
                self.node.wl.fast_forward(table, shard, version)
            else:
                snap = self.node.snaps.latest(table, shard)
                if snap is not None:
                    version, blob_data = snap
                    est_bytes += self._load_snapshot(idx, shard,
                                                     blob_data)
            tail = self.node.wl.replay(table, shard,
                                       from_version=version)
            for e in tail:
                self.node._apply_entry(e)
            version += len(tail)
            retained = True
            if self._client is not None and est_bytes > 0:
                retained = self._client.reserve(est_bytes,
                                                trigger="hydrate")
            self._resident[key] = {
                "bytes": est_bytes if retained else 0,
                "version": version, "last_touch": time.time(),
                "transient": not retained}
            self.hydrations += 1
            metrics.DAX_HYDRATIONS.inc(
                outcome="full" if retained else "transient")
            self._drop_transients_locked(but=key)
            self._export()
            return applied + len(tail)
        except Exception:
            # no partial residency: a failed hydrate drops whatever
            # fragments it materialized and stays cold
            self._resident.pop(key, None)
            self._evict_fragments_only(table, shard)
            metrics.DAX_HYDRATIONS.inc(outcome="error")
            raise
        finally:
            self._hydrating = None

    def _evict_fragments_only(self, table: str, shard: int):
        idx = self.node.api.holder.index(table)
        if idx is not None:
            for f in idx.fields.values():
                for v in f.views.values():
                    v.fragments.pop(shard, None)

    def _load_snapshot(self, idx, shard: int, blob_data: bytes) -> int:
        nbytes = 0
        for (fname, view, row), words in load_fragment_rows(
                blob_data).items():
            f = idx.field(fname)
            if f is None:
                continue
            frag = f.view(view, create=True).fragment(
                shard, create=True)
            frag.set_row_words(row, words)
            nbytes += int(words.nbytes)
        return nbytes

    def note_write(self, table: str, shard: int, version: int):
        """A routed import landed (already applied by the node):
        advance the applied version so the next ensure doesn't
        re-replay it."""
        r = self._resident.get((table, shard))
        if r is not None and version > r["version"]:
            r["version"] = version

    def release(self, table: str, shard: int):
        """Directive revoked the shard: drop by reference only (the
        blob/write-log tier keeps the data)."""
        key = (table, shard)
        if key in self._resident:
            self._evict_locked(key)
        else:
            self._evict_fragments_only(table, shard)
        self._touches.pop(key, None)

    # -- blob write plane ----------------------------------------------

    def upload_snapshot(self, table: str, shard: int, version: int,
                        data: bytes):
        """Checkpoint upload (called under the node lock right after
        the local snapshot lands, so blob state is crash-consistent
        with the recorded WAL version)."""
        if self.blob is None or not settings.blob_enabled():
            return
        self.blob.put_snapshot(table, shard, version, data)
        r = self._resident.get((table, shard))
        if r is not None and version > r["version"]:
            r["version"] = version

    def seal_tail(self, table: str, shard: int) -> int:
        """Seal the live write-log tail past the blob's covered
        version as one segment object (compaction / migration
        hand-off upload point).  Returns entries sealed."""
        if self.blob is None or not settings.blob_enabled():
            return 0
        covered = self.blob.covered_version(table, shard)
        head = self.node.wl.version(table, shard)
        if head <= covered:
            return 0
        entries = self.node.wl.replay(table, shard,
                                      from_version=covered)
        self.blob.put_segment(table, shard, covered, head,
                              _encode_segment(entries))
        return len(entries)

    # -- prefetch warming ----------------------------------------------

    def kick_warm(self):
        """Start (or no-op if running) the background warmer: hydrate
        the hottest still-cold assigned shards, budget permitting."""
        n = settings.prefetch()
        if n <= 0 or not self.lazy:
            return
        t = self._warm_thread
        if t is not None and t.is_alive():
            return
        t = threading.Thread(target=self._warm_loop, args=(n,),
                             name=f"dax-warm-{self.node.address}",
                             daemon=True)
        self._warm_thread = t
        t.start()

    def _warm_candidates(self) -> list[tuple[str, int]]:
        cold = [(table, shard)
                for table, shards in self.node.held.items()
                for shard in shards
                if (table, shard) not in self._resident]
        cold.sort(key=lambda k: (-self._touches.get(k, 0), k))
        return cold

    def _warm_loop(self, n: int):
        for _ in range(n):
            with self.node._lock:
                cands = self._warm_candidates()
                if not cands:
                    return
                try:
                    self.ensure(*cands[0], touch=False)
                except Exception:
                    return  # warming is best-effort by contract
                if self._resident.get(cands[0], {}).get("transient"):
                    return  # budget full: stop pushing

    # -- surfaces -------------------------------------------------------

    def payload(self) -> dict:
        """One worker's /debug/dax + /dax/residency row."""
        resident_bytes = sum(r["bytes"]
                             for r in self._resident.values())
        return {
            "worker": self.node.address,
            "lazy": self.lazy,
            "blob": self.blob is not None,
            "budget_bytes": self.budget_bytes,
            "resident_bytes": resident_bytes,
            "pressure": (resident_bytes / self.budget_bytes
                         if self.budget_bytes else 0.0),
            "hydrations": self.hydrations,
            "evictions": self.evictions,
            "resident": sorted(
                f"{t}/{s}" for t, s in self._resident),
            "assigned": {t: sorted(s)
                         for t, s in self.node.held.items()},
        }


def _encode_segment(entries: list[dict]) -> bytes:
    import json
    return "\n".join(json.dumps(e, separators=(",", ":"))
                     for e in entries).encode()


def _decode_segment(data: bytes) -> list[dict]:
    import json
    return [json.loads(line) for line in data.decode().splitlines()
            if line.strip()]
