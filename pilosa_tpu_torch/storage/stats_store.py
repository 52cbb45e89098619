"""Durable statistics-catalog storage — snapshot + tail log.

The statistics catalog (obs/stats.py) must survive restarts so a
restarted node plans like a warm one.  The format is the JAX
package's ``storage/stats_store.py``, so either package reads the
other's file.
Persistence reuses the idiom proven in ``storage/translate.py``:

- an append-only JSONL **tail log** of incremental events (data-stats
  ingest notes — low rate, one line per import call, never per query);
- a **snapshot** file (``<path>.snap``) holding the full catalog
  state, written atomically via tmp + fsync + rename — it is either
  absent or complete, never torn;
- on load, a **torn final tail line** (crash mid-append) is dropped
  rather than poisoning the store, and a torn or over-threshold tail
  triggers an immediate recompaction;
- every tail event carries a monotonic sequence (``"q"``) and the
  snapshot records the highest sequence it has folded
  (``"_tail_seq"``) — a crash BETWEEN the snapshot rename and the
  tail truncation leaves the old tail behind, and without the
  watermark a reload would replay events the snapshot already
  contains (data-stats counters are additive, so they would double).

The snapshot writer consults the ``stats-snapshot`` fault point
(obs/faults.py): an armed rule writes half the tmp file and dies
before the rename, proving the catalog never serves a half-written
file — the old snapshot stays intact and the next load serves it.
"""

from __future__ import annotations

import json
import os
import threading

# tail records before the next snapshot compaction (0 disables)
DEFAULT_COMPACT_THRESHOLD = 4096


class StatsStore:
    """One catalog's on-disk state: ``<path>`` tail log +
    ``<path>.snap`` snapshot.  The catalog owns the in-memory state;
    this class only moves dicts to and from disk."""

    def __init__(self, path: str,
                 compact_threshold: int | None = None):
        self.path = path
        self.compact_threshold = (DEFAULT_COMPACT_THRESHOLD
                                  if compact_threshold is None
                                  else compact_threshold)
        self._lock = threading.Lock()
        self._log = None
        self._tail_records = 0
        self._seq = 0  # monotonic tail-event sequence (see "q")
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    @property
    def snap_path(self) -> str:
        return self.path + ".snap"

    @property
    def tail_records(self) -> int:
        return self._tail_records

    # -- load ----------------------------------------------------------

    def load(self) -> tuple[dict | None, list[dict], bool]:
        """Read the persisted state: ``(snapshot_state | None, tail
        events, torn)``.  A torn final tail line is DROPPED (the event
        never acked; replaying a half-record would poison the
        catalog); ``torn`` tells the caller to recompact immediately
        once it has replayed the surviving events.  Opens the tail log
        for appending."""
        from pilosa_tpu_torch.obs import metrics
        state = None
        folded_seq = 0
        if os.path.exists(self.snap_path):
            # tmp+rename: the snapshot is either absent or complete —
            # but FAIL OPEN on external corruption (disk damage, a
            # tool touching the file): stats are advisory telemetry
            # and must never refuse a server boot
            try:
                with open(self.snap_path) as f:
                    state = json.load(f)
                folded_seq = int(state.pop("_tail_seq", 0))
            except (ValueError, OSError):
                state = None
                folded_seq = 0
                metrics.STATS_PERSIST.inc(event="corrupt_drop")
        events: list[dict] = []
        torn = False
        if os.path.exists(self.path):
            with open(self.path) as f:
                lines = f.read().splitlines()
            last = max((i for i, ln in enumerate(lines) if ln.strip()),
                       default=-1)
            for i, line in enumerate(lines):
                line = line.strip()
                if not line:
                    continue
                try:
                    ev = json.loads(line)
                except ValueError:
                    if i == last:
                        # torn tail: the process died mid-append
                        torn = True
                        metrics.STATS_PERSIST.inc(event="torn_drop")
                        break
                    # corrupt NON-final line: fail open — drop the
                    # event, keep the rest, and recompact (torn=True
                    # drives it) so the damage never reloads
                    torn = True
                    metrics.STATS_PERSIST.inc(event="corrupt_drop")
                    continue
                seq = int(ev.pop("q", 0))
                self._seq = max(self._seq, seq)
                if seq and seq <= folded_seq:
                    # already folded into the snapshot: a crash
                    # between the snapshot rename and the tail
                    # truncation left this event behind — replaying
                    # it would double-count additive data stats
                    continue
                events.append(ev)
        with self._lock:
            self._seq = max(self._seq, folded_seq)
            self._log = open(self.path, "a")
            self._tail_records = len(events)
        metrics.STATS_PERSIST.inc(event="load")
        return state, events, torn

    # -- tail append ---------------------------------------------------

    def append(self, event: dict) -> None:
        """Append one incremental event to the tail log (flushed —
        the catalog's ingest notes must survive a crash up to at most
        the torn final line)."""
        from pilosa_tpu_torch.obs import metrics
        with self._lock:
            self._seq += 1
            line = json.dumps({**event, "q": self._seq}) + "\n"
            if self._log is None:
                self._log = open(self.path, "a")
            self._log.write(line)
            self._log.flush()
            self._tail_records += 1
        metrics.STATS_PERSIST.inc(event="tail")

    def tail_over_threshold(self) -> bool:
        return bool(self.compact_threshold) and \
            self._tail_records >= self.compact_threshold

    # -- snapshot compaction -------------------------------------------

    def compact(self, state: dict) -> None:
        """Write the full catalog state atomically and truncate the
        tail log.  The ``stats-snapshot`` fault seam simulates a
        crash mid-snapshot-write: half the tmp file lands, then the
        'process dies' (raise) — the rename never happens, so readers
        keep the previous complete snapshot."""
        from pilosa_tpu_torch.obs import faults, metrics
        tmp = self.snap_path + ".tmp"
        with self._lock:
            # watermark: the snapshot holds everything up to _seq, so
            # a reload can skip stale tail events a crash-between-
            # rename-and-truncate left behind
            payload = json.dumps({**state, "_tail_seq": self._seq})
            if faults.armed("stats-snapshot"):
                with open(tmp, "w") as f:
                    f.write(payload[: max(1, len(payload) // 2)])
                # fire AFTER the half-write so the rule's raise leaves
                # the torn tmp behind, like the real crash would
                faults.fire("stats-snapshot", self.path)
            with open(tmp, "w") as f:
                f.write(payload)
                f.write("\n")
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self.snap_path)
            if self._log:
                self._log.close()
            self._log = open(self.path, "w")  # truncate replayed tail
            self._tail_records = 0
        metrics.STATS_PERSIST.inc(event="snapshot")

    def close(self):
        with self._lock:
            if self._log:
                self._log.close()
                self._log = None
