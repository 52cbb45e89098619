"""Streaming write plane — crash-consistent coalesced ingest windows.

The write-side analog of the serving read batcher (executor/serving.py):
concurrent mutations are admitted for a short window, coalesced per
(index, field) into ONE bulk apply — which is one delta-log append
per touched (field, shard) fragment row (models/fragment.py) feeding
one device patch on the next read (executor/stacked.py) — and ONE
WAL-checkpointed storage sync per window (storage/shards.py).  A
submit only ACKS after the window durably landed, so the reference's
durability contract holds end to end (idk/ingest.go:1062
commitRecord: offsets commit only after the downstream batch lands;
no acknowledged record is ever lost, and a crashed ingester resumes
from the last committed offset):

- **ack ⇒ durable**: the window's RBF write transactions fsynced
  their WAL frames before any submitter unblocked (``sync=True``);
- **crash ⇒ replay, exactly-once observable**: a window that dies at
  any seam (delta-log append, WAL sync, checkpoint, offset commit —
  each armed as a named fault point, obs/faults.py) never acks, the
  source re-delivers its records, and re-applying them is idempotent
  (set-bits are idempotent, BSI/mutex writes are last-write-wins), so
  the replay converges bit-exact with a cold rebuild and an acked
  batch is never double-applied *observably*.

Backpressure: admission queues are bounded per tenant (default
tenant = index), so one firehose fills only its own queue and point
writers keep landing — a shed is a typed 503 with a Retry-After hint
(:class:`WriteBacklogError`), matching the read path's load-shed
contract (cluster/coordinator.py LoadShedError).

Observability: ``pilosa_ingest_*`` metrics (window occupancy,
coalesced mutations, ack latency, sheds, replays) and one flight
record per window (route ``ingest``) at /debug/queries.

The applies go through ``Field.import_bits``/``import_values`` under
``API._import_lock`` and end in ``API.sweep_import``, so the next read
patches the resident device stacks instead of uploading them again.
On a cluster node (``api.fences`` set) a window waits out a fence
flip, forwards the mutations of shards that moved to their new owner
(``_reroute_moved``) and registers the rest in flight, so the
rebalance's drain covers it.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque

import numpy as np

from pilosa_tpu_torch.ingest.importer import Importer
from pilosa_tpu_torch.models.index import EXISTENCE_FIELD
from pilosa_tpu_torch.obs import faults, flight, metrics


class WriteBacklogError(Exception):
    """Typed 503: the write plane's admission queue is over budget —
    shed the submit instead of queueing unboundedly.  ``status`` and
    ``retry_after_s`` ride to the HTTP layer the same way the read
    path's LoadShedError does."""

    status = 503

    def __init__(self, msg: str, retry_after_s: float = 0.05):
        super().__init__(msg)
        self.retry_after_s = retry_after_s


class MutationError(Exception):
    """Typed 400: a window's apply failed on the DATA (a value the
    field can't coerce, a field/index dropped mid-window) — the
    window is poisoned and every submit in it fails with this, but
    the PLANE stays up: conflating a malformed request with a storage
    crash would let one bad client 503 every tenant until a process
    restart (a one-request DoS).  Nothing acked; a partially-applied
    group is unacked in-memory state the next landed window's sync
    persists, and re-submitting is idempotent as ever."""

    status = 400

    def __init__(self, cause: BaseException):
        super().__init__(f"window rejected: "
                         f"{type(cause).__name__}: {cause}")
        self.cause = cause


class StreamCrashed(Exception):
    """The write plane died mid-window (a crash fault or a real
    storage error).  Every unacked submit — in the dead window or
    still queued — fails with this; recovery is a restart + replay
    from the last committed source offsets.  503: the condition is
    retryable against a restarted plane."""

    status = 503
    retry_after_s = 1.0

    def __init__(self, cause: BaseException):
        super().__init__(f"write plane crashed: "
                         f"{type(cause).__name__}: {cause}")
        self.cause = cause


class Mutation:
    """One submitted write: bits, values, or an existence mark."""

    __slots__ = ("index", "field", "kind", "rows", "cols", "values",
                 "timestamps", "clear", "mark_exists", "tenant", "n",
                 "event", "error", "window_id", "t0")

    def __init__(self, index, field, kind, rows, cols, values,
                 timestamps, clear, mark_exists, tenant):
        self.index = index
        self.field = field
        self.kind = kind          # "bits" | "values" | "exists"
        self.rows = rows
        self.cols = cols
        self.values = values
        self.timestamps = timestamps
        self.clear = clear
        self.mark_exists = mark_exists
        self.tenant = tenant
        self.n = len(cols)
        self.event = threading.Event()
        self.error: BaseException | None = None
        self.window_id = 0
        self.t0 = time.perf_counter()


class StreamWriter:
    """The coalescing write-plane front: bounded admission, one
    window loop thread, durable land, ack after sync."""

    def __init__(self, api, window_s: float = 0.002,
                 max_batch: int = 4096, queue_max: int = 8192,
                 tenant_queue_max: int | None = None, sync: bool = True):
        self.api = api
        self.window_s = window_s
        self.max_batch = max_batch
        self.queue_max = queue_max
        self.tenant_queue_max = (tenant_queue_max
                                 if tenant_queue_max is not None
                                 else max(1, queue_max // 2))
        self.sync = sync
        self._cond = threading.Condition()
        self._queues: dict[str, deque[Mutation]] = {}
        self._rr: deque[str] = deque()  # tenant round-robin order
        self._pending = 0
        self._thread: threading.Thread | None = None
        self._closed = False
        self._failed: BaseException | None = None
        self._window_ids = itertools.count(1)
        self._maintain_s = 0.0  # per-window maintenance attribution
        # plane-lifetime stats (the bench/smoke assertions read these)
        self.windows_landed = 0
        self.windows_failed = 0
        self.mutations_landed = 0
        self.sheds = 0
        # stall watchdog on the window drain (obs/watchdog.py) —
        # idle while parked on the condition, armed through a land;
        # in-process multi-plane tests share the name (loop identity)
        from pilosa_tpu_torch.obs import watchdog
        self.watch = watchdog.register("ingest-window")

    # -- lifecycle -----------------------------------------------------

    def start(self) -> "StreamWriter":
        with self._cond:
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._loop, daemon=True,
                    name="ingest-window-loop")
                self._thread.start()
        return self

    def close(self, timeout: float = 10.0):
        """Drain queued mutations (landing them) and stop the loop."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout)

    @property
    def failed(self) -> BaseException | None:
        return self._failed

    # -- admission -----------------------------------------------------

    def submit(self, index: str, field: str | None, rows=None,
               cols=None, values=None, timestamps=None,
               clear: bool = False, mark_exists: bool = True,
               tenant: str | None = None, wait: bool = True,
               timeout: float | None = None):
        """Admit one mutation; blocks until its window durably landed
        (``wait=False`` returns the Mutation — pair with :meth:`wait`
        to coalesce several submits into one window).  Raises
        WriteBacklogError when the tenant's queue is over budget and
        StreamCrashed when the plane is dead."""
        cols = np.asarray([] if cols is None else cols, dtype=np.int64)
        if field is None:
            kind = "exists"
            if rows is not None or values is not None:
                raise ValueError("existence mark takes columns only")
        elif values is not None:
            kind = "values"
            values = np.asarray(values)
            if len(values) != len(cols):
                raise ValueError("columns and values length mismatch")
        else:
            kind = "bits"
            rows = np.asarray([] if rows is None else rows,
                              dtype=np.int64)
            if len(rows) != len(cols):
                raise ValueError("rows and columns length mismatch")
        idx = self.api.holder.index(index)
        if idx is None:
            raise KeyError(f"index not found: {index}")
        if field is not None and idx.field(field) is None:
            raise KeyError(f"field not found: {field}")
        m = Mutation(index, field, kind, rows, cols, values,
                     timestamps, clear, mark_exists,
                     tenant if tenant is not None else index)
        self.start()
        with self._cond:
            if self._failed is not None:
                raise StreamCrashed(self._failed)
            if self._closed:
                raise RuntimeError("write plane is closed")
            q = self._queues.get(m.tenant)
            if q is None:
                q = self._queues[m.tenant] = deque()
                self._rr.append(m.tenant)
            if (len(q) >= self.tenant_queue_max
                    or self._pending >= self.queue_max):
                self.sheds += 1
                metrics.INGEST_SHED.inc(tenant=m.tenant)
                # hint: roughly how long until the backlog drains a
                # window's worth — floored at 10 ms so a zero-window
                # plane still tells the client to back off
                hint = max(0.01, self.window_s,
                           self.window_s * (self._pending
                                            / max(1, self.max_batch)))
                raise WriteBacklogError(
                    f"write backlog over budget for tenant "
                    f"{m.tenant!r} ({len(q)} queued)",
                    retry_after_s=min(hint, 5.0))
            q.append(m)
            self._pending += 1
            metrics.INGEST_QUEUE_DEPTH.set(self._pending)
            self._cond.notify_all()
        if not wait:
            return m
        self.wait([m], timeout=timeout)
        return m.n

    def wait(self, muts, timeout: float | None = None):
        """Block until every mutation landed; raises its error."""
        deadline = (None if timeout is None
                    else time.monotonic() + timeout)
        for m in muts:
            rem = (None if deadline is None
                   else max(0.0, deadline - time.monotonic()))
            if not m.event.wait(rem):
                raise TimeoutError("ingest window did not land in time")
            if m.error is not None:
                raise m.error

    # -- window loop ---------------------------------------------------

    def _loop(self):
        while True:
            self.watch.idle()  # parked waiting for work ≠ stalled
            with self._cond:
                while self._pending == 0 and not self._closed:
                    self._cond.wait()
                if self._pending == 0 and self._closed:
                    return
            # admission window: let concurrent submitters pile in so
            # the whole window pays ONE apply + ONE sync (group
            # commit); a lone submit pays at most window_s extra
            if self.window_s > 0:
                time.sleep(self.window_s)
            self.watch.stamp("drain")
            batch = self._drain()
            if batch:
                try:
                    self._land(batch)
                except BaseException as e:
                    self.watch.idle()
                    self._crash(e, batch)
                    return  # the plane is dead; restart + replay

    def _drain(self) -> list[Mutation]:
        """Take up to max_batch mutations, round-robin across tenants
        so a firehose tenant cannot monopolize a window."""
        batch: list[Mutation] = []
        with self._cond:
            while self._pending and len(batch) < self.max_batch:
                t = self._rr[0]
                self._rr.rotate(-1)
                q = self._queues.get(t)
                if q:
                    batch.append(q.popleft())
                    self._pending -= 1
            metrics.INGEST_QUEUE_DEPTH.set(self._pending)
            self._cond.notify_all()
        return batch

    def _land(self, batch: list[Mutation]):
        """Apply + sync one window, then ack.  A data error poisons
        just this window (typed 400, plane survives); any other
        exception crashes the plane (the caller handles it).  Either
        way a partially-landed window never acks."""
        t_start = time.time()
        t0 = time.perf_counter()
        wid = next(self._window_ids)
        by_index: dict[str, list[Mutation]] = {}
        for m in batch:
            m.window_id = wid
            by_index.setdefault(m.index, []).append(m)
        # chaos seam: delay rules stall the window (backpressure
        # drills); error rules crash it before anything applied
        faults.fire("ingest-window-stall",
                    ",".join(sorted(by_index)))
        phases: dict[str, float] = {}
        total_n = 0
        ta = time.perf_counter()
        self.watch.stamp("apply")
        self._maintain_s = 0.0
        try:
            for index, muts in by_index.items():
                total_n += self._apply_index(index, muts)
        except (ValueError, TypeError, KeyError) as e:
            # data-shaped failure (bad value for the field's kind,
            # field/index dropped mid-window): poison THIS window
            # only — its submits fail typed-400, the plane keeps
            # landing everyone else's.  InjectedFault and real
            # storage errors (OSError family) still crash the plane.
            self._poison(batch, e)
            return
        # cache sweep + standing-query maintenance attribute to their
        # own phase: the ingest records answer "how much of the window
        # went to landing bits vs maintaining subscribed results"
        phases["apply"] = time.perf_counter() - ta - self._maintain_s
        if self._maintain_s:
            phases["maintain"] = self._maintain_s
        if self.sync:
            ts = time.perf_counter()
            self.watch.stamp("sync")
            for index in by_index:
                idx = self.api.holder.index(index)
                if idx is not None:
                    # one WAL-checkpointed sync per window per index:
                    # every dirty fragment of the window persists in
                    # one write tx per shard file (wal-torn /
                    # crash-pre-checkpoint seams live inside)
                    idx.sync()
            phases["sync"] = time.perf_counter() - ts
        # ack: only now do submitters unblock / offsets commit
        now = time.perf_counter()
        lat = [(now - m.t0, None, None) for m in batch]
        metrics.INGEST_ACK_LATENCY.observe_batch(lat)
        for m in batch:
            m.event.set()
        self.windows_landed += 1
        self.mutations_landed += total_n
        metrics.INGEST_WINDOWS.inc(outcome="landed")
        metrics.INGEST_WINDOW_OCCUPANCY.observe(len(batch))
        metrics.INGEST_WINDOW_MUTATIONS.observe(total_n)
        metrics.INGEST_MUTATIONS.inc(total_n)
        if flight.recorder.enabled:
            phases_ms = {k: round(v * 1e3, 4)
                         for k, v in phases.items()}
            flight.recorder.record({
                "trace_id": f"w{wid:x}",
                "index": ",".join(sorted(by_index)),
                "query": f"ingest-window[{len(batch)} submits, "
                         f"{total_n} mutations]",
                "start": t_start,
                "duration_ms": round(
                    (time.perf_counter() - t0) * 1e3, 4),
                "route": "ingest",
                "batch": len(batch),
                "phases": phases_ms,
                "stack": {},
                "bytes_moved": 0,
                "mutations": total_n,
            })

    def _apply_index(self, index: str, muts: list[Mutation]) -> int:
        """Coalesce one index's mutations and apply them under the
        index import lock.  Groups split whenever a field's (kind,
        clear) changes, so set→clear→set of one bit inside a window
        keeps its arrival order; within a group, concatenation order
        preserves last-write-wins."""
        idx = self.api.holder.index(index)
        if idx is None:
            raise KeyError(f"index dropped mid-window: {index}")
        groups: list[list[Mutation]] = []
        open_group: dict[str, int] = {}  # field -> groups index
        exist_cols: list[np.ndarray] = []
        touched_fields: set[str] = set()
        shard_sets: list[np.ndarray] = []
        n = 0
        for m in muts:
            n += m.n
            if m.mark_exists and not m.clear and m.n:
                exist_cols.append(m.cols)
            if m.kind == "exists":
                continue
            gi = open_group.get(m.field)
            if gi is not None and (
                    groups[gi][0].kind != m.kind
                    or groups[gi][0].clear != m.clear):
                gi = None  # op changed: new group keeps ordering
            if gi is None:
                open_group[m.field] = len(groups)
                groups.append([m])
            else:
                groups[gi].append(m)
            touched_fields.add(m.field)
            if m.n:
                shard_sets.append(m.cols // idx.width)
        # online resharding: a fence flipping now is waited out, the
        # mutations of shards that MOVED go to the new owner's import
        # surface instead of the donor's released storage, and the
        # local rest registers in flight so the controller's drain
        # covers this window (a shard fenced after this point still
        # lands in the donor's delta log before the final chase)
        fences = getattr(self.api, "fences", None)
        fence_done = None
        if fences is not None:
            if fences.active():
                all_shards = ({int(s) for arr in shard_sets
                               for s in np.unique(arr)}
                              if shard_sets else set())
                fences.await_writable(index, all_shards)
                moved = fences.moved_map(index)
                if moved:
                    # n stays as admitted: the forwarded mutations
                    # landed too, on the new owner
                    groups, exist_cols = self._reroute_moved(
                        idx, index, groups, exist_cols, moved)
            # unconditional on a cluster node (as api._fence_import): a
            # window admitted just before a fence arms must already be
            # visible to the drain
            tok = fences.enter_write(index, set())
            fence_done = lambda: fences.exit_write(tok)  # noqa: E731
        try:
            self._apply_groups(idx, index, groups, exist_cols,
                               touched_fields)
        finally:
            if fence_done is not None:
                fence_done()
        # narrowed result-cache sweep: exactly the (field, shard)
        # slices this window dirtied (shared with the API import paths)
        shards = None
        if shard_sets:
            u = np.unique(np.concatenate(shard_sets))
            shards = ({int(s) for s in u} if u.size <= 256 else None)
        tm = time.perf_counter()
        self.api.sweep_import(index, touched_fields, shards=shards)
        self._maintain_s += time.perf_counter() - tm
        return n

    def _reroute_moved(self, idx, index: str, groups, exist_cols,
                       moved: dict):
        """Split every group's columns on the moved-shard table
        (shard -> (owner id, owner uri)): the moved subsets go to their
        new owner over the node-to-node transport (whose import marks
        existence and acks there), the rest applies here.  A failed
        forward fails the window (its submitters get the error, and a
        client's retry routes against the settled placement)."""
        from pilosa_tpu_torch.cluster.client import InternalClient
        client = InternalClient()
        moved_shards = np.asarray(sorted(moved), dtype=np.int64)
        kept_groups: list = []
        try:
            for group in groups:
                kept = []
                for m in group:
                    if not m.n:
                        kept.append(m)
                        continue
                    shard_of = m.cols // idx.width
                    mask = np.isin(shard_of, moved_shards)
                    if not mask.any():
                        kept.append(m)
                        continue
                    for s in np.unique(shard_of[mask]):
                        _owner_id, owner_uri = moved[int(s)]
                        sel = shard_of == s
                        if m.kind == "values":
                            client.import_values(
                                owner_uri, index, m.field, m.cols[sel],
                                np.asarray(m.values)[sel].tolist(),
                                clear=m.clear)
                        else:
                            tss = None
                            if m.timestamps is not None:
                                tss = [m.timestamps[i]
                                       for i in np.flatnonzero(sel)]
                            client.import_bits(
                                owner_uri, index, m.field, m.rows[sel],
                                m.cols[sel], timestamps=tss,
                                clear=m.clear)
                    keep = ~mask
                    if keep.any():
                        m.cols = m.cols[keep]
                        if m.kind == "values":
                            m.values = np.asarray(m.values)[keep]
                        else:
                            m.rows = m.rows[keep]
                            if m.timestamps is not None:
                                m.timestamps = [m.timestamps[i] for i
                                                in np.flatnonzero(keep)]
                        kept.append(m)
                if kept:
                    kept_groups.append(kept)
            kept_exist: list[np.ndarray] = []
            for arr in exist_cols:
                shard_of = arr // idx.width
                mask = np.isin(shard_of, moved_shards)
                if not mask.any():
                    kept_exist.append(arr)
                    continue
                for s in np.unique(shard_of[mask]):
                    _owner_id, owner_uri = moved[int(s)]
                    sel = arr[shard_of == s]
                    try:
                        client.import_bits(owner_uri, index,
                                           EXISTENCE_FIELD,
                                           [0] * len(sel), sel)
                    except Exception:
                        # a bare existence mark for a shard the new
                        # owner has not made yet: its next real write
                        # there marks it anyway
                        pass
                if (~mask).any():
                    kept_exist.append(arr[~mask])
        except ValueError:
            raise
        except Exception as e:
            raise ValueError(f"moved-shard forward failed: {e}") from e
        return kept_groups, kept_exist

    def _apply_groups(self, idx, index: str, groups, exist_cols,
                      touched_fields: set) -> None:
        with self.api._import_lock(index):
            for group in groups:
                f = idx.field(group[0].field)
                if f is None:
                    raise KeyError(
                        f"field dropped mid-window: {group[0].field}")
                kind, clear = group[0].kind, group[0].clear
                cols = np.concatenate([m.cols for m in group]) \
                    if len(group) > 1 else group[0].cols
                if kind == "values":
                    vals = np.concatenate(
                        [np.asarray(m.values) for m in group]) \
                        if len(group) > 1 else group[0].values
                    f.import_values(cols, vals, clear=clear)
                else:
                    rows = np.concatenate([m.rows for m in group]) \
                        if len(group) > 1 else group[0].rows
                    tss = None
                    if any(m.timestamps is not None for m in group):
                        tss = []
                        for m in group:
                            tss.extend(m.timestamps
                                       if m.timestamps is not None
                                       else [None] * m.n)
                    f.import_bits(rows, cols, timestamps=tss,
                                  clear=clear)
            if exist_cols:
                idx.mark_columns_exist(np.concatenate(exist_cols))
                touched_fields.add(EXISTENCE_FIELD)

    def _poison(self, batch: list[Mutation], e: BaseException):
        """Fail one window's mutations on a data error; the plane
        stays up and the queues keep draining."""
        self.windows_failed += 1
        metrics.INGEST_WINDOWS.inc(outcome="poisoned")
        err = MutationError(e)
        for m in batch:
            m.error = err
            m.event.set()

    def _crash(self, e: BaseException, batch: list[Mutation]):
        """The window died: fail its mutations, everything queued,
        and every future submit — the plane models a dead process
        whose recovery is restart + replay."""
        self.windows_failed += 1
        metrics.INGEST_WINDOWS.inc(outcome="failed")
        with self._cond:
            self._failed = e
            queued = [m for q in self._queues.values() for m in q]
            self._queues.clear()
            self._rr.clear()
            self._pending = 0
            metrics.INGEST_QUEUE_DEPTH.set(0)
            self._cond.notify_all()
        err = StreamCrashed(e)
        for m in batch + queued:
            if not m.event.is_set():
                m.error = err
                m.event.set()
        from pilosa_tpu_torch.obs.monitor import capture_exception
        capture_exception(e, where="ingest.window")
        # incident trigger (obs/incidents.py): the write plane dying
        # is the canonical restart-and-replay event — bundle the
        # stacks/flight/metrics state the post-mortem needs
        from pilosa_tpu_torch.obs import incidents
        incidents.report("ingest-crash", detail=type(e).__name__,
                         context={"message": str(e)[:300],
                                  "batch": len(batch),
                                  "queued": len(queued)})


class StreamImporter(Importer):
    """Importer over the write plane: every import rides a coalesced
    window and returns only after it durably landed — so a Pipeline
    committing source offsets after ``Batch.flush`` is committing
    after the land, which is the whole exactly-once contract."""

    def __init__(self, api, writer: StreamWriter,
                 tenant: str | None = None):
        self.api = api
        self.writer = writer
        self.tenant = tenant

    def import_bits(self, index, field, rows, cols, timestamps=None,
                    clear=False, mark_exists=True):
        return self.writer.submit(index, field, rows=rows, cols=cols,
                                  timestamps=timestamps, clear=clear,
                                  mark_exists=mark_exists,
                                  tenant=self.tenant)

    def import_values(self, index, field, cols, values, clear=False,
                      mark_exists=True):
        return self.writer.submit(index, field, cols=cols,
                                  values=values, clear=clear,
                                  mark_exists=mark_exists,
                                  tenant=self.tenant)

    def mark_columns_exist(self, index, cols):
        self.writer.submit(index, None, cols=cols,
                           tenant=self.tenant)

    def create_keys(self, index, field, keys):
        # key translation is append-only and its own durable log
        # (storage/translate.py) — it does not ride windows
        ids = self.api.translate_keys(index, field, keys, create=True)
        return dict(zip(keys, ids))

    def apply_schema(self, schema):
        self.api.apply_schema(schema)

    def sync(self, index):
        """No-op: an acked window is already durable."""
