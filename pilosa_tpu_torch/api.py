"""API facade — every externally visible operation as one method.

The reference's ``API`` struct (api.go:45), the one entry point the
HTTP and gRPC handlers call: Query (api.go:209), schema CRUD
(api.go:254-477), the imports (api.go:618, 1438, 1771), status and
info, and key translation, over a Holder and an Executor, with the JSON
form of every result (``serialize_result``, the handler-side marshaling
of http_handler.go).  The statuses and messages of ``ApiError`` are the
JAX package's.

``API(holder)`` runs its queries on the CUDA card and raises without
one; ``device="cpu"`` runs the kernels' plain versions.  Imports go
through the models' numpy scatter and end in ``Fragment.touch``, so an
executor with resident stacks patches them, or rebuilds them by reason,
on its next query.  Imports into one index take turns (the reference's
one writer a shard); key translation runs outside that lock.

``query(..., profile=True)`` returns the query's span tree beside its
results, and a query slower than ``long_query_time`` seconds (0, the
default, turns the log off) is kept with its spans in
``long_queries()`` and logged through ``logger`` (a stderr logger by
default).  The imports count ``pilosa_import_total`` and
``pilosa_imported_bits_total`` by index, and ``import_bits``/
``import_values`` note each import in the statistics catalog
(``obs/stats.py``), whose record counts order SQL joins.  Queries run
through ``Executor.execute``, the solo path: a profile is that call's
spans.  ``sql`` runs statements through ``sql_engine``, a
``SQLEngine`` sharing the API's executor (and so its device stacks).
"""

from __future__ import annotations

import base64
import contextlib
import datetime as dt
import os
import struct
import threading
import time
import zlib
from concurrent.futures import ThreadPoolExecutor
from decimal import Decimal

import numpy as np

from pilosa_tpu_torch import __version__
from pilosa_tpu_torch.cluster.txn import TransactionError, TransactionManager
from pilosa_tpu_torch.executor.executor import ExecError, Executor
from pilosa_tpu_torch.executor.results import (
    DistinctValues,
    ExtractedTable,
    GroupCount,
    Pair,
    RowResult,
    SortedRow,
    ValCount,
)
from pilosa_tpu_torch.models.holder import Holder
from pilosa_tpu_torch.models.index import EXISTENCE_FIELD
from pilosa_tpu_torch.models.schema import FieldOptions
from pilosa_tpu_torch.models.timeq import ns_of
from pilosa_tpu_torch.models.view import VIEW_STANDARD
from pilosa_tpu_torch.obs import metrics
from pilosa_tpu_torch.obs import stats as _stats
from pilosa_tpu_torch.obs import tracing as _tr
from pilosa_tpu_torch.obs.logger import StderrLogger
from pilosa_tpu_torch.obs.tracing import RecordingTracer
from pilosa_tpu_torch.ops import bitmap as bm
from pilosa_tpu_torch.pql import ParseError, is_write_query
from pilosa_tpu_torch.sql import SQLEngine, SQLError
from pilosa_tpu_torch.storage import roaring


class ApiError(Exception):
    def __init__(self, msg: str, status: int = 400):
        super().__init__(msg)
        self.status = status


class QueryHistoryEntry:
    __slots__ = ("index", "query", "start", "duration")

    def __init__(self, index, query, start, duration):
        self.index = index
        self.query = query
        self.start = start
        self.duration = duration

    def to_dict(self):
        return {"index": self.index, "query": self.query,
                "start": self.start, "runtime_ns": int(self.duration * 1e9)}


class API:
    """Facade over a Holder and its Executor (api.go:45)."""

    def __init__(self, holder: Holder, device=None, name: str = "node0"):
        self.holder = holder
        self.name = name
        self.executor = Executor(holder, device)
        self.sql_engine = SQLEngine(holder, executor=self.executor)
        self.start_time = time.time()
        self._history: list[QueryHistoryEntry] = []
        self._hist_lock = threading.Lock()
        self.history_keep = 100
        # the long-query log (server.go:201 OptServerLongQueryTime): a
        # query slower than this many seconds is logged and kept with
        # its spans; 0 turns it off
        self.long_query_time: float = 0.0
        self._long_queries: list[dict] = []
        self.logger = StderrLogger()
        self._import_locks: dict[str, threading.Lock] = {}
        self._import_locks_mu = threading.Lock()
        # exclusive transactions (transaction.go:20): while one is
        # active every write answers 409
        self.txns = TransactionManager()
        # when true (the server sets it for a holder on disk), a write
        # returns only after its index's dirty rows are synced: an
        # acknowledged write survives a kill, as a streamed one does
        self.durable_writes = False
        # the online-resharding write fence (cluster/rebalance.py
        # FenceTable), which a ClusterNode installs; None on a plain
        # node, where every fence check below does nothing
        self.fences = None

    def _ack(self, index: str | None) -> None:
        """The durability barrier of ``durable_writes`` after a write:
        the index's sync, or with no index (SQL) the holder's."""
        if not self.durable_writes:
            return
        if index is None:
            self.holder.sync()
        elif self.holder.index(index) is not None:
            self.sync(index)

    def _check_writable(self) -> None:
        """Writes are refused while an exclusive transaction is active
        (transaction.go: a backup quiesces the cluster)."""
        if self.txns.exclusive_active():
            raise ApiError(
                "cluster is read-only: exclusive transaction active", 409)

    # -- the online-resharding fence seams -----------------------------------

    def _fence_import(self, index: str, cols):
        """Import admission under the fence: a MOVED shard raises the
        410 redirect (nothing applied, so re-sending to the new owner is
        safe), a FENCING shard waits out the flip, and the import
        registers in flight until its finalizer runs, so the
        controller's drain waits for it.  Returns the finalizer, or None
        on a plain node.  On a cluster node the registration is
        unconditional: a write admitted just before a fence begins must
        already be visible to the drain."""
        if self.fences is None:
            return None
        width = self.holder.width
        shards = ({int(c) // width for c in cols}
                  if cols is not None and len(cols) else set())
        tok = self.fences.enter_write(index, shards)
        return lambda: self.fences.exit_write(tok)

    def _fenced_import(self, index: str, cols):
        """The context-manager form of ``_fence_import``, the one place
        every import-shaped write takes the fence."""
        @contextlib.contextmanager
        def guard():
            done = self._fence_import(index, cols)
            try:
                yield
            finally:
                if done is not None:
                    done()
        return guard()

    def _fence_read_shards(self, index: str, shards):
        """Read admission: a MOVED shard redirects, and the read
        registers in flight so that a release cannot drop the donor's
        fragments under a running scan.  Returns the finalizer, or None
        on a plain node; unconditional on a cluster node, as above."""
        if self.fences is None:
            return None
        tok = self.fences.enter_read(index, shards)
        return lambda: self.fences.exit_read(tok)

    def _fence_write_query(self, index: str, pql: str):
        """A PQL write's fence: admit (waiting out a FENCING flip, 410
        on a MOVED shard) and register in flight.  With no fence armed
        the write registers as the index's wildcard, which every drain
        waits on, instead of parsing the PQL a second time.  Returns the
        finalizer, or None on a plain node."""
        if self.fences is None:
            return None
        shards = set()
        if self.fences.active():
            try:
                from pilosa_tpu_torch.pql import parse
                q = parse(pql) if isinstance(pql, str) else pql
                for c in q.calls:
                    col = c.args.get("_col")
                    if isinstance(col, int) and not isinstance(col, bool):
                        shards.add(col // self.holder.width)
            except Exception:
                pass  # unparseable: the executor raises its own 400
        tok = self.fences.enter_write(index, shards)
        return lambda: self.fences.exit_write(tok)

    # -- queries -----------------------------------------------------------

    def query(self, index: str, pql: str, shards: list[int] | None = None,
              profile: bool = False, remote: bool = False,
              qos=None) -> dict:
        """A PQL query (api.go:209 API.Query): {"results": [...]}, one
        serialized result a call, and with ``profile`` the span trees
        of the call under "profile" (tracing/tracing.go:22-50).  Reads
        go through ``Executor.execute_serving``: with the serving layer
        on (``executor.enable_serving``) they pass admission (``qos``,
        executor/sched.py QoS), the result cache and the micro-batcher,
        and a profiled query's span tree holds the phases its batch
        leader ran for it (tracing.capture_context / span_into).
        ``remote`` marks a coordinator's leg, whose column ids are
        already translated.  On a cluster node the query passes the
        resharding fence first."""
        t0 = time.time()
        write = is_write_query(pql)
        if write:
            self._check_writable()
            fence_done = self._fence_write_query(index, pql)
        else:
            fence_done = self._fence_read_shards(index, shards)
        tracer = None
        # the long-query log records spans for every query, so a slow
        # one can show where its time went
        if profile or self.long_query_time > 0:
            tracer = RecordingTracer()
            prev = _tr.push_thread_tracer(tracer)
        try:
            results = self.executor.execute_serving(
                index, pql, shards, remote=remote, qos=qos)
        except (ExecError, ParseError, ValueError, KeyError) as e:
            raise ApiError(str(e), 400) from e
        finally:
            if tracer is not None:
                _tr.pop_thread_tracer(prev)
            if fence_done is not None:
                fence_done()
        if write:
            self._ack(index)
        resp = {"results": [serialize_result(r) for r in results]}
        if profile and tracer.roots:
            resp["profile"] = [sp.to_dict() for sp in tracer.roots]
        self._record_history(index, pql, t0, tracer)
        return resp

    def sql(self, statement: str, auth_check=None, qos=None) -> dict:
        """SQL statements (http_handler.go:1440 /sql): the last one's
        {"schema": {"fields": [...]}, "data": [...]}.  ``auth_check``,
        when set, gates each statement's table access; ``qos`` carries
        the request's admission intent to the serving arm (typed
        shed and deadline errors propagate)."""
        metrics.SQL_TOTAL.inc()
        t0 = time.time()
        wrote = []

        def guard():  # the engine calls it once when a statement writes
            self._check_writable()
            wrote.append(True)

        try:
            res = self.sql_engine.query_one(
                statement, auth_check=auth_check, write_guard=guard, qos=qos)
        except (ExecError, SQLError, ParseError, ValueError, KeyError) as e:
            raise ApiError(str(e), 400) from e
        if wrote:
            self._ack(None)
        self._record_history("", statement, t0)
        return {
            "schema": {"fields": [{"name": n, "type": t}
                                  for n, t in res.schema]},
            "data": [[_json_value(v) for v in row] for row in res.rows],
        }

    def _record_history(self, index, query, t0, tracer=None):
        dur = time.time() - t0
        e = QueryHistoryEntry(index, query, t0, dur)
        with self._hist_lock:
            self._history.append(e)
            if len(self._history) > self.history_keep:
                self._history.pop(0)
        if 0 < self.long_query_time <= dur:
            entry = e.to_dict()
            if tracer is not None and tracer.roots:
                entry["spans"] = [sp.to_dict() for sp in tracer.roots]
            with self._hist_lock:
                self._long_queries.append(entry)
                if len(self._long_queries) > self.history_keep:
                    self._long_queries.pop(0)
            self.logger.warn(
                "long query (%.1fms > %.0fms) index=%r: %s",
                dur * 1e3, self.long_query_time * 1e3, index,
                str(query)[:200])

    def long_queries(self) -> list[dict]:
        """The slow-query ring with span timings, newest first
        (/debug/long-queries)."""
        with self._hist_lock:
            return list(reversed(self._long_queries))

    def query_history(self) -> list[dict]:
        """Recent queries, newest first (http_handler.go /query-history)."""
        with self._hist_lock:
            return [e.to_dict() for e in reversed(self._history)]

    # -- schema (api.go:254-477) -------------------------------------------

    def schema(self) -> dict:
        return {"indexes": self.holder.schema()}

    def create_index(self, name: str, keys: bool = False,
                     track_existence: bool = True) -> dict:
        _validate_name(name)
        try:
            idx = self.holder.create_index(
                name, keys=keys, track_existence=track_existence)
        except ValueError as e:
            raise ApiError(str(e), 409) from e
        self.holder.save_schema()
        return idx.to_dict()

    def delete_index(self, name: str) -> None:
        if self.holder.index(name) is None:
            raise ApiError(f"index not found: {name}", 404)
        self.holder.delete_index(name)

    def create_field(self, index: str, field: str,
                     options: dict | None = None) -> dict:
        _validate_name(field)
        idx = self._index(index)
        try:
            f = idx.create_field(field, FieldOptions.from_dict(options or {}))
        except ValueError as e:
            raise ApiError(str(e), 409) from e
        self.holder.save_schema()
        return f.to_dict()

    def delete_field(self, index: str, field: str) -> None:
        idx = self._index(index)
        if idx.field(field) is None:
            raise ApiError(f"field not found: {field}", 404)
        idx.delete_field(field)
        self.holder.save_schema()

    def apply_schema(self, schema: dict) -> None:
        """POST /schema (api.go ApplySchema): create what is missing.
        Every entry is checked first, so a bad one leaves no index half
        made."""
        indexes = schema.get("indexes", [])
        try:
            for ix in indexes:
                _validate_name(ix["name"])
                for fd in ix.get("fields", []):
                    _validate_name(fd["name"])
                    FieldOptions.from_dict(fd.get("options", {}))
        except (KeyError, TypeError, ValueError, AttributeError) as e:
            raise ApiError(f"invalid schema: {e!r}", 400) from e
        for ix in indexes:
            idx = self.holder.create_index(
                ix["name"], keys=ix.get("keys", False),
                track_existence=ix.get("track_existence", True),
                ok_if_exists=True)
            for fd in ix.get("fields", []):
                idx.create_field(fd["name"],
                                 FieldOptions.from_dict(fd.get("options", {})),
                                 ok_if_exists=True)
        self.holder.save_schema()

    # -- imports (api.go:618 Import, api.go:1438 ImportValue) --------------

    # distinct-shard cap past which an import's sweep falls back to field
    # granularity (_slices_stale walks fields x views x shards)
    _SWEEP_SHARDS_MAX = 256

    def sweep_import(self, index: str, fields, cols=None,
                     shards: set | None = None,
                     mark_exists: bool = False) -> None:
        """The import-time result-cache sweep: evict exactly the serving
        cache's entries whose read set meets the (field, shard) slices a
        bulk import dirtied (entries over other shards of the fields keep
        serving), and push the landed delta through the standing
        registrations.  No-op without a serving cache; the cache's
        get-time validation backstops every write path.  ``mark_exists``
        adds the existence field, which every import that marked columns
        dirtied too."""
        serving = getattr(self.executor, "serving", None)
        if serving is None or serving.cache is None:
            return
        idx = self.holder.index(index)
        if idx is None:
            return
        fields = set(fields)
        if mark_exists:
            fields.add(EXISTENCE_FIELD)
        if shards is None and cols is not None and len(cols):
            u = np.unique(np.asarray(cols, dtype=np.int64) // idx.width)
            if u.size <= self._SWEEP_SHARDS_MAX:
                shards = {int(s) for s in u}
        serving.cache.sweep(self.holder, fields, shards)
        metrics.RESULT_CACHE.inc(outcome="write")
        serving.standing.on_write(index, fields, shards)

    def _import_lock(self, index: str) -> threading.Lock:
        with self._import_locks_mu:
            lk = self._import_locks.get(index)
            if lk is None:
                lk = self._import_locks[index] = threading.Lock()
            return lk

    def _field(self, idx, field: str):
        f = idx.field(field)
        if f is None:
            raise ApiError(f"field not found: {field}", 404)
        return f

    def import_bits(self, index: str, field: str, rows=None, cols=None,
                    row_keys=None, col_keys=None, timestamps=None,
                    clear: bool = False, mark_exists: bool = True) -> int:
        """Set (or with ``clear``, clear) the (row, column) pairs; keys
        are created as needed.  Returns the pairs set, or the bits a
        clear changed."""
        self._check_writable()
        idx = self._index(index)
        f = self._field(idx, field)
        metrics.IMPORT_TOTAL.inc(index=index)
        rows = self._translate_rows(f, rows, row_keys)
        cols = self._translate_cols(idx, cols, col_keys)
        if len(rows) != len(cols):
            raise ApiError("rows and columns length mismatch", 400)
        with self._fenced_import(index, cols), self._import_lock(index):
            if clear:
                n = sum(bool(f.clear_bit(int(r), int(c)))
                        for r, c in zip(rows, cols))
            else:
                f.import_bits(rows, cols, timestamps)
                if mark_exists:
                    idx.mark_columns_exist(cols)
        if not clear:
            n = len(cols)
            metrics.IMPORTED_BITS.inc(n, index=index)
            # outside the import lock, as in the JAX package
            _stats.note_ingest(index, field, rows=rows, cols=cols,
                               width=idx.width)
        self.sweep_import(index, {field}, cols,
                          mark_exists=mark_exists and not clear)
        self._ack(index)
        return n

    def import_roaring(self, index: str, field: str, shard: int,
                       rows: dict, clear: bool = False) -> int:
        """A roaring fragment import (api.go:1771 ImportRoaring): one
        official-format blob (bytes or base64) a row id, of
        shard-relative columns.  Returns the bits set or cleared."""
        self._check_writable()
        idx = self._index(index)
        f = self._field(idx, field)
        metrics.IMPORT_TOTAL.inc(index=index)
        n = 0
        touched = []
        with self._fenced_import(index, [int(shard) * idx.width]), \
                self._import_lock(index):
            for row_s, blob in rows.items():
                row = int(row_s)
                data = base64.b64decode(blob) if isinstance(blob, str) \
                    else blob
                try:
                    cols = roaring.decode(data)
                except (ValueError, struct.error) as e:
                    # a truncated buffer fails inside the codec: client
                    # input, a 400
                    raise ApiError(
                        f"bad roaring data for row {row}: {e}", 400) from e
                if cols.size and int(cols.max()) >= idx.width:
                    raise ApiError(
                        f"column {int(cols.max())} exceeds shard width", 400)
                abs_cols = cols.astype(np.int64) + shard * idx.width
                if clear:
                    for c in abs_cols.tolist():
                        f.clear_bit(row, c)
                else:
                    f.import_bits(np.full(abs_cols.size, row, np.int64),
                                  abs_cols)
                    touched.append(abs_cols)
                n += int(cols.size)
            if touched:
                idx.mark_columns_exist(np.concatenate(touched))
        metrics.IMPORTED_BITS.inc(n, index=index)
        self.sweep_import(index, {field}, shards={int(shard)},
                          mark_exists=True)
        self._ack(index)
        return n

    def export_roaring(self, index: str, field: str, shard: int,
                       row: int) -> bytes:
        """One row's columns in one shard as official roaring bytes."""
        f = self._field(self._index(index), field)
        v = f.views.get(VIEW_STANDARD)
        frag = v.fragment(shard) if v else None
        if frag is None:
            return roaring.encode([])
        return roaring.encode(roaring.from_words(frag.row_words(row)))

    def import_values(self, index: str, field: str, cols=None, values=None,
                      col_keys=None, clear: bool = False,
                      mark_exists: bool = True) -> int:
        """Store (or with ``clear``, drop) BSI values at the columns."""
        self._check_writable()
        idx = self._index(index)
        f = self._field(idx, field)
        metrics.IMPORT_TOTAL.inc(index=index)
        cols = self._translate_cols(idx, cols, col_keys)
        if values is None:
            raise ApiError("values required", 400)
        if len(values) != len(cols):
            raise ApiError("columns and values length mismatch", 400)
        with self._fenced_import(index, cols), self._import_lock(index):
            if clear:
                n = sum(bool(f.clear_value(int(c))) for c in cols)
            else:
                f.import_values(cols, values)
                if mark_exists:
                    idx.mark_columns_exist(cols)
        if not clear:
            n = len(cols)
            metrics.IMPORTED_BITS.inc(n, index=index)
            _stats.note_ingest(index, field, cols=cols, values=values,
                               width=idx.width)
        self.sweep_import(index, {field}, cols,
                          mark_exists=mark_exists and not clear)
        self._ack(index)
        return n

    def mark_columns_exist(self, index: str, cols) -> None:
        """Mark a columnar batch's records once (the per-field imports
        of the batch pass mark_exists=False)."""
        idx = self._index(index)
        with self._fenced_import(index, cols), self._import_lock(index):
            idx.mark_columns_exist(cols)
        self.sweep_import(index, set(), cols, mark_exists=True)
        self._ack(index)

    def clear_field_columns(self, index: str, field: str, cols,
                            mark_exists: bool = True) -> int:
        """Drop every bit the field holds at the columns, in every view
        (a record's field set to NULL); the records still exist."""
        self._check_writable()
        idx = self._index(index)
        f = self._field(idx, field)
        by_shard: dict[int, list[int]] = {}
        for c in cols:
            by_shard.setdefault(int(c) // idx.width, []).append(
                int(c) % idx.width)
        with self._fenced_import(index, cols), self._import_lock(index):
            for shard, local in by_shard.items():
                mask = bm.from_columns(local, idx.width)
                for v in f.views.values():
                    frag = v.fragment(shard)
                    if frag is not None:
                        frag.clear_columns(mask)
            if mark_exists:
                idx.mark_columns_exist(cols)
        self.sweep_import(index, {field}, cols, mark_exists=mark_exists)
        self._ack(index)
        return len(cols)

    def import_columns(self, index: str, cols, bits: dict | None = None,
                       values: dict | None = None, workers: int = 4) -> int:
        """A columnar import of several fields over one column array:
        ``bits`` maps a set, mutex or bool field to its row ids,
        ``values`` a BSI field to its values.  The fields import on
        ``workers`` threads (each writes only its own fragments, and
        numpy releases the interpreter lock); the records are marked
        once.  Returns columns x fields."""
        self._check_writable()
        idx = self._index(index)
        jobs = []
        for fname, rows in (bits or {}).items():
            jobs.append((self._field(idx, fname).import_bits,
                         (rows, cols, None)))
        for fname, vals in (values or {}).items():
            jobs.append((self._field(idx, fname).import_values, (cols, vals)))
        metrics.IMPORT_TOTAL.inc(index=index)
        with self._fenced_import(index, cols), self._import_lock(index):
            if workers > 1 and len(jobs) > 1:
                with ThreadPoolExecutor(max_workers=workers) as pool:
                    for fut in [pool.submit(fn, *args) for fn, args in jobs]:
                        fut.result()
            else:
                for fn, args in jobs:
                    fn(*args)
            idx.mark_columns_exist(cols)
        metrics.IMPORTED_BITS.inc(len(cols) * len(jobs), index=index)
        self.sweep_import(index, set(bits or {}) | set(values or {}), cols,
                          mark_exists=True)
        self._ack(index)
        return len(cols) * len(jobs)

    def sync(self, index: str) -> None:
        """Write the index's dirty rows to its RBF files, between
        imports: a sync beside an import could miss the rows that
        import dirties while it writes."""
        idx = self._index(index)
        with self._import_lock(index):
            idx.sync()

    def _translate_rows(self, f, rows, row_keys):
        if row_keys is not None:
            if not f.options.keys:
                raise ApiError("field does not use row keys", 400)
            m = f.row_translator.create_keys(*row_keys)
            return [m[k] for k in row_keys]
        return rows if rows is not None else []

    def _translate_cols(self, idx, cols, col_keys):
        if col_keys is not None:
            if not idx.keys:
                raise ApiError("index does not use column keys", 400)
            m = idx.column_translator.create_keys(*col_keys)
            return [m[k] for k in col_keys]
        return cols if cols is not None else []

    # -- transactions (api.go StartTransaction; transaction.go) ------------

    def start_transaction(self, id=None, exclusive: bool = False,
                          timeout: float | None = None) -> dict:
        try:
            return self.txns.start(id=id, timeout=timeout,
                                   exclusive=exclusive).to_dict()
        except TransactionError as e:
            raise ApiError(str(e), 409) from e

    def finish_transaction(self, tid: str) -> dict:
        try:
            return self.txns.finish(tid).to_dict()
        except TransactionError as e:
            raise ApiError(str(e), 404) from e

    def get_transaction(self, tid: str) -> dict:
        try:
            return self.txns.get(tid).to_dict()
        except TransactionError as e:
            raise ApiError(str(e), 404) from e

    # -- introspection -----------------------------------------------------

    def info(self) -> dict:
        return {"shard_width": self.holder.width, "memory": None,
                "cpu_arch": self.executor.device.type,
                "version": __version__,
                "uptime_seconds": int(time.time() - self.start_time)}

    def version(self) -> dict:
        return {"version": __version__}

    def status(self) -> dict:
        return {"state": "NORMAL",
                "node": {"id": self.name, "is_primary": True},
                "local_id": self.name, "cluster_name": "pilosa-tpu",
                "indexes": sorted(self.holder.indexes)}

    def shard_max(self) -> dict:
        return {ix.name: (max(ix.available_shards)
                          if ix.available_shards else 0)
                for ix in self.holder.indexes.values()}

    def available_shards(self, index: str) -> list[int]:
        return sorted(self._index(index).available_shards)

    # -- backup and restore (ctl/backup.go, ctl/restore.go) ---------------

    def _safe_rel_path(self, rel: str) -> str:
        if not self.holder.path:
            raise ApiError("node has no data directory", 400)
        base = os.path.abspath(self.holder.path)
        p = os.path.abspath(os.path.normpath(os.path.join(base, rel)))
        if not p.startswith(base + os.sep):
            raise ApiError(f"path escapes data directory: {rel}", 400)
        return p

    def backup_manifest(self) -> dict:
        """Sync, then list every data file (schema, RBF shard files and
        WALs, translate stores) relative to the data directory."""
        if not self.holder.path:
            raise ApiError("node has no data directory", 400)
        self.holder.sync()
        files = []
        for root, _, fns in os.walk(self.holder.path):
            for fn in fns:
                files.append(os.path.relpath(os.path.join(root, fn),
                                             self.holder.path))
        return {"schema": self.schema(), "files": sorted(files)}

    def backup_file(self, rel: str) -> bytes:
        p = self._safe_rel_path(rel)
        if not os.path.isfile(p):
            raise ApiError(f"no such backup file: {rel}", 404)
        with open(p, "rb") as f:
            return f.read()

    def restore_file(self, rel: str, data: bytes) -> None:
        p = self._safe_rel_path(rel)
        os.makedirs(os.path.dirname(p) or ".", exist_ok=True)
        with open(p, "wb") as f:
            f.write(data)

    def restore_complete(self) -> dict:
        """Reload the holder from the restored files (ctl/restore.go's
        reload after the upload).  The reloaded fragments are new
        objects with new generations, so no device stack or cached
        result of the old ones is served again."""
        if not self.holder.path:
            raise ApiError("node has no data directory", 400)
        self.holder.close()
        self.holder.indexes = {}
        self.holder.load_schema()
        return {"indexes": sorted(self.holder.indexes)}

    # -- translation sync (holder.go:1488-1715, the translate syncer) -------

    def _keyed_index(self, index: str):
        idx = self._index(index)
        if not idx.keys:
            raise ApiError(f"index {index} is not keyed", 400)
        return idx

    def translate_partitions(self, index: str) -> list[int]:
        """The partitions of the index's column-key store holding keys."""
        return self._keyed_index(index).column_translator \
            .nonempty_partitions()

    def translate_partition_snapshot(self, index: str,
                                     partition: int) -> dict:
        return self._keyed_index(index).column_translator \
            .partition_snapshot(int(partition))

    def translate_restore_partition(self, index: str, partition: int,
                                    snap: dict) -> dict:
        self._keyed_index(index).column_translator.restore_partition(
            int(partition), snap)
        return {"restored": int(partition),
                "entries": len(snap.get("entries", []))}

    def _row_translator(self, index: str, field: str):
        f = self._index(index).field(field)
        if f is None or f.row_translator is None:
            raise ApiError(f"no keyed field {field} in {index}", 404)
        return f.row_translator

    def field_translate_snapshot(self, index: str, field: str) -> dict:
        return self._row_translator(index, field).snapshot()

    def field_translate_restore(self, index: str, field: str,
                                snap: dict) -> dict:
        self._row_translator(index, field).restore_snapshot(snap)
        return {"entries": len(snap.get("entries", []))}

    # -- fragment sync: replica repair (fragment.go checksum blocks) and
    # -- the resharding transfer (block copy, delta chase) -----------------

    def _fragment_or_none(self, index, field, view, shard):
        idx = self.holder.index(index)
        f = idx.field(field) if idx is not None else None
        v = f.views.get(view) if f is not None else None
        return v.fragment(int(shard)) if v is not None else None

    def _fragment_or_404(self, index, field, view, shard):
        """The fragment a transfer or repair writes, made as needed (a
        fresh recipient has no existence field until its first mark)."""
        idx = self._index(index)
        f = idx.field(field)
        if f is None and field == EXISTENCE_FIELD:
            f = idx._ensure_existence()
        if f is None:
            raise ApiError(f"field not found: {field}", 404)
        v = f.view(view, create=True)
        if v is None:
            raise ApiError(f"view not found: {view}", 404)
        frag = v.fragment(int(shard), create=True)
        if frag is None:
            raise ApiError(f"no fragment shard={shard}", 404)
        return frag

    def fragment_views(self, index: str, field: str) -> list[str]:
        return sorted(self._field(self._index(index), field).views)

    def fragment_checksums(self, index: str, field: str, view: str,
                           shard: int) -> dict:
        """Block digests, to find where replicas diverge; {} when the
        fragment does not exist (nothing stored is all-empty)."""
        frag = self._fragment_or_none(index, field, view, shard)
        if frag is None:
            self._index(index)
            return {}
        return {str(b): d for b, d in frag.block_checksums().items()}

    def fragment_checksums_many(self, index: str, field: str, view: str,
                                shards) -> dict:
        """``fragment_checksums`` of many shards in one call: {shard:
        digests} (the port's batched form of the rejoin's diff)."""
        return {str(int(s)): self.fragment_checksums(index, field, view,
                                                     int(s))
                for s in shards}

    def fragment_block(self, index: str, field: str, view: str,
                       shard: int, block: int) -> dict:
        """One block's rows as base64(zlib(packed words)); {} when the
        fragment does not exist (the repairing peer then clears its
        diverged rows)."""
        frag = self._fragment_or_none(index, field, view, shard)
        if frag is None:
            self._index(index)
            return {}
        return {str(r): _pack_words(w)
                for r, w in frag.block_rows(int(block)).items()}

    def fragment_set_block(self, index: str, field: str, view: str,
                           shard: int, block: int, payload: dict) -> dict:
        frag = self._fragment_or_404(index, field, view, shard)
        rows = {int(r): _unpack_words(b64) for r, b64 in payload.items()}
        frag.set_block_rows(int(block), rows)
        return {"block": int(block), "rows": len(rows)}

    def fragment_state(self, index: str, field: str, view: str,
                       shard: int) -> dict:
        """The copy's bootstrap in one round trip: the donor fragment's
        (gen, version), taken before its block digests, so a chase from
        ``version`` covers every write made during the copy."""
        frag = self._fragment_or_none(index, field, view, shard)
        if frag is None:
            return {"absent": True}
        gen, version = frag.gen, frag.version
        return {"gen": gen, "version": version,
                "checksums": {str(b): d for b, d
                              in frag.block_checksums().items()}}

    def fragment_deltas(self, index: str, field: str, view: str,
                        shard: int, since: int) -> dict:
        """The delta chase's feed: the current words of every row the
        delta log names above ``since``; ``covered`` False when the log
        cannot prove coverage (the caller diffs checksums again)."""
        frag = self._fragment_or_none(index, field, view, shard)
        if frag is None:
            return {"absent": True}
        gen, version, count, rows = frag.delta_export(int(since))
        if rows is None:
            return {"covered": False, "gen": gen, "version": version}
        return {"covered": True, "gen": gen, "version": version,
                "count": count,
                "rows": {str(r): _pack_words(w) for r, w in rows.items()}}

    def fragment_set_rows(self, index: str, field: str, view: str,
                          shard: int, payload: dict) -> dict:
        """The recipient's side of the chase: replace whole rows with the
        donor's current words (idempotent)."""
        frag = self._fragment_or_404(index, field, view, shard)
        rows = payload.get("rows", payload)
        for r, b64 in rows.items():
            frag.set_row_words(int(r), _unpack_words(b64))
        return {"rows": len(rows)}

    # -- key translation (api.go:929-1038) ---------------------------------

    def _translator(self, index: str, field: str | None):
        idx = self._index(index)
        if field:
            f = idx.field(field)
            if f is None or not f.options.keys:
                raise ApiError("field not found or not keyed", 400)
            return f.row_translator
        if not idx.keys:
            raise ApiError("index does not use keys", 400)
        return idx.column_translator

    def translate_keys(self, index: str, field: str | None, keys: list,
                       create: bool = False) -> list:
        """Each key's id (None for a missing key unless ``create``)."""
        tr = self._translator(index, field)
        m = tr.create_keys(*keys) if create else tr.find_keys(*keys)
        return [int(m[k]) if k in m else None for k in keys]

    def translate_ids(self, index: str, field: str | None,
                      ids: list) -> list:
        return self._translator(index, field).translate_ids(ids)

    def _index(self, name: str):
        idx = self.holder.index(name)
        if idx is None:
            raise ApiError(f"index not found: {name}", 404)
        return idx


def _pack_words(words) -> str:
    """Packed row words on the node-to-node wire: base64(zlib(bytes))."""
    return base64.b64encode(zlib.compress(
        np.ascontiguousarray(words, dtype=np.uint32).tobytes())).decode()


def _unpack_words(b64: str) -> np.ndarray:
    return np.frombuffer(zlib.decompress(base64.b64decode(b64)),
                         dtype=np.uint32)


_NAME_OK = set("abcdefghijklmnopqrstuvwxyz0123456789-_")


def _validate_name(name: str):
    if not name or name[0] not in "abcdefghijklmnopqrstuvwxyz" or \
            not all(c in _NAME_OK for c in name) or len(name) > 230:
        raise ApiError(f"invalid name: {name!r}", 400)


# -- result serialization (handler-side marshaling) ------------------------

def rfc3339(d: dt.datetime) -> str:
    """RFC3339 with a Z suffix, the reference's timestamp form (naive
    datetimes are UTC; a sub-microsecond value shows its 9-digit
    fraction with the trailing zeros trimmed, as Go's RFC3339Nano)."""
    ns = ns_of(d)
    if d.tzinfo is not None:
        d = d.astimezone(dt.timezone.utc).replace(tzinfo=None)
    if ns % 1000:
        base = d.replace(microsecond=0).isoformat()
        return base + (".%09d" % ns).rstrip("0") + "Z"
    return d.isoformat() + "Z"


def _json_value(v):
    if isinstance(v, np.integer):
        return int(v)
    if isinstance(v, np.floating):
        return float(v)
    if isinstance(v, Decimal):
        return float(v)  # the reference's decimal wire form
    if isinstance(v, dt.datetime):
        return rfc3339(v)
    if isinstance(v, np.ndarray):
        return [_json_value(x) for x in v.tolist()]
    if isinstance(v, (list, tuple)):
        return [_json_value(x) for x in v]
    return v


def serialize_result(r) -> object:
    """One PQL result as a JSON-able object, the reference's
    QueryResponse form of each result type."""
    if r is None or isinstance(r, (bool, int, float, str, np.integer,
                                   np.floating)):
        return _json_value(r)
    if isinstance(r, RowResult):
        d = {"columns": [int(c) for c in r.columns()]}
        if r.keys is not None:
            d["keys"] = list(r.keys)
        return d
    if isinstance(r, ValCount):
        return {"value": _json_value(r.value), "count": int(r.count)}
    if isinstance(r, DistinctValues):
        return {"values": [_json_value(v) for v in r.values]}
    if isinstance(r, Pair):
        d = {"id": int(r.id), "count": int(r.count)}
        if r.key is not None:
            d["key"] = r.key
        return d
    if isinstance(r, GroupCount):
        d = {"group": [_json_value(g) if not isinstance(g, dict) else
                       {k: _json_value(v) for k, v in g.items()}
                       for g in r.group],
             "count": int(r.count)}
        if r.agg is not None:
            d["agg"] = _json_value(r.agg)
        if r.agg_count is not None:
            d["agg_count"] = _json_value(r.agg_count)
        return d
    if isinstance(r, SortedRow):
        return {"columns": [int(c) for c in r.columns],
                "values": [_json_value(v) for v in r.values]}
    if isinstance(r, ExtractedTable):
        return {"fields": [_json_value(f) if not isinstance(f, dict) else f
                           for f in r.fields],
                "columns": [{k: _json_value(v) for k, v in c.items()}
                            if isinstance(c, dict) else _json_value(c)
                            for c in r.columns]}
    if isinstance(r, (list, tuple)):
        return [serialize_result(x) for x in r]
    if isinstance(r, dict):
        return {k: serialize_result(v) for k, v in r.items()}
    if isinstance(r, np.ndarray):
        return [_json_value(x) for x in r.tolist()]
    return _json_value(r)
