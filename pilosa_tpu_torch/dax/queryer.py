"""Queryer — stateless query front end over compute workers.

Reference: dax/queryer/queryer.go:34 + orchestrator.go:83 — a
re-implementation of the executor's mapReduce that asks the
Controller which workers own the touched shards, fans the PQL out per
worker, and reduces the serialized partials (the same cross-node
reducers the cluster layer uses).

Writes route through the queryer too: each (table, shard) import goes
to its owning worker, which write-logs before applying.

SQL fronting (dax/queryer/queryer.go:134 embeds the sql3 planner over
a Controller-backed schema API): :meth:`Queryer.sql` runs the SAME
SQL engine over a schema-only holder whose executor ships each
compiled PQL call to the compute workers and decodes the wire results
back into engine result objects — the single-controller analog of the
reference's orchestrator-backed planner.  DDL and INSERT translate to
controller schema changes and routed imports.
"""

from __future__ import annotations

import time

from pilosa_tpu_torch.cluster.client import InternalClient
from pilosa_tpu_torch.cluster.coordinator import (
    _empty_result,
    _reduce,
    _sort_call_for_shipping,
    extract_of_sort_wire,
)
from pilosa_tpu_torch.dax.controller import Controller
from pilosa_tpu_torch.executor.executor import Executor
from pilosa_tpu_torch.executor.results import deserialize_result
from pilosa_tpu_torch.pql import parse
from pilosa_tpu_torch.shardwidth import SHARD_WIDTH


class _RemoteExecutor(Executor):
    """Executor whose calls execute ON THE COMPUTE WORKERS: every
    dispatched call serializes back to PQL (Call.to_pql) and rides the
    queryer's fan-out; wire results decode into engine result objects.
    The local holder carries SCHEMA ONLY (no fragments), so the SQL
    engine's planning (WHERE compilation, schema checks, key handling)
    works unchanged while the data plane stays remote.  It takes the
    service's device and launches nothing itself: its holder has no
    rows, and every call it runs is answered by the workers."""

    def __init__(self, holder, queryer: "Queryer", device=None):
        super().__init__(holder, device)
        self.queryer = queryer

    def _execute_call(self, idx, call, shards, pre=None):
        # the queryer handles the Sort offset hoist and the
        # Extract(Sort) order-preserving split at the wire level;
        # translate=False: this executor pre-translates the call and
        # key-translates the decoded result OBJECTS itself
        call = self._translate_call(idx, call)
        res = self.queryer.query(idx.name, call.to_pql(),
                                 translate=False)["results"][0]
        return self._translate_result(
            idx, call, deserialize_result(call, res, idx.width))

    # -- front-end key translation (the reference orchestrator's
    # preTranslate/translateResults split: workers run in ID space,
    # string keys exist only here) --------------------------------------

    def _translate_call(self, idx, call):
        return translate_call_keys(idx, call)

    def _translate_result(self, idx, call, res):
        return translate_result_keys(idx, call, res)


def translate_call_keys(idx, call):
    """Ship pre-translated row ids: string row values for keyed
    fields become ids via the queryer-holder translators (an unknown
    key matches nothing, FindKeys semantics).  Handles bare strings,
    lists of strings (Rows(ids=...) shapes), and Condition values —
    keyed-shape raw PQL must never silently match nothing because a
    worker compared a string against an ID-space row."""
    from pilosa_tpu_torch.pql.ast import Call, Condition

    def conv(name, v):
        f = idx.field(name)
        if f is None or not f.options.keys:
            return v
        tr = f.row_translator

        def one(x):
            if not isinstance(x, str):
                return x
            rid = tr.find_keys(x).get(x)
            return -1 if rid is None else int(rid)  # -1: no match

        if isinstance(v, str):
            return one(v)
        if isinstance(v, list):
            nv = [one(x) for x in v]
            return v if all(a is b for a, b in zip(nv, v)) else nv
        if isinstance(v, Condition):
            cv = v.value
            ncv = ([one(x) for x in cv] if isinstance(cv, list)
                   else one(cv))
            if ncv is cv:
                return v
            return Condition(v.op, ncv)
        return v

    def walk(c):
        args = {}
        changed = False
        for k, v in c.args.items():
            nv = conv(k, v) if not isinstance(v, Call) \
                else walk(v)
            changed |= nv is not v
            args[k] = nv
        kids = [walk(ch) for ch in c.children]
        changed |= any(a is not b
                       for a, b in zip(kids, c.children))
        if not changed:
            return c
        return Call(c.name, args=args, children=kids)
    return walk(call)


def translate_result_keys(idx, call, res):
    """ids -> keys on results from the ID-space workers, using
    the queryer-holder translators (translateResults analog,
    executor.go:7519)."""
    from decimal import Decimal

    from pilosa_tpu_torch.executor.results import (
        ExtractedTable,
        Pair,
        ValCount,
    )
    from pilosa_tpu_torch.models.schema import FieldType

    def field_tr(fname):
        f = idx.field(fname) if fname else None
        if f is None or not f.options.keys:
            return None, None
        return f, f.row_translator

    def requantize(f, v):
        # decimals cross the wire as display floats; restore the
        # exact engine type at the front
        if isinstance(v, (int, float)) and not isinstance(v, bool):
            return Decimal(str(v)).quantize(
                Decimal(1).scaleb(-f.options.scale))
        return v

    if isinstance(res, ExtractedTable):
        if idx.keys and idx.column_translator is not None:
            # ID-space workers can't attach column keys; the
            # front owns the column translator
            ids = [int(e["column"]) for e in res.columns]
            for e, k in zip(res.columns,
                            idx.column_translator.translate_ids(
                                ids)):
                if k is not None:
                    e["column_key"] = k
        for i, fname in enumerate(res.fields):
            f = idx.field(fname)
            if f is None:
                continue
            if f.options.type == FieldType.DECIMAL:
                for e in res.columns:
                    e["rows"][i] = requantize(f, e["rows"][i])
                continue
            _f, tr = field_tr(fname)
            if tr is None:
                continue
            for e in res.columns:
                v = e["rows"][i]
                if isinstance(v, list):
                    e["rows"][i] = tr.translate_ids(v)
                elif isinstance(v, int) and \
                        f.options.type == FieldType.MUTEX:
                    e["rows"][i] = tr.translate_id(v)
        return res
    from pilosa_tpu_torch.executor.results import DistinctValues
    if isinstance(res, DistinctValues):
        f = idx.field(call.arg("_field") or "")
        if f is not None and \
                f.options.type == FieldType.DECIMAL:
            res.values = [requantize(f, v) for v in res.values]
        return res
    if isinstance(res, ValCount):
        f = idx.field(call.arg("_field") or "")
        if f is not None and \
                f.options.type == FieldType.DECIMAL and \
                call.name != "Count":
            res.value = requantize(f, res.value) \
                if res.value is not None else None
        return res
    if isinstance(res, list) and res and \
            isinstance(res[0], Pair):
        _f, tr = field_tr(call.arg("_field"))
        if tr is not None:
            keys = tr.translate_ids([p.id for p in res])
            for p, k in zip(res, keys):
                p.key = k
        return res
    if isinstance(res, list) and res and \
            hasattr(res[0], "group"):
        for gc in res:
            for entry in gc.group:
                f, tr = field_tr(entry.get("field"))
                if tr is not None and "row_key" not in entry:
                    entry["row_key"] = tr.translate_id(
                        entry["row_id"])
        return res
    return res


class Queryer:
    def __init__(self, controller: Controller,
                 translate_dir: str | None = None, device=None):
        # translate_dir persists the front-end key translators (the
        # keyed-field key->id maps workers never see); a restarted
        # queryer over the same dir reloads them.  One active queryer
        # at a time owns the dir (the reference's translation state
        # likewise lives with the control plane, not the workers).
        self.translate_dir = translate_dir
        self.controller = controller
        self.device = device
        # generous timeout: a worker's FIRST query over its share
        # hydrates every touched shard from the blob tier under its
        # node lock (restore, sha256, decode) and uploads the stacks,
        # which must not be mistaken for a dead node
        self._client = InternalClient(timeout=180.0)
        self._sql = None  # lazy: schema-only holder + engine
        # table -> (controller schema_version, is_keyed)
        self._keyed_cache: dict[str, tuple[int, bool]] = {}

    # -- schema / ingest ----------------------------------------------

    def apply_schema(self, schema: dict):
        self.controller.apply_schema(schema)

    def _group_by_shard(self, cols, width: int = SHARD_WIDTH):
        groups: dict[int, list[int]] = {}
        for i, c in enumerate(cols):
            groups.setdefault(int(c) // width, []).append(i)
        return groups

    def _import_fanout(self, table: str, field: str, cols,
                       payload) -> int:
        """Shared owner fan-out for every /dax/import write op:
        group cols by shard, register the shards, POST one request
        per owning worker.  payload(idxs) -> op-specific body
        fields."""
        n = 0
        groups = self._group_by_shard(cols)
        self.controller.add_shards(table, groups.keys())
        for shard, idxs in groups.items():
            # a live migration may have this shard FENCED (ownership
            # mid-flip): hold until the flip lands so the write goes
            # to exactly one owner
            self.controller.fence_wait(table, shard)
            _, uri = self.controller.worker_for(table, shard)
            body = {"table": table, "field": field, "shard": shard,
                    "cols": [int(cols[i]) for i in idxs]}
            body.update(payload(idxs))
            r = self._client._request(uri, "POST", "/dax/import", body)
            n += r["imported"]
        return n

    def import_bits(self, table: str, field: str, rows, cols) -> int:
        return self._import_fanout(
            table, field, cols,
            lambda idxs: {"op": "bits",
                          "rows": [int(rows[i]) for i in idxs]})

    def import_values(self, table: str, field: str, cols, values) -> int:
        return self._import_fanout(
            table, field, cols,
            lambda idxs: {"op": "values",
                          "values": [values[i] for i in idxs]})

    def clear_field(self, table: str, field: str, cols) -> int:
        """Record-level field clear on the owning workers (explicit
        NULL for a bool/mutex column — apply_record's clear_field
        shipped over the wire, write-logged like any import)."""
        return self._import_fanout(table, field, cols,
                                   lambda idxs: {"op": "clear"})

    # -- SQL fronting (queryer.go:134 QuerySQL) -------------------------

    def _sql_engine(self):
        if self._sql is None:
            from pilosa_tpu_torch.models.holder import Holder
            from pilosa_tpu_torch.sql import SQLEngine
            holder = Holder(path=self.translate_dir) \
                if self.translate_dir else Holder()
            self._sql = SQLEngine(holder, executor=_RemoteExecutor(
                holder, self, self.device))
        # mirror controller schema into the schema-only holder
        self._apply_schema_local(self._sql.holder,
                                 self.controller.schema)
        return self._sql

    @staticmethod
    def _apply_schema_local(holder, schema: dict):
        from pilosa_tpu_torch.models.schema import FieldOptions
        names = set()
        for ix in schema.get("indexes", []):
            names.add(ix["name"])
            idx = holder.create_index(ix["name"],
                                      keys=ix.get("keys", False),
                                      ok_if_exists=True)
            for f in ix.get("fields", []):
                idx.create_field(
                    f["name"],
                    FieldOptions.from_dict(f.get("options", {})),
                    ok_if_exists=True)
        # mirror is authoritative-FROM-controller: drop local indexes
        # the controller no longer knows (DROP TABLE must not
        # resurrect on the next mirror refresh)
        for n in list(holder.indexes):
            if n not in names:
                holder.delete_index(n)

    def sql(self, statement: str) -> dict:
        """SQL over the compute fleet: reads compile locally (schema-
        only holder) and execute remotely; DDL updates the controller
        schema; INSERT routes through the shard-owner imports.
        Returns the API wire shape {"schema": ..., "data": ...}."""
        from pilosa_tpu_torch.sql import SQLError
        from pilosa_tpu_torch.sql import ast as sqlast
        from pilosa_tpu_torch.sql.parser import parse_sql

        stmts = parse_sql(statement)
        out = None
        for stmt in stmts:
            eng = self._sql_engine()
            if isinstance(stmt, sqlast.CreateTable):
                eng._execute(stmt)  # schema-only holder
                self.apply_schema({"indexes": eng.holder.schema()})
                out = {"schema": {"fields": []}, "data": []}
                continue
            if isinstance(stmt, sqlast.DropTable):
                eng._execute(stmt)  # schema-only holder (404 checks)
                self.controller.drop_table(stmt.name)
                out = {"schema": {"fields": []}, "data": []}
                continue
            if isinstance(stmt, sqlast.Insert):
                out = self._sql_insert(stmt)
                continue
            if isinstance(stmt, sqlast.BulkInsert):
                # materialize the converted CSV rows (shared engine
                # helper), then route through the same shard-owner
                # imports as INSERT — executing it on the schema-only
                # mirror would silently drop the data
                idx = eng.holder.index(stmt.table)
                if idx is None:
                    raise SQLError(f"table not found: {stmt.table}")
                fields, _ = eng.stmts.bulk_fields(idx, stmt.columns)
                # same MAP/TRANSFORM analysis as the local engine —
                # count mismatches and type incompatibilities must
                # not silently insert partial records
                eng.stmts.bulk_typecheck(stmt, idx, fields)
                rows = list(eng.stmts.iter_bulk_rows(stmt, idx, fields))
                out = self._sql_insert(sqlast.Insert(
                    stmt.table, stmt.columns, rows))
                continue
            res = eng._execute(stmt)
            out = {
                "schema": {"fields": [
                    {"name": n, "type": t} for n, t in res.schema]},
                "data": [list(r) for r in res.rows],
            }
        return out

    def _sql_insert(self, stmt) -> dict:
        """INSERT VALUES routed through owner imports (unkeyed ids)."""
        import datetime as _dt
        from decimal import Decimal as _D

        from pilosa_tpu_torch.sql.common import rfc3339 as _rfc3339
        from pilosa_tpu_torch.sql.engine import SQLError

        eng = self._sql_engine()
        idx = eng.holder.index(stmt.table)
        if idx is None:
            raise SQLError(f"table not found: {stmt.table}")
        if "_id" not in stmt.columns:
            raise SQLError("INSERT requires an _id column")
        id_pos = stmt.columns.index("_id")
        # accumulate per-field batches so the fleet sees ONE import
        # fan-out per field, not one RPC per (row, value)
        bit_rows: dict[str, tuple[list, list]] = {}
        val_cols: dict[str, tuple[list, list]] = {}
        # bool/mutex hold ONE value per record: collapse duplicate
        # rows for the same _id to the LAST action (set, or None =
        # explicit-NULL clear) so the batched fan-out preserves
        # apply_record's row-by-row order
        single_last: dict[str, dict[int, object]] = {}
        replace_cols: list[int] = []
        for row in stmt.rows:
            # keyed _id translates at the front like field keys
            col = int(eng._col_id(idx, row[id_pos]))
            if stmt.replace:
                replace_cols.append(col)
            for cname, v in zip(stmt.columns, row):
                if cname == "_id":
                    continue
                f = idx.field(cname)
                if f is None:
                    raise SQLError(f"column not found: {cname}")
                t = f.options.type
                if t.value in ("bool", "mutex"):
                    single_last.setdefault(cname, {})[col] = v
                    continue
                if v is None:
                    # NULL on set/BSI columns is a no-op, matching
                    # apply_record (only bool/mutex state clears)
                    continue
                if t.is_bsi:
                    # ship USER values (JSON-able): the worker's
                    # import does the single value_to_int conversion
                    # — pre-scaling here double-scaled decimals
                    f.value_to_int(v)  # validate/raise front-side
                    wire = (str(v) if isinstance(v, _D)
                            else _rfc3339(v)
                            if isinstance(v, _dt.datetime) else v)
                    cs, vs = val_cols.setdefault(cname, ([], []))
                    cs.append(col)
                    vs.append(wire)
                else:
                    vals = v if isinstance(v, list) else [v]
                    rs, cs = bit_rows.setdefault(cname, ([], []))
                    for item in vals:
                        if isinstance(item, str):
                            # keyed field rows translate at the FRONT
                            # (queryer-holder translators); workers
                            # run in ID space
                            tr = f.row_translator
                            if tr is None:
                                raise SQLError(
                                    f"column {cname} holds ids, got "
                                    f"string {item!r}")
                            item = tr.create_keys(item)[item]
                        rs.append(int(item))
                        cs.append(col)
        if replace_cols:
            # full-record replace: clear old values on the owners
            # first (the engine's clear_columns analog), one fan-out
            cols_pql = ",".join(str(c) for c in replace_cols)
            self.query(stmt.table,
                       f"Delete(ConstRow(columns=[{cols_pql}]))")
        for cname, colvals in single_last.items():
            f = idx.field(cname)
            clears = [c for c, v in colvals.items() if v is None]
            rs, cs = [], []
            for c, v in colvals.items():
                if v is None:
                    continue
                if f.options.type.value == "bool":
                    rs.append(1 if v else 0)
                else:
                    if isinstance(v, list):
                        raise SQLError(
                            f"column {cname} accepts a single value")
                    if isinstance(v, str):
                        tr = f.row_translator
                        if tr is None:
                            raise SQLError(
                                f"column {cname} holds ids, got "
                                f"string {v!r}")
                        v = tr.create_keys(v)[v]
                    rs.append(int(v))
                cs.append(c)
            if clears:
                # an EXPLICIT null clears the record's bool/mutex
                # state on the OWNING worker instead of being
                # silently skipped (defs_bool select-all2: inserting
                # (2, null) over (2, true) must read back NULL), and
                # marks existence so a NULL-only record still
                # inserts — exactly apply_record's local semantics
                self.clear_field(stmt.table, cname, clears)
            if cs:
                self.import_bits(stmt.table, cname, rs, cs)
        for cname, (rs, cs) in bit_rows.items():
            self.import_bits(stmt.table, cname, rs, cs)
        for cname, (cs, vs) in val_cols.items():
            self.import_values(stmt.table, cname, cs, vs)
        return {"schema": {"fields": []}, "data": [[len(stmt.rows)]]}

    # -- reads (orchestrator.go:83 Execute) ----------------------------

    def _keyed_index(self, table: str):
        """The schema-only mirror index for `table` IF any key
        translation applies to it, else None.  Keyedness is memoized
        by controller schema version so the common unkeyed raw-PQL
        fan-out never pays the mirror refresh; keyed tables refresh
        via _sql_engine (same path SQL fronting uses)."""
        ver = self.controller.schema_version
        ent = self._keyed_cache.get(table)
        if ent is None or ent[0] != ver:
            keyed = False
            for ix in self.controller.schema.get("indexes", []):
                if ix.get("name") == table:
                    keyed = bool(ix.get("keys")) or any(
                        f.get("options", {}).get("keys")
                        for f in ix.get("fields", []))
                    break
            ent = (ver, keyed)
            self._keyed_cache[table] = ent
        if not ent[1]:
            return None
        return self._sql_engine().holder.index(table)

    def query(self, table: str, pql: str,
              translate: bool = True) -> dict:
        """Raw-PQL fan-out.  Keyed-shape PQL routes through the same
        translate_call_keys / translate_result_keys pair the SQL front
        uses: string row values become ids BEFORE shipping (workers
        run in pure ID space — an untranslated key would silently
        match nothing) and result ids come back with their keys
        attached.  translate=False is the internal ID-space entry used
        by _RemoteExecutor, which does its own translation on the
        richer result objects."""
        q = parse(pql)
        idx = self._keyed_index(table) if translate else None
        if idx is not None:
            from pilosa_tpu_torch.pql.ast import Query
            q = Query(calls=[translate_call_keys(idx, c)
                             for c in q.calls])
        # order-sensitive calls need call-level handling before the
        # fan-out (same contracts as ClusterExecutor): Extract(Sort)
        # splits; Sort hoists its offset to the merge
        if any((c.name == "Extract" and c.children
                and c.children[0].name == "Sort") for c in q.calls):
            results = []
            for c in q.calls:
                if c.name == "Extract" and c.children \
                        and c.children[0].name == "Sort":
                    results.append(extract_of_sort_wire(
                        c, lambda cc: self.query(
                            table, cc.to_pql(),
                            translate=False)["results"][0]))
                else:
                    results.append(self.query(
                        table, c.to_pql(),
                        translate=False)["results"][0])
            out = {"results": results}
            return (self._translate_wire_results(idx, q, out)
                    if idx is not None else out)
        shipped = [(_sort_call_for_shipping(c) if c.name == "Sort"
                    else c) for c in q.calls]
        pql = "".join(c.to_pql() for c in shipped)
        from pilosa_tpu_torch.cluster.client import RemoteError
        from pilosa_tpu_torch.obs import faults, flight
        from pilosa_tpu_torch.taskpool import Pool

        # a live migration can flip a shard's owner between routing
        # and worker execution; the ex-owner answers a typed 409
        # (never a silent empty partial).  Only the CONFLICTED
        # subset re-resolves ownership and retries — re-running the
        # whole fan-out would re-race every other in-flight flip
        # (a scale event moves many shards back to back), while the
        # conflicted shards' own flip completes in bounded time.
        remaining = sorted(self.controller.tables.get(table, ()))
        partials: list = []
        conflict: Exception | None = None
        for attempt in range(8):
            # group shards by owning worker (ComputeNodes in the
            # reference)
            by_worker: dict[str, list[int]] = {}
            uris: dict[str, str] = {}
            for s in remaining:
                addr, uri = self.controller.worker_for(table, s)
                by_worker.setdefault(addr, []).append(s)
                uris[addr] = uri

            def one(pool, addr):
                with pool.blocked():  # RPC wait
                    faults.fire("dax-rpc", uris[addr])
                    t0 = time.perf_counter()
                    try:
                        out = self._client.query_node(
                            uris[addr], table, pql, by_worker[addr],
                            idempotent=True)
                        flight.note_attempt(
                            addr, time.perf_counter() - t0, "ok")
                        return ("ok", addr, out)
                    except RemoteError as e:
                        flight.note_attempt(
                            addr, time.perf_counter() - t0, "error")
                        if getattr(e, "status", None) == 409:
                            return ("conflict", addr, e)
                        raise
                    except Exception:
                        flight.note_attempt(
                            addr, time.perf_counter() - t0, "error")
                        raise

            # Pool.map settles every sibling RPC before re-raising
            # the first failure (by worker order), so one worker
            # dying fails only THIS query — never the pool or
            # mid-flight siblings
            outs = Pool(size=2).map(one, sorted(by_worker))
            partials.extend(o["results"] for st, _, o in outs
                            if st == "ok")
            conflicted = [(a, e) for st, a, e in outs
                          if st == "conflict"]
            if not conflicted:
                remaining = []
                break
            conflict = conflicted[0][1]
            remaining = sorted(
                s for a, _ in conflicted for s in by_worker[a])
            time.sleep(0.02 * (attempt + 1))
        if remaining:
            routes = {s: self.controller.worker_for(table, s)[0]
                      for s in remaining}
            raise RemoteError(
                getattr(conflict, "status", 409),
                f"ownership retries exhausted for {table}/shards "
                f"{remaining} (now routed {routes}): {conflict}")
        if not partials:
            out = {"results": [_empty_result(c) for c in q.calls]}
        else:
            out = {"results": [
                _reduce(q.calls[ci], [p[ci] for p in partials])
                for ci in range(len(q.calls))]}
        return (self._translate_wire_results(idx, q, out)
                if idx is not None else out)

    def _translate_wire_results(self, idx, q, out: dict) -> dict:
        """ids -> keys on the reduced WIRE results: deserialize each
        call's JSON form into its result object, run the shared
        translate_result_keys pass plus the single-node /query parity
        bits (column keys on Row results, row keys from keyed Rows —
        the ID-space workers can't attach either), re-serialize."""
        from pilosa_tpu_torch.api import serialize_result
        from pilosa_tpu_torch.executor.results import RowResult
        translated = []
        for call, wire in zip(q.calls, out["results"]):
            res = deserialize_result(call, wire, idx.width)
            res = translate_result_keys(idx, call, res)
            if isinstance(res, RowResult):
                if idx.keys and idx.column_translator is not None \
                        and not getattr(res, "is_row_ids", False):
                    res.keys = idx.column_translator.translate_ids(
                        res.columns())
            elif call.name == "Rows" and isinstance(res, list):
                f = idx.field(call.arg("_field") or "")
                if f is not None and f.options.keys \
                        and f.row_translator is not None:
                    keys = f.row_translator.translate_ids(
                        [int(r) for r in res])
                    # keyless ids (raw-id imports) fall back to the
                    # id, matching the single-node _execute_rows
                    res = [k if k is not None else r
                           for k, r in zip(keys, res)]
            translated.append(serialize_result(res))
        return {"results": translated}
