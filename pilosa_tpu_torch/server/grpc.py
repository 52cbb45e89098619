"""gRPC plane — the reference's client-facing RPC surface.

Behavioral parity with server/grpc.go: the ``proto.Pilosa`` service
(QuerySQL/QueryPQL streaming + Unary, Inspect, index CRUD,
server/grpc.go:38 GRPCHandler, :276 QuerySQLUnary, :502 QueryPQL) over
the same wire messages (proto/pilosa.proto), byte for byte the JAX
package's, so one client talks to either server.  Service stubs are
hand-written against grpcio's generic handler API because only message
codegen (protoc --python_out) is available; the method table mirrors
the generated one.

Result -> RowResponse mapping follows server/grpc.go ResultToRowser
(:160): Row results stream one row per column id/key, TopN streams
(row, count) pairs, ValCount/GroupCount map to typed columns.

This module needs the ``grpc`` and ``google.protobuf`` packages, and
importing it without them raises an ImportError that names them: the
rest of the server (HTTP, config, CLI) imports without either, and a
node runs with gRPC off (``grpc-port = -1``).
"""

from __future__ import annotations

import datetime as dt
import time
from concurrent import futures
from decimal import Decimal as PyDecimal

try:
    import grpc
    from pilosa_tpu_torch.server.proto import pb
except ImportError as e:  # pragma: no cover - depends on the install
    raise ImportError(
        "gRPC serving needs the 'grpc' (grpcio) and 'google.protobuf' "
        "(protobuf) packages, which this Python does not have; run the "
        "node with grpc-port = -1 to serve HTTP only") from e

from pilosa_tpu_torch.api import ApiError
from pilosa_tpu_torch.executor.results import (
    DistinctValues,
    ExtractedTable,
    GroupCount,
    Pair,
    RowResult,
    SortedRow,
    ValCount,
)
from pilosa_tpu_torch.pql import is_write_query as _pql_is_write

_SERVICE = "proto.Pilosa"


# ---------------------------------------------------------------------------
# result -> wire rows
# ---------------------------------------------------------------------------

def _col(value, datatype: str) -> pb.ColumnResponse:
    c = pb.ColumnResponse()
    if datatype == "string":
        c.stringVal = str(value)
    elif datatype == "uint64":
        c.uint64Val = int(value)
    elif datatype == "int64":
        c.int64Val = int(value)
    elif datatype == "bool":
        c.boolVal = bool(value)
    elif datatype == "float64":
        c.float64Val = float(value)
    elif datatype == "timestamp":
        c.timestampVal = value.isoformat() if isinstance(
            value, dt.datetime) else str(value)
    elif datatype == "decimal":
        d = PyDecimal(str(value))
        sign, digits, exp = d.as_tuple()
        unscaled = int("".join(map(str, digits))) * (-1 if sign else 1)
        if exp > 0:
            unscaled *= 10 ** exp
            exp = 0
        c.decimalVal.value = unscaled
        c.decimalVal.scale = -exp
    elif datatype == "[]uint64":
        c.uint64ArrayVal.vals.extend(int(v) for v in value)
    elif datatype == "[]string":
        c.stringArrayVal.vals.extend(str(v) for v in value)
    else:
        c.stringVal = str(value)
    return c


def _headers(pairs) -> list[pb.ColumnInfo]:
    return [pb.ColumnInfo(name=n, datatype=t) for n, t in pairs]


def result_to_rows(result):
    """Yield (headers, row_columns) for one PQL result
    (server/grpc.go ResultToRowser dispatch)."""
    if isinstance(result, RowResult):
        if result.keys is not None:
            hdrs = _headers([("_id", "string")])
            for k in result.keys:
                yield hdrs, [_col(k, "string")]
        else:
            hdrs = _headers([("_id", "uint64")])
            for c in result.columns():
                yield hdrs, [_col(int(c), "uint64")]
    elif isinstance(result, list) and (not result or
                                       isinstance(result[0], Pair)):
        # TopN/TopK pairs (grpc.go pairsToRows)
        if result and result[0].key is not None:
            hdrs = _headers([("_id", "string"), ("count", "uint64")])
            for p in result:
                yield hdrs, [_col(p.key, "string"),
                             _col(p.count, "uint64")]
        else:
            hdrs = _headers([("_id", "uint64"), ("count", "uint64")])
            for p in result:
                yield hdrs, [_col(p.id, "uint64"),
                             _col(p.count, "uint64")]
    elif isinstance(result, ValCount):
        dtype = ("float64" if isinstance(result.value, float) else
                 "timestamp" if isinstance(result.value, dt.datetime) else
                 "int64")
        hdrs = _headers([("value", dtype), ("count", "int64")])
        yield hdrs, [_col(result.value if result.value is not None else 0,
                          dtype), _col(result.count, "int64")]
    elif isinstance(result, list) and result and \
            isinstance(result[0], GroupCount):
        first = result[0]
        names = []
        for g in first.group:
            names.append((g.get("field", "?"),
                          "string" if "key" in g else "uint64"))
        hdrs = _headers(names + [("count", "uint64")] +
                        ([("agg", "int64")] if first.agg is not None else []))
        for gc in result:
            cols = []
            for g in gc.group:
                if "key" in g:
                    cols.append(_col(g["key"], "string"))
                elif "value" in g:
                    cols.append(_col(g["value"], "uint64"))
                else:
                    cols.append(_col(g.get("row_id", 0), "uint64"))
            cols.append(_col(gc.count, "uint64"))
            if gc.agg is not None:
                cols.append(_col(gc.agg, "int64"))
            yield hdrs, cols
    elif isinstance(result, DistinctValues):
        hdrs = _headers([("value", "int64")])
        for v in result.values:
            yield hdrs, [_col(v, "int64")]
    elif isinstance(result, SortedRow):
        hdrs = _headers([("_id", "uint64"), ("value", "int64")])
        for c, v in zip(result.columns, result.values):
            yield hdrs, [_col(c, "uint64"), _col(v, "int64")]
    elif isinstance(result, ExtractedTable):
        hdrs = _headers([("_id", "uint64")] +
                        [(f["name"], "[]uint64") for f in result.fields])
        for col in result.columns:
            cols = [_col(col["column"], "uint64")]
            for rows in col["rows"]:
                if isinstance(rows, (list, tuple)):
                    cols.append(_col(rows, "[]uint64"))
                else:
                    cols.append(_col([] if rows is None else [rows],
                                     "[]uint64"))
            yield hdrs, cols
    elif isinstance(result, bool):
        yield _headers([("result", "bool")]), [_col(result, "bool")]
    elif isinstance(result, int):
        yield _headers([("count", "uint64")]), [_col(result, "uint64")]
    elif result is None:
        return
    else:
        yield _headers([("result", "string")]), [_col(result, "string")]


_SQL_DTYPE = {"int": "int64", "id": "uint64", "string": "string",
              "bool": "bool", "decimal": "decimal",
              "timestamp": "timestamp", "idset": "[]uint64",
              "stringset": "[]string"}


def sql_to_rows(res):
    hdrs = _headers([(n, _SQL_DTYPE.get(t, "string"))
                     for n, t in res.schema])
    for row in res.rows:
        cols = []
        for (n, t), v in zip(res.schema, row):
            if v is None:
                cols.append(_col("", "string"))
            else:
                cols.append(_col(v, _SQL_DTYPE.get(t, "string")))
        yield hdrs, cols


# ---------------------------------------------------------------------------
# service
# ---------------------------------------------------------------------------

class GRPCHandler:
    """Method implementations (server/grpc.go:38)."""

    def __init__(self, api, sql_engine=None, auth=None):
        self.api = api
        # the API's engine by default (and with it the serving-enabled
        # executor and its caches): gRPC SQL must not be a second
        # client of the memory ledger
        self.sql = sql_engine if sql_engine is not None else api.sql_engine
        self.auth = auth  # (authenticator, authorizer) or None

    # -- helpers -------------------------------------------------------

    def _check(self, ctx, index: str | None, write: bool) -> dict:
        """authn + authz gate (http_handler chkAuthZ analog); returns
        the validated claims ({} when auth is disabled)."""
        if self.auth is None:
            return {}
        from pilosa_tpu_torch.server.authn import AuthError
        authn, authz = self.auth
        md = dict(ctx.invocation_metadata() or ())
        token = md.get("authorization", "")
        try:
            claims = authn.authenticate(token)
        except AuthError as e:
            ctx.abort(grpc.StatusCode.UNAUTHENTICATED, str(e))
        if authz is None or index is None:
            return claims
        need = "write" if write else "read"
        if not authz.allowed(claims.get("groups", []), index, need):
            ctx.abort(grpc.StatusCode.PERMISSION_DENIED,
                      f"not authorized for {need} on {index}")
        return claims

    def _pql_results(self, request, ctx):
        """Raw executor results (api.query would JSON-serialize them;
        the wire mapping here needs the typed result objects).  Routed
        through the serving layer: concurrent RPC handler threads
        coalesce into shared device dispatches when it is enabled.

        Profile=true rides the invocation metadata (the wire message
        predates profiling): ``("profile", "true")`` returns the
        device-phase span tree — the same shape as the HTTP
        ``?profile=true`` response — as the ``profile-json`` trailing
        metadata entry."""
        self._check(ctx, request.index, write=_pql_is_write(request.pql))
        md = dict(ctx.invocation_metadata() or ())
        profile = md.get("profile", "").lower() == "true"
        # QoS admission intent rides the metadata like profile does
        # (("tenant", ...), ("priority", ...), ("deadline-ms", ...)) —
        # the gRPC twin of the X-Pilosa-* HTTP headers
        qos = None
        if any(k in md for k in ("tenant", "priority", "deadline-ms")):
            from pilosa_tpu_torch.executor.sched import QoS
            try:
                dl = (float(md["deadline-ms"])
                      if "deadline-ms" in md else None)
            except ValueError:
                dl = None
            qos = QoS.make(tenant=md.get("tenant"),
                           priority=md.get("priority"),
                           deadline_ms=dl)
        # cross-node trace propagation: ("trace-id", ...)
        # metadata is the gRPC twin of the X-Pilosa-Trace-Id header —
        # the query's flight record inherits the caller's id and the
        # serialized span tree returns as "trace-json" trailing
        # metadata (the response-trailer form HTTP carries in-body).
        # Inlined rather than flight.remote_leg (the canonical
        # scaffold the HTTP leg uses) because ONE tracer here serves
        # both the profile-json and trace-json trailers and trailer
        # assembly must happen inside the abort-safe finally.
        trace_id = md.get("trace-id")
        tracer = prev = prev_inh = None
        if profile or trace_id is not None:
            import json as _json

            from pilosa_tpu_torch.obs import tracing as _tr
            tracer = _tr.RecordingTracer()
            prev = _tr.push_thread_tracer(tracer)
        if trace_id is not None:
            from pilosa_tpu_torch.obs import flight as _fl
            prev_inh = _fl.inherit_trace(trace_id)
        try:
            return self.api.executor.execute_serving(
                request.index, request.pql, qos=qos)
        except Exception as e:
            # typed QoS outcomes keep their wire semantics: a shed is
            # RESOURCE_EXHAUSTED (retryable), an expired deadline is
            # DEADLINE_EXCEEDED — not a client argument error
            status = getattr(e, "status", None)
            if status == 503:
                ctx.abort(grpc.StatusCode.RESOURCE_EXHAUSTED, str(e))
            if status == 504:
                ctx.abort(grpc.StatusCode.DEADLINE_EXCEEDED, str(e))
            ctx.abort(grpc.StatusCode.INVALID_ARGUMENT, str(e))
        finally:
            if trace_id is not None:
                _fl.pop_inherit(prev_inh)
            if tracer is not None:
                _tr.pop_thread_tracer(prev)
                trailers = []
                if profile:
                    trailers.append(("profile-json", _json.dumps(
                        [s.to_dict() for s in tracer.roots])))
                if trace_id is not None:
                    node = getattr(self.api, "name", "") or "local"
                    trailers.append(("trace-json", _json.dumps(
                        {"node": node,
                         "spans": [_tr.span_to_wire(s)
                                   for s in tracer.roots]})))
                try:
                    ctx.set_trailing_metadata(tuple(trailers))
                except Exception:
                    pass  # aborted context: never mask the status

    # -- PQL -----------------------------------------------------------

    def QueryPQL(self, request, ctx):
        t0 = time.perf_counter()
        for result in self._pql_results(request, ctx):
            for hdrs, cols in result_to_rows(result):
                yield pb.RowResponse(
                    headers=hdrs, columns=cols,
                    duration=int((time.perf_counter() - t0) * 1e9))
                t0 = time.perf_counter()

    def QueryPQLUnary(self, request, ctx):
        t0 = time.perf_counter()
        table = pb.TableResponse()
        for result in self._pql_results(request, ctx):
            for hdrs, cols in result_to_rows(result):
                if not table.headers:
                    table.headers.extend(hdrs)
                table.rows.append(pb.Row(columns=cols))
        table.duration = int((time.perf_counter() - t0) * 1e9)
        return table

    # -- SQL -----------------------------------------------------------

    def _sql_results(self, request, ctx):
        claims = self._check(ctx, None, write=False)
        auth_check = None
        if self.auth is not None and self.auth[1] is not None:
            # per-statement table authz (the reference checks each
            # resolved table during SQL planning)
            auth_check = self.auth[1].sql_check(claims.get("groups", []))
        try:
            return self.sql.query(request.sql, auth_check=auth_check,
                                  write_guard=self.api._check_writable)
        except PermissionError as e:
            ctx.abort(grpc.StatusCode.PERMISSION_DENIED, str(e))
        except Exception as e:
            ctx.abort(grpc.StatusCode.INVALID_ARGUMENT, str(e))

    def QuerySQL(self, request, ctx):
        t0 = time.perf_counter()
        for res in self._sql_results(request, ctx):
            for hdrs, cols in sql_to_rows(res):
                yield pb.RowResponse(
                    headers=hdrs, columns=cols,
                    duration=int((time.perf_counter() - t0) * 1e9))
                t0 = time.perf_counter()

    def QuerySQLUnary(self, request, ctx):
        t0 = time.perf_counter()
        table = pb.TableResponse()
        for res in self._sql_results(request, ctx):
            for hdrs, cols in sql_to_rows(res):
                if not table.headers:
                    table.headers.extend(hdrs)
                table.rows.append(pb.Row(columns=cols))
        table.duration = int((time.perf_counter() - t0) * 1e9)
        return table

    # -- Inspect (server/grpc.go Inspect) ------------------------------

    def Inspect(self, request, ctx):
        self._check(ctx, request.index, write=False)
        idx = self.api.holder.index(request.index)
        if idx is None:
            ctx.abort(grpc.StatusCode.NOT_FOUND,
                      f"index not found: {request.index}")
        which = request.columns.WhichOneof("type")
        if which == "ids":
            cols = list(request.columns.ids.vals)
        elif which == "keys":
            tr = idx.column_translator
            found = tr.find_keys(*request.columns.keys.vals) if tr else {}
            cols = [found[k] for k in request.columns.keys.vals
                    if k in found]
        else:
            cols = []
        limit = request.limit or len(cols)
        cols = cols[request.offset:request.offset + limit]
        fields = [f for f in idx.fields.values()
                  if not request.filterFields
                  or f.name in request.filterFields]
        hdrs = _headers([("_id", "uint64")] +
                        [(f.name, "string") for f in fields])
        for c in cols:
            out = [_col(int(c), "uint64")]
            for f in fields:
                vals = self._field_values(f, int(c))
                out.append(_col(vals, "string"))
            yield pb.RowResponse(headers=hdrs, columns=out)

    def _field_values(self, f, col: int) -> str:
        from pilosa_tpu_torch.models.schema import FieldType
        shard, scol = divmod(col, f.width)
        if f.options.type.is_bsi:
            v = f.views.get(f.bsi_view)
            frag = v.fragment(shard) if v else None
            if frag is None or not frag.contains(0, scol):  # exists bit
                return ""
            mag = sum(1 << i for i in range(f.bit_depth)
                      if frag.contains(2 + i, scol))
            val = -mag if frag.contains(1, scol) else mag  # sign bit
            return str(f.int_to_value(val))
        from pilosa_tpu_torch.models.view import VIEW_STANDARD
        view = f.views.get(VIEW_STANDARD)
        frag = view.fragment(shard) if view else None
        if frag is None:
            return ""
        rows = [r for r in frag.row_ids if frag.contains(r, scol)]
        if f.options.type == FieldType.BOOL:
            return str(bool(rows and rows[-1] == 1)).lower() if rows else ""
        if f.options.keys:
            return ",".join(f.row_translator.translate_ids(rows))
        return ",".join(str(r) for r in rows)

    # -- index CRUD ----------------------------------------------------

    def CreateIndex(self, request, ctx):
        self._check(ctx, request.name, write=True)
        try:
            self.api.create_index(request.name, keys=request.keys)
        except ApiError as e:
            ctx.abort(grpc.StatusCode.ALREADY_EXISTS
                      if e.status == 409 else grpc.StatusCode.INVALID_ARGUMENT,
                      str(e))
        return pb.CreateIndexResponse()

    def GetIndex(self, request, ctx):
        self._check(ctx, request.name, write=False)
        if self.api.holder.index(request.name) is None:
            ctx.abort(grpc.StatusCode.NOT_FOUND,
                      f"index not found: {request.name}")
        return pb.GetIndexResponse(index=pb.Index(name=request.name))

    def GetIndexes(self, request, ctx):
        claims = self._check(ctx, None, write=False)
        names = sorted(self.api.holder.indexes)
        if self.auth is not None and self.auth[1] is not None:
            # filter to readable indexes (grpc.go GetAuthorizedIndexList)
            authz = self.auth[1]
            groups = claims.get("groups", [])
            names = [n for n in names if authz.allowed(groups, n, "read")]
        return pb.GetIndexesResponse(indexes=[
            pb.Index(name=n) for n in names])

    def DeleteIndex(self, request, ctx):
        self._check(ctx, request.name, write=True)
        try:
            self.api.delete_index(request.name)
        except ApiError as e:
            ctx.abort(grpc.StatusCode.NOT_FOUND, str(e))
        return pb.DeleteIndexResponse()


def _method_table(handler: GRPCHandler) -> dict:
    u, s = grpc.unary_unary_rpc_method_handler, \
        grpc.unary_stream_rpc_method_handler

    def mh(kind, fn, req, resp):
        return kind(fn, request_deserializer=req.FromString,
                    response_serializer=resp.SerializeToString)

    return {
        "CreateIndex": mh(u, handler.CreateIndex,
                          pb.CreateIndexRequest, pb.CreateIndexResponse),
        "GetIndexes": mh(u, handler.GetIndexes,
                         pb.GetIndexesRequest, pb.GetIndexesResponse),
        "GetIndex": mh(u, handler.GetIndex,
                       pb.GetIndexRequest, pb.GetIndexResponse),
        "DeleteIndex": mh(u, handler.DeleteIndex,
                          pb.DeleteIndexRequest, pb.DeleteIndexResponse),
        "QuerySQL": mh(s, handler.QuerySQL,
                       pb.QuerySQLRequest, pb.RowResponse),
        "QuerySQLUnary": mh(u, handler.QuerySQLUnary,
                            pb.QuerySQLRequest, pb.TableResponse),
        "QueryPQL": mh(s, handler.QueryPQL,
                       pb.QueryPQLRequest, pb.RowResponse),
        "QueryPQLUnary": mh(u, handler.QueryPQLUnary,
                            pb.QueryPQLRequest, pb.TableResponse),
        "Inspect": mh(s, handler.Inspect,
                      pb.InspectRequest, pb.RowResponse),
    }


class GRPCServer:
    """grpcServer (server/grpc.go:618 Serve wiring)."""

    def __init__(self, api, bind: str = "127.0.0.1:0", auth=None,
                 max_workers: int = 8):
        self.handler = GRPCHandler(api, auth=auth)
        self.server = grpc.server(
            futures.ThreadPoolExecutor(max_workers=max_workers))
        self.server.add_generic_rpc_handlers((
            grpc.method_handlers_generic_handler(
                _SERVICE, _method_table(self.handler)),))
        self.port = self.server.add_insecure_port(bind)

    @property
    def uri(self) -> str:
        return f"127.0.0.1:{self.port}"

    def start(self):
        self.server.start()
        return self

    def stop(self, grace: float = 0.5):
        self.server.stop(grace)
