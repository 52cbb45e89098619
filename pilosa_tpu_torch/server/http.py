"""HTTP transport — the router and handlers over the API facade.

Reference: http_handler.go (route table :493-562, gorilla/mux) and
server.go (the Server wiring holder, executor and monitors).  Routes:

    POST   /index/{index}/query             PQL (?profile=true)
    POST   /sql                             SQL
    GET    /schema, POST /schema            schema, apply schema
    POST   /index/{index}, DELETE           create / delete an index
    POST   /index/{index}/field/{field}, DELETE   create / delete a field
    POST   /index/{index}/field/{field}/import    bits or values
    POST   /index/{index}/import-columns    .npz columnar import
    POST   /index/{index}/ingest            the streaming write plane
    POST   /index/{index}/standing, GET /standing, DELETE /standing/{id}
    POST   /internal/translate/{index}/keys/find|create, /ids (?field=)
    GET    /internal/shards/max, /internal/shards/{index}
    GET    /status /info /version /query-history /metrics /metrics.json
    GET    /login, /debug/*, /internal/diagnostics, /internal/perf-counters
    POST   /transaction, /transaction/{id}/finish; GET /transaction/{id},
           /transactions
    POST   /index/{index}/field/{field}/import-roaring/{shard}
    GET    /index/{index}/field/{field}/row/{row}/roaring
    POST   /index/{index}/dataframe, GET, POST .../dataframe/apply
    GET    /internal/translate/{index}/partitions,
           .../partition/{p}/snapshot, POST .../partition/{p}/restore
    GET    /internal/translate/{index}/field/{field}/snapshot, POST
           .../restore
    GET    /internal/fragment/{index}/{field}/views, and under
           /internal/fragment/{index}/{field}/{view}/{shard}: GET
           /checksums, /block/{b}, /state, /deltas; POST /block/{b},
           /rows (replica repair and the resharding transfer); POST
           /internal/fragment/{index}/{field}/{view}/checksums, the
           digests of many shards in one request (the port's own)
    GET    /internal/backup/manifest, /internal/backup/file;
    POST   /internal/restore/file, /internal/restore/complete

A query body with ``"remote": true`` is a coordinator's leg: its ids
are already translated (``Executor.execute(remote=True)``).  An
embedding service adds its own routes with ``add_route`` (the cluster
node's ``/debug/cluster/*`` and ``/internal/rebalance/*``).

``Server(device=None)`` serves from the CUDA card and raises without
one; ``device="cpu"`` runs the kernels' plain versions.  The server is
a stdlib ThreadingHTTPServer: handler threads call into the serving
layer, whose batch leader launches the kernels, and do nothing on
their own but parse and encode JSON.
"""

from __future__ import annotations

import json
import os
import re
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

from pilosa_tpu_torch.api import API, ApiError
from pilosa_tpu_torch.models.holder import Holder
from pilosa_tpu_torch.obs import metrics
from pilosa_tpu_torch.obs.logger import Logger, NopLogger


class _Httpd(ThreadingHTTPServer):
    # socketserver's default accept backlog is 5: under a client storm
    # concentrated by a node death, an overloaded-but-ALIVE node
    # starts refusing connects — which the cluster layer reads as
    # ANOTHER node dying (refused = definitive death)
    request_queue_size = 128


class Route:
    def __init__(self, method: str, pattern: str, fn,
                 admin_only: bool = False):
        self.method = method
        self.pattern = pattern  # kept for route-surface introspection
        self.re = re.compile("^" + re.sub(
            r"\{(\w+)\}", r"(?P<\1>[^/]+)", pattern) + "$")
        self.fn = fn
        self.admin_only = admin_only


class Server:
    """Wires holder + API + HTTP listener (server.go:46 analog)."""

    def __init__(self, holder: Holder | None = None, bind: str = "127.0.0.1",
                 port: int = 0, logger: Logger | None = None,
                 auth=None, api: API | None = None, config=None,
                 device=None):
        self._owns_holder = holder is None
        self.holder = holder if holder is not None else Holder()
        self.api = api if api is not None else API(self.holder, device)
        self.logger = logger or NopLogger()
        # serving path (executor/serving.py): handler threads route
        # queries through the cross-query micro-batcher and the
        # versioned result cache, as Config says ([serving]; load()
        # reads the PILOSA_TPU_SERVING_* environment)
        if config is None:
            from pilosa_tpu_torch import config as cfgmod
            config = cfgmod.load()
        config.check_supported()  # before any thread starts
        if self.api.executor.serving is None and (
                config.serving_batching or config.serving_cache_mb > 0):
            self.api.executor.enable_serving(
                window_s=config.serving_batch_window_ms / 1e3,
                max_batch=config.serving_batch_max,
                cache_bytes=config.serving_cache_mb << 20,
                batching=config.serving_batching,
                ragged=config.serving_ragged,
                admission=config.serving_admission,
                heavy_slots=config.serving_heavy_slots,
                queue_max=config.serving_queue_max,
                tenant_weights=config.serving_tenant_weights,
                default_deadline_ms=config.serving_default_deadline_ms)
        # every plane's switches ([memory], [roofline], [slo], [sql],
        # [timeq], [standing], [stats], [watchdog], [incidents],
        # [audit], ...): their configure() calls, the incident bundles
        # under the holder's directory
        config.apply_all(data_dir=self.holder.path)
        if (self.api.executor.serving is not None
                and config.memory_prefetch):
            self.api.executor.serving.start_prefetcher(
                interval_s=config.memory_prefetch_interval_s)
        # streaming write plane (ingest/stream.py): the batched
        # /index/{i}/ingest endpoint coalesces concurrent mutations
        # into durable windows; acks only after the WAL-synced land
        self.stream = None
        if config.ingest_stream:
            from pilosa_tpu_torch.ingest.stream import StreamWriter
            self.stream = StreamWriter(
                self.api,
                window_s=config.ingest_window_ms / 1e3,
                max_batch=config.ingest_max_batch,
                queue_max=config.ingest_queue,
                tenant_queue_max=config.ingest_tenant_queue,
                sync=config.ingest_sync)
        # an acknowledged write is durable on every write route, as it
        # is on /ingest: with [ingest] sync on and a holder on disk, a
        # write returns after its index's sync
        self.api.durable_writes = bool(config.ingest_sync
                                       and self.holder.path)
        # (Authenticator, Authorizer | None) — enables the chkAuthZ
        # middleware in dispatch (http_handler.go chkAuthZ)
        self.auth = auth
        self._routes: list[Route] = []
        self._register_routes()
        handler = _make_handler(self)
        self.httpd = _Httpd((bind, port), handler)
        self.port = self.httpd.server_address[1]
        self._thread: threading.Thread | None = None
        self._serving = False
        self.maintenance_interval = 60.0  # TTL sweep + flush cadence
        self._ticker_thread: threading.Thread | None = None
        self._ticker_stop = threading.Event()

    # -- lifecycle -----------------------------------------------------

    def serve_forever(self):
        self.logger.info("listening on :%d", self.port)
        self._serving = True
        self._start_tickers()
        self.httpd.serve_forever()

    def start(self):
        """Serve on a background thread (tests, embedded use)."""
        from pilosa_tpu_torch.obs import testhook
        testhook.opened("http.Server", self, f"port={self.port}")
        self._serving = True
        self._thread = threading.Thread(
            target=self.httpd.serve_forever, daemon=True)
        self._thread.start()
        self._start_tickers()
        return self

    def _start_tickers(self):
        """Holder maintenance loop: TTL view sweep + flush (the
        reference's cache-flush ticker, holder.go:1244, and TTL view
        removal, time.go:158)."""
        if self._ticker_thread is not None:
            return
        self._ticker_thread = threading.Thread(target=self._tick_loop,
                                               daemon=True)
        self._ticker_thread.start()

    def _tick_loop(self):
        # stall watchdog: the ticker drives TTL sweeps, flushes, SLO
        # sampling and stats folding — a tick wedged on a dead
        # disk must be a named stall, not silently stale telemetry
        from pilosa_tpu_torch.obs import watchdog
        watch = watchdog.register("maintenance-ticker")
        while not self._ticker_stop.wait(self.maintenance_interval):
            watch.stamp("tick")
            try:
                removed = self.holder.remove_expired_views()
                # quantum rollup ([timeq] rollup): completed fine
                # views OR-fold into their coarser parents so range
                # covers shrink as data ages
                from pilosa_tpu_torch.models import timeq
                folded = (self.holder.rollup_views()
                          if timeq.rollup_enabled() else [])
                for _ in folded:
                    metrics.TIMEQ_ROLLUP_TOTAL.inc()
                if removed or folded:
                    if removed:
                        self.logger.info("ttl removed %d views",
                                         len(removed))
                    if folded:
                        self.logger.info("rolled up %d views",
                                         len(folded))
                    # an expired/rolled quantum view invalidates
                    # derived state: the dropped fragments' gens were
                    # bumped (models/field.py), the serving result
                    # cache is swept eagerly so no cached Row/Count
                    # keeps serving the expired window, and standing
                    # registrations re-scope their quantum cover (one
                    # declared fallback each)
                    srv = self.api.executor.serving
                    if srv is not None and srv.cache is not None:
                        srv.cache.sweep(self.holder)
                        srv.standing.on_write()
                self.holder.sync()
                # SLO sample ring: one cumulative reading per tick so
                # burn-rate windows have history between scrapes
                from pilosa_tpu_torch.obs import slo
                slo.tick()
                # statistics catalog: fold pending flight records,
                # refresh the regression sentinel, snapshot on cadence
                from pilosa_tpu_torch.obs import stats
                stats.tick()
                # host/runtime stats (obs/diagnostics.py): refresh the
                # dormant collector so every incident bundle carries a
                # host snapshot that PREDATES its anomaly (phone-home
                # stays off — collection is in-process only)
                from pilosa_tpu_torch.obs import diagnostics
                diagnostics.collect()
                # correctness-audit scrubbers (obs/audit.py): sampled
                # ResultCache recomputes, standing drift checks at
                # quiesce, and — on cluster nodes — the replica
                # block-checksum scrub, each budgeted per tick
                from pilosa_tpu_torch.obs import audit
                audit.tick(self.api.executor.serving)
            except Exception as e:
                self.logger.error("maintenance tick failed: %s", e)
            finally:
                watch.idle()

    def close(self):
        """Stop the listener, the maintenance ticker, the stream
        writer and the serving layer's threads (prefetcher, audit
        workers), then close the holder if the server made it."""
        from pilosa_tpu_torch.obs import stats, testhook
        testhook.closed("http.Server", self)
        # save the statistics catalog (a node restarted within the
        # snapshot interval still plans warm) and detach its store when
        # it lives under this server's directory, so that later notes
        # do not append to a closed server's file; a sibling server's
        # store stays attached
        try:
            cat = stats.get()
            cat.save()
            if cat.store is not None and self.holder.path and \
                    cat.store.path.startswith(
                        os.path.join(self.holder.path, "")):
                cat.detach_store()
        except Exception as e:
            self.logger.warn("stats snapshot on close failed: %s", e)
        if self.api.executor.serving is not None:
            self.api.executor.serving.close()
        if self.stream is not None:
            self.stream.close()
        self._ticker_stop.set()
        if self._ticker_thread:
            self._ticker_thread.join(timeout=2)
        # shutdown() blocks on an event only serve_forever() sets —
        # calling it on a never-started server would deadlock
        if self._serving:
            self.httpd.shutdown()
        self.httpd.server_close()
        if self._thread:
            self._thread.join(timeout=5)
        if self._owns_holder:
            self.holder.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- routing -------------------------------------------------------

    def _register_routes(self):
        r = self._routes.append
        r(Route("POST", "/index/{index}/query", self._post_query))
        r(Route("POST", "/sql", self._post_sql))
        r(Route("GET", "/schema", self._get_schema))
        r(Route("POST", "/schema", self._post_schema))
        r(Route("POST", "/index/{index}", self._post_index))
        r(Route("DELETE", "/index/{index}", self._delete_index))
        r(Route("POST", "/index/{index}/field/{field}", self._post_field))
        r(Route("DELETE", "/index/{index}/field/{field}",
                self._delete_field))
        r(Route("POST", "/index/{index}/field/{field}/import",
                self._post_import))
        r(Route("POST", "/index/{index}/import-columns",
                self._post_import_columns))
        r(Route("POST", "/index/{index}/ingest", self._post_ingest))
        # standing queries (executor/standing.py): register/list/drop
        # write-through maintained subscriptions
        r(Route("POST", "/index/{index}/standing",
                self._post_standing))
        r(Route("GET", "/standing", self._get_standing))
        r(Route("DELETE", "/standing/{sid}", self._delete_standing))
        r(Route("POST", "/internal/translate/{index}/keys/find",
                self._post_translate_find))
        r(Route("POST", "/internal/translate/{index}/keys/create",
                self._post_translate_create))
        r(Route("POST", "/internal/translate/{index}/ids",
                self._post_translate_ids))
        r(Route("GET", "/internal/shards/max", self._get_shards_max))
        r(Route("GET", "/internal/shards/{index}",
                lambda req: self.api.available_shards(
                    req.vars["index"])))
        r(Route("GET", "/status", lambda req: self.api.status()))
        r(Route("GET", "/info", lambda req: self.api.info()))
        r(Route("GET", "/version", lambda req: self.api.version()))
        r(Route("GET", "/query-history",
                lambda req: self.api.query_history()))
        r(Route("GET", "/metrics", self._get_metrics))
        r(Route("GET", "/metrics.json", self._get_metrics_json))
        r(Route("GET", "/login", self._get_login))
        r(Route("GET", "/debug/errors", self._get_debug_errors))
        # profiling surface (http_handler.go:493-494 pprof/fgprof):
        # wall-clock stack sampler + heap snapshot + slow-query ring
        r(Route("GET", "/debug/profile", self._get_debug_profile))
        r(Route("GET", "/debug/allocs", self._get_debug_allocs))
        r(Route("GET", "/debug/long-queries",
                lambda req: self.api.long_queries()))
        # query flight recorder (obs/flight.py): recent per-query
        # records as JSON, and as Chrome trace_event JSON loadable in
        # Perfetto / chrome://tracing
        r(Route("GET", "/debug/queries", self._get_debug_queries))
        r(Route("GET", "/debug/trace", self._get_debug_trace))
        # SLO burn-rate plane (obs/slo.py): multi-window error-budget
        # burn over the latency histogram + typed-error counters
        r(Route("GET", "/debug/slo", self._get_debug_slo))
        # statistics catalog (obs/stats.py): per-field data stats +
        # per-fingerprint runtime profiles + the regression sentinel
        r(Route("GET", "/debug/stats", self._get_debug_stats))
        # fault-injection registry (obs/faults.py): armed rules with
        # fire counts — the chaos-operator's view of what is live
        r(Route("GET", "/debug/faults", self._get_debug_faults))
        # incident forensics plane (obs/incidents.py): black-box
        # bundle listing + fetch, the watchdog registry riding along
        r(Route("GET", "/debug/incidents", self._get_debug_incidents))
        # recent log-line ring (obs/logger.py) — the tail every
        # incident bundle attaches, served live for correlation
        r(Route("GET", "/debug/logs", self._get_debug_logs))
        # standing-query registry (executor/standing.py): live
        # registrations with per-query maintenance outcome counters
        r(Route("GET", "/debug/standing", self._get_debug_standing))
        # continuous correctness auditing (obs/audit.py): recent
        # samples, mismatch quarantine ring, scrub progress
        r(Route("GET", "/debug/audit", self._get_debug_audit))
        # disaggregated DAX tier (dax/worker.py + dax/controller.py):
        # worker roster with per-shard residency, placement overlay,
        # and the autoscaler's last reconcile decision
        r(Route("GET", "/debug/dax", self._get_debug_dax))
        r(Route("GET", "/internal/diagnostics", self._get_diagnostics))
        r(Route("GET", "/internal/perf-counters",
                self._get_perf_counters))
        r(Route("POST", "/transaction", self._post_transaction))
        r(Route("POST", "/transaction/{tid}/finish",
                lambda req: self.api.finish_transaction(req.vars["tid"])))
        r(Route("GET", "/transaction/{tid}",
                lambda req: self.api.get_transaction(req.vars["tid"])))
        r(Route("GET", "/transactions",
                lambda req: self.api.txns.list()))
        r(Route("POST",
                "/index/{index}/field/{field}/import-roaring/{shard}",
                self._post_import_roaring))
        r(Route("GET",
                "/index/{index}/field/{field}/row/{row}/roaring",
                self._get_row_roaring))
        r(Route("POST", "/index/{index}/dataframe", self._post_dataframe))
        r(Route("GET", "/index/{index}/dataframe", self._get_dataframe))
        r(Route("POST", "/index/{index}/dataframe/apply",
                self._post_dataframe_apply))
        # translation sync and replica repair (holder.go:1488-1715;
        # fragment.go checksum blocks)
        r(Route("GET", "/internal/translate/{index}/partitions",
                lambda req: self.api.translate_partitions(
                    req.vars["index"])))
        r(Route("GET",
                "/internal/translate/{index}/partition/{p}/snapshot",
                lambda req: self.api.translate_partition_snapshot(
                    req.vars["index"], int(req.vars["p"]))))
        r(Route("POST",
                "/internal/translate/{index}/partition/{p}/restore",
                lambda req: self.api.translate_restore_partition(
                    req.vars["index"], int(req.vars["p"]), req.json())))
        r(Route("GET",
                "/internal/translate/{index}/field/{field}/snapshot",
                lambda req: self.api.field_translate_snapshot(
                    req.vars["index"], req.vars["field"])))
        r(Route("GET", "/internal/fragment/{index}/{field}/views",
                lambda req: self.api.fragment_views(
                    req.vars["index"], req.vars["field"])))
        frag = "/internal/fragment/{index}/{field}/{view}/{shard}"

        def fv(req):
            v = req.vars
            return v["index"], v["field"], v["view"], int(v["shard"])
        r(Route("GET", frag + "/checksums",
                lambda req: self.api.fragment_checksums(*fv(req))))
        # the port's batched form: many shards' digests in one request
        r(Route("POST", "/internal/fragment/{index}/{field}/{view}/checksums",
                lambda req: self.api.fragment_checksums_many(
                    req.vars["index"], req.vars["field"], req.vars["view"],
                    (req.json() or {}).get("shards", []))))
        r(Route("GET", frag + "/block/{b}",
                lambda req: self.api.fragment_block(
                    *fv(req), int(req.vars["b"]))))
        # the online-resharding transfer: the resumable block push, the
        # copy's bootstrap state, and the delta chase's feed and apply
        r(Route("POST", frag + "/block/{b}",
                lambda req: self.api.fragment_set_block(
                    *fv(req), int(req.vars["b"]), req.json() or {})))
        r(Route("GET", frag + "/state",
                lambda req: self.api.fragment_state(*fv(req))))
        r(Route("GET", frag + "/deltas",
                lambda req: self.api.fragment_deltas(
                    *fv(req), int(req.query.get("since", ["0"])[0]))))
        r(Route("POST", frag + "/rows",
                lambda req: self.api.fragment_set_rows(
                    *fv(req), req.json() or {})))
        r(Route("POST",
                "/internal/translate/{index}/field/{field}/restore",
                lambda req: self.api.field_translate_restore(
                    req.vars["index"], req.vars["field"],
                    req.json() or {})))
        r(Route("GET", "/internal/backup/manifest",
                lambda req: self.api.backup_manifest()))
        r(Route("GET", "/internal/backup/file", self._get_backup_file))
        r(Route("POST", "/internal/restore/file", self._post_restore_file))
        r(Route("POST", "/internal/restore/complete",
                lambda req: self.api.restore_complete()))
    # paths served without a token when auth is enabled
    # (http_handler.go: login/metrics/version stay open)
    _OPEN_PATHS = {"/version", "/metrics", "/metrics.json", "/login"}

    def _get_debug_errors(self, req):
        """Recent captured errors (monitor.go events; /debug surface)."""
        from pilosa_tpu_torch.obs.monitor import global_monitor
        return global_monitor.recent()

    def _get_debug_profile(self, req):
        """fgprof-style wall-clock stack sample; ?seconds=&hz= bound
        the collection (defaults 2s @ 100Hz, capped at 30s).
        ?format=collapsed drops the header comment and attaches the
        body as a download — pure folded-stack lines for flamegraph
        tooling (flamegraph.pl / speedscope / inferno).  ?ring=1
        serves the CONTINUOUS profiler's merged ring instead of
        sampling live — the profile that was already running when
        something went wrong."""
        from pilosa_tpu_torch.obs import profiler
        collapsed = req.query.get(
            "format", [""])[0] == "collapsed"
        if req.query.get("ring", ["0"])[0] in ("1", "true"):
            c = profiler.continuous
            if c is None:
                raise ApiError("continuous profiler disabled "
                               "([incidents] profile=false)", 400)
            body = c.folded()
        else:
            seconds = min(30.0, float(
                req.query.get("seconds", ["2"])[0]))
            hz = min(1000, int(req.query.get("hz", ["100"])[0]))
            body = profiler.sample_stacks(seconds, hz,
                                          collapsed=collapsed)
        if collapsed:
            req.extra_headers["Content-Disposition"] = (
                "attachment; filename=pilosa-profile.folded")
        return RawResponse(body, "text/plain")

    def _get_debug_incidents(self, req):
        """Incident bundles (obs/incidents.py): the newest-first
        metadata listing plus the live watchdog registry, or ONE full
        bundle via ?id= (404 when unknown — never a half bundle; torn
        tmp files are invisible to both paths)."""
        from pilosa_tpu_torch.obs import incidents
        iid = req.query.get("id", [None])[0]
        if iid is not None:
            bundle = incidents.get().fetch(iid)
            if bundle is None:
                raise ApiError(f"no such incident: {iid}", 404)
            return bundle
        limit = int(req.query.get("limit", ["50"])[0])
        return incidents.get().payload(limit)

    def _get_debug_logs(self, req):
        """Recent log lines (obs/logger.py ring), oldest first —
        ?limit=N bounds the tail (default 200)."""
        from pilosa_tpu_torch.obs import logger
        limit = int(req.query.get("limit", ["200"])[0])
        lines = logger.ring.recent(limit)
        return {"lines": lines, "returned": len(lines),
                "kept": len(logger.ring),
                "capacity": logger.ring._ring.maxlen}

    def _get_debug_allocs(self, req):
        """tracemalloc heap snapshot (pprof allocs analog)."""
        from pilosa_tpu_torch.obs import profiler
        top = int(req.query.get("top", ["25"])[0])
        return RawResponse(profiler.heap_snapshot(top), "text/plain")

    def _get_debug_queries(self, req):
        """Recent flight records, newest first.  Filters (a 4k-record
        ring must stay greppable from curl):

            ?limit=N (alias ?n=)  newest N AFTER filtering
            ?route=fused|cached|direct|solo|cluster|ingest
            ?tenant=NAME          serving-path tenant attribution
            ?since_ms=EPOCH_MS    records started at/after this time
            ?audited=1|0          audit-sampled serves only (or the
                                  never-sampled remainder) — the hop
                                  from an audit-mismatch incident
                                  bundle to the query's full trace
        """
        from pilosa_tpu_torch.obs import flight
        q = req.query
        limit = int(q.get("limit", q.get("n", ["100"]))[0])
        # scan the whole ring, filter, then truncate — "matched" is
        # the pre-truncation count so curl users see how much more a
        # bigger limit would return (a debug endpoint can afford the
        # full-ring walk)
        recs = filter_flight_records(
            flight.recorder.recent(len(flight.recorder)),
            route=q.get("route", [None])[0],
            tenant=q.get("tenant", [None])[0],
            since_ms=q.get("since_ms", [None])[0],
            audited=q.get("audited", [None])[0])
        return {"enabled": flight.recorder.enabled,
                "matched": len(recs),
                "queries": recs[:max(0, limit)]}

    def _get_debug_slo(self, req):
        """SLO burn rates (obs/slo.py): samples the typed-error
        counters + latency histogram now and evaluates every
        configured window."""
        from pilosa_tpu_torch.obs import slo
        return slo.get().evaluate()

    def _get_debug_stats(self, req):
        """Statistics catalog (obs/stats.py): data stats per
        (index, field), runtime profiles per plan fingerprint, gate
        rates, per-node attempt summaries, and the active perf
        regressions.  Filters: ?index= ?fingerprint= ?limit=N
        (newest-N profiles)."""
        from pilosa_tpu_torch.obs import stats
        q = req.query
        limit = q.get("limit", [None])[0]
        return stats.get().payload(
            index=q.get("index", [None])[0],
            fingerprint=q.get("fingerprint", [None])[0],
            limit=int(limit) if limit is not None else None)

    def _get_debug_trace(self, req):
        """Recent flight records as Chrome trace_event JSON — save
        the body and open it in Perfetto (ui.perfetto.dev) or
        chrome://tracing."""
        from pilosa_tpu_torch.obs import flight
        n = int(req.query.get("n", ["100"])[0])
        return RawResponse(flight.recorder.chrome_trace_json(n),
                           "application/json")

    def _get_debug_faults(self, req):
        """Armed fault-point rules (obs/faults.py registry)."""
        from pilosa_tpu_torch.obs import faults
        return {"faults": faults.active()}

    def _get_diagnostics(self, req):
        from pilosa_tpu_torch import __version__
        from pilosa_tpu_torch.obs.diagnostics import Diagnostics
        return Diagnostics(version=__version__).payload()

    def _get_perf_counters(self, req):
        from pilosa_tpu_torch.obs.diagnostics import performance_counters
        return performance_counters.snapshot()

    def _get_login(self, req):
        if self.auth is None:
            raise ApiError("auth not enabled", 400)
        authn_, _ = self.auth
        return {"url": authn_.login_url()}

    def _check_auth(self, method: str, path: str, req,
                    admin_only: bool = False):
        """chkAuthZ middleware (http_handler.go chkAuthZ): validate the
        bearer token, then require read (GET) / write (other) on the
        route's index, or admin for /internal + schema writes."""
        req.auth_claims = {}
        if self.auth is None or path in self._OPEN_PATHS:
            return
        from pilosa_tpu_torch.server.authn import AuthError
        authn_, authz_ = self.auth
        try:
            claims = authn_.authenticate(req.headers.get("Authorization", ""))
        except AuthError as e:
            raise ApiError(str(e), 401)
        req.auth_claims = claims
        if authz_ is None:
            return
        groups = claims.get("groups", [])
        if admin_only or path.startswith("/internal") or \
                path.startswith("/transaction") or \
                path.startswith("/debug") or (
                path == "/schema" and method != "GET"):
            # transactions included: an exclusive transaction holds the
            # whole cluster read-only, so starting/finishing one is an
            # operator action
            if not authz_.is_admin(groups):
                raise ApiError("admin required", 403)
            return
        index = req.vars.get("index")
        if index is None:
            return
        if path.endswith("/query"):
            # reads POST too: permission follows the query's calls
            from pilosa_tpu_torch.pql import is_write_query
            body = req.json_lenient()
            pql = (body or {}).get("query") or req.text()
            need = "write" if is_write_query(pql) else "read"
        else:
            need = "read" if method == "GET" else "write"
        if not authz_.allowed(groups, index, need):
            raise ApiError(f"not authorized for {need} on {index}", 403)

    def add_route(self, method: str, pattern: str, fn,
                  admin_only: bool = True, override: bool = False):
        """Register an extra route (an embedding service's, such as the
        cluster node's).  Under auth it is admin-only by default: the
        per-index rules do not know it, and a node's control surface
        must not answer a read token.  ``override`` puts it ahead of
        the built-in routes."""
        rt = Route(method, pattern, fn, admin_only=admin_only)
        if override:
            self._routes.insert(0, rt)
        else:
            self._routes.append(rt)

    def dispatch(self, method: str, path: str, req) -> tuple[int, object]:
        for rt in self._routes:
            if rt.method != method:
                continue
            m = rt.re.match(path)
            if m:
                req.vars = m.groupdict()
                try:
                    self._check_auth(method, path, req,
                                     admin_only=rt.admin_only)
                    return 200, rt.fn(req)
                except ApiError as e:
                    return e.status, {"error": str(e)}
                except Exception as e:  # keep the connection alive
                    # typed status-carrying errors (LoadShedError 503,
                    # DeadlineExceeded 504, RemoteError pass-through)
                    # keep their semantics on the wire instead of
                    # collapsing into 500 — clients distinguish
                    # "shed, retry elsewhere" from "server bug"
                    status = getattr(e, "status", None)
                    if isinstance(status, int) and 400 <= status < 600:
                        ra = getattr(e, "retry_after_s", None)
                        if ra is not None:
                            # a shed is retryable by contract — say
                            # when (one heartbeat), per RFC 9110 §10.2.3
                            req.extra_headers = {
                                "Retry-After": str(max(1, round(ra)))}
                        # typed redirect/annotation surfaces
                        # (ShardMovedError's X-Pilosa-New-Owner +
                        # moved_shards body fields): the error type
                        # itself says what to attach
                        hdrs = getattr(e, "extra_headers", None)
                        if hdrs:
                            req.extra_headers.update(hdrs)
                        extra = getattr(e, "error_fields", None)
                        if extra:
                            return status, {"error": str(e),
                                            "type": type(e).__name__,
                                            **extra}
                        if status >= 500:
                            # 5xx pass-throughs (a peer's RemoteError
                            # 500, a shed) must not go dark in
                            # monitoring even though the wire keeps
                            # the typed status
                            from pilosa_tpu_torch.obs.monitor import (
                                capture_exception,
                            )
                            capture_exception(e, path=path,
                                              method=method)
                        return status, {"error": str(e),
                                        "type": type(e).__name__}
                    from pilosa_tpu_torch.obs.monitor import capture_exception
                    capture_exception(e, path=path, method=method)
                    self.logger.error("http 500 on %s: %s", path, e)
                    return 500, {"error": f"internal error: {e}"}
        return 404, {"error": f"no route: {method} {path}"}

    # -- handlers ------------------------------------------------------

    def _post_query(self, req):
        body = req.json_lenient()
        if body is not None:
            pql = body.get("query", "")
            shards = body.get("shards")
            # a coordinator's leg: its ids are already translated
            remote = bool(body.get("remote"))
        else:  # raw PQL body, like the reference's text/plain mode
            pql = req.text()
            shards = None
            remote = False
        profile = req.query.get("profile", ["false"])[0] == "true"
        trace_id = req.headers.get("X-Pilosa-Trace-Id")
        if trace_id is None:
            return self.api.query(req.vars["index"], pql, shards,
                                  profile, remote=remote,
                                  qos=_qos_from_headers(req.headers))
        # cross-node trace propagation: this node is a
        # remote leg of a cluster fan-out.  The query's flight record
        # inherits the coordinator's trace id (so the rings merge at
        # /debug/cluster/queries), the leg executes under ONE
        # recording span — attached to this handler thread via the
        # same thread-tracer machinery Profile=true uses — and the
        # serialized tree returns in the response's "trace" trailer
        # for the coordinator's per-node Perfetto lanes.
        from pilosa_tpu_torch.obs import flight
        parent = req.headers.get("X-Pilosa-Span-Parent", "")
        node = getattr(self.api, "name", "") or "local"
        with flight.remote_leg(trace_id) as (tracer, spans):
            with tracer.span(f"rpc:{req.vars['index']}", node=node,
                             **({"parent": parent} if parent else {})):
                resp = self.api.query(
                    req.vars["index"], pql, shards, profile,
                    remote=remote, qos=_qos_from_headers(req.headers))
        if spans:
            resp["trace"] = {"node": node, "spans": spans}
        return resp

    def _post_sql(self, req):
        body = req.json_lenient()
        stmt = body.get("sql", "") if body is not None else req.text()
        auth_check = None
        if self.auth is not None and self.auth[1] is not None:
            auth_check = self.auth[1].sql_check(
                req.auth_claims.get("groups", []))
        try:
            # the same QoS headers the PQL surface honors
            # (X-Pilosa-Tenant / -Priority / -Deadline-Ms): SELECT
            # statements admit through sched.py with per-statement
            # cost classes; shed/deadline render as typed 503/504
            return self.api.sql(stmt, auth_check=auth_check,
                                qos=_qos_from_headers(req.headers))
        except PermissionError as e:
            raise ApiError(str(e), 403)

    def _standing_registry(self):
        srv = self.api.executor.serving
        if srv is None or srv.cache is None:
            raise ApiError("standing queries require the serving "
                           "result cache", 400)
        return srv.standing

    def _post_standing(self, req):
        """Register a standing query: body {"query": "<PQL>"} or
        {"sql": "SELECT COUNT(*) ..."}.  The result is maintained
        write-through from ingest deltas; polls of the same query
        text serve the advanced entry (route "standing")."""
        from pilosa_tpu_torch.executor.standing import StandingUnsupported
        reg = self._standing_registry()
        body = req.json_lenient() or {}
        try:
            if body.get("sql"):
                return reg.register_sql(self.api.sql_engine,
                                        body["sql"])
            if not body.get("query"):
                raise ApiError(
                    "body requires \"query\" (PQL) or \"sql\"", 400)
            return reg.register(req.vars["index"], body["query"])
        except StandingUnsupported as e:
            raise ApiError(str(e), 400)

    def _get_standing(self, req):
        return {"standing": self._standing_registry().list_info()}

    def _delete_standing(self, req):
        reg = self._standing_registry()
        try:
            sid = int(req.vars["sid"])
        except ValueError:
            raise ApiError("standing id must be an integer", 400)
        if not reg.unregister(sid):
            raise ApiError(f"standing query not found: {sid}", 404)
        return {"removed": sid}

    def _get_debug_standing(self, req):
        """Standing-query registry: registrations with maintenance
        outcome counters (incremental/fallback/noop) — the operator
        view of whether subscriptions stay on the O(delta) path."""
        from pilosa_tpu_torch.executor import standing as _standing
        reg = self._standing_registry()
        return {"enabled": _standing.enabled(),
                "standing": reg.list_info()}

    def _get_debug_audit(self, req):
        """Continuous correctness auditing (obs/audit.py): sampler
        config, per-kind/outcome counters, recent samples, the
        mismatch quarantine ring, and scrub progress."""
        from pilosa_tpu_torch.obs import audit
        srv = self.api.executor.serving
        return audit.payload(getattr(srv, "audit", None)
                             if srv is not None else None)

    def _get_debug_dax(self, req):
        """Disaggregated-tier state: every in-process worker's
        residency (dax/worker.py) and every controller's roster +
        last reconcile decision.  A plain cluster node answers with
        empty rosters — only modules ALREADY imported are consulted,
        so the debug sweep never drags the DAX stack in."""
        import sys
        payload: dict = {"workers": [], "controllers": []}
        wmod = sys.modules.get("pilosa_tpu_torch.dax.worker")
        if wmod is not None:
            payload["workers"] = wmod.hydrator_payloads()
        cmod = sys.modules.get("pilosa_tpu_torch.dax.controller")
        if cmod is not None:
            payload["controllers"] = cmod.controller_payloads()
        return payload

    def _post_import_columns(self, req):
        """Binary columnar import — the wire form of
        API.import_columns for out-of-process ingesters (the
        reference's IDK clones POST binary shard payloads the same
        way, idk/ingest.go:319 -> ImportRoaringShard).  Body: an
        .npz with 'cols' plus 'bits/<field>' row-id and
        'values/<field>' value arrays."""
        import io

        import numpy as np
        try:
            z = np.load(io.BytesIO(req.raw()))
        except Exception as e:
            raise ApiError(f"malformed npz payload: {e}", 400)
        if not isinstance(z, np.lib.npyio.NpzFile):
            # a bare .npy body parses as an ndarray — still a 400
            raise ApiError("payload must be an .npz archive", 400)
        with z:
            if "cols" not in z.files:
                raise ApiError("payload missing 'cols'", 400)
            cols = z["cols"]
            bits = {k.split("/", 1)[1]: z[k] for k in z.files
                    if k.startswith("bits/")}
            values = {k.split("/", 1)[1]: z[k] for k in z.files
                      if k.startswith("values/")}
        n = self.api.import_columns(req.vars["index"], cols,
                                    bits=bits, values=values)
        return {"imported": n}

    def _post_ingest(self, req):
        """Batched streaming ingest (the write-side analog of the
        serving read batcher): every write in the body is admitted to
        the coalescing window plane and the request returns only
        after they all DURABLY landed — a 200 is an ack in the
        commit-after-land sense.  Backlog over budget → typed 503
        with Retry-After.  Body::

            {"writes": [
              {"field": f, "rows": [...], "columns": [...]},
              {"field": f, "columns": [...], "values": [...]},
              {"field": f, "rowKeys": [...], "columnKeys": [...]},
            ]}
        """
        if self.stream is None:
            raise ApiError("streaming ingest disabled "
                           "([ingest] stream=false)", 400)
        body = req.json() or {}
        writes = body.get("writes")
        if not isinstance(writes, list) or not writes:
            raise ApiError("body must carry a non-empty 'writes' "
                           "list", 400)
        index = req.vars["index"]
        muts = []
        try:
            for w in writes:
                field = w.get("field")
                if not field:
                    raise ApiError("every write needs a field", 400)
                cols = w.get("columns")
                if w.get("columnKeys") is not None:
                    cols = self.api.translate_keys(
                        index, None, w["columnKeys"], create=True)
                rows = w.get("rows")
                if w.get("rowKeys") is not None:
                    rows = self.api.translate_keys(
                        index, field, w["rowKeys"], create=True)
                try:
                    muts.append(self.stream.submit(
                        index, field, rows=rows, cols=cols,
                        values=w.get("values"),
                        timestamps=w.get("timestamps"),
                        clear=bool(w.get("clear", False)),
                        wait=False))
                except (KeyError, ValueError) as e:
                    raise ApiError(str(e), 400)
            self.stream.wait(muts, timeout=60.0)
        finally:
            # never leave un-awaited mutations: a shed mid-list must
            # still wait out the already-admitted ones (they land
            # regardless; the client retry is idempotent).  ONE
            # shared deadline across the list — a per-mutation 60 s
            # against a stalled plane would pin this worker thread
            # for 60 s x N
            deadline = time.monotonic() + 60.0
            for m in muts:
                m.event.wait(
                    timeout=max(0.0, deadline - time.monotonic()))
        return {"landed": sum(m.n for m in muts),
                "windows": len({m.window_id for m in muts})}

    def _post_import_roaring(self, req):
        """Roaring import (route shape of /import-roaring in
        http_handler.go): {"rows": {rowID: base64-roaring}, "clear"}."""
        body = req.json() or {}
        n = self.api.import_roaring(
            req.vars["index"], req.vars["field"],
            int(req.vars["shard"]), body.get("rows", {}),
            clear=bool(body.get("clear")))
        return {"imported": n}

    def _get_backup_file(self, req):
        rel = req.query.get("path", [""])[0]
        return RawResponse(self.api.backup_file(rel),
                           "application/octet-stream")

    def _post_restore_file(self, req):
        rel = req.query.get("path", [""])[0]
        self.api.restore_file(rel, req._raw or b"")
        return {}

    def _get_row_roaring(self, req):
        shard = int(req.query.get("shard", ["0"])[0])
        data = self.api.export_roaring(
            req.vars["index"], req.vars["field"], shard,
            int(req.vars["row"]))
        return RawResponse(data, "application/octet-stream")

    def _df(self, req):
        from pilosa_tpu_torch.models.dataframe import DataframeError
        idx = self.api.holder.index(req.vars["index"])
        if idx is None:
            raise ApiError(f"index not found: {req.vars['index']}", 404)
        return idx.dataframe

    def _post_dataframe(self, req):
        """Append rows to the index dataframe (arrow.go ingest;
        http_handler.go:506 route)."""
        body = req.json() or {}
        df = self._df(req)
        try:
            df.add_rows(body.get("rows", []))
        except Exception as e:
            raise ApiError(str(e), 400)
        df.maybe_save()  # amortized; holder.sync flushes the tail
        return {"rows": df.n_rows}

    def _get_dataframe(self, req):
        df = self._df(req)
        return {"schema": df.schema(), "rows": df.n_rows}

    def _post_dataframe_apply(self, req):
        from pilosa_tpu_torch.models.dataframe import DataframeError
        body = req.json() or {}
        df = self._df(req)
        try:
            if "aggregate" in body:
                # on the node's device, as its queries run
                return {"result": df.aggregate(
                    body["aggregate"], body["column"],
                    device=self.api.executor.device)}
            return {"result": df.apply(body.get("expr", ""),
                                       body.get("columns"))}
        except DataframeError as e:
            raise ApiError(str(e), 400)

    def _post_transaction(self, req):
        body = req.json_lenient() or {}
        return self.api.start_transaction(
            id=body.get("id"), exclusive=bool(body.get("exclusive")),
            timeout=body.get("timeout"))

    def _get_schema(self, req):
        schema = self.api.schema()
        if self.auth is not None and self.auth[1] is not None:
            groups = req.auth_claims.get("groups", [])
            authz_ = self.auth[1]
            schema = {"indexes": [
                ix for ix in schema.get("indexes", [])
                if authz_.allowed(groups, ix["name"], "read")]}
        return schema

    def _post_schema(self, req):
        body = req.json()
        if body is None:
            raise ApiError("request body required", 400)
        self.api.apply_schema(body)
        return {}

    def _post_index(self, req):
        body = req.json() or {}
        opts = body.get("options", body)
        return self.api.create_index(
            req.vars["index"], keys=bool(opts.get("keys", False)),
            track_existence=bool(opts.get("trackExistence",
                                          opts.get("track_existence", True))))

    def _delete_index(self, req):
        self.api.delete_index(req.vars["index"])
        return {}

    def _post_field(self, req):
        body = req.json() or {}
        return self.api.create_field(
            req.vars["index"], req.vars["field"], body.get("options", body))

    def _delete_field(self, req):
        self.api.delete_field(req.vars["index"], req.vars["field"])
        return {}

    def _post_import(self, req):
        body = req.json() or {}
        kw = dict(index=req.vars["index"], field=req.vars["field"],
                  clear=bool(body.get("clear", False)))
        if "values" in body:
            n = self.api.import_values(
                cols=body.get("columns"), values=body.get("values"),
                col_keys=body.get("columnKeys"), **kw)
        else:
            n = self.api.import_bits(
                rows=body.get("rows"), cols=body.get("columns"),
                row_keys=body.get("rowKeys"),
                col_keys=body.get("columnKeys"),
                timestamps=body.get("timestamps"), **kw)
        return {"imported": n}

    def _post_translate_find(self, req):
        body = req.json() or {}
        return self.api.translate_keys(
            req.vars["index"], req.query.get("field", [None])[0],
            body.get("keys", []), create=False)

    def _post_translate_create(self, req):
        body = req.json() or {}
        return self.api.translate_keys(
            req.vars["index"], req.query.get("field", [None])[0],
            body.get("keys", []), create=True)

    def _post_translate_ids(self, req):
        body = req.json() or {}
        return self.api.translate_ids(
            req.vars["index"], req.query.get("field", [None])[0],
            body.get("ids", []))

    def _get_shards_max(self, req):
        return {"standard": self.api.shard_max()}

    def _get_metrics(self, req):
        from pilosa_tpu_torch.obs import flight
        flight.flush_metrics()  # drain buffered phase samples first
        # exemplars are EXPLICITLY opt-in (?exemplars=1): the classic
        # 0.0.4 text parser fails the whole scrape on a mid-line '#',
        # and advertising OpenMetrics via Accept-header negotiation
        # would be worse — Prometheus sends that header by default and
        # its OpenMetrics parser rejects this exposition (no '# EOF',
        # classic counter naming), failing every stock scrape
        if req.query.get("exemplars", ["0"])[0] in ("1", "true"):
            return RawResponse(
                metrics.registry.render_text(openmetrics=True),
                "text/plain; version=0.0.4")
        return RawResponse(metrics.registry.render_text(),
                           "text/plain; version=0.0.4")

    def _get_metrics_json(self, req):
        from pilosa_tpu_torch.obs import flight
        flight.flush_metrics()  # JSON scrapes see current data too
        return metrics.registry.render_json()


def filter_flight_records(recs: list, route=None, tenant=None,
                          since_ms=None, audited=None) -> list:
    """The /debug/queries filter predicates (route / tenant /
    since_ms / audited)."""
    if route is not None:
        recs = [r for r in recs if r.get("route") == route]
    if tenant is not None:
        recs = [r for r in recs if r.get("tenant") == tenant]
    if since_ms is not None:
        cut = float(since_ms) / 1e3
        recs = [r for r in recs if r.get("start", 0.0) >= cut]
    if audited is not None:
        want = str(audited).lower() not in ("0", "false", "")
        recs = [r for r in recs if bool(r.get("audited")) == want]
    return recs


def _qos_from_headers(headers):
    """QoS admission intent from the request headers:

        X-Pilosa-Tenant:      fair-queueing tenant (default "default")
        X-Pilosa-Priority:    "point" | "heavy" class override
        X-Pilosa-Deadline-Ms: client's total latency budget

    None when no QoS header is present (the serving layer then applies
    its configured defaults)."""
    tenant = headers.get("X-Pilosa-Tenant")
    priority = headers.get("X-Pilosa-Priority")
    deadline = headers.get("X-Pilosa-Deadline-Ms")
    if tenant is None and priority is None and deadline is None:
        return None
    from pilosa_tpu_torch.executor.sched import QoS
    try:
        dl = float(deadline) if deadline is not None else None
    except ValueError:
        dl = None
    return QoS.make(tenant=tenant, priority=priority, deadline_ms=dl)


class RawResponse:
    def __init__(self, body: str | bytes, content_type: str):
        self.body = body
        self.content_type = content_type


HTTPServer = Server  # alias matching the reference's naming


def _make_handler(server: Server):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        # request helpers -------------------------------------------------
        def _body(self) -> bytes:
            n = int(self.headers.get("Content-Length", 0) or 0)
            return self.rfile.read(n) if n else b""

        def json(self):
            """Parse the body as a JSON object; 400 on malformed JSON
            or a non-object body, None when the body is empty."""
            raw = self._raw or b""
            if not raw:
                return None
            try:
                v = json.loads(raw)
            except json.JSONDecodeError as e:
                raise ApiError(f"malformed JSON body: {e}", 400)
            if not isinstance(v, dict):
                raise ApiError("JSON body must be an object", 400)
            return v

        def json_lenient(self):
            """For endpoints with a raw-text fallback mode (/sql and
            PQL query bodies): parsed JSON dict, or None."""
            try:
                return self.json()
            except ApiError:
                return None

        def text(self) -> str:
            return (self._raw or b"").decode("utf-8", "replace")

        def raw(self) -> bytes:
            return self._raw or b""

        # dispatch --------------------------------------------------------
        def _handle(self, method: str):
            u = urlparse(self.path)
            self.query = parse_qs(u.query)
            # always drain the body: unread bytes on a keep-alive
            # connection would be parsed as the next request line
            self._raw = self._body()
            self.extra_headers = {}  # reset across keep-alive requests
            status, result = server.dispatch(method, u.path, self)
            self._send(status, result)
            metrics.HTTP_REQUESTS.inc(
                method=method, path=u.path.split("/")[1] or "/",
                status=str(status))

        def _send(self, status: int, result):
            if isinstance(result, RawResponse):
                body = (result.body if isinstance(result.body, bytes)
                        else result.body.encode())
                ctype = result.content_type
            else:
                body = json.dumps(result).encode()
                ctype = "application/json"
            self.send_response(status)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            for k, v in getattr(self, "extra_headers", {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            self._handle("GET")

        def do_POST(self):
            self._handle("POST")

        def do_DELETE(self):
            self._handle("DELETE")

        def log_message(self, fmt, *args):
            server.logger.debug("http: " + fmt, *args)

    return Handler
