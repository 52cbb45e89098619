"""The port's HTTP server against the JAX package's.

One node of each package serves the same seeded data (width 2048, four
shards; the port on the CPU), and the same requests, in order, go to
both: every route the port registers, with its error paths (400, 404,
409, a shed 503 with Retry-After), authentication and authorization
(401, 403), and the transaction 409s on PQL writes, imports and SQL
DML.  Status codes and JSON bodies must be equal, exactly, except for
the fields each case lists in its ``drop`` set:

- ``start``, ``runtime_ns``, ``deadline``, ``uptime_seconds``,
  ``uptime_s``, ``duration_ms``, ``id`` of a generated transaction:
  times and generated ids;
- ``version``: each package's own version string;
- ``cpu_arch``: "tpu" against the port's device type;
- ``shard_width`` in /info: the JAX package reports its module
  constant 2^20, the port the holder's width;
- ``profile``: span trees, whose names and timings are each engine's.

Answers that depend on what else ran in the process (metrics values,
flight records, logs, stack samples) are compared by status and shape
(keys, names), as each case says.  A coordinator's leg (a
``"remote": true`` body, whose column ids are already translated) and
the node-to-node routes of the cluster plane answer as the JAX node's
do.  A port node
on disk is also held to its own durability promise: every write it
acknowledged, through PQL or /ingest, reads back from its files while
another thread syncs the holder over and over."""

import io
import threading
import time

import numpy as np
import pytest

from pilosa_tpu.obs import faults as jax_faults
from pilosa_tpu.server.authn import Authenticator as JaxAuthenticator
from pilosa_tpu.server.authn import encode_jwt
from pilosa_tpu.server.authz import Authorizer as JaxAuthorizer
from pilosa_tpu_torch.obs import faults as port_faults
from pilosa_tpu_torch.server.authn import Authenticator
from pilosa_tpu_torch.server.authz import Authorizer
from pilosa_tpu_torch.models.holder import Holder
from pilosa_tpu_torch.server.http import Server
from torch_server_dual import W, build_holder, call, configs, \
    dual_servers, restore_globals, strip

TIMES = frozenset({"start", "runtime_ns", "deadline", "uptime_seconds",
                   "uptime_s", "duration_ms"})


@pytest.fixture(scope="module")
def nodes():
    jh, ph = build_holder("jax"), build_holder("port")
    with dual_servers(jh, ph) as pair:
        yield pair
    jh.close()
    ph.close()


def _npz(cols, bits=None, values=None) -> bytes:
    buf = io.BytesIO()
    arrays = {"cols": np.asarray(cols, dtype=np.int64)}
    for f, r in (bits or {}).items():
        arrays[f"bits/{f}"] = np.asarray(r, dtype=np.int64)
    for f, v in (values or {}).items():
        arrays[f"values/{f}"] = np.asarray(v, dtype=np.int64)
    np.savez(buf, **arrays)
    return buf.getvalue()


def _roaring_b64(cols) -> str:
    import base64

    from pilosa_tpu_torch.storage import roaring
    return base64.b64encode(roaring.encode(list(cols))).decode()


Q = "/index/i/query"
# (case id, method, path, JSON body or text, extra: dict of raw=, headers=,
# drop=) — run in this order against both nodes
CASES = [
    ("status", "GET", "/status", None, {}),
    ("info", "GET", "/info", None,
     {"drop": TIMES | {"version", "cpu_arch", "shard_width"}}),
    ("version", "GET", "/version", None, {"drop": {"version"}}),
    ("schema", "GET", "/schema", None, {}),
    ("shards-max", "GET", "/internal/shards/max", None, {}),
    ("shards-i", "GET", "/internal/shards/i", None, {}),
    ("shards-404", "GET", "/internal/shards/nope", None, {}),
    ("no-route", "GET", "/nope", None, {}),
    ("no-route-method", "DELETE", "/status", None, {}),
    ("count", "POST", Q, {"query": "Count(Row(a=1))"}, {}),
    ("reads", "POST", Q, {"query": "Count(Intersect(Row(a=1), Row(s=2))) "
                          "TopN(s, n=4) TopN(s, Row(a=0), n=3) "
                          "Sum(field=age) Sum(Row(a=2), field=price) "
                          "Min(field=age) Max(Row(a=3), field=age) "
                          "Count(Row(age > 60)) Count(Row(20 < age < 80))"},
     {}),
    ("groupby", "POST", Q, {"query": "GroupBy(Rows(a), Rows(m), "
                            "aggregate=Sum(field=age))"}, {}),
    ("rows-distinct", "POST", Q, {"query": "Rows(s) Distinct(field=age) "
                                  "Row(a=1) Row(age=17)"}, {}),
    ("shards-arg", "POST", Q, {"query": "Count(Row(a=1))",
                               "shards": [0, 2]}, {}),
    ("raw-pql", "POST", Q, "Count(Union(Row(a=1), Row(a=2)))", {}),
    ("profile", "POST", Q + "?profile=true", {"query": "Count(Row(s=1))"},
     {"drop": {"profile"}}),
    ("keyed-reads", "POST", "/index/k/query",
     {"query": "Row(tag=red) TopN(tag) Count(All()) "
               "GroupBy(Rows(tag))"}, {}),
    ("parse-error", "POST", Q, {"query": "Count(Row(a=1)"}, {}),
    ("bad-field", "POST", Q, {"query": "Count(Row(zz=1))"}, {}),
    ("bad-index", "POST", "/index/nope/query", {"query": "Count(All())"},
     {}),
    ("malformed-json-import", "POST", "/index/i/field/a/import", "{nope",
     {}),
    ("set-clear", "POST", Q, {"query": "Set(5, a=1) Set(2100, a=3) "
                              "Clear(5, a=1) Set(9, age=44)"}, {}),
    ("after-writes", "POST", Q, {"query": "Row(a=3) Count(Row(a=1)) "
                                 "Sum(field=age)"}, {}),
    ("sql-select", "POST", "/sql", {"sql": "SELECT COUNT(*) FROM i"}, {}),
    ("sql-select-rows", "POST", "/sql",
     {"sql": "SELECT _id, age, price FROM i WHERE age > 100 "
             "ORDER BY _id LIMIT 5"}, {}),
    ("sql-groupby", "POST", "/sql",
     {"sql": "SELECT a, COUNT(*), SUM(age) FROM i GROUP BY a"}, {}),
    ("sql-text", "POST", "/sql", "SELECT MAX(age) FROM i", {}),
    ("sql-insert", "POST", "/sql",
     {"sql": "INSERT INTO i (_id, a, age) VALUES (6000, 2, 33)"}, {}),
    ("sql-error", "POST", "/sql", {"sql": "SELECT nope FROM i"}, {}),
    ("sql-show", "POST", "/sql", {"sql": "SHOW TABLES"}, {}),
    ("create-index", "POST", "/index/x", {"options": {"keys": False}}, {}),
    ("create-index-409", "POST", "/index/x", {}, {}),
    ("create-index-400", "POST", "/index/Bad", {}, {}),
    ("create-field", "POST", "/index/x/field/f", {}, {}),
    ("create-int-field", "POST", "/index/x/field/v",
     {"options": {"type": "int", "min": -10, "max": 10}}, {}),
    ("create-field-409", "POST", "/index/x/field/f", {}, {}),
    ("create-field-404", "POST", "/index/nope/field/f", {}, {}),
    ("apply-schema", "POST", "/schema",
     {"indexes": [{"name": "y", "fields": [{"name": "g"}]}]}, {}),
    ("apply-schema-400", "POST", "/schema", {"indexes": [{"nom": 1}]}, {}),
    ("apply-schema-empty", "POST", "/schema", None, {}),
    ("import-bits", "POST", "/index/x/field/f/import",
     {"rows": [1, 1, 2], "columns": [3, 2050, 7]}, {}),
    ("import-values", "POST", "/index/x/field/v/import",
     {"columns": [3, 7], "values": [-4, 9]}, {}),
    ("import-clear", "POST", "/index/x/field/f/import",
     {"rows": [1], "columns": [3], "clear": True}, {}),
    ("import-mismatch", "POST", "/index/x/field/f/import",
     {"rows": [1, 2], "columns": [3]}, {}),
    ("import-404", "POST", "/index/x/field/nope/import",
     {"rows": [1], "columns": [3]}, {}),
    ("import-keys", "POST", "/index/k/field/tag/import",
     {"rowKeys": ["red", "teal"], "columnKeys": ["u1", "u99"]}, {}),
    ("import-columns", "POST", "/index/x/import-columns", None,
     {"raw": _npz([10, 11, 4097], bits={"f": [2, 2, 3]},
                  values={"v": [1, 2, 3]})}),
    ("import-columns-bad", "POST", "/index/x/import-columns", None,
     {"raw": b"not an npz"}),
    ("import-roaring", "POST", "/index/x/field/f/import-roaring/1",
     {"rows": {"5": _roaring_b64([0, 1, 100])}}, {}),
    ("row-roaring", "GET", "/index/x/field/f/row/5/roaring?shard=1", None,
     {}),
    ("x-reads", "POST", "/index/x/query",
     {"query": "Row(f=1) Row(f=2) Row(f=5) Sum(field=v) Count(All())"}, {}),
    ("ingest", "POST", "/index/x/ingest",
     {"writes": [{"field": "f", "rows": [7, 7], "columns": [1, 2049]},
                 {"field": "v", "columns": [1], "values": [5]},
                 {"field": "f", "rows": [7], "columns": [1],
                  "clear": True}]}, {}),
    ("ingest-keys", "POST", "/index/k/ingest",
     {"writes": [{"field": "tag", "rowKeys": ["green"],
                  "columnKeys": ["u200"]}]}, {}),
    ("ingest-empty", "POST", "/index/x/ingest", {"writes": []}, {}),
    ("ingest-no-field", "POST", "/index/x/ingest",
     {"writes": [{"rows": [1], "columns": [1]}]}, {}),
    ("ingest-bad-field", "POST", "/index/x/ingest",
     {"writes": [{"field": "nope", "rows": [1], "columns": [1]}]}, {}),
    ("ingest-mismatch", "POST", "/index/x/ingest",
     {"writes": [{"field": "f", "rows": [1, 2], "columns": [1]}]}, {}),
    ("after-ingest", "POST", "/index/x/query",
     {"query": "Row(f=7) Sum(field=v)"}, {}),
    ("after-ingest-k", "POST", "/index/k/query", {"query": "Row(tag=green)"},
     {}),
    ("translate-find", "POST", "/internal/translate/k/keys/find",
     {"keys": ["u1", "u2", "zzz"]}, {}),
    ("translate-create", "POST", "/internal/translate/k/keys/create",
     {"keys": ["u300"]}, {}),
    ("translate-field", "POST",
     "/internal/translate/k/keys/find?field=tag", {"keys": ["red", "no"]},
     {}),
    ("translate-ids", "POST", "/internal/translate/k/ids",
     {"ids": [1, 2, 3]}, {}),
    ("translate-400", "POST", "/internal/translate/i/keys/find",
     {"keys": ["a"]}, {}),
    ("standing-register", "POST", "/index/i/standing",
     {"query": "Count(Row(a=2))"}, {"drop": TIMES}),
    ("standing-sql", "POST", "/index/i/standing",
     {"sql": "SELECT COUNT(*) FROM i WHERE a = 1"}, {"drop": TIMES}),
    ("standing-bad", "POST", "/index/i/standing", {}, {}),
    ("standing-list", "GET", "/standing", None, {"drop": TIMES}),
    ("standing-write", "POST", Q, {"query": "Set(77, a=2)"}, {}),
    ("standing-poll", "POST", Q, {"query": "Count(Row(a=2))"}, {}),
    ("standing-debug", "GET", "/debug/standing", None, {"drop": TIMES}),
    ("standing-delete", "DELETE", "/standing/1", None, {}),
    ("standing-delete-404", "DELETE", "/standing/99", None, {}),
    ("standing-delete-400", "DELETE", "/standing/xx", None, {}),
    ("df-post", "POST", "/index/i/dataframe",
     {"rows": [{"_id": 1, "score": 2.5}, {"_id": 4097, "score": 1.0}]}, {}),
    ("df-get", "GET", "/index/i/dataframe", None, {}),
    ("df-apply", "POST", "/index/i/dataframe/apply",
     {"aggregate": "sum", "column": "score"}, {}),
    ("df-apply-bad", "POST", "/index/i/dataframe/apply",
     {"expr": "nope("}, {}),
    ("df-404", "GET", "/index/nope/dataframe", None, {}),
    ("txn-start", "POST", "/transaction",
     {"id": "t1", "exclusive": True, "timeout": 60}, {"drop": TIMES}),
    ("txn-get", "GET", "/transaction/t1", None, {"drop": TIMES}),
    ("txn-list", "GET", "/transactions", None, {"drop": TIMES}),
    ("txn-second", "POST", "/transaction", {"id": "t2"}, {}),
    ("txn-pql-409", "POST", Q, {"query": "Set(1, a=1)"}, {}),
    ("txn-read-ok", "POST", Q, {"query": "Count(Row(a=1))"}, {}),
    ("txn-import-409", "POST", "/index/x/field/f/import",
     {"rows": [1], "columns": [1]}, {}),
    ("txn-import-columns-409", "POST", "/index/x/import-columns", None,
     {"raw": _npz([1], bits={"f": [1]})}),
    ("txn-roaring-409", "POST", "/index/x/field/f/import-roaring/0",
     {"rows": {"1": _roaring_b64([1])}}, {}),
    ("txn-sql-409", "POST", "/sql",
     {"sql": "INSERT INTO i (_id, a) VALUES (1, 1)"}, {}),
    ("txn-sql-read-ok", "POST", "/sql", {"sql": "SELECT COUNT(*) FROM i"},
     {}),
    ("txn-finish", "POST", "/transaction/t1/finish", None, {"drop": TIMES}),
    ("txn-finish-404", "POST", "/transaction/t1/finish", None, {}),
    ("txn-get-404", "GET", "/transaction/t1", None, {}),
    ("txn-writes-land", "POST", Q, {"query": "Set(1, a=1)"}, {}),
    ("txn-sql-lands", "POST", "/sql",
     {"sql": "INSERT INTO i (_id, a) VALUES (2, 1)"}, {}),
    ("txn-after", "POST", Q, {"query": "Row(a=1)"}, {}),
    ("history", "GET", "/query-history", None, {"drop": TIMES}),
    ("long-queries", "GET", "/debug/long-queries", None, {}),
    ("login-400", "GET", "/login", None, {}),
    ("debug-faults", "GET", "/debug/faults", None, {}),
    ("debug-dax", "GET", "/debug/dax", None, {"rosters": True}),
    ("delete-field", "DELETE", "/index/x/field/v", None, {}),
    ("delete-field-404", "DELETE", "/index/x/field/v", None, {}),
    ("delete-index", "DELETE", "/index/y", None, {}),
    ("delete-index-404", "DELETE", "/index/y", None, {}),
    ("schema-after", "GET", "/schema", None, {}),
]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_route_matches_jax(nodes, case):
    _id, method, path, body, extra = case
    drop = frozenset(extra.get("drop", ()))
    js, ps = nodes
    got = [call(s, method, path, body, headers=extra.get("headers"),
                raw=extra.get("raw")) for s in (js, ps)]
    (jst, jh, jb), (pst, ph, pb) = got
    assert pst == jst, (jb, pb)
    assert ph.get("Content-Type") == jh.get("Content-Type")
    if extra.get("rosters"):
        # /debug/dax lists every live DAX worker and controller of the
        # process, each package its own (test_torch_dax_tier.py holds
        # their entries to the JAX package's): the same shape
        assert set(pb) == set(jb) == {"workers", "controllers"}
        for key, fields in (("workers", _HYDRATOR_KEYS),
                            ("controllers", _CONTROLLER_KEYS)):
            assert all(set(e) == fields for e in pb[key] + jb[key])
        return
    assert strip(pb, drop) == strip(jb, drop)


_HYDRATOR_KEYS = {"worker", "lazy", "blob", "budget_bytes", "resident_bytes",
                  "pressure", "hydrations", "evictions", "resident",
                  "assigned"}
_CONTROLLER_KEYS = {"workers", "standbys", "admitted", "overlay", "fenced",
                    "last_reconcile"}


# counters of the port's tracing plane (obs/runtime.py's garbage-collector
# passes, obs/audit.py's shadow time) that the JAX package does not keep
PORT_ONLY_METRICS = {"pilosa_audit_shadow_seconds_total",
                     "pilosa_gc_pause_seconds_total",
                     "pilosa_gc_passes_total"}

# routes whose answer depends on what else ran in the process: equal
# status and content type, and the listed top-level keys of each answer
SHAPE_CASES = [
    ("/metrics", None), ("/metrics.json", None), ("/debug/errors", None),
    ("/debug/allocs?top=3", None), ("/debug/profile?seconds=0.05", None),
    ("/debug/queries?limit=3", {"enabled", "matched", "queries"}),
    ("/debug/trace?n=2", None),
    ("/debug/slo", {"slos", "windows", "samples", "uptime_s"}),
    ("/debug/stats?limit=2", None),
    ("/debug/incidents", None), ("/debug/logs?limit=5",
                                 {"lines", "returned", "kept", "capacity"}),
    ("/debug/audit", None), ("/internal/diagnostics", None),
    ("/internal/perf-counters", None),
]


@pytest.mark.parametrize("path,keys", SHAPE_CASES,
                         ids=[c[0] for c in SHAPE_CASES])
def test_debug_route_shape_matches_jax(nodes, path, keys):
    js, ps = nodes
    (jst, jh, jb), (pst, ph, pb) = [call(s, "GET", path) for s in (js, ps)]
    assert (pst, ph.get("Content-Type")) == (jst, jh.get("Content-Type"))
    assert pst == 200
    if isinstance(jb, dict):
        # the port's statistics catalog has no multi-node attempt
        # summaries ("nodes") and no plan-executable cost gates
        # ("gates"; the port compiles no plans)
        missing = {"nodes", "gates"} if path.startswith("/debug/stats") \
            else set()
        extra = PORT_ONLY_METRICS if path == "/metrics.json" else set()
        assert set(pb) == (set(jb) - missing) | extra
        if keys is not None:
            assert set(pb) == keys
    elif path == "/metrics":
        def names(b):
            return {ln.split()[2] for ln in b.decode().splitlines()
                    if ln.startswith("# TYPE")}
        assert names(pb) == names(jb) | PORT_ONLY_METRICS


def test_slo_windows_match_jax(nodes):
    js, ps = nodes
    jb, pb = [call(s, "GET", "/debug/slo")[2] for s in (js, ps)]
    assert pb["windows"] == jb["windows"] == ["5m", "1h", "6h"]
    for name in ("latency", "availability"):
        assert set(pb["slos"][name]) == set(jb["slos"][name])
        assert pb["slos"][name]["objective"] == jb["slos"][name]["objective"]
        assert set(pb["slos"][name]["windows"]) == {"5m", "1h", "6h"}


def test_remote_leg_answers_400(nodes):
    """A coordinator's leg ("remote": true) runs with its column ids
    already translated: on the keyed index a raw column id answers as
    the JAX node's does, where the same body without "remote" is the
    400 both packages give a keyed index's raw id.  (The test keeps the
    name it had when the port refused remote legs.)"""
    js, ps = nodes
    kq = "/index/k/query"
    for body, want in (({"query": "Count(All())", "remote": True}, 200),
                       ({"query": "Count(ConstRow(columns=[1, 2]))",
                         "remote": True}, 200),
                       ({"query": "Count(ConstRow(columns=[1, 2]))"},
                        None)):
        for q in (Q, kq):
            (jst, _jh, jb), (pst, _ph, pb) = [call(s, "POST", q, body)
                                              for s in (js, ps)]
            assert (pst, pb) == (jst, jb), (q, body)
            if want is not None:
                assert pst == want


@pytest.mark.parametrize("method,path", [
    ("GET", "/internal/translate/k/partitions"),
    ("GET", "/internal/fragment/i/a/views"),
    ("GET", "/internal/backup/manifest"),
    ("POST", "/internal/restore/complete"),
])
def test_multi_node_routes_not_registered(nodes, method, path):
    """The node-to-node routes answer as the JAX node's: the keyed
    index's partitions, a field's views, and the backup and restore
    routes' 400 on a node without a data directory.  (The test keeps
    the name it had when the port did not register them.)"""
    js, ps = nodes
    (jst, _jh, jb), (pst, _ph, pb) = [call(s, method, path)
                                      for s in (js, ps)]
    assert (pst, pb) == (jst, jb)
    assert pst != 404


def test_shed_is_typed_503_with_retry_after():
    """A write backlog over its tenant's budget sheds with a typed 503
    and a Retry-After header in both packages: the window is held by an
    armed ``ingest-window-stall`` delay while more submits arrive."""
    jh, ph = build_holder("jax"), build_holder("port")
    try:
        with dual_servers(jh, ph, ingest_tenant_queue=1,
                          ingest_window_ms=0.0) as (js, ps):
            for srv, flt in ((js, jax_faults), (ps, port_faults)):
                flt.inject("ingest-window-stall", delay_s=1.0, times=1)
                out = []

                def post(c, srv=srv, out=out):
                    out.append(call(srv, "POST", "/index/i/ingest",
                                    {"writes": [{"field": "a", "rows": [1],
                                                 "columns": [c]}]}))
                first = threading.Thread(target=post, args=(100,))
                first.start()
                deadline = time.monotonic() + 10
                while (srv.stream._thread is None or srv.stream._pending) \
                        and time.monotonic() < deadline:
                    time.sleep(0.002)  # until the stalled window took it
                rest = [threading.Thread(target=post, args=(101 + i,))
                        for i in range(3)]
                for t in rest:
                    t.start()
                for t in [first] + rest:
                    t.join(30)
                statuses = sorted(o[0] for o in out)
                shed = [o for o in out if o[0] == 503]
                assert statuses[0] == 200 and shed, statuses
                for st, hdrs, body in shed:
                    assert body["type"] == "WriteBacklogError"
                    assert int(hdrs["Retry-After"]) >= 1
                flt.clear()
    finally:
        jh.close()
        ph.close()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_acknowledged_writes_survive_a_concurrent_sync(tmp_path,
                                                       monkeypatch, seed):
    """A port node on disk with ``[ingest] sync`` acknowledges a write
    only once it is on disk, also while another thread runs
    ``holder.sync()`` in a loop (the maintenance ticker's and SQL's
    sync): four clients send PQL Sets and four POST /ingest, each write
    to a row of its own, so that no later write marks the row dirty
    again.  The holder's files, reopened without a sync as after a
    kill, hold every acknowledged bit."""
    monkeypatch.setenv("RBF_NOSYNC", "1")
    path = str(tmp_path / "node")
    h = Holder(path=path, width=W)
    h.create_index("d").create_field("a")
    h.sync()
    n_writers, n_writes, n_shards = 8, 40, 8
    acked = [[] for _ in range(n_writers)]
    errors = []
    _, pcfg = configs()
    with restore_globals():
        srv = Server(holder=h, port=0, config=pcfg, device="cpu")
        srv.maintenance_interval = 3600.0  # this test's loop syncs
        srv.start()
        stop = threading.Event()

        def syncer():
            while not stop.is_set():
                h.sync()

        def writer(w):
            rng = np.random.default_rng([seed, w])
            for i in range(n_writes):
                row = w * n_writes + i
                cols = [int(c) for c in rng.choice(
                    W * n_shards, size=3, replace=False)]
                if w % 2:
                    pql = " ".join(f"Set({c}, a={row})" for c in cols)
                    st, _, body = call(srv, "POST", "/index/d/query",
                                       {"query": pql})
                else:
                    st, _, body = call(
                        srv, "POST", "/index/d/ingest",
                        {"writes": [{"field": "a", "rows": [row] * 3,
                                     "columns": cols}]})
                if st != 200:
                    errors.append((w, i, st, body))
                    return
                acked[w] += [(row, c) for c in cols]

        sync_thread = threading.Thread(target=syncer)
        sync_thread.start()
        writers = [threading.Thread(target=writer, args=(w,))
                   for w in range(n_writers)]
        try:
            for t in writers:
                t.start()
            for t in writers:
                t.join(120)
        finally:
            stop.set()
            sync_thread.join(60)
            srv.close()
    h.close()  # the files as they are: no sync on close
    assert not errors, errors[:3]
    h2 = Holder(path=path, width=W)
    h2.load_schema()
    try:
        f = h2.index("d").field("a")
        missing = []
        for row, c in (x for a in acked for x in a):
            frag = f.view("standard").fragment(c // W)
            if frag is None or not frag.contains(row, c % W):
                missing.append((row, c))
        assert sum(map(len, acked)) == n_writers * n_writes * 3
        assert not missing, (len(missing), missing[:5])
    finally:
        h2.close()


SECRET = b"s3cret"
POLICY = {"user-groups": {"readers": {"i": "read"},
                          "writers": {"i": "write"}},
          "admin": "admins"}


def _tok(groups):
    return {"Authorization": "Bearer " + encode_jwt(
        {"sub": "u", "groups": groups, "exp": time.time() + 600}, SECRET)}


@pytest.fixture(scope="module")
def auth_nodes():
    jh, ph = build_holder("jax"), build_holder("port")
    jauth = (JaxAuthenticator(SECRET), JaxAuthorizer(
        POLICY["user-groups"], POLICY["admin"]))
    pauth = (Authenticator(SECRET), Authorizer(
        POLICY["user-groups"], POLICY["admin"]))
    with dual_servers(jh, ph, auth=jauth, port_auth=pauth) as pair:
        yield pair
    jh.close()
    ph.close()


AUTH_CASES = [
    ("no-token", "POST", Q, {"query": "Count(All())"}, None),
    ("bad-token", "POST", Q, {"query": "Count(All())"},
     {"Authorization": "Bearer nope"}),
    ("wrong-secret", "POST", Q, {"query": "Count(All())"},
     {"Authorization": "Bearer " + encode_jwt(
         {"sub": "u", "groups": ["readers"], "exp": time.time() + 600},
         b"other")}),
    ("version-open", "GET", "/version", None, None),
    ("login", "GET", "/login", None, None),
    ("reader-read", "POST", Q, {"query": "Count(Row(a=1))"},
     _tok(["readers"])),
    ("reader-write-403", "POST", Q, {"query": "Set(1, a=1)"},
     _tok(["readers"])),
    ("writer-write", "POST", Q, {"query": "Set(1, a=1)"},
     _tok(["writers"])),
    ("reader-other-index-403", "POST", "/index/k/query",
     {"query": "Count(All())"}, _tok(["readers"])),
    ("reader-import-403", "POST", "/index/i/field/a/import",
     {"rows": [1], "columns": [1]}, _tok(["readers"])),
    ("reader-schema-filtered", "GET", "/schema", None, _tok(["readers"])),
    ("reader-schema-write-403", "POST", "/schema", {"indexes": []},
     _tok(["readers"])),
    ("reader-debug-403", "GET", "/debug/faults", None, _tok(["readers"])),
    ("reader-internal-403", "GET", "/internal/shards/max", None,
     _tok(["readers"])),
    ("reader-txn-403", "POST", "/transaction", {"id": "x"},
     _tok(["readers"])),
    ("reader-sql", "POST", "/sql", {"sql": "SELECT COUNT(*) FROM i"},
     _tok(["readers"])),
    ("reader-sql-other-403", "POST", "/sql",
     {"sql": "SELECT COUNT(*) FROM k"}, _tok(["readers"])),
    ("reader-sql-insert-403", "POST", "/sql",
     {"sql": "INSERT INTO i (_id, a) VALUES (3, 1)"}, _tok(["readers"])),
    ("admin-debug", "GET", "/debug/faults", None, _tok(["admins"])),
    ("admin-txn", "POST", "/transaction", {"id": "adm"},
     _tok(["admins"])),
    ("nobody-403", "POST", Q, {"query": "Count(All())"}, _tok(["x"])),
]


@pytest.mark.parametrize("case", AUTH_CASES, ids=[c[0] for c in AUTH_CASES])
def test_auth_matches_jax(auth_nodes, case):
    _id, method, path, body, headers = case
    js, ps = auth_nodes
    (jst, _jh, jb), (pst, _ph, pb) = [
        call(s, method, path, body, headers=headers) for s in (js, ps)]
    drop = TIMES | {"version", "url"}
    assert pst == jst, (jb, pb)
    assert strip(pb, drop) == strip(jb, drop)
