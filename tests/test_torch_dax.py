"""The port's DAX tier against the JAX package's: directives, write-log
durability, snapshot+replay recovery, poller-driven rebalance, the
queryer's PQL and SQL fronts (tests/test_dax.py's cases).

Each case runs one scenario on the JAX ``DAXService`` and on the port's
``DAXService(device="cpu")`` (tests/torch_dax_dual.py) on the same
seeded inputs, asserts test_dax.py's expectations on each, and asserts
the two packages' records (wire answers, SQL rows, held shards,
write-log lines and snapshot bytes) equal."""

import contextlib
import threading
import time

import pytest

from torch_dax_dual import SCHEMA, SHARD, dax_globals, dual, seed


@pytest.fixture(autouse=True)
def _globals():
    with dax_globals():
        yield


@contextlib.contextmanager
def service(pk, d, n_workers=3):
    svc = pk.DAXService(str(d / "svc"), n_workers=n_workers)
    try:
        yield svc
    finally:
        svc.close()


def held_map(svc) -> dict:
    return {w.address: {t: sorted(s) for t, s in w.held.items()}
            for w in svc.workers}


def test_writelogger_roundtrip(tmp_path):
    def run(pk, d):
        wl = pk.WriteLogger(str(d / "wl"))
        v1 = wl.append("t", 0, {"op": "bits", "rows": [1], "cols": [2]})
        v2 = wl.append("t", 0, {"op": "bits", "rows": [1], "cols": [3]})
        assert (v1, v2) == (1, 2)
        rec = {"all": wl.replay("t", 0),
               "from1": wl.replay("t", 0, from_version=1)}
        wl.truncate_through("t", 0, 1)
        assert wl.version("t", 0) == 2
        rec["after"] = (wl.replay("t", 0, from_version=1),
                        wl.replay("t", 0, from_version=2),
                        wl.version("t", 0), wl.shards("t"))
        with open(wl._log_path("t", 0), "rb") as f:
            rec["log"] = f.read()
        with open(wl._log_path("t", 0) + ".base", "rb") as f:
            rec["base"] = f.read()
        assert rec["after"] == ([rec["all"][1]], [], 2, [0])
        return rec
    dual(run, tmp_path)


def test_snapshotter_versions(tmp_path):
    def run(pk, d):
        s = pk.Snapshotter(str(d / "sn"))
        assert s.latest("t", 0) is None
        s.write("t", 0, 3, b"aaa")
        s.write("t", 0, 7, b"bbb")
        assert s.latest("t", 0) == (7, b"bbb")
        import os
        return sorted(os.listdir(d / "sn"))
    dual(run, tmp_path)


def test_directive_assigns_shards(tmp_path):
    def run(pk, d):
        with service(pk, d) as svc:
            seed(svc, 6)
            held, total = set(), 0
            for w in svc.workers:
                held |= w.held.get("t", set())
                total += len(w.held.get("t", ()))
            assert held == set(range(6)) and total == 6
            return held_map(svc)
    dual(run, tmp_path)


def test_placement_balanced_and_stable(tmp_path):
    def run(pk, d):
        addrs = ["w0", "w1", "w2"]
        before = {s: pk.place("t", s, addrs) for s in range(300)}
        counts = {a: list(before.values()).count(a) for a in addrs}
        assert min(counts.values()) > 50
        after = {s: pk.place("t", s, addrs + ["w3"]) for s in range(300)}
        moved = [s for s in before if after[s] != before[s]]
        assert all(after[s] == "w3" for s in moved)
        assert len(moved) < 120
        return before, after
    dual(run, tmp_path)


def test_dax_query_fan_out(tmp_path):
    def run(pk, d):
        with service(pk, d) as svc:
            seed(svc, 6)
            q = svc.queryer.query
            rec = [q("t", "Count(Row(f=1))"), q("t", "Row(f=1)"),
                   q("t", "Sum(Row(f=1), field=v)")]
            assert rec[0]["results"] == [6]
            assert rec[1]["results"][0]["columns"] == \
                [s * SHARD + 7 for s in range(6)]
            assert rec[2]["results"][0] == {"value": 210, "count": 6}
            return rec
    dual(run, tmp_path)


def test_worker_death_recovery(tmp_path):
    def run(pk, d):
        with service(pk, d) as svc:
            seed(svc, 6)
            victim = svc.workers[0]
            svc.kill_worker(victim.address)
            dead = svc.controller.poll_once()
            assert victim.address in dead
            rec = [svc.queryer.query("t", "Count(Row(f=1))"),
                   svc.queryer.query("t", "Sum(Row(f=1), field=v)")]
            assert rec[0]["results"] == [6]
            assert rec[1]["results"][0]["count"] == 6
            return dead, rec, svc.controller.assignments()
    dual(run, tmp_path)


def test_snapshot_plus_log_tail_recovery(tmp_path):
    """Snapshot a shard, write more, then move the shard: the new owner
    loads snapshot + replays only the tail.  The snapshot's bytes are
    equal in both packages."""
    def run(pk, d):
        with service(pk, d) as svc:
            seed(svc, 3)
            addr, _ = svc.controller.worker_for("t", 0)
            owner = next(w for w in svc.workers if w.address == addr)
            owner.snapshot_shard("t", 0)
            ver = svc.wl.version("t", 0)
            snap = svc.snaps.latest("t", 0)
            assert snap[0] == ver
            svc.wl.truncate_through("t", 0, ver)
            svc.queryer.import_bits("t", "f", [2], [5])
            svc.kill_worker(addr)
            svc.controller.poll_once()
            rec = [svc.queryer.query("t", "Count(Row(f=1))")["results"],
                   svc.queryer.query("t", "Count(Row(f=2))")["results"]]
            assert rec == [[3], [1]]
            return snap, rec
    dual(run, tmp_path)


def test_stale_directive_ignored(tmp_path):
    def run(pk, d):
        with service(pk, d) as svc:
            seed(svc, 2)
            w = svc.workers[0]
            v = w.directive_version
            w.apply_directive(pk.Directive(address=w.address,
                                           version=v - 1,
                                           assignments={"t": []}))
            assert w.directive_version == v
            return v, held_map(svc)
    dual(run, tmp_path)


def test_worker_rejects_unassigned_shard_write(tmp_path):
    def run(pk, d):
        with service(pk, d) as svc:
            seed(svc, 2)
            addr, _ = svc.controller.worker_for("t", 0)
            other = next(w for w in svc.workers if w.address != addr)
            with pytest.raises(pk.RemoteError) as e:
                pk.InternalClient()._request(
                    other.uri, "POST", "/dax/import", {
                        "op": "bits", "table": "t", "shard": 0,
                        "field": "f", "rows": [1], "cols": [1]})
            assert e.value.status == 409
            return e.value.status
    dual(run, tmp_path)


def test_dax_sql_fronting(tmp_path):
    def run(pk, d):
        with service(pk, d) as svc:
            q = svc.queryer
            rec = [q.sql("CREATE TABLE ev (_id id, code int min 0 max "
                         "1000, f id)")]
            assert "ev" in svc.controller.tables
            ins = ("INSERT INTO ev (_id, code, f) VALUES " +
                   ", ".join(f"({s * SHARD + 1}, {s * 10}, 1)"
                             for s in range(5)))
            for stmt in (ins, "SELECT count(*) FROM ev WHERE f = 1",
                         "SELECT sum(code) FROM ev",
                         "SELECT count(*) FROM ev WHERE code >= 20",
                         "SELECT _id, code FROM ev ORDER BY code DESC "
                         "LIMIT 2",
                         "DELETE FROM ev WHERE code < 20",
                         "SELECT count(*) FROM ev"):
                rec.append(q.sql(stmt))
            assert [r["data"] for r in rec[1:]] == [
                [[5]], [[5]], [[100]], [[3]],
                [[4 * SHARD + 1, 40], [3 * SHARD + 1, 30]], rec[6]["data"],
                [[3]]]
            with pytest.raises(pk.SQLError) as e:
                q.sql("SELECT ev._id FROM ev JOIN ev2 ON ev.f = ev2._id")
            return rec, str(e.value)
    dual(run, tmp_path)


def test_dax_sql_groupby_agg_and_replace(tmp_path):
    def run(pk, d):
        with service(pk, d) as svc:
            q = svc.queryer
            q.sql("CREATE TABLE g (_id id, r id, v int min 0 max 1000)")
            q.sql("INSERT INTO g (_id, r, v) VALUES (1, 1, 10), "
                  "(2, 1, 20), (3, 2, 5)")
            rec = [sorted(q.sql("SELECT r, sum(v) FROM g GROUP BY r")
                          ["data"]),
                   sorted(q.sql("SELECT v, count(*) FROM g GROUP BY v")
                          ["data"])]
            assert rec == [[[1, 30], [2, 5]], [[5, 1], [10, 1], [20, 1]]]
            q.sql("REPLACE INTO g (_id, r) VALUES (1, 2)")
            rec.append(q.sql("SELECT count(*) FROM g WHERE r = 1")["data"])
            rec.append(q.sql("SELECT count(*) FROM g WHERE v IS NOT NULL")
                       ["data"])
            assert rec[2:] == [[[1]], [[2]]]
            q.sql("DROP TABLE g")
            assert "g" not in svc.controller.tables
            with pytest.raises(pk.SQLError):
                q.sql("SELECT count(*) FROM g")
            rec.append(q.sql("CREATE TABLE g (_id id, r id)"))
            return rec
    dual(run, tmp_path)


def test_dax_sql_order_by_timestamp_desc(tmp_path):
    def run(pk, d):
        with service(pk, d) as svc:
            q = svc.queryer
            q.sql("CREATE TABLE ts (_id id, t timestamp)")
            q.sql("INSERT INTO ts (_id, t) VALUES "
                  f"(1, '2021-01-01T00:00'), ({SHARD + 2}, "
                  f"'2023-01-01T00:00'), ({2 * SHARD + 3}, "
                  f"'2022-01-01T00:00')")
            r = q.sql("SELECT _id FROM ts ORDER BY t DESC")
            assert [row[0] for row in r["data"]] == \
                [SHARD + 2, 2 * SHARD + 3, 1]
            return r, q.sql("SELECT _id, t FROM ts")
    dual(run, tmp_path)


def test_dax_sql_bulk_insert_and_sort_offset(tmp_path):
    def run(pk, d):
        with service(pk, d) as svc:
            q = svc.queryer
            q.sql("CREATE TABLE b (_id id, v int min 0 max 10000)")
            rows = "\n".join(f"{s * SHARD + 1},{s * 10}" for s in range(6))
            rec = [q.sql(f"BULK INSERT INTO b (_id, v) FROM '{rows}' "
                         "WITH FORMAT 'CSV' INPUT 'STREAM'"),
                   q.sql("SELECT count(*) FROM b"),
                   q.query("b", "Sort(All(), field=v, offset=2, limit=3)"),
                   q.sql("SELECT _id FROM b ORDER BY v LIMIT 2 OFFSET 1")]
            assert rec[0]["data"] == [[6]] and rec[1]["data"] == [[6]]
            assert rec[2]["results"][0]["values"] == [20, 30, 40]
            assert [r[0] for r in rec[3]["data"]] == \
                [SHARD + 1, 2 * SHARD + 1]
            return rec
    dual(run, tmp_path)


def test_directive_push_is_delta(tmp_path):
    def run(pk, d):
        with service(pk, d) as svc:
            seed(svc, 4)
            before = {w.address: w.directive_version for w in svc.workers}
            addr, _ = svc.controller.worker_for("t", 17)
            svc.controller.add_shards("t", [17])
            changed = [w.address for w in svc.workers
                       if w.directive_version != before[w.address]]
            assert changed == [addr], (changed, addr)
            return changed, held_map(svc)
    dual(run, tmp_path)


def test_rebalance_under_load_no_data_loss(tmp_path):
    """A worker killed mid-ingest: every acknowledged write survives.
    The writes that land depend on timing, so the record compared is
    the outcome."""
    def run(pk, d):
        with service(pk, d) as svc:
            svc.queryer.apply_schema(SCHEMA)
            acked, stop = [], threading.Event()

            def ingest():
                i = 0
                deadline = time.time() + 30
                while i < 400 and time.time() < deadline and \
                        (not stop.is_set() or len(acked) < 60):
                    col = (i % 8) * SHARD + i
                    try:
                        svc.queryer.import_bits("t", "f", [1], [col])
                        acked.append(col)
                    except Exception:
                        time.sleep(0.01)
                    i += 1
                stop.set()

            t = threading.Thread(target=ingest)
            t.start()
            time.sleep(0.15)
            svc.kill_worker(svc.workers[1].address)
            svc.controller.poll_once()
            time.sleep(0.3)
            stop.set()
            t.join(timeout=30)
            assert not t.is_alive()
            got = set(svc.queryer.query("t", "Row(f=1)")
                      ["results"][0]["columns"])
            missing = [c for c in acked if c not in got]
            assert not missing, f"{len(missing)} acknowledged writes lost"
            assert len(acked) > 50
            return {"lost": missing, "over_50": len(acked) > 50,
                    "workers": sorted(svc.controller.workers)}
    dual(run, tmp_path)


def test_dax_sql_shape_support_matrix(tmp_path):
    def run(pk, d):
        with service(pk, d) as svc:
            q = svc.queryer
            q.apply_schema({"indexes": [
                {"name": "s", "fields": [
                    {"name": "g", "options": {"type": "mutex"}},
                    {"name": "n", "options": {"type": "int", "min": 0,
                                              "max": 100}}]},
                {"name": "s2", "fields": [
                    {"name": "m", "options": {"type": "int", "min": 0,
                                              "max": 100}}]},
            ]})
            q.sql("INSERT INTO s (_id, g, n) VALUES (1, 10, 5), "
                  "(2, 20, 7), (3, 10, 9)")
            q.sql("INSERT INTO s2 (_id, m) VALUES (1, 5), (2, 9)")
            cases = [
                ("SELECT count(*) FROM s", [[3]]),
                ("SELECT count(*) FROM s WHERE n > 5", [[2]]),
                ("SELECT sum(n) FROM s", [[21]]),
                ("SELECT g, count(*) FROM s GROUP BY g",
                 [[10, 2], [20, 1]]),
                ("SELECT DISTINCT g FROM s", [[10], [20]]),
                ("SELECT _id FROM s WHERE g = 10 ORDER BY _id LIMIT 1",
                 [[1]]),
                ("SELECT s._id FROM s JOIN s2 ON s.n = s2.m", [[1], [3]]),
                ("SELECT n, count(*) FROM s GROUP BY n",
                 [[5, 1], [7, 1], [9, 1]]),
            ]
            rec = []
            for stmt, want in cases:
                got = q.sql(stmt)["data"]
                assert sorted(map(repr, got)) == sorted(map(repr, want)), \
                    (stmt, got)
                rec.append(sorted(map(repr, got)))
            q.sql("CREATE TABLE sk (_id id, k string); "
                  "INSERT INTO sk (_id, k) VALUES (1, 'x')")
            rec.append(q.sql("SELECT _id FROM sk WHERE k = 'x'")["data"])
            q.sql("CREATE TABLE sk2 (_id string, k int); "
                  "INSERT INTO sk2 (_id, k) VALUES ('a', 1)")
            rec.append(q.sql("SELECT _id FROM sk2 WHERE k = 1")["data"])
            assert rec[-2:] == [[[1]], [["a"]]]
            return rec
    dual(run, tmp_path)


def test_controller_restart_loses_nothing(tmp_path):
    def run(pk, d):
        with service(pk, d) as svc:
            cols = seed(svc, 6)
            before = svc.queryer.query("t", "Row(f=1)")
            assert set(before["results"][0]["columns"]) == set(cols)
            old = svc.controller
            versions = {w.address: w.directive_version
                        for w in svc.workers}
            fresh = svc.restart_controller()
            assert fresh is not old
            assert sorted(fresh.workers) == sorted(old.workers)
            assert fresh.tables["t"] == set(range(6))
            assert [ix["name"] for ix in fresh.schema["indexes"]] == ["t"]
            fresh.poll_once()
            assert {w.address: w.directive_version
                    for w in svc.workers} == versions
            after = svc.queryer.query("t", "Row(f=1)")
            new_col = 7 * SHARD + 3
            svc.queryer.import_bits("t", "f", [1], [new_col])
            got = svc.queryer.query("t", "Row(f=1)")
            assert new_col in set(got["results"][0]["columns"])
            moved = [w.address for w in svc.workers
                     if w.directive_version != versions[w.address]]
            assert len(moved) == 1
            return before, after, got, moved
    dual(run, tmp_path)


def test_controller_restart_after_worker_death(tmp_path):
    def run(pk, d):
        with service(pk, d) as svc:
            cols = seed(svc, 6)
            fresh = svc.restart_controller()
            victim = svc.workers[0]
            svc.kill_worker(victim.address)
            dead = fresh.poll_once()
            assert victim.address in dead
            r = svc.queryer.query("t", "Row(f=1)")
            assert set(r["results"][0]["columns"]) == set(cols)
            return dead, r
    dual(run, tmp_path)


def test_dax_bulk_insert_typechecks(tmp_path):
    def run(pk, d):
        with service(pk, d) as svc:
            svc.queryer.apply_schema({"indexes": [
                {"name": "bt", "fields": [
                    {"name": "a", "options": {"type": "int", "min": 0,
                                              "max": 100}}]}]})
            with pytest.raises(pk.SQLError, match="mismatch in the count"):
                svc.queryer.sql(
                    "BULK INSERT INTO bt (_id, a) map (0 ID, 1 INT) "
                    "transform(@0) FROM x'1,5' "
                    "with format 'CSV' input 'STREAM'")
            svc.queryer.sql(
                "BULK INSERT INTO bt (_id, a) map (0 ID, 1 INT) "
                "transform(@0, @1) FROM x'1,5\n2,7' "
                "with format 'CSV' input 'STREAM'")
            got = svc.queryer.sql("SELECT _id, a FROM bt")["data"]
            assert sorted(map(tuple, got)) == [(1, 5), (2, 7)]
            return sorted(map(tuple, got))
    dual(run, tmp_path)


def _front_req(front, method, path, body=None):
    import http.client
    import json
    c = http.client.HTTPConnection("127.0.0.1", front.port, timeout=30)
    c.request(method, path, body=body)
    out = json.loads(c.getresponse().read())
    c.close()
    return out


def test_queryer_http_front(tmp_path):
    import json

    def run(pk, d):
        with service(pk, d) as svc:
            cols = seed(svc, 6)
            front = svc.serve_queryer()
            try:
                rec = [_front_req(front, "POST", "/sql",
                                  "SELECT count(*) FROM t"),
                       _front_req(front, "POST", "/queryer/t",
                                  json.dumps({"query": "Count(Row(f=1))"})),
                       _front_req(front, "GET", "/dax/status")]
            finally:
                front.close()
            assert rec[0]["data"] == [[len(cols)]]
            assert rec[1]["results"][0] == len(cols)
            assert len(rec[2]["workers"]) == 3
            assert rec[2]["tables"]["t"] == sorted(c // SHARD for c in cols)
            return rec
    dual(run, tmp_path)


def test_queryer_front_json_sql_form(tmp_path):
    import json

    def run(pk, d):
        with service(pk, d) as svc:
            seed(svc, 2)
            front = svc.serve_queryer()
            out = _front_req(front, "POST", "/sql",
                             json.dumps({"sql": "SELECT count(*) FROM t"}))
            assert out["data"] == [[2]]
            return out
    dual(run, tmp_path)


def test_dax_runs_reference_sql_corpus_sample(tmp_path):
    from tests.sql_defs_ref import FAMILIES
    from tests.test_sql_ref_conformance import canon, conv_exp

    pick = {"defs_having.go:selectHavingTests",
            "defs_between.go:betweenTests",
            "defs_between.go:notBetweenTests",
            "defs_distinct.go:distinctTests",
            "defs_orderby.go:orderByTests",
            "defs_groupby.go:groupByTests",
            "defs_join.go:joinTestsUsers",
            "defs_join.go:joinTestsOrders",
            "defs_join.go:joinTestsQuantity",
            "defs_join.go:joinTests"}
    fam = [(o, s, c) for o, s, c in FAMILIES if o in pick]
    assert len(fam) == len(pick)

    def run(pk, d):
        rec = []
        with service(pk, d) as svc:
            q = svc.queryer
            for origin, setup, cases in fam:
                for s in setup or []:
                    q.sql(s)
                for cname, sql, exp in cases:
                    if isinstance(exp, tuple) and exp and \
                            exp[0] == "error":
                        with pytest.raises(pk.SQLError) as exc:
                            q.sql(sql)
                        assert exp[1].lower() in str(exc.value).lower(), \
                            (origin, cname)
                        rec.append((cname, "error", str(exc.value)))
                        continue
                    got = [tuple(r) for r in q.sql(sql)["data"]]
                    expc = [tuple(conv_exp(c) for c in r) for r in exp]
                    if expc and got and all(len(r) < len(got[0])
                                            for r in expc):
                        w = max(len(r) for r in expc)
                        got = [r[:w] for r in got]
                        expc = [r[:w] for r in expc]
                    assert canon(got) == canon(expc), (origin, cname, got,
                                                       expc)
                    rec.append((cname, repr(got)))
        assert len(rec) >= 60
        return rec
    dual(run, tmp_path)


def test_keyed_translation_survives_service_restart(tmp_path):
    def run(pk, d):
        svc = pk.DAXService(str(d), n_workers=2)
        q = svc.queryer
        q.sql("CREATE TABLE sk (_id id, k string)")
        q.sql("INSERT INTO sk (_id, k) VALUES (1, 'x'), (2, 'y')")
        rec = [q.sql("SELECT _id FROM sk WHERE k = 'y'")["data"]]
        svc.close()
        svc2 = pk.DAXService(str(d), n_workers=2)
        try:
            q2 = svc2.queryer
            rec.append(q2.sql("SELECT _id FROM sk WHERE k = 'y'")["data"])
            q2.sql("INSERT INTO sk (_id, k) VALUES (3, 'z')")
            rec.append(sorted(map(tuple, q2.sql("SELECT _id, k FROM sk")
                                  ["data"])))
        finally:
            svc2.close()
        assert rec == [[[2]], [[2]], [(1, "x"), (2, "y"), (3, "z")]]
        return rec
    dual(run, tmp_path)


def test_dax_keyed_table_end_to_end(tmp_path):
    def run(pk, d):
        with service(pk, d) as svc:
            q = svc.queryer
            q.sql("CREATE TABLE kt (_id string, an_int int min 0 max 100, "
                  "a_string string)")
            q.sql("INSERT INTO kt (_id, an_int, a_string) VALUES "
                  "('one', 11, 'str1'), ('two', 22, 'str2'), "
                  "('three', 33, 'str3')")
            rec = [sorted(map(tuple, q.sql(
                "SELECT _id, an_int, a_string FROM kt")["data"])),
                q.sql("SELECT _id FROM kt WHERE an_int = 22")["data"],
                q.sql("SELECT _id FROM kt WHERE a_string = 'str3'")["data"],
                q.sql("SELECT count(*) FROM kt")["data"]]
            assert rec == [[("one", 11, "str1"), ("three", 33, "str3"),
                            ("two", 22, "str2")], [["two"]], [["three"]],
                           [[3]]]
            return rec
    dual(run, tmp_path)


def test_dax_sql_bool_explicit_null_clears(tmp_path):
    def run(pk, d):
        with service(pk, d) as svc:
            q = svc.queryer
            q.sql("CREATE TABLE singleboolfield (_id id, a_bool bool)")
            q.sql("insert into singleboolfield (_id, a_bool) values "
                  "(1, true), (2, true), (3, false), (4, false), "
                  "(5, null), (6, null)")
            rec = [q.sql("select * from singleboolfield")]
            q.sql("insert into singleboolfield (_id, a_bool) values "
                  "(1, false), (2, null), (3, true), (4, null), "
                  "(5, false), (6, true)")
            rec.append(q.sql("select * from singleboolfield"))
            assert [r["data"] for r in rec] == [
                [[1, True], [2, True], [3, False], [4, False], [5, None],
                 [6, None]],
                [[1, False], [2, None], [3, True], [4, None], [5, False],
                 [6, True]]]
            return rec
    dual(run, tmp_path)


def test_dax_raw_pql_keyed_translation(tmp_path):
    def run(pk, d):
        with service(pk, d) as svc:
            q = svc.queryer
            q.sql("CREATE TABLE kt (_id id, tag stringset)")
            q.sql("INSERT INTO kt (_id, tag) VALUES (1, ('a','b')), "
                  "(2, ('b'))")
            rec = [q.query("kt", "Count(Row(tag='b'))")["results"],
                   q.query("kt", "Count(Row(tag='a'))")["results"],
                   q.query("kt", "Count(Row(tag='zzz'))")["results"],
                   q.query("kt", "TopN(tag, n=10)")["results"][0],
                   q.query("kt", "Rows(tag)")["results"][0]]
            assert rec[:3] == [[2], [1], [0]]
            assert [(p["key"], p["count"]) for p in rec[3]] == \
                [("b", 2), ("a", 1)]
            assert rec[4] == ["a", "b"]
            return rec
    dual(run, tmp_path)


def test_dax_clear_op_replay_recovery(tmp_path):
    """The "clear" write-log op replays like any write; the shared
    write-log's lines are equal in both packages."""
    def run(pk, d):
        with service(pk, d) as svc:
            q = svc.queryer
            q.sql("CREATE TABLE rb (_id id, b bool)")
            q.sql("INSERT INTO rb (_id, b) VALUES (1, true)")
            q.sql("INSERT INTO rb (_id, b) VALUES (1, null)")
            owner, _ = svc.controller.worker_for("rb", 0)
            svc.kill_worker(owner)
            svc.controller.poll_once()
            out = q.sql("select * from rb")
            assert out["data"] == [[1, None]]
            return out, svc.wl.replay("rb", 0)
    dual(run, tmp_path)


def test_queryer_front_encodes_wire_cells(tmp_path):
    """The front's /sql answers DECIMAL and TIMESTAMP cells in API.sql's
    wire form (a decimal as a float, a timestamp in RFC 3339).  The JAX
    front hands the engine's Decimal and datetime cells to json.dumps,
    which raises: its client's connection closes with no answer
    (ROADMAP C.8)."""
    import http.client
    import json

    from torch_dax_dual import Pkg

    def run(pk, d):
        with service(pk, d, n_workers=1) as svc:
            q = svc.queryer
            q.sql("CREATE TABLE wc (_id id, p decimal(2), t timestamp)")
            q.sql("INSERT INTO wc (_id, p, t) VALUES "
                  "(1, 1.25, '2022-06-01T12:00:00Z')")
            front = svc.serve_queryer()
            c = http.client.HTTPConnection("127.0.0.1", front.port,
                                           timeout=30)
            try:
                c.request("POST", "/sql", body=json.dumps(
                    {"sql": "SELECT _id, p, t FROM wc"}))
                r = c.getresponse()
                return r.status, json.loads(r.read())
            except http.client.RemoteDisconnected:
                return None
            finally:
                c.close()

    assert run(Pkg("jax"), tmp_path / "jax") is None
    (tmp_path / "port").mkdir()
    st, body = run(Pkg("port"), tmp_path / "port")
    assert st == 200
    assert body["data"] == [[1, 1.25, "2022-06-01T12:00:00Z"]]
