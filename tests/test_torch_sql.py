"""The port's SQL engine against the JAX package's.

``tests/test_sql.py``'s cases run unchanged on a ``DualEngine`` (every
statement through the JAX ``SQLEngine`` and the port's, the same rows
exactly or the same error, the port's answer returned to the case's own
assertions), on both of the port's engines.  Then what the port must
keep across statements: ORDER BY of a depth-64 column (-2^63 and
2^63 - 1 stored), INSERT, REPLACE and DELETE between SELECTs on one
long-lived executor (resident stacks and tiles patched through the
fragments' delta logs, never rebuilt by reason), ALTER TABLE RENAME
between SELECTs and across a sync and reopen, COPY and path-backed
holders reopened (the cases of ``tests/test_persistence.py`` that
run SQL), ``API.sql`` JSON and ``ApiError`` statuses against the JAX
API, DISTINCT through a forced spill (``storage/extendiblehash.py``
and ``storage/bufferpool.py`` of both packages, the testhook audit of
the port's spill handles), and the statistics catalog's join order.
The port runs on the CPU (device="cpu").  Exact throughout."""

import inspect
import json

import numpy as np
import pytest

import tests.test_sql as jax_sql_cases
from pilosa_tpu.api import API as JaxAPI
from pilosa_tpu.api import ApiError as JaxApiError
from pilosa_tpu.models.holder import Holder as JaxHolder
from pilosa_tpu.obs import stats as jax_stats
from pilosa_tpu.sql import costplan as jax_costplan
from pilosa_tpu.storage import bufferpool as jax_bufferpool
from pilosa_tpu.storage import extendiblehash as jax_eh
from pilosa_tpu_torch.api import API, ApiError
from pilosa_tpu_torch.models.holder import Holder
from pilosa_tpu_torch.obs import metrics, stats, testhook
from pilosa_tpu_torch.sql import SQLError, costplan
from pilosa_tpu_torch.storage import bufferpool
from pilosa_tpu_torch.storage import extendiblehash as eh
from tests.torch_sql_dual import ENGINES, W, DualEngine

# test_sql.py's cases; the two join cases build their engines from
# their own imports of the JAX package, so they are restated below
_OWN_IMPORTS = {"test_inner_join_basic", "test_inner_join_errors"}
_SQL_CASES = sorted(n for n, f in vars(jax_sql_cases).items()
                    if n.startswith("test_") and inspect.isfunction(f)
                    and n not in _OWN_IMPORTS)


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("name", _SQL_CASES)
def test_sql_case_on_both_packages(monkeypatch, engine, name):
    """One case of tests/test_sql.py, its engines DualEngines: the
    module's SQLEngine(Holder(width=W)) builds one, its SQLError is the
    port's, and its fixtures run as written."""
    monkeypatch.setattr(jax_sql_cases, "SQLEngine",
                        lambda width: DualEngine(engine, width=width))
    monkeypatch.setattr(jax_sql_cases, "Holder", lambda width=W: width)
    monkeypatch.setattr(jax_sql_cases, "SQLError", SQLError)
    fn = getattr(jax_sql_cases, name)
    params = inspect.signature(fn).parameters
    kwargs = {}
    if "eng" in params or "eng_nulls" in params:
        eng = jax_sql_cases.eng.__wrapped__()
        if "eng_nulls" in params:
            kwargs["eng_nulls"] = jax_sql_cases.eng_nulls.__wrapped__(eng)
        else:
            kwargs["eng"] = eng
    fn(**kwargs)


@pytest.mark.parametrize("engine", ENGINES)
def test_inner_join(engine):
    """test_sql.py's two join cases on a DualEngine."""
    eng = DualEngine(engine)
    eng.query("CREATE TABLE users (_id ID, name STRING, age INT MIN 0 MAX 120)")
    eng.query("CREATE TABLE orders (_id ID, user_id INT MIN 0 MAX 1000, "
              "amount INT MIN 0 MAX 10000)")
    eng.query("INSERT INTO users (_id, name, age) VALUES "
              "(1, 'alice', 30), (2, 'bob', 40), (3, 'carol', 50)")
    eng.query("INSERT INTO orders (_id, user_id, amount) VALUES "
              "(10, 1, 100), (11, 1, 150), (12, 2, 200), (13, 99, 5)")
    r = eng.query_one(
        "SELECT orders._id, users.name, orders.amount "
        "FROM orders INNER JOIN users ON orders.user_id = users._id "
        "ORDER BY amount DESC")
    assert r.rows == [(12, "bob", 200), (11, "alice", 150),
                      (10, "alice", 100)]
    assert eng.query_one(
        "SELECT COUNT(*) FROM orders JOIN users "
        "ON users._id = orders.user_id").rows == [(3,)]
    assert eng.query_one(
        "SELECT users.name FROM orders JOIN users "
        "ON orders.user_id = users._id "
        "WHERE users.age > 35 AND orders.amount >= 200").rows == [("bob",)]
    assert eng.query_one(
        "SELECT orders._id FROM orders JOIN users "
        "ON orders.user_id = users._id ORDER BY orders._id LIMIT 2"
    ).rows == [(10,), (11,)]
    eng.query("CREATE TABLE a (_id ID, x INT MIN 0 MAX 9)")
    eng.query("CREATE TABLE b (_id ID, y INT MIN 0 MAX 9)")
    for bad in ("SELECT x FROM a JOIN b ON x = y",
                "SELECT x FROM a JOIN b ON a.x = a.x",
                "SELECT c.z FROM a JOIN b ON a.x = b.y"):
        with pytest.raises(SQLError):
            eng.query(bad)


# -- ORDER BY of a depth-64 column ------------------------------------------

_LOW, _HIGH = -(1 << 63), (1 << 63) - 1


@pytest.mark.parametrize("engine", ENGINES)
def test_order_by_depth64_column(engine):
    """An int column with no min/max grows to depth 64 once it holds
    -2^63; ORDER BY then becomes a Sort the per-shard engine decodes in
    Python ints, on both engines, as the JAX loop does."""
    eng = DualEngine(engine)
    eng.query("CREATE TABLE big (_id id, v int, tag string)")
    eng.query(f"INSERT INTO big (_id, v, tag) VALUES (1, 5, 'a'), "
              f"(2, {_LOW}, 'b'), (3, {_HIGH}, 'a'), ({W + 4}, -3, 'b'), "
              f"({2 * W + 1}, 0, 'a'), ({2 * W + 2}, {_HIGH - 1}, 'b')")
    assert eng.holder.index("big").field("v").bit_depth == 64
    assert eng.query_one("SELECT _id, v FROM big ORDER BY v LIMIT 3").rows \
        == [(2, _LOW), (W + 4, -3), (2 * W + 1, 0)]
    assert eng.query_one(
        "SELECT _id, v FROM big ORDER BY v DESC LIMIT 2").rows == \
        [(3, _HIGH), (2 * W + 2, _HIGH - 1)]
    assert [r[0] for r in eng.query_one(
        "SELECT v FROM big ORDER BY v").rows] == \
        [_LOW, -3, 0, 5, _HIGH - 1, _HIGH]
    assert eng.query_one(
        "SELECT _id FROM big WHERE tag = 'a' ORDER BY v DESC LIMIT 10"
    ).rows == [(3,), (1,), (2 * W + 1,)]
    assert eng.query_one("SELECT MIN(v), MAX(v) FROM big").rows == \
        [(_LOW, _HIGH)]


# -- writes between SELECTs on one executor -------------------------------

_SELECTS = [
    "SELECT COUNT(*) FROM t WHERE SETCONTAINS(s, 1) AND SETCONTAINS(s, 2)",
    "SELECT SUM(age) FROM t WHERE SETCONTAINS(s, 1)",
    "SELECT SUM(age), COUNT(*) FROM t",
    "SELECT COUNT(*) FROM t WHERE age >= 60",
    "SELECT COUNT(*) FROM t WHERE age BETWEEN 10 AND 40",
    "SELECT MIN(age), MAX(age), AVG(age) FROM t WHERE SETCONTAINS(s, 3)",
    "SELECT m, SUM(age) FROM t GROUP BY m",
    "SELECT m, COUNT(*) FROM t WHERE age > 30 GROUP BY m",
    "SELECT DISTINCT age FROM t",
    "SELECT PERCENTILE(age, 50) FROM t",
    "SELECT _id, age FROM t WHERE SETCONTAINS(s, 1) ORDER BY age DESC "
    "LIMIT 7",
    "SELECT _id FROM t WHERE m = 'x' LIMIT 5",
]


def _t_table(eng, rng, n=600):
    eng.query("CREATE TABLE t (_id id, s idset, age int min 0 max 100, "
              "m string)")
    cols = rng.choice(3 * W, size=n, replace=False)
    vals = []
    for c in cols.tolist():
        s = rng.choice(4, size=int(rng.integers(1, 3)), replace=False)
        vals.append(f"({c}, ({', '.join(str(x) for x in s.tolist())}), "
                    f"{int(rng.integers(0, 101))}, "
                    f"'{['x', 'y', 'z'][int(rng.integers(0, 3))]}')")
    eng.query("INSERT INTO t (_id, s, age, m) VALUES " + ", ".join(vals))
    return cols


def _caches(eng, engine):
    return (eng.executor.stacked.cache if engine == "stacked"
            else eng.executor.tiles.cache)


@pytest.mark.parametrize("engine", ENGINES)
def test_writes_between_selects_patch_resident_stacks(engine):
    """INSERT bypasses the executor: the resident stacks (stacked) and
    tiles (per-shard) pick its writes up through the fragments' delta
    logs and patch, with no rebuild by reason (coverage, gen,
    dirty_frac); REPLACE's column clears and DELETE's executor write
    the same.  Every answer equals the JAX package's."""
    eng = DualEngine(engine)
    rng = np.random.default_rng(7)
    cols = _t_table(eng, rng)
    for q in _SELECTS:
        eng.query(q)
    cache = _caches(eng, engine)
    before = cache.counters()
    writes = [
        "INSERT INTO t (_id, age) VALUES " + ", ".join(
            f"({c}, {int(v)})" for c, v in zip(
                cols[:40].tolist(), rng.integers(0, 101, size=40))),
        "INSERT INTO t (_id, s) VALUES " + ", ".join(
            f"({c}, (1, 2))" for c in cols[40:60].tolist()),
        f"REPLACE INTO t (_id, s, age, m) VALUES ({cols[60]}, (3), 99, 'z')",
        f"INSERT INTO t (_id, age, m) VALUES ({W - 1}, 77, 'y')",
        "DELETE FROM t WHERE age = 50",
    ]
    for w in writes:
        eng.query(w)
        for q in _SELECTS:
            eng.query(q)
    after = cache.counters()
    assert after["patches"] > before["patches"], (before, after)
    reasons = {k: v for k, v in after["rebuilds"].items() if k != "cold"}
    assert reasons == {k: v for k, v in before["rebuilds"].items()
                       if k != "cold"}, (before, after)


# -- ALTER TABLE RENAME, COPY and reopened holders --------------------------

class _PathDual:
    """DualEngines over path-backed holders of both packages, reopened
    (sync, close, load_schema) on ask; closes what it opened."""

    def __init__(self, tmp_path, engine):
        self.tmp, self.engine = tmp_path, engine
        self.opened = []
        self.eng = self._open()

    def _open(self):
        jh = JaxHolder(path=str(self.tmp / "jax"), width=W)
        ph = Holder(path=str(self.tmp / "port"), width=W)
        jh.load_schema()
        ph.load_schema()
        self.opened += [jh, ph]
        return DualEngine(self.engine, jax_holder=jh, holder=ph)

    def reopen(self) -> DualEngine:
        for h in (self.eng.jax.holder, self.eng.holder):
            h.sync()
            h.close()
        self.eng = self._open()
        return self.eng

    def close(self):
        for h in self.opened:
            h.close()


@pytest.fixture
def path_dual(tmp_path, monkeypatch):
    monkeypatch.setenv("RBF_NOSYNC", "1")
    made = []

    def make(engine):
        d = _PathDual(tmp_path / engine, engine)
        made.append(d)
        return d
    yield make
    for d in made:
        d.close()


_RENAMED = [
    "SELECT SUM(score), COUNT(*) FROM p",
    "SELECT COUNT(*) FROM p WHERE score > 15",
    "SELECT grp, SUM(score) FROM p GROUP BY grp",
    "SELECT _id, score FROM p ORDER BY score DESC LIMIT 3",
    "SELECT DISTINCT score FROM p",
]


@pytest.mark.parametrize("engine", ENGINES)
def test_alter_rename_between_selects_and_reopen(path_dual, engine):
    """ALTER TABLE RENAME COLUMN between SELECTs on one executor: the
    new name answers from the field's data, the old name is gone, and
    a column made again under the old name answers from its own data,
    never from a stack built for the renamed field; after sync and
    reopen the names hold, on disk too."""
    d = path_dual(engine)
    eng = d.eng
    eng.query("CREATE TABLE p (_id id, score int, grp string)")
    eng.query("INSERT INTO p (_id, score, grp) VALUES (1, 10, 'a'), "
              f"(2, 20, 'b'), ({W + 3}, 30, 'a'), ({2 * W}, 5, 'b')")
    for q in _RENAMED:
        eng.query(q)
    eng.query("ALTER TABLE p RENAME COLUMN score TO points")
    with pytest.raises(SQLError):
        eng.query("SELECT SUM(score) FROM p")
    for q in _RENAMED:
        eng.query(q.replace("score", "points"))
    eng.query("ALTER TABLE p ADD COLUMN score int")
    eng.query(f"INSERT INTO p (_id, score) VALUES (1, 7), ({W + 3}, 9)")
    for q in _RENAMED + [q.replace("score", "points") for q in _RENAMED]:
        eng.query(q)
    assert eng.query_one("SELECT SUM(score), SUM(points) FROM p").rows == \
        [(16, 65)]
    eng = d.reopen()
    for q in _RENAMED + [q.replace("score", "points") for q in _RENAMED]:
        eng.query(q)
    assert eng.query_one("SELECT SUM(score), SUM(points) FROM p").rows == \
        [(16, 65)]
    eng.query("ALTER TABLE p RENAME COLUMN grp TO team")
    eng = d.reopen()
    assert eng.query_one("SELECT team, COUNT(*) FROM p GROUP BY team").rows \
        == [("a", 2), ("b", 2)]


@pytest.mark.parametrize("engine", ENGINES)
def test_sql_engine_roundtrip(path_dual, engine):
    """tests/test_persistence.py test_sql_engine_roundtrip on both."""
    d = path_dual(engine)
    d.eng.query("CREATE TABLE t (_id id, color string, n int)")
    d.eng.query("INSERT INTO t (_id, color, n) VALUES "
                "(1,'red',10),(2,'blue',20),(3,'red',30)")
    eng = d.reopen()
    assert [r[0] for r in eng.query_one(
        "SELECT _id FROM t WHERE color = 'red'").rows] == [1, 3]
    assert eng.query_one("SELECT SUM(n) FROM t").rows == [(60,)]
    eng.query("INSERT INTO t (_id, color, n) VALUES (4,'red',5)")
    eng = d.reopen()
    assert eng.query_one(
        "SELECT COUNT(*) FROM t WHERE color = 'red'").rows == [(3,)]


@pytest.mark.parametrize("engine", ENGINES)
def test_drop_table_drops_translator_keys(path_dual, engine):
    """tests/test_persistence.py test_delete_index_drops_translator_keys
    on both."""
    d = path_dual(engine)
    eng = d.eng
    eng.query("CREATE TABLE t (_id string, color string)")
    eng.query("INSERT INTO t (_id, color) VALUES ('a','red'),('b','blue')")
    eng.jax.holder.sync()
    eng.holder.sync()
    eng.query("DROP TABLE t")
    eng.query("CREATE TABLE t (_id string, color string)")
    eng.query("INSERT INTO t (_id, color) VALUES ('z','green')")
    assert eng.query_one("SELECT _id, color FROM t").rows == [("z", "green")]
    assert eng.query_one(
        "SELECT COUNT(*) FROM t WHERE color='red'").rows == [(0,)]
    eng = d.reopen()
    assert eng.query_one("SELECT _id FROM t").rows == [("z",)]


@pytest.mark.parametrize("engine", ENGINES)
def test_copy_tables_and_reopen(path_dual, engine):
    """COPY of a keyed table (its keys persisted but not yet opened
    after a reopen, tests/test_persistence.py
    test_copy_keyed_table_after_reopen) and of an unkeyed one with
    every column type; the copies answer as their sources before and
    after a second reopen."""
    d = path_dual(engine)
    eng = d.eng
    eng.query("CREATE TABLE users (_id string, score int, tags stringset)")
    eng.query("INSERT INTO users (_id, score, tags) VALUES "
              "('alice', 10, ('x', 'y')), ('bob', 20, ('y')), "
              "('carol', -4, ('z'))")
    eng.query("CREATE TABLE u2 (_id id, n int, d decimal(2), b bool, "
              "ts timestamp, s idset, m id)")
    eng.query("INSERT INTO u2 (_id, n, d, b, ts, s, m) VALUES "
              "(1, 5, 1.25, true, '2024-01-02T03:04:05Z', (1, 2), 7), "
              f"({W + 9}, -6, -0.5, false, '2023-05-06T00:00:00Z', (2), 8)")
    eng = d.reopen()
    eng.query("COPY users TO users2")
    eng.query("COPY u2 TO u3")
    for q in ("SELECT _id, score, tags FROM {}",
              "SELECT SUM(score) FROM {} WHERE SETCONTAINS(tags, 'y')"):
        assert sorted(eng.query_one(q.format("users2")).rows) == \
            sorted(eng.query_one(q.format("users")).rows)
    assert eng.query_one("SELECT * FROM u3").rows == \
        eng.query_one("SELECT * FROM u2").rows
    eng = d.reopen()
    assert sorted(eng.query_one("SELECT _id, score FROM users2").rows) == \
        [("alice", 10), ("bob", 20), ("carol", -4)]
    eng.query("INSERT INTO users2 (_id, score) VALUES ('dave', 1)")
    assert eng.query_one("SELECT COUNT(*) FROM users").rows == [(3,)]
    assert eng.query_one("SELECT COUNT(*) FROM users2").rows == [(4,)]
    assert eng.query_one("SELECT * FROM u3").rows == \
        eng.query_one("SELECT * FROM u2").rows


# -- API.sql ------------------------------------------------------------------

_API_SETUP = [
    "CREATE TABLE orders (_id id, region string, qty int, "
    "price decimal(2), tags stringset, paid bool, at timestamp)",
    "INSERT INTO orders (_id, region, qty, price, tags, paid, at) VALUES "
    "(1, 'west', 5, 10.50, ('a','b'), true, '2024-01-01T00:00:00Z'), "
    "(2, 'west', 12, 3.25, ('b'), false, '2024-02-01T12:30:00Z'), "
    "(3, 'east', 7, 99.99, ('a','c'), true, '2023-12-31T23:59:59Z')",
]
_API_QUERIES = [
    "SELECT * FROM orders",
    "SELECT region, SUM(qty), AVG(qty) FROM orders GROUP BY region",
    "SELECT COUNT(*) FROM orders WHERE SETCONTAINS(tags, 'a')",
    "SELECT _id, price, at FROM orders ORDER BY qty DESC LIMIT 2",
    "SELECT DISTINCT region FROM orders",
    "SHOW TABLES",
    "SHOW COLUMNS FROM orders",
    "SELECT MIN(price), MAX(at) FROM orders",
    "EXPLAIN SELECT region, COUNT(*) FROM orders GROUP BY region",
]
_API_ERRORS = [
    "SELECT nope FROM orders",
    "SELECT * FROM missing",
    "SELECT garbage syntax here",
    "INSERT INTO orders (_id, region) VALUES (7, 42)",
    "CREATE TABLE orders (_id id, x int)",
    "SELECT region, COUNT(*) FROM orders",
]


@pytest.fixture
def api_pair():
    japi, api = JaxAPI(JaxHolder(width=W)), API(Holder(width=W), device="cpu")
    for s in _API_SETUP:
        assert api.sql(s) == japi.sql(s)
    return japi, api


@pytest.mark.parametrize("engine", ENGINES)
def test_api_sql_json_matches_jax(api_pair, engine):
    """API.sql's {"schema", "data"} JSON equals the JAX API's, statement
    for statement; the port's API shares one executor between PQL and
    SQL, and records the statement in its history."""
    japi, api = api_pair
    api.executor.use_stacked = engine == "stacked"
    assert api.sql_engine.executor is api.executor
    for q in _API_QUERIES:
        got = api.sql(q)
        assert got == japi.sql(q), q
        json.dumps(got)
    assert api.sql("SELECT COUNT(*) FROM orders; SELECT SUM(qty) FROM orders") \
        == japi.sql("SELECT COUNT(*) FROM orders; SELECT SUM(qty) FROM orders")
    assert api.query("orders", "Count(All())") == \
        japi.query("orders", "Count(All())")
    assert any(e["query"] == _API_QUERIES[-1] for e in api.query_history())


@pytest.mark.parametrize("stmt", _API_ERRORS)
def test_api_sql_errors_match_jax(api_pair, stmt):
    japi, api = api_pair
    with pytest.raises(JaxApiError) as want:
        japi.sql(stmt)
    with pytest.raises(ApiError) as got:
        api.sql(stmt)
    assert (got.value.status, str(got.value)) == \
        (want.value.status, str(want.value))


def test_api_sql_counts_statements_and_plans():
    """SQL_TOTAL counts API.sql calls, SQL_PLAN_COST observes each
    SELECT's planning, and SQL_PUSHDOWN counts each pushed operator
    with outcome "host" (the solo arm)."""
    api = API(Holder(width=W), device="cpu")
    for s in _API_SETUP:
        api.sql(s)

    def read():
        return (metrics.SQL_TOTAL.value(),
                metrics.SQL_PLAN_COST.count(),
                metrics.SQL_PUSHDOWN.value(op="groupby", outcome="host"))
    t0, p0, g0 = read()
    api.sql("SELECT region, COUNT(*) FROM orders GROUP BY region")
    api.sql("SELECT COUNT(*) FROM orders")
    t1, p1, g1 = read()
    assert (t1 - t0, p1 - p0, g1 - g0) == (2, 2, 1)


# -- DISTINCT through the spill set -------------------------------------------

@pytest.mark.parametrize("pkg", [(jax_bufferpool, jax_eh), (bufferpool, eh)],
                         ids=["jax", "port"])
def test_spill_structures(tmp_path, pkg):
    """tests/test_spill_kafka.py's bufferpool, extendible hash and spill
    set cases on either package's modules."""
    bp, ehm = pkg
    pool = bp.BufferPool(bp.DiskManager(str(tmp_path / "p.db")), max_frames=4)
    pages = []
    for i in range(10):
        p = pool.new_page()
        p.data[:4] = i.to_bytes(4, "little")
        pages.append(p.page_no)
        pool.unpin(p, dirty=True)
    for i, pno in enumerate(pages):
        p = pool.fetch(pno)
        assert int.from_bytes(p.data[:4], "little") == i
        pool.unpin(p)
    pool.close()
    pool = bp.BufferPool(bp.DiskManager(str(tmp_path / "p.db")), 4)
    assert int.from_bytes(pool.fetch(pages[3]).data[:4], "little") == 3
    pool.close()
    pool = bp.BufferPool(bp.DiskManager(str(tmp_path / "x.db")), max_frames=2)
    pool.new_page()
    b = pool.new_page()
    with pytest.raises(RuntimeError):
        pool.new_page()
    pool.unpin(b)
    pool.new_page()
    pool.close()
    pool = bp.BufferPool(bp.DiskManager(str(tmp_path / "eh.db")),
                         max_frames=32)
    h = ehm.ExtendibleHash(pool)
    for i in range(3000):
        h.put(f"key-{i}".encode(), str(i).encode())
    assert len(h) == 3000 and h.global_depth > 0
    assert h.get(b"key-97") == b"97" and h.get(b"missing") is None
    h.put(b"key-1", b"new")
    assert len(h) == 3000 and h.get(b"key-1") == b"new"
    pool.close()
    s = ehm.SpillSet(str(tmp_path / "sp.bin"), threshold=100)
    assert sum(s.add(f"k{i % 250}".encode()) for i in range(500)) == 250
    assert s._mem is None and len(s) == 250
    assert sorted(s) == sorted(f"k{i}".encode() for i in range(250))
    s.close()
    s = ehm.SpillSet(str(tmp_path / "w.bin"), threshold=2)
    big = [b"K" * 20000 + str(i).encode() for i in range(6)]
    assert sum(s.add(k) for k in big + big) == 6
    s.close()


@pytest.mark.parametrize("engine", ENGINES)
def test_distinct_through_a_forced_spill(monkeypatch, engine):
    """Multi-column DISTINCT (the spill-backed dedup) with a threshold
    of 4 keys in both packages: the answers equal, the port's spill set
    reached the disk, and every spill handle it opened was closed (the
    port's testhook audit)."""
    spilled = []
    port_spill = eh.SpillSet

    def tiny(orig):
        def make(path, threshold=1 << 16, frames=64):
            s = orig(path, threshold=4, frames=16)
            spilled.append(s)
            return s
        return make
    monkeypatch.setattr(jax_eh, "SpillSet", tiny(jax_eh.SpillSet))
    monkeypatch.setattr(eh, "SpillSet", tiny(eh.SpillSet))
    monkeypatch.setattr(testhook, "ENABLED", True)
    testhook.reset()
    eng = DualEngine(engine)
    eng.query("CREATE TABLE d (_id id, g int min 0 max 9, k string)")
    eng.query("INSERT INTO d (_id, g, k) VALUES " + ", ".join(
        f"({i * 37}, {i % 7}, 'k{i % 5}')" for i in range(200)))
    res = eng.query_one("SELECT DISTINCT g, k FROM d ORDER BY g, k")
    assert len(res.rows) == 35
    assert eng.query_one("SELECT DISTINCT g FROM d ORDER BY g").rows == \
        [(i,) for i in range(7)]
    assert len(eng.query_one(
        "SELECT DISTINCT k, g FROM d WHERE g < 2 LIMIT 4").rows) == 4
    port_sets = [s for s in spilled if isinstance(s, port_spill)]
    assert port_sets and all(s._mem is None for s in port_sets)
    assert testhook.audit() == {}


# -- the statistics catalog and the join order -------------------------------

@pytest.fixture
def fresh_stats():
    prev = jax_stats.swap(jax_stats.StatsCatalog())
    stats.reset()
    yield
    jax_stats.swap(prev)
    stats.reset()


def test_catalog_join_order_matches_jax(fresh_stats):
    """After the same imports through each package's API, the catalogs
    hold the same per-field stats, estimate the same record counts and
    reorder a star join the same
    way (EXPLAIN's join-order note); with the switch off
    (costplan.configure(enabled=False); the JAX package through its
    own configure) the written order stays, and the rows agree
    throughout."""
    japi, api = JaxAPI(JaxHolder(width=W)), API(Holder(width=W), device="cpu")
    stmts = ["CREATE TABLE f (_id id, a int, b int, c int)",
             "CREATE TABLE da (_id id, x int)",
             "CREATE TABLE db (_id id, y int)",
             "CREATE TABLE dc (_id id, z int)"]
    for s in stmts:
        assert api.sql(s) == japi.sql(s)
    dims = {"da": ("x", 300, "a"), "db": ("y", 40, "b"),
            "dc": ("z", 120, "c")}
    for p in (japi, api):
        for t, (field, n, fk) in dims.items():
            p.import_values(t, field, cols=list(range(n)),
                            values=(np.arange(n) % 9).tolist())
            p.import_values("f", fk, cols=list(range(500)),
                            values=(np.arange(500) % n).tolist())
    for t in ("f", "da", "db", "dc"):
        assert stats.get().est_index_rows(t) == \
            jax_stats.get().est_index_rows(t), t
    for t, f in [("f", "a"), ("f", "b"), ("f", "c"), ("da", "x"),
                 ("db", "y"), ("dc", "z"), ("da", "nope")]:
        assert stats.get().field_stats(t, f) == \
            jax_stats.get().field_stats(t, f), (t, f)
    join = ("SELECT COUNT(*) FROM f JOIN da ON f.a = da._id "
            "JOIN db ON f.b = db._id JOIN dc ON f.c = dc._id")
    plan = api.sql("EXPLAIN " + join)
    assert plan == japi.sql("EXPLAIN " + join)
    assert any("join order (catalog: db~40, dc~120, da~300)" in r[0]
               for r in plan["data"]), plan
    assert api.sql(join) == japi.sql(join)
    costplan.configure(enabled=False)
    jax_costplan.configure(enabled=False)
    try:
        plan = api.sql("EXPLAIN " + join)
        assert plan == japi.sql("EXPLAIN " + join)
        assert not any("join order" in r[0] for r in plan["data"])
        assert api.sql(join) == japi.sql(join)
    finally:
        costplan.configure(enabled=True)
        jax_costplan.configure(enabled=None)
