"""SQL on the port's serving plane (pilosa_tpu_torch/sql/engine.py's
serving arm) against the JAX package's: ``API.sql`` JSON with serving
on equals the JAX API's over a statement matrix with writes between
reads; the statement result cache and its write invalidation;
route-"sql" flight records; per-statement admission (typed 503/504);
pushdown off as the A/B arm; a concurrent suite under interleaved
writes; and ``API.query`` JSON with serving on over the executor parity
corpus of tests/test_torch_api.py.  The cases of tests/test_sql_serving.py."""

import threading

import pytest
import torch

from pilosa_tpu.api import API as JaxAPI
from pilosa_tpu.models import Holder as JaxHolder
from pilosa_tpu_torch.api import API, _json_value
from pilosa_tpu_torch.executor.sched import (
    QoS,
    ServingDeadlineExceeded,
    ServingShedError,
)
from pilosa_tpu_torch.models import Holder
from pilosa_tpu_torch.obs import flight, metrics
from pilosa_tpu_torch.sql import costplan
from pilosa_tpu_torch.sql.engine import SQLEngine
from test_torch_api import _CORPUS, apis  # noqa: F401  (fixture)
from torch_serving_common import (
    fresh_stats,  # noqa: F401  (fixture)
    run_threads,
    stop_planes,  # noqa: F401  (autouse)
    wait_until,
)

torch.set_num_threads(1)

W = 1 << 10


def _seed(api):
    api.sql("create table t (_id id, i1 int, s1 string, m1 int, w1 int)")
    api.sql("insert into t (_id, i1, s1, m1, w1) values "
            "(1, 5, 'a', 2, 1), (2, 7, 'b', 2, 1), (3, 5, 'c', 3, 1), "
            "(4, 9, 'a', 3, 1), (5, 2, 'b', 2, 1), (6, 7, 'c', 4, 1)")
    api.sql("create table u (_id id, k1 int, lbl string)")
    api.sql("insert into u (_id, k1, lbl) values "
            "(1, 2, 'x'), (2, 3, 'y'), (3, 4, 'z')")


STABLE_STMTS = [
    "select count(*) from t",
    "select count(*), sum(i1) from t where m1 = 2",
    "select _id, i1 from t where _id = 3",
    "select distinct i1 from t",
    "select m1, count(*), sum(i1) from t group by m1",
    "select t.i1, u.lbl from t inner join u on t.m1 = u.k1 where u.k1 = 2",
    "select count(*) from t inner join u on t.m1 = u.k1",
    "select i1 from t where i1 > 4 order by i1 desc limit 3",
    "select avg(i1) from t",
    "select s1, count(*) from t group by s1",
    "select _id from t where s1 = 'a'",
    "select min(i1), max(i1) from t",
]

WRITES = [
    "insert into t (_id, i1, s1, m1, w1) values (7, 100, 'b', 2, 1)",
    "delete from t where _id = 2",
    "insert into t (_id, i1) values (3, 11)",
]


def _api_pair():
    japi, api = JaxAPI(JaxHolder(width=W)), API(Holder(width=W),
                                                 device="cpu")
    japi.executor.enable_serving()
    api.executor.enable_serving()
    _seed(japi)
    _seed(api)
    return japi, api


@pytest.fixture
def serving_api():
    api = API(Holder(width=W), device="cpu")
    layer = api.executor.enable_serving()
    _seed(api)
    yield api
    layer.close()


def test_sql_json_equals_jax_with_serving_on():
    """The statement matrix, read twice (the second from the statement
    cache) around each write, gives the JAX API's JSON."""
    japi, api = _api_pair()
    for w in [None] + WRITES:
        if w is not None:
            assert api.sql(w) == japi.sql(w), w
        for s in STABLE_STMTS:
            want = japi.sql(s)
            assert api.sql(s) == want, s
            assert api.sql(s) == want, s
    assert api.executor.serving.cache.hits > 0


def test_sql_engine_shares_the_api_executor():
    api = API(Holder(width=W), device="cpu")
    assert api.sql_engine.executor is api.executor
    eng = SQLEngine(Holder(width=W), device="cpu")
    assert eng.executor is not api.executor


def test_pushdown_off_ab_bit_exact(serving_api):
    api = serving_api
    pushed = [api.sql(s)["data"] for s in STABLE_STMTS]
    costplan.configure(enabled=False)
    try:
        host = [api.sql(s)["data"] for s in STABLE_STMTS]
    finally:
        costplan.configure(enabled=True)
    assert pushed == host
    assert [api.sql(s)["data"] for s in STABLE_STMTS] == pushed


def test_sql_flight_record_shape(serving_api):
    api = serving_api
    flight.recorder.clear()
    api.sql("select count(*), sum(i1) from t where m1 = 2")
    recs = [r for r in flight.recorder.recent(32) if r.get("route") == "sql"]
    assert recs
    rec = recs[0]
    assert rec["fingerprint"]
    assert {d["op"]: d["outcome"] for d in rec["pushdown"]} == \
        {"agg_count": "pushdown", "agg_sum": "pushdown"}
    assert rec.get("serving_routes")
    assert set(rec["serving_routes"]) <= {"fused", "cached", "direct"}
    assert rec["priority"] in ("point", "heavy")


def test_statement_cache_hit_and_write_invalidation(serving_api):
    api = serving_api
    srv = api.executor.serving
    q = "select m1, count(*), sum(i1) from t group by m1"
    first = api.sql(q)["data"]
    h0 = srv.cache.hits
    assert api.sql(q)["data"] == first
    assert srv.cache.hits > h0
    api.sql("insert into t (_id, i1, m1, w1) values (7, 100, 2, 1)")
    after = api.sql(q)["data"]
    assert after != first
    host = SQLEngine(api.holder, device="cpu")
    assert sorted(after) == sorted(
        [[_json_value(v) for v in r] for r in host.query_one(q).rows])


def test_sql_deadline_and_shed_typed_errors(serving_api, fresh_stats):
    api = serving_api
    qos = QoS.make(deadline_ms=1.0)
    qos.deadline_s -= 10.0            # dead on arrival
    with pytest.raises(ServingDeadlineExceeded):
        api.sql("select m1, count(*) from t group by m1", qos=qos)
    srv = api.executor.serving
    srv.sched.heavy_slots = 1
    srv.sched.queue_max = 1
    slot = srv.sched.heavy_slot(None)
    slot.__enter__()
    blocked = threading.Thread(target=lambda: api.sql(
        "select m1, count(*) from t group by m1"), daemon=True)
    try:
        blocked.start()
        assert wait_until(lambda: srv.sched.queued() == 1)
        with pytest.raises(ServingShedError) as ei:
            api.sql("select i1, count(*) from t group by i1")
        assert ei.value.retry_after_s > 0
    finally:
        slot.__exit__(None, None, None)
        blocked.join(30)
    assert not blocked.is_alive()


def test_concurrent_sql_suite_under_writes():
    """Readers of the stable matrix (whose answers no write here
    changes) and of the w1 count, while a writer toggles a w1 bit:
    every serving answer equals the host path's, and the w1 count is
    one of its two quiesced states."""
    import random
    api = API(Holder(width=W), device="cpu")
    layer = api.executor.enable_serving()
    _seed(api)
    host = SQLEngine(api.holder, device="cpu")

    def host_rows(q):
        return [[_json_value(v) for v in r] for r in host.query_one(q).rows]

    expected = {q: host_rows(q) for q in STABLE_STMTS}
    wq = "select count(w1) from t where w1 = 1"
    api.executor.execute("t", "Clear(1, w1=1)")
    states = [host_rows(wq)]
    api.executor.execute("t", "Set(1, w1=1)")
    states.append(host_rows(wq))
    errors: list = []
    stop = threading.Event()

    def writer():
        i = 0
        while not stop.is_set() and i < 400:
            api.executor.execute("t", f"{'Clear' if i % 2 == 0 else 'Set'}"
                                      f"(1, w1=1)")
            i += 1

    def reader(seed):
        def go():
            rng = random.Random(seed)
            try:
                for _ in range(3):
                    q = rng.choice(STABLE_STMTS)
                    got = api.sql(q)["data"]
                    if sorted(map(repr, got)) != \
                            sorted(map(repr, expected[q])):
                        errors.append((q, got, expected[q]))
                    if api.sql(wq)["data"] not in states:
                        errors.append(wq)
            except Exception as e:  # pragma: no cover
                errors.append(repr(e))
        return go

    wt = threading.Thread(target=writer, daemon=True)
    wt.start()
    try:
        run_threads([reader(i) for i in range(8)])
    finally:
        stop.set()
        wt.join(30)
    assert not wt.is_alive()
    assert not errors, errors[:3]
    layer.close()


def test_pushdown_metrics_and_plan_cost(serving_api):
    api = serving_api
    c = metrics.SQL_PUSHDOWN
    before = c.value(op="agg_count", outcome="pushdown")
    api.sql("select count(*) from t")
    assert c.value(op="agg_count", outcome="pushdown") == before + 1
    costplan.configure(enabled=False)
    try:
        hb = c.value(op="agg_sum", outcome="host")
        api.sql("select sum(i1) from t")
        assert c.value(op="agg_sum", outcome="host") == hb + 1
    finally:
        costplan.configure(enabled=True)
    assert metrics.SQL_PLAN_COST.count() > 0


def test_udf_statements_escape_the_statement_cache(serving_api):
    api = serving_api
    api.sql("create function dbl(@x int) returns int as (@x + 1)")
    q = "select _id, dbl(i1) from t where _id = 1"
    assert api.sql(q)["data"] in ([["1", 6]], [[1, 6]])
    api.sql("drop function dbl")
    api.sql("create function dbl(@x int) returns int as (@x * 2)")
    assert api.sql(q)["data"] in ([["1", 10]], [[1, 10]])


@pytest.mark.parametrize("index,query", _CORPUS)
def test_api_query_corpus_with_serving_on(apis, index, query):  # noqa: F811
    """The executor parity corpus through API.query with both packages'
    serving layers on: the port's JSON equals the JAX API's."""
    japi, api = apis[index]
    if japi.executor.serving is None:
        japi.executor.enable_serving(window_s=0.0, max_batch=8)
    if api.executor.serving is None:
        api.executor.enable_serving(window_s=0.0, max_batch=8)
    api.executor.use_stacked = True
    want = japi.query(index, query)
    assert api.query(index, query) == want
    assert api.query(index, query) == want          # cached
