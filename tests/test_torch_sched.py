"""The port's QoS admission (pilosa_tpu_torch/executor/sched.py)
against the JAX package's: ``classify`` and ``classify_sql`` give the
JAX classes, the bounded heavy gate, weighted per-tenant fair queueing,
backpressure (typed 503 with a retry hint), deadlines (typed 504), and
point reads that bypass a saturated gate.  The cases of
tests/test_sched.py, with events in place of sleeps."""

import threading
import time

import pytest

from pilosa_tpu.executor import sched as jsched
from pilosa_tpu.pql import parse as jparse
from pilosa_tpu.sql.parser import parse_sql as jparse_sql
from pilosa_tpu_torch.executor.sched import (
    CLASS_HEAVY,
    CLASS_POINT,
    AdmissionScheduler,
    QoS,
    ServingDeadlineExceeded,
    ServingShedError,
    classify,
    classify_sql,
    parse_weights,
)
from pilosa_tpu_torch.obs import metrics
from pilosa_tpu_torch.pql import parse
from pilosa_tpu_torch.sql.parser import parse_sql
from torch_serving_common import (
    PORT,
    build_holder,
    fresh_stats,  # noqa: F401  (fixture)
    make_executor,
    run_threads,
    stop_planes,  # noqa: F401  (autouse)
    wait_until,
)

PQL = ["Count(Row(a=1))", "Sum(Row(a=1), field=v)", "Row(a=1)",
       "GroupBy(Rows(a), aggregate=Sum(field=v))", "TopN(a, n=3)",
       "Extract(All(), Rows(a))", "Count(Distinct(field=v))",
       "Percentile(field=v, nth=50)", "Rows(a)", "Min(field=v)",
       "Union(Row(a=1), Row(b=2))", "Options(Count(Row(a=1)), shards=[0])"]

SQL = ["SELECT COUNT(*) FROM t", "SELECT _id FROM t WHERE _id = 3",
       "SELECT _id, a FROM t LIMIT 5", "SELECT _id FROM t",
       "SELECT a, COUNT(*) FROM t GROUP BY a",
       "SELECT DISTINCT a FROM t LIMIT 3",
       "SELECT t._id FROM t JOIN u ON t._id = u._id LIMIT 2",
       "SELECT SUM(v) FROM t WHERE a = 1",
       "SELECT _id FROM t WHERE a = 1 LIMIT 10"]

PRIORITIES = [None, "point", "heavy"]


@pytest.mark.parametrize("priority", PRIORITIES)
@pytest.mark.parametrize("q", PQL)
def test_classify_equals_jax(q, priority):
    qos = QoS.make(priority=priority) if priority else None
    jqos = jsched.QoS.make(priority=priority) if priority else None
    assert classify(parse(q), qos) == jsched.classify(jparse(q), jqos)


@pytest.mark.parametrize("priority", PRIORITIES)
@pytest.mark.parametrize("sql", SQL)
def test_classify_sql_equals_jax(sql, priority):
    qos = QoS.make(priority=priority) if priority else None
    jqos = jsched.QoS.make(priority=priority) if priority else None
    assert classify_sql(parse_sql(sql)[0], qos) == \
        jsched.classify_sql(jparse_sql(sql)[0], jqos)


def test_classify():
    assert classify(parse("Count(Row(a=1))"), None) == CLASS_POINT
    assert classify(parse("TopN(a, n=3)"), None) == CLASS_HEAVY
    assert classify(parse("Count(Distinct(field=v))"), None) == CLASS_HEAVY
    assert classify(parse("Count(Row(a=1))"),
                    QoS.make(priority="heavy")) == CLASS_HEAVY
    assert classify(parse("TopN(a, n=3)"),
                    QoS.make(priority="point")) == CLASS_POINT


def test_classify_by_measured_cost():
    """A warm fingerprint profile outranks the query kind, against the
    catalog's heavy_cost_ms."""
    from pilosa_tpu_torch.obs import stats
    cat = stats.StatsCatalog(heavy_cost_ms=5.0)
    prev = stats.swap(cat)
    try:
        for fp, ms in (("cheap", 0.1), ("dear", 50.0)):
            for _ in range(4):
                cat.note_flight({"fingerprint": fp, "duration_ms": ms})
        cat.fold()
        assert classify(parse("TopN(a, n=3)"), None,
                        fingerprint="cheap") == CLASS_POINT
        assert classify(parse("Count(Row(a=1))"), None,
                        fingerprint="dear") == CLASS_HEAVY
        assert classify(parse("Count(Row(a=1))"), None,
                        fingerprint="cold") == CLASS_POINT
    finally:
        stats.swap(prev)


def test_parse_weights():
    assert parse_weights("a:4, b:1") == {"a": 4.0, "b": 1.0}
    assert parse_weights("") == {} == parse_weights(None)
    assert parse_weights("a:4,junk,b:zero,c:2") == {"a": 4.0, "c": 2.0}
    assert parse_weights("a:4,junk,b:zero,c:2") == \
        jsched.parse_weights("a:4,junk,b:zero,c:2")


def test_heavy_gate_bounds_concurrency():
    sched = AdmissionScheduler(heavy_slots=2, queue_max=64)
    peak, running = [0], [0]
    lock = threading.Lock()
    go = threading.Event()

    def worker():
        with sched.heavy_slot(None):
            with lock:
                running[0] += 1
                peak[0] = max(peak[0], running[0])
            go.wait(5)
            with lock:
                running[0] -= 1

    def release():
        assert wait_until(lambda: sched.queued() == 6)
        go.set()

    run_threads([worker] * 8 + [release])
    assert peak[0] == 2
    assert sched.queued() == 0


def test_weighted_fair_queue_grant_order():
    """Stride scheduling: with the one slot busy, a weight-4 tenant's
    queued requests drain about four times as fast as a weight-1
    tenant's."""
    sched = AdmissionScheduler(heavy_slots=1, queue_max=64,
                               tenant_weights={"big": 4.0, "small": 1.0})
    order: list[str] = []
    blocker = sched.heavy_slot(None)
    blocker.__enter__()
    ts = []
    for i in range(8):
        tenant = "big" if i % 2 == 0 else "small"

        def worker(tenant=tenant):
            with sched.heavy_slot(QoS.make(tenant=tenant)):
                order.append(tenant)
        t = threading.Thread(target=worker, daemon=True)
        t.start()
        ts.append(t)
        assert wait_until(lambda n=i + 1: sched.queued() == n)
    blocker.__exit__(None, None, None)
    for t in ts:
        t.join(30)
    assert not any(t.is_alive() for t in ts)
    assert order.count("big") == 4 and order.count("small") == 4
    assert order[:5].count("big") >= 4, order
    assert not sched._queues and not sched._passes


def test_backpressure_shed_typed_503():
    sched = AdmissionScheduler(heavy_slots=1, queue_max=2)
    blocker = sched.heavy_slot(None)
    blocker.__enter__()
    waiters = []
    for _ in range(2):
        def queue_one():
            with sched.heavy_slot(None):
                pass
        t = threading.Thread(target=queue_one, daemon=True)
        t.start()
        waiters.append(t)
    assert wait_until(lambda: sched.queued() == 2)
    shed0 = metrics.ADMISSION_TOTAL.value(**{"class": "heavy",
                                             "outcome": "shed"})
    with pytest.raises(ServingShedError) as ei:
        with sched.heavy_slot(None):
            pass
    assert ei.value.status == 503 and ei.value.retry_after_s > 0
    assert metrics.ADMISSION_TOTAL.value(
        **{"class": "heavy", "outcome": "shed"}) == shed0 + 1
    blocker.__exit__(None, None, None)
    for t in waiters:
        t.join(30)
    assert not any(t.is_alive() for t in waiters)


def test_deadline_expiry_504():
    sched = AdmissionScheduler(heavy_slots=1, queue_max=8)
    dead = QoS.make(deadline_ms=1.0)
    dead.deadline_s = time.monotonic() - 1.0     # dead on arrival
    with pytest.raises(ServingDeadlineExceeded) as ei:
        with sched.heavy_slot(dead):
            pass
    assert ei.value.status == 504
    blocker = sched.heavy_slot(None)
    blocker.__enter__()
    t0 = time.perf_counter()
    with pytest.raises(ServingDeadlineExceeded):
        with sched.heavy_slot(QoS.make(deadline_ms=50)):
            pass
    assert time.perf_counter() - t0 < 5.0
    assert sched.queued() == 0
    blocker.__exit__(None, None, None)


def test_audit_class_has_its_own_cap():
    sched = AdmissionScheduler(heavy_slots=1, queue_max=1)
    a = sched.audit_slot()
    assert a is not None
    assert sched.audit_slot() is None       # one audit at a time
    a.release()
    b = sched.audit_slot()
    assert b is not None
    b.release()


@pytest.fixture(scope="module")
def holder():
    return build_holder(PORT, track_existence=False)


def test_point_reads_bypass_saturated_heavy_gate(holder, fresh_stats):
    srv = make_executor(PORT, holder)
    layer = srv.enable_serving(window_s=0.0, max_batch=8, heavy_slots=1,
                               queue_max=4)
    blocker = layer.sched.heavy_slot(None)
    blocker.__enter__()
    try:
        assert srv.execute_serving("i", "Count(Row(a=1))") == [75]
    finally:
        blocker.__exit__(None, None, None)


def test_default_deadline_applies_to_tenant_only_qos(holder, fresh_stats):
    srv = make_executor(PORT, holder)
    layer = srv.enable_serving(window_s=0.0, max_batch=8, heavy_slots=1,
                               queue_max=4, default_deadline_ms=60.0)
    blocker = layer.sched.heavy_slot(None)
    blocker.__enter__()
    try:
        with pytest.raises(ServingDeadlineExceeded):
            srv.execute_serving("i", "TopN(a, n=3)",
                                qos=QoS.make(tenant="acme"))
    finally:
        blocker.__exit__(None, None, None)


def test_heavy_query_end_to_end_shed_and_flight_fields(holder,
                                                       fresh_stats):
    from pilosa_tpu_torch.obs import flight
    srv = make_executor(PORT, holder)
    layer = srv.enable_serving(window_s=0.0, max_batch=8, heavy_slots=1,
                               queue_max=1)
    srv.execute_serving("i", "Count(Row(a=2))",
                        qos=QoS.make(tenant="acme", deadline_ms=5000))
    mine = [r for r in flight.recorder.recent(20)
            if r.get("tenant") == "acme"]
    assert mine and mine[-1]["priority"] == "point"
    assert mine[-1]["deadline_ms"] == 5000.0
    blocker = layer.sched.heavy_slot(None)
    blocker.__enter__()
    done = threading.Event()

    def queued_one():
        srv.execute_serving("i", "TopN(a, n=3)")
        done.set()
    t = threading.Thread(target=queued_one, daemon=True)
    t.start()
    try:
        assert wait_until(lambda: layer.sched.queued() == 1)
        with pytest.raises(ServingShedError):
            srv.execute_serving("i", "TopN(a, n=2)")
    finally:
        blocker.__exit__(None, None, None)
        t.join(30)
    assert done.is_set()
