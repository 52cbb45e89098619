"""The port's tracing plane inside the serving path, on the CPU: spans
and flight phases on perf_counter (the clock a device trace is placed
on), the heavy-slot wait, the batch leader, launch and sync, the SQL
statement's inner phases, the garbage collector's passes and the
audit's shadow time.  Port-only: nothing here imports the JAX package."""

import gc
import json
import threading
import time

import numpy as np
import pytest
import torch

from pilosa_tpu_torch.api import API
from pilosa_tpu_torch.executor.executor import Executor
from pilosa_tpu_torch.executor.sched import QoS
from pilosa_tpu_torch.memory import encode, pressure
from pilosa_tpu_torch.models.holder import Holder
from pilosa_tpu_torch.models.schema import FieldOptions, FieldType
from pilosa_tpu_torch.obs import (audit, faults, flight, metrics, runtime,
                                  tracing)

torch.set_num_threads(1)

W = 2048


def _holder(index: str = "tp") -> Holder:
    """Set fields a (4 rows), b (6 rows) and an INT v over 3 shards."""
    rng = np.random.default_rng(7)
    h = Holder(width=W)
    idx = h.create_index(index)
    n = 400
    idx.create_field("a").import_bits(rng.integers(0, 4, size=n),
                                      rng.integers(0, 3 * W, size=n))
    idx.create_field("b").import_bits(rng.integers(0, 6, size=n),
                                      rng.integers(0, 3 * W, size=n))
    v = idx.create_field("v", FieldOptions(type=FieldType.INT, min=0,
                                           max=1000))
    cols = np.unique(rng.integers(0, 3 * W, size=200))
    v.import_values(cols, rng.integers(0, 1001, size=cols.size))
    return h


@pytest.fixture
def serving():
    """An executor with its serving layer (no result cache), the flight
    recorder on and cleared; its planes stopped after the test."""
    flight.recorder.configure(enabled=True)
    flight.recorder.clear()
    ex = Executor(_holder(), device="cpu")
    srv = ex.enable_serving(window_s=0.0, max_batch=8, cache_bytes=0,
                            heavy_slots=2)
    yield ex, srv
    srv.close()
    audit.stop_all()


def _traced(fn):
    """fn() on a thread tracer; (its value, its root spans)."""
    t = tracing.RecordingTracer()
    prev = tracing.push_thread_tracer(t)
    try:
        return fn(), t.roots
    finally:
        tracing.pop_thread_tracer(prev)


def _walk(spans):
    for s in spans:
        yield s
        yield from _walk(s.children)


def _record(route: str) -> dict:
    (rec,) = [r for r in flight.recorder.recent(64) if r["route"] == route]
    return rec


# -- spans ---------------------------------------------------------------------

def test_the_nop_span_reads_no_clock():
    with tracing.NopTracer().span("x") as s:
        assert s.start == s.end == 0.0 and s.duration == 0.0


# -- the serving path ----------------------------------------------------------

def test_a_batch_leader_names_its_batch(serving):
    ex, srv = serving
    (n,), roots = _traced(lambda: ex.execute_serving("tp", "Count(Row(a=1))"))
    assert n > 0
    rec = _record("fused")
    spans = {s.name: s for s in _walk(roots)}
    batch = spans["serving.batch"]
    assert rec["batch_id"] == batch.tags["batch_id"]
    assert batch.tags["riders"] == 1
    assert batch.tags["trace_ids"] == [rec["trace_id"]]
    assert spans["serving.dispatch"].tags["batch_id"] == rec["batch_id"]
    assert {"serving.snapshot", "serving.to_host", "serving.cache_lookup",
            "serving.batch_wait"} <= set(spans)
    inside = {c.name for c in _walk(batch.children)}
    assert {"serving.snapshot", "serving.to_host"} <= inside
    assert spans["serving.batch_wait"].tags == {"wait": True, "leader": True}


def _until(cond):
    for _ in range(5000):
        if cond():
            return True
        time.sleep(0.002)
    return False


def test_a_follower_waits_in_a_batch_wait_span(serving):
    """While one batch runs, the next leader waits for it and a third
    request parks behind that leader: each wait is a
    ``serving.batch_wait`` span, the follower's with no ``leader`` tag."""
    ex, srv = serving
    gate = threading.Event()
    orig = srv._run_batch

    def held(batch):
        gate.wait(10)
        return orig(batch)
    srv._run_batch = held
    got = {}

    def serve(name, q):
        def run():
            got[name] = _traced(lambda: ex.execute_serving("tp", q))
        t = threading.Thread(target=run)
        t.start()
        return t
    b = srv.batcher
    ts = [serve("first", "Count(Row(a=2))")]
    try:
        assert _until(lambda: b._inflight == 1)
        ts.append(serve("leader", "Count(Row(a=3))"))
        assert _until(lambda: b._leader)
        ts.append(serve("follower", "Count(Row(b=3))"))
        assert _until(lambda: len(b._pending) == 2)
    finally:
        gate.set()
        for t in ts:
            t.join(30)

    def waits(name):
        return [s.tags for s in _walk(got[name][1])
                if s.name == "serving.batch_wait"]
    assert waits("follower") == [{"wait": True}]
    assert waits("leader") == [{"wait": True, "leader": True}]


def test_a_heavy_wait_is_admit_and_not_duration(serving):
    ex, srv = serving
    slots = [srv.sched.heavy_slot(None) for _ in range(2)]
    for s in slots:
        s.__enter__()
    got = {}

    def query():
        got["out"] = _traced(lambda: ex.execute_serving(
            "tp", "GroupBy(Rows(a), Rows(b))",
            qos=QoS.make(priority="heavy")))
        got["done"] = time.perf_counter()
    t = threading.Thread(target=query)
    t.start()
    try:
        for _ in range(5000):
            if srv.sched.queued() == 1:
                break
            time.sleep(0.002)
        assert srv.sched.queued() == 1
        time.sleep(0.2)
    finally:
        released = time.perf_counter()
        for s in slots:
            s.__exit__(None, None, None)
    t.join(30)
    (rec,) = [r for r in flight.recorder.recent(64)
              if r["query"].startswith("GroupBy") and r["route"] != "solo"]
    assert rec["phases"]["admit"] >= 150.0
    # the record's duration starts after the gate
    assert rec["duration_ms"] <= (got["done"] - released) * 1e3
    (admit,) = [s for s in got["out"][1] if s.name == "serving.admit"]
    assert admit.tags == {"wait": True, "class": "heavy"}
    assert admit.duration >= 0.15


@pytest.mark.parametrize("query, route", [
    ("Count(Row(a=1))", "fused"),
    ("Count(Row(a=1)) Count(Row(b=1))", "direct")])
def test_launch_and_sync_sum_to_execute(serving, query, route):
    """A clean dispatch's execute is its launch and sync, and for a
    fused batch also the copy of its outputs to the host."""
    ex, _srv = serving
    ex.execute_serving("tp", query)
    ph = _record(route)["phases"]
    assert ph["launch"] >= 0 and ph["sync"] >= 0
    assert ("to_host" in ph) == (route == "fused")
    inside = sum(ph.get(k, 0.0) for k in flight.IN_EXECUTE)
    assert abs(inside - ph["execute"]) * 1e-3 <= 1e-6


@pytest.fixture
def dense_pages():
    """Dense pages, so that a read launches work on the engine, and no
    armed out-of-memory fault left behind."""
    prev = encode._ENABLED
    encode.configure(enabled=False)
    yield
    encode.configure(enabled=prev)
    faults.clear("device-oom")


def test_a_retry_launches_from_its_own_attempt(dense_pages):
    """The failed attempt and the relief sweep after it are in execute
    alone: launch starts with the attempt that returned."""
    ex = Executor(_holder(), device="cpu")
    want = ex.execute("tp", "Sum(Row(a=1), field=v)")  # stacks built
    flight.recorder.configure(enabled=True)
    flight.recorder.clear()
    r0 = metrics.OOM_TOTAL.value(outcome="retry_ok")
    pressure.inject_oom(1)
    assert ex.execute("tp", "Sum(Row(a=1), field=v)") == want
    assert metrics.OOM_TOTAL.value(outcome="retry_ok") == r0 + 1
    assert not faults.armed("device-oom")
    rec = _record("solo")
    ph = rec["phases"]
    assert 0 <= ph["launch"] + ph["sync"] < ph["execute"]
    at = {k: (off, ms) for k, off, ms in rec["intervals"]}
    (e_off, e_ms), (l_off, _l_ms) = at["execute"], at["launch"]
    assert l_off > e_off
    assert at["sync"][0] + at["sync"][1] == pytest.approx(e_off + e_ms,
                                                          abs=1e-3)


def test_a_host_fallback_notes_neither_launch_nor_sync(dense_pages):
    ex = Executor(_holder(), device="cpu")
    want = ex.execute("tp", "Sum(Row(a=1), field=v)")
    flight.recorder.configure(enabled=True)
    flight.recorder.clear()
    f0 = metrics.OOM_TOTAL.value(outcome="host_fallback")
    pressure.inject_oom(2)  # the attempt and the retry
    assert ex.execute("tp", "Sum(Row(a=1), field=v)") == want
    assert metrics.OOM_TOTAL.value(outcome="host_fallback") == f0 + 1
    ph = _record("solo")["phases"]
    assert ph["execute"] > 0
    assert not set(ph) & flight.IN_EXECUTE


def _fixed_record(split: bool) -> dict:
    """A fused record from a fixed sequence of phases; with ``split``
    the leader's execute also notes its launch and sync."""
    flight.recorder.configure(enabled=True)
    rec = flight.begin("tp", "Count(Row(a=1))")
    flight.note_phase("cache_lookup", 0.001)
    leader = flight.Acc()
    for name, dt in (("plan_build", 0.002), ("stack_hit", 0.001),
                     ("execute", 0.004), ("demux", 0.0005)):
        leader.add_phase(name, dt)
    if split:
        leader.add_phase("launch", 0.003)
        leader.add_phase("sync", 0.001)
    flight.note_phase("batch", 0.010)
    flight.commit(rec, 0.012, route="fused", extra_acc=leader)
    return flight.recorder.recent(1)[0]


def test_launch_and_sync_leave_wait_as_it_was():
    plain, split = _fixed_record(False), _fixed_record(True)
    assert plain["phases"]["wait"] == split["phases"]["wait"] == \
        pytest.approx(10.0 - 7.5)


def test_admit_lies_outside_the_batch():
    flight.recorder.configure(enabled=True)
    rec = flight.begin("tp", "GroupBy(Rows(a))")
    flight.note_phase("admit", 0.050)
    flight.note_phase("batch", 0.010)
    flight.commit(rec, 0.012, route="fused")
    assert flight.recorder.recent(1)[0]["phases"]["wait"] == \
        pytest.approx(10.0)


def test_sql_statement_keeps_its_inner_reads_phases():
    """A statement's inner reads ride the batcher; the leader's work
    for them lands in the statement's record, so its wait is its batch
    time less that work, as for PQL."""
    flight.recorder.configure(enabled=True)
    flight.recorder.clear()
    api = API(Holder(width=W), device="cpu")
    srv = api.executor.enable_serving(window_s=0.0, max_batch=8,
                                      cache_bytes=0)
    try:
        api.sql("create table t (_id id, i1 int, m1 int)")
        api.sql("insert into t (_id, i1, m1) values (1, 5, 2), (2, 7, 2), "
                "(3, 5, 3), (4, 9, 3), (5, 2, 2)")
        flight.recorder.clear()
        out, roots = _traced(lambda: api.sql(
            "select count(*), sum(i1) from t where m1 = 2"))
        assert out["data"] == [[3, 14]]
        rec = _record("sql")
        ph = rec["phases"]
        assert {"plan_build", "execute", "launch", "sync", "demux"} <= set(ph)
        assert any(k.startswith("stack_") for k in ph)
        assert ph["wait"] < ph["batch"]
        (stmt,) = [s for s in roots if s.name == "sql.statement"]
        assert [c.name for c in stmt.children] == ["sql.plan", "sql.run"]
    finally:
        srv.close()
        audit.stop_all()


def test_chrome_trace_draws_phases_at_their_offsets():
    flight.recorder.configure(enabled=True)
    rec = flight.begin("tp", "Count(Row(a=1))")
    t0 = rec["t0"]
    flight.note_phase("execute", 0.002, t0 + 0.010)
    flight.note_phase("demux", 0.001, t0 + 0.004)
    flight.commit(rec, 0.015)
    got = flight.recorder.recent(1)[0]
    doc = json.loads(flight.recorder.chrome_trace_json(1))
    q = [e for e in doc["traceEvents"] if e.get("cat") == "query"][0]
    ph = {e["name"]: e for e in doc["traceEvents"] if e.get("cat") == "phase"}
    assert ph["execute"]["ts"] - q["ts"] == pytest.approx(10_000, abs=1)
    assert ph["demux"]["ts"] - q["ts"] == pytest.approx(4_000, abs=1)
    assert ph["execute"]["dur"] == pytest.approx(2_000)
    assert got["intervals"] == [["execute", 10.0, 2.0], ["demux", 4.0, 1.0]]


# -- threads no client owns ----------------------------------------------------

def test_gc_passes_count_and_enter_the_ring():
    runtime.install()
    n0 = runtime.pass_count()
    full0 = metrics.GC_PASSES.value(generation="2")
    s0 = metrics.GC_PAUSE.value(generation="2")
    t0 = time.perf_counter()
    gc.collect()
    assert runtime.pass_count() > n0
    assert metrics.GC_PASSES.value(generation="2") >= full0 + 1
    assert metrics.GC_PAUSE.value(generation="2") > s0
    assert "pilosa_gc_pause_seconds_total{generation=\"2\"}" in \
        metrics.registry.render_text()
    full = [p for p in runtime.passes(t0) if p[2] == 2]
    assert full and t0 <= full[-1][0] <= full[-1][1] <= time.perf_counter()


def _slow_shadow(srv, started: threading.Event, release: threading.Event):
    plane = srv.audit
    orig = plane._shadow_exec

    def slow(s):
        started.set()
        release.wait(10)
        return orig(s)
    plane._shadow_exec = slow


def test_shadow_seconds_count_a_running_shadow(serving):
    ex, srv = serving
    started, release = threading.Event(), threading.Event()
    _slow_shadow(srv, started, release)
    rate = audit._SAMPLE_RATE
    audit.configure(sample_rate=1.0)
    try:
        total0 = metrics.AUDIT_SHADOW_SECONDS.value()
        t0 = time.perf_counter()
        ex.execute_serving("tp", "Count(Row(a=3))")
        assert started.wait(10)
        a = audit.shadow_seconds()
        time.sleep(0.1)
        b = audit.shadow_seconds()
        assert b - a >= 0.09           # the running one, up to now
        release.set()
        assert srv.audit.wait_idle(30)
        done = metrics.AUDIT_SHADOW_SECONDS.value() - total0
        assert done >= 0.1
        # read back over the shadow's window, after it ended
        assert audit.shadow_seconds() - audit.shadow_seconds(t0) == \
            pytest.approx(done, abs=1e-6)
    finally:
        release.set()
        audit.configure(sample_rate=rate)
