"""The port's observability planes against the JAX package's.

tests/test_obs.py's logger, metrics and tracing cases and the flight
recorder cases of tests/test_flight.py that need no serving layer and
no HTTP server, run on both packages' obs modules (``pkg``): the
port's copies behave as the originals.  Then the seams: the port's
``Executor.execute`` opens the JAX solo path's spans (names and nesting
equal on the same seeded holder, cold and warm), its flight record
carries the same fields, ``API.query(profile=True)`` returns the span
tree and the long-query log keeps slow queries with their spans, and
the metrics the port's engine moves (query totals, stacked routes,
stack-cache outcomes against ``StackCache.counters()``, import totals)
are read from the port's own registry as deltas.  The port runs on the
CPU (device="cpu")."""

import datetime as dt
import io
import json
import threading
import types

import numpy as np
import pytest
import torch

import pilosa_tpu.obs as jax_obs
import pilosa_tpu_torch.obs as port_obs
from pilosa_tpu.executor.executor import Executor as JaxExecutor
from pilosa_tpu.models.holder import Holder as JaxHolder
from pilosa_tpu.models.schema import FieldOptions as JaxFieldOptions
from pilosa_tpu.models.schema import FieldType as JaxFieldType
from pilosa_tpu.models.schema import TimeQuantum as JaxTimeQuantum
from pilosa_tpu.obs import flight as jax_flight
from pilosa_tpu.obs import logger as jax_logger
from pilosa_tpu.obs import metrics as jax_metrics
from pilosa_tpu.obs import tracing as jax_tracing
from pilosa_tpu_torch.api import API
from pilosa_tpu_torch.executor.executor import Executor
from pilosa_tpu_torch.models.holder import Holder
from pilosa_tpu_torch.models.schema import FieldOptions, FieldType, TimeQuantum
from pilosa_tpu_torch.obs import flight, metrics, tracing
from pilosa_tpu_torch.obs import logger as port_logger

torch.set_num_threads(1)

PKGS = {
    "jax": types.SimpleNamespace(obs=jax_obs, lg=jax_logger,
                                 flight=jax_flight, tracing=jax_tracing,
                                 metrics=jax_metrics),
    "port": types.SimpleNamespace(obs=port_obs, lg=port_logger,
                                  flight=flight, tracing=tracing,
                                  metrics=metrics),
}


@pytest.fixture(params=sorted(PKGS))
def pkg(request):
    return PKGS[request.param]


# -- tests/test_obs.py -------------------------------------------------------

def test_logger_levels_and_format(pkg):
    buf = io.StringIO()
    log = pkg.obs.Logger(buf, level=pkg.lg.INFO)
    log.debug("hidden %d", 1)
    log.info("hello %s", "world")
    log.error("boom")
    out = buf.getvalue()
    assert "hidden" not in out
    assert "INFO" in out and "hello world" in out
    assert "ERROR" in out and "boom" in out


def test_logger_prefix(pkg):
    buf = io.StringIO()
    pkg.obs.Logger(buf).with_prefix("executor").info("x")
    assert "[executor]" in buf.getvalue()


def test_logger_ring_and_nop(pkg):
    pkg.lg.ring.clear()
    pkg.obs.Logger(io.StringIO()).warn("kept %d", 7)
    pkg.obs.NopLogger().error("dropped")
    lines = pkg.lg.ring.recent(10)
    assert len(lines) == 1 and "WARN" in lines[0] and "kept 7" in lines[0]


def test_counter_gauge_labels(pkg):
    r = pkg.obs.MetricsRegistry()
    c = r.counter("q_total", "queries")
    c.inc()
    c.inc(2, index="i0")
    g = r.gauge("open_dbs")
    g.set(5)
    g.add(-1)
    text = r.render_text()
    assert "# TYPE q_total counter" in text
    assert "q_total 1" in text
    assert 'q_total{index="i0"} 2' in text
    assert "open_dbs 4" in text
    assert c.value(index="i0") == 2
    assert c.total() == 3


def test_histogram_buckets(pkg):
    r = pkg.obs.MetricsRegistry()
    h = r.histogram("lat", buckets=(0.01, 0.1, 1.0))
    for v in (0.005, 0.05, 0.05, 0.5, 5.0):
        h.observe(v)
    text = r.render_text()
    assert 'lat_bucket{le="0.01"} 1' in text
    assert 'lat_bucket{le="0.1"} 3' in text
    assert 'lat_bucket{le="1"} 4' in text
    assert 'lat_bucket{le="+Inf"} 5' in text
    assert "lat_count 5" in text
    h2 = r.histogram("lat2", buckets=(0.01, 0.1, 1.0))
    h2.observe(0.1)
    assert 'lat2_bucket{le="0.1"} 1' in r.render_text()


def test_metrics_registry_same_instance(pkg):
    r = pkg.obs.MetricsRegistry()
    assert r.counter("a") is r.counter("a")


def test_render_json(pkg):
    r = pkg.obs.MetricsRegistry()
    r.counter("c").inc(3)
    r.histogram("h").observe(0.2)
    j = r.render_json()
    assert j["c"][""] == 3
    assert j["h"][""]["count"] == 1


def test_histogram_quantiles_render(pkg):
    r = pkg.obs.MetricsRegistry()
    lat = r.histogram("lat3", "latency", buckets=(0.01, 0.1, 1.0),
                      quantiles=(0.5, 0.99))
    for v in (0.005, 0.02, 0.05, 0.5, 0.9):
        lat.observe(v)
    q = lat.quantile(0.5)
    assert 0.01 < q <= 0.1
    assert lat.quantile(0.99) <= 1.0
    text = r.render_text()
    assert "lat3_p50 " in text and "lat3_p99 " in text
    assert "# TYPE lat3_p50 gauge" in text


def test_histogram_quantile_empty_is_zero(pkg):
    r = pkg.obs.MetricsRegistry()
    assert r.histogram("lat4", "x", quantiles=(0.5,)).quantile(0.5) == 0.0


def test_tracer_span_tree(pkg):
    t = pkg.obs.RecordingTracer()
    pkg.obs.set_tracer(t)
    try:
        with pkg.obs.start_span("query", index="i"):
            with pkg.obs.start_span("mapReduce"):
                with pkg.obs.start_span("shard", shard=0):
                    pass
            with pkg.obs.start_span("translate"):
                pass
        assert len(t.roots) == 1
        d = t.roots[0].to_dict()
        assert d["name"] == "query" and d["tags"] == {"index": "i"}
        assert [c["name"] for c in d["children"]] == ["mapReduce",
                                                       "translate"]
        assert d["children"][0]["children"][0]["tags"] == {"shard": 0}
        assert d["duration_us"] >= 0
    finally:
        pkg.obs.set_tracer(pkg.obs.NopTracer())


def test_tracer_thread_isolation(pkg):
    t = pkg.obs.RecordingTracer()
    pkg.obs.set_tracer(t)
    try:
        def work(i):
            with pkg.obs.start_span(f"root{i}"):
                with pkg.obs.start_span("child"):
                    pass
        ts = [threading.Thread(target=work, args=(i,)) for i in range(4)]
        [x.start() for x in ts]
        [x.join() for x in ts]
        assert len(t.roots) == 4
        assert all(len(r.children) == 1 for r in t.roots)
    finally:
        pkg.obs.set_tracer(pkg.obs.NopTracer())


def test_nop_tracer_cheap(pkg):
    pkg.obs.set_tracer(pkg.obs.NopTracer())
    with pkg.obs.start_span("x") as s:
        s.set_tag("a", 1)


# -- tests/test_flight.py, the cases with no serving layer -------------------

def test_nop_span_not_shared(pkg):
    t = pkg.tracing.NopTracer()
    with t.span("x") as s1:
        s1.children.append(pkg.tracing.Span("evil"))
        s1.tags["k"] = "v"
        s1.start = -1.0
    with t.span("y") as s2:
        assert s2 is not s1 and s2.children == []
        assert "k" not in s2.tags and s2.start != -1.0
        s2.set_tag("a", 1)
        s2.finish()
        assert s2.duration == 0.0 and s2.tags == {}


def test_span_copy_is_deep(pkg):
    s = pkg.tracing.Span("root")
    s.set_tag("k", "v")
    c = pkg.tracing.Span("child")
    c.finish()
    s.children.append(c)
    s.finish()
    cp = s.copy()
    assert cp.to_dict() == s.to_dict()
    cp.children.append(pkg.tracing.Span("extra"))
    cp.tags["other"] = 1
    assert len(s.children) == 1 and "other" not in s.tags


def test_capture_context_none_when_untraced(pkg):
    assert pkg.tracing.capture_context() is None


def test_span_into_grafts_across_threads(pkg):
    tr = pkg.tracing
    tracer = tr.RecordingTracer()
    prev = tr.push_thread_tracer(tracer)
    try:
        with tr.start_span("root") as root:
            ctx = tr.capture_context()
            assert ctx is not None and ctx.parent is root

            def leader():
                with tr.span_into(ctx, "leader.work", batch=3):
                    with tr.start_span("leader.nested"):
                        pass

            t = threading.Thread(target=leader)
            t.start()
            t.join()
        d = tracer.roots[0].to_dict()
        names = [c["name"] for c in d["children"]]
        lw = d["children"][names.index("leader.work")]
        assert lw["tags"] == {"batch": 3}
        assert [c["name"] for c in lw["children"]] == ["leader.nested"]
    finally:
        tr.pop_thread_tracer(prev)


def test_span_into_none_silences_borrowed_thread(pkg):
    tr = pkg.tracing
    tracer = tr.RecordingTracer()
    prev = tr.push_thread_tracer(tracer)
    try:
        with tr.start_span("root"):
            with tr.span_into(None, "follower.plan"):
                with tr.start_span("follower.inner"):
                    pass
        assert "children" not in tracer.roots[0].to_dict()
    finally:
        tr.pop_thread_tracer(prev)


def test_span_into_rootless_context_records_root(pkg):
    tr = pkg.tracing
    tracer = tr.RecordingTracer()
    prev = tr.push_thread_tracer(tracer)
    try:
        ctx = tr.capture_context()
    finally:
        tr.pop_thread_tracer(prev)
    with tr.span_into(ctx, "detached"):
        pass
    assert [s.name for s in tracer.roots] == ["detached"]


def test_span_wire_roundtrip(pkg):
    tr = pkg.tracing
    s = tr.Span("root")
    c = tr.Span("child")
    c.set_tag("k", 1)
    c.finish()
    s.children.append(c)
    s.finish()
    w = tr.span_to_wire(s)
    back = tr.span_from_wire(json.loads(json.dumps(w)), anchor=10.0)
    assert back.name == "root" and back.children[0].tags == {"k": 1}
    assert back.start == 10.0


def test_flight_ring_bounded(pkg):
    rec = pkg.flight.recorder
    rec.configure(enabled=True, keep=4)
    try:
        rec.clear()
        for i in range(10):
            rec.record({"trace_id": f"t{i}", "start": 0.0,
                        "duration_ms": 1.0, "phases": {}})
        recs = rec.recent(100)
        assert len(recs) == 4 and recs[0]["trace_id"] == "t9"
    finally:
        rec.configure(keep=512)


def test_flight_begin_commit_fields(pkg):
    """A record opened and committed by hand carries the same fields in
    both packages, the port's also its origin on perf_counter (``t0``)
    and where its phases happened (``intervals``); a nested begin opens
    nothing."""
    fl = pkg.flight
    fl.recorder.configure(enabled=True)
    fl.recorder.clear()
    rec = fl.begin("i", "Count(Row(a=1))")
    assert fl.begin("i", "inner") is None
    fl.note_phase("execute", 0.002)
    fl.note_stack("rebuild", 128, 0.001)
    fl.commit(rec, 0.005, route="solo")
    (got,) = fl.recorder.recent(5)
    shared = {k: v for k, v in got.items()
              if pkg.flight is not flight or k not in ("t0", "intervals")}
    assert sorted(shared) == ["batch", "bytes_moved", "duration_ms",
                              "index", "phases", "query", "route", "stack",
                              "stack_keys", "start", "trace_id"]
    if pkg.flight is flight:
        assert [i[0] for i in got["intervals"]] == ["execute",
                                                    "stack_rebuild"]
    assert got["route"] == "solo" and got["stack"] == {"rebuild": 1}
    assert got["bytes_moved"] == 128
    assert set(got["phases"]) == {"execute", "stack_rebuild"}
    assert fl.active_acc() is None
    doc = json.loads(fl.recorder.chrome_trace_json(5))
    assert any(ev.get("cat") == "query" for ev in doc["traceEvents"])


# -- the port's seams, against the JAX solo path ------------------------------

W = 2048


def _holder(h, opts, ftype, tq):
    """Index i: set fields a, b, a TIME field ev (YMDH) and an INT v
    over 3 shards, the same seeded bits in either package."""
    rng = np.random.default_rng(41)
    idx = h.create_index("i")
    a, b = idx.create_field("a"), idx.create_field("b")
    ev = idx.create_field("ev", opts(type=ftype.TIME,
                                     time_quantum=tq("YMDH")))
    n = 600
    cols = rng.integers(0, 3 * W, size=n)
    a.import_bits(rng.integers(0, 3, size=n), cols)
    b.import_bits(rng.integers(0, 5, size=n), rng.integers(0, 3 * W, size=n))
    base = dt.datetime(2022, 6, 1)
    for i, c in enumerate(rng.integers(0, 3 * W, size=200).tolist()):
        ev.set_bit(i % 2, c, timestamp=base + dt.timedelta(hours=i % 50))
    v = idx.create_field("v", opts(type=ftype.INT, min=-50, max=50))
    vc = np.unique(rng.integers(0, 3 * W, size=300))
    v.import_values(vc, rng.integers(-50, 51, size=vc.size))
    return h


@pytest.fixture(scope="module")
def holders():
    return (_holder(JaxHolder(width=W), JaxFieldOptions, JaxFieldType,
                    JaxTimeQuantum),
            _holder(Holder(width=W), FieldOptions, FieldType, TimeQuantum))


def _tree(d):
    return (d["name"], [_tree(c) for c in d.get("children", [])])


def _traced(tr, ex, index, query):
    tracer = tr.RecordingTracer()
    prev = tr.push_thread_tracer(tracer)
    try:
        out = ex.execute(index, query)
    finally:
        tr.pop_thread_tracer(prev)
    return out, [_tree(s.to_dict()) for s in tracer.roots]


SPAN_QUERIES = [
    "Count(Row(a=1))",
    "Count(Intersect(Row(a=1), Row(b=2)))",
    "Count(Row(ev=1, from='2022-06-01T05:00', to='2022-06-02T20:00'))",
    "Row(a=2)",
    "TopN(b, Row(a=1), n=3)",
    "Count(Row(a=1)) Count(Row(b=1))",
    "Sum(Row(a=1), field=v)",
    "Count(Row(v > 10))",
    "Min(field=v)",
    "GroupBy(Rows(a), Rows(b))",
    "GroupBy(Rows(a), filter=Row(b=1), aggregate=Sum(field=v))",
]


@pytest.mark.parametrize("query", SPAN_QUERIES)
def test_execute_spans_equal_the_jax_solo_path(holders, query):
    """Cold and warm, the span trees of Executor.execute (names and
    nesting: executor.Execute, executor.execute<Call>, stacked.plan_build
    with a stacked.stack a built stack, stacked.dispatch) equal the JAX
    package's on the same holder."""
    jh, ph = holders
    jex, pex = JaxExecutor(jh), Executor(ph, device="cpu")
    for _ in ("cold", "warm"):
        _jout, jtree = _traced(jax_tracing, jex, "i", query)
        _pout, ptree = _traced(tracing, pex, "i", query)
        assert ptree == jtree


def test_execute_tags_the_trace_id_and_records_a_solo_flight(holders):
    _jh, ph = holders
    ex = Executor(ph, device="cpu")
    flight.recorder.configure(enabled=True)
    flight.recorder.clear()
    tracer = tracing.RecordingTracer()
    prev = tracing.push_thread_tracer(tracer)
    try:
        ex.execute("i", "Count(Row(b=2))")
    finally:
        tracing.pop_thread_tracer(prev)
    (rec,) = flight.recorder.recent(5)
    assert rec["route"] == "solo" and rec["index"] == "i"
    assert "execute" in rec["phases"] and "plan_build" in rec["phases"]
    assert tracer.roots[0].tags["trace_id"] == rec["trace_id"]
    flight.flush_metrics()
    assert metrics.PHASE_DURATION.count(phase="execute") > 0


def test_flight_disabled_records_nothing(holders):
    _jh, ph = holders
    ex = Executor(ph, device="cpu")
    flight.recorder.configure(enabled=False)
    try:
        flight.recorder.clear()
        ex.execute("i", "Count(Row(a=0))")
        assert flight.recorder.recent(5) == []
    finally:
        flight.recorder.configure(enabled=True)


def test_query_metrics_and_routes(holders):
    """pilosa_query_total by index and status, the duration histogram,
    and pilosa_stacked_queries_total by path, as deltas of the port's
    registry."""
    _jh, ph = holders
    ex = Executor(ph, device="cpu")
    ok0 = metrics.QUERY_TOTAL.value(index="i", status="ok")
    err0 = metrics.QUERY_TOTAL.value(index="(unknown)", status="error")
    n0 = metrics.QUERY_DURATION.count()
    st0 = metrics.STACKED_QUERIES.value(path="stacked")
    ex.execute("i", "Count(Row(a=1)) Count(Row(b=1))")
    with pytest.raises(Exception):
        ex.execute("nowhere", "Count(Row(a=1))")
    assert metrics.QUERY_TOTAL.value(index="i", status="ok") == ok0 + 1
    assert metrics.QUERY_TOTAL.value(index="(unknown)",
                                     status="error") == err0 + 1
    assert metrics.QUERY_DURATION.count() == n0 + 2
    assert metrics.STACKED_QUERIES.value(path="stacked") == st0 + 2
    lp0 = metrics.STACKED_QUERIES.value(path="loop")
    ex.execute("i", "MinRow(field=a)")
    ex.use_stacked = False
    ex.execute("i", "Count(Row(a=1))")
    # neither route asks the stacked engine: no path is counted
    assert metrics.STACKED_QUERIES.value(path="loop") == lp0


def _stack_outcomes():
    return {o: metrics.STACK_CACHE.value(outcome=o)
            for o in ("hit", "miss", "patch", "rebuild")}


def test_stack_cache_metric_equals_counters(holders):
    """pilosa_stack_cache_total moves with StackCache.counters(): hit =
    hits, miss = every other access, patch = patches + adopts, rebuild
    = full_rebuilds; the maintenance bytes split patched and rebuilt."""
    _jh, ph = holders
    ex = Executor(ph, device="cpu")
    before = _stack_outcomes()
    pb0 = metrics.STACK_MAINT_BYTES.value(kind="patched")
    rb0 = metrics.STACK_MAINT_BYTES.value(kind="rebuilt")
    q = "Count(Intersect(Row(a=1), Row(b=2)))"
    ex.execute("i", q)
    ex.execute("i", q)
    ex.execute("i", "Set(5, a=1)")
    ex.execute("i", "Set(4200, b=9)")
    ex.execute("i", q)
    c = ex.stacked.cache.counters()
    got = {k: v - before[k] for k, v in _stack_outcomes().items()}
    assert got == {"hit": c["hits"],
                   "miss": c["adopts"] + c["patches"] + c["full_rebuilds"],
                   "patch": c["patches"] + c["adopts"],
                   "rebuild": c["full_rebuilds"]}
    assert c["patches"] >= 1 and c["hits"] >= 2
    assert metrics.STACK_MAINT_BYTES.value(kind="patched") - pb0 == \
        c["patched_bytes"]
    assert metrics.STACK_MAINT_BYTES.value(kind="rebuilt") - rb0 == \
        c["rebuilt_bytes"]
    # undo the writes on the shared holder
    ex.execute("i", "Clear(5, a=1)")
    ex.execute("i", "Clear(4200, b=9)")


def test_per_shard_tiles_move_no_stack_metric(holders):
    """The per-shard engine's tile cache is its own: it opens no
    stacked.stack span and moves no stack-cache outcome."""
    _jh, ph = holders
    ex = Executor(ph, device="cpu")
    ex.use_stacked = False
    before = _stack_outcomes()
    _out, trees = _traced(tracing, ex, "i", "Count(Row(a=1))")
    assert _stack_outcomes() == before
    assert trees == [("executor.Execute", [("executor.executeCount", [])])]


def test_api_profile_and_long_query_log(holders):
    _jh, ph = holders
    api = API(ph, device="cpu")
    q = "Count(Intersect(Row(a=1), Row(b=2)))"
    resp = api.query("i", q, profile=True)
    assert resp["results"] == [api.executor.execute("i", q)[0]]
    (root,) = resp["profile"]
    assert root["name"] == "executor.Execute"
    assert [c["name"] for c in root["children"]] == ["executor.executeCount"]
    assert "profile" not in api.query("i", q)
    assert api.long_queries() == []
    buf = io.StringIO()
    api.logger = port_obs.Logger(buf)
    api.long_query_time = 1e-9
    api.query("i", q)
    (entry,) = api.long_queries()
    assert entry["query"] == q and entry["index"] == "i"
    assert entry["spans"][0]["name"] == "executor.Execute"
    assert "long query" in buf.getvalue()
    assert isinstance(API(ph, device="cpu").logger, port_obs.Logger)


def test_import_metrics(holders):
    _jh, ph = holders
    api = API(ph, device="cpu")
    api.create_index("m")
    api.create_field("m", "f")
    api.create_field("m", "v", {"type": "int", "min": 0, "max": 100})
    t0 = metrics.IMPORT_TOTAL.value(index="m")
    b0 = metrics.IMPORTED_BITS.value(index="m")
    api.import_bits("m", "f", rows=[1, 1, 2], cols=[3, 4, 5])
    api.import_values("m", "v", cols=[3, 4], values=[7, 8])
    api.import_columns("m", [10, 11], bits={"f": [1, 2]},
                       values={"v": [1, 2]})
    api.import_bits("m", "f", rows=[1], cols=[3], clear=True)
    assert metrics.IMPORT_TOTAL.value(index="m") == t0 + 4
    assert metrics.IMPORTED_BITS.value(index="m") == b0 + 3 + 2 + 4


def test_obs_env_names_are_the_jax_packages():
    """The obs planes read the JAX package's environment names, and
    nothing else of the port reads them."""
    import inspect
    assert "PILOSA_TPU_FLIGHT" in inspect.getsource(flight)
    from pilosa_tpu_torch.obs import faults, testhook
    assert "PILOSA_TPU_FAULT_SPEC" in inspect.getsource(faults)
    assert "PILOSA_TPU_TESTHOOK" in inspect.getsource(testhook)
