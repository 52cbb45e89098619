"""The port's standing queries (pilosa_tpu_torch/executor/standing.py)
against the JAX package's: write-through maintained Count, TopN,
GroupBy and SQL COUNT(*) results, equal to cold execution at every
poll and to the JAX registry's answers on the same writes, incremental
for plain writes and one declared fallback a structural event (TTL
expiry, rollup, a delta-log overflow).  The cases of
tests/test_standing.py, each run through both packages."""

import datetime as dt

import numpy as np
import pytest
import torch

from pilosa_tpu.executor.standing import (
    StandingUnsupported as JaxStandingUnsupported,
)
from pilosa_tpu.models import fragment as jfragment
from pilosa_tpu.models.schema import TimeQuantum as JaxTimeQuantum
from pilosa_tpu.sql.engine import SQLEngine as JaxSQLEngine
from pilosa_tpu_torch.executor import standing as st
from pilosa_tpu_torch.executor.serving import _MISS
from pilosa_tpu_torch.executor.standing import StandingUnsupported
from pilosa_tpu_torch.models import fragment as pfragment
from pilosa_tpu_torch.models.schema import TimeQuantum
from pilosa_tpu_torch.pql import parse
from pilosa_tpu_torch.sql.engine import SQLEngine
from torch_serving_common import (
    JAX,
    PORT,
    make_executor,
    stop_planes,  # noqa: F401  (autouse)
)

torch.set_num_threads(1)

PKGS = [JAX, PORT]
UNSUPPORTED = {id(JAX): JaxStandingUnsupported, id(PORT): StandingUnsupported}
FRAG = {id(JAX): jfragment, id(PORT): pfragment}
TQ = {id(JAX): JaxTimeQuantum, id(PORT): TimeQuantum}


def build(pkg, n=300):
    h = pkg["Holder"](width=1 << 12)
    idx = h.create_index("i")
    idx.create_field("a", pkg["FieldOptions"](type=pkg["FieldType"].SET,
                                              cache_type="none"))
    idx.create_field("b")
    ex = make_executor(pkg, h)
    for c in range(n):
        ex.execute("i", f"Set({c}, a={c % 4})")
        ex.execute("i", f"Set({c}, b={c % 6})")
    srv = ex.enable_serving(window_s=0.0, max_batch=8)
    return h, ex, srv


def ser(pkg, res):
    return [pkg["ser"](r) for r in res]


def test_count_incremental_bit_exact():
    traces = []
    for pkg in PKGS:
        h, ex, srv = build(pkg)
        q = "Count(Row(a=1))"
        srv.standing.register("i", q)
        cold = make_executor(pkg, h)
        trace = []
        for w in ["Set(3001, a=1)", "Set(3002, a=1)", "Clear(1, a=1)",
                  "Set(3001, a=1)", "Clear(3002, a=1)"]:
            ex.execute_serving("i", w)
            got = ex.execute_serving("i", q)
            assert got == cold.execute("i", q)
            trace.append(got)
        (sq,) = srv.standing._by_id.values()
        assert sq.stats["fallback"] == 0 and sq.stats["incremental"] >= 4
        traces.append(trace)
    assert traces[0] == traces[1]


QS = ["Count(Row(a=1))", "Count(Union(Row(a=0), Row(b=5)))",
      "Count(Not(Row(a=2)))", "TopN(a, n=3)", "TopN(a, Row(b=1), n=2)",
      "GroupBy(Rows(a), Rows(b))"]


def test_property_interleaved_all_kinds():
    traces = []
    for pkg in PKGS:
        h, ex, srv = build(pkg, n=160)
        rng = np.random.default_rng(0xC0FFEE)
        for q in QS:
            srv.standing.register("i", q)
        cold = make_executor(pkg, h)
        trace = []
        for step in range(40):
            col = int(rng.integers(0, 400))
            row = int(rng.integers(0, 6))
            fld = "a" if rng.integers(0, 2) else "b"
            op = "Clear" if rng.integers(0, 3) == 0 else "Set"
            rid = row % 4 if fld == "a" else row
            ex.execute_serving("i", f"{op}({col}, {fld}={rid})")
            if step % 4 == 0:
                for q in QS:
                    got = ser(pkg, ex.execute_serving("i", q))
                    assert got == ser(pkg, cold.execute("i", q)), (step, q)
                    trace.append(got)
        for sq in srv.standing._by_id.values():
            assert sq.stats["incremental"] > 0, sq.describe()
            assert sq.stats["fallback"] == 0, sq.describe()
        traces.append(trace)
    assert traces[0] == traces[1]


def test_sql_standing_bit_exact():
    traces = []
    for pkg, E in ((JAX, JaxSQLEngine), (PORT, SQLEngine)):
        h, ex, srv = build(pkg)
        eng = E(h, ex)
        s = "SELECT COUNT(*) FROM i WHERE a = 1"
        srv.standing.register_sql(eng, s)
        cold = E(h, make_executor(pkg, h))
        trace = []
        for w in ["INSERT INTO i (_id, a) VALUES (9001, 1)",
                  "INSERT INTO i (_id, b) VALUES (9002, 2)",
                  "DELETE FROM i WHERE _id = 9001"]:
            eng.query_one(w)
            got, want = eng.query_one(s), cold.query_one(s)
            assert got.rows == want.rows and got.schema == want.schema
            trace.append((list(got.rows), list(got.schema)))
        (sq,) = srv.standing._by_id.values()
        assert sq.kind == "sql" and sq.stats["incremental"] > 0
        traces.append(trace)
    assert traces[0] == traces[1]


@pytest.mark.parametrize("bad", [
    "Count(Row(v > 3))", "Sum(field=v)", "TopK(b, k=4)",
    "GroupBy(Rows(a), aggregate=Count(Distinct(field=b)))", "Row(a=1)",
    "TopN(b, n=3)"])
def test_unsupported_shapes_reject_typed(bad):
    for pkg in PKGS:
        h, ex, srv = build(pkg, n=40)
        h.index("i").create_field("v", pkg["FieldOptions"](
            type=pkg["FieldType"].INT, min=0, max=100))
        with pytest.raises(UNSUPPORTED[id(pkg)]):
            srv.standing.register("i", bad)
        assert srv.standing.list_info() == []


def test_ttl_expiry_rescopes_standing_cover():
    got = []
    for pkg in PKGS:
        h = pkg["Holder"](width=1 << 12)
        idx = h.create_index("t", track_existence=False)
        f = idx.create_field("ev", pkg["FieldOptions"](
            type=pkg["FieldType"].TIME, time_quantum=TQ[id(pkg)]("YMD"),
            ttl=86400.0))
        old = dt.datetime(2021, 3, 1, 12)
        recent = dt.datetime.now(dt.timezone.utc).replace(tzinfo=None)
        f.set_bit(1, 10, timestamp=old)
        f.set_bit(1, 11, timestamp=old)
        f.set_bit(1, 20, timestamp=recent)
        ex = make_executor(pkg, h)
        srv = ex.enable_serving(window_s=0.0, max_batch=8)
        q = ("Count(Row(ev=1, from='2021-01-01T00:00',"
             " to='2030-01-01T00:00'))")
        srv.standing.register("t", q)
        assert ex.execute_serving("t", q) == [3]
        e0 = FRAG[id(pkg)].mutation_epoch()
        removed = h.remove_expired_views()
        assert any(v.startswith("standard_2021") for v in removed)
        assert FRAG[id(pkg)].mutation_epoch() == e0 + 1   # one latch bump
        srv.standing.on_write()
        got.append((ex.execute_serving("t", q), ex.execute("t", q)))
        (sq,) = srv.standing._by_id.values()
        assert sq.stats["fallback"] == 1
    assert got[0] == got[1] == ([1], [1])


def test_rollup_fold_keeps_standing_bit_exact():
    got = []
    for pkg in PKGS:
        h = pkg["Holder"](width=1 << 12)
        idx = h.create_index("t", track_existence=False)
        f = idx.create_field("ev", pkg["FieldOptions"](
            type=pkg["FieldType"].TIME, time_quantum=TQ[id(pkg)]("MD")))
        old = dt.datetime(2021, 3, 1, 12)
        for c in range(20):
            f.set_bit(1, c, timestamp=old)
        ex = make_executor(pkg, h)
        srv = ex.enable_serving(window_s=0.0, max_batch=8)
        q = ("Count(Row(ev=1, from='2021-03-01T00:00',"
             " to='2021-03-02T00:00'))")
        srv.standing.register("t", q)
        assert ex.execute_serving("t", q) == [20]
        assert f.rollup_views(now=dt.datetime(2022, 1, 1))
        srv.standing.on_write()
        got.append((ex.execute_serving("t", q), ex.execute("t", q)))
    assert got[0] == got[1] == ([20], [20])


def test_delta_log_overflow_falls_back_once():
    got = []
    for pkg in PKGS:
        h, ex, srv = build(pkg)
        q = "Count(Row(a=1))"
        srv.standing.register("i", q)
        (sq,) = srv.standing._by_id.values()
        f = h.index("i").field("a")
        for c in range(FRAG[id(pkg)].DELTA_LOG_MAX + 10):
            f.set_bit(1, 1000 + c)
        srv.standing.on_write("i", {"a"})
        res = ex.execute_serving("i", q)
        assert res == make_executor(pkg, h).execute("i", q)
        assert sq.stats["fallback"] == 1
        got.append(res)
    assert got[0] == got[1]


def test_switch_disables_plane():
    h, ex, srv = build(PORT)
    q = "Count(Row(a=1))"
    srv.standing.register("i", q)
    st.configure(enabled=False)
    try:
        with pytest.raises(StandingUnsupported):
            srv.standing.register("i", "Count(Row(a=2))")
        srv.standing.on_write("i", {"a"})
        assert srv.standing.catch_up(("i", "x", None)) is _MISS
        cold = make_executor(PORT, h)
        ex.execute_serving("i", "Set(7001, a=1)")
        assert ex.execute_serving("i", q) == cold.execute("i", q)
        (sq,) = srv.standing._by_id.values()
        assert sq.stats["incremental"] == 0
    finally:
        st.configure(enabled=True)
    ex.execute_serving("i", "Set(3005, a=1)")
    assert ex.execute_serving("i", q) == cold.execute("i", q)
    assert sq.stats["incremental"] + sq.stats["fallback"] > 0


def test_standing_entry_survives_sweeps_and_eviction():
    h, ex, srv = build(PORT)
    q = "Count(Row(a=1))"
    srv.standing.register("i", q)
    key = ("i", repr(parse(q).calls), None)
    assert key in srv.cache
    ex.execute("i", "Set(8001, a=1)")      # solo write, no push
    srv.cache.sweep(h)
    assert key in srv.cache
    cold = make_executor(PORT, h)
    assert ex.execute_serving("i", q) == cold.execute("i", q)
    assert srv.cache._reclaim(1 << 30) == 0
    assert key in srv.cache
    (sq,) = srv.standing._by_id.values()
    assert srv.standing.unregister(sq.sid)
    assert key not in srv.cache
    assert ex.execute_serving("i", q) == cold.execute("i", q)


def test_registration_admission_limits():
    h, ex, srv = build(PORT)
    st.configure(max_registrations=2)
    try:
        srv.standing.register("i", "Count(Row(a=1))")
        srv.standing.register("i", "Count(Row(a=2))")
        with pytest.raises(StandingUnsupported):
            srv.standing.register("i", "Count(Row(a=3))")
        st.configure(max_registrations=256)
        with pytest.raises(StandingUnsupported):
            srv.standing.register("i", "Count(Row(a=1))")
    finally:
        st.configure(max_registrations=256)
    info = srv.standing.list_info()
    assert [d["kind"] for d in info] == ["count", "count"]
