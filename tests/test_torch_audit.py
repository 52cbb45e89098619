"""The port's audit plane (obs/audit.py), incident bundles
(obs/incidents.py), stall watchdog (obs/watchdog.py) and roofline and
stats hooks, against the JAX package's where both answer.

The audit never false-positives (a write racing a sampled serve is a
counted ``stale_skip``), the ``audit-corrupt`` drill is caught by the
shadow, cache and standing verifiers, the switch leaves serving
untouched, a saturated audit class sheds audits and never queries, and
the shadow arm is a private per-shard Executor on the same device.  The
cases of tests/test_audit.py and tests/test_incidents.py without the
server, the cluster and the sleeps: watchdog scans take an explicit
clock, workers are waited on."""

import numpy as np
import pytest
import torch

from pilosa_tpu.obs import audit as jaudit
from pilosa_tpu_torch.executor.executor import Executor
from pilosa_tpu_torch.models.holder import Holder
from pilosa_tpu_torch.models.schema import FieldOptions, FieldType
from pilosa_tpu_torch.obs import (
    audit,
    faults,
    flight,
    incidents,
    metrics,
    roofline,
    stats,
    watchdog,
)
from torch_serving_common import stop_planes  # noqa: F401  (autouse)

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _reset_audit():
    audit.configure(enabled=True, sample_rate=0.01, route_rates={},
                    queue_max=64, concurrency=1, scrub_cache_n=4,
                    scrub_standing_n=2, quarantine=32)
    faults.clear()
    yield
    faults.clear()
    audit.configure(enabled=True, sample_rate=0.01, route_rates={})


@pytest.fixture()
def mgr(tmp_path):
    """A fresh incident manager, with the process's stats catalog and
    watchdog monitor kept out of it: their reports (a sentinel firing on
    another test's records, a stall) would land in this manager."""
    m = incidents.IncidentManager(dir=str(tmp_path / "inc"),
                                  min_interval_s=3600.0)
    prev = incidents.swap(m)
    prev_stats = stats.swap(stats.StatsCatalog())
    watchdog.configure(enabled=False)
    yield m
    m.wait_idle(10)
    assert m.stop()
    watchdog.configure(enabled=True)
    stats.swap(prev_stats)
    incidents.swap(prev)


def build(n=200):
    h = Holder(width=1 << 12)
    idx = h.create_index("i")
    idx.create_field("a", FieldOptions(type=FieldType.SET,
                                       cache_type="none"))
    idx.create_field("b")
    ex = Executor(h, device="cpu")
    for c in range(n):
        ex.execute("i", f"Set({c}, a={c % 4})")
        ex.execute("i", f"Set({c}, b={c % 6})")
    srv = ex.enable_serving(window_s=0.0, max_batch=8)
    return h, ex, srv


def outcome(srv, kind, oc):
    return srv.audit.counts.get((kind, oc), 0)


def test_no_false_positives_under_write_storm():
    audit.configure(sample_rate=1.0)
    h, ex, srv = build(n=160)
    srv.audit.seed(0xF00D)
    rng = np.random.default_rng(0xF00D)
    qs = ["Count(Row(a=1))", "Row(a=2)", "TopN(a, n=3)",
          "Count(Union(Row(a=0), Row(b=5)))", "GroupBy(Rows(a), Rows(b))"]
    for step in range(40):
        col = int(rng.integers(0, 500))
        fld = "a" if rng.integers(0, 2) else "b"
        rid = int(rng.integers(0, 4 if fld == "a" else 6))
        op = "Clear" if rng.integers(0, 3) == 0 else "Set"
        ex.execute_serving("i", f"{op}({col}, {fld}={rid})")
        ex.execute_serving("i", qs[step % len(qs)])
    assert srv.audit.wait_idle(60)
    assert outcome(srv, "shadow", "mismatch") == 0, srv.audit.describe()
    assert outcome(srv, "shadow", "match") > 0
    assert not srv.audit.quarantine
    srv.close()


def test_stale_skip_when_writes_pass_the_snapshot(monkeypatch):
    """A sample whose fragments moved before the shadow ran is skipped
    and counted, never compared."""
    audit.configure(sample_rate=1.0)
    h, ex, srv = build(n=40)
    plane = srv.audit
    # hold the workers back while the sample queues and a write lands
    monkeypatch.setattr(plane, "_ensure_workers_locked", lambda: None)
    ex.execute_serving("i", "Count(Row(a=1))")
    assert plane.queue_depth() == 1
    ex.execute("i", "Set(3999, a=1)")
    monkeypatch.undo()
    with plane._cv:
        plane._ensure_workers_locked()
        plane._cv.notify_all()
    assert plane.wait_idle(30)
    assert outcome(srv, "shadow", "stale_skip") == 1
    assert outcome(srv, "shadow", "mismatch") == 0
    srv.close()


def test_scrubbers_no_false_positives():
    audit.configure(sample_rate=1.0, scrub_cache_n=8, scrub_standing_n=8)
    h, ex, srv = build(n=120)
    srv.standing.register("i", "Count(Row(a=1))")
    srv.standing.register("i", "TopN(a, n=2)")
    for q in ["Count(Row(a=0))", "Row(a=3)", "Count(Row(b=2))"]:
        ex.execute_serving("i", q)
        ex.execute_serving("i", q)
    assert srv.audit.wait_idle(30)
    srv.audit.scrub()
    assert srv.audit.wait_idle(30)
    d = srv.audit.describe()
    assert outcome(srv, "cache", "mismatch") == 0, d
    assert outcome(srv, "standing", "mismatch") == 0, d
    assert outcome(srv, "cache", "match") > 0, d
    assert outcome(srv, "standing", "match") > 0, d
    assert d["scrub"]["cache_scanned"] > 0
    assert d["scrub"]["standing_scanned"] == 2
    srv.close()


def test_corruption_drill_serve_seam(mgr):
    audit.configure(sample_rate=1.0)
    h, ex, srv = build()
    q = "Count(Row(a=1))"
    clean = Executor(h, device="cpu").execute("i", q)
    faults.inject("audit-corrupt", match="serve:", times=1)
    assert ex.execute_serving("i", q) != clean
    assert srv.audit.wait_idle(30)
    assert outcome(srv, "shadow", "mismatch") == 1
    (ent,) = srv.audit.quarantine
    assert ent["kind"] == "shadow"
    assert ent["live_digest"] != ent["shadow_digest"]
    assert ent["shadow_arm"] == {"arm": "per-shard", "use_stacked": False,
                                 "serving": False, "cache": False}
    assert ent["live_arm"]["route"] in ("solo", "fused", "cached")
    # the oracle is a private per-shard executor on the same device
    o = srv.audit.oracle()
    assert o is not ex and o.use_stacked is False
    assert o.device == ex.device and o.tiles is not ex.tiles
    assert mgr.wait_idle(10)
    bundles = [b for b in mgr.list() if b["trigger"] == "audit-mismatch"]
    assert len(bundles) == 1
    ctx = mgr.fetch(bundles[0]["id"])["context"]
    assert ctx["live_digest"] == ent["live_digest"]
    assert ex.execute_serving("i", q) == clean
    assert srv.audit.wait_idle(30)
    assert outcome(srv, "shadow", "mismatch") == 1
    srv.close()


def test_corruption_drill_cache_seam():
    audit.configure(sample_rate=1.0)
    h, ex, srv = build()
    q = "Count(Row(a=0))"
    clean = Executor(h, device="cpu").execute("i", q)
    assert ex.execute_serving("i", q) == clean
    assert srv.audit.wait_idle(30)
    ex.execute_serving("i", "Set(9001, a=3)")
    faults.inject("audit-corrupt", match="cache:", times=1)
    assert ex.execute_serving("i", q) == clean
    assert srv.audit.wait_idle(30)
    assert outcome(srv, "shadow", "mismatch") == 0
    srv.audit.scrub()
    assert srv.audit.wait_idle(30)
    assert outcome(srv, "cache", "mismatch") == 1, srv.audit.describe()
    srv.close()


def test_corruption_drill_standing_seam():
    audit.configure(sample_rate=0.0)
    h, ex, srv = build()
    q = "Count(Row(a=1))"
    srv.standing.register("i", q)
    faults.inject("audit-corrupt", match="standing:", times=1)
    ex.execute_serving("i", "Set(9002, a=1)")
    ex.execute_serving("i", q)
    srv.audit.scrub()
    assert srv.audit.wait_idle(30)
    assert outcome(srv, "standing", "mismatch") == 1, srv.audit.describe()
    srv.close()


def test_switch_bit_exact():
    audit.configure(sample_rate=1.0)
    h, ex, srv = build(n=120)
    cold = Executor(h, device="cpu")
    qs = ["Count(Row(a=1))", "Row(a=2)", "TopN(a, n=3)"]
    on = [ex.execute_serving("i", q) for q in qs]
    assert srv.audit.wait_idle(30)
    before = outcome(srv, "shadow", "sampled")
    assert before == len(qs)
    audit.configure(enabled=False)
    off = [ex.execute_serving("i", q) for q in qs]
    srv.audit.scrub()
    assert on == off == [cold.execute("i", q) for q in qs]
    assert outcome(srv, "shadow", "sampled") == before
    assert srv.audit.scrub_stats["ticks"] == 0
    audit.configure(enabled=True)
    ex.execute_serving("i", qs[0])
    assert srv.audit.wait_idle(30)
    assert outcome(srv, "shadow", "sampled") == before + 1
    srv.close()


def test_route_rates_and_digests_equal_jax():
    assert audit.parse_route_rates("cached=1.0,fused=0,junk,=3,x=n") == \
        jaudit.parse_route_rates("cached=1.0,fused=0,junk,=3,x=n") == \
        {"cached": 1.0, "fused": 0.0}
    from pilosa_tpu.executor.results import ValCount as JVC
    from pilosa_tpu_torch.executor.results import ValCount
    for r in ([3], [ValCount(value=5, count=2)], [True]):
        jr = [JVC(value=5, count=2)] if isinstance(r[0], ValCount) else r
        assert audit.result_digest(r) == jaudit.result_digest(jr)
        assert audit.result_digest(audit.corrupt_results(r)) == \
            jaudit.result_digest(jaudit.corrupt_results(jr))


def test_saturated_audit_plane_sheds_audits_not_queries():
    audit.configure(sample_rate=1.0, queue_max=1)
    h, ex, srv = build(n=120)
    cold = Executor(h, device="cpu")
    slot = srv.sched.audit_slot()
    assert slot is not None and srv.sched.audit_slot() is None
    try:
        for i in range(10):
            q = f"Count(Row(a={i % 4}))"
            assert ex.execute_serving("i", q) == cold.execute("i", q)
        assert srv.audit.wait_idle(30)
    finally:
        slot.release()
    d = srv.audit.describe()
    assert outcome(srv, "shadow", "match") == 0, d
    assert outcome(srv, "shadow", "shed") == 10, d
    ex.execute_serving("i", "Count(Row(a=1))")
    assert srv.audit.wait_idle(30)
    assert outcome(srv, "shadow", "match") == 1
    srv.close()


def test_flight_records_carry_audit_outcome():
    audit.configure(sample_rate=0.0)
    h, ex, srv = build()
    ex.execute_serving("i", "Count(Row(a=2))")
    audit.configure(sample_rate=1.0)
    ex.execute_serving("i", "Count(Row(a=1))")
    assert srv.audit.wait_idle(30)
    recs = flight.recorder.recent(50)
    hits = [r for r in recs if r.get("audited")]
    assert hits and any(r.get("audit_outcome") == "match" for r in hits)
    srv.close()


# -- incidents and the watchdog ----------------------------------------------

def test_each_trigger_one_deduped_bundle(mgr):
    trig = ("perf-regression", "watchdog-stall", "device-oom",
            "batch-leader-exception", "audit-mismatch")
    for t in trig:
        assert incidents.report(t, detail="first") is True
        assert incidents.report(t, detail="second") is False
    assert mgr.wait_idle(10)
    assert sorted(m["trigger"] for m in mgr.list(100)) == sorted(trig)
    b = mgr.fetch(mgr.list()[0]["id"])
    for key in ("stacks", "flight", "trace", "metrics", "stats", "faults",
                "host", "log_tail", "profile"):
        assert key in b, key


def test_watchdog_fires_once_per_episode(mgr):
    mgr.min_interval_s = 0.0
    watchdog.configure(enabled=False)
    w = watchdog.register("test-loop", deadline_s=0.05)
    try:
        w.stamp("phase-a")
        fired = watchdog.scan(now=w.t + 1.0)
        assert [f["loop"] for f in fired] == ["test-loop"]
        assert fired[0]["phase"] == "phase-a"
        assert "test_torch_audit" in fired[0]["stack"]
        assert watchdog.scan(now=w.t + 2.0) == []      # same episode
        w.stamp("phase-b")
        assert [f["phase"] for f in
                watchdog.scan(now=w.t + 1.0)] == ["phase-b"]
        w.idle()
        assert watchdog.scan(now=w.t + 5.0) == []
        tok = w.begin("dispatch")
        assert [f["phase"] for f in
                watchdog.scan(now=tok[0] + 1.0)] == ["dispatch"]
        w.end(tok)
        assert mgr.wait_idle(10)
        assert len([m for m in mgr.list(100)
                    if m["trigger"] == "watchdog-stall"]) == 3
    finally:
        watchdog.deregister("test-loop")
        watchdog.configure(enabled=True)


def test_serving_batcher_watch_and_leader_exception(mgr):
    h, ex, srv = build(n=40)
    assert any(d["loop"] == "serving-batcher" for d in watchdog.watches())

    def boom(batch):
        raise RuntimeError("leader died mid-batch")
    srv._run_batch = boom
    with pytest.raises(RuntimeError):
        ex.execute_serving("i", "Count(Row(a=1))")
    assert mgr.wait_idle(10)
    got = [m for m in mgr.list(100)
           if m["trigger"] == "batch-leader-exception"]
    assert len(got) == 1
    assert "leader died" in mgr.fetch(got[0]["id"])["context"]["message"]
    srv.close()


def test_oom_ladder_trip_triggers_incident(mgr):
    from pilosa_tpu_torch.memory import pressure
    faults.inject("device-oom", times=1)
    assert pressure.guarded(lambda: 42) == 42
    assert mgr.wait_idle(10)
    got = [m for m in mgr.list(100) if m["trigger"] == "device-oom"]
    assert len(got) == 1 and "InjectedOOM" in got[0]["detail"]


def test_perf_regression_sentinel_triggers_incident(mgr):
    cat = stats.StatsCatalog(regression_ratio=3.0, regression_min_samples=4)
    prev = stats.swap(cat)
    try:
        rec = {"fingerprint": "regfp", "route": "direct", "phases": {},
               "batch": 1, "bytes_moved": 0}
        for _ in range(10):
            cat.note_flight({**rec, "duration_ms": 1.0})
        cat.fold()
        for _ in range(6):
            cat.note_flight({**rec, "duration_ms": 30.0})
        cat.fold()
        assert cat.regressions()
        assert mgr.wait_idle(10)
        got = [m for m in mgr.list(100) if m["trigger"] == "perf-regression"]
        assert len(got) == 1 and got[0]["detail"] == "regfp"
    finally:
        stats.swap(prev)


def test_flight_commit_feeds_stats_and_roofline():
    """flight.commit folds every record into the catalog (a serving
    fingerprint's profile), and a stacked dispatch's roofline note
    lands in its record."""
    cat = stats.StatsCatalog()
    prev = stats.swap(cat)
    peak = roofline.swap_state(True, 1e12)
    try:
        h = build(n=40)[0]
        srv_ex = Executor(h, device="cpu")
        srv = srv_ex.enable_serving(window_s=0.0, max_batch=8, cache_bytes=0)
        q = "Count(Not(Row(a=1)))"
        for _ in range(3):
            srv_ex.execute_serving("i", q)
        srv.close()
        cat.fold()
        assert [p["n"] for p in cat.payload()["runtime"].values()] == [3]
        Executor(h, device="cpu").execute("i", q)
        rec = flight.recorder.recent(1)[0]
        assert "count" in rec["roofline"]
        assert rec["roofline"]["count"]["fraction"] >= 0
        assert roofline.snapshot()["ops"]["count"]["dispatches"] >= 1
        assert metrics.DEVICE_BW_GBPS.value(op="count") > 0
    finally:
        roofline.swap_state(*peak)
        stats.swap(prev)


def test_published_peak_of_an_h100():
    assert roofline.published_peak("NVIDIA H100 80GB HBM3") == 3.35e12
    assert roofline.published_peak("NVIDIA A40") is None


def test_the_cpu_gets_no_peak_and_no_fraction():
    """With no card there is no published peak, so a record's roofline
    share and the snapshot carry bytes and GB/s but no fraction."""
    prev = roofline.swap_state(True, None)
    try:
        assert roofline.resolve_peak() is None
        flight.recorder.configure(enabled=True)
        rec = flight.begin("i", "Count(Row(a=1))")
        roofline.note("count", 1 << 20, 0.001)
        flight.commit(rec, 0.002)
        got = flight.recorder.recent(1)[0]["roofline"]["count"]
        assert got["gbps"] > 0 and "fraction" not in got
        assert "fraction" not in roofline.snapshot()["ops"]["count"]
    finally:
        roofline.swap_state(*prev)
