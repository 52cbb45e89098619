"""The port's SLO plane (obs/slo.py) against the JAX package's.

The same cumulative readings fed to both trackers give the same
``evaluate()`` payload (burn rates, covered windows, remaining budget)
apart from ``uptime_s`` (each tracker's clock), and the same windows
parse alike.  The live port tracker reads the port's own metrics under
the JAX names (``pilosa_query_duration_seconds``, the admission,
cluster and ingest counters), and a covered window burning past the
incident threshold reports one ``slo-burn`` incident."""

import time

import pytest

from pilosa_tpu.obs import slo as jax_slo
from pilosa_tpu_torch.obs import incidents, metrics, slo


def _fed(mod):
    class Fed(mod.SloTracker):
        def __init__(self, **kw):
            super().__init__(**kw)
            self.feed = []

        def _read(self):
            return self.feed.pop(0)
    return Fed


@pytest.mark.parametrize("spec", ["5m,1h", "300,60", "2h,junk,30s", "",
                                  "1d", "0,-5m", "10s,10s", " 7m , 2h "])
def test_parse_windows_matches_jax(spec):
    assert slo.parse_windows(spec) == jax_slo.parse_windows(spec)


# (latency_ms, lat objective, availability objective, windows, readings
# as seconds-ago offsets with cumulative (total, good, raised, degraded))
FEEDS = [
    (100, 0.99, 0.999, "60s", [(59, 1000, 990, 0, 0), (0, 2000, 1970, 2, 0)]),
    (100, 0.99, 0.999, "60s", [(59, 10, 10, 0, 0), (0, 20, 20, 0, 3)]),
    (250, 0.95, 0.99, "30s,5m", [(290, 0, 0, 0, 0), (25, 50, 40, 1, 0),
                                 (0, 400, 300, 9, 2)]),
    (50, 0.999, 0.9999, "1m,1h", [(10, 5, 5, 0, 0), (0, 5, 5, 0, 0)]),
    (10, 0.9, 0.9, "5m,1h,6h", [(0, 0, 0, 0, 0)]),
]


@pytest.mark.parametrize("feed", FEEDS)
def test_evaluate_matches_jax(feed):
    lat_ms, lat_obj, av_obj, windows, readings = feed
    now = time.time()
    out = []
    for mod in (jax_slo, slo):
        t = _fed(mod)(latency_ms=lat_ms, latency_objective=lat_obj,
                      availability_objective=av_obj, windows=windows)
        t._t0 = now - 7200
        for ago, *vals in readings[:-1]:
            t.feed = [(now - ago, *map(float, vals))]
            t.sample()
        ago, *vals = readings[-1]
        t.feed = [(now - ago, *map(float, vals))]
        got = t.evaluate()
        got.pop("uptime_s")
        out.append(got)
    assert out[1] == out[0]


def test_live_tracker_reads_the_port_metrics():
    """The live reading is the port's histogram and typed-error counters,
    under the JAX names."""
    assert metrics.QUERY_DURATION.name == "pilosa_query_duration_seconds"
    t = slo.SloTracker(latency_ms=1e6)
    _now, total0, good0, raised0, deg0 = t._read()
    metrics.QUERY_DURATION.observe(0.001)
    metrics.ADMISSION_TOTAL.inc(outcome="shed")
    metrics.INGEST_SHED.inc(tenant="slo-test")
    metrics.CLUSTER_EVENTS.inc(event="partial")
    _now, total, good, raised, deg = t._read()
    assert (total - total0, good - good0, raised - raised0,
            deg - deg0) == (1.0, 1.0, 2.0, 1.0)


def test_configure_get_and_tick():
    prev = slo.tracker
    try:
        t = slo.configure(latency_ms=5.0, latency_objective=0.9,
                          availability_objective=0.99, windows="1m")
        assert slo.get() is t and t.windows == [("1m", 60.0)]
        n = len(t._samples)
        slo.tick()
        assert len(t._samples) == n + 1
    finally:
        slo.tracker = prev


def test_slo_burn_fires_an_incident(tmp_path):
    """A covered window whose burn rate is at or past the incident
    threshold reports one "slo-burn" bundle."""
    mgr = incidents.IncidentManager(dir=str(tmp_path), min_interval_s=0.0)
    prev = incidents.swap(mgr)
    try:
        incidents.configure(enabled=True, slo_burn_threshold=2.0)
        t = _fed(slo)(latency_ms=1.0, latency_objective=0.99,
                      windows="60s")
        now = time.time()
        t._t0 = now - 600
        t.feed = [(now - 59, 100.0, 100.0, 0.0, 0.0)]
        t.sample()
        t.feed = [(now, 200.0, 150.0, 0.0, 0.0)]  # burn 50x
        t.evaluate()
        assert mgr.wait_idle(10.0)
        listed = mgr.list()
        assert [b["trigger"] for b in listed] == ["slo-burn"]
        assert listed[0]["detail"] == "latency:60s"
    finally:
        incidents.swap(prev)
        mgr.stop()
