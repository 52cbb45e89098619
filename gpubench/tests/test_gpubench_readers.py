"""The per-layer readers and the breakdown on a recorded trace."""

import pytest

from gpubench import manifest as man
from gpubench import metrics as readers
from gpubench.loop import Request, Window
from gpubench.trace import Bundle, ShadowClock, breakdown, busy_s


def recorded() -> Bundle:
    # a 2 s window: three kernels and a copy on the card, two requests'
    # spans, four flight records, four requests, 0.5 s of audit shadow
    device = [("popcount_rows_kernel(...)", 0.10, 0.20),
              ("void groupby_joint_kernel<7>(...)", 0.15, 0.45),
              ("Memcpy HtoD", 1.00, 1.10),
              ("popcount_rows_kernel(...)", 1.90, 2.30)]
    spans = [("executor.Execute", 0.2, 1.5), ("serving.plan", 0.5, 0.9),
             ("executor.Execute", 1.2, 1.95)]
    flight = [{"phases": {"wait": 2.0, "plan_build": 1.0, "execute": 4.0,
                          "stack_hit": 0.5}},
              {"phases": {"wait": 4.0, "execute": 2.0, "stack_rebuild": 1.5}},
              {"phases": {}}, {"phases": {"plan_build": 3.0}}]
    win = Window(0.0, 2.0, [Request({}, 0.0, 0.1 * (i + 1)) for i in range(4)])
    b = Bundle(window=win, answered=4, flight=flight,
               counters={"served": {"fused": 6, "direct": 1, "cached": 1,
                                    "standing": 0},
                         "dispatches": 3, "cache": {},
                         "sql_plan_ms_sum": 5.0, "sql_plan_count": 2},
               launches={"popcount_rows": 2, "groupby_fused": 1},
               costs={"popcount_rows": [0.1, 2], "groupby_fused": [0.15, 1]},
               device=device, spans=spans, audit_s=0.5, audit_launches=1)
    b.busy_s = 0.35 + 0.1 + 0.1     # [0.1, 0.45], [1.0, 1.1], [1.9, 2.0]
    return b


@pytest.mark.parametrize("name, want", [
    ("serving.riders_per_dispatch", 2.0),
    ("serving.queue_ms", 1.5),
    ("sql.plan_ms", 2.5),
    ("executor.plan_ms", 1.0),
    ("stacked.execute_ms", 1.5),
    ("memory.stack_ms", 0.5),
    # 3 launches, one of them the audit's, over 4 queries
    ("kernels.launches_per_query", 0.5),
    # (0.1 + 0.15) s of least time over (0.1 + 0.4 + 0.3) s of kernel
    ("kernels.roofline", 100 * 0.25 / 0.8),
    ("kernels.roofline_cover", 100.0),
    ("device.idle_share", 100 * (1 - 0.55 / 2.0)),
    ("audit.shadow_share", 25.0),
    ("p50_ms.host", 200.0),
    ("p95_ms.host", 400.0),
    ("qps.host", 2.0),
])
def test_reader(name, want):
    assert readers.load(name).read(recorded()) == pytest.approx(want)


def test_every_manifest_metric_has_a_reader():
    for x in man.load()["per_layer"]:
        assert callable(readers.load(x["name"]).read)


def test_nothing_to_read():
    b = recorded()
    b.device, b.flight, b.costs = [], [], {}
    b.counters.update(dispatches=0, sql_plan_count=0)
    for name in ("serving.riders_per_dispatch", "serving.queue_ms",
                 "sql.plan_ms", "executor.plan_ms", "kernels.roofline",
                 "device.idle_share"):
        assert readers.load(name).read(b) is None


def test_a_dropped_record_leaves_the_kernel_out():
    b = recorded()
    b.costs["popcount_rows"][1] = 3          # one launch not in the trace
    assert readers.load("kernels.roofline").read(b) == \
        pytest.approx(100 * 0.15 / 0.3)
    # and the cover says how much of the kernels' time went with it
    assert readers.load("kernels.roofline_cover").read(b) == \
        pytest.approx(100 * 0.3 / 0.8)
    assert readers.roofline_terms(b)[3] == {"popcount_rows": [3, 2]}


def test_a_few_records_past_the_launches_still_count():
    b = recorded()
    # a record at the trace's edge that no counted launch made
    b.device.append(("popcount_rows_kernel(...)", 2.5, 2.6))
    assert readers.roofline_terms(b)[3] == {}
    assert readers.load("kernels.roofline").read(b) == \
        pytest.approx(100 * 0.25 / 0.9)
    b.device += [("popcount_rows_kernel(...)", 2.7, 2.71)] * readers.EDGE
    assert readers.roofline_terms(b)[3] == {"popcount_rows": [2, 7]}


def test_a_failed_request_ranks_above_every_answer():
    b = recorded()
    b.window.requests[0].error = "refused"   # the fastest one, 0.1 s
    assert readers.load("p50_ms.host").read(b) == pytest.approx(300.0)
    assert readers.load("p95_ms.host").read(b) is None


def test_phases_are_per_query_answered():
    b = recorded()
    b.answered = 2
    assert readers.load("executor.plan_ms").read(b) == pytest.approx(2.0)


def test_shadow_clock_owns_the_oracles_records():
    c = ShadowClock()
    c.spans = [(1.0, 3.0, 101.0, 103.0), (5.0, 6.0, 105.0, 106.0)]
    assert c.seconds(2.0, 5.5) == pytest.approx(1.5)
    assert c.count(2.0, 5.5) == 2 and c.count(3.5, 4.5) == 0
    assert c.owns({"route": "solo", "start": 102.0})
    c.open[1] = (5.2, 105.2)                   # one still running
    assert c.count(5.1, 5.3) == 2
    assert c.seconds(7.0, 8.0) == pytest.approx(1.0)
    assert not c.owns({"route": "fused", "start": 102.0})
    assert not c.owns({"route": "solo", "start": 104.0})


def test_breakdown():
    b = recorded()
    got = breakdown(b, Window(0.0, 2.0))
    assert got["device_ops"][:2] == [
        ["void groupby_joint_kernel<7>(...)", pytest.approx(0.3)],
        ["popcount_rows_kernel(...)", pytest.approx(0.2)]]     # clipped
    # longest first: 1.1 to 1.9 under a request's root span, 0.45 to
    # 1.0 with serving.plan the innermost span open at its middle
    assert got["idle_gaps"][:2] == [["executor.Execute", pytest.approx(0.8)],
                                    ["serving.plan", pytest.approx(0.55)]]
    assert got["idle_gaps"][-1] == ["no request span open",
                                    pytest.approx(0.1)]


def test_busy_is_the_union_inside_the_window():
    b = recorded()
    assert busy_s(b.device, b.window) == pytest.approx(b.busy_s)
    assert busy_s([], b.window) == 0.0
