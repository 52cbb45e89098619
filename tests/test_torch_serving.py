"""The port's serving path (pilosa_tpu_torch/executor/serving.py)
against the JAX package's: the micro-batcher's fusion, the versioned
result cache, consistency under concurrent writes, API.query through
Executor.execute_serving, and the mutation epoch of every write path.

Each case of tests/test_serving.py runs on both packages over the same
data (width 2048, four shards); the port runs on the CPU.  Answers are
exact.  No sleep synchronises anything: threads are joined with a
timeout that fails the test, and waits poll a condition."""

import random
import threading

import pytest
import torch

import pilosa_tpu.models.fragment as jfrag
from pilosa_tpu.api import API as JaxAPI
from pilosa_tpu.executor.serving import ResultCache as JaxResultCache
from pilosa_tpu.pql import parse as jparse
from pilosa_tpu_torch import memory
from pilosa_tpu_torch.api import API
from pilosa_tpu_torch.executor.results import RowResult
from pilosa_tpu_torch.executor.serving import (
    ResultCache,
    Uncacheable,
    field_snapshot,
    query_fields,
)
from pilosa_tpu_torch.models import fragment as pfrag
from pilosa_tpu_torch.obs import metrics
from pilosa_tpu_torch.pql import parse
from torch_serving_common import (
    JAX,
    PORT,
    both,
    build_holder,
    make_executor,
    results_of,
    fresh_stats,  # noqa: F401  (fixture)
    run_threads,
    stop_planes,  # noqa: F401  (autouse)
    wait_until,
)

torch.set_num_threads(1)

QUERIES = [
    "Count(Row(a=1))",
    "Count(Intersect(Row(a=1), Row(b=2)))",
    "Count(Union(Row(a=0), Row(b=5)))",
    "Count(Difference(Row(a=2), Row(b=1)))",
    "Count(Xor(Row(a=3), Row(b=0)))",
    "Count(Not(Row(a=1)))",
    "Count(Row(v > 50))",
    "Count(Row(v >= 12))",
    "Count(Row(v == 14))",
    "Row(a=2)",
    "Union(Row(a=1), Row(b=3))",
    "Intersect(Row(a=1), Row(v < 40))",
    "TopN(a, n=3)",
    "TopN(a, Row(b=1), n=2)",
    "TopK(b, k=4)",
    "Sum(Row(a=1), field=v)",
    "Sum(field=v)",
    "All()",
    "GroupBy(Rows(a), Rows(b))",
    "GroupBy(Rows(a), aggregate=Sum(field=v))",
    "GroupBy(Rows(b), filter=Row(a=1), aggregate=Sum(field=v))",
]


@pytest.fixture(scope="module")
def holders():
    return both()


@pytest.fixture(scope="module")
def jax_want(holders):
    jex = make_executor(JAX, holders[0])
    return {q: results_of(JAX, jex, q) for q in QUERIES}


@pytest.mark.parametrize("ragged", [True, False])
@pytest.mark.parametrize("q", QUERIES)
def test_solo_bit_exact(holders, jax_want, q, ragged):
    """Every query through the serving path, cache cold and warm,
    equals the JAX package's serving answer and the port's solo one."""
    jh, ph = holders
    jsrv = make_executor(JAX, jh)
    jsrv.enable_serving(window_s=0.0, max_batch=8)
    srv = make_executor(PORT, ph)
    layer = srv.enable_serving(window_s=0.0, max_batch=8, ragged=ragged)
    try:
        want = jax_want[q]
        assert results_of(JAX, jsrv, q, serving=True) == want
        assert results_of(PORT, make_executor(PORT, ph), q) == want
        assert results_of(PORT, srv, q, serving=True) == want   # cold
        assert results_of(PORT, srv, q, serving=True) == want   # cached
    finally:
        layer.close()


@pytest.mark.parametrize("ragged", [True, False])
def test_concurrent_batched_bit_exact(holders, jax_want, ragged):
    """Concurrent distinct queries fuse into shared dispatches and each
    demuxes to its own exact (JAX-equal) answer."""
    _jh, ph = holders
    srv = make_executor(PORT, ph)
    layer = srv.enable_serving(window_s=0.05, max_batch=64,
                               cache_bytes=0, ragged=ragged)
    batches0 = metrics.SERVING_BATCH_SIZE.count()
    got = {}
    lock = threading.Lock()
    barrier = threading.Barrier(len(QUERIES))

    def run(q):
        def go():
            barrier.wait(30)
            r = results_of(PORT, srv, q, serving=True)
            with lock:
                got[q] = r
        return go

    try:
        run_threads([run(q) for q in QUERIES])
    finally:
        layer.close()
    assert got == jax_want
    assert metrics.SERVING_BATCH_SIZE.count() - batches0 < len(QUERIES)
    assert layer.cache is None


def test_cache_hit_skips_execution(holders):
    srv = make_executor(PORT, holders[1])
    layer = srv.enable_serving(window_s=0.0, max_batch=8)
    q = "Count(Intersect(Row(a=1), Row(b=2)))"
    first = results_of(PORT, srv, q, serving=True)
    h0 = layer.cache.hits
    assert results_of(PORT, srv, q, serving=True) == first
    assert layer.cache.hits == h0 + 1


def _cache_keys(layer):
    return {k[1] for k in layer.cache._entries}


def test_write_invalidates_exactly():
    """A write to a referenced fragment evicts exactly the entries that
    read it, on both packages alike."""
    keys = []
    for pkg in (JAX, PORT):
        h = build_holder(pkg, track_existence=False)
        srv = make_executor(pkg, h)
        layer = srv.enable_serving(window_s=0.0, max_batch=8)
        for q in ("Count(Row(a=1))", "Count(Row(b=1))", "Sum(field=v)"):
            srv.execute_serving("i", q)
        assert len(layer.cache) == 3
        srv.execute_serving("i", "Set(5000, a=1)")
        keys.append(_cache_keys(layer))
        assert results_of(pkg, srv, "Count(Row(a=1))", serving=True) == \
            results_of(pkg, make_executor(pkg, h), "Count(Row(a=1))")
        h0 = layer.cache.hits
        srv.execute_serving("i", "Count(Row(b=1))")
        assert layer.cache.hits == h0 + 1
    assert keys[0] == keys[1] == {"[Count(Row(b=1))]", "[Sum(_field='v')]"}


def test_cache_misses_after_field_drop_and_recreate():
    got = []
    for pkg in (JAX, PORT):
        h = build_holder(pkg, track_existence=False)
        srv = make_executor(pkg, h)
        layer = srv.enable_serving(window_s=0.0, max_batch=8)
        q = "Count(Row(a=1))"
        before = results_of(pkg, srv, q, serving=True)
        assert before[0] > 0
        idx = h.index("i")
        idx.delete_field("a")
        idx.create_field("a")
        make_executor(pkg, h).execute("i", "Set(1, a=1)")
        got.append(results_of(pkg, srv, q, serving=True))
        assert layer.cache.misses >= 2
    assert got == [[1], [1]]


def test_cache_lazy_invalidation_on_direct_write():
    """A write that bypasses the serving layer still invalidates
    through the version guard."""
    h = build_holder(PORT, track_existence=False)
    srv = make_executor(PORT, h)
    layer = srv.enable_serving(window_s=0.0, max_batch=8)
    q = "Count(Row(a=1))"
    before = results_of(PORT, srv, q, serving=True)
    make_executor(PORT, h).execute("i", "Set(6000, a=1)")
    assert results_of(PORT, srv, q, serving=True)[0] == before[0] + 1
    assert layer.cache.misses >= 2


@pytest.mark.parametrize("q", [
    "Count(Intersect(Row(a=1), Row(v > 3)))", "Count(Not(Row(a=1)))",
    "TopN(a, Row(b=1), n=2)", "GroupBy(Rows(a), aggregate=Sum(field=v))",
    "Options(Row(a=1), shards=[0])", "Count(Distinct(field=v))"])
def test_dep_walk_equals_jax(holders, q):
    jh, ph = holders
    from pilosa_tpu.executor import serving as jserving
    try:
        want = jserving.query_fields(jh.index("i"), jparse(q))
    except jserving.Uncacheable:
        with pytest.raises(Uncacheable):
            query_fields(ph.index("i"), parse(q))
        return
    assert query_fields(ph.index("i"), parse(q)) == want


def test_result_cache_lru_accounting_and_ledger():
    """The byte bound holds, the entries' bytes add up, and the cache
    holds exactly its bytes in its ledger client."""
    import numpy as np
    led = memory.ledger()
    c = ResultCache(max_bytes=1 << 10)
    jc = JaxResultCache(max_bytes=1 << 10)
    h = build_holder(PORT, track_existence=False)
    idx = h.index("i")
    snap = field_snapshot(idx, frozenset(["a"]))
    for i in range(64):
        r = RowResult(idx.width)
        r.segments[0] = np.zeros(16, dtype=np.uint32)
        c.put(("i", f"q{i}", None), frozenset(["a"]), snap, [r])
        from pilosa_tpu.executor.results import RowResult as JRow
        jr = JRow(idx.width)
        jr.segments[0] = np.zeros(16, dtype=np.uint32)
        jc.put(("i", f"q{i}", None), frozenset(["a"]), snap, [jr])
    assert c.nbytes <= c.max_bytes
    assert c.nbytes == sum(e[3] for e in c._entries.values())
    assert c.nbytes == jc.nbytes and len(c) == len(jc)
    assert c._client.name == "result_cache"
    assert c._client.bytes == c.nbytes
    assert c._client in [r() for r in led._clients]
    c.clear()
    assert c._client.bytes == 0


def test_stress_concurrent_reads_and_writes():
    """Readers through execute_serving while a writer interleaves Sets:
    version-consistent (monotone) counts and intact cache accounting."""
    h = build_holder(PORT, track_existence=False)
    srv = make_executor(PORT, h)
    layer = srv.enable_serving(window_s=0.0005, max_batch=16)
    writer_ex = make_executor(PORT, h)
    n_writes, n_readers, n_iters = 60, 4, 20
    errs: list = []
    outs = [[] for _ in range(n_readers)]

    def writer():
        try:
            for c in range(n_writes):
                writer_ex.execute("i", f"Set({c * 31}, a=9)")
        except Exception as e:  # pragma: no cover
            errs.append(e)

    def reader(out):
        def go():
            try:
                prev = -1
                for _ in range(n_iters):
                    (n,) = srv.execute_serving("i", "Count(Row(a=9))")
                    assert n >= prev, (n, prev)
                    prev = n
                    out.append(n)
            except Exception as e:  # pragma: no cover
                errs.append(e)
        return go

    run_threads([writer] + [reader(o) for o in outs])
    assert not errs
    (n,) = make_executor(PORT, h).execute("i", "Count(Row(a=9))")
    assert n == n_writes
    for o in outs:
        assert o == sorted(o) and 0 <= o[-1] <= n_writes
    rc = layer.cache
    with rc._lock:
        assert rc.nbytes == sum(e[3] for e in rc._entries.values())
    assert rc.nbytes <= rc.max_bytes


def test_property_random_trees_with_writes():
    """Seeded random trees through both packages' serving layers
    (batched and cached) stay equal across interleaved writes."""
    jh, ph = both()
    jsrv = make_executor(JAX, jh)
    jsrv.enable_serving(window_s=0.0, max_batch=8)
    srv = make_executor(PORT, ph)
    srv.enable_serving(window_s=0.0, max_batch=8)
    rng = random.Random(42)

    def tree(depth):
        if depth <= 0 or rng.random() < 0.4:
            f, r = rng.choice([("a", rng.randrange(4)),
                               ("b", rng.randrange(6))])
            if rng.random() < 0.25:
                op = rng.choice([">", "<", ">=", "<=", "=="])
                return f"Row(v {op} {rng.randrange(97)})"
            return f"Row({f}={r})"
        op = rng.choice(["Union", "Intersect", "Difference", "Xor"])
        kids = ", ".join(tree(depth - 1) for _ in range(rng.randrange(2, 4)))
        return f"{op}({kids})"

    def query():
        t = tree(2)
        wrap = rng.randrange(4)
        return [f"Count({t})", f"TopN(a, {t}, n=3)",
                f"Sum({t}, field=v)", t][wrap]

    for _ in range(4):
        for _ in range(8):
            q = query()
            want = results_of(JAX, jsrv, q, serving=True)
            assert results_of(PORT, srv, q, serving=True) == want, q
            assert results_of(PORT, srv, q, serving=True) == want, q
        for _ in range(4):
            c = rng.randrange(400) * 17
            f, r = rng.choice([("a", rng.randrange(4)),
                               ("b", rng.randrange(6))])
            jsrv.execute_serving("i", f"Set({c}, {f}={r})")
            srv.execute_serving("i", f"Set({c}, {f}={r})")


def test_serving_metrics_move(holders):
    srv = make_executor(PORT, holders[1])
    srv.enable_serving(window_s=0.0, max_batch=8)
    lat0 = metrics.SERVING_LATENCY.count()
    ok0 = metrics.RESULT_CACHE.value(outcome="hit")
    for _ in range(2):
        srv.execute_serving("i", "Count(Row(a=3))")
    assert metrics.SERVING_LATENCY.count() == lat0 + 2
    assert metrics.RESULT_CACHE.value(outcome="hit") == ok0 + 1


# -- API.query and API.sql through execute_serving --------------------------

API_QUERIES = QUERIES + ["Set(7, a=2)", "Count(Row(a=2))", "Clear(7, a=2)",
                         "Count(Row(a=2))", "Min(field=v)", "Rows(b)"]


def test_api_query_json_equals_jax_with_serving_on():
    jh, ph = both()
    japi, api = JaxAPI(jh), API(ph, device="cpu")
    japi.executor.enable_serving(window_s=0.0, max_batch=8)
    layer = api.executor.enable_serving(window_s=0.0, max_batch=8)
    calls0 = layer.cache.hits + layer.cache.misses
    for q in API_QUERIES + API_QUERIES:
        assert api.query("i", q) == japi.query("i", q), q
    assert layer.cache.hits + layer.cache.misses > calls0
    assert layer.cache.hits > 0


def test_api_profile_records_the_leaders_phases():
    """A profiled query that rides a fused batch holds the batch
    leader's serving.plan and serving.dispatch spans in its own tree."""
    api = API(build_holder(PORT), device="cpu")
    api.executor.enable_serving(window_s=0.0, max_batch=8, cache_bytes=0)
    resp = api.query("i", "Count(Row(a=1))", profile=True)
    assert resp["results"] == [75]

    def names(spans):
        out = []
        for sp in spans:
            out.append(sp["name"])
            out += names(sp.get("children", []))
        return out
    got = names(resp["profile"])
    assert "executor.Execute" in got
    assert "serving.plan" in got and "serving.dispatch" in got


def test_api_query_qos_sheds_typed(fresh_stats):
    """A heavy read past a full admission queue sheds with a typed 503
    and a retry hint; a point read, and an explicit point priority,
    still serve."""
    from pilosa_tpu_torch.executor.sched import QoS, ServingShedError
    api = API(build_holder(PORT), device="cpu")
    layer = api.executor.enable_serving(window_s=0.0, max_batch=8,
                                        heavy_slots=1, queue_max=1)
    blocker = layer.sched.heavy_slot(None)
    blocker.__enter__()
    queued = {}

    def queued_one():
        queued["r"] = api.query("i", "TopN(a, n=3)")

    t = threading.Thread(target=queued_one, daemon=True)
    t.start()
    try:
        assert wait_until(lambda: layer.sched.queued() == 1)
        with pytest.raises(ServingShedError) as ei:
            api.query("i", "TopN(a, n=2)")
        assert ei.value.status == 503 and ei.value.retry_after_s > 0
        assert api.query("i", "Count(Row(a=1))") == {"results": [75]}
        assert api.query("i", "TopN(a, n=1)",
                         qos=QoS.make(priority="point"))["results"]
    finally:
        blocker.__exit__(None, None, None)
        t.join(30)
    assert not t.is_alive() and queued["r"]["results"]


def test_import_sweeps_the_result_cache():
    """API imports sweep exactly the entries over the fields and shards
    they dirtied, as the JAX API's sweep_import does."""
    kept = []
    for pkg, A in ((JAX, JaxAPI), (PORT, API)):
        h = build_holder(pkg, track_existence=False)
        api = A(h) if pkg is JAX else A(h, device="cpu")
        layer = api.executor.enable_serving(window_s=0.0, max_batch=8)
        for q in ("Count(Row(a=1))", "Count(Row(b=1))",
                  "Options(Count(Row(a=2)), shards=[3])"):
            api.query("i", q)
        w0 = metrics.RESULT_CACHE.value(outcome="write") if pkg is PORT \
            else 0
        api.import_bits("i", "a", rows=[1, 2], cols=[3, 5])
        kept.append(sorted(k[1] for k in layer.cache._entries))
        if pkg is PORT:
            assert metrics.RESULT_CACHE.value(outcome="write") == w0 + 1
            assert api.query("i", "Count(Row(a=1))")["results"] == [76]
    assert kept[0] == kept[1]


# -- the mutation epoch ------------------------------------------------------

def _epoch_moves(pkg, mod, action) -> bool:
    before = mod.mutation_epoch()
    action()
    return mod.mutation_epoch() != before


WRITES = {
    "Set": lambda api, h: api.query("i", "Set(9999, a=3)"),
    "Clear": lambda api, h: api.query("i", "Clear(0, a=0)"),
    "Store": lambda api, h: api.query("i", "Store(Row(a=1), b=5)"),
    "ClearRow": lambda api, h: api.query("i", "ClearRow(b=2)"),
    "Delete": lambda api, h: api.query("i", "Delete(Row(a=2))"),
    "import_bits": lambda api, h: api.import_bits("i", "a", rows=[1],
                                                  cols=[11]),
    "import_values": lambda api, h: api.import_values("i", "v", cols=[11],
                                                      values=[5]),
    "import_columns": lambda api, h: api.import_columns(
        "i", [12, 13], bits={"a": [1, 2]}, values={"v": [3, 4]}),
    "delete_field": lambda api, h: h.index("i").delete_field("b"),
    "delete_index": lambda api, h: h.delete_index("i"),
    "create_field": lambda api, h: h.index("i").create_field("z"),
}


@pytest.mark.parametrize("write", sorted(WRITES))
def test_mutation_epoch_moves_where_jax_moves(write):
    moved = []
    for pkg, A, mod in ((JAX, JaxAPI, jfrag), (PORT, API, pfrag)):
        h = build_holder(pkg)
        api = A(h) if pkg is JAX else A(h, device="cpu")
        moved.append(_epoch_moves(pkg, mod, lambda: WRITES[write](api, h)))
    assert moved[0] == moved[1], moved
    if write != "create_field":
        assert moved[1]


def test_mutation_epoch_of_the_ports_own_write_paths():
    """The paths the port has of its own (a pipeline batch, rollup,
    TTL removal, clone_to, rename_field) move the epoch; a read does
    not."""
    import datetime as dt

    from pilosa_tpu_torch.models import timeq
    from pilosa_tpu_torch.models.schema import TimeQuantum
    h = build_holder(PORT)
    idx = h.index("i")
    t = idx.create_field("t", PORT["FieldOptions"](
        type=PORT["FieldType"].TIME, time_quantum=TimeQuantum("YMD"),
        ttl=3600))
    ex = make_executor(PORT, h)
    assert not _epoch_moves(PORT, pfrag,
                            lambda: ex.execute("i", "Count(Row(a=1))"))
    assert _epoch_moves(PORT, pfrag, lambda: ex.execute(
        "i", "Set(3, t=1, 2020-01-02T03:00)"))
    assert _epoch_moves(PORT, pfrag, lambda: h.remove_expired_views(
        dt.datetime(2030, 1, 1)))
    prev = timeq.write_finest()
    timeq.configure(write_finest=True, rollup=True)
    try:
        ex.execute("i", "Set(4, t=2, 2031-05-06T07:00)")
        assert _epoch_moves(PORT, pfrag, lambda: h.rollup_views(
            dt.datetime(2031, 7, 1)))
    finally:
        timeq.configure(write_finest=prev, rollup=False)
    assert t is idx.field("t")
    dst = h.create_index("copy", track_existence=True)
    assert _epoch_moves(PORT, pfrag, lambda: idx.clone_to(dst))
    assert _epoch_moves(PORT, pfrag, lambda: idx.rename_field("b", "bb"))
    from pilosa_tpu_torch.ingest.batch import Batch, Record
    api = API(h, device="cpu")
    b = Batch(api, "i", {"a": {"type": "set"}}, size=2)
    assert _epoch_moves(PORT, pfrag, lambda: (
        b.add(Record(20, {"a": 1})), b.add(Record(21, {"a": 2})),
        b.flush()))
