"""The port's memory plane against the JAX package's (tests/test_memory.py):
the budget ledger, paged stacks, cost-aware eviction, the prefetcher and
the OOM ladder.

The ledger cases run the JAX file's cases on the port's Ledger.  The
paged cases hold the port's answers, under a Ledger clamped below the
working set, to the JAX package's Executor on the same seeded holder
(its default engine, paged and sparse), and check what the port's
cache did (misses, page rebuilds, hot pages kept, drained entries
dropped).  The OOM ladder's rungs run through the ``device-oom`` fault
point; ``is_oom`` takes torch's out-of-memory error and never a failed
launch.  The port takes its switches through ``memory.configure()``,
which the ``restore_memory`` fixture puts back.  Every output is an
integer: the tolerance is 0 throughout."""

from __future__ import annotations

import dataclasses
import gc
import logging
import threading

import numpy as np
import pytest
import torch

from pilosa_tpu.executor.executor import Executor as JaxExecutor
from pilosa_tpu.models.holder import Holder as JaxHolder
from pilosa_tpu.models.schema import FieldOptions as JaxFieldOptions
from pilosa_tpu.models.schema import FieldType as JaxFieldType
from pilosa_tpu_torch import memory
from pilosa_tpu_torch.executor.executor import Executor
from pilosa_tpu_torch.executor.stacked import StackCache
from pilosa_tpu_torch.memory import encode, pressure
from pilosa_tpu_torch.memory.ledger import Ledger
from pilosa_tpu_torch.memory.pages import PagedStack
from pilosa_tpu_torch.memory.policy import Prefetcher
from pilosa_tpu_torch.models.holder import Holder
from pilosa_tpu_torch.models.schema import FieldOptions, FieldType
from pilosa_tpu_torch.obs import faults, flight, metrics

torch.set_num_threads(1)

W = 1 << 15  # a small shard width keeps stacks small


def _build(holder, opts, ftype, n_shards=8, n_rows=8):
    """tests/test_memory.py's holder: a set field f of 4000 seeded bits
    over n_rows rows, and an INT v (0..127) on 500 of its columns."""
    h = holder(width=W)
    idx = h.create_index("i")
    f = idx.create_field("f")
    rng = np.random.default_rng(5)
    rows = rng.integers(0, n_rows, size=4000)
    cols = rng.integers(0, n_shards * W, size=4000)
    f.import_bits(rows, cols)
    v = idx.create_field("v", opts(type=ftype.INT, min=0, max=127))
    v.import_values(cols[:500] % (n_shards * W),
                    (cols[:500] % 97).astype(np.int64))
    return h


def _port(**kw):
    return _build(Holder, FieldOptions, FieldType, **kw)


def _jax(**kw):
    return _build(JaxHolder, JaxFieldOptions, JaxFieldType, **kw)


def _norm(results):
    out = []
    for r in results:
        if isinstance(r, list) and r and hasattr(r[0], "group"):
            out.append([(tuple((g["field"], g["row_id"]) for g in gc.group),
                         gc.count, gc.agg) for gc in r])
        elif isinstance(r, list):
            out.append([(p.id, p.count) for p in r])
        elif dataclasses.is_dataclass(r):
            out.append(dataclasses.asdict(r))
        elif hasattr(r, "columns"):
            out.append(r.columns().tolist())
        else:
            out.append(r)
    return out


@pytest.fixture
def restore_memory():
    """Put back the process's memory switches and the global ledger's
    budget: these tests change them."""
    led = memory.ledger()
    prev = (memory._paged_default, memory._page_bytes_default,
            pressure.OOM_RETRY, pressure.HOST_FALLBACK, encode._ENABLED)
    yield
    (memory._paged_default, memory._page_bytes_default,
     pressure.OOM_RETRY, pressure.HOST_FALLBACK, encode._ENABLED) = prev
    led.set_budget(None)
    faults.clear("device-oom")


def _clamped(ex, budget: int) -> StackCache:
    cache = ex.stacked.cache = StackCache(
        seams=True, ledger=Ledger(budget_bytes=budget), device=ex.device)
    return cache


# ---------------------------------------------------------------------------
# ledger
# ---------------------------------------------------------------------------

def test_ledger_reserve_release_denial():
    led = Ledger(budget_bytes=1000)
    c = led.register("a")
    assert led.budget() == 1000
    assert c.reserve(600)
    assert led.total_bytes == 600
    assert not c.reserve(500)       # would cross the budget, no reclaim
    assert led.total_bytes == 600
    assert not c.reserve(2000)      # alone past the budget
    c.release(600)
    assert led.total_bytes == 0
    assert c.reserve(1000)          # an exact fit
    c.release(1000)


def test_ledger_cross_client_reclaim():
    led = Ledger(budget_bytes=1000)
    state = {"held": 0}

    def reclaim_a(need):
        freed = min(state["held"], need)
        state["held"] -= freed
        a.release(freed)
        return freed

    a = led.register("a", reclaim=reclaim_a, cold_ts=lambda: 1.0)
    b = led.register("b", cold_ts=lambda: 2.0)
    assert a.reserve(900)
    state["held"] = 900
    assert b.reserve(400)           # a sheds 300 or more
    assert led.total_bytes <= 1000
    assert b.bytes == 400 and a.bytes <= 600


@pytest.mark.parametrize("explicit", [None, 12345])
def test_ledger_budget_detection(explicit, monkeypatch):
    """Without a card the budget is the 8 GiB fallback; an explicit one
    wins; with a card, the card's total less the headroom."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert Ledger(budget_bytes=explicit).budget() == (explicit or 8 << 30)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda d: (1 << 30, 80 << 30))
    assert Ledger(budget_bytes=explicit).budget() == (
        explicit or int((80 << 30) * 0.9))


def test_ledger_shrink_reclaims():
    led = Ledger(budget_bytes=1000)
    pool = {"held": 800}

    def reclaim(need):
        freed = min(pool["held"], need)
        pool["held"] -= freed
        c.release(freed)
        return freed

    c = led.register("a", reclaim=reclaim)
    assert c.reserve(800)
    led.set_budget(500)
    assert led.total_bytes <= 500


def test_ledger_dead_clients_drop_out():
    led = Ledger(budget_bytes=1000)
    c = led.register("ghost")
    assert c.reserve(700)
    del c
    gc.collect()
    assert led.total_bytes == 0
    assert led.register("live").reserve(1000)


def test_concurrent_reserve_reclaim_race():
    """Threads reserving and releasing while reclaim evicts across
    clients: the total never crosses the budget, and drains to 0."""
    budget = 64 << 10
    led = Ledger(budget_bytes=budget)
    n_threads = 8
    lock = threading.Lock()
    pools = {i: 0 for i in range(n_threads)}
    clients = {}

    def make_reclaim(i):
        def reclaim(need):
            with lock:
                freed = min(pools[i], need)
                pools[i] -= freed
            if freed:
                clients[i].release(freed)
            return freed
        return reclaim

    for i in range(n_threads):
        clients[i] = led.register(f"c{i}", reclaim=make_reclaim(i))
    violations = []
    stop = threading.Event()

    def watcher():
        while not stop.is_set():
            if led.total_bytes > budget:
                violations.append(led.total_bytes)

    def hammer(i):
        rng = np.random.default_rng(i)
        for _ in range(300):
            n = int(rng.integers(256, 4096))
            if clients[i].reserve(n):
                with lock:
                    pools[i] += n
            if rng.random() < 0.4:
                with lock:
                    give = pools[i] // 2
                    pools[i] -= give
                if give:
                    clients[i].release(give)

    threads = [threading.Thread(target=hammer, args=(i,))
               for i in range(n_threads)]
    wt = threading.Thread(target=watcher)
    wt.start()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    stop.set()
    wt.join()
    assert not violations
    for i in range(n_threads):
        if pools[i]:
            clients[i].release(pools[i])
    assert led.total_bytes == 0


def test_both_engines_share_one_budget():
    """The stacked engine's stacks and the per-shard engine's tiles are
    two clients of one ledger: no private default caps."""
    ex = Executor(_port(n_shards=2), device="cpu")
    assert ex.stacked.cache.max_bytes is None
    assert ex.tiles.cache.max_bytes is None
    assert ex.stacked.cache._ledger is ex.tiles.cache._ledger \
        is memory.ledger()
    ex.execute("i", "Count(Row(f=1))")
    ex.use_stacked = False
    ex.execute("i", "Count(Row(f=1))")
    assert ex.stacked.cache._client.bytes == ex.stacked.cache.nbytes > 0
    assert ex.tiles.cache._client.bytes == ex.tiles.cache.nbytes > 0
    assert metrics.MEM_RESIDENT.value(client="tile_cache") > 0


def test_concurrent_stack_cache_under_pressure():
    """Threads racing a clamped cache stay exact, and its accounting
    stays consistent."""
    ex = Executor(_port(n_shards=8), device="cpu")
    want = [ex.execute("i", f"Count(Row(f={r}))")[0] for r in range(8)]
    led = Ledger(budget_bytes=24 << 10)
    cache = ex.stacked.cache = StackCache(seams=True, ledger=led,
                                          device=ex.device)
    errs = []

    def worker(seed):
        try:
            rng = np.random.default_rng(seed)
            for _ in range(20):
                r = int(rng.integers(0, 8))
                assert ex.execute("i", f"Count(Row(f={r}))")[0] == want[r]
        except Exception as e:  # pragma: no cover - failure detail
            errs.append(e)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errs
    assert led.total_bytes <= led.budget()
    with cache._lock:
        assert cache.nbytes == sum(e[2] for e in cache._entries.values())
    assert cache._client.bytes == cache.nbytes
    cache.clear()
    assert cache._client.bytes == 0


# ---------------------------------------------------------------------------
# paged residency, held to the JAX Executor
# ---------------------------------------------------------------------------

_CLAMP_QUERIES = ([f"Count(Row(f={r}))" for r in range(8)]
                  + ["Count(Intersect(Row(f=1), Row(f=2)))",
                     "TopN(f, n=4)", "Sum(Row(f=1), field=v)",
                     "GroupBy(Rows(f))"])


@pytest.fixture(scope="module")
def clamp_want():
    jex = JaxExecutor(_jax())
    return [_norm(jex.execute("i", q)) for q in _CLAMP_QUERIES]


@pytest.mark.parametrize("page_bytes,sparse", [
    (4 << 20, True), (8192, True), (8192, False)])
def test_paged_exact_under_half_budget(page_bytes, sparse, clamp_want,
                                       restore_memory):
    """Under a Ledger clamped to half the working set, every query equals
    the JAX Executor's answer, round after round, and the cache misses."""
    memory.configure(page_bytes=page_bytes)
    encode.configure(enabled=sparse)
    h = _port()
    plain = Executor(h, device="cpu")
    for q in _CLAMP_QUERIES:
        plain.execute("i", q)
    ws = plain.stacked.cache.nbytes
    assert ws > 0
    ex = Executor(h, device="cpu")
    cache = _clamped(ex, max(ws // 2, 4096))
    for _ in range(3):
        got = [_norm(ex.execute("i", q)) for q in _CLAMP_QUERIES]
        assert got == clamp_want
    assert cache.misses > len(_CLAMP_QUERIES)
    assert cache._ledger.total_bytes <= cache._ledger.budget()
    assert cache._client.bytes == cache.nbytes


def _entry(cache, field="f", row=3):
    [(key, ent)] = [(k, e) for k, e in cache._entries.items()
                    if k[0] == "rows" and k[2] == field and k[4] == (row,)]
    return key, ent


def test_page_eviction_rebuilds_only_missing_pages(restore_memory):
    """A fresh entry with one evicted page builds that page alone
    (outcome page_rebuild)."""
    encode.configure(enabled=False)
    memory.configure(page_bytes=8192)
    ex = Executor(_port(n_shards=16), device="cpu")
    cache = _clamped(ex, 1 << 20)
    want = ex.execute("i", "Count(Row(f=3))")[0]
    key, ent = _entry(cache)
    ps = ent[1]
    assert isinstance(ps, PagedStack) and ps.n_pages > 1
    full = ps.lanes * ps.width_words * 4
    with cache._lock:
        ps.pages[0] = None
        cache._sync_entry_locked(key, ps)
    cache._client.release(ps.page_nbytes)
    r0 = cache.rebuilt_bytes
    assert ex.execute("i", "Count(Row(f=3))")[0] == want
    assert cache.page_rebuilds == 1
    assert cache.rebuilt_bytes - r0 == ps.page_nbytes < full
    assert metrics.STACK_CACHE.value(outcome="page_rebuild") >= 1


def test_patch_applies_to_single_page(restore_memory):
    encode.configure(enabled=False)
    memory.configure(page_bytes=8192)
    ex = Executor(_port(n_shards=16), device="cpu")
    cache = _clamped(ex, 1 << 20)
    before = ex.execute("i", "Count(Row(f=3))")[0]
    ex.execute("i", f"Set({15 * W + 77}, f=3)")
    p0 = cache.patched_bytes
    assert ex.execute("i", "Count(Row(f=3))")[0] == before + 1
    assert cache.patches == 1 and cache.full_rebuilds == 1
    assert 0 < cache.patched_bytes - p0 <= 8192


def test_broad_scan_does_not_evict_hot_pages(restore_memory):
    """An entry larger than half the budget keeps only that share: the
    TopN candidate block streams its tail and the hot row stacks stay
    (16 shards x 4 KiB lanes: hot stacks 64 KiB each, the TopN block
    256 KiB, a 320 KiB budget)."""
    memory.configure(page_bytes=8192)
    h = _port(n_shards=16, n_rows=4)
    jex = JaxExecutor(_jax(n_shards=16, n_rows=4))
    ex = Executor(h, device="cpu")
    cache = _clamped(ex, 320 << 10)
    hot = [f"Count(Row(f={r}))" for r in range(2)]
    want = [jex.execute("i", q)[0] for q in hot]
    top = _norm(jex.execute("i", "TopN(f, n=4)"))
    assert [ex.execute("i", q)[0] for q in hot] == want
    assert _norm(ex.execute("i", "TopN(f, n=4)")) == top
    h0 = cache.hits
    for _ in range(3):
        for q, w in zip(hot, want):
            assert ex.execute("i", q)[0] == w
        assert _norm(ex.execute("i", "TopN(f, n=4)")) == top
    assert cache.hits - h0 >= 6
    assert cache._client.bytes <= 320 << 10


def test_fully_drained_entries_are_dropped():
    ex = Executor(_port(n_shards=4), device="cpu")
    led = Ledger(budget_bytes=1 << 20)
    cache = ex.stacked.cache = StackCache(seams=True, ledger=led,
                                          device=ex.device)
    for r in range(8):
        ex.execute("i", f"Count(Intersect(Row(f={r}), Row(f={r})))")
    assert len(cache._entries) >= 8
    led.reclaim_frac(1.0, trigger="shrink")
    assert cache.nbytes == 0 and len(cache._entries) == 0


def test_prewarm_skips_dropped_field():
    h = _port(n_shards=4)
    ex = Executor(h, device="cpu")
    led = Ledger(budget_bytes=1 << 20)
    cache = ex.stacked.cache = StackCache(seams=True, ledger=led,
                                          device=ex.device)
    ex.execute("i", "Count(Row(f=1))")
    [fp] = [f for f, (k, _r) in cache._recipes.items()
            if k[0] == "rows" and k[4] == (1,)]
    h.index("i").delete_field("f")
    led.reclaim_frac(1.0, trigger="shrink")
    assert cache.prewarm(fp) is False
    assert fp not in cache._recipes
    assert led.total_bytes == 0


def test_whole_entries_when_paging_disabled(restore_memory):
    memory.configure(paged=False)
    ex = Executor(_port(n_shards=4), device="cpu")
    want = ex.execute("i", "Count(Row(f=1))")[0]
    assert all(not isinstance(e[1], PagedStack)
               for e in ex.stacked.cache._entries.values())
    assert ex.execute("i", "Count(Row(f=1))")[0] == want
    assert ex.stacked.cache.hits >= 1


def test_too_big_entry_counted_and_warned_once(caplog):
    c = StackCache(max_bytes=64)
    big = torch.zeros(1024, dtype=torch.int32)
    t0 = metrics.STACK_CACHE.value(outcome="too_big")
    with caplog.at_level(logging.WARNING, "pilosa_tpu_torch.stacked"):
        for _ in range(3):
            assert c.get(("k", 1), [], lambda: big, lambda: None) is big
    assert c.nbytes == 0 and c.too_big == 3
    assert metrics.STACK_CACHE.value(outcome="too_big") == t0 + 3
    assert len([r for r in caplog.records
                if "exceeds the device budget" in r.message]) == 1


# ---------------------------------------------------------------------------
# the OOM ladder
# ---------------------------------------------------------------------------

def test_injected_oom_absorbed_by_retry(restore_memory):
    # dense pages: a Count over encoded pages launches nothing, and the
    # armed injection would wait for the next guarded call
    encode.configure(enabled=False)
    ex = Executor(_port(n_shards=4), device="cpu")
    want = ex.execute("i", "Count(Row(f=1))")[0]
    r0 = metrics.OOM_TOTAL.value(outcome="retry_ok")
    pressure.inject_oom(1)
    assert ex.execute("i", "Count(Row(f=1))")[0] == want
    assert metrics.OOM_TOTAL.value(outcome="retry_ok") == r0 + 1
    assert not faults.armed("device-oom")


def test_persistent_oom_degrades_to_host(restore_memory, caplog):
    jex = JaxExecutor(_jax(n_shards=4))
    ex = Executor(_port(n_shards=4), device="cpu")
    q = "Sum(Row(f=1), field=v)"
    want = _norm(jex.execute("i", q))
    assert _norm(ex.execute("i", q)) == want
    f0 = metrics.OOM_TOTAL.value(outcome="host_fallback")
    r0 = metrics.OOM_TOTAL.value(outcome="raised")
    pressure.inject_oom(2)  # the attempt and the retry
    with caplog.at_level(logging.WARNING, "pilosa_tpu_torch.memory"):
        assert _norm(ex.execute("i", q)) == want
    assert metrics.OOM_TOTAL.value(outcome="host_fallback") == f0 + 1
    assert metrics.OOM_TOTAL.value(outcome="raised") == r0
    assert any("runs on the host" in r.message for r in caplog.records)


def test_card_engine_raises_after_the_retry(restore_memory, monkeypatch):
    """An engine on the card has no host fallback: an OOM that the retry
    does not absorb rides up, counted as raised."""
    ex = Executor(_port(n_shards=4), device="cpu")
    q = "Count(Intersect(Row(f=1), Row(f=2)))"
    want = ex.execute("i", q)[0]
    # the stacks stay where they were built; the engine reads as a card's
    monkeypatch.setattr(ex.stacked, "device", torch.device("cuda"))
    assert not ex.stacked.sparse_fast()
    f0 = metrics.OOM_TOTAL.value(outcome="host_fallback")
    r0 = metrics.OOM_TOTAL.value(outcome="raised")
    pressure.inject_oom(2)  # the attempt and the retry
    with pytest.raises(pressure.InjectedOOM):
        ex.execute("i", q)
    assert metrics.OOM_TOTAL.value(outcome="raised") == r0 + 1
    assert metrics.OOM_TOTAL.value(outcome="host_fallback") == f0
    monkeypatch.undo()
    assert ex.execute("i", q)[0] == want


def test_host_plan_refuses_a_device_tensor():
    leaf = torch.zeros((2, 4), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="only a plan on the CPU"):
        pressure.run_host_plan(("count", ("leaf", 0)), [leaf], [])


def test_oom_reraises_when_fallback_disabled(restore_memory):
    memory.configure(oom_retry=False, host_fallback=False)
    encode.configure(enabled=False)
    ex = Executor(_port(n_shards=2), device="cpu")
    ex.execute("i", "Count(Row(f=1))")
    pressure.inject_oom(1)
    with pytest.raises(Exception, match="RESOURCE_EXHAUSTED"):
        ex.execute("i", "Count(Row(f=2))")


@pytest.mark.parametrize("exc,want", [
    (RuntimeError("RESOURCE_EXHAUSTED: Out of memory allocating 123"), True),
    (MemoryError("Out of memory"), True),
    (torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate "
                                 "2.00 GiB"), True),
    (pressure.InjectedOOM("RESOURCE_EXHAUSTED: injected"), True),
    (RuntimeError("INVALID_ARGUMENT: nope"), False),
    (ValueError("unrelated out of memory"), False),
    (RuntimeError("CUDA error: an illegal memory access was encountered"),
     False),
    (RuntimeError("assemble_pages: CUDA launch failed (cudaError 2)"),
     False),
    (RuntimeError("nvcc failed:\nlibpage_kernels.so: error"), False),
])
def test_is_oom(exc, want):
    assert pressure.is_oom(exc) is want


def test_a_failed_launch_is_not_absorbed():
    """A launch error rides up at once: no relief sweep, no retry."""
    calls = []

    def run():
        calls.append(1)
        raise RuntimeError("CUDA error: an illegal memory access was "
                           "encountered")

    c0 = metrics.OOM_TOTAL.value(outcome="caught")
    with pytest.raises(RuntimeError, match="illegal memory access"):
        pressure.guarded(run, host_fallback=lambda: 0)
    assert calls == [1]
    assert metrics.OOM_TOTAL.value(outcome="caught") == c0


# ---------------------------------------------------------------------------
# the prefetcher
# ---------------------------------------------------------------------------

@pytest.fixture
def recorder():
    prev = (flight.recorder.enabled, flight.recorder._ring.maxlen)
    flight.recorder.configure(enabled=True, keep=256)
    flight.recorder.clear()
    yield flight.recorder
    flight.recorder.configure(enabled=prev[0], keep=prev[1])


def test_prefetcher_warms_rebuilt_keys(restore_memory, recorder):
    memory.configure(page_bytes=8192)
    ex = Executor(_port(n_shards=16), device="cpu")
    led = Ledger(budget_bytes=1 << 20)
    cache = ex.stacked.cache = StackCache(seams=True, ledger=led,
                                          device=ex.device)
    want = ex.execute("i", "Count(Row(f=2))")[0]
    led.reclaim_frac(1.0, trigger="shrink")
    assert cache.nbytes == 0
    assert any(rec.get("stack_keys") for rec in recorder.recent(16))
    e0 = metrics.PREFETCH_TOTAL.value(outcome="error")
    assert Prefetcher(cache, ledger=led).step() >= 1
    assert metrics.PREFETCH_TOTAL.value(outcome="warmed") >= 1
    assert metrics.PREFETCH_TOTAL.value(outcome="error") == e0
    h0, m0 = cache.hits, cache.misses
    assert ex.execute("i", "Count(Row(f=2))")[0] == want
    assert cache.hits == h0 + 1 and cache.misses == m0


def test_prewarm_after_write_is_not_stale(restore_memory, recorder):
    memory.configure(page_bytes=8192)
    ex = Executor(_port(n_shards=4), device="cpu")
    cache = _clamped(ex, 1 << 20)
    before = ex.execute("i", "Count(Row(f=1))")[0]
    ex.execute("i", f"Set({3 * W + 11}, f=1)")
    [fp] = [f for f, (k, _r) in cache._recipes.items()
            if k[0] == "rows" and k[4] == (1,)]
    assert cache.prewarm(fp) is True
    assert ex.execute("i", "Count(Row(f=1))")[0] == before + 1


def test_prefetcher_skips_under_pressure():
    led = Ledger(budget_bytes=1000)
    hog = led.register("x")
    assert hog.reserve(900)          # under a quarter of the budget free
    cache = StackCache(ledger=led)

    class FakeRecorder:
        def recent(self, n):
            return [{"stack_keys": [("deadbeef", "rebuild")]}]

    s0 = metrics.PREFETCH_TOTAL.value(outcome="skipped_pressure")
    assert Prefetcher(cache, recorder=FakeRecorder(), ledger=led).step() == 0
    assert metrics.PREFETCH_TOTAL.value(outcome="skipped_pressure") == s0 + 1


def test_prefetcher_counts_a_raising_prewarm():
    class Broken:
        def prewarm(self, fp):
            raise RuntimeError("assemble_pages: CUDA launch failed")

    class FakeRecorder:
        def recent(self, n):
            return [{"stack_keys": [("deadbeef", "rebuild")]}]

    e0 = metrics.PREFETCH_TOTAL.value(outcome="error")
    p = Prefetcher(Broken(), recorder=FakeRecorder(),
                   ledger=Ledger(budget_bytes=1 << 20))
    assert p.step() == 0
    assert metrics.PREFETCH_TOTAL.value(outcome="error") == e0 + 1


def test_prefetcher_start_stop_idempotent():
    p = Prefetcher(StackCache(ledger=Ledger(budget_bytes=1 << 20)),
                   interval_s=10.0)
    assert p.start() is p.start()
    p.stop()
    assert p._thread is None
