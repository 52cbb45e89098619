"""The port's ragged page-table program (pilosa_tpu_torch/executor/
ragged.py) and its two kernels' plain versions against the JAX
package's.

``concat_gather`` and ``segment_count``'s plain versions equal the JAX
``ops/bitmap.py`` functions and ``segment_count_np`` (padded lane
indices and segment ids at nseg included); a mixed batch over two
indexes and explicit shard subsets answers the same through the port's
ragged program, its per-group path, its solo executor and the JAX
ServingLayer.  Batches are driven through ``_run_batch`` directly where
the composition matters; threads are joined with a timeout that fails
the test.  The port runs on the CPU, where each wrapper runs its plain
version: the tests count the wrappers' calls to see the route."""

import random

import numpy as np
import pytest
import torch

from pilosa_tpu.executor.executor import Executor as JaxExecutor
from pilosa_tpu.ops import bitmap as jbm
from pilosa_tpu.pql import parse as jparse
from pilosa_tpu_torch import memory
from pilosa_tpu_torch.executor import stacked as stk
from pilosa_tpu_torch.executor.executor import Executor
from pilosa_tpu_torch.models.view import VIEW_STANDARD
from pilosa_tpu_torch.obs import faults, metrics
from pilosa_tpu_torch.obs.monitor import global_monitor
from pilosa_tpu_torch.ops import bitmap as bm
from pilosa_tpu_torch.ops import kernels as K
from pilosa_tpu_torch.pql import parse
from torch_serving_common import (
    JAX,
    PORT,
    W,
    run_threads,
    stop_planes,  # noqa: F401  (autouse)
)

torch.set_num_threads(1)


def build_mixed(pkg):
    """Two indexes of different shard counts and field shapes, the
    heterogeneous-traffic fixture of tests/test_ragged.py at width W."""
    h = pkg["Holder"](width=W)
    a = h.create_index("alpha", track_existence=True)
    a.create_field("a")
    a.create_field("b")
    a.create_field("v", pkg["FieldOptions"](type=pkg["FieldType"].INT,
                                            min=0, max=1000))
    b = h.create_index("beta", track_existence=False)
    b.create_field("c")
    b.create_field("w", pkg["FieldOptions"](type=pkg["FieldType"].INT,
                                            min=-50, max=500))
    ex = pkg["Executor"](h, **pkg["kw"])
    for i in range(240):
        col = (i * 9973) % (3 * W)          # 3 shards
        ex.execute("alpha", f"Set({col}, a={i % 4})")
        ex.execute("alpha", f"Set({col}, b={i % 6})")
        ex.execute("alpha", f"Set({col}, v={(i * 7) % 97})")
    for i in range(180):
        col = (i * 7919) % (5 * W)          # 5 shards
        ex.execute("beta", f"Set({col}, c={i % 3})")
        ex.execute("beta", f"Set({col}, w={(i * 11) % 300 - 40})")
    return h


@pytest.fixture(scope="module")
def holders():
    return build_mixed(JAX), build_mixed(PORT)


MIXED = [
    ("alpha", "Count(Row(a=1))", None),
    ("alpha", "Count(Row(b=2))", None),
    ("beta", "Count(Row(c=0))", None),
    ("beta", "Count(Row(c=2))", None),
    ("alpha", "Count(Intersect(Row(a=1), Row(b=2)))", None),
    ("alpha", "Count(Union(Row(a=0), Row(b=5)))", None),
    ("beta", "Count(Union(Row(c=0), Row(c=1)))", None),
    ("alpha", "Row(a=2)", None),
    ("beta", "Row(c=1)", None),
    ("alpha", "Sum(Row(a=1), field=v)", None),
    ("beta", "Sum(field=w)", None),
    ("alpha", "Count(Row(v > 50))", None),
    ("beta", "Count(Row(w > 100))", None),
    ("beta", "Count(Row(w < 0))", None),
    ("alpha", "TopN(a, n=3)", None),
    ("beta", "TopN(c, n=2)", None),
    ("alpha", "GroupBy(Rows(a), Rows(b))", None),
    ("alpha", "GroupBy(Rows(b), filter=Row(a=1), aggregate=Sum(field=v))",
     None),
    # explicit shard subsets: the same index under another shard set is
    # its own group, fused into the same ragged program
    ("alpha", "Count(Row(a=1))", [0, 1]),
    ("alpha", "Count(Row(a=1))", [2]),
    ("beta", "Count(Row(c=0))", [0, 2, 4]),
    ("alpha", "Count(Not(Row(a=1)))", None),
]


def _key(i, q, s):
    return (i, q, tuple(s) if s else None)


def solo(pkg, h, items):
    ex = pkg["Executor"](h, **pkg["kw"])
    return {_key(i, q, s): [pkg["ser"](x) for x in ex.execute(i, q, s)]
            for i, q, s in items}


def run_one_batch(pkg, layer, items, expect_fused=True):
    """ONE batch through the leader protocol (no admission window)."""
    p = jparse if pkg is JAX else parse
    reqs = []
    for index, q, shards in items:
        idx = layer.executor.holder.index(index)
        r = layer._classify(index, idx, p(q), shards, None, (index, q, None))
        assert r is not None, (index, q)
        reqs.append(r)
    layer._run_batch(reqs)
    out = {}
    for (index, q, shards), r in zip(items, reqs):
        assert r.error is None, (index, q, r.error)
        if expect_fused:
            assert not r.direct and r.result is not None, (index, q)
        out[_key(index, q, shards)] = (
            None if r.result is None else [pkg["ser"](x) for x in r.result])
    return out


@pytest.fixture
def calls(monkeypatch):
    """Counts of the two page-table wrappers' calls (on the CPU they
    run their plain versions and count no launch)."""
    n = {"concat_gather": 0, "segment_count": 0}
    for name in n:
        real = getattr(K, name)

        def wrap(*a, _real=real, _name=name, **kw):
            n[_name] += 1
            return _real(*a, **kw)
        monkeypatch.setattr(K, name, wrap)
    return n


# -- the two kernels' plain versions against the JAX functions --------------

@pytest.mark.parametrize("n_pages,pl,w", [(3, 4, 8), (1, 5, 3), (6, 2, 64)])
def test_segment_ops_equal_jax(n_pages, pl, w):
    rng = np.random.default_rng(n_pages * 100 + w)
    pages = [rng.integers(0, 1 << 32, size=(pl, w), dtype=np.uint32)
             for _ in range(n_pages)]
    tpages = [torch.from_numpy(p.view(np.int32)) for p in pages]
    n = n_pages * pl
    lane_idx = rng.integers(0, n, size=2 * n).astype(np.int32)
    # the JAX contract: pages pow2-padded by repeating the last one,
    # lane_idx by repeating its last index
    padded = tuple(pages) + (pages[-1],) * ((1 << (n_pages - 1).bit_length())
                                            - n_pages)
    li_pad = np.concatenate([lane_idx, [lane_idx[-1]] * 3]).astype(np.int32)
    want = np.asarray(jbm.concat_gather(padded, li_pad))
    got = bm.concat_gather(tpages, torch.from_numpy(li_pad)).numpy()
    assert np.array_equal(got.view(np.uint32), want)
    nseg = 3
    seg = np.concatenate([rng.integers(0, nseg, size=2 * n),
                          [nseg] * 3]).astype(np.int32)   # dump slot
    # the JAX twin keeps the dump slot as a segment of its own
    jcount = np.asarray(jbm.segment_count(want, seg, nseg))
    npc = jbm.segment_count_np(want, seg, nseg + 1)[:nseg]
    pc = bm.segment_count(tpages, torch.from_numpy(li_pad),
                          torch.from_numpy(seg), nseg)
    assert pc.dtype == torch.int64
    assert pc.tolist() == npc.tolist() == jcount.tolist()
    # ids past nseg and below 0 are dropped, never counted again
    seg2 = seg.copy()
    seg2[:2] = [-1, nseg + 5]
    ref = jbm.segment_count_np(want[2:], seg2[2:], nseg + 1)[:nseg]
    assert bm.segment_count(tpages, torch.from_numpy(li_pad),
                            torch.from_numpy(seg2), nseg).tolist() == \
        ref.tolist()


def test_segment_count_int64_equals_jax_where_exact():
    """The port answers int64 (the card test sums past 2^31); where the
    JAX int32 answer is exact the two are equal."""
    full = torch.full((4, 4096), -1, dtype=torch.int32)     # 2^17 bits
    li = torch.arange(16, dtype=torch.int32).repeat(7)
    seg = torch.zeros(li.numel(), dtype=torch.int32)
    got = bm.segment_count([full] * 4, li, seg, 1)
    assert got.dtype == torch.int64
    want = np.asarray(jbm.segment_count(
        np.full((li.numel(), 4096), 0xFFFFFFFF, np.uint32),
        seg.numpy(), 1))
    assert got.tolist() == [int(want[0])] == [li.numel() << 17]


def test_wrappers_refuse_mixed_shapes():
    a = torch.zeros((4, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="shape"):
        K.concat_gather([a, a[:2]], torch.zeros(1, dtype=torch.int32))
    with pytest.raises(ValueError, match="no pages"):
        K.segment_count([], torch.zeros(1, dtype=torch.int32),
                        torch.zeros(1, dtype=torch.int32), 1)
    assert K.gather_table([a, a]) is None


# -- the fused program against solo and the JAX serving layer ----------------

@pytest.mark.parametrize("ragged", [True, False])
def test_mixed_batch_equals_jax(holders, calls, ragged):
    jh, ph = holders
    want = solo(JAX, jh, MIXED)
    assert solo(PORT, ph, MIXED) == want
    jsrv = JaxExecutor(jh)
    jlayer = jsrv.enable_serving(window_s=0.0, max_batch=64, cache_bytes=0,
                                 admission=False, ragged=ragged)
    assert run_one_batch(JAX, jlayer, MIXED) == want
    srv = Executor(ph, device="cpu")
    layer = srv.enable_serving(window_s=0.0, max_batch=64, cache_bytes=0,
                               admission=False, ragged=ragged)
    kind = "ragged" if ragged else "group"
    d0 = metrics.SERVING_DISPATCH.value(kind=kind)
    m0 = len(global_monitor.recent())
    assert run_one_batch(PORT, layer, MIXED) == want
    n_groups = len({(i, tuple(s) if s else None) for i, _q, s in MIXED})
    got = metrics.SERVING_DISPATCH.value(kind=kind) - d0
    if ragged:
        # first sighting: the whole batch rides one extras program
        assert got == 1
        assert calls["segment_count"] >= 1 and calls["concat_gather"] >= 1
        assert not [e for e in global_monitor.recent()[m0:]
                    if e.get("where") == "serving.ragged_plan"]
    else:
        assert got == n_groups
        assert calls == {"concat_gather": 0, "segment_count": 0}
    layer.close()


def test_concurrent_mixed_batches(holders):
    _jh, ph = holders
    want = solo(PORT, ph, MIXED)
    srv = Executor(ph, device="cpu")
    layer = srv.enable_serving(window_s=0.05, max_batch=64, cache_bytes=0,
                               admission=False)
    got = {}
    import threading
    bar = threading.Barrier(len(MIXED))

    def one(i, q, s):
        def go():
            bar.wait(30)
            got[_key(i, q, s)] = [PORT["ser"](x)
                                  for x in srv.execute_serving(i, q, s)]
        return go
    r0 = metrics.SERVING_DISPATCH.value(kind="ragged")
    run_threads([one(*it) for it in MIXED])
    assert got == want
    assert metrics.SERVING_DISPATCH.value(kind="ragged") > r0
    layer.close()


def test_multipage_and_encoded_page_tables(holders, calls):
    """Small pages make several pages an operand, and the sparse data's
    pages encode: the buckets expand them and the gathers reassemble
    every operand exactly."""
    _jh, ph = holders
    prev = memory.page_bytes()
    memory.configure(page_bytes=1024)       # 32 lanes of 32 words
    try:
        srv = Executor(ph, device="cpu")
        layer = srv.enable_serving(window_s=0.0, max_batch=64,
                                   cache_bytes=0, admission=False)
        idx = ph.index("alpha")
        with stk.raw_pages():
            pv = srv.stacked.rows_stack_for(
                idx, idx.field("a"), (VIEW_STANDARD,), (0, 1, 2, 3),
                tuple(sorted(idx.available_shards)))
        assert isinstance(pv, stk.PageView) and len(pv.pages) > 1
        dense = pv.dense_pages()
        assert all(isinstance(p, torch.Tensor) for p in dense)
        flat = torch.cat(dense)[:pv.lanes].reshape(pv.shape)
        assert torch.equal(flat, stk._expand_view(pv))
        assert run_one_batch(PORT, layer, MIXED) == solo(PORT, ph, MIXED)
        assert calls["concat_gather"] > 0
    finally:
        memory.configure(page_bytes=prev)


def test_property_random_mixed_batches_with_writes():
    """Seeded random mixed batches stay equal to the JAX package's solo
    answers while the same writes land on both holders."""
    rng = random.Random(7)
    jh, ph = build_mixed(JAX), build_mixed(PORT)
    jw, pw = JaxExecutor(jh), Executor(ph, device="cpu")
    srv = Executor(ph, device="cpu")
    layer = srv.enable_serving(window_s=0.0, max_batch=64, cache_bytes=0,
                               admission=False)

    def tree(index, depth):
        fields = [("a", 4), ("b", 6)] if index == "alpha" else [("c", 3)]
        if depth <= 0 or rng.random() < 0.45:
            if rng.random() < 0.3:
                vf = "v" if index == "alpha" else "w"
                op = rng.choice([">", "<", ">=", "<=", "=="])
                return f"Row({vf} {op} {rng.randrange(-20, 120)})"
            f, r = rng.choice(fields)
            return f"Row({f}={rng.randrange(r)})"
        op = rng.choice(["Union", "Intersect", "Difference", "Xor"])
        kids = ", ".join(tree(index, depth - 1)
                         for _ in range(rng.randrange(2, 4)))
        return f"{op}({kids})"

    def query(index):
        t = tree(index, 2)
        wrap = rng.randrange(4)
        tf, vf = ("a", "v") if index == "alpha" else ("c", "w")
        return [f"Count({t})", f"TopN({tf}, {t}, n=3)",
                f"Sum({t}, field={vf})", t][wrap]

    n_shards = {"alpha": 3, "beta": 5}
    for round_ in range(4):
        items = []
        for _ in range(10):
            index = rng.choice(["alpha", "beta"])
            shards = None
            if rng.random() < 0.3:
                shards = sorted(rng.sample(range(n_shards[index]),
                                           rng.randrange(1, n_shards[index]
                                                         + 1)))
            items.append((index, query(index), shards))
        items = list({_key(*it): it for it in items}.values())
        assert run_one_batch(PORT, layer, items) == solo(JAX, jh, items), \
            round_
        for _ in range(6):
            index = rng.choice(["alpha", "beta"])
            col = rng.randrange(n_shards[index] * W)
            f = rng.choice(["a", "b"] if index == "alpha" else ["c"])
            q = f"Set({col}, {f}={rng.randrange(3)})"
            jw.execute(index, q)
            pw.execute(index, q)


def test_monotone_counts_under_concurrent_writes():
    h = build_mixed(PORT)
    srv = Executor(h, device="cpu")
    srv.enable_serving(window_s=0.001, max_batch=32, cache_bytes=0,
                       admission=False)
    writer = Executor(h, device="cpu")
    n_writes, n_readers, n_iters = 40, 4, 15
    errs: list = []

    def write():
        try:
            for c in range(n_writes):
                writer.execute("alpha", f"Set({c}, a=9)")
                writer.execute("beta", f"Set({c}, c=9)")
        except Exception as e:  # pragma: no cover
            errs.append(e)

    def read(index, row):
        def go():
            try:
                prev = -1
                for _ in range(n_iters):
                    (n,) = srv.execute_serving(index,
                                               f"Count(Row({row}=9))")
                    assert n >= prev, (index, n, prev)
                    prev = n
            except Exception as e:  # pragma: no cover
                errs.append(e)
        return go

    run_threads([write] + [read("alpha", "a") if i % 2 else read("beta", "c")
                           for i in range(n_readers)])
    assert not errs
    assert Executor(h, device="cpu").execute("alpha", "Count(Row(a=9))") == \
        [n_writes]


def test_canonical_program_replays_until_the_epoch_moves(holders):
    """Once the canonical slot set covers the traffic, every batch of it
    replays the cached program (no build); a write moves the mutation
    epoch and the next batch builds again, with the written answer."""
    _jh, ph = holders
    h = build_mixed(PORT)
    srv = Executor(h, device="cpu")
    layer = srv.enable_serving(window_s=0.0, max_batch=64, cache_bytes=0,
                               admission=False)
    b1 = [("alpha", "Count(Row(a=0))", None),
          ("alpha", "Count(Row(a=1))", None),
          ("beta", "Count(Row(c=0))", None)]
    b2 = [("alpha", "Count(Row(b=1))", None),
          ("alpha", "Count(Row(b=3))", None),
          ("beta", "Count(Row(c=2))", None)]
    assert run_one_batch(PORT, layer, b1) == solo(PORT, h, b1)
    canon = layer._ragged_canon
    assert len(canon.slots) == 0              # probation: extras program
    assert run_one_batch(PORT, layer, b1) == solo(PORT, h, b1)
    assert len(canon.slots) == 3
    assert run_one_batch(PORT, layer, b2) == solo(PORT, h, b2)
    assert run_one_batch(PORT, layer, b2) == solo(PORT, h, b2)
    assert len(canon.slots) == 6
    builds = canon.builds
    assert run_one_batch(PORT, layer, b1) == solo(PORT, h, b1)
    assert run_one_batch(PORT, layer, b2) == solo(PORT, h, b2)
    assert canon.builds == builds and canon.cached is not None
    Executor(h, device="cpu").execute("alpha", "Set(1, a=0)")
    assert run_one_batch(PORT, layer, b1) == solo(PORT, h, b1)
    assert canon.builds == builds + 1


def test_failed_ragged_plan_degrades_to_per_group(holders, monkeypatch):
    _jh, ph = holders
    from pilosa_tpu_torch.executor import ragged

    def boom(layer, groups):
        raise RuntimeError("planner fault")
    monkeypatch.setattr(ragged, "run_ragged", boom)
    srv = Executor(ph, device="cpu")
    layer = srv.enable_serving(window_s=0.0, max_batch=64, cache_bytes=0,
                               admission=False)
    g0 = metrics.SERVING_DISPATCH.value(kind="group")
    m0 = len(global_monitor.recent())
    assert run_one_batch(PORT, layer, MIXED) == solo(PORT, ph, MIXED)
    assert metrics.SERVING_DISPATCH.value(kind="group") > g0
    assert [e for e in global_monitor.recent()[m0:]
            if e.get("where") == "serving.ragged_plan"]


def test_failed_dispatch_sends_riders_solo(holders):
    """An armed serving-dispatch fault fails the fused program; every
    rider then re-executes on its own thread, exactly."""
    _jh, ph = holders
    srv = Executor(ph, device="cpu")
    layer = srv.enable_serving(window_s=0.0, max_batch=64, cache_bytes=0,
                               admission=False)
    faults.inject("serving-dispatch", times=1)
    try:
        out = run_one_batch(PORT, layer, MIXED[:4], expect_fused=False)
    finally:
        faults.clear("serving-dispatch")
    assert all(v is None for v in out.values())
    items = MIXED[:4]
    got = {_key(i, q, s): [PORT["ser"](x)
                           for x in srv.execute_serving(i, q, s)]
           for i, q, s in items}
    assert got == solo(PORT, ph, items)
