"""The port's per-shard engine and its two new kernels against the JAX
package, on the same data.

The port runs on the CPU (device="cpu": the kernels' plain versions).
Its Executor with ``use_stacked = False`` is held to the JAX Executor
with ``use_stacked = False`` — once with the JAX defaults and once with
PILOSA_TPU_PALLAS=1, which sends the JAX loop's filtered TopN/TopK
through ``masked_popcount`` and its Sum through ``bsi_sum_counts`` in
interpret mode.  The shapes the stacked engine refuses (a depth-40
field, GroupBy Min/Max over overlapping rows, Count(Distinct)) and a
depth-63 field run on both of the port's arms.  At kernel level, ``masked_popcount`` and the
one-hot histogram's plain versions are held to the JAX Pallas kernels
in interpret mode, and the port's ``onepass_arm = "onehot"`` to the JAX
executor's forced one-hot arm.  Every answer is an integer, a decimal
of integers or a set: the comparison is exact."""

import dataclasses

import numpy as np
import pytest
import torch

import __graft_entry__ as ge
from pilosa_tpu.executor.executor import Executor as JaxExecutor
from pilosa_tpu.models.holder import Holder as JaxHolder
from pilosa_tpu.models.schema import FieldOptions as JaxFieldOptions
from pilosa_tpu.models.schema import FieldType as JaxFieldType
from pilosa_tpu.models.schema import TimeQuantum as JaxTimeQuantum
from pilosa_tpu.ops import kernels as jk
from pilosa_tpu_torch.executor.executor import Executor
from pilosa_tpu_torch.models.state import holder_from_state, holder_state
from pilosa_tpu_torch.ops import kernels as K
from tests.test_torch_executor import (
    DENSE_QUERIES,
    GROUPBY_QUERIES,
    QUERIES,
    _categorical,
    _dense,
    _norm,
    jax_state,
)

# one intra-op thread: these tests share the machine with the rest of
# the suite's workers, several of which time their own work
torch.set_num_threads(1)

WIDTH = 2048
TS_BASE = 1 << 39


def _deep(h, opts, ftype):
    """A depth-40 field ts (2^39 plus a second of one day, on about half
    the columns), overlapping set rows s, mutex rows m, a filter row a
    and a signed BSI sv, over three shards."""
    rng = np.random.default_rng(31)
    n_shards = 3
    idx = h.create_index("t")
    cols = np.arange(WIDTH * n_shards)
    ts = idx.create_field("ts", opts(type=ftype.INT, min=0,
                                     max=(1 << 40) - 1))
    tcols = cols[rng.integers(0, 2, size=cols.size) > 0]
    ts.import_values(tcols, TS_BASE + rng.integers(0, 86400, size=tcols.size))
    s = idx.create_field("s", opts(cache_type="none"))
    n = cols.size
    s.import_bits(rng.integers(0, 5, size=n), rng.integers(0, cols.size,
                                                           size=n))
    m = idx.create_field("m", opts(type=ftype.MUTEX))
    mcols = cols[rng.integers(0, 4, size=cols.size) > 0]
    m.import_bits(rng.integers(0, 3, size=mcols.size), mcols)
    a = idx.create_field("a")
    acols = cols[rng.integers(0, 3, size=cols.size) == 0]
    a.import_bits(np.ones(acols.size, np.int64), acols)
    sv = idx.create_field("sv", opts(type=ftype.INT, min=-50, max=50))
    vcols = cols[rng.integers(0, 3, size=cols.size) > 0]
    sv.import_values(vcols, rng.integers(-50, 51, size=vcols.size))
    idx.mark_columns_exist(cols)
    return h


@pytest.fixture(scope="module")
def holders():
    jh = ge._build_holder(width=WIDTH, n_shards=4)
    jd = _dense(JaxHolder(width=WIDTH), JaxFieldOptions, JaxFieldType,
                JaxFieldOptions(type=JaxFieldType.TIME,
                                time_quantum=JaxTimeQuantum("YMD")))
    jc = _categorical(JaxHolder(width=WIDTH), JaxFieldOptions, JaxFieldType)
    jt = _deep(JaxHolder(width=WIDTH), JaxFieldOptions, JaxFieldType)
    return {name: (j, holder_from_state(jax_state(j)))
            for name, j in (("i", jh), ("d", jd), ("c", jc), ("t", jt))}


def _norm_all(results):
    """_norm, plus MinRow/MaxRow's single Pair."""
    return [(r.id, r.count) if hasattr(r, "id") else _norm([r])[0]
            for r in results]


def _jax_loop(jh, index, query):
    ex = JaxExecutor(jh)
    ex.use_stacked = False
    return _norm_all(ex.execute(index, query))


def _port(ph, index, query, use_stacked=False, arm="fused"):
    ex = Executor(ph, device="cpu")
    ex.use_stacked = use_stacked
    ex.stacked.onepass_arm = arm
    return _norm_all(ex.execute(index, query)), ex


_CASES = ([("i", q) for q in QUERIES] + [("d", q) for q in DENSE_QUERIES]
          + GROUPBY_QUERIES)


@pytest.mark.parametrize("pallas", [False, True], ids=["xla", "pallas"])
@pytest.mark.parametrize("index,query", _CASES)
def test_per_shard_engine_matches_jax_loop(holders, monkeypatch, pallas,
                                           index, query):
    if pallas:
        monkeypatch.setenv("PILOSA_TPU_PALLAS", "1")
    jh, ph = holders[index]
    got, ex = _port(ph, index, query)
    assert got == _jax_loop(jh, index, query)
    # (an unfiltered TopN reads the rank caches and takes neither engine)
    assert all(route in ("asked", "only_route") for _call, route in ex.paths)


# the per-shard TopN/TopK scan (one masked_popcount_shards call a query):
# ids= with rows absent everywhere (their count 0 kept), from/to over
# the YMD time field tq (several views a shard, or none), shards= subsets with
# an absent shard, filter trees that build temporaries (Intersect(Row,
# Range)), and the unfiltered scan of a field without rank caches (u)
TOPN_SCAN_QUERIES = [
    ("d", "TopN(s, ids=[0, 2, 5, 7], n=6)", None),
    ("d", "TopK(s, Row(m=1), ids=[1, 3, 9], k=3)", None),
    ("d", "TopN(tq, from='2024-02-01', to='2024-05-01', n=2)", None),
    ("d", "TopK(tq, Row(s=1), from='2024-01-01', to='2024-04-01', k=3)",
     None),
    # a time range that covers no view: every count 0
    ("d", "TopK(tq, Row(s=1), ids=[0, 1, 7], from='2030-01-01', "
     "to='2030-02-01', k=3)", None),
    ("d", "TopN(tq, ids=[2, 3], from='2030-01-01', to='2030-02-01', n=2)",
     [0, 2]),
    ("d", "TopN(tq, from='2030-01-01', to='2030-02-01', n=2)", None),
    ("d", "TopN(s, Row(s=2), n=4)", [0, 2, 9]),
    ("d", "TopN(u, n=3)", [1, 7]),
    ("d", "TopK(u, Intersect(Row(s=3), Row(-50 < v < 400)), k=4)", None),
    ("d", "TopN(u, Intersect(Row(s=1), Row(v > 0)), n=3)", [0, 1]),
    ("i", "TopK(f, Row(g=2), k=5)", [3, 1]),
]


def _pairs(results):
    return [dataclasses.asdict(p) for p in results[0]]


@pytest.mark.parametrize("pallas", [False, True], ids=["xla", "pallas"])
@pytest.mark.parametrize("engine", ["stacked", "per_shard"])
@pytest.mark.parametrize("index,query,shards", TOPN_SCAN_QUERIES)
def test_topn_scan_matches_jax(holders, monkeypatch, pallas, engine, index,
                               query, shards):
    """Both engines equal the JAX executor's same engine, Pair for Pair;
    the per-shard engine counts every shard's candidates in one
    masked_popcount_shards call a query, the stacked engine in none."""
    if pallas:
        monkeypatch.setenv("PILOSA_TPU_PALLAS", "1")
    calls = []
    real = K.masked_popcount_shards

    def counted(tiles, *args, **kwargs):
        calls.append(len(tiles))
        return real(tiles, *args, **kwargs)

    monkeypatch.setattr(K, "masked_popcount_shards", counted)
    jh, ph = holders[index]
    jex = JaxExecutor(jh)
    jex.use_stacked = engine == "stacked"
    ex = Executor(ph, device="cpu")
    ex.use_stacked = engine == "stacked"
    got = _pairs(ex.execute(index, query, shards=shards))
    assert got == _pairs(jex.execute(index, query, shards=shards))
    n_shards = len(ex._shard_list(ph.index(index), shards))
    assert calls == ([] if engine == "stacked" else [n_shards])


@pytest.mark.parametrize("budget_tiles", [4, 9, 100])
@pytest.mark.parametrize("query", [
    "TopN(s, Row(s=2), n=4)", "TopN(u, n=3)",
    "TopK(tq, Row(s=1), from='2024-01-01', to='2024-04-01', k=3)",
    "TopK(s, Row(m=1), ids=[%s], k=5)" % ", ".join(map(str, range(40)))])
def test_topn_scan_batches_shards_past_the_budget(holders, monkeypatch,
                                                  query, budget_tiles):
    """What a launch holds, (rows x views + 1) tiles a shard, stays
    within _ROWS_STACK_BUDGET: past it the scan launches once a batch of
    shards, or once a chunk of rows, with the same answer."""
    calls = []
    real = K.masked_popcount_shards

    def counted(tiles, masks, n_rows, *args):
        calls.append((len(tiles), n_rows, len(tiles[0])))
        return real(tiles, masks, n_rows, *args)

    monkeypatch.setattr(K, "masked_popcount_shards", counted)
    jh, ph = holders["d"]
    jex = JaxExecutor(jh)
    jex.use_stacked = False
    ex = Executor(ph, device="cpu")
    ex.use_stacked = False
    ex._ROWS_STACK_BUDGET = budget_tiles * (ph.width // 32) * 4
    assert _pairs(ex.execute("d", query)) == _pairs(jex.execute("d", query))
    for n_shards, n_rows, n_views in calls:
        assert n_shards * (n_rows * max(1, n_views) + 1) <= budget_tiles
    if budget_tiles < 100:
        assert len(calls) > 1


# the shapes the JAX package answers on its host loops or its decode
# stream: MinRow/MaxRow, set-field Distinct, a depth-40 field's
# Min/Max/Distinct, GroupBy Min/Max over overlapping rows or past depth
# 16, and Count(Distinct)
FALLBACK_QUERIES = [
    "MinRow(field=s)",
    "MaxRow(field=s)",
    "MinRow(Row(a=1), field=s)",
    "MaxRow(Row(m=1), field=s)",
    "Distinct(field=s)",
    "Distinct(Row(a=1), field=s)",
    "Min(field=ts)",
    "Max(Row(a=1), field=ts)",
    "Min(Row(m=0), field=ts)",
    "Distinct(field=ts)",
    "Distinct(Row(m=2), field=ts)",
    "GroupBy(Rows(s), aggregate=Max(field=sv))",
    "GroupBy(Rows(m), Rows(s), aggregate=Min(field=ts))",
    "GroupBy(Rows(m), filter=Row(a=1), aggregate=Max(field=ts))",
    "GroupBy(Rows(m), aggregate=Count(Distinct(field=s)))",
    "GroupBy(Rows(s), aggregate=Count(Distinct(field=sv)))",
    "GroupBy(Rows(m), filter=Row(a=1), "
    "aggregate=Count(Distinct(Row(s=1), field=ts)))",
]


@pytest.mark.parametrize("arm", ["stacked", "per_shard"])
@pytest.mark.parametrize("query", FALLBACK_QUERIES)
def test_fallback_shapes_match_jax(holders, arm, query):
    jh, ph = holders["t"]
    got, _ex = _port(ph, "t", query, use_stacked=arm == "stacked")
    assert got == _jax_loop(jh, "t", query)


def _depth63(h, opts, ftype):
    """An INT field of bit depth 63 (min -2^62, max 2^62) holding 5,
    -2^62 and 7 on three columns, set rows g=0 on the first two and g=1
    on the third; and huge, of depth 64, holding 5, -2^63 and 2^63 - 1."""
    idx = h.create_index("big")
    big = idx.create_field("big", opts(type=ftype.INT, min=-(1 << 62),
                                       max=1 << 62))
    big.import_values(np.array([0, 1, 2]), np.array([5, -(1 << 62), 7]))
    huge = idx.create_field("huge", opts(type=ftype.INT, min=-(1 << 63),
                                         max=(1 << 63) - 1))
    huge.import_values(np.array([0, 1, 2]),
                       np.array([5, -(1 << 63), (1 << 63) - 1]))
    idx.create_field("g").import_bits(np.array([0, 0, 1]), np.array([0, 1, 2]))
    idx.mark_columns_exist(np.array([0, 1, 2]))
    return h


@pytest.fixture(scope="module")
def deep63():
    jh = _depth63(JaxHolder(width=WIDTH), JaxFieldOptions, JaxFieldType)
    return jh, holder_from_state(jax_state(jh))


# the depth-63 GroupBy Min/Max raised "decode_np: depth 63 > 62" on both
# of the port's engines; the JAX loop answers them in int64
DEPTH63_PINNED = {
    "GroupBy(Rows(g), aggregate=Max(field=big))":
        [((("g", 0),), 2, 5, 2), ((("g", 1),), 1, 7, 1)],
    "GroupBy(Rows(g), aggregate=Min(field=big))":
        [((("g", 0),), 2, -(1 << 62), 2), ((("g", 1),), 1, 7, 1)],
}
DEPTH63_QUERIES = list(DEPTH63_PINNED) + [
    "Min(field=big)", "Max(field=big)", "Sum(field=big)",
    "Distinct(field=big)", "Count(Row(big < 0))", "Count(Row(big >= 6))",
    f"Count(Row(big == {-(1 << 62)}))",
    f"Count(Row({-(1 << 62)} <= big <= 5))",
    "Count(Row(huge < 0))", f"Count(Row(huge == {-(1 << 63)}))",
    f"Count(Row(huge > {(1 << 63) - 2}))", "Count(Row(-10 < huge < 10))"]


@pytest.mark.parametrize("arm", ["stacked", "per_shard"])
@pytest.mark.parametrize("query", DEPTH63_QUERIES)
def test_depth63_field_matches_jax(deep63, arm, query):
    jh, ph = deep63
    got, _ex = _port(ph, "big", query, use_stacked=arm == "stacked")
    assert got == _norm_all(JaxExecutor(jh).execute("big", query))
    if query in DEPTH63_PINNED:
        assert got == [DEPTH63_PINNED[query]]


@pytest.mark.parametrize("query,route", [
    ("Min(field=ts)", ("Min", "value_hist_depth")),
    ("Max(Row(a=1), field=ts)", ("Max", "value_hist_depth")),
    ("Distinct(field=ts)", ("Distinct", "value_hist_depth")),
    ("GroupBy(Rows(m), aggregate=Max(field=ts))",
     ("GroupBy", "groupby_minmax")),
    ("GroupBy(Rows(s), aggregate=Min(field=sv))",
     ("GroupBy", "groupby_minmax")),
    ("GroupBy(Rows(m), aggregate=Count(Distinct(field=s)))",
     ("GroupBy", "count_distinct")),
    ("MaxRow(field=s)", ("MaxRow", "only_route")),
    ("Distinct(field=s)", ("Distinct", "unfiltered_set")),
    ("Distinct(Row(a=1), field=s)", ("Distinct", "stacked")),
    ("GroupBy(Rows(m), aggregate=Sum(field=sv))", ("GroupBy", "stacked")),
    ("Min(field=sv)", ("Min", "stacked")),
])
def test_default_executor_counts_each_route(holders, query, route):
    """The default executor takes the per-shard engine only for the
    named shapes, and counts why."""
    _got, ex = _port(holders["t"][1], "t", query, use_stacked=True)
    assert dict(ex.paths) == {route: 1}


def test_per_shard_engine_sees_writes(holders):
    """The per-shard tile cache follows fragment versions."""
    ph = holder_from_state(holder_state(holders["t"][1]))
    ex = Executor(ph, device="cpu")
    ex.use_stacked = False
    q = "TopK(s, Row(a=1), k=5)"
    before = dict((p.id, p.count) for p in ex.execute("t", q)[0])
    a_words = ph.index("t").field("a").views["standard"].fragments[0] \
        .row_words(1)
    s_words = ph.index("t").field("s").views["standard"].fragments[0] \
        .row_words(2)
    col = next(c for c in range(WIDTH) if a_words[c >> 5] >> (c & 31) & 1
               and not s_words[c >> 5] >> (c & 31) & 1)
    ph.index("t").field("s").set_bit(2, col)
    after = dict((p.id, p.count) for p in ex.execute("t", q)[0])
    assert after[2] == before[2] + 1


# -- kernels ------------------------------------------------------------------

def _words(rng, shape):
    x = rng.integers(0, 1 << 32, size=shape, dtype=np.uint32)
    x[..., 3::17] = 0x80000000
    x[..., 5::19] = 0xFFFFFFFF
    return x


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.uint32)
                            .view(np.int32))


@pytest.mark.parametrize("n,w", [(5, 128), (32, 2048), (3, 192)])
def test_masked_popcount_plain_matches_pallas(rng, n, w):
    x, mask = _words(rng, (n, w)), _words(rng, (w,))
    K.reset_launches()
    got = K.masked_popcount(_t(x), _t(mask))
    assert got.dtype == torch.int32 and got.shape == (n,)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jk.masked_popcount(x, mask)))
    assert K.LAUNCHES["masked_popcount"] == 0


def test_masked_popcount_refuses_bad_inputs(rng):
    x = _t(_words(rng, (4, 64)))
    with pytest.raises(ValueError):
        K.masked_popcount(x, x[0, :63].contiguous())
    with pytest.raises(ValueError):
        K.masked_popcount(x[:, ::2], x[0, :32].contiguous())
    with pytest.raises(TypeError):
        K.masked_popcount(x.to(torch.int64), x[0].to(torch.int64))


@pytest.mark.parametrize("signed", [True, False])
@pytest.mark.parametrize("depth", [0, 4])
@pytest.mark.parametrize("cb", [0, 3])
def test_groupby_onehot_plain_matches_pallas(rng, cb, depth, signed):
    s_dim, w = 2, 64
    cp = _words(rng, (s_dim, cb, w))
    valid = _words(rng, (s_dim, w))
    planes = _words(rng, (s_dim, 2 + depth, w)) if depth else None
    n_codes = max(1 << cb, 1)
    got = K.groupby_onehot(_t(cp), _t(valid),
                           None if planes is None else _t(planes),
                           n_codes, signed)
    want = jk.groupby_onehot(cp, valid, planes, n_codes, signed)
    for g, wnt in zip(got, want):
        if g is None:
            assert wnt is None
        else:
            np.testing.assert_array_equal(g.numpy(), np.asarray(wnt))


# the port's one-hot arm against the JAX executor's forced one-hot arm
# (each JAX query compiles its interpret-mode kernel, 5-15 s): GroupBy
# Sum over disjoint fields, unsigned and signed, and the value histogram
ONEHOT_QUERIES = [
    ("c", "GroupBy(Rows(edu), Rows(gen), Rows(dom), aggregate=Sum(field=age))"),
    ("c", "GroupBy(Rows(edu), Rows(dom), aggregate=Sum(field=sv))"),
    ("c", "Distinct(field=age)"),
    ("c", "Min(field=age)"),
]


@pytest.mark.parametrize("index,query", ONEHOT_QUERIES)
def test_onehot_arm_matches_jax_onehot(holders, monkeypatch, index, query):
    monkeypatch.setenv("PILOSA_TPU_GROUPBY_ONEPASS_ARM", "onehot")
    jh, ph = holders[index]
    got, ex = _port(ph, index, query, use_stacked=True, arm="onehot")
    assert got == _norm_all(JaxExecutor(jh).execute(index, query))
    assert all(route == "stacked" for _call, route in ex.paths)


def test_onehot_arm_keeps_minmax_on_fused(holders):
    """A GroupBy Max stays on groupby_fused under the one-hot arm: the
    one-hot histogram has no Min/Max table."""
    K.reset_launches()
    q = "GroupBy(Rows(edu), Rows(gen), aggregate=Max(field=age))"
    onehot, _ = _port(holders["c"][1], "c", q, use_stacked=True, arm="onehot")
    fused, _ = _port(holders["c"][1], "c", q, use_stacked=True)
    assert onehot == fused
    ex = Executor(holders["c"][1], device="cpu")
    ex.stacked.onepass_arm = "xla"
    with pytest.raises(ValueError):
        ex.execute("c", q)
