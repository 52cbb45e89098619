"""The port's Executor.execute against the JAX package's, on the same data.

The data crosses over as a state dict (pilosa_tpu_torch.models.state)
filled from the JAX holder's public attributes; the port runs on the
CPU (device="cpu", the kernels' plain versions).  The JAX side runs
once with its defaults and once with PILOSA_TPU_PALLAS=1, which routes
its hot paths through the Pallas kernels in interpret mode; GroupBy,
Min, Max and Distinct run against its defaults, its forced fused
one-pass arm and its forced per-combo kernel.  All answers are
integers, decimals of integers or column sets: the comparison is
exact."""

import dataclasses
import datetime as dt

import numpy as np
import pytest
import torch

import __graft_entry__ as ge
from pilosa_tpu.executor.executor import Executor as JaxExecutor
from pilosa_tpu.executor.results import Pair as JaxPair
from pilosa_tpu.models.holder import Holder as JaxHolder
from pilosa_tpu.models.schema import FieldOptions as JaxFieldOptions
from pilosa_tpu.models.schema import FieldType as JaxFieldType
from pilosa_tpu.models.schema import TimeQuantum as JaxTimeQuantum
from pilosa_tpu_torch.executor.executor import ExecError, Executor
from pilosa_tpu_torch.executor.results import Pair
from pilosa_tpu_torch.models.holder import Holder
from pilosa_tpu_torch.models.schema import FieldOptions, FieldType, TimeQuantum
from pilosa_tpu_torch.models.state import holder_from_state, holder_state
from pilosa_tpu_torch.ops import kernels as K

# one intra-op thread: these tests share the machine with the rest of
# the suite's workers, several of which time their own work
torch.set_num_threads(1)

QUERIES = ge._DRYRUN_QUERIES + [
    "Count(Row(f=1))",
    "Sum(field=b)",
    "Intersect(Row(f=1), Row(g=2))",
    "Count(Row(b == 7))",
    "Count(Row(b != 7))",
]

# a denser holder built through both packages' import APIs, so the
# counts and sums are far from zero
DENSE_QUERIES = [
    "Count(Intersect(Row(s=1), Row(s=2)))",
    "Count(Union(Row(s=0), Row(s=3), Row(s=5)))",
    "Count(Difference(Row(s=1), Row(s=2), Row(s=3)))",
    "Count(Xor(Row(s=1), Row(s=4)))",
    "Count(Intersect(Row(s=1), Row(s=2), Row(s=3)))",
    "Count(Not(Union(Row(s=1), Row(s=2))))",
    "Count(All())",
    "Shift(Row(s=2), n=33)",
    "Count(Row(v >= -20))",
    "Count(Row(v < 17))",
    "Count(Row(-100 <= v <= 100))",
    "Count(Row(v == null))",
    "Row(v != null)",
    "Count(Row(v > 5000))",
    "Sum(field=v)",
    "Sum(Union(Row(s=1), Row(s=2)), field=v)",
    "Sum(Row(s=9), field=v)",
    "Sum(field=dec)",
    "Count(Row(dec > 1.25))",
    "TopN(s, n=4)",
    "TopN(s, Row(s=2), n=4)",
    "TopN(s, Intersect(Row(s=1), Row(v > 0)), n=3)",
    "TopN(u, n=3)",
    "TopN(u, Row(s=0), n=3)",
    "TopK(s, k=2)",
    "Count(Row(tq=1, from='2024-02-01', to='2024-05-01'))",
    "Count(Row(m=2))",
    "Count(Row(s=1))Count(Row(s=2))",
]


# GroupBy, Min, Max and Distinct: Sum/Min/Max aggregates, filter=,
# having=, limit=, previous=, signed values (v, dec), overlapping rows
# (s, u, f) and mutex rows (m)
GROUPBY_QUERIES = [
    ("i", "GroupBy(Rows(f), Rows(g), aggregate=Sum(field=b))"),
    ("i", "GroupBy(Rows(f))"),
    ("i", "Min(field=b)"),
    ("i", "Max(field=b)"),
    ("i", "Distinct(field=b)"),
    ("d", "GroupBy(Rows(s))"),
    ("d", "GroupBy(Rows(s), Rows(m), aggregate=Sum(field=v))"),
    ("d", "GroupBy(Rows(m), aggregate=Sum(field=v))"),
    ("d", "GroupBy(Rows(m), aggregate=Max(field=v))"),
    ("d", "GroupBy(Rows(m), aggregate=Min(field=v))"),
    ("d", "GroupBy(Rows(m), Rows(s), filter=Row(v > 0), "
          "aggregate=Sum(field=dec))"),
    ("d", "GroupBy(Rows(s), Rows(u), having=Condition(count > 3), limit=5)"),
    ("d", "GroupBy(Rows(s), Rows(m), previous=[2, 1], "
          "aggregate=Sum(field=v))"),
    ("d", "GroupBy(Rows(s, previous=1, limit=3), Rows(m))"),
    ("d", "GroupBy(Rows(m), aggregate=Sum(field=v), "
          "having=Condition(sum > 0))"),
    ("d", "GroupBy(Rows(m), filter=Row(s=9), aggregate=Sum(field=v))"),
    ("d", "Min(field=v)"),
    ("d", "Max(Row(s=2), field=v)"),
    ("d", "Max(field=v)"),
    ("d", "Min(Row(s=7), field=v)"),
    ("d", "Distinct(Row(s=3), field=v)"),
    ("c", "GroupBy(Rows(edu), Rows(gen), Rows(dom), aggregate=Sum(field=age))"),
    ("c", "GroupBy(Rows(gen), Rows(dom), aggregate=Sum(field=age))"),
    ("c", "GroupBy(Rows(edu), Rows(gen), Rows(dom), Rows(reg), "
          "aggregate=Sum(field=age))"),
    ("c", "GroupBy(Rows(edu), Rows(gen), filter=Row(a=1), "
          "aggregate=Sum(field=age))"),
    ("c", "GroupBy(Rows(edu), Rows(gen), aggregate=Max(field=age))"),
    ("c", "GroupBy(Rows(dom), Rows(reg), aggregate=Min(field=sv))"),
    ("c", "GroupBy(Rows(edu), Rows(dom), aggregate=Sum(field=sv))"),
    ("c", "GroupBy(Rows(gen), Rows(a), aggregate=Sum(field=age))"),
    ("c", "Min(field=age)"),
    ("c", "Max(Row(a=1), field=age)"),
    ("c", "Distinct(field=age)"),
    ("c", "Distinct(Row(gen=1), field=sv)"),
]


def jax_state(h) -> dict:
    """The state dict, filled from the JAX holder's public attributes."""
    out = {"width": h.width, "indexes": {}}
    for iname, idx in h.indexes.items():
        fields = {}
        for fname, f in idx.fields.items():
            fields[fname] = {
                "options": f.options.to_dict(), "bit_depth": f.bit_depth,
                "views": {vn: {s: {r: np.array(fr.row_words(r))
                                   for r in fr.row_ids}
                               for s, fr in v.fragments.items()}
                          for vn, v in f.views.items()}}
        out["indexes"][iname] = {"keys": idx.keys,
                                 "track_existence": idx.track_existence,
                                 "fields": fields}
    return out


def _dense(h, opts, ftype, tq_opts):
    """Same seeded recipe for either package's Holder."""
    rng = np.random.default_rng(11)
    width, n_shards = h.width, 3
    idx = h.create_index("d")
    s = idx.create_field("s")
    u = idx.create_field("u", opts(cache_type="none"))
    v = idx.create_field("v", opts(type=ftype.INT, min=-1000, max=1000))
    dec = idx.create_field("dec", opts(type=ftype.DECIMAL, scale=2,
                                       min=-10000, max=10000))
    m = idx.create_field("m", opts(type=ftype.MUTEX))
    tq = idx.create_field("tq", tq_opts)
    n = 900 * n_shards
    cols = rng.integers(0, width * n_shards, size=n)
    s.import_bits(rng.integers(0, 6, size=n), cols)
    u.import_bits(rng.integers(0, 5, size=n),
                  rng.integers(0, width * n_shards, size=n))
    vcols = rng.integers(0, width * n_shards, size=n // 2)
    v.import_values(vcols, rng.integers(-1000, 1001, size=vcols.size))
    dcols = rng.integers(0, width * n_shards, size=200)
    dec.import_values(dcols, rng.integers(-10000, 10001, size=200))
    m.import_bits(rng.integers(0, 4, size=400),
                  rng.integers(0, width * n_shards, size=400))
    for i, c in enumerate(cols[:300].tolist()):
        tq.set_bit(1, c, timestamp=dt.datetime(2024, 1 + (i % 6), 1 + i % 20))
    idx.mark_columns_exist(np.concatenate([cols, vcols]))
    return h


def _categorical(h, opts, ftype):
    """The able shape at small size: disjoint categorical fields edu,
    gen, dom, reg (a digit >= R means absent), an overlapping set field
    a, an unsigned BSI age and a signed BSI sv."""
    rng = np.random.default_rng(23)
    width, n_shards = h.width, 3
    idx = h.create_index("c")
    cols = np.arange(width * n_shards)
    for name, n, spread in (("edu", 6, 8), ("gen", 2, 2), ("dom", 5, 8),
                            ("reg", 4, 4)):
        digit = rng.integers(0, spread, size=cols.size)
        keep = digit < n
        idx.create_field(name).import_bits(digit[keep], cols[keep])
    a = idx.create_field("a")
    pick = rng.integers(0, 2, size=cols.size).astype(bool)
    a.import_bits(np.ones(int(pick.sum()), np.int64), cols[pick])
    age = idx.create_field("age", opts(type=ftype.INT, min=0, max=127))
    age.import_values(cols, rng.integers(0, 128, size=cols.size))
    sv = idx.create_field("sv", opts(type=ftype.INT, min=-100, max=100))
    vcols = cols[rng.integers(0, 3, size=cols.size) > 0]
    sv.import_values(vcols, rng.integers(-100, 101, size=vcols.size))
    return h


def _norm(results):
    out = []
    for r in results:
        if isinstance(r, list) and r and hasattr(r[0], "group"):
            out.append([(tuple((g["field"], g["row_id"]) for g in gc.group),
                         gc.count, gc.agg, gc.agg_count) for gc in r])
        elif type(r).__name__ in ("SortedRow", "ExtractedTable"):
            out.append(dataclasses.asdict(r))
        elif hasattr(r, "values") and not callable(r.values):
            out.append(list(r.values))
        elif hasattr(r, "columns"):
            out.append(r.columns().tolist())
        elif isinstance(r, list) and all(isinstance(x, int) for x in r):
            out.append(list(r))                     # Rows: row ids
        elif isinstance(r, list):
            out.append([(p.id, p.count) for p in r])
        elif hasattr(r, "value"):
            out.append((r.value, r.count))
        else:
            out.append(r)
    return out


@pytest.fixture(scope="module")
def holders():
    jh = ge._build_holder(width=2048, n_shards=4)
    jd = _dense(JaxHolder(width=2048), JaxFieldOptions, JaxFieldType,
                JaxFieldOptions(type=JaxFieldType.TIME,
                                time_quantum=JaxTimeQuantum("YMD")))
    jc = _categorical(JaxHolder(width=2048), JaxFieldOptions, JaxFieldType)
    return {"i": (jh, holder_from_state(jax_state(jh))),
            "d": (jd, holder_from_state(jax_state(jd))),
            "c": (jc, holder_from_state(jax_state(jc)))}


_CASES = [("i", q) for q in QUERIES] + [("d", q) for q in DENSE_QUERIES]


@pytest.mark.parametrize("pallas", [False, True], ids=["xla", "pallas"])
@pytest.mark.parametrize("index,query", _CASES)
def test_execute_matches_jax(holders, monkeypatch, pallas, index, query):
    if pallas:
        monkeypatch.setenv("PILOSA_TPU_PALLAS", "1")
    jh, ph = holders[index]
    want = _norm(JaxExecutor(jh).execute(index, query))
    got = _norm(Executor(ph, device="cpu").execute(index, query))
    assert got == want


def test_pair_has_the_jax_fields():
    """Pair(id, key, count), in the JAX package's order, so a positional
    Pair(5, None, 12) means the same in both packages."""
    names = [f.name for f in dataclasses.fields(Pair)]
    assert names == [f.name for f in dataclasses.fields(JaxPair)]
    assert names == ["id", "key", "count"]
    assert dataclasses.asdict(Pair(5, None, 12)) == \
        dataclasses.asdict(JaxPair(5, None, 12))


_TOPN_CASES = [(i, q) for i, q in _CASES if q.startswith("Top")]


@pytest.mark.parametrize("engine", ["stacked", "per_shard"])
@pytest.mark.parametrize("index,query", _TOPN_CASES)
def test_topn_pairs_asdict_match_jax(holders, engine, index, query):
    """TopN/TopK answers as dicts, key included (None: unkeyed), equal
    to the JAX executor's on the same engine."""
    jh, ph = holders[index]
    jex = JaxExecutor(jh)
    jex.use_stacked = engine == "stacked"
    ex = Executor(ph, device="cpu")
    ex.use_stacked = engine == "stacked"
    got = [dataclasses.asdict(p) for p in ex.execute(index, query)[0]]
    assert got == [dataclasses.asdict(p) for p in jex.execute(index, query)[0]]
    assert got and all(p["key"] is None for p in got)


# Range rows: every comparison and sign regime (signed v and dec, the
# unsigned age), and the plan-time short cuts that need no comparator
RANGE_QUERIES = [
    ("d", "Count(Row(v >= -20))", True),
    ("d", "Count(Row(v > 20))", True),
    ("d", "Count(Row(v < -17))", True),
    ("d", "Count(Row(v <= 17))", True),
    ("d", "Count(Row(v == -7))", True),
    ("d", "Count(Row(v != 7))", True),
    ("d", "Row(v == 0)", True),
    ("d", "Count(Row(-100 <= v <= 100))", True),
    ("d", "Count(Row(20 < v < 300))", True),
    ("d", "Count(Row(-300 <= v < -2))", True),
    ("d", "Count(Row(dec > 1.25))", True),
    ("d", "Count(Row(dec < -3.5))", True),
    ("d", "Count(Intersect(Row(v > 0), Row(s=1)))", True),
    ("c", "Count(Row(age >= 64))", True),
    ("c", "Count(Row(age < 64))", True),
    ("c", "Count(Row(10 < age < 100))", True),
    ("c", "Count(Row(-5 < sv <= 5))", True),
    ("d", "Count(Row(v > 5000))", False),
    ("d", "Count(Row(v < 5000))", False),
    ("d", "Count(Row(v == 2.5))", False),
    ("d", "Count(Row(300 < v < 20))", False),
    ("d", "Count(Row(v == null))", False),
    ("d", "Count(Row(v != null))", False),
]


@pytest.mark.parametrize("engine", ["stacked", "per_shard"])
@pytest.mark.parametrize("index,query,compares", RANGE_QUERIES)
def test_range_rows_go_through_bsi_range(holders, monkeypatch, engine, index,
                                         query, compares):
    """Both engines answer a Range row through kernels.bsi_range, once
    for the stack or once a shard (three shards here), and equal the JAX
    executor; a short cut planned on the host launches none."""
    calls = []
    real = K.bsi_range

    def counted(*args, **kwargs):
        calls.append(args[1])
        return real(*args, **kwargs)

    monkeypatch.setattr(K, "bsi_range", counted)
    jh, ph = holders[index]
    ex = Executor(ph, device="cpu")
    ex.use_stacked = engine == "stacked"
    got = _norm(ex.execute(index, query))
    assert got == _norm(JaxExecutor(jh).execute(index, query))
    assert len(calls) == (0 if not compares else
                          1 if engine == "stacked" else 3)


# the JAX package's GroupBy arms: its defaults (the host histogram
# and the XLA per-combo scan on the CPU), its fused one-pass Pallas
# kernel and its per-combo Pallas kernel, both in interpret mode
_JAX_GROUPBY_ARMS = {
    "default": {},
    "fused": {"PILOSA_TPU_GROUPBY_ONEPASS_ARM": "fused"},
    "kernel": {"PILOSA_TPU_GROUPBY_KERNEL": "1"},
}


@pytest.mark.parametrize("arm", list(_JAX_GROUPBY_ARMS))
@pytest.mark.parametrize("index,query", GROUPBY_QUERIES)
def test_groupby_minmax_distinct_match_jax(holders, monkeypatch, arm, index,
                                           query):
    for k, v in _JAX_GROUPBY_ARMS[arm].items():
        monkeypatch.setenv(k, v)
    jh, ph = holders[index]
    want = _norm(JaxExecutor(jh).execute(index, query))
    got = _norm(Executor(ph, device="cpu").execute(index, query))
    assert got == want


def test_groupby_sees_writes(holders):
    """The group-code stack and the disjointness cache follow fragment
    versions: a write between two GroupBys shows in the second."""
    ph = holder_from_state(holder_state(holders["c"][1]))
    ex = Executor(ph, device="cpu")
    q = "GroupBy(Rows(gen), Rows(dom), aggregate=Sum(field=age))"
    before = {tuple(g["row_id"] for g in gc.group): (gc.count, gc.agg)
              for gc in ex.execute("c", q)[0]}
    idx = ph.index("c")

    def has(fname, row, c):
        words = idx.field(fname).views["standard"].fragments[0].row_words(row)
        return bool(words[c >> 5] >> (c & 31) & 1)

    # a column of gen row 1 in no dom row: dom stays disjoint
    col = next(c for c in range(ph.width)
               if has("gen", 1, c) and not any(has("dom", r, c)
                                               for r in range(5)))
    idx.field("dom").import_bits([0], [col])
    after = {tuple(g["row_id"] for g in gc.group): (gc.count, gc.agg)
             for gc in ex.execute("c", q)[0]}
    assert after[(1, 0)][0] == before[(1, 0)][0] + 1


def _same_state(a, b):
    assert a["width"] == b["width"]
    assert a["indexes"].keys() == b["indexes"].keys()
    for iname, ia in a["indexes"].items():
        ib = b["indexes"][iname]
        assert (ia["keys"], ia["track_existence"]) == \
            (ib["keys"], ib["track_existence"])
        assert ia["fields"].keys() == ib["fields"].keys()
        for fname, fa in ia["fields"].items():
            fb = ib["fields"][fname]
            assert fa["options"] == fb["options"], fname
            assert fa["bit_depth"] == fb["bit_depth"], fname
            assert fa["views"].keys() == fb["views"].keys(), fname
            for vn, sa in fa["views"].items():
                sb = fb["views"][vn]
                assert sa.keys() == sb.keys(), (fname, vn)
                for shard, ra in sa.items():
                    rb = sb[shard]
                    assert ra.keys() == rb.keys(), (fname, vn, shard)
                    for r in ra:
                        np.testing.assert_array_equal(ra[r], rb[r])


def test_port_import_api_builds_the_same_holder(holders):
    """_build_holder's recipe through the port's own model API gives
    the state the JAX holder carries across."""
    rng = np.random.default_rng(0)
    width, n_shards = 2048, 4
    h = Holder(width=width)
    idx = h.create_index("i")
    f = idx.create_field("f")
    g = idx.create_field("g")
    b = idx.create_field("b", FieldOptions(type=FieldType.INT,
                                           min=-1000, max=1000))
    tq = idx.create_field("tq", FieldOptions(
        type=FieldType.TIME, time_quantum=TimeQuantum("YMD")))
    n = 64 * n_shards
    cols = rng.integers(0, width * n_shards, size=n)
    f.import_bits(rng.integers(0, 8, size=n), cols)
    g.import_bits(rng.integers(0, 8, size=n),
                  rng.integers(0, width * n_shards, size=n))
    vcols = np.unique(rng.integers(0, width * n_shards, size=n))
    b.import_values(vcols, rng.integers(-1000, 1000, size=vcols.size))
    for i, c in enumerate(cols[:n // 2].tolist()):
        tq.set_bit(i % 3, c, timestamp=dt.datetime(2024, 1 + (i % 6), 15))
    idx.mark_columns_exist(list(cols))
    _same_state(holder_state(h), holder_state(holders["i"][1]))
    _same_state(holder_state(holders["i"][1]), jax_state(holders["i"][0]))


def test_dense_import_api_builds_the_same_holder(holders):
    h = _dense(Holder(width=2048), FieldOptions, FieldType,
               FieldOptions(type=FieldType.TIME,
                            time_quantum=TimeQuantum("YMD")))
    _same_state(holder_state(h), jax_state(holders["d"][0]))


def test_state_round_trip(holders):
    st = holder_state(holders["d"][1])
    _same_state(holder_state(holder_from_state(st)), st)


@pytest.mark.parametrize("query", [
    "Row(f='key')", "Set(1, f=1)", "Clear(1, f=1)", "ClearRow(f=1)",
    "Delete(Row(f=1))", "Store(Row(f=1), g=9)", "Rows(f, like='k%')",
    "Rows(f, previous='k')", "Rows(f, column='c')",
    "Extract(ConstRow(columns=['c']), Rows(f))"])
def test_keys_and_writes_on_an_unkeyed_index_match_jax(query):
    """String row and column keys, Rows(like=) and the write calls on an
    unkeyed index: each answers as the JAX executor does, or raises the
    ExecError it raises, with its message; after a write, both packages
    read the written fields alike.  Fresh holders a case, since some
    write."""
    jh = ge._build_holder(width=2048, n_shards=4)
    ph = holder_from_state(jax_state(jh))
    ex = Executor(ph, device="cpu")
    try:
        want = _norm(JaxExecutor(jh).execute("i", query))
    except Exception as e:  # noqa: BLE001 - the JAX ExecError class
        assert type(e).__name__ == "ExecError"
        with pytest.raises(ExecError) as got:
            ex.execute("i", query)
        assert str(got.value) == str(e)
        return
    assert _norm(ex.execute("i", query)) == want
    after = "Count(Row(f=1))Count(Row(g=9))Count(All())"
    assert _norm(ex.execute("i", after)) == \
        _norm(JaxExecutor(jh).execute("i", after))


@pytest.mark.parametrize("pallas", [False, True], ids=["xla", "pallas"])
@pytest.mark.parametrize("engine", ["stacked", "per_shard"])
@pytest.mark.parametrize("query", [
    "Sort(Row(f=1), field=b)", "Sort(All(), field=b, limit=9, offset=2)",
    "Percentile(field=b, nth=50)", "Extract(All(), Rows(f))",
    "Extract(Sort(All(), field=b, sort-desc=true, limit=6), Rows(b), "
    "Rows(tq))", "Rows(f)"])
def test_formerly_unported_calls_match_jax(holders, monkeypatch, pallas,
                                           engine, query):
    """The calls that raised "not ported yet" before the read surface
    was ported, on both engines, equal to the JAX executor."""
    if pallas:
        monkeypatch.setenv("PILOSA_TPU_PALLAS", "1")
    jh, ph = holders["i"]
    ex = Executor(ph, device="cpu")
    ex.use_stacked = engine == "stacked"
    assert _norm(ex.execute("i", query)) == \
        _norm(JaxExecutor(jh).execute("i", query))


@pytest.mark.parametrize("query", [
    "Max(field=dec)",                                  # depth 20 > 19
    "Distinct(field=dec)",
    "GroupBy(Rows(m), aggregate=Min(field=dec))",      # depth 20 > 16
    "GroupBy(Rows(s), aggregate=Max(field=v))",        # overlapping rows
    "Distinct(field=s)",                               # set field
])
def test_host_fallbacks_not_ported_yet_raise(holders, query):
    """What the JAX package answers with its host loops (the per-shard
    Min/Max walk, the decode stream, set-field Distinct) no longer
    raises: the default executor routes it to the per-shard engine (or
    the decode stream) and answers as the JAX package does."""
    jh, ph = holders["d"]
    want = _norm(JaxExecutor(jh).execute("d", query))
    assert _norm(Executor(ph, device="cpu").execute("d", query)) == want


def test_writes_are_seen_by_the_next_query(holders):
    """The device-stack cache patches a stack when a fragment's version
    moves."""
    ph = holder_from_state(holder_state(holders["d"][1]))
    ex = Executor(ph, device="cpu")
    before = ex.execute("d", "Count(Row(s=1))")[0]
    col = next(c for c in range(ph.width)
               if not ph.index("d").field("s").views["standard"]
               .fragments[0].row_words(1)[c >> 5] >> (c & 31) & 1)
    ph.index("d").field("s").set_bit(1, col)
    assert ex.execute("d", "Count(Row(s=1))")[0] == before + 1
