"""The port's PQL read surface against the JAX package, on the same data.

Options, Rows, UnionRows, IncludesColumn, Limit, FieldValue,
Percentile, Sort, Extract and ConstRow, and Distinct, UnionRows and
ConstRow nested as bitmap operands (the cross-index Distinct join
among them), on both of the port's engines (the stacked default and
``use_stacked = False``), held to the JAX Executor with its defaults
and with PILOSA_TPU_PALLAS=1 (its Pallas kernels in interpret mode).
The port runs on the CPU (device="cpu": the kernels' plain versions).
Dataclass results compare as ``dataclasses.asdict``, rows as their
column lists: every comparison is exact."""

import dataclasses
import datetime as dt

import numpy as np
import pytest
import torch

from pilosa_tpu.executor.executor import Executor as JaxExecutor
from pilosa_tpu.models.holder import Holder as JaxHolder
from pilosa_tpu.models.schema import FieldOptions as JaxFieldOptions
from pilosa_tpu.models.schema import FieldType as JaxFieldType
from pilosa_tpu.models.schema import TimeQuantum as JaxTimeQuantum
from pilosa_tpu_torch.executor.executor import ExecError, Executor
from pilosa_tpu_torch.executor.results import ExtractedTable, SortedRow
from pilosa_tpu_torch.models.state import holder_from_state
from pilosa_tpu_torch.ops import kernels as K
from tests.test_torch_executor import jax_state

# one intra-op thread: these tests share the machine with the rest of
# the suite's workers, several of which time their own work
torch.set_num_threads(1)

WIDTH = 2048
N_SHARDS = 4                  # shards 0-3 hold the data
NCOLS = WIDTH * N_SHARDS
DEEP_BASE = 1 << 39
TS0 = 1_700_000_000           # epoch seconds


def _surface(h, opts, ftype, tq_opts):
    """Index r: a filter row a, overlapping set rows s (two rows with
    ids past the data, so a nested Distinct sets bits in shards 4 and
    5), mutex m, bool bl, time tq, INT v with heavy ties and negatives,
    DECIMAL dec, TIMESTAMP ts, a depth-40 INT deep, an INT empty with
    no value, a depth-63 INT big and a depth-64 INT huge.  Index o: INT
    userid holding column ids of r (some negative, some past r's data),
    INT price, a set field cat and a DECIMAL dd."""
    rng = np.random.default_rng(17)
    idx = h.create_index("r")
    cols = np.arange(NCOLS)
    a = idx.create_field("a")
    acols = cols[rng.random(NCOLS) < 0.4]
    a.import_bits(np.ones(acols.size, np.int64), acols)
    s = idx.create_field("s")
    n = 3000
    s.import_bits(rng.integers(0, 6, size=n), rng.integers(0, NCOLS, size=n))
    s.import_bits(np.array([9000, 9000, 12000]), np.array([3, 4100, 5]))
    m = idx.create_field("m", opts(type=ftype.MUTEX))
    mcols = cols[rng.random(NCOLS) < 0.7]
    m.import_bits(rng.integers(0, 4, size=mcols.size), mcols)
    bl = idx.create_field("bl", opts(type=ftype.BOOL))
    bcols = cols[rng.random(NCOLS) < 0.5]
    bl.import_bits(rng.integers(0, 2, size=bcols.size), bcols)
    tq = idx.create_field("tq", tq_opts)
    tcols = rng.integers(0, NCOLS, size=300)
    for i, c in enumerate(tcols.tolist()):
        tq.set_bit(i % 4, c, timestamp=dt.datetime(2024, 1 + i % 6,
                                                   1 + i % 25))
    v = idx.create_field("v", opts(type=ftype.INT, min=-1000, max=1000))
    vcols = cols[rng.random(NCOLS) < 0.6]
    vv = rng.integers(-6, 7, size=vcols.size)
    vv[:5] = [-1000, 1000, -999, 999, 0]
    v.import_values(vcols, vv)
    dec = idx.create_field("dec", opts(type=ftype.DECIMAL, scale=2,
                                       min=-100000, max=100000))
    dcols = rng.choice(NCOLS, size=900, replace=False)
    dec.import_values(dcols, [f"{x / 100:.2f}" for x in
                              rng.integers(-2000, 2001, size=dcols.size)])
    ts = idx.create_field("ts", opts(type=ftype.TIMESTAMP))
    tscols = rng.choice(NCOLS, size=700, replace=False)
    ts.import_values(tscols, (TS0 + rng.integers(0, 86400 * 30,
                                                 size=tscols.size)).tolist())
    deep = idx.create_field("deep", opts(type=ftype.INT, min=-(1 << 40),
                                         max=(1 << 40) - 1))
    dpcols = cols[rng.random(NCOLS) < 0.5]
    sign = np.where(rng.random(dpcols.size) < 0.3, -1, 1)
    deep.import_values(dpcols, sign * (DEEP_BASE + rng.integers(
        0, 40, size=dpcols.size)))
    idx.create_field("empty", opts(type=ftype.INT, min=0, max=100))
    big = idx.create_field("big", opts(type=ftype.INT, min=-(1 << 62),
                                       max=1 << 62))
    big.import_values(np.array([1, 2, 4097]),
                      np.array([5, -(1 << 62), (1 << 62) - 3]))
    huge = idx.create_field("huge", opts(type=ftype.INT, min=-(1 << 63),
                                         max=(1 << 63) - 1))
    huge.import_values(np.array([0, 1, 2, 4100, 6000, 6001]),
                       np.array([5, -(1 << 63), (1 << 63) - 1, -7, 5,
                                 (1 << 63) - 2], dtype=object))
    idx.mark_columns_exist(cols)

    o = h.create_index("o")
    ocols = np.arange(2 * WIDTH)
    uid = o.create_field("userid", opts(type=ftype.INT, min=-100,
                                        max=20000))
    uvals = rng.integers(0, NCOLS, size=ocols.size)
    uvals[:4] = [-5, -1, 9000, 15000]
    uid.import_values(ocols, uvals)
    price = o.create_field("price", opts(type=ftype.INT, min=0, max=100))
    price.import_values(ocols, rng.integers(0, 101, size=ocols.size))
    o.create_field("cat").import_bits(rng.integers(0, 3, size=ocols.size),
                                      ocols)
    o.create_field("dd", opts(type=ftype.DECIMAL, scale=1, min=0,
                              max=1000)).import_values(ocols[:50],
                                                       ["1.5"] * 50)
    o.mark_columns_exist(ocols)
    return h


@pytest.fixture(scope="module")
def holders():
    jh = _surface(JaxHolder(width=WIDTH), JaxFieldOptions, JaxFieldType,
                  JaxFieldOptions(type=JaxFieldType.TIME,
                                  time_quantum=JaxTimeQuantum("YMD")))
    return jh, holder_from_state(jax_state(jh))


QUERIES = [
    # Percentile: nth 0/1/50/99/100, filters, negatives, decimal,
    # timestamp, an empty field, a depth-40 field (Min/Max past the
    # value histogram's depth)
    "Percentile(field=v, nth=0)",
    "Percentile(field=v, nth=1)",
    "Percentile(field=v, nth=50)",
    "Percentile(field=v, nth=99)",
    "Percentile(field=v, nth=100)",
    "Percentile(field=v, nth=50, filter=Row(a=1))",
    "Percentile(field=v, nth=25, filter=Row(m=2))",
    "Percentile(field=dec, nth=50)",
    "Percentile(field=dec, nth=90, filter=Row(a=1))",
    "Percentile(field=ts, nth=50)",
    "Percentile(field=ts, nth=10)",
    "Percentile(field=empty, nth=50)",
    "Percentile(field=deep, nth=50)",
    "Percentile(field=deep, nth=70, filter=Row(a=1))",
    "Percentile(field=v, nth=50, filter=Row(s=9000))",
    # Sort: asc/desc, ties, negatives, offset/limit, filters, depth 40
    "Sort(Row(a=1), field=v)",
    "Sort(Row(a=1), field=v, limit=10)",
    "Sort(Row(a=1), field=v, sort-desc=true, limit=10, offset=5)",
    "Sort(All(), field=v, offset=50, limit=100)",
    "Sort(All(), field=v, sort-desc=true, offset=1500, limit=300)",
    "Sort(Row(m=1), field=dec, sort-desc=true)",
    "Sort(Row(a=1), field=deep, limit=20)",
    "Sort(Row(a=1), field=deep, sort-desc=true, limit=20, offset=7)",
    "Sort(Row(m=0), field=ts, limit=7, offset=3)",
    "Sort(field=v, limit=5)",
    "Sort(Row(a=1), field=v, offset=100000)",
    "Sort(Row(a=1), field=empty, limit=3)",
    "Sort(Intersect(Row(a=1), Row(v < 0)), field=v, sort-desc=true, "
    "limit=40)",
    # Sort of a depth-64 field (-2^63 and 2^63 - 1 among its values):
    # decoded on the host in Python ints on both engines
    "Sort(field=huge)",
    "Sort(All(), field=huge, sort-desc=true, limit=3, offset=1)",
    "Sort(Row(a=1), field=huge)",
    "Sort(ConstRow(columns=[1, 2, 6000, 6001]), field=huge, sort-desc=true)",
    "Extract(Sort(field=huge, sort-desc=true, limit=4), Rows(huge))",
    # Limit: a limit spanning shards, offsets past the end, no limit
    "Limit(Row(a=1), limit=3000, offset=500)",
    "Limit(Row(a=1), offset=100000)",
    "Limit(Row(a=1), limit=5)",
    "Limit(Row(a=1), offset=2500)",
    "Limit(Union(Row(s=1), Row(m=2)), limit=10, offset=1500)",
    "Limit(Row(s=9000), limit=0)",
    # negative limits and offsets: Python's slice of the whole order
    "Sort(Row(a=1), field=v, limit=-1)",
    "Sort(Row(a=1), field=v, sort-desc=true, limit=-3)",
    "Sort(Row(a=1), field=v, offset=-2, limit=3)",
    "Limit(Row(a=1), offset=-3)",
    "Limit(Row(a=1), limit=-1)",
    "Limit(Row(a=1), limit=3, offset=-5)",
    # Extract: bool, mutex, set, time and BSI fields; Sort as the filter
    "Extract(Limit(Row(a=1), limit=40, offset=800), Rows(bl), Rows(m), "
    "Rows(s), Rows(tq), Rows(v), Rows(dec), Rows(ts), Rows(deep))",
    "Extract(Sort(Row(a=1), field=v, sort-desc=true, limit=25), Rows(v), "
    "Rows(bl), Rows(m))",
    "Extract(ConstRow(columns=[0, 1, 2, 5, 2049, 4097, 9000]), Rows(s), "
    "Rows(v), Rows(big))",
    "Extract(Row(s=2), Rows(m), Rows(bl))",
    "Extract(Sort(Row(m=3), field=deep, limit=15), Rows(deep), Rows(s))",
    # Rows: column=, previous=, limit=, from/to
    "Rows(s)",
    "Rows(s, column=3)",
    "Rows(s, previous=2)",
    "Rows(s, limit=3)",
    "Rows(s, previous=1, limit=2)",
    "Rows(tq)",
    "Rows(tq, from='2024-02-01', to='2024-04-01')",
    "Rows(m, column=4100)",
    # UnionRows, top level and nested
    "UnionRows(Rows(s))",
    "UnionRows(Rows(s, limit=2), Rows(m))",
    "UnionRows(Rows(tq, from='2024-02-01', to='2024-04-01'))",
    "Count(UnionRows(Rows(m), Rows(bl)))",
    "Count(Intersect(Row(a=1), UnionRows(Rows(m))))",
    "Count(Difference(UnionRows(Rows(s)), Row(a=1)))",
    # nested Distinct (set field, rows past the data), the cross-index
    # join (negative foreign values dropped, some past r's data)
    "Count(Intersect(Row(a=1), Distinct(field=s)))",
    "Union(Row(s=3), Distinct(field=s))",
    "Count(Union(Row(a=1), Distinct(Row(a=1), field=s)))",
    "Count(Intersect(Row(a=1), Distinct(Row(price > 10), index=o, "
    "field=userid)))",
    "Union(Row(s=1), Distinct(index=o, field=userid))",
    "Count(Distinct(Row(price < 5), index=o, field=userid))",
    "TopN(m, Distinct(index=o, field=userid), n=3)",
    "Sum(Distinct(Row(price > 50), index=o, field=userid), field=v)",
    # ConstRow spanning shards, in shards with no data
    "ConstRow(columns=[1, 2050, 4200, 16000])",
    "Count(Intersect(Row(a=1), ConstRow(columns=[0, 1, 2, 3, 2048, "
    "4099, 6200])))",
    "Count(Union(Row(a=1), ConstRow(columns=[16000, 16001, 1])))",
    "Not(Union(Row(s=1), ConstRow(columns=[16000])))",
    "Options(ConstRow(columns=[1, 16000]), shards=[0])",
    # IncludesColumn (outside shards= too) and FieldValue
    "IncludesColumn(Row(s=9000), column=4100)",
    "IncludesColumn(Row(s=9000), column=4101)",
    "Options(IncludesColumn(Row(s=9000), column=4100), shards=[0, 1])",
    "IncludesColumn(ConstRow(columns=[16000]), column=16000)",
    "IncludesColumn(Distinct(field=s), column=12000)",
    "FieldValue(field=big, column=1)",
    "FieldValue(field=big, column=2)",
    "FieldValue(field=big, column=4097)",
    "FieldValue(field=big, column=3)",
    "FieldValue(field=dec, column=16000)",
    "FieldValue(field=v, column=0)",
    # Options
    "Options(Count(Row(a=1)), shards=[0, 3])",
    "Options(Sort(Row(a=1), field=v, limit=8), shards=[1])",
    "Options(Percentile(field=v, nth=50), shards=[2, 3])",
]

# one FieldValue for every column of dec and ts holding a value, and
# one unset
_FIELD_VALUE_COLS = [0, 1, 2, 3, 100, 2048, 5000, 8191]


def _norm(results):
    out = []
    for r in results:
        if dataclasses.is_dataclass(r):
            out.append((type(r).__name__, dataclasses.asdict(r)))
        elif hasattr(r, "segments"):
            out.append(("row", r.columns().tolist()))
        elif isinstance(r, list) and r and dataclasses.is_dataclass(r[0]):
            out.append([dataclasses.asdict(p) for p in r])
        else:
            out.append(r)
    return out


_JAX_CACHE: dict = {}


def _jax(jh, monkeypatch, pallas: bool, query: str, index: str = "r"):
    key = (pallas, index, query)
    if key not in _JAX_CACHE:
        if pallas:
            monkeypatch.setenv("PILOSA_TPU_PALLAS", "1")
        try:
            _JAX_CACHE[key] = _norm(JaxExecutor(jh).execute(index, query))
        finally:
            monkeypatch.delenv("PILOSA_TPU_PALLAS", raising=False)
    return _JAX_CACHE[key]


def _port(ph, engine: str, query: str, index: str = "r"):
    ex = Executor(ph, device="cpu")
    ex.use_stacked = engine == "stacked"
    return _norm(ex.execute(index, query)), ex


@pytest.mark.parametrize("pallas", [False, True], ids=["xla", "pallas"])
@pytest.mark.parametrize("engine", ["stacked", "per_shard"])
@pytest.mark.parametrize("query", QUERIES)
def test_read_surface_matches_jax(holders, monkeypatch, pallas, engine,
                                  query):
    jh, ph = holders
    got, ex = _port(ph, engine, query)
    assert got == _jax(jh, monkeypatch, pallas, query)
    if engine == "per_shard":
        assert all(route in ("asked", "only_route")
                   for _call, route in ex.paths), ex.paths


@pytest.mark.parametrize("engine", ["stacked", "per_shard"])
@pytest.mark.parametrize("fname", ["dec", "ts", "v", "deep"])
def test_field_value_matches_jax(holders, monkeypatch, engine, fname):
    jh, ph = holders
    for c in _FIELD_VALUE_COLS:
        q = f"FieldValue(field={fname}, column={c})"
        assert _port(ph, engine, q)[0] == _jax(jh, monkeypatch, False, q), q


@pytest.mark.parametrize("engine", ["stacked", "per_shard"])
@pytest.mark.parametrize("query", [
    "Count(Distinct(index=o, field=cat))",
    "Count(Distinct(index=o, field=dd))",
    "Count(Distinct(index=nowhere, field=userid))",
    "Count(Intersect(Row(a=1), Distinct(field=v)))",
])
def test_bad_nested_distinct_raises_as_jax(holders, engine, query):
    """The cross-index join takes only an unkeyed INT field, and a BSI
    Distinct of the same index is no bitmap operand: both packages
    raise."""
    jh, ph = holders
    with pytest.raises(Exception) as jax_err:
        JaxExecutor(jh).execute("r", query)
    assert type(jax_err.value).__name__ == "ExecError"
    with pytest.raises(ExecError):
        _port(ph, engine, query)


@pytest.mark.parametrize("engine", ["stacked", "per_shard"])
@pytest.mark.parametrize("limit,offset", [(3000, 500), (5, 0), (7, 100000),
                                          (None, 2500), (None, -3), (-1, None),
                                          (3, -5)])
def test_nested_limit_counts_its_columns(holders, engine, limit, offset):
    """A Limit nested as an operand (Count(Limit(...))) is this port's
    own: the JAX executor raises "unknown or non-bitmap call".  Its
    count is the length of the JAX Limit's columns."""
    jh, ph = holders
    args = ", ".join(f"{k}={v}" for k, v in (("limit", limit),
                                             ("offset", offset))
                     if v is not None)
    top = f"Limit(Row(a=1), {args})"
    want = len(JaxExecutor(jh).execute("r", top)[0].columns())
    with pytest.raises(Exception, match="non-bitmap call: Limit"):
        JaxExecutor(jh).execute("r", f"Count({top})")
    got, ex = _port(ph, engine, f"Count({top})")
    assert got == [want]
    assert _port(ph, engine, f"Count(Intersect(All(), {top}))")[0] == [want]


@pytest.mark.parametrize("engine", ["stacked", "per_shard"])
def test_limit_counts_once_and_pulls_back_only_its_shards(holders,
                                                          monkeypatch,
                                                          engine):
    """Limit launches popcount_rows once over the child's stack and
    brings back to the host only the shards that hold its columns."""
    jh, ph = holders
    pulled = []
    from pilosa_tpu_torch.ops import bitmap as bm
    real = bm.to_numpy

    def spy(t):
        pulled.append(tuple(t.shape))
        return real(t)

    calls = []
    real_pc = K.popcount_rows

    def counted(x):
        calls.append(tuple(x.shape))
        return real_pc(x)

    monkeypatch.setattr(bm, "to_numpy", spy)
    monkeypatch.setattr(K, "popcount_rows", counted)
    q = "Limit(Row(a=1), limit=10, offset=1500)"
    got, _ex = _port(ph, engine, q)
    assert calls == [(N_SHARDS, WIDTH // 32)]
    assert pulled == [(1, WIDTH // 32)]      # the shard holding 1500-1509
    assert got == _jax(jh, monkeypatch, False, q)


@pytest.mark.parametrize("query,route", [
    ("Percentile(field=deep, nth=50)", ("Min", "value_hist_depth")),
    ("Percentile(field=deep, nth=50)", ("Max", "value_hist_depth")),
    ("Percentile(field=v, nth=50)", ("Min", "stacked")),
    ("Sort(Row(a=1), field=v, limit=3)", ("Sort", "stacked")),
    ("Sort(Row(a=1), field=big, limit=3)", ("Sort", "decode_depth")),
    ("Extract(Row(s=2), Rows(big))", ("Extract", "decode_depth")),
    ("Extract(Row(s=2), Rows(v))", ("Extract", "stacked")),
    ("Extract(Row(s=2), Rows(m))", ("Extract", "only_route")),
    ("UnionRows(Rows(s))", ("UnionRows", "stacked")),
    ("Count(Intersect(Row(a=1), UnionRows(Rows(m))))",
     ("UnionRows", "stacked")),
    ("Limit(Row(a=1), limit=3)", ("Limit", "stacked")),
    ("IncludesColumn(Row(a=1), column=3)", ("IncludesColumn", "stacked")),
    ("Rows(s)", ("Rows", "only_route")),
    ("FieldValue(field=v, column=3)", ("FieldValue", "only_route")),
    ("ConstRow(columns=[3])", ("ConstRow", "stacked")),
    ("Count(Intersect(Row(a=1), Distinct(field=s)))",
     ("Distinct", "unfiltered_set")),
])
def test_default_executor_counts_each_new_route(holders, query, route):
    _got, ex = _port(holders[1], "stacked", query)
    assert ex.paths[route] >= 1, ex.paths


def test_sort_and_extract_results_have_the_jax_fields():
    from pilosa_tpu.executor.results import ExtractedTable as JaxTable
    from pilosa_tpu.executor.results import SortedRow as JaxSorted
    for ours, theirs in ((SortedRow, JaxSorted), (ExtractedTable, JaxTable)):
        names = [f.name for f in dataclasses.fields(ours)]
        assert names == [f.name for f in dataclasses.fields(theirs)]
        assert dataclasses.asdict(ours([1], [2])) == \
            dataclasses.asdict(theirs([1], [2]))


@pytest.mark.parametrize("engine", ["stacked", "per_shard"])
@pytest.mark.parametrize("keep", [None, 0, 3, 50])
def test_sort_chunks_equal_one_stable_sort(engine, keep):
    """Many shards of heavy ties and negatives, sorted through the
    chunked device sort (a chunk of 2 shards), equal numpy's stable
    lexsort of every column, both directions."""
    from pilosa_tpu_torch.executor import stacked as st
    from pilosa_tpu_torch.models.holder import Holder
    from pilosa_tpu_torch.models.schema import FieldOptions, FieldType
    rng = np.random.default_rng(2)
    h = Holder(width=WIDTH)
    idx = h.create_index("x")
    n_shards = 7
    cols = np.arange(WIDTH * n_shards)
    keep_cols = cols[rng.random(cols.size) < 0.7]
    vals = rng.integers(-3, 4, size=keep_cols.size)
    idx.create_field("v", FieldOptions(type=FieldType.INT, min=-3,
                                       max=3)).import_values(keep_cols, vals)
    ex = Executor(h, device="cpu")
    ex.use_stacked = engine == "stacked"
    old = st._DECODE_CHUNK
    st._DECODE_CHUNK = 2
    try:
        for desc in (False, True):
            order = np.lexsort((keep_cols, -vals if desc else vals))
            want_cols = keep_cols[order].tolist()
            args = "" if keep is None else f", limit={keep}, offset=4"
            got = ex.execute("x", f"Sort(field=v, sort-desc={str(desc).lower()}"
                                  f"{args})")[0]
            lo = 0 if keep is None else 4
            hi = None if keep is None else 4 + keep
            assert got.columns == want_cols[lo:hi]
            assert got.values == vals[order][lo:hi].tolist()
    finally:
        st._DECODE_CHUNK = old


@pytest.mark.parametrize("engine", ["stacked", "per_shard"])
def test_limit_windows_equal_the_sliced_row(holders, engine):
    """Limit's word-level selection over windows that start and end at
    shard and word boundaries, span shards, and run past the end,
    equals slicing the child's columns."""
    _jh, ph = holders
    ex = Executor(ph, device="cpu")
    ex.use_stacked = engine == "stacked"
    full = ex.execute("r", "Union(Row(a=1), Row(s=9000))")[0].columns()
    ends = [int(np.searchsorted(full, s * WIDTH)) for s in range(1, 5)]
    starts = sorted({0, 1, 31, 32, 33, *ends, *(e - 1 for e in ends),
                     len(full) - 1, len(full), len(full) + 5})
    for offset in starts:
        for limit in (None, 1, 2, 31, 32, 33, 900, 5000):
            args = f"offset={offset}" + ("" if limit is None
                                         else f", limit={limit}")
            got = ex.execute(
                "r", f"Limit(Union(Row(a=1), Row(s=9000)), {args})")[0]
            end = None if limit is None else offset + limit
            assert got.columns().tolist() == full[offset:end].tolist(), args
