"""String keys in the port against the JAX package, on the same data.

The port's own copies of the key translation (``storage/translate.py``)
and id allocation (``storage/idalloc.py``) give the JAX package's ids
for the same keys and sessions.  Keyed indexes and fields are built
through each package's holder, translators and import API from one
seeded recipe: the reference's keyed fixture (KEYED_SETUP of
tests/test_pql_ref_conformance.py, from defs_keyed.go) and a larger
seeded keyed index.  Every keyed read path, and keyed writes, runs on
both of the port's engines (device="cpu") and equals the JAX executor:
dataclass results as ``dataclasses.asdict`` (Pair keys, groups with
"row_key", Extract with "column_key"), row results as their columns and
``RowResult.keys``.  Exact throughout."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from pilosa_tpu.executor.executor import Executor as JaxExecutor
from pilosa_tpu.models.holder import Holder as JaxHolder
from pilosa_tpu.models.schema import FieldOptions as JaxFieldOptions
from pilosa_tpu.models.schema import FieldType as JaxFieldType
from pilosa_tpu.storage import idalloc as jax_idalloc
from pilosa_tpu.storage import translate as jax_translate
from pilosa_tpu_torch.executor.executor import ExecError, Executor
from pilosa_tpu_torch.models.holder import Holder
from pilosa_tpu_torch.models.schema import FieldOptions, FieldType
from pilosa_tpu_torch.storage import idalloc, translate

torch.set_num_threads(1)

WIDTH = 2048

# -- translation and id allocation ------------------------------------------


@pytest.mark.parametrize("index", ["i", "keyed", "kidx", "ü-index"])
def test_partition_functions_match_jax(index):
    for key in ["", "a", "one", "c0000001", "ключ", "k" * 40]:
        assert translate.key_to_key_partition(index, key) == \
            jax_translate.key_to_key_partition(index, key)
    for shard in [0, 1, 2, 255, 256, 1023, 10 ** 6]:
        assert translate.shard_to_shard_partition(index, shard) == \
            jax_translate.shard_to_shard_partition(index, shard)
    for prev in [0, 5, WIDTH - 1, 3 * WIDTH + 7]:
        for part in [-1, 0, 17, 255]:
            assert translate.next_partitioned_id(
                index, prev, part, shard_width=WIDTH) == \
                jax_translate.next_partitioned_id(index, prev, part,
                                                  shard_width=WIDTH)


@pytest.mark.parametrize("width", [WIDTH, 1 << 20])
def test_partitioned_ids_match_jax(width):
    """Keys created in batches, repeats among them, give the JAX ids;
    lookups, reverse lookups and matches agree."""
    ours = translate.PartitionedTranslator("kidx", shard_width=width)
    theirs = jax_translate.PartitionedTranslator("kidx", shard_width=width)
    rng = np.random.default_rng(5)
    keys = [f"c{i:07d}" for i in range(3000)]
    for lo in range(0, len(keys), 700):
        batch = keys[lo:lo + 700] + [keys[int(rng.integers(0, lo + 1))]]
        assert ours.create_keys(*batch) == theirs.create_keys(*batch)
    probe = keys[::97] + ["missing", "c9999999"]
    assert ours.find_keys(*probe) == theirs.find_keys(*probe)
    ids = sorted(ours.find_keys(*keys).values())
    assert ours.translate_ids(ids + [7, 10 ** 7]) == \
        theirs.translate_ids(ids + [7, 10 ** 7])
    pred = lambda k: k.endswith("7")  # noqa: E731
    assert ours.match(pred) == theirs.match(pred)


def test_partitioned_logs_reopen_as_jax(tmp_path):
    """Index column keys with a path: one log a partition; a reopened
    translator finds the keys on disk (match opens the partitions it has
    not loaded yet) and allocates as the JAX one does."""
    got = {}
    for name, mod in (("ours", translate), ("jax", jax_translate)):
        path = str(tmp_path / name)
        a = mod.PartitionedTranslator("kidx", path, shard_width=WIDTH)
        first = a.create_keys(*[f"c{i:03d}" for i in range(300)])
        a.close()
        b = mod.PartitionedTranslator("kidx", path, shard_width=WIDTH)
        got[name] = (first, b.match(lambda k: k.endswith("9")),
                     b.find_keys("c007", "c299", "zz"),
                     b.create_keys("c300", "c007"),
                     sorted(os.listdir(path)))
        b.close()
    assert got["ours"] == got["jax"]


def test_row_store_and_log_match_jax(tmp_path, monkeypatch):
    """A field's sequential store, with its JSONL log and compaction
    every 40 records: the same ids, and a reopen (a torn last line
    dropped) gives them back and allocates the next id as the JAX store
    does."""
    monkeypatch.setattr(translate, "COMPACT_THRESHOLD", 40)
    mk = {"ours": lambda p: translate.TranslateStore(p, index="kidx"),
          "jax": lambda p: jax_translate.TranslateStore(
              p, index="kidx", compact_threshold=40)}
    got = {}
    for name, make in mk.items():
        p = str(tmp_path / name / "keys.jsonl")
        s = make(p)
        first = s.create_keys(*[f"k{i:02d}" for i in range(64)])
        again = s.create_keys("k03", "k70", "k03")
        s.close()
        with open(p, "a") as f:
            f.write('{"id": 99, "ke')          # a torn append
        s2 = make(p)
        got[name] = (first, again, s2.entries(), s2.max_id(),
                     s2.create_keys("fresh"),
                     s2.match(lambda k: k.startswith("k1")),
                     sorted(os.listdir(os.path.dirname(p))))
        s2.close()
    assert got["ours"] == got["jax"]


def test_idalloc_sessions_match_jax(tmp_path):
    """Reserve, re-reserve, commit short, roll back and reopen: the same
    ranges as the JAX allocator."""
    out = {}
    for name, mod in (("ours", idalloc), ("jax", jax_idalloc)):
        p = str(tmp_path / f"{name}.json")
        a = mod.IDAllocator(p)
        steps = [a.reserve("i", b"s1", 10), a.reserve("i", b"s2", 5),
                 a.reserve("i", b"s1", 10)]
        a.commit("i", b"s2", 3)
        a.rollback("i", b"s1")
        steps.append(a.reserve("j", b"x", 4))
        b = mod.IDAllocator(p)
        steps += [b.reserve("j", b"x", 4), b.reserve("i", b"s3", 2)]
        b.commit("j", b"x", 1)
        steps.append(b.reserve("j", b"y", 2))
        with pytest.raises(KeyError):
            b.commit("i", b"nope")
        out[name] = [(r.start, r.stop) for r in steps]
    assert out["ours"] == out["jax"]


# -- keyed data -------------------------------------------------------------

# the reference's keyed fixture (defs_keyed.go), as the rows of
# KEYED_SETUP: _id, an_int, an_id_set, an_id, a_string, a_string_set
KEYED_ROWS = [
    ("one", 11, (11, 12, 13), 101, "str1", ("a1", "b1", "c1")),
    ("two", 22, (11, 12, 23), 201, "str2", ("a2", "b2", "c2")),
    ("three", 33, (11, 32, 33), 301, "str3", ("a3", "b3", "c3")),
    ("four", 44, (41, 42, 43), 401, "str4", ("a4", "b4", "c4")),
]
N_KEYS = 600           # column keys of the seeded keyed index


def _keyed(h, opts, ftype):
    """Index "keyed" (KEYED_SETUP's table, its SQL types as fields:
    int, idset = set, id = mutex, string = keyed mutex, stringset =
    keyed set) and index "kidx" (column keys c0000..; a keyed set field
    kf of 12 row keys, each column in one or two rows; a keyed mutex
    km; an unkeyed set field ks; an INT kv with negatives), and index
    "ko" (keyed) whose INT uid holds column ids of kidx, for the
    cross-index Distinct.  Keys go through the translators, bits
    through the import API."""
    idx = h.create_index("keyed", keys=True)
    an_int = idx.create_field("an_int", opts(type=ftype.INT, min=0, max=100))
    an_id_set = idx.create_field("an_id_set")
    an_id = idx.create_field("an_id", opts(type=ftype.MUTEX))
    a_string = idx.create_field("a_string", opts(type=ftype.MUTEX, keys=True))
    a_string_set = idx.create_field("a_string_set", opts(keys=True))
    cids = idx.column_translator.create_keys(*[r[0] for r in KEYED_ROWS])
    for key, v, ids, i, s, ss in KEYED_ROWS:
        c = cids[key]
        an_int.import_values([c], [v])
        an_id_set.import_bits(list(ids), [c] * len(ids))
        an_id.import_bits([i], [c])
        a_string.import_bits([a_string.row_translator.create_keys(s)[s]], [c])
        rows = a_string_set.row_translator.create_keys(*ss)
        a_string_set.import_bits([rows[k] for k in ss], [c] * len(ss))
    idx.mark_columns_exist(list(cids.values()))

    rng = np.random.default_rng(41)
    k = h.create_index("kidx", keys=True)
    kf = k.create_field("kf", opts(keys=True))
    km = k.create_field("km", opts(type=ftype.MUTEX, keys=True))
    ks = k.create_field("ks", opts(cache_type="none"))
    kv = k.create_field("kv", opts(type=ftype.INT, min=-1000, max=1000))
    keys = [f"c{i:04d}" for i in range(N_KEYS)]
    ids = k.column_translator.create_keys(*keys)
    cols = np.array([ids[c] for c in keys], dtype=np.int64)
    rkeys = kf.row_translator.create_keys(*[f"k{i:02d}" for i in range(12)])
    rid = np.array([rkeys[f"k{i:02d}"] for i in range(12)])
    first = rng.integers(0, 12, size=N_KEYS)
    kf.import_bits(rid[first], cols)
    two = rng.random(N_KEYS) < 0.2
    kf.import_bits(rid[rng.integers(0, 12, size=int(two.sum()))], cols[two])
    mkeys = km.row_translator.create_keys("red", "green", "blue")
    pick = rng.random(N_KEYS) < 0.8
    km.import_bits(np.array(list(mkeys.values()))[
        rng.integers(0, 3, size=int(pick.sum()))], cols[pick])
    ks.import_bits(rng.integers(0, 5, size=N_KEYS), cols)
    vals = rng.integers(-1000, 1001, size=N_KEYS)
    has = rng.random(N_KEYS) < 0.9
    kv.import_values(cols[has], vals[has])
    k.mark_columns_exist(cols)

    o = h.create_index("ko", keys=True)
    oids = o.column_translator.create_keys(*[f"o{i}" for i in range(40)])
    uid = o.create_field("uid", opts(type=ftype.INT, min=-10,
                                     max=int(cols.max()) + 10))
    uid.import_values(np.array(list(oids.values())),
                      np.append(cols[rng.integers(0, N_KEYS, size=38)],
                                [-3, int(cols.max()) + 5]))
    return h


@pytest.fixture(scope="module")
def holders():
    return (_keyed(JaxHolder(width=WIDTH), JaxFieldOptions, JaxFieldType),
            _keyed(Holder(width=WIDTH), FieldOptions, FieldType))


def _norm(results):
    out = []
    for r in results:
        if dataclasses.is_dataclass(r):
            out.append((type(r).__name__, dataclasses.asdict(r)))
        elif hasattr(r, "segments"):
            out.append(("row", r.columns().tolist(), r.keys))
        elif isinstance(r, list) and r and dataclasses.is_dataclass(r[0]):
            out.append([dataclasses.asdict(p) for p in r])
        else:
            out.append(r)
    return out


REFERENCE_QUERIES = [
    # the reference's keyed PQLTests (tests/test_pql_ref_conformance.py)
    "MinRow(field=an_id_set)", "MaxRow(field=an_id_set)",
    "TopK(an_id_set, k=2)", "Rows(field=an_id_set)",
    "IncludesColumn(Row(an_id_set=12), column='two')",
    "Extract(ConstRow(columns=['two']), Rows(an_id))",
    "FieldValue(field=an_int, column='three')",
    "Count(UnionRows(Rows(field=an_id_set)))",
    # and the fixture's keyed fields through the rest of the surface
    "Row(a_string='str2')", "Row(a_string_set='b3')", "Row(an_id_set=11)",
    "Count(Row(a_string_set='nope'))", "Row(an_int > 20)",
    "Rows(a_string)", "Rows(a_string_set)", "Rows(a_string_set, like='a%')",
    "Rows(a_string_set, column='four')", "Rows(an_id, column='one')",
    "TopN(a_string_set, n=3)", "TopN(a_string, Row(an_int < 40), n=5)",
    "GroupBy(Rows(a_string))",
    "GroupBy(Rows(a_string), Rows(an_id_set), aggregate=Sum(field=an_int))",
    "Distinct(field=a_string_set)", "Distinct(field=an_id_set)",
    "Extract(All(), Rows(a_string), Rows(a_string_set), Rows(an_int), "
    "Rows(an_id_set), Rows(an_id))",
    "ConstRow(columns=['one', 'four', 'zzz'])", "All()",
    "Not(Row(a_string='str1'))", "Sum(field=an_int)",
    "FieldValue(field=an_int, column='nobody')",
]

KIDX_QUERIES = [
    "Count(Row(kf='k03'))", "Row(kf='k03')", "Row(kf='nope')",
    "Row(ks=2)", "Row(km='green')",
    "Union(Row(kf='k01'), Row(km='blue'))",
    "Count(Intersect(Row(kf='k05'), Row(ks=1)))",
    "TopN(kf, n=5)", "TopN(kf, Row(ks=3), n=5)", "TopK(kf, k=3)",
    "TopN(km, n=3)", "TopN(kf, Row(kv > 500), n=4)",
    "GroupBy(Rows(kf), Rows(ks), aggregate=Sum(field=kv))",
    "GroupBy(Rows(km))", "GroupBy(Rows(kf), previous=['k05'])",
    "GroupBy(Rows(kf), Rows(ks), previous=['k02', 1], limit=7)",
    "GroupBy(Rows(km), Rows(ks), aggregate=Max(field=kv))",
    "GroupBy(Rows(km), filter=Row(kf='k04'), aggregate=Min(field=kv))",
    "Rows(kf)", "Rows(kf, like='k1%')", "Rows(kf, like='k_3')",
    "Rows(kf, previous='k04')", "Rows(kf, previous='k04', limit=3)",
    "Rows(kf, column='c0005')", "Rows(ks, column='c0007')",
    "Rows(kf, column='nokey')", "Rows(km, like='%e%')",
    "UnionRows(Rows(kf, like='k0%'))", "Count(UnionRows(Rows(kf)))",
    "Distinct(field=kf)", "Distinct(Row(ks=1), field=kf)",
    "Distinct(field=ks)", "Count(Intersect(Row(ks=1), Distinct(field=ks)))",
    "Extract(ConstRow(columns=['c0001', 'c0002', 'zz']), Rows(kf), "
    "Rows(km), Rows(kv), Rows(ks))",
    "Extract(Limit(Row(ks=2), limit=5), Rows(kf), Rows(km))",
    "FieldValue(field=kv, column='c0009')", "FieldValue(field=kv, column='no')",
    "IncludesColumn(Row(kf='k01'), column='c0003')",
    "IncludesColumn(Row(kf='k01'), column='nope')",
    "ConstRow(columns=['c0001', 'c0100', 'c0599'])",
    "Count(ConstRow(columns=['c0001', 'c0100', 'nope']))",
    "Limit(Row(ks=1), limit=4, offset=2)",
    "Sort(Row(ks=1), field=kv, limit=5)", "MinRow(field=kf)",
    "MaxRow(Row(ks=4), field=kf)", "Min(field=kv)",
    "Sum(Row(kf='k02'), field=kv)", "Max(Row(km='red'), field=kv)",
    "Intersect(Row(ks=1), Distinct(index=ko, field=uid))",
    "Count(Distinct(Row(uid > 0), index=ko, field=uid))",
    "Options(Row(kf='k07'), shards=[0])",
]

_CASES = ([("keyed", q) for q in REFERENCE_QUERIES]
          + [("kidx", q) for q in KIDX_QUERIES])


_JAX_CACHE: dict = {}


@pytest.mark.parametrize("engine", ["stacked", "per_shard"])
@pytest.mark.parametrize("index,query", _CASES)
def test_keyed_reads_match_jax(holders, engine, index, query):
    """Each keyed read on both of the port's engines equals the JAX
    executor's (its default engine: the keyed index's ~230 shards of a
    few columns each make its per-shard loop slow on the CPU)."""
    jh, ph = holders
    if (index, query) not in _JAX_CACHE:
        _JAX_CACHE[index, query] = _norm(JaxExecutor(jh).execute(index, query))
    ex = Executor(ph, device="cpu")
    ex.use_stacked = engine == "stacked"
    assert _norm(ex.execute(index, query)) == _JAX_CACHE[index, query]


def test_keyed_results_carry_keys(holders):
    """The keyed shapes are really keyed: row results list their column
    keys, pairs their row keys, groups their row_key, Extract its
    column_key (the equality above would hold for two empty answers)."""
    ex = Executor(holders[1], device="cpu")
    row = ex.execute("kidx", "Row(kf='k03')")[0]
    assert row.keys and all(k.startswith("c") for k in row.keys)
    assert len(row.keys) == row.count()
    pairs = ex.execute("kidx", "TopN(kf, n=3)")[0]
    assert [p.key[0] for p in pairs] == ["k"] * 3
    groups = ex.execute("kidx", "GroupBy(Rows(kf), Rows(ks))")[0]
    assert groups[0].group[0]["row_key"] == "k00"
    assert "row_key" not in groups[0].group[1]
    table = ex.execute("keyed", "Extract(ConstRow(columns=['two']), "
                                "Rows(a_string_set))")[0]
    assert table.columns[0]["column_key"] == "two"
    assert table.columns[0]["rows"] == [["a2", "b2", "c2"]]
    assert ex.execute("kidx", "Distinct(field=ks)")[0].keys is None


@pytest.mark.parametrize("engine", ["stacked", "per_shard"])
@pytest.mark.parametrize("query", [
    "Set(5, kf='k01')", "Set('c0001', kf=3)", "Row(kf=3)",
    "Rows(ks, like='k%')", "Rows(kf, previous='zzz')",
    "GroupBy(Rows(kf), previous=['zzz'])",
    "GroupBy(Rows(ks), previous=['k01'])", "FieldValue(field=kv, column=3)",
])
def test_keyed_errors_match_jax(holders, engine, query):
    """Ids where keys belong, keys where ids belong, and unknown
    previous= keys: both packages raise an ExecError with one message."""
    jh, ph = holders
    with pytest.raises(Exception) as want:
        JaxExecutor(jh).execute("kidx", query)
    assert type(want.value).__name__ == "ExecError"
    ex = Executor(ph, device="cpu")
    ex.use_stacked = engine == "stacked"
    with pytest.raises(ExecError) as got:
        ex.execute("kidx", query)
    assert str(got.value) == str(want.value)


KEYED_WRITES = [
    "Set('c9999', kf='k99')", "Set('c0003', kf='k99')",
    "Set('newcol', km='violet')", "Set('c0004', kv=-777)",
    "Set('c0005', ks=4)", "Clear('c0003', kf='k99')",
    "Clear('nobody', kf='k01')", "Clear('c0004', kv=0)",
    "Clear('c0001', kf='nope')", "Store(Row(kf='k02'), kf='k98')",
    "Store(Intersect(Row(ks=1), Row(km='red')), fresh='x1')",
    "ClearRow(kf='k05')", "ClearRow(kf='nope')",
    "Delete(ConstRow(columns=['c0010', 'c0011', 'nope']))",
    "Delete(Row(km='blue'))",
]
AFTER_WRITES = [
    "Count(Row(kf='k99'))", "Row(kf='k99')", "Row(km='violet')",
    "FieldValue(field=kv, column='c0004')", "Row(kf='k98')",
    "Row(fresh='x1')", "Count(Row(kf='k05'))", "Count(Row(km='blue'))",
    "TopN(kf, n=4)", "TopN(kf, Row(ks=4), n=4)",
    "GroupBy(Rows(km), Rows(ks), aggregate=Sum(field=kv))",
    "Extract(ConstRow(columns=['c9999', 'newcol', 'c0010']), Rows(kf), "
    "Rows(km), Rows(kv))", "Rows(kf)", "Rows(fresh)", "Count(All())",
    "Sum(field=kv)",
]


@pytest.mark.parametrize("engine", ["stacked", "per_shard"])
def test_keyed_writes_match_jax(engine):
    """Keyed writes (a new column key and a new row key on a Set, a new
    keyed field from Store) on a long-lived executor of each package
    (the JAX one on its default engine): every write's answer, and
    every read after it, equal."""
    jh = _keyed(JaxHolder(width=WIDTH), JaxFieldOptions, JaxFieldType)
    ph = _keyed(Holder(width=WIDTH), FieldOptions, FieldType)
    jh.index("kidx").create_field("fresh", JaxFieldOptions(keys=True))
    ph.index("kidx").create_field("fresh", FieldOptions(keys=True))
    jex = JaxExecutor(jh)
    ex = Executor(ph, device="cpu")
    ex.use_stacked = engine == "stacked"
    for q in AFTER_WRITES:               # warm: resident stacks to patch
        ex.execute("kidx", q)
    for w in KEYED_WRITES:
        assert _norm(ex.execute("kidx", w)) == \
            _norm(jex.execute("kidx", w)), w
        for q in AFTER_WRITES:
            assert _norm(ex.execute("kidx", q)) == \
                _norm(jex.execute("kidx", q)), (w, q)
    cache = ex.stacked.cache if engine == "stacked" else ex.tiles.cache
    assert cache.patches > 0
