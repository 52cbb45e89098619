"""Path-backed holders of the port against the JAX package's.

The cases of tests/test_persistence.py (the SQL one apart) run the same
seeded recipe through each package's Holder(path=...): after sync and
a reopen with load_schema, the holders carry the same rows, BSI depths,
views, schema and key ids, and the port's answers equal the JAX
executor's.  A holder directory written by either package opens in the
other: the JAX-written directory answers the executor parity corpus of
tests/test_torch_executor.py in the port, on both engines, as the JAX
executor answers on the holder that wrote it, and the reverse.  The
port runs on the CPU (device="cpu").  Exact throughout."""

import datetime as dt
import json
import os
import types

import numpy as np
import pytest
import torch

import __graft_entry__ as ge
from pilosa_tpu.executor.executor import Executor as JaxExecutor
from pilosa_tpu.models import holder as jax_holder_mod
from pilosa_tpu.models import schema as jax_schema
from pilosa_tpu_torch.executor.executor import Executor
from pilosa_tpu_torch.models import holder as holder_mod
from pilosa_tpu_torch.models import schema
from pilosa_tpu_torch.models.state import holder_state
from test_torch_executor import (
    DENSE_QUERIES,
    GROUPBY_QUERIES,
    QUERIES,
    _categorical,
    _dense,
    _norm,
    _same_state,
    jax_state,
)
from test_torch_keys import _norm as _keyed_norm

torch.set_num_threads(1)

W = 2048
PKGS = {
    "port": types.SimpleNamespace(
        Holder=holder_mod.Holder, FieldOptions=schema.FieldOptions,
        FieldType=schema.FieldType, TimeQuantum=schema.TimeQuantum,
        state=holder_state, execute=lambda h, i, q, stacked=True:
        _engine(Executor(h, device="cpu"), stacked).execute(i, q)),
    "jax": types.SimpleNamespace(
        Holder=jax_holder_mod.Holder, FieldOptions=jax_schema.FieldOptions,
        FieldType=jax_schema.FieldType, TimeQuantum=jax_schema.TimeQuantum,
        state=jax_state, execute=lambda h, i, q, stacked=True:
        _engine(JaxExecutor(h), stacked).execute(i, q)),
}


def _engine(ex, stacked: bool):
    ex.use_stacked = stacked
    return ex


@pytest.fixture(autouse=True)
def nosync(monkeypatch):
    monkeypatch.setenv("RBF_NOSYNC", "1")


def reopen(pkg, path):
    h = pkg.Holder(path=str(path), width=W)
    h.load_schema()
    return h


@pytest.fixture
def on_both(tmp_path):
    """on_both(recipe, queries): recipe(pkg, holder) in each package on a
    path-backed holder, then sync, close and reopen; the reopened
    states, schema files and the queries' answers are equal (and equal
    before the reopen).  Returns the reopened holders by package, closed
    after the test (the suite audits that every RBF handle of the JAX
    package is closed)."""
    opened = []

    def run(recipe, queries=(), norm=_norm):
        out, answers = {}, {}
        for name, pkg in PKGS.items():
            h = pkg.Holder(path=str(tmp_path / name), width=W)
            opened.append(h)
            recipe(pkg, h)
            before = [norm(pkg.execute(h, i, q)) for i, q in queries]
            h.sync()
            h.close()
            out[name] = reopen(pkg, tmp_path / name)
            opened.append(out[name])
            answers[name] = [norm(pkg.execute(out[name], i, q))
                             for i, q in queries]
            assert answers[name] == before
        _same_state(holder_state(out["port"]), jax_state(out["jax"]))
        assert answers["port"] == answers["jax"]
        schemas = []
        for name in ("port", "jax"):
            with open(tmp_path / name / "schema.json") as f:
                schemas.append(json.load(f))
        assert schemas[0] == schemas[1]
        return out

    yield run
    for h in opened:
        h.close()


def test_set_field_roundtrip(on_both):
    def recipe(pkg, h):
        idx = h.create_index("i")
        f = idx.create_field("f", pkg.FieldOptions(type=pkg.FieldType.SET))
        f.import_bits([1, 1, 2, 7], [3, 9000, 5, 4097])
        idx.mark_columns_exist([3, 9000, 5, 4097])
    out = on_both(recipe, [("i", "Row(f=1)"), ("i", "Count(All())"),
                                     ("i", "TopN(f, n=3)")])
    v = out["port"].index("i").field("f").views["standard"]
    assert v.shards == [0, 2, 4]
    assert sorted(out["port"].index("i").field("_exists").available_shards) \
        == [0, 2, 4]


def test_bsi_roundtrip_and_depth_recovery(on_both):
    def recipe(pkg, h):
        idx = h.create_index("i")
        f = idx.create_field("v", pkg.FieldOptions(type=pkg.FieldType.INT))
        f.import_values([0, 1, 5000], [-3, 1000000, 42])
    out = on_both(recipe, [("i", "Sum(field=v)"), ("i", "Row(v < 0)"),
                                     ("i", "Max(field=v)")])
    assert out["port"].index("i").field("v").bit_depth == \
        (1000000).bit_length()
    assert _norm(PKGS["port"].execute(out["port"], "i", "Sum(field=v)")) == \
        [(-3 + 1000000 + 42, 3)]


def test_clear_and_delete_persist(on_both):
    """A cleared bit and a Delete(...) of columns stay gone after the
    reopen; rows written after a first sync land in the second."""
    def recipe(pkg, h):
        idx = h.create_index("i")
        f = idx.create_field("f", pkg.FieldOptions(type=pkg.FieldType.SET))
        f.import_bits([1, 1, 2], [3, 4, 4])
        idx.mark_columns_exist([3, 4])
        h.sync()
        f.clear_bit(1, 3)
        pkg.execute(h, "i", "Delete(Row(f=2))")
        f.import_bits([3], [2048 + 9])
    out = on_both(recipe, [("i", "Row(f=1)"), ("i", "Row(f=2)"),
                                     ("i", "Row(f=3)"), ("i", "Count(All())")])
    assert _norm(PKGS["port"].execute(out["port"], "i", "Row(f=1)")) == [[]]


def test_delete_field_removes_bitmaps_and_keys(tmp_path, on_both):
    def recipe(pkg, h):
        idx = h.create_index("i")
        fa = idx.create_field("a", pkg.FieldOptions(type=pkg.FieldType.SET,
                                                    keys=True))
        fb = idx.create_field("b", pkg.FieldOptions(type=pkg.FieldType.SET))
        fa.import_bits([fa.row_translator.create_keys("x")["x"]], [1])
        fb.import_bits([0], [2])
        h.sync()
        idx.delete_field("a")
        h.save_schema()
    out = on_both(recipe, [("i", "Row(b=0)")])
    idx = out["port"].index("i")
    assert idx.field("a") is None
    assert all(fn != "a" for fn, _, _ in idx.storage.discover())
    assert not os.path.exists(tmp_path / "port" / "i" / "fields" / "a")
    # a field made again under the name starts with no keys
    a2 = idx.create_field("a", schema.FieldOptions(keys=True))
    assert a2.row_translator.find_keys("x") == {}


def test_delete_index_destroys_storage(tmp_path):
    for name, pkg in PKGS.items():
        h = pkg.Holder(path=str(tmp_path / name), width=W)
        f = h.create_index("i").create_field("f")
        f.import_bits([0], [1])
        h.sync()
        assert os.path.isdir(tmp_path / name / "i" / "backends")
        h.delete_index("i")
        assert not os.path.exists(tmp_path / name / "i")
        h.close()
        h = reopen(pkg, tmp_path / name)
        assert h.indexes == {}
        h.close()


def test_time_quantum_views_roundtrip(on_both):
    def recipe(pkg, h):
        f = h.create_index("i").create_field("t", pkg.FieldOptions(
            type=pkg.FieldType.TIME, time_quantum=pkg.TimeQuantum("YMD")))
        f.set_bit(1, 5, timestamp=dt.datetime(2024, 3, 15))
        f.set_bit(1, 2049, timestamp=dt.datetime(2023, 7, 1))
    out = on_both(recipe, [
        ("i", "Row(t=1, from='2024-01-01T00:00', to='2024-12-31T00:00')"),
        ("i", "Row(t=1)")])
    assert "standard_20240315" in out["port"].index("i").field("t").views


def test_delete_view_drops_its_bitmaps(tmp_path):
    """Field.delete_view removes the view and its bitmap in every shard
    file: a reopen does not bring it back."""
    h = holder_mod.Holder(path=str(tmp_path), width=W)
    f = h.create_index("i").create_field("t", schema.FieldOptions(
        type=schema.FieldType.TIME, time_quantum=schema.TimeQuantum("YM")))
    f.set_bit(1, 5, timestamp=dt.datetime(2024, 3, 15))
    f.set_bit(1, 2049, timestamp=dt.datetime(2024, 4, 1))
    h.sync()
    assert f.delete_view("standard_202403")
    assert not f.delete_view("standard_202403")
    h.close()
    h2 = reopen(PKGS["port"], tmp_path)
    assert sorted(h2.index("i").field("t").views) == [
        "standard", "standard_2024", "standard_202404"]
    assert ("t", "standard_202403", 0) not in h2.index("i").storage.discover()


def test_keyed_index_and_fields_across_a_reopen(tmp_path, on_both):
    """Column and row keys come back from their logs (``_keys/`` and
    ``fields/<f>/keys.jsonl``): the same answers with keys, and a key
    created after the reopen gets the JAX id, the next one, not 0."""
    def recipe(pkg, h):
        idx = h.create_index("k", keys=True)
        f = idx.create_field("kf", pkg.FieldOptions(keys=True))
        v = idx.create_field("kv", pkg.FieldOptions(
            type=pkg.FieldType.INT, min=-50, max=50))
        cols = idx.column_translator.create_keys(
            *[f"c{i:03d}" for i in range(40)])
        rows = f.row_translator.create_keys(*[f"r{i}" for i in range(5)])
        ids = np.array([cols[f"c{i:03d}"] for i in range(40)])
        f.import_bits([rows[f"r{i % 5}"] for i in range(40)], ids)
        v.import_values(ids[::2], np.arange(-20, 20, 2))
        idx.mark_columns_exist(ids)
    queries = [("k", "Row(kf='r3')"), ("k", "TopN(kf, n=3)"),
               ("k", "Count(Row(kv > 0))"), ("k", "Rows(kf)"),
               ("k", "GroupBy(Rows(kf), aggregate=Sum(field=kv))")]
    out = on_both(recipe, queries, norm=_keyed_norm)
    after = {}
    for name in ("port", "jax"):
        idx = out[name].index("k")
        after[name] = (idx.column_translator.create_keys("new-col"),
                       idx.field("kf").row_translator.create_keys("new-row"),
                       idx.column_translator.find_keys("c007"))
        ex = (Executor(out[name], device="cpu") if name == "port"
              else JaxExecutor(out[name]))
        ex.execute("k", "Set('another', kf='r0')")
        after[name] += (_keyed_norm(ex.execute("k", "Row(kf='r0')")),)
    assert after["port"] == after["jax"]
    assert after["port"][1]["new-row"] == 6   # r0..r4 are 1..5
    assert sorted(os.listdir(tmp_path / "port" / "k" / "_keys")) == \
        sorted(os.listdir(tmp_path / "jax" / "k" / "_keys"))


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_keyed_holder_opens_in_the_other_package(tmp_path, writer):
    """A keyed index and keyed field written by one package: the other
    reopens them with the same key ids (both ways of translation), the
    same keyed answers, and allocates the same next ids."""
    reader = "jax" if writer == "port" else "port"
    w = PKGS[writer]
    h = w.Holder(path=str(tmp_path), width=W)
    idx = h.create_index("k", keys=True)
    f = idx.create_field("kf", w.FieldOptions(keys=True))
    cols = idx.column_translator.create_keys(*[f"c{i:03d}" for i in range(90)])
    rows = f.row_translator.create_keys(*[f"r{i}" for i in range(7)])
    f.import_bits([rows[f"r{i % 7}"] for i in range(90)],
                  [cols[f"c{i:03d}"] for i in range(90)])
    idx.mark_columns_exist(list(cols.values()))
    queries = [("k", "Row(kf='r2')"), ("k", "TopN(kf, n=3)"),
               ("k", "GroupBy(Rows(kf))")]
    want = [_keyed_norm(w.execute(h, i, q)) for i, q in queries]
    h.sync()
    h.close()
    r = reopen(PKGS[reader], tmp_path)
    try:
        ridx = r.index("k")
        assert ridx.column_translator.find_keys(*cols) == cols
        assert ridx.field("kf").row_translator.find_keys(*rows) == rows
        assert ridx.column_translator.translate_ids(sorted(cols.values())) \
            == sorted(cols, key=cols.get)
        assert [_keyed_norm(PKGS[reader].execute(r, i, q))
                for i, q in queries] == want
        got = (ridx.column_translator.create_keys("c-new"),
               ridx.field("kf").row_translator.create_keys("r-new"))
    finally:
        r.close()
    again = w.Holder(path=str(tmp_path / "again"), width=W)
    try:
        aidx = again.create_index("k", keys=True)
        aidx.column_translator.create_keys(*cols)
        af = aidx.create_field("kf", w.FieldOptions(keys=True))
        af.row_translator.create_keys(*rows)
        assert got == (aidx.column_translator.create_keys("c-new"),
                       af.row_translator.create_keys("r-new"))
    finally:
        again.close()


# -- the parity corpus across the packages ------------------------------------


def _jax_written(root):
    """The executor parity holders (indexes i, d and c) written to disk
    by the JAX package, and the JAX holder that wrote them."""
    jh = jax_holder_mod.Holder(path=str(root), width=W)
    src = ge._build_holder(width=W, n_shards=4).index("i")
    src.clone_to(jh.create_index("i"))
    _dense(jh, jax_schema.FieldOptions, jax_schema.FieldType,
           jax_schema.FieldOptions(type=jax_schema.FieldType.TIME,
                                   time_quantum=jax_schema.TimeQuantum("YMD")))
    _categorical(jh, jax_schema.FieldOptions, jax_schema.FieldType)
    jh.sync()
    return jh


def _port_written(root, st):
    """The same holders written to disk by the port, from the state."""
    h = holder_mod.Holder(path=str(root), width=W)
    for iname, ist in st["indexes"].items():
        idx = h.create_index(iname, keys=ist["keys"],
                             track_existence=ist["track_existence"])
        for fname, fst in ist["fields"].items():
            f = idx.create_field(fname,
                                 schema.FieldOptions.from_dict(fst["options"]))
            f.bit_depth = fst["bit_depth"]
            for vname, shards in fst["views"].items():
                view = f.view(vname, create=True)
                for shard, rows in shards.items():
                    frag = view.fragment(shard, create=True)
                    for r, words in rows.items():
                        frag.set_row_words(r, words)
    h.sync()
    return h


@pytest.fixture(scope="module")
def disks(tmp_path_factory):
    os.environ["RBF_NOSYNC"] = "1"
    root = tmp_path_factory.mktemp("disks")
    jh = _jax_written(root / "jax")
    port_reopened = reopen(PKGS["port"], root / "jax")
    _same_state(holder_state(port_reopened), jax_state(jh))
    ph = _port_written(root / "port", jax_state(jh))
    jax_reopened = reopen(PKGS["jax"], root / "port")
    _same_state(jax_state(jax_reopened), holder_state(ph))
    with open(root / "jax" / "schema.json") as a, \
            open(root / "port" / "schema.json") as b:
        assert json.load(a) == json.load(b)
    yield {"jax_to_port": (jh, port_reopened), "port_to_jax": (ph, jax_reopened)}
    for h in (jh, port_reopened, ph, jax_reopened):
        h.close()


_CORPUS = ([("i", q) for q in QUERIES] + [("d", q) for q in DENSE_QUERIES]
           + GROUPBY_QUERIES)


@pytest.mark.parametrize("engine", ["stacked", "per_shard"])
@pytest.mark.parametrize("index,query", _CORPUS)
def test_jax_written_holder_answers_in_the_port(disks, engine, index, query):
    jh, ph = disks["jax_to_port"]
    want = _norm(JaxExecutor(jh).execute(index, query))
    assert _norm(PKGS["port"].execute(ph, index, query,
                                      engine == "stacked")) == want


@pytest.mark.parametrize("index,query", _CORPUS)
def test_port_written_holder_answers_in_jax(disks, index, query):
    ph, jh = disks["port_to_jax"]
    want = _norm(Executor(ph, device="cpu").execute(index, query))
    assert _norm(JaxExecutor(jh).execute(index, query)) == want
