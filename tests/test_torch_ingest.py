"""The port's ingest (Batch, APIImporter, sources, Pipeline) against the
JAX package's.

Each case of tests/test_ingest.py (the HTTP multiprocess one apart, and
the JAX package's native-scatter fallback, which the port does not
have) runs on both packages' API over a holder of width 2048: the same
records, the same seeded numpy columns, and then the same answers
through each API.query, equal JSON, besides the case's own checks.
Id-allocation sessions of the pipeline give the JAX ids.  The port
runs on the CPU (device="cpu").  Exact throughout."""

import io

import numpy as np
import pytest
import torch

from pilosa_tpu.api import API as JaxAPI
from pilosa_tpu.ingest import APIImporter as JaxAPIImporter
from pilosa_tpu.ingest import Batch as JaxBatch
from pilosa_tpu.ingest import CSVSource as JaxCSVSource
from pilosa_tpu.ingest import DatagenSource as JaxDatagenSource
from pilosa_tpu.ingest import Pipeline as JaxPipeline
from pilosa_tpu.ingest import Record as JaxRecord
from pilosa_tpu.models.fragment import Fragment as JaxFragment
from pilosa_tpu.models.holder import Holder as JaxHolder
from pilosa_tpu.ops import bsi as jax_bsi
from pilosa_tpu.storage.idalloc import IDAllocator as JaxIDAllocator
from pilosa_tpu_torch.api import API
from pilosa_tpu_torch.ingest import (
    APIImporter,
    Batch,
    CSVSource,
    DatagenSource,
    KafkaSource,
    Pipeline,
    Record,
)
from pilosa_tpu_torch.models.fragment import Fragment
from pilosa_tpu_torch.models.holder import Holder
from pilosa_tpu_torch.storage.idalloc import IDAllocator

torch.set_num_threads(1)

W = 2048
PKG = {
    "port": dict(api=lambda: API(Holder(width=W), device="cpu"),
                 Importer=APIImporter, Batch=Batch, CSVSource=CSVSource,
                 DatagenSource=DatagenSource, Pipeline=Pipeline,
                 Record=Record, IDAllocator=IDAllocator),
    "jax": dict(api=lambda: JaxAPI(JaxHolder(width=W)),
                Importer=JaxAPIImporter, Batch=JaxBatch,
                CSVSource=JaxCSVSource, DatagenSource=JaxDatagenSource,
                Pipeline=JaxPipeline, Record=JaxRecord,
                IDAllocator=JaxIDAllocator),
}


def on_both(run, queries):
    """run(pkg dict, api) in each package; then each (index, query)
    through API.query, equal JSON in both.  Returns the port's answers
    and run's results by package."""
    answers, results = {}, {}
    for name, pkg in PKG.items():
        api = pkg["api"]()
        results[name] = run(pkg, api)
        answers[name] = [api.query(i, q)["results"] for i, q in queries]
    assert answers["port"] == answers["jax"]
    return answers["port"], results


def test_batch_bits_and_values():
    def run(pkg, api):
        api.apply_schema({"indexes": [{"name": "b", "fields": [
            {"name": "f", "options": {"type": "set"}},
            {"name": "n", "options": {"type": "int", "min": 0, "max": 100}},
        ]}]})
        b = pkg["Batch"](pkg["Importer"](api), "b",
                         {"f": {"type": "set"}, "n": {"type": "int"}}, size=3)
        R = pkg["Record"]
        full = [b.add(R(id=1, values={"f": 7, "n": 10})),
                b.add(R(id=2, values={"f": [7, 8], "n": 20})),
                b.add(R(id=3, values={"n": None}))]
        b.flush()
        return full, b.imported
    got, res = on_both(run, [("b", "Count(Row(f=7))"), ("b", "Sum(field=n)"),
                             ("b", "Count(Row(f=8))"), ("b", "Count(All())")])
    assert got == [[2], [{"value": 30, "count": 2}], [1], [2]]
    assert res["port"] == res["jax"] == ([False, False, True], 5)


def test_batch_keyed_translation():
    def run(pkg, api):
        api.apply_schema({"indexes": [{"name": "k", "keys": True, "fields": [
            {"name": "color", "options": {"type": "set", "keys": True}}]}]})
        b = pkg["Batch"](pkg["Importer"](api), "k",
                         {"color": {"type": "set", "keys": True}}, size=10,
                         index_keys=True)
        b.add(pkg["Record"](id="alice", values={"color": "red"}))
        b.add(pkg["Record"](id="bob", values={"color": ["red", "blue"]}))
        b.flush()
        return api.translate_keys("k", None, ["alice", "bob", "carol"])
    got, res = on_both(run, [("k", 'Row(color="red")'),
                             ("k", "TopN(color, n=2)")])
    assert sorted(got[0][0]["keys"]) == ["alice", "bob"]
    assert res["port"] == res["jax"] and res["port"][2] is None


CSV = ("_id,segment:id,name:string,qty:int,ok:bool,tags:stringset\n"
       "1,3,aaa,10,true,x;y\n"
       "2,3,bbb,20,false,y\n"
       "3,4,,30,true,\n")


def test_csv_source_and_pipeline():
    def run(pkg, api):
        src = pkg["CSVSource"](io.StringIO(CSV))
        return src.schema, pkg["Pipeline"](src, pkg["Importer"](api),
                                           "c").run()
    got, res = on_both(run, [("c", "Count(Row(segment=3))"),
                             ("c", "Sum(field=qty)"),
                             ("c", 'Count(Row(tags="y"))'),
                             ("c", "Count(Row(ok=true))"),
                             ("c", "Count(Row(segment=4))"),
                             ("c", "Row(name='aaa')")])
    assert got[:5] == [[2], [{"value": 60, "count": 3}], [2], [2], [1]]
    assert res["port"] == res["jax"]
    assert res["port"][0]["qty"]["type"] == "int" and res["port"][1] == 3


def test_csv_keyed_ids():
    def run(pkg, api):
        src = pkg["CSVSource"](io.StringIO("_id:string,seg:id\nuserA,1\n"
                                           "userB,1\n"))
        return pkg["Pipeline"](src, pkg["Importer"](api), "ck").run()
    got, _ = on_both(run, [("ck", "Row(seg=1)")])
    assert sorted(got[0][0]["keys"]) == ["userA", "userB"]


@pytest.mark.parametrize("header", ["_id,x:bogustype\n1,2\n", "x:id\n1\n",
                                    "_id,_ts:int\n1,2\n"])
def test_csv_bad_header(header):
    for pkg in PKG.values():
        with pytest.raises(ValueError):
            pkg["CSVSource"](io.StringIO(header))


def test_datagen_deterministic_and_as_jax():
    ours = list(DatagenSource(50, seed=7))
    assert [r.values for r in ours] == \
        [r.values for r in DatagenSource(50, seed=7)]
    assert [(r.id, r.values) for r in ours] == \
        [(r.id, r.values) for r in JaxDatagenSource(50, seed=7)]
    keyed = DatagenSource(3, seed=1, keys=True)
    assert [r.id for r in keyed] == ["user0", "user1", "user2"]


def test_pipeline_concurrency_matches_serial():
    """Four workers over one queue give the state one worker gives."""
    qs = ["Count(Row(segment=5))", "Sum(field=amount)",
          "Count(Row(active=true))", "TopN(segment, n=4)", "Count(All())"]

    def run(pkg, api):
        n1 = pkg["Pipeline"](pkg["DatagenSource"](500, seed=3),
                             pkg["Importer"](api), "s1", batch_size=64,
                             concurrency=1).run()
        n4 = pkg["Pipeline"](pkg["DatagenSource"](500, seed=3),
                             pkg["Importer"](api), "s4", batch_size=64,
                             concurrency=4).run()
        return n1, n4
    got, res = on_both(run, [(i, q) for i in ("s1", "s4") for q in qs])
    assert got[:len(qs)] == got[len(qs):]
    assert res["port"] == (500, 500)


def test_pipeline_small_batches_flush_all():
    def run(pkg, api):
        return pkg["Pipeline"](pkg["DatagenSource"](97, seed=1),
                               pkg["Importer"](api), "sb",
                               batch_size=10).run()
    got, res = on_both(run, [("sb", "Count(All())")])
    assert got == [[97]] and res["port"] == 97


def test_kafka_gated():
    with pytest.raises(NotImplementedError):
        KafkaSource("broker:9092")


def test_csv_time_field_with_ts():
    def run(pkg, api):
        src = pkg["CSVSource"](io.StringIO(
            "_id,ev:time,_ts\n1,7,2020-03-15T10:00:00\n"
            "2,7,2021-06-01T00:00:00\n"))
        assert src.schema["ev"]["type"] == "time"
        return pkg["Pipeline"](src, pkg["Importer"](api), "tv").run()
    got, _ = on_both(run, [
        ("tv", "Count(Row(ev=7))"),
        ("tv", "Count(Row(ev=7, from='2020-01-01T00:00', "
               "to='2020-12-31T00:00'))")])
    assert got == [[2], [1]]


def test_pipeline_worker_error_raises_not_hangs():
    class BadSource(DatagenSource):
        def __iter__(self):
            for _ in range(10000):
                yield Record(id="not-an-int", values={"segment": 1})
    src = BadSource(1)
    src.id_keys = False  # int(id) fails in every batch
    p = Pipeline(src, APIImporter(API(Holder(width=W), device="cpu")), "bad",
                 batch_size=5, concurrency=3)
    with pytest.raises((ValueError, TypeError)):
        p.run()


SCHEMA_C = {"indexes": [{"name": "c", "fields": [
    {"name": "f", "options": {"type": "set"}},
    {"name": "m", "options": {"type": "mutex"}},
    {"name": "s", "options": {"type": "mutex", "keys": True}},
    {"name": "n", "options": {"type": "int", "min": 0, "max": 1000}},
]}]}
BSCHEMA_C = {"f": {"type": "set"}, "m": {"type": "mutex"},
             "s": {"type": "mutex", "keys": True}, "n": {"type": "int"}}
C_QUERIES = ["Count(Row(f=3))", "Count(Row(m=2))", "Count(Row(s='k5'))",
             "Count(Row(n > 500))", "Count(All())", "Row(m=1)",
             "TopN(s, n=3)", "Sum(field=n)"]


def _columns_c():
    rng = np.random.default_rng(3)
    n = 6 * W // 5   # two shards
    ids = np.arange(n)
    f = rng.integers(0, 9, size=n)
    m = rng.integers(0, 4, size=n)
    s = np.array([f"k{v}" for v in rng.integers(0, 7, size=n)], dtype=object)
    nv = rng.integers(0, 1000, size=n).astype(object)
    nv[::7] = None  # NULL cells set no bit
    return ids, f, m, s, nv


def test_columnar_add_matches_record_path():
    """Batch.add_columns equals per-record adds (sets, mutex last write
    wins, string keys, int values, NULL cells) in each package, and the
    packages agree."""
    def run(pkg, api):
        api.apply_schema(SCHEMA_C)
        api.apply_schema({"indexes": [{**SCHEMA_C["indexes"][0],
                                       "name": "r"}]})
        ids, f, m, s, nv = _columns_c()
        pkg["Batch"](pkg["Importer"](api), "c", BSCHEMA_C).add_columns(
            ids, {"f": f, "m": m, "s": s, "n": nv})
        recb = pkg["Batch"](pkg["Importer"](api), "r", BSCHEMA_C, size=64)
        for i in range(ids.size):
            recb.add(pkg["Record"](int(ids[i]), {
                "f": int(f[i]), "m": int(m[i]), "s": str(s[i]),
                "n": None if nv[i] is None else int(nv[i])}))
        recb.flush()
    got, _ = on_both(run, [(i, q) for i in ("c", "r") for q in C_QUERIES])
    assert got[:len(C_QUERIES)] == got[len(C_QUERIES):]


@pytest.mark.parametrize("workers", [1, 4])
def test_import_columns_matches_jax(workers):
    """API.import_columns on 1 or 4 threads: the JAX answers, and the
    records marked once."""
    schema = {"indexes": [{"name": "p", "fields": [
        {"name": "a", "options": {"type": "set"}},
        {"name": "b", "options": {"type": "mutex"}},
        {"name": "v", "options": {"type": "int", "min": 0, "max": 50}},
    ]}]}
    rng = np.random.default_rng(5)
    n = 900
    ids = np.sort(rng.choice(3 * W, size=n, replace=False))
    bits = {"a": rng.integers(0, 5, size=n), "b": rng.integers(0, 5, size=n)}
    vals = {"v": rng.integers(0, 50, size=n)}

    def run(pkg, api):
        api.apply_schema(schema)
        return api.import_columns("p", ids, bits=bits, values=vals,
                                  workers=workers)
    got, res = on_both(run, [("p", q) for q in (
        "Count(All())", "Count(Row(a=1))", "Count(Row(b=4))", "Sum(field=v)",
        "GroupBy(Rows(a), Rows(b), aggregate=Sum(field=v))")])
    assert got[0] == [n] and res["port"] == res["jax"] == 3 * n


def test_pipeline_id_allocation_gives_the_jax_ids(tmp_path):
    """Records without an id take ids from IDAllocator sessions; the
    same source gives the JAX ids, and the allocator files agree."""
    def run(pkg, api):
        class NoIds(pkg["DatagenSource"]):
            def __iter__(self):
                for r in super().__iter__():
                    r.id = None
                    yield r
        path = str(tmp_path / f"{pkg['Pipeline'].__module__}.json")
        alloc = pkg["IDAllocator"](path)
        n = pkg["Pipeline"](NoIds(230, seed=9), pkg["Importer"](api), "a",
                            batch_size=64, allocator=alloc).run()
        again = pkg["IDAllocator"](path)
        return n, again.reserve("a", b"next", 3)
    got, res = on_both(run, [("a", "Row(segment=3)"), ("a", "Count(All())"),
                             ("a", "Sum(field=amount)")])
    assert got[1] == [230]
    assert res["port"] == res["jax"]


def test_import_values_int64_min_magnitude():
    """INT64_MIN round-trips through the bulk BSI write, as in the JAX
    package: its magnitude 2^63 exists only in uint64."""
    int64_min = -(1 << 63)
    out = []
    for cls in (Fragment, JaxFragment):
        frag = cls("i", "v", "bsi", 0, width=1 << 12)
        frag.import_values([5, 9, 7], [int64_min, 3, int64_min + 1], 64)
        planes = np.stack([frag.row_words(r) for r in range(66)])
        out.append(jax_bsi.decode(planes))
    assert out[0][0].tolist() == out[1][0].tolist() == [5, 7, 9]
    assert out[0][1] == out[1][1] == [int64_min, int64_min + 1, 3]


@pytest.mark.parametrize("depth,value", [(3, 8), (63, -(1 << 63)),
                                         (10, -1024)])
def test_import_values_depth_overflow_raises(depth, value):
    """An out-of-depth magnitude is an error in both packages, not a
    wrapped write."""
    for cls in (Fragment, JaxFragment):
        frag = cls("i", "v", "bsi", 0, width=1 << 12)
        with pytest.raises(ValueError, match="bits"):
            frag.import_values([1], [value], depth=depth)


def test_pipeline_workers_and_syncs_lose_no_rows(tmp_path, monkeypatch):
    """Sixteen workers (more than this machine's cores) import into a
    path-backed index and sync after every batch, with the interpreter
    switching threads every microsecond: after a reopen the index holds
    every record, as one worker's in-memory import does (a sync beside
    an import would drop the rows that import dirtied while it wrote)."""
    import sys
    monkeypatch.setenv("RBF_NOSYNC", "1")
    qs = [("g", q) for q in ("Count(All())", "Sum(field=amount)",
                             "TopN(segment, n=16)", "Count(Row(active=true))")]
    want_api = API(Holder(width=W), device="cpu")
    Pipeline(DatagenSource(3000, seed=4), APIImporter(want_api), "g",
             batch_size=50).run()
    want = [want_api.query(i, q) for i, q in qs]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        api = API(Holder(path=str(tmp_path), width=W), device="cpu")
        n = Pipeline(DatagenSource(3000, seed=4), APIImporter(api), "g",
                     batch_size=50, concurrency=16).run()
    finally:
        sys.setswitchinterval(old)
    api.holder.close()
    h = Holder(path=str(tmp_path), width=W)
    h.load_schema()
    assert n == 3000
    assert [API(h, device="cpu").query(i, q) for i, q in qs] == want
    h.close()
