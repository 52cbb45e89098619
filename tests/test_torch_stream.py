"""The port's streaming write plane against the JAX package's.

``StreamWriter`` and ``StreamImporter`` (ingest/stream.py), the
in-process ``Broker`` and its ``StreamSource``, ``SQLSource`` and
``KinesisSource`` (ingest/kafka.py), and the Avro codec and source
(ingest/avro.py), each package on the same seeded inputs (width 2048;
the port on the CPU):

- the same submits through both writers leave equal bits in the two
  holders and equal answers;
- a backlog over its tenant's budget sheds with a typed 503 that carries
  ``retry_after_s``; a data error poisons one window as a typed 400 and
  the plane lands the next;
- a crash at each seam (``ingest-window-stall``, ``crash-post-append``,
  ``wal-torn``, ``crash-pre-checkpoint``, ``crash-pre-commit``), then a
  reopen from disk and a replay from the committed offsets, converges
  to a cold rebuild of the stream, in each package, and the two
  packages' holders end equal;
- the sources give equal ``Record``s, and Avro ``encode``/``frame`` equal
  bytes, on the same messages.  Exact throughout."""

import datetime as dt
import json
import sqlite3
import time

import numpy as np
import pytest

from pilosa_tpu.api import API as JaxAPI
from pilosa_tpu.ingest import APIImporter as JaxAPIImporter
from pilosa_tpu.ingest import Pipeline as JaxPipeline
from pilosa_tpu.ingest import avro as jax_avro
from pilosa_tpu.ingest import kafka as jax_kafka
from pilosa_tpu.ingest import stream as jax_stream
from pilosa_tpu.models.holder import Holder as JaxHolder
from pilosa_tpu.obs import faults as jax_faults
from pilosa_tpu_torch.api import API
from pilosa_tpu_torch.ingest import APIImporter, Pipeline, avro, kafka, stream
from pilosa_tpu_torch.models.holder import Holder
from pilosa_tpu_torch.obs import faults

SCHEMA = {"indexes": [{"name": "w", "fields": [
    {"name": "f", "options": {"type": "set"}},
    {"name": "g", "options": {"type": "set"}},
    {"name": "v", "options": {"type": "int", "min": 0, "max": 1 << 20}},
]}]}
W = 2048

PKG = {
    "jax": dict(api=JaxAPI, holder=JaxHolder, stream=jax_stream,
                kafka=jax_kafka, avro=jax_avro, pipeline=JaxPipeline,
                importer=JaxAPIImporter, faults=jax_faults, kw={}),
    "port": dict(api=API, holder=Holder, stream=stream, kafka=kafka,
                 avro=avro, pipeline=Pipeline, importer=APIImporter,
                 faults=faults, kw={"device": "cpu"}),
}


@pytest.fixture(autouse=True)
def _clean_faults():
    jax_faults.clear()
    faults.clear()
    yield
    jax_faults.clear()
    faults.clear()


def make_api(pkg: str, path=None):
    p = PKG[pkg]
    h = (p["holder"](path=str(path), width=W) if path is not None
         else p["holder"](width=W))
    api = p["api"](h, **p["kw"])
    api.apply_schema(SCHEMA)
    return api


def reopen(pkg: str, path):
    p = PKG[pkg]
    h = p["holder"](path=str(path), width=W)
    h.load_schema()
    return p["api"](h, **p["kw"])


def bits(h, index="w") -> dict:
    """Every non-empty row of every fragment, as bytes, by (field, view,
    shard, row): the representation-free state of one index."""
    out = {}
    idx = h.index(index)
    for fname in sorted(idx.fields):
        for vname, v in sorted(idx.fields[fname].views.items()):
            for shard, fr in sorted(v.fragments.items()):
                for r in fr.row_ids:
                    w = np.asarray(fr.row_words(r), dtype=np.uint32)
                    if w.any():
                        out[(fname, vname, shard, r)] = w.tobytes()
    return out


READS = ["Count(Row(f=1))", "Row(f=2)", "TopN(f)", "Sum(field=v)",
         "Count(Row(v > 500))", "Row(g=1)", "Count(All())"]


def _submits(seed: int):
    """A seeded list of submit kwargs: set and clear bits, values and
    existence marks, over four shards."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(60):
        n = int(rng.integers(1, 20))
        cols = rng.integers(0, 4 * W, size=n).tolist()
        kind = int(rng.integers(0, 4))
        if kind == 0:
            out.append(dict(field="f", rows=rng.integers(0, 4, n).tolist(),
                            cols=cols))
        elif kind == 1:
            out.append(dict(field="f", rows=rng.integers(0, 4, n).tolist(),
                            cols=cols, clear=True))
        elif kind == 2:
            out.append(dict(field="v", cols=cols,
                            values=rng.integers(0, 1000, n).tolist()))
        else:
            out.append(dict(field=None, cols=cols))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("window_ms", [0.0, 2.0])
def test_writers_give_equal_state(seed, window_ms):
    got = {}
    for pkg in PKG:
        api = make_api(pkg)
        w = PKG[pkg]["stream"].StreamWriter(api, window_s=window_ms / 1e3,
                                            sync=False).start()
        try:
            muts = [w.submit("w", s.pop("field"), wait=False, **s)
                    for s in _submits(seed)]
            w.wait(muts, timeout=60)
            landed = (w.windows_landed, w.mutations_landed)
        finally:
            w.close()
        got[pkg] = (bits(api.holder),
                    [api.query("w", q) for q in READS], landed[1])
        assert landed[0] >= 1
        api.holder.close()
    assert got["port"] == got["jax"]


def test_read_after_ack_patches_resident_stacks():
    """A read after an acknowledged window counts its writes, and the
    port's executor patches its resident stacks for it instead of
    building them again."""
    api = make_api("port")
    ex = api.executor
    api.import_bits("w", "f", rows=[1] * 50, cols=list(range(0, 5000, 100)))
    assert api.query("w", "Count(Row(f=1))")["results"] == [50]
    before = ex.stacked.cache.counters()
    w = stream.StreamWriter(api, window_s=0.0, sync=False).start()
    try:
        assert w.submit("w", "f", rows=[1, 1], cols=[7, 4099]) == 2
        assert api.query("w", "Count(Row(f=1))")["results"] == [52]
    finally:
        w.close()
    after = ex.stacked.cache.counters()
    assert after.get("patches", 0) > before.get("patches", 0)
    assert after.get("rebuilds", 0) == before.get("rebuilds", 0)
    api.holder.close()


def test_shed_is_typed_503_with_retry_after():
    out = {}
    for pkg in PKG:
        p = PKG[pkg]
        api = make_api(pkg)
        p["faults"].inject("ingest-window-stall", times=1, delay_s=1.0,
                           error=False)
        w = p["stream"].StreamWriter(api, window_s=0.0, queue_max=64,
                                     tenant_queue_max=1, sync=False).start()
        try:
            first = w.submit("w", "f", rows=[1], cols=[1], wait=False)
            deadline = time.monotonic() + 10
            while w._pending and time.monotonic() < deadline:
                time.sleep(0.002)  # until the stalled window drained it
            second = w.submit("w", "f", rows=[1], cols=[2], wait=False)
            with pytest.raises(p["stream"].WriteBacklogError) as ei:
                w.submit("w", "f", rows=[1], cols=[3], wait=False)
            e = ei.value
            assert e.status == 503 and e.retry_after_s > 0
            w.wait([first, second], timeout=30)
            out[pkg] = (str(e), w.sheds, bits(api.holder))
        finally:
            w.close()
            api.holder.close()
    assert out["port"] == out["jax"]


@pytest.mark.parametrize("bad", [
    dict(field="v", cols=[1], values=["not-an-int"]),
    dict(field="v", cols=[1, 2], values=[3, {"a": 1}]),
])
def test_data_error_poisons_one_window(bad):
    out = {}
    for pkg in PKG:
        p = PKG[pkg]
        api = make_api(pkg)
        w = p["stream"].StreamWriter(api, window_s=0.0, sync=False).start()
        try:
            with pytest.raises(p["stream"].MutationError) as ei:
                w.submit("w", bad["field"], cols=bad["cols"],
                         values=bad["values"])
            assert ei.value.status == 400 and w.failed is None
            assert w.submit("w", "f", rows=[1], cols=[5]) == 1
            out[pkg] = (str(ei.value), w.windows_failed,
                        api.query("w", "Row(f=1) Sum(field=v)"))
        finally:
            w.close()
            api.holder.close()
    assert out["port"] == out["jax"]


def test_unknown_field_and_shape_errors_match():
    out = {}
    for pkg in PKG:
        api = make_api(pkg)
        w = PKG[pkg]["stream"].StreamWriter(api, window_s=0.0, sync=False)
        errs = []
        for kw in (dict(index="w", field="nope", rows=[1], cols=[1]),
                   dict(index="nope", field="f", rows=[1], cols=[1]),
                   dict(index="w", field="f", rows=[1, 2], cols=[1]),
                   dict(index="w", field="v", cols=[1, 2], values=[1]),
                   dict(index="w", field=None, rows=[1], cols=[1])):
            try:
                w.submit(**kw)
                errs.append(None)
            except (KeyError, ValueError) as e:
                errs.append((type(e).__name__, str(e)))
        w.close()
        out[pkg] = errs
        api.holder.close()
    assert out["port"] == out["jax"]


# -- crash seams and replay ---------------------------------------------------

def _produce(broker, topic, n, seed):
    rng = np.random.default_rng(seed)
    for i in range(n):
        broker.produce(topic, {"_id": int(i), "f": int(rng.integers(0, 5)),
                               "v": int(rng.integers(0, 1000))}, key=i)


def _run_pipeline(pkg, api, broker, topic, group, batch_size=8,
                  use_stream=True):
    p = PKG[pkg]
    schema = {"f": {"type": "set"},
              "v": {"type": "int", "min": 0, "max": 1 << 20}}
    src = p["kafka"].StreamSource(broker, topic, group=group, schema=schema)
    writer = None
    if use_stream:
        writer = p["stream"].StreamWriter(api, window_s=0.0).start()
        imp = p["stream"].StreamImporter(api, writer)
    else:
        imp = p["importer"](api)
    try:
        n = p["pipeline"](src, imp, "w", batch_size=batch_size).run()
    finally:
        if writer is not None:
            writer.close()
    return n, src


def _cold(pkg, broker, topic):
    api = make_api(pkg)
    _run_pipeline(pkg, api, broker, topic, group="cold", use_stream=False)
    out = bits(api.holder)
    api.holder.close()
    return out


@pytest.mark.parametrize("seam,batch_size", [
    ("ingest-window-stall", 8), ("crash-post-append", 3),
    ("wal-torn", 8), ("wal-torn", 5), ("crash-pre-checkpoint", 3),
    ("crash-pre-commit", 8), ("crash-pre-commit", 5)])
def test_crash_seam_restart_converges(tmp_path, monkeypatch, seam,
                                      batch_size):
    """Kill the ingester at the seam, reopen the holder from disk, resume
    from the committed offsets: each package converges to a cold
    rebuild of the stream, every offset is committed, and the two
    packages' holders end equal."""
    monkeypatch.setenv("RBF_NOSYNC", "1")
    got = {}
    for pkg in PKG:
        p = PKG[pkg]
        path = tmp_path / pkg
        broker = p["kafka"].Broker(n_partitions=2)
        _produce(broker, "t", 40, seed=batch_size)
        api = make_api(pkg, path)
        p["faults"].inject(seam, times=1)
        with pytest.raises(Exception):
            _run_pipeline(pkg, api, broker, "t", group="g",
                          batch_size=batch_size)
        p["faults"].clear()
        api.holder.close()
        api2 = reopen(pkg, path)
        try:
            _, src2 = _run_pipeline(pkg, api2, broker, "t", group="g")
            state = bits(api2.holder)
            assert state == _cold(pkg, broker, "t"), (pkg, seam)
            committed = broker.committed("g", "t")
            for part in broker.partitions("t"):
                assert committed.get(part, 0) == broker.head("t", part)
            if seam in ("crash-pre-checkpoint", "crash-pre-commit"):
                assert src2.replayed > 0
            got[pkg] = state
        finally:
            api2.holder.close()
    assert got["port"] == got["jax"]


# -- sources ------------------------------------------------------------------

def _records(src) -> list:
    return [(r.id, r.values, r.time) for r in src]


def _messages(seed):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(30):
        m = {"_id": f"k{i}" if i % 5 == 0 else i,
             "f": int(rng.integers(0, 5)),
             "tags": ["a", "b"][: int(rng.integers(1, 3))],
             "score": float(rng.integers(0, 1000)) / 8,
             "ok": bool(i % 2)}
        if i % 3 == 0:
            m["_ts"] = "2024-01-0%dT00:00:00" % (1 + i % 9)
        out.append(m)
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_stream_source_records_match(seed):
    out = {}
    for pkg in PKG:
        k = PKG[pkg]["kafka"]
        b = k.Broker(n_partitions=3)
        for i, m in enumerate(_messages(seed)):
            b.produce("t", m, key=i)
        src = k.StreamSource(b, "t", group="g", poll_batch=7)
        recs = _records(src)
        src.commit(10)
        again = _records(k.StreamSource(b, "t", group="g"))
        out[pkg] = (recs, src.schema, src.id_keys, b.committed("g", "t"),
                    again)
    assert out["port"] == out["jax"]


@pytest.mark.parametrize("iterator", ["TRIM_HORIZON", "LATEST", "RESUME"])
def test_kinesis_source_records_match(iterator):
    out = {}
    for pkg in PKG:
        k = PKG[pkg]["kafka"]
        b = k.Broker(n_partitions=2)
        for i, m in enumerate(_messages(2)[:10]):
            b.produce("s", m, key=i)
        first = k.KinesisSource(b, "s", group="g", iterator_type=iterator)
        recs = _records(first)
        first.commit(4)
        for i, m in enumerate(_messages(3)[:5]):
            b.produce("s", m, key=i)
        later = _records(k.KinesisSource(b, "s", group="g",
                                         iterator_type=iterator))
        out[pkg] = (recs, later)
    assert out["port"] == out["jax"]
    with pytest.raises(ValueError):
        kafka.KinesisSource(kafka.Broker(), "s", iterator_type="NOPE")


def test_sql_source_records_match():
    conn = sqlite3.connect(":memory:")
    conn.execute("CREATE TABLE t (_id INTEGER, f INTEGER, name TEXT, "
                 "score REAL, ok BOOLEAN)")
    rng = np.random.default_rng(5)
    for i in range(25):
        conn.execute("INSERT INTO t VALUES (?, ?, ?, ?, ?)",
                     (i, int(rng.integers(0, 9)),
                      None if i % 4 == 0 else f"n{i % 3}",
                      float(i) / 4, i % 2))
    out = {}
    for pkg in PKG:
        src = PKG[pkg]["kafka"].SQLSource(conn, "SELECT * FROM t")
        out[pkg] = (_records(src), src.schema, src.id_keys)
    assert out["port"] == out["jax"]
    with pytest.raises(ValueError):
        kafka.SQLSource(conn, "SELECT f FROM t")


AVRO_SCHEMA = {"type": "record", "name": "ev", "fields": [
    {"name": "_id", "type": "long"},
    {"name": "f", "type": "int"},
    {"name": "name", "type": "string"},
    {"name": "score", "type": "double"},
    {"name": "ok", "type": "boolean"},
    {"name": "tags", "type": {"type": "array", "items": "string"}},
    {"name": "opt", "type": ["null", "long"]},
    {"name": "price", "type": {"type": "bytes", "logicalType": "decimal",
                               "precision": 10, "scale": 2}},
]}


def _avro_values(seed):
    from decimal import Decimal
    rng = np.random.default_rng(seed)
    return [{"_id": int(i) * 7 - 20, "f": int(rng.integers(-50, 50)),
             "name": f"n{i}", "score": float(i) / 3, "ok": bool(i % 2),
             "tags": [f"t{j}" for j in range(i % 3)],
             "opt": None if i % 2 else int(rng.integers(-1 << 40, 1 << 40)),
             "price": Decimal(int(rng.integers(0, 10 ** 6))) / 100}
            for i in range(12)]


def test_avro_codec_bytes_match():
    for v in _avro_values(0):
        jb = jax_avro.encode(AVRO_SCHEMA, v)
        assert avro.encode(AVRO_SCHEMA, v) == jb
        assert avro.decode(AVRO_SCHEMA, jb) == jax_avro.decode(AVRO_SCHEMA,
                                                                jb)
        assert avro.frame(3, jb) == jax_avro.frame(3, jb)
        assert avro.unframe(avro.frame(3, jb)) == (3, jb)
    for n in (0, -1, 1, 63, -64, 1 << 40, -(1 << 62)):
        assert avro._zigzag_encode(n) == jax_avro._zigzag_encode(n)
    with pytest.raises(avro.AvroError):
        avro.unframe(b"\x01abc")


def test_avro_stream_source_records_match():
    out = {}
    for pkg in PKG:
        a, k = PKG[pkg]["avro"], PKG[pkg]["kafka"]
        reg = a.SchemaRegistry()
        sid = reg.register("ev-value", AVRO_SCHEMA)
        b = k.Broker(n_partitions=2)
        for i, v in enumerate(_avro_values(1)):
            b.produce("ev", a.frame(sid, a.encode(AVRO_SCHEMA, v)), key=i)
        src = a.AvroStreamSource(b, "ev", reg, group="g")
        out[pkg] = (_records(src), src.schema, sid,
                    reg.latest("ev-value"))
    assert out["port"] == out["jax"]


def test_stream_pipeline_lands_records_equal():
    """JSON and Avro records through StreamSource, Pipeline and a
    StreamImporter land the same bits in both packages."""
    out = {}
    for pkg in PKG:
        p = PKG[pkg]
        api = make_api(pkg)
        b = p["kafka"].Broker(n_partitions=2)
        _produce(b, "t", 50, seed=9)
        n, src = _run_pipeline(pkg, api, b, "t", group="g", batch_size=6)
        out[pkg] = (n, bits(api.holder), api.query("w", "TopN(f)"),
                    json.dumps(b.committed("g", "t"), sort_keys=True))
        api.holder.close()
    assert out["port"] == out["jax"]
    assert out["port"][0] == 50


def test_broker_offsets_and_replay_marks_match():
    out = {}
    for pkg in PKG:
        b = PKG[pkg]["kafka"].Broker(n_partitions=2)
        for i in range(9):
            b.produce("t", {"_id": i}, key=i)
        got = [b.fetch("t", p, 1, 3) for p in b.partitions("t")]
        b.commit_offsets("g", "t", {0: 2})
        marks = [b.delivered_mark("g", "t", 0, o) for o in (0, 1, 0, 3)]
        out[pkg] = (got, b.committed("g", "t"), marks,
                    [b.head("t", p) for p in b.partitions("t")])
    assert out["port"] == out["jax"]


def test_time_records_keep_timestamps():
    out = {}
    for pkg in PKG:
        k = PKG[pkg]["kafka"]
        b = k.Broker(n_partitions=1)
        b.produce("t", {"_id": 1, "f": 2,
                        "_ts": dt.datetime(2024, 5, 1).isoformat()})
        out[pkg] = _records(k.StreamSource(b, "t"))
    assert out["port"] == out["jax"]
