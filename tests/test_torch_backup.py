"""Backup and restore, translate snapshots and the persisted statistics
catalog, the port against the JAX package.

The port CLI's ``backup`` of a port node on disk and its ``restore``
into a fresh port node give the source node's answers; a JAX node's
backup restored into a port node answers as the JAX node does (the
port reads the JAX on-disk format).  The translate partition and field
snapshots, and their restores, are equal between the packages, as are
the node-to-node fragment routes' JSON (``tests/torch_server_dual.py``:
the same requests to a JAX and a port server over equal data).  The
statistics catalog's store (``storage/stats_store.py``) persists and
reloads the port's catalog as the JAX one does, and either package
reads the other's file."""

import json
import os

import pytest
import torch

from pilosa_tpu.models.holder import Holder as JaxHolder
from pilosa_tpu.obs import stats as jax_stats
from pilosa_tpu.server.http import Server as JaxServer
from pilosa_tpu_torch.cli.main import _safe_join
from pilosa_tpu_torch.cli.main import main as port_main
from pilosa_tpu_torch.cluster.client import InternalClient, RemoteError
from pilosa_tpu_torch.models.holder import Holder
from pilosa_tpu_torch.obs import stats
from pilosa_tpu_torch.server.http import Server
from torch_server_dual import (
    W,
    build_holder,
    call,
    configs,
    dual_servers,
    restore_globals,
    strip,
)

torch.set_num_threads(1)

QUERIES = ["Count(Row(a=1))", "Row(a=2)", "TopN(s, n=4)",
           "Sum(field=age)", "Count(Row(age > 60))", "Min(field=price)",
           "GroupBy(Rows(a), Rows(m))", "Distinct(field=age)"]
KEYED = ['Row(tag="red")', 'Count(Row(tag="blue"))', "TopN(tag)"]


@pytest.fixture()
def disk_node(tmp_path):
    """A port node over a seeded holder on disk."""
    path = str(tmp_path / "src")
    with restore_globals():
        _jc, pc = configs()
        h = build_holder("port", path=path)
        srv = Server(holder=h, port=0, config=pc, device="cpu").start()
        try:
            yield srv, h
        finally:
            srv.close()
            h.close()


def _answers(api):
    return ([api.query("i", q)["results"] for q in QUERIES]
            + [api.query("k", q)["results"] for q in KEYED])


def test_cli_backup_restore_roundtrip(disk_node, tmp_path, capsys):
    srv, _h = disk_node
    want = _answers(srv.api)
    host = f"127.0.0.1:{srv.port}"
    bdir = str(tmp_path / "bkp")
    assert port_main(["backup", "--host", host, "--output-dir", bdir,
                      "--quiet"]) == 0
    man = json.load(open(os.path.join(bdir, "MANIFEST.json")))
    assert "schema.json" in man["files"]
    assert any(f.endswith(".rbf") for f in man["files"])
    assert srv.api.txns.list() == {}  # the exclusive transaction ended
    with restore_globals():
        _jc, pc = configs()
        h2 = Holder(path=str(tmp_path / "dst"), width=W)
        srv2 = Server(holder=h2, port=0, config=pc, device="cpu").start()
        try:
            assert port_main(["restore", "--host", f"127.0.0.1:{srv2.port}",
                              "--source-dir", bdir, "--quiet"]) == 0
            assert _answers(srv2.api) == want
            # the restored node takes writes and reads them back
            before = srv2.api.query("i", "Row(a=3)")["results"][0][
                "columns"]
            srv2.api.query("i", "Set(5, a=3)")
            assert srv2.api.query("i", "Count(Row(a=3))")["results"] == \
                [len(set(before) | {5})]
        finally:
            srv2.close()
            h2.close()
    out = capsys.readouterr().out
    assert "backup complete" in out and "restore complete" in out


def test_jax_backup_restores_into_a_port_node(tmp_path):
    """A JAX node's backup (its CLI, its on-disk format) restored into
    a port node through the port CLI answers as the JAX node does."""
    from pilosa_tpu.cli.main import main as jax_main
    jpath = str(tmp_path / "jsrc")
    bdir = str(tmp_path / "jbkp")
    with restore_globals():
        jcfg, pcfg = configs()
        jh = build_holder("jax", path=jpath)
        js = JaxServer(holder=jh, port=0, config=jcfg).start()
        try:
            want = _answers(js.api)
            assert jax_main(["backup", "--host", f"127.0.0.1:{js.port}",
                             "--output-dir", bdir, "--quiet"]) == 0
        finally:
            js.close()
            jh.close()
        h2 = Holder(path=str(tmp_path / "pdst"), width=W)
        ps = Server(holder=h2, port=0, config=pcfg, device="cpu").start()
        try:
            assert port_main(["restore", "--host", f"127.0.0.1:{ps.port}",
                              "--source-dir", bdir, "--quiet"]) == 0
            assert _answers(ps.api) == want
        finally:
            ps.close()
            h2.close()


def test_backup_routes_refuse_a_path_outside_the_data_dir(disk_node):
    srv, _h = disk_node
    cli = InternalClient()
    host = f"127.0.0.1:{srv.port}"
    for path in ("/internal/backup/file?path=../../etc/passwd",
                 "/internal/backup/file?path=/etc/passwd"):
        with pytest.raises(RemoteError) as e:
            cli.get_raw(host, path)
        assert e.value.status == 400
    with pytest.raises(RemoteError) as e:
        cli.get_raw(host, "/internal/backup/file?path=nope.bin")
    assert e.value.status == 404
    with pytest.raises(ValueError):
        _safe_join("/b", "../x")
    with pytest.raises(ValueError):
        _safe_join("/b", "/etc/x")
    assert _safe_join("/b", "i/x.rbf") == "/b/i/x.rbf"


# -- the node-to-node routes against the JAX server -----------------------------


@pytest.fixture(scope="module")
def servers():
    with dual_servers(build_holder("jax"), build_holder("port")) as s:
        yield s


ROUTES = [
    ("GET", "/internal/translate/k/partitions", None),
    ("GET", "/internal/translate/i/partitions", None),
    ("GET", "/internal/translate/k/field/tag/snapshot", None),
    ("GET", "/internal/translate/k/field/nope/snapshot", None),
    ("GET", "/internal/fragment/i/a/views", None),
    ("GET", "/internal/fragment/i/age/views", None),
    ("GET", "/internal/fragment/i/nope/views", None),
    ("GET", "/internal/fragment/i/a/standard/0/checksums", None),
    ("GET", "/internal/fragment/i/age/bsig_age/2/checksums", None),
    ("GET", "/internal/fragment/i/a/standard/9/checksums", None),
    ("GET", "/internal/fragment/nope/a/standard/0/checksums", None),
    ("GET", "/internal/fragment/i/a/standard/1/block/0", None),
    ("GET", "/internal/fragment/i/s/standard/3/block/0", None),
    ("GET", "/internal/fragment/i/a/standard/9/block/0", None),
    ("GET", "/internal/fragment/i/m/standard/1/deltas?since=0", None),
    ("GET", "/internal/fragment/i/a/standard/9/deltas?since=0", None),
    ("GET", "/internal/fragment/i/a/standard/9/state", None),
    ("GET", "/internal/backup/manifest", None),
    ("POST", "/internal/restore/complete", None),
    ("POST", "/internal/translate/i/partition/3/restore",
     {"entries": []}),
]


@pytest.mark.parametrize("method,path,body", ROUTES,
                         ids=[f"{m} {p}" for m, p, _b in ROUTES])
def test_node_routes_answer_as_jax(servers, method, path, body):
    """Equal status and JSON, except the fragment's ``gen`` (a process
    counter), ``version`` and the delta ``count`` (the number of delta
    log entries, which each package's import writes its own way) of the
    resharding routes; the rows they ship must be equal."""
    js, ps = servers
    (jst, _jh, jb), (pst, _ph, pb) = [call(s, method, path, body)
                                      for s in (js, ps)]
    drop = frozenset({"gen", "version", "count"})
    assert (pst, strip(pb, drop)) == (jst, strip(jb, drop))


def test_partition_snapshots_equal_jax(servers):
    js, ps = servers
    parts = call(ps, "GET", "/internal/translate/k/partitions")[2]
    assert parts and parts == call(js, "GET",
                                   "/internal/translate/k/partitions")[2]
    for p in parts:
        path = f"/internal/translate/k/partition/{p}/snapshot"
        assert call(ps, "GET", path)[2] == call(js, "GET", path)[2]


def test_fragment_state_and_block_roundtrip_equal_jax(servers):
    """A block fetched from one package and pushed into the other's
    fresh fragment digests as the source does; the state route gives
    the same checksums in both."""
    js, ps = servers
    base = "/internal/fragment/i/s/standard/2"
    jstate, pstate = [call(s, "GET", base + "/state")[2] for s in (js, ps)]
    assert pstate["checksums"] == jstate["checksums"]
    for b in pstate["checksums"]:
        jblk = call(js, "GET", f"{base}/block/{b}")[2]
        assert call(ps, "GET", f"{base}/block/{b}")[2] == jblk
        dst = "/internal/fragment/i/s/standard/77"
        for s in (js, ps):
            st, _h, out = call(s, "POST", f"{dst}/block/{b}", jblk)
            assert st == 200 and out["rows"] == len(jblk)
        assert call(ps, "GET", dst + "/checksums")[2] == \
            call(js, "GET", dst + "/checksums")[2] == \
            {b: pstate["checksums"][b]}
    # the delta chase's apply: whole rows replaced, equal in both
    rows = {"rows": {"1": call(js, "GET", f"{base}/block/0")[2]["1"]}}
    for s in (js, ps):
        assert call(s, "POST", "/internal/fragment/i/s/standard/78/rows",
                    rows)[2] == {"rows": 1}
    assert call(ps, "GET", "/internal/fragment/i/s/standard/78/checksums") \
        == call(js, "GET", "/internal/fragment/i/s/standard/78/checksums")


def test_translate_restores_equal_jax():
    """A partition and a field snapshot restored into each package's
    fresh keyed index give the same translations."""
    out = []
    for pkg in ("jax", "port"):
        src = build_holder(pkg)
        dst = (JaxHolder if pkg == "jax" else Holder)(width=W)
        k = dst.create_index("k", keys=True)
        from importlib import import_module
        schema = import_module(("pilosa_tpu" if pkg == "jax"
                                else "pilosa_tpu_torch") + ".models.schema")
        tag = k.create_field("tag", schema.FieldOptions(keys=True))
        sct = src.index("k").column_translator
        for p in sct.nonempty_partitions():
            k.column_translator.restore_partition(
                p, sct.partition_snapshot(p))
        tag.row_translator.restore_snapshot(
            src.index("k").field("tag").row_translator.snapshot())
        keys = [f"u{i}" for i in range(40)]
        out.append((k.column_translator.find_keys(*keys),
                    tag.row_translator.find_keys("red", "green", "blue"),
                    k.column_translator.nonempty_partitions()))
    assert out[0] == out[1]


# -- the statistics catalog's store -------------------------------------------


def _cluster_rec(node, ms):
    return {"trace_id": "t", "route": "cluster", "duration_ms": ms,
            "start": 0.0, "batch": 1, "phases": {}, "bytes_moved": 0,
            "attempts": [{"node": node, "ms": ms, "outcome": "ok",
                          "t_off_ms": 0.0}]}


def _fill(cat):
    cat.note_ingest("si", "f", rows=[0, 1, 2], cols=[1, 2, 1 << 20],
                    width=1 << 20)
    cat.note_ingest("si", "v", cols=[5, 6], values=[3, 90],
                    width=1 << 20)
    for i in range(8):
        cat.note_flight({"fingerprint": "fp1", "route": "direct",
                         "duration_ms": 2.0 + i * 0.1,
                         "phases": {"execute": 1.0}, "batch": 1,
                         "bytes_moved": 100})
    for _ in range(40):
        cat.note_flight(_cluster_rec("n1", 10.0))
        cat.note_flight(_cluster_rec("n2", 40.0))


def _view(cat):
    p = cat.profile("fp1")
    return (cat.field_stats("si", "f"), cat.field_stats("si", "v"),
            (p.n, round(p.ms, 9)) if p else None,
            cat.hedge_samples() is not None)


@pytest.mark.parametrize("writer,reader", [
    ("port", "port"), ("jax", "port"), ("port", "jax"),
])
def test_stats_store_persists_and_reloads_like_jax(tmp_path, writer,
                                                   reader):
    """A catalog saved by ``writer`` and reopened by ``reader`` holds
    what the JAX catalog saved and reopened by itself holds."""
    mods = {"jax": jax_stats, "port": stats}
    ref = jax_stats.StatsCatalog(path=str(tmp_path / "ref.jsonl"))
    _fill(ref)
    ref.save()
    ref.close()
    ref2 = jax_stats.StatsCatalog(path=str(tmp_path / "ref.jsonl"))
    want = _view(ref2)
    ref2.close()
    w = mods[writer].StatsCatalog(path=str(tmp_path / "s.jsonl"))
    _fill(w)
    w.save()
    w.close()
    r = mods[reader].StatsCatalog(path=str(tmp_path / "s.jsonl"))
    assert r.loaded_from_disk
    assert _view(r) == want
    r.close()


def test_stats_tail_replay_and_torn_tail_like_jax(tmp_path):
    out = []
    for mod in (jax_stats, stats):
        path = tmp_path / f"{mod.__name__}.jsonl"
        cat = mod.StatsCatalog(path=str(path))
        cat.note_ingest("si", "f", rows=[0], cols=[5], width=1 << 20)
        cat.note_ingest("si", "f", rows=[1], cols=[6], width=1 << 20)
        cat.close()
        with open(path, "a") as f:
            f.write('{"t": "ingest", "i": "si", "f": "f", "ro')
        cat2 = mod.StatsCatalog(path=str(path))
        out.append((cat2.field_stats("si", "f"), cat2.store.tail_records,
                    os.path.getsize(path)))
        cat2.close()
    assert out[0] == out[1]
    assert out[1][0]["rows"] == 2 and out[1][1:] == (0, 0)


def test_restarted_port_server_reloads_its_catalog(tmp_path):
    """[stats] persist: a port server on a data directory saves the
    catalog when it closes, and the next server on the same directory
    serves it at /debug/stats before any query."""
    path = str(tmp_path / "node")
    prev = stats.swap(stats.StatsCatalog())
    try:
        with restore_globals():
            _jc, pc = configs()
            h = Holder(path=path, width=W)
            srv = Server(holder=h, port=0, config=pc, device="cpu").start()
            try:
                srv.api.create_index("si")
                srv.api.create_field("si", "f", {"type": "set"})
                srv.api.import_bits("si", "f", rows=[0, 1, 2],
                                    cols=[1, 2, W + 3])
                for _ in range(4):
                    srv.api.query("si", "Count(Row(f=0))")
                assert stats.get().store is not None
            finally:
                srv.close()
                h.close()
            assert stats.get().store is None  # detached at close
            stats.get().clear()
            h = Holder(path=path, width=W)
            h.load_schema()
            srv = Server(holder=h, port=0, config=pc, device="cpu").start()
            try:
                st, _hd, body = call(srv, "GET", "/debug/stats")
                assert st == 200
                assert body["data"]["si/f"]["rows"] == 3
                assert body["runtime"]
                assert body["store"]["loaded"] is True
            finally:
                srv.close()
                h.close()
    finally:
        stats.swap(prev)
