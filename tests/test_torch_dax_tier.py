"""The port's disaggregated DAX tier against the JAX package's: the blob
shard store, stateless workers that hydrate from it, the fault drills,
the surfaces and the [dax]/[blob] config (tests/test_dax_tier.py's
cases; its autoscaling cases are in test_torch_dax_scale.py).

Each case runs one scenario on both packages (tests/torch_dax_dual.py)
and asserts test_dax_tier.py's expectations on each and the two
records equal: wire answers, blob objects and manifests byte for byte,
write-log lines and snapshot bytes.  A tier written by either package
hydrates the other's workers to the same answers.  The port's knobs
are set through the Config its services hand their workers, never the
environment."""

import json
import os
import time
import urllib.request

import numpy as np
import pytest

from torch_dax_dual import (
    SCHEMA,
    SHARD,
    TIER_KNOBS,
    Pkg,
    checkpoint,
    cold_service,
    dax_globals,
    dual,
    results,
    seal,
    seed,
    tree_bytes,
)

N = 24


@pytest.fixture(autouse=True)
def _globals():
    with dax_globals():
        yield


def tier_seed(svc, n_shards=N):
    return seed(svc, n_shards, [(s % 90) + 10 for s in range(n_shards)])


def mem_objects(blob) -> dict:
    return dict(blob.backend._objects)


# ---------------------------------------------------------------------------
# blob store
# ---------------------------------------------------------------------------

def _backend(pk, kind, d):
    return pk.MemBackend() if kind == "mem" \
        else pk.LocalDirBackend(str(d / "blob"))


def _objects(store, kind, d):
    return mem_objects(store) if kind == "mem" else tree_bytes(d / "blob")


@pytest.mark.parametrize("kind", ["mem", "dir"])
def test_blob_store_roundtrip(tmp_path, kind):
    def run(pk, d):
        store = pk.BlobStore(_backend(pk, kind, d))
        assert store.manifest("t", 0) is None
        assert store.covered_version("t", 0) == 0
        assert store.restore("t", 0) is None
        store.put_snapshot("t", 0, 5, b"snapshot-at-5")
        assert store.covered_version("t", 0) == 5
        store.put_segment("t", 0, 5, 8, b"entries-6-7-8")
        assert store.covered_version("t", 0) == 8
        errs = []
        for fn, match in ((lambda: store.put_segment("t", 0, 9, 12, b"gap"),
                           "gap"),
                          (lambda: store.put_segment("t", 0, 8, 8, b""),
                           "empty"),
                          (lambda: store.put_snapshot("t", 0, 4, b"old"),
                           "stale")):
            with pytest.raises(pk.BlobError, match=match) as e:
                fn()
            errs.append(str(e.value))
        rec = {"errs": errs, "restore1": store.restore("t", 0),
               "objects1": _objects(store, kind, d)}
        assert rec["restore1"] == (8, b"snapshot-at-5",
                                   [(5, 8, b"entries-6-7-8")])
        store.put_snapshot("t", 0, 8, b"snapshot-at-8")
        rec["restore2"] = store.restore("t", 0)
        assert rec["restore2"] == (8, b"snapshot-at-8", [])
        store.put_snapshot("t", 1, 2, b"other-shard")
        assert store.shards() == [("t", 0), ("t", 1)]
        rec["manifest"] = store.manifest("t", 0)
        store.delete_shard("t", 0)
        assert store.shards() == [("t", 1)]
        assert store.manifest("t", 0) is None
        rec["objects2"] = _objects(store, kind, d)
        return rec
    dual(run, tmp_path)


@pytest.mark.parametrize("kind", ["mem", "dir"])
def test_blob_torn_upload_never_visible(tmp_path, kind):
    def run(pk, d):
        store = pk.BlobStore(_backend(pk, kind, d))
        store.put_snapshot("t", 3, 10, b"good-snapshot-v10")
        pk.faults.inject("blob-torn-upload", times=1)
        with pytest.raises(pk.faults.InjectedFault):
            store.put_snapshot("t", 3, 20, b"newer-snapshot-v20")
        rec = [store.restore("t", 3), store.covered_version("t", 3),
               _objects(store, kind, d)]
        assert rec[:2] == [(10, b"good-snapshot-v10", []), 10]
        store.put_snapshot("t", 3, 20, b"newer-snapshot-v20")
        rec.append(store.restore("t", 3))
        assert rec[-1][:2] == (20, b"newer-snapshot-v20")
        return rec
    dual(run, tmp_path)


def test_blob_checksum_mismatch_is_typed(tmp_path):
    def run(pk, d):
        store = pk.BlobStore(pk.LocalDirBackend(str(d / "b")))
        store.put_snapshot("t", 0, 1, b"the-real-bytes")
        key = store.manifest("t", 0)["snapshot"]["key"]
        with open(os.path.join(str(d / "b"), *key.split("/")), "wb") as f:
            f.write(b"bitrot")
        with pytest.raises(pk.BlobError, match="checksum mismatch") as e:
            store.restore("t", 0)
        return key, str(e.value), e.value.status
    dual(run, tmp_path)


def test_localdir_backend_hygiene(tmp_path):
    def run(pk, d):
        b = pk.LocalDirBackend(str(d / "b"))
        rec = []
        for bad in ("/etc/passwd", "~/x", "a/../../escape"):
            with pytest.raises(pk.BlobError,
                               match="invalid object key") as e:
                b.put(bad, b"x")
            rec.append(str(e.value))
        b.put("t/00000/obj", b"data")
        with open(str(d / "b" / "t" / "00000" / "half.tmp"), "wb") as f:
            f.write(b"partial")
        assert b.list() == ["t/00000/obj"]
        with pytest.raises(pk.BlobError, match="no such object"):
            b.get("t/00000/missing")
        for args in (("dir", None), ("s3", "/x")):
            with pytest.raises(pk.BlobError) as e:
                pk.make_backend(*args)
            rec.append(str(e.value))
        return rec
    dual(run, tmp_path)


@pytest.mark.parametrize("kind", ["mem", "dir"])
def test_blob_unavailable_fault_is_typed(tmp_path, kind):
    def run(pk, d):
        store = pk.BlobStore(_backend(pk, kind, d))
        store.put_snapshot("t", 0, 1, b"x")
        pk.faults.inject("blob-unavailable", times=1)
        with pytest.raises(pk.BlobUnavailableError) as e:
            store.manifest("t", 0)
        assert store.covered_version("t", 0) == 1
        return str(e.value), e.value.status
    dual(run, tmp_path)


# ---------------------------------------------------------------------------
# stateless workers
# ---------------------------------------------------------------------------

def test_cold_worker_writes_continue_blob_numbering(tmp_path):
    def run(pk, d):
        blob = pk.BlobStore(pk.MemBackend())
        src = pk.DAXService(str(d / "src"), n_workers=1, blob=blob)
        tier_seed(src, 2)
        checkpoint(src)
        covered0 = blob.covered_version("t", 0)
        assert covered0 > 0
        src.close()
        cold = cold_service(pk, d, "cold", blob)
        try:
            cold.queryer.import_bits("t", "f", [3], [7])
            w = cold.workers[0]
            assert w.wl.version("t", 0) == covered0 + 1
            assert w.hyd.seal_tail("t", 0) == 1
            assert blob.covered_version("t", 0) == covered0 + 1
            r = cold.queryer.query("t", "Row(f=3)")
            assert r["results"][0]["columns"] == [7]
            return covered0, r, mem_objects(blob)
        finally:
            cold.close()
    dual(run, tmp_path, **TIER_KNOBS)


def test_prefetch_warms_cold_shards(tmp_path):
    def run(pk, d):
        blob = pk.BlobStore(pk.MemBackend())
        src = pk.DAXService(str(d / "src"), n_workers=1, blob=blob)
        tier_seed(src, 6)
        checkpoint(src)
        src.close()
        pk.knobs(prefetch=3)
        cold = cold_service(pk, d, "cold", blob)
        try:
            w = cold.workers[0]
            pk.InternalClient()._request(
                w.uri, "POST", "/index/t/query",
                {"query": "Count(Row(f=1))", "shards": [0]})
            deadline = time.monotonic() + 10
            while time.monotonic() < deadline \
                    and len(w.hyd._resident) < 1 + 3:
                time.sleep(0.02)
            assert len(w.hyd._resident) >= 1 + 3
            return len(w.hyd._resident) >= 4
        finally:
            cold.close()
    dual(run, tmp_path, **TIER_KNOBS)


def test_kill_switch_ab_bit_exact(tmp_path):
    """The tier kill-switch ([dax] blob = false, set through the Config
    for the port) drops workers back to local-disk snapshot+log
    hydration; results match the blob path bit-exact."""
    def run(pk, d):
        blob = pk.BlobStore(pk.MemBackend())
        svc = pk.DAXService(str(d / "svc"), n_workers=2, blob=blob)
        try:
            tier_seed(svc, 6)
            checkpoint(svc)
            on = results(svc)

            def evict_all():
                for w in svc.workers:
                    for t, shards in list(w.held.items()):
                        for s in sorted(shards):
                            with w._lock:
                                w.hyd.release(t, s)
                                w.held[t].add(s)

            pk.knobs(blob=False)
            assert not pk.settings.blob_enabled()
            evict_all()
            off = results(svc)
            pk.knobs(blob=True)
            assert pk.settings.blob_enabled()
            evict_all()
            again = results(svc)
            assert off == on and again == on
            return on, off, again
        finally:
            svc.close()
    dual(run, tmp_path, **TIER_KNOBS)


def test_blob_unavailable_query_typed_503(tmp_path):
    def run(pk, d):
        blob = pk.BlobStore(pk.MemBackend())
        src = pk.DAXService(str(d / "src"), n_workers=1, blob=blob)
        tier_seed(src, 4)
        checkpoint(src)
        oracle = results(src)
        src.close()
        cold = cold_service(pk, d, "cold", blob)
        try:
            pk.faults.inject("blob-unavailable", times=0)
            with pytest.raises(pk.RemoteError) as ei:
                cold.queryer.query("t", "Count(Row(f=1))")
            assert ei.value.status == 503
            assert "blob tier unavailable" in str(ei.value)
            pk.faults.clear("blob-unavailable")
            got = results(cold)
            assert got == oracle
            return ei.value.status, oracle, got
        finally:
            cold.close()
    dual(run, tmp_path, **TIER_KNOBS)


def test_worker_hydrate_crash_leaves_shard_cold(tmp_path):
    def run(pk, d):
        blob = pk.BlobStore(pk.MemBackend())
        src = pk.DAXService(str(d / "src"), n_workers=1, blob=blob)
        tier_seed(src, 4)
        checkpoint(src)
        oracle = results(src)
        src.close()
        cold = cold_service(pk, d, "cold", blob)
        try:
            w = cold.workers[0]
            pk.faults.inject("worker-hydrate-crash", times=1)
            with pytest.raises(pk.RemoteError) as ei:
                cold.queryer.query("t", "Count(Row(f=1))")
            assert not w.hyd._resident
            got = results(cold)
            assert got == oracle
            return ei.value.status, got
        finally:
            cold.close()
    dual(run, tmp_path, **TIER_KNOBS)


def test_query_for_unheld_shard_is_typed_409(tmp_path):
    def run(pk, d):
        blob = pk.BlobStore(pk.MemBackend())
        src = pk.DAXService(str(d / "src"), n_workers=1, blob=blob)
        try:
            tier_seed(src, 4)
            w = src.workers[0]
            with pytest.raises(pk.RemoteError) as ei:
                pk.InternalClient()._request(
                    w.uri, "POST", "/index/t/query",
                    {"query": "Count(Row(f=1))", "shards": [2, 99]})
            assert ei.value.status == 409
            assert "does not hold" in str(ei.value)
            cnt = src.queryer.query("t", "Count(Row(f=1))")["results"]
            assert cnt == [4]
            return ei.value.status, cnt
        finally:
            src.close()
    dual(run, tmp_path, **TIER_KNOBS)


def test_directive_release_drains_inflight_readers(tmp_path):
    import threading

    def run(pk, d):
        blob = pk.BlobStore(pk.MemBackend())
        src = pk.DAXService(str(d / "src"), n_workers=1, blob=blob)
        try:
            tier_seed(src, 4)
            w = src.workers[0]
            key = ("t", 2)
            with w._lock:
                w._shard_readers[key] = 1
            applied = threading.Event()

            def revoke():
                w.apply_directive(pk.Directive(
                    address=w.address, version=w.directive_version + 1,
                    assignments={"t": [0, 1, 3]}))
                applied.set()

            th = threading.Thread(target=revoke, daemon=True)
            th.start()
            time.sleep(0.3)
            rec = [applied.is_set(), w._release_epoch.get(key, 0),
                   2 in w.held.get("t", set())]
            assert rec == [False, 0, False]
            with w._lock:
                del w._shard_readers[key]
                w._readers_cv.notify_all()
            th.join(10)
            assert applied.is_set()
            assert w._release_epoch.get(key, 0) == 1
            return rec
        finally:
            src.close()
    dual(run, tmp_path, **TIER_KNOBS)


def test_import_blob_outage_rejects_write_typed(tmp_path):
    def run(pk, d):
        blob = pk.BlobStore(pk.MemBackend())
        src = pk.DAXService(str(d / "src"), n_workers=1, blob=blob)
        tier_seed(src, 2)
        checkpoint(src)
        src.close()
        cold = cold_service(pk, d, "cold", blob)
        try:
            pk.faults.inject("blob-unavailable", times=0)
            with pytest.raises(pk.RemoteError) as ei:
                cold.queryer.import_bits("t", "f", [9], [3])
            assert ei.value.status == 503
            pk.faults.clear("blob-unavailable")
            cold.queryer.import_bits("t", "f", [9], [3])
            r = cold.queryer.query("t", "Row(f=9)")
            assert r["results"][0]["columns"] == [3]
            return ei.value.status, r
        finally:
            cold.close()
    dual(run, tmp_path, **TIER_KNOBS)


# ---------------------------------------------------------------------------
# the two packages on one tier, byte for byte
# ---------------------------------------------------------------------------

def test_tier_objects_and_logs_equal_byte_for_byte(tmp_path):
    """The same seeded writes, checkpoint and seal: both packages' blob
    objects (snapshots, segments, manifests), shared write-log files and
    local snapshot files are equal byte for byte."""
    def run(pk, d):
        blob = pk.BlobStore(pk.LocalDirBackend(str(d / "blob")))
        svc = pk.DAXService(str(d / "svc"), n_workers=2, blob=blob)
        try:
            cols = tier_seed(svc, 6)
            checkpoint(svc)
            svc.queryer.import_bits("t", "f", [2] * 6,
                                    [c + 1 for c in cols])
            svc.queryer.import_values("t", "v", cols[:3], [1, 2, 3])
            seal(svc)
            return {"blob": tree_bytes(d / "blob"),
                    "writelog": tree_bytes(d / "svc" / "writelog"),
                    "snapshots": tree_bytes(d / "svc" / "snapshots"),
                    "answers": results(svc)}
        finally:
            svc.close()
    rec = dual(run, tmp_path, **TIER_KNOBS)
    assert any(k.endswith("manifest.json") for k in rec["blob"])
    assert any("/seg.v" in k for k in rec["blob"])


def test_snapshot_codec_bytes_equal(tmp_path):
    """snapshot_fragment_rows gives the same bytes in both packages for
    the same rows, and each package's load reads the other's."""
    from pilosa_tpu.dax.snapshotter import (
        load_fragment_rows as jax_load,
        snapshot_fragment_rows as jax_snap,
    )
    from pilosa_tpu_torch.dax.snapshotter import (
        load_fragment_rows,
        snapshot_fragment_rows,
    )
    rng = np.random.default_rng(18)
    rows = {("f", "standard", int(r)): rng.integers(
        0, 1 << 32, size=SHARD // 32, dtype=np.uint32) for r in range(5)}
    rows[("v", "bsig_v", 0)] = np.zeros(SHARD // 32, dtype=np.uint32)
    data = snapshot_fragment_rows(rows)
    assert data == jax_snap(rows)
    for load in (load_fragment_rows, jax_load):
        back = load(data)
        assert list(back) == list(rows)
        for k, w in rows.items():
            assert back[k].dtype == np.uint32
            assert np.array_equal(back[k], w)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_tier_written_by_one_package_hydrates_the_other(tmp_path, writer):
    """A dir tier (snapshots, then sealed segments) written by one
    package's fleet hydrates a cold worker of the other package to the
    writer's answers."""
    reader = "port" if writer == "jax" else "jax"
    root = tmp_path / "blob"
    w_pk = Pkg(writer, **TIER_KNOBS)
    blob = w_pk.BlobStore(w_pk.LocalDirBackend(str(root)))
    src = w_pk.DAXService(str(tmp_path / "src"), n_workers=2, blob=blob)
    try:
        cols = tier_seed(src, N)
        checkpoint(src)
        src.queryer.import_bits("t", "f", [2] * N, [c + 1 for c in cols])
        seal(src)
        oracle = results(src)
    finally:
        src.close()
    r_pk = Pkg(reader, **TIER_KNOBS)
    cold = cold_service(r_pk, tmp_path, "cold",
                        r_pk.BlobStore(r_pk.LocalDirBackend(str(root))))
    try:
        assert results(cold) == oracle
        p = cold.workers[0].hyd.payload()
        assert p["hydrations"] == N and p["evictions"] == 0
    finally:
        cold.close()


def test_hydrated_words_reach_the_device_stacks(tmp_path):
    """The port's stacked engine sees hydrated, released and
    re-hydrated fragments as new data: after each step the next query
    patches or builds its stacks and answers from the words it was
    given, never from a released shard's stacks."""
    pk = Pkg("port", **TIER_KNOBS)
    blob = pk.BlobStore(pk.MemBackend())
    src = pk.DAXService(str(tmp_path / "src"), n_workers=1, blob=blob)
    try:
        tier_seed(src, 4)
        checkpoint(src)
    finally:
        src.close()
    cold = cold_service(pk, tmp_path, "cold", blob)
    try:
        w = cold.workers[0]
        cache = w.api.executor.stacked.cache
        q = "Count(Row(f=1))"
        assert cold.queryer.query("t", q)["results"] == [4]
        c0 = cache.counters()
        with w._lock:
            w.hyd.release("t", 2)   # held stays: the next touch re-hydrates
        assert not w.hyd.resident("t", 2)
        # a write lands in the shard's write-log tail while it is cold:
        # its re-hydrate replays it over the snapshot and must serve it
        w.wl.append("t", 2, {"op": "bits", "table": "t", "field": "f",
                             "rows": [1], "cols": [2 * SHARD + 9]})
        assert cold.queryer.query("t", q)["results"] == [5]
        c1 = cache.counters()
        moved = (c1["patches"] + c1["adopts"] + c1["full_rebuilds"]) - \
            (c0["patches"] + c0["adopts"] + c0["full_rebuilds"])
        assert moved >= 1, (c0, c1)
        assert w.hyd.resident("t", 2)
        # released and the assignment revoked: the shard answers from no
        # stack of this worker
        w.apply_directive(pk.Directive(
            address=w.address, version=w.directive_version + 1,
            schema=cold.controller.schema, assignments={"t": [0, 1, 3]}))
        got = w.api.query("t", "Count(Union(Row(f=1), Row(f=3)))",
                          shards=[0, 1, 2, 3])["results"]
        assert got == [3]
    finally:
        cold.close()


# ---------------------------------------------------------------------------
# surfaces: /debug/dax, /dax/residency, metrics
# ---------------------------------------------------------------------------

def test_debug_dax_surface(tmp_path):
    def run(pk, d):
        blob = pk.BlobStore(pk.MemBackend())
        src = pk.DAXService(str(d / "src"), n_workers=0, blob=blob)
        try:
            src.add_worker("dbg-w0")
            tier_seed(src, 4)
            checkpoint(src)
            w = src.workers[0]
            with urllib.request.urlopen(
                    f"http://{w.uri}/debug/dax", timeout=10) as r:
                body = json.loads(r.read())
            assert {"workers", "controllers"} <= set(body)
            mine = [p for p in body["workers"]
                    if p["worker"] == w.address]
            assert mine and mine[0]["resident"]
            assert mine[0]["assigned"]["t"] == [0, 1, 2, 3]
            with urllib.request.urlopen(
                    f"http://{w.uri}/dax/residency", timeout=10) as r:
                res = json.loads(r.read())
            assert res["worker"] == w.address
            assert res["blob"] is True
            ctl = [c for c in body["controllers"]
                   if c["workers"] == ["dbg-w0"]]
            assert ctl
            return sorted(body), mine[0], res, ctl[-1]
        finally:
            src.close()
    dual(run, tmp_path, **TIER_KNOBS)


def test_dax_metrics_move(tmp_path):
    def run(pk, d):
        m = pk.metrics
        blob = pk.BlobStore(pk.MemBackend())
        put0 = m.DAX_BLOB_BYTES.total(op="put")
        hyd0 = m.DAX_HYDRATIONS.total()
        src = pk.DAXService(str(d / "src"), n_workers=1, blob=blob)
        try:
            tier_seed(src, 2)
            checkpoint(src)
            rec = [m.DAX_BLOB_BYTES.total(op="put") - put0,
                   m.DAX_HYDRATIONS.total() - hyd0,
                   m.DAX_RESIDENT_SHARDS.value(
                       worker=src.workers[0].address)]
            assert rec[0] > 0 and rec[1] > 0 and rec[2] == 2
            return rec
        finally:
            src.close()
    dual(run, tmp_path, **TIER_KNOBS)


# ---------------------------------------------------------------------------
# config plumbing
# ---------------------------------------------------------------------------

_TOML = """
[blob]
backend = "dir"
root = "/data/blob"

[dax]
worker-budget-bytes = 4096
scale-out-burn = 3.5
max-workers = 4
lazy-hydrate = false
"""


def test_dax_config_stanzas_and_env_twins(tmp_path):
    """The same file and environment give equal [dax]/[blob] fields in
    both packages, and apply_dax_settings pushes them into each
    package's settings module.  The port's accessors read what config
    pushed, never the environment: a variable set after the load moves
    the JAX accessor only."""
    from pilosa_tpu import config as jcfg
    from pilosa_tpu.dax import settings as jset
    from pilosa_tpu_torch import config as pcfg
    from pilosa_tpu_torch.dax import settings as pset
    p = tmp_path / "server.toml"
    p.write_text(_TOML)
    for cfgmod in (jcfg, pcfg):
        c = cfgmod.load(env={})
        assert (c.dax_blob, c.blob_backend, c.dax_max_workers) \
            == (True, "", 8)
    j, c = jcfg.load(str(p), env={}), pcfg.load(str(p), env={})
    assert {k: v for k, v in vars(c).items()
            if k.startswith(("dax_", "blob_"))} == \
        {k: v for k, v in vars(j).items()
         if k.startswith(("dax_", "blob_"))}
    assert (c.blob_backend, c.blob_root, c.dax_worker_budget_bytes,
            c.dax_scale_out_burn, c.dax_max_workers,
            c.dax_lazy_hydrate) == ("dir", "/data/blob", 4096, 3.5, 4,
                                    False)
    env = {"PILOSA_TPU_DAX_MAX_WORKERS": "6"}
    assert pcfg.load(str(p), env=env).dax_max_workers == \
        jcfg.load(str(p), env=env).dax_max_workers == 6
    c.apply_dax_settings()
    j.apply_dax_settings()
    for s in (pset, jset):
        assert s.backend() == "dir"
        assert s.worker_budget_bytes() == 4096
        assert s.scale_out_burn() == 3.5
        assert not s.lazy_hydrate()
    os.environ["PILOSA_TPU_DAX_SCALE_OUT_BURN"] = "7.25"
    assert jset.scale_out_burn() == 7.25
    assert pset.scale_out_burn() == 3.5
    assert pcfg.load(str(p)).dax_scale_out_burn == 7.25


def test_kill_switch_outranks_config(tmp_path):
    """PILOSA_TPU_DAX_BLOB=0 turns the tier off in both packages: the
    JAX accessor reads it live, the port's config.load reads it into
    dax_blob, which apply_dax_settings pushes."""
    from pilosa_tpu import config as jcfg
    from pilosa_tpu.dax import settings as jset
    from pilosa_tpu_torch import config as pcfg
    from pilosa_tpu_torch.dax import settings as pset
    os.environ["PILOSA_TPU_DAX_BLOB"] = "0"
    j = jcfg.load()
    j.dax_blob = True
    j.apply_dax_settings()
    assert not jset.blob_enabled()
    c = pcfg.load()
    assert c.dax_blob is False
    c.apply_dax_settings()
    assert not pset.blob_enabled()
    del os.environ["PILOSA_TPU_DAX_BLOB"]
    assert jset.blob_enabled()
    assert not pset.blob_enabled()
    pcfg.load().apply_dax_settings()
    assert pset.blob_enabled()


def test_generate_config_has_dax_stanzas():
    from pilosa_tpu.cli.main import DEFAULT_CONFIG as jax_default
    from pilosa_tpu_torch.cli.main import DEFAULT_CONFIG
    assert DEFAULT_CONFIG == jax_default
    for s in ("[dax]", "[blob]", "worker-budget-bytes", "scale-out-burn"):
        assert s in DEFAULT_CONFIG


def test_blob_from_settings_respects_switch(tmp_path):
    def run(pk, d):
        assert pk.blob_from_settings(str(d)) is None
        pk.settings.configure(backend="dir", root="")
        b = pk.blob_from_settings(str(d))
        assert b is not None
        assert b.backend.root == os.path.join(str(d), "blob")
        pk.knobs(blob=False)
        assert pk.blob_from_settings(str(d)) is None
        return os.path.relpath(b.backend.root, str(d))
    dual(run, tmp_path)


def test_service_takes_blob_tier_from_its_config(tmp_path):
    """A port DAXService with [blob] backend = "dir" in its Config (as
    `cli dax --config` gives it) builds its tier under the storage dir;
    its workers' boots keep the knobs the Config set."""
    pk = Pkg("port", **TIER_KNOBS)
    pk.cfg.blob_backend = "dir"
    pk.cfg.dax_chase_rounds = 7
    svc = pk.DAXService(str(tmp_path / "svc"), n_workers=0)
    try:
        assert svc.blob is not None
        assert svc.blob.backend.root == str(tmp_path / "svc" / "blob")
        svc.add_blob_worker("w0")
        svc.add_blob_worker("w1")
        assert pk.settings.chase_rounds() == 7
        assert pk.settings.prefetch() == 0
    finally:
        svc.close()


# ---------------------------------------------------------------------------
# writelogger fast-forward
# ---------------------------------------------------------------------------

def test_writelogger_fast_forward(tmp_path):
    def run(pk, d):
        wl = pk.WriteLogger(str(d / "wl"))
        wl.append("t", 0, {"op": "bits", "rows": [1], "cols": [2]})
        wl.append("t", 0, {"op": "bits", "rows": [1], "cols": [3]})
        wl.fast_forward("t", 0, 10)
        assert wl.version("t", 0) == 10
        assert wl.replay("t", 0, from_version=0) == []
        v = wl.append("t", 0, {"op": "bits", "rows": [1], "cols": [4]})
        assert v == 11
        assert len(wl.replay("t", 0, from_version=10)) == 1
        wl.fast_forward("t", 0, 5)
        assert wl.version("t", 0) == 11
        return tree_bytes(d / "wl")
    dual(run, tmp_path)


def test_service_and_worker_need_a_card_unless_told_cpu(tmp_path,
                                                        monkeypatch):
    """No fallback: a DAXService, a ComputeNode and the queryer on no
    card raise unless told device="cpu"."""
    import torch

    from pilosa_tpu_torch.dax.computer import ComputeNode
    from pilosa_tpu_torch.dax.server import DAXService
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pk = Pkg("port")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DAXService(str(tmp_path / "a"), n_workers=0, config=pk.cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ComputeNode("w", pk.WriteLogger(str(tmp_path / "wl")),
                    pk.Snapshotter(str(tmp_path / "sn")), config=pk.cfg)
    svc = DAXService(str(tmp_path / "b"), n_workers=1, device="cpu",
                     config=pk.cfg)
    try:
        svc.queryer.apply_schema(SCHEMA)
        assert svc.workers[0].api.executor.device.type == "cpu"
        assert svc.queryer.sql("SELECT count(*) FROM t")["data"] == [[0]]
    finally:
        svc.close()
