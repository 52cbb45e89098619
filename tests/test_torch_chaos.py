"""The port's chaos seams against the JAX package's, on the same data.

Each fault point the port carries is armed in both packages on the same
seeded recipe: ``torn-write`` in the key translator's log,
``crash-post-append`` in the fragment's delta log, ``wal-torn`` and
``crash-pre-checkpoint`` in a shard's sync, and ``device-patch`` in the
stacked engine's patcher.  The storage faults leave the same state on
disk: after a reopen the holders are equal and answer the same.  The
injected ``device-patch`` fault is answered by a rebuild counted under
the reason "fault" (the JAX package's cache rebuilds too), while any
other exception out of a patch still propagates.  The port's testhook
audits its RBF handles here: none is left open.  The port runs on the
CPU (device="cpu")."""

import datetime as dt
import types

import numpy as np
import pytest
import torch

from pilosa_tpu.executor.executor import Executor as JaxExecutor
from pilosa_tpu.models import holder as jax_holder_mod
from pilosa_tpu.models import schema as jax_schema
from pilosa_tpu.obs import faults as jax_faults
from pilosa_tpu.storage import translate as jax_translate
from pilosa_tpu_torch.executor.executor import Executor
from pilosa_tpu_torch.models import holder as holder_mod
from pilosa_tpu_torch.models import schema
from pilosa_tpu_torch.models.state import holder_state
from pilosa_tpu_torch.obs import faults, metrics, testhook
from pilosa_tpu_torch.ops import bitmap as bm
from pilosa_tpu_torch.storage import translate
from test_torch_executor import _norm, _same_state, jax_state

torch.set_num_threads(1)

W = 2048

PKGS = {
    "port": types.SimpleNamespace(
        Holder=holder_mod.Holder, FieldOptions=schema.FieldOptions,
        FieldType=schema.FieldType, TimeQuantum=schema.TimeQuantum,
        state=holder_state, faults=faults, translate=translate,
        execute=lambda h, q: _norm(Executor(h, device="cpu").execute("c", q))),
    "jax": types.SimpleNamespace(
        Holder=jax_holder_mod.Holder, FieldOptions=jax_schema.FieldOptions,
        FieldType=jax_schema.FieldType, TimeQuantum=jax_schema.TimeQuantum,
        state=jax_state, faults=jax_faults, translate=jax_translate,
        execute=lambda h, q: _norm(JaxExecutor(h).execute("c", q))),
}

QUERIES = ["Row(f=1)", "Count(Row(f=2))", "Sum(field=v)",
           "Count(Row(ev=1, from='2022-06-01T00:00', to='2022-06-03T00:00'))"]


@pytest.fixture(autouse=True)
def audited(monkeypatch):
    """RBF_NOSYNC as the storage tests set it, every fault disarmed
    after the test, and the port's testhook on: every RBF handle the
    port opens in the test is closed by its end."""
    monkeypatch.setenv("RBF_NOSYNC", "1")
    monkeypatch.setattr(testhook, "ENABLED", True)
    testhook.reset()
    yield
    for pkg in PKGS.values():
        pkg.faults.clear()
    leaked = testhook.audit()
    testhook.reset()
    assert leaked == {}, leaked


def _load(pkg, h, n=300, seed=3):
    """Index c: a set field f, an INT v and a TIME field ev over 3
    shards, seeded."""
    rng = np.random.default_rng(seed)
    idx = h.create_index("c")
    f = idx.create_field("f")
    v = idx.create_field("v", pkg.FieldOptions(type=pkg.FieldType.INT,
                                               min=0, max=500))
    ev = idx.create_field("ev", pkg.FieldOptions(
        type=pkg.FieldType.TIME, time_quantum=pkg.TimeQuantum("YMD")))
    cols = rng.integers(0, 3 * W, size=n)
    f.import_bits(rng.integers(0, 4, size=n), cols)
    vc = np.unique(cols)
    v.import_values(vc, rng.integers(0, 501, size=vc.size))
    ev.import_bits(np.ones(n // 3, np.int64), cols[:n // 3],
                   [dt.datetime(2022, 6, 1 + i % 4) for i in range(n // 3)])
    return idx


def _more(pkg, idx, seed=4):
    rng = np.random.default_rng(seed)
    cols = rng.integers(0, 3 * W, size=50)
    idx.field("f").import_bits(rng.integers(0, 4, size=50), cols)
    idx.field("v").import_values(cols[:10], rng.integers(0, 501, size=10))


def _reopened(pkg, path):
    h = pkg.Holder(path=path, width=W)
    h.load_schema()
    return h


def _both(tmp_path, scenario):
    """scenario(pkg, holder) on each package's path-backed holder; then
    close, reopen, and hold the reopened states and answers equal.
    Returns {pkg name: (scenario's result, answers after the reopen)}."""
    out, states = {}, {}
    for name, pkg in PKGS.items():
        path = str(tmp_path / name)
        h = pkg.Holder(path=path, width=W)
        try:
            got = scenario(pkg, h)
        finally:
            h.close()
        h2 = _reopened(pkg, path)
        try:
            states[name] = pkg.state(h2)
            out[name] = (got, [pkg.execute(h2, q) for q in QUERIES])
        finally:
            h2.close()
    _same_state(states["port"], states["jax"])
    assert out["port"] == out["jax"]
    return out


def test_wal_torn_drops_the_torn_commit_in_both(tmp_path):
    def scenario(pkg, h):
        idx = _load(pkg, h)
        h.sync()
        _more(pkg, idx)
        pkg.faults.inject("wal-torn", times=1)
        with pytest.raises(pkg.faults.InjectedFault):
            idx.sync()
        frag = idx.field("f").views["standard"].fragments
        return any(fr.dirty_rows for fr in frag.values())

    out = _both(tmp_path, scenario)
    assert out["port"][0] is True           # the failed sync left rows dirty


def test_wal_torn_reopens_as_the_last_durable_state(tmp_path):
    pkg = PKGS["port"]
    path = str(tmp_path / "p")
    h = pkg.Holder(path=path, width=W)
    idx = _load(pkg, h)
    h.sync()
    durable = pkg.state(h)
    _more(pkg, idx)
    faults.inject("wal-torn", times=1)
    with pytest.raises(faults.InjectedFault):
        idx.sync()
    h.close()
    h2 = _reopened(pkg, path)
    try:
        _same_state(pkg.state(h2), durable)
    finally:
        h2.close()


def test_crash_pre_checkpoint_is_durable_in_both(tmp_path):
    """Dying after a shard's WAL commit but before the checkpoint loses
    nothing of that commit: the reopen replays it."""
    def scenario(pkg, h):
        idx = _load(pkg, h)
        h.save_schema()
        pkg.faults.inject("crash-pre-checkpoint", times=1)
        with pytest.raises(pkg.faults.InjectedFault):
            idx.sync()

    out = _both(tmp_path, scenario)
    # the fault strikes after the first shard's commit: that shard's
    # rows came back from the WAL, the shards after it were never synced
    h = PKGS["port"].Holder(width=W)
    _load(PKGS["port"], h)
    (row,) = PKGS["port"].execute(h, "Row(f=1)")
    assert out["port"][1][0] == [[c for c in row if c < W]]


def test_crash_post_append_in_both(tmp_path):
    """The fault strikes after a write's delta entry landed: the bit is
    in memory, the version moved, and the next sync persists it."""
    def scenario(pkg, h):
        idx = _load(pkg, h)
        h.sync()
        f = idx.field("f")
        pkg.faults.inject("crash-post-append", match="c/f/standard/1",
                          times=1)
        with pytest.raises(pkg.faults.InjectedFault):
            f.set_bit(3, W + 17)
        frag = f.views["standard"].fragment(1)
        landed = bool(np.asarray(frag.row_words(3))[0] >> 17 & 1)
        f.set_bit(3, 17)               # a shard the rule does not match
        h.sync()
        return landed

    out = _both(tmp_path, scenario)
    assert out["port"][0] is True


@pytest.mark.parametrize("partition", [-1, 7])
def test_torn_write_drops_the_torn_key_in_both(tmp_path, partition):
    out = {}
    for name, pkg in PKGS.items():
        p = str(tmp_path / f"{name}.jsonl")
        st = pkg.translate.TranslateStore(path=p, index="i",
                                          partition_id=partition)
        first = st.create_keys("alpha", "beta")
        pkg.faults.inject("torn-write", match=p)
        with pytest.raises(pkg.faults.InjectedFault):
            st.create_keys("gamma")
        st.close()
        with open(p) as fh:
            torn = fh.read()
        st2 = pkg.translate.TranslateStore(path=p, index="i",
                                           partition_id=partition)
        try:
            after = (st2.find_keys("alpha", "beta", "gamma"),
                     st2.create_keys("delta"))
        finally:
            st2.close()
        out[name] = (first, torn, after)
    assert out["port"] == out["jax"]
    assert "gamma" not in out["port"][2][0]


def _device_patch_run(pkg, name):
    h = pkg.Holder(width=W)
    _load(pkg, h)
    ex = Executor(h, device="cpu") if name == "port" else JaxExecutor(h)
    q = "Count(Row(f=1))"
    first = ex.execute("c", q)
    ex.execute("c", f"Set({W + 5}, f=1)")
    pkg.faults.inject("device-patch", times=1)
    try:
        second = ex.execute("c", q)
    finally:
        pkg.faults.clear("device-patch")
    ex.execute("c", f"Set({W + 6}, f=1)")
    return ex, [first, second, ex.execute("c", q)]


def test_device_patch_fault_is_answered_by_a_counted_rebuild():
    faults0 = metrics.FAULTS_TOTAL.value(point="device-patch")
    ex, answers = _device_patch_run(PKGS["port"], "port")
    _jex, jax_answers = _device_patch_run(PKGS["jax"], "jax")
    assert answers == jax_answers
    c = ex.stacked.cache.counters()
    assert c["rebuilds"] == {"cold": 1, "fault": 1}
    assert c["patches"] == 1           # with the fault cleared, a patch
    assert metrics.FAULTS_TOTAL.value(point="device-patch") == faults0 + 1


def test_device_patch_seam_is_the_stacked_engines_only():
    """The per-shard engine's tiles carry no device-patch seam: an armed
    fault stays armed through its patch."""
    h = PKGS["port"].Holder(width=W)
    _load(PKGS["port"], h)
    ex = Executor(h, device="cpu")
    ex.use_stacked = False
    ex.execute("c", "Count(Row(f=1))")
    ex.execute("c", f"Set({W + 5}, f=1)")
    faults.inject("device-patch", times=1)
    ex.execute("c", "Count(Row(f=1))")
    assert [r["point"] for r in faults.active()] == ["device-patch"]
    assert ex.tiles.cache.rebuilds.get("fault", 0) == 0


def test_a_raising_patch_still_propagates(monkeypatch):
    h = PKGS["port"].Holder(width=W)
    _load(PKGS["port"], h)
    ex = Executor(h, device="cpu")
    ex.execute("c", "Count(Row(f=1))")
    ex.execute("c", f"Set({W + 5}, f=1)")

    def broken(*_a, **_k):
        raise RuntimeError("patch_rows failed")

    monkeypatch.setattr(bm, "patch_rows", broken)
    with pytest.raises(RuntimeError, match="patch_rows failed"):
        ex.execute("c", "Count(Row(f=1))")
    assert "fault" not in ex.stacked.cache.rebuilds


def test_fault_spec_arms_the_ports_registry():
    assert faults.configure("device-patch,times=2;torn-write@x") == 2
    assert sorted(r["point"] for r in faults.active()) == [
        "device-patch", "torn-write"]
    assert jax_faults.active() == []


def test_testhook_tracks_rbf_handles(tmp_path):
    """opened/closed for the port's rbf.DB: an open holder's shard files
    show in the audit, and close clears them."""
    h = PKGS["port"].Holder(path=str(tmp_path / "t"), width=W)
    _load(PKGS["port"], h)
    h.sync()
    assert len(testhook.audit().get("rbf.DB", [])) == 3
    h.close()
    assert testhook.audit() == {}
