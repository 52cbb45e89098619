"""The port's DAX autoscaling and paging against the JAX package's
(tests/test_dax_tier.py's scale and cold-start cases): a cold worker
paging a corpus 10x over its budget, live scale-out and scale-in under
writes, the interruption drills, the reconcile thresholds and the
scale state a restarted controller resumes.

Each case runs one scenario on both packages (tests/torch_dax_dual.py),
asserts test_dax_tier.py's expectations on each, and asserts the two
records equal (wire answers, move plans and outcomes, residency and
blob objects byte for byte).  The port's knobs (cooldown among them)
are set through its services' Config."""

import pytest

from torch_dax_dual import (
    TIER_KNOBS,
    checkpoint,
    cold_service,
    dax_globals,
    dual,
    results,
    seal,
    seed,
)

N = 24
_SIG = {"burn": 9.9, "pressure": {}, "shed": 0, "shed_delta": 0.0}


@pytest.fixture(autouse=True)
def _globals():
    with dax_globals():
        yield


def tier_seed(svc, n_shards=N):
    return seed(svc, n_shards, [(s % 90) + 10 for s in range(n_shards)])


def blob_fleet(pk, d, standbys=1):
    blob = pk.BlobStore(pk.MemBackend())
    svc = pk.DAXService(str(d / "fleet"), n_workers=0, blob=blob)
    svc.add_blob_worker("w0")
    for i in range(standbys):
        svc.add_standby(f"s{i}")
    return svc


def test_cold_start_bit_exact_10x_over_budget(tmp_path):
    """An empty-data-dir worker hydrating snapshot+segments from blob
    through a ledger >= 10x smaller than the corpus answers bit-exact,
    paging residency (evictions > 0, resident bytes never over
    budget)."""
    def run(pk, d):
        blob = pk.BlobStore(pk.MemBackend())
        src = pk.DAXService(str(d / "src"), n_workers=2, blob=blob)
        try:
            cols = tier_seed(src)
            checkpoint(src)
            src.queryer.import_bits("t", "f", [2] * N,
                                    [c + 1 for c in cols])
            seal(src)
            oracle = results(src)
            probe = cold_service(pk, d, "probe", blob)
            try:
                assert results(probe) == oracle
                total = probe.workers[0].hyd.payload()["resident_bytes"]
            finally:
                probe.close()
            budget = max(total // 12, 64)
            assert total >= 10 * budget
            cold = cold_service(pk, d, "cold", blob, budget=budget)
            try:
                got = results(cold)
                assert got == oracle
                p = cold.workers[0].hyd.payload()
                assert p["resident_bytes"] <= budget
                assert p["evictions"] > 0
                assert p["hydrations"] > N
                assert p["pressure"] <= 1.0
                return {"oracle": oracle, "got": got, "total": total,
                        "payload": {k: v for k, v in p.items()
                                    if k != "worker"},
                        "blob": dict(blob.backend._objects)}
            finally:
                cold.close()
        finally:
            src.close()
    dual(run, tmp_path, **TIER_KNOBS)


def test_scale_out_then_in_storm_bit_exact(tmp_path):
    def run(pk, d):
        pk.incidents.get().clear()
        svc = blob_fleet(pk, d)
        try:
            cols = tier_seed(svc)
            checkpoint(svc)
            before = results(svc)
            out = svc.controller._scale_out(dict(_SIG))
            assert out["outcome"] == "done"
            assert sorted(svc.controller.workers) == ["s0", "w0"]
            moved = [k for k, v in out["outcomes"].items() if v == "done"]
            assert len(moved) >= 5
            assert svc.controller._fences == {}
            assert results(svc) == before
            svc.queryer.import_bits("t", "f", [2] * N,
                                    [c + 1 for c in cols])
            after_w = results(svc)
            assert after_w["row2"] == [c + 1 for c in cols]
            inn = svc.controller._scale_in(dict(_SIG))
            assert inn["outcome"] == "done"
            assert sorted(svc.controller.workers) == ["w0"]
            assert "s0" in svc.controller.standbys
            assert svc.controller._fences == {}
            assert results(svc) == after_w
            mgr = pk.incidents.get()
            assert mgr.wait_idle(30)
            got = {b["trigger"]: b for b in mgr.payload()["incidents"]}
            assert {"dax-scale-out", "dax-scale-in"} <= set(got)
            ctx = mgr.fetch(got["dax-scale-out"]["id"])["context"]
            assert ctx["admitted"] == "s0"
            assert ctx["plan"] and all(v in ("done", "noop")
                                       for v in ctx["outcomes"].values())
            return {"before": before, "after": after_w, "out": out,
                    "in": inn, "plan": ctx["plan"]}
        finally:
            svc.close()
    dual(run, tmp_path, **TIER_KNOBS)


def test_interrupted_scale_out_resumes(tmp_path):
    def run(pk, d):
        svc = blob_fleet(pk, d)
        try:
            tier_seed(svc)
            checkpoint(svc)
            before = results(svc)
            pk.faults.inject("scale-event-interrupted", times=1)
            out = svc.controller._scale_out(dict(_SIG))
            assert out["outcome"] == "partial"
            assert svc.controller._fences == {}
            assert results(svc) == before
            d2 = svc.controller.reconcile_once()
            assert d2["action"] == "resume"
            assert all(v in ("done", "noop")
                       for v in d2["outcomes"].values())
            assert svc.controller._pending_moves_locked() == []
            assert results(svc) == before
            return before, out, d2["outcomes"]
        finally:
            svc.close()
    dual(run, tmp_path, **TIER_KNOBS)


def test_interrupted_scale_in_resumes_drain(tmp_path):
    def run(pk, d):
        svc = blob_fleet(pk, d)
        try:
            tier_seed(svc)
            checkpoint(svc)
            assert svc.controller._scale_out(dict(_SIG))["outcome"] \
                == "done"
            before = results(svc)
            pk.faults.inject("scale-event-interrupted", times=1)
            inn = svc.controller._scale_in(dict(_SIG))
            assert inn["outcome"] == "partial"
            assert sorted(svc.controller.workers) == ["s0", "w0"]
            assert svc.controller._draining == "s0"
            assert results(svc) == before
            d2 = svc.controller.reconcile_once()
            assert d2["action"] == "resume-drain"
            assert d2["outcome"] == "done"
            assert sorted(svc.controller.workers) == ["w0"]
            assert svc.controller._draining is None
            assert svc.controller._fences == {}
            assert results(svc) == before
            return before, inn, d2["outcomes"]
        finally:
            svc.close()
    dual(run, tmp_path, **TIER_KNOBS)


def test_reconcile_thresholds_drive_scaling(tmp_path):
    """High burn admits the standby, calm burn drains it, and the
    cooldown (set through the port's Config) gates back-to-back
    events."""
    def run(pk, d):
        svc = blob_fleet(pk, d)
        try:
            tier_seed(svc, 8)
            checkpoint(svc)
            burn = {"v": 0.0}
            svc.controller.signals = lambda: dict(_SIG, burn=burn["v"])
            acts = [svc.controller.reconcile_once()["action"]]
            burn["v"] = 5.0
            acts.append(svc.controller.reconcile_once()["action"])
            assert sorted(svc.controller.workers) == ["s0", "w0"]
            pk.knobs(cooldown_s=3600)
            burn["v"] = 0.0
            acts.append(svc.controller.reconcile_once()["action"])
            pk.knobs(cooldown_s=0)
            acts.append(svc.controller.reconcile_once()["action"])
            assert acts == ["none", "scale-out", "none", "scale-in"]
            assert sorted(svc.controller.workers) == ["w0"]
            assert svc.controller.last_reconcile["action"] == "scale-in"
            return acts
        finally:
            svc.close()
    dual(run, tmp_path, **TIER_KNOBS)


def test_scale_state_survives_controller_restart(tmp_path):
    def run(pk, d):
        svc = blob_fleet(pk, d)
        try:
            tier_seed(svc)
            checkpoint(svc)
            pk.faults.inject("scale-event-interrupted", times=1)
            assert svc.controller._scale_out(dict(_SIG))["outcome"] \
                == "partial"
            pend = svc.controller._pending_moves_locked()
            assert pend
            svc.restart_controller()
            for w in svc.workers:
                svc.controller.register_worker(w.address, w.uri)
            assert svc.controller._pending_moves_locked() == pend
            d2 = svc.controller.reconcile_once()
            assert d2["action"] == "resume"
            assert svc.controller._pending_moves_locked() == []
            return pend, d2["outcomes"]
        finally:
            svc.close()
    dual(run, tmp_path, **TIER_KNOBS)


def test_restarted_controller_numbers_directives_past_grants(tmp_path):
    """A migration's grant directive is saved with its version, so a
    controller restarted after a scale-out pushes directives its workers
    enact: the fleet answers exactly afterwards.  The JAX controller
    keeps the grant's version in memory only; its restarted controller
    numbers the admitted worker's next directive at the grant's version,
    the worker drops it as stale, and reads of the shards moved to it
    exhaust their ownership retries (ROADMAP C)."""
    from torch_dax_dual import Pkg
    pk = Pkg("port", **TIER_KNOBS)
    svc = blob_fleet(pk, tmp_path)
    try:
        tier_seed(svc)
        checkpoint(svc)
        before = results(svc)
        pk.faults.inject("scale-event-interrupted", times=1)
        assert svc.controller._scale_out(dict(_SIG))["outcome"] \
            == "partial"
        svc.restart_controller()
        for w in svc.workers:
            svc.controller.register_worker(w.address, w.uri)
        assert svc.controller.reconcile_once()["action"] == "resume"
        assert results(svc) == before
        held = {w.address: {t: sorted(s) for t, s in w.held.items()}
                for w in svc.workers}
        assert held == {a: asg for a, asg in
                        svc.controller.assignments().items()}
    finally:
        svc.close()
