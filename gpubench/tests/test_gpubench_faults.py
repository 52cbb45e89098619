"""A run with the timed path broken underneath comes out not correct:
the harness's run of a cell, its look for a card skipped, on a tiny
holder on the CPU, once for each fault a serving cell can have.

A cell on one card has no training step and no exchange between chips;
its faults are an answer altered where it is produced, and riders of a
serving batch left out of it (each given another rider's answer)."""

import dataclasses
import itertools

import pytest
import torch

from gpubench import run

CPU = torch.device("cpu")


def alter(res):
    """The result with its first count or value off by one."""
    if isinstance(res, bool):
        return res
    if isinstance(res, int):
        return res + 1
    if isinstance(res, list) and res:
        return [alter(res[0])] + res[1:]
    if dataclasses.is_dataclass(res):
        for f in ("count", "value"):
            if isinstance(getattr(res, f, None), int):
                return dataclasses.replace(res, **{f: getattr(res, f) + 1})
    return res


def cell_run(cell, tiny, seconds=1.0):
    import time
    return run.run_cell(cell, 2**34 + 3, seconds, False, CPU, time.time(),
                        cfg_over=tiny)


@pytest.mark.parametrize("cell", ["able-groupby-c8", "taxi-sql-c8"])
def test_sound_run_is_correct(cell, tiny):
    out = cell_run(cell, tiny)
    assert out["correct"], out["checks"]
    assert out["checks"]["checked"][0] > 0


@pytest.mark.parametrize("cell", ["able-groupby-c8", "taxi-sql-c8"])
def test_an_altered_answer(cell, tiny, monkeypatch):
    from pilosa_tpu_torch.executor.serving import ServingLayer
    orig = ServingLayer._execute_read
    turn = itertools.count()

    def broken(self, *a, **k):
        res = orig(self, *a, **k)
        return [alter(res[0])] + res[1:] if next(turn) % 5 == 0 else res
    monkeypatch.setattr(ServingLayer, "_execute_read", broken)
    out = cell_run(cell, tiny)
    assert not out["correct"] and out["checks"]["wrong"][0] > 0


def test_half_of_a_batch_left_out(tiny, monkeypatch):
    # ragged.py imports demux_into from serving at each call
    from pilosa_tpu_torch.executor import serving
    orig = serving.demux_into
    last = {}

    def broken(r, demux, out):
        orig(r, demux, out)
        # every second rider is left out and handed its neighbour's answer
        if last.get("res") is not None and next(last["turn"]) % 2:
            r.result = last["res"]
        last["res"] = r.result
    last["turn"] = itertools.count()
    monkeypatch.setattr(serving, "demux_into", broken)
    out = cell_run("able-groupby-c8", tiny)
    assert not out["correct"] and out["checks"]["wrong"][0] > 0


def test_the_audit_is_on_and_seeded_from_the_run(tiny):
    from gpubench import manifest as man
    from gpubench import node
    cfg = dict(man.config("able-1b"), **tiny)
    h = node.load_holder(cfg, 7, CPU)
    states = []
    for seed in (2**40 + 1, 2**40 + 1, 2**40 + 2):
        api = node.start(h, cfg, CPU, seed)
        plane = api.executor.serving.audit
        states.append(plane._rng.getstate())
        from pilosa_tpu_torch.obs import audit
        assert audit.enabled()
        node.stop(api)
    assert states[0] == states[1] != states[2]
