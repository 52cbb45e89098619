"""The control of ``correct``: the reference in the port's place, one
precision down (float32), comes out not correct, at a size a test run
holds (4 shards of 2^20 columns for able-1b, 8 of 2^16 for taxi-1b,
where float32 counts and sums already round)."""

import pytest
import torch

from gpubench import control

CPU = torch.device("cpu")


@pytest.mark.parametrize("cell, over", [
    ("able-groupby-c8", {"shards": 4, "chunk_shards": 2}),
    ("taxi-sql-c8", {"shards": 8, "shard_width": 1 << 16,
                     "chunk_shards": 4}),
])
def test_float32_control_fails(cell, over):
    bad, n = control.wrong(cell, 12345, 60, CPU, over)
    assert n == 60 and bad > 0


def test_exact_reference_holds_itself(tiny):
    from gpubench import answers
    from gpubench import manifest as man
    from gpubench.reference import Cube
    cfg = dict(man.config("taxi-1b"), **tiny)
    cube = Cube(cfg, 5, CPU)
    for spec in control.requests(man.cell(man.load(), "taxi-sql-c8"), cfg,
                                 5, 20):
        got = cube.answer(spec)
        if spec["op"] == "topn":
            got = got[:spec["n"]]
        assert answers.same(spec, got, cube.answer(spec))
