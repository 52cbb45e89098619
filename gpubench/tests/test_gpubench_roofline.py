"""The kernel files' bounds reproduce chip_smoke.py's phase 3 at its
shapes (PERF.md's kernel table, H100 80GB HBM3)."""

import pytest
import torch

from gpubench import peaks, roofline

S, W, R, D = 954, 32768, 8, 7
# the card's __popc rate: 16 a clock an SM x 132 SMs x 1980 MHz
POPC = 16 * 132 * 1980e6
FILES = roofline.load_all()


def meta(*shape):
    return torch.empty(shape, dtype=torch.int32, device="meta")


def ms(kernel, wrapper, *args, **kw):
    return peaks.least_s(FILES[kernel].WRAPPERS[wrapper](*args, **kw),
                         POPC) * 1e3


@pytest.mark.parametrize("got, want", [
    (lambda: ms("popcount_rows", "popcount_rows", meta(S, W)), 0.0373),
    (lambda: ms("popcount_rows", "popcount_rows", meta(R * S, W)), 0.2986),
    (lambda: ms("pair_popcount", "pair_popcount", meta(S, W), meta(S, W)),
     0.0747),
    (lambda: ms("rows_filter_counts", "rows_filter_counts", meta(R, S, W),
                meta(S, W)), 0.3359),
    (lambda: ms("bsi_sum_counts", "bsi_sum_counts", meta(S, 2 + D, W),
                meta(S, W)), 0.3733),
    (lambda: ms("bsi_sum_counts", "bsi_sum_counts", meta(S, 2 + D, W)),
     0.3360),
    (lambda: ms("bsi_sum_counts", "bsi_sum_counts",
                meta(1, 2 + D, W).expand(S, -1, -1), meta(S, W)), 0.0377),
    (lambda: ms("bsi_range", "bsi_range", meta(S, 2 + D, W), "between", 11,
                99), 0.3733),
    (lambda: ms("groupby_fused", "groupby_fused", meta(S, 7, W), meta(S, W),
                meta(S, 2 + D, W), 128, signed=False), 0.5972),
    (lambda: ms("groupby_fused", "groupby_fused", meta(S, 7, W), meta(S, W),
                meta(S, 2 + D, W), 128), 0.6345),
    (lambda: ms("groupby_fused", "groupby_fused", meta(S, 9, W), meta(S, W),
                meta(S, 2 + D, W), 512, signed=False), 0.6719),
    (lambda: ms("groupby_onehot", "groupby_onehot", meta(S, 7, W), meta(S, W),
                meta(S, 2 + D, W), 128, signed=False), 0.5972),
    (lambda: ms("masked_popcount", "masked_popcount", meta(256, W), meta(W)),
     0.0101),
    (lambda: ms("concat_gather", "concat_gather", [meta(32, W)] * 30,
                torch.empty(S, dtype=torch.int64, device="meta")), 0.0747),
])
def test_phase3_bounds(got, want):
    assert round(got(), 4) == want


def test_masked_popcount_shards_bound():
    class Tiles:
        pass
    tiles = [[Tiles()] for _ in range(S)]
    got = ms("masked_popcount", "masked_popcount_shards", tiles,
             [object()] * S, R, W, None)
    assert round(got, 4) == 0.3360


def test_every_kernel_has_a_file():
    assert set(FILES) == {
        "popcount_rows", "pair_popcount", "masked_popcount",
        "rows_filter_counts", "bsi_sum_counts", "bsi_range",
        "groupby_fused", "groupby_onehot", "groupby_sum",
        "assemble_pages", "concat_gather", "segment_count"}
    from pilosa_tpu_torch.ops import kernels
    assert set(FILES) == set(kernels.LAUNCHES)
    for mod in FILES.values():
        for name in mod.WRAPPERS:
            assert callable(getattr(kernels, name))
