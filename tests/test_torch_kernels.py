"""The kernels' plain versions (what a CPU tensor runs) against the
JAX package's Pallas kernels, which run in interpret mode off-TPU.

Shapes are ragged (N = 5, W = 200) so the JAX side's row and word
padding is exercised; outputs are integers, so comparisons are exact.
bsi_range, which has no Pallas kernel, is held to the JAX package's jnp
range_* functions on planes of depth 1 to 63.  The CUDA kernels
themselves are held to these plain versions on the card
(tests/test_torch_gpu.py, chip_smoke.py)."""

import itertools

import numpy as np
import pytest
import torch

from pilosa_tpu.ops import bsi as jbsi
from pilosa_tpu.ops import kernels as jk
from pilosa_tpu_torch.ops import bsi
from pilosa_tpu_torch.ops import kernels as K

# one intra-op thread: these tests share the machine with the rest of
# the suite's workers, several of which time their own work
torch.set_num_threads(1)


def _words(rng, shape):
    x = rng.integers(0, 1 << 32, size=shape, dtype=np.uint32)
    x[..., 3::17] = 0x80000000
    x[..., 5::19] = 0xFFFFFFFF
    return x


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x).view(np.int32))


def _eq(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_popcount_rows(rng):
    x = _words(rng, (5, 200))
    got = K.popcount_rows(_t(x))
    assert got.dtype == torch.int32
    _eq(got, jk.popcount_rows(x))


def test_pair_popcount(rng):
    a, b = _words(rng, (5, 200)), _words(rng, (5, 200))
    _eq(K.pair_popcount(_t(a), _t(b)), jk.pair_popcount(a, b))


def test_rows_filter_counts(rng):
    rows, filt = _words(rng, (3, 5, 200)), _words(rng, (5, 200))
    got = K.rows_filter_counts(_t(rows), _t(filt))
    assert got.shape == (3, 5)
    _eq(got, jk.rows_filter_counts(rows, filt))


@pytest.mark.parametrize("depth", range(1, 9))
@pytest.mark.parametrize("filtered", [False, True])
def test_bsi_sum_counts(rng, depth, filtered):
    s = 3
    planes = _words(rng, (s, 2 + depth, 200))
    filt = _words(rng, (s, 200)) if filtered else None
    cnt, pos, neg = K.bsi_sum_counts(
        _t(planes), None if filt is None else _t(filt))
    assert cnt.shape == (s,) and pos.shape == neg.shape == (s, depth)
    for i in range(s):
        want = jk.bsi_sum_counts(planes[i],
                                 None if filt is None else filt[i])
        _eq(cnt[i], want[0])
        _eq(pos[i], want[1])
        _eq(neg[i], want[2])


def test_cpu_tensors_take_the_plain_version(rng):
    """A CPU tensor never counts as a kernel launch."""
    K.reset_launches()
    x = _t(_words(rng, (4, 8)))
    K.popcount_rows(x)
    K.pair_popcount(x, x)
    K.rows_filter_counts(x.view(1, 4, 8), x)
    K.bsi_sum_counts(x.view(1, 4, 8))
    assert all(n == 0 for n in K.LAUNCHES.values())


def test_wrappers_check_their_inputs(rng):
    x = _t(_words(rng, (4, 8)))
    with pytest.raises(TypeError):
        K.popcount_rows(x.to(torch.int64))
    with pytest.raises(ValueError):
        K.popcount_rows(x.view(32))
    with pytest.raises(ValueError):
        K.popcount_rows(x.t())
    with pytest.raises(ValueError):
        K.pair_popcount(x, x[:2])
    with pytest.raises(ValueError):
        K.rows_filter_counts(x.view(1, 4, 8), x[:2])
    with pytest.raises(ValueError):
        K.bsi_sum_counts(x.view(2, 2, 8))           # no magnitude plane
    with pytest.raises(ValueError):
        K.bsi_sum_counts(x.view(1, 4, 8), x[:2])


# -- bsi_range: the comparator against the JAX package's jnp range_* ----------

RANGE_W = 64        # words: 2048 columns a shard
RANGE_DEPTHS = (1, 7, 40, 63, 64)


def _preds(rng, depth):
    """Predicate magnitudes: 0, the largest, and one at random."""
    return [0, (1 << depth) - 1,
            int.from_bytes(rng.bytes(8), "little") >> (64 - depth)]


def _range_planes(rng, n_shards, depth, mags):
    """(S, 2+d, W) uint32 planes holding the predicates' magnitudes, one
    off them and random ones, either sign, plus magnitude and sign bits
    on columns that do not exist (which no comparison may return)."""
    top = min((1 << depth) - 1, (1 << 63) - 1)   # int64 values
    out = []
    for _ in range(n_shards):
        near = [min(max(m + k, 0), top) for m in mags for k in (-1, 0, 1)]
        vals = [int(v) for v in rng.integers(0, top, size=400, endpoint=True)]
        vals += near * 20
        signs = rng.integers(0, 2, size=len(vals)).astype(bool)
        vals = [-v if s else v for v, s in zip(vals, signs)]
        cols = rng.choice(RANGE_W * 32 - 64, size=len(vals), replace=False)
        out.append(bsi.encode(cols, np.array(vals, dtype=np.int64), depth,
                              RANGE_W * 32))
    out = np.stack(out)
    out[:, 1:] |= _words(rng, out[:, 1:].shape) & ~out[:, :1]
    return out


def _jax_range(planes, op, p, q, p_neg, q_neg):
    depth = planes.shape[0] - 2
    pb = jbsi.predicate_masks(p, depth)
    if op == "between":
        return np.asarray(jbsi.range_between(
            planes, pb, jbsi.predicate_masks(q, depth), p_neg, q_neg))
    if op in ("eq", "neq"):
        return np.asarray(getattr(jbsi, f"range_{op}")(planes, pb, p_neg))
    fn = jbsi.range_lt if op.startswith("lt") else jbsi.range_gt
    return np.asarray(fn(planes, pb, p_neg, allow_eq=op.endswith("e")))


def _check_range(planes_np, planes_t, op, p, q, p_neg, q_neg):
    got = K.bsi_range(planes_t, op, p, q, p_neg, q_neg)
    assert got.dtype == torch.int32 and got.shape == (planes_np.shape[0],
                                                      RANGE_W)
    got = got.numpy().view(np.uint32)
    for s in range(planes_np.shape[0]):
        _eq(got[s], _jax_range(planes_np[s], op, p, q, p_neg, q_neg))


@pytest.mark.parametrize("depth", RANGE_DEPTHS)
@pytest.mark.parametrize("op", ["eq", "neq", "lt", "lte", "gt", "gte"])
@pytest.mark.parametrize("p_neg", [False, True])
def test_bsi_range_matches_jax(rng, depth, op, p_neg):
    """Every comparison and predicate sign, bit for bit, at predicates 0,
    2^d - 1 and random, on a 2-shard stack and on one shard's (2+d, W)
    planes through unsqueeze."""
    preds = _preds(rng, depth)
    planes = _range_planes(rng, 2, depth, preds)
    for p in preds:
        _check_range(planes, _t(planes), op, p, None, p_neg, False)
        _check_range(planes[:1], _t(planes[0]).unsqueeze(0), op, p, None,
                     p_neg, False)


@pytest.mark.parametrize("depth", RANGE_DEPTHS)
@pytest.mark.parametrize("p_neg,q_neg", [(False, False), (True, True),
                                         (True, False), (False, True)],
                         ids=["positive", "negative", "across", "inverted"])
def test_bsi_range_between_regimes_match_jax(rng, depth, p_neg, q_neg):
    preds = _preds(rng, depth)
    planes = _range_planes(rng, 2, depth, preds)
    for p, q in itertools.product(preds, preds):
        _check_range(planes, _t(planes), "between", p, q, p_neg, q_neg)


@pytest.mark.parametrize("depth", RANGE_DEPTHS)
def test_bsi_range_on_views(rng, depth):
    """A plane range of a larger stack (shard-strided) and one shard's
    planes at shard stride 0 give the contiguous answers."""
    preds = _preds(rng, depth)
    planes = _range_planes(rng, 3, depth, preds)
    big = np.concatenate([_words(rng, (3, 1, RANGE_W)), planes], axis=1)
    view = _t(big)[:, 1:]
    assert not view.is_contiguous()
    one = _t(planes[:1]).expand(3, -1, -1)
    for op, q in (("lte", None), ("neq", None), ("between", preds[1])):
        _check_range(planes, view, op, preds[2], q, True, False)
        _check_range(np.repeat(planes[:1], 3, axis=0), one, op, preds[2], q,
                     True, False)


def test_bsi_range_checks_its_inputs(rng):
    planes = _t(_words(rng, (2, 9, 8)))
    K.reset_launches()
    with pytest.raises(ValueError):
        K.bsi_range(planes, "ge", 3)                   # no such op
    with pytest.raises(ValueError):
        K.bsi_range(planes, "lt", 1 << 7)              # past the depth
    with pytest.raises(ValueError):
        K.bsi_range(planes, "between", 3)              # q missing
    with pytest.raises(ValueError):
        K.bsi_range(planes, "lt", 3, 4)                # q given
    with pytest.raises(ValueError):
        K.bsi_range(planes[:, :2], "eq", 0)            # no magnitude plane
    with pytest.raises(ValueError):
        K.bsi_range(_t(_words(rng, (1, 67, 8))), "eq", 0)   # depth 65
    with pytest.raises(TypeError):
        K.bsi_range(planes.to(torch.int64), "eq", 0)
    assert K.LAUNCHES["bsi_range"] == 0


# -- masked_popcount_shards: the per-shard TopN/TopK scan in one call ---------

SHARD_W = 64        # words: 2048 columns a shard


def _shard_tiles(rng, n_shards, n_views, n_rows):
    """Per shard and view the (R, W) uint32 rows, None for a view with
    no fragment: shard 1 lacks its first view, the last shard every
    view."""
    out = []
    for s in range(n_shards):
        views = []
        for v in range(n_views):
            missing = s == n_shards - 1 or (s == 1 and v == 0 and n_views > 1)
            views.append(None if missing else _words(rng, (n_rows, SHARD_W)))
        out.append(views)
    return out


def _row_tiles(rows, form="aligned"):
    """RowTiles of the (R, W) uint32 rows, the tile cache's form: R (W,)
    tiles, each its own tensor ("aligned"), or rows of a wider tensor
    one word in ("offset": tiles that are not 16-byte aligned)."""
    if form == "offset":
        wide = np.zeros((rows.shape[0], rows.shape[1] + 1), dtype=np.uint32)
        wide[:, 1:] = rows
        tiles = list(_t(wide)[:, 1:])
    else:
        tiles = [_t(row) for row in rows]
    return K.RowTiles(tiles, rows.shape[1], "cpu")


def _as_port(views_np, form):
    """The port's form of one shard's views: RowTiles, or None."""
    return [None if v is None else _row_tiles(v, form) for v in views_np]


def _jax_shards(views_np, masks_np, n_rows):
    """The JAX loop's sum: per shard the present views ORed, then one
    Pallas masked_popcount (popcount_rows without a filter) a shard,
    summed in int64."""
    total = np.zeros(n_rows, dtype=np.int64)
    for s, views in enumerate(views_np):
        acc = None
        for v in views:
            if v is not None:
                acc = v if acc is None else acc | v
        if acc is None:
            continue
        got = (jk.popcount_rows(acc) if masks_np is None
               else jk.masked_popcount(acc, masks_np[s]))
        total += np.asarray(got, dtype=np.int64)
    return total


@pytest.mark.parametrize("n_rows", [1, 8, 300])
@pytest.mark.parametrize("n_views", [0, 1, 3])
@pytest.mark.parametrize("masked", [False, True], ids=["no_filter", "filter"])
@pytest.mark.parametrize("form", ["aligned", "offset"])
def test_masked_popcount_shards_plain_matches_pallas(rng, n_rows, n_views,
                                                     masked, form):
    """Three shards (one missing a view, one missing every view) counted
    in one call, against the JAX Pallas kernels run once a shard; no
    view at all (a time range that covers none) counts zeros."""
    views_np = _shard_tiles(rng, 3, n_views, n_rows)
    masks_np = _words(rng, (3, SHARD_W)) if masked else None
    tiles = [_as_port(v, form) for v in views_np]
    masks = None if masks_np is None else [_t(m) for m in masks_np]
    K.reset_launches()
    got = K.masked_popcount_shards(tiles, masks, n_rows, SHARD_W, "cpu")
    assert got.dtype == torch.int64 and got.shape == (n_rows,)
    _eq(got, _jax_shards(views_np, masks_np, n_rows))
    assert K.LAUNCHES["masked_popcount"] == 0


@pytest.mark.parametrize("n_rows", [0, 8])
def test_masked_popcount_shards_no_shards(n_rows):
    got = K.masked_popcount_shards([], None, n_rows, SHARD_W, "cpu")
    assert got.dtype == torch.int64 and got.shape == (n_rows,)
    assert not got.any()
    got = K.masked_popcount_shards([[None, None]], [None], n_rows, SHARD_W,
                                   "cpu")
    assert got.shape == (n_rows,) and not got.any()


def test_masked_popcount_shards_mixes_filtered_shards(rng):
    """A None mask among masks counts that shard's rows whole."""
    rows = _words(rng, (2, 4, SHARD_W))
    mask = _words(rng, (SHARD_W,))
    got = K.masked_popcount_shards([[_row_tiles(rows[0])],
                                    [_row_tiles(rows[1])]],
                                   [_t(mask), None], 4, SHARD_W, "cpu")
    want = (np.asarray(jk.masked_popcount(rows[0], mask), dtype=np.int64)
            + np.asarray(jk.popcount_rows(rows[1]), dtype=np.int64))
    _eq(got, want)


def test_masked_popcount_shards_checks_its_inputs(rng):
    x = _t(_words(rng, (4, SHARD_W)))
    wide = _t(_words(rng, (4, 2 * SHARD_W)))
    m = x[0].contiguous()
    rows = list(x)
    tiles = K.RowTiles(rows, SHARD_W, "cpu")
    assert tiles.addrs == [r.data_ptr() for r in rows]

    def call(views, masks=None, n_rows=4):
        return K.masked_popcount_shards(views, masks, n_rows, SHARD_W, "cpu")

    K.reset_launches()
    with pytest.raises(TypeError):
        call([[x]])                                   # a tensor, not RowTiles
    with pytest.raises(ValueError):
        K.RowTiles(list(x[:, :32]), SHARD_W, "cpu")   # tiles of 32 words
    with pytest.raises(ValueError):
        K.RowTiles(list(wide[:, ::2]), SHARD_W, "cpu")  # words not contiguous
    with pytest.raises(TypeError):
        K.RowTiles(list(x.to(torch.int64)), SHARD_W, "cpu")
    with pytest.raises(ValueError):
        K.RowTiles(rows, SHARD_W, "meta")             # tiles elsewhere
    with pytest.raises(ValueError):
        call([[K.RowTiles(rows[:3], SHARD_W, "cpu")]])    # 3 rows for R = 4
    with pytest.raises(ValueError):
        call([[K.RowTiles(list(wide), 2 * SHARD_W, "cpu")]])   # other width
    with pytest.raises(ValueError):
        call([[tiles], [tiles, tiles]])               # views differ
    with pytest.raises(ValueError):
        call([[tiles]], [m, m])                       # 2 masks, 1 shard
    with pytest.raises(ValueError):
        call([[tiles]], [m[:32]])                     # short mask
    with pytest.raises(ValueError):
        call([[tiles]], [wide[0, ::2]])               # strided mask
    with pytest.raises(TypeError):
        call([[tiles]], [m.to(torch.int64)])
    assert K.LAUNCHES["masked_popcount"] == 0
