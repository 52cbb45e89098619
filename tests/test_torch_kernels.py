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
