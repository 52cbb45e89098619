"""The port's GroupBy pieces against the JAX package's, on the same inputs.

Seeded numpy inputs (a few shards, W <= 16 words; the recipe of
tests/test_groupby_fused.py) go through the JAX functions — the Pallas
kernels in interpret mode and their XLA references — and through the
port's plain versions, which is what a CPU tensor runs.  Every output
is an integer: the comparison is exact (tolerance 0).  The CUDA kernels
are held to the same plain versions on the card (tests/test_torch_gpu.py,
chip_smoke.py)."""

import itertools

import numpy as np
import pytest
import torch

from pilosa_tpu.ops import bitmap as jbm
from pilosa_tpu.ops import bsi as jbsi
from pilosa_tpu.ops import kernels as jk
from pilosa_tpu_torch.executor.stacked import StackedEngine
from pilosa_tpu_torch.models.holder import Holder
from pilosa_tpu_torch.models.schema import FieldOptions, FieldType
from pilosa_tpu_torch.ops import bitmap as bm
from pilosa_tpu_torch.ops import kernels as K

# one intra-op thread: these tests share the machine with the rest of
# the suite's workers, several of which time their own work
torch.set_num_threads(1)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.uint32)
                            .view(np.int32))


def _eq(got, want):
    if got is None or want is None:
        assert got is None and want is None
        return
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def _category_field(rng, n_rows, s_dim, width):
    """(R, S, W) rows with each column in at most one row."""
    assign = rng.integers(-1, n_rows, size=(s_dim, width))
    rows = np.zeros((n_rows, s_dim, width // 32), np.uint32)
    for s in range(s_dim):
        for r in range(n_rows):
            rows[r, s] = jbm.from_columns(np.nonzero(assign[s] == r)[0], width)
    return rows


def _fixture(rng, nf_rows, depth, s_dim=3, w=16, signed=True,
             all_invalid=False, extreme=False):
    """Group-code planes (S, CB, W), valid (S, W), BSI planes
    (S, 2+d, W) and n_codes, as numpy uint32."""
    width = w * 32
    fields = [_category_field(rng, nr, s_dim, width) for nr in nf_rows]
    lo = -(2 ** depth) + 1 if signed else 0
    vals = rng.integers(lo, 2 ** depth, size=(s_dim, width))
    if extreme:
        ext = rng.integers(0, 2, size=(s_dim, width)).astype(bool)
        vals[ext] = np.where(rng.integers(0, 2, size=int(ext.sum())),
                             2 ** depth - 1, lo if signed else 0)
    ex = rng.integers(0, 2, size=(s_dim, width)).astype(bool)
    planes = np.stack([
        jbsi.encode(np.nonzero(ex[s])[0], vals[s][ex[s]], depth=depth,
                    width=width) for s in range(s_dim)])
    cb = sum(bm.digit_bits(nr) for nr in nf_rows)
    cp = (np.concatenate([np.asarray(jbm.digit_planes(rows))
                          for rows in fields]).transpose(1, 0, 2)
          if cb else np.zeros((s_dim, 0, w), np.uint32))
    if all_invalid:
        valid = np.zeros((s_dim, w), np.uint32)
    else:
        valid = np.full((s_dim, w), 0xFFFFFFFF, np.uint32)
        for rows in fields:
            valid &= np.bitwise_or.reduce(rows, axis=0)
    return np.ascontiguousarray(cp), valid, planes, 1 << cb


# (nf_rows, depth, signed, all_invalid, extreme)
HIST_CASES = [
    ((5, 3), 4, True, False, False),
    ((4,), 6, False, False, False),          # unsigned
    ((3, 2, 4), 3, True, False, False),
    ((5, 3), 4, True, True, False),          # all-invalid
    ((6,), 7, True, False, True),            # extreme magnitudes
    ((2, 2), 1, True, False, False),         # depth 1
    ((1,), 3, True, False, False),           # cb = 0: one code
    ((1, 1), 2, False, False, False),        # cb = 0, unsigned
]


@pytest.mark.parametrize("minmax", [False, True], ids=["hist", "minmax"])
@pytest.mark.parametrize("case", HIST_CASES)
def test_groupby_codes_plain_matches_jax(rng, case, minmax):
    nf_rows, depth, signed, all_invalid, extreme = case
    cp, valid, planes, n_codes = _fixture(
        rng, nf_rows, depth, signed=signed, all_invalid=all_invalid,
        extreme=extreme)
    got = K.groupby_fused(_t(cp), _t(valid), _t(planes), n_codes, signed,
                          minmax=minmax)
    want_xla = jk.groupby_codes_xla(cp, valid, planes, n_codes, signed,
                                    minmax=minmax)
    want_fused = jk.groupby_fused(cp, valid, planes, n_codes, signed,
                                  minmax=minmax)
    assert len(got) == len(want_xla) == len(want_fused)
    for g, x, f in zip(got, want_xla, want_fused):
        assert g.dtype == torch.int32
        _eq(g, x)
        _eq(g, f)


def test_groupby_codes_plain_without_planes(rng):
    cp, valid, _planes, n_codes = _fixture(rng, (5, 3), 2)
    got = K.groupby_fused(_t(cp), _t(valid), None, n_codes)
    want = jk.groupby_codes_xla(cp, valid, None, n_codes)
    assert got[1:] == (None, None, None)
    _eq(got[0], want[0])


def test_groupby_fused_takes_views_of_a_larger_stack(rng):
    """The engine hands the (S, CB+1, W) group-code stack over as two
    views, code planes and valid plane, with the stack's shard stride."""
    cp, valid, planes, n_codes = _fixture(rng, (3, 4), 3)
    cg = _t(np.concatenate([cp, valid[:, None]], axis=1))
    got = K.groupby_fused(cg[:, :-1], cg[:, -1], _t(planes), n_codes)
    want = jk.groupby_codes_xla(cp, valid, planes, n_codes)
    for g, x in zip(got, want):
        _eq(g, x)


def _sum_data(rng, s=3, w=16, depth=5):
    stacks = [rng.integers(0, 1 << 32, size=(4, s, w), dtype=np.uint32),
              rng.integers(0, 1 << 32, size=(2, s, w), dtype=np.uint32)]
    vals = rng.integers(-(2 ** depth) + 1, 2 ** depth, size=(s, w * 32))
    ex = rng.integers(0, 2, size=(s, w * 32)).astype(bool)
    planes = np.stack([jbsi.encode(np.nonzero(ex[i])[0], vals[i][ex[i]],
                                   depth=depth, width=w * 32)
                       for i in range(s)])
    combos = np.array(list(itertools.product(range(4), range(2))),
                      dtype=np.int32)
    return stacks, planes, combos


@pytest.mark.parametrize("signed", [True, False])
@pytest.mark.parametrize("with_planes", [True, False])
def test_groupby_sum_plain_matches_jax(rng, signed, with_planes):
    stacks, planes, combos = _sum_data(rng)
    planes = planes if with_planes else None
    got = K.groupby_sum([_t(x) for x in stacks], _t(combos).view(torch.int32),
                        None if planes is None else _t(planes), signed)
    want = jk.groupby_sum(stacks, combos, planes, signed=signed)
    for g, x in zip(got, want):
        _eq(g, x)


def test_groupby_sum_plain_one_field_and_empty_sel(rng):
    stacks, planes, _ = _sum_data(rng)
    sel = np.array([[3], [0], [3]], dtype=np.int32)
    got = K.groupby_sum([_t(stacks[0])], torch.from_numpy(sel), _t(planes))
    want = jk.groupby_sum([stacks[0]], sel, planes)
    for g, x in zip(got, want):
        _eq(g, x)
    empty = K.groupby_sum([_t(stacks[0])],
                          torch.zeros((0, 1), dtype=torch.int32), _t(planes))
    assert [tuple(x.shape) for x in empty] == [(0,), (0,), (0, 5), (0, 5)]


@pytest.mark.parametrize("depth", [1, 4, 7])
@pytest.mark.parametrize("filtered", [False, True])
def test_bsi_value_hist_matches_jax(rng, depth, filtered):
    s, w = 3, 8
    vals = rng.integers(-(2 ** depth) + 1, 2 ** depth, size=(s, w * 32))
    ex = rng.integers(0, 2, size=(s, w * 32)).astype(bool)
    planes = np.stack([jbsi.encode(np.nonzero(ex[i])[0], vals[i][ex[i]],
                                   depth=depth, width=w * 32)
                       for i in range(s)])
    filt = (rng.integers(0, 1 << 32, size=(s, w), dtype=np.uint32)
            if filtered else None)
    pos, neg = K.bsi_value_hist(_t(planes),
                                None if filt is None else _t(filt))
    want_pos, want_neg = jk.bsi_value_hist(planes, filt, use_kernel=False)
    _eq(pos, want_pos)
    _eq(neg, want_neg)
    assert K.distinct_from_hist(pos, neg) == jk.distinct_from_hist(
        want_pos, want_neg)
    for lo, hi in ((-5, 3), (0, 2 ** depth), (-(2 ** depth), -1), (2, 1)):
        assert K.range_count_from_hist(pos, neg, lo, hi) == \
            jk.range_count_from_hist(want_pos, want_neg, lo, hi)


def test_minmax_from_table_matches_jax(rng):
    cp, valid, planes, n_codes = _fixture(rng, (5, 3), 4)
    mm = K.groupby_fused(_t(cp), _t(valid), _t(planes), n_codes,
                         minmax=True)[4]
    for op in ("min", "max"):
        got = K.minmax_from_table(mm.numpy(), 4, op)
        want = jk.minmax_from_table(np.asarray(mm.numpy()), 4, op)
        _eq(got[0], want[0])
        _eq(got[1], want[1])


@pytest.mark.parametrize("n_rows", [1, 2, 5, 8, 9])
def test_digit_and_code_planes_match_jax(rng, n_rows):
    rows = _category_field(rng, n_rows, 2, 256)
    got = bm.digit_planes(_t(rows))
    want = np.asarray(jbm.digit_planes(rows))
    assert bm.digit_bits(n_rows) == jbm.digit_bits(n_rows)
    _eq(got.numpy().view(np.uint32), want)
    _eq(bm.digit_planes(rows), want)                 # numpy input
    _eq(bm.code_from_planes(got), jbm.code_from_planes(want))
    _eq(bm.code_from_planes_np(want), jbm.code_from_planes_np(want))
    _eq(bm.unpack_bits(_t(rows)), jbm.unpack_bits(rows))


def _gate_holder():
    """Two disjoint categorical fields, one overlapping set field and a
    BSI field."""
    rng = np.random.default_rng(5)
    h = Holder(width=1024)
    idx = h.create_index("g")
    cols = np.arange(3 * 1024)
    for name, n in (("edu", 6), ("dom", 5)):
        f = idx.create_field(name)
        digit = rng.integers(0, n + 2, size=cols.size)   # >= n: absent
        keep = digit < n
        f.import_bits(digit[keep], cols[keep])
    t = idx.create_field("t")
    t.import_bits(rng.integers(0, 6, size=8000),
                  rng.integers(0, cols.size, size=8000))
    m = idx.create_field("m", FieldOptions(type=FieldType.MUTEX))
    m.import_bits(rng.integers(0, 4, size=500), rng.integers(0, 3072, 500))
    v = idx.create_field("v", FieldOptions(type=FieldType.INT, min=-50,
                                           max=50))
    v.import_values(cols, rng.integers(-50, 51, size=cols.size))
    return h


def test_onepass_gate_follows_disjointness():
    h = _gate_holder()
    idx = h.index("g")
    eng = StackedEngine(None, torch.device("cpu"))
    skey = (0, 1, 2)

    def rows_of(name):
        f = idx.field(name)
        ids = sorted({r for fr in f.views["standard"].fragments.values()
                      for r in fr.row_ids})
        return (f, ids)

    edu, dom, t, m = (rows_of(n) for n in ("edu", "dom", "t", "m"))
    assert eng._rows_disjoint(idx, *edu, skey)
    assert eng._rows_disjoint(idx, *m, skey)          # mutex: by type
    assert not eng._rows_disjoint(idx, *t, skey)
    assert not eng._rows_disjoint(idx, edu[0], [0, 0], skey)
    # disjoint fields: one pass, whatever the combo count
    assert eng._groupby_onepass_fits(idx, [edu, dom], skey)
    assert eng._groupby_onepass_fits(idx, [(edu[0], [0, 1])], skey)
    # an overlapping field: per combo
    assert not eng._groupby_onepass_fits(idx, [edu, t], skey)
    # past the shard bound the int32 histogram is refused
    assert not eng._groupby_onepass_fits(idx, [edu, dom],
                                         tuple(range(2001)))
    # past the code bound (2^20 dense codes) too
    wide = (edu[0], list(range(1 << 20)) + [0])
    assert not eng._groupby_onepass_fits(idx, [wide], skey)


def test_groupby_wrappers_check_their_inputs(rng):
    cp, valid, planes, n_codes = _fixture(rng, (5, 3), 4)
    cp, valid, planes = _t(cp), _t(valid), _t(planes)
    K.reset_launches()
    K.groupby_fused(cp, valid, planes, n_codes, minmax=True)
    stacks, _, combos = _sum_data(rng)
    stacks = [_t(x) for x in stacks]
    sel = torch.from_numpy(combos)
    K.groupby_sum(stacks, sel)
    assert all(n == 0 for n in K.LAUNCHES.values())   # CPU: plain only
    with pytest.raises(ValueError):
        K.groupby_fused(cp, valid[:2], planes, n_codes)
    with pytest.raises(ValueError):
        K.groupby_fused(cp, valid, None, n_codes, minmax=True)
    with pytest.raises(ValueError):
        K.groupby_fused(cp, valid, planes, 0)
    with pytest.raises(ValueError):
        K.groupby_fused(cp.transpose(1, 2), valid, planes, n_codes)
    deep = torch.zeros((3, 2 + 31, 16), dtype=torch.int32)
    with pytest.raises(ValueError):
        K.groupby_fused(cp, valid, deep, n_codes, minmax=True)
    with pytest.raises(TypeError):
        K.groupby_fused(cp.to(torch.int64), valid, planes, n_codes)
    with pytest.raises(ValueError):
        K.groupby_sum(stacks, sel + 4)                # row out of range
    with pytest.raises(ValueError):
        K.groupby_sum(stacks, sel[:, :1])             # one column, 2 fields
    with pytest.raises(ValueError):
        K.groupby_sum([stacks[0][:, :2], stacks[1]], sel)
    with pytest.raises(ValueError):
        K.groupby_sum(stacks * 5, sel.repeat(1, 5))   # 10 fields > 8
    with pytest.raises(ValueError):
        K.groupby_sum(stacks, sel.t())                # not contiguous
