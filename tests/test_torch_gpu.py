"""The CUDA kernels held to their plain versions on the card.

Marked ``gpu``; each test asks the ``cuda`` fixture for the device and
skips where there is none.  On a machine with a card (which need not
have JAX, imported by tests/conftest.py) run:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from pilosa_tpu_torch.ops import kernels as K

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _words(shape, device, seed=0):
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    x = torch.randint(-2**31, 2**31, shape, generator=g, device=device,
                      dtype=torch.int32)
    x[..., 3::17] = -2**31   # 0x80000000
    x[..., 5::19] = -1       # 0xFFFFFFFF
    return x


def _same(got, want):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want):
        assert g.device.type == "cuda"
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w)


# W = 200 and 201 exercise the scalar tail; rows sliced at an odd
# offset exercise the unaligned path
_SHAPES = [(1, 8), (5, 200), (7, 201), (954, 32768), (3, 100003)]


@pytest.mark.parametrize("n,w", _SHAPES)
def test_popcount_rows(cuda, n, w):
    x = _words((n + 1, w), cuda)
    for t in (x[:n], x[1:]):
        before = K.LAUNCHES["popcount_rows"]
        got = K.popcount_rows(t)
        torch.cuda.synchronize()
        assert K.LAUNCHES["popcount_rows"] == before + 1
        _same(got, K.popcount_rows_plain(t))


@pytest.mark.parametrize("n,w", _SHAPES)
def test_pair_popcount(cuda, n, w):
    a, b = _words((n + 1, w), cuda, 1), _words((n + 1, w), cuda, 2)
    _same(K.pair_popcount(a[:n], b[:n]), K.pair_popcount_plain(a[:n], b[:n]))
    _same(K.pair_popcount(a[1:], b[:n]), K.pair_popcount_plain(a[1:], b[:n]))


@pytest.mark.parametrize("r,s,w", [(1, 1, 8), (3, 5, 200), (8, 954, 32768),
                                   (17, 3, 4099)])
def test_rows_filter_counts(cuda, r, s, w):
    rows, filt = _words((r, s, w), cuda, 3), _words((s, w), cuda, 4)
    _same(K.rows_filter_counts(rows, filt),
          K.rows_filter_counts_plain(rows, filt))


@pytest.mark.parametrize("depth,s,w", [
    (d, s, w) for d in (1, 7, 20, 63) for s, w in ((1, 8), (3, 2049))]
    + [(7, 954, 32768)])
@pytest.mark.parametrize("filtered", [False, True])
def test_bsi_sum_counts(cuda, depth, s, w, filtered):
    planes = _words((s, 2 + depth, w), cuda, 5)
    filt = _words((s, w), cuda, 6) if filtered else None
    _same(K.bsi_sum_counts(planes, filt), K.bsi_sum_counts_plain(planes, filt))


@pytest.mark.parametrize("c,depth,w", [(1, 7, 8), (60, 7, 2049), (3, 40, 300)])
def test_bsi_sum_counts_one_shard_many_filters(cuda, c, depth, w):
    """Stride-0 planes: one shard's planes against C filters (the
    per-shard GroupBy's combo masks)."""
    planes = _words((1, 2 + depth, w), cuda, 30).expand(c, -1, -1)
    filt = _words((c, w), cuda, 31)
    _same(K.bsi_sum_counts(planes, filt), K.bsi_sum_counts_plain(planes, filt))
    _same(K.bsi_sum_counts(planes, filt),
          K.bsi_sum_counts(planes.contiguous(), filt))


@pytest.mark.parametrize("c", [1, 8, 60, 954])
@pytest.mark.parametrize("depth", [1, 7, 12, 25, 40, 63])
def test_bsi_sum_counts_stride0_instance(cuda, c, depth):
    """The stride-0 instance (planes staged once a word chunk, filters
    counted against them on the tensor cores) at the per-shard GroupBy's
    filter counts, a part-filled last m-tile, every n-tile count (1, 2, 4
    and 9 tiles of plane columns), several m-tiles a block (C = 954), a
    ragged W, and planes without negatives."""
    w = 2049 if c < 954 else 1031
    planes = _words((1, 2 + depth, w), cuda, 32)
    filt = _words((c, w), cuda, 33)
    for pl in (planes, torch.cat([planes[:, :1], torch.zeros_like(
            planes[:, :1]), planes[:, 2:]], dim=1)):
        one = pl.expand(c, -1, -1)
        _same(K.bsi_sum_counts(one, filt), K.bsi_sum_counts_plain(one, filt))


_RANGE_OPS = ["eq", "neq", "lt", "lte", "gt", "gte", "between"]


def _range_cases(depth, seed):
    """(op, p, q, p_neg, q_neg) over every op, sign and between regime at
    predicates 0, 2^d - 1 and one at random."""
    rng = np.random.default_rng(seed)
    preds = [0, (1 << depth) - 1,
             int.from_bytes(rng.bytes(8), "little") >> (64 - depth)]
    for op in _RANGE_OPS:
        for p in preds:
            for p_neg in (False, True):
                if op != "between":
                    yield op, p, None, p_neg, False
                    continue
                for q in preds:
                    for q_neg in (False, True):
                        yield op, p, q, p_neg, q_neg


def _range_planes(shape, device, seed):
    """Random planes with some columns at each case's predicate: word 0
    of every shard holds the magnitude bits of 2^d - 1, word 1 of 0."""
    x = _words(shape, device, seed)
    x[:, 2:, 0] = -1
    x[:, 2:, 1] = 0
    return x


@pytest.mark.parametrize("depth", [1, 7, 40, 63, 64])
@pytest.mark.parametrize("s,w", [(3, 2049), (2, 8), (5, 1027)])
def test_bsi_range(cuda, depth, s, w):
    """Every op and sign regime against the plain version, contiguous,
    on an unaligned view (the scalar path), a shard-strided plane range
    and one shard's planes at shard stride 0."""
    base = _range_planes((s, 3 + depth, w), cuda, 40)
    flat = _words((s * (2 + depth) * w + 1,), cuda, 41)
    views = [base[:, 1:].contiguous(), base[:, 1:],
             flat[1:].view(s, 2 + depth, w),
             base[:1, 1:].expand(s, -1, -1)]
    for op, p, q, p_neg, q_neg in _range_cases(depth, depth):
        for pl in views:
            before = K.LAUNCHES["bsi_range"]
            got = K.bsi_range(pl, op, p, q, p_neg, q_neg)
            assert K.LAUNCHES["bsi_range"] == before + 1
            _same(got, K.bsi_range_plain(pl, op, p, q, p_neg, q_neg)
                  .contiguous())


def test_bsi_range_main_path_shape(cuda):
    planes = _range_planes((954, 9, 32768), cuda, 42)
    for op, p, q in (("gte", 64, None), ("lt", 64, None),
                     ("between", 11, 99), ("neq", 0, None)):
        _same(K.bsi_range(planes, op, p, q),
              K.bsi_range_plain(planes, op, p, q).contiguous())


def test_cuda_ranges_never_take_the_eager_comparator(cuda, monkeypatch):
    """Range rows on the card, on both engines, go through the kernel:
    ops/bsi.py's range_* (the plain version) must not run."""
    from pilosa_tpu_torch.executor.executor import Executor
    from pilosa_tpu_torch.models.holder import Holder
    from pilosa_tpu_torch.models.schema import FieldOptions, FieldType
    from pilosa_tpu_torch.ops import bsi

    rng = np.random.default_rng(5)
    h = Holder(width=4096)
    idx = h.create_index("i")
    v = idx.create_field("v", FieldOptions(type=FieldType.INT,
                                           min=-500, max=500))
    cols = rng.integers(0, 4096 * 3, size=6000)
    v.import_values(cols, rng.integers(-500, 501, size=cols.size))
    queries = ["Count(Row(v >= -20))", "Count(Row(v < 17))",
               "Count(Row(-100 <= v <= 100))", "Count(Row(v == 7))",
               "Count(Row(v != -7))", "Count(Row(v > 3))",
               "Count(Row(20 < v < 300))"]
    wants = [Executor(h, device="cpu").execute("i", q) for q in queries]

    def eager(*_a, **_k):
        raise AssertionError("the eager comparator ran on the card")
    for name in ("range_eq", "range_neq", "range_lt", "range_gt",
                 "range_between", "cmp_unsigned"):
        monkeypatch.setattr(bsi, name, eager)
    for stacked in (True, False):
        ex = Executor(h)
        ex.use_stacked = stacked
        before = K.LAUNCHES["bsi_range"]
        for q, want in zip(queries, wants):
            assert ex.execute("i", q) == want, q
        assert K.LAUNCHES["bsi_range"] > before


# groupby_fused: (S, CB, W, depth, signed, n_codes).  W = 200/2049 are
# ragged against the 2048-word tile of the (K, G) arm and 513/511/1023
# against the joint arm's 1024-word tile; CB = 0 is the one-code case.
# Arms (csrc/groupby_kernels.cu pt_groupby_fused): the joint (code, value)
# table in one magnitude chunk or two, with lane copies when tiny; the
# count-only table (lane copies up to 512 codes); the (K, G) table in
# shared memory (depth 20, or Min/Max past one chunk) and past it in
# global memory (the last two)
_FUSED = [
    (3, 7, 200, 7, False, 128),
    (3, 7, 2049, 7, True, 128),    # the largest one-chunk joint table (132 KB)
    (2, 0, 201, 3, True, 1),
    (5, 9, 1000, 7, True, 512),
    (2, 3, 64, 1, True, 8),
    (2, 5, 300, 20, True, 32),
    (2, 2, 300, 40, False, 4),
    (2, 12, 700, 16, True, 4096),
    (3, 20, 100, 0, True, 1 << 20),
    (2, 8, 513, 7, True, 256),     # the first past it: two chunks
    (2, 7, 200, 8, False, 225),    # more codes than 2^CB: the rest stay 0
    (2, 8, 1023, 8, True, 128),    # depth 8 signed: two chunks
    (3, 5, 511, 8, False, 32),     # depth 8 unsigned: one chunk
    (2, 8, 300, 7, False, 200),    # codes >= G dropped, joint table
    (2, 10, 600, 3, True, 700),
    (2, 9, 130, 0, True, 300),     # codes >= G dropped, count only
    (2, 4, 77, 2, True, 16),       # joint table in lane copies
    (2, 8, 64, 0, False, 256),     # the value histogram's lane copies
    (2, 14, 64, 0, False, 16384),  # a count-only table past lane copies
]


@pytest.mark.parametrize("s,cb,w,depth,signed,g", _FUSED)
@pytest.mark.parametrize("minmax", [False, True])
def test_groupby_fused(cuda, s, cb, w, depth, signed, g, minmax):
    if minmax and not 1 <= depth <= K.GB_MINMAX_MAX_DEPTH:
        pytest.skip("minmax takes depth 1..30")
    cp = _words((s, cb, w), cuda, 7)
    valid = _words((s, w), cuda, 8)
    planes = _words((s, 2 + depth, w), cuda, 9) if depth else None
    before = K.LAUNCHES["groupby_fused"]
    got = K.groupby_fused(cp, valid, planes, g, signed, minmax=minmax)
    torch.cuda.synchronize()
    assert K.LAUNCHES["groupby_fused"] == before + 1
    want = K.groupby_codes_plain(cp, valid, planes, g, signed, minmax=minmax)
    for a, b in zip(got, want):
        if a is None:
            assert b is None
        else:
            _same(a, b)


@pytest.mark.parametrize("s,cb,w,depth,signed,g", [
    (3, 7, 1000, 7, False, 128), (3, 7, 600, 7, True, 128),
    (2, 9, 700, 7, False, 512), (2, 8, 300, 0, False, 256),
    (2, 12, 300, 16, True, 4096)])
@pytest.mark.parametrize("fill", ["dense", "runs"])
@pytest.mark.parametrize("minmax", [False, True])
def test_groupby_fused_dense_and_empty_words(cuda, s, cb, w, depth, signed, g,
                                             fill, minmax):
    """The main path's density (every column valid, every value
    present) and valid planes of all-zero and all-ones word runs."""
    if minmax and not depth:
        pytest.skip("minmax takes BSI planes")
    cp = _words((s, cb, w), cuda, 32)
    planes = _words((s, 2 + depth, w), cuda, 33) if depth else None
    if fill == "dense":
        valid = torch.full((s, w), -1, dtype=torch.int32, device=cuda)
        if planes is not None:
            planes[:, 0] = -1
    else:
        valid = _words((s, w), cuda, 34)
        valid[:, 0:40] = 0
        valid[:, 40:90] = -1
        valid[:, -37:] = 0
    got = K.groupby_fused(cp, valid, planes, g, signed, minmax=minmax)
    want = K.groupby_codes_plain(cp, valid, planes, g, signed, minmax=minmax)
    for a, b in zip(got, want):
        if a is None:
            assert b is None
        else:
            _same(a, b)


def test_groupby_fused_all_invalid_and_views(cuda):
    """An all-zero valid plane adds nothing; views with the shard stride
    of a larger stack (the engine's group-code stack, a BSI stack's
    sign and magnitude planes) read the same words as copies."""
    cg = _words((4, 8, 2048), cuda, 10)
    planes = _words((4, 9, 2048), cuda, 11)
    zero = torch.zeros((4, 2048), dtype=torch.int32, device=cuda)
    got = K.groupby_fused(cg[:, :-1], zero, planes, 128, minmax=True)
    assert all(int(x.abs().sum()) == 0 for x in got[:4])
    assert got[4].tolist() == [[-1] * 128, [128] * 128] * 2
    _same(K.groupby_fused(cg[:, :-1], cg[:, -1], planes, 128)[1],
          K.groupby_fused(cg[:, :-1].contiguous(), cg[:, -1].contiguous(),
                          planes, 128)[1])
    _same(K.bsi_value_hist(planes, cg[:, 0]),
          K.bsi_value_hist_plain(planes, cg[:, 0]))
    _same(K.bsi_value_hist(planes), K.bsi_value_hist_plain(planes))


# groupby_sum: (field row counts, C, S, W, depth, signed).  Up to 16
# rows in all are staged in shared memory with the planes; (40, 30) and
# the 24 rows of eight fields are read per combo from global memory.
# C = 60 signed and C = 1100 take several passes of combos; S = 1 is
# fewer tiles than the persistent grid; W = 2049/513/77 are ragged
# against the 512-word tile and not a multiple of 4 words (4-byte copies);
# depth <= 8 and <= 16 keep the magnitudes in registers, 63 in the ring
_SUM = [
    ((4,), 1, 3, 200, 7, True),
    ((4, 2), 8, 3, 2049, 7, True),
    ((3, 2, 5), 30, 2, 1000, 5, False),
    ((2, 2, 2, 2), 16, 2, 513, 1, True),
    ((40, 30), 1100, 2, 64, 3, True),
    ((5, 3), 15, 2, 300, 63, True),
    ((5, 3), 15, 2, 300, 0, True),
    ((4, 2), 60, 2, 700, 7, True),
    ((3,), 5, 1, 77, 7, True),
    ((2,) * 8, 10, 2, 300, 3, True),
    ((3,) * 8, 10, 2, 260, 2, False),
    ((3, 2), 6, 2, 300, 12, False),
    ((3, 2), 6, 2, 300, 16, True),
]


@pytest.mark.parametrize("rows,c,s,w,depth,signed", _SUM)
def test_groupby_sum(cuda, rows, c, s, w, depth, signed):
    stacks = [_words((r, s, w), cuda, 12 + i) for i, r in enumerate(rows)]
    g = torch.Generator()
    g.manual_seed(c)
    sel = torch.stack([torch.randint(0, r, (c,), generator=g) for r in rows],
                      dim=1).to(torch.int32).to(cuda)
    planes = _words((s, 2 + depth, w), cuda, 20) if depth else None
    before = K.LAUNCHES["groupby_sum"]
    got = K.groupby_sum(stacks, sel, planes, signed)
    torch.cuda.synchronize()
    assert K.LAUNCHES["groupby_sum"] == before + 1
    want = K.groupby_sum_plain(stacks, sel, planes, signed)
    for a, b in zip(got, want):
        if a is None:
            assert b is None
        else:
            _same(a, b)


@pytest.mark.parametrize("signed", [False, True])
def test_groupby_sum_main_path_layout(cuda, signed):
    """GroupBy(Rows(t), Rows(a)) as the engine lays it out: 8 t rows x
    the one a row, combo r = (t row r, a row 0), depth 7."""
    s, w = 5, 4096
    stacks = [_words((8, s, w), cuda, 35), _words((1, s, w), cuda, 36)]
    sel = torch.tensor([[r, 0] for r in range(8)], dtype=torch.int32,
                       device=cuda)
    planes = _words((s, 9, w), cuda, 37)
    got = K.groupby_sum(stacks, sel, planes, signed)
    want = K.groupby_sum_plain(stacks, sel, planes, signed)
    for a, b in zip(got, want):
        _same(a, b)


# masked_popcount: N = 0, 1, 256 (the TopN loop's chunk) and 300 (past a
# chunk), W ragged against the 1024-word block and the 4-word vector
@pytest.mark.parametrize("n", [0, 1, 256, 300])
@pytest.mark.parametrize("w", [8, 1025, 32768, 4099])
def test_masked_popcount(cuda, n, w):
    x = _words((n + 1, w), cuda, 21)
    mask = _words((w + 1,), cuda, 22)
    for rows, m in ((x[:n], mask[:w]), (x[1:], mask[1:])):
        before = K.LAUNCHES["masked_popcount"]
        got = K.masked_popcount(rows, m)
        torch.cuda.synchronize()
        assert K.LAUNCHES["masked_popcount"] == before + (1 if n else 0)
        assert got.shape == (n,)
        _same(got, K.masked_popcount_plain(rows, m))


def test_masked_popcount_refuses_strided(cuda):
    x = _words((4, 64), cuda, 23)
    with pytest.raises(ValueError):
        K.masked_popcount(x[:, ::2], x[0, :32].contiguous())
    with pytest.raises(ValueError):
        K.masked_popcount(x[:, :32], x[0, :32].contiguous())


# masked_popcount_shards: the per-shard TopN/TopK scan in one launch.  S =
# 0, 1, 3 and 954; V = 0 (a time range that covers no view: nothing
# launches), 1 and 3 with absent views (None); R = 1, 8 and 300; odd W;
# the tile cache's RowTiles, also at one word's offset (row by row some
# tiles and masks not 16-byte aligned)
def _shard_case(s, v, r, w, cuda, masked, layout):
    base = _words((s, v, r, w + 1), cuda, 31)
    mbase = _words((s, w + 1), cuda, 32)
    off = 1 if layout == "offset" else 0
    tiles = []
    for si in range(s):
        views = []
        for vi in range(v):
            if si % 5 == 4 or (si % 3 == 1 and vi == 0 and v > 1):
                views.append(None)
            else:
                views.append(K.RowTiles(list(base[si, vi, :, off:off + w]),
                                        w, cuda))
        tiles.append(views)
    masks = None
    if masked:
        masks = [None if si % 4 == 2 else mbase[si, off:off + w]
                 for si in range(s)]
    return tiles, masks


@pytest.mark.parametrize("s,v,r,w", [
    (0, 1, 8, 64), (1, 1, 8, 32768), (1, 3, 300, 4099), (3, 1, 8, 201),
    (3, 3, 300, 1025), (3, 1, 1, 7), (954, 1, 8, 32768), (954, 3, 8, 1030),
    (3, 0, 8, 64), (1, 0, 300, 1025)])
@pytest.mark.parametrize("masked", [False, True], ids=["no_filter", "filter"])
@pytest.mark.parametrize("layout", ["aligned", "offset"])
def test_masked_popcount_shards(cuda, s, v, r, w, masked, layout):
    tiles, masks = _shard_case(s, v, r, w, cuda, masked, layout)
    before = K.LAUNCHES["masked_popcount"]
    got = K.masked_popcount_shards(tiles, masks, r, w, cuda)
    torch.cuda.synchronize()
    assert K.LAUNCHES["masked_popcount"] == before + (1 if s and v else 0)
    assert got.dtype == torch.int64 and got.shape == (r,)
    _same(got, K.masked_popcount_shards_plain(tiles, masks, r, w, cuda))
    if not v:
        assert not got.any()


def test_masked_popcount_shards_main_path_shape(cuda):
    """(954 shards, 8 rows, 32768 words) of row tiles, as the per-shard
    TopN hands them over, with and without filters and with two views,
    equal to one masked_popcount a shard summed."""
    rows = _words((954, 2, 8, 32768), cuda, 33)
    filt = _words((954, 32768), cuda, 34)
    for v in (1, 2):
        tiles = [[K.RowTiles(list(rows[si, vi]), 32768, cuda)
                  for vi in range(v)] for si in range(954)]
        for masks in (None, list(filt)):
            got = K.masked_popcount_shards(tiles, masks, 8, 32768, cuda)
            want = torch.zeros(8, dtype=torch.int64, device=cuda)
            for si in range(954):
                acc = rows[si, 0] if v == 1 else rows[si, 0] | rows[si, 1]
                want += (K.popcount_rows(acc) if masks is None
                         else K.masked_popcount(acc, filt[si])).to(torch.int64)
            _same(got, want)


def test_masked_popcount_shards_launches_or_raises(cuda, monkeypatch):
    """A CUDA call launches the kernel (never the plain version) and
    raises on what the kernel does not take."""
    def plain(*_a, **_k):
        raise AssertionError("the plain version ran for a CUDA tensor")
    monkeypatch.setattr(K, "masked_popcount_shards_plain", plain)
    x = _words((2, 4, 64), cuda, 35)
    t0, t1 = (K.RowTiles(list(x[i]), 64, cuda) for i in (0, 1))
    got = K.masked_popcount_shards([[t0], [t1]], [x[0, 0], None], 4, 64,
                                   cuda)
    torch.cuda.synchronize()
    want = (K.masked_popcount(x[0], x[0, 0]).to(torch.int64)
            + K.popcount_rows(x[1]).to(torch.int64))
    _same(got, want)
    with pytest.raises(TypeError):
        K.masked_popcount_shards([[x[0]]], None, 4, 64, cuda)
    with pytest.raises(ValueError):
        K.RowTiles(list(x[0].cpu()), 64, cuda)
    with pytest.raises(ValueError):
        K.masked_popcount_shards([[K.RowTiles(list(x[0].cpu()), 64, "cpu")]],
                                 None, 4, 64, cuda)
    with pytest.raises(ValueError):
        K.masked_popcount_shards([[t0]], None, 4, 65, cuda)
    with pytest.raises(ValueError):
        K.masked_popcount_shards([[t0]], [x[0, 0].cpu()], 4, 64, cuda)


def test_bad_cuda_shape_raises_before_the_plain_version(cuda, monkeypatch):
    """A CUDA tensor the kernel does not take raises; it never reaches
    the plain version."""
    def plain(*_a, **_k):
        raise AssertionError("the plain version ran for a CUDA tensor")
    monkeypatch.setattr(K, "masked_popcount_plain", plain)
    monkeypatch.setattr(K, "groupby_codes_plain", plain)
    x = _words((4, 64), cuda, 24)
    with pytest.raises(ValueError):
        K.masked_popcount(x, x[0, :63].contiguous())
    with pytest.raises(ValueError):
        K.groupby_onehot(x.view(4, 1, 64), x[:3], None, 2)
    with pytest.raises(ValueError):
        K.groupby_onehot(x.view(4, 1, 64), x, None, 4097)
    K.masked_popcount(x, x[0].contiguous())       # the kernel itself runs
    torch.cuda.synchronize()


# groupby_onehot: (S, CB, W, depth, signed, n_codes); CB 0 to 12, depth
# 0, 7 and 16 (K up to 34: three payload tiles), G up to 4096 (16 code
# groups on gridDim.y), W ragged against the 8-word tile
_ONEHOT = [
    (2, 0, 201, 0, True, 1),
    (3, 1, 64, 7, False, 2),
    (3, 3, 200, 7, True, 8),
    (3, 7, 2049, 7, False, 128),
    (3, 7, 2049, 7, True, 128),
    (4, 8, 999, 0, True, 256),
    (5, 9, 1000, 7, False, 512),
    (2, 5, 300, 16, True, 20),
    (2, 10, 513, 16, False, 1000),
    (2, 12, 700, 16, True, 4096),
    (2, 12, 96, 0, True, 4096),
    # the redesign's edges: K <= 8 (the factored form) at 5 and 8, K = 18
    # (two payload m-tiles), K = 16 past 128 codes (32 slices a warp), G
    # not a multiple of 8, codes past the first 256-code group at K = 6, 9
    # and 34, more code planes than G needs, W short of, just past and not
    # a multiple of the 256-word ring tile
    (3, 3, 130, 3, False, 8),
    (2, 5, 77, 3, True, 20),
    (3, 7, 127, 7, False, 100),
    (2, 10, 333, 16, False, 1000),
    (3, 12, 640, 7, False, 4096),
    (2, 12, 256, 2, True, 4096),
    (2, 13, 129, 16, True, 4096),
    (2, 9, 255, 7, True, 300),
    (3, 8, 300, 7, True, 200),
    (954, 7, 64, 7, False, 128),
]


@pytest.mark.parametrize("s,cb,w,depth,signed,g", _ONEHOT)
def test_groupby_onehot(cuda, s, cb, w, depth, signed, g):
    cp = _words((s, cb, w), cuda, 25)
    valid = _words((s, w), cuda, 26)
    planes = _words((s, 2 + depth, w), cuda, 27) if depth else None
    before = K.LAUNCHES["groupby_onehot"]
    got = K.groupby_onehot(cp, valid, planes, g, signed)
    torch.cuda.synchronize()
    assert K.LAUNCHES["groupby_onehot"] == before + 1
    want = K.groupby_codes_plain(cp, valid, planes, g, signed)
    fused = K.groupby_fused(cp, valid, planes, g, signed)
    for a, b, c in zip(got, want, fused):
        if a is None:
            assert b is None and c is None
        else:
            _same(a, b)
            _same(a, c)


def _onehot_equals_plain_and_fused(cp, valid, planes, g, signed):
    got = K.groupby_onehot(cp, valid, planes, g, signed)
    torch.cuda.synchronize()
    want = K.groupby_codes_plain(cp, valid, planes, g, signed)
    fused = K.groupby_fused(cp, valid, planes, g, signed)
    for a, b, c in zip(got, want, fused):
        if a is None:
            assert b is None and c is None
        else:
            _same(a, b)
            _same(a, c)
    return got


@pytest.mark.parametrize("depth,signed,g", [(0, True, 128), (7, False, 128),
                                            (7, True, 128), (16, True, 1000)])
def test_groupby_onehot_dense_codes(cuda, depth, signed, g):
    """Every column valid and in one code (the same slice for every word),
    then every column valid with every code of G present in every shard."""
    s, w = 3, 520
    cb = max(g - 1, 1).bit_length()
    planes = _words((s, 2 + depth, w), cuda, 30) if depth else None
    every = torch.full((s, w), -1, dtype=torch.int32, device=cuda)
    one_code = torch.zeros((s, cb, w), dtype=torch.int32, device=cuda)
    one_code[:, 0] = -1                                   # code 1 everywhere
    counts = _onehot_equals_plain_and_fused(one_code, every, planes, g, signed)[0]
    assert int(counts[1]) == s * w * 32
    codes = torch.arange(w * 32, device=cuda) % g
    bits = torch.stack([(codes >> b) & 1 for b in range(cb)])  # (cb, w * 32)
    packed = (bits.view(cb, w, 32).to(torch.int64)
              << torch.arange(32, device=cuda)).sum(-1)
    cp = packed.where(packed < 2**31, packed - 2**32).to(torch.int32)
    cp = cp.unsqueeze(0).repeat(s, 1, 1)
    counts = _onehot_equals_plain_and_fused(cp, every, planes, g, signed)[0]
    assert bool((counts > 0).all())


@pytest.mark.parametrize("cb,depth,signed,g", [(7, 7, True, 128), (8, 0, True, 256),
                                               (10, 16, False, 1000)])
def test_groupby_onehot_strided_views(cuda, cb, depth, signed, g):
    """Code planes and valid as views of one (S, CB+1, W) stack, planes
    at an odd word offset (no 16-byte copies), W odd: the same words as
    contiguous copies."""
    s, w = 3, 301
    stack = _words((s, cb + 1, w), cuda, 31)
    flat = _words((s * (2 + depth) * w + 1,), cuda, 32)
    planes = flat[1:].view(s, 2 + depth, w) if depth else None
    got = _onehot_equals_plain_and_fused(stack[:, :-1], stack[:, -1], planes,
                                         g, signed)
    copies = K.groupby_onehot(stack[:, :-1].contiguous(),
                              stack[:, -1].contiguous(),
                              None if planes is None else planes.contiguous(),
                              g, signed)
    for a, b in zip(got, copies):
        if a is not None:
            _same(a, b)


def test_groupby_onehot_views_and_value_hist(cuda):
    """Strided views read the same words as copies; the value
    histogram through the one-hot kernel equals its plain version."""
    cg = _words((4, 8, 2048), cuda, 28)
    planes = _words((4, 9, 2048), cuda, 29)
    _same(K.groupby_onehot(cg[:, :-1], cg[:, -1], planes, 128)[2],
          K.groupby_onehot(cg[:, :-1].contiguous(), cg[:, -1].contiguous(),
                           planes, 128)[2])
    _same(K.bsi_value_hist(planes, cg[:, 0], gb=K.groupby_onehot),
          K.bsi_value_hist_plain(planes, cg[:, 0]))


def test_empty_inputs_launch_nothing(cuda):
    before = dict(K.LAUNCHES)
    x = torch.zeros((0, 16), dtype=torch.int32, device=cuda)
    assert K.popcount_rows(x).shape == (0,)
    assert K.pair_popcount(x, x).shape == (0,)
    assert K.rows_filter_counts(x.view(3, 0, 16)[:, :0], x).shape == (3, 0)
    assert K.LAUNCHES == before


def test_executor_on_the_card_matches_the_cpu(cuda):
    """A small index answered on the card and by the plain versions."""
    from pilosa_tpu_torch.executor.executor import Executor
    from pilosa_tpu_torch.models.holder import Holder
    from pilosa_tpu_torch.models.schema import FieldOptions, FieldType

    rng = np.random.default_rng(3)
    h = Holder(width=4096)
    idx = h.create_index("i")
    f = idx.create_field("f", FieldOptions(cache_type="none"))
    v = idx.create_field("v", FieldOptions(type=FieldType.INT,
                                           min=-500, max=500))
    cat = idx.create_field("cat")
    cols = rng.integers(0, 4096 * 5, size=20000)
    f.import_bits(rng.integers(0, 6, size=cols.size), cols)
    v.import_values(cols[:5000], rng.integers(-500, 501, size=5000))
    every = np.arange(4096 * 5)
    cat.import_bits(rng.integers(0, 7, size=every.size), every)
    idx.mark_columns_exist(cols)
    queries = ["Count(Intersect(Row(f=1), Row(f=2)))", "Count(Row(f=3))",
               "Count(Not(Row(f=1)))", "TopN(f, n=4)",
               "TopN(f, Union(Row(f=1), Row(v > 3)), n=4)",
               "Sum(field=v)", "Sum(Row(f=2), field=v)",
               "Count(Row(-20 < v < 300))", "Row(v == 7)",
               "GroupBy(Rows(cat), aggregate=Sum(field=v))",
               "GroupBy(Rows(cat), filter=Row(f=1), aggregate=Max(field=v))",
               "GroupBy(Rows(f), Rows(cat), aggregate=Sum(field=v))",
               "Min(field=v)", "Max(Row(f=2), field=v)", "Distinct(field=v)"]
    on_cpu = Executor(h, device="cpu")
    wants = [repr(on_cpu.execute("i", q)) for q in queries]
    # 1 KiB pages: two lanes of 128 words a page, so every stack of the
    # five shards has several pages and a hit runs assemble_pages
    from pilosa_tpu_torch import memory
    page_bytes = memory.page_bytes()
    memory.configure(page_bytes=1024)
    try:
        on_card = Executor(h)
        per_shard = Executor(h)
        per_shard.use_stacked = False
        onehot = Executor(h)
        onehot.stacked.onepass_arm = "onehot"
        K.reset_launches()
        for ex in (on_card, per_shard, onehot):
            for q, want in zip(queries, wants):
                assert repr(ex.execute("i", q)) == want, q
    finally:
        memory.configure(page_bytes=page_bytes)
    # the ragged program's page-table reads launch only under the serving
    # layer (test_serving_ragged_on_the_card)
    assert all(n > 0 for k, n in K.LAUNCHES.items()
               if k not in ("concat_gather", "segment_count")), K.LAUNCHES
    assert per_shard.paths[("TopN", "asked")] == 2


def test_serving_ragged_on_the_card(cuda):
    """A mixed batch over two indexes and a shard subset through the
    serving layer's ragged program on the card equals the CPU's solo
    answers, and launches both page-table kernels."""
    from pilosa_tpu_torch import memory
    from pilosa_tpu_torch.executor.executor import Executor
    from pilosa_tpu_torch.models.holder import Holder
    from pilosa_tpu_torch.models.schema import FieldOptions, FieldType
    from pilosa_tpu_torch.pql import parse

    rng = np.random.default_rng(5)
    h = Holder(width=4096)
    for name, n_shards in (("alpha", 5), ("beta", 3)):
        idx = h.create_index(name)
        f = idx.create_field("f", FieldOptions(cache_type="none"))
        v = idx.create_field("v", FieldOptions(type=FieldType.INT,
                                               min=0, max=500))
        cat = idx.create_field("cat")
        cols = rng.integers(0, 4096 * n_shards, size=6000)
        f.import_bits(rng.integers(0, 4, size=cols.size), cols)
        v.import_values(cols[:2000], rng.integers(0, 501, size=2000))
        every = np.arange(4096 * n_shards)
        cat.import_bits(rng.integers(0, 5, size=every.size), every)
        idx.mark_columns_exist(cols)
    items = [("alpha", "Count(Row(f=1))", None),
             ("alpha", "Count(Row(f=2))", None),
             ("alpha", "Count(Row(f=1))", [0, 1, 2]),
             ("beta", "Count(Row(f=0))", None),
             ("beta", "Count(Row(f=3))", None),
             ("alpha", "Count(Intersect(Row(f=1), Row(f=2)))", None),
             ("beta", "Row(f=2)", None), ("alpha", "TopN(f, n=3)", None),
             ("alpha", "Sum(Row(f=1), field=v)", None),
             ("beta", "Count(Row(v > 250))", None),
             ("alpha", "GroupBy(Rows(cat), aggregate=Sum(field=v))", None)]
    on_cpu = Executor(h, device="cpu")
    wants = [repr(on_cpu.execute(i, q, s)) for i, q, s in items]
    page_bytes = memory.page_bytes()
    memory.configure(page_bytes=1024)     # two lanes of 128 words a page
    try:
        ex = Executor(h)
        layer = ex.enable_serving(window_s=0.0, max_batch=64, cache_bytes=0,
                                  admission=False)
        K.reset_launches()
        for _ in range(2):
            reqs = [layer._classify(i, h.index(i), parse(q), s, None,
                                    (i, q, None)) for i, q, s in items]
            layer._run_batch(reqs)
            for (i, q, s), r, want in zip(items, reqs, wants):
                assert r.error is None and not r.direct, (q, r.error)
                assert repr(r.result) == want, q
        assert K.LAUNCHES["concat_gather"] > 0
        assert K.LAUNCHES["segment_count"] > 0
        layer.close()
    finally:
        memory.configure(page_bytes=page_bytes)


def test_fallback_shapes_on_the_card_match_the_cpu(cuda):
    """A depth-40 field's Min/Max/Distinct, GroupBy Max past depth 16 and
    over overlapping rows, and Count(Distinct), on the default executor."""
    from pilosa_tpu_torch.executor.executor import Executor
    from pilosa_tpu_torch.models.holder import Holder
    from pilosa_tpu_torch.models.schema import FieldOptions, FieldType

    rng = np.random.default_rng(4)
    h = Holder(width=4096)
    idx = h.create_index("t")
    cols = np.arange(4096 * 3)
    ts = idx.create_field("ts", FieldOptions(type=FieldType.INT, min=0,
                                             max=(1 << 40) - 1))
    ts.import_values(cols[::2], (1 << 39) + rng.integers(0, 86400,
                                                          size=cols[::2].size))
    s = idx.create_field("s", FieldOptions(cache_type="none"))
    s.import_bits(rng.integers(0, 4, size=cols.size),
                  rng.integers(0, cols.size, size=cols.size))
    m = idx.create_field("m", FieldOptions(type=FieldType.MUTEX))
    m.import_bits(rng.integers(0, 3, size=cols.size), cols)
    queries = ["Min(field=ts)", "Max(Row(m=1), field=ts)", "Distinct(field=ts)",
               "Distinct(Row(m=2), field=ts)",
               "GroupBy(Rows(m), aggregate=Max(field=ts))",
               "GroupBy(Rows(s), aggregate=Min(field=ts))",
               "GroupBy(Rows(m), aggregate=Count(Distinct(field=s)))",
               "MinRow(Row(m=1), field=s)", "Distinct(Row(m=0), field=s)"]
    on_card, on_cpu = Executor(h), Executor(h, device="cpu")
    for q in queries:
        assert repr(on_card.execute("t", q)) == repr(on_cpu.execute("t", q)), q
    assert on_card.paths == on_cpu.paths


def _read_surface_holder(width: int, n_shards: int, seed: int):
    """A set field f, an INT v of heavy ties and negatives (-3..3) on
    about 70% of the columns, over n_shards shards."""
    from pilosa_tpu_torch.models.holder import Holder
    from pilosa_tpu_torch.models.schema import FieldOptions, FieldType

    rng = np.random.default_rng(seed)
    h = Holder(width=width)
    idx = h.create_index("s")
    cols = np.arange(width * n_shards)
    idx.create_field("f").import_bits(
        rng.integers(0, 3, size=cols.size), cols)
    vcols = cols[rng.random(cols.size) < 0.7]
    vals = rng.integers(-3, 4, size=vcols.size)
    idx.create_field("v", FieldOptions(type=FieldType.INT, min=-3, max=3)) \
        .import_values(vcols, vals)
    return h, vcols, vals


@pytest.mark.parametrize("stacked", [True, False])
def test_limit_bounded_sort_equals_a_full_stable_sort(cuda, monkeypatch,
                                                      stacked):
    """Sort on the card, each chunk of shards sorted on the device and
    cut to offset+limit, equals numpy's stable sort of every column,
    ties in column order, both directions (chunks of 3 shards)."""
    from pilosa_tpu_torch.executor import stacked as st
    from pilosa_tpu_torch.executor.executor import Executor

    h, vcols, vals = _read_surface_holder(1 << 16, 10, 8)
    monkeypatch.setattr(st, "_DECODE_CHUNK", 3)
    ex = Executor(h)
    ex.use_stacked = stacked
    for desc in (False, True):
        order = np.lexsort((vcols, -vals if desc else vals))
        for offset, limit in ((0, 10), (1000, 500), (250000, 70000),
                              (0, None), (400000, 5)):
            args = f", offset={offset}" + (
                "" if limit is None else f", limit={limit}")
            got = ex.execute("s", f"Sort(field=v, sort-desc="
                                  f"{str(desc).lower()}{args})")[0]
            end = None if limit is None else offset + limit
            assert got.columns == vcols[order][offset:end].tolist()
            assert got.values == vals[order][offset:end].tolist()


@pytest.mark.parametrize("stacked", [True, False])
def test_limit_selects_the_shards_of_full_materialisation(cuda, stacked):
    """Limit on the card (popcount_rows over the child's stack, only the
    covering shards brought back) equals slicing every column of the
    child's row."""
    from pilosa_tpu_torch.executor.executor import Executor

    h, _vcols, _vals = _read_surface_holder(1 << 16, 10, 9)
    ex = Executor(h)
    ex.use_stacked = stacked
    full = ex.execute("s", "Union(Row(f=1), Row(v == -3))")[0].columns()
    for offset, limit in ((0, 1), (5, 70000), (21000, 30000),
                          (len(full) - 3, 10), (len(full), 4), (7, None)):
        args = f"offset={offset}" + ("" if limit is None
                                     else f", limit={limit}")
        before = K.LAUNCHES["popcount_rows"]
        got = ex.execute("s", f"Limit(Union(Row(f=1), Row(v == -3)), "
                              f"{args})")[0]
        end = None if limit is None else offset + limit
        assert got.columns().tolist() == full[offset:end].tolist()
        assert K.LAUNCHES["popcount_rows"] == before + 1


def test_percentile_launches_kernels_and_never_a_plain_version(cuda,
                                                               monkeypatch):
    """Percentile on the card launches bsi_range for its search and
    (stacked) groupby_fused for its Min/Max, on both engines, and no
    plain version of a kernel runs; the answers equal the CPU's."""
    from pilosa_tpu_torch.executor.executor import Executor

    h, _vcols, _vals = _read_surface_holder(1 << 14, 6, 10)
    queries = ["Percentile(field=v, nth=50)", "Percentile(field=v, nth=97)",
               "Percentile(field=v, nth=30, filter=Row(f=2))"]
    wants = [repr(Executor(h, device="cpu").execute("s", q)) for q in queries]

    def plain(*_a, **_k):
        raise AssertionError("a plain version ran on the card")
    for name in dir(K):
        if name.endswith("_plain"):
            monkeypatch.setattr(K, name, plain)
    for stacked in (True, False):
        ex = Executor(h)
        ex.use_stacked = stacked
        K.reset_launches()
        for q, want in zip(queries, wants):
            assert repr(ex.execute("s", q)) == want, q
        assert K.LAUNCHES["bsi_range"] > 0, K.LAUNCHES
        assert (K.LAUNCHES["groupby_fused"] > 0) == stacked, K.LAUNCHES


@pytest.mark.parametrize("plen", [1, 3, 64, 32768])
def test_patch_rows_on_the_card(cuda, plen):
    """patch_rows scatters word runs into a CUDA stack in place, equal to
    patch_rows_np on the host words."""
    from pilosa_tpu_torch.ops import bitmap as bm

    rng = np.random.default_rng(plen)
    w = max(plen, 4096)
    host = rng.integers(0, 1 << 32, size=(40, w), dtype=np.uint32)
    n = 17
    idxs = rng.choice(40, size=n, replace=False)
    starts = rng.integers(0, w - plen + 1, size=n)
    data = rng.integers(0, 1 << 32, size=(n, plen), dtype=np.uint32)
    t = bm.to_tensor(host, cuda)
    ptr = t.data_ptr()
    out = bm.patch_rows(t, idxs, starts, data)
    torch.cuda.synchronize()
    assert out is t and t.data_ptr() == ptr and t.device.type == "cuda"
    assert np.array_equal(bm.to_numpy(t),
                          bm.patch_rows_np(host, idxs, starts, data))


def test_patched_stacks_on_the_card_equal_rebuilds(cuda):
    """Writes through execute patch the card's resident stacks and tiles
    in place (counted as patches, no rebuild); each patched stack and
    tile equals a fresh executor's build bit for bit, and the answers
    equal the CPU's."""
    from pilosa_tpu_torch.executor.executor import Executor
    from pilosa_tpu_torch.models.holder import Holder
    from pilosa_tpu_torch.models.schema import FieldOptions, FieldType
    from pilosa_tpu_torch.models.view import VIEW_STANDARD
    from pilosa_tpu_torch.ops import bitmap as bm

    rng = np.random.default_rng(8)
    width, n_shards = 1 << 16, 6
    h = Holder(width=width)
    idx = h.create_index("p")
    f = idx.create_field("f", FieldOptions(cache_type="none"))
    v = idx.create_field("v", FieldOptions(type=FieldType.INT, min=-500,
                                           max=500))
    cols = rng.integers(0, width * n_shards, size=200000)
    f.import_bits(rng.integers(0, 4, size=cols.size), cols)
    v.import_values(np.unique(cols), rng.integers(
        -500, 501, size=np.unique(cols).size))
    reads = ["Count(Intersect(Row(f=1), Row(f=2)))", "TopN(f, Row(f=0), n=4)",
             "Sum(Row(f=3), field=v)", "Count(Row(v > 100))"]
    ex, lp = Executor(h), Executor(h)
    lp.use_stacked = False
    for e in (ex, lp):
        for q in reads:
            e.execute("p", q)
    before = [c.counters() for c in (ex.stacked.cache, lp.tiles.cache)]
    for i in range(20):
        c = int(rng.integers(0, width * n_shards - 3))
        ex.execute("p", f"Set({c}, f={i % 4})Set({c + 1}, v={i * 7 - 70})")
        ex.execute("p", f"Clear({c + 2}, f={i % 4})")
        answers = [[repr(e.execute("p", q)) for q in reads] for e in (ex, lp)]
        want = [repr(Executor(h, device="cpu").execute("p", q)) for q in reads]
        assert answers == [want, want]
    for cache, was in zip((ex.stacked.cache, lp.tiles.cache), before):
        now = cache.counters()
        assert now["patches"] > was["patches"]
        assert now["full_rebuilds"] == was["full_rebuilds"], now
    skey = tuple(range(n_shards))
    fresh = Executor(h).stacked
    for got, want in (
            (ex.stacked.rows_stack_for(idx, f, (VIEW_STANDARD,), [0, 1, 2, 3],
                                       skey),
             fresh.rows_stack_for(idx, f, (VIEW_STANDARD,), [0, 1, 2, 3],
                                  skey)),
            (ex.stacked.plane_stack(idx, v, skey),
             fresh.plane_stack(idx, v, skey))):
        assert got.device.type == "cuda"
        assert np.array_equal(bm.to_numpy(got), bm.to_numpy(want))
    # the per-shard engine's patched (W,) row tiles and plane tiles
    # equal fresh uploads, and reading them built nothing
    built = lp.tiles.cache.full_rebuilds
    uploads = Executor(h).tiles
    for s_ in skey:
        fr = f.views[VIEW_STANDARD].fragment(s_)
        pairs = [(lp.tiles.row(fr, r), uploads.row(fr, r)) for r in range(4)]
        vf = v.views[v.bsi_view].fragment(s_)
        pairs.append((lp.tiles.planes(vf, v.bit_depth),
                      uploads.planes(vf, v.bit_depth)))
        for got, want in pairs:
            assert got.device.type == "cuda"
            assert np.array_equal(bm.to_numpy(got), bm.to_numpy(want))
    assert lp.tiles.cache.full_rebuilds == built


def test_api_import_sync_and_reopen_on_the_card(cuda, tmp_path, monkeypatch):
    """The API on the card over a path-backed holder: a columnar import
    into resident stacks is answered as the CPU answers (patched or
    rebuilt by reason, never stale), and after sync and a reopen a new
    API on the card answers the same from the rows that came off disk."""
    from pilosa_tpu_torch.api import API
    from pilosa_tpu_torch.models.holder import Holder

    monkeypatch.setenv("RBF_NOSYNC", "1")
    width, n_shards = 1 << 16, 4
    rng = np.random.default_rng(12)
    api = API(Holder(path=str(tmp_path), width=width))
    api.apply_schema({"indexes": [{"name": "g", "fields": [
        {"name": "segment", "options": {"type": "set",
                                        "cache_type": "none"}},
        {"name": "amount", "options": {"type": "int", "min": 0,
                                       "max": 999}},
        {"name": "active", "options": {"type": "bool"}}]}]})
    queries = ["Count(Row(segment=3))", "TopN(segment, n=5)",
               "Sum(field=amount)", "Count(Row(amount > 500))",
               "GroupBy(Rows(segment), aggregate=Sum(field=amount))",
               "Min(field=amount)", "Max(field=amount)",
               "Count(Row(active=true))"]

    def load(lo, n):
        cols = np.arange(lo, lo + n, dtype=np.int64)
        api.import_columns("g", cols, bits={
            "segment": rng.integers(0, 16, size=n),
            "active": rng.integers(0, 2, size=n)},
            values={"amount": rng.integers(0, 1000, size=n)})

    def on_cpu(h):
        cpu = API(h, device="cpu")
        return [cpu.query("g", q) for q in queries]

    load(0, width * n_shards)
    assert [api.query("g", q) for q in queries] == on_cpu(api.holder)
    load(width, width // 2)            # into resident stacks
    want = on_cpu(api.holder)
    assert [api.query("g", q) for q in queries] == want
    counters = api.executor.stacked.cache.counters()
    assert counters["patches"] + sum(counters["rebuilds"].values()) > 0
    api.holder.sync()
    api.holder.close()
    del api
    torch.cuda.empty_cache()
    h = Holder(path=str(tmp_path), width=width)
    h.load_schema()
    again = API(h)
    assert [again.query("g", q) for q in queries] == want
    h.close()


def _time_holder(width, n_shards, hours, seed=21):
    """A TIME field ev (YMDH, rows 0-3) with seeded columns in each hour
    from 2022-06-01, imported with timestamps; returns the holder and
    the (row, column, hour) triples."""
    import datetime as dt

    from pilosa_tpu_torch.models.holder import Holder
    from pilosa_tpu_torch.models.schema import (
        FieldOptions, FieldType, TimeQuantum)

    rng = np.random.default_rng(seed)
    h = Holder(width=width)
    f = h.create_index("e", track_existence=False).create_field(
        "ev", FieldOptions(type=FieldType.TIME,
                           time_quantum=TimeQuantum("YMDH")))
    n = 40
    hrs = np.repeat(np.arange(hours), n)
    rows = rng.integers(0, 4, size=hrs.size)
    cols = rng.integers(0, width * n_shards, size=hrs.size)
    base = dt.datetime(2022, 6, 1)
    f.import_bits(rows, cols,
                  [base + dt.timedelta(hours=int(x)) for x in hrs])
    return h, np.stack([rows, cols, hrs], axis=1)


def _window(lo, hi):
    import datetime as dt
    base = dt.datetime(2022, 6, 1)
    fmt = "%Y-%m-%dT%H:%M"
    return (f"Count(Row(ev=1, from='"
            f"{(base + dt.timedelta(hours=lo)).strftime(fmt)}', to='"
            f"{(base + dt.timedelta(hours=hi)).strftime(fmt)}'))")


def _window_count(tr, lo, hi):
    m = (tr[:, 0] == 1) & (tr[:, 2] >= lo) & (tr[:, 2] < hi)
    return int(np.unique(tr[m, 1]).size)


def test_qcover_count_and_rolled_window_on_the_card(cuda):
    """A Count over a 38-view cover runs as single-view leaves on the
    card (one build a leaf, popcount_rows launched), equal to the CPU
    and to numpy; the window shifted by an hour builds one leaf; with
    qcover off the cover is one leaf and the answer is the same."""
    from pilosa_tpu_torch.executor.executor import Executor
    from pilosa_tpu_torch.models import timeq

    h, tr = _time_holder(1 << 16, 3, 120)
    ex = Executor(h)
    q = _window(30, 114)                # 18 H + 2 D + 18 H
    before = K.LAUNCHES["popcount_rows"]
    got = ex.execute("e", q)
    assert K.LAUNCHES["popcount_rows"] > before
    assert got == Executor(h, device="cpu").execute("e", q) == [
        _window_count(tr, 30, 114)]
    assert ex.stacked.cache.full_rebuilds == 38
    assert ex.execute("e", _window(31, 115)) == [_window_count(tr, 31, 115)]
    assert ex.stacked.cache.full_rebuilds == 39
    timeq.configure(qcover=False)
    try:
        assert Executor(h).execute("e", q) == got
    finally:
        timeq.configure(qcover=True)


def test_live_edge_write_patches_one_leaf_on_the_card(cuda):
    """A Set inside the cover's newest hour patches that hour's leaf on
    the card (one patch, no build), and the Count is exact."""
    import datetime as dt

    from pilosa_tpu_torch.executor.executor import Executor

    h, tr = _time_holder(1 << 16, 3, 72)
    ex = Executor(h)
    q = _window(6, 60)
    assert ex.execute("e", q) == [_window_count(tr, 6, 60)]
    col = next(c for c in range(3 << 16) if not (
        (tr[:, 0] == 1) & (tr[:, 1] == c) & (tr[:, 2] >= 6)
        & (tr[:, 2] < 60)).any())
    ts = (dt.datetime(2022, 6, 1) + dt.timedelta(hours=59, minutes=30)
          ).strftime("%Y-%m-%dT%H:%M")
    ex.execute("e", f"Set({col}, ev=1, {ts})")
    c0 = ex.stacked.cache.counters()
    assert ex.execute("e", q) == [_window_count(tr, 6, 60) + 1]
    c1 = ex.stacked.cache.counters()
    assert c1["patches"] - c0["patches"] == 1
    assert c1["full_rebuilds"] == c0["full_rebuilds"]


def test_dataframe_aggregate_on_the_card(cuda):
    """aggregate reduces on the card and answers as the CPU does: ints
    exact under the 32-bit wrap, float sums and means within a relative
    1e-6 of numpy's float64 sum of the float32 values."""
    from pilosa_tpu_torch.models.dataframe import IndexDataframe

    rng = np.random.default_rng(5)
    n = 1 << 16
    ints = rng.integers(0, (1 << 31) + (1 << 28), size=n)
    floats = rng.random(n)
    df = IndexDataframe(None)
    df.add_rows([{"_id": i, "i": int(a), "f": float(b)}
                 for i, (a, b) in enumerate(zip(ints, floats))])
    i32 = ints.astype(np.int32)
    f32 = floats.astype(np.float32)
    for op in ("sum", "min", "max", "count"):
        assert df.aggregate(op, "i") == df.aggregate(op, "i", device="cpu")
    assert df.aggregate("sum", "i") == (
        int(i32.astype(np.int64).sum()) + (1 << 31)) % (1 << 32) - (1 << 31)
    assert df.aggregate("min", "f") == float(f32.min())
    assert df.aggregate("max", "f") == float(f32.max())
    assert df.aggregate("count", "f") == float(n)
    for op, col, want in (
            ("sum", "f", f32.astype(np.float64).sum()),
            ("mean", "f", f32.astype(np.float64).mean()),
            ("mean", "i", i32.astype(np.float64).mean())):
        got = df.aggregate(op, col)
        assert abs(got - want) <= 1e-6 * abs(want), (op, col, got, want)


def test_sql_on_the_card_matches_the_cpu(cuda):
    """SQL statements answered on the card, on both engines, equal the
    plain versions' answers; an INSERT between two passes patches the
    resident stacks, and the kernels of SQL's path launch."""
    from pilosa_tpu_torch.executor.executor import Executor
    from pilosa_tpu_torch.models.holder import Holder
    from pilosa_tpu_torch.sql import SQLEngine

    rng = np.random.default_rng(5)
    stmts = [
        "SELECT COUNT(*) FROM t WHERE SETCONTAINS(s, 1) AND "
        "SETCONTAINS(s, 2)",
        "SELECT SUM(age) FROM t WHERE SETCONTAINS(s, 1)",
        "SELECT COUNT(*) FROM t WHERE age BETWEEN 10 AND 100",
        "SELECT m, SUM(age) FROM t GROUP BY m",
        "SELECT MIN(age), MAX(age), AVG(age) FROM t WHERE SETCONTAINS(s, 3)",
        "SELECT DISTINCT age FROM t",
        "SELECT PERCENTILE(age, 50) FROM t",
        "SELECT _id, age FROM t WHERE SETCONTAINS(s, 1) AND age > 120 "
        "ORDER BY age DESC LIMIT 20",
        "SELECT _id FROM t WHERE SETCONTAINS(s, 2) LIMIT 10",
    ]

    def build(device):
        h = Holder(width=4096)
        eng = SQLEngine(h, executor=Executor(h, device=device))
        eng.query("CREATE TABLE t (_id id, s idset, age int min -10 "
                  "max 250, m string)")
        r = np.random.default_rng(5)
        vals = ", ".join(
            f"({c}, ({int(r.integers(0, 4))}, {int(r.integers(0, 4))}), "
            f"{int(r.integers(-10, 251))}, '{'xyz'[int(r.integers(0, 3))]}')"
            for c in r.choice(4096 * 6, size=1500, replace=False).tolist())
        eng.query("INSERT INTO t (_id, s, age, m) VALUES " + vals)
        return eng

    cpu = build("cpu")
    insert = "INSERT INTO t (_id, age) VALUES " + ", ".join(
        f"({c}, {int(v)})" for c, v in zip(
            rng.choice(4096 * 6, size=64, replace=False).tolist(),
            rng.integers(0, 251, size=64)))
    wants = [[cpu.query_one(q).rows for q in stmts]]
    cpu.query(insert)
    wants.append([cpu.query_one(q).rows for q in stmts])
    for stacked in (True, False):
        eng = build(None)
        eng.executor.use_stacked = stacked
        K.reset_launches()
        assert [eng.query_one(q).rows for q in stmts] == wants[0]
        cache = (eng.executor.stacked.cache if stacked
                 else eng.executor.tiles.cache)
        before = cache.counters()
        eng.query(insert)
        assert [eng.query_one(q).rows for q in stmts] == wants[1]
        after = cache.counters()
        assert after["patches"] > before["patches"]
        assert {k: v for k, v in after["rebuilds"].items() if k != "cold"} \
            == {k: v for k, v in before["rebuilds"].items() if k != "cold"}
        for k in ("popcount_rows", "bsi_range", "bsi_sum_counts"):
            assert K.LAUNCHES[k] > 0, (stacked, k, K.LAUNCHES)


# -- assemble_pages (csrc/page_kernels.cu) ------------------------------------

def _page_mix_inputs(lanes, pl, w, kinds, device, seed=0, sparsity=64):
    """Pages of the given kinds (cycled) holding `lanes` lanes, their
    payloads from memory/encode.py on seeded words (an encoded page
    holds up to one bit in `sparsity` words); returns (pages, host words
    of every lane)."""
    from pilosa_tpu_torch.memory import encode
    rng = np.random.default_rng(seed)
    n_pages = -(-lanes // pl)
    host = np.zeros((n_pages * pl, w), np.uint32)
    pages = []
    for i in range(n_pages):
        kind = kinds[i % len(kinds)]
        blk = np.zeros((pl, w), np.uint32)
        nv = min(pl, lanes - i * pl)             # lanes past nv: padding
        flat = blk[:nv].reshape(-1)
        if kind == "dense":
            flat[:] = rng.integers(0, 1 << 32, size=flat.size,
                                   dtype=np.uint32)
        else:
            if kind == "run":
                lo = int(rng.integers(0, flat.size // 2))
                flat[lo:lo + max(flat.size // 4, 1)] = 0xFFFFFFFF
            n = int(rng.integers(1, max(2, flat.size // sparsity)))
            pos = rng.choice(flat.size * 32, size=n, replace=False)
            np.bitwise_or.at(flat, pos // 32,
                             np.uint32(1) << (pos % 32).astype(np.uint32))
        host[i * pl:(i + 1) * pl] = blk
        enc = None if kind == "dense" else encode.encode_block(blk)
        assert (enc.kind if enc is not None else "dense") == kind
        pages.append(torch.from_numpy(blk.view(np.int32)).to(device)
                     if enc is None else enc.to_device(device))
    return pages, host[:lanes]


@pytest.mark.parametrize("lanes,pl,w,kinds", [
    (1, 1, 8, ["dense"]), (5, 2, 201, ["dense"]), (7, 3, 64, ["packed"]),
    (9, 4, 36, ["run"]), (40, 16, 64, ["dense", "packed", "run"]),
    (954, 32, 32768, ["dense"]), (96, 32, 32768, ["packed", "run"])])
def test_assemble_pages(cuda, lanes, pl, w, kinds):
    pages, host = _page_mix_inputs(lanes, pl, w, kinds, cuda)
    before = K.LAUNCHES["assemble_pages"]
    got = K.assemble_pages(pages, (lanes, w), pl)
    torch.cuda.synchronize()
    assert K.LAUNCHES["assemble_pages"] == before + 1
    _same(got, K.assemble_pages_plain(pages, (lanes, w), pl))
    assert np.array_equal(got.cpu().numpy().view(np.uint32), host)
    # a kept table (the stack cache's warm hit) gives the same words
    table = K.page_table(pages, (lanes, w), pl)
    _same(K.assemble_pages(pages, (lanes, w), pl, table=table), got)


# the kernel's blocks take runs of tiles of K._PAGE_TILE_WORDS words (up
# to 2 a dense run, 8 an encoded one; 3 stages of shared memory an encoded
# run): a page of under one tile, of exactly two, of three, of six, seven,
# and one that ends inside a tile
_TILE = K._PAGE_TILE_WORDS


@pytest.mark.parametrize("lanes,pl,w", [
    (2, 2, _TILE // 4), (2, 2, _TILE), (3, 3, _TILE), (6, 6, _TILE),
    (7, 7, _TILE), (25, 25, 1000),
    (40, 4, _TILE), (1, 1, 1), (9, 4, 1), (7, 3, 201), (300, 1, 256),
    (300, 1, 8)])
def test_assemble_pages_run_edges(cuda, lanes, pl, w):
    pages, host = _page_mix_inputs(lanes, pl, w, ["dense"], cuda, seed=lanes)
    got = K.assemble_pages(pages, (lanes, w), pl)
    _same(got, K.assemble_pages_plain(pages, (lanes, w), pl))
    assert np.array_equal(got.cpu().numpy().view(np.uint32), host)


@pytest.mark.parametrize("lanes,pl,w,kinds,sparsity", [
    (96, 4, 8192, ["packed", "dense", "run", "dense"], 16),
    (64, 16, 8192, ["packed"], 8), (64, 16, 8192, ["run"], 8),
    (30, 4, 1001, ["run", "dense", "packed"], 64),
    (7, 1, 64, ["dense", "packed", "run"], 64),
    (300, 1, 256, ["dense", "packed", "run"], 64),
    (2000, 32, 4096, ["packed", "dense"], 256)])
def test_assemble_pages_mixed_tables(cuda, lanes, pl, w, kinds, sparsity):
    """Dense pages between encoded ones; blocks that start inside an
    encoded page (several tiles a page); odd W (the word-loop branch)."""
    pages, host = _page_mix_inputs(lanes, pl, w, kinds, cuda, seed=w,
                                   sparsity=sparsity)
    table = K.page_table(pages, (lanes, w), pl)
    got = K.assemble_pages(pages, (lanes, w), pl, table=table)
    _same(got, K.assemble_pages_plain(pages, (lanes, w), pl))
    assert np.array_equal(got.cpu().numpy().view(np.uint32), host)


def _edge_pages(pl, w, device):
    """Encoded pages whose coordinates and runs fall on tile edges, a run
    page holding every bit, a packed page of sentinels alone and a run
    page of sentinels alone."""
    from pilosa_tpu_torch.ops import bitmap as bm
    total, words = pl * w * 32, pl * w

    def t(a, dtype):
        return torch.from_numpy(np.asarray(a, dtype).view(np.int32)).to(device)

    bits = _TILE * 32
    edge = sorted({0, 1, 31, 32, bits - 1, bits, 2 * bits - 1, 2 * bits,
                   3 * bits, total - 1})
    coords = np.full(16, total, np.uint32)
    coords[:len(edge)] = edge
    packed = bm._Payload("packed", t(coords, np.uint32))
    resid = np.full(4, total, np.uint32)
    resid[:2] = [5, bits + 7]
    starts = np.full(8, words, np.int32)
    starts[:3] = [_TILE - 1, 2 * _TILE, 3 * _TILE + 5]
    lens = np.zeros(8, np.int32)
    lens[:3] = [2, _TILE, _TILE - 5]
    run = bm._Payload("run", t(resid, np.uint32), t(starts, np.int32),
                      t(lens, np.int32))
    every = bm._Payload("run", t([total], np.uint32), t([0], np.int32),
                        t([words], np.int32))
    no_bits = bm._Payload("packed", t([total] * 4, np.uint32))
    no_runs = bm._Payload("run", t([total] * 2, np.uint32),
                          t([words] * 2, np.int32), t([0, 0], np.int32))
    return [packed, run, every, no_bits, no_runs]


def test_assemble_pages_tile_boundaries(cuda):
    """Every kind at tile edges, beside dense pages, the last page
    padded; a packed page holding every bit; one launch a call, and a
    kept table gives the words of a table built in the call."""
    from pilosa_tpu_torch.ops import bitmap as bm
    pl, w = 8, _TILE // 2                 # 4 tiles a page
    dense, _ = _page_mix_inputs(pl, pl, w, ["dense"], cuda, seed=5)
    enc = _edge_pages(pl, w, cuda)
    pages = [enc[0], dense[0], enc[1], enc[2], enc[3], dense[0], enc[4]]
    lanes = len(pages) * pl - 3
    before = K.LAUNCHES["assemble_pages"]
    built = K.assemble_pages(pages, (lanes, w), pl)
    torch.cuda.synchronize()
    assert K.LAUNCHES["assemble_pages"] == before + 1
    _same(built, K.assemble_pages_plain(pages, (lanes, w), pl))
    kept = K.page_table(pages, (lanes, w), pl)
    for _ in range(2):
        _same(K.assemble_pages(pages, (lanes, w), pl, table=kept), built)
    assert K.LAUNCHES["assemble_pages"] == before + 3
    every = torch.arange(4 * 64 * 32, dtype=torch.int32, device=cuda)
    _same(bm.expand_coords(every, 4, 64),
          torch.full((4, 64), -1, dtype=torch.int32, device=cuda))


def test_assemble_pages_dense_view_one_word_in(cuda):
    """A dense page one word into its allocation takes the word loop;
    the output beside it still takes the bulk copies."""
    from pilosa_tpu_torch.memory import encode
    flat = _words((4 * 1024 + 1,), cuda, seed=9)
    view = flat[1:].view(4, 1024)
    blk = np.zeros((4, 1024), np.uint32)
    blk.reshape(-1)[::97] = 0x10001
    pages = [view, encode.encode_block(blk).to_device(cuda), view]
    got = K.assemble_pages(pages, (11, 1024), 4)
    _same(got, K.assemble_pages_plain(pages, (11, 1024), 4))


def test_assemble_pages_refuses_a_bad_table(cuda):
    pages, _ = _page_mix_inputs(8, 4, 8, ["dense"], cuda)
    table = K.page_table(pages, (8, 8), 4)
    with pytest.raises(ValueError):
        K.assemble_pages(pages, (8, 8), 4, table=table[:-1])
    with pytest.raises(ValueError):
        K.assemble_pages(pages, (8, 8), 4, table=table.view(-1, 1))


@pytest.mark.parametrize("n", [1 << 8, 1 << 12, 1 << 16])
def test_expand_coords_on_the_card(cuda, n):
    """One packed 4 MiB page (32 lanes of 32768 words) expanded."""
    from pilosa_tpu_torch.ops import bitmap as bm
    rng = np.random.default_rng(n)
    pos = np.sort(rng.choice(32 * 32768 * 32, size=n, replace=False))
    coords = np.full(1 << (n - 1).bit_length(), 32 * 32768 * 32, np.uint32)
    coords[:n] = pos
    c = torch.from_numpy(coords.view(np.int32)).to(cuda)
    _same(bm.expand_coords(c, 32, 32768),
          bm.expand_coords_plain(c, 32, 32768))


def test_assemble_pages_refuses_a_bad_page(cuda):
    good = torch.zeros((4, 8), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        K.assemble_pages([good, good[:, :4].contiguous()], (8, 8), 4)
    with pytest.raises(ValueError):
        K.assemble_pages([good, good.cpu()], (8, 8), 4)


# -- the ragged program's page-table reads ------------------------------------

def _bucket(n_pages, pl, w, device, seed=0):
    return [_words((pl, w), device, seed=seed + i) for i in range(n_pages)]


@pytest.mark.parametrize("n_pages,pl,w", [
    (1, 4, 8), (3, 5, 201), (30, 32, 32768), (7, 1, 100003), (4, 3, 1)])
def test_concat_gather(cuda, n_pages, pl, w):
    """Identity, reversed, permuted and padded gathers, and a lane on the
    last page, against torch.cat(pages)[lane_idx]."""
    pages = _bucket(n_pages, pl, w, cuda, seed=n_pages)
    n = n_pages * pl
    g = np.random.default_rng(n)
    cases = [np.arange(n), np.arange(n)[::-1], g.permutation(n),
             np.array([n - 1]), np.r_[np.arange(n // 2), [n - 1] * 3]]
    table = K.gather_table(pages)
    for li in cases:
        li = np.ascontiguousarray(li, dtype=np.int32)
        before = K.LAUNCHES["concat_gather"]
        got = K.concat_gather(pages, li)
        torch.cuda.synchronize()
        assert K.LAUNCHES["concat_gather"] == before + 1
        _same(got, K.concat_gather_plain(pages, torch.from_numpy(li).to(cuda)))
        # a kept table and device indices give the same rows
        dev = torch.from_numpy(li).to(cuda)
        _same(K.concat_gather(pages, dev, table=table), got)


def test_concat_gather_refuses_lanes_outside_the_bucket(cuda):
    pages = _bucket(2, 4, 64, cuda)
    for li in ([8], [-1]):
        with pytest.raises(ValueError, match="outside"):
            K.concat_gather(pages, np.array(li, dtype=np.int32))
    with pytest.raises(ValueError, match="shape"):
        K.concat_gather([pages[0], pages[1][:2]], np.zeros(1, np.int32))


@pytest.mark.parametrize("n_pages,pl,w", [
    (60, 32, 32768), (3, 5, 201), (2, 1, 100003)])
def test_segment_count(cuda, n_pages, pl, w):
    """Two segments, ragged segments, repeated lanes, and padded ids at
    and past nseg (dropped), against popcount + index_add_."""
    pages = _bucket(n_pages, pl, w, cuda, seed=7)
    n = n_pages * pl
    g = np.random.default_rng(n)
    half = n // 2
    cases = [
        (np.arange(n), np.repeat([0, 1], [half, n - half]), 2),
        (g.permutation(n), g.integers(0, 4, n), 4),
        # padding: the last lane repeated into the dump segment nseg, and
        # ids past it and below 0
        (np.r_[np.arange(n), [n - 1] * 5],
         np.r_[np.zeros(n, int), [3, 3, 3, 9, -1]], 3)]
    for li, seg, nseg in cases:
        li = np.ascontiguousarray(li, dtype=np.int32)
        seg = np.ascontiguousarray(seg, dtype=np.int32)
        before = K.LAUNCHES["segment_count"]
        got = K.segment_count(pages, li, seg, nseg)
        torch.cuda.synchronize()
        assert K.LAUNCHES["segment_count"] == before + 1
        want = K.segment_count_plain(pages, torch.from_numpy(li).to(cuda),
                                     torch.from_numpy(seg).to(cuda), nseg)
        _same(got, want)
        host = np.concatenate([p.cpu().numpy() for p in pages]).view(np.uint32)
        ref = np.zeros(nseg, np.int64)
        ok = (seg >= 0) & (seg < nseg)
        np.add.at(ref, seg[ok], np.bitwise_count(host[li[ok]]).sum(axis=1))
        assert np.array_equal(got.cpu().numpy(), ref)


def test_segment_count_of_954_full_lanes(cuda):
    """A segment of 954 all-ones lanes of 32768 words (954 * 2^20 bits),
    and one of 2100 (past int32), exact in the int64 output."""
    pages = [torch.full((32, 32768), -1, dtype=torch.int32, device=cuda)
             for _ in range(66)]
    for n in (954, 2100):
        li = np.arange(n, dtype=np.int32)
        got = K.segment_count(pages, li, np.zeros(n, np.int32), 1)
        assert got.cpu().tolist() == [n << 20]


def test_server_on_the_card_answers_over_http(cuda, tmp_path):
    """A port node with no device argument serves from the card: Count,
    TopN and a GroupBy over HTTP equal ``Executor.execute`` on the same
    holder, and a write acknowledged by /index/{i}/ingest is counted by
    the next read."""
    import json
    import urllib.request

    from pilosa_tpu_torch import config
    from pilosa_tpu_torch.api import serialize_result
    from pilosa_tpu_torch.executor.executor import Executor
    from pilosa_tpu_torch.models.holder import Holder
    from pilosa_tpu_torch.server.http import Server

    rng = np.random.default_rng(3)
    w = 1 << 16
    h = Holder(width=w)
    idx = h.create_index("i")
    a, b = idx.create_field("a"), idx.create_field("b")
    cols = np.unique(rng.integers(0, 8 * w, size=20000))
    a.import_bits(rng.integers(0, 4, cols.size), cols)
    b.import_bits(rng.integers(0, 3, cols.size), cols)
    idx.mark_columns_exist(cols)
    srv = Server(holder=h, port=0,
                 config=config.load(None, env={},
                                    overrides={"grpc_port": -1})).start()

    def post(path, body):
        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.port}{path}",
            data=json.dumps(body).encode(), method="POST")
        with urllib.request.urlopen(req, timeout=120) as r:
            return json.loads(r.read())
    try:
        assert srv.api.executor.device.type == "cuda"
        solo = Executor(h, cuda)
        for q in ("Count(Intersect(Row(a=1), Row(b=2)))", "TopN(a, n=3)",
                  "GroupBy(Rows(a), Rows(b))"):
            want = srv.api.query("i", q)["results"]
            assert want == [serialize_result(r) for r in solo.execute("i", q)]
            assert post("/index/i/query", {"query": q})["results"] == want
        n0 = post("/index/i/query", {"query": "Count(Row(a=1))"})["results"][0]
        free = int(np.setdiff1d(np.arange(8 * w), cols)[0])
        got = post("/index/i/ingest", {"writes": [
            {"field": "a", "rows": [1], "columns": [free]}]})
        assert got["landed"] == 1
        assert post("/index/i/query",
                    {"query": "Count(Row(a=1))"})["results"] == [n0 + 1]
    finally:
        srv.close()
        h.close()


def test_cluster_on_the_card_fans_out_and_fails_over(cuda):
    """Two port nodes on the card, replica_n = 2, at width 2^20 over 8
    shards: a fan-out Count, Sum and GroupBy through the coordinator
    equal numpy, each node's own leg launches its kernels, and the
    answers stay exact after one node dies."""
    from pilosa_tpu_torch import config
    from pilosa_tpu_torch.cluster import ClusterNode, InMemDisCo
    from pilosa_tpu_torch.models.holder import Holder

    w, n_shards = 1 << 20, 8
    rng = np.random.default_rng(21)
    cols = np.unique(rng.integers(0, n_shards * w, size=200_000))
    a = rng.integers(0, 4, cols.size)
    b = rng.integers(0, 3, cols.size)
    v = rng.integers(0, 1000, cols.size)
    cfg = config.load(None, env={}, overrides={"grpc_port": -1,
                                               "cluster_hedge_ms": -1.0})
    disco = InMemDisCo(lease_ttl=5.0)
    nodes = [ClusterNode(f"node{i}", disco, holder=Holder(width=w),
                         replica_n=2, heartbeat_interval=0.5,
                         config=cfg).open() for i in range(2)]
    try:
        assert all(nd.api.executor.device.type == "cuda" for nd in nodes)
        nodes[0].apply_schema({"indexes": [{"name": "c", "fields": [
            {"name": "a", "options": {"type": "set"}},
            {"name": "b", "options": {"type": "set"}},
            {"name": "v", "options": {"type": "int", "min": 0,
                                      "max": 1000}}]}]})
        nodes[0].import_bits("c", "a", a.tolist(), cols.tolist())
        nodes[0].import_bits("c", "b", b.tolist(), cols.tolist())
        nodes[0].import_values("c", "v", cols.tolist(), v.tolist())
        want = {
            "Count(Row(a=1))": [int((a == 1).sum())],
            "Sum(Row(b=2), field=v)": [{"value": int(v[b == 2].sum()),
                                        "count": int((b == 2).sum())}],
        }
        gb = sorted((int(x), int(y), int(((a == x) & (b == y)).sum()))
                    for x in range(4) for y in range(3)
                    if ((a == x) & (b == y)).any())
        snap = nodes[0].snapshot()
        groups = snap.shards_by_node("c", range(n_shards))
        assert set(groups) == {"node0", "node1"}
        for nd in nodes:
            K.reset_launches()
            nd.api.query("c", "Count(Row(a=1))", shards=groups[nd.node_id])
            assert sum(K.LAUNCHES.values()) > 0, nd.node_id

        def check():
            for q, r in want.items():
                assert nodes[0].query("c", q)["results"] == r, q
            got = nodes[0].query("c", "GroupBy(Rows(a), Rows(b))")
            assert sorted((g["group"][0]["row_id"], g["group"][1]["row_id"],
                           g["count"]) for g in got["results"][0]) == gb

        K.reset_launches()
        check()
        assert K.LAUNCHES["groupby_fused"] + K.LAUNCHES["groupby_sum"] > 0
        nodes[1].pause()
        check()
        assert {n.id: n.state for n in disco.nodes()}["node1"] == "DOWN"
    finally:
        for nd in nodes:
            try:
                nd.close()
            except Exception:
                pass
        for nd in nodes:
            nd.api.holder.close()
