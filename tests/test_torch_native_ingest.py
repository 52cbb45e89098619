"""The port's host ingest scatters (pilosa_tpu_torch/storage/csrc/
scatter.cc through storage/native_ingest.py) against the JAX package's
``native_ingest`` and the port's own numpy plain versions, on seeded
inputs with the edge cases: no input, repeated columns (the last write
wins), the first and last word of a plane, negative and zero values,
and codes past the code space.  Exact (integer words and counts)."""

import numpy as np
import pytest

from pilosa_tpu.ops import bitmap as jbm
from pilosa_tpu.storage import native_ingest as jni
from pilosa_tpu_torch.models.holder import Holder
from pilosa_tpu_torch.models.schema import FieldOptions, FieldType
from pilosa_tpu_torch.ops import bitmap as bm
from pilosa_tpu_torch.storage import _build
from pilosa_tpu_torch.storage import native_ingest as ni

W = 2048
WORDS = W // 32


def _cols(rng, case: str, n: int) -> np.ndarray:
    if case == "empty":
        return np.zeros(0, np.int64)
    if case == "repeated":
        return rng.integers(0, 40, size=n).astype(np.int64)
    if case == "edges":
        return np.concatenate([[0, 31, 32, W - 32, W - 1, W - 1, 0],
                               rng.integers(0, W, size=n)]).astype(np.int64)
    return rng.integers(0, W, size=n).astype(np.int64)


CASES = ["empty", "repeated", "edges", "random"]


@pytest.mark.parametrize("case", CASES)
def test_or_bits(case):
    rng = np.random.default_rng(1)
    cols = _cols(rng, case, 500)
    got = np.zeros(WORDS, np.uint32)
    ni.or_bits(got, cols)
    want = np.zeros(WORDS, np.uint32)
    jni.or_bits(want, cols)
    plain = np.zeros(WORDS, np.uint32)
    ni.or_bits_plain(plain, cols)
    assert np.array_equal(got, want) and np.array_equal(got, plain)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("depth", [1, 7, 20, 63])
def test_bsi_fill(case, depth):
    rng = np.random.default_rng(depth)
    cols = _cols(rng, case, 400)
    hi = (1 << depth) - 1
    vals = rng.integers(-hi, hi, size=cols.size, endpoint=True)
    if cols.size > 3:
        vals[:3] = [0, hi, -hi]
    got = np.zeros((2 + depth, WORDS), np.uint32)
    ni.bsi_fill(got, cols, vals, depth)
    want = np.zeros((2 + depth, WORDS), np.uint32)
    jni.bsi_fill(want, cols, vals, depth)
    plain = np.zeros((2 + depth, WORDS), np.uint32)
    ni.bsi_fill_plain(plain, cols, vals, depth)
    assert np.array_equal(got, want) and np.array_equal(got, plain)


@pytest.mark.parametrize("case", CASES)
def test_mutex_fill(case):
    rng = np.random.default_rng(3)
    cols = _cols(rng, case, 600)
    rowidx = rng.integers(0, 5, size=cols.size).astype(np.int64)
    out = []
    for fill in (ni.mutex_fill, jni.mutex_fill, ni.mutex_fill_plain):
        written = np.zeros(WORDS, np.uint32)
        scratch = np.zeros((5, WORDS), np.uint32)
        fill(written, scratch, rowidx, cols)
        out.append((written, scratch))
    for written, scratch in out[1:]:
        assert np.array_equal(written, out[0][0])
        assert np.array_equal(scratch, out[0][1])


def _groupcode_inputs(seed: int, cb: int, depth: int, empty: bool):
    rng = np.random.default_rng(seed)
    code_planes = rng.integers(0, 2**32, size=(cb, WORDS), dtype=np.uint32)
    valid = (np.zeros(WORDS, np.uint32) if empty else
             rng.integers(0, 2**32, size=WORDS, dtype=np.uint32))
    bsi = rng.integers(0, 2**32, size=(2 + depth, WORDS), dtype=np.uint32)
    return code_planes, valid, bsi


@pytest.mark.parametrize("signed", [False, True])
@pytest.mark.parametrize("planes", [False, True])
@pytest.mark.parametrize("shape", [(3, 7, 6), (4, 12, 16), (1, 1, 2)],
                         ids=["7codes", "12codes", "2codes"])
@pytest.mark.parametrize("empty", [False, True], ids=["some", "none_valid"])
def test_groupcode_hist(signed, planes, shape, empty):
    cb, depth, n_codes = shape
    code_planes, valid, bsi = _groupcode_inputs(cb * 7 + depth, cb, depth,
                                                empty)
    bsi = bsi if planes else None
    d = depth if planes else 0
    out = []
    for hist in (ni.groupcode_hist, jni.groupcode_hist,
                 ni.groupcode_hist_plain):
        acc = (np.zeros(n_codes, np.int64), np.zeros(n_codes, np.int64),
               np.zeros((n_codes, d), np.int64),
               np.zeros((n_codes, d), np.int64))
        hist(code_planes, valid, bsi, n_codes, signed, *acc)
        out.append(acc)
    for acc in out[1:]:
        for a, b in zip(acc, out[0]):
            assert np.array_equal(a, b)
    if not empty:
        assert out[0][0].sum() > 0


@pytest.mark.parametrize("signed", [False, True])
@pytest.mark.parametrize("shape", [(3, 7, 6), (4, 12, 16), (2, 30, 3)],
                         ids=["7codes", "12codes", "depth30"])
@pytest.mark.parametrize("empty", [False, True], ids=["some", "none_valid"])
def test_groupcode_minmax(signed, shape, empty):
    cb, depth, n_codes = shape
    code_planes, valid, bsi = _groupcode_inputs(cb * 5 + depth, cb, depth,
                                                empty)
    out = []
    for fn in (ni.groupcode_minmax, jni.groupcode_minmax,
               ni.groupcode_minmax_plain):
        mm = np.array([[-1], [1 << depth], [-1], [1 << depth]],
                      np.int64).repeat(n_codes, axis=1)
        fn(code_planes, valid, bsi, n_codes, signed, mm)
        out.append(mm)
    assert np.array_equal(out[0], out[1])
    assert np.array_equal(out[0], out[2])


def test_bad_indices_raise_before_the_call():
    words = np.zeros(WORDS, np.uint32)
    with pytest.raises(ValueError):
        ni.or_bits(words, [W])
    with pytest.raises(ValueError):
        ni.or_bits(words, [-1])
    with pytest.raises(ValueError):
        ni.mutex_fill(words, np.zeros((2, WORDS), np.uint32), [2], [5])
    with pytest.raises(ValueError):
        ni.bsi_fill(np.zeros((4, WORDS), np.uint32), [1], [1], 3)
    assert not words.any()


def test_failed_build_raises_with_gxx_output(monkeypatch, tmp_path):
    """A g++ that fails raises with its output (no quiet numpy path)."""
    monkeypatch.setattr(_build, "_ROOT", tmp_path)
    monkeypatch.setattr(_build, "GXX_FLAGS",
                        _build.GXX_FLAGS + ("-fno-such-option-anywhere",))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed building "
                                           "libscatter.so"):
        _build.build("scatter")


def test_fragment_imports_go_through_the_fills(monkeypatch):
    """import_values, import_mutex and from_columns call the C fills,
    and the written rows equal what the plain versions give."""
    calls = []
    for name in ("bsi_fill", "mutex_fill", "or_bits"):
        real = getattr(ni, name)

        def wrap(*a, _real=real, _name=name, **kw):
            calls.append(_name)
            return _real(*a, **kw)
        monkeypatch.setattr(ni, name, wrap)
    rng = np.random.default_rng(9)
    h = Holder(width=W)
    idx = h.create_index("i")
    v = idx.create_field("v", FieldOptions(type=FieldType.INT, min=-500,
                                           max=500))
    m = idx.create_field("m", FieldOptions(type=FieldType.MUTEX))
    cols = rng.integers(0, W, size=300)
    vals = rng.integers(-500, 501, size=300)
    v.import_values(cols, vals)
    rows = rng.integers(0, 4, size=300)
    m.import_bits(rows, cols)
    packed = bm.from_columns(cols, W)
    assert {"bsi_fill", "mutex_fill", "or_bits"} <= set(calls)
    assert np.array_equal(packed, jbm.from_columns(cols, W))
    depth = v.bit_depth
    planes = np.zeros((2 + depth, WORDS), np.uint32)
    ni.bsi_fill_plain(planes, cols, vals, depth)
    frag = v.views[v.bsi_view].fragment(0)
    for r in range(2 + depth):
        assert np.array_equal(frag.row_words(r), planes[r])
    last = {int(c): int(r) for c, r in zip(cols, rows)}
    mf = m.views["standard"].fragment(0)
    for r in range(4):
        want = sorted(c for c, rr in last.items() if rr == r)
        got = np.flatnonzero(np.unpackbits(
            mf.row_words(r).view(np.uint8), bitorder="little")).tolist()
        assert got == want
