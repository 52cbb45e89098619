"""The host ingest scatters (``csrc/scatter.cc``) through ctypes.

The port of ``pilosa_tpu/storage/native_ingest.py``.  The columnar
import's hot loops, the bit scatter (``np.bitwise_or.at``) and the BSI
and mutex fills, are word-at-a-time scatters numpy cannot fuse; the C
loops run them in one pass, the fills with last-write-wins built in
(a reverse scan that skips a column already written).  The library is
built by ``storage/_build.py`` with g++ on first use, as RBF is; a
failed build raises with g++'s output.  There is no other path: the
numpy functions ending in ``_plain`` are the plain versions the tests
hold the C loops to, and nothing else calls them.

Callers: ``ops/bitmap.py`` ``or_bits`` (every ``from_columns``), and
the fragment's ``import_values`` (``bsi_fill``) and ``import_mutex``
(``mutex_fill``).  ``groupcode_hist`` and ``groupcode_minmax`` are the
JAX package's host GroupBy arm; the port runs GroupBy on its kernels
(their plain versions on the CPU), so nothing in it calls them.

Every index is checked against its array before a call: the C loops
write where they are told.
"""

from __future__ import annotations

import ctypes as ct
import threading

import numpy as np

_lock = threading.Lock()
_lib = None

_I64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_U32 = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
_MAX_CODE_PLANES = 64
_MAX_DEPTH = 63


def _load():
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            from pilosa_tpu_torch.storage import _build
            lib = _build.library("scatter")
            lib.pt_or_bits.argtypes = [_U32, _I64, ct.c_int64]
            lib.pt_bsi_fill_t.argtypes = [_U32, ct.c_int64, _I64, _I64,
                                          ct.c_int64]
            lib.pt_mutex_fill.argtypes = [_U32, _U32, ct.c_int64, _I64, _I64,
                                          ct.c_int64]
            lib.pt_groupcode_hist.argtypes = [
                _U32, ct.c_int64, _U32, ct.c_void_p, ct.c_int64, ct.c_int64,
                ct.c_int64, ct.c_int64, _I64, _I64, _I64, _I64]
            lib.pt_groupcode_minmax.argtypes = [
                _U32, ct.c_int64, _U32, _U32, ct.c_int64, ct.c_int64,
                ct.c_int64, ct.c_int64, _I64]
            for f in (lib.pt_or_bits, lib.pt_bsi_fill_t, lib.pt_mutex_fill,
                      lib.pt_groupcode_hist, lib.pt_groupcode_minmax):
                f.restype = None
            _lib = lib
    return _lib


def _cols(cols, bits: int, what: str = "column") -> np.ndarray:
    cols = np.ascontiguousarray(cols, dtype=np.int64).reshape(-1)
    if cols.size and (int(cols.min()) < 0 or int(cols.max()) >= bits):
        raise ValueError(f"{what} id outside [0, {bits})")
    return cols


def _words(a: np.ndarray, name: str) -> None:
    if (not isinstance(a, np.ndarray) or a.dtype != np.uint32
            or not a.flags.c_contiguous):
        raise TypeError(f"{name} must be a C-contiguous uint32 array")


def _inout(a: np.ndarray, shape: tuple, name: str) -> None:
    if (not isinstance(a, np.ndarray) or a.dtype != np.int64
            or not a.flags.c_contiguous or a.shape != shape):
        raise TypeError(f"{name} must be a C-contiguous int64 array of "
                        f"shape {shape}")


def or_bits(words: np.ndarray, cols) -> None:
    """words[c >> 5] |= 1 << (c & 31) for every column c, in place."""
    _words(words, "words")
    cols = _cols(cols, words.size * 32)
    _load().pt_or_bits(words, cols, cols.size)


def bsi_fill(scratch: np.ndarray, cols, vals, depth: int) -> None:
    """Fill a zeroed (2+depth, plane_words) scratch: plane 0 exists,
    1 sign, 2+i magnitude bit i; the last write of a column wins.
    Magnitude bits at or past ``depth`` are dropped (the caller refuses
    such values first)."""
    _words(scratch, "scratch")
    n_planes, plane_words = scratch.shape
    if n_planes != 2 + depth:
        raise ValueError(f"scratch has {n_planes} planes, not {2 + depth}")
    cols = _cols(cols, plane_words * 32)
    vals = np.ascontiguousarray(vals, dtype=np.int64).reshape(-1)
    if vals.shape != cols.shape:
        raise ValueError("cols and vals differ in length")
    # interleaved fill (one cache line a value), then one transpose back
    # to plane-major
    scratch_t = np.zeros((plane_words, n_planes), np.uint32)
    _load().pt_bsi_fill_t(scratch_t, n_planes, cols, vals, cols.size)
    scratch[:] = scratch_t.T


def mutex_fill(written: np.ndarray, scratch: np.ndarray, rowidx,
               cols) -> None:
    """Fill a zeroed (n_rows, plane_words) scratch with one bit a (dense
    row index, column), the last write of a column winning; ``written``
    collects every column written (the clear-then-set mask)."""
    _words(written, "written")
    _words(scratch, "scratch")
    n_rows, plane_words = scratch.shape
    if written.size != plane_words:
        raise ValueError("written and scratch differ in width")
    cols = _cols(cols, plane_words * 32)
    rowidx = _cols(rowidx, n_rows, "row index")
    if rowidx.shape != cols.shape:
        raise ValueError("rowidx and cols differ in length")
    _load().pt_mutex_fill(written, scratch.reshape(-1), plane_words, rowidx,
                          cols, cols.size)


def _hist_args(code_planes, valid, bsi):
    code_planes = np.ascontiguousarray(code_planes, dtype=np.uint32)
    valid = np.ascontiguousarray(valid, dtype=np.uint32)
    w = valid.shape[0]
    if code_planes.ndim != 2 or code_planes.shape[1] != w \
            or code_planes.shape[0] > _MAX_CODE_PLANES:
        raise ValueError(f"code planes {code_planes.shape} for width {w}")
    if bsi is not None:
        bsi = np.ascontiguousarray(bsi, dtype=np.uint32)
        if bsi.ndim != 2 or bsi.shape[1] != w or not \
                3 <= bsi.shape[0] <= 2 + _MAX_DEPTH:
            raise ValueError(f"BSI planes {bsi.shape} for width {w}")
    return code_planes, valid, bsi, w


def groupcode_hist(code_planes, valid, bsi, n_codes: int, signed: bool,
                   counts: np.ndarray, nn: np.ndarray, pos: np.ndarray,
                   neg: np.ndarray) -> None:
    """One shard of the one-pass GroupBy histogram: accumulate counts
    (n_codes,), nn (n_codes,) and the sign-split per-plane partials pos
    and neg (n_codes, depth), int64, in place.  code_planes (CB, W)
    packed group-code bit-planes, valid (W,), bsi (2+depth, W) or None
    (then nn, pos and neg are left as they are)."""
    code_planes, valid, bsi, w = _hist_args(code_planes, valid, bsi)
    depth = 0 if bsi is None else bsi.shape[0] - 2
    _inout(counts, (n_codes,), "counts")
    _inout(nn, (n_codes,) if bsi is not None else nn.shape, "nn")
    _inout(pos, (n_codes, depth) if bsi is not None else pos.shape, "pos")
    _inout(neg, (n_codes, depth) if bsi is not None else neg.shape, "neg")
    _load().pt_groupcode_hist(
        code_planes, code_planes.shape[0], valid,
        None if bsi is None else bsi.ctypes.data, depth, int(bool(signed)),
        w, int(n_codes), counts, nn, pos, neg)


def groupcode_minmax(code_planes, valid, bsi, n_codes: int, signed: bool,
                     mm: np.ndarray) -> None:
    """One shard of the per-group Min/Max magnitude table: update mm
    (4, n_codes) int64 rows [max_mag_pos, min_mag_pos, max_mag_neg,
    min_mag_neg] in place; the caller fills the identities (-1, and
    1 << depth) first."""
    code_planes, valid, bsi, w = _hist_args(code_planes, valid, bsi)
    if bsi is None:
        raise ValueError("groupcode_minmax needs BSI planes")
    _inout(mm, (4, n_codes), "mm")
    _load().pt_groupcode_minmax(
        code_planes, code_planes.shape[0], valid, bsi, bsi.shape[0] - 2,
        int(bool(signed)), w, int(n_codes), mm)


# ---------------------------------------------------------------------------
# plain versions (numpy): what the tests hold the C loops to
# ---------------------------------------------------------------------------

def _bits(words) -> np.ndarray:
    return np.unpackbits(np.ascontiguousarray(words, dtype=np.uint32)
                         .view(np.uint8), bitorder="little").astype(bool)


def _codes(code_planes) -> np.ndarray:
    code = np.zeros(code_planes.shape[1] * 32, dtype=np.int64)
    for b in range(code_planes.shape[0]):
        code |= _bits(code_planes[b]).astype(np.int64) << b
    return code


def _last_writes(cols, *others):
    """The last entry of each column (and the same entries of others)."""
    cols = np.asarray(cols, dtype=np.int64)
    if cols.size > 1:
        _, rev_first = np.unique(cols[::-1], return_index=True)
        keep = cols.size - 1 - rev_first
        return (cols[keep],) + tuple(np.asarray(o)[keep] for o in others)
    return (cols,) + tuple(np.asarray(o) for o in others)


def or_bits_plain(words: np.ndarray, cols) -> None:
    cols = np.asarray(cols, dtype=np.int64)
    np.bitwise_or.at(words, cols >> 5,
                     np.uint32(1) << (cols & 31).astype(np.uint32))


def bsi_fill_plain(scratch: np.ndarray, cols, vals, depth: int) -> None:
    cols, vals = _last_writes(cols, np.asarray(vals, dtype=np.int64))
    neg = vals < 0
    mags = np.where(neg, np.negative(vals), vals).view(np.uint64)
    or_bits_plain(scratch[0], cols)
    or_bits_plain(scratch[1], cols[neg])
    for i in range(depth):
        or_bits_plain(scratch[2 + i],
                      cols[(mags >> np.uint64(i)) & np.uint64(1) == 1])


def mutex_fill_plain(written: np.ndarray, scratch: np.ndarray, rowidx,
                     cols) -> None:
    cols, rowidx = _last_writes(cols, np.asarray(rowidx, dtype=np.int64))
    or_bits_plain(written, cols)
    for r in np.unique(rowidx):
        or_bits_plain(scratch[int(r)], cols[rowidx == r])


def groupcode_hist_plain(code_planes, valid, bsi, n_codes: int,
                         signed: bool, counts, nn, pos, neg) -> None:
    code = _codes(np.asarray(code_planes, dtype=np.uint32))
    va = _bits(valid)
    inb = code < n_codes
    counts += np.bincount(code[va & inb], minlength=n_codes)[:n_codes]
    if bsi is None:
        return
    ex = _bits(bsi[0]) & va & inb
    sg = _bits(bsi[1])
    nn += np.bincount(code[ex], minlength=n_codes)[:n_codes]
    posm = ex & ~sg if signed else ex
    negm = ex & sg
    for p in range(bsi.shape[0] - 2):
        mb = _bits(bsi[2 + p])
        pos[:, p] += np.bincount(code[mb & posm], minlength=n_codes)[:n_codes]
        if signed:
            neg[:, p] += np.bincount(code[mb & negm],
                                     minlength=n_codes)[:n_codes]


def groupcode_minmax_plain(code_planes, valid, bsi, n_codes: int,
                           signed: bool, mm) -> None:
    code = _codes(np.asarray(code_planes, dtype=np.uint32))
    ex = _bits(bsi[0]) & _bits(valid)
    sg = _bits(bsi[1])
    mag = np.zeros(code.shape, np.int64)
    for p in range(bsi.shape[0] - 2):
        mag |= _bits(bsi[2 + p]).astype(np.int64) << p
    posm = ex & ~sg if signed else ex
    negm = ex & sg if signed else np.zeros_like(ex)
    inb = code < n_codes
    for row, op, mask in ((0, np.maximum, posm), (1, np.minimum, posm),
                          (2, np.maximum, negm), (3, np.minimum, negm)):
        sel = mask & inb
        if sel.any():
            op.at(mm[row], code[sel], mag[sel])
