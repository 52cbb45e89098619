"""Bit-sliced integer (BSI) operations.

Encoding matches the reference (fragment.go:34-66, 579-718): an
integer field's shard is a stack of packed bit-planes —

- plane 0: exists (not-null) bit
- plane 1: sign bit (set ⇒ negative)
- plane 2+i: magnitude bit i, LSB first

i.e. sign-magnitude.  Device ``planes`` are ``torch.int32`` tensors of
shape ``(..., 2 + depth, W)``: one shard ``(P, W)`` or a shard stack
``(S, P, W)``; every op indexes the plane axis from the end, so both
forms work without a batch transform.

Range predicates are fixed-shape bit-serial comparator chains: one pass
over the magnitude planes yields per-column LT/EQ masks against a
predicate given as per-plane broadcast masks (``predicate_masks``).
The predicate's sign is a Python bool, so the sign regime is chosen by
a Python branch.  Here they are eager torch, the plain version of the
``kernels.bsi_range`` kernel that both engines call.  Sum returns
per-plane popcounts that the host combines as exact Python ints
(``host_sum``).
"""

from __future__ import annotations

import numpy as np
import torch

from pilosa_tpu_torch.ops import bitmap as bm
from pilosa_tpu_torch.shardwidth import (
    BSI_EXISTS_BIT,
    BSI_OFFSET_BIT,
    BSI_SIGN_BIT,
    SHARD_WIDTH,
)

_ONES = np.uint32(0xFFFFFFFF)


# ---------------------------------------------------------------------------
# Host-side encode/decode + predicate prep (numpy / exact Python ints)
# ---------------------------------------------------------------------------

def depth_for_range(lo: int, hi: int) -> int:
    """Bit depth needed to store magnitudes in [lo, hi] (>= 1)."""
    m = max(abs(int(lo)), abs(int(hi)), 1)
    return max(1, m.bit_length())


def encode(columns, values, depth: int | None = None,
           width: int = SHARD_WIDTH) -> np.ndarray:
    """Pack (column, value) pairs into (2+depth, W) uint32 planes.

    fragment.setValueBase semantics: exists bit set, sign bit iff
    value < 0, magnitude bits of abs(value) LSB-first; the last write
    of a duplicated column wins."""
    columns = np.asarray(columns, dtype=np.int64)
    vals = np.asarray(values, dtype=np.int64).reshape(-1)
    if vals.shape != columns.shape:
        raise ValueError("columns and values differ in length")
    if columns.size:
        _, rev_first = np.unique(columns[::-1], return_index=True)
        keep = columns.size - 1 - rev_first
        columns, vals = columns[keep], vals[keep]
    neg = vals < 0
    # uint64 view so INT64_MIN's magnitude (2^63) is representable
    mags = np.where(neg, np.negative(vals), vals).view(np.uint64)
    need = depth_for_range(0, int(mags.max())) if vals.size else 1
    if depth is None:
        depth = need
    elif need > depth:
        raise ValueError(
            f"value magnitude needs {need} bits, field depth is {depth}")
    planes = np.zeros((2 + depth, width // 32), dtype=np.uint32)
    planes[BSI_EXISTS_BIT] = bm.from_columns(columns, width)
    planes[BSI_SIGN_BIT] = bm.from_columns(columns[neg], width)
    for i in range(depth):
        planes[BSI_OFFSET_BIT + i] = bm.from_columns(
            columns[(mags >> np.uint64(i)) & np.uint64(1) == 1], width)
    return planes


def decode(planes) -> tuple[np.ndarray, list[int]]:
    """Inverse of encode: (2+depth, W) uint32 → (columns, values) with
    exact Python ints."""
    planes = np.asarray(planes, dtype=np.uint32)
    depth = planes.shape[0] - 2
    cols = bm.to_columns(planes[BSI_EXISTS_BIT])
    if cols.size == 0:
        return cols, []
    w = (cols >> np.uint64(5)).astype(np.int64)
    b = (cols & np.uint64(31)).astype(np.uint32)

    def bits(plane):
        return ((plane[w] >> b) & 1).astype(np.int64)

    sign = bits(planes[BSI_SIGN_BIT]).astype(bool)
    if depth <= 62:
        mags = np.zeros(cols.size, dtype=np.int64)
        for i in range(depth):
            mags |= bits(planes[BSI_OFFSET_BIT + i]) << np.int64(i)
        return cols, np.where(sign, -mags, mags).tolist()
    mags = np.zeros(cols.size, dtype=object)
    for i in range(depth):
        mags += bits(planes[BSI_OFFSET_BIT + i]).astype(object) << i
    return cols, [-m if s else m for m, s in zip(mags.tolist(), sign)]


def predicate_masks(upredicate: int, depth: int) -> np.ndarray:
    """Per-plane broadcast masks for an unsigned predicate: mask[i] is
    0xFFFFFFFF iff bit i of upredicate is set.  The executor clamps
    out-of-range predicates before it gets here."""
    if not 0 <= upredicate < (1 << depth):
        raise ValueError(f"predicate {upredicate} outside depth {depth}")
    return np.array([_ONES if (upredicate >> i) & 1 else np.uint32(0)
                     for i in range(depth)], dtype=np.uint32)


# ---------------------------------------------------------------------------
# Device-side ops (torch.int32, planes (..., P, W))
# ---------------------------------------------------------------------------

def _exists(planes):
    return planes[..., BSI_EXISTS_BIT, :]


def _sign(planes):
    return planes[..., BSI_SIGN_BIT, :]


def _mag(planes):
    return planes[..., BSI_OFFSET_BIT:, :]


def cmp_unsigned(mag_planes: torch.Tensor, pbits):
    """Bit-serial compare of per-column magnitudes with a predicate.

    mag_planes: (..., depth, W), LSB-first.  pbits: (depth,) uint32
    masks from predicate_masks().  Returns packed (lt, eq): magnitude
    <, == predicate — the reference's rangeLTUnsigned / rangeEQ walks
    (fragment.go:968-1213) as depth steps of four bitwise ops."""
    depth = mag_planes.shape[-2]
    pbits = np.asarray(pbits, dtype=np.uint32).view(np.int32)
    lt = torch.zeros_like(mag_planes[..., 0, :])
    eq = torch.full_like(mag_planes[..., 0, :], -1)
    for i in range(depth - 1, -1, -1):
        m = mag_planes[..., i, :]
        p = int(pbits[i])  # 0 or -1: a scalar word mask
        lt = lt | (eq & ~m & p)
        eq = eq & ~(m ^ p)
    return lt, eq


def range_eq(planes, pbits, pred_is_neg: bool):
    """Columns whose value == predicate (fragment.rangeEQ)."""
    exists, sign = _exists(planes), _sign(planes)
    _, eq = cmp_unsigned(_mag(planes), pbits)
    sign_sel = exists & sign if pred_is_neg else exists & ~sign
    return sign_sel & eq


def range_neq(planes, pbits, pred_is_neg: bool):
    """exists AND NOT eq (fragment.rangeNEQ)."""
    return _exists(planes) & ~range_eq(planes, pbits, pred_is_neg)


def _lt_gt(planes, pbits, allow_eq: bool):
    lt, eq = cmp_unsigned(_mag(planes), pbits)
    if allow_eq:
        return lt | eq, ~lt
    return lt, ~(lt | eq)


def range_lt(planes, pbits, pred_is_neg: bool, allow_eq: bool):
    """Columns with value < (or <=) predicate (fragment.rangeLT):
      p >= 0: negatives ∪ (positives with mag <(=) p)
      p <  0: negatives with mag >(=) |p|"""
    exists, sign = _exists(planes), _sign(planes)
    ltu, gtu = _lt_gt(planes, pbits, allow_eq)
    if pred_is_neg:
        return exists & sign & gtu
    return (exists & sign) | (exists & ~sign & ltu)


def range_gt(planes, pbits, pred_is_neg: bool, allow_eq: bool):
    """Columns with value > (or >=) predicate (fragment.rangeGT):
      p >= 0: positives with mag >(=) p
      p <  0: positives ∪ (negatives with mag <(=) |p|)"""
    exists, sign = _exists(planes), _sign(planes)
    ltu, gtu = _lt_gt(planes, pbits, allow_eq)
    if pred_is_neg:
        return (exists & ~sign) | (exists & sign & ltu)
    return exists & ~sign & gtu


def range_between(planes, abits, bbits, a_is_neg: bool, b_is_neg: bool):
    """Columns with a <= value <= b (fragment.rangeBetween); abits and
    bbits are magnitude masks of |a| and |b|.  Regimes:
      0 <= a <= b : positives with a <= mag <= b
      a <= b < 0  : negatives with |b| <= mag <= |a|
      a < 0 <= b  : (negatives with mag <= |a|) ∪ (positives, mag <= b)
      a >= 0 > b  : inverted range — empty"""
    exists, sign = _exists(planes), _sign(planes)
    if not a_is_neg and b_is_neg:
        return torch.zeros_like(exists)
    lt_a, eq_a = cmp_unsigned(_mag(planes), abits)
    lt_b, eq_b = cmp_unsigned(_mag(planes), bbits)
    lte_a, lte_b = lt_a | eq_a, lt_b | eq_b
    if not a_is_neg:
        return exists & ~sign & ~lt_a & lte_b
    if b_is_neg:
        return exists & sign & ~lt_b & lte_a
    return (exists & sign & lte_a) | (exists & ~sign & lte_b)


def not_null(planes):
    """The exists row (fragment.notNull)."""
    return _exists(planes)


def sum_counts(planes, filter_words=None):
    """Per-plane popcounts for an exact host-side Sum.

    Returns (count, pos_pc, neg_pc) as int32: the count of non-null
    (filtered) columns, and per-magnitude-plane popcounts split by
    sign, shape (..., depth).  The plain version of
    kernels.bsi_sum_counts (fragment.sum, fragment.go:718-746)."""
    exists, sign = _exists(planes), _sign(planes)
    consider = exists if filter_words is None else exists & filter_words
    pos = consider & ~sign
    neg = consider & sign
    mag = _mag(planes)
    return (bm.count(consider), bm.count(mag & pos.unsqueeze(-2)),
            bm.count(mag & neg.unsqueeze(-2)))


def host_sum(count, pos_pc, neg_pc) -> tuple[int, int]:
    """Combine sum_counts() outputs of one shard, or per-plane totals,
    into exact (sum, count) Python ints."""
    pos_pc = np.asarray(pos_pc, dtype=np.int64).tolist()
    neg_pc = np.asarray(neg_pc, dtype=np.int64).tolist()
    total = sum((p - n) << i for i, (p, n) in enumerate(zip(pos_pc, neg_pc)))
    return int(total), int(np.asarray(count, dtype=np.int64).sum())


# ---------------------------------------------------------------------------
# Min/Max plane walks (fragment.go:745-857), branch-free
# ---------------------------------------------------------------------------
#
# Every step keeps its decision on the device (torch.where on the
# any-set flag), so a walk of d planes queues its work without a host
# sync; the caller fetches all shards' results at once.  The walks take
# (..., d, W) planes and (..., W) filters, one shard or a stack.

def _walk_count(filt: torch.Tensor) -> torch.Tensor:
    """Per-row popcount of the walk's surviving columns, through the
    popcount_rows kernel (its plain version on a CPU tensor)."""
    from pilosa_tpu_torch.ops import kernels
    w = filt.shape[-1]
    return kernels.popcount_rows(
        filt.reshape(-1, w).contiguous()).reshape(filt.shape[:-1])


def _max_unsigned_walk(mag_planes, filter_words):
    """fragment.maxUnsigned (fragment.go:836-857): MSB first, keep the
    columns with a one bit wherever any survive.  Returns (bits (..., d)
    bool LSB-first, count int32 of the columns attaining the max)."""
    depth = mag_planes.shape[-2]
    filt = filter_words
    bits = []
    for i in range(depth - 1, -1, -1):
        ones = filt & mag_planes[..., i, :]
        took = bm.any_set(ones)
        filt = torch.where(took.unsqueeze(-1), ones, filt)
        bits.append(took)
    return torch.stack(bits[::-1], dim=-1), _walk_count(filt)


def _min_unsigned_walk(mag_planes, filter_words):
    """fragment.minUnsigned (fragment.go:783-803): prefer zero bits; a
    bit is forced to one when no zero survives."""
    depth = mag_planes.shape[-2]
    filt = filter_words
    bits = []
    for i in range(depth - 1, -1, -1):
        zeroes = filt & ~mag_planes[..., i, :]
        nonempty = bm.any_set(zeroes)
        filt = torch.where(nonempty.unsqueeze(-1), zeroes, filt)
        bits.append(~nonempty)
    return torch.stack(bits[::-1], dim=-1), _walk_count(filt)


def min_op(planes, filter_words=None):
    """fragment.min (fragment.go:745-781): -(max unsigned over the
    negatives) when any negative is in scope, else the min unsigned over
    the non-negatives.  Returns device (is_neg, bits (..., d), count,
    nonempty); host_minmax assembles the value."""
    exists, sign = _exists(planes), _sign(planes)
    consider = exists if filter_words is None else exists & filter_words
    negs = consider & sign
    pos = consider & ~sign
    any_neg = bm.any_set(negs)
    nb, ncount = _max_unsigned_walk(_mag(planes), negs)
    pb, pcount = _min_unsigned_walk(_mag(planes), pos)
    bits = torch.where(any_neg.unsqueeze(-1), nb, pb)
    count = torch.where(any_neg, ncount, pcount)
    return any_neg, bits, count, bm.any_set(consider)


def max_op(planes, filter_words=None):
    """fragment.max (fragment.go:805-834): non-negatives preferred, else
    -(min unsigned over the negatives)."""
    exists, sign = _exists(planes), _sign(planes)
    consider = exists if filter_words is None else exists & filter_words
    pos = consider & ~sign
    negs = consider & sign
    any_pos = bm.any_set(pos)
    pb, pcount = _max_unsigned_walk(_mag(planes), pos)
    nb, ncount = _min_unsigned_walk(_mag(planes), negs)
    bits = torch.where(any_pos.unsqueeze(-1), pb, nb)
    count = torch.where(any_pos, pcount, ncount)
    return ~any_pos, bits, count, bm.any_set(consider)


def host_minmax(is_neg, bits, count, nonempty) -> tuple[int, int]:
    """(value, count) in exact ints from one shard's min_op/max_op
    outputs (host values); (0, 0) on an empty scope, as the reference."""
    if not bool(np.asarray(nonempty)):
        return 0, 0
    mag = sum(1 << i for i, b in enumerate(np.asarray(bits).tolist()) if b)
    val = -mag if bool(np.asarray(is_neg)) else mag
    return int(val), int(np.asarray(count))


# ---------------------------------------------------------------------------
# Per-column decode (the decode stream and the host loops)
# ---------------------------------------------------------------------------

def unpack_bits_np(words) -> np.ndarray:
    """Host bit-unpack: (..., W) uint32 words → (..., W*32) bool per
    column (column c = word c >> 5, bit c & 31)."""
    words = np.ascontiguousarray(words, dtype=np.uint32)
    return np.unpackbits(words.view(np.uint8), axis=-1,
                         bitorder="little").view(bool)


def decode_device(planes: torch.Tensor):
    """Device decode of every column: planes (..., 2+d, W) →
    (exists (..., W*32) bool, values (..., W*32) int64, 0 where no value
    exists).  Values are built in int64 directly: magnitude bits 0..62
    fit, so d <= 63."""
    depth = planes.shape[-2] - 2
    if depth > 63:
        raise ValueError(f"decode_device: depth {depth} > 63")
    exists = bm.unpack_bits(planes[..., BSI_EXISTS_BIT, :]) == 1
    sign = bm.unpack_bits(planes[..., BSI_SIGN_BIT, :]) == 1
    mag = torch.zeros(exists.shape, dtype=torch.int64, device=planes.device)
    for i in range(depth):
        mag |= bm.unpack_bits(planes[..., BSI_OFFSET_BIT + i, :]).to(
            torch.int64) << i
    vals = torch.where(sign, -mag, mag)
    return exists, torch.where(exists, vals, 0)


def decode_np(planes: np.ndarray):
    """Host twin of decode_device for one fragment's (2+d, W) uint32
    planes: (exists (W*32,) bool, values (W*32,) int64), d <= 63."""
    planes = np.asarray(planes, dtype=np.uint32)
    depth = planes.shape[0] - 2
    if depth > 63:
        raise ValueError(f"decode_np: depth {depth} > 63")
    exists = unpack_bits_np(planes[BSI_EXISTS_BIT])
    sign = unpack_bits_np(planes[BSI_SIGN_BIT])
    mag = np.zeros(exists.shape, dtype=np.int64)
    for i in range(depth):
        # a deep field's high planes are often empty
        if planes[BSI_OFFSET_BIT + i].any():
            mag |= unpack_bits_np(planes[BSI_OFFSET_BIT + i]).astype(
                np.int64) << np.int64(i)
    return exists, np.where(exists, np.where(sign, -mag, mag), 0)
