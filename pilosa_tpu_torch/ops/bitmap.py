"""Dense packed-bitmap operations.

A shard-row is one bit per column, packed LSB-first into 32-bit words:
column ``c`` lives at word ``c >> 5``, bit ``c & 31``.  A full
2^20-column shard-row is 32768 words (128 KiB).

Host side the words are ``numpy.uint32``; device side they are
``torch.int32`` tensors carrying the same bits (torch has no logical
right shift on uint32 and no popcount op).  ``to_tensor`` and
``to_numpy`` cross the boundary without copying the bits' meaning:
``.view(np.int32)`` one way, ``.view(np.uint32)`` the other.  Every
right shift on int32 is arithmetic, so each one here is masked after
the shift.  All device ops act on the last (word) axis and broadcast
over leading axes (rows, shards).

Reference semantics covered (behaviour, not code): pairwise set ops
(roaring/roaring.go:927-1663), Count (roaring.go:542), CountRange
(roaring.go:573), Shift (executor.go Shift).
"""

from __future__ import annotations

import numpy as np
import torch

from pilosa_tpu_torch.shardwidth import BITS_PER_WORD, SHARD_WIDTH

# ---------------------------------------------------------------------------
# Host-side packing helpers (numpy uint32)
# ---------------------------------------------------------------------------


def empty(width: int = SHARD_WIDTH) -> np.ndarray:
    """An all-zeros packed shard-row of `width` bits (width % 32 == 0)."""
    if width % BITS_PER_WORD:
        raise ValueError(f"width {width} is not a multiple of 32")
    return np.zeros(width // BITS_PER_WORD, dtype=np.uint32)


def or_bits(words: np.ndarray, cols) -> None:
    """words[c >> 5] |= 1 << (c & 31) for every column c, in place: the
    host scatter of storage/csrc/scatter.cc (storage/native_ingest.py)."""
    from pilosa_tpu_torch.storage import native_ingest
    native_ingest.or_bits(words, cols)


def from_columns(cols, width: int = SHARD_WIDTH) -> np.ndarray:
    """Pack set column ids (each < width) into words."""
    words = empty(width)
    cols = np.asarray(cols, dtype=np.int64)
    if cols.size:
        if cols.min() < 0 or cols.max() >= width:
            raise ValueError("column id out of range")
        or_bits(words, cols)
    return words


def to_columns(words) -> np.ndarray:
    """Unpack a packed row into its sorted set column ids.  Only the
    nonzero words unpack, so a sparse row costs its words' scan, not a
    byte per column."""
    words = np.asarray(words, dtype=np.uint32)
    nz = np.flatnonzero(words)
    # little-endian bytes + little bit order: bit i of a word lands at
    # index i of its 32, the LSB-first layout
    bits = np.unpackbits(words[nz].view(np.uint8),
                         bitorder="little").reshape(nz.size, BITS_PER_WORD)
    w, b = np.nonzero(bits)
    return (nz[w].astype(np.uint64) << np.uint64(5)) | b.astype(np.uint64)


def range_mask(start: int, end: int, width: int = SHARD_WIDTH) -> np.ndarray:
    """Packed mask with bits set for columns in [start, end)."""
    start = max(0, min(start, width))
    end = max(start, min(end, width))
    mask = empty(width)
    sw, sb = start >> 5, start & 31
    ew, eb = end >> 5, end & 31
    if sw == ew:
        if sb != eb:
            mask[sw] = ((np.uint32(1) << np.uint32(eb - sb)) - 1) << sb
        return mask
    mask[sw] = np.uint32(0xFFFFFFFF) << np.uint32(sb)
    mask[sw + 1:ew] = 0xFFFFFFFF
    if eb:
        mask[ew] = (np.uint32(1) << np.uint32(eb)) - 1
    return mask


def to_tensor(words: np.ndarray, device) -> torch.Tensor:
    """Host uint32 words → int32 tensor with the same bits on `device`."""
    arr = np.ascontiguousarray(words, dtype=np.uint32).view(np.int32)
    return torch.from_numpy(arr).to(device)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """int32 word tensor → host uint32 words with the same bits."""
    return t.detach().cpu().numpy().view(np.uint32)


# ---------------------------------------------------------------------------
# Device-side ops (torch.int32)
# ---------------------------------------------------------------------------


def intersect(a, b):
    return torch.bitwise_and(a, b)


def union(a, b):
    return torch.bitwise_or(a, b)


def difference(a, b):
    """a AND NOT b."""
    return torch.bitwise_and(a, torch.bitwise_not(b))


def xor(a, b):
    return torch.bitwise_xor(a, b)


def complement(a):
    """Bitwise NOT over the full shard width (PQL ``Not()`` is
    existence-relative: the executor composes this via difference())."""
    return torch.bitwise_not(a)


def popcount_words(words: torch.Tensor) -> torch.Tensor:
    """Per-word popcount, SWAR, as int32 counts 0..32.

    The plain version of the kernels' ``__popc``.  It widens to int64
    and masks to the low 32 bits first, so no step depends on int32
    overflow or on the sign of the arithmetic right shift."""
    x = words.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return (((x * 0x01010101) >> 24) & 0xFF).to(torch.int32)


def count(words: torch.Tensor) -> torch.Tensor:
    """Set bits reduced over the last (word) axis → int32.

    Per-shard counts are < 2^20 so int32 is exact; cross-shard totals
    are summed as int64 or Python ints by the callers."""
    return popcount_words(words).sum(dim=-1, dtype=torch.int32)


def any_set(words: torch.Tensor) -> torch.Tensor:
    """True where any bit of the last axis is set."""
    return (words != 0).any(dim=-1)


def intersection_count(a, b):
    """popcount(a & b) (roaring.IntersectionCount semantics)."""
    return count(torch.bitwise_and(a, b))


def shift(words: torch.Tensor, n: int = 1) -> torch.Tensor:
    """Shift all bits toward higher column ids by a static n (zero fill).

    Column c becomes column c+n; bits shifted past the end drop off.
    Reference: PQL Shift() → executor.executeShiftShard → Row.Shift."""
    if n == 0:
        return words
    if n < 0:
        raise ValueError("shift count must be >= 0")
    q, r = divmod(n, BITS_PER_WORD)
    w = words.shape[-1]
    if q >= w:
        return torch.zeros_like(words)
    zeros = torch.zeros(words.shape[:-1] + (q + 1,), dtype=words.dtype,
                        device=words.device)
    words_q = (torch.cat([zeros[..., :q], words[..., :w - q]], dim=-1)
               if q else words)
    if r == 0:
        return words_q
    # carry the top r bits of the previous word; the int32 right shift
    # is arithmetic, so mask to the r carried bits
    prev = torch.cat([zeros[..., :1], words_q[..., :w - 1]], dim=-1)
    carry = (prev >> (BITS_PER_WORD - r)) & ((1 << r) - 1)
    return (words_q << r) | carry


def count_range(words: torch.Tensor, start: int, end: int,
                width: int | None = None) -> torch.Tensor:
    """Count of set bits with column id in [start, end)
    (roaring CountRange semantics)."""
    if width is None:
        width = words.shape[-1] * BITS_PER_WORD
    mask = to_tensor(range_mask(start, end, width), words.device)
    return count(torch.bitwise_and(words, mask))


def union_rows(rows: torch.Tensor) -> torch.Tensor:
    """OR-fold over axis 0: (R, ..., W) → (..., W)."""
    acc = rows[0].clone()
    for i in range(1, rows.shape[0]):
        acc |= rows[i]
    return acc


def intersect_rows(rows: torch.Tensor) -> torch.Tensor:
    """AND-fold over axis 0: (R, ..., W) → (..., W)."""
    acc = rows[0].clone()
    for i in range(1, rows.shape[0]):
        acc &= rows[i]
    return acc


# ---------------------------------------------------------------------------
# Stack patching (resident stacks patched on write)
# ---------------------------------------------------------------------------
#
# A write's delta log names the dirty (lane, word-run) spans of a
# resident stack; these scatter the runs' current words into it, so a
# point write uploads a few words instead of the stack.

def _run_bounds(shape, idxs, starts, p: int):
    """Host int64 (idxs, starts), checked: every run of p words lies
    within one lane of an (L, W) stack."""
    idxs = np.asarray(idxs, dtype=np.int64).reshape(-1)
    starts = np.asarray(starts, dtype=np.int64).reshape(-1)
    n_lanes, w = shape
    if idxs.shape != starts.shape:
        raise ValueError("idxs and starts differ in length")
    if idxs.size and (idxs.min() < 0 or idxs.max() >= n_lanes
                      or starts.min() < 0 or starts.max() + p > w):
        raise ValueError(f"a run of {p} words lies outside the "
                         f"({n_lanes}, {w}) stack")
    return idxs, starts


def patch_rows(stack2d: torch.Tensor, idxs, starts, data) -> torch.Tensor:
    """Scatter word runs into an (L, W) int32 stack in place: run k
    replaces ``stack2d[idxs[k], starts[k]:starts[k]+P]`` with
    ``data[k]`` (data (N, P), host uint32 or a device int32 tensor;
    each run within one lane).  The runs' flat word indices are formed
    on the stack's device and the words land in one ``index_copy_``
    over the flattened stack, which must be contiguous.  Runs that
    overlap must carry the same words (the cache's runs are read from
    the live rows), since the order they land in is not fixed.  Returns
    stack2d."""
    if stack2d.ndim != 2 or not stack2d.is_contiguous():
        raise ValueError("patch_rows needs a contiguous (L, W) stack")
    dev = stack2d.device
    if not isinstance(data, torch.Tensor):
        data = to_tensor(np.asarray(data, dtype=np.uint32), dev)
    n, p = data.shape
    idxs, starts = _run_bounds(stack2d.shape, idxs, starts, p)
    if idxs.size != n:
        raise ValueError("data and idxs differ in length")
    if n == 0:
        return stack2d
    base = torch.from_numpy(idxs * stack2d.shape[1] + starts).to(dev)
    flat = (base.unsqueeze(1) + torch.arange(p, device=dev)).reshape(-1)
    stack2d.view(-1).index_copy_(0, flat, data.to(dev).reshape(-1))
    return stack2d


def patch_rows_np(stack2d: np.ndarray, idxs, starts, data: np.ndarray,
                  out=None) -> np.ndarray:
    """Host twin of patch_rows on uint32 words.  Copies by default; pass
    ``out`` (stack2d itself, or a copy) to write in place."""
    data = np.asarray(data, dtype=np.uint32)
    idxs, starts = _run_bounds(stack2d.shape, idxs, starts, data.shape[1])
    if out is None:
        out = stack2d.copy()
    p = data.shape[1]
    for k in range(idxs.size):
        out[idxs[k], starts[k]:starts[k] + p] = data[k]
    return out


# ---------------------------------------------------------------------------
# Group-code planes (one-pass GroupBy)
# ---------------------------------------------------------------------------
#
# A stack of R disjoint packed rows (no column in two rows) is a base-R
# digit per column; these helpers re-encode that digit as
# digit_bits(R) packed bit-planes, so the one-pass GroupBy histogram
# composes a dense group code per column without unpacking the row
# stacks.  digit_planes uses only | so it serves numpy and torch alike.

def digit_bits(n_rows: int) -> int:
    """Bit-planes needed to encode a digit in [0, n_rows)."""
    return max(int(n_rows) - 1, 0).bit_length()


def digit_planes(rows):
    """Disjoint row stack (R, ..., W) → (digit_bits(R), ..., W) packed
    digit planes: plane b is the OR of the rows whose index has bit b
    set, so a column in row r carries the bits of r.  The caller
    guarantees disjointness (an overlap would OR two digits)."""
    nbits = digit_bits(rows.shape[0])
    planes = []
    for b in range(nbits):
        acc = None
        for i in range(rows.shape[0]):
            if (i >> b) & 1:
                acc = rows[i] if acc is None else acc | rows[i]
        planes.append(acc)
    if isinstance(rows, np.ndarray):
        return (np.stack(planes) if planes
                else np.zeros((0,) + rows.shape[1:], dtype=rows.dtype))
    return (torch.stack(planes) if planes
            else rows.new_zeros((0,) + tuple(rows.shape[1:])))


_BIT_SHIFTS = torch.arange(BITS_PER_WORD, dtype=torch.int32)


def unpack_bits(words: torch.Tensor) -> torch.Tensor:
    """(..., W) int32 words → (..., W*32) int32 0/1 per column
    (column c = word c >> 5, bit c & 31).  The arithmetic shift is
    masked to its low bit."""
    shifts = _BIT_SHIFTS.to(words.device)
    bits = (words.unsqueeze(-1) >> shifts) & 1
    return bits.reshape(*words.shape[:-1], words.shape[-1] * BITS_PER_WORD)


def code_from_planes(planes: torch.Tensor) -> torch.Tensor:
    """(CB, ..., W) packed planes → (..., W*32) int32 per-column codes,
    plane b contributing bit b.  CB = 0 gives all-zero codes."""
    cb = planes.shape[0]
    code = torch.zeros(tuple(planes.shape[1:-1])
                       + (planes.shape[-1] * BITS_PER_WORD,),
                       dtype=torch.int32, device=planes.device)
    for b in range(cb):
        code |= unpack_bits(planes[b]) << b
    return code


def code_from_planes_np(planes: np.ndarray) -> np.ndarray:
    """Host twin of code_from_planes (numpy uint32 planes, same layout)."""
    planes = np.asarray(planes, dtype=np.uint32)
    out_shape = planes.shape[1:-1] + (planes.shape[-1] * BITS_PER_WORD,)
    code = np.zeros(out_shape, dtype=np.int32)
    shifts = np.arange(BITS_PER_WORD, dtype=np.uint32)
    for b in range(planes.shape[0]):
        bits = ((planes[b][..., None] >> shifts) & 1).astype(np.int32)
        code |= bits.reshape(out_shape) << b
    return code


# ---------------------------------------------------------------------------
# Pages of the stack cache (memory/pages.py, memory/encode.py)
# ---------------------------------------------------------------------------
# A page is a (page_lanes, W) block of a stack's flattened lanes, dense
# or encoded: packed, the sorted flat bit offsets of its set bits as
# uint32 coordinates; run, sorted word-granular runs of all-ones words
# (int32 starts and lengths) plus the residual bits as coordinates.
# Payloads are pow2-padded with sentinels (a coordinate of the page's
# bit count, a run start of its word count with length 0), which every
# op here drops.  On the card the pages become dense through the
# assemble_pages kernel (ops/kernels.py); the plain versions are below.

def _u32(t: torch.Tensor) -> torch.Tensor:
    """int32 words or coordinates carrying uint32 bits → int64 values."""
    return t.to(torch.int64) & 0xFFFFFFFF


def _as_words(flat: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) → int32 tensor with the same bits."""
    return torch.where(flat >= 1 << 31, flat - (1 << 32), flat) \
        .to(torch.int32)


def expand_coords_plain(coords: torch.Tensor, page_lanes: int,
                        width_words: int) -> torch.Tensor:
    """Packed coordinates → dense (page_lanes, W) int32 block."""
    n_words = page_lanes * width_words
    c = _u32(coords.reshape(-1))
    c = c[c < n_words * BITS_PER_WORD]
    flat = torch.zeros(n_words, dtype=torch.int64, device=coords.device)
    # the coordinates are distinct set bits, so adding them ORs them
    flat.index_add_(0, c >> 5, torch.ones_like(c) << (c & 31))
    return _as_words(flat).reshape(page_lanes, width_words)


def expand_runs_plain(starts: torch.Tensor, lens: torch.Tensor,
                      coords: torch.Tensor, page_lanes: int,
                      width_words: int) -> torch.Tensor:
    """Run page (all-ones word runs + residual coordinates) → dense
    (page_lanes, W) int32 block."""
    n_words = page_lanes * width_words
    base = expand_coords_plain(coords, page_lanes, width_words).reshape(-1)
    s = starts.reshape(-1).to(torch.int64)
    ln = lens.reshape(-1).to(torch.int64)
    w = torch.arange(n_words, dtype=torch.int64, device=base.device)
    # runs are sorted and disjoint: the covering candidate is the last
    # run starting at or before w (sentinel starts sort past every w)
    j = (torch.searchsorted(s, w, right=True) - 1).clamp(0, s.numel() - 1)
    inside = (w >= s[j]) & (w < s[j] + ln[j])
    return torch.where(inside, torch.full_like(base, -1), base) \
        .reshape(page_lanes, width_words)


def assemble_pages(pages, shape: tuple, page_lanes: int,
                   table=None) -> torch.Tensor:
    """Pages (dense tensors or encoded pages) → the stack's (lanes, W)
    words in its logical shape, the last page's padding dropped: one
    ``kernels.assemble_pages`` launch on the card (over ``table``, the
    pages' ``kernels.page_table``, when the caller kept it)."""
    from pilosa_tpu_torch.ops import kernels
    return kernels.assemble_pages(pages, shape, page_lanes, table=table)


def concat_gather(pages, lane_idx, table=None) -> torch.Tensor:
    """Rows ``lane_idx`` of a bucket of dense (page_lanes, W) pages viewed
    as one concatenated array: one ``kernels.concat_gather`` launch on the
    card, the concatenation never built."""
    from pilosa_tpu_torch.ops import kernels
    return kernels.concat_gather(pages, lane_idx, table=table)


def segment_count(pages, lane_idx, seg_ids, num_segments: int,
                  table=None) -> torch.Tensor:
    """Per-segment popcount totals (int64) of bucket lanes ``lane_idx``,
    ids outside [0, num_segments) dropped: one ``kernels.segment_count``
    launch on the card, no lane materialised.  The JAX package's
    segment_count takes gathered lanes and answers int32; this one reads
    the lanes through the page table and is exact in int64."""
    from pilosa_tpu_torch.ops import kernels
    return kernels.segment_count(pages, lane_idx, seg_ids, num_segments,
                                 table=table)


class _Payload:
    """An encoded page's payload for assemble_pages."""

    __slots__ = ("kind", "coords", "run_starts", "run_lens")

    def __init__(self, kind, coords, run_starts=None, run_lens=None):
        self.kind, self.coords = kind, coords
        self.run_starts, self.run_lens = run_starts, run_lens


def expand_coords(coords: torch.Tensor, page_lanes: int,
                  width_words: int) -> torch.Tensor:
    """Packed coordinate page → dense (page_lanes, W) int32 block."""
    return assemble_pages([_Payload("packed", coords)],
                          (page_lanes, width_words), page_lanes)


def expand_runs(starts: torch.Tensor, lens: torch.Tensor,
                coords: torch.Tensor, page_lanes: int,
                width_words: int) -> torch.Tensor:
    """Run page → dense (page_lanes, W) int32 block."""
    return assemble_pages([_Payload("run", coords, starts, lens)],
                          (page_lanes, width_words), page_lanes)


def packed_count(coords: torch.Tensor, total_bits: int) -> torch.Tensor:
    """Set bits of a packed page (its sentinels dropped), int32."""
    return (_u32(coords) < int(total_bits)).sum(dtype=torch.int32)


def packed_segment_count(coords: torch.Tensor, lane_bits: int,
                         num_lanes: int) -> torch.Tensor:
    """Per-lane set bits of a packed page: a coordinate's lane is
    coord // lane_bits; sentinels land past num_lanes and drop."""
    lane = _u32(coords) // int(lane_bits)
    lane = lane[lane < num_lanes]
    return torch.bincount(lane, minlength=num_lanes).to(torch.int32)


def packed_intersect_count(coords: torch.Tensor, dense_words: torch.Tensor,
                           total_bits: int) -> torch.Tensor:
    """popcount(expand(coords) & dense) without expanding: the dense
    word under each coordinate, its bit tested."""
    c = _u32(coords)
    flat = _u32(dense_words.reshape(-1))
    wi = (c >> 5).clamp(max=flat.numel() - 1)
    bits = (flat[wi] >> (c & 31)) & 1
    return torch.where(c < int(total_bits), bits, 0).sum(dtype=torch.int32)
