"""The query path's kernels: CUDA on the card, plain PyTorch beside each.

Eight hand-written CUDA kernels replace the eight Pallas kernels of
``pilosa_tpu/ops/kernels.py``, a ninth the BSI comparator that the JAX
package fuses under its plan's jit, and a tenth its jitted page
assembly.  In ``csrc/bitmap_kernels.cu``:

- ``popcount_rows``       — Count of a leaf or a per-shard tree, the
  stacked unfiltered TopN row counts, the per-shard GroupBy's combo counts
- ``pair_popcount``       — Count(Intersect(leaf, leaf)), MinRow/MaxRow and
  set-field Distinct under a filter
- ``masked_popcount``     — the per-shard TopN/TopK candidate scan: one
  launch over every shard's row tiles against that shard's filter
  (``masked_popcount_shards``), or one (N, W) & (W,) call
- ``rows_filter_counts``  — filtered TopN candidate counts (stacked)
- ``bsi_sum_counts``      — BSI Sum's filtered sign-split plane counts, and
  the per-shard GroupBy's Sum partials
- ``bsi_range``           — the BSI comparator: a Range row of
  eq/neq/lt/lte/gt/gte/between from one read of the planes (no Pallas
  kernel: the JAX package leaves ``ops/bsi.py``'s jnp walk to XLA)

and in ``csrc/groupby_kernels.cu``:

- ``groupby_fused``       — the one-pass group-code histogram (disjoint
  GroupBy, GroupBy Min/Max, and through ``bsi_value_hist`` top-level
  Min, Max and BSI Distinct)
- ``groupby_onehot``      — the same histogram without the Min/Max table,
  as int8 tensor-core products (the stacked engine's ``"onehot"`` arm)
- ``groupby_sum``         — the per-combo GroupBy count and Sum partials

and in ``csrc/page_kernels.cu``:

- ``assemble_pages``      — a paged stack's operand from its pages, dense,
  packed or run, in one launch (the JAX package's jitted
  ``assemble_pages``, ``expand_coords`` and ``expand_runs``: no Pallas)

and in ``csrc/ragged_kernels.cu``, the ragged serving program's two
page-table reads (the JAX package's jnp ``concat_gather`` and
``segment_count``: no Pallas):

- ``concat_gather``       — lanes of a bucket of dense pages, viewed as one
  concatenated array that is never built, gathered into an operand
- ``segment_count``       — the popcounts of such lanes summed by segment:
  a family of point Counts in one pass, no operand materialised

Words are ``torch.int32`` tensors carrying uint32 bits.  Each wrapper
checks device, dtype, shape and contiguity, allocates its outputs, and
then either launches its kernel on the current stream (a CUDA tensor)
or runs its plain version (a CPU tensor).  There is no other switch and
no fallback: a CUDA tensor launches the kernel or raises.  Each wrapper
counts its launches in ``LAUNCHES`` — incremented where the kernel is
launched and nowhere else — so a run can show which kernels the query
path went through.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from pilosa_tpu_torch.ops import bitmap as bm
from pilosa_tpu_torch.ops import bsi

_P = ctypes.c_void_p
_I = ctypes.c_int64
_ARGTYPES = {
    "pt_popcount_rows": [_P, _P, _I, _I, _P],
    "pt_pair_popcount": [_P, _P, _P, _I, _I, _P],
    "pt_masked_popcount": [_P, _P, _P, _I, _I, _P],
    "pt_masked_popcount_shards": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "pt_rows_filter_counts": [_P, _P, _P, _I, _I, _I, _P],
    "pt_bsi_sum_counts": [_P, _I, _P, _P, _P, _P, _I, _I, _I, _P],
    "pt_bsi_range": [_P, _I, _P, _I, _I, _I, _I, ctypes.c_uint64,
                     ctypes.c_uint64, _I, _I, _P],
    "pt_groupby_fused": [_P, _I, _I, _P, _I, _P, _I, _I, _I, _I, _I, _I,
                         _P, _P, _P],
    "pt_groupby_onehot": [_P, _I, _I, _P, _I, _P, _I, _I, _I, _I, _I, _I,
                          _P, _P],
    "pt_groupby_sum": [ctypes.POINTER(_P), ctypes.POINTER(_I), _I, _P, _I, _P,
                       _I, _I, _I, _I, _P, _P, _P, _P, _P],
    "pt_assemble_pages": [_P, _I, _I, _P, _I, _P],
    "pt_concat_gather": [_P, _I, _I, _P, _I, _P, _I, _P],
    "pt_segment_count": [_P, _I, _I, _P, _P, _I, _I, _P, _I, _P],
}
_LIBS = {"pt_groupby_fused": "groupby_kernels",
         "pt_groupby_onehot": "groupby_kernels",
         "pt_groupby_sum": "groupby_kernels",
         "pt_assemble_pages": "page_kernels",
         "pt_concat_gather": "ragged_kernels",
         "pt_segment_count": "ragged_kernels"}
_GRID_MAX = (1 << 31) - 1
_INT32_MAX = (1 << 31) - 1

# kernel limits (csrc/groupby_kernels.cu): code bits and magnitude
# planes held in registers, stack pointers passed by value
GB_MAX_CODE_BITS = 24
GB_MAX_DEPTH = 63
GB_MINMAX_MAX_DEPTH = 30   # the (4, G) magnitude table is int32
GB_MAX_FIELDS = 8
# the one-hot kernel's tables: at most 4096 codes (16-code slices across
# the grid) and 2 + 2*16 payload rows (three 16-row tensor-core tiles)
ONEHOT_MAX_CODES = 4096
ONEHOT_MAX_DEPTH = 16
# masked_popcount's grid: at most S x ceil(W / 1024) blocks plus
# kMpTargetBlocks (csrc/bitmap_kernels.cu launch_masked_popcount)
_MASKED_CHUNK = 1024
_MASKED_EXTRA_BLOCKS = 2048
# words of one bsi_range block (csrc/bitmap_kernels.cu kRangeChunk)
_RANGE_CHUNK = 1024

# shard columns one plain-histogram step unpacks (bounded memory at
# full width: 16 shards of 2^20 columns)
_PLAIN_COLUMNS = 1 << 24

LAUNCHES = {name: 0 for name in (
    "popcount_rows", "pair_popcount", "masked_popcount", "rows_filter_counts",
    "bsi_sum_counts", "bsi_range", "groupby_fused", "groupby_onehot",
    "groupby_sum", "assemble_pages", "concat_gather", "segment_count")}

# bsi_range's comparisons, in the C entry's numbering
RANGE_OPS = ("eq", "neq", "lt", "lte", "gt", "gte", "between")
# int64 values have magnitudes up to 2^63, so depth 64, and predicate
# magnitudes below 2^64 fit the kernel's uint64
RANGE_MAX_DEPTH = 64


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _fn(name: str):
    from pilosa_tpu_torch.ops import _build
    f = getattr(_build.library(_LIBS.get(name, "bitmap_kernels")), name)
    if f.argtypes is None:
        f.argtypes = _ARGTYPES[name]
        f.restype = ctypes.c_int
    return f


def _launch(kernel: str, cname: str, *args) -> None:
    stream = torch.cuda.current_stream().cuda_stream
    err = _fn(cname)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed (cudaError {err})")
    LAUNCHES[kernel] += 1


def _check(name: str, t: torch.Tensor, ndim: int, device,
           any_shard_stride: bool = False) -> None:
    """dtype, rank, device and layout.  With ``any_shard_stride`` the
    first (shard) axis may have any stride as long as, within a shard,
    the words are contiguous and the planes W words apart, so a plane
    range of a larger stack goes in as a view."""
    if t.dtype != torch.int32:
        raise TypeError(f"{name}: expected int32 words, got {t.dtype}")
    if t.ndim != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name}: tensors on {t.device} and {device}")
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {t.device}")
    if not any_shard_stride:
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensor must be contiguous")
        return
    w = t.shape[-1]
    if t.numel() and ((w > 1 and t.stride(-1) != 1) or (
            ndim == 3 and t.shape[1] > 1 and t.stride(1) != w)):
        raise ValueError(f"{name}: words must be contiguous within a shard")


def _check_int32_totals(name: str, s: int, w: int) -> None:
    # per-group and per-combo totals are int32 on the card: exact while
    # every column of S shards could be counted once
    if s * w * 32 > _INT32_MAX:
        raise ValueError(f"{name}: {s} shards x {w} words can overflow "
                         "int32 totals; chunk the shards")


def check_tile(t: torch.Tensor, words: int, device) -> None:
    """A row tile as masked_popcount_shards reads it: a contiguous (W,)
    int32 tensor on ``device``."""
    if t.dtype is not torch.int32:
        raise TypeError(f"row tile: expected int32 words, got {t.dtype}")
    if t.shape != (words,) or not t.is_contiguous() or t.device != device:
        raise ValueError(f"row tile: expected contiguous ({words},) words "
                         f"on {device}, got {tuple(t.shape)} on {t.device}")


class RowTiles:
    """One view's R row tiles on one shard, each a contiguous (W,) int32
    tensor on ``device``, with their addresses, which are derived here
    from the tiles and nowhere else.  Every tile is checked here, unless
    ``checked`` says its maker checked it: the per-shard engine's
    TileCache checks each tile where it uploads it (checking 7632 tiles
    a query cost more host time than the launch saved)."""
    __slots__ = ("tiles", "addrs", "words", "device")

    def __init__(self, tiles, words: int, device, checked: bool = False):
        if not checked:
            device = device_of(device)
            for t in tiles:
                check_tile(t, words, device)
        self.tiles = list(tiles)
        self.addrs = [t.data_ptr() for t in self.tiles]
        self.words = words
        self.device = device


# ---------------------------------------------------------------------------
# plain versions (the CPU path, and the reference the card is held to)
# ---------------------------------------------------------------------------

def popcount_rows_plain(x: torch.Tensor) -> torch.Tensor:
    return bm.count(x)


def pair_popcount_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return bm.count(a & b)


def masked_popcount_plain(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return bm.count(x & mask)


def masked_popcount_shards_plain(tiles, masks, n_rows: int, words: int,
                                 device) -> torch.Tensor:
    """Plain version of masked_popcount_shards: per shard, its views'
    rows ORed, counted against its mask (masked_popcount_plain; without
    a mask the rows' own popcount), summed over the shards in int64."""
    out = torch.zeros(n_rows, dtype=torch.int64, device=device)
    for s, views in enumerate(tiles):
        acc = None
        for t in views:
            if t is not None and n_rows:
                rows = torch.stack(t.tiles)
                acc = rows if acc is None else acc | rows
        if acc is None:
            continue
        m = None if masks is None else masks[s]
        out += (bm.count(acc) if m is None
                else masked_popcount_plain(acc, m)).to(torch.int64)
    return out


def rows_filter_counts_plain(rows: torch.Tensor,
                             filt: torch.Tensor) -> torch.Tensor:
    return bm.count(rows & filt.unsqueeze(0))


def bsi_sum_counts_plain(planes: torch.Tensor, filt=None):
    return bsi.sum_counts(planes, filt)


def bsi_range_plain(planes: torch.Tensor, op: str, p: int, q=None,
                    p_neg: bool = False, q_neg: bool = False) -> torch.Tensor:
    """The comparator as ops/bsi.py's eager walk, on per-plane predicate
    masks built here."""
    depth = planes.shape[-2] - 2
    pb = bsi.predicate_masks(p, depth)
    if op == "between":
        return bsi.range_between(planes, pb, bsi.predicate_masks(q, depth),
                                 p_neg, q_neg)
    if op in ("eq", "neq"):
        return getattr(bsi, f"range_{op}")(planes, pb, p_neg)
    fn = bsi.range_lt if op.startswith("lt") else bsi.range_gt
    return fn(planes, pb, p_neg, allow_eq=op.endswith("e"))


def _hist_rows(depth: int, signed: bool) -> int:
    """K, the payload rows [counts, nn, pos x d, neg x d] of the table."""
    return 1 if depth == 0 else 2 + (2 if signed else 1) * depth


def _bins(seg: torch.Tensor, mask: torch.Tensor, g: int) -> torch.Tensor:
    """Per-code counts of the masked columns; the rest land in bucket g."""
    return torch.bincount(torch.where(mask, seg, g), minlength=g + 1)


def groupby_codes_plain(code_planes: torch.Tensor, valid: torch.Tensor,
                        planes: torch.Tensor | None = None, n_codes: int = 1,
                        signed: bool = True, minmax: bool = False):
    """Plain version of groupby_fused: unpack each column's group code,
    then scatter-add its payload, a few shards at a time so memory
    stays bounded at full width (the port of groupby_codes_xla).

    code_planes (S, CB, W), valid (S, W), planes (S, 2+d, W) or None →
    counts (G,), nn (G,), pos (G, d), neg (G, d) int32, G = n_codes,
    plus mm (4, G) int32 with ``minmax``; nn/pos/neg are None without
    planes.  Invalid columns and codes >= G go to an overflow bucket
    that is dropped."""
    s, _cb, w = code_planes.shape
    depth = 0 if planes is None else planes.shape[1] - 2
    dev = valid.device
    g = int(n_codes)
    hist = torch.zeros((_hist_rows(depth, signed), g + 1), dtype=torch.int64,
                       device=dev)
    big = 1 << depth
    mm = None
    if minmax:
        mm = torch.tensor([-1, big, -1, big], dtype=torch.int64,
                          device=dev).unsqueeze(1).repeat(1, g + 1)
    step = max(1, _PLAIN_COLUMNS // max(w * 32, 1))
    for lo in range(0, s, step):
        sl = slice(lo, lo + step)
        code = bm.code_from_planes(code_planes[sl].transpose(0, 1))
        code = code.reshape(-1).to(torch.int64)
        va = bm.unpack_bits(valid[sl]).reshape(-1) == 1
        seg = torch.where(va & (code < g), code, g)
        hist[0] += torch.bincount(seg, minlength=g + 1)
        if not depth:
            continue
        pl = planes[sl]
        ex = (bm.unpack_bits(pl[:, 0]).reshape(-1) == 1) & va
        sg = bm.unpack_bits(pl[:, 1]).reshape(-1) == 1
        posm = ex & ~sg if signed else ex
        negm = ex & sg
        hist[1] += _bins(seg, ex, g)
        mag = torch.zeros_like(seg)
        for p in range(depth):
            bit = bm.unpack_bits(pl[:, 2 + p]).reshape(-1) == 1
            hist[2 + p] += _bins(seg, bit & posm, g)
            if signed:
                hist[2 + depth + p] += _bins(seg, bit & negm, g)
            if minmax:
                mag |= bit.to(torch.int64) << p
        if minmax:
            for side, mask in ((0, posm), (2, negm if signed else None)):
                if mask is None:
                    continue
                idx = torch.where(mask, seg, g)
                mm[side].scatter_reduce_(0, idx, mag, "amax")
                mm[side + 1].scatter_reduce_(0, idx, mag, "amin")
    hist = hist[:, :g].to(torch.int32)
    counts = hist[0]
    if depth == 0:
        return counts, None, None, None
    nn = hist[1]
    pos = hist[2:2 + depth].T.contiguous()
    neg = (hist[2 + depth:].T.contiguous() if signed
           else torch.zeros_like(pos))
    if not minmax:
        return counts, nn, pos, neg
    return counts, nn, pos, neg, mm[:, :g].to(torch.int32)


def groupby_sum_plain(stacks, sel: torch.Tensor,
                      planes: torch.Tensor | None = None,
                      signed: bool = True):
    """Plain version of groupby_sum: for each combo c, m = AND over
    fields of stacks[f][sel[c, f]], counted alone, against exists, and
    per magnitude plane split by sign (every exists column on the
    positive side when ``signed`` is False).  Returns counts (C,), nn
    (C,), pos (C, d), neg (C, d) int32; nn/pos/neg None without
    planes."""
    depth = 0 if planes is None else planes.shape[1] - 2
    dev = sel.device
    counts, nn, pos, neg = [], [], [], []
    for row in sel.cpu().tolist():
        m = stacks[0][row[0]]
        for f in range(1, len(stacks)):
            m = m & stacks[f][row[f]]
        counts.append(bm.count(m).sum(dtype=torch.int64))
        if not depth:
            continue
        em = m & planes[:, 0]
        nn.append(bm.count(em).sum(dtype=torch.int64))
        pm = em & ~planes[:, 1] if signed else em
        nm = em & planes[:, 1]
        pos.append(torch.stack([bm.count(planes[:, 2 + p] & pm)
                                .sum(dtype=torch.int64)
                                for p in range(depth)]))
        neg.append(torch.stack([bm.count(planes[:, 2 + p] & nm)
                                .sum(dtype=torch.int64)
                                for p in range(depth)]) if signed
                   else torch.zeros(depth, dtype=torch.int64, device=dev))
    c = sel.shape[0]

    def stacked(xs, shape):
        if not xs:
            return torch.zeros(shape, dtype=torch.int32, device=dev)
        return torch.stack(xs).to(torch.int32)

    out_counts = stacked(counts, (c,))
    if not depth:
        return out_counts, None, None, None
    return (out_counts, stacked(nn, (c,)), stacked(pos, (c, depth)),
            stacked(neg, (c, depth)))


def _page_lanes(lanes: int, page_lanes: int, n_pages: int) -> None:
    if page_lanes < 1 or n_pages != -(-lanes // page_lanes):
        raise ValueError(f"assemble_pages: {n_pages} pages of {page_lanes} "
                         f"lanes cannot hold {lanes} lanes")


def assemble_pages_plain(pages, shape: tuple, page_lanes: int):
    """Plain version of assemble_pages: each page expanded on its own
    (bm.expand_coords_plain / expand_runs_plain; a dense page as it
    is), concatenated with torch.cat and trimmed to the stack's lanes."""
    w = int(shape[-1])
    lanes = int(np.prod(shape[:-1], dtype=np.int64))
    _page_lanes(lanes, page_lanes, len(pages))
    parts = []
    for p in pages:
        if isinstance(p, torch.Tensor):
            parts.append(p.reshape(page_lanes, w))
        elif p.kind == "packed":
            parts.append(bm.expand_coords_plain(p.coords, page_lanes, w))
        else:
            parts.append(bm.expand_runs_plain(p.run_starts, p.run_lens,
                                              p.coords, page_lanes, w))
    if not parts:
        return torch.empty(tuple(shape), dtype=torch.int32)
    flat = torch.cat(parts) if len(parts) > 1 else parts[0]
    return flat[:lanes].reshape(tuple(shape))


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def popcount_rows(x: torch.Tensor) -> torch.Tensor:
    """Per-row popcount: x (N, W) → (N,) int32."""
    _check("popcount_rows", x, 2, x.device)
    if x.device.type == "cpu":
        return popcount_rows_plain(x)
    n, w = x.shape
    if n > _GRID_MAX:
        raise ValueError("popcount_rows: too many rows for one launch")
    out = torch.empty(n, dtype=torch.int32, device=x.device)
    if n:
        _launch("popcount_rows", "pt_popcount_rows", x.data_ptr(),
                out.data_ptr(), n, w)
    return out


def pair_popcount(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """popcount(a & b) per row, the AND never materialised:
    (N, W) × 2 → (N,) int32."""
    _check("pair_popcount", a, 2, a.device)
    _check("pair_popcount", b, 2, a.device)
    if a.shape != b.shape:
        raise ValueError(f"pair_popcount: shapes {tuple(a.shape)} "
                         f"and {tuple(b.shape)} differ")
    if a.device.type == "cpu":
        return pair_popcount_plain(a, b)
    n, w = a.shape
    if n > _GRID_MAX:
        raise ValueError("pair_popcount: too many rows for one launch")
    out = torch.empty(n, dtype=torch.int32, device=a.device)
    if n:
        _launch("pair_popcount", "pt_pair_popcount", a.data_ptr(),
                b.data_ptr(), out.data_ptr(), n, w)
    return out


def _masked_grid(s: int, w: int) -> None:
    if s * ((w + _MASKED_CHUNK - 1) // _MASKED_CHUNK) \
            > _GRID_MAX - _MASKED_EXTRA_BLOCKS:
        raise ValueError("masked_popcount: too many shards x words for one "
                         "launch")


def masked_popcount(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """popcount(x[i] & mask) per row, one filter for every row:
    (N, W) & (W,) → (N,) int32 (the TPU kernel's signature; one shard of
    masked_popcount_shards)."""
    _check("masked_popcount", x, 2, x.device)
    _check("masked_popcount", mask, 1, x.device)
    if mask.shape[0] != x.shape[1]:
        raise ValueError(f"masked_popcount: rows {tuple(x.shape)} vs mask "
                         f"{tuple(mask.shape)}")
    if x.device.type == "cpu":
        return masked_popcount_plain(x, mask)
    n, w = x.shape
    _masked_grid(1, w)
    out = torch.zeros(n, dtype=torch.int32, device=x.device)
    if n * w:
        _launch("masked_popcount", "pt_masked_popcount", x.data_ptr(),
                mask.data_ptr(), out.data_ptr(), n, w)
    return out


def device_of(device) -> torch.device:
    """``device`` as its tensors name it: a card with its index."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def _tile_addrs(t, n_rows: int, words: int, device) -> list[int]:
    """Row addresses of one view's RowTiles (its tiles were checked
    where it was made), after checking that it holds R tiles of W words
    on ``device``."""
    name = "masked_popcount_shards"
    if not isinstance(t, RowTiles):
        raise TypeError(f"{name}: a view is RowTiles or None, got "
                        f"{type(t).__name__}")
    if len(t.addrs) != n_rows or t.words != words or t.device != device:
        raise ValueError(f"{name}: RowTiles of {len(t.addrs)} x "
                         f"{t.words} words on {t.device}, expected "
                         f"{n_rows} x {words} on {device}")
    return t.addrs


def _mask_addr(m: torch.Tensor, words: int, device) -> int:
    """The address of a (W,) filter, checked in one test (the common
    case costs one pass over 954 filters a query)."""
    name = "masked_popcount_shards"
    if (m.dtype is not torch.int32 or m.shape != (words,)
            or m.get_device() != (-1 if device.index is None else device.index)
            or not m.is_contiguous()):
        if m.dtype is not torch.int32:
            raise TypeError(f"{name}: expected int32 words, got {m.dtype}")
        raise ValueError(f"{name}: expected contiguous ({words},) filter "
                         f"words on {device}, got {tuple(m.shape)} on "
                         f"{m.device}")
    return m.data_ptr()


def shard_table(tiles, masks, n_rows: int, words: int,
                device) -> np.ndarray:
    """masked_popcount_shards' address table, (S*V*R + S,) int64: the
    tiles' row addresses in (S, V, R) order, then the S filter
    addresses; 0 is an absent tile or no filter.  Checks every view and
    mask on the way."""
    name = "masked_popcount_shards"
    device = device_of(device)
    s = len(tiles)
    v = len(tiles[0]) if s else 0
    if masks is not None and len(masks) != s:
        raise ValueError(f"{name}: {len(masks)} masks for {s} shards")
    addrs: list[int] = []
    for views in tiles:
        if len(views) != v:
            raise ValueError(f"{name}: every shard needs {v} views")
        for t in views:
            if t is None:
                addrs.extend([0] * n_rows)
            else:
                addrs.extend(_tile_addrs(t, n_rows, words, device))
    if masks is None:
        addrs.extend([0] * s)
    else:
        addrs.extend(0 if m is None else _mask_addr(m, words, device)
                     for m in masks)
    return np.array(addrs, dtype=np.int64)


def masked_popcount_shards(tiles, masks, n_rows: int, words: int,
                           device) -> torch.Tensor:
    """out[r] = Σ over shards s of popcount((OR over views v of
    tiles[s][v][r]) & masks[s]) → (n_rows,) int64, in one launch.

    ``tiles`` is a list over shards of lists over views (the same number
    for every shard, possibly none: a time range that covers no view);
    a view is None (no fragment: zeros) or a RowTiles (the tile cache's
    R row tiles).  ``masks`` is a list over shards of (W,) filter words
    (None: no filter for that shard), or None for no filter at all.
    The kernel reads every tile where it lies, through an address table
    built here and copied once; R, W and the device are given, since no
    shard (S = 0) or only absent tiles name none."""
    device = device_of(device)
    table = shard_table(tiles, masks, n_rows, words, device)
    if device.type == "cpu":
        return masked_popcount_shards_plain(tiles, masks, n_rows, words,
                                            device)
    out = torch.zeros(n_rows, dtype=torch.int64, device=device)
    s = len(tiles)
    v = len(tiles[0]) if s else 0
    if not (s and v and n_rows and words):
        return out
    _masked_grid(s, words)
    vec = words % 4 == 0 and not (table & 15).any()
    zero = torch.zeros(words, dtype=torch.int32, device=device)
    # pinned, so the copy is asynchronous; the caching host allocator
    # keeps the buffer from reuse until the copy has run, and every
    # tile and mask is referenced by the caller until the launch is
    # enqueued (the device allocator is stream-ordered after that)
    dev = torch.from_numpy(table).pin_memory().to(device, non_blocking=True)
    base = dev.data_ptr()
    _launch("masked_popcount", "pt_masked_popcount_shards", base,
            base + s * v * n_rows * 8, zero.data_ptr(), out.data_ptr(), s, v,
            n_rows, words, int(vec))
    return out


def rows_filter_counts(rows: torch.Tensor, filt: torch.Tensor) -> torch.Tensor:
    """popcount(rows[r, s] & filt[s]): (R, S, W), (S, W) → (R, S) int32."""
    _check("rows_filter_counts", rows, 3, rows.device)
    _check("rows_filter_counts", filt, 2, rows.device)
    if rows.shape[1:] != filt.shape:
        raise ValueError(f"rows_filter_counts: rows {tuple(rows.shape)} "
                         f"vs filter {tuple(filt.shape)}")
    if rows.device.type == "cpu":
        return rows_filter_counts_plain(rows, filt)
    r, s, w = rows.shape
    if r * s > _GRID_MAX:
        raise ValueError("rows_filter_counts: too many rows for one launch")
    out = torch.empty((r, s), dtype=torch.int32, device=rows.device)
    if r * s:
        _launch("rows_filter_counts", "pt_rows_filter_counts",
                rows.data_ptr(), filt.data_ptr(), out.data_ptr(), r, s, w)
    return out


def bsi_sum_counts(planes: torch.Tensor, filt: torch.Tensor | None = None):
    """Filtered count plus sign-split per-plane popcounts of a shard
    stack: planes (S, 2+d, W), filt (S, W) or None →
    cnt (S,), pos (S, d), neg (S, d), all int32.  The planes may have
    any shard stride (``_check``); stride 0 holds one shard's planes
    against S filters."""
    _check("bsi_sum_counts", planes, 3, planes.device, any_shard_stride=True)
    s, p, w = planes.shape
    if p < 3:
        raise ValueError("bsi_sum_counts: need at least one magnitude plane")
    if filt is not None:
        _check("bsi_sum_counts", filt, 2, planes.device)
        if filt.shape != (s, w):
            raise ValueError(f"bsi_sum_counts: filter {tuple(filt.shape)} "
                             f"vs planes {tuple(planes.shape)}")
    if planes.device.type == "cpu":
        return bsi_sum_counts_plain(planes, filt)
    d = p - 2
    dev = planes.device
    cnt = torch.zeros(s, dtype=torch.int32, device=dev)
    pos = torch.zeros((s, d), dtype=torch.int32, device=dev)
    neg = torch.zeros((s, d), dtype=torch.int32, device=dev)
    if s * ((w + 2047) // 2048) > _GRID_MAX:
        raise ValueError("bsi_sum_counts: too many shards for one launch")
    if s * w:
        _launch("bsi_sum_counts", "pt_bsi_sum_counts", planes.data_ptr(),
                planes.stride(0), None if filt is None else filt.data_ptr(),
                cnt.data_ptr(),
                pos.data_ptr(), neg.data_ptr(), s, p, w)
    return cnt, pos, neg


def bsi_range(planes: torch.Tensor, op: str, p: int, q=None,
              p_neg: bool = False, q_neg: bool = False) -> torch.Tensor:
    """The columns of each shard whose value satisfies a comparison:
    planes (S, 2+d, W) with any shard stride (``_check``), 1 <= d <= 64
    → (S, W) int32 words.  ``op`` is one of RANGE_OPS; ``p`` (and for
    "between", ``q``) are unsigned predicate magnitudes below 2^d, with
    their signs ``p_neg``/``q_neg``, as ops/bsi.py's range_* take them:
    "between" is p <= value <= q, empty when p >= 0 > q."""
    name = "bsi_range"
    _check(name, planes, 3, planes.device, any_shard_stride=True)
    s, pl, w = planes.shape
    depth = pl - 2
    if not 1 <= depth <= RANGE_MAX_DEPTH:
        raise ValueError(f"{name}: depth {depth} outside 1..{RANGE_MAX_DEPTH}")
    if op not in RANGE_OPS:
        raise ValueError(f"{name}: op {op!r} not in {RANGE_OPS}")
    if (q is None) != (op != "between"):
        raise ValueError(f"{name}: q is given exactly for 'between'")
    for v in (p, 0 if q is None else q):
        if not 0 <= int(v) < (1 << depth):
            raise ValueError(f"{name}: predicate {v} outside depth {depth}")
    if planes.device.type == "cpu":
        return bsi_range_plain(planes, op, p, q, p_neg, q_neg).contiguous()
    chunks = (w + _RANGE_CHUNK - 1) // _RANGE_CHUNK
    if s * chunks > _GRID_MAX:
        raise ValueError(f"{name}: too many shards for one launch")
    out = torch.empty((s, w), dtype=torch.int32, device=planes.device)
    if s * w:
        _launch(name, "pt_bsi_range", planes.data_ptr(), planes.stride(0),
                out.data_ptr(), s, pl, w, RANGE_OPS.index(op), int(p),
                int(q or 0), int(bool(p_neg)), int(bool(q_neg)))
    return out


def groupby_fused(code_planes: torch.Tensor, valid: torch.Tensor,
                  planes: torch.Tensor | None = None, n_codes: int = 1,
                  signed: bool = True, minmax: bool = False):
    """One-pass GroupBy histogram over a dense code space of n_codes
    groups: code_planes (S, CB, W) (plane b is bit b of each column's
    code), valid (S, W), planes (S, 2+d, W) or None →
    counts (G,), nn (G,), pos (G, d), neg (G, d) int32 (nn/pos/neg None
    without planes; neg zero when ``signed`` is False), plus with
    ``minmax`` a (4, G) int32 table [max_mag_pos, min_mag_pos,
    max_mag_neg, min_mag_neg] with identities -1 and 1 << d (combine
    with minmax_from_table).  Each input may be a view with any shard
    stride (``_check``)."""
    name = "groupby_fused"
    s, cb, w, depth = _hist_inputs(name, code_planes, valid, planes, n_codes)
    if minmax and depth == 0:
        raise ValueError(f"{name}: minmax requires BSI planes")
    if minmax and depth > GB_MINMAX_MAX_DEPTH:
        raise ValueError(f"{name}: minmax magnitudes need depth <= "
                         f"{GB_MINMAX_MAX_DEPTH}")
    if cb > GB_MAX_CODE_BITS or depth > GB_MAX_DEPTH:
        raise ValueError(f"{name}: at most {GB_MAX_CODE_BITS} code planes "
                         f"and depth {GB_MAX_DEPTH}")
    dev = valid.device
    if dev.type == "cpu":
        return groupby_codes_plain(code_planes, valid, planes, n_codes,
                                   signed, minmax)
    g = int(n_codes)
    hist = torch.zeros((_hist_rows(depth, signed), g), dtype=torch.int32,
                       device=dev)
    mm = None
    if minmax:
        mm = torch.tensor([-1, 1 << depth, -1, 1 << depth], dtype=torch.int32,
                          device=dev).unsqueeze(1).repeat(1, g)
    if s * w:
        _launch(name, "pt_groupby_fused",
                code_planes.data_ptr(), code_planes.stride(0), cb,
                valid.data_ptr(), valid.stride(0),
                None if planes is None else planes.data_ptr(),
                0 if planes is None else planes.stride(0), depth, s, w, g,
                int(bool(signed)), hist.data_ptr(),
                None if mm is None else mm.data_ptr())
    out = _split_hist(hist, depth, signed)
    return out if mm is None else out + (mm,)


def groupby_onehot(code_planes: torch.Tensor, valid: torch.Tensor,
                   planes: torch.Tensor | None = None, n_codes: int = 1,
                   signed: bool = True):
    """The one-pass histogram of groupby_fused, without its Min/Max
    table, as payload x one-hot products on the int8 tensor cores:
    the same inputs (views with any shard stride) and the same
    counts (G,), nn (G,), pos (G, d), neg (G, d) int32, for
    G <= ONEHOT_MAX_CODES codes and depth <= ONEHOT_MAX_DEPTH.  Its
    plain version is groupby_codes_plain, the same function."""
    name = "groupby_onehot"
    s, cb, w, depth = _hist_inputs(name, code_planes, valid, planes, n_codes)
    if (cb > GB_MAX_CODE_BITS or depth > ONEHOT_MAX_DEPTH
            or int(n_codes) > ONEHOT_MAX_CODES):
        raise ValueError(f"{name}: at most {GB_MAX_CODE_BITS} code planes, "
                         f"depth {ONEHOT_MAX_DEPTH} and {ONEHOT_MAX_CODES} "
                         "codes")
    dev = valid.device
    if dev.type == "cpu":
        return groupby_codes_plain(code_planes, valid, planes, n_codes,
                                   signed)
    g = int(n_codes)
    hist = torch.zeros((_hist_rows(depth, signed), g), dtype=torch.int32,
                       device=dev)
    if s * w:
        _launch(name, "pt_groupby_onehot",
                code_planes.data_ptr(), code_planes.stride(0), cb,
                valid.data_ptr(), valid.stride(0),
                None if planes is None else planes.data_ptr(),
                0 if planes is None else planes.stride(0), depth, s, w, g,
                int(bool(signed)), hist.data_ptr())
    return _split_hist(hist, depth, signed)


def _hist_inputs(name: str, code_planes, valid, planes, n_codes):
    """The checks both one-pass histograms share: (S, CB, W) code
    planes, (S, W) valid, (S, 2+d, W) planes or None, each with any
    shard stride, n_codes >= 1 and int32-exact totals.  Returns
    (S, CB, W, d)."""
    dev = valid.device
    _check(name, code_planes, 3, dev, any_shard_stride=True)
    _check(name, valid, 2, dev, any_shard_stride=True)
    s, cb, w = code_planes.shape
    if valid.shape != (s, w):
        raise ValueError(f"{name}: valid {tuple(valid.shape)} vs code "
                         f"planes {tuple(code_planes.shape)}")
    depth = 0
    if planes is not None:
        _check(name, planes, 3, dev, any_shard_stride=True)
        if planes.shape[0] != s or planes.shape[2] != w or planes.shape[1] < 3:
            raise ValueError(f"{name}: planes {tuple(planes.shape)} vs code "
                             f"planes {tuple(code_planes.shape)}")
        depth = planes.shape[1] - 2
    if int(n_codes) < 1:
        raise ValueError(f"{name}: n_codes must be >= 1")
    _check_int32_totals(name, s, w)
    return s, cb, w, depth


def _split_hist(hist: torch.Tensor, depth: int, signed: bool):
    """(K, G) table → counts, nn, pos (G, d), neg (G, d); nn/pos/neg
    None without planes, neg zero when unsigned."""
    counts = hist[0]
    if depth == 0:
        return counts, None, None, None
    pos = hist[2:2 + depth].T.contiguous()
    neg = (hist[2 + depth:].T.contiguous() if signed
           else torch.zeros_like(pos))
    return counts, hist[1], pos, neg


def groupby_sum(stacks, sel: torch.Tensor, planes: torch.Tensor | None = None,
                signed: bool = True):
    """Per-combo GroupBy count and Sum partials: stacks nf x (R_f, S, W),
    sel (C, nf) int32 row indices, planes (S, 2+d, W) or None →
    counts (C,), nn (C,), pos (C, d), neg (C, d) int32 (nn/pos/neg None
    without planes; neg zero when ``signed`` is False)."""
    name = "groupby_sum"
    stacks = list(stacks)
    dev = sel.device
    nf = len(stacks)
    if not 1 <= nf <= GB_MAX_FIELDS:
        raise ValueError(f"{name}: 1 to {GB_MAX_FIELDS} fields, got {nf}")
    for st in stacks:
        _check(name, st, 3, dev)
    s, w = stacks[0].shape[1:]
    if any(st.shape[1:] != (s, w) for st in stacks):
        raise ValueError(f"{name}: stacks differ in (S, W): "
                         f"{[tuple(st.shape) for st in stacks]}")
    _check(name, sel, 2, dev)
    if sel.shape[1] != nf:
        raise ValueError(f"{name}: sel {tuple(sel.shape)} for {nf} fields")
    depth = 0
    if planes is not None:
        _check(name, planes, 3, dev)
        if planes.shape[0] != s or planes.shape[2] != w or planes.shape[1] < 3:
            raise ValueError(f"{name}: planes {tuple(planes.shape)} vs "
                             f"stacks (S, W) = ({s}, {w})")
        depth = planes.shape[1] - 2
    if depth > GB_MAX_DEPTH:
        raise ValueError(f"{name}: depth {depth} > {GB_MAX_DEPTH}")
    _check_int32_totals(name, s, w)
    c = sel.shape[0]
    if c:
        rows = torch.tensor([st.shape[0] for st in stacks], dtype=torch.int32,
                            device=dev)
        if bool(((sel < 0) | (sel >= rows)).any()):
            raise ValueError(f"{name}: sel row index out of range")
    if dev.type == "cpu":
        return groupby_sum_plain(stacks, sel, planes, signed)
    if s * ((w + 255) // 256) > _GRID_MAX:
        raise ValueError(f"{name}: too many shards for one launch")
    counts = torch.zeros(c, dtype=torch.int32, device=dev)
    nn = pos = neg = None
    if depth:
        nn = torch.zeros(c, dtype=torch.int32, device=dev)
        pos = torch.zeros((c, depth), dtype=torch.int32, device=dev)
        neg = torch.zeros((c, depth), dtype=torch.int32, device=dev)
    if c and s * w:
        ptrs = (_P * nf)(*[st.data_ptr() for st in stacks])
        n_rows = (_I * nf)(*[st.shape[0] for st in stacks])
        _launch(name, "pt_groupby_sum", ptrs, n_rows, nf, sel.data_ptr(), c,
                None if planes is None else planes.data_ptr(), depth, s, w,
                int(bool(signed)), counts.data_ptr(),
                None if nn is None else nn.data_ptr(),
                None if pos is None else pos.data_ptr(),
                None if neg is None else neg.data_ptr())
    return counts, nn, pos, neg


# one row of assemble_pages' page table (csrc/page_kernels.cu PageDesc):
# kind, dense, coords, n_coords, run starts, run lens, n_runs, first
# output lane, lanes written, padding
_PAGE_KINDS = {"dense": 0, "packed": 1, "run": 2}
_PAGE_DESC = 10
# words of one tile (csrc/page_kernels.cu kTileWords); the most tiles of a
# page that one block takes (dense, encoded), fewer where a stack's tiles
# of a kind would give the card fewer than _PAGE_MIN_BLOCKS blocks (about
# four waves of two blocks an SM on an H100)
_PAGE_TILE_WORDS = 8192
_PAGE_RUN_TILES = (2, 8)
_PAGE_MIN_BLOCKS = 1024


def _payload(name: str, t: torch.Tensor, device) -> int:
    if t.dtype != torch.int32 or t.ndim != 1 or not t.is_contiguous() \
            or t.device != device:
        raise ValueError(f"{name}: expected a contiguous 1-D int32 payload "
                         f"on {device}, got {tuple(t.shape)} {t.dtype} on "
                         f"{t.device}")
    return t.data_ptr()


def _pages_device(pages):
    first = pages[0]
    return (first if isinstance(first, torch.Tensor) else first.coords).device


def page_tiles(n_lanes, w: int) -> np.ndarray:
    """Tiles of _PAGE_TILE_WORDS words of each page (the last shorter)."""
    return -(-np.asarray(n_lanes, dtype=np.int64) * int(w) // _PAGE_TILE_WORDS)


def page_runs(tiles, dense) -> tuple:
    """Tiles a block takes of a dense and of an encoded page: at most
    _PAGE_RUN_TILES, and fewer for a kind whose tiles would otherwise
    make fewer than _PAGE_MIN_BLOCKS blocks."""
    dense = np.asarray(dense, dtype=bool)
    return tuple(int(min(most, max(1, int(tiles[kind].sum())
                                   // _PAGE_MIN_BLOCKS)))
                 for most, kind in zip(_PAGE_RUN_TILES, (dense, ~dense)))


def page_plan(n_lanes, dense, w: int, run_tiles=None) -> np.ndarray:
    """assemble_pages' grid: a (G, 3) int64 array, one row a block, of
    (page, first tile, tiles).  Each page's tiles (``page_tiles``) are
    cut into runs of ``run_tiles`` (dense, encoded) tiles, by default
    ``page_runs``, in page order, and a block takes a run.  ``n_lanes``
    and ``dense`` have one entry a page."""
    dense = np.asarray(dense, dtype=bool)
    tiles = page_tiles(n_lanes, w)
    if run_tiles is None:
        run_tiles = page_runs(tiles, dense)
    run = np.where(dense, run_tiles[0], run_tiles[1]).astype(np.int64)
    runs = -(-tiles // run)
    page = np.repeat(np.arange(tiles.size, dtype=np.int64), runs)
    first = (np.arange(page.size, dtype=np.int64)
             - np.repeat(np.cumsum(runs) - runs, runs)) * run[page]
    return np.stack([page, first, np.minimum(run[page], tiles[page] - first)],
                    axis=1)


def page_table(pages, shape: tuple, page_lanes: int):
    """assemble_pages' 1-D int64 device table of ``pages``: one
    _PAGE_DESC row a page, each page checked here, then the grid's
    ``page_plan``; None for pages on the CPU, whose plain version needs
    none.  A caller that keeps the pages may keep the table and pass it
    to every assemble_pages of them."""
    name = "assemble_pages"
    w = int(shape[-1])
    lanes = int(np.prod(shape[:-1], dtype=np.int64))
    _page_lanes(lanes, page_lanes, len(pages))
    if not pages:
        raise ValueError(f"{name}: no pages")
    device = _pages_device(pages)
    if device.type == "cpu":
        return None
    table = np.zeros((len(pages), _PAGE_DESC), dtype=np.int64)
    for i, p in enumerate(pages):
        row = table[i]
        row[7] = i * page_lanes
        row[8] = min(page_lanes, lanes - i * page_lanes)
        if isinstance(p, torch.Tensor):
            _check(name, p, 2, device)
            if tuple(p.shape) != (page_lanes, w):
                raise ValueError(f"{name}: page {tuple(p.shape)}, expected "
                                 f"({page_lanes}, {w})")
            row[0], row[1] = _PAGE_KINDS["dense"], p.data_ptr()
            continue
        if p.kind not in ("packed", "run"):
            raise ValueError(f"{name}: unknown page kind {p.kind!r}")
        row[0] = _PAGE_KINDS[p.kind]
        row[2] = _payload(name, p.coords, device)
        row[3] = p.coords.numel()
        if p.kind == "run":
            row[4] = _payload(name, p.run_starts, device)
            row[5] = _payload(name, p.run_lens, device)
            row[6] = p.run_starts.numel()
            if p.run_lens.numel() != row[6]:
                raise ValueError(f"{name}: run starts and lengths differ")
    plan = page_plan(table[:, 8], table[:, 0] == _PAGE_KINDS["dense"], w)
    return torch.from_numpy(np.concatenate([table.reshape(-1),
                                            plan.reshape(-1)])).to(device)


def assemble_pages(pages, shape: tuple, page_lanes: int,
                   table=None) -> torch.Tensor:
    """A paged stack's words from its pages: shape (lead..., W), lanes =
    prod(lead), page i holding lanes [i*page_lanes, (i+1)*page_lanes).
    A page is a dense (page_lanes, W) int32 tensor or an encoded page
    (``kind`` "packed" with its uint32 ``coords`` as int32, or "run"
    with ``run_starts``, ``run_lens`` and the residual ``coords``), its
    payload pow2-padded with sentinels.  One launch writes every lane,
    the last page's padding and every sentinel dropped.  ``table`` is
    the pages' ``page_table``, kept by the caller; without it the table
    is built (and each page checked) here."""
    name = "assemble_pages"
    shape = tuple(int(d) for d in shape)
    w = shape[-1]
    lanes = int(np.prod(shape[:-1], dtype=np.int64))
    _page_lanes(lanes, page_lanes, len(pages))
    if not pages:
        raise ValueError(f"{name}: no pages")
    device = _pages_device(pages)
    if device.type == "cpu":
        return assemble_pages_plain(pages, shape, page_lanes)
    t = page_table(pages, shape, page_lanes) if table is None else table
    # the grid: one row of three a block past the descriptors
    n_blocks, rest = divmod(t.numel() - len(pages) * _PAGE_DESC, 3)
    if (t.dtype != torch.int64 or t.device != device or t.ndim != 1
            or rest or n_blocks < (1 if lanes and w else 0)):
        raise ValueError(f"{name}: a table of {tuple(t.shape)} {t.dtype} on "
                         f"{t.device} for {len(pages)} pages on {device}")
    out = torch.empty((lanes, w), dtype=torch.int32, device=device)
    if lanes and w:
        _launch(name, "pt_assemble_pages", t.data_ptr(), len(pages), n_blocks,
                out.data_ptr(), w)
    return out.reshape(shape)


# ---------------------------------------------------------------------------
# the ragged program's page-table reads: a bucket of dense (page_lanes, W)
# pages viewed as one concatenated (P * page_lanes, W) array
# ---------------------------------------------------------------------------

def _bucket_shape(name: str, pages, checked: bool = False) -> tuple:
    """(page_lanes, W, device) of a bucket: dense contiguous int32 pages
    of one shape on one device, each checked unless ``checked`` (the
    pages of a kept ``gather_table``, which checked them)."""
    if not pages:
        raise ValueError(f"{name}: no pages")
    first = pages[0]
    if not isinstance(first, torch.Tensor) or first.ndim != 2:
        raise ValueError(f"{name}: a bucket holds dense (page_lanes, W) "
                         f"pages")
    shape = tuple(first.shape)
    for p in (pages[:1] if checked else pages):
        if not isinstance(p, torch.Tensor) or tuple(p.shape) != shape:
            raise ValueError(f"{name}: pages of differing shapes, expected "
                             f"{shape}")
        _check(name, p, 2, first.device)
    return shape[0], shape[1], first.device


def gather_table(pages) -> torch.Tensor | None:
    """concat_gather's and segment_count's device table of a bucket: the
    pages' base addresses, int64, one a page, each page checked here;
    None for pages on the CPU, whose plain versions need none.  A caller
    that keeps the pages may keep the table and pass it to every read
    of them."""
    _pl, _w, device = _bucket_shape("gather_table", pages)
    if device.type == "cpu":
        return None
    return torch.tensor([p.data_ptr() for p in pages], dtype=torch.int64,
                        device=device)


def _lane_param(name: str, t, n_lanes: int, device, what: str):
    """An int32 (L,) index array on the pages' device.  Host indices
    (numpy or a CPU tensor) are checked against ``n_lanes`` here, then
    uploaded; device ones go as they are (the kernels read a lane
    outside the bucket as zeros)."""
    if isinstance(t, np.ndarray):
        t = torch.from_numpy(np.ascontiguousarray(t, dtype=np.int32))
    if t.dtype != torch.int32 or t.ndim != 1:
        raise ValueError(f"{name}: {what} must be a 1-D int32 array, got "
                         f"{tuple(t.shape)} {t.dtype}")
    if t.device.type == "cpu":
        if what == "lane_idx" and t.numel() and (
                int(t.min()) < 0 or int(t.max()) >= n_lanes):
            raise ValueError(f"{name}: lane_idx outside the bucket's "
                             f"{n_lanes} lanes")
        return t.contiguous().to(device)
    if t.device != device:
        raise ValueError(f"{name}: {what} on {t.device}, pages on {device}")
    return t.contiguous()


def _table_ok(name: str, t: torch.Tensor, n_pages: int, device) -> None:
    if (t.dtype != torch.int64 or t.ndim != 1 or t.numel() != n_pages
            or t.device != device):
        raise ValueError(f"{name}: a table of {tuple(t.shape)} {t.dtype} on "
                         f"{t.device} for {n_pages} pages on {device}")


def concat_gather_plain(pages, lane_idx) -> torch.Tensor:
    """Plain version of concat_gather: torch.cat(pages)[lane_idx]."""
    flat = torch.cat(list(pages)) if len(pages) > 1 else pages[0]
    return flat[torch.as_tensor(lane_idx).to(torch.int64)]


def segment_count_plain(pages, lane_idx, seg_ids, nseg: int) -> torch.Tensor:
    """Plain version of segment_count: the gathered lanes' SWAR popcounts
    (bm.popcount_words) summed into their segments with index_add_; ids
    outside [0, nseg) are dropped."""
    lanes = concat_gather_plain(pages, lane_idx)
    pc = bm.popcount_words(lanes).sum(dim=-1, dtype=torch.int64)
    seg = torch.as_tensor(seg_ids).to(torch.int64)
    keep = (seg >= 0) & (seg < nseg)
    out = torch.zeros(int(nseg), dtype=torch.int64, device=lanes.device)
    return out.index_add_(0, seg[keep], pc[keep])


def concat_gather(pages, lane_idx, table=None) -> torch.Tensor:
    """(L, W) int32 whose row i is lane ``lane_idx[i]`` of the bucket
    ``pages`` (dense (page_lanes, W) int32 pages, viewed as one
    concatenated array that is never built).  ``table`` is the pages'
    ``gather_table``, kept by the caller (its pages are then not
    checked again); without it the table is built here."""
    name = "concat_gather"
    page_lanes, w, device = _bucket_shape(name, pages, table is not None)
    if device.type == "cpu":
        return concat_gather_plain(pages, lane_idx)
    idx = _lane_param(name, lane_idx, len(pages) * page_lanes, device,
                      "lane_idx")
    t = gather_table(pages) if table is None else table
    _table_ok(name, t, len(pages), device)
    n = idx.numel()
    if n > _GRID_MAX:
        raise ValueError(f"{name}: too many lanes for one launch")
    out = torch.empty((n, w), dtype=torch.int32, device=device)
    if n and w:
        _launch(name, "pt_concat_gather", t.data_ptr(), len(pages),
                page_lanes, idx.data_ptr(), n, out.data_ptr(), w)
    return out


def segment_count(pages, lane_idx, seg_ids, nseg: int,
                  table=None) -> torch.Tensor:
    """(nseg,) int64: row s sums popcount(lane lane_idx[i]) of the bucket
    ``pages`` over every i with ``seg_ids[i] == s``; ids outside [0,
    nseg) are dropped (a padded index array may point its padding past
    the last segment).  One pass over the lanes; none is materialised."""
    name = "segment_count"
    page_lanes, w, device = _bucket_shape(name, pages, table is not None)
    if device.type == "cpu":
        return segment_count_plain(pages, lane_idx, seg_ids, nseg)
    idx = _lane_param(name, lane_idx, len(pages) * page_lanes, device,
                      "lane_idx")
    seg = _lane_param(name, seg_ids, 0, device, "seg_ids")
    if seg.numel() != idx.numel():
        raise ValueError(f"{name}: {idx.numel()} lanes but {seg.numel()} "
                         f"segment ids")
    t = gather_table(pages) if table is None else table
    _table_ok(name, t, len(pages), device)
    n = idx.numel()
    if n > _GRID_MAX:
        raise ValueError(f"{name}: too many lanes for one launch")
    out = torch.zeros(int(nseg), dtype=torch.int64, device=device)
    if n and w and nseg > 0:
        _launch(name, "pt_segment_count", t.data_ptr(), len(pages),
                page_lanes, idx.data_ptr(), seg.data_ptr(), n, int(nseg),
                out.data_ptr(), w)
    return out


# ---------------------------------------------------------------------------
# host helpers around the histogram (numpy)
# ---------------------------------------------------------------------------

def minmax_from_table(mm, depth: int, op: str):
    """Host combiner for the (4, G) Min/Max magnitude table: per group,
    max = max_mag_pos when any non-negative member exists, else
    -min_mag_neg; min = -max_mag_neg when any negative member exists,
    else min_mag_pos.  Returns (values (G,) int64, has (G,) bool)."""
    mm = np.asarray(mm, dtype=np.int64)
    big = 1 << depth
    mxp, mnp_, mxn, mnn = mm[0], mm[1], mm[2], mm[3]
    if op == "max":
        vals = np.where(mxp >= 0, mxp, -mnn)
        has = (mxp >= 0) | (mnn < big)
    else:
        vals = np.where(mxn >= 0, -mxn, mnp_)
        has = (mxn >= 0) | (mnp_ < big)
    return vals, has


def _value_hist_codes(planes: torch.Tensor, filter_words):
    """The planes-to-code layout of the value histogram, owned here
    alone: the code planes are the stack's own sign and magnitude
    planes, ``planes[:, 1:]`` as a view (no copy), so the sign is the
    LOW code bit and code = 2*|v| + sign; validity is exists AND the
    filter.  Returns (code planes, valid, n_codes)."""
    valid = planes[:, 0]
    if filter_words is not None:
        valid = valid & filter_words
    return planes[:, 1:], valid, 1 << (planes.shape[1] - 1)


def bsi_value_hist(planes: torch.Tensor, filter_words=None, gb=None):
    """Per-value histogram of a BSI stack through one of the one-pass
    histograms ``gb`` (groupby_fused unless given): planes (S, 2+d, W),
    filter_words (S, W) or None → (pos (2^d,), neg (2^d,)) int32,
    pos[v] = columns holding +v, neg[v] = columns holding -v.
    Distinct, Min/Max and Range counts derive from it without decoding
    a column."""
    codes, valid, n_codes = _value_hist_codes(planes, filter_words)
    counts = (gb or groupby_fused)(codes, valid, None, n_codes)[0]
    return counts[0::2].contiguous(), counts[1::2].contiguous()


def bsi_value_hist_plain(planes: torch.Tensor, filter_words=None):
    """Plain version of bsi_value_hist (groupby_codes_plain)."""
    codes, valid, n_codes = _value_hist_codes(planes, filter_words)
    counts = groupby_codes_plain(codes, valid, None, n_codes)[0]
    return counts[0::2].contiguous(), counts[1::2].contiguous()


def range_count_from_hist(pos, neg, lo: int, hi: int) -> int:
    """Columns whose value lies in [lo, hi], exact, from the value
    histogram's pos/neg magnitude counts."""
    pos = np.asarray(pos, dtype=np.int64)
    neg = np.asarray(neg, dtype=np.int64)
    total = 0
    if hi >= 0:
        total += int(pos[max(lo, 0):hi + 1].sum())
    if lo < 0:
        nlo, nhi = max(-hi, 1), -lo           # magnitudes of negatives
        if nlo <= nhi:
            total += int(neg[nlo:nhi + 1].sum())
    return total


def distinct_from_hist(pos, neg) -> list[int]:
    """Sorted distinct signed values present in the value histogram
    (-0 cannot occur: only v < 0 carries the sign)."""
    pos = np.asarray(pos)
    neg = np.asarray(neg)
    vals = [-int(v) for v in np.nonzero(neg)[0][::-1] if v > 0]
    vals += [int(v) for v in np.nonzero(pos)[0]]
    return vals


def groupby_onepass_hbm_bytes(n_shards: int, width_words: int,
                              code_bits: int, depth: int = 0,
                              has_filter: bool = False,
                              signed: bool = True) -> int:
    """Bytes the one-pass histogram must read: code planes + valid
    plane, the BSI stack (its sign plane only when signed) and the
    filter words, each once."""
    per_shard = (code_bits + 1) + ((1 + depth + int(signed)) if depth else 0) \
        + (1 if has_filter else 0)
    return 4 * n_shards * width_words * per_shard


def groupby_percombo_hbm_bytes(n_shards: int, width_words: int,
                               n_rows: int, depth: int = 0,
                               signed: bool = True) -> int:
    """Bytes the per-combo kernel must read: each distinct stack row
    that sel references once (a block walks every combo over one word
    chunk, so a row shared by combos is read again from cache), the
    plane stack (its sign plane only when signed) once."""
    return 4 * n_shards * width_words * (
        n_rows + ((1 + depth + int(signed)) if depth else 0))
