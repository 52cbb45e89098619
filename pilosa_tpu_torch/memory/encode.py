"""Sparse page encodings: roaring's containers on the paged stack.

The reference keeps three container types per 64Ki-column chunk (array,
bitmap, run) because dense bitmaps waste memory and bandwidth on sparse
data.  The port's device unit is the stack-cache page
(memory/pages.py), a (page_lanes, W) block of uint32 words, and this
module picks, per page, between

- **dense**  — the page as it is (the only kind with a word-patch path),
- **packed** — the sorted coordinates of the set bits, one uint32 a bit
  (the flat bit offset inside the page), padded to a power of two with
  an out-of-range sentinel,
- **run**    — word runs of all-ones words (sorted (start, len) int32
  pairs over the flat word space) plus the residual set bits outside
  them as a packed coordinate tail.

A page keeps its identity (its lanes, its place in the ledger, eviction,
patching and prefetch); only its resident bytes change, and the ledger
charges an encoded page its true size.  ``expand()`` gives the dense
block back bit for bit through the ``assemble_pages`` kernel.

Decision rule, per page, from its host words: the cheapest sparse
candidate must cost at most ``_DENSE_FRAC`` of the dense page to enter,
and a page that is already sparse goes dense again only past a 1.5x
looser bound (hysteresis).  The stats catalog's density of a field
skips the scan for clearly dense fields.

The host arrays equal the JAX package's element for element.  The
switches go through :func:`configure` only (the JAX package's
``PILOSA_TPU_SPARSE_FORMAT`` does not reach the port).
"""

from __future__ import annotations

import numpy as np
import torch

_FULL = np.uint32(0xFFFFFFFF)

_ENABLED = True
_DENSE_FRAC = 0.5
_LEAVE_RATIO = 1.5
# a field the stats catalog pins inside this density band skips the
# per-page scan: packed cannot pay above ~1/64 and runs only near 1
_HINT_DENSE_LO = 0.2
_HINT_DENSE_HI = 0.9
# floor of the pow2-padded payload lengths
_PAD_FLOOR = 8


def enabled() -> bool:
    return _ENABLED


def configure(enabled: bool | None = None,
              dense_frac: float | None = None):
    """The sparse-format switches; None leaves a switch as it is."""
    global _ENABLED, _DENSE_FRAC
    if enabled is not None:
        _ENABLED = bool(enabled)
    if dense_frac is not None and dense_frac > 0:
        _DENSE_FRAC = float(dense_frac)


def _pow2(n: int) -> int:
    n = max(int(n), _PAD_FLOOR)
    return 1 << (n - 1).bit_length()


def _positions(words_at: np.ndarray, words: np.ndarray) -> np.ndarray:
    """Sorted flat bit offsets of the set bits of ``words``, the nonzero
    words at sorted flat positions ``words_at`` (LSB first inside each
    word, as ops/bitmap.py packs them): a sparse page costs its set
    words, not its 2^25 bits."""
    bits = np.unpackbits(np.ascontiguousarray(words).view(np.uint8),
                         bitorder="little").reshape(-1, 32)
    word, bit = np.nonzero(bits)
    return (words_at[word] * 32 + bit).astype(np.uint32)


def _to_device(a, device) -> torch.Tensor:
    """A host payload (uint32 coordinates or int32 runs) → an int32
    tensor with the same bits on ``device``."""
    if isinstance(a, torch.Tensor):
        return a.to(device)
    arr = np.ascontiguousarray(a)
    if arr.dtype == np.uint32:
        arr = arr.view(np.int32)
    return torch.from_numpy(arr).to(device)


class EncodedPage:
    """One page's sparse payload.  ``coords`` / ``run_starts`` /
    ``run_lens`` start as host numpy arrays and move to the device with
    :meth:`to_device` (int32 tensors carrying the same bits).
    ``lane_counts``, the per-lane popcounts taken at encode time, stay
    on the host: they answer the engine's packed Count and TopN arms
    without the device."""

    __slots__ = ("kind", "page_lanes", "width_words", "coords",
                 "run_starts", "run_lens", "lane_counts", "n_valid",
                 "n_runs", "host_positions", "_nbytes")

    def __init__(self, kind: str, page_lanes: int, width_words: int,
                 coords, run_starts, run_lens,
                 lane_counts: np.ndarray, n_valid: int, n_runs: int):
        self.kind = kind                    # "packed" | "run"
        self.page_lanes = int(page_lanes)
        self.width_words = int(width_words)
        self.coords = coords                # sentinel-padded uint32
        self.run_starts = run_starts        # sentinel-padded int32
        self.run_lens = run_lens            # zero-padded int32
        self.lane_counts = lane_counts      # host (page_lanes,) int64
        self.n_valid = int(n_valid)         # true coordinate count
        self.n_runs = int(n_runs)
        # a packed page keeps its sorted positions on the host (set at
        # encode time), for the packed set-op Count arm
        self.host_positions: np.ndarray | None = None
        self._nbytes: int | None = None

    def positions(self) -> "np.ndarray | None":
        """Sorted distinct flat set-bit offsets, host int64 (packed
        pages only)."""
        if self.kind != "packed":
            return None
        if self.host_positions is None:
            c = self.coords
            if isinstance(c, torch.Tensor):
                c = c.cpu().numpy().view(np.uint32)
            self.host_positions = np.asarray(c, dtype=np.int64)[
                :self.n_valid]
        return self.host_positions

    @property
    def nbytes(self) -> int:
        """True resident bytes (what the ledger charges)."""
        if self._nbytes is None:
            n = int(self.coords.nbytes)
            if self.run_starts is not None:
                n += int(self.run_starts.nbytes) + int(self.run_lens.nbytes)
            self._nbytes = n
        return self._nbytes

    @property
    def shape(self) -> tuple:
        return (self.page_lanes, self.width_words)

    def bit_count(self) -> int:
        return int(self.lane_counts.sum())

    def to_device(self, device) -> "EncodedPage":
        """Move the payloads onto ``device`` (in place)."""
        self.coords = _to_device(self.coords, device)
        if self.run_starts is not None:
            self.run_starts = _to_device(self.run_starts, device)
            self.run_lens = _to_device(self.run_lens, device)
        return self

    def expand(self) -> torch.Tensor:
        """The dense (page_lanes, W) int32 block, bit for bit."""
        from pilosa_tpu_torch.ops import bitmap as bm
        if self.kind == "packed":
            return bm.expand_coords(self.coords, self.page_lanes,
                                    self.width_words)
        return bm.expand_runs(self.run_starts, self.run_lens, self.coords,
                              self.page_lanes, self.width_words)


def is_encoded(page) -> bool:
    return isinstance(page, EncodedPage)


def page_kind(page) -> str:
    return page.kind if isinstance(page, EncodedPage) else "dense"


def page_nbytes(page) -> int:
    """True byte size of a page (dense tensor or encoded)."""
    return int(page.nbytes)


def moved(page, device):
    """The page on ``device``: itself where it is there already, else a
    copy (an encoded page's payloads copied, its host state shared).
    The cached page is never moved."""
    if isinstance(page, EncodedPage):
        if page.coords.device == torch.device(device):
            return page
        out = EncodedPage(page.kind, page.page_lanes, page.width_words,
                          page.coords, page.run_starts, page.run_lens,
                          page.lane_counts, page.n_valid, page.n_runs)
        out.host_positions = page.host_positions
        return out.to_device(device)
    return page.to(device)


def to_dense(page):
    """An encoded page expanded; a dense one as it is."""
    return page.expand() if isinstance(page, EncodedPage) else page


def encode_block(block: np.ndarray, prev_kind: str | None = None,
                 density_hint: float | None = None):
    """An encoding for one host page block: an :class:`EncodedPage`
    (host arrays; the caller moves them to the device) or None to keep
    the block dense.  ``prev_kind`` is the page's current encoding
    (hysteresis); ``density_hint`` the stats catalog's density of the
    field, used only to skip the scan for clearly dense fields."""
    if not _ENABLED:
        return None
    pl, w = block.shape
    total_bits = pl * w * 32
    if total_bits >= 1 << 32:
        return None  # coordinates are uint32
    if (density_hint is not None and prev_kind in (None, "dense")
            and _HINT_DENSE_LO <= density_hint <= _HINT_DENSE_HI):
        return None
    dense_b = int(block.nbytes)
    flat = np.ascontiguousarray(block, dtype=np.uint32).reshape(-1)
    limit = _DENSE_FRAC if prev_kind in (None, "dense") else min(
        _DENSE_FRAC * _LEAVE_RATIO, 0.95)
    full = flat == _FULL
    n_full = int(np.count_nonzero(full))
    # every nonzero word holds a bit, and every one that is not full a
    # residual bit: past the limit with these bounds, neither candidate
    # can pay (the usual dense page ends here, before any popcount)
    nz = int(np.count_nonzero(flat))
    if min(4 * _pow2(nz), 8 * _PAD_FLOOR + 4 * _pow2(nz - n_full)) \
            > limit * dense_b:
        return None
    nzw = np.flatnonzero(flat != 0)   # a bool scan: ~4x faster than on words
    vals = flat[nzw]
    pc = np.bitwise_count(vals)
    nbits = int(pc.sum(dtype=np.int64))
    lane_counts = np.bincount(nzw // w, weights=pc,
                              minlength=pl).astype(np.int64)
    n_resid = nbits - 32 * n_full
    packed_b = 4 * _pow2(nbits)
    edges = (np.flatnonzero(np.diff(
        np.concatenate(([False], full, [False])).astype(np.int8)))
        if n_full else np.zeros(0, dtype=np.int64))
    n_runs = edges.size // 2
    run_b = 8 * _pow2(n_runs) + 4 * _pow2(n_resid)
    kind, best_b = (("packed", packed_b) if packed_b <= run_b
                    else ("run", run_b))
    if best_b > limit * dense_b:
        return None
    if kind == "packed":
        pos = _positions(nzw, vals)
        coords = np.full(_pow2(pos.size), total_bits, dtype=np.uint32)
        coords[:pos.size] = pos
        enc = EncodedPage("packed", pl, w, coords, None, None,
                          lane_counts, pos.size, 0)
        enc.host_positions = pos.astype(np.int64)
        return enc
    starts, ends = edges[0::2], edges[1::2]
    run_starts = np.full(_pow2(starts.size), pl * w, dtype=np.int32)
    run_lens = np.zeros(_pow2(starts.size), dtype=np.int32)
    run_starts[:starts.size] = starts
    run_lens[:starts.size] = ends - starts
    part = ~full[nzw]
    pos = _positions(nzw[part], vals[part])
    coords = np.full(_pow2(pos.size), total_bits, dtype=np.uint32)
    coords[:pos.size] = pos
    return EncodedPage("run", pl, w, coords, run_starts, run_lens,
                       lane_counts, pos.size, int(starts.size))
