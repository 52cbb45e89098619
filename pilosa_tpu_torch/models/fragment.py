"""Fragment — the data-plane unit: one bitmap per (field, view, shard).

A fragment is logically one bitmap keyed ``row*SHARD_WIDTH + col``
(fragment.go:84).  Each host row is held in one of two forms chosen by
cardinality, the in-memory analog of the reference's array/bitmap
container split (roaring/container_stash.go:46-85):

- **sparse**: a sorted int64 array of set column ids, for rows with at
  most ``SPARSE_MAX`` bits;
- **dense**: packed uint32 words, once a row crosses the threshold.

BSI views reuse the row space: row 0 = exists, row 1 = sign, rows 2..
= magnitude planes (fragment.go:34-66).

Device copies do not live here: the stacked engine
(``executor/stacked.py``) assembles (S, W) shard stacks from
``row_words``, and the per-shard engine (``executor.TileCache``)
uploads (W,) rows and (2+d, W) planes; each keeps them on its device
in its own cache, tagged with the fragment's ``(gen, version)`` stamp.

Every mutation ends in ``touch(row, lo, hi)`` once its bytes have
landed: the version moves and the delta log records the (row, word
span) it dirtied.  The log is a window of the last ``DELTA_LOG_MAX``
entries; ``deltas_since(v)`` lists the spans written after version v,
or None when the window no longer reaches back to v, and the device
caches patch those spans instead of uploading the stack again.
``bump_gen`` retires the fragment's identity: every stamp taken before
compares unequal, and a cache rebuilds.

Given ``storage`` (the index's ``storage.shards.IndexStorage``), a
fragment loads its rows from the shard's RBF file when it is made, and
``touch`` adds each written row to ``dirty_rows``, the rows the next
``Index.sync`` persists.  Every host mutation runs under the fragment's
``lock``, which the sync also holds while it takes a fragment's dirty
rows and writes their words: a sync sees each mutation whole, and a
write that lands during a sync marks its row again for the next one.
"""

from __future__ import annotations

import functools
import itertools
import threading
from collections import deque

import numpy as np

from pilosa_tpu_torch.models.cache import make_cache
from pilosa_tpu_torch.obs import faults
from pilosa_tpu_torch.ops import bitmap as bm
from pilosa_tpu_torch.storage import native_ingest
from pilosa_tpu_torch.shardwidth import (
    BSI_OFFSET_BIT,
    BSI_SIGN_BIT,
    SHARD_WIDTH,
    SPARSE_MAX,
)

# process-wide fragment generation: an identity that never repeats, so
# a device stack built from a dropped fragment can never be mistaken
# for one built from its successor
# a mutex import of at most this many distinct rows fills dense scratch
# planes in one native pass (storage/native_ingest.py mutex_fill); more
# rows take the sort path (the JAX fragment's _MUTEX_KERNEL_MAX_ROWS)
_MUTEX_FILL_MAX_ROWS = 256

_FRAG_GEN = itertools.count(1)

# process-wide mutation epoch: moves on every fragment version bump,
# fragment creation, gen retirement and schema-level deletion
# (models/index.py, models/holder.py), so one load answers "did any data
# change since I built this?".  The ragged serving program
# (executor/ragged.py) replays its cached canonical program while it is
# unchanged.  A plain int += under the GIL: a torn read can only
# under-read, which forces a rebuild and never a stale serve (the
# fragments' (gen, version) stamps stay the precise staleness test).
_MUT_EPOCH = 0


def _locked(fn):
    """Run a host mutation under the fragment's lock."""
    @functools.wraps(fn)
    def run(self, *args, **kwargs):
        with self.lock:
            return fn(self, *args, **kwargs)
    return run


def bump_mutation_epoch() -> None:
    global _MUT_EPOCH
    _MUT_EPOCH += 1


def mutation_epoch() -> int:
    return _MUT_EPOCH

# delta-log window a fragment keeps (the JAX package's
# PILOSA_TPU_DELTA_LOG_MAX default); read at each append
DELTA_LOG_MAX = 256


class Fragment:
    """Host rows of one (index, field, view, shard)."""

    def __init__(self, index: str, field: str, view: str, shard: int,
                 width: int = SHARD_WIDTH, storage=None,
                 cache_type: str = "none", cache_size: int = 50000):
        self.index_name = index
        self.field_name = field
        self.view_name = view
        self.shard = shard
        self.width = width
        self._rows: dict[int, np.ndarray] = {}    # row id -> packed words
        self._sparse: dict[int, np.ndarray] = {}  # row id -> sorted cols
        # bumped by every host mutation; device stacks compare it
        self.version = 0
        self.gen = next(_FRAG_GEN)
        bump_mutation_epoch()  # a new fragment changes read results
        # (version after the mutation, row, word_lo, word_hi) of the
        # mutations after version _delta_floor
        self._delta_log: deque = deque()
        self._delta_floor = 0
        # the non-empty row ids, sorted (None until first read), and the
        # rows written since: only those are checked again
        self._row_ids_cache: list[int] | None = None
        self._rows_touched: set[int] = set()
        # TopN rank cache (fragment.openCache, fragment.go:201): counts
        # refresh lazily for rows written since the last read, in write
        # order (LRU recency survives the batching)
        self._cache = make_cache(cache_type, cache_size)
        self._cache_stale: dict[int, None] = {}
        # rows written since the last sync (IndexStorage.write_fragments)
        self.dirty_rows: set[int] = set()
        # ((gen, version), {block: digest}) of the last block_checksums
        self._sums = None
        # held by every host mutation and by the sync of this fragment
        # (re-entrant: import_mutex and set_value call other mutations)
        self.lock = threading.RLock()
        if storage is not None:
            # int64 arrays are sorted columns, uint32 arrays packed words
            for r, w in storage.load_rows(field, view, shard,
                                          width).items():
                if w.dtype == np.int64:
                    self._sparse[r] = w
                else:
                    self._rows[r] = w
            if self._cache is not None:
                self._cache_stale.update(dict.fromkeys(self._rows))
                self._cache_stale.update(dict.fromkeys(self._sparse))

    # -- representation ----------------------------------------------------

    def _densify(self, row: int) -> np.ndarray:
        w = bm.from_columns(self._sparse.pop(row), self.width)
        self._rows[row] = w
        return w

    def _store_cols(self, row: int, arr: np.ndarray) -> None:
        self._sparse[row] = arr
        if arr.size > SPARSE_MAX:
            self._densify(row)

    def touch(self, row: int, lo: int | None = None,
              hi: int | None = None) -> None:
        """After a mutation's bytes land: the version moves and the delta
        log records the row's dirtied words [lo, hi) (the whole row when
        lo is None), one entry a mutation.  Entries past DELTA_LOG_MAX
        drop off the front, the floor rising to the dropped version.  The
        mutation epoch moves before the version, after the bytes landed:
        a reader that stamped the old epoch rebuilds."""
        bump_mutation_epoch()
        self.version += 1
        if lo is None:
            lo, hi = 0, self.width // 32
        self._rows_touched.add(row)
        self.dirty_rows.add(row)
        log = self._delta_log
        log.append((self.version, row, lo, hi))
        # chaos seam: die right after the delta entry landed, the window
        # between the in-memory write and any durability (the detail is
        # built only when the point is armed)
        if faults.armed("crash-post-append"):
            faults.fire("crash-post-append",
                        f"{self.index_name}/{self.field_name}/"
                        f"{self.view_name}/{self.shard}")
        while len(log) > DELTA_LOG_MAX:
            self._delta_floor = log.popleft()[0]
        if self._cache is not None:
            self._cache_stale.pop(row, None)
            self._cache_stale[row] = None

    def deltas_since(self, version: int):
        """The (row, word_lo, word_hi) spans of every mutation after
        `version`, or None when the log cannot prove coverage: the
        version predates the window, or this fragment never reached
        it."""
        if version < self._delta_floor or version > self.version:
            return None
        return [(r, lo, hi) for (v, r, lo, hi) in self._delta_log
                if v > version]

    def bump_gen(self, bump_epoch: bool = True) -> None:
        """Retire the fragment's cache identity: every (gen, version)
        stamp taken before compares unequal afterwards.  A batched sweep
        passes ``bump_epoch=False`` and moves the mutation epoch once,
        before the first gen moves."""
        if bump_epoch:
            bump_mutation_epoch()
        self.gen = next(_FRAG_GEN)

    def _row_mut(self, row: int) -> np.ndarray:
        """Mutable dense words of a row (densifying if needed); the
        caller calls touch() after writing."""
        w = self._rows.get(row)
        if w is None:
            w = (self._densify(row) if row in self._sparse
                 else bm.empty(self.width))
            self._rows[row] = w
        return w

    def _check_cols(self, cols: np.ndarray) -> None:
        if cols.size and (cols.min() < 0 or cols.max() >= self.width):
            raise ValueError("column id out of range")

    # -- host mutation -----------------------------------------------------

    @_locked
    def set_row_words(self, row: int, words) -> None:
        """Replace a whole row (the Store and ClearRow write path; a
        scalar fills every word); it re-compresses under the
        threshold."""
        w = bm.empty(self.width)
        w[:] = np.asarray(words, dtype=np.uint32)
        self._rows.pop(row, None)
        self._sparse.pop(row, None)
        if int(np.bitwise_count(w).sum()) <= SPARSE_MAX:
            self._sparse[row] = bm.to_columns(w).astype(np.int64)
        else:
            self._rows[row] = w
        self.touch(row)

    @_locked
    def set_bit(self, row: int, col: int) -> bool:
        """Set one bit; True if it changed (fragment.setBit)."""
        if not 0 <= col < self.width:
            raise ValueError("column id out of range")
        words = self._rows.get(row)
        if words is None:
            arr = self._sparse.get(row, np.empty(0, dtype=np.int64))
            i = int(np.searchsorted(arr, col))
            if i < arr.size and arr[i] == col:
                return False
            self._store_cols(row, np.insert(arr, i, col))
            self.touch(row, col >> 5, (col >> 5) + 1)
            return True
        b = np.uint32(1) << np.uint32(col & 31)
        if words[col >> 5] & b:
            return False
        words[col >> 5] |= b
        self.touch(row, col >> 5, (col >> 5) + 1)
        return True

    def contains(self, row: int, col: int) -> bool:
        """Whether the bit (row, col) is set."""
        words = self._rows.get(row)
        if words is None:
            arr = self._sparse.get(row)
            if arr is None:
                return False
            i = int(np.searchsorted(arr, col))
            return i < arr.size and int(arr[i]) == col
        return bool((words[col >> 5] >> np.uint32(col & 31)) & 1)

    @_locked
    def clear_bit(self, row: int, col: int) -> bool:
        words = self._rows.get(row)
        if words is None:
            arr = self._sparse.get(row)
            if arr is None:
                return False
            i = int(np.searchsorted(arr, col))
            if i >= arr.size or arr[i] != col:
                return False
            self._sparse[row] = np.delete(arr, i)
            self.touch(row, col >> 5, (col >> 5) + 1)
            return True
        b = np.uint32(1) << np.uint32(col & 31)
        if not words[col >> 5] & b:
            return False
        words[col >> 5] &= ~b
        self.touch(row, col >> 5, (col >> 5) + 1)
        return True

    @_locked
    def import_bits(self, rows, cols, clear: bool = False) -> None:
        """Bulk set/clear, one vectorised merge per distinct row
        (fragment.bulkImport semantics)."""
        rows = np.asarray(rows, dtype=np.int64)
        cols = np.asarray(cols, dtype=np.int64)
        if rows.shape != cols.shape:
            raise ValueError("rows and cols differ in length")
        self._check_cols(cols)
        order = np.argsort(rows, kind="stable")
        rows_s, cols_s = rows[order], cols[order]
        starts = np.flatnonzero(np.concatenate(
            ([True], rows_s[1:] != rows_s[:-1]))) if rows_s.size \
            else np.array([], dtype=np.int64)
        bounds = np.append(starts[1:], rows_s.size)
        for r, lo, hi in zip(rows_s[starts].tolist(), starts.tolist(),
                             bounds.tolist()):
            sel = cols_s[lo:hi]
            # the words this row's columns dirty
            wlo, whi = int(sel.min()) >> 5, (int(sel.max()) >> 5) + 1
            if r not in self._rows:
                arr = self._sparse.get(r)
                if clear:
                    if arr is None:
                        continue
                    self._sparse[r] = np.setdiff1d(arr, sel)
                elif arr is None and sel.size > SPARSE_MAX:
                    self._rows[r] = bm.from_columns(sel, self.width)
                else:
                    self._store_cols(r, np.unique(sel) if arr is None
                                     else np.union1d(arr, sel))
                self.touch(r, wlo, whi)
                continue
            mask = bm.from_columns(sel, self.width)
            words = self._rows[r]
            if clear:
                words &= ~mask
            else:
                words |= mask
            self.touch(r, wlo, whi)

    @_locked
    def import_row_words(self, row: int, words) -> None:
        """Bulk dense-row import: OR pre-packed words into a row (the
        dense analog of fragment.importRoaring, fragment.go:2038)."""
        w = self._row_mut(row)
        np.bitwise_or(w, np.asarray(words, dtype=np.uint32), out=w)
        self.touch(row)

    @_locked
    def clear_columns(self, mask_words: np.ndarray) -> bool:
        """Clear the masked columns in every row; True if any changed."""
        mask = np.asarray(mask_words, dtype=np.uint32)
        nz = np.flatnonzero(mask)
        if not nz.size:
            return False
        wlo, whi = int(nz[0]), int(nz[-1]) + 1
        changed = False
        for r, row in list(self._rows.items()):
            if (row & mask).any():
                row &= ~mask
                self.touch(r, wlo, whi)
                changed = True
        for r, arr in list(self._sparse.items()):
            hit = ((mask[arr >> 5] >> (arr & 31).astype(np.uint32))
                   & 1).astype(bool)
            if hit.any():
                self._sparse[r] = arr[~hit]
                self.touch(r, wlo, whi)
                changed = True
        return changed

    @_locked
    def import_mutex(self, rows, cols) -> None:
        """Mutex/bool bulk write: one row per column, the last write of
        a column winning; the column is cleared in every other row."""
        rows = np.asarray(rows, dtype=np.int64)
        cols = np.asarray(cols, dtype=np.int64)
        if cols.size == 0:
            return
        if rows.shape != cols.shape:
            raise ValueError("rows and cols differ in length")
        self._check_cols(cols)
        uniq, rowidx = np.unique(rows, return_inverse=True)
        if uniq.size > _MUTEX_FILL_MAX_ROWS:
            _, rev_first = np.unique(cols[::-1], return_index=True)
            keep = cols.size - 1 - rev_first
            rows, cols = rows[keep], cols[keep]
            self.clear_columns(bm.from_columns(cols, self.width))
            self.import_bits(rows, cols)
            return
        # one reverse pass, the last write of a column winning
        # (storage/csrc/scatter.cc pt_mutex_fill)
        written = bm.empty(self.width)
        scratch = np.zeros((uniq.size, self.width // 32), np.uint32)
        native_ingest.mutex_fill(written, scratch, rowidx, cols)
        self.clear_columns(written)
        for k, r in enumerate(uniq.tolist()):
            got = bm.to_columns(scratch[k])
            if got.size:
                self.import_bits(np.full(got.size, r, np.int64), got)

    # -- BSI mutation (fragment.setValueBase semantics) --------------------

    @_locked
    def set_value(self, col: int, depth: int, value: int) -> bool:
        """Write one sign-magnitude value across the bit-plane rows."""
        uval = abs(int(value))
        if uval >= (1 << depth):
            raise ValueError("value magnitude exceeds bit depth")
        changed = False
        for i in range(depth):
            op = self.set_bit if (uval >> i) & 1 else self.clear_bit
            changed |= op(BSI_OFFSET_BIT + i, col)
        changed |= self.set_bit(0, col)
        if value < 0:
            changed |= self.set_bit(BSI_SIGN_BIT, col)
        else:
            changed |= self.clear_bit(BSI_SIGN_BIT, col)
        return changed

    @_locked
    def clear_value(self, col: int, depth: int) -> bool:
        """Drop a column's value: its bit in every plane, exists first."""
        changed = False
        for r in range(2 + depth):
            changed |= self.clear_bit(r, col)
        return changed

    @_locked
    def import_values(self, cols, values, depth: int,
                      clear: bool = False) -> None:
        """Bulk BSI write (fragment.importValue): last write per column
        wins; the written columns are replaced in every plane.  ``clear``
        drops the columns' values instead (values are ignored)."""
        cols = np.asarray(cols, dtype=np.int64)
        if clear:
            if cols.size == 0:
                return
            self._check_cols(cols)
            wlo, whi = int(cols.min()) >> 5, (int(cols.max()) >> 5) + 1
            touched = bm.from_columns(cols, self.width)
            for r in range(2 + depth):
                self._row_mut(r)[:] &= ~touched
                self.touch(r, wlo, whi)
            return
        vals = np.asarray(values, dtype=np.int64).reshape(-1)
        if cols.shape != vals.shape:
            raise ValueError("cols and values differ in length")
        if cols.size == 0:
            return
        self._check_cols(cols)
        # uint64 view: INT64_MIN's magnitude 2^63 is visible, so an
        # out-of-depth value is refused instead of wrapping (the fill
        # drops such bits only as a last bound)
        mags = np.where(vals < 0, np.negative(vals), vals).view(np.uint64)
        if int(mags.max()).bit_length() > depth:
            raise ValueError(
                f"value magnitude needs {int(mags.max()).bit_length()} "
                f"bits, fragment depth is {depth}")
        wlo, whi = int(cols.min()) >> 5, (int(cols.max()) >> 5) + 1
        # one reverse pass, the last write of a column winning
        # (storage/csrc/scatter.cc pt_bsi_fill_t)
        planes = np.zeros((2 + depth, self.width // 32), np.uint32)
        native_ingest.bsi_fill(planes, cols, vals, depth)
        touched = planes[0]           # the exists plane is what was written
        for r, new in enumerate(planes):
            w = self._row_mut(r)
            w &= ~touched
            w |= new
            self.touch(r, wlo, whi)

    # -- reads -------------------------------------------------------------

    def _has_bits(self, row: int) -> bool:
        w = self._rows.get(row)
        if w is not None:
            return bool(w.any())
        arr = self._sparse.get(row)
        return arr is not None and arr.size > 0

    @property
    def row_ids(self) -> list[int]:
        """The ids of the rows holding a bit, ascending.  After writes
        only the written rows are checked again, under the fragment's
        lock: a write landing meanwhile (a replica repair or a
        resharding transfer beside a read) would otherwise change the
        set of written rows while it is walked."""
        with self.lock:
            if self._row_ids_cache is None:
                self._row_ids_cache = sorted(
                    r for r in set(self._rows) | set(self._sparse)
                    if self._has_bits(r))
                self._rows_touched.clear()
            elif self._rows_touched:
                ids = set(self._row_ids_cache)
                for r in self._rows_touched:
                    if self._has_bits(r):
                        ids.add(r)
                    else:
                        ids.discard(r)
                self._row_ids_cache = sorted(ids)
                self._rows_touched.clear()
            return list(self._row_ids_cache)

    def max_row_id(self) -> int:
        ids = self.row_ids
        return ids[-1] if ids else 0

    def row_words(self, row: int) -> np.ndarray:
        """Packed host words of a row (zeros if absent); read-only."""
        w = self._rows.get(row)
        if w is not None:
            return w
        arr = self._sparse.get(row)
        if arr is not None:
            return bm.from_columns(arr, self.width)
        return bm.empty(self.width)

    def row_columns(self, row: int) -> np.ndarray:
        """A row's set column ids, ascending, as int64."""
        w = self._rows.get(row)
        if w is not None:
            return bm.to_columns(w).astype(np.int64)
        arr = self._sparse.get(row)
        return arr.copy() if arr is not None else np.empty(0, np.int64)

    def row_count(self, row: int) -> int:
        w = self._rows.get(row)
        if w is not None:
            return int(np.bitwise_count(w).sum())
        arr = self._sparse.get(row)
        return int(arr.size) if arr is not None else 0

    def memory_bytes(self) -> int:
        """Host bytes of the fragment's rows."""
        return (sum(w.nbytes for w in self._rows.values())
                + sum(a.nbytes for a in self._sparse.values()))

    # -- node sync (fragment.go checksum blocks; online resharding) --------

    # rows a checksum block covers
    BLOCK_ROWS = 64

    @_locked
    def delta_export(self, since: int):
        """The resharding chase's unit: the current words of every row
        the delta log names above ``since``, as ``(gen, version,
        span_count, {row: words})``, or ``(gen, version, None, None)``
        when the log cannot prove coverage (the caller then diffs block
        checksums again).  Current contents, not historical patches,
        make the replay idempotent."""
        gen, version = self.gen, self.version
        spans = self.deltas_since(int(since))
        if spans is None:
            return gen, version, None, None
        rows = sorted({int(r) for r, _lo, _hi in spans})
        return gen, version, len(spans), {r: self.row_words(r).copy()
                                          for r in rows}

    @_locked
    def block_checksums(self) -> dict[int, str]:
        """A digest a row block b (rows [b*BLOCK_ROWS, (b+1)*BLOCK_ROWS))
        holding a bit, over each row's id and contents in row order,
        whatever form a row is held in: a row of at most SPARSE_MAX bits
        hashes its sorted set columns as int64, as the JAX package's
        digest does; a denser row hashes its packed words behind a
        marker (the JAX digest hashes its columns, 8 bytes a set bit,
        16 times the words' bytes for a half-full row).  So at widths up
        to SPARSE_MAX bits the digests are the JAX package's.  They are
        kept for the fragment's (gen, version): a second pass over an
        unchanged fragment hashes nothing."""
        import hashlib
        stamp = (self.gen, self.version)
        if self._sums is not None and self._sums[0] == stamp:
            return dict(self._sums[1])
        acc: dict = {}
        for r in self.row_ids:
            b = r // self.BLOCK_ROWS
            h = acc.get(b)
            if h is None:
                h = acc[b] = hashlib.blake2b(digest_size=16)
            h.update(int(r).to_bytes(8, "little"))
            arr = self._sparse.get(r)
            if arr is None:
                w = self._rows[r]
                if int(np.bitwise_count(w).sum()) > SPARSE_MAX:
                    h.update(b"words")
                    h.update(np.ascontiguousarray(w).tobytes())
                    continue
                arr = bm.to_columns(w).astype(np.int64)
            h.update(np.ascontiguousarray(arr).tobytes())
        out = {b: h.hexdigest() for b, h in acc.items()}
        self._sums = (stamp, out)
        return dict(out)

    @_locked
    def block_rows(self, block: int) -> dict[int, np.ndarray]:
        """The packed words of every non-empty row of one block."""
        lo, hi = block * self.BLOCK_ROWS, (block + 1) * self.BLOCK_ROWS
        return {r: self.row_words(r).copy() for r in self.row_ids
                if lo <= r < hi}

    @_locked
    def set_block_rows(self, block: int, rows: dict) -> None:
        """Replace one block with a peer's rows (the repair and transfer
        write); a row absent from ``rows`` is cleared.  Each row goes
        through ``set_row_words``, so the version, the delta log, the
        dirty rows and the mutation epoch move as for any write: a
        resident stack is patched and the result cache drops what the
        write made stale."""
        lo, hi = block * self.BLOCK_ROWS, (block + 1) * self.BLOCK_ROWS
        for r in [r for r in self.row_ids if lo <= r < hi]:
            if r not in rows:
                self.set_row_words(r, 0)
        for r, words in rows.items():
            if not lo <= int(r) < hi:
                raise ValueError(f"row {r} outside block {block}")
            self.set_row_words(int(r), words)

    def row_cache(self):
        """The TopN rank/LRU cache, refreshed for rows written since
        the last access (None when the cache type is none), under the
        fragment's lock (see row_ids)."""
        if self._cache is None:
            return None
        with self.lock:
            if self._cache_stale:
                for r in self._cache_stale:
                    self._cache.add(r, self.row_count(r))
                self._cache_stale = {}
        return self._cache
