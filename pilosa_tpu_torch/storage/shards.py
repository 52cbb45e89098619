"""Per-index shard storage: one RBF file a shard.

The reference's dbshard layout (dbshard.go:1-30): one RBF database a
(index, shard) under ``<index>/backends/shard.%04d.rbf``, holding one
bitmap ``<field>/<view>`` a fragment, whose container keys are
``row * tiles_per_row + tile`` (a row of ``width`` bits is
``max(1, width >> 16)`` 65536-bit tiles; a row narrower than a tile is
padded to one on write and sliced on read).  The JAX package writes the
same files.

The host fragments stay the query plane's source; this layer is their
durability.  ``write_fragments`` persists a shard's dirty rows in one
write transaction, and a fragment loads its rows from here when it is
made.  A WAL past ``CHECKPOINT_WAL_BYTES`` is checkpointed after the
commit (the checkpoint-on-size of rbf/db.go).

Two fault points sit after the commit of ``write_fragments``, as in the
JAX package: ``wal-torn`` closes the shard's handle and cuts the WAL
mid-frame (the commit never replays), and ``crash-pre-checkpoint`` dies
after the WAL is durable but before the rows count as synced.
"""

from __future__ import annotations

import os
import re
import shutil
import threading

import numpy as np

from pilosa_tpu_torch.obs import faults
from pilosa_tpu_torch.ops import bitmap as bm
from pilosa_tpu_torch.shardwidth import SPARSE_MAX
from pilosa_tpu_torch.storage import rbf

BACKENDS_DIR = "backends"
_SHARD_FILE = re.compile(r"^shard\.(\d+)\.rbf$")
CHECKPOINT_WAL_BYTES = 64 << 20


def bitmap_name(field: str, view: str) -> str:
    return f"{field}/{view}"


def tiles_per_row(width: int) -> int:
    return max(1, width >> 16)


class IndexStorage:
    """The per-shard RBF handles of one index directory."""

    def __init__(self, path: str):
        self.path = path
        self._dbs: dict[int, rbf.DB] = {}
        self._lock = threading.Lock()

    def _dir(self) -> str:
        return os.path.join(self.path, BACKENDS_DIR)

    def _shard_path(self, shard: int) -> str:
        return os.path.join(self._dir(), f"shard.{shard:04d}.rbf")

    def db(self, shard: int) -> rbf.DB:
        # one handle a shard file, ever: a second handle would replay
        # (and truncate) a WAL the first still appends to
        with self._lock:
            d = self._dbs.get(shard)
            if d is None:
                os.makedirs(self._dir(), exist_ok=True)
                d = rbf.DB(self._shard_path(shard))
                self._dbs[shard] = d
            return d

    def shards_on_disk(self) -> list[int]:
        if not os.path.isdir(self._dir()):
            return []
        return sorted(int(m.group(1)) for fn in os.listdir(self._dir())
                      if (m := _SHARD_FILE.match(fn)))

    def discover(self) -> list[tuple[str, str, int]]:
        """Every (field, view, shard) with a bitmap on disk."""
        out = []
        for shard in self.shards_on_disk():
            with self.db(shard).begin() as tx:
                for name in tx.list_bitmaps():
                    field, _, view = name.partition("/")
                    out.append((field, view, shard))
        return out

    def disk_bytes(self) -> int:
        """Bytes of every shard file and WAL of the index."""
        if not os.path.isdir(self._dir()):
            return 0
        return sum(os.path.getsize(os.path.join(self._dir(), fn))
                   for fn in os.listdir(self._dir()))

    # -- fragment IO -------------------------------------------------------

    def load_rows(self, field: str, view: str, shard: int,
                  width: int) -> dict[int, np.ndarray]:
        """Every row of a fragment, compressed as each row completes: an
        int64 array holds the sorted columns of a row of at most
        SPARSE_MAX bits, a uint32 array the packed words of a denser
        one.  At most one dense row is held uncompressed at a time."""
        nw = width // 32
        tpr = tiles_per_row(width)
        rows: dict[int, np.ndarray] = {}
        name = bitmap_name(field, view)

        def finalize(row: int, w: np.ndarray):
            if int(np.bitwise_count(w).sum()) <= SPARSE_MAX:
                rows[row] = bm.to_columns(w).astype(np.int64)
            else:
                rows[row] = w

        cur_row, cur_w = None, None
        with self.db(shard).begin() as tx:
            if not tx.has_bitmap(name):
                return rows
            for ckey, tile in tx.items(name):
                row, t = divmod(ckey, tpr)
                if row != cur_row:
                    if cur_row is not None:
                        finalize(cur_row, cur_w)
                    cur_w = np.zeros(nw, dtype=np.uint32)
                    cur_row = row
                if nw < rbf.TILE_WORDS:
                    cur_w[:] = tile[:nw]
                else:
                    cur_w[t * rbf.TILE_WORDS:(t + 1) * rbf.TILE_WORDS] = tile
        if cur_row is not None:
            finalize(cur_row, cur_w)
        return rows

    def write_fragments(self, frags) -> None:
        """Persist the dirty rows of fragments of ONE shard in one write
        transaction.  Each fragment's dirty rows are taken, and their
        words written, under the fragment's lock: a write that lands
        during the sync marks its row dirty again for the next sync.
        Rows taken by a sync that fails stay dirty.  A row written
        empty removes its containers."""
        if not frags:
            return
        shard = frags[0].shard
        if any(frag.shard != shard for frag in frags):
            raise ValueError("write_fragments takes one shard's fragments")
        db = self.db(shard)
        taken = []  # (fragment, the rows this sync took from it)
        try:
            with db.begin(write=True) as tx:
                for frag in frags:
                    name = bitmap_name(frag.field_name, frag.view_name)
                    tx.create_bitmap(name)
                    tpr = tiles_per_row(frag.width)
                    nw = frag.width // 32
                    with frag.lock:
                        rows, frag.dirty_rows = frag.dirty_rows, set()
                        taken.append((frag, rows))
                        for row in sorted(rows):
                            words = frag.row_words(row)
                            if nw < rbf.TILE_WORDS:
                                tile = np.zeros(rbf.TILE_WORDS,
                                                dtype=np.uint32)
                                tile[:nw] = words
                                tx.put(name, row, tile)
                                continue
                            for t in range(tpr):
                                tx.put(name, row * tpr + t,
                                       np.ascontiguousarray(words[
                                           t * rbf.TILE_WORDS:
                                           (t + 1) * rbf.TILE_WORDS]))
            path = self._shard_path(shard)
            if faults.take("wal-torn", path):
                self._tear_wal(shard)
                raise faults.InjectedFault("wal-torn", path)
            faults.fire("crash-pre-checkpoint", path)
        except BaseException:
            for frag, rows in taken:
                with frag.lock:
                    frag.dirty_rows |= rows
            raise
        if db.wal_size > CHECKPOINT_WAL_BYTES:
            db.checkpoint()  # skipped (False) while readers pin the WAL

    def _tear_wal(self, shard: int) -> None:
        """Enact the wal-torn fault: close the shard's handle, as a
        dying process loses it, and cut the WAL mid-frame so its last
        commit can never replay.  4 KiB is half a page: always inside
        the last frame's page image."""
        with self._lock:
            d = self._dbs.pop(shard, None)
        if d is not None:
            d.close()
        wal = self._shard_path(shard) + ".wal"
        if os.path.exists(wal):
            sz = os.path.getsize(wal)
            if sz:
                os.truncate(wal, max(0, sz - 4096))

    def delete_field_bitmaps(self, field: str) -> None:
        prefix = field + "/"
        for shard in self.shards_on_disk():
            with self.db(shard).begin(write=True) as tx:
                for name in tx.list_bitmaps():
                    if name.startswith(prefix):
                        tx.delete_bitmap(name)

    def delete_view_bitmaps(self, field: str, view: str) -> None:
        """Remove one view's bitmap from every shard file."""
        name = bitmap_name(field, view)
        for shard in self.shards_on_disk():
            with self.db(shard).begin(write=True) as tx:
                if tx.has_bitmap(name):
                    tx.delete_bitmap(name)

    def drop_shard(self, shard: int) -> None:
        """Delete one shard's file and WAL; a later write to the shard
        makes a fresh file."""
        with self._lock:
            d = self._dbs.pop(shard, None)
        if d is not None:
            d.close()
        p = self._shard_path(shard)
        for f in (p, p + ".wal"):
            if os.path.exists(f):
                os.remove(f)

    # -- lifecycle ---------------------------------------------------------

    def checkpoint_all(self) -> None:
        for d in list(self._dbs.values()):
            d.checkpoint()

    def close(self) -> None:
        with self._lock:
            dbs, self._dbs = list(self._dbs.values()), {}
        for d in dbs:
            d.close()

    def destroy(self) -> None:
        """Close and delete every shard file (index deletion)."""
        self.close()
        if os.path.isdir(self._dir()):
            shutil.rmtree(self._dir())
