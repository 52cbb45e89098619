"""On-disk extendible hash table over the buffer pool.

Reference: extendiblehash/extendiblehash.go:1 — a directory of bucket
page ids indexed by the low ``global_depth`` bits of the key hash;
buckets split (doubling the directory when a bucket at full global
depth overflows).  The sql3 layer spills large DISTINCT sets here
(opdistinct) instead of holding them in memory — this build's SQL
engine does the same above a size threshold.

Bucket page layout (8 KiB): [u16 n_entries][u16 local_depth] then
n_entries of [u16 klen][u16 vlen][key][value].
"""

from __future__ import annotations

import hashlib
import struct

from pilosa_tpu_torch.storage.bufferpool import BufferPool, PAGE_SIZE

_HDR = struct.Struct("<HH")
_ENT = struct.Struct("<HH")


def _hash(key: bytes) -> int:
    return int.from_bytes(hashlib.blake2b(key, digest_size=8).digest(),
                          "little")


class _Bucket:
    def __init__(self, page):
        self.page = page
        n, depth = _HDR.unpack_from(page.data, 0)
        self.local_depth = depth
        self.entries: list[tuple[bytes, bytes]] = []
        off = _HDR.size
        for _ in range(n):
            klen, vlen = _ENT.unpack_from(page.data, off)
            off += _ENT.size
            k = bytes(page.data[off:off + klen]); off += klen
            v = bytes(page.data[off:off + vlen]); off += vlen
            self.entries.append((k, v))

    def bytes_used(self) -> int:
        return _HDR.size + sum(_ENT.size + len(k) + len(v)
                               for k, v in self.entries)

    def write(self):
        d = self.page.data
        _HDR.pack_into(d, 0, len(self.entries), self.local_depth)
        off = _HDR.size
        for k, v in self.entries:
            _ENT.pack_into(d, off, len(k), len(v))
            off += _ENT.size
            d[off:off + len(k)] = k; off += len(k)
            d[off:off + len(v)] = v; off += len(v)


class ExtendibleHash:
    def __init__(self, pool: BufferPool):
        self.pool = pool
        self.global_depth = 0
        first = pool.new_page()
        _HDR.pack_into(first.data, 0, 0, 0)
        pool.unpin(first, dirty=True)
        self.directory = [first.page_no]
        self.n_keys = 0

    # -- public --------------------------------------------------------

    def put(self, key: bytes, value: bytes = b""):
        assert len(key) + len(value) + _ENT.size + _HDR.size <= PAGE_SIZE, \
            "entry larger than a page"
        while not self._try_put(key, value):
            pass

    def get(self, key: bytes) -> bytes | None:
        page = self.pool.fetch(self._dir_page(key))
        try:
            b = _Bucket(page)
            for k, v in b.entries:
                if k == key:
                    return v
            return None
        finally:
            self.pool.unpin(page)

    def __contains__(self, key: bytes) -> bool:
        return self.get(key) is not None

    def __len__(self) -> int:
        return self.n_keys

    def keys(self):
        """All keys (dedup across directory aliases of each bucket)."""
        seen_pages = set()
        for pno in self.directory:
            if pno in seen_pages:
                continue
            seen_pages.add(pno)
            page = self.pool.fetch(pno)
            try:
                for k, _ in _Bucket(page).entries:
                    yield k
            finally:
                self.pool.unpin(page)

    # -- internals -----------------------------------------------------

    def _dir_index(self, key: bytes) -> int:
        return _hash(key) & ((1 << self.global_depth) - 1)

    def _dir_page(self, key: bytes) -> int:
        return self.directory[self._dir_index(key)]

    def _try_put(self, key: bytes, value: bytes) -> bool:
        page = self.pool.fetch(self._dir_page(key))
        b = _Bucket(page)
        try:
            for i, (k, _) in enumerate(b.entries):
                if k == key:
                    b.entries[i] = (key, value)
                    b.write()
                    self.pool.unpin(page, dirty=True)
                    return True
            need = _ENT.size + len(key) + len(value)
            if b.bytes_used() + need <= PAGE_SIZE:
                b.entries.append((key, value))
                b.write()
                self.pool.unpin(page, dirty=True)
                self.n_keys += 1
                return True
        except Exception:
            self.pool.unpin(page)
            raise
        # overflow: split (extendiblehash.go split/grow)
        self._split(page, b)
        return False

    def _split(self, page, b: _Bucket):
        if b.local_depth == self.global_depth:
            # double the directory
            self.directory = self.directory + list(self.directory)
            self.global_depth += 1
        new_page = self.pool.new_page()
        new_depth = b.local_depth + 1
        old_entries = b.entries
        bit = 1 << b.local_depth
        # rehome directory slots whose index has the new bit set and
        # pointed at the old page
        mask = (1 << self.global_depth) - 1
        for i in range(len(self.directory)):
            if self.directory[i] == page.page_no and (i & bit):
                self.directory[i] = new_page.page_no
        keep, move = [], []
        for k, v in old_entries:
            (move if (_hash(k) & bit) else keep).append((k, v))
        b.entries = keep
        b.local_depth = new_depth
        b.write()
        nb = _Bucket(new_page)
        nb.entries = move
        nb.local_depth = new_depth
        nb.write()
        self.pool.unpin(page, dirty=True)
        self.pool.unpin(new_page, dirty=True)


class SpillSet:
    """DISTINCT spill set: in-memory until `threshold` keys, then an
    on-disk extendible hash (sql3 opdistinct behavior)."""

    def __init__(self, path: str, threshold: int = 1 << 16,
                 frames: int = 64):
        from pilosa_tpu_torch.storage.bufferpool import DiskManager
        self.path = path
        self.threshold = threshold
        self.frames = frames
        self._mem: set[bytes] | None = set()
        self._disk: ExtendibleHash | None = None
        self._pool = None
        from pilosa_tpu_torch.obs import testhook
        testhook.opened("spill.SpillSet", self, path)

    # keys longer than this store as a 32-byte blake2b digest so no
    # entry can outgrow a bucket page (collision odds ~2^-128)
    _MAX_INLINE_KEY = 4096

    def add(self, key: bytes) -> bool:
        """Add; True if newly added."""
        if len(key) > self._MAX_INLINE_KEY:
            key = b"#" + hashlib.blake2b(key, digest_size=32).digest()
        if self._mem is not None:
            if key in self._mem:
                return False
            self._mem.add(key)
            if len(self._mem) > self.threshold:
                self._spill()
            return True
        if key in self._disk:
            return False
        self._disk.put(key)
        return True

    def _spill(self):
        from pilosa_tpu_torch.storage.bufferpool import DiskManager
        self._pool = BufferPool(DiskManager(self.path),
                                max_frames=self.frames)
        self._disk = ExtendibleHash(self._pool)
        for k in self._mem:
            self._disk.put(k)
        self._mem = None

    def __len__(self):
        return len(self._mem) if self._mem is not None else len(self._disk)

    def __iter__(self):
        if self._mem is not None:
            return iter(self._mem)
        return self._disk.keys()

    def close(self):
        from pilosa_tpu_torch.obs import testhook
        testhook.closed("spill.SpillSet", self)
        if self._pool is not None:
            self._pool.close()
            self._pool.disk.destroy()
