"""ctypes binding of the RBF page store (``storage/csrc/rbf.cc``).

A single-file page store with a WAL, checkpoints and one-writer /
N-reader MVCC snapshots (the reference's rbf/db.go and rbf/tx.go),
holding roaring containers (array, run or bitmap encodings, picked per
container as roaring's Container.optimize does) that decode to dense
8 KiB tiles of 65536 bits.  The on-disk format is the JAX package's bit
for bit: a file either package writes opens in the other.

The library is built with g++ at first use (``storage/_build.py``); a
failed build raises.  ``RBF_NOSYNC`` in the environment skips the
fsyncs (the tests set it).
"""

from __future__ import annotations

import ctypes as ct
import functools

import numpy as np

from pilosa_tpu_torch.obs import testhook
from pilosa_tpu_torch.storage import _build

PAGE_SIZE = 8192
TILE_BYTES = 8192
TILE_WORDS = TILE_BYTES // 4       # uint32 words in a container tile
TILE_BITS = 1 << 16                # bits in a container

NOTFOUND = -2
BUSY = -3


class RBFError(RuntimeError):
    pass


def _declare(lib: ct.CDLL) -> ct.CDLL:
    vp, cp, i64 = ct.c_void_p, ct.c_char_p, ct.c_int64
    sigs = {
        "rbf_errmsg": (ct.c_char_p, []),
        "rbf_open": (vp, [cp]),
        "rbf_close": (ct.c_int, [vp]),
        "rbf_checkpoint": (ct.c_int, [vp]),
        "rbf_wal_size": (i64, [vp]),
        "rbf_page_count": (i64, [vp]),
        "rbf_begin": (vp, [vp, ct.c_int]),
        "rbf_commit": (ct.c_int, [vp]),
        "rbf_rollback": (ct.c_int, [vp]),
        "rbf_create_bitmap": (ct.c_int, [vp, cp]),
        "rbf_delete_bitmap": (ct.c_int, [vp, cp]),
        "rbf_has_bitmap": (ct.c_int, [vp, cp]),
        "rbf_list_bitmaps": (i64, [vp, cp, i64]),
        "rbf_put_container": (ct.c_int, [vp, cp, ct.c_uint64, vp]),
        "rbf_get_container": (ct.c_int, [vp, cp, ct.c_uint64, vp]),
        "rbf_remove_container": (ct.c_int, [vp, cp, ct.c_uint64]),
        "rbf_container_count": (i64, [vp, cp]),
        "rbf_bitmap_count": (i64, [vp, cp]),
        "rbf_get_range": (ct.c_int, [vp, cp, ct.c_uint64, i64, vp]),
        "rbf_iter_open": (vp, [vp, cp]),
        "rbf_iter_next": (ct.c_int, [vp, ct.POINTER(ct.c_uint64), vp]),
        "rbf_iter_close": (None, [vp]),
        "rbf_container_encode": (ct.c_int32,
                                 [vp, vp, ct.POINTER(ct.c_int32)]),
        "rbf_container_decode": (ct.c_int, [ct.c_int32, vp, ct.c_int32,
                                            vp]),
    }
    for name, (res, args) in sigs.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = res, args
    return lib


@functools.cache
def _load() -> ct.CDLL:
    return _declare(_build.library("rbf"))


def _err(lib, rc, what):
    raise RBFError(f"{what}: rc={rc} ({lib.rbf_errmsg().decode()})")


def _tile_buf(arr: np.ndarray):
    """The pointer of a (2048,) uint32 C-contiguous tile, checked."""
    if (arr.dtype != np.uint32 or not arr.flags.c_contiguous
            or arr.size != TILE_WORDS):
        raise ValueError("an RBF tile is a C-contiguous (2048,) uint32 array")
    return arr.ctypes.data_as(ct.c_void_p)


class Tx:
    """One transaction: a read snapshot or the one writer."""

    def __init__(self, db: "DB", writable: bool):
        self._lib = db._lib
        ptr = self._lib.rbf_begin(db._ptr, 1 if writable else 0)
        if not ptr:
            _err(self._lib, -1, "begin")
        self._ptr = ptr
        self.writable = writable

    def commit(self):
        if self._ptr:
            rc = self._lib.rbf_commit(self._ptr)
            self._ptr = None
            if rc != 0:
                _err(self._lib, rc, "commit")

    def rollback(self):
        if self._ptr:
            self._lib.rbf_rollback(self._ptr)
            self._ptr = None

    def __enter__(self):
        return self

    def __exit__(self, et, ev, tb):
        if et is None:
            self.commit()
        else:
            self.rollback()

    # -- catalog --

    def create_bitmap(self, name: str):
        rc = self._lib.rbf_create_bitmap(self._ptr, name.encode())
        if rc != 0:
            _err(self._lib, rc, "create_bitmap")

    def delete_bitmap(self, name: str) -> bool:
        rc = self._lib.rbf_delete_bitmap(self._ptr, name.encode())
        if rc == NOTFOUND:
            return False
        if rc != 0:
            _err(self._lib, rc, "delete_bitmap")
        return True

    def has_bitmap(self, name: str) -> bool:
        rc = self._lib.rbf_has_bitmap(self._ptr, name.encode())
        if rc < 0:
            _err(self._lib, rc, "has_bitmap")
        return rc == 1

    def list_bitmaps(self) -> list[str]:
        need = self._lib.rbf_list_bitmaps(self._ptr, None, 0)
        if need < 0:
            _err(self._lib, need, "list_bitmaps")
        if need == 0:
            return []
        buf = ct.create_string_buffer(int(need))
        self._lib.rbf_list_bitmaps(self._ptr, buf, need)
        return buf.raw[:need].decode().rstrip("\n").split("\n")

    # -- containers --

    def put(self, name: str, ckey: int, dense: np.ndarray):
        """Store a dense (2048,) uint32 tile; an all-zero tile removes
        the container."""
        rc = self._lib.rbf_put_container(self._ptr, name.encode(), ckey,
                                         _tile_buf(dense))
        if rc != 0:
            _err(self._lib, rc, "put")

    def get(self, name: str, ckey: int) -> np.ndarray | None:
        out = np.zeros(TILE_WORDS, dtype=np.uint32)
        rc = self._lib.rbf_get_container(self._ptr, name.encode(), ckey,
                                         _tile_buf(out))
        if rc == NOTFOUND:
            return None
        if rc != 0:
            _err(self._lib, rc, "get")
        return out

    def remove(self, name: str, ckey: int) -> bool:
        rc = self._lib.rbf_remove_container(self._ptr, name.encode(), ckey)
        if rc == NOTFOUND:
            return False
        if rc != 0:
            _err(self._lib, rc, "remove")
        return True

    def container_count(self, name: str) -> int:
        n = self._lib.rbf_container_count(self._ptr, name.encode())
        if n < 0:
            _err(self._lib, n, "container_count")
        return int(n)

    def count(self, name: str) -> int:
        n = self._lib.rbf_bitmap_count(self._ptr, name.encode())
        if n < 0:
            _err(self._lib, n, "count")
        return int(n)

    def get_range(self, name: str, base: int, n: int) -> np.ndarray:
        """Containers [base, base+n) as (n*2048,) uint32 dense tiles
        (zeros where a container is missing)."""
        out = np.zeros(n * TILE_WORDS, dtype=np.uint32)
        rc = self._lib.rbf_get_range(self._ptr, name.encode(), base, n,
                                     out.ctypes.data_as(ct.c_void_p))
        if rc != 0:
            _err(self._lib, rc, "get_range")
        return out

    def items(self, name: str):
        """Yield (ckey, dense (2048,) uint32 tile) in key order."""
        it = self._lib.rbf_iter_open(self._ptr, name.encode())
        if not it:
            _err(self._lib, -1, "iter_open")
        try:
            key = ct.c_uint64()
            while True:
                out = np.zeros(TILE_WORDS, dtype=np.uint32)
                rc = self._lib.rbf_iter_next(it, ct.byref(key),
                                             _tile_buf(out))
                if rc == 0:
                    return
                if rc < 0:
                    _err(self._lib, rc, "iter_next")
                yield int(key.value), out
        finally:
            self._lib.rbf_iter_close(it)


class DB:
    """One RBF database file (and its ``.wal`` beside it)."""

    def __init__(self, path: str):
        self._lib = _load()
        ptr = self._lib.rbf_open(path.encode())
        if not ptr:
            raise RBFError(f"open {path}: {self._lib.rbf_errmsg().decode()}")
        self._ptr = ptr
        self.path = path
        testhook.opened("rbf.DB", self, path)

    def begin(self, write: bool = False) -> Tx:
        return Tx(self, write)

    def checkpoint(self) -> bool:
        """Fold the WAL into the main file; False while readers pin it."""
        rc = self._lib.rbf_checkpoint(self._ptr)
        if rc == BUSY:
            return False
        if rc != 0:
            _err(self._lib, rc, "checkpoint")
        return True

    @property
    def wal_size(self) -> int:
        return int(self._lib.rbf_wal_size(self._ptr))

    @property
    def page_count(self) -> int:
        return int(self._lib.rbf_page_count(self._ptr))

    def close(self):
        if self._ptr:
            testhook.closed("rbf.DB", self)
            rc = self._lib.rbf_close(self._ptr)
            self._ptr = None
            if rc != 0:
                _err(self._lib, rc, "close")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def container_encode(dense: np.ndarray) -> tuple[int, bytes]:
    """A dense (2048,) uint32 tile as (encoding, payload), the smallest
    of array, runs and bitmap."""
    lib = _load()
    out = ct.create_string_buffer(TILE_BYTES)
    enc = ct.c_int32()
    n = lib.rbf_container_encode(_tile_buf(dense), out, ct.byref(enc))
    if n < 0:
        _err(lib, n, "encode")
    return int(enc.value), out.raw[:n]


def container_decode(enc: int, payload: bytes) -> np.ndarray:
    lib = _load()
    out = np.zeros(TILE_WORDS, dtype=np.uint32)
    rc = lib.rbf_container_decode(enc, payload, len(payload), _tile_buf(out))
    if rc != 0:
        _err(lib, rc, "decode")
    return out
