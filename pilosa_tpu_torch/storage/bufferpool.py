"""Page buffer pool with clock replacement over a disk file.

Reference: bufferpool/ (bufferpool.go BufferPool, clockreplacer.go
ClockReplacer, diskmanager.go) — fixed-size page frames cached in
memory over an on-disk page file; victims chosen by the clock
algorithm; used by the sql3 layer's spill-to-disk structures
(extendiblehash/ for DISTINCT).

Pages are 8 KiB like the RBF engine's (rbf/rbf.go PageSize).
"""

from __future__ import annotations

import os
import threading

PAGE_SIZE = 8192


class Page:
    __slots__ = ("page_no", "data", "dirty", "pin_count", "ref")

    def __init__(self, page_no: int):
        self.page_no = page_no
        self.data = bytearray(PAGE_SIZE)
        self.dirty = False
        self.pin_count = 0
        self.ref = False  # clock reference bit


class DiskManager:
    """Page-granular file IO (bufferpool diskmanager)."""

    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        if not os.path.exists(path):
            open(path, "wb").close()
        # r+b, NOT a+b: append mode ignores seek() on write, which
        # would scatter every in-place page write to the file tail
        self._f = open(path, "r+b")
        self._f.seek(0, os.SEEK_END)
        self._n_pages = self._f.tell() // PAGE_SIZE

    def allocate(self) -> int:
        no = self._n_pages
        self._n_pages += 1
        self._f.seek(no * PAGE_SIZE)
        self._f.write(b"\0" * PAGE_SIZE)
        return no

    def read(self, page_no: int, buf: bytearray):
        self._f.seek(page_no * PAGE_SIZE)
        got = self._f.read(PAGE_SIZE)
        buf[: len(got)] = got
        buf[len(got):] = b"\0" * (PAGE_SIZE - len(got))

    def write(self, page_no: int, data):
        self._f.seek(page_no * PAGE_SIZE)
        self._f.write(bytes(data))

    @property
    def n_pages(self) -> int:
        return self._n_pages

    def close(self):
        self._f.close()

    def destroy(self):
        self.close()
        if os.path.exists(self.path):
            os.unlink(self.path)


class ClockReplacer:
    """Second-chance eviction (clockreplacer.go)."""

    def __init__(self):
        self._frames: list[Page] = []
        self._hand = 0

    def track(self, page: Page):
        self._frames.append(page)

    def untrack(self, page: Page):
        self._frames.remove(page)
        self._hand = 0

    def victim(self) -> Page | None:
        if not self._frames:
            return None
        spins = 0
        while spins < 2 * len(self._frames):
            p = self._frames[self._hand % len(self._frames)]
            self._hand = (self._hand + 1) % len(self._frames)
            spins += 1
            if p.pin_count > 0:
                continue
            if p.ref:
                p.ref = False  # second chance
                continue
            return p
        return None


class BufferPool:
    """Fixed-frame page cache (bufferpool.go BufferPool)."""

    def __init__(self, disk: DiskManager, max_frames: int = 128):
        self.disk = disk
        self.max_frames = max_frames
        self._pages: dict[int, Page] = {}
        self._clock = ClockReplacer()
        self._lock = threading.RLock()

    def new_page(self) -> Page:
        with self._lock:
            no = self.disk.allocate()
            return self._admit(Page(no), fresh=True)

    def fetch(self, page_no: int) -> Page:
        """Pinned page; callers must unpin()."""
        with self._lock:
            p = self._pages.get(page_no)
            if p is None:
                p = Page(page_no)
                self.disk.read(page_no, p.data)
                p = self._admit(p, fresh=False)
            else:
                p.pin_count += 1
                p.ref = True
            return p

    def _admit(self, p: Page, fresh: bool) -> Page:
        while len(self._pages) >= self.max_frames:
            v = self._clock.victim()
            if v is None:
                raise RuntimeError(
                    "buffer pool exhausted: all pages pinned")
            if v.dirty:
                self.disk.write(v.page_no, v.data)
            self._clock.untrack(v)
            del self._pages[v.page_no]
        p.pin_count = 1
        p.ref = True
        if fresh:
            p.dirty = True
        self._pages[p.page_no] = p
        self._clock.track(p)
        return p

    def unpin(self, page: Page, dirty: bool = False):
        with self._lock:
            page.pin_count = max(0, page.pin_count - 1)
            page.dirty = page.dirty or dirty

    def flush_all(self):
        with self._lock:
            for p in self._pages.values():
                if p.dirty:
                    self.disk.write(p.page_no, p.data)
                    p.dirty = False

    def close(self):
        self.flush_all()
        self.disk.close()
