"""Paged device stacks: residency at the granularity of a page.

A stack-cache entry is a set of fixed-size *pages*: the stack's leading
axes flatten to L lanes (one lane is one (leading coordinates, W) row),
and consecutive lanes group into pages of ``memory.page_bytes()`` each.
Pages are independent device tensors:

- the query's operand is assembled from them by one ``assemble_pages``
  launch (ops/kernels.py), so the engine sees the single tensor it
  always did;
- eviction drops the coldest pages (memory/policy.py), not whole
  entries, so an overcommitted working set uploads again only the pages
  a query lost;
- a point write patches the one page that holds its dirty lanes.

Under the serving mesh (``memory/placement.py``) a stack grows a device
axis: its lanes partition by their shard's owner slot and each slot's
lanes page on their own, so a page never straddles two slots and lives
on its owner's device.  Without it (``lane_device`` None) the layout is
the single-device one, contiguous lanes a page.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np

from pilosa_tpu_torch import memory


def page_lanes_for(width_words: int, itemsize: int = 4) -> int:
    """Lanes per page: the most whole lanes that fit the page size
    (at least 1: a lane wider than a page pages lane by lane)."""
    lane_bytes = max(int(width_words) * itemsize, 1)
    return max(int(memory.page_bytes()) // lane_bytes, 1)


@dataclass
class StackRecipe:
    """What the paged path needs to build an entry page by page,
    supplied by the stack builders of executor/stacked.py:

    - ``logical_lead``: the stack's leading shape (lanes = its product)
    - ``width_words``: the length of the word axis
    - ``lane_words(lane)``: the lane's current host words, read from the
      live fragments (the stack's ``_Layout.words``)
    - ``build_host()``: the whole host (lead..., W) array
    - ``versions_fn()``: the entry's current fragment stamps
    - ``deltas_fn(old_versions)``: the dirty lanes since old_versions
      ({lane: [(lo, hi)] word runs, or None for the whole lane}), or a
      string naming why no patch can serve (the rebuild's reason)
    - ``replay()``: fetches the stack again through the engine at the
      live fragments (the prefetcher's warm action)
    - ``weight``: rebuild cost per byte against a plain row stack
      (group-code pages OR many rows a lane, so eviction holds them
      longer)
    - ``alive_fn()``: False once the fields the recipe captured were
      dropped, so the prefetcher builds nothing no query can hit
    - ``lane_device``: the serving mesh's owner slot of each lane (int32
      (lanes,), from memory/placement.py), or None for the single-device
      layout; it gives the PagedStack its device axis
    - ``shard_axis``: which axis of ``logical_lead`` indexes the shards
      (the axis ``lane_device`` varies along): the ragged program keeps
      each slot's own shards along it
    """

    logical_lead: tuple
    width_words: int
    lane_words: object
    build_host: object
    versions_fn: object
    deltas_fn: object = None
    weight: float = 1.0
    alive_fn: object = None
    replay: object = None
    lane_device: object = None
    shard_axis: int | None = None

    @property
    def lanes(self) -> int:
        n = 1
        for d in self.logical_lead:
            n *= int(d)
        return n


class PagedStack:
    """One cache entry's resident pages, with its recency and hits.

    ``pages[i]`` is a (page_lanes, W) int32 device tensor (the last page
    zero-padded), an encoded page (memory/encode.py), or None when
    evicted.  Slots are swapped only under the owning cache's lock;
    readers snapshot the page list, so an eviction never takes a tensor
    from under an assembly.  Recency and hits are entry-level: an
    operand always needs all its pages.

    With ``lane_device`` the lanes partition by owner slot (stably:
    within a slot the global lane order is kept) and each slot's run of
    lanes pages on its own.  ``page_device[pi]`` is the page's owner
    slot, ``page_table[pi]`` its global lane ids, and ``lane_page`` /
    ``lane_slot`` the page and row that hold each lane."""

    __slots__ = ("shape", "lanes", "page_lanes", "width_words",
                 "weight", "pages", "last_access", "hits",
                 "lane_device", "shard_axis", "page_device",
                 "page_table", "lane_page", "lane_slot", "version",
                 "assembly")

    def __init__(self, shape: tuple, page_lanes: int,
                 weight: float = 1.0, lane_device=None,
                 shard_axis: int | None = None):
        self.shape = tuple(shape)
        self.width_words = int(shape[-1])
        n = 1
        for d in shape[:-1]:
            n *= int(d)
        self.lanes = n
        self.page_lanes = int(page_lanes)
        self.weight = float(weight)
        self.shard_axis = shard_axis
        self.lane_device = None
        self.page_device = None
        self.page_table = None
        self.lane_page = None
        self.lane_slot = None
        n_pages = -(-self.lanes // self.page_lanes)
        if lane_device is not None:
            ld = np.ascontiguousarray(lane_device, dtype=np.int32)
            if ld.shape != (self.lanes,):
                raise ValueError("lane_device must be (lanes,)")
            self.lane_device = ld
            order = np.argsort(ld, kind="stable")
            self.page_table, self.page_device = [], []
            pl = self.page_lanes
            for dev in np.unique(ld):
                run = order[ld[order] == dev]
                for k in range(0, run.size, pl):
                    self.page_table.append(run[k:k + pl])
                    self.page_device.append(int(dev))
            self.lane_page = np.empty(self.lanes, dtype=np.int32)
            self.lane_slot = np.empty(self.lanes, dtype=np.int32)
            for pi, ids in enumerate(self.page_table):
                self.lane_page[ids] = pi
                self.lane_slot[ids] = np.arange(ids.size, dtype=np.int32)
            n_pages = len(self.page_table)
        self.pages: list = [None] * n_pages
        self.last_access = time.time()
        self.hits = 0
        # bumped by every slot change; ``assembly`` is what a hit at that
        # version reuses: (version, device page table, page mix)
        self.version = 0
        self.assembly = None

    def set_page(self, pi: int, page) -> None:
        """Put ``page`` (or None) in slot ``pi``."""
        self.pages[pi] = page
        self.version += 1
        self.assembly = None

    @property
    def n_pages(self) -> int:
        return len(self.pages)

    @property
    def page_nbytes(self) -> int:
        """Dense bytes of one page, the upper bound.  The ledger charges
        each page its true size instead (``resident_bytes``)."""
        return self.page_lanes * self.width_words * 4

    def resident_bytes(self) -> int:
        return sum(int(p.nbytes) for p in self.pages if p is not None)

    def missing(self) -> list[int]:
        return [i for i, p in enumerate(self.pages) if p is None]

    def complete(self) -> bool:
        # identity, not ``None in pages``: that would call each tensor's ==
        return not any(p is None for p in self.pages)

    def page_lane_ids(self, pi: int) -> np.ndarray:
        """The global lane ids page ``pi`` holds, in row order."""
        if self.page_table is not None:
            return self.page_table[pi]
        lo = pi * self.page_lanes
        return np.arange(lo, min(lo + self.page_lanes, self.lanes))

    def page_of(self, lane: int) -> tuple[int, int]:
        """(page index, row inside the page) holding ``lane``."""
        if self.lane_page is not None:
            return int(self.lane_page[lane]), int(self.lane_slot[lane])
        return divmod(int(lane), self.page_lanes)

    def device_of(self, pi: int) -> int | None:
        """The page's owner slot (None: the single-device layout)."""
        return None if self.page_device is None else self.page_device[pi]

    def inv_perm(self) -> "np.ndarray | None":
        """lane -> row of the pages' padded concatenation, or None where
        page order is lane order (the single-device layout)."""
        if self.lane_page is None:
            return None
        return (self.lane_page.astype(np.int64) * self.page_lanes
                + self.lane_slot)

    def build_page_host(self, pi: int, lane_words) -> np.ndarray:
        """Host words of one page (zero past the last lane)."""
        block = np.zeros((self.page_lanes, self.width_words),
                         dtype=np.uint32)
        for k, lane in enumerate(self.page_lane_ids(pi)):
            block[k] = lane_words(int(lane))
        return block

    def touch(self, now: float | None = None):
        self.last_access = time.time() if now is None else now
        self.hits += 1
