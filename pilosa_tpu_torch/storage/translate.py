"""Key translation: string keys ↔ integer ids.

The reference's TranslateStore (translate.go:43) and its partitioned
index-key layout:

- Field row keys use one sequential store (partition -1).
- Index column keys are split over 256 partitions
  (disco/snapshot.go:15 DefaultPartitionN).  A key hashes to its
  partition with FNV-64a over index+key (disco/snapshot.go:87), and
  ids are allocated so that the id's shard hashes to the same
  partition (translate.go:103 GenerateNextPartitionedID): keyed
  columns spread deterministically over the shard space.

The same keys, created in the same order, get the same ids as in the
JAX package.

Given a path, a store keeps an append-only JSONL log and compacts it
into ``<path>.snap`` once ``COMPACT_THRESHOLD`` records have gathered
in the log; a reopen replays the snapshot and the tail, and a torn
last line (a crash mid-append) is dropped.  The ``torn-write`` fault
point makes that tear: half a record, the log closed, an error.
"""

from __future__ import annotations

import functools
import json
import os
import threading

from pilosa_tpu_torch.obs import faults
from pilosa_tpu_torch.shardwidth import SHARD_WIDTH

PARTITION_N = 256

# tail-log records before the next snapshot compaction
COMPACT_THRESHOLD = 100_000

_FNV_OFFSET = 0xCBF29CE484222325
_FNV_PRIME = 0x100000001B3
_MASK = 0xFFFFFFFFFFFFFFFF


def _fnv64a(*parts: bytes) -> int:
    h = _FNV_OFFSET
    for p in parts:
        for b in p:
            h = ((h ^ b) * _FNV_PRIME) & _MASK
    return h


def key_to_key_partition(index: str, key: str,
                         partition_n: int = PARTITION_N) -> int:
    """disco.KeyToKeyPartition: fnv64a(index + key) % N."""
    return _fnv64a(index.encode(), key.encode()) % partition_n


@functools.lru_cache(maxsize=65536)
def shard_to_shard_partition(index: str, shard: int,
                             partition_n: int = PARTITION_N) -> int:
    """disco.ShardToShardPartition: fnv64a(index + bigendian(shard)) % N,
    memoised (translating ids hits the same few shards many times)."""
    return _fnv64a(index.encode(), shard.to_bytes(8, "big")) % partition_n


def next_partitioned_id(index: str, prev: int, partition_id: int,
                        shard_width: int = SHARD_WIDTH) -> int:
    """translate.GenerateNextPartitionedID: the smallest id > prev whose
    shard belongs to partition_id (stepping a shard at a time)."""
    if partition_id == -1:
        return prev + 1
    candidate = prev + 1
    while True:
        if shard_to_shard_partition(
                index, candidate // shard_width) == partition_id:
            return candidate
        candidate += shard_width


class TranslateStore:
    """One translation store (one field, or one index partition)."""

    def __init__(self, path: str | None = None, index: str = "",
                 partition_id: int = -1, shard_width: int = SHARD_WIDTH):
        self.path = path
        self.index = index
        self.partition_id = partition_id
        self.shard_width = shard_width
        self._by_key: dict[str, int] = {}
        self._by_id: dict[int, str] = {}
        self._max_id = 0
        self._lock = threading.RLock()
        self._log = None
        self._tail_records = 0
        if path:
            self._open()

    @property
    def snap_path(self) -> str:
        return self.path + ".snap"

    def _open(self):
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        torn = False
        if os.path.exists(self.snap_path):
            # written through tmp+rename: absent or complete
            with open(self.snap_path) as f:
                snap = json.load(f)
            for i, k in snap.get("entries", []):
                self._set(int(i), k)
        if os.path.exists(self.path):
            with open(self.path) as f:
                lines = f.read().splitlines()
            last = max((i for i, ln in enumerate(lines) if ln.strip()),
                       default=-1)
            for i, line in enumerate(lines):
                line = line.strip()
                if not line:
                    continue
                try:
                    entry = json.loads(line)
                except ValueError:
                    if i == last:
                        # torn tail: the record was never acknowledged
                        torn = True
                        break
                    raise
                self._set(entry["id"], entry["key"])
                self._tail_records += 1
        self._log = open(self.path, "a")
        if torn or self._tail_records >= COMPACT_THRESHOLD:
            # nothing may be appended after a torn tail, and a tail past
            # the threshold means the last run died before compacting
            self._compact_locked()

    def _append_locked(self, id_: int, key: str):
        line = json.dumps({"id": id_, "key": key}) + "\n"
        if faults.take("torn-write", self.path or ""):
            # chaos seam: a crash mid-append leaves a torn last line.
            # Write half the record and stop as the crash would: close
            # the log, so nothing lands after the tear and the reopen's
            # torn-tail recovery can absorb it, and raise
            self._log.write(line[:max(1, len(line) // 2)])
            self._log.flush()
            self._log.close()
            raise faults.InjectedFault("torn-write", self.path or "")
        self._log.write(line)
        self._tail_records += 1

    def _maybe_compact_locked(self):
        if self._tail_records >= COMPACT_THRESHOLD:
            self._compact_locked()

    def _compact_locked(self):
        """Write the whole state to the snapshot file atomically and
        truncate the tail log."""
        tmp = self.snap_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"index": self.index,
                       "partition": self.partition_id,
                       "entries": [[i, k] for i, k in
                                   sorted(self._by_id.items())]}, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.snap_path)
        if self._log:
            self._log.close()
        self._log = open(self.path, "w")
        self._tail_records = 0

    def close(self):
        if self._log:
            self._log.close()
            self._log = None

    def _set(self, id_: int, key: str):
        self._by_key[key] = id_
        self._by_id[id_] = key
        self._max_id = max(self._max_id, id_)

    def max_id(self) -> int:
        return self._max_id

    def find_keys(self, *keys: str) -> dict[str, int]:
        """Ids of the keys that exist; missing keys are absent from the
        result (translate.go FindKeys)."""
        with self._lock:
            return {k: self._by_key[k] for k in keys if k in self._by_key}

    def create_keys(self, *keys: str) -> dict[str, int]:
        """Ids of the keys, allocating new ids as needed."""
        out = {}
        with self._lock:
            for k in keys:
                id_ = self._by_key.get(k)
                if id_ is None:
                    id_ = next_partitioned_id(
                        self.index, self._max_id, self.partition_id,
                        self.shard_width)
                    self._set(id_, k)
                    if self._log:
                        self._append_locked(id_, k)
                out[k] = id_
            if self._log:
                self._log.flush()
                self._maybe_compact_locked()
        return out

    def force_set(self, id_: int, key: str):
        """Record a key under a given id (translate.go ForceSet: the
        replication write path; ``Index.clone_to`` copies keys so)."""
        with self._lock:
            self._set(id_, key)
            if self._log:
                self._append_locked(id_, key)
                self._log.flush()
                self._maybe_compact_locked()

    def translate_id(self, id_: int) -> str | None:
        return self._by_id.get(id_)

    def translate_ids(self, ids) -> list[str | None]:
        return [self._by_id.get(int(i)) for i in ids]

    def match(self, predicate) -> list[int]:
        """Ids of the keys a predicate accepts, ascending (translate.go
        Match)."""
        with self._lock:
            return sorted(id_ for k, id_ in self._by_key.items()
                          if predicate(k))

    def entries(self) -> list[tuple[int, str]]:
        """(id, key) pairs by id."""
        with self._lock:
            return sorted(self._by_id.items())

    # -- replication (holder.go:1488-1715, the translation syncer) ---------

    def snapshot(self) -> dict:
        """The whole store as JSON, streamed to a replica or a rejoining
        node (the JAX package's form)."""
        with self._lock:
            return {"index": self.index, "partition": self.partition_id,
                    "entries": [[i, k] for i, k in
                                sorted(self._by_id.items())]}

    def restore_snapshot(self, snap: dict):
        """Replace the contents with an owner's snapshot; on disk the
        compaction writes exactly the restored state (a stale snapshot
        file would bring back keys the owner no longer has)."""
        with self._lock:
            self._by_key.clear()
            self._by_id.clear()
            self._max_id = 0
            for i, k in snap.get("entries", []):
                self._set(int(i), k)
            if self._log:
                self._compact_locked()


class PartitionedTranslator:
    """Index column-key translation over N partition stores
    (cluster.go:511-826 key-translation routing, one node)."""

    def __init__(self, index: str, path: str | None = None,
                 shard_width: int = SHARD_WIDTH):
        self.index = index
        self.shard_width = shard_width
        self._stores: dict[int, TranslateStore] = {}
        self._path = path
        self._lock = threading.RLock()

    def _store(self, partition: int) -> TranslateStore:
        with self._lock:
            s = self._stores.get(partition)
            if s is None:
                path = (os.path.join(self._path,
                                     f"keys.{partition:04d}.jsonl")
                        if self._path else None)
                s = TranslateStore(path, index=self.index,
                                   partition_id=partition,
                                   shard_width=self.shard_width)
                self._stores[partition] = s
            return s

    def _group(self, keys) -> dict[int, list[str]]:
        groups: dict[int, list[str]] = {}
        for k in keys:
            groups.setdefault(key_to_key_partition(self.index, k),
                              []).append(k)
        return groups

    def find_keys(self, *keys: str) -> dict[str, int]:
        out = {}
        for p, ks in self._group(keys).items():
            out.update(self._store(p).find_keys(*ks))
        return out

    def create_keys(self, *keys: str) -> dict[str, int]:
        out = {}
        for p, ks in self._group(keys).items():
            out.update(self._store(p).create_keys(*ks))
        return out

    def translate_ids(self, ids) -> list[str | None]:
        """Each id's key: its shard's partition names the store, looked
        up once a shard."""
        by_shard: dict = {}
        out = []
        for i in ids:
            i = int(i)
            lookup = by_shard.get(i // self.shard_width)
            if lookup is None:
                lookup = by_shard[i // self.shard_width] = self._store(
                    shard_to_shard_partition(
                        self.index, i // self.shard_width)).translate_id
            out.append(lookup(i))
        return out

    def _on_disk(self) -> list[int]:
        """Partitions with a log file under the path (opened or not)."""
        if not (self._path and os.path.isdir(self._path)):
            return []
        return [int(fn.split(".")[1]) for fn in os.listdir(self._path)
                if fn.startswith("keys.") and fn.endswith(".jsonl")]

    def nonempty_partitions(self) -> list[int]:
        """Partitions holding a key, opened or only on disk (right after
        a reopen no store is open yet)."""
        return sorted(p for p in set(self._stores) | set(self._on_disk())
                      if self._store(p).max_id())

    def partition_snapshot(self, partition: int) -> dict:
        """One partition store's snapshot, streamed to a peer."""
        return self._store(partition).snapshot()

    def restore_partition(self, partition: int, snap: dict):
        self._store(partition).restore_snapshot(snap)

    def match(self, predicate) -> list[int]:
        ids: set[int] = set()
        for p in set(self._stores) | set(self._on_disk()):
            ids.update(self._store(p).match(predicate))
        return sorted(ids)

    def close(self):
        for s in self._stores.values():
            s.close()
