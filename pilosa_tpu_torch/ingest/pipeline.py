"""Pipeline — the IDK ``Main`` ingest loop.

idk/ingest.go:59,255,357: per-worker clones, each looping
Source.Record → batch.Add → flush when full → offset commit.  One
Source feeds N worker threads over a queue; each worker owns its Batch
(m.clone() a worker, idk/ingest.go:302) and flushes on its own, and
offsets commit after the owning batch landed and the importer synced
(at least once, as the reference).  Records without an id take ids
from an ``IDAllocator`` in reserve/commit sessions.
"""

from __future__ import annotations

import hashlib
import queue
import threading

from pilosa_tpu_torch.ingest.batch import Batch


class Pipeline:
    def __init__(self, source, importer, index: str,
                 batch_size: int = 1 << 16, concurrency: int = 1,
                 index_keys: bool | None = None, allocator=None):
        self.source = source
        self.importer = importer
        self.index = index
        self.batch_size = batch_size
        self.concurrency = max(1, concurrency)
        self.index_keys = (source.id_keys if index_keys is None and
                           hasattr(source, "id_keys") else bool(index_keys))
        self.records_ingested = 0
        # optional IDAllocator for records WITHOUT an _id: ids come
        # from reserve/commit sessions keyed by the source position
        # (idk/idallocator.go over idalloc.go:127 — a crashed worker
        # that retries the same batch reserves the SAME session and
        # gets the same range, so replayed records keep their ids)
        self.allocator = allocator

    def apply_schema(self):
        """Schema-detect step: create index+fields from the source."""
        fields = [{"name": n, "options": dict(o)}
                  for n, o in self.source.schema.items()]
        self.importer.apply_schema({"indexes": [{
            "name": self.index, "keys": self.index_keys,
            "fields": fields}]})

    def run(self) -> int:
        """Ingest everything; returns the number of records."""
        self.apply_schema()
        if self.concurrency == 1:
            n = self._run_worker(iter(self.source))
            self.records_ingested = n
            return n
        q: queue.Queue = queue.Queue(maxsize=self.concurrency * 1024)
        counts = [0] * self.concurrency
        errs: list[BaseException] = []

        def worker(i):
            def drain():
                while True:
                    rec = q.get()
                    if rec is None:
                        return
                    yield rec
            try:
                counts[i] = self._run_worker(drain(), worker=i)
            except BaseException as e:  # surface to the caller
                errs.append(e)

        threads = [threading.Thread(target=worker, args=(i,), daemon=True)
                   for i in range(self.concurrency)]
        for t in threads:
            t.start()
        for rec in self.source:
            # bounded put that still notices dead workers: if every
            # worker died on an error the queue never drains and a
            # plain put() would block forever
            while True:
                try:
                    q.put(rec, timeout=0.5)
                    break
                except queue.Full:
                    if errs:
                        raise errs[0]
        # sentinel puts need the same dead-worker guard as record puts:
        # if all workers died with the queue full, no one drains it
        for _ in threads:
            while True:
                try:
                    q.put(None, timeout=0.5)
                    break
                except queue.Full:
                    if errs:
                        raise errs[0]
        for t in threads:
            t.join()
        if errs:
            raise errs[0]
        self.records_ingested = sum(counts)
        return self.records_ingested

    def _alloc_session(self, n: int) -> bytes:
        """The reservation session of the batch a worker starts after n
        records: the same batch retried reserves the same session, and
        so the same id range (idalloc.go:127).  The middle field is a
        streaming source's position (``ingest/kafka.StreamSource``'s
        last pending offset), None for the other sources."""
        pos = None
        if getattr(self.source, "_pending", None):
            pos = self.source._pending[-1]
        return hashlib.blake2b(f"{self.index}|{pos}|{n}".encode(),
                               digest_size=16).digest()

    def _run_worker(self, records, worker: int = 0) -> int:
        b = Batch(self.importer, self.index, self.source.schema,
                  size=self.batch_size, index_keys=self.index_keys)
        n = 0
        pending = 0  # records flushed downstream since last commit
        block: range | None = None
        block_i = 0
        session: bytes | None = None
        # sessions are per worker (the allocator supports concurrent
        # in-flight sessions on one key); same-id replay determinism
        # holds at concurrency=1 — with workers, queue distribution is
        # nondeterministic, so replays keep uniqueness, not identity
        # (the reference's per-clone consumers have the same shape,
        # idk/ingest.go:302)
        akey = self.index
        for rec in records:
            if rec.id is None:
                if self.allocator is None:
                    raise ValueError(
                        "record without _id and no id allocator")
                if block is None or block_i >= len(block):
                    session = self._alloc_session(n) + bytes([worker])
                    block = self.allocator.reserve(
                        akey, session, self.batch_size)
                    block_i = 0
                rec.id = block[block_i]
                block_i += 1
            full = b.add(rec)
            n += 1
            pending += 1
            if full:
                b.flush()
                if block is not None:
                    self.allocator.commit(akey, session, block_i)
                    block, session = None, None
                # durability barrier BEFORE the offset commit: an
                # acknowledged record must survive a crash
                # (idk/ingest.go:1062 commit-after-land)
                self.importer.sync(self.index)
                self.source.commit(pending)
                pending = 0
        b.flush()
        if block is not None:
            self.allocator.commit(akey, session, block_i)
        self.importer.sync(self.index)
        self.source.commit(pending)
        return n
