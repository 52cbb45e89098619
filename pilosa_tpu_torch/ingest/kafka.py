"""Kafka-semantics streaming ingest.

Reference: idk/kafka/source.go:34 — a consumer-group source yielding
records from topic partitions, committing offsets only after the
downstream batch lands (idk/ingest.go:1062 commitRecord), so a
crashed ingester resumes from the last committed offset and no
acknowledged record is lost.

Two halves:

- :class:`Broker` — an in-process broker with topics, partitions,
  append-only offset-addressed logs, and consumer-group offset
  storage.  It is the test.Cluster analog for streaming ingest (the
  reference's kafka tests run against a dockerized broker; here the
  broker is embeddable).
- :class:`StreamSource` — the idk-style Source over any broker object
  with the same ``fetch/committed/commit_offsets`` surface; a
  confluent-kafka adapter can drop in where the environment has one.

Messages are JSON objects; ``_id`` names the record id and ``_ts`` an
optional record timestamp (the Avro schema-registry decoding of the
reference collapses to JSON here).
"""

from __future__ import annotations

import json
import threading

from pilosa_tpu_torch.ingest.batch import Record
from pilosa_tpu_torch.ingest.sources import Source


class Broker:
    """In-memory topic/partition log + consumer-group offsets."""

    def __init__(self, n_partitions: int = 4):
        self.n_partitions = n_partitions
        self._topics: dict[str, list[list[bytes]]] = {}
        self._group_offsets: dict[tuple[str, str], dict[int, int]] = {}
        # per-(group, topic) high-watermark of offsets ever DELIVERED
        # to a consumer — the broker outlives a crashed consumer, so
        # re-delivery below this mark is an observable replay (the
        # pilosa_ingest_replayed_total signal a recovering ingester
        # emits)
        self._delivered: dict[tuple[str, str], dict[int, int]] = {}
        self._lock = threading.Lock()

    def create_topic(self, topic: str, n_partitions: int | None = None):
        with self._lock:
            self._topics.setdefault(
                topic, [[] for _ in range(n_partitions
                                          or self.n_partitions)])

    def produce(self, topic: str, value, key=None,
                partition: int | None = None) -> tuple[int, int]:
        """Append; returns (partition, offset).  Keyed messages hash
        to a stable partition (kafka key-partitioning)."""
        if not isinstance(value, (bytes, bytearray)):
            value = json.dumps(value).encode()
        with self._lock:
            if topic not in self._topics:
                self._topics[topic] = [
                    [] for _ in range(self.n_partitions)]
            parts = self._topics[topic]
            if partition is None:
                partition = (hash(key) % len(parts)) if key is not None \
                    else (sum(len(p) for p in parts) % len(parts))
            log = parts[partition]
            log.append(bytes(value))
            return partition, len(log) - 1

    def fetch(self, topic: str, partition: int, offset: int,
              max_records: int = 500) -> list[tuple[int, bytes]]:
        """[(offset, value)] from `offset` onward."""
        with self._lock:
            parts = self._topics.get(topic)
            if parts is None:
                return []
            log = parts[partition]
            return [(i, log[i]) for i in
                    range(offset, min(len(log), offset + max_records))]

    def partitions(self, topic: str) -> list[int]:
        with self._lock:
            parts = self._topics.get(topic)
            return list(range(len(parts))) if parts else []

    def committed(self, group: str, topic: str) -> dict[int, int]:
        with self._lock:
            return dict(self._group_offsets.get((group, topic), {}))

    def commit_offsets(self, group: str, topic: str,
                       offsets: dict[int, int]):
        with self._lock:
            cur = self._group_offsets.setdefault((group, topic), {})
            for p, o in offsets.items():
                cur[p] = max(cur.get(p, 0), o)

    def reset_offsets(self, group: str, topic: str,
                      offsets: dict[int, int]):
        """Seek: OVERWRITE checkpoints (kinesis iterator semantics —
        commit_offsets only moves forward)."""
        with self._lock:
            self._group_offsets.setdefault((group, topic), {}).update(
                {p: int(o) for p, o in offsets.items()})

    def delivered_mark(self, group: str, topic: str, partition: int,
                       offset: int) -> bool:
        """Record that `offset` was delivered to `group`; True when it
        had already been delivered before (a crash-recovery replay)."""
        with self._lock:
            d = self._delivered.setdefault((group, topic), {})
            prev = d.get(partition, -1)
            if offset > prev:
                d[partition] = offset
            return offset <= prev

    def head(self, topic: str, partition: int) -> int:
        """Next offset to be produced (the high watermark) — O(1)."""
        with self._lock:
            parts = self._topics.get(topic)
            if parts is None:
                return 0
            return len(parts[partition])


class StreamSource(Source):
    """Consumer-group Source over a Broker (idk/kafka/source.go:34).

    Iteration resumes from the group's committed offsets; commit()
    advances them only for records already yielded — the at-least-once
    contract idk relies on (uncommitted records are re-delivered after
    a crash, and imports are idempotent so replays are safe).
    """

    def __init__(self, broker: Broker, topic: str, group: str = "g0",
                 schema: dict | None = None, poll_batch: int = 500):
        self.broker = broker
        self.topic = topic
        self.group = group
        self.schema = dict(schema or {})
        self.id_keys = False
        self.poll_batch = poll_batch
        self._pending: list[tuple[int, int]] = []  # (partition, offset+1)
        self._yielded = 0
        # records re-delivered because a previous consumer crashed
        # before committing their offsets (broker-side watermark)
        self.replayed = 0

    def _detect(self, obj: dict):
        """Schema detection from message values (idk schema detect)."""
        for k, v in obj.items():
            if k in ("_id", "_ts") or k in self.schema:
                continue
            if isinstance(v, bool):
                t = {"type": "bool"}
            elif isinstance(v, int):
                t = {"type": "int", "min": -(1 << 31), "max": 1 << 31}
            elif isinstance(v, float):
                t = {"type": "decimal", "scale": 4}
            elif isinstance(v, list):
                t = {"type": "set",
                     "keys": bool(v and isinstance(v[0], str))}
            else:
                t = {"type": "set", "keys": True}
            self.schema[k] = t

    def __iter__(self):
        committed = self.broker.committed(self.group, self.topic)
        cursors = {p: committed.get(p, 0)
                   for p in self.broker.partitions(self.topic)}
        progress = True
        while progress:
            progress = False
            for p in sorted(cursors):
                got = self.broker.fetch(self.topic, p, cursors[p],
                                        self.poll_batch)
                mark = getattr(self.broker, "delivered_mark", None)
                for off, raw in got:
                    if mark is not None and mark(self.group, self.topic,
                                                 p, off):
                        self.replayed += 1
                        from pilosa_tpu_torch.obs import metrics
                        metrics.INGEST_REPLAYED.inc(topic=self.topic)
                    obj = json.loads(raw.decode())
                    if isinstance(obj.get("_id"), str):
                        self.id_keys = True
                    self._detect(obj)
                    rec = Record(
                        id=obj.get("_id"),
                        values={k: v for k, v in obj.items()
                                if k not in ("_id", "_ts")},
                        time=obj.get("_ts"))
                    self._pending.append((p, off + 1))
                    self._yielded += 1
                    yield rec
                if got:
                    cursors[p] = got[-1][0] + 1
                    progress = True
        # one poll sweep with no progress ends the iteration (batch
        # mode); a live consumer would block on new messages instead

    def commit(self, n: int):
        """Commit offsets for the `n` OLDEST still-pending records —
        the ones the caller just flushed downstream.  Records yielded
        but not yet flushed stay pending, so a crash re-delivers them
        (at-least-once, idk/ingest.go:1062 commitRecord).

        With a shared source across pipeline workers the FIFO
        assumption is approximate; the reference gives each concurrent
        ingester its OWN consumer (idk/ingest.go:302 m.clone()) — do
        the same for strict guarantees.
        """
        if not self._pending or n <= 0:
            return
        # chaos seam: die after the batch durably landed but BEFORE
        # the offsets commit — the crash window exactly-once replay
        # must absorb (the records re-deliver; applying them again is
        # idempotent, so the replay is exactly-once observable)
        from pilosa_tpu_torch.obs import faults
        faults.fire("crash-pre-commit", f"{self.topic}@{self.group}")
        done, self._pending = self._pending[:n], self._pending[n:]
        offsets: dict[int, int] = {}
        for p, upto in done:
            offsets[p] = max(offsets.get(p, 0), upto)
        self.broker.commit_offsets(self.group, self.topic, offsets)


class SQLSource(Source):
    """Rows from a SQL database as Records (idk/sql analog; sqlite3
    via the stdlib — any DB-API cursor shape works)."""

    def __init__(self, conn, query: str, id_column: str = "_id",
                 schema: dict | None = None):
        self.conn = conn
        self.query = query
        self.id_column = id_column
        cur = conn.execute(query)
        self._names = [d[0] for d in cur.description]
        self._rows = cur.fetchall()
        if id_column not in self._names:
            raise ValueError(f"query must select {id_column!r}")
        self.id_keys = any(isinstance(r[self._names.index(id_column)],
                                      str) for r in self._rows)
        if schema is None:
            schema = {}
            idx_id = self._names.index(id_column)
            for i, n in enumerate(self._names):
                if i == idx_id:
                    continue
                sample = next((r[i] for r in self._rows
                               if r[i] is not None), None)
                if isinstance(sample, bool):
                    schema[n] = {"type": "bool"}
                elif isinstance(sample, int):
                    schema[n] = {"type": "int",
                                 "min": -(1 << 31), "max": 1 << 31}
                elif isinstance(sample, float):
                    schema[n] = {"type": "decimal", "scale": 4}
                else:
                    schema[n] = {"type": "set", "keys": True}
        self.schema = schema

    def __iter__(self):
        idx_id = self._names.index(self.id_column)
        for row in self._rows:
            values = {n: row[i] for i, n in enumerate(self._names)
                      if i != idx_id and row[i] is not None}
            yield Record(id=row[idx_id], values=values)


class KinesisSource(StreamSource):
    """Kinesis-semantics source (idk/kinesis): shard iterators with a
    start position instead of consumer-group offsets.

    - ``TRIM_HORIZON`` starts at the oldest retained record;
    - ``LATEST`` starts at the stream head (only NEW records);
    - ``RESUME`` (the checkpointing mode) behaves like StreamSource:
      continue from the committed checkpoint.

    Checkpoints commit through the same group-offset store, so the
    at-least-once replay contract matches the Kafka source.
    """

    def __init__(self, broker: Broker, topic: str, group: str = "g0",
                 iterator_type: str = "RESUME", poll_batch: int = 500,
                 schema: dict | None = None):
        super().__init__(broker, topic, group=group, schema=schema,
                         poll_batch=poll_batch)
        it = iterator_type.upper()
        if it not in ("TRIM_HORIZON", "LATEST", "RESUME"):
            raise ValueError(f"unknown iterator type {iterator_type!r}")
        # a LATEST source built before the first produce must still
        # pin head checkpoints — materialize the topic's partitions
        self.broker.create_topic(topic)
        if it == "TRIM_HORIZON":
            # a true seek: existing checkpoints rewind too
            self.broker.reset_offsets(
                group, topic,
                {p: 0 for p in broker.partitions(topic)})
        elif it == "LATEST":
            self.broker.reset_offsets(
                group, topic,
                {p: broker.head(topic, p)
                 for p in broker.partitions(topic)})
