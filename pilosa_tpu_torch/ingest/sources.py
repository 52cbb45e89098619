"""Ingest sources — CSV, datagen, and the Kafka gate (the in-process
broker's consumer is ``ingest/kafka.py``).

idk's pluggable ``Source`` (idk/kafka/source.go:34, idk/csv,
idk/datagen): a source yields ``Record``s and carries a field schema.
A CSV header types its columns as ``name:type`` (idk/csv's
``name__Int`` suffixes).
"""

from __future__ import annotations

import csv as _csv
import random

from pilosa_tpu_torch.ingest.batch import Record


class Source:
    """Iterable of Records with a schema (idk.Source analog)."""

    #: {field: {"type": ..., "keys": bool}}
    schema: dict

    def __iter__(self):
        raise NotImplementedError

    def commit(self, offset: int):
        """Offset commit hook (Kafka semantics); default no-op."""


_CSV_TYPES = {
    "id", "string", "int", "decimal", "timestamp", "bool",
    "idset", "stringset", "time",
}


def _parse_header(cols: list[str]):
    """``name:type`` header cells (default string→set field).  The
    ``_id`` / ``_id:string`` cell names the record id column; an
    optional ``_ts`` cell carries the record timestamp feeding any
    ``time``-typed fields' quantum views."""
    schema = {}
    id_col, id_keys = None, False
    fields = []
    for c in cols:
        name, _, typ = c.partition(":")
        typ = typ or {"_id": "id", "_ts": "timestamp"}.get(name, "string")
        # 'key' (valid only on _id) is the one annotation outside
        # _CSV_TYPES; _ts must be a timestamp
        if (typ not in _CSV_TYPES and
                not (name == "_id" and typ == "key")) or (
                name == "_ts" and typ != "timestamp"):
            raise ValueError(f"unknown csv type {typ!r} in column {c!r}")
        if name == "_ts":
            fields.append(("_ts", None))
            continue
        if name == "_id":
            id_col = name
            id_keys = typ in ("string", "key")
            fields.append(("_id", None))
            continue
        if typ in ("id", "idset"):
            schema[name] = {"type": "set", "keys": False}
        elif typ in ("string", "stringset"):
            schema[name] = {"type": "set", "keys": True}
        elif typ == "time":
            schema[name] = {"type": "time", "keys": False,
                            "time_quantum": "YMDH"}
        elif typ == "bool":
            schema[name] = {"type": "bool"}
        else:
            schema[name] = {"type": typ}
        fields.append((name, typ))
    if id_col is None:
        raise ValueError("csv needs an _id column")
    return schema, fields, id_keys


def _convert(typ: str, raw: str):
    if raw == "":
        return None
    if typ in ("id", "time"):
        # a time-typed cell is a row id; its timestamp comes from the
        # record's _ts column
        return int(raw)
    if typ == "int":
        return int(raw)
    if typ == "decimal":
        return float(raw)
    if typ == "bool":
        return raw.lower() in ("1", "true", "t", "yes")
    return raw


class CSVSource(Source):
    """CSV files with typed headers (idk/csv analog)."""

    def __init__(self, path_or_lines):
        if isinstance(path_or_lines, str):
            self._fh = open(path_or_lines, newline="")
            rows = _csv.reader(self._fh)
        else:
            self._fh = None
            rows = _csv.reader(path_or_lines)
        self._rows = iter(rows)
        header = next(self._rows)
        self.schema, self._fields, self.id_keys = _parse_header(header)

    def __iter__(self):
        for cells in self._rows:
            if not cells:
                continue
            rec_id = None
            rec_ts = None
            values = {}
            for (name, typ), raw in zip(self._fields, cells):
                if name == "_id":
                    rec_id = raw if self.id_keys else int(raw)
                    continue
                if name == "_ts":
                    rec_ts = raw or None
                    continue
                if typ in ("idset", "stringset") and raw:
                    values[name] = [ _convert("id" if typ == "idset"
                                              else "string", x)
                                     for x in raw.split(";") ]
                else:
                    v = _convert(typ, raw)
                    if v is not None:
                        values[name] = v
            yield Record(id=rec_id, values=values, time=rec_ts)
        if self._fh:
            self._fh.close()


class DatagenSource(Source):
    """Seeded synthetic records (idk/datagen analog) — used by tests
    and benchmarks to produce deterministic load without real data."""

    def __init__(self, n: int, seed: int = 0, n_rows: int = 16,
                 int_max: int = 1000, keys: bool = False):
        self.n = n
        self.seed = seed
        self.n_rows = n_rows
        self.int_max = int_max
        self.id_keys = keys
        self.schema = {
            "segment": {"type": "set", "keys": False},
            "amount": {"type": "int"},
            "active": {"type": "bool"},
        }

    def __iter__(self):
        rng = random.Random(self.seed)
        for i in range(self.n):
            rec_id = f"user{i}" if self.id_keys else i
            yield Record(id=rec_id, values={
                "segment": rng.randrange(self.n_rows),
                "amount": rng.randrange(self.int_max),
                "active": rng.random() < 0.5,
            })


class KafkaSource(Source):
    """The gate of a real Kafka consumer (idk/kafka/source.go:34), which
    needs confluent-kafka.  ``ingest/kafka.StreamSource`` gives the full
    consumer-group semantics (partitions, offset commits, resume) over
    the in-process ``Broker``."""

    def __init__(self, *a, **kw):
        raise NotImplementedError(
            "KafkaSource requires a kafka client (confluent-kafka); "
            "use pilosa_tpu_torch.ingest.kafka.StreamSource for the "
            "in-process broker")
