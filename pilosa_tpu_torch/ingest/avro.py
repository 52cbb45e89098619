"""Avro + schema-registry decoding for the Kafka source.

Reference: idk/kafka/source.go:34 — the reference's Kafka consumer
decodes Confluent-framed Avro (magic byte 0, big-endian uint32 schema
id, Avro binary body), fetching writer schemas from a schema registry
and mapping Avro field types onto pilosa field types.  This module is
a dependency-free re-implementation of that subset:

- :class:`SchemaRegistry` — in-process registry with the Confluent
  surface shape (register(subject, schema) -> id, by_id(id)); tests
  use it as the "fake registry"; an HTTP registry adapter can drop in
  by implementing ``by_id``.
- :func:`encode` / :func:`decode` — Avro binary codec for the type
  subset idk ingests: null, boolean, int, long, float, double,
  string, bytes (incl. logicalType decimal), arrays, unions, and
  top-level records.
- :class:`AvroStreamSource` — a StreamSource whose messages are
  Confluent-framed Avro; the pilosa schema derives from the AVRO
  schema (registry-driven, not value-sniffed).
"""

from __future__ import annotations

import io
import json
import struct
import threading
from decimal import Decimal

from pilosa_tpu_torch.ingest.batch import Record
from pilosa_tpu_torch.ingest.kafka import StreamSource

WIRE_MAGIC = 0


class AvroError(Exception):
    pass


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

class SchemaRegistry:
    """In-process Confluent-shaped schema registry."""

    def __init__(self):
        self._by_id: dict[int, dict] = {}
        self._ids: dict[str, int] = {}   # canonical json -> id
        self._subjects: dict[str, list[int]] = {}
        self._next = 1
        self._lock = threading.Lock()

    def register(self, subject: str, schema: dict | str) -> int:
        if isinstance(schema, str):
            schema = json.loads(schema)
        canon = json.dumps(schema, sort_keys=True)
        with self._lock:
            sid = self._ids.get(canon)
            if sid is None:
                sid = self._next
                self._next += 1
                self._ids[canon] = sid
                self._by_id[sid] = schema
            self._subjects.setdefault(subject, [])
            if sid not in self._subjects[subject]:
                self._subjects[subject].append(sid)
            return sid

    def by_id(self, schema_id: int) -> dict:
        with self._lock:
            s = self._by_id.get(schema_id)
        if s is None:
            raise AvroError(f"schema id {schema_id} not registered")
        return s

    def latest(self, subject: str) -> tuple[int, dict]:
        with self._lock:
            ids = self._subjects.get(subject)
            if not ids:
                raise AvroError(f"no versions for subject {subject}")
            return ids[-1], self._by_id[ids[-1]]


# ---------------------------------------------------------------------------
# binary codec
# ---------------------------------------------------------------------------

def _zigzag_encode(n: int) -> bytes:
    u = (n << 1) ^ (n >> 63)
    out = bytearray()
    while True:
        b = u & 0x7F
        u >>= 7
        if u:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _zigzag_decode(buf: io.BytesIO) -> int:
    shift, u = 0, 0
    while True:
        raw = buf.read(1)
        if not raw:
            raise AvroError("truncated varint")
        b = raw[0]
        u |= (b & 0x7F) << shift
        if not b & 0x80:
            break
        shift += 7
    return (u >> 1) ^ -(u & 1)


def _type_of(schema):
    if isinstance(schema, str):
        return schema
    if isinstance(schema, list):
        return "union"
    return schema["type"]


def _encode_value(schema, v, out: bytearray):
    t = _type_of(schema)
    if t == "union":
        for i, branch in enumerate(schema):
            bt = _type_of(branch)
            if (v is None) == (bt == "null"):
                out += _zigzag_encode(i)
                if bt != "null":
                    _encode_value(branch, v, out)
                return
        raise AvroError(f"no union branch for {v!r}")
    if t == "null":
        return
    if t == "boolean":
        out.append(1 if v else 0)
    elif t in ("int", "long"):
        out += _zigzag_encode(int(v))
    elif t == "float":
        out += struct.pack("<f", float(v))
    elif t == "double":
        out += struct.pack("<d", float(v))
    elif t == "string":
        raw = str(v).encode()
        out += _zigzag_encode(len(raw)) + raw
    elif t == "bytes":
        if isinstance(schema, dict) and \
                schema.get("logicalType") == "decimal":
            scale = int(schema.get("scale", 0))
            unscaled = int(Decimal(str(v)).scaleb(scale))
            blen = max(1, (unscaled.bit_length() + 8) // 8)
            raw = unscaled.to_bytes(blen, "big", signed=True)
        else:
            raw = bytes(v)
        out += _zigzag_encode(len(raw)) + raw
    elif t == "array":
        if v:
            out += _zigzag_encode(len(v))
            for item in v:
                _encode_value(schema["items"], item, out)
        out += _zigzag_encode(0)
    elif t == "record":
        for f in schema["fields"]:
            _encode_value(f["type"], v.get(f["name"]), out)
    else:
        raise AvroError(f"unsupported avro type {t!r}")


def _decode_value(schema, buf: io.BytesIO):
    t = _type_of(schema)
    if t == "union":
        i = _zigzag_decode(buf)
        if not 0 <= i < len(schema):
            raise AvroError(f"bad union branch {i}")
        return _decode_value(schema[i], buf)
    if t == "null":
        return None
    if t == "boolean":
        return buf.read(1) == b"\x01"
    if t in ("int", "long"):
        return _zigzag_decode(buf)
    if t == "float":
        return struct.unpack("<f", buf.read(4))[0]
    if t == "double":
        return struct.unpack("<d", buf.read(8))[0]
    if t == "string":
        n = _zigzag_decode(buf)
        return buf.read(n).decode()
    if t == "bytes":
        n = _zigzag_decode(buf)
        raw = buf.read(n)
        if isinstance(schema, dict) and \
                schema.get("logicalType") == "decimal":
            scale = int(schema.get("scale", 0))
            unscaled = int.from_bytes(raw, "big", signed=True)
            return Decimal(unscaled).scaleb(-scale)
        return raw
    if t == "array":
        out = []
        while True:
            n = _zigzag_decode(buf)
            if n == 0:
                return out
            if n < 0:  # block with byte-size prefix
                n = -n
                _zigzag_decode(buf)
            for _ in range(n):
                out.append(_decode_value(schema["items"], buf))
    if t == "record":
        return {f["name"]: _decode_value(f["type"], buf)
                for f in schema["fields"]}
    raise AvroError(f"unsupported avro type {t!r}")


def encode(schema: dict, value: dict) -> bytes:
    out = bytearray()
    _encode_value(schema, value, out)
    return bytes(out)


def decode(schema: dict, data: bytes) -> dict:
    return _decode_value(schema, io.BytesIO(data))


def frame(schema_id: int, body: bytes) -> bytes:
    """Confluent wire format: magic 0 + uint32 schema id + body."""
    return struct.pack(">bI", WIRE_MAGIC, schema_id) + body


def unframe(msg: bytes) -> tuple[int, bytes]:
    if len(msg) < 5 or msg[0] != WIRE_MAGIC:
        raise AvroError("not a Confluent-framed Avro message")
    (sid,) = struct.unpack(">I", msg[1:5])
    return sid, msg[5:]


# ---------------------------------------------------------------------------
# source
# ---------------------------------------------------------------------------

def _field_schema(avro_field_type) -> dict | None:
    """Avro field type -> pilosa field options (idk avro mapping)."""
    t = _type_of(avro_field_type)
    if t == "union":
        branches = [b for b in avro_field_type if _type_of(b) != "null"]
        if len(branches) != 1:
            raise AvroError("only [null, T] unions are ingestable")
        return _field_schema(branches[0])
    if t == "string":
        return {"type": "set", "keys": True}
    if t in ("int", "long"):
        return {"type": "int", "min": -(1 << 62), "max": 1 << 62}
    if t == "boolean":
        return {"type": "bool"}
    if t in ("float", "double"):
        return {"type": "decimal", "scale": 4}
    if t == "bytes":
        if isinstance(avro_field_type, dict) and \
                avro_field_type.get("logicalType") == "decimal":
            return {"type": "decimal",
                    "scale": int(avro_field_type.get("scale", 0))}
        return None  # opaque bytes are not a pilosa field
    if t == "array":
        it = _type_of(avro_field_type["items"])
        return {"type": "set", "keys": it == "string"}
    return None


class AvroStreamSource(StreamSource):
    """Confluent-framed Avro over the broker, schemas from a registry.

    The pilosa schema comes from the writer's Avro record schema
    (fields named ``_id``/``_ts`` map to record id / time), refreshed
    per message so schema evolution (a new registered version) is
    picked up mid-stream like idk's registry client."""

    def __init__(self, broker, topic: str, registry: SchemaRegistry,
                 group: str = "g0", poll_batch: int = 500,
                 subject: str | None = None):
        super().__init__(broker, topic, group=group,
                         poll_batch=poll_batch)
        self.registry = registry
        # idk resolves the subject's schema BEFORE consuming, so the
        # pilosa schema exists before the first message arrives
        # (convention: "<topic>-value")
        try:
            _, schema = registry.latest(subject or f"{topic}-value")
            self._apply_avro_schema(schema)
        except AvroError:
            pass  # unknown subject: detect from the first message

    def _apply_avro_schema(self, schema: dict):
        if _type_of(schema) != "record":
            raise AvroError("top-level Avro schema must be a record")
        for f in schema["fields"]:
            if f["name"] in ("_id", "_ts") or f["name"] in self.schema:
                continue
            fs = _field_schema(f["type"])
            if fs is not None:
                self.schema[f["name"]] = fs

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
                for off, raw in got:
                    sid, body = unframe(raw)
                    schema = self.registry.by_id(sid)
                    self._apply_avro_schema(schema)
                    obj = decode(schema, body)
                    if isinstance(obj.get("_id"), str):
                        self.id_keys = True
                    rec = Record(
                        id=obj.get("_id"),
                        values={k: v for k, v in obj.items()
                                if k not in ("_id", "_ts")
                                and k in self.schema},
                        time=obj.get("_ts"))
                    self._pending.append((p, off + 1))
                    self._yielded += 1
                    yield rec
                if got:
                    cursors[p] = got[-1][0] + 1
                    progress = True
