"""User-facing client library — ORM-style schema + PQL builders.

Reference: client/ (client.go:45 Client, :281 shard-aware import) and
its ORM layer: ``Schema`` -> ``Index`` -> ``Field`` builders whose
methods compose PQL call objects (client/orm.go), executed via
``Client.query``.  HTTP JSON against the server's public routes.

    c = Client("127.0.0.1:10101")
    schema = c.schema()
    idx = schema.index("events")
    f = idx.field("user", keys=True)
    c.sync_schema(schema)
    c.query(idx.count(f.row("alice") & f.row("bob")))
"""

from __future__ import annotations

from pilosa_tpu_torch.cluster.client import InternalClient, RemoteError  # noqa: F401


class PQL:
    """A composable PQL call expression (client/orm.go PQLQuery)."""

    def __init__(self, index: "IndexDef", text: str):
        self.index = index
        self.text = text

    # set algebra composes like the ORM's Union/Intersect/... builders
    def __and__(self, other):
        return PQL(self.index, f"Intersect({self.text}, {other.text})")

    def __or__(self, other):
        return PQL(self.index, f"Union({self.text}, {other.text})")

    def __xor__(self, other):
        return PQL(self.index, f"Xor({self.text}, {other.text})")

    def __sub__(self, other):
        return PQL(self.index, f"Difference({self.text}, {other.text})")

    def __invert__(self):
        return PQL(self.index, f"Not({self.text})")

    def __repr__(self):
        return f"PQL({self.text!r})"


def _lit(v) -> str:
    if isinstance(v, str):
        return '"' + v.replace("\\", "\\\\").replace('"', '\\"') + '"'
    if isinstance(v, bool):
        return "true" if v else "false"
    return str(v)


class FieldDef:
    def __init__(self, index: "IndexDef", name: str, **options):
        self.index = index
        self.name = name
        self.options = options or {"type": "set"}

    # -- row-level builders (client/orm.go PQLRowQuery) ---------------

    def row(self, value) -> PQL:
        return PQL(self.index, f"Row({self.name}={_lit(value)})")

    def set(self, col, value) -> PQL:
        return PQL(self.index,
                   f"Set({_lit(col)}, {self.name}={_lit(value)})")

    def clear(self, col, value) -> PQL:
        return PQL(self.index,
                   f"Clear({_lit(col)}, {self.name}={_lit(value)})")

    def topn(self, n: int, filter: PQL | None = None) -> PQL:
        inner = f", {filter.text}" if filter else ""
        return PQL(self.index, f"TopN({self.name}{inner}, n={n})")

    def rows(self) -> PQL:
        return PQL(self.index, f"Rows({self.name})")

    def sum(self, filter: PQL | None = None) -> PQL:
        inner = f"{filter.text}, " if filter else ""
        return PQL(self.index, f"Sum({inner}field={self.name})")

    def min(self, filter: PQL | None = None) -> PQL:
        inner = f"{filter.text}, " if filter else ""
        return PQL(self.index, f"Min({inner}field={self.name})")

    def max(self, filter: PQL | None = None) -> PQL:
        inner = f"{filter.text}, " if filter else ""
        return PQL(self.index, f"Max({inner}field={self.name})")

    def gt(self, v) -> PQL:
        return PQL(self.index, f"Row({self.name} > {_lit(v)})")

    def lt(self, v) -> PQL:
        return PQL(self.index, f"Row({self.name} < {_lit(v)})")

    def between(self, lo, hi) -> PQL:
        return PQL(self.index,
                   f"Row({self.name} >< [{_lit(lo)},{_lit(hi)}])")


class IndexDef:
    def __init__(self, schema: "Schema", name: str, keys: bool = False):
        self.schema = schema
        self.name = name
        self.keys = keys
        self.fields: dict[str, FieldDef] = {}

    def field(self, name: str, **options) -> FieldDef:
        f = self.fields.get(name)
        if f is None:
            f = self.fields[name] = FieldDef(self, name, **options)
        return f

    def count(self, row: PQL) -> PQL:
        return PQL(self, f"Count({row.text})")

    def group_by(self, *rows_calls: PQL) -> PQL:
        inner = ", ".join(r.text for r in rows_calls)
        return PQL(self, f"GroupBy({inner})")

    def batch_query(self, *calls: PQL) -> PQL:
        return PQL(self, "".join(c.text for c in calls))


class Schema:
    def __init__(self):
        self.indexes: dict[str, IndexDef] = {}

    def index(self, name: str, keys: bool = False) -> IndexDef:
        ix = self.indexes.get(name)
        if ix is None:
            ix = self.indexes[name] = IndexDef(self, name, keys=keys)
        return ix

    def to_dict(self) -> dict:
        return {"indexes": [
            {"name": ix.name, "keys": ix.keys,
             "fields": [{"name": f.name, "options": f.options}
                        for f in ix.fields.values()]}
            for ix in self.indexes.values()]}


class Client:
    """HTTP client (client.go:45)."""

    def __init__(self, host: str = "127.0.0.1:10101",
                 token: str | None = None, timeout: float = 60.0):
        self.host = host
        headers = {"Authorization": f"Bearer {token}"} if token else {}
        self._http = InternalClient(timeout=timeout, headers=headers)

    # -- schema --------------------------------------------------------

    def schema(self) -> Schema:
        """Server schema as builder objects (Client.Schema)."""
        got = self._http._request(self.host, "GET", "/schema")
        s = Schema()
        for ix in got.get("indexes", []):
            opts = ix.get("options", {})
            idef = s.index(ix["name"], keys=opts.get("keys", False))
            for f in ix.get("fields", []):
                idef.field(f["name"], **f.get("options", {}))
        return s

    def sync_schema(self, schema: Schema):
        """Create everything the schema declares (Client.SyncSchema)."""
        self._http._request(self.host, "POST", "/schema",
                            schema.to_dict())

    # -- queries -------------------------------------------------------

    def query(self, q: PQL) -> list:
        resp = self._http._request(
            self.host, "POST", f"/index/{q.index.name}/query",
            {"query": q.text})
        return resp["results"]

    def sql(self, statement: str) -> dict:
        return self._http._request(self.host, "POST", "/sql",
                                   {"sql": statement})

    # -- shard-aware import (client.go:281) ----------------------------

    def import_bits(self, index: str, field: str, bits,
                    batch_size: int = 1 << 16) -> int:
        """bits: iterable of (row, col); batched per request, grouped
        by shard server-side."""
        n = 0
        rows, cols = [], []
        for r, c in bits:
            rows.append(int(r))
            cols.append(int(c))
            if len(rows) >= batch_size:
                n += self._http.import_bits(self.host, index, field,
                                            rows, cols)
                rows, cols = [], []
        if rows:
            n += self._http.import_bits(self.host, index, field,
                                        rows, cols)
        return n

    def import_values(self, index: str, field: str, pairs,
                      batch_size: int = 1 << 16) -> int:
        n = 0
        cols, vals = [], []
        for c, v in pairs:
            cols.append(int(c))
            vals.append(v)
            if len(cols) >= batch_size:
                n += self._http.import_values(self.host, index, field,
                                              cols, vals)
                cols, vals = [], []
        if cols:
            n += self._http.import_values(self.host, index, field,
                                          cols, vals)
        return n

    def import_roaring(self, index: str, field: str, shard: int,
                       rows: dict, clear: bool = False) -> int:
        """rows: {row_id: roaring bytes or base64 str}."""
        import base64
        enc = {str(r): (base64.b64encode(b).decode()
                        if isinstance(b, (bytes, bytearray)) else b)
               for r, b in rows.items()}
        resp = self._http._request(
            self.host, "POST",
            f"/index/{index}/field/{field}/import-roaring/{shard}",
            {"rows": enc, "clear": clear})
        return resp["imported"]

    def status(self) -> dict:
        return self._http._request(self.host, "GET", "/status")
