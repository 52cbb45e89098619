"""Importer — the bridge from client-side batches to the engine.

The reference's ``Importer`` interface (importer.go:13) and its
in-process implementation over the API (importer.go:34), and
``HTTPImporter`` over a node's HTTP import endpoints.
"""

from __future__ import annotations


class Importer:
    """Importer interface (importer.go:13)."""

    def import_bits(self, index: str, field: str, rows, cols,
                    timestamps=None, clear: bool = False,
                    mark_exists: bool = True) -> int:
        raise NotImplementedError

    def import_values(self, index: str, field: str, cols, values,
                      clear: bool = False,
                      mark_exists: bool = True) -> int:
        raise NotImplementedError

    def mark_columns_exist(self, index: str, cols) -> None:
        """Mark a columnar batch's records once; a no-op for importers
        whose imports always mark."""

    def create_keys(self, index: str, field: str | None,
                    keys: list[str]) -> dict[str, int]:
        raise NotImplementedError

    def apply_schema(self, schema: dict):
        raise NotImplementedError

    def sync(self, index: str) -> None:
        """The durability barrier: when it returns, every record the
        importer accepted for ``index`` survives a crash.  The Pipeline
        calls it before it commits source offsets (idk/ingest.go:1062,
        commit after land)."""


class APIImporter(Importer):
    """The in-process importer over ``api.API``."""

    def __init__(self, api):
        self.api = api

    def import_bits(self, index, field, rows, cols, timestamps=None,
                    clear=False, mark_exists=True):
        return self.api.import_bits(index, field, rows=rows, cols=cols,
                                    timestamps=timestamps, clear=clear,
                                    mark_exists=mark_exists)

    def import_values(self, index, field, cols, values, clear=False,
                      mark_exists=True):
        return self.api.import_values(index, field, cols=cols,
                                      values=values, clear=clear,
                                      mark_exists=mark_exists)

    def mark_columns_exist(self, index, cols):
        self.api.mark_columns_exist(index, cols)

    def create_keys(self, index, field, keys):
        ids = self.api.translate_keys(index, field, keys, create=True)
        return dict(zip(keys, ids))

    def apply_schema(self, schema):
        self.api.apply_schema(schema)

    def sync(self, index):
        """Write the index's dirty rows to its RBF files (one write
        transaction a shard, the WAL fsynced): a no-op for an index
        without a path."""
        self.api.sync(index)


class HTTPImporter(Importer):
    """Importer over the HTTP import endpoints of a node: the
    client-side half of the reference's shard-transactional import path
    (client/client.go import; api.go:618).  Every import the node
    acknowledges has landed there."""

    def __init__(self, host: str, client=None):
        from pilosa_tpu_torch.cluster.client import InternalClient
        # InternalClient addresses are host:port; tolerate a scheme
        self.host = host.split("://", 1)[-1]
        self.client = client or InternalClient()

    def import_bits(self, index, field, rows, cols, timestamps=None,
                    clear=False, mark_exists=True):
        return self.client.import_bits(self.host, index, field, rows, cols,
                                       timestamps=timestamps, clear=clear)

    def import_values(self, index, field, cols, values, clear=False,
                      mark_exists=True):
        return self.client.import_values(self.host, index, field, cols,
                                         values, clear=clear)

    def create_keys(self, index, field, keys):
        ids = self.client.create_keys(self.host, index, field, list(keys))
        return dict(zip(keys, ids))

    def apply_schema(self, schema):
        self.client._request(self.host, "POST", "/schema", schema)

    def import_columns(self, index, cols, bits=None, values=None) -> int:
        """A columnar binary import (POST /index/{i}/import-columns, an
        .npz payload), the bulk path of an out-of-process ingester
        (idk/ingest.go:319's per-clone shard imports)."""
        import io
        import json

        import numpy as np
        buf = io.BytesIO()
        arrays = {"cols": np.asarray(cols, dtype=np.int64)}
        for f, rows in (bits or {}).items():
            arrays[f"bits/{f}"] = np.asarray(rows, dtype=np.int64)
        for f, vals in (values or {}).items():
            arrays[f"values/{f}"] = np.asarray(vals, dtype=np.int64)
        np.savez(buf, **arrays)
        # through the shared client, so auth headers and RemoteError
        # handling match the other methods
        raw = self.client.post_raw(
            self.host, f"/index/{index}/import-columns", buf.getvalue())
        return json.loads(raw)["imported"]
