"""Holder — root of all data (holder.go:58): the index map.

An index is made keyed (string column keys) with
``create_index(name, keys=True)``.  Given a path, the holder persists as
the JAX package's does (holder.Open's schema load, holder.go:432): the
schema in ``<path>/schema.json`` (``save_schema``, the list of
``Index.to_dict``), each index under ``<path>/<index>/``; ``sync``
writes the schema and every dirty row, and ``load_schema`` on a new
holder over the path brings back the indexes, fields, rows and keys.
"""

from __future__ import annotations

import datetime as dt
import json
import os
import shutil
import threading

from pilosa_tpu_torch.models.fragment import bump_mutation_epoch
from pilosa_tpu_torch.models.index import Index
from pilosa_tpu_torch.models.schema import FieldOptions
from pilosa_tpu_torch.shardwidth import SHARD_WIDTH

SCHEMA_FILE = "schema.json"


class Holder:
    def __init__(self, path: str | None = None, width: int = SHARD_WIDTH):
        self.path = path
        self.width = width
        self.indexes: dict[str, Index] = {}
        self._lock = threading.RLock()

    def create_index(self, name: str, keys: bool = False,
                     track_existence: bool = True,
                     ok_if_exists: bool = False) -> Index:
        with self._lock:
            if name in self.indexes:
                if ok_if_exists:
                    return self.indexes[name]
                raise ValueError(f"index already exists: {name}")
            ipath = os.path.join(self.path, name) if self.path else None
            idx = Index(name, keys=keys, track_existence=track_existence,
                        width=self.width, path=ipath)
            self.indexes[name] = idx
            return idx

    def index(self, name: str) -> Index | None:
        return self.indexes.get(name)

    def delete_index(self, name: str) -> None:
        """Drop an index with everything it holds on disk (rows and
        keys), and from the saved schema: a reopen does not bring it
        back, and an index made again under the name starts empty."""
        bump_mutation_epoch()  # a deletion touches no fragment
        with self._lock:
            idx = self.indexes.pop(name, None)
            if idx is None:
                return
            idx.close()
            if idx.path and os.path.isdir(idx.path):
                shutil.rmtree(idx.path)
            self.save_schema()

    def sync(self) -> None:
        """Persist the schema and every dirty fragment row."""
        with self._lock:
            self.save_schema()
            for idx in self.indexes.values():
                idx.sync()

    def remove_expired_views(self, now: dt.datetime | None = None
                             ) -> list[str]:
        """The TTL sweep over every time field of every index (time.go:158
        and the holder's view-removal ticker): the names of the views
        removed.  The fields share one epoch latch, as the JAX
        package's sweep does (Field.remove_expired_views)."""
        removed: list[str] = []
        latch = [False]
        with self._lock:
            for idx in self.indexes.values():
                for f in idx.fields.values():
                    removed += f.remove_expired_views(now, epoch_latch=latch)
        return removed

    def rollup_views(self, now: dt.datetime | None = None
                     ) -> list[tuple[str, str, str, str]]:
        """The [timeq] rollup sweep over every time field: completed
        fine-unit views fold into their coarser parents
        (Field.rollup_views).  Returns the (index, field, child view,
        parent view) tuples folded."""
        folded = []
        with self._lock:
            for iname, idx in self.indexes.items():
                for f in idx.fields.values():
                    folded += [(iname, f.name, c, p)
                               for c, p in f.rollup_views(now)]
        return folded

    def close(self) -> None:
        with self._lock:
            for idx in self.indexes.values():
                idx.close()

    def schema(self) -> list[dict]:
        return [idx.to_dict() for _, idx in sorted(self.indexes.items())]

    # -- schema persistence ------------------------------------------------

    def save_schema(self) -> None:
        if not self.path:
            return
        os.makedirs(self.path, exist_ok=True)
        with open(os.path.join(self.path, SCHEMA_FILE), "w") as f:
            json.dump(self.schema(), f, indent=1)

    def load_schema(self) -> None:
        """Make the saved indexes and fields, and load their fragments."""
        if not self.path:
            return
        p = os.path.join(self.path, SCHEMA_FILE)
        if not os.path.exists(p):
            return
        with open(p) as f:
            saved = json.load(f)
        for idx_d in saved:
            opts = idx_d.get("options", {})
            idx = self.create_index(
                idx_d["name"], keys=opts.get("keys", False),
                track_existence=opts.get("trackExistence", True),
                ok_if_exists=True)
            for fd in idx_d.get("fields", []):
                idx.create_field(fd["name"],
                                 FieldOptions.from_dict(fd["options"]),
                                 ok_if_exists=True)
            idx.load_fragments()
