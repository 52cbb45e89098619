"""Holder — root of all data (holder.go:58): the index map.

Host rows only: an index is made keyed (string column keys) with
``create_index(name, keys=True)``.  Schema and bitmap persistence are
not ported yet.
"""

from __future__ import annotations

from pilosa_tpu_torch.models.index import Index
from pilosa_tpu_torch.shardwidth import SHARD_WIDTH


class Holder:
    def __init__(self, width: int = SHARD_WIDTH):
        self.width = width
        self.indexes: dict[str, Index] = {}

    def create_index(self, name: str, keys: bool = False,
                     track_existence: bool = True) -> Index:
        if name in self.indexes:
            raise ValueError(f"index already exists: {name}")
        idx = Index(name, keys=keys, track_existence=track_existence,
                    width=self.width)
        self.indexes[name] = idx
        return idx

    def index(self, name: str) -> Index | None:
        return self.indexes.get(name)

    def close(self) -> None:
        for idx in self.indexes.values():
            idx.close()
