"""Index — a namespace of fields (index.go:27).

Column existence is tracked in a hidden ``_exists`` field when
track_existence is on (index.go existenceFieldName); it backs Not() and
All().  A keyed index (``keys=True``) translates string column keys to
column ids through a ``PartitionedTranslator`` (``column_translator``).
"""

from __future__ import annotations

import numpy as np

from pilosa_tpu_torch.models.field import Field
from pilosa_tpu_torch.models.schema import FieldOptions, FieldType
from pilosa_tpu_torch.shardwidth import SHARD_WIDTH
from pilosa_tpu_torch.storage.translate import PartitionedTranslator

EXISTENCE_FIELD = "_exists"


class Index:
    def __init__(self, name: str, keys: bool = False,
                 track_existence: bool = True, width: int = SHARD_WIDTH):
        self.name = name
        self.keys = keys
        self.track_existence = track_existence
        self.width = width
        self.fields: dict[str, Field] = {}
        self._column_translator: PartitionedTranslator | None = None
        if track_existence:
            self._ensure_existence()

    @property
    def column_translator(self) -> PartitionedTranslator | None:
        """The partitioned column-key translator of a keys=True index,
        made at first use; None on an unkeyed index."""
        if not self.keys:
            return None
        if self._column_translator is None:
            self._column_translator = PartitionedTranslator(
                self.name, shard_width=self.width)
        return self._column_translator

    def close(self) -> None:
        """Close the index's key translators (its own and its fields')."""
        if self._column_translator is not None:
            self._column_translator.close()
            self._column_translator = None
        for f in self.fields.values():
            f.close()

    def _ensure_existence(self) -> Field:
        f = self.fields.get(EXISTENCE_FIELD)
        if f is None:
            f = Field(self.name, EXISTENCE_FIELD,
                      FieldOptions(type=FieldType.SET), self.width)
            self.fields[EXISTENCE_FIELD] = f
        return f

    def create_field(self, name: str,
                     options: FieldOptions | None = None) -> Field:
        if name in self.fields:
            if name == EXISTENCE_FIELD:
                return self.fields[name]
            raise ValueError(f"field already exists: {name}")
        f = Field(self.name, name, options, self.width)
        self.fields[name] = f
        return f

    def field(self, name: str) -> Field | None:
        return self.fields.get(name)

    def mark_columns_exist(self, cols) -> None:
        if not self.track_existence:
            return
        cols = np.asarray(cols, dtype=np.int64)
        self._ensure_existence().import_bits(
            np.zeros(cols.size, dtype=np.int64), cols)

    @property
    def available_shards(self) -> set[int]:
        s: set[int] = set()
        for f in self.fields.values():
            s.update(f.available_shards)
        return s
