"""Index — a namespace of fields (index.go:27).

Column existence is tracked in a hidden ``_exists`` field when
track_existence is on (index.go existenceFieldName); it backs Not() and
All().  A keyed index (``keys=True``) translates string column keys to
column ids through a ``PartitionedTranslator`` (``column_translator``).

Given a path, the index persists as the JAX package's does: its
fragments in ``<path>/backends/shard.%04d.rbf`` (``IndexStorage``), its
column keys in ``<path>/_keys/``, and each field's row keys in
``<path>/fields/<field>/keys.jsonl``.  ``sync`` writes the dirty rows;
``load_fragments`` makes every fragment found on disk.

``dataframe`` is the index's columnar companion store
(``models/dataframe.py``), made at first use; ``sync`` saves its new
rows to ``<path>/dataframe.parquet``.
"""

from __future__ import annotations

import os
import shutil
import threading

import numpy as np

from pilosa_tpu_torch.models.dataframe import IndexDataframe
from pilosa_tpu_torch.models.field import Field
from pilosa_tpu_torch.models.fragment import bump_mutation_epoch
from pilosa_tpu_torch.models.schema import FieldOptions, FieldType
from pilosa_tpu_torch.models.view import VIEW_STANDARD, bsi_view_name
from pilosa_tpu_torch.shardwidth import BSI_OFFSET_BIT, SHARD_WIDTH
from pilosa_tpu_torch.storage.shards import IndexStorage
from pilosa_tpu_torch.storage.translate import (
    PartitionedTranslator,
    key_to_key_partition,
    shard_to_shard_partition,
)

EXISTENCE_FIELD = "_exists"


class Index:
    def __init__(self, name: str, keys: bool = False,
                 track_existence: bool = True, width: int = SHARD_WIDTH,
                 path: str | None = None):
        self.name = name
        self.keys = keys
        self.track_existence = track_existence
        self.width = width
        self.path = path
        self.fields: dict[str, Field] = {}
        self._lock = threading.RLock()
        self._column_translator: PartitionedTranslator | None = None
        self._dataframe: IndexDataframe | None = None
        self.storage = IndexStorage(path) if path is not None else None
        if track_existence:
            self._ensure_existence()

    @property
    def dataframe(self) -> IndexDataframe:
        """The index's dataframe (apply.go, arrow.go; the
        /index/{i}/dataframe route), made at first use and loaded from
        the index's path when one was saved there."""
        with self._lock:  # two racing first uses must not make two
            if self._dataframe is None:
                self._dataframe = IndexDataframe(self.path)
            return self._dataframe

    @property
    def column_translator(self) -> PartitionedTranslator | None:
        """The partitioned column-key translator of a keys=True index,
        made at first use; None on an unkeyed index."""
        if not self.keys:
            return None
        with self._lock:
            if self._column_translator is None:
                tpath = os.path.join(self.path, "_keys") if self.path else None
                self._column_translator = PartitionedTranslator(
                    self.name, tpath, shard_width=self.width)
            return self._column_translator

    def _ensure_existence(self) -> Field:
        with self._lock:
            f = self.fields.get(EXISTENCE_FIELD)
            if f is None:
                f = Field(self.name, EXISTENCE_FIELD,
                          FieldOptions(type=FieldType.SET), self.width,
                          storage=self.storage)
                self.fields[EXISTENCE_FIELD] = f
            return f

    def _field_path(self, name: str) -> str | None:
        return os.path.join(self.path, "fields", name) if self.path else None

    def create_field(self, name: str, options: FieldOptions | None = None,
                     ok_if_exists: bool = False) -> Field:
        with self._lock:
            if name in self.fields:
                if ok_if_exists or name == EXISTENCE_FIELD:
                    return self.fields[name]
                raise ValueError(f"field already exists: {name}")
            f = Field(self.name, name, options, self.width,
                      path=self._field_path(name), storage=self.storage)
            self.fields[name] = f
            return f

    def field(self, name: str) -> Field | None:
        return self.fields.get(name)

    def clone_to(self, dst: "Index") -> None:
        """Deep-copy this index's schema, bitmaps (every view), key
        translations and BSI depths into ``dst``, a fresh index with the
        same ``keys`` (SQL COPY).  Column keys re-partition under dst's
        name, since a partition hashes the index name: each goes to its
        key's partition and, where that differs, its shard's too."""
        if self.keys:
            src_ct, ct = self.column_translator, dst.column_translator
            for p in src_ct.nonempty_partitions():
                for i, k in src_ct._store(p).entries():
                    fwd = key_to_key_partition(dst.name, k)
                    rev = shard_to_shard_partition(dst.name, i // ct.shard_width)
                    ct._store(fwd).force_set(i, k)
                    if rev != fwd:
                        ct._store(rev).force_set(i, k)

        def copy_field(f, nf):
            nf.bit_depth = f.bit_depth
            if f.row_translator is not None and nf.row_translator is not None:
                for i, k in f.row_translator.entries():
                    nf.row_translator.force_set(i, k)
            for vn, v in f.views.items():
                nv = nf.view(vn, create=True)
                for shard, frag in v.fragments.items():
                    nfrag = nv.fragment(shard, create=True)
                    for r in frag.row_ids:
                        nfrag.set_row_words(r, frag.row_words(r))

        bump_mutation_epoch()
        for f in self.public_fields():
            copy_field(f, dst.create_field(f.name, f.options))
        ef = self.fields.get(EXISTENCE_FIELD)
        if ef is not None:
            copy_field(ef, dst._ensure_existence())

    def rename_field(self, old: str, new: str) -> None:
        """ALTER TABLE .. RENAME COLUMN (sql3/planner/
        compilealtertable.go): the field takes the new name with its
        views, fragments and row-key directory, and its persisted
        bitmaps are written under the new name and dropped under the
        old.  A device stack left under the old name (``StackCache``)
        serves nothing stale: an entry is served only while its
        fragment slots' (gen, version) stamps match, and a field made
        later under the old name has fragments of new gens."""
        with self._lock:
            f = self.fields.get(old)
            if f is None:
                raise ValueError(f"field not found: {old}")
            if new in self.fields or new == EXISTENCE_FIELD:
                raise ValueError(f"field already exists: {new}")
            # the rows now answer under another name
            bump_mutation_epoch()
            del self.fields[old]
            f.name = new
            self.fields[new] = f
            oldp, newp = self._field_path(old), self._field_path(new)
            if oldp and os.path.isdir(oldp):
                os.rename(oldp, newp)  # open key logs survive a rename
            if f.path:
                f.path = newp
            old_bsi, new_bsi = bsi_view_name(old), bsi_view_name(new)
            for vn in list(f.views):
                v = f.views[vn]
                v.field_name = new
                nvn = new_bsi if vn == old_bsi else vn
                for frag in v.fragments.values():
                    frag.field_name = new
                    frag.view_name = nvn
                    # every row is written again under the new name
                    frag.dirty_rows.update(frag._rows)
                    frag.dirty_rows.update(frag._sparse)
                if nvn != vn:
                    v.name = nvn
                    f.views[nvn] = f.views.pop(vn)
        if self.storage is not None:
            self.sync()
            self.storage.delete_field_bitmaps(old)

    def delete_field(self, name: str) -> None:
        """Drop a field with its bitmaps and its row-key files, so a
        field made again under the name starts empty."""
        with self._lock:
            f = self.fields.pop(name, None)
            if f is None:
                return
            # a deletion touches no fragment: the epoch must still move
            bump_mutation_epoch()
            if self.storage is not None:
                self.storage.delete_field_bitmaps(name)
            f.close()
            fp = self._field_path(name)
            if fp and os.path.isdir(fp):
                shutil.rmtree(fp)

    def existence_row(self, shard: int):
        """Packed existence words of a shard (None if untracked or
        absent)."""
        f = self.fields.get(EXISTENCE_FIELD)
        v = f.views.get(VIEW_STANDARD) if f is not None else None
        frag = v.fragment(shard) if v else None
        return frag.row_words(0) if frag else None

    def public_fields(self) -> list[Field]:
        return [f for n, f in sorted(self.fields.items())
                if n != EXISTENCE_FIELD]

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

    # -- persistence -------------------------------------------------------

    def sync(self) -> None:
        """Persist every dirty fragment row, one write transaction a
        shard file, and the dataframe's new rows."""
        if self._dataframe is not None:
            self._dataframe.sync()
        if self.storage is None:
            return
        with self._lock:
            by_shard: dict[int, list] = {}
            # syncs of an index run one at a time under its lock, so a
            # write's own sync ends after any sync that took its rows;
            # writers may add views and fragments meanwhile
            for f in list(self.fields.values()):
                for v in list(f.views.values()):
                    for frag in list(v.fragments.values()):
                        if frag.dirty_rows:
                            by_shard.setdefault(frag.shard, []).append(frag)
            for shard in sorted(by_shard):
                self.storage.write_fragments(by_shard[shard])

    def load_fragments(self) -> None:
        """Make every fragment found on disk (an open of the holder); a
        BSI field's depth comes back from its highest stored plane."""
        if self.storage is None:
            return
        with self._lock:
            for fname, vname, shard in self.storage.discover():
                f = self.fields.get(fname)
                if f is None:
                    continue  # a bitmap of a field no longer in the schema
                frag = f.view(vname, create=True).fragment(shard, create=True)
                if f.options.type.is_bsi:
                    depth = frag.max_row_id() - BSI_OFFSET_BIT + 1
                    f.bit_depth = max(f.bit_depth, depth)

    def close(self) -> None:
        """Close the shard files and the key translators, and let the
        dataframe go (``sync`` saves it; close does not, as in the JAX
        package)."""
        self._dataframe = None
        if self.storage is not None:
            self.storage.close()
        if self._column_translator is not None:
            self._column_translator.close()
            self._column_translator = None
        for f in self.fields.values():
            f.close()

    def to_dict(self) -> dict:
        return {"name": self.name,
                "options": {"keys": self.keys,
                            "trackExistence": self.track_existence},
                "fields": [f.to_dict() for f in self.public_fields()]}
