"""Statistics catalog, the data plane the SQL cost planner reads.

The JAX package's ``obs/stats.py`` keeps two planes: per-(index,
field) data stats maintained from the ingest path, and per-plan-
fingerprint runtime profiles folded from flight records.  The port
keeps the first, as far as SQL and the API read it:

- ``note_ingest`` (called by ``API.import_bits``/``import_values``
  after the write landed) folds one import into the field's row set,
  per-shard bit counts and value range;
- ``StatsCatalog.est_index_rows`` gives ``sql/costplan.py`` a table's
  record count, the input of its join ordering;
- ``note_page_encoding`` tallies the stack cache's page encodings per
  field (memory/encode.py), and ``field_density`` gives the encoder its
  skip-the-scan hint.

The runtime profiles, ``note_flight`` and ``est_cost_ms`` come with the
serving plane.  The switch goes through ``configure(enabled=...)``
only (on by default, as in the JAX package); the port reads no
environment variable for it.  Stats steer plans, never results.
"""

from __future__ import annotations

import threading

import numpy as np

# ingest row sets are capped (the JAX package's _ROWS_CAP)
_ROWS_CAP = 8192

_enabled = True


def enabled() -> bool:
    return _enabled


class FieldStats:
    """Data-plane stats for one (index, field)."""

    __slots__ = ("rows", "rows_capped", "shard_bits", "vmin", "vmax",
                 "vcount", "encodings")

    def __init__(self):
        self.rows: set[int] = set()
        self.rows_capped = False
        self.shard_bits: dict[int, int] = {}
        self.vmin: float | None = None
        self.vmax: float | None = None
        self.vcount = 0
        # page encodings chosen for this field's pages (kind -> pages)
        self.encodings: dict[str, int] = {}

    def note(self, rows, shard_bits: dict, vmin=None, vmax=None,
             vcount: int = 0):
        for r in rows:
            if len(self.rows) >= _ROWS_CAP:
                self.rows_capped = True
                break
            self.rows.add(int(r))
        for s, n in shard_bits.items():
            self.shard_bits[int(s)] = self.shard_bits.get(int(s), 0) + int(n)
        if vmin is not None:
            self.vmin = vmin if self.vmin is None else min(self.vmin, vmin)
        if vmax is not None:
            self.vmax = vmax if self.vmax is None else max(self.vmax, vmax)
        self.vcount += int(vcount)

    def skew(self) -> float | None:
        """Max-shard over mean-shard bit count (1.0 is even)."""
        if not self.shard_bits:
            return None
        vals = list(self.shard_bits.values())
        mean = sum(vals) / len(vals)
        return round(max(vals) / mean, 4) if mean > 0 else None

    def payload(self) -> dict:
        out = {"rows": len(self.rows), "rows_capped": self.rows_capped,
               "shards": len(self.shard_bits),
               "bits": sum(self.shard_bits.values())}
        skew = self.skew()
        if skew is not None:
            out["shard_skew"] = skew
        if self.vcount:
            out["values"] = {"count": self.vcount, "min": self.vmin,
                             "max": self.vmax}
        if self.encodings:
            out["encodings"] = dict(self.encodings)
        return out


class StatsCatalog:
    """The process's per-(index, field) ingest stats."""

    def __init__(self):
        self._lock = threading.Lock()
        self._fields: dict[tuple[str, str], FieldStats] = {}

    def note_ingest(self, index: str, field: str, rows=None, cols=None,
                    values=None, width: int = 1 << 20):
        """Fold one import call into the field's stats."""
        rows_l: list = []
        sb: dict = {}
        vmin = vmax = None
        vn = 0
        if rows is not None and len(rows):
            uniq = np.unique(np.asarray(rows).astype(np.int64))
            rows_l = [int(r) for r in uniq[:_ROWS_CAP]]
        if cols is not None and len(cols):
            sh, cnt = np.unique(np.asarray(cols).astype(np.int64) // width,
                                return_counts=True)
            sb = {int(s): int(c) for s, c in zip(sh, cnt)}
        if values is not None and len(values):
            va = np.asarray(values)
            if va.dtype.kind in "iu":
                vmin, vmax, vn = int(va.min()), int(va.max()), int(va.size)
            elif va.dtype.kind == "f":
                vmin, vmax = float(va.min()), float(va.max())
                vn = int(va.size)
        with self._lock:
            fs = self._fields.get((index, field))
            if fs is None:
                fs = self._fields[(index, field)] = FieldStats()
            fs.note(rows_l, sb, vmin=vmin, vmax=vmax, vcount=vn)

    def note_page_encoding(self, index: str, field: str, kind: str):
        """Tally one page-encoding decision for a field's pages."""
        with self._lock:
            fs = self._fields.get((index, field))
            if fs is None:
                fs = self._fields[(index, field)] = FieldStats()
            fs.encodings[kind] = fs.encodings.get(kind, 0) + 1

    def field_density(self, index: str, field: str,
                      width_bits: int) -> float | None:
        """Estimated set-bit density of one (row, shard) slab of the
        field, or None when the catalog cannot say (no ingest stats, or
        a capped row set, which would overstate it)."""
        with self._lock:
            fs = self._fields.get((index, field))
            if (fs is None or fs.rows_capped or not fs.rows
                    or not fs.shard_bits or width_bits <= 0):
                return None
            total = sum(fs.shard_bits.values())
            slots = len(fs.rows) * len(fs.shard_bits) * width_bits
        return total / slots if slots > 0 else None

    def field_stats(self, index: str, field: str) -> dict | None:
        with self._lock:
            fs = self._fields.get((index, field))
            return fs.payload() if fs is not None else None

    def est_index_rows(self, index: str) -> float | None:
        """A table's estimated record count for the SQL planner: the
        existence field's bit count when an import noted it, else the
        widest field's; None when the catalog holds nothing for it."""
        with self._lock:
            fs = self._fields.get((index, "_exists"))
            if fs is not None and fs.shard_bits:
                return float(sum(fs.shard_bits.values()))
            best = None
            for (i, _f), st in self._fields.items():
                if i != index or not st.shard_bits:
                    continue
                n = sum(st.shard_bits.values())
                if best is None or n > best:
                    best = n
            return float(best) if best is not None else None

    def clear(self):
        with self._lock:
            self._fields.clear()


_catalog = StatsCatalog()


def get() -> StatsCatalog:
    return _catalog


def configure(enabled: bool | None = None) -> StatsCatalog:
    """The [stats] switch; None leaves it as it is."""
    global _enabled
    if enabled is not None:
        _enabled = bool(enabled)
    return _catalog


def reset() -> None:
    """Forget every stat (a fresh process's catalog)."""
    _catalog.clear()


def note_ingest(index: str, field: str, rows=None, cols=None, values=None,
                width: int = 1 << 20):
    if not _enabled:
        return
    try:
        _catalog.note_ingest(index, field, rows=rows, cols=cols,
                             values=values, width=width)
    except Exception:
        pass  # stats must never fail a write


def note_page_encoding(index: str, field: str, kind: str):
    if not _enabled:
        return
    _catalog.note_page_encoding(index, field, kind)


def field_density(index: str, field: str, width_bits: int) -> float | None:
    if not _enabled:
        return None
    return _catalog.field_density(index, field, width_bits)
