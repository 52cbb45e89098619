"""Statistics catalog, the data plane the SQL cost planner reads.

Two planes, as in the JAX package's ``obs/stats.py``: per-(index,
field) data stats maintained from the ingest path, and per-plan-
fingerprint runtime profiles folded from flight records.  The data
plane, as far as SQL and the API read it:

- ``note_ingest`` (called by ``API.import_bits``/``import_values``
  after the write landed) folds one import into the field's row set,
  per-shard bit counts and value range;
- ``StatsCatalog.est_index_rows`` gives ``sql/costplan.py`` a table's
  record count, the input of its join ordering;
- ``note_page_encoding`` tallies the stack cache's page encodings per
  field (memory/encode.py), and ``field_density`` gives the encoder its
  skip-the-scan hint.

The runtime plane: ``flight.commit`` hands every finished record to
``note_flight`` (a lock-free append, folded in batches into a
``FingerprintProfile`` a plan fingerprint).  ``est_cost_ms`` is the
serving layer's admission signal (executor/sched.py classify),
``est_recompute_ms`` the result cache's eviction signal, and the
regression sentinel exports ``pilosa_perf_regression`` and reports a
"perf-regression" incident while a fingerprint runs ``regression_ratio``
times over its baseline.  ``hedge_samples`` gives the cluster
coordinator its per-node attempt times.  ``tick`` folds pending records
and saves on the snapshot cadence.

Persistence (``configure(path=...)``, the server's ``[stats] persist``
under its data directory): ``storage/stats_store.py``, a snapshot plus a
tail log of ingest events, in the JAX package's format.  A node
restarted on the same directory plans with its old profiles, field
stats and per-node attempt times.

The switch goes through ``configure(enabled=...)`` only (on by default,
as in the JAX package); the port reads no environment variable for it.
Stats steer plans, never results.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict, deque

import numpy as np

from pilosa_tpu_torch.obs import metrics

# ingest row sets are capped (the JAX package's _ROWS_CAP)
_ROWS_CAP = 8192
# fold the pending flight records every N appends (amortizes the
# catalog lock the same way flight.py amortizes the histogram lock)
_FOLD_N = 32
# bounded tables: profiles LRU-evict past this, per-node attempt rings
# are capped below
_MAX_PROFILES = 512
_MAX_NODE_SAMPLES = 256
_MAX_CLUSTER_DURS = 512

_enabled = True


def enabled() -> bool:
    return _enabled


def _ewma(prev: float | None, v: float, alpha: float) -> float:
    if prev is None:
        return v
    return prev + alpha * (v - prev)


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

    def to_state(self) -> dict:
        # "vhist" is the JAX package's value-histogram summary, which
        # the port does not keep: written empty so either package reads
        # the other's file
        return {"rows": sorted(self.rows),
                "rows_capped": self.rows_capped,
                "shard_bits": {str(k): v
                               for k, v in self.shard_bits.items()},
                "vmin": self.vmin, "vmax": self.vmax,
                "vcount": self.vcount, "vhist": None,
                "encodings": dict(self.encodings)}

    @classmethod
    def from_state(cls, st: dict) -> "FieldStats":
        fs = cls()
        fs.rows = {int(r) for r in st.get("rows", ())}
        fs.rows_capped = bool(st.get("rows_capped"))
        fs.shard_bits = {int(k): int(v)
                         for k, v in st.get("shard_bits", {}).items()}
        fs.vmin = st.get("vmin")
        fs.vmax = st.get("vmax")
        fs.vcount = int(st.get("vcount", 0))
        fs.encodings = {str(k): int(v)
                        for k, v in (st.get("encodings") or {}).items()}
        return fs

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


class FingerprintProfile:
    """Runtime-plane profile for one plan fingerprint.  ``ms`` is the
    steady cost estimate (mid EWMA); ``fast_ms`` / ``base_ms`` are the
    sentinel pair: the baseline freezes while a regression fires, so
    the fault cannot be absorbed into it."""

    __slots__ = ("n", "ms", "exec_ms", "recompute_ms", "bytes",
                 "batch", "hits", "total", "fast_ms", "base_ms",
                 "firing")

    def __init__(self):
        self.n = 0
        self.ms: float | None = None
        self.exec_ms: float | None = None
        # EWMA over non-cached serves only: what the plan costs to
        # compute (the cache-eviction signal); ``ms`` counts hits too
        # (the admission signal: a cached serve costs the engine nothing)
        self.recompute_ms: float | None = None
        self.bytes: float | None = None
        self.batch: float | None = None
        self.hits = 0
        self.total = 0
        self.fast_ms: float | None = None
        self.base_ms: float | None = None
        self.firing = False

    def fold(self, rec: dict, ratio: float = 3.0,
             min_samples: int = 6):
        d = float(rec.get("duration_ms", 0.0))
        phases = rec.get("phases", {}) or {}
        self.n += 1
        self.total += 1
        if rec.get("route") == "cached" or rec.get("cached"):
            self.hits += 1
        else:
            self.recompute_ms = _ewma(self.recompute_ms, d, 0.2)
        self.ms = _ewma(self.ms, d, 0.2)
        self.exec_ms = _ewma(
            self.exec_ms,
            float(phases.get("execute", 0.0))
            + float(phases.get("compile", 0.0)), 0.2)
        self.bytes = _ewma(self.bytes,
                           float(rec.get("bytes_moved", 0)), 0.2)
        self.batch = _ewma(self.batch, float(rec.get("batch", 1)), 0.2)
        self.fast_ms = _ewma(self.fast_ms, d, 0.5)
        # detection per record, before the baseline moves: a sustained
        # slowdown must not drip into the baseline faster than the
        # comparison runs
        if self.base_ms is not None and self.base_ms >= 0.01 \
                and self.n >= min_samples:
            self.firing = (self.fast_ms / self.base_ms) >= ratio
        # the baseline skips the first (cold) samples and freezes while
        # a regression fires
        if not self.firing and self.n > 3:
            self.base_ms = _ewma(self.base_ms, d, 0.05)

    def to_state(self) -> dict:
        return {"n": self.n, "ms": self.ms, "exec_ms": self.exec_ms,
                "recompute_ms": self.recompute_ms,
                "bytes": self.bytes, "batch": self.batch,
                "hits": self.hits, "total": self.total,
                "fast_ms": self.fast_ms, "base_ms": self.base_ms}

    @classmethod
    def from_state(cls, st: dict) -> "FingerprintProfile":
        p = cls()
        p.n = int(st.get("n", 0))
        p.ms = st.get("ms")
        p.exec_ms = st.get("exec_ms")
        p.recompute_ms = st.get("recompute_ms")
        p.bytes = st.get("bytes")
        p.batch = st.get("batch")
        p.hits = int(st.get("hits", 0))
        p.total = int(st.get("total", 0))
        p.fast_ms = st.get("fast_ms")
        p.base_ms = st.get("base_ms")
        return p

    def payload(self) -> dict:
        out = {"n": self.n,
               "ms": round(self.ms or 0.0, 4),
               "execute_ms": round(self.exec_ms or 0.0, 4),
               "bytes": int(self.bytes or 0),
               "batch": round(self.batch or 1.0, 2),
               "cache_hit_rate": round(self.hits / self.total, 4)
               if self.total else 0.0}
        if self.base_ms is not None:
            out["baseline_ms"] = round(self.base_ms, 4)
            out["window_ms"] = round(self.fast_ms or 0.0, 4)
        if self.firing:
            out["regressing"] = True
        return out


class StatsCatalog:
    """The process statistics catalog: the per-(index, field) ingest
    stats, the per-fingerprint runtime profiles and the regression
    sentinel."""

    def __init__(self, path: str | None = None,
                 heavy_cost_ms: float = 5.0,
                 regression_ratio: float = 3.0,
                 regression_min_samples: int = 6,
                 snapshot_interval_s: float = 60.0):
        self.heavy_cost_ms = float(heavy_cost_ms)
        self.regression_ratio = float(regression_ratio)
        self.regression_min_samples = int(regression_min_samples)
        self.snapshot_interval_s = float(snapshot_interval_s)
        self._lock = threading.Lock()
        # orders (apply an ingest event, append it to the tail) against
        # (capture the state, snapshot it): an event landing between
        # the two halves of a save must not be truncated unsaved
        self._persist_mu = threading.Lock()
        self._fields: dict[tuple[str, str], FieldStats] = {}
        self._profiles: OrderedDict[str, FingerprintProfile] = \
            OrderedDict()
        self._node_ms: dict[str, deque] = {}
        self._cluster_durs: deque = deque(maxlen=_MAX_CLUSTER_DURS)
        # lock-free pending list (list.append is GIL-atomic): flight
        # records queue here and fold in batches off the hot path
        self._pending: list[dict] = []
        self._last_save = time.monotonic()
        self.store = None
        self.store_path: str | None = None  # kept across detach_store
        self.loaded_from_disk = False
        if path:
            self._open_store(path)

    # -- persistence -----------------------------------------------------

    def _open_store(self, path: str):
        from pilosa_tpu_torch.storage.stats_store import StatsStore
        self.store = StatsStore(path)
        self.store_path = path
        state, events, torn = self.store.load()
        if state is not None:
            self._load_state(state)
            self.loaded_from_disk = True
        for ev in events:
            self._apply_event(ev)
            self.loaded_from_disk = True
        if torn or self.store.tail_over_threshold():
            # a torn tail must not be appended after, and a tail over
            # its threshold means the last run died before compacting
            self.store.compact(self._state())

    def _state(self) -> dict:
        # "gates" is the JAX package's cost-gate rates, which the port
        # does not keep
        with self._lock:
            return {
                "v": 1,
                "fields": {f"{i}\x00{f}": fs.to_state()
                           for (i, f), fs in self._fields.items()},
                "profiles": {fp: p.to_state()
                             for fp, p in self._profiles.items()},
                "nodes": {n: [round(v, 3) for v in dq]
                          for n, dq in self._node_ms.items()},
                "cluster_durs": [round(v, 3) for v in self._cluster_durs],
                "gates": {},
            }

    def _load_state(self, st: dict):
        with self._lock:
            for key, fst in st.get("fields", {}).items():
                i, _, f = key.partition("\x00")
                self._fields[(i, f)] = FieldStats.from_state(fst)
            for fp, pst in st.get("profiles", {}).items():
                self._profiles[fp] = FingerprintProfile.from_state(pst)
            for n, lst in st.get("nodes", {}).items():
                self._node_ms[n] = deque(
                    (float(v) for v in lst), maxlen=_MAX_NODE_SAMPLES)
            # replace, not extend: a reopen after a detach would count
            # every persisted duration twice
            self._cluster_durs.clear()
            self._cluster_durs.extend(
                float(v) for v in st.get("cluster_durs", ()))

    def save(self):
        """Snapshot the whole catalog (tmp + rename) and truncate the
        tail, under the persistence lock."""
        if self.store is None:
            return
        self.fold()
        with self._persist_mu:
            self.store.compact(self._state())
        self._last_save = time.monotonic()

    def maybe_save(self):
        if self.store is None:
            return
        if (time.monotonic() - self._last_save >= self.snapshot_interval_s
                or self.store.tail_over_threshold()):
            self.save()

    def detach_store(self):
        """Close and drop the store (its server is closing): later notes
        stay in memory instead of appending to a closed server's
        file."""
        with self._persist_mu:
            if self.store is not None:
                self.store.close()
                self.store = None
                self.loaded_from_disk = False

    def close(self):
        if self.store is not None:
            self.store.close()

    # -- data plane (ingest path) ----------------------------------------

    def note_ingest(self, index: str, field: str, rows=None, cols=None,
                    values=None, width: int = 1 << 20):
        """Fold one import call into the field's stats and append it to
        the store's tail."""
        ev: dict = {"t": "ingest", "i": index, "f": field}
        if rows is not None and len(rows):
            uniq = np.unique(np.asarray(rows).astype(np.int64))
            ev["rows"] = [int(r) for r in uniq[:_ROWS_CAP]]
        if cols is not None and len(cols):
            sh, cnt = np.unique(np.asarray(cols).astype(np.int64) // width,
                                return_counts=True)
            ev["sb"] = {str(int(s)): int(c) for s, c in zip(sh, cnt)}
        if values is not None and len(values):
            va = np.asarray(values)
            if va.dtype.kind in "iu":
                ev["vmin"], ev["vmax"] = int(va.min()), int(va.max())
                ev["vn"] = int(va.size)
            elif va.dtype.kind == "f":
                ev["vmin"], ev["vmax"] = float(va.min()), float(va.max())
                ev["vn"] = int(va.size)
        with self._persist_mu:
            self._apply_event(ev)
            if self.store is not None:
                self.store.append(ev)

    def _apply_event(self, ev: dict):
        if ev.get("t") != "ingest":
            return
        key = (str(ev.get("i", "")), str(ev.get("f", "")))
        with self._lock:
            fs = self._fields.get(key)
            if fs is None:
                fs = self._fields[key] = FieldStats()
            fs.note(ev.get("rows", ()), ev.get("sb", {}),
                    vmin=ev.get("vmin"), vmax=ev.get("vmax"),
                    vcount=ev.get("vn", 0))

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

    # -- runtime plane -------------------------------------------------------

    def note_flight(self, rec: dict):
        """Queue one finished flight record for folding (lock-free
        append; amortized batch fold)."""
        pend = self._pending
        pend.append(rec)
        if len(pend) >= _FOLD_N:
            self.fold()

    def fold(self):
        """Drain the pending records into the profiles and node tables
        and run the sentinel over the touched fingerprints.  The swap of
        the pending list happens under the lock, so two folders never
        drain the same buffer."""
        with self._lock:
            buf, self._pending = self._pending, []
        if not buf:
            return
        touched: list[str] = []
        evicted_firing: list[str] = []
        with self._lock:
            for rec in buf:
                fp = rec.get("fingerprint")
                if fp is not None and rec.get("error") is None:
                    p = self._profiles.get(fp)
                    if p is None:
                        p = self._profiles[fp] = FingerprintProfile()
                        while len(self._profiles) > _MAX_PROFILES:
                            ofp, op = self._profiles.popitem(last=False)
                            if op.firing:
                                evicted_firing.append(ofp)
                    else:
                        self._profiles.move_to_end(fp)
                    p.fold(rec, ratio=self.regression_ratio,
                           min_samples=self.regression_min_samples)
                    touched.append(fp)
                if rec.get("route") == "cluster" and \
                        rec.get("error") is None:
                    self._cluster_durs.append(
                        float(rec.get("duration_ms", 0.0)))
                    for a in rec.get("attempts", ()):
                        if not str(a.get("outcome", "")).endswith("ok"):
                            continue
                        node = str(a.get("node", ""))
                        dq = self._node_ms.get(node)
                        if dq is None:
                            dq = self._node_ms[node] = deque(
                                maxlen=_MAX_NODE_SAMPLES)
                        dq.append(float(a.get("ms", 0.0)))
            n_profiles = len(self._profiles)
        metrics.STATS_FOLDS.inc(len(buf))
        metrics.STATS_PROFILES.set(n_profiles)
        for fp in evicted_firing:
            metrics.PERF_REGRESSION.set(0.0, fingerprint=fp,
                                        metric="duration_ms")
        for fp in set(touched):
            self._sentinel(fp)

    def _sentinel(self, fp: str):
        """Export one fingerprint's sentinel state as
        ``pilosa_perf_regression{fingerprint,metric}``: the ratio while
        firing (with one rate-limited "perf-regression" incident), an
        explicit 0 once it recovers."""
        with self._lock:
            p = self._profiles.get(fp)
            if p is None:
                return
            base, fast, firing = p.base_ms, p.fast_ms, p.firing
        if firing and base:
            metrics.PERF_REGRESSION.set(round(fast / base, 3),
                                        fingerprint=fp,
                                        metric="duration_ms")
            from pilosa_tpu_torch.obs import incidents
            incidents.report(
                "perf-regression", detail=fp,
                context={"fingerprint": fp,
                         "baseline_ms": round(base, 4),
                         "window_ms": round(fast or 0.0, 4),
                         "ratio": round((fast or 0.0) / base, 3)})
        elif metrics.PERF_REGRESSION.value(fingerprint=fp,
                                           metric="duration_ms"):
            metrics.PERF_REGRESSION.set(0.0, fingerprint=fp,
                                        metric="duration_ms")

    def regressions(self) -> list[dict]:
        self.fold()
        out = []
        with self._lock:
            items = list(self._profiles.items())
        for fp, p in items:
            if p.firing and p.base_ms:
                out.append({"fingerprint": fp, "metric": "duration_ms",
                            "baseline_ms": round(p.base_ms, 4),
                            "window_ms": round(p.fast_ms or 0.0, 4),
                            "ratio": round((p.fast_ms or 0.0)
                                           / p.base_ms, 3)})
        return out

    def profile(self, fingerprint: str) -> FingerprintProfile | None:
        with self._lock:
            return self._profiles.get(fingerprint)

    def est_cost_ms(self, fingerprint: str) -> float | None:
        """Estimated serve cost of a plan fingerprint (cache hits
        included: the admission signal), or None below three samples."""
        with self._lock:
            p = self._profiles.get(fingerprint)
            if p is None or p.n < 3 or p.ms is None:
                return None
            return p.ms

    def est_recompute_ms(self, fingerprint: str) -> float | None:
        """Estimated recompute cost (non-cached serves only: the
        cache-eviction signal)."""
        with self._lock:
            p = self._profiles.get(fingerprint)
            if p is None:
                return None
            return p.recompute_ms

    def hedge_samples(self, min_records: int = 32):
        """Per-node attempt samples + cluster durations, or None when
        the catalog holds too few."""
        self.fold()
        with self._lock:
            by_node = {n: list(dq) for n, dq in self._node_ms.items()
                       if dq}
            durs = list(self._cluster_durs)
        atts = sum(len(v) for v in by_node.values())
        if atts < min_records and len(durs) < min_records:
            return None
        return by_node, durs

    def payload(self, index: str | None = None,
                fingerprint: str | None = None,
                limit: int | None = None) -> dict:
        """The /debug/stats answer; ``limit`` keeps the newest profiles."""
        self.fold()
        with self._lock:
            fields = {f"{i}/{f}": fs.payload()
                      for (i, f), fs in sorted(self._fields.items())
                      if index is None or i == index}
            profs = [(fp, p.payload())
                     for fp, p in reversed(self._profiles.items())
                     if fingerprint is None or fp == fingerprint]
        if limit is not None:
            profs = profs[: max(0, int(limit))]
        out = {"enabled": enabled(), "data": fields,
               "runtime": dict(profs), "regressions": self.regressions(),
               "knobs": {"heavy_cost_ms": self.heavy_cost_ms,
                         "regression_ratio": self.regression_ratio,
                         "regression_min_samples":
                             self.regression_min_samples}}
        if self.store is not None:
            out["store"] = {"path": self.store.path,
                            "loaded": self.loaded_from_disk,
                            "tail_records": self.store.tail_records}
        return out

    def clear(self):
        with self._lock:
            self._fields.clear()
            self._profiles.clear()
            self._node_ms.clear()
            self._cluster_durs.clear()
            self._pending = []
            self.loaded_from_disk = False


_catalog = StatsCatalog()


def get() -> StatsCatalog:
    return _catalog


def configure(enabled: bool | None = None, path: str | None = None,
              heavy_cost_ms: float | None = None,
              regression_ratio: float | None = None,
              regression_min_samples: int | None = None,
              snapshot_interval_s: float | None = None) -> StatsCatalog:
    """The [stats] knobs; None leaves a knob as it is.  A new ``path``
    opens that store and loads what it holds, after forgetting the
    catalog's state (another directory's stats must not be written into
    this one's file); the same path with its store detached reopens
    it."""
    global _enabled
    cat = _catalog
    if enabled is not None:
        _enabled = bool(enabled)
    if heavy_cost_ms is not None:
        cat.heavy_cost_ms = float(heavy_cost_ms)
    if regression_ratio is not None:
        cat.regression_ratio = float(regression_ratio)
    if regression_min_samples is not None:
        cat.regression_min_samples = int(regression_min_samples)
    if snapshot_interval_s is not None:
        cat.snapshot_interval_s = float(snapshot_interval_s)
    if path is not None:
        if cat.store_path != path:
            if cat.store is not None:
                cat.store.close()
                cat.store = None
            cat.clear()
            cat._open_store(path)
        elif cat.store is None:
            cat._open_store(path)
    return cat


def swap(catalog: StatsCatalog) -> StatsCatalog:
    """Test seam: replace the process catalog, returning the prior one."""
    global _catalog
    prev, _catalog = _catalog, catalog
    return prev


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


def note_flight(rec: dict):
    """Hot-path entry (flight.commit): one enabled check + one lock-free
    list append; folding is amortized."""
    if not _enabled:
        return
    _catalog.note_flight(rec)


def est_cost_ms(fingerprint: str) -> float | None:
    if not _enabled:
        return None
    return _catalog.est_cost_ms(fingerprint)


def est_recompute_ms(fingerprint: str) -> float | None:
    if not _enabled:
        return None
    return _catalog.est_recompute_ms(fingerprint)


def heavy_cost_ms() -> float:
    return _catalog.heavy_cost_ms


def hedge_samples(min_records: int = 32):
    if not _enabled:
        return None
    return _catalog.hedge_samples(min_records=min_records)


def tick():
    """Maintenance hook: fold pending records, refresh the sentinel
    and save on the snapshot cadence."""
    try:
        _catalog.fold()
        _catalog.maybe_save()
    except Exception:
        pass  # the stats plane must never take its caller down
