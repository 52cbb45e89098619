"""[dax] / [blob] runtime knobs, pushed by config.

``config.Config.apply_dax_settings()`` hands the loaded stanzas to
``configure()``; the accessors read what it set.  ``config.load`` is
where the ``PILOSA_TPU_DAX_*`` and ``PILOSA_TPU_BLOB_*`` variables
meet the file, as for every other plane of the port: this module reads
no environment, so a knob changes only through a Config (or a direct
``configure()`` call).  It stays import-light (no dax package
machinery) so config application never drags the queryer/executor in.
"""

from __future__ import annotations

_blob = True
_backend = ""            # "" = no blob tier | "dir" | "mem"
_root = ""               # dir-backend root ("" = <data-dir>/blob)
_lazy_hydrate = True
_worker_budget_bytes = 0  # 0 = unbounded (no per-worker ledger bound)
_prefetch = 2            # shards warmed per hydrate tick (0 = off)
_scale_out_burn = 2.0    # SLO burn rate tripping scale-out
_scale_in_burn = 0.5     # burn rate under which scale-in may drain
_pressure_high = 0.9     # worker ledger fill fraction tripping scale-out
_min_workers = 1
_max_workers = 8
_standby = 1             # standby workers cli dax keeps warm
_reconcile_interval_s = 5.0
_cooldown_s = 30.0       # min seconds between scale events
_chase_lag = 8           # hydrate-replay backlog under which FENCE starts
_chase_rounds = 12       # bounded DELTA-CHASE rounds


def configure(blob=None, backend=None, root=None, lazy_hydrate=None,
              worker_budget_bytes=None, prefetch=None,
              scale_out_burn=None, scale_in_burn=None,
              pressure_high=None, min_workers=None, max_workers=None,
              standby=None, reconcile_interval_s=None,
              cooldown_s=None, chase_lag=None, chase_rounds=None):
    """Apply the [dax]/[blob] config stanzas (None = leave as is)."""
    g = globals()
    for name, val in (("_blob", blob), ("_backend", backend),
                      ("_root", root), ("_lazy_hydrate", lazy_hydrate),
                      ("_worker_budget_bytes", worker_budget_bytes),
                      ("_prefetch", prefetch),
                      ("_scale_out_burn", scale_out_burn),
                      ("_scale_in_burn", scale_in_burn),
                      ("_pressure_high", pressure_high),
                      ("_min_workers", min_workers),
                      ("_max_workers", max_workers),
                      ("_standby", standby),
                      ("_reconcile_interval_s", reconcile_interval_s),
                      ("_cooldown_s", cooldown_s),
                      ("_chase_lag", chase_lag),
                      ("_chase_rounds", chase_rounds)):
        if val is not None:
            g[name] = val


def blob_enabled() -> bool:
    """The tier kill-switch: off, workers fall back to the seed's
    local-disk snapshot+log recovery, bit-exact."""
    return bool(_blob)


def backend() -> str:
    return str(_backend)


def root() -> str:
    return str(_root)


def lazy_hydrate() -> bool:
    return bool(_lazy_hydrate)


def worker_budget_bytes() -> int:
    return int(_worker_budget_bytes)


def prefetch() -> int:
    return int(_prefetch)


def scale_out_burn() -> float:
    return float(_scale_out_burn)


def scale_in_burn() -> float:
    return float(_scale_in_burn)


def pressure_high() -> float:
    return float(_pressure_high)


def min_workers() -> int:
    return int(_min_workers)


def max_workers() -> int:
    return int(_max_workers)


def standby() -> int:
    return int(_standby)


def reconcile_interval_s() -> float:
    return float(_reconcile_interval_s)


def cooldown_s() -> float:
    return float(_cooldown_s)


def chase_lag() -> int:
    return int(_chase_lag)


def chase_rounds() -> int:
    return int(_chase_rounds)
