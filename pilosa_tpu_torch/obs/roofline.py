"""Roofline attribution: joins bytes touched with device time.

A dispatch that knows both its operands' bytes and its execute seconds
(the stacked engine's plan dispatch, the serving layer's ragged
program) calls :func:`note`, which folds the sample into per-op-family
achieved bandwidth:

- ``pilosa_device_bandwidth_gbps{op}``      achieved GB/s (cumulative
  bytes / cumulative execute seconds)
- ``pilosa_device_bandwidth_fraction{op}``  achieved / peak

The peak is configured (``configure(peak_gbps=)``) or the card's
published HBM rate, looked up by the name torch reports
(:func:`published_peak`; an H100 SXM's 3.35 TB/s).  With no card, or a
card not in the table, there is no peak and no fraction.  Per-query
shares land in each flight record's ``roofline`` field
(obs/flight.py).

Always-on budget: :func:`note` is one dict update + two gauge sets on a
path that just paid a device dispatch; the disabled path is a single
module-global check.  The port reads no environment for the switch or
the peak.
"""

from __future__ import annotations

import threading

from pilosa_tpu_torch.obs import flight, metrics

_lock = threading.Lock()         # guards _stats
# op -> [bytes, seconds, dispatches]; cumulative since process start
_stats: dict[str, list] = {}
_peak_bytes_per_s: float | None = None
_enabled = True

# published HBM rates in bytes/s, by a part of the device name; the
# first entry the name contains wins
PUBLISHED_PEAKS = (
    ("H100 PCIe", 2.0e12),
    ("H100 NVL", 3.9e12),
    ("H100", 3.35e12),
)


def enabled() -> bool:
    return _enabled is not False


def configure(enabled: bool | None = None,
              peak_gbps: float | None = None):
    """Apply the [roofline] config knobs (config.py).  ``peak_gbps``
    overrides the card's published peak; 0/None keeps it."""
    global _enabled, _peak_bytes_per_s
    if enabled is not None:
        _enabled = bool(enabled)
    if peak_gbps:
        set_peak(float(peak_gbps) * 1e9)


def set_peak(bytes_per_s: float):
    global _peak_bytes_per_s
    _peak_bytes_per_s = float(bytes_per_s)
    metrics.DEVICE_PEAK_GBPS.set(_peak_bytes_per_s / 1e9)
    _refresh_fractions()


def peak_or_none() -> float | None:
    """The known peak (bytes/s), or None."""
    return _peak_bytes_per_s


def published_peak(device_name: str) -> float | None:
    """The published HBM rate (bytes/s) of a card of this name, or
    None for a card not in ``PUBLISHED_PEAKS``."""
    for part, rate in PUBLISHED_PEAKS:
        if part in device_name:
            return rate
    return None


def resolve_peak() -> float | None:
    """The peak: a configured one, else the current CUDA card's
    published rate; None on the CPU or an unknown card."""
    if _peak_bytes_per_s is None:
        import torch
        if torch.cuda.is_available():
            rate = published_peak(torch.cuda.get_device_name())
            if rate is not None:
                set_peak(rate)
    return _peak_bytes_per_s


def note(op: str, nbytes: int, seconds: float, device=None):
    """Fold one cached-executable dispatch into the per-op bandwidth
    attribution (and the active flight record's roofline share).

    ``device`` (a serving-mesh slot index, memory/placement.py)
    attributes a PER-DEVICE share of a mesh dispatch: the sample
    accumulates under the ``"{op}/dev{device}"`` stats key — its own
    snapshot/window row, the per-chip bench occupancy truth — and
    sets the gauges with a ``device="d{device}"`` label.  Device
    samples never touch the flight record (the caller notes the
    aggregate separately; double-counting the per-device split would
    inflate every rider's roofline share)."""
    if not enabled() or seconds <= 0 or nbytes <= 0:
        return
    key = op if device is None else f"{op}/dev{device}"
    with _lock:
        st = _stats.get(key)
        if st is None:
            st = _stats[key] = [0, 0.0, 0]
        st[0] += int(nbytes)
        st[1] += seconds
        st[2] += 1
        b, s = st[0], st[1]
    gbps = b / s / 1e9
    labels = {"op": op}
    if device is not None:
        labels["device"] = f"d{device}"
    metrics.DEVICE_BW_GBPS.set(gbps, **labels)
    peak = _peak_bytes_per_s
    if peak:
        metrics.DEVICE_BW_FRACTION.set((b / s) / peak, **labels)
    if device is None:
        flight.note_op(op, nbytes, seconds)


def _split_key(key: str) -> dict:
    """Stats key -> gauge labels ("ragged/dev3" -> op + device)."""
    if "/dev" in key:
        op, _, d = key.rpartition("/dev")
        return {"op": op, "device": f"d{d}"}
    return {"op": key}


def _refresh_fractions():
    """Re-derive the fraction gauges after the peak is set (dispatches
    may have been noted before it)."""
    peak = _peak_bytes_per_s
    if not peak:
        return
    with _lock:
        items = [(key, st[0], st[1]) for key, st in _stats.items()]
    for key, b, s in items:
        if s > 0:
            metrics.DEVICE_BW_FRACTION.set((b / s) / peak,
                                           **_split_key(key))


def snapshot() -> dict:
    """Cumulative per-op attribution for bench cells and /debug use:
    ``{"peak_gbps": ..., "ops": {op: {bytes, seconds, dispatches,
    gbps, fraction?}}}``.  Pure read."""
    peak = _peak_bytes_per_s
    with _lock:
        items = {op: list(st) for op, st in _stats.items()}
    ops = {}
    for op, (b, s, n) in items.items():
        ent = {"bytes": b, "seconds": round(s, 6), "dispatches": n}
        if s > 0:
            ent["gbps"] = round(b / s / 1e9, 4)
            if peak:
                ent["fraction"] = round((b / s) / peak, 5)
        ops[op] = ent
    out = {"ops": ops}
    if peak:
        out["peak_gbps"] = round(peak / 1e9, 3)
    return out


def window(before: dict, after: dict) -> dict:
    """Delta between two :func:`snapshot` calls — the per-bench-cell
    achieved-GB/s + fraction-of-peak emission."""
    peak_gbps = after.get("peak_gbps")
    ops = {}
    for op, a in after.get("ops", {}).items():
        b0 = before.get("ops", {}).get(op, {})
        db = a["bytes"] - b0.get("bytes", 0)
        ds = a["seconds"] - b0.get("seconds", 0.0)
        dn = a["dispatches"] - b0.get("dispatches", 0)
        if dn <= 0 or ds <= 0:
            continue
        ent = {"bytes": db, "seconds": round(ds, 6), "dispatches": dn,
               "gbps": round(db / ds / 1e9, 4)}
        if peak_gbps:
            ent["fraction"] = round((db / ds / 1e9) / peak_gbps, 5)
        ops[op] = ent
    out = {"ops": ops}
    if peak_gbps:
        out["peak_gbps"] = peak_gbps
    return out


def reset_stats():
    """Test/bench seam: forget cumulative attribution (gauges keep
    their last values until the next note)."""
    with _lock:
        _stats.clear()


def swap_state(enabled=None, peak_bytes_per_s=None):
    """Test/bench seam: set (or with None-able values, CLEAR) the
    module enable flag and peak, returning the prior pair so a probe
    can restore exactly what it found — including 'unset'."""
    global _enabled, _peak_bytes_per_s
    prev = (_enabled, _peak_bytes_per_s)
    _enabled = enabled
    _peak_bytes_per_s = peak_bytes_per_s
    if peak_bytes_per_s:
        metrics.DEVICE_PEAK_GBPS.set(peak_bytes_per_s / 1e9)
    return prev
