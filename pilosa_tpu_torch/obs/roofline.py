"""Roofline attribution: joins bytes touched with device time.

A dispatch that knows both its operands' bytes and its execute seconds
(the stacked engine's plan dispatch, the serving layer's ragged
program) calls :func:`note`, which folds the sample into per-op-family
achieved bandwidth:

- ``pilosa_device_bandwidth_gbps{op}``      achieved GB/s (cumulative
  bytes / cumulative execute seconds)
- ``pilosa_device_bandwidth_fraction{op}``  achieved / peak

The peak is configured (``configure(peak_gbps=)``, a device spec) or
measured once by a STREAM-style torch probe (:func:`ensure_peak`) on
the card; on the CPU the probe measures host memory bandwidth, so the
fraction stays meaningful there too.  Per-query shares land in each
flight record's ``roofline`` field (obs/flight.py).

Always-on budget: :func:`note` is one dict update + two gauge sets on a
path that just paid a device dispatch; the disabled path is a single
module-global check.  The port reads no environment for the switch or
the peak.
"""

from __future__ import annotations

import atexit
import threading

from pilosa_tpu_torch.obs import flight, metrics

_lock = threading.Lock()         # guards _stats
_probe_lock = threading.Lock()   # serializes the peak probe/spawn
# op -> [bytes, seconds, dispatches]; cumulative since process start
_stats: dict[str, list] = {}
_peak_bytes_per_s: float | None = None
_enabled = True
_probe_thread: threading.Thread | None = None


def _join_probe() -> None:
    """At exit, let a running background probe finish: an interpreter
    that exits while the probe's torch ops run aborts in torch's thread
    pool teardown."""
    t = _probe_thread
    if t is not None and t.is_alive():
        t.join(timeout=30)


def enabled() -> bool:
    return _enabled is not False


def configure(enabled: bool | None = None,
              peak_gbps: float | None = None):
    """Apply the [roofline] config knobs (config.py).  ``peak_gbps``
    overrides the measured probe (device-spec peak); 0/None keeps the
    probe."""
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
    """The known peak (bytes/s) WITHOUT triggering a probe — hot-path
    callers (flight.commit) must never block on measurement."""
    return _peak_bytes_per_s


def measure_peak(size_mb: int = 16, reps: int = 3,
                 device=None) -> float:
    """STREAM-style copy probe: time ``y = x ^ 1`` over a ``size_mb``
    int32 buffer (reads + writes = 2x bytes) with torch, best of
    ``reps`` after one warm run.  Returns bytes/s.  On the card
    (``device`` None means the current CUDA device when there is one)
    this measures its memory stream; on the CPU, host memory bandwidth:
    each is the denominator of the fraction gauge for that device."""
    import time as _time

    import torch
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    n = (size_mb << 20) // 4
    x = torch.zeros((n,), dtype=torch.int32, device=device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    torch.bitwise_xor(x, 1)  # warm
    sync()
    best = float("inf")
    for _ in range(reps):
        t0 = _time.perf_counter()
        torch.bitwise_xor(x, 1)
        sync()
        best = min(best, _time.perf_counter() - t0)
    return 2 * x.numel() * 4 / max(best, 1e-9)


def ensure_peak(block: bool = True) -> float | None:
    """Resolve the peak: a configured one, else the measured probe.
    ``block=False`` runs the probe on a background daemon thread (the
    server-startup path — first queries must not wait ~50 ms on a
    bandwidth probe) and returns None until it lands."""
    global _peak_bytes_per_s, _probe_thread
    if _peak_bytes_per_s is not None:
        return _peak_bytes_per_s
    if not block:
        with _probe_lock:
            if _probe_thread is None or not _probe_thread.is_alive():
                if _probe_thread is None:
                    atexit.register(_join_probe)
                _probe_thread = threading.Thread(
                    target=lambda: ensure_peak(block=True), daemon=True)
                _probe_thread.start()
        return None
    with _probe_lock:
        if _peak_bytes_per_s is None:
            try:
                set_peak(measure_peak())
            except Exception:
                return None  # no usable backend: fractions stay unset
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
    """Re-derive the fraction gauges after the peak lands (the
    background probe may finish after dispatches already noted)."""
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
    gbps, fraction?}}}``.  Pure read — never triggers a probe."""
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
