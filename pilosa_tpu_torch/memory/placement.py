"""Shard-to-slot placement for the serving mesh.

The port of ``pilosa_tpu/memory/placement.py``.  The serving mesh
spreads the serving layer's fused ragged program (executor/ragged.py)
over N slots: every (index, shard) gets a sticky owner slot, every
paged stack partitions its lanes by that owner (memory/pages.py), and
the program's ``ragged_mesh`` run gathers each slot's pages on the
slot's device and combines the slots' partials on the lead device.
This module is the one source of placement:

- **unit**: the (index, shard) pair.  Every stack kind a ragged group
  reads (row, plane, group-code) maps lanes to shards, so stickiness by
  shard keeps all of a shard's pages on one slot: elementwise work stays
  on the slot and only the reductions cross slots.
- **balance**: a new shard goes to the slot with the fewest live bytes
  in the ledger's per-slot split (memory/ledger.py), the assignment
  count breaking ties.
- **epoch**: every rebalance or pin change bumps ``epoch()``.  Stack
  cache keys and the canonical ragged program carry ``(mesh width,
  epoch)``, so a width flip or a rebalance never hits a stack or a
  program of a dead placement; superseded entries age out through
  eviction, and pages are built again on their new owner at next use.

The settings go through :func:`configure` only; the port reads no
environment variable (the JAX ``PILOSA_TPU_MESH_DEVICES`` and
``PILOSA_TPU_PLACEMENT_PIN`` twins reach it through ``config.load`` and
``Config.apply_placement_settings``).  ``[cluster] mesh-devices`` sets
the width (0 or 1: off); ``[cluster] placement-pin`` force-places
shards, ``index/shard=slot`` or ``index/*=slot``, comma-separated.
``devices`` names the slots' torch devices (default: the visible CUDA
cards); a list may repeat a device, and the slots then share it.

The placement lock is never held across a ledger call or a launch.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

_lock = threading.RLock()
_configured: int = 0            # [cluster] mesh-devices (0 = off)
_pins: dict = {}                # (index, shard | "*") -> slot
_assign: dict = {}              # (index, shard) -> slot
_counts: dict = {}              # slot -> assignment count
_devices: list | None = None    # the slots' devices; None: the cards
_epoch: int = 0
_mesh_cache: dict = {}          # (n, devices) -> parallel.mesh.Mesh


def configure(mesh_devices: int | None = None, pin: str | None = None,
              devices=None):
    """Apply the [cluster] mesh knobs; None leaves a knob as it is.
    Changing any of them bumps the placement epoch (a stack or program
    cached under another topology or pin set must not be reused)."""
    global _configured, _pins, _devices
    with _lock:
        changed = False
        if mesh_devices is not None and int(mesh_devices) != _configured:
            _configured = int(mesh_devices)
            changed = True
        if pin is not None:
            pins = _parse_pins(pin)
            if pins != _pins:
                _pins = pins
                changed = True
        if devices is not None:
            devs = [torch.device(d) for d in devices]
            if devs != _devices:
                _devices = devs
                changed = True
        if changed:
            _rebalance_locked()


def _parse_pins(spec: str) -> dict:
    pins: dict = {}
    for part in str(spec).split(","):
        part = part.strip()
        if not part or "=" not in part:
            continue
        lhs, _, dev = part.partition("=")
        idx, _, shard = lhs.partition("/")
        try:
            slot = int(dev)
            key = (idx.strip(), "*" if shard.strip() == "*"
                   else int(shard))
        except ValueError:
            continue
        pins[key] = slot
    return pins


def _available() -> list:
    if _devices is not None:
        return list(_devices)
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def mesh_devices() -> int:
    """The serving mesh's width: the configured mesh-devices, clamped to
    the devices given (or to the visible cards).  1 means the mesh is
    off: every layout and dispatch is the single-device one."""
    n = _configured
    if n <= 1:
        return 1
    return max(1, min(n, len(_available())))


def devices() -> list:
    """The slots' devices (slot i is ``devices()[i]``)."""
    return _available()[:mesh_devices()]


def device_of(slot: int) -> torch.device:
    return _available()[int(slot)]


def serving_mesh():
    """The serving mesh as a one-row ``parallel.mesh.Mesh`` of
    ``devices()``, cached a topology.  Distinct from
    ``StackedEngine.mesh`` (the engine's mesh arm): the serving mesh
    keeps paging on, pages placed on their owner slots."""
    from pilosa_tpu_torch.parallel.mesh import Mesh
    devs = devices()
    key = (len(devs), tuple(str(d) for d in devs))
    with _lock:
        m = _mesh_cache.get(key)
        if m is None:
            m = _mesh_cache[key] = Mesh(devs, rows=1)
        return m


def epoch() -> int:
    return _epoch


def rebalance():
    """Forget every sticky assignment and bump the epoch: new stack keys
    and programs build on freshly balanced owners, and the superseded
    generation ages out through eviction (a live migration is a build
    on the new owner and an eviction of the old, fenced by the keys)."""
    with _lock:
        _rebalance_locked()


def _rebalance_locked():
    global _epoch
    _assign.clear()
    _counts.clear()
    _epoch += 1


def reset():
    """Drop assignments, pins, devices and the width; bump the epoch."""
    global _configured, _pins, _devices
    with _lock:
        _configured = 0
        _pins = {}
        _devices = None
        _rebalance_locked()


def _device_bytes(n: int) -> list[int]:
    from pilosa_tpu_torch import memory
    return memory.ledger().device_bytes(n)


def place(index_name: str, shard: int) -> int:
    """The sticky owner slot of one (index, shard).  The first placement
    balances the ledger's live per-slot bytes (the assignment count
    breaks ties); a pin overrides."""
    n = mesh_devices()
    if n <= 1:
        return 0
    key = (str(index_name), int(shard))
    with _lock:
        slot = _assign.get(key)
        if slot is not None:
            return slot
        pin = _pins.get(key, _pins.get((key[0], "*")))
    occ = None
    if pin is None or not 0 <= int(pin) < n:
        # read outside the placement lock: the ledger has its own
        occ = _device_bytes(n)
    with _lock:
        slot = _assign.get(key)
        if slot is not None:
            return slot
        if occ is None:
            slot = int(pin)
        else:
            slot = min(range(n), key=lambda d: (
                occ[d] if d < len(occ) else 0, _counts.get(d, 0), d))
        _assign[key] = slot
        _counts[slot] = _counts.get(slot, 0) + 1
    # keep the ledger's per-slot split current (idempotent)
    from pilosa_tpu_torch import memory
    memory.ledger().set_devices(n)
    return slot


def owners(index_name: str, shards) -> np.ndarray:
    """Owner slot per shard (int32, len(shards)): the group-level owner
    map every leaf of a ragged group shares."""
    return np.array([place(index_name, s) for s in shards], dtype=np.int32)


def snapshot() -> dict:
    """Placement state for the debug surfaces."""
    with _lock:
        per = {d: 0 for d in range(mesh_devices())}
        for slot in _assign.values():
            per[slot] = per.get(slot, 0) + 1
        return {"mesh_devices": mesh_devices(), "epoch": _epoch,
                "assigned_shards": dict(per), "pins": len(_pins)}
