"""Device-memory budget ledger: one accountant for the card's bytes.

Clients (the stacked engine's stack cache, the per-shard engine's tile
cache) register with a *reclaim callback* and account every resident
device allocation through :meth:`Ledger.reserve` / :meth:`release`.
The accounted total never exceeds the budget: a reservation that would
cross it first drives reclaim across the other clients (coldest first,
the requester last), and is denied when not enough cold bytes exist, in
which case the caller serves its tensor without retaining it.

The budget resolves lazily on first use: an explicit
``configure(budget_bytes=...)``, else the card's total memory
(``torch.cuda.mem_get_info``) less ``headroom_frac``, else, with no
card, an 8 GiB fallback.  The budget is accounting only: it never
decides where a query runs.

Clients are held by weak reference: a cache that is garbage-collected
drops out of the accounting with its tensors.

The device slots (``set_devices``, ``device_budget``,
``reserve(..., device=slot)``) are the serving mesh's split
(memory/placement.py): the budget divides evenly between the slots, a
slot-labelled reservation past its slot's share is denied, and
``device_bytes()`` feeds the placer's balance and the
``pilosa_memory_device_resident_bytes{device}`` gauge.  Without the
mesh there is one slot.
"""

from __future__ import annotations

import threading
import weakref

from pilosa_tpu_torch.obs import metrics

_FALLBACK_BUDGET = 8 << 30
_RECLAIM_ATTEMPTS = 3


class Client:
    """One registered owner of device bytes.  ``reserve``/``release``
    are the only mutators; ``bytes`` is the client's accounted total."""

    __slots__ = ("name", "_bytes", "_dev", "_reclaim_cb",
                 "_cold_ts_cb", "_ledger", "__weakref__")

    def __init__(self, name: str, ledger: "Ledger", reclaim_cb=None,
                 cold_ts_cb=None):
        self.name = name
        self._bytes = 0
        self._dev: dict[int, int] = {}   # device slot -> labelled bytes
        self._reclaim_cb = reclaim_cb
        self._cold_ts_cb = cold_ts_cb
        self._ledger = ledger

    @property
    def bytes(self) -> int:
        return self._bytes

    def reserve(self, nbytes: int, trigger: str = "reserve",
                device: int | None = None) -> bool:
        return self._ledger.reserve(self, nbytes, trigger=trigger,
                                    device=device)

    def release(self, nbytes: int, device: int | None = None):
        self._ledger.release(self, nbytes, device=device)

    def cold_ts(self) -> float:
        """Timestamp of the client's coldest resident entry (0: unknown,
        taken as coldest), which orders the cross-client reclaim."""
        if self._cold_ts_cb is None:
            return 0.0
        try:
            return float(self._cold_ts_cb())
        except Exception:
            return 0.0


class Ledger:
    def __init__(self, budget_bytes: int | None = None,
                 headroom_frac: float = 0.1):
        self._explicit = int(budget_bytes) if budget_bytes else None
        self.headroom_frac = float(headroom_frac)
        self._budget: int | None = None
        self._clients: list[weakref.ref] = []
        self._lock = threading.Lock()
        self._n_devices = 1

    # -- registration ---------------------------------------------------

    def register(self, name: str, reclaim=None, cold_ts=None) -> Client:
        """Register a client.  ``reclaim(nbytes) -> freed`` evicts the
        client's cold bytes under pressure (it calls ``client.release``
        for what it drops and reports the total); ``cold_ts()`` orders
        the sweep.  The ledger keeps only a weak reference."""
        c = Client(name, self, reclaim_cb=reclaim, cold_ts_cb=cold_ts)
        with self._lock:
            self._clients.append(weakref.ref(c))
        return c

    def _live_locked(self) -> list[Client]:
        live, refs = [], []
        for r in self._clients:
            c = r()
            if c is not None:
                live.append(c)
                refs.append(r)
        self._clients = refs
        return live

    # -- budget ---------------------------------------------------------

    def set_budget(self, budget_bytes: int | None):
        """Explicit budget (None: detect on next use).  Shrinking below
        the resident total reclaims down to the new bound."""
        with self._lock:
            self._explicit = int(budget_bytes) if budget_bytes else None
            self._budget = self._explicit
            total = sum(c._bytes for c in self._live_locked())
            budget = self._budget
        if budget is not None:
            metrics.MEM_BUDGET.set(budget)
            if total > budget:
                self._reclaim(total - budget, requester=None,
                              trigger="shrink")

    def budget(self) -> int:
        b = self._budget
        if b is not None:
            return b
        b = self._detect()
        with self._lock:
            if self._budget is None:
                self._budget = b
            b = self._budget
        metrics.MEM_BUDGET.set(b)
        return b

    def _detect(self) -> int:
        if self._explicit:
            return self._explicit
        import torch
        if torch.cuda.is_available():
            _free, total = torch.cuda.mem_get_info(
                torch.cuda.current_device())
            return max(int(total * (1.0 - self.headroom_frac)), 1 << 20)
        return _FALLBACK_BUDGET

    # -- devices --------------------------------------------------------

    def set_devices(self, n: int):
        """Number of device slots: the budget splits evenly between
        them, and slot-labelled reservations are held to their share."""
        with self._lock:
            self._n_devices = max(int(n), 1)

    def device_budget(self) -> int:
        b = self.budget()
        with self._lock:
            return b // max(self._n_devices, 1)

    def device_bytes(self, n: int | None = None) -> list[int]:
        """Slot-labelled resident bytes per slot, over the clients."""
        with self._lock:
            nd = max(self._n_devices if n is None else int(n), 1)
            out = [0] * nd
            for c in self._live_locked():
                for slot, nb in c._dev.items():
                    if 0 <= slot < nd:
                        out[slot] += nb
            return out

    def _dev_total_locked(self, slot: int) -> int:
        return sum(c._dev.get(slot, 0) for c in self._live_locked())

    # -- accounting -----------------------------------------------------

    @property
    def total_bytes(self) -> int:
        with self._lock:
            return sum(c._bytes for c in self._live_locked())

    def free_bytes(self) -> int:
        return max(self.budget() - self.total_bytes, 0)

    def reserve(self, client: Client, nbytes: int,
                trigger: str = "reserve",
                device: int | None = None) -> bool:
        """Account ``nbytes`` to ``client`` if they fit the budget,
        reclaiming cold bytes across clients first.  False: denied, and
        the caller must not retain the allocation."""
        nbytes = int(nbytes)
        if nbytes <= 0:
            return True
        budget = self.budget()
        with self._lock:
            nd = self._n_devices
        dev_budget = budget // nd if device is not None and nd > 1 \
            else None
        if nbytes > budget or (dev_budget is not None
                               and nbytes > dev_budget):
            metrics.MEM_DENIED.inc(client=client.name)
            return False
        for _attempt in range(_RECLAIM_ATTEMPTS):
            with self._lock:
                total = sum(c._bytes for c in self._live_locked())
                need = max(total + nbytes - budget, 0)
                if need == 0 and dev_budget is not None:
                    need = max(self._dev_total_locked(device) + nbytes
                               - dev_budget, 0)
                if need == 0:
                    client._bytes += nbytes
                    if device is not None:
                        client._dev[device] = (client._dev.get(device, 0)
                                               + nbytes)
                    self._export_locked()
                    return True
            if self._reclaim(need, requester=client, trigger=trigger) <= 0:
                break
        metrics.MEM_DENIED.inc(client=client.name)
        return False

    def release(self, client: Client, nbytes: int,
                device: int | None = None):
        nbytes = int(nbytes)
        if nbytes <= 0:
            return
        with self._lock:
            client._bytes = max(client._bytes - nbytes, 0)
            if device is not None:
                left = client._dev.get(device, 0) - nbytes
                if left > 0:
                    client._dev[device] = left
                else:
                    client._dev.pop(device, None)
            self._export_locked()

    # -- reclaim --------------------------------------------------------

    def _reclaim(self, need: int, requester: Client | None,
                 trigger: str) -> int:
        """Ask clients to shed ``need`` bytes: coldest clients first, the
        requester last.  Callbacks run without the ledger's lock (they
        call release() as they evict)."""
        metrics.MEM_RECLAIMS.inc(trigger=trigger)
        with self._lock:
            others = [c for c in self._live_locked()
                      if c is not requester and c._reclaim_cb is not None
                      and c._bytes > 0]
            me = (requester if requester is not None
                  and requester._reclaim_cb is not None else None)
        others.sort(key=lambda c: c.cold_ts())
        freed_total = 0
        for c in others + ([me] if me is not None else []):
            if freed_total >= need:
                break
            try:
                freed = int(c._reclaim_cb(need - freed_total) or 0)
            except Exception:
                freed = 0
            if freed > 0:
                freed_total += freed
                metrics.MEM_RECLAIMED.inc(freed, client=c.name)
        return freed_total

    def reclaim_frac(self, frac: float = 0.5, trigger: str = "oom") -> int:
        """Shed a fraction of the resident total (the OOM ladder's relief
        sweep); returns the bytes asked for."""
        with self._lock:
            total = sum(c._bytes for c in self._live_locked())
        need = int(total * frac)
        if need > 0:
            self._reclaim(need, requester=None, trigger=trigger)
        return need

    def _export_locked(self):
        per: dict[str, int] = {}
        dev: dict[int, int] = {}
        for c in self._live_locked():
            per[c.name] = per.get(c.name, 0) + c._bytes
            for slot, nb in c._dev.items():
                dev[slot] = dev.get(slot, 0) + nb
        for name, nb in per.items():
            metrics.MEM_RESIDENT.set(nb, client=name)
        for slot, nb in dev.items():
            metrics.MEM_DEVICE_RESIDENT.set(nb, device=f"d{slot}")
