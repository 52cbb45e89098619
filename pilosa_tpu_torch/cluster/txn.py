"""Cluster-wide transactions (transaction.go:20,56,87,223).

Exclusive transactions gate operations that need a quiesced cluster
(backup uses one).  Semantics kept from the reference: a transaction
has an id, timeout and deadline; at most one EXCLUSIVE transaction is
active and while one is active (or pending) no new transactions start;
an exclusive transaction becomes 'active' once granted; finishing or
expiring it unblocks the queue.  Lives on the primary node.
"""

from __future__ import annotations

import threading
import time
import uuid
from dataclasses import dataclass, field


class TransactionError(Exception):
    pass


@dataclass
class Transaction:
    id: str
    timeout: float
    exclusive: bool = False
    active: bool = False
    created: float = field(default_factory=time.time)
    deadline: float = 0.0

    def to_dict(self):
        return {"id": self.id, "timeout": self.timeout,
                "exclusive": self.exclusive, "active": self.active,
                "deadline": self.deadline}


class TransactionManager:
    def __init__(self, default_timeout: float = 60.0):
        self._txs: dict[str, Transaction] = {}
        self._lock = threading.RLock()
        self.default_timeout = default_timeout

    def start(self, id: str | None = None, timeout: float | None = None,
              exclusive: bool = False) -> Transaction:
        """Start (or queue) a transaction (api.StartTransaction)."""
        timeout = timeout or self.default_timeout
        with self._lock:
            self._expire_locked()
            tid = id or uuid.uuid4().hex
            if tid in self._txs:
                raise TransactionError(f"transaction exists: {tid}")
            blocked = any(t.exclusive for t in self._txs.values())
            if exclusive:
                if blocked:
                    # a second queued exclusive could never activate
                    # (activation requires being the only remaining tx)
                    raise TransactionError(
                        "exclusive transaction already pending")
                # exclusive waits for all current txs to drain; it is
                # immediately active only on an idle manager
                tx = Transaction(tid, timeout, exclusive=True,
                                 active=not self._txs)
            else:
                if blocked:
                    raise TransactionError(
                        "exclusive transaction pending; retry later")
                tx = Transaction(tid, timeout, active=True)
            tx.deadline = time.time() + timeout
            self._txs[tid] = tx
            return _copy(tx)

    def exclusive_active(self) -> bool:
        """True while an ACTIVE exclusive transaction holds the
        cluster read-only (transaction.go: writes are refused while a
        backup's exclusive transaction runs)."""
        with self._lock:
            self._expire_locked()
            return any(t.exclusive and t.active
                       for t in self._txs.values())

    def finish(self, tid: str) -> Transaction:
        with self._lock:
            tx = self._txs.pop(tid, None)
            if tx is None:
                raise TransactionError(f"no such transaction: {tid}")
            self._activate_exclusive_locked()
            return tx

    def get(self, tid: str) -> Transaction:
        with self._lock:
            self._expire_locked()
            tx = self._txs.get(tid)
            if tx is None:
                raise TransactionError(f"no such transaction: {tid}")
            return _copy(tx)

    def list(self) -> dict[str, dict]:
        with self._lock:
            self._expire_locked()
            return {t.id: t.to_dict() for t in self._txs.values()}

    def poll_until_active(self, tid: str, poll: float = 0.02,
                          max_wait: float = 10.0) -> Transaction:
        """Wait for a queued exclusive transaction to activate
        (ctl/backup.go polls the same way)."""
        deadline = time.time() + max_wait
        while True:
            tx = self.get(tid)
            if tx.active:
                return tx
            if time.time() > deadline:
                raise TransactionError(f"timeout waiting for {tid}")
            time.sleep(poll)

    def _expire_locked(self):
        now = time.time()
        dead = [t.id for t in self._txs.values() if t.deadline < now]
        for tid in dead:
            del self._txs[tid]
        if dead:
            self._activate_exclusive_locked()

    def _activate_exclusive_locked(self):
        excl = [t for t in self._txs.values() if t.exclusive]
        if excl and len(self._txs) == 1:
            excl[0].active = True


def _copy(tx: Transaction) -> Transaction:
    return Transaction(tx.id, tx.timeout, tx.exclusive, tx.active,
                       tx.created, tx.deadline)
