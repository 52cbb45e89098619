"""Adaptive worker pool with blocked-task detection.

Reference: task/ (task/doc.go:4-30) — a worker pool whose size grows
when every worker is blocked on IO (so compute-bound work keeps a
small pool, but a pool full of stalled RPCs adds workers instead of
deadlocking) and shrinks back toward the target.  The executor's
shard fan-out uses it (executor.go:6714-6739); here the HOST-side
users are the cluster/DAX node fan-outs, whose tasks are HTTP RPCs —
exactly the blocked-on-IO shape the adaptive growth exists for.
(Device-side shard math does not go through a pool: the engines batch
shards into single kernel launches instead.)
"""

from __future__ import annotations

import threading
from contextlib import contextmanager


class TaskFailure:
    """Typed settled-failure marker: the exception one pooled task
    raised, with the item that produced it.  ``map_settled`` returns
    these IN PLACE of results, so one crashing fan-out task fails only
    its own request — the pool, its counters, and every sibling task
    settle normally (worker-death containment)."""

    __slots__ = ("item", "error")

    def __init__(self, item, error: BaseException):
        self.item = item
        self.error = error

    def __repr__(self):
        return (f"TaskFailure(item={self.item!r}, "
                f"error={type(self.error).__name__}: {self.error})")


class Pool:
    def __init__(self, size: int = 2, max_size: int = 32):
        self.size = size
        self.max_size = max_size
        self._lock = threading.Lock()
        self._active = 0    # workers currently running a task
        self._blocked = 0   # of those, how many declared themselves blocked

    @contextmanager
    def blocked(self):
        """A task wraps its IO waits in this (task.Pool's Block/
        Unblock); while every worker is blocked the pool admits
        more concurrency."""
        with self._lock:
            self._blocked += 1
        try:
            yield
        finally:
            with self._lock:
                self._blocked -= 1

    def _current_limit(self) -> int:
        # all running workers blocked -> grow, up to max_size
        if self._active and self._blocked >= self._active:
            return min(self.max_size, self._active + 1)
        return self.size

    def map(self, fn, items) -> list:
        """Run fn(item) for every item; order-preserving results.
        The first exception (by item order) propagates after all
        tasks settle."""
        outs = self.map_settled(fn, items)
        for o in outs:
            if isinstance(o, TaskFailure):
                raise o.error
        return outs

    def map_settled(self, fn, items) -> list:
        """Run fn(item) for every item; order-preserving results with
        per-item failures CONTAINED: a task whose fn raises settles as
        a :class:`TaskFailure` (typed, carrying the item and the
        exception) instead of poisoning the whole map — siblings run
        to completion and the pool's counters stay balanced, so a
        shared pool is reusable after any storm of task deaths.

        fn receives (pool, item) when it accepts two args, so tasks
        can use pool.blocked() around their IO.
        """
        items = list(items)
        results: list = [None] * len(items)
        it = iter(enumerate(items))
        it_lock = threading.Lock()

        import inspect
        try:
            takes_pool = len(inspect.signature(fn).parameters) >= 2
        except (TypeError, ValueError):
            takes_pool = False  # uninspectable callable (C builtin)

        def worker():
            while True:
                with it_lock:
                    try:
                        i, item = next(it)
                    except StopIteration:
                        return
                with self._lock:
                    self._active += 1
                try:
                    results[i] = fn(self, item) if takes_pool else fn(item)
                except BaseException as e:
                    results[i] = TaskFailure(item, e)
                finally:
                    with self._lock:
                        self._active -= 1

        n = min(len(items), self._spawn_count())
        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(max(1, n))]
        for t in threads:
            t.start()
        # adaptive growth: while tasks remain and all workers report
        # blocked, add a worker (bounded)
        remaining = True
        while remaining:
            alive = [t for t in threads if t.is_alive()]
            if not alive:
                break
            with self._lock:
                grow = (self._active and
                        self._blocked >= self._active and
                        len(threads) < self.max_size)
            if grow:
                t = threading.Thread(target=worker, daemon=True)
                threads.append(t)
                t.start()
            alive[0].join(timeout=0.05)
            remaining = any(t.is_alive() for t in threads)
        for t in threads:
            t.join()
        return results

    def _spawn_count(self) -> int:
        return self.size


# default host-fan-out pool (executor.go default pool size 2, adaptive)
default_pool = Pool(size=2, max_size=32)
