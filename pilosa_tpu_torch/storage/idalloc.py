"""ID allocation with reserve/commit sessions.

Behavioral port of idalloc.go:43,127,238: ingesters reserve a range of
column ids under a (key, session) pair, write records, then commit.
Re-reserving with the same session before commit returns the same
range (exactly-once semantics across ingester retries).  Multiple
sessions may be in flight per key at once — each concurrent ingester
owns its own session (idk/ingest.go:302 per-clone consumers) and they
must not clobber each other's reservations.  Rolling back or
partially committing the LATEST reservation returns its tail to the
pool; earlier ranges are simply abandoned (ids are sparse-friendly,
gaps are harmless).
"""

from __future__ import annotations

import json
import os
import threading


class IDAllocator:
    def __init__(self, path: str | None = None):
        self.path = path
        self._next: dict[str, int] = {}       # key -> next unreserved id
        # key -> session -> (start, count)
        self._reserved: dict[str, dict[bytes, tuple[int, int]]] = {}
        self._lock = threading.RLock()
        if path and os.path.exists(path):
            with open(path) as f:
                state = json.load(f)
            if "next" not in state and "reserved" not in state:
                # legacy flat format: the whole dict is the next-map
                state = {"next": state}
            self._next = {k: int(v) for k, v in state.get("next", {}).items()}
            for k, sessions in state.get("reserved", {}).items():
                if isinstance(sessions, list):
                    # legacy single-session format [sess, start, count]
                    sess, start, count = sessions
                    self._reserved[k] = {
                        bytes.fromhex(sess): (int(start), int(count))}
                else:
                    self._reserved[k] = {
                        bytes.fromhex(s): (int(v[0]), int(v[1]))
                        for s, v in sessions.items()}

    def _persist(self):
        """Both next-ids AND in-flight reservations persist, so an
        ingester retrying the same session after a crash gets the same
        range back (idalloc.go keeps reservations in BoltDB)."""
        if self.path:
            os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
            with open(self.path, "w") as f:
                json.dump({
                    "next": self._next,
                    "reserved": {
                        k: {sess.hex(): [start, count]
                            for sess, (start, count) in sessions.items()}
                        for k, sessions in self._reserved.items()},
                }, f)

    def reserve(self, key: str, session: bytes, count: int) -> range:
        """Reserve `count` ids for (key, session).  Matching an
        in-flight session returns the same range (idalloc.go:127);
        other sessions' reservations are left untouched."""
        with self._lock:
            sessions = self._reserved.setdefault(key, {})
            held = sessions.get(session)
            if held is not None:
                start, h_count = held
                return range(start, start + h_count)
            start = self._next.get(key, 0)
            sessions[session] = (start, count)
            self._next[key] = start + count
            self._persist()
            return range(start, start + count)

    def _release_tail(self, key: str, start: int, r_count: int,
                      used: int):
        """Return the unused tail to the pool when this reservation is
        still the newest one (its end == next); abandoned otherwise."""
        if self._next.get(key, 0) == start + r_count:
            self._next[key] = start + used

    def commit(self, key: str, session: bytes, count: int | None = None):
        """Commit the reservation (idalloc.go:238).  count < reserved
        marks the rest unused."""
        with self._lock:
            sessions = self._reserved.get(key, {})
            held = sessions.get(session)
            if held is None:
                raise KeyError("no matching reservation to commit")
            start, r_count = held
            if count is not None and count < r_count:
                self._release_tail(key, start, r_count, count)
            del sessions[session]
            if not sessions:
                del self._reserved[key]
            self._persist()

    def rollback(self, key: str, session: bytes):
        with self._lock:
            sessions = self._reserved.get(key, {})
            held = sessions.pop(session, None)
            if held is not None:
                self._release_tail(key, held[0], held[1], 0)
                if not sessions:
                    del self._reserved[key]
                self._persist()
