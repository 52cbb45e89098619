"""Durable controller state — the schemar + Transactor analog.

Reference: dax/controller/schemar/ keeps the schema in a SQL database
and dax/controller's Transactor wraps every registry mutation in a DB
transaction, so a controller restart loses nothing: workers, schema,
table/shard jobs, per-worker directive versions and the fingerprints
of what each worker last enacted all reload from disk.  This module
is the same idea on sqlite (stdlib): one file, one transaction per
mutation, write-through from the controller under its lock.
"""

from __future__ import annotations

import json
import sqlite3
import threading


class Schemar:
    """sqlite-backed controller state store."""

    def __init__(self, path: str):
        self.path = path
        # the controller serializes mutations under its own RLock;
        # the sqlite handle still gets a lock so poller/API threads
        # can read concurrently
        self._lock = threading.Lock()
        self._closed = False
        self._db = sqlite3.connect(path, check_same_thread=False)
        with self._lock, self._db:
            self._db.executescript(
                "CREATE TABLE IF NOT EXISTS workers ("
                " address TEXT PRIMARY KEY, uri TEXT NOT NULL);"
                "CREATE TABLE IF NOT EXISTS kv ("
                " key TEXT PRIMARY KEY, value TEXT NOT NULL);"
                "CREATE TABLE IF NOT EXISTS shard_jobs ("
                " tbl TEXT NOT NULL, shard INTEGER NOT NULL,"
                " PRIMARY KEY (tbl, shard));"
                "CREATE TABLE IF NOT EXISTS worker_state ("
                " address TEXT PRIMARY KEY, version INTEGER NOT NULL,"
                " pushed TEXT);")

    # -- load (controller start) ----------------------------------------

    def load(self) -> dict:
        with self._lock:
            if self._closed:
                raise RuntimeError("schemar is closed")
            cur = self._db.cursor()
            workers = dict(cur.execute(
                "SELECT address, uri FROM workers").fetchall())
            row = cur.execute(
                "SELECT value FROM kv WHERE key='schema'").fetchone()
            schema = json.loads(row[0]) if row else {}
            tables: dict[str, set[int]] = {}
            for tbl, shard in cur.execute(
                    "SELECT tbl, shard FROM shard_jobs"):
                tables.setdefault(tbl, set()).add(int(shard))
            versions = {}
            pushed = {}
            for addr, ver, fp in cur.execute(
                    "SELECT address, version, pushed "
                    "FROM worker_state"):
                versions[addr] = int(ver)
                if fp is not None:
                    pushed[addr] = fp
        return {"workers": workers, "schema": schema,
                "tables": tables, "versions": versions,
                "pushed": pushed}

    # -- mutations (one transaction each) -------------------------------

    def _tx(self, fn) -> None:
        """One locked transaction; a no-op after close() — a poll
        cycle blocked on a dead worker's HTTP timeout can outlive
        restart_controller's stop_poller join, and its late drop must
        not crash on the closed handle (the fresh controller's own
        poll re-detects the dead worker)."""
        with self._lock:
            if self._closed:
                return
            with self._db:
                fn(self._db)

    def save_worker(self, address: str, uri: str):
        self._tx(lambda db: db.execute(
            "INSERT INTO workers (address, uri) VALUES (?, ?) "
            "ON CONFLICT(address) DO UPDATE SET uri=excluded.uri",
            (address, uri)))

    def register_worker(self, address: str, uri: str, version: int):
        """Worker row + fingerprint reset in ONE transaction: a crash
        between them must not strand a re-registered (fresh) worker
        behind a stale persisted fingerprint."""
        def run(db):
            db.execute(
                "INSERT INTO workers (address, uri) VALUES (?, ?) "
                "ON CONFLICT(address) DO UPDATE SET "
                "uri=excluded.uri", (address, uri))
            db.execute(
                "INSERT INTO worker_state (address, version, pushed) "
                "VALUES (?, ?, NULL) ON CONFLICT(address) DO UPDATE "
                "SET pushed=NULL", (address, version))
        self._tx(run)

    def delete_worker(self, address: str):
        def run(db):
            db.execute("DELETE FROM workers WHERE address=?",
                       (address,))
            db.execute("DELETE FROM worker_state WHERE address=?",
                       (address,))
        self._tx(run)

    def save_schema(self, schema: dict):
        self._tx(lambda db: db.execute(
            "INSERT INTO kv (key, value) VALUES ('schema', ?) "
            "ON CONFLICT(key) DO UPDATE SET value=excluded.value",
            (json.dumps(schema),)))

    def add_shards(self, table: str, shards):
        self._tx(lambda db: db.executemany(
            "INSERT OR IGNORE INTO shard_jobs (tbl, shard) "
            "VALUES (?, ?)", [(table, int(s)) for s in shards]))

    def drop_table(self, table: str):
        self._tx(lambda db: db.execute(
            "DELETE FROM shard_jobs WHERE tbl=?", (table,)))

    def save_kv(self, key: str, value: str):
        """Generic durable controller state (placement overlay,
        standby roster, admit order) — same write-through-per-
        mutation contract as the named tables."""
        self._tx(lambda db: db.execute(
            "INSERT INTO kv (key, value) VALUES (?, ?) "
            "ON CONFLICT(key) DO UPDATE SET value=excluded.value",
            (key, value)))

    def load_kv(self, key: str) -> str | None:
        with self._lock:
            if self._closed:
                return None
            row = self._db.execute(
                "SELECT value FROM kv WHERE key=?", (key,)).fetchone()
        return row[0] if row else None

    def save_worker_state(self, address: str, version: int,
                          pushed: str | None):
        self._tx(lambda db: db.execute(
            "INSERT INTO worker_state (address, version, pushed) "
            "VALUES (?, ?, ?) ON CONFLICT(address) DO UPDATE SET "
            "version=excluded.version, pushed=excluded.pushed",
            (address, version, pushed)))

    def close(self):
        with self._lock:
            self._closed = True
            self._db.close()
