"""WriteLogger — shared append-only log per (table, shard).

Reference: dax/writelogger/writelogger.go:22 — AppendMessage/
LogReader over a shared filesystem; each (table, partition|shard) has
its own log file, truncated when a snapshot supersedes it.

Entries are JSONL: {"op": "bits"|"values", ...import payload...}.
Replay applies them in append order, which reproduces the shard
exactly (imports are idempotent last-write-wins per bit/value).
"""

from __future__ import annotations

import json
import os
import threading


class WriteLogger:
    def __init__(self, path: str):
        self.path = path
        self._lock = threading.Lock()
        # absolute version per (table, shard), seeded from disk once —
        # O(1) appends instead of re-counting the file every time
        self._versions: dict[tuple[str, int], int] = {}
        os.makedirs(path, exist_ok=True)

    def _log_path(self, table: str, shard: int) -> str:
        return os.path.join(self.path, f"{table}.shard.{shard:04d}.log")

    def _base(self, table: str, shard: int) -> int:
        """Versions are ABSOLUTE across truncations: a snapshot taken
        at version V stays valid after the entries it covers are
        dropped.  base = how many entries have been truncated away."""
        p = self._log_path(table, shard) + ".base"
        if not os.path.exists(p):
            return 0
        with open(p) as f:
            return int(f.read().strip() or 0)

    def _set_base(self, table: str, shard: int, base: int):
        with open(self._log_path(table, shard) + ".base", "w") as f:
            f.write(str(base))

    def _count(self, table: str, shard: int) -> int:
        p = self._log_path(table, shard)
        if not os.path.exists(p):
            return 0
        with open(p) as f:
            return sum(1 for _ in f)

    def _version_locked(self, table: str, shard: int) -> int:
        key = (table, shard)
        v = self._versions.get(key)
        if v is None:
            v = self._base(table, shard) + self._count(table, shard)
            self._versions[key] = v
        return v

    def append(self, table: str, shard: int, entry: dict) -> int:
        """Append one entry; returns the log's absolute version (total
        entries ever appended)."""
        with self._lock:
            v = self._version_locked(table, shard) + 1
            p = self._log_path(table, shard)
            with open(p, "a") as f:
                f.write(json.dumps(entry, separators=(",", ":")) + "\n")
            self._versions[(table, shard)] = v
            return v

    def replay(self, table: str, shard: int,
               from_version: int = 0) -> list[dict]:
        """Entries after absolute version from_version, in append
        order (writelogger.LogReader)."""
        p = self._log_path(table, shard)
        if not os.path.exists(p):
            return []
        skip = max(0, from_version - self._base(table, shard))
        out = []
        with open(p) as f:
            for i, line in enumerate(f):
                if i >= skip and line.strip():
                    out.append(json.loads(line))
        return out

    def version(self, table: str, shard: int) -> int:
        with self._lock:
            return self._version_locked(table, shard)

    def fast_forward(self, table: str, shard: int, version: int):
        """Advance a (possibly fresh) log to an absolute version the
        blob tier already covers, so later appends continue the
        global numbering instead of regressing below it.  Any local
        entries at or below `version` are covered by definition and
        dropped (stateless workers boot with an empty log, so this is
        normally a pure base bump)."""
        with self._lock:
            cur = self._version_locked(table, shard)
            if version <= cur:
                return
            p = self._log_path(table, shard)
            with open(p, "w"):
                pass
            self._set_base(table, shard, version)
            self._versions[(table, shard)] = version

    def truncate_through(self, table: str, shard: int, version: int):
        """Drop entries a snapshot at absolute `version` covers."""
        with self._lock:
            base = self._base(table, shard)
            if version <= base:
                return
            keep = self.replay(table, shard, from_version=version)
            p = self._log_path(table, shard)
            with open(p, "w") as f:
                for e in keep:
                    f.write(json.dumps(e, separators=(",", ":")) + "\n")
            self._set_base(table, shard, version)

    def shards(self, table: str) -> list[int]:
        out = []
        for fn in os.listdir(self.path):
            if fn.startswith(f"{table}.shard.") and fn.endswith(".log"):
                out.append(int(fn.split(".")[-2]))
        return sorted(out)
