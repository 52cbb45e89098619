"""Snapshotter — versioned shard snapshots in shared storage.

Reference: dax/snapshotter/snapshotter.go:24 — WriteSnapshot/
ReadSnapshot keyed (table, shard, writelog-version); recovery loads
the latest snapshot then replays the write-log tail past its version
(api_directive.go:559 loadShard).
"""

from __future__ import annotations

import json
import os
import threading


class Snapshotter:
    def __init__(self, path: str):
        self.path = path
        self._lock = threading.Lock()
        os.makedirs(path, exist_ok=True)

    def _snap_path(self, table: str, shard: int, version: int) -> str:
        return os.path.join(
            self.path, f"{table}.shard.{shard:04d}.v{version:08d}.snap")

    def write(self, table: str, shard: int, version: int, blob: bytes):
        """Store a snapshot of the shard state as of log `version`."""
        with self._lock:
            p = self._snap_path(table, shard, version)
            tmp = p + ".tmp"
            with open(tmp, "wb") as f:
                f.write(blob)
            os.replace(tmp, p)  # atomic: readers never see partials
            # older versions are garbage once a newer one lands
            for fn in os.listdir(self.path):
                if (fn.startswith(f"{table}.shard.{shard:04d}.v")
                        and fn.endswith(".snap")
                        and fn != os.path.basename(p)):
                    os.unlink(os.path.join(self.path, fn))

    def latest(self, table: str, shard: int) -> tuple[int, bytes] | None:
        """(version, blob) of the newest snapshot, or None.  Holds the
        lock so write()'s unlink of superseded versions can't race the
        scan-then-open."""
        with self._lock:
            best = None
            prefix = f"{table}.shard.{shard:04d}.v"
            for fn in os.listdir(self.path):
                if fn.startswith(prefix) and fn.endswith(".snap"):
                    v = int(fn[len(prefix):-5])
                    if best is None or v > best:
                        best = v
            if best is None:
                return None
            with open(self._snap_path(table, shard, best), "rb") as f:
                return best, f.read()


def snapshot_fragment_rows(frag_rows: dict) -> bytes:
    """Serialize {(field, view, row_id): packed-words} row data."""
    out = []
    for (field, view, row), words in frag_rows.items():
        out.append({"f": field, "v": view, "r": int(row),
                    "w": words.tobytes().hex()})
    return json.dumps(out).encode()


def load_fragment_rows(blob: bytes):
    import numpy as np
    out = {}
    for e in json.loads(blob.decode()):
        out[(e["f"], e["v"], e["r"])] = np.frombuffer(
            bytes.fromhex(e["w"]), dtype=np.uint32).copy()
    return out
