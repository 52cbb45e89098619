"""Blob shard store — the disaggregated tier's one durable home.

Reference: the DAX deployment parks cold shard data in an external
object store (S3-shaped WriteLogger/Snapshotter services) so compute
workers stay stateless; this build re-expresses that as an in-process
object-store-SHAPED interface: opaque keys, put/get/list/delete, no
rename, no partial reads — everything a real S3 client offers, and
nothing it doesn't.  Two backends ship: ``LocalDirBackend`` (keys are
relative paths under a root, written tmp+fsync+rename so a crashed
put never leaves a half object) and ``MemBackend`` (a dict — the
fault-injection arm of every drill).

Layout — per (table, shard), a *versioned manifest* names the current
snapshot object plus the WAL segment objects layered over it::

    {table}/{shard:05d}/manifest.json
        {"manifest_version": N, "table": t, "shard": s,
         "snapshot": {"key", "version", "sha256", "bytes"} | None,
         "segments": [{"key", "from_version", "to_version",
                       "sha256", "bytes"}, ...]}
    {table}/{shard:05d}/snap.v{version:08d}.{sha8}
    {table}/{shard:05d}/seg.v{from:08d}-{to:08d}.{sha8}

Torn-upload invisibility is structural: data objects upload FIRST
under content-hashed keys, the manifest flips LAST, and a reader
always resolves through the manifest — an upload that dies anywhere
before the manifest flip leaves at most an orphan object no manifest
names (the ``blob-torn-upload`` fault point drills exactly that
window).  Every get re-verifies the manifest's sha256 before
returning; a checksum mismatch is a typed :class:`BlobError`, never
silently-served corruption.  ``blob-unavailable`` turns any backend
op into a :class:`BlobUnavailableError` (workers surface it as a
typed 503 — degraded, never a silent partial result).
"""

from __future__ import annotations

import hashlib
import json
import os
import threading

from pilosa_tpu_torch.obs import faults, metrics


class BlobError(Exception):
    """Typed blob-tier failure (checksum mismatch, malformed
    manifest).  Carries an HTTP status so serving surfaces map it
    without string-matching."""

    status = 500


class BlobUnavailableError(BlobError):
    """The blob tier is unreachable — the outage shape.  503: the
    condition is transient and retryable, exactly like an admission
    shed."""

    status = 503


def _check(op: str, key: str):
    """The ``blob-unavailable`` fault seam, consulted by every
    backend op (detail: ``op:key``)."""
    try:
        faults.fire("blob-unavailable", f"{op}:{key}")
    except faults.InjectedFault as e:
        raise BlobUnavailableError(
            f"blob tier unavailable ({op} {key!r})") from e


class MemBackend:
    """Dict-backed object store — the default test/drill arm."""

    def __init__(self):
        self._objects: dict[str, bytes] = {}
        self._lock = threading.Lock()

    def put(self, key: str, data: bytes):
        _check("put", key)
        with self._lock:
            self._objects[key] = bytes(data)

    def get(self, key: str) -> bytes:
        _check("get", key)
        with self._lock:
            try:
                return self._objects[key]
            except KeyError:
                raise BlobError(f"no such object: {key}") from None

    def exists(self, key: str) -> bool:
        _check("head", key)
        with self._lock:
            return key in self._objects

    def list(self, prefix: str = "") -> list[str]:
        _check("list", prefix)
        with self._lock:
            return sorted(k for k in self._objects
                          if k.startswith(prefix))

    def delete(self, key: str):
        _check("delete", key)
        with self._lock:
            self._objects.pop(key, None)


class LocalDirBackend:
    """Keys are relative paths under ``root``; puts land
    tmp+fsync+rename so a crash mid-put never leaves a half object
    (the same atomicity contract every store in this repo keeps)."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    def _path(self, key: str) -> str:
        # opaque keys stay INSIDE the root: reject traversal shapes
        # rather than normalizing them away
        if key.startswith(("/", "~")) or ".." in key.split("/"):
            raise BlobError(f"invalid object key: {key!r}")
        return os.path.join(self.root, *key.split("/"))

    def put(self, key: str, data: bytes):
        _check("put", key)
        path = self._path(key)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)

    def get(self, key: str) -> bytes:
        _check("get", key)
        try:
            with open(self._path(key), "rb") as f:
                return f.read()
        except FileNotFoundError:
            raise BlobError(f"no such object: {key}") from None

    def exists(self, key: str) -> bool:
        _check("head", key)
        return os.path.isfile(self._path(key))

    def list(self, prefix: str = "") -> list[str]:
        _check("list", prefix)
        out = []
        for dirpath, _dirs, files in os.walk(self.root):
            rel = os.path.relpath(dirpath, self.root)
            rel = "" if rel == "." else rel.replace(os.sep, "/") + "/"
            for fname in files:
                if fname.endswith(".tmp"):
                    continue  # torn-put debris is never listable
                key = rel + fname
                if key.startswith(prefix):
                    out.append(key)
        return sorted(out)

    def delete(self, key: str):
        _check("delete", key)
        try:
            os.remove(self._path(key))
        except FileNotFoundError:
            pass


def make_backend(kind: str, root: str | None = None):
    """Config-string backend factory ([blob] backend = "dir"|"mem")."""
    if kind == "mem":
        return MemBackend()
    if kind == "dir":
        if not root:
            raise BlobError("[blob] backend='dir' needs [blob] root")
        return LocalDirBackend(root)
    raise BlobError(f"unknown blob backend {kind!r}")


def _sha(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


class BlobStore:
    """Versioned per-shard manifests over a backend.

    The writer protocol (one writer per shard at a time — the shard's
    owning worker, serialized by the controller's placement):
    ``put_snapshot`` on checkpoint, ``put_segment`` for the WAL tail
    sealed at hand-off; both upload data first and flip the manifest
    last.  Readers call ``restore`` and get a checksum-verified
    (version, snapshot bytes, ordered segment list).
    """

    def __init__(self, backend):
        self.backend = backend
        self._lock = threading.Lock()

    # -- keys ----------------------------------------------------------

    @staticmethod
    def _prefix(table: str, shard: int) -> str:
        return f"{table}/{int(shard):05d}/"

    def _manifest_key(self, table: str, shard: int) -> str:
        return self._prefix(table, shard) + "manifest.json"

    # -- manifest read -------------------------------------------------

    def manifest(self, table: str, shard: int) -> dict | None:
        """The current manifest, or None when the shard has never
        been uploaded.  Unavailability propagates typed; a manifest
        that exists but doesn't parse is corruption, not absence."""
        key = self._manifest_key(table, shard)
        if not self.backend.exists(key):
            return None
        raw = self.backend.get(key)
        metrics.DAX_BLOB_BYTES.inc(len(raw), op="get")
        try:
            m = json.loads(raw)
        except ValueError as e:
            raise BlobError(f"corrupt manifest {key}: {e}") from None
        if not isinstance(m, dict) or "manifest_version" not in m:
            raise BlobError(f"malformed manifest {key}")
        return m

    def shards(self) -> list[tuple[str, int]]:
        """Every (table, shard) with a manifest — the cold catalog a
        booting worker or a donor-less copy phase enumerates."""
        out = []
        for key in self.backend.list():
            if not key.endswith("/manifest.json"):
                continue
            parts = key.split("/")
            if len(parts) != 3:
                continue
            try:
                out.append((parts[0], int(parts[1])))
            except ValueError:
                continue
        return sorted(out)

    def covered_version(self, table: str, shard: int) -> int:
        """Highest WAL version the blob tier holds for a shard (0 =
        nothing uploaded): the worker's seal/snapshot planes upload
        only past this, and hydration replays the live WAL from it."""
        m = self.manifest(table, shard)
        if m is None:
            return 0
        v = int((m.get("snapshot") or {}).get("version", 0))
        for seg in m.get("segments", ()):
            v = max(v, int(seg.get("to_version", 0)))
        return v

    # -- writes (data first, manifest flip LAST) -----------------------

    def _flip_manifest(self, table: str, shard: int, m: dict):
        m["manifest_version"] = int(m.get("manifest_version", 0)) + 1
        raw = json.dumps(m, sort_keys=True).encode()
        self.backend.put(self._manifest_key(table, shard), raw)
        metrics.DAX_BLOB_BYTES.inc(len(raw), op="put")

    def _put_object(self, key: str, data: bytes):
        """One data-object upload, with the ``blob-torn-upload``
        crash seam: when armed, HALF the object lands under the key
        and the 'process dies' before the manifest flip — the reader
        contract is that this must be invisible (the old manifest
        still resolves the old, complete objects)."""
        if faults.armed("blob-torn-upload"):
            self.backend.put(key, data[: max(1, len(data) // 2)])
            faults.fire("blob-torn-upload", key)
        self.backend.put(key, data)
        metrics.DAX_BLOB_BYTES.inc(len(data), op="put")

    def put_snapshot(self, table: str, shard: int, version: int,
                     data: bytes) -> str:
        """Upload a shard snapshot at WAL ``version`` and flip the
        manifest to it, retiring the segments (and prior snapshot) it
        supersedes.  Retired objects delete AFTER the flip — a crash
        between leaves unreferenced garbage, never a dangling
        reference."""
        with self._lock:
            m = self.manifest(table, shard) or {
                "manifest_version": 0, "table": table,
                "shard": int(shard), "snapshot": None, "segments": []}
            if version < int((m.get("snapshot") or {})
                             .get("version", 0)):
                raise BlobError(
                    f"stale snapshot upload v{version} for "
                    f"{table}/{shard}")
            digest = _sha(data)
            key = (self._prefix(table, shard)
                   + f"snap.v{int(version):08d}.{digest[:8]}")
            self._put_object(key, data)
            old_snap = m.get("snapshot")
            keep, retired = [], []
            for seg in m.get("segments", ()):
                if int(seg.get("to_version", 0)) <= int(version):
                    retired.append(seg["key"])
                else:
                    keep.append(seg)
            m["snapshot"] = {"key": key, "version": int(version),
                             "sha256": digest, "bytes": len(data)}
            m["segments"] = keep
            self._flip_manifest(table, shard, m)
            if old_snap and old_snap.get("key") != key:
                retired.append(old_snap["key"])
            for k in retired:
                try:
                    self.backend.delete(k)
                except BlobError:
                    pass  # garbage, swept on a later pass
            return key

    def put_segment(self, table: str, shard: int, from_version: int,
                    to_version: int, data: bytes) -> str:
        """Upload one sealed WAL segment covering
        ``(from_version, to_version]`` and append it to the
        manifest."""
        if to_version <= from_version:
            raise BlobError(
                f"empty segment v{from_version}-{to_version}")
        with self._lock:
            m = self.manifest(table, shard) or {
                "manifest_version": 0, "table": table,
                "shard": int(shard), "snapshot": None, "segments": []}
            covered = int((m.get("snapshot") or {}).get("version", 0))
            for seg in m.get("segments", ()):
                covered = max(covered, int(seg["to_version"]))
            if from_version != covered:
                raise BlobError(
                    f"segment gap for {table}/{shard}: have v"
                    f"{covered}, got v{from_version}-{to_version}")
            digest = _sha(data)
            key = (self._prefix(table, shard)
                   + f"seg.v{int(from_version):08d}-"
                     f"{int(to_version):08d}.{digest[:8]}")
            self._put_object(key, data)
            m.setdefault("segments", []).append(
                {"key": key, "from_version": int(from_version),
                 "to_version": int(to_version), "sha256": digest,
                 "bytes": len(data)})
            self._flip_manifest(table, shard, m)
            return key

    def delete_shard(self, table: str, shard: int):
        """Drop a shard from the blob tier (table drop): manifest
        first — readers lose the reference before the data goes."""
        with self._lock:
            self.backend.delete(self._manifest_key(table, shard))
            for key in self.backend.list(self._prefix(table, shard)):
                self.backend.delete(key)

    # -- restore (checksum-verified) -----------------------------------

    def _get_verified(self, ref: dict) -> bytes:
        data = self.backend.get(ref["key"])
        metrics.DAX_BLOB_BYTES.inc(len(data), op="get")
        if _sha(data) != ref.get("sha256"):
            raise BlobError(
                f"checksum mismatch on {ref['key']} "
                f"({len(data)} bytes)")
        return data

    def restore(self, table: str, shard: int):
        """(covered_version, snapshot bytes | None, [(from, to,
        segment bytes), ...]) — everything a hydrating worker
        replays, each object verified against its manifest sha256.
        None when the shard has never been uploaded."""
        m = self.manifest(table, shard)
        if m is None:
            return None
        snap = m.get("snapshot")
        snap_data = self._get_verified(snap) if snap else None
        version = int(snap.get("version", 0)) if snap else 0
        segs = []
        for seg in sorted(m.get("segments", ()),
                          key=lambda s: int(s["from_version"])):
            segs.append((int(seg["from_version"]),
                         int(seg["to_version"]),
                         self._get_verified(seg)))
            version = max(version, int(seg["to_version"]))
        return version, snap_data, segs
