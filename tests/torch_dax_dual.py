"""The JAX package's DAX tier and the port's side by side.

``Pkg("jax")`` and ``Pkg("port")`` give one package's DAX surface under
the same names (``DAXService``, ``BlobStore``, ``MemBackend``,
``faults``, ...), so that one scenario function runs on each and the
two records it returns can be compared.  The port's services run on
the CPU (``device="cpu"``) with one ``Config`` that the package object
owns and hands to every service it makes; ``Pkg.knobs`` sets a [dax]
knob through that Config (and ``apply_dax_settings``) for the port and
through the environment twin the JAX accessors read for the JAX
package.  ``dual`` runs a scenario on both and asserts the records
equal; ``dax_globals`` restores both packages' settings, the
environment and the fault registries around a test.
"""

from __future__ import annotations

import contextlib
import importlib
import os

from torch_server_dual import restore_globals

SHARD = 1 << 20

SCHEMA = {"indexes": [{"name": "t", "fields": [
    {"name": "f", "options": {"type": "set"}},
    {"name": "v", "options": {"type": "int", "min": 0, "max": 1000}},
]}]}

# [dax] knob -> the JAX accessor's environment twin
_JAX_ENV = {
    "blob": "PILOSA_TPU_DAX_BLOB",
    "prefetch": "PILOSA_TPU_DAX_PREFETCH",
    "cooldown_s": "PILOSA_TPU_DAX_COOLDOWN_S",
    "chase_lag": "PILOSA_TPU_DAX_CHASE_LAG",
    "chase_rounds": "PILOSA_TPU_DAX_CHASE_ROUNDS",
    "worker_budget_bytes": "PILOSA_TPU_DAX_WORKER_BUDGET_BYTES",
}

# the deterministic knobs of the tier tests (test_dax_tier.py's
# _tier_env)
TIER_KNOBS = {"prefetch": 0, "cooldown_s": 0, "chase_lag": 2,
              "chase_rounds": 4}


class Pkg:
    """One package's DAX surface under shared names."""

    def __init__(self, name: str, **knobs):
        self.name = name
        root = "pilosa_tpu" if name == "jax" else "pilosa_tpu_torch"

        def mod(m):
            return importlib.import_module(f"{root}.{m}")

        blob = mod("storage.blob")
        for n in ("BlobStore", "MemBackend", "LocalDirBackend",
                  "make_backend", "BlobError", "BlobUnavailableError"):
            setattr(self, n, getattr(blob, n))
        self.settings = mod("dax.settings")
        self.Directive = mod("dax.directive").Directive
        self.WriteLogger = mod("dax.writelogger").WriteLogger
        snap = mod("dax.snapshotter")
        self.Snapshotter = snap.Snapshotter
        self.snapshot_fragment_rows = snap.snapshot_fragment_rows
        self.load_fragment_rows = snap.load_fragment_rows
        self.place = mod("dax.controller")._place
        server = mod("dax.server")
        self._service = server.DAXService
        self.blob_from_settings = server.blob_from_settings
        self.faults = mod("obs.faults")
        self.incidents = mod("obs.incidents")
        self.metrics = mod("obs.metrics")
        client = mod("cluster.client")
        self.InternalClient = client.InternalClient
        self.RemoteError = client.RemoteError
        self.SQLError = mod("sql").SQLError
        self.config_mod = mod("config")
        self.cfg = None
        if name == "port":
            self.cfg = self.config_mod.load(None, env={},
                                            overrides={"grpc_port": -1})
            self.cfg.apply_dax_settings()
        self.knobs(**knobs)

    def DAXService(self, storage_dir: str, n_workers: int = 2,
                   poll_interval: float = 0.5, blob=None):
        if self.name == "jax":
            return self._service(storage_dir, n_workers=n_workers,
                                 poll_interval=poll_interval, blob=blob)
        return self._service(storage_dir, n_workers=n_workers,
                             poll_interval=poll_interval, blob=blob,
                             device="cpu", config=self.cfg)

    def knobs(self, **kw):
        """Set [dax] knobs: the port's through its Config, the JAX
        package's through the environment twins its accessors read
        (``blob=True`` removes the JAX kill-switch variable)."""
        for k, v in kw.items():
            if self.name == "jax":
                if k == "blob" and v:
                    os.environ.pop(_JAX_ENV[k], None)
                else:
                    os.environ[_JAX_ENV[k]] = str(int(v) if isinstance(
                        v, bool) else v)
            else:
                setattr(self.cfg, f"dax_{k}", v)
        if self.cfg is not None:
            self.cfg.apply_dax_settings()


@contextlib.contextmanager
def dax_globals():
    """Both packages' dax settings, the environment, every switch the
    servers' config sets and the fault registries, put back on exit."""
    from pilosa_tpu.dax import settings as jax_settings
    from pilosa_tpu.obs import faults as jax_faults
    from pilosa_tpu_torch.obs import faults as port_faults
    saved = {k: getattr(jax_settings, k) for k in vars(jax_settings)
             if k.startswith("_") and not k.startswith("__")
             and not callable(getattr(jax_settings, k))}
    with restore_globals():
        jax_faults.clear()
        port_faults.clear()
        try:
            yield
        finally:
            jax_faults.clear()
            port_faults.clear()
            for k, v in saved.items():
                setattr(jax_settings, k, v)


def dual(scenario, tmp_path, **knobs):
    """Run ``scenario(pkg, dir)`` for the JAX package and then the port
    (each in its own directory under tmp_path, with the given knobs) and
    assert the two records equal; returns the port's record."""
    recs = []
    for name in ("jax", "port"):
        pk = Pkg(name, **knobs)
        d = tmp_path / name
        d.mkdir()
        recs.append(scenario(pk, d))
    assert recs[1] == recs[0], (recs[0], recs[1])
    return recs[1]


def seed(svc, n_shards: int, values=None):
    """test_dax.py's / test_dax_tier.py's _seed: schema, one bit of f=1
    and one value of v in each of n_shards shards; returns the
    columns."""
    svc.queryer.apply_schema(SCHEMA)
    cols = [s * SHARD + 7 for s in range(n_shards)]
    svc.queryer.import_bits("t", "f", [1] * n_shards, cols)
    svc.queryer.import_values(
        "t", "v", cols, list(range(10, 10 * n_shards + 10, 10))
        if values is None else values)
    return cols


def results(svc) -> dict:
    """test_dax_tier.py's _results: the fixed query set's wire
    answers."""
    q = svc.queryer.query
    return {
        "row1": q("t", "Row(f=1)")["results"][0]["columns"],
        "row2": q("t", "Row(f=2)")["results"][0]["columns"],
        "cnt": q("t", "Count(Row(f=1))")["results"],
        "sum": q("t", "Sum(Row(f=1), field=v)")["results"][0],
    }


def checkpoint(svc):
    """Push every held shard's state into the blob tier."""
    for w in svc.workers:
        for t, shards in list(w.held.items()):
            for s in sorted(shards):
                w.snapshot_shard(t, s)


def seal(svc):
    for w in svc.workers:
        for t, shards in list(w.held.items()):
            for s in sorted(shards):
                w.hyd.seal_tail(t, s)


def cold_service(pk, path, name: str, blob, budget=None):
    """A fresh service whose ONLY worker boots with an empty private
    data dir — everything it serves must come from the blob tier."""
    svc = pk.DAXService(str(path / name), n_workers=0, blob=blob)
    svc.queryer.apply_schema(SCHEMA)
    svc.add_blob_worker(f"{name}-w0", budget_bytes=budget)
    for t, s in blob.shards():
        svc.controller.add_shards(t, [s])
    return svc


def tree_bytes(root) -> dict:
    """Every file under root, by relative path, with its bytes."""
    out = {}
    for dirpath, _dirs, files in os.walk(root):
        for f in files:
            p = os.path.join(dirpath, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out
