"""DAX service host — controller + queryer (+ workers) in one process.

Reference: dax/server/ — one binary can host any combination of the
controller, queryer, and computer services; tests and small
deployments run them all in-process (the test.Cluster analog for
DAX).

Two worker shapes coexist:

- ``add_worker``: the seed's shared-storage worker (one WriteLogger +
  Snapshotter directory for the fleet, eager shard loads) — the
  legacy arrangement every pre-tier test runs.
- ``add_blob_worker`` / ``add_standby``: the disaggregated shape — a
  PRIVATE empty data dir per worker, all durable state in the blob
  tier, lazy ledger-paged hydration.  ``start_autoscaler`` runs the
  controller's reconcile loop over them.

``DAXService(device=None)`` runs every worker, the queryer front and
the queryer's schema-only executor on the CUDA card and raises without
one; ``device="cpu"`` runs them on the CPU (the kernels' plain
versions).  ``config`` (``config.load()`` when None) is applied to
``dax.settings`` before the blob tier is chosen and handed to every
worker's ``Server``, whose boot applies it again: a knob set on it
holds for the whole fleet.
"""

from __future__ import annotations

import os

from pilosa_tpu_torch.dax import settings
from pilosa_tpu_torch.dax.computer import ComputeNode
from pilosa_tpu_torch.dax.controller import Controller
from pilosa_tpu_torch.dax.queryer import Queryer
from pilosa_tpu_torch.dax.schemar import Schemar
from pilosa_tpu_torch.dax.snapshotter import Snapshotter
from pilosa_tpu_torch.dax.writelogger import WriteLogger


def blob_from_settings(storage_dir: str):
    """BlobStore per the [blob] stanza (None when no backend is
    configured or the tier kill-switch is off)."""
    from pilosa_tpu_torch.storage.blob import BlobStore, make_backend
    if not settings.blob_enabled():
        return None
    kind = settings.backend()
    if not kind:
        return None
    root = settings.root() or os.path.join(storage_dir, "blob")
    return BlobStore(make_backend(kind, root))


class DAXService:
    """All three services over one shared storage directory."""

    def __init__(self, storage_dir: str, n_workers: int = 2,
                 poll_interval: float = 0.5, blob=None, device=None,
                 config=None):
        from pilosa_tpu_torch import config as cfgmod
        from pilosa_tpu_torch.executor.executor import resolve_device
        self._storage_dir = storage_dir
        self._poll_interval = poll_interval
        self.device = resolve_device(device)
        self.config = cfgmod.load() if config is None else config
        self.config.apply_dax_settings()
        self.blob = blob if blob is not None \
            else blob_from_settings(storage_dir)
        self.wl = WriteLogger(os.path.join(storage_dir, "writelog"))
        self.snaps = Snapshotter(os.path.join(storage_dir, "snapshots"))
        self.controller = Controller(
            poll_interval=poll_interval,
            schemar=Schemar(os.path.join(storage_dir,
                                         "controller.db")))
        self.queryer = Queryer(
            self.controller,
            translate_dir=os.path.join(storage_dir, "queryer"),
            device=self.device)
        self.workers: list[ComputeNode] = []
        for i in range(n_workers):
            self.add_worker(f"worker{i}")

    def serve_queryer(self, bind: str = "127.0.0.1", port: int = 0):
        """HTTP front for the queryer — the dax/server single-binary
        surface: POST /sql (SQL over the fleet), POST
        /queryer/{table} (PQL), GET /dax/status (workers +
        assignments)."""
        from pilosa_tpu_torch.models.holder import Holder
        from pilosa_tpu_torch.server.http import Server

        front = Server(holder=Holder(), bind=bind, port=port,
                       device=self.device, config=self.config)

        def front_sql(req):
            # both body forms of the standard /sql endpoint: raw SQL
            # text and {"sql": "..."}
            from pilosa_tpu_torch.api import _json_value
            body = req.json_lenient()
            stmt = body.get("sql") if isinstance(body, dict) else None
            out = self.queryer.sql(stmt if stmt is not None
                                   else req.text())
            # the cells in API.sql's wire form (a decimal as a float, a
            # timestamp as RFC 3339): the JAX front hands the engine's
            # Decimal and datetime cells to json.dumps, which raises
            out["data"] = [[_json_value(v) for v in row]
                           for row in out["data"]]
            return out

        front.add_route("POST", "/sql", front_sql, override=True)
        front.add_route(
            "POST", "/queryer/{table}",
            lambda req: self.queryer.query(
                req.vars["table"], (req.json() or {}).get("query",
                                                          "")))
        front.add_route(
            "GET", "/dax/status",
            lambda req: self.controller.status())
        self.queryer_front = front.start()
        return self.queryer_front

    def restart_controller(self):
        """Kill the controller process-state and boot a fresh one from
        the schemar DB (the reference's controller restart: schema +
        job registry + directive versions survive in the SQL store).
        Workers keep serving throughout."""
        self.controller.stop_reconciler()
        self.controller.stop_poller()
        self.controller._schemar.close()
        self.controller = Controller(
            poll_interval=self._poll_interval,
            schemar=Schemar(os.path.join(self._storage_dir,
                                         "controller.db")))
        self.queryer.controller = self.controller
        return self.controller

    def add_worker(self, address: str) -> ComputeNode:
        """Shared-storage worker (the seed arrangement).  When the
        service has a blob tier, the worker writes through to it on
        snapshot and hydrates lazily from it."""
        w = ComputeNode(address, self.wl, self.snaps, blob=self.blob,
                        device=self.device, config=self.config).open()
        self.workers.append(w)
        self.controller.register_worker(address, w.uri)
        return w

    # -- the disaggregated shape ---------------------------------------

    def _stateless_node(self, address: str,
                        budget_bytes: int | None = None
                        ) -> ComputeNode:
        if self.blob is None:
            raise RuntimeError(
                "stateless workers need a blob tier (configure "
                "[blob] backend or pass blob=)")
        d = os.path.join(self._storage_dir, "workers", address)
        w = ComputeNode(
            address,
            WriteLogger(os.path.join(d, "writelog")),
            Snapshotter(os.path.join(d, "snapshots")),
            blob=self.blob, lazy=True, budget_bytes=budget_bytes,
            device=self.device, config=self.config).open()
        self.workers.append(w)
        return w

    def add_blob_worker(self, address: str,
                        budget_bytes: int | None = None
                        ) -> ComputeNode:
        """A stateless worker: boots with an EMPTY private data dir
        and hydrates assigned shards from blob manifests on first
        touch, paged through its own device-budget ledger."""
        w = self._stateless_node(address, budget_bytes)
        self.controller.register_worker(address, w.uri)
        return w

    def add_standby(self, address: str,
                    budget_bytes: int | None = None) -> ComputeNode:
        """A warm spare the autoscaler can admit: boots, health-
        checks, holds nothing until a scale-out."""
        w = self._stateless_node(address, budget_bytes)
        self.controller.register_standby(address, w.uri)
        return w

    def start_autoscaler(self, interval: float | None = None):
        self.controller.start_reconciler(interval)
        return self

    def kill_worker(self, address: str):
        """Fault injection: stop the worker WITHOUT deregistering —
        the poller must notice (poller/poller.go behavior)."""
        for w in self.workers:
            if w.address == address:
                w.close()

    def close(self):
        front = getattr(self, "queryer_front", None)
        if front is not None:
            try:
                front.close()
            except Exception:
                pass
            self.queryer_front = None
        self.controller.stop_reconciler()
        self.controller.stop_poller()
        for w in self.workers:
            try:
                w.close()
            except Exception:
                pass
