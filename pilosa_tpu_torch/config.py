"""Layered configuration: defaults < TOML file < env < flags.

Reference: server/config.go — one Config struct filled from a TOML
file, PILOSA_* environment variables and cobra flags, in that order of
precedence; ``generate-config`` prints the default file.  The env
prefix is ``PILOSA_TPU_``, and nested TOML tables flatten with ``_``
(``[auth] secret`` -> ``PILOSA_TPU_AUTH_SECRET``).  The same file, env
and flags give the JAX package's Config field for field.

``load`` is where the port reads ``PILOSA_TPU_*``: its modules read no
environment switch, and each ``apply_*`` method hands the loaded
values to the module's ``configure()`` call instead.  Knobs of planes
the port does not have (``[stacked] patch = false``, the kernel switch)
are parsed into the same fields; their ``apply_*`` raises
``ConfigError`` when one is set away from its default.
"""

from __future__ import annotations

import os
import tomllib
from dataclasses import dataclass, fields


@dataclass
class Config:
    data_dir: str = ""
    bind: str = "127.0.0.1"
    port: int = 10101
    grpc_port: int = 20101       # -1 turns gRPC off
    cluster_name: str = "cluster0"
    replicas: int = 1
    auth_secret: str = ""
    auth_policy: str = ""
    tpu_kernels: str = "auto"    # auto | on; off raises
    # queries slower than this many seconds go to the long-query log;
    # 0 turns it off (server.go:201 OptServerLongQueryTime)
    long_query_time: float = 0.0
    # serving (executor/serving.py): the micro-batcher, the result
    # cache, the ragged page-table dispatch and admission classes
    serving_batching: bool = True
    serving_batch_window_ms: float = 1.0
    serving_batch_max: int = 32
    serving_cache_mb: int = 64
    serving_ragged: bool = True
    serving_admission: bool = True
    serving_heavy_slots: int = 2
    serving_queue_max: int = 128
    serving_tenant_weights: str = ""
    serving_default_deadline_ms: float = 0.0
    # stack maintenance (executor/stacked.py patching, the fragment
    # delta log, memory/encode.py's sparse page format)
    stack_patch: bool = True
    stack_delta_log_max: int = 256
    stack_patch_max_frac: float = 0.5
    stack_sparse_format: bool = True
    stack_sparse_dense_frac: float = 0.5
    # the residency manager (pilosa_tpu_torch/memory); budget-bytes 0
    # detects the card's memory less headroom-frac
    memory_budget_bytes: int = 0
    memory_headroom_frac: float = 0.1
    memory_page_bytes: int = 4 << 20
    memory_paged: bool = True
    memory_prefetch: bool = True
    memory_prefetch_interval_s: float = 0.5
    memory_oom_retry: bool = True
    memory_host_fallback: bool = True
    # the streaming write plane (ingest/stream.py): windows coalesce
    # concurrent writes and ack after the land; queue and tenant-queue
    # bound the backlog (a shed is a typed 503); sync=false acks after
    # the apply, without the storage sync
    ingest_stream: bool = True
    ingest_window_ms: float = 2.0
    ingest_max_batch: int = 4096
    ingest_queue: int = 8192
    ingest_tenant_queue: int = 4096
    ingest_sync: bool = True
    # fault points armed at start ("point[@match][,times=N][,delay=MS]"
    # joined by ";", obs/faults.py); the hedge, deadline and rebalance
    # knobs are the multi-node plane's
    fault_spec: str = ""
    cluster_hedge_ms: float = 0.0
    cluster_deadline_s: float = 0.0
    cluster_mesh_devices: int = 0
    cluster_placement_pin: str = ""
    cluster_rebalance_chase_lag: int = 8
    cluster_rebalance_max_rounds: int = 12
    cluster_rebalance_fence_timeout_s: float = 10.0
    # the query flight recorder (obs/flight.py)
    flight_recorder: bool = True
    flight_ring: int = 512
    # roofline attribution (obs/roofline.py); peak-gbps 0 takes the
    # card's published HBM rate
    roofline_attribution: bool = True
    roofline_peak_gbps: float = 0.0
    # the statistics catalog (obs/stats.py), memory-only in the port
    stats_enabled: bool = True
    stats_persist: bool = True
    stats_snapshot_interval_s: float = 60.0
    stats_heavy_cost_ms: float = 5.0
    stats_regression_ratio: float = 3.0
    stats_regression_min_samples: int = 6
    # SQL SELECT operators through the serving plane (sql/costplan.py)
    sql_pushdown: bool = True
    # incident bundles (obs/incidents.py), the continuous profiler and
    # the log ring
    incidents_enabled: bool = True
    incidents_dir: str = ""
    incidents_min_interval_s: float = 60.0
    incidents_max_bundles: int = 32
    incidents_max_bundle_bytes: int = 1 << 20
    incidents_slo_burn_threshold: float = 8.0
    incidents_profile: bool = True
    incidents_profile_hz: float = 7.0
    incidents_profile_window_s: float = 10.0
    incidents_profile_windows: int = 6
    incidents_log_ring: int = 512
    # stall watchdogs (obs/watchdog.py)
    watchdog_enabled: bool = True
    watchdog_interval_s: float = 1.0
    watchdog_deadline_s: float = 10.0
    # SLO burn rates (obs/slo.py): latency-objective of the queries
    # answer under latency-ms; availability-objective bounds the typed
    # errors; windows "5m,1h,6h" or bare seconds
    slo_latency_ms: float = 250.0
    slo_latency_objective: float = 0.99
    slo_availability_objective: float = 0.999
    slo_windows: str = "5m,1h,6h"
    # time views (models/timeq.py)
    timeq_write_finest: bool = False
    timeq_rollup: bool = False
    timeq_qcover: bool = True
    # standing queries (executor/standing.py)
    standing_enabled: bool = True
    standing_max: int = 256
    # correctness auditing (obs/audit.py)
    audit_enabled: bool = True
    audit_sample_rate: float = 0.01
    audit_route_rates: str = ""
    audit_queue_max: int = 64
    audit_concurrency: int = 1
    audit_scrub_cache_n: int = 4
    audit_scrub_standing_n: int = 2
    audit_scrub_replica_n: int = 2
    audit_quarantine: int = 32
    # the disaggregated tier ([dax] + [blob], dax/settings.py): blob is
    # the tier's kill-switch; backend/root pick the blob store;
    # worker-budget-bytes bounds each stateless worker's resident set
    # (0 = unbounded); the scale-* thresholds drive the autoscaler
    blob_backend: str = ""
    blob_root: str = ""
    dax_blob: bool = True
    dax_lazy_hydrate: bool = True
    dax_worker_budget_bytes: int = 0
    dax_prefetch: int = 2
    dax_scale_out_burn: float = 2.0
    dax_scale_in_burn: float = 0.5
    dax_pressure_high: float = 0.9
    dax_min_workers: int = 1
    dax_max_workers: int = 8
    dax_standby: int = 1
    dax_reconcile_interval_s: float = 5.0
    dax_cooldown_s: float = 30.0
    dax_chase_lag: int = 8
    dax_chase_rounds: int = 12

    # -- apply: push the knobs into the port's configure() calls ---------

    def _refuse(self, plane: str) -> None:
        """Raise ConfigError when a knob of a plane the port does not
        have (``_UNPORTED[plane]``) is set away from its default: the
        knob would do nothing, and a config must not claim what the
        node does not run."""
        section, names = _UNPORTED[plane]
        bad = [n for n in names if getattr(self, n) != _DEFAULTS[n]]
        if bad:
            raise ConfigError(
                f"[{section}] {', '.join(bad)}: not supported by "
                f"pilosa_tpu_torch (the plane is not ported); leave "
                f"{'it' if len(bad) == 1 else 'them'} at the default")

    def check_supported(self):
        """Raise ConfigError for every knob the port cannot honour (the
        ones the apply_* methods below refuse), before anything
        starts."""
        self.apply_kernel_setting()
        for plane in _UNPORTED:
            self._refuse(plane)

    def apply_kernel_setting(self):
        """[tpu] kernels: the port always launches its hand-written
        CUDA kernels on a CUDA tensor (a CPU executor runs their plain
        versions), so "auto" and "on" both mean that, and "off", a
        kernel switch the port does not have, raises."""
        if self.tpu_kernels not in ("auto", "on"):
            raise ConfigError(
                f"[tpu] kernels = {self.tpu_kernels!r}: pilosa_tpu_torch "
                f"has no kernel switch; use \"auto\" or \"on\"")

    def apply_stack_settings(self):
        """[stacked]: the delta-log bound, the patch-or-rebuild
        fraction and the sparse page format.  The port always patches
        resident stacks, so ``patch = false`` raises."""
        self._refuse("stacked")
        from pilosa_tpu_torch.executor import stacked
        from pilosa_tpu_torch.memory import encode
        from pilosa_tpu_torch.models import fragment
        fragment.DELTA_LOG_MAX = int(self.stack_delta_log_max)
        stacked._PATCH_MAX_FRAC = float(self.stack_patch_max_frac)
        encode.configure(enabled=self.stack_sparse_format,
                         dense_frac=self.stack_sparse_dense_frac)

    def apply_flight_settings(self):
        """Configure the process-global flight recorder ([flight])."""
        from pilosa_tpu_torch.obs import flight
        flight.recorder.configure(enabled=self.flight_recorder,
                                  keep=self.flight_ring)

    def apply_fault_settings(self):
        """Arm the config's fault points ([faults] spec) and hand the
        [cluster] hedge, deadline and rebalance knobs to the cluster
        plane's configure() calls (read per fan-out and per rebalance,
        so a reconfigure applies live).  Test-armed faults
        (faults.inject) are never touched."""
        from pilosa_tpu_torch.cluster import coordinator, rebalance
        from pilosa_tpu_torch.obs import faults
        # load() folds PILOSA_TPU_FAULT_SPEC into fault_spec: drop the
        # import-time arming before arming it again as config, or each
        # rule's budget doubles
        if self.fault_spec:
            faults.clear(source="env")
        faults.configure(self.fault_spec)
        coordinator.configure(hedge_ms=self.cluster_hedge_ms,
                              deadline_s=self.cluster_deadline_s)
        rebalance.configure(
            chase_lag=self.cluster_rebalance_chase_lag,
            max_rounds=self.cluster_rebalance_max_rounds,
            fence_timeout_s=self.cluster_rebalance_fence_timeout_s)

    def apply_roofline_settings(self):
        """Configure roofline attribution ([roofline]); without a
        configured peak, the card's published one."""
        from pilosa_tpu_torch.obs import roofline
        roofline.configure(enabled=self.roofline_attribution,
                           peak_gbps=self.roofline_peak_gbps or None)
        if roofline.enabled():
            roofline.resolve_peak()

    def apply_stats_settings(self, data_dir: str | None = None):
        """Configure the statistics catalog ([stats]).  With
        ``persist`` and a data directory (``data_dir``, the holder's
        path, or ``data-dir``) the catalog is kept in
        ``<dir>/stats.jsonl``, saved every ``snapshot-interval-s``;
        without a directory it lives in memory."""
        from pilosa_tpu_torch.obs import stats
        base = data_dir if data_dir is not None else (self.data_dir
                                                      or None)
        path = (os.path.join(base, "stats.jsonl")
                if (self.stats_persist and base) else None)
        stats.configure(
            enabled=self.stats_enabled, path=path,
            heavy_cost_ms=self.stats_heavy_cost_ms,
            regression_ratio=self.stats_regression_ratio,
            regression_min_samples=self.stats_regression_min_samples,
            snapshot_interval_s=self.stats_snapshot_interval_s)

    def apply_sql_settings(self):
        """Configure the SQL serving plane ([sql] pushdown)."""
        from pilosa_tpu_torch.sql import costplan
        costplan.configure(enabled=self.sql_pushdown)

    def apply_watchdog_settings(self):
        """Configure the stall-watchdog monitor ([watchdog])."""
        from pilosa_tpu_torch.obs import watchdog
        watchdog.configure(enabled=self.watchdog_enabled,
                           interval_s=self.watchdog_interval_s,
                           deadline_s=self.watchdog_deadline_s)

    def apply_incident_settings(self, data_dir: str | None = None):
        """Configure the incident forensics plane ([incidents]): the
        bundle manager (kept under ``data_dir``/incidents when there is
        one, in memory otherwise), the continuous profiler, and the log
        ring's size."""
        from pilosa_tpu_torch.obs import incidents, logger, profiler
        base = data_dir if data_dir is not None else (self.data_dir
                                                     or None)
        dir = self.incidents_dir or (
            os.path.join(base, "incidents") if base else None)
        snap = {f.name: getattr(self, f.name)
                for f in fields(Config)
                if "secret" not in f.name}  # bundles must not leak auth
        # dir=None leaves the manager's current dir alone (a path-less
        # embedded server must not detach a sibling's persistence)
        incidents.configure(
            enabled=self.incidents_enabled, dir=dir,
            min_interval_s=self.incidents_min_interval_s,
            max_bundles=self.incidents_max_bundles,
            max_bundle_bytes=self.incidents_max_bundle_bytes,
            slo_burn_threshold=self.incidents_slo_burn_threshold,
            config_snapshot=snap)
        profiler.configure_continuous(
            enabled=self.incidents_enabled and self.incidents_profile,
            hz=self.incidents_profile_hz,
            window_s=self.incidents_profile_window_s,
            keep=self.incidents_profile_windows)
        logger.ring.configure(int(self.incidents_log_ring))

    def apply_slo_settings(self):
        """Build the process SLO tracker from the [slo] knobs."""
        from pilosa_tpu_torch.obs import slo
        slo.configure(
            latency_ms=self.slo_latency_ms,
            latency_objective=self.slo_latency_objective,
            availability_objective=self.slo_availability_objective,
            windows=self.slo_windows)

    def apply_timeq_settings(self):
        """Push the [timeq] knobs into models/timeq.py."""
        from pilosa_tpu_torch.models import timeq
        timeq.configure(write_finest=self.timeq_write_finest,
                        rollup=self.timeq_rollup, qcover=self.timeq_qcover)

    def apply_standing_settings(self):
        """Configure the standing-query registry ([standing])."""
        from pilosa_tpu_torch.executor import standing
        standing.configure(enabled=self.standing_enabled,
                           max_registrations=self.standing_max)

    def apply_audit_settings(self):
        """Configure the correctness-auditing plane ([audit]), the
        replica scrubber's budget a tick among its knobs."""
        from pilosa_tpu_torch.obs import audit
        audit.configure(
            enabled=self.audit_enabled,
            sample_rate=self.audit_sample_rate,
            route_rates=self.audit_route_rates,
            queue_max=self.audit_queue_max,
            concurrency=self.audit_concurrency,
            scrub_cache_n=self.audit_scrub_cache_n,
            scrub_standing_n=self.audit_scrub_standing_n,
            scrub_replica_n=self.audit_scrub_replica_n,
            quarantine=self.audit_quarantine)

    def apply_dax_settings(self):
        """Push the [dax]/[blob] stanzas into dax/settings.py (the
        ``PILOSA_TPU_DAX_*``/``PILOSA_TPU_BLOB_*`` variables reached
        them in ``load``; the settings module reads none)."""
        from pilosa_tpu_torch.dax import settings as dax_settings
        dax_settings.configure(
            blob=self.dax_blob,
            backend=self.blob_backend,
            root=self.blob_root,
            lazy_hydrate=self.dax_lazy_hydrate,
            worker_budget_bytes=self.dax_worker_budget_bytes,
            prefetch=self.dax_prefetch,
            scale_out_burn=self.dax_scale_out_burn,
            scale_in_burn=self.dax_scale_in_burn,
            pressure_high=self.dax_pressure_high,
            min_workers=self.dax_min_workers,
            max_workers=self.dax_max_workers,
            standby=self.dax_standby,
            reconcile_interval_s=self.dax_reconcile_interval_s,
            cooldown_s=self.dax_cooldown_s,
            chase_lag=self.dax_chase_lag,
            chase_rounds=self.dax_chase_rounds)

    def apply_placement_settings(self):
        """[cluster] mesh-devices and placement-pin: the serving mesh's
        width and pins (memory/placement.py; the ``PILOSA_TPU_MESH_
        DEVICES``/``PILOSA_TPU_PLACEMENT_PIN`` twins reached them in
        ``load``).  The slots are the visible cards."""
        from pilosa_tpu_torch.memory import placement
        placement.configure(mesh_devices=self.cluster_mesh_devices,
                            pin=self.cluster_placement_pin)

    def apply_memory_settings(self):
        """Push the [memory] knobs into the residency manager
        (pilosa_tpu_torch/memory: budget ledger, paged stacks, OOM
        ladder)."""
        from pilosa_tpu_torch import memory
        memory.configure(budget_bytes=self.memory_budget_bytes,
                         headroom_frac=self.memory_headroom_frac,
                         page_bytes=self.memory_page_bytes,
                         paged=self.memory_paged,
                         oom_retry=self.memory_oom_retry,
                         host_fallback=self.memory_host_fallback)

    def apply_all(self, data_dir: str | None = None):
        """check_supported, then every apply_* above (Server's one
        call), so that a refused knob leaves every switch as it was."""
        self.check_supported()
        self.apply_stack_settings()
        self.apply_flight_settings()
        self.apply_fault_settings()
        self.apply_memory_settings()
        self.apply_placement_settings()
        self.apply_roofline_settings()
        self.apply_slo_settings()
        self.apply_sql_settings()
        self.apply_timeq_settings()
        self.apply_standing_settings()
        self.apply_stats_settings(data_dir=data_dir)
        self.apply_watchdog_settings()
        self.apply_incident_settings(data_dir=data_dir)
        self.apply_audit_settings()
        self.apply_dax_settings()
        # the node is up: its garbage-collector passes are counted
        from pilosa_tpu_torch.obs import runtime
        runtime.install()


_DEFAULTS = {f.name: f.default for f in fields(Config)}

# plane -> (section, knobs): the knobs of planes the port does not have,
# refused away from their defaults by the apply_* methods
_UNPORTED = {
    "stacked": ("stacked", ("stack_patch",)),
}


class ConfigError(ValueError):
    """A config value the port cannot honour."""


# TOML key (possibly [table] key) -> Config attribute
_TOML_KEYS = {
    "data-dir": "data_dir",
    "bind": "bind",
    "port": "port",
    "grpc-port": "grpc_port",
    "cluster.name": "cluster_name",
    "cluster.replicas": "replicas",
    "auth.secret": "auth_secret",
    "auth.policy": "auth_policy",
    "tpu.kernels": "tpu_kernels",
    "long-query-time": "long_query_time",
    "serving.batching": "serving_batching",
    "serving.batch-window-ms": "serving_batch_window_ms",
    "serving.batch-max": "serving_batch_max",
    "serving.cache-mb": "serving_cache_mb",
    "serving.ragged": "serving_ragged",
    "serving.admission": "serving_admission",
    "serving.heavy-slots": "serving_heavy_slots",
    "serving.queue-max": "serving_queue_max",
    "serving.tenant-weights": "serving_tenant_weights",
    "serving.default-deadline-ms": "serving_default_deadline_ms",
    "stacked.patch": "stack_patch",
    "stacked.delta-log-max": "stack_delta_log_max",
    "stacked.patch-max-frac": "stack_patch_max_frac",
    "stacked.sparse-format": "stack_sparse_format",
    "stacked.sparse-dense-frac": "stack_sparse_dense_frac",
    "flight.recorder": "flight_recorder",
    "flight.ring": "flight_ring",
    "roofline.attribution": "roofline_attribution",
    "roofline.peak-gbps": "roofline_peak_gbps",
    "stats.enabled": "stats_enabled",
    "stats.persist": "stats_persist",
    "stats.snapshot-interval-s": "stats_snapshot_interval_s",
    "stats.heavy-cost-ms": "stats_heavy_cost_ms",
    "stats.regression-ratio": "stats_regression_ratio",
    "stats.regression-min-samples": "stats_regression_min_samples",
    "sql.pushdown": "sql_pushdown",
    "incidents.enabled": "incidents_enabled",
    "incidents.dir": "incidents_dir",
    "incidents.min-interval-s": "incidents_min_interval_s",
    "incidents.max-bundles": "incidents_max_bundles",
    "incidents.max-bundle-bytes": "incidents_max_bundle_bytes",
    "incidents.slo-burn-threshold": "incidents_slo_burn_threshold",
    "incidents.profile": "incidents_profile",
    "incidents.profile-hz": "incidents_profile_hz",
    "incidents.profile-window-s": "incidents_profile_window_s",
    "incidents.profile-windows": "incidents_profile_windows",
    "incidents.log-ring": "incidents_log_ring",
    "watchdog.enabled": "watchdog_enabled",
    "watchdog.interval-s": "watchdog_interval_s",
    "watchdog.deadline-s": "watchdog_deadline_s",
    "slo.latency-ms": "slo_latency_ms",
    "slo.latency-objective": "slo_latency_objective",
    "slo.availability-objective": "slo_availability_objective",
    "slo.windows": "slo_windows",
    "ingest.stream": "ingest_stream",
    "ingest.window-ms": "ingest_window_ms",
    "ingest.max-batch": "ingest_max_batch",
    "ingest.queue": "ingest_queue",
    "ingest.tenant-queue": "ingest_tenant_queue",
    "ingest.sync": "ingest_sync",
    "faults.spec": "fault_spec",
    "cluster.mesh-devices": "cluster_mesh_devices",
    "cluster.placement-pin": "cluster_placement_pin",
    "cluster.hedge-ms": "cluster_hedge_ms",
    "cluster.deadline-s": "cluster_deadline_s",
    "cluster.rebalance-chase-lag": "cluster_rebalance_chase_lag",
    "cluster.rebalance-max-rounds": "cluster_rebalance_max_rounds",
    "cluster.rebalance-fence-timeout-s":
        "cluster_rebalance_fence_timeout_s",
    "memory.budget-bytes": "memory_budget_bytes",
    "memory.headroom-frac": "memory_headroom_frac",
    "memory.page-bytes": "memory_page_bytes",
    "memory.paged": "memory_paged",
    "memory.prefetch": "memory_prefetch",
    "memory.prefetch-interval-s": "memory_prefetch_interval_s",
    "memory.oom-retry": "memory_oom_retry",
    "memory.host-fallback": "memory_host_fallback",
    "timeq.write-finest": "timeq_write_finest",
    "timeq.rollup": "timeq_rollup",
    "timeq.qcover": "timeq_qcover",
    "standing.enabled": "standing_enabled",
    "standing.max": "standing_max",
    "audit.enabled": "audit_enabled",
    "audit.sample-rate": "audit_sample_rate",
    "audit.route-rates": "audit_route_rates",
    "audit.queue-max": "audit_queue_max",
    "audit.concurrency": "audit_concurrency",
    "audit.scrub-cache-n": "audit_scrub_cache_n",
    "audit.scrub-standing-n": "audit_scrub_standing_n",
    "audit.scrub-replica-n": "audit_scrub_replica_n",
    "audit.quarantine": "audit_quarantine",
    "blob.backend": "blob_backend",
    "blob.root": "blob_root",
    "dax.blob": "dax_blob",
    "dax.lazy-hydrate": "dax_lazy_hydrate",
    "dax.worker-budget-bytes": "dax_worker_budget_bytes",
    "dax.prefetch": "dax_prefetch",
    "dax.scale-out-burn": "dax_scale_out_burn",
    "dax.scale-in-burn": "dax_scale_in_burn",
    "dax.pressure-high": "dax_pressure_high",
    "dax.min-workers": "dax_min_workers",
    "dax.max-workers": "dax_max_workers",
    "dax.standby": "dax_standby",
    "dax.reconcile-interval-s": "dax_reconcile_interval_s",
    "dax.cooldown-s": "dax_cooldown_s",
    "dax.chase-lag": "dax_chase_lag",
    "dax.chase-rounds": "dax_chase_rounds",
}

ENV_PREFIX = "PILOSA_TPU_"


def _flatten(doc: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in doc.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flatten(v, key + "."))
        else:
            out[key] = v
    return out


_PLACEMENT_TWINS = {"MESH_DEVICES": "cluster_mesh_devices",
                    "PLACEMENT_PIN": "cluster_placement_pin"}


def load(path: str | None = None, env: dict | None = None,
         overrides: dict | None = None) -> Config:
    """Build a Config with flag > env > file > default precedence
    (server/config.go's viper layering)."""
    cfg = Config()
    names = {f.name for f in fields(Config)}
    if path:
        with open(path, "rb") as f:
            doc = tomllib.load(f)
        flat = _flatten(doc)
        for tk, attr in _TOML_KEYS.items():
            if tk in flat:
                setattr(cfg, attr, _coerce(cfg, attr, flat[tk]))
    env = os.environ if env is None else env
    for attr in names:
        ev = env.get(ENV_PREFIX + attr.upper())
        if ev is not None:
            setattr(cfg, attr, _coerce(cfg, attr, ev))
    # the JAX placement module's own twins, which outrank the config
    # there (memory/placement.py reads them on every call); here they
    # are read once, into the same fields
    for name, attr in _PLACEMENT_TWINS.items():
        ev = env.get(ENV_PREFIX + name)
        if ev is not None:
            setattr(cfg, attr, _coerce(cfg, attr, ev))
    for k, v in (overrides or {}).items():
        if v is not None and k in names:
            setattr(cfg, k, _coerce(cfg, k, v))
    return cfg


def _coerce(cfg: Config, attr: str, value):
    cur = getattr(cfg, attr)
    if isinstance(cur, bool):
        return str(value).lower() in ("1", "true", "yes", "on")
    if isinstance(cur, int):
        return int(value)
    if isinstance(cur, float):
        return float(value)
    return str(value)
