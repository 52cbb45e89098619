"""The port's config.py against the JAX package's.

The same TOML file, environment and overrides give equal ``Config``
fields in both packages, and ``generate-config`` prints the same text.
Each ``apply_*`` of the port reaches the port's ``configure()`` calls
(read back through the modules' getters) and writes no environment
variable.  The knobs of planes the port does not have (the mesh knobs
of [cluster], ``[stacked] patch = false``) and ``[tpu] kernels = "off"``
raise ``ConfigError``; the cluster plane's knobs ([cluster] hedge,
deadline and rebalance, ``[stats] persist`` and ``snapshot-interval-s``,
``[audit] scrub-replica-n``) reach its ``configure()`` calls, and the
[dax] and [blob] stanzas reach ``dax.settings`` as the JAX Config's
reach the JAX package's."""

import dataclasses
import importlib
import io
import os
from contextlib import redirect_stdout

import pytest

from pilosa_tpu import config as jax_config
from pilosa_tpu_torch import config
from torch_server_dual import restore_globals

# the modules (the JAX package's cli/__init__ binds the name ``main`` to
# the function)
jax_cli = importlib.import_module("pilosa_tpu.cli.main")
cli = importlib.import_module("pilosa_tpu_torch.cli.main")

TOML = """\
data-dir = "/tmp/px"
bind = "0.0.0.0"
port = 10199
grpc-port = -1
long-query-time = 0.25

[cluster]
name = "c9"
replicas = 2

[auth]
secret = "s"
policy = "/tmp/policy.yaml"

[tpu]
kernels = "on"

[serving]
batching = false
batch-window-ms = 3.5
cache-mb = 7
ragged = false
tenant-weights = "a:2,b:1"

[stacked]
delta-log-max = 64
patch-max-frac = 0.25
sparse-format = false
sparse-dense-frac = 0.3

[memory]
budget-bytes = 123456789
headroom-frac = 0.2
page-bytes = 1048576
paged = false
prefetch = false
oom-retry = false
host-fallback = false

[ingest]
stream = false
window-ms = 5.0
max-batch = 100
queue = 50
tenant-queue = 10
sync = false

[faults]
spec = "rpc-delay@10101,delay=5,times=2"

[flight]
recorder = false
ring = 64

[roofline]
attribution = false
peak-gbps = 1234.5

[stats]
enabled = false
persist = false
heavy-cost-ms = 9.5
regression-ratio = 4.0
regression-min-samples = 3

[sql]
pushdown = false

[incidents]
enabled = false
min-interval-s = 5.0
max-bundles = 3
slo-burn-threshold = 2.5
profile = false
log-ring = 99

[watchdog]
enabled = false
interval-s = 0.5
deadline-s = 3.0

[slo]
latency-ms = 50.0
latency-objective = 0.95
availability-objective = 0.99
windows = "30s,5m"

[timeq]
write-finest = true
rollup = true
qcover = false

[standing]
enabled = false
max = 7

[audit]
enabled = false
sample-rate = 0.5
route-rates = "cached=0.1"
queue-max = 8
concurrency = 2
scrub-cache-n = 1
scrub-standing-n = 0
quarantine = 4
"""

ENVS = [
    {},
    {"PILOSA_TPU_PORT": "10200", "PILOSA_TPU_SERVING_CACHE_MB": "0",
     "PILOSA_TPU_INGEST_SYNC": "false", "PILOSA_TPU_SLO_WINDOWS": "1m",
     "PILOSA_TPU_AUDIT_SAMPLE_RATE": "0.25", "PILOSA_TPU_DATA_DIR": "/x"},
    {"PILOSA_TPU_MEMORY_PAGED": "0", "PILOSA_TPU_TPU_KERNELS": "auto",
     "PILOSA_TPU_NOT_A_FIELD": "1"},
]
OVERRIDES = [{}, {"port": 1, "data_dir": None, "grpc_port": 5},
             {"auth_secret": "o", "long_query_time": "1.5"}]


@pytest.fixture
def toml_path(tmp_path):
    p = tmp_path / "c.toml"
    p.write_text(TOML)
    return str(p)


@pytest.mark.parametrize("overrides", OVERRIDES)
@pytest.mark.parametrize("env", ENVS)
@pytest.mark.parametrize("with_file", [False, True])
def test_load_matches_jax(toml_path, with_file, env, overrides):
    path = toml_path if with_file else None
    j = jax_config.load(path, env=env, overrides=overrides)
    p = config.load(path, env=env, overrides=overrides)
    assert dataclasses.asdict(p) == dataclasses.asdict(j)


def test_fields_and_toml_keys_match_jax():
    assert ({f.name: f.default for f in dataclasses.fields(config.Config)}
            == {f.name: f.default
                for f in dataclasses.fields(jax_config.Config)})
    assert config._TOML_KEYS == jax_config._TOML_KEYS
    assert config.ENV_PREFIX == jax_config.ENV_PREFIX


def test_generate_config_matches_jax():
    outs = []
    for mod in (jax_cli, cli):
        buf = io.StringIO()
        with redirect_stdout(buf):
            assert mod.main(["generate-config"]) == 0
        outs.append(buf.getvalue())
    assert outs[1] == outs[0] == jax_cli.DEFAULT_CONFIG


def test_generated_config_loads_equal(tmp_path):
    p = tmp_path / "default.toml"
    p.write_text(cli.DEFAULT_CONFIG)
    j = jax_config.load(str(p), env={})
    c = config.load(str(p), env={})
    assert dataclasses.asdict(c) == dataclasses.asdict(j)
    c.check_supported()  # the default file asks for nothing unported


def _state():
    """The port's switches as its modules report them."""
    from pilosa_tpu_torch import memory
    from pilosa_tpu_torch.executor import stacked, standing
    from pilosa_tpu_torch.memory import encode, pressure
    from pilosa_tpu_torch.models import fragment, timeq
    from pilosa_tpu_torch.obs import (audit, faults, flight, incidents,
                                      logger, profiler, roofline, slo, stats,
                                      watchdog)
    from pilosa_tpu_torch.dax import settings as dax_settings
    from pilosa_tpu_torch.sql import costplan
    inc = incidents.get()
    t = slo.get()
    return {
        "paged": memory.paged_enabled(), "page_bytes": memory.page_bytes(),
        "budget": memory.ledger().budget(),
        "headroom": memory.ledger().headroom_frac,
        "oom_retry": pressure.OOM_RETRY,
        "host_fallback": pressure.HOST_FALLBACK,
        "sparse": encode.enabled(), "dense_frac": encode._DENSE_FRAC,
        "delta_log_max": fragment.DELTA_LOG_MAX,
        "patch_max_frac": stacked._PATCH_MAX_FRAC,
        "flight": flight.recorder.enabled,
        "flight_ring": flight.recorder._ring.maxlen,
        "faults": sorted(r["point"] for r in faults.active()),
        "roofline": roofline.enabled(), "peak": roofline.peak_or_none(),
        "stats": stats.enabled(), "heavy_ms": stats.get().heavy_cost_ms,
        "regression": stats.get().regression_ratio,
        "pushdown": costplan.enabled(),
        "watchdog": watchdog.enabled(),
        "watchdog_interval": watchdog._interval_s,
        "incidents": incidents.enabled(),
        "inc_interval": inc.min_interval_s, "inc_bundles": inc.max_bundles,
        "burn_thr": inc.slo_burn_threshold,
        "profiler": profiler.continuous is not None,
        "log_ring": logger.ring._ring.maxlen,
        "slo": (t.latency_ms, t.latency_objective,
                t.availability_objective, t.windows),
        "timeq": (timeq.write_finest(), timeq.rollup_enabled(),
                  timeq.qcover()),
        "standing": (standing.enabled(), standing._MAX),
        "audit": (audit.enabled(), audit._SAMPLE_RATE, audit._QUEUE_MAX,
                  audit._CONCURRENCY, audit._SCRUB_CACHE_N,
                  audit._SCRUB_STANDING_N, audit._QUARANTINE),
        "dax": _dax_state(dax_settings),
    }


def _dax_state(settings) -> tuple:
    """A dax.settings module's accessors, in either package."""
    return (settings.blob_enabled(), settings.backend(), settings.root(),
            settings.lazy_hydrate(), settings.worker_budget_bytes(),
            settings.prefetch(), settings.scale_out_burn(),
            settings.scale_in_burn(), settings.pressure_high(),
            settings.min_workers(), settings.max_workers(),
            settings.standby(), settings.reconcile_interval_s(),
            settings.cooldown_s(), settings.chase_lag(),
            settings.chase_rounds())


def test_apply_reaches_the_port_configure_calls(toml_path, tmp_path):
    # the file sets [stats] persist = false: the catalog opens no store
    cfg = config.load(toml_path, env={})
    env_before = dict(os.environ)
    with restore_globals():
        cfg.apply_all(data_dir=str(tmp_path))
        got = _state()
        assert dict(os.environ) == env_before  # no environment written
    assert got == {
        "paged": False, "page_bytes": 1 << 20, "budget": 123456789,
        "headroom": 0.2, "oom_retry": False, "host_fallback": False,
        "sparse": False, "dense_frac": 0.3, "delta_log_max": 64,
        "patch_max_frac": 0.25, "flight": False, "flight_ring": 64,
        "faults": ["rpc-delay"], "roofline": False, "peak": 1234.5e9,
        "stats": False, "heavy_ms": 9.5, "regression": 4.0,
        "pushdown": False, "watchdog": False, "watchdog_interval": 0.5,
        "incidents": False, "inc_interval": 5.0, "inc_bundles": 3,
        "burn_thr": 2.5, "profiler": False, "log_ring": 99,
        "slo": (50.0, 0.95, 0.99, [("30s", 30.0), ("5m", 300.0)]),
        "timeq": (True, True, False), "standing": (False, 7),
        "audit": (False, 0.5, 8, 2, 1, 0, 4),
        "dax": (True, "", "", True, 0, 2, 2.0, 0.5, 0.9, 1, 8, 1, 5.0,
                30.0, 8, 12),
    }


def test_defaults_apply_to_module_defaults():
    """A default Config leaves every switch at the module's default."""
    with restore_globals():
        base = _state()
        config.Config().apply_all()
        after = _state()
    base.pop("profiler")
    after.pop("profiler")  # the default config starts the profiler
    assert after == base


@pytest.mark.parametrize("key,value", [
    ("tpu_kernels", "off"), ("tpu_kernels", "fast"), ("stack_patch", False),
    ("cluster_hedge_ms", 5.0), ("cluster_deadline_s", 1.0),
    ("cluster_mesh_devices", 2), ("cluster_placement_pin", "i/0=1"),
    ("cluster_rebalance_chase_lag", 3), ("stats_persist", False),
    ("stats_snapshot_interval_s", 5.0),
    ("audit_scrub_replica_n", 0), ("blob_backend", "dir"),
    ("blob_root", "/b"), ("dax_blob", False), ("dax_max_workers", 2),
])
def test_unported_knobs_raise(key, value, tmp_path):
    """The knobs of planes the port does not have raise; those of the
    cluster plane, the DAX tier and the serving mesh, which these cases
    listed before they were ported, apply and land in their configure()
    calls (the test keeps its name and cases)."""
    cfg = config.load(None, env={}, overrides={key: value})
    if key in _DAX_KNOBS:
        from pilosa_tpu_torch.dax import settings
        cfg.check_supported()
        with restore_globals():
            cfg.apply_all()
            got = {"blob_backend": settings.backend(),
                   "blob_root": settings.root(),
                   "dax_blob": settings.blob_enabled(),
                   "dax_max_workers": settings.max_workers()}[key]
        assert got == value
        return
    if key in _CLUSTER_KNOBS:
        from pilosa_tpu_torch.cluster import coordinator, rebalance
        from pilosa_tpu_torch.obs import audit, stats
        cfg.check_supported()
        with restore_globals():
            prev = stats.swap(stats.StatsCatalog())
            try:
                cfg.apply_all(data_dir=str(tmp_path))
                got = {
                    "cluster_hedge_ms": coordinator.settings()["hedge_ms"],
                    "cluster_deadline_s":
                        coordinator.settings()["deadline_s"],
                    "cluster_rebalance_chase_lag":
                        rebalance.settings()["chase_lag"],
                    "stats_persist": stats.get().store is not None,
                    "stats_snapshot_interval_s":
                        stats.get().snapshot_interval_s,
                    "audit_scrub_replica_n": audit._SCRUB_REPLICA_N,
                }[key]
                stats.get().detach_store()
            finally:
                stats.swap(prev)
        assert got == value
        return
    if key in _PLACEMENT_KNOBS:
        from pilosa_tpu_torch.memory import placement
        cfg.check_supported()
        with restore_globals():
            cfg.apply_all()
            got = {"cluster_mesh_devices": placement._configured,
                   "cluster_placement_pin": placement._pins}[key]
        assert got == {"cluster_mesh_devices": 2,
                       "cluster_placement_pin": {("i", 0): 1}}[key]
        return
    with pytest.raises(config.ConfigError, match="kernel switch|not ported"):
        cfg.check_supported()
    with restore_globals(), pytest.raises(config.ConfigError):
        cfg.apply_all()


# the serving mesh's knobs among the cases above: they apply
_PLACEMENT_KNOBS = {"cluster_mesh_devices", "cluster_placement_pin"}

# the DAX tier's knobs among the cases above: they apply
_DAX_KNOBS = {"blob_backend", "blob_root", "dax_blob", "dax_max_workers"}

# the cluster plane's knobs among the cases above: they apply
_CLUSTER_KNOBS = {"cluster_hedge_ms", "cluster_deadline_s",
                  "cluster_rebalance_chase_lag", "stats_persist",
                  "stats_snapshot_interval_s", "audit_scrub_replica_n"}


@pytest.mark.parametrize("kernels", ["auto", "on"])
def test_kernels_auto_and_on_accepted(kernels):
    cfg = config.load(None, env={}, overrides={"tpu_kernels": kernels})
    cfg.check_supported()
    cfg.apply_kernel_setting()


def test_unported_section_from_toml_raises(tmp_path):
    """[dax] and [blob] from a file (refused before the tier was
    ported; the test keeps its name): both packages' Configs load them
    equal, and each one's apply_dax_settings leaves its package's
    dax.settings in the same state."""
    from pilosa_tpu.dax import settings as jax_settings
    from pilosa_tpu_torch.dax import settings
    p = tmp_path / "dax.toml"
    p.write_text('[dax]\nmax-workers = 3\n\n[blob]\nbackend = "mem"\n')
    j = jax_config.load(str(p), env={})
    c = config.load(str(p), env={})
    assert dataclasses.asdict(c) == dataclasses.asdict(j)
    c.check_supported()
    saved = {k: getattr(jax_settings, k) for k in vars(jax_settings)
             if k.startswith("_") and not k.startswith("__")
             and not callable(getattr(jax_settings, k))}
    with restore_globals():
        try:
            for var in [v for v in os.environ
                        if v.startswith(("PILOSA_TPU_DAX_",
                                         "PILOSA_TPU_BLOB_"))]:
                del os.environ[var]  # the JAX accessors read them
            c.apply_all()
            j.apply_dax_settings()
            got, want = _dax_state(settings), _dax_state(jax_settings)
        finally:
            for k, v in saved.items():
                setattr(jax_settings, k, v)
    assert got == want
    assert (got[1], got[10]) == ("mem", 3)
