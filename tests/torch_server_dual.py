"""Start the JAX package's server and the port's side by side.

``dual_servers`` starts one node of each package over holders that
``build_holder`` fills by the same seeded calls, with configs from
``config.load(None, env={})`` in each package, and the port on the CPU
(``device="cpu"``).  ``call`` sends one request to a node and returns
(status, headers, body): the body parsed as JSON when the answer says so,
else the raw bytes.  ``strip`` drops the fields a parity test leaves out
(times, trace ids, versions), by name, at any depth.

``restore_globals`` puts back what a server changes process-wide: the
environment (the JAX ``config.apply_*`` write ``os.environ``), and in
both packages the module switches their ``configure()`` calls set and
the threads they start (watchdog, continuous profiler, incident
manager, fault rules, SLO tracker), and the statistics catalog's store,
so a later test file in the same worker sees the defaults.
"""

from __future__ import annotations

import contextlib
import http.client
import json
import os

import numpy as np
import torch

from pilosa_tpu import config as jax_config
from pilosa_tpu.models.holder import Holder as JaxHolder
from pilosa_tpu.server.http import Server as JaxServer
from pilosa_tpu_torch import config as port_config
from pilosa_tpu_torch.models.holder import Holder
from pilosa_tpu_torch.server.http import Server

torch.set_num_threads(1)

W = 2048
N_SHARDS = 4


def build_holder(pkg: str, seed: int = 7, path: str | None = None):
    """One package's holder ("jax" or "port"), built by the same seeded
    calls in each.  Index ``i``: set fields a (rows 0-3) and s (rows
    0-7), a mutex m, an INT age (0-120) and a DECIMAL(2) price, over
    N_SHARDS shards; index ``k``: string column keys and a keyed set
    field ``tag``."""
    if pkg == "jax":
        from pilosa_tpu.models.schema import FieldOptions, FieldType
        cls = JaxHolder
    else:
        from pilosa_tpu_torch.models.schema import FieldOptions, FieldType
        cls = Holder
    rng = np.random.default_rng(seed)
    h = cls(path=path, width=W) if path else cls(width=W)
    if path:
        h.load_schema()
    idx = h.create_index("i")
    a = idx.create_field("a")
    s = idx.create_field("s")
    m = idx.create_field("m", FieldOptions(type=FieldType.MUTEX))
    age = idx.create_field("age", FieldOptions(type=FieldType.INT, min=0,
                                               max=120))
    price = idx.create_field("price", FieldOptions(
        type=FieldType.DECIMAL, scale=2, min=0, max=100000))
    n = 96 * N_SHARDS
    cols = np.unique(rng.integers(0, W * N_SHARDS, size=n))
    a.import_bits(rng.integers(0, 4, size=cols.size), cols)
    s.import_bits(rng.integers(0, 8, size=n),
                  rng.integers(0, W * N_SHARDS, size=n))
    m.import_bits(rng.integers(0, 5, size=cols.size), cols)
    age.import_values(cols, rng.integers(0, 121, size=cols.size))
    price.import_values(cols[::3],
                        rng.integers(0, 100000, size=cols[::3].size))
    idx.mark_columns_exist(cols)
    k = h.create_index("k", keys=True)
    tag = k.create_field("tag", FieldOptions(keys=True))
    keys = [f"u{i}" for i in range(40)]
    cmap = k.column_translator.create_keys(*keys)
    tmap = tag.row_translator.create_keys("red", "green", "blue")
    tags = ["red", "green", "blue"]
    tag.import_bits([tmap[tags[i % 3]] for i in range(40)],
                    [cmap[x] for x in keys])
    k.mark_columns_exist([cmap[x] for x in keys])
    if path:
        h.save_schema()
        h.sync()
    return h


def configs(**overrides):
    """(JAX Config, port Config) from no file and no environment, with
    the same overrides."""
    return (jax_config.load(None, env={}, overrides=overrides),
            port_config.load(None, env={}, overrides=overrides))


# the port's module switches that its configure() calls set, by module
_PORT_SWITCHES = {
    "pilosa_tpu_torch.memory": ("_paged_default", "_page_bytes_default"),
    "pilosa_tpu_torch.memory.encode": ("_ENABLED", "_DENSE_FRAC"),
    "pilosa_tpu_torch.memory.placement": ("_configured", "_pins", "_devices",
                                          "_epoch"),
    "pilosa_tpu_torch.memory.pressure": ("OOM_RETRY", "HOST_FALLBACK"),
    "pilosa_tpu_torch.models.fragment": ("DELTA_LOG_MAX",),
    "pilosa_tpu_torch.executor.stacked": ("_PATCH_MAX_FRAC",),
    "pilosa_tpu_torch.obs.roofline": ("_enabled", "_peak_bytes_per_s"),
    "pilosa_tpu_torch.obs.stats": ("_enabled",),
    "pilosa_tpu_torch.sql.costplan": ("_enabled",),
    "pilosa_tpu_torch.obs.watchdog": ("_enabled", "_interval_s",
                                      "_default_deadline_s"),
    "pilosa_tpu_torch.obs.incidents": ("_enabled",),
    "pilosa_tpu_torch.models.timeq": ("_WRITE_FINEST", "_ROLLUP", "_QCOVER"),
    "pilosa_tpu_torch.executor.standing": ("_ENABLED", "_MAX"),
    "pilosa_tpu_torch.obs.audit": (
        "_ENABLED", "_SAMPLE_RATE", "_ROUTE_RATES", "_QUEUE_MAX",
        "_CONCURRENCY", "_SCRUB_CACHE_N", "_SCRUB_STANDING_N",
        "_SCRUB_REPLICA_N", "_QUARANTINE"),
    "pilosa_tpu_torch.obs.slo": ("tracker",),
    "pilosa_tpu_torch.cluster.coordinator": ("_HEDGE_MS", "_DEADLINE_S",
                                             "_HEDGE_CACHE"),
    "pilosa_tpu_torch.cluster.rebalance": ("_CHASE_LAG", "_MAX_ROUNDS",
                                           "_FENCE_TIMEOUT_S"),
    "pilosa_tpu_torch.dax.settings": (
        "_blob", "_backend", "_root", "_lazy_hydrate",
        "_worker_budget_bytes", "_prefetch", "_scale_out_burn",
        "_scale_in_burn", "_pressure_high", "_min_workers", "_max_workers",
        "_standby", "_reconcile_interval_s", "_cooldown_s", "_chase_lag",
        "_chase_rounds"),
}
_STATS_KNOBS = ("heavy_cost_ms", "regression_ratio", "regression_min_samples",
                "snapshot_interval_s")
_INCIDENT_KNOBS = ("dir", "min_interval_s", "max_bundles", "max_bundle_bytes",
                   "slo_burn_threshold", "config_snapshot")


@contextlib.contextmanager
def restore_globals():
    """Put back, on exit, the environment and every process-wide switch
    the servers' config may set, and stop the threads it may start."""
    import importlib

    from pilosa_tpu.obs import faults as jax_faults
    from pilosa_tpu.obs import profiler as jax_profiler
    from pilosa_tpu.obs import slo as jax_slo
    from pilosa_tpu_torch import memory
    from pilosa_tpu_torch.obs import faults, flight, incidents, logger, \
        profiler, stats, watchdog
    env = dict(os.environ)
    mods = {name: importlib.import_module(name) for name in _PORT_SWITCHES}
    saved = {name: {a: getattr(mods[name], a) for a in attrs}
             for name, attrs in _PORT_SWITCHES.items()}
    led = memory.ledger()
    led_saved = (led._explicit, led.headroom_frac)
    rec_saved = (flight.recorder.enabled, flight.recorder._ring.maxlen)
    cat = stats.get()
    cat_saved = {k: getattr(cat, k) for k in _STATS_KNOBS}
    store_saved = (cat.store, cat.store_path)
    mgr = incidents.get()
    mgr_saved = {k: getattr(mgr, k) for k in _INCIDENT_KNOBS}
    ring_saved = logger.ring._ring.maxlen
    jax_tracker = jax_slo.tracker
    try:
        yield
    finally:
        os.environ.clear()
        os.environ.update(env)
        for name, attrs in saved.items():
            for a, v in attrs.items():
                setattr(mods[name], a, v)
        led.set_budget(led_saved[0])
        led.headroom_frac = led_saved[1]
        flight.recorder.configure(enabled=rec_saved[0], keep=rec_saved[1])
        for k, v in cat_saved.items():
            setattr(cat, k, v)
        # a store a server under test opened (persist under its data
        # directory) is closed, and the catalog's own put back
        if cat.store is not store_saved[0]:
            if cat.store is not None:
                cat.store.close()
            cat.store, cat.store_path = store_saved
        for k, v in mgr_saved.items():
            setattr(mgr, k, v)
        logger.ring.configure(ring_saved)
        faults.clear(source="config")
        profiler.configure_continuous(enabled=False)
        watchdog.stop()
        mgr.stop()
        jax_faults.clear(source="config")
        jax_profiler.configure_continuous(enabled=False)
        jax_slo.tracker = jax_tracker


@contextlib.contextmanager
def dual_servers(jh: JaxHolder, ph: Holder, auth=None, port_auth=None,
                 **overrides):
    """(JAX server, port server) started on port 0 over the holders."""
    jcfg, pcfg = configs(**overrides)
    with restore_globals():
        js = JaxServer(holder=jh, port=0, auth=auth, config=jcfg).start()
        try:
            ps = Server(holder=ph, port=0, auth=port_auth, config=pcfg,
                        device="cpu").start()
            try:
                yield js, ps
            finally:
                ps.close()
        finally:
            js.close()


def call(srv, method: str, path: str, body=None, headers=None,
         raw: bytes | None = None, timeout: float = 60.0):
    """One request: (status, headers, parsed JSON or raw bytes)."""
    conn = http.client.HTTPConnection("127.0.0.1", srv.port,
                                      timeout=timeout)
    try:
        hdrs = dict(headers or {})
        data = raw
        if data is None and body is not None:
            data = (body.encode() if isinstance(body, str)
                    else json.dumps(body).encode())
        conn.request(method, path, body=data, headers=hdrs)
        resp = conn.getresponse()
        payload = resp.read()
        out = payload
        if resp.getheader("Content-Type", "").startswith(
                "application/json"):
            out = json.loads(payload)
        return resp.status, dict(resp.getheaders()), out
    finally:
        conn.close()


def strip(v, drop: frozenset):
    """v without the keys named in ``drop``, at any depth."""
    if isinstance(v, dict):
        return {k: strip(x, drop) for k, x in v.items() if k not in drop}
    if isinstance(v, list):
        return [strip(x, drop) for x in v]
    return v
