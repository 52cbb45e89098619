"""pilosa_tpu_torch imports nothing of JAX and nothing of pilosa_tpu,
builds its storage library into build/torch_host/ and never into the
JAX package's native/build/, and runs on the card unless told
otherwise.

The import check runs in a fresh interpreter: this test process has
already imported jax and pilosa_tpu through tests/conftest.py."""

import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]

_CHECK = r"""
import pkgutil, sys
import pilosa_tpu_torch
names = [m.name for m in pkgutil.walk_packages(pilosa_tpu_torch.__path__,
                                               "pilosa_tpu_torch.")]
for n in names:
    __import__(n)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "jaxlib"
             or m == "pilosa_tpu" or m.startswith("pilosa_tpu."))
print(len(names), bad)
assert not bad, bad
for n in ("executor.executor", "api", "ingest.batch", "ingest.importer",
          "ingest.sources", "ingest.pipeline", "storage.rbf",
          "storage.shards", "storage.roaring", "models.dataframe",
          "models.timeq", "obs.metrics", "obs.logger", "obs.tracing",
          "obs.testhook", "obs.faults", "obs.flight", "obs.stats",
          "storage.bufferpool", "storage.extendiblehash", "sql",
          "sql.lexer", "sql.ast", "sql.parser", "sql.common", "sql.funcs",
          "sql.typecheck", "sql.wherec", "sql.costplan", "sql.plan",
          "sql.select_exec", "sql.statements", "sql.engine", "memory",
          "memory.ledger", "memory.pages", "memory.encode", "memory.policy",
          "memory.pressure", "executor.sched", "executor.serving",
          "executor.ragged", "executor.standing", "obs.monitor",
          "obs.diagnostics", "obs.profiler", "obs.incidents",
          "obs.watchdog", "obs.roofline", "obs.audit", "taskpool",
          "cluster", "cluster.txn", "cluster.client", "obs.slo",
          "ingest.stream", "ingest.kafka", "ingest.avro", "config",
          "server", "server.authn", "server.authz", "server.http",
          "server.grpc", "server.proto", "client", "cli", "cli.fbsql",
          "cli.main", "cluster.hash", "cluster.disco", "cluster.snapshot",
          "cluster.coordinator", "cluster.rebalance",
          "storage.stats_store", "storage.blob", "dax", "dax.directive",
          "dax.settings", "dax.writelogger", "dax.snapshotter",
          "dax.schemar", "dax.worker", "dax.computer", "dax.controller",
          "dax.queryer", "dax.server", "parallel", "parallel.mesh",
          "parallel.dist", "memory.placement", "storage.native_ingest",
          "executor.mesh_arm"):
    assert "pilosa_tpu_torch." + n in names, n
# pyarrow loads only when a dataframe is saved, loaded or exported
assert "pyarrow" not in sys.modules
"""


def test_port_imports_no_jax_and_no_pilosa_tpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", _CHECK], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    n_modules = int(out.stdout.split()[0])
    assert n_modules >= 60


_RBF_BUILD = r"""
import os, sys
import numpy as np
from pilosa_tpu_torch.storage import _build, rbf
rbf.container_encode(np.zeros(rbf.TILE_WORDS, dtype=np.uint32))
so = _build.build("rbf")
print(so)
assert not [m for m in sys.modules if m == "jax" or m.startswith("jax.")
            or m == "pilosa_tpu" or m.startswith("pilosa_tpu.")]
"""


def _listing(d: Path) -> dict:
    if not d.is_dir():
        return {}
    return {p.name: p.stat().st_mtime_ns for p in d.iterdir()}


def test_rbf_builds_into_build_torch_host_only():
    """The port's RBF library comes from its own copy of the sources,
    built into build/torch_host/<hash>/; loading it (building it if it
    is missing) leaves the JAX package's native/build/ as it was."""
    native = ROOT / "native" / "build"
    before = _listing(native)
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", _RBF_BUILD], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    so = Path(out.stdout.split()[-1])
    assert so.parent.parent == ROOT / "build" / "torch_host"
    assert so.name == "librbf.so" and so.exists()
    assert _listing(native) == before


def test_executor_needs_a_card_unless_told_cpu(monkeypatch):
    from pilosa_tpu_torch.executor.executor import Executor
    from pilosa_tpu_torch.models.holder import Holder

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    h = Holder(width=2048)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Executor(h)
    assert Executor(h, device="cpu").device.type == "cpu"
    from pilosa_tpu_torch.api import API
    with pytest.raises(RuntimeError, match="no CUDA device"):
        API(h)
    assert API(h, device="cpu").executor.device.type == "cpu"
    from pilosa_tpu_torch.sql import SQLEngine
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SQLEngine(h)
    assert SQLEngine(h, device="cpu").executor.device.type == "cpu"


def test_timeq_switches_read_no_environment():
    """The port's [timeq] switches come through timeq.configure() only:
    the JAX package's environment twins leave them at their defaults."""
    env = dict(os.environ, PYTHONPATH=str(ROOT), PILOSA_TPU_QCOVER="0",
               PILOSA_TPU_TIMEQ_WRITE_FINEST="1", PILOSA_TPU_TIMEQ_ROLLUP="1")
    code = ("from pilosa_tpu_torch.models import timeq as t; "
            "print(t.qcover(), t.write_finest(), t.rollup_enabled()); "
            "t.configure(qcover=False, write_finest=True, rollup=True); "
            "print(t.qcover(), t.write_finest(), t.rollup_enabled())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split("\n")[:2] == ["True False False",
                                          "False True True"]


def test_sql_and_stats_switches_read_no_environment():
    """The port's [sql] pushdown and [stats] switches come through
    costplan.configure() and stats.configure() only: the JAX package's
    environment twins leave them at their defaults (on)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT), PILOSA_TPU_SQL_PUSHDOWN="0",
               PILOSA_TPU_STATS="0")
    code = ("from pilosa_tpu_torch.sql import costplan as c; "
            "from pilosa_tpu_torch.obs import stats as s; "
            "print(c.enabled(), s.enabled()); "
            "c.configure(enabled=False); s.configure(enabled=False); "
            "print(c.enabled(), s.enabled())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split("\n")[:2] == ["True True", "False False"]


def test_serving_switches_read_no_environment():
    """The serving layer's ragged and admission switches are constructor
    arguments, and the audit, standing, incidents, watchdog and roofline
    planes go through configure() only: the JAX package's environment
    twins leave them at their defaults (on)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT),
               PILOSA_TPU_SERVING_RAGGED="0",
               PILOSA_TPU_SERVING_ADMISSION="0", PILOSA_TPU_AUDIT="0",
               PILOSA_TPU_AUDIT_SAMPLE_RATE="0.5", PILOSA_TPU_STANDING="0",
               PILOSA_TPU_INCIDENTS="0", PILOSA_TPU_WATCHDOG="0",
               PILOSA_TPU_ROOFLINE="0", PILOSA_TPU_PEAK_GBPS="7")
    code = ("from pilosa_tpu_torch.models.holder import Holder; "
            "from pilosa_tpu_torch.executor.executor import Executor; "
            "from pilosa_tpu_torch.executor import standing; "
            "from pilosa_tpu_torch.obs import audit, incidents, watchdog, "
            "roofline; "
            "lay = Executor(Holder(width=2048), device='cpu')"
            ".enable_serving(); "
            "print(lay.ragged, lay.sched is not None, audit.enabled(), "
            "audit._SAMPLE_RATE, standing.enabled(), incidents.enabled(), "
            "watchdog.enabled(), roofline.enabled(), "
            "roofline.peak_or_none()); lay.close()")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split("\n")[0] == \
        "True True True 0.01 True True True True None"


def test_memory_switches_read_no_environment():
    """The port's memory and sparse-format switches come through
    memory.configure() and encode.configure() only: the JAX package's
    environment twins leave them at their defaults (paging on, 4 MiB
    pages, the sparse format on, the budget detected: 8 GiB with no
    card)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT), PILOSA_TPU_MEMORY_PAGED="0",
               PILOSA_TPU_MEMORY_PAGE_BYTES="8192",
               PILOSA_TPU_MEMORY_BUDGET_BYTES="12345",
               PILOSA_TPU_MEMORY_OOM_RETRY="0",
               PILOSA_TPU_MEMORY_HOST_FALLBACK="0",
               PILOSA_TPU_SPARSE_FORMAT="0", CUDA_VISIBLE_DEVICES="")
    code = ("from pilosa_tpu_torch import memory as m; "
            "from pilosa_tpu_torch.memory import encode as e, pressure as p; "
            "print(m.paged_enabled(), m.page_bytes(), m.ledger().budget(), "
            "p.OOM_RETRY, p.HOST_FALLBACK, e.enabled()); "
            "m.configure(paged=False, page_bytes=8192, budget_bytes=12345, "
            "oom_retry=False, host_fallback=False); e.configure(enabled=False); "
            "print(m.paged_enabled(), m.page_bytes(), m.ledger().budget(), "
            "p.OOM_RETRY, p.HOST_FALLBACK, e.enabled())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split("\n")[:2] == [
        f"True {4 << 20} {8 << 30} True True True",
        "False 8192 12345 False False False"]


_NO_GRPC = r"""
import importlib, importlib.abc, io, contextlib, sys

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("grpc", "yaml") or \
                name.startswith("google.protobuf"):
            raise ImportError(f"refused: {name}")
        return None

sys.meta_path.insert(0, Refuse())
for n in ("server", "server.http", "server.authn", "server.authz", "config",
          "cli", "cli.main", "cli.fbsql", "client", "ingest",
          "ingest.stream", "ingest.kafka", "ingest.avro", "obs.slo",
          "taskpool", "cluster", "cluster.txn", "cluster.client", "api"):
    importlib.import_module("pilosa_tpu_torch." + n)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("grpc", "yaml")
             or m.startswith("google.protobuf"))
assert not bad, bad
try:
    importlib.import_module("pilosa_tpu_torch.server.grpc")
except ImportError as e:
    assert "grpc" in str(e) and "grpc-port = -1" in str(e), e
else:
    raise AssertionError("server.grpc imported without grpc")
from pilosa_tpu_torch.cli import main as cli
err = io.StringIO()
with contextlib.redirect_stderr(err):
    rc = cli.main(["server", "--device", "cpu", "--port", "0",
                   "--grpc-port", "0"])
assert rc == 1 and "grpc" in err.getvalue(), err.getvalue()
print("ok")
"""


def test_server_imports_without_grpc_protobuf_or_yaml():
    """server.http, config, cli, client, the stream plane and the SLO
    plane import with grpc, google.protobuf and yaml refused; importing
    server.grpc then raises an ImportError naming the packages, and a
    node asked for gRPC fails to start instead of serving without it."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", _NO_GRPC], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.strip().endswith("ok")


def test_config_load_reads_the_environment_apply_writes_none():
    """config.load takes the PILOSA_TPU_* environment; the port's
    apply_* then hand the values to configure() calls and write no
    environment variable (the JAX package's write PILOSA_TPU_PALLAS,
    PILOSA_TPU_STACK_PATCH and the cluster twins)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT), PILOSA_TPU_SLO_WINDOWS="7m",
               PILOSA_TPU_TIMEQ_QCOVER="false")
    code = ("import os; from pilosa_tpu_torch import config; "
            "from pilosa_tpu_torch.models import timeq; "
            "from pilosa_tpu_torch.obs import slo; "
            "before = dict(os.environ); c = config.load(); "
            "c.apply_all(); "
            "print(c.slo_windows, slo.get().windows, timeq.qcover(), "
            "dict(os.environ) == before)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split("\n")[0] == "7m [('7m', 420.0)] False True"


def test_cluster_switches_read_no_environment():
    """The cluster plane's knobs come through coordinator.configure()
    and rebalance.configure() only: the JAX package's environment twins
    (hedge, deadline and the rebalance tunables) leave them at their
    defaults, in the modules and in a controller made with no
    arguments."""
    env = dict(os.environ, PYTHONPATH=str(ROOT),
               PILOSA_TPU_CLUSTER_HEDGE_MS="7",
               PILOSA_TPU_CLUSTER_DEADLINE_S="3",
               PILOSA_TPU_REBALANCE_CHASE_LAG="2",
               PILOSA_TPU_REBALANCE_MAX_ROUNDS="3",
               PILOSA_TPU_REBALANCE_FENCE_TIMEOUT_S="1.5")
    code = ("from pilosa_tpu_torch.cluster import coordinator as c, "
            "rebalance as r\n"
            "from pilosa_tpu_torch.cluster.coordinator import "
            "ClusterExecutor as E\n"
            "print(c.settings(), r.settings(), E._default_deadline())\n"
            "class N:\n"
            "    replica_n = 1\n"
            "    def _client(self): return None\n"
            "    def snapshot(self):\n"
            "        from pilosa_tpu_torch.cluster import ClusterSnapshot\n"
            "        return ClusterSnapshot([])\n"
            "k = r.RebalanceController(N())\n"
            "print(k.chase_lag, k.max_rounds, k.fence_timeout_s)\n"
            "c.configure(hedge_ms=7, deadline_s=3)\n"
            "r.configure(chase_lag=2, max_rounds=3, fence_timeout_s=1.5)\n"
            "k = r.RebalanceController(N())\n"
            "print(c.settings(), k.chase_lag, k.max_rounds, "
            "k.fence_timeout_s, E._hedge_delay(), "
            "E._default_deadline().remaining() > 2)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.split("\n")
    assert lines[0] == ("{'hedge_ms': 0.0, 'deadline_s': 0.0} "
                        "{'chase_lag': 8, 'max_rounds': 12, "
                        "'fence_timeout_s': 10.0} None")
    assert lines[1] == "8 12 10.0"
    assert lines[2] == ("{'hedge_ms': 7.0, 'deadline_s': 3.0} 2 3 1.5 "
                        "0.007 True")


def test_dax_switches_read_no_environment():
    """The [dax]/[blob] knobs come through dax.settings.configure()
    only: the JAX package's environment twins leave the port's
    accessors at their defaults until a Config (whose load reads them)
    applies them."""
    env = dict(os.environ, PYTHONPATH=str(ROOT),
               PILOSA_TPU_DAX_BLOB="0", PILOSA_TPU_BLOB_BACKEND="dir",
               PILOSA_TPU_DAX_PREFETCH="5",
               PILOSA_TPU_DAX_COOLDOWN_S="1.5",
               PILOSA_TPU_DAX_CHASE_LAG="3")
    code = ("from pilosa_tpu_torch.dax import settings as s\n"
            "def show():\n"
            "    print(s.blob_enabled(), s.backend(), s.prefetch(), "
            "s.cooldown_s(), s.chase_lag())\n"
            "show()\n"
            "from pilosa_tpu_torch import config\n"
            "config.load().apply_dax_settings()\n"
            "show()\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split("\n")[:2] == ["True  2 30.0 8",
                                          "False dir 5 1.5 3"]


def test_placement_switches_read_no_environment():
    """The serving mesh's knobs come through placement.configure() only:
    the JAX package's PILOSA_TPU_MESH_DEVICES and PILOSA_TPU_PLACEMENT_PIN
    leave the port's mesh off until a Config (whose load reads them)
    applies them; the slots are then the given devices."""
    env = dict(os.environ, PYTHONPATH=str(ROOT), PILOSA_TPU_MESH_DEVICES="4",
               PILOSA_TPU_PLACEMENT_PIN="i/*=2")
    code = ("import sys, torch\n"
            "from pilosa_tpu_torch.memory import placement as p\n"
            "from pilosa_tpu_torch import parallel\n"
            "from pilosa_tpu_torch.storage import native_ingest\n"
            "def show():\n"
            "    print(p.mesh_devices(), p._configured, p._pins)\n"
            "show()\n"
            "from pilosa_tpu_torch import config\n"
            "config.load().apply_placement_settings()\n"
            "p.configure(devices=[torch.device('cpu')] * 8)\n"
            "show()\n"
            "print(p.owners('i', [0, 1]).tolist())\n"
            "assert not [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'pilosa_tpu' or "
            "m.startswith('pilosa_tpu.')]\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split("\n")[:3] == ["1 0 {}", "4 4 {('i', '*'): 2}",
                                          "[2, 2]"]


def test_make_mesh_needs_a_card_unless_given_devices(monkeypatch):
    from pilosa_tpu_torch.parallel import make_mesh
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh(2)
    assert make_mesh(2, devices=["cpu", "cpu"]).size == 2
