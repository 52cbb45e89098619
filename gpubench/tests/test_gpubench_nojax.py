"""Nothing a run loads is JAX or the JAX package: a cell's code path at
a tiny size, in a process of its own on the CPU, then its sys.modules
by top-level name (the part before the first dot, compared whole)."""

import json
import subprocess
import sys

from gpubench import manifest as man
from gpubench import run

SCRIPT = """
import json, sys, time, torch
from gpubench import run
out = run.run_cell("able-groupby-c8", 2**33 + 1, 0.5, True, torch.device("cpu"),
                   time.time(), cfg_over={"shards": 2, "shard_width": 2048,
                                          "chunk_shards": 2})
print(json.dumps({"correct": out["correct"], "metrics": sorted(out["metrics"]),
                  "host": sorted(out["host"]),
                  "tops": sorted({k.split(".")[0] for k in sys.modules})}))
"""


def test_a_run_loads_no_jax():
    env = {"PATH": "/usr/bin:/bin", "HOME": "/tmp", "PYTHONPATH": "",
           "JAX_PLATFORMS": "cpu"}
    p = subprocess.run([sys.executable, "-c", SCRIPT], cwd=man.root(),
                       env=env, capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    got = json.loads(p.stdout.strip().splitlines()[-1])
    assert got["correct"]
    assert {"audit.shadow_share", "kernels.launches_per_query",
            "p95_ms.host"} <= set(got["metrics"])
    assert {"process_cpu_s", "probe_ms", "gc_s", "shadow_s"} <= set(got["host"])
    assert "pilosa_tpu_torch" in got["tops"] and "torch" in got["tops"]
    assert not set(got["tops"]) & {"jax", "jaxlib", "flax", "pilosa_tpu",
                                   "bench"}


def test_forbidden_names_are_whole(monkeypatch):
    mods = dict(sys.modules)
    mods.pop("bench", None)
    for k in [k for k in mods if k.split(".")[0] in run.FORBIDDEN]:
        mods.pop(k)
    mods["pilosa_tpu_torch.api"] = None
    mods["benchmarks_of_mine"] = None
    monkeypatch.setattr(sys, "modules", mods)
    assert run.forbidden_modules() == []
    mods["pilosa_tpu.ops"] = None
    mods["jax"] = None
    assert run.forbidden_modules() == ["jax", "pilosa_tpu"]
