"""BENCHMARK.json: its cells, configurations, mixes and metrics, found by
name, and the checks on its names and units."""

from __future__ import annotations

import json
import re
from pathlib import Path

HERE = Path(__file__).resolve().parent
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}\Z")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}\Z")


def root() -> Path:
    """The checkout: the folder that holds BENCHMARK.json."""
    return HERE.parent


def load(path: Path | None = None) -> dict:
    return json.loads((path or root() / "BENCHMARK.json").read_text())


def cell(m: dict, name: str) -> dict:
    for w in m["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(name: str) -> dict:
    cfg = json.loads((HERE / "configs" / f"{name}.json").read_text())
    if cfg["name"] != name:
        raise ValueError(f"configs/{name}.json names itself {cfg['name']!r}")
    return cfg


def applies(metric: dict, cell_name: str) -> bool:
    return "workloads" not in metric or cell_name in metric["workloads"]


def problems(m: dict) -> list[str]:
    """What in the manifest breaks the naming rules, or names a file
    the benchmark does not have."""
    bad = []
    names = ([c["name"] for c in m["configs"]]
             + [w["name"] for w in m["workloads"]]
             + [w["config"] for w in m["workloads"]]
             + [w["traffic"] for w in m["workloads"]]
             + [x["name"] for x in m["end_to_end"] + m["per_layer"]]
             + [k for c in m["configs"] for k in c["reduced"]])
    bad += [f"name {n!r}" for n in names if not NAME.match(n)]
    bad += [f"unit {x['unit']!r}" for x in m["end_to_end"] + m["per_layer"]
            if not UNIT.match(x["unit"])]
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        seen = [x["name"] for x in m[kind]]
        bad += [f"{kind}: {n!r} twice" for n in set(seen)
                if seen.count(n) > 1]
    for w in m["workloads"]:
        if not (HERE / "traffic" / f"{w['traffic']}.json").exists():
            bad.append(f"{w['name']}: no traffic/{w['traffic']}.json")
    for c in m["configs"]:
        if not (root() / c["file"]).exists():
            bad.append(f"{c['name']}: no {c['file']}")
    for x in m["per_layer"]:
        if not (HERE / "metrics" / f"{x['name']}.py").exists():
            bad.append(f"no metrics/{x['name']}.py")
    return bad
