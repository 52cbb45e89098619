"""BENCHMARK.json against the benchmark's contract: its keys, names,
units and the files it names."""

import json

import pytest

from gpubench import manifest as man
from gpubench import metrics as readers

M = man.load()
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}


def test_keys_and_sizes():
    assert set(M) == TOP
    assert M["paths"] == ["gpubench"]
    assert M["command"][:3] == ["python3", "-m", "gpubench.run"]
    assert 1 <= M["run_seconds"] <= 51
    assert len((man.root() / "BENCHMARK.json").read_bytes()) <= 64 << 10
    assert 1 <= len(M["configs"]) <= 24 and 1 <= len(M["workloads"]) <= 24


def test_names_units_and_files():
    assert man.problems(M) == []


@pytest.mark.parametrize("name, ok", [
    ("able-groupby-c8", True), ("p95_ms.host", True), ("_x", True),
    ("a b", False), ("a/b", False), ("a,b", False), (".x", False),
    ("x" * 65, False), ("ü", False)])
def test_name_rule(name, ok):
    assert bool(man.NAME.match(name)) is ok


@pytest.mark.parametrize("unit, ok", [
    ("queries/s", True), ("%", True), ("ms", True), ("launches", True),
    ("tokens per second", False), ("x" * 17, False), ("µs", False)])
def test_unit_rule(unit, ok):
    assert bool(man.UNIT.match(unit)) is ok


def test_metrics():
    e2e = {x["name"] for x in M["end_to_end"]}
    assert {"device_ms_per_query", "setup_s"} <= e2e
    for x in M["end_to_end"]:
        assert x["source"] in ("host_clock", "device_trace")
        assert x["better"] in ("lower", "higher")
        assert 0.01 <= x["bound"] <= 0.25
    for x in M["per_layer"]:
        assert x["moves"] in e2e
        assert x["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert callable(readers.load(x["name"]).read)
        for w in x.get("workloads", []):
            assert w in {c["name"] for c in M["workloads"]}


@pytest.mark.parametrize("c", M["configs"], ids=lambda c: c["name"])
def test_config_files(c):
    cfg = json.loads((man.root() / c["file"]).read_text())
    assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
    for key in ("source", "assumed", "guarantees", "node", "bytes_on_card",
                "shards", "shard_width", "fields"):
        assert key in cfg
    from pilosa_tpu_torch.config import Config
    defaults = Config()
    # the node section states config.py's defaults, the audit's with them
    assert "node_changed" not in cfg
    for k, v in cfg["node"].items():
        assert getattr(defaults, k) == v, k
    assert cfg["node"]["audit_enabled"] is True


def test_cells_use_each_config_once_a_traffic():
    pairs = [(w["config"], w["traffic"]) for w in M["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert {c["name"] for c in M["configs"]} == {w["config"]
                                                for w in M["workloads"]}
    assert all(w["chips"] == 1 for w in M["workloads"])
