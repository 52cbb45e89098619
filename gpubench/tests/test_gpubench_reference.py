"""The reference against the port: every mix's requests, answered by
the port on a tiny holder on the CPU and by the histogram reference."""

import itertools

import pytest
import torch

from gpubench import answers, loop, node
from gpubench import manifest as man
from gpubench import mix as mixmod
from gpubench.reference import Cube

CPU = torch.device("cpu")
SEED = 2**35 + 11


@pytest.fixture(scope="module")
def nodes():
    out = {}
    tiny = {"shards": 3, "shard_width": 2048, "chunk_shards": 2}
    m = man.load()
    for name in ("able-1b", "taxi-1b"):
        cfg = dict(man.config(name), **tiny)
        h = node.load_holder(cfg, SEED, CPU)
        read = set().union(*(mixmod.Mix(mixmod.load(w["traffic"]), cfg).fields()
                             for w in m["workloads"] if w["config"] == name))
        from pilosa_tpu_torch.api import API
        out[name] = (cfg, API(h, CPU), Cube(cfg, SEED, CPU, fields=read))
    return out


def test_a_cube_of_some_fields_answers_as_the_whole():
    cfg = {"name": "small", "shards": 2, "shard_width": 1024, "chunk_shards": 1,
           "fields": [{"name": "s", "kind": "set", "rows": 2, "bits": {"p": 0.5}},
                      {"name": "c", "kind": "set", "rows": 3,
                       "weights": [1, 2, 3], "absent": 1},
                      {"name": "v", "kind": "int", "min": 0, "max": 15,
                       "dist": {"uniform": True}}]}
    whole, some = Cube(cfg, 5, CPU), Cube(cfg, 5, CPU, fields={"c", "v"})
    assert some.names == ["c", "v"]
    where = [{"field": "v", "between": [3, 11]}, {"field": "c", "eq": 1}]
    for spec in ({"op": "count", "where": where},
                 {"op": "sum", "field": "v", "where": where},
                 {"op": "groupby", "group": ["c"], "aggregate": "sum",
                  "field": "v", "where": where[:1]}):
        assert some.answer(spec) == whole.answer(spec)


def test_the_fields_a_mix_reads():
    cfg = man.config("able-1b")
    got = mixmod.Mix(mixmod.load("able-groupby"), cfg).fields()
    assert got == {"edu", "gen", "dom", "reg", "age", "t"}


@pytest.mark.parametrize("cell", [w["name"] for w in man.load()["workloads"]])
def test_port_equals_reference(nodes, cell):
    w = man.cell(man.load(), cell)
    cfg, api, cube = nodes[w["config"]]
    mix = mixmod.Mix(mixmod.load(w["traffic"]), cfg)
    specs = mix.shapes(SEED) + list(itertools.islice(mix.stream(SEED), 30))
    for spec in specs:
        got = answers.canonical(spec, loop.send(api, cfg["index"], spec))
        assert answers.same(spec, got, cube.answer(spec)), \
            mixmod.render(spec, cfg["index"])


def test_same_catches_a_difference():
    spec = {"op": "groupby", "group": ["a", "b"], "front": "sql",
            "order": [["b", "asc"], ["count", "desc"]]}
    want = [((0, 0), 5, None), ((1, 0), 7, None), ((0, 1), 2, None)]
    assert answers.same(spec, [want[1], want[0], want[2]], want)
    assert not answers.same(spec, want, want)          # ORDER BY broken
    assert not answers.same(spec, [want[1], want[0]], want)
    topn = {"op": "topn", "n": 2}
    assert answers.same(topn, [(3, 9), (1, 4)], [(3, 9), (1, 4), (2, 4)])
    assert answers.same(topn, [(3, 9), (2, 4)], [(3, 9), (1, 4), (2, 4)])
    assert not answers.same(topn, [(3, 9), (2, 3)], [(3, 9), (1, 4), (2, 3)])
    assert not answers.same({"op": "sum"}, (10, 3), (10, 4))
