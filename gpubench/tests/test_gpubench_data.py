"""The seeded generators: deterministic from the seed, the packed words'
layout, and each kind of field."""

import numpy as np
import pytest
import torch

from gpubench import data
from gpubench import manifest as man

CPU = torch.device("cpu")


@pytest.mark.parametrize("name", ["able-1b", "taxi-1b"])
def test_values_deterministic_from_the_seed(name, tiny):
    cfg = dict(man.config(name), **tiny)
    seed = 2**33 + 5            # past 32 bits, as a run's seed may be
    a = data.chunk_values(cfg, seed, 0, 4096, CPU)
    b = data.chunk_values(cfg, seed, 0, 4096, CPU)
    c = data.chunk_values(cfg, seed + 1, 0, 4096, CPU)
    d = data.chunk_values(cfg, seed, 1, 4096, CPU)
    for f in cfg["fields"]:
        k = f["name"]
        assert torch.equal(a[k], b[k])
        if f.get("rows", 2) > 1 or f["kind"] == "int":
            assert not torch.equal(a[k], c[k]) and not torch.equal(a[k], d[k])


def test_pack_bits_layout():
    rng = np.random.default_rng(3)
    bits = rng.integers(0, 2, size=(2, 256)).astype(bool)
    words = data.pack_bits(torch.from_numpy(bits)).numpy().view(np.uint32)
    for r in range(2):
        for c in range(256):
            assert bool((words[r, c // 32] >> (c % 32)) & 1) == bits[r, c]


@pytest.mark.parametrize("name", ["able-1b", "taxi-1b"])
def test_field_words(name, tiny):
    cfg = dict(man.config(name), **tiny)
    n = 2 * cfg["shard_width"]
    vals = data.chunk_values(cfg, 9, 0, n, CPU)
    for f in cfg["fields"]:
        v = vals[f["name"]]
        w = data.field_words(f, v, 2, cfg["shard_width"])
        bits = (w.to(torch.int64).unsqueeze(-1) >> torch.arange(32)) & 1
        bits = bits.reshape(w.shape[0], -1)
        if f["kind"] == "int":
            assert w.shape[0] == 2 + data.depth_of(f)
            assert bool(bits[0].all()) and not bool(bits[1].any())
            got = sum(bits[2 + p] << p for p in range(data.depth_of(f)))
            assert torch.equal(got, v - f["min"])
            assert int(v.min()) >= f["min"] and int(v.max()) <= f["max"]
        elif "bits" in f:
            got = sum(bits[r] << r for r in range(f["rows"]))
            assert torch.equal(got, v)
        else:
            # one row a column at most; the value rows means absent
            assert int(bits.sum(0).max()) <= 1
            present = v < f["rows"]
            assert torch.equal(bits.sum(0).bool(), present)
            assert torch.equal(bits.argmax(0)[present], v[present])


def test_weights():
    w = data.weights_of({"geometric": {"mean": 3.0, "cap": 63}})
    assert len(w) == 64 and abs(sum(w) - 1) < 1e-12
    assert abs(sum(k * p for k, p in enumerate(w)) - 3.0) < 1e-6


def test_given_weights_hold():
    cfg = man.config("taxi-1b")
    vals = data.chunk_values(cfg, 4, 0, 1 << 16, CPU)
    year, cab = vals["pickup_year"], vals["cab_type"]
    assert not bool(cab[year < 4].any())       # no green before 2013
    assert bool(cab[year == 6].any())
    assert float((vals["passenger_count"] == 1).double().mean()) > 0.6


@pytest.mark.parametrize("traffic, size", [("able-groupby", 80),
                                           ("taxi-sql", 4),
                                           ("able-scan", None)])
def test_a_deck_holds_every_shape_by_its_weight(traffic, size):
    import collections
    from fractions import Fraction

    from gpubench import mix as mixmod
    m = mixmod.Mix(mixmod.load(traffic), man.config("able-1b" if "able" in
                                                     traffic else "taxi-1b"))
    deck = m.deck()
    if size is not None:
        assert len(deck) == size
    by_form = collections.Counter(form["name"] for form, *_ in deck)
    total = sum(Fraction(str(w)) for w in m.weights)
    for form, w in zip(m.forms, m.weights):
        assert Fraction(by_form[form["name"]], len(deck)) == \
            Fraction(str(w)) / total
    # every warm-up shape is dealt, and nothing else
    keys = {(f["name"], str(g), p, fl) for f, g, p, fl in deck}
    assert keys == {(f["name"], str(g), p, fl)
                    for f, g, p, fl, _ in m._shape_keys()}


def test_every_seed_sends_the_same_work_in_another_order():
    import itertools

    from gpubench import mix as mixmod
    m = mixmod.Mix(mixmod.load("able-groupby"), man.config("able-1b"))

    def shapes(seed, k):
        return sorted((s["name"], tuple(s.get("group", ())),
                       tuple(c["field"] for c in s["where"]))
                      for s in itertools.islice(m.stream(seed), k))
    a = list(itertools.islice(m.stream(2**33 + 1), 160))
    assert a == list(itertools.islice(m.stream(2**33 + 1), 160))
    assert a != list(itertools.islice(m.stream(2**33 + 2), 160))
    assert shapes(2**33 + 1, 160) == shapes(2**33 + 2, 160)


def test_clients_take_one_stream_in_turn():
    import threading

    from gpubench import loop
    turns = loop.Turns(iter(range(4000)))
    got = [[] for _ in range(8)]

    def client(i):
        for x in turns:
            got[i].append(x)
    threads = [threading.Thread(target=client, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert sorted(x for g in got for x in g) == list(range(4000))
    assert all(g == sorted(g) for g in got)
