"""The port's time views against the JAX package's, on the same data.

TTL (tests/test_timeq.py's cases on both packages: the removed lists,
stale stacks never served, removal across a reopen), write-finest with
its late-write rule, ``_refine_cover`` and rollup (the folded pairs and
every view's row words), and the stacked quantum-cover op: a grid of
``from``/``to`` windows, open bounds, and empty and missing covers, over
Count, Intersect, Sum, TopN and GroupBy filters, on both of the port's
engines with qcover on and off, equal to the JAX Executor.  The JAX
package's switches are flipped through their environment twins, the
port's through ``timeq.configure``; both are restored.  The port runs on
the CPU (device="cpu").  Exact throughout."""

import datetime as dt
import types

import numpy as np
import pytest
import torch

from pilosa_tpu.executor.executor import Executor as JaxExecutor
from pilosa_tpu.models import holder as jax_holder_mod
from pilosa_tpu.models import schema as jax_schema
from pilosa_tpu.obs import metrics as jax_metrics
from pilosa_tpu_torch.executor.executor import Executor
from pilosa_tpu_torch.models import holder as holder_mod
from pilosa_tpu_torch.models import schema, timeq
from pilosa_tpu_torch.models.state import holder_state
from pilosa_tpu_torch.obs import metrics
from test_torch_executor import _norm, _same_state, jax_state

torch.set_num_threads(1)

W = 2048
N_SHARDS = 3
BASE = dt.datetime(2022, 5, 30, 20)       # the data crosses a month
HOURS = 80

PKGS = {
    "port": types.SimpleNamespace(
        Holder=holder_mod.Holder, FieldOptions=schema.FieldOptions,
        FieldType=schema.FieldType, TimeQuantum=schema.TimeQuantum,
        state=holder_state),
    "jax": types.SimpleNamespace(
        Holder=jax_holder_mod.Holder, FieldOptions=jax_schema.FieldOptions,
        FieldType=jax_schema.FieldType, TimeQuantum=jax_schema.TimeQuantum,
        state=jax_state),
}


@pytest.fixture
def finest(monkeypatch):
    """Write-finest on in both packages for the test, off after."""
    monkeypatch.setenv("PILOSA_TPU_TIMEQ_WRITE_FINEST", "1")
    timeq.configure(write_finest=True)
    yield
    timeq.configure(write_finest=False)


@pytest.fixture(params=["qcover", "monolithic"])
def qcover(request):
    timeq.configure(qcover=request.param == "qcover")
    yield request.param
    timeq.configure(qcover=True)


def _events(pkg, h, quantum="YMDH"):
    """Index t: a TIME field ev (rows 0-2) with seeded bits over HOURS
    hours from BASE, half through set_bit and half through import_bits
    with timestamps; a set field a, a set field s (no rank cache) and an
    INT v."""
    rng = np.random.default_rng(31)
    idx = h.create_index("t")
    ev = idx.create_field("ev", pkg.FieldOptions(
        type=pkg.FieldType.TIME, time_quantum=pkg.TimeQuantum(quantum)))
    a = idx.create_field("a")
    s = idx.create_field("s", pkg.FieldOptions(cache_type="none"))
    v = idx.create_field("v", pkg.FieldOptions(type=pkg.FieldType.INT,
                                               min=-100, max=100))
    ncols = N_SHARDS * W
    hrs = np.repeat(np.arange(HOURS), 12)
    rows = rng.integers(0, 3, size=hrs.size)
    cols = rng.integers(0, ncols, size=hrs.size)
    times = [BASE + dt.timedelta(hours=int(x)) for x in hrs]
    half = hrs.size // 2
    for r, c, t in zip(rows[:half], cols[:half], times[:half]):
        ev.set_bit(int(r), int(c), timestamp=t)
    ev.import_bits(rows[half:], cols[half:], times[half:])
    a.import_bits(np.ones(ncols // 3, np.int64),
                  rng.choice(ncols, ncols // 3, replace=False))
    s.import_bits(rng.integers(0, 6, size=900), rng.integers(0, ncols, 900))
    vc = rng.choice(ncols, 700, replace=False)
    v.import_values(vc, rng.integers(-100, 101, size=vc.size))
    return h


@pytest.fixture(scope="module")
def holders():
    return {name: _events(pkg, pkg.Holder(width=W))
            for name, pkg in PKGS.items()}


def _row(lo, hi):
    args = "".join(f", {k}='{v}'" for k, v in (("from", lo), ("to", hi))
                   if v is not None)
    return f"Row(ev=1{args})"


WINDOWS = [
    ("2022-05-31T06:00", "2022-06-02T18:00"),   # hours, days, hours
    ("2022-05-30T00:00", "2022-07-01T00:00"),   # the June month view
    ("2022-06-01T03:00", "2022-06-01T04:00"),   # one view
    ("2022-05-31T23:00", "2022-06-01T01:00"),   # across a month
    (None, "2022-06-01T12:00"),                 # open from
    ("2022-06-02T05:00", None),                 # open to
    ("2022-08-01T00:00", "2022-08-03T00:00"),   # past the data
    ("2021-01-01T00:00", "2021-02-01T00:00"),   # before it
]

TEMPLATES = [
    "Count({row})",
    "Count(Intersect({row}, Row(a=1)))",
    "Count(Union({row}, Row(s=2)))",
    "Sum({row}, field=v)",
    "TopN(s, {row}, n=4)",
    "GroupBy(Rows(s), filter={row})",
    "Row(ev=1, from='2022-05-31T22:00', to='2022-06-01T02:00')",
]

_JAX: dict = {}


def _jax(h, query):
    if query not in _JAX:
        _JAX[query] = _norm(JaxExecutor(h).execute("t", query))
    return _JAX[query]


@pytest.mark.parametrize("engine", ["stacked", "per_shard"])
@pytest.mark.parametrize("window", WINDOWS, ids=lambda w: f"{w[0]}-{w[1]}")
@pytest.mark.parametrize("template", TEMPLATES)
def test_cover_queries_match_jax(holders, qcover, engine, window, template):
    query = template.format(row=_row(*window))
    ex = Executor(holders["port"], device="cpu")
    ex.use_stacked = engine == "stacked"
    assert _norm(ex.execute("t", query)) == _jax(holders["jax"], query)


@pytest.mark.parametrize("window", WINDOWS, ids=lambda w: f"{w[0]}-{w[1]}")
def test_views_for_range_match_jax(holders, window):
    assert holders["port"].index("t").field("ev").views_for_range(*window) \
        == holders["jax"].index("t").field("ev").views_for_range(*window)


def test_qcover_counter_moves_in_both_packages(holders):
    """The JAX solo path reaches PlanBuilder's qcover branch, and the
    port's does at the same calls: a multi-view cover counts, a one-view
    cover and an empty one do not."""
    for window, moves in ((WINDOWS[0], 1), (WINDOWS[2], 0), (WINDOWS[6], 0)):
        q = f"Count({_row(*window)})"
        j0 = jax_metrics.TIMEQ_QCOVER_TOTAL.value()
        p0 = metrics.TIMEQ_QCOVER_TOTAL.value()
        JaxExecutor(holders["jax"]).execute("t", q)
        Executor(holders["port"], device="cpu").execute("t", q)
        assert jax_metrics.TIMEQ_QCOVER_TOTAL.value() - j0 == moves
        assert metrics.TIMEQ_QCOVER_TOTAL.value() - p0 == moves


def _cover_leaves(ex):
    return {k[3] for k in ex.stacked.cache.keys() if k[0] == "rows"}


def test_shifted_window_builds_one_leaf(holders):
    ex = Executor(holders["port"], device="cpu")
    ex.execute("t", f"Count({_row('2022-05-31T06:00', '2022-06-02T18:00')})")
    built = ex.stacked.cache.full_rebuilds
    assert built == len(_cover_leaves(ex)) > 2
    assert all(len(views) == 1 for views in _cover_leaves(ex))
    q = f"Count({_row('2022-05-31T07:00', '2022-06-02T19:00')})"
    assert _norm(ex.execute("t", q)) == _jax(holders["jax"], q)
    assert ex.stacked.cache.full_rebuilds == built + 1
    # a one-view Row of a cover member is served by its leaf
    ex.execute("t", f"Count({_row('2022-06-02T10:00', '2022-06-02T11:00')})")
    assert ex.stacked.cache.full_rebuilds == built + 1
    timeq.configure(qcover=False)
    try:
        ex.execute("t", q)
        assert ex.stacked.cache.full_rebuilds == built + 2
        assert any(len(v) > 1 for v in _cover_leaves(ex))
    finally:
        timeq.configure(qcover=True)


def test_live_edge_write_patches_one_leaf():
    h = _events(PKGS["port"], PKGS["port"].Holder(width=W))
    ex = Executor(h, device="cpu")
    q = f"Count({_row('2022-05-31T06:00', '2022-06-02T18:00')})"
    n = ex.execute("t", q)[0]
    col = next(c for c in range(N_SHARDS * W)
               if ex.execute("t", f"Count(Intersect({_row(None, None)}, "
                                  f"ConstRow(columns=[{c}])))")[0] == 0)
    ex.execute("t", f"Set({col}, ev=1, 2022-06-02T17:30)")
    c0 = ex.stacked.cache.counters()
    assert ex.execute("t", q) == [n + 1]
    c1 = ex.stacked.cache.counters()
    assert c1["patches"] - c0["patches"] == 1
    assert c1["full_rebuilds"] == c0["full_rebuilds"]
    assert c1["adopts"] == c0["adopts"]


# -- TTL (tests/test_timeq.py:129-300 on both packages) -----------------------

def _ttl_holder(pkg, path=None, width=1 << 12):
    return pkg.Holder(path=path, width=width) if path else \
        pkg.Holder(width=width)


@pytest.mark.parametrize("quantum", ["YMD", "YMDH", "MD", "H"])
def test_ttl_view_removal_matches_jax(quantum):
    """Removed lists are equal, the standard and current views survive,
    and a ttl=0 field is never swept."""
    now = dt.datetime(2022, 6, 10, 12)
    out = {}
    for name, pkg in PKGS.items():
        h = _ttl_holder(pkg)
        idx = h.create_index("ttl")
        f = idx.create_field("ev", pkg.FieldOptions(
            type=pkg.FieldType.TIME,
            time_quantum=pkg.TimeQuantum(quantum), ttl=86400.0))
        keep = idx.create_field("keep", pkg.FieldOptions(
            type=pkg.FieldType.TIME, time_quantum=pkg.TimeQuantum("Y")))
        for i, t in enumerate((dt.datetime(2020, 1, 1, 12),
                               dt.datetime(2022, 6, 8, 5),
                               dt.datetime(2022, 6, 9, 11),
                               dt.datetime(2022, 6, 10, 11))):
            f.set_bit(1, 10 + i, timestamp=t)
            keep.set_bit(1, i, timestamp=t)
        removed = f.remove_expired_views(now=now)
        out[name] = (removed, sorted(f.views),
                     keep.remove_expired_views(now=now), pkg.state(h))
    assert out["port"][:3] == out["jax"][:3]
    assert out["port"][0] and "standard" in out["port"][1]
    assert out["port"][2] == []
    _same_state(out["port"][3], out["jax"][3])


def test_holder_sweep_matches_jax_per_field():
    """The port's Holder sweep at a given time removes what the JAX
    fields' own sweeps remove, field by field, and a second sweep
    removes nothing."""
    now = dt.datetime(2019, 6, 1)
    out = {}
    for name, pkg in PKGS.items():
        h = _ttl_holder(pkg)
        idx = h.create_index("ep")
        for fi in range(2):
            f = idx.create_field(f"ev{fi}", pkg.FieldOptions(
                type=pkg.FieldType.TIME,
                time_quantum=pkg.TimeQuantum("YMDH"), ttl=86400.0))
            for day in (1, 2, 3):
                f.set_bit(1, day, timestamp=dt.datetime(2019, 5, day, 6))
        if name == "port":
            out[name] = (h.remove_expired_views(now=now),
                         h.remove_expired_views(now=now))
        else:
            fields = list(h.index("ep").fields.values())
            out[name] = ([v for f in fields
                          for v in f.remove_expired_views(now=now)],
                         [v for f in fields
                          for v in f.remove_expired_views(now=now)])
    assert out["port"] == out["jax"]
    assert len(out["port"][0]) > 6 and out["port"][1] == []


@pytest.mark.parametrize("engine", ["stacked", "per_shard"])
def test_ttl_expiry_serves_no_stale_stack(engine):
    """After the sweep the fragments' gens have moved, and an executor
    that served the expired window answers from what survives, as the
    JAX executor does."""
    q = "Count(Row(ev=1, from='2021-03-01T00:00', to='2021-03-03T00:00'))"
    answers = {}
    for name, pkg in PKGS.items():
        h = pkg.Holder()
        idx = h.create_index("ttl2", track_existence=False)
        f = idx.create_field("ev", pkg.FieldOptions(
            type=pkg.FieldType.TIME, time_quantum=pkg.TimeQuantum("YMD"),
            ttl=86400.0))
        old = dt.datetime(2021, 3, 1, 12)
        f.set_bit(1, 10, timestamp=old)
        f.set_bit(1, 11, timestamp=old)
        f.set_bit(1, 12, timestamp=dt.datetime(2021, 3, 2, 12))
        ex = (Executor(h, device="cpu") if name == "port"
              else JaxExecutor(h))
        ex.use_stacked = engine == "stacked"
        before = ex.execute("ttl2", q)
        gens = {n: [(fr, fr.gen) for fr in v.fragments.values()]
                for n, v in f.views.items()}
        removed = f.remove_expired_views(now=dt.datetime(2021, 3, 3, 6))
        assert removed and all(fr.gen != g for n in removed
                               for fr, g in gens[n])
        answers[name] = (before, removed, ex.execute("ttl2", q))
    assert answers["port"] == answers["jax"]
    assert answers["port"][0] == [3] and answers["port"][2] == [1]


def test_ttl_removal_persists_across_reopen(tmp_path, monkeypatch):
    """Expired views leave storage: a reopen does not bring them back,
    in either package, and the reopened holders are equal."""
    monkeypatch.setenv("RBF_NOSYNC", "1")
    opened, states = [], {}
    try:
        for name, pkg in PKGS.items():
            path = str(tmp_path / name)
            h = pkg.Holder(path=path)
            opened.append(h)
            idx = h.create_index("t")
            f = idx.create_field("ev", pkg.FieldOptions(
                type=pkg.FieldType.TIME, time_quantum=pkg.TimeQuantum("YM"),
                ttl=3600.0))
            f.set_bit(1, 5, timestamp=dt.datetime(2019, 6, 1))
            f.set_bit(1, 6, timestamp=dt.datetime(2030, 6, 1))
            h.sync()
            assert f.remove_expired_views(now=dt.datetime(2025, 1, 1))
            h.sync()
            h.close()
            h2 = pkg.Holder(path=path)
            opened.append(h2)
            h2.load_schema()
            f2 = h2.index("t").field("ev")
            assert all(not v.startswith("standard_2019") for v in f2.views)
            assert "standard_2030" in f2.views
            states[name] = pkg.state(h2)
    finally:
        for h in opened:
            h.close()
    _same_state(states["port"], states["jax"])


# -- write-finest, _refine_cover and rollup ------------------------------------

@pytest.mark.parametrize("quantum", ["YMDH", "YMD", "MDH", "DH", "MD"])
def test_write_finest_refine_and_rollup_match_jax(finest, quantum):
    """Under write-finest both packages write the same views; the covers
    refine the same way before a rollup and read the rolled views after;
    the folded pairs and every view's row words are equal; a late write
    into a rolled span reaches the parents that exist."""
    queries = [f"Count({_row(*w)})" for w in WINDOWS[:6]] + [
        "TopN(ev, n=3, from='2022-05-31T00:00', to='2022-06-02T00:00')"]
    out = {}
    for name, pkg in PKGS.items():
        h = _events(pkg, pkg.Holder(width=W), quantum=quantum)
        f = h.index("t").field("ev")
        assert f.views_for_range(*WINDOWS[0]) or quantum == "MD"
        run = (lambda q: _norm(Executor(h, device="cpu").execute("t", q))) \
            if name == "port" else \
            (lambda q: _norm(JaxExecutor(h).execute("t", q)))
        views0 = sorted(f.views)
        covers0 = [f.views_for_range(*w) for w in WINDOWS]
        before = [run(q) for q in queries]
        # after the last write: every view a fold makes is complete
        done = BASE + dt.timedelta(hours=HOURS)
        folded = f.rollup_views(now=done)
        again = f.rollup_views(now=done)
        covers1 = [f.views_for_range(*w) for w in WINDOWS]
        after = [run(q) for q in queries]
        # late writes: into a rolled span, and into an open one
        f.set_bit(2, 77, timestamp=dt.datetime(2022, 5, 31, 3))
        f.import_bits([0, 1], [78, 4000], [dt.datetime(2022, 5, 31, 4),
                                           dt.datetime(2022, 6, 2, 9)])
        late = [run(q) for q in queries]
        out[name] = (views0, covers0, before, folded, again, covers1,
                     after, late, sorted(f.views), pkg.state(h))
    for i, (p, j) in enumerate(zip(out["port"][:-1], out["jax"][:-1])):
        assert p == j, i
    _same_state(out["port"][-1], out["jax"][-1])
    # a pair folds once; a fold may make a parent whose later children
    # were not complete (the June month from June 1-2 while June 3 is
    # open), and a cover then reads that parent: both packages answer so
    assert out["port"][4] == []
    assert (out["port"][2][1] != out["port"][6][1]) == ("M" in quantum)


def test_write_finest_writes_standard_and_finest_only(finest):
    for name, pkg in PKGS.items():
        h = pkg.Holder(width=W)
        f = h.create_index("t").create_field("ev", pkg.FieldOptions(
            type=pkg.FieldType.TIME, time_quantum=pkg.TimeQuantum("YMDH")))
        f.set_bit(1, 3, timestamp=dt.datetime(2022, 6, 1, 5))
        f.import_bits([1], [4], ["2022-06-01T06:00"])
        assert sorted(f.views) == ["standard", "standard_2022060105",
                                   "standard_2022060106"], name


def test_holder_rollup_tuples():
    """Holder.rollup_views folds every time field and names each fold
    as (index, field, child, parent), the JAX Holder's tuples."""
    now = dt.datetime(2022, 6, 1, 12)
    out = {}
    for name, pkg in PKGS.items():
        h = _events(pkg, pkg.Holder(width=W), quantum="DH")
        if name == "port":
            out[name] = h.rollup_views(now=now)
        else:
            out[name] = [("t", f.name, c, p)
                         for f in h.index("t").fields.values()
                         for c, p in f.rollup_views(now=now)]
    assert out["port"] == out["jax"] and out["port"]
