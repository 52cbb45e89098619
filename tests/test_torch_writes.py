"""The PQL write path in the port against the JAX package, and the
device caches patched on write.

Seeded interleavings of Set, Clear, Store, ClearRow and Delete with
read queries run on long-lived executors of both packages, the port on
both of its engines (device="cpu"): every write's answer and every
read after it are equal.  The port's resident stacks are patched in
place from the fragments' delta logs (``StackCache``): a patched stack
equals a cold build bit for bit (after the JAX package's
tests/test_stack_patch.py), point writes count patches and no
rebuilds, a delta-log overflow, a gen bump and a near-total patch
rebuild under their own reason, and a patch that raises propagates
with no rebuild.  ``patch_rows`` and ``patch_rows_np`` equal the JAX
``patch_rows``, and the fragments log the JAX package's spans."""

import dataclasses
import datetime as dt

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pilosa_tpu.executor.executor import Executor as JaxExecutor
from pilosa_tpu.models.fragment import Fragment as JaxFragment
from pilosa_tpu.models.holder import Holder as JaxHolder
from pilosa_tpu.models.schema import FieldOptions as JaxFieldOptions
from pilosa_tpu.models.schema import FieldType as JaxFieldType
from pilosa_tpu.models.schema import TimeQuantum as JaxTimeQuantum
from pilosa_tpu.ops import bitmap as jax_bm
from pilosa_tpu_torch.executor.executor import Executor
from pilosa_tpu_torch.models import fragment as fragmod
from pilosa_tpu_torch.models.fragment import Fragment
from pilosa_tpu_torch.models.holder import Holder
from pilosa_tpu_torch.models.schema import FieldOptions, FieldType, TimeQuantum
from pilosa_tpu_torch.models.view import VIEW_STANDARD
from pilosa_tpu_torch.ops import bitmap as bm

torch.set_num_threads(1)

WIDTH = 2048
N_SHARDS = 4
NCOLS = WIDTH * N_SHARDS
SHARDS = tuple(range(N_SHARDS))


def _build(h, opts, ftype, tq):
    """Index w: overlapping set rows s (some dense), a mutex m, an INT v
    with negatives, a time field tq, and disjoint g1/g2 for the
    group-code stack."""
    rng = np.random.default_rng(3)
    idx = h.create_index("w")
    cols = np.arange(NCOLS)
    s = idx.create_field("s")
    s.import_bits(rng.integers(0, 3, size=6000), rng.integers(0, NCOLS, 6000))
    s.import_bits(np.full(40, 3), rng.integers(0, NCOLS, 40))
    m = idx.create_field("m", opts(type=ftype.MUTEX))
    mc = cols[rng.random(NCOLS) < 0.6]
    m.import_bits(rng.integers(0, 4, size=mc.size), mc)
    v = idx.create_field("v", opts(type=ftype.INT, min=-100, max=100))
    vc = np.unique(rng.integers(0, NCOLS, 3000))
    v.import_values(vc, rng.integers(-100, 101, size=vc.size))
    t = idx.create_field("tq", opts(type=ftype.TIME, time_quantum=tq("YMD")))
    for i, c in enumerate(rng.integers(0, NCOLS, 200).tolist()):
        t.set_bit(i % 3, c, timestamp=dt.datetime(2024, 1 + i % 4, 1 + i % 9))
    idx.create_field("g1").import_bits(rng.integers(0, 3, NCOLS), cols)
    idx.create_field("g2").import_bits(rng.integers(0, 4, NCOLS), cols)
    idx.mark_columns_exist(cols)
    return h


def _pair():
    return (_build(JaxHolder(width=WIDTH), JaxFieldOptions, JaxFieldType,
                   JaxTimeQuantum),
            _build(Holder(width=WIDTH), FieldOptions, FieldType, TimeQuantum))


def _norm(results):
    out = []
    for r in results:
        if dataclasses.is_dataclass(r):
            out.append(dataclasses.asdict(r))
        elif hasattr(r, "segments"):
            out.append(r.columns().tolist())
        elif isinstance(r, list) and r and dataclasses.is_dataclass(r[0]):
            out.append([dataclasses.asdict(p) for p in r])
        else:
            out.append(r)
    return out


READS = [
    "Count(Row(s=1))", "Count(Intersect(Row(s=1), Row(m=2)))",
    "Count(Union(Row(s=0), Row(s=3)))", "Row(s=3)", "Count(Not(Row(s=2)))",
    "TopN(s, n=4)", "TopN(s, Row(m=1), n=4)", "Sum(field=v)",
    "Sum(Row(s=2), field=v)", "Count(Row(v > 10))", "Min(field=v)",
    "Max(Row(m=3), field=v)",
    "GroupBy(Rows(g1), Rows(g2), aggregate=Sum(field=v))",
    "GroupBy(Rows(s), Rows(m))",
    "Count(Row(tq=1, from='2024-02-01', to='2024-04-01'))",
    "Count(Row(st=1))", "Rows(s)",
]


def _write(rng, made: set) -> str:
    """One seeded write."""
    col = int(rng.integers(0, NCOLS + WIDTH // 2))   # some past the data
    op = int(rng.integers(0, 12))
    r = int(rng.integers(0, 4))
    if op == 0:
        return f"Set({col}, s={r})"
    if op == 1:
        return f"Clear({col}, s={r})"
    if op == 2:
        return f"Set({col}, m={r})"
    if op == 3:
        return f"Set({col}, v={int(rng.integers(-100, 101))})"
    if op == 4:
        return f"Clear({col}, v=0)"
    if op == 5:
        return f"Set({col}, tq={r % 3}, 2024-0{1 + r}-0{2 + r}T00:00)"
    if op == 6:
        return f"Set({col}, g1={r % 3})"
    if op == 7:
        made.add("st")
        return "Store(Intersect(Row(s=1), Row(m=2)), st=1)"
    if op == 8:
        return f"Store(Row(s={r}), s=5)"
    if op == 9:
        return f"ClearRow(s={r})"
    if op == 10:
        cs = sorted(set(rng.integers(0, NCOLS, 6).tolist()))
        return f"Delete(ConstRow(columns={cs}))"
    return "Delete(Intersect(Row(s=3), Row(m=1)))"


@pytest.mark.parametrize("engine", ["stacked", "per_shard"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_write_interleavings_match_jax(seed, engine):
    """A long-lived executor of each package (the JAX one on its default
    engine) takes the same seeded writes between reads; every answer is
    equal after every step, and the port's caches patched."""
    jh, ph = _pair()
    jex = JaxExecutor(jh)
    ex = Executor(ph, device="cpu")
    ex.use_stacked = engine == "stacked"
    rng = np.random.default_rng(100 + seed)
    made: set = set()
    reads = [q for q in READS if "st=" not in q]
    for q in reads:
        ex.execute("w", q)
    for step in range(24):
        w = _write(rng, made)
        assert _norm(ex.execute("w", w)) == _norm(jex.execute("w", w)), w
        for q in reads + (["Count(Row(st=1))"] if made else []):
            assert _norm(ex.execute("w", q)) == _norm(jex.execute("w", q)), \
                (step, w, q)
    cache = ex.stacked.cache if engine == "stacked" else ex.tiles.cache
    assert cache.patches > 0, cache.counters()


# -- patched stacks against cold builds ---------------------------------------

def _stacks(ex, idx):
    eng = ex.stacked
    f, v = idx.field("s"), idx.field("v")
    g1, g2 = idx.field("g1"), idx.field("g2")
    out = {
        "row0": eng.row_stack(idx, f, (VIEW_STANDARD,), 0, SHARDS),
        "row3": eng.row_stack(idx, f, (VIEW_STANDARD,), 3, SHARDS),
        "planes": eng.plane_stack(idx, v, SHARDS),
        "rows": eng.rows_stack_for(idx, f, (VIEW_STANDARD,), [0, 1, 2, 3],
                                   SHARDS),
        "gc": eng.groupcode_stack(idx, [(g1, [0, 1, 2]), (g2, [0, 1, 2, 3])],
                                  SHARDS),
    }
    tiles = ex.tiles
    for shard in (0, 2):
        out[f"tile{shard}"] = tiles.row(f.views[VIEW_STANDARD]
                                        .fragment(shard), 1)
        out[f"planes{shard}"] = tiles.planes(v.views[v.bsi_view]
                                             .fragment(shard), v.bit_depth)
    return {k: bm.to_numpy(t).copy() for k, t in out.items()}


def _mutate(rng, idx):
    """One random mutation through the models API."""
    f, v, g1 = idx.field("s"), idx.field("v"), idx.field("g1")
    op = int(rng.integers(0, 9))
    col = int(rng.integers(0, NCOLS))
    if op == 0:
        f.set_bit(int(rng.integers(0, 4)), col)
    elif op == 1:
        f.clear_bit(int(rng.integers(0, 4)), col)
    elif op == 2:
        n = int(rng.integers(1, 50))
        f.import_bits(rng.integers(0, 4, n), rng.integers(0, NCOLS, n))
    elif op == 3:
        cols = np.unique(rng.integers(0, NCOLS, int(rng.integers(1, 30))))
        v.import_values(cols, rng.integers(-100, 101, cols.size))
    elif op == 4:
        g1.set_bit(int(rng.integers(0, 3)), col)
    elif op == 5:
        v.clear_value(col)
    elif op == 6:
        n = int(rng.integers(1, 20))
        f.import_bits(rng.integers(0, 4, n), rng.integers(0, NCOLS, n),
                      clear=True)
    elif op == 7:
        frag = f.views[VIEW_STANDARD].fragment(col // WIDTH)
        frag.clear_columns(bm.from_columns(rng.integers(0, WIDTH, 3), WIDTH))
    else:
        v.import_values(rng.integers(0, NCOLS, 5), None, clear=True)


def test_patched_stacks_equal_cold_builds():
    """Rows, row, plane and group-code stacks and the per-shard engine's
    row and plane tiles, patched across random mutations, equal what a
    fresh executor builds, bit for bit; point writes move far fewer
    bytes than the builds."""
    ph = _pair()[1]
    idx = ph.index("w")
    ex = Executor(ph, device="cpu")
    _stacks(ex, idx)
    rng = np.random.default_rng(9)
    for step in range(25):
        for _ in range(int(rng.integers(1, 4))):
            _mutate(rng, idx)
        got = _stacks(ex, idx)
        want = _stacks(Executor(ph, device="cpu"), idx)
        for name in want:
            assert np.array_equal(got[name], want[name]), (step, name)
    for cache in (ex.stacked.cache, ex.tiles.cache):
        assert cache.patches > 0
        # bulk imports dirty most of a 64-word tile: those rebuild
        assert set(cache.rebuilds) <= {"cold", "dirty_frac"}, \
            cache.counters()
        assert cache.patched_bytes < cache.rebuilt_bytes


def test_point_writes_patch_and_never_rebuild():
    """After warm queries, point writes through execute patch every stack
    and tile they touch, on both engines: no build of any kind."""
    ph = _pair()[1]
    ex = Executor(ph, device="cpu")
    lp = Executor(ph, device="cpu")
    lp.use_stacked = False
    for e in (ex, lp):
        for q in READS[:13]:
            e.execute("w", q)
    before = {id(c): c.counters() for c in (ex.stacked.cache, lp.tiles.cache)}
    for w in ["Set(5, s=1)", "Clear(4100, s=0)", "Set(77, v=-42)",
              "Set(6000, m=3)", "Clear(91, v=0)", "Set(3000, g2=1)"]:
        ex.execute("w", w)
        for e in (ex, lp):
            for q in READS[:13]:
                e.execute("w", q)
    for cache in (ex.stacked.cache, lp.tiles.cache):
        was, now = before[id(cache)], cache.counters()
        assert now["full_rebuilds"] == was["full_rebuilds"], now
        assert now["patches"] > was["patches"]
        # a written fragment's other rows keep their tiles
        assert now["adopts"] > was["adopts"]
        # a point write's runs are one-word runs
        assert now["patched_bytes"] - was["patched_bytes"] < 4096


def _warm(ph):
    ex = Executor(ph, device="cpu")
    idx = ph.index("w")
    return ex, idx, _stacks(ex, idx)


def test_delta_log_overflow_rebuilds(monkeypatch):
    """Past the delta-log window the log cannot prove coverage: the
    stacks rebuild (reason "coverage"), still bit-exact."""
    monkeypatch.setattr(fragmod, "DELTA_LOG_MAX", 3)
    ph = _pair()[1]
    ex, idx, _ = _warm(ph)
    rng = np.random.default_rng(4)
    frag = idx.field("s").views[VIEW_STANDARD].fragment(0)
    for c in range(8):
        frag.set_bit(1, 1000 + c)
    for _ in range(30):
        _mutate(rng, idx)
    got = _stacks(ex, idx)
    want = _stacks(Executor(ph, device="cpu"), idx)
    for name in want:
        assert np.array_equal(got[name], want[name]), name
    assert ex.stacked.cache.rebuilds["coverage"] > 0
    assert frag.deltas_since(0) is None


def test_gen_bump_rebuilds():
    """A retired fragment (bump_gen) never serves its old stamp: the
    stacked engine rebuilds (reason "gen"), the tile cache, keyed by
    gen, builds anew; both bit-exact."""
    ph = _pair()[1]
    ex, idx, _ = _warm(ph)
    frag = idx.field("s").views[VIEW_STANDARD].fragment(0)
    frag.set_bit(1, 7)
    frag.bump_gen()
    tiles_before = ex.tiles.cache.rebuilds["cold"]
    got = _stacks(ex, idx)
    want = _stacks(Executor(ph, device="cpu"), idx)
    for name in want:
        assert np.array_equal(got[name], want[name]), name
    assert ex.stacked.cache.rebuilds["gen"] > 0
    assert ex.tiles.cache.rebuilds["cold"] > tiles_before


def test_near_total_patch_rebuilds():
    """ClearRow empties a row in every shard: the one-row stack, every
    word dirty, rebuilds (reason "dirty_frac"); the four-row stack, a
    quarter dirty, is patched."""
    ph = _pair()[1]
    ex = Executor(ph, device="cpu")
    ex.execute("w", "Count(Row(s=2))TopN(s, Row(m=1), n=4)")
    before = ex.stacked.cache.counters()
    ex.execute("w", "ClearRow(s=2)")
    ex.execute("w", "Set(3, s=2)")          # row 2 stays a candidate
    assert _norm(ex.execute("w", "Count(Row(s=2))TopN(s, Row(m=1), n=4)")) \
        == _norm(JaxExecutor(_pair()[0]).execute(
            "w", "ClearRow(s=2)Set(3, s=2)Count(Row(s=2))"
                 "TopN(s, Row(m=1), n=4)"))[2:]
    now = ex.stacked.cache.counters()
    assert now["rebuilds"].get("dirty_frac", 0) == 1, now
    assert now["patches"] > before["patches"]


def test_failed_patch_propagates(monkeypatch):
    """A patch whose scatter raises propagates to the caller: no silent
    rebuild, and the stale entry leaves the cache (nothing half-patched
    can be served); the next query builds it anew."""
    ph = _pair()[1]
    ex = Executor(ph, device="cpu")
    ex.execute("w", "Count(Row(s=1))")
    ex.execute("w", "Set(9, s=1)")

    def broken(*args, **kwargs):
        raise RuntimeError("scatter launch failed")

    monkeypatch.setattr(bm, "patch_rows", broken)
    before = ex.stacked.cache.counters()
    with pytest.raises(RuntimeError, match="scatter launch failed"):
        ex.execute("w", "Count(Row(s=1))")
    assert ex.stacked.cache.counters()["full_rebuilds"] == \
        before["full_rebuilds"]
    monkeypatch.undo()
    want = JaxExecutor(_pair()[0]).execute("w", "Set(9, s=1)Count(Row(s=1))")
    assert ex.execute("w", "Count(Row(s=1))") == want[1:]
    assert ex.stacked.cache.rebuilds["cold"] == before["rebuilds"]["cold"] + 1


# -- patch_rows and the delta log against the JAX package -----------------------

@pytest.mark.parametrize("plen", [1, 2, 8, 64])
def test_patch_rows_match_jax(plen):
    rng = np.random.default_rng(plen)
    stack = rng.integers(0, 1 << 32, size=(12, 64), dtype=np.uint32)
    n = 9
    idxs = rng.choice(12, size=n, replace=False)
    starts = rng.integers(0, 64 - plen + 1, size=n)
    data = rng.integers(0, 1 << 32, size=(n, plen), dtype=np.uint32)
    want = np.asarray(jax_bm.patch_rows(jnp.asarray(stack), jnp.asarray(idxs),
                                        jnp.asarray(starts),
                                        jnp.asarray(data)))
    assert np.array_equal(bm.patch_rows_np(stack, idxs, starts, data), want)
    t = bm.to_tensor(stack, "cpu")
    out = bm.patch_rows(t, idxs, starts, data)
    assert out is t
    assert np.array_equal(bm.to_numpy(t), want)


def test_patch_rows_refuses_runs_outside_a_lane():
    t = torch.zeros((3, 16), dtype=torch.int32)
    with pytest.raises(ValueError):
        bm.patch_rows(t, [0], [12], np.ones((1, 8), np.uint32))
    with pytest.raises(ValueError):
        bm.patch_rows(t, [3], [0], np.ones((1, 8), np.uint32))
    with pytest.raises(ValueError):
        bm.patch_rows(t.t(), [0], [0], np.ones((1, 1), np.uint32))


def test_delta_spans_match_jax():
    """The same mutations log the same (row, word_lo, word_hi) spans in
    both packages' fragments (their versions count differently: the
    JAX fragment bumps twice a mutation)."""
    rng = np.random.default_rng(12)
    frags = (Fragment("i", "f", "standard", 0, WIDTH),
             JaxFragment("i", "f", "standard", 0, WIDTH))
    marks = [[], []]
    for step in range(60):
        op = int(rng.integers(0, 7))
        col = int(rng.integers(0, WIDTH))
        rows = rng.integers(0, 5, size=int(rng.integers(1, 40)))
        cols = rng.integers(0, WIDTH, size=rows.size)
        ucols = np.unique(cols)
        vals = rng.integers(-7, 8, size=ucols.size)
        for k, fr in enumerate(frags):
            if op == 0:
                fr.set_bit(int(rows[0]), col)
            elif op == 1:
                fr.clear_bit(int(rows[0]), col)
            elif op == 2:
                fr.import_bits(rows, cols)
            elif op == 3:
                fr.import_bits(rows, cols, clear=True)
            elif op == 4:
                fr.set_row_words(int(rows[0]), bm.from_columns(cols, WIDTH))
            elif op == 5:
                fr.clear_columns(bm.from_columns(cols[:3], WIDTH))
            else:
                fr.import_values(ucols, vals, 4)
            marks[k].append(fr.version)
        if step % 13 == 0:
            for a, b in zip(marks[0], marks[1]):
                assert frags[0].deltas_since(a) == frags[1].deltas_since(b)
    assert frags[0].deltas_since(0) == frags[1].deltas_since(0)


def test_disjointness_rechecked_after_writes():
    """The one-pass GroupBy's gate: after writes only the written
    fragments are checked again (none while an unwritten one already
    overlaps), and the answer always equals a fresh engine's."""
    ph = _pair()[1]
    idx = ph.index("w")
    g1 = idx.field("g1")
    eng = Executor(ph, device="cpu").stacked

    def check(want):
        fresh = Executor(ph, device="cpu").stacked
        assert eng._rows_disjoint(idx, g1, [0, 1, 2], SHARDS) is want
        assert fresh._rows_disjoint(idx, g1, [0, 1, 2], SHARDS) is want

    def row_of(col):
        fr = g1.views[VIEW_STANDARD].fragment(col // WIDTH)
        return next(r for r in range(3)
                    if fr.row_words(r)[(col % WIDTH) >> 5]
                    >> ((col % WIDTH) & 31) & 1)

    check(True)
    r0 = row_of(5)
    g1.set_bit((r0 + 1) % 3, 5)                  # shard 0 overlaps
    check(False)
    r3 = row_of(3 * WIDTH + 9)
    g1.set_bit((r3 + 1) % 3, 3 * WIDTH + 9)      # shard 3 too, not checked
    check(False)
    g1.clear_bit((r0 + 1) % 3, 5)                # shard 3 still overlaps
    check(False)
    g1.clear_bit((r3 + 1) % 3, 3 * WIDTH + 9)
    check(True)
