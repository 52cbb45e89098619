"""The port's sparse page encodings against the JAX package's
(tests/test_sparse_format.py, without its mesh case).

``encode_block`` gives the JAX package's host arrays element for element
(coordinates, run starts and lengths, lane counts, the pow2 padding and
its sentinels).  The plain versions of ``assemble_pages``,
``expand_coords`` / ``expand_runs`` and the ``packed_*`` counts equal the
JAX package's jitted functions across a density sweep.  Through the
engine, a density sweep of queries equals the JAX Executor (paged and
sparse, its defaults); writes to a packed page, an encoding flip and a
retired fragment stay exact; the ledger charges the encoded bytes the
JAX package's ledger charges; the flight record has its page mix and
the stats catalog its per-field encodings.  The JAX package's switch is
its environment variable, the port's ``encode.configure``.  Every
output is an integer: the tolerance is 0 throughout."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from pilosa_tpu.executor.executor import Executor as JaxExecutor
from pilosa_tpu.executor.stacked import TileStackCache
from pilosa_tpu.memory import encode as jax_encode
from pilosa_tpu.memory.ledger import Ledger as JaxLedger
from pilosa_tpu.models.holder import Holder as JaxHolder
from pilosa_tpu.ops import bitmap as jax_bm
from pilosa_tpu_torch.executor.executor import Executor
from pilosa_tpu_torch.executor.stacked import StackCache
from pilosa_tpu_torch.memory import encode
from pilosa_tpu_torch.memory.ledger import Ledger
from pilosa_tpu_torch.models.holder import Holder
from pilosa_tpu_torch.obs import flight, metrics, stats
from pilosa_tpu_torch.ops import bitmap as bm
from pilosa_tpu_torch.ops import kernels

torch.set_num_threads(1)

W = 1 << 15


def _bits_at_density(rng, n_bits: int, density: float) -> np.ndarray:
    n = max(int(n_bits * density), 1)
    return rng.choice(n_bits, size=min(n, n_bits), replace=False)


def _build(holder, density: float, n_shards: int = 4, n_rows: int = 6,
           seed: int = 11):
    h = holder(width=W)
    idx = h.create_index("i")
    f = idx.create_field("f")
    rng = np.random.default_rng(seed)
    rows, cols = [], []
    for r in range(n_rows):
        c = _bits_at_density(rng, n_shards * W, density)
        rows.append(np.full(c.size, r, dtype=np.int64))
        cols.append(c)
    f.import_bits(np.concatenate(rows), np.concatenate(cols))
    return h


_QUERIES = [
    "Count(Row(f=0))",
    "Count(Row(f=3))",
    "Count(Union(Row(f=0), Row(f=1)))",
    "Count(Intersect(Row(f=2), Row(f=3)))",
    "Count(Difference(Row(f=4), Row(f=5)))",
    "Count(Xor(Row(f=1), Row(f=2), Row(f=3)))",
    "Row(f=1)",
    "TopN(f, n=4)",
    "TopN(f, Row(f=0), n=4)",
]


def _norm(results):
    out = []
    for r in results:
        if isinstance(r, list):
            out.append([(p.id, p.count) for p in r])
        elif hasattr(r, "columns"):
            out.append(r.columns().tolist())
        else:
            out.append(r)
    return out


def _run_all(ex) -> list:
    return [_norm(ex.execute("i", q)) for q in _QUERIES]


@pytest.fixture
def sparse_on(monkeypatch):
    """The sparse format on in both packages (their defaults), put back
    after the test."""
    monkeypatch.setenv("PILOSA_TPU_SPARSE_FORMAT", "1")
    prev = encode._ENABLED
    encode.configure(enabled=True)
    yield
    encode._ENABLED = prev


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


# ---------------------------------------------------------------------------
# encode_block: the JAX package's host arrays
# ---------------------------------------------------------------------------

def _blocks():
    rng = np.random.default_rng(3)
    out = {}
    pl, w = 32, 128
    for n in (1, 7, 200, 2000):
        blk = np.zeros((pl, w), np.uint32)
        flat = blk.reshape(-1)
        pos = rng.choice(pl * w * 32, size=n, replace=False)
        np.bitwise_or.at(flat, pos // 32,
                         np.uint32(1) << (pos % 32).astype(np.uint32))
        out[f"packed{n}"] = blk
    blk = np.full((pl, w), 0xFFFFFFFF, np.uint32)
    blk[5, 17] = 0x0000FF00
    blk[20, 100] = 0
    out["run"] = blk
    blk = np.zeros((pl, w), np.uint32)
    blk[3:9] = 0xFFFFFFFF
    blk[12, 5:40] = 0xFFFFFFFF
    blk[30, 7] = 0x80000001
    out["runs_resid"] = blk
    out["dense"] = rng.integers(0, 1 << 32, size=(pl, w), dtype=np.uint32)
    out["empty"] = np.zeros((pl, w), np.uint32)
    blk = np.zeros((16, 64), np.uint32)
    flat = blk.reshape(-1)
    pos = rng.choice(16 * 64 * 32, size=(16 * 64 // 7) * 32 // 6,
                     replace=False)
    flat[pos // 32] |= np.uint32(1) << (pos % 32).astype(np.uint32)
    out["near_threshold"] = blk
    return out


_BLOCKS = _blocks()


@pytest.mark.parametrize("prev_kind,hint", [
    (None, None), ("packed", None), ("dense", 0.5), ("packed", 0.5),
    (None, 0.01)])
@pytest.mark.parametrize("name", sorted(_BLOCKS))
def test_encode_block_equals_jax(name, prev_kind, hint, sparse_on):
    blk = _BLOCKS[name]
    got = encode.encode_block(blk, prev_kind=prev_kind, density_hint=hint)
    want = jax_encode.encode_block(blk, prev_kind=prev_kind,
                                   density_hint=hint)
    assert (got is None) == (want is None)
    if want is None:
        return
    for attr in ("kind", "page_lanes", "width_words", "n_valid", "n_runs",
                 "nbytes"):
        assert getattr(got, attr) == getattr(want, attr), attr
    for attr in ("coords", "run_starts", "run_lens", "lane_counts"):
        g, w = getattr(got, attr), getattr(want, attr)
        if w is None:
            assert g is None
            continue
        assert g.dtype == np.asarray(w).dtype and np.array_equal(g, w), attr
    assert np.array_equal(got.positions(), want.positions())
    got.to_device("cpu")
    assert np.array_equal(bm.to_numpy(got.expand()), blk)
    assert got.bit_count() == int(np.bitwise_count(blk).sum())


def test_encode_switch_and_kinds(sparse_on):
    blk = np.zeros((8, 32), np.uint32)
    blk[0, 0] = 7
    assert encode.encode_block(blk).kind == "packed"
    assert encode.encode_block(_BLOCKS["run"]).kind == "run"
    encode.configure(enabled=False)
    assert not encode.enabled() and encode.encode_block(blk) is None


# ---------------------------------------------------------------------------
# the page ops' plain versions against the JAX package's jitted functions
# ---------------------------------------------------------------------------

def _packed(rng, pl, w, n):
    blk = np.zeros((pl, w), np.uint32)
    flat = blk.reshape(-1)
    pos = np.sort(rng.choice(pl * w * 32, size=n, replace=False))
    np.bitwise_or.at(flat, pos // 32,
                     np.uint32(1) << (pos % 32).astype(np.uint32))
    coords = np.full(jax_encode._pow2(n), pl * w * 32, dtype=np.uint32)
    coords[:n] = pos
    return blk, coords


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


@pytest.mark.parametrize("density", [1e-4, 1e-3, 1e-2, 0.1, 0.5])
def test_page_ops_equal_jax(density):
    rng = np.random.default_rng(int(density * 1e6))
    pl, w = 16, 64
    n = max(1, int(pl * w * 32 * density))
    blk, coords = _packed(rng, pl, w, n)
    total = pl * w * 32
    want = np.asarray(jax_bm.expand_coords(coords, pl, w))
    assert np.array_equal(want, blk)
    assert np.array_equal(_u32(bm.expand_coords(_t(coords), pl, w)), want)
    assert int(bm.packed_count(_t(coords), total)) == \
        int(jax_bm.packed_count(coords, total))
    assert np.array_equal(
        bm.packed_segment_count(_t(coords), w * 32, pl).numpy(),
        np.asarray(jax_bm.packed_segment_count(coords, w * 32, pl)))
    other = rng.integers(0, 1 << 32, size=(pl, w), dtype=np.uint32)
    assert int(bm.packed_intersect_count(_t(coords), _t(other), total)) == \
        int(jax_bm.packed_intersect_count(coords, other.reshape(-1), total))
    # a run page: saturated words with holes at this density
    full = np.where(rng.random((pl, w)) < density, np.uint32(0),
                    np.uint32(0xFFFFFFFF)).astype(np.uint32)
    full[rng.integers(0, pl), rng.integers(0, w)] = 0x12345678
    enc = jax_encode.encode_block(full)
    if enc is not None and enc.kind == "run":
        want = np.asarray(jax_bm.expand_runs(enc.run_starts, enc.run_lens,
                                             enc.coords, pl, w))
        got = bm.expand_runs(_t(enc.run_starts), _t(enc.run_lens),
                             _t(enc.coords), pl, w)
        assert np.array_equal(_u32(got), want)
        assert np.array_equal(want, full)


@pytest.mark.parametrize("lanes", [1, 15, 16, 17, 40, 48])
def test_assemble_pages_equals_jax(lanes):
    """A mix of dense, packed and run pages, the last one padded, held to
    the JAX assemble_pages over the JAX expands."""
    rng = np.random.default_rng(lanes)
    pl, w = 16, 64
    n_pages = -(-lanes // pl)
    full = np.zeros((n_pages * pl, w), np.uint32)
    jax_pages, pages = [], []
    for i in range(n_pages):
        kind = ("dense", "packed", "run")[i % 3]
        if kind == "dense":
            blk = rng.integers(0, 1 << 32, size=(pl, w), dtype=np.uint32)
            jax_pages.append(blk)
            pages.append(_t(blk).reshape(pl, w))
        elif kind == "packed":
            blk, coords = _packed(rng, pl, w, 50)
            jax_pages.append(np.asarray(jax_bm.expand_coords(coords, pl, w)))
            pages.append(bm._Payload("packed", _t(coords)))
        else:
            blk = np.zeros((pl, w), np.uint32)
            blk[2:5] = 0xFFFFFFFF
            blk[9, 3] = 0x00F00F00
            enc = jax_encode.encode_block(blk)
            assert enc.kind == "run"
            jax_pages.append(np.asarray(jax_bm.expand_runs(
                enc.run_starts, enc.run_lens, enc.coords, pl, w)))
            pages.append(bm._Payload("run", _t(enc.coords),
                                     _t(enc.run_starts), _t(enc.run_lens)))
        full[i * pl:(i + 1) * pl] = blk
    shape = (lanes, w)
    want = np.asarray(jax_bm.assemble_pages(tuple(jax_pages), shape))
    assert np.array_equal(want, full[:lanes])
    assert np.array_equal(_u32(bm.assemble_pages(pages, shape, pl)), want)
    assert np.array_equal(
        _u32(kernels.assemble_pages_plain(pages, shape, pl)), want)
    with pytest.raises(ValueError, match="cannot hold"):
        bm.assemble_pages(pages + pages[:1], shape, pl)


_TILE = kernels._PAGE_TILE_WORDS


def _edge_page(rng, kind, pl, w, nv):
    """A (pl, w) block of one kind, its first nv lanes used, with bits and
    runs on the kernel's tile edges and the lanes' edges; returns (host
    block, the port's page, the JAX expansion)."""
    words, bits = pl * w, pl * w * 32
    blk = np.zeros((pl, w), np.uint32)
    flat = blk.reshape(-1)
    used = nv * w
    if kind == "dense":
        flat[:used] = rng.integers(0, 1 << 32, size=used, dtype=np.uint32)
        return blk, _t(blk).reshape(pl, w), blk
    edges = {0, 1, 31, 32, w * 32 - 1, w * 32, used * 32 - 1}
    for t in range(_TILE, used + 1, _TILE):
        edges |= {t * 32 - 1, t * 32, t * 32 + 33}
    pos = np.array(sorted(e for e in edges if 0 <= e < used * 32), np.int64)
    if kind == "packed":
        extra = rng.choice(used * 32, size=min(40, used), replace=False)
        pos = np.unique(np.concatenate([pos, extra]))
        np.bitwise_or.at(flat, pos // 32,
                         np.uint32(1) << (pos % 32).astype(np.uint32))
        coords = np.full(jax_encode._pow2(pos.size), bits, dtype=np.uint32)
        coords[:pos.size] = pos
        return (blk, bm._Payload("packed", _t(coords)),
                np.asarray(jax_bm.expand_coords(coords, pl, w)))
    # runs: ending on a tile edge, starting on one, the last used word,
    # and one word at the lanes' edges; residual bits outside them
    runs = [(2, 5), (used - 1, used)]
    for t in range(_TILE, used, _TILE):
        runs += [(t - 3, t), (t, t + 2)]
    for lo, hi in runs:
        flat[lo:hi] = 0xFFFFFFFF
    full = flat == 0xFFFFFFFF
    resid = pos[~full[pos // 32]]
    np.bitwise_or.at(flat, resid // 32,
                     np.uint32(1) << (resid % 32).astype(np.uint32))
    enc = jax_encode.encode_block(blk)
    assert enc is not None and enc.kind == "run", enc
    return (blk, bm._Payload("run", _t(enc.coords), _t(enc.run_starts),
                             _t(enc.run_lens)),
            np.asarray(jax_bm.expand_runs(enc.run_starts, enc.run_lens,
                                          enc.coords, pl, w)))


@pytest.mark.parametrize("lanes,pl,w", [
    (5, 1, 201), (7, 3, 1001), (9, 4, 8192), (3, 1, 8192), (11, 2, 8192),
    (4, 4, 1)])
def test_assemble_pages_tile_edges_equal_jax(lanes, pl, w):
    """Odd W, one-lane pages, and every kind with bits and runs on the
    kernel's tile edges (a page of 1, 2 or 4 tiles), dense pages between
    encoded ones and the last page padded: the port's plain version
    against the JAX assemble_pages over the JAX expands."""
    rng = np.random.default_rng(lanes * w)
    n_pages = -(-lanes // pl)
    kinds = ("packed", "dense", "run") if w >= 8 else ("dense",)
    full = np.zeros((n_pages * pl, w), np.uint32)
    pages, jax_pages = [], []
    for i in range(n_pages):
        nv = min(pl, lanes - i * pl)
        blk, page, jax_page = _edge_page(rng, kinds[i % len(kinds)], pl, w, nv)
        full[i * pl:(i + 1) * pl] = blk
        pages.append(page)
        jax_pages.append(jax_page)
    shape = (lanes, w)
    want = np.asarray(jax_bm.assemble_pages(tuple(jax_pages), shape))
    assert np.array_equal(want, full[:lanes])
    assert np.array_equal(_u32(kernels.assemble_pages_plain(pages, shape, pl)),
                          want)
    assert np.array_equal(_u32(bm.assemble_pages(pages, shape, pl)), want)


@pytest.mark.parametrize("run_tiles", [None, (1, 1), (5, 3)])
@pytest.mark.parametrize("kinds", [("dense",), ("packed",), ("run",),
                                   ("dense", "packed", "run", "dense")])
@pytest.mark.parametrize("lanes,pl,w", [
    (954, 32, 32768), (7632, 32, 32768), (1, 1, 1), (9, 4, 1), (7, 3, 201),
    (300, 1, 256), (40, 16, 64), (25, 25, 1000), (2000, 32, 4096)])
def test_page_plan_writes_every_word_once(kinds, lanes, pl, w, run_tiles):
    """assemble_pages' grid: its blocks' runs of tiles, in order, cover
    every output word once (a tile of a page covers _TILE of its lanes'
    words, the last one fewer), each run inside one page and no longer
    than its kind's run; by default (page_runs) the runs shorten until
    each kind gives _PAGE_MIN_BLOCKS blocks, and no further."""
    n_pages = -(-lanes // pl)
    n_lanes = np.minimum(pl, lanes - pl * np.arange(n_pages))
    dense = np.array([kinds[i % len(kinds)] == "dense"
                      for i in range(n_pages)])
    plan = kernels.page_plan(n_lanes, dense, w, run_tiles)
    assert plan.dtype == np.int64 and plan.ndim == 2 and plan.shape[1] == 3
    if run_tiles is None:
        tiles = kernels.page_tiles(n_lanes, w)
        run_tiles = kernels.page_runs(tiles, dense)
        for r, most, kind in zip(run_tiles, kernels._PAGE_RUN_TILES,
                                 (dense, ~dense)):
            n = int(tiles[kind].sum())
            assert 1 <= r <= most
            assert r == most or n < (r + 1) * kernels._PAGE_MIN_BLOCKS
    lane0 = np.concatenate(([0], np.cumsum(n_lanes)))
    spans = []
    for p, first, count in plan.tolist():
        run = run_tiles[0] if dense[p] else run_tiles[1]
        assert 1 <= count <= run and first % run == 0
        words = int(n_lanes[p]) * w
        assert (first + count - 1) * _TILE < words   # its last tile too
        spans.append((int(lane0[p]) * w + first * _TILE,
                      int(lane0[p]) * w + min((first + count) * _TILE, words)))
        # a run stops at its page's end, or a whole run short of it
        assert min((first + count) * _TILE, words) == words or count == run
    assert [a for a, _ in spans] == [0] + [e for _, e in spans[:-1]]
    assert spans[-1][1] == lanes * w


def test_page_table_is_none_on_the_cpu():
    pages = [torch.zeros((4, 8), dtype=torch.int32)] * 2
    assert kernels.page_table(pages, (7, 8), 4) is None


# ---------------------------------------------------------------------------
# through the engine, against the JAX Executor
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("density", [1e-5, 1e-4, 1e-3, 1e-2, 0.1, 0.5, 0.9])
def test_density_sweep_equals_jax(density, sparse_on):
    want = _run_all(JaxExecutor(_build(JaxHolder, density)))
    p0 = metrics.STACK_PAGES.value(event="build", encoding="packed")
    ex = Executor(_build(Holder, density), device="cpu")
    assert _run_all(ex) == want
    assert _run_all(ex) == want           # the kept, maybe encoded, pages
    if density <= 1e-3:
        assert metrics.STACK_PAGES.value(event="build",
                                         encoding="packed") > p0
    encode.configure(enabled=False)
    assert _run_all(Executor(_build(Holder, density), device="cpu")) == want


@pytest.mark.parametrize("density", [1e-5, 1e-4, 1e-3, 0.1])
def test_density_sweep_expanded_as_on_the_card(density, sparse_on,
                                               monkeypatch):
    """An engine on the card takes no packed arm: its encoded pages
    expand through assemble_pages and the kernels count them."""
    want = _run_all(JaxExecutor(_build(JaxHolder, density)))
    ex = Executor(_build(Holder, density), device="cpu")
    monkeypatch.setattr(ex.stacked, "sparse_fast", lambda: False)
    calls = []
    real = bm.assemble_pages

    def counted(pages, *a, **k):
        calls.append(sum(encode.is_encoded(p) for p in pages))
        return real(pages, *a, **k)
    monkeypatch.setattr(bm, "assemble_pages", counted)
    assert _run_all(ex) == want
    assert _run_all(ex) == want           # the kept, maybe encoded, pages
    if density <= 1e-3:
        assert sum(calls) > 0


def test_packed_arms_launch_nothing(sparse_on, monkeypatch):
    """Counts and an unfiltered TopN over packed pages are answered from
    what encoding took: no popcount kernel is called."""
    ex = Executor(_build(Holder, 1e-4), device="cpu")
    jex = JaxExecutor(_build(JaxHolder, 1e-4))
    queries = ["Count(Row(f=0))", "Count(Union(Row(f=0), Row(f=1)))",
               "TopN(f, n=4)"]
    want = [_norm(jex.execute("i", q)) for q in queries]
    for q in queries:
        ex.execute("i", q)                 # build the pages

    def refuse(*_a, **_k):
        raise AssertionError("a kernel ran")

    for name in ("popcount_rows", "pair_popcount", "rows_filter_counts"):
        monkeypatch.setattr(kernels, name, refuse)
    assert [_norm(ex.execute("i", q)) for q in queries] == want


def test_write_to_packed_page_rebuilds_and_stays_exact(sparse_on):
    h = _build(Holder, 1e-4)
    jh = _build(JaxHolder, 1e-4)
    ex, jex = Executor(h, device="cpu"), JaxExecutor(jh)
    before = ex.execute("i", "Count(Row(f=0))")[0]
    assert any(encode.is_encoded(p) for e in ex.stacked.cache._entries.values()
               if hasattr(e[1], "pages") for p in e[1].pages)
    e0 = metrics.PAGE_ENCODE.value(**{"from": "packed", "to": "packed",
                                      "reason": "patch"})
    for e in (ex, jex):
        e.execute("i", f"Set({2 * W + 5}, f=0)")
    assert ex.execute("i", "Count(Row(f=0))")[0] == before + 1 == \
        jex.execute("i", "Count(Row(f=0))")[0]
    assert metrics.PAGE_ENCODE.value(**{"from": "packed", "to": "packed",
                                        "reason": "patch"}) > e0
    assert ex.stacked.cache.patches == 1


def test_encode_flip_mid_stream(sparse_on):
    """A packed page filled past the leave bound is encoded dense on its
    next write; the answers stay exact."""
    rng = np.random.default_rng(21)
    h = _build(Holder, 1e-4, n_shards=2)
    jh = _build(JaxHolder, 1e-4, n_shards=2)
    ex = Executor(h, device="cpu")
    ex.execute("i", "Count(Row(f=1))")
    d0 = metrics.PAGE_ENCODE.total(to="dense")
    cols = rng.choice(2 * W, size=W, replace=False)
    for hh in (h, jh):
        hh.index("i").field("f").import_bits(np.ones(cols.size, np.int64),
                                             cols)
    assert ex.execute("i", "Count(Row(f=1))") == \
        JaxExecutor(jh).execute("i", "Count(Row(f=1))")
    assert metrics.PAGE_ENCODE.total(to="dense") > d0


def test_retired_fragment_reencodes(sparse_on):
    h = _build(Holder, 1e-4, n_shards=2)
    jh = _build(JaxHolder, 1e-4, n_shards=2)
    ex = Executor(h, device="cpu")
    ex.execute("i", "Count(Row(f=2))")
    frag = h.index("i").field("f").views["standard"].fragment(0)
    frag.bump_gen()
    cols = np.random.default_rng(33).choice(2 * W, size=64, replace=False)
    for hh in (h, jh):
        hh.index("i").field("f").import_bits(np.full(cols.size, 2, np.int64),
                                             cols)
    assert ex.execute("i", "Count(Row(f=2))") == \
        JaxExecutor(jh).execute("i", "Count(Row(f=2))")
    assert ex.stacked.cache.rebuilds["gen"] == 1


# ---------------------------------------------------------------------------
# accounting and the obs seams
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("query", ["Count(Row(f=0))",
                                   "Count(Intersect(Row(f=2), Row(f=3)))"])
def test_ledger_charges_jax_encoded_bytes(query, sparse_on):
    led = Ledger(budget_bytes=1 << 30)
    ex = Executor(_build(Holder, 1e-4), device="cpu")
    cache = ex.stacked.cache = StackCache(seams=True, ledger=led,
                                          device=ex.device)
    ex.execute("i", query)
    jled = JaxLedger(budget_bytes=1 << 30)
    jex = JaxExecutor(_build(JaxHolder, 1e-4))
    jex.stacked.cache = TileStackCache(ledger=jled)
    jex.execute("i", query)
    assert led.total_bytes == cache.nbytes == jled.total_bytes > 0
    for ent in cache._entries.values():
        ps = ent[1]
        assert ent[2] == ps.resident_bytes() == sum(
            encode.page_nbytes(p) for p in ps.pages)
        assert ps.resident_bytes() < ps.n_pages * ps.page_nbytes


def test_flight_records_page_mix(sparse_on):
    flight.recorder.clear()
    ex = Executor(_build(Holder, 1e-4), device="cpu")
    ex.execute("i", "Count(Union(Row(f=0), Row(f=1)))")
    recs = [r for r in flight.recorder.recent(32)
            if r.get("page_mix", {}).get("packed")]
    assert recs
    assert any(fp for r in recs for fp, outcome in r["stack_keys"]
               if outcome == "rebuild")


def test_stats_encoding_breakdown(sparse_on):
    stats.reset()
    Executor(_build(Holder, 1e-4), device="cpu").execute("i",
                                                         "Count(Row(f=0))")
    fs = stats.get().field_stats("i", "f")
    assert fs is not None and fs["encodings"].get("packed")
    stats.reset()
