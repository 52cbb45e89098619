"""The port's RBF store and shard storage against the JAX package's.

The port keeps its own copy of the RBF C++ (``storage/csrc``), built
with g++ into ``build/torch_host/``, and its own bindings
(``storage/rbf.py``, ``shards.py``, ``roaring.py``).  Here the same
seeded operations run through both packages: the container encodings
and the roaring bytes are equal, every store operation (put, get,
remove, the catalog, ranges and iteration, reopen, checkpoint,
rollback, and recovery of a WAL tail that never committed) gives the
same answers, and a shard file written by either package's
``IndexStorage`` reads the same in the other.  Exact throughout."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from pilosa_tpu.models.fragment import Fragment as JaxFragment
from pilosa_tpu.storage import rbf as jax_rbf
from pilosa_tpu.storage import roaring as jax_roaring
from pilosa_tpu.storage import shards as jax_shards
from pilosa_tpu_torch.models.fragment import Fragment
from pilosa_tpu_torch.ops import bitmap as bm
from pilosa_tpu_torch.storage import rbf, roaring, shards

ROOT = Path(__file__).resolve().parents[1]
TW = rbf.TILE_WORDS
MODS = {"port": rbf, "jax": jax_rbf}


@pytest.fixture(autouse=True)
def nosync(monkeypatch):
    monkeypatch.setenv("RBF_NOSYNC", "1")


def tile_from_bits(bits):
    t = np.zeros(TW, dtype=np.uint32)
    for b in bits:
        t[b >> 5] |= np.uint32(1) << np.uint32(b & 31)
    return t


def rand_tile(rng, style):
    if style == "array":
        return tile_from_bits(rng.choice(1 << 16, size=int(rng.integers(1, 100)),
                                         replace=False))
    if style == "runs":
        t = np.zeros(TW, dtype=np.uint32)
        for _ in range(int(rng.integers(1, 5))):
            s = int(rng.integers(0, 60000))
            for b in range(s, min(s + int(rng.integers(1, 5000)), 1 << 16)):
                t[b >> 5] |= np.uint32(1) << np.uint32(b & 31)
        return t
    return rng.integers(0, 1 << 32, size=TW, dtype=np.uint32)


def on_both(tmp_path, run):
    """run(rbf module, file path) in each package; the answers."""
    out = {}
    for name, mod in MODS.items():
        os.makedirs(tmp_path / name)
        out[name] = run(mod, str(tmp_path / name / "t.rbf"))
    assert out["port"] == out["jax"]
    return out["port"]


def _as_key(tile):
    return None if tile is None else tile.tobytes()


# -- container codecs ---------------------------------------------------------


@pytest.mark.parametrize("style", ["array", "runs", "bitmap", "edges"])
def test_container_encoding_bytes_match_jax(style):
    rng = np.random.default_rng(len(style))
    tiles = ([tile_from_bits([65535]), tile_from_bits(range(60, 70)),
              tile_from_bits([1, 500, 65535]), np.zeros(TW, np.uint32),
              np.full(TW, 0xFFFFFFFF, np.uint32)]
             if style == "edges" else [rand_tile(rng, style)
                                       for _ in range(20)])
    for t in tiles:
        enc, payload = rbf.container_encode(t)
        assert (enc, payload) == jax_rbf.container_encode(t)
        if payload:  # an empty tile encodes to nothing: a put removes it
            np.testing.assert_array_equal(rbf.container_decode(enc, payload),
                                          t)
    if style != "edges":
        assert enc == {"array": 1, "runs": 2, "bitmap": 3}[style]


def test_tile_buffers_are_checked():
    with pytest.raises(ValueError, match="uint32"):
        rbf.container_encode(np.zeros(TW, dtype=np.int64))
    with pytest.raises(ValueError, match="uint32"):
        rbf.container_encode(np.zeros(TW + 1, dtype=np.uint32))


# -- the store ----------------------------------------------------------------


def test_put_get_remove_and_catalog(tmp_path):
    def run(mod, p):
        rng = np.random.default_rng(1)
        t1, t2 = rand_tile(rng, "array"), rand_tile(rng, "bitmap")
        got = []
        with mod.DB(p) as db:
            with db.begin(write=True) as tx:
                tx.create_bitmap("f/standard")
                tx.create_bitmap("g/bsig_g")
                tx.put("f/standard", 0, t1)
                tx.put("f/standard", 7, t2)
                tx.put("g/bsig_g", 3, t1)
                tx.put("g/bsig_g", 3, np.zeros(TW, np.uint32))  # removes
                got.append(tx.container_count("g/bsig_g"))
            with db.begin() as tx:
                got += [_as_key(tx.get("f/standard", 0)),
                        _as_key(tx.get("f/standard", 7)),
                        _as_key(tx.get("f/standard", 3)),
                        tx.container_count("f/standard"),
                        tx.count("f/standard"), tx.list_bitmaps(),
                        tx.has_bitmap("nope")]
            with db.begin(write=True) as tx:
                got += [tx.remove("f/standard", 0), tx.remove("f/standard", 99),
                        tx.delete_bitmap("g/bsig_g"),
                        tx.delete_bitmap("g/bsig_g")]
            with db.begin() as tx:
                got += [_as_key(tx.get("f/standard", 0)),
                        tx.container_count("f/standard"), tx.list_bitmaps()]
        return got
    got = on_both(tmp_path, run)
    assert got[-1] == ["f/standard"] and got[4] == 2


def test_get_range_and_items(tmp_path):
    def run(mod, p):
        rng = np.random.default_rng(2)
        tiles = {k: rand_tile(rng, ["array", "runs", "bitmap"][k % 3])
                 for k in [0, 1, 5, 16, 300]}
        with mod.DB(p) as db:
            with db.begin(write=True) as tx:
                tx.create_bitmap("b")
                for k, t in tiles.items():
                    tx.put("b", k, t)
            with db.begin() as tx:
                rng_words = tx.get_range("b", 0, 17).tobytes()
                items = [(k, t.tobytes()) for k, t in tx.items("b")]
        assert items == [(k, t.tobytes()) for k, t in sorted(tiles.items())]
        return rng_words, items
    on_both(tmp_path, run)


def test_seeded_operations_vs_a_dict(tmp_path):
    """Thirty write transactions of seeded puts, removes and gets over
    three bitmaps: the same answers in both packages and in a dict."""
    def run(mod, p):
        rng = np.random.default_rng(42)
        model: dict = {}
        names = ["a", "b", "c/long/name"]
        seen = []
        with mod.DB(p) as db:
            with db.begin(write=True) as tx:
                for n in names:
                    tx.create_bitmap(n)
            for _ in range(30):
                with db.begin(write=True) as tx:
                    for _ in range(20):
                        n = names[int(rng.integers(3))]
                        k = int(rng.integers(0, 50))
                        op = int(rng.integers(3))
                        if op == 0:
                            t = rand_tile(rng, ["array", "runs", "bitmap"][
                                int(rng.integers(3))])
                            tx.put(n, k, t)
                            model[(n, k)] = t.tobytes()
                        elif op == 1:
                            seen.append(tx.remove(n, k))
                            model.pop((n, k), None)
                        else:
                            got = _as_key(tx.get(n, k))
                            assert got == model.get((n, k))
                            seen.append(got)
                with db.begin() as tx:
                    for n in names:
                        keys = [k for k, _ in tx.items(n)]
                        assert keys == sorted(k for (m, k) in model if m == n)
                        seen.append(keys)
        return seen
    on_both(tmp_path, run)


def test_reopen_checkpoint_and_rollback(tmp_path):
    def run(mod, p):
        rng = np.random.default_rng(4)
        tiles = {k: rand_tile(rng, "bitmap") for k in range(20)}
        got = []
        with mod.DB(p) as db:
            with db.begin(write=True) as tx:
                tx.create_bitmap("b")
                for k, t in tiles.items():
                    tx.put("b", k, t)
            got.append(db.wal_size > 0)
            reader = db.begin()
            got.append(db.checkpoint())        # False: a reader pins it
            reader.commit()
            got += [db.checkpoint(), db.wal_size]
            with db.begin(write=True) as tx:   # lands in a fresh WAL
                tx.put("b", 100, tiles[0])
            tx = db.begin(write=True)
            tx.put("b", 101, tiles[1])
            tx.rollback()
        with mod.DB(p) as db, db.begin() as tx:
            got += [tx.container_count("b"), _as_key(tx.get("b", 101)),
                    [t.tobytes() for _, t in tx.items("b")]]
        return got
    got = on_both(tmp_path, run)
    assert got[:4] == [True, False, True, 0] and got[4] == 21


def test_uncommitted_wal_tail_is_dropped(tmp_path):
    """A WAL tail without a commit frame (a crash mid-append) is
    discarded on open, in either package, whichever wrote the file."""
    def run(mod, p):
        with mod.DB(p) as db, db.begin(write=True) as tx:
            tx.create_bitmap("b")
            tx.put("b", 0, tile_from_bits([7]))
        with open(p + ".wal", "ab") as f:
            f.write(b"\x01" + b"\x00" * 7 + b"\xAB" * 5000)
        other = jax_rbf if mod is rbf else rbf
        with other.DB(p) as db, db.begin() as tx:
            return _as_key(tx.get("b", 0)), tx.container_count("b")
    assert on_both(tmp_path, run) == (tile_from_bits([7]).tobytes(), 1)


def test_killed_writer_keeps_the_committed_state(tmp_path):
    """A process killed with a write transaction open: the port reopens
    exactly what committed."""
    p = str(tmp_path / "t.rbf")
    script = f"""
import os, sys
import numpy as np
sys.path.insert(0, {str(ROOT)!r})
from pilosa_tpu_torch.storage.rbf import DB, TILE_WORDS
d = DB({p!r})
with d.begin(write=True) as tx:
    tx.create_bitmap("b")
    for k in range(50):
        t = np.zeros(TILE_WORDS, dtype=np.uint32); t[k] = 1
        tx.put("b", k, t)
print("committed", flush=True)
tx = d.begin(write=True)
for k in range(50, 100):
    t = np.zeros(TILE_WORDS, dtype=np.uint32); t[k] = 1
    tx.put("b", k, t)
os.kill(os.getpid(), 9)
"""
    r = subprocess.run([sys.executable, "-c", script],
                       env=dict(os.environ, RBF_NOSYNC="1"),
                       capture_output=True, text=True, timeout=120)
    assert "committed" in r.stdout, r.stderr
    with rbf.DB(p) as d, d.begin() as tx:
        assert tx.container_count("b") == 50
        want = np.zeros(TW, dtype=np.uint32)
        want[10] = 1
        np.testing.assert_array_equal(tx.get("b", 10), want)


def test_leaf_split_of_mixed_cell_sizes(tmp_path):
    """Array containers of about 2 KB (the largest cells kept inline)
    beside small ones: a split of half the cells by count can leave one
    half over a page, which the JAX package's copy writes past a stack
    buffer.  The port splits where the bytes balance; every container
    reads back, in the port and in the JAX package."""
    rng = np.random.default_rng(13)
    # twenty small containers, then twenty of ~1000 bits, keys ascending:
    # the fourth large one overflows the leaf, and half its cells by
    # count leaves eight small and four large ones, over a page
    tiles = {k: tile_from_bits(rng.choice(
        1 << 16, int(rng.integers(1, 30)) if k < 20 else 1000 + k,
        replace=False)) for k in range(40)}
    p = str(tmp_path / "t.rbf")
    with rbf.DB(p) as db, db.begin(write=True) as tx:
        tx.create_bitmap("v/bsig_v")
        for k, t in tiles.items():
            tx.put("v/bsig_v", k, t)
    for mod in (rbf, jax_rbf):
        with mod.DB(p) as db, db.begin() as tx:
            got = dict(tx.items("v/bsig_v"))
            assert sorted(got) == sorted(tiles)
            for k, t in tiles.items():
                np.testing.assert_array_equal(got[k], t)


def test_single_writer_and_read_only_tx(tmp_path):
    with rbf.DB(str(tmp_path / "t.rbf")) as db:
        tx = db.begin(write=True)
        with pytest.raises(rbf.RBFError):
            db.begin(write=True)
        tx.rollback()
        with db.begin() as rtx, pytest.raises(rbf.RBFError):
            rtx.create_bitmap("b")


# -- shard files across the packages -------------------------------------------


def _fill(frag_cls, width, shard, rng_seed):
    """A set fragment (sparse and dense rows) and a BSI-shaped one."""
    rng = np.random.default_rng(rng_seed)
    f = frag_cls("i", "f", "standard", shard, width)
    f.import_bits(rng.integers(0, 5, size=300), rng.integers(0, width, 300))
    f.import_row_words(9, rng.integers(0, 1 << 32, size=width // 32,
                                       dtype=np.uint32))
    v = frag_cls("i", "v", "bsig_v", shard, width)
    v.import_values(rng.choice(width, 100, replace=False),
                    rng.integers(-500, 500, size=100), 9)
    return [f, v]


@pytest.mark.parametrize("width", [2048, 1 << 17], ids=["under_a_tile",
                                                       "two_tiles"])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_shard_files_read_the_same_in_both(tmp_path, width, writer):
    """Fragments of two shards written by one package's IndexStorage
    (dirty rows, padded to a tile below 65536 columns) load in each
    package's storage as the same rows; a cleared row's containers go,
    and the writer's dirty sets are empty after the write."""
    mine = {"port": (shards.IndexStorage, Fragment),
            "jax": (jax_shards.IndexStorage, JaxFragment)}
    store_cls, frag_cls = mine[writer]
    store = store_cls(str(tmp_path))
    frags = {s: _fill(frag_cls, width, s, s) for s in (0, 3)}
    for s, fs in frags.items():
        for fr in fs:
            fr.dirty_rows = set(fr.row_ids)  # the JAX fragment marks on write
        store.write_fragments(fs)
        assert not any(fr.dirty_rows for fr in fs)
    frags[3][0].set_row_words(9, np.zeros(width // 32, dtype=np.uint32))
    store.write_fragments([frags[3][0]])
    store.close()
    want = {(fr.field_name, fr.view_name, s): {r: fr.row_words(r).tobytes()
                                               for r in fr.row_ids}
            for s, fs in frags.items() for fr in fs}
    for cls in (shards.IndexStorage, jax_shards.IndexStorage):
        reader = cls(str(tmp_path))
        assert sorted(reader.discover()) == sorted(want)
        for (fname, vname, s), rows in want.items():
            got = reader.load_rows(fname, vname, s, width)
            dense = {r: (w if w.dtype == np.uint32 else
                         bm.from_columns(w, width)).tobytes()
                     for r, w in got.items()}
            assert dense == rows, (cls, fname, s)
        reader.close()


def test_storage_deletes_match_jax(tmp_path):
    """delete_field_bitmaps, delete_view_bitmaps and drop_shard leave
    the same bitmaps on disk in both packages."""
    out = {}
    for name, cls, frag_cls in (("port", shards.IndexStorage, Fragment),
                                ("jax", jax_shards.IndexStorage, JaxFragment)):
        store = cls(str(tmp_path / name))
        for s in (0, 1, 2):
            fs = _fill(frag_cls, 2048, s, s)
            t = frag_cls("i", "f", "standard_2024", s, 2048)
            t.set_bit(1, 5)
            for fr in [*fs, t]:
                fr.dirty_rows = set(fr.row_ids)
            store.write_fragments([*fs, t])
        store.delete_view_bitmaps("f", "standard_2024")
        store.delete_field_bitmaps("v")
        store.drop_shard(1)
        store.checkpoint_all()
        out[name] = (sorted(store.discover()), store.shards_on_disk())
        store.destroy()
        assert store.shards_on_disk() == []
    assert out["port"] == out["jax"]
    assert out["port"] == ([("f", "standard", 0), ("f", "standard", 2)],
                           [0, 2])


# -- the official roaring format -------------------------------------------------


@pytest.mark.parametrize("case", ["empty", "array", "bitmap", "keys"])
def test_roaring_bytes_match_jax(case):
    rng = np.random.default_rng(9)
    vals = {"empty": [],
            "array": rng.choice(1 << 16, 300, replace=False),
            "bitmap": rng.choice(1 << 16, 9000, replace=False),
            "keys": np.concatenate([rng.choice(1 << 20, 5000, replace=False),
                                    [0, (1 << 32) - 1]])}[case]
    blob = roaring.encode(vals)
    assert blob == jax_roaring.encode(vals)
    np.testing.assert_array_equal(roaring.decode(blob),
                                  np.unique(np.asarray(vals, np.uint32)))
    np.testing.assert_array_equal(roaring.decode(blob),
                                  jax_roaring.decode(blob))


def test_roaring_run_containers_decode_as_jax():
    """A cookie-12347 buffer with a run container and an array one."""
    import struct
    head = struct.pack("<I", 12347 | (1 << 16))        # two containers
    flags = bytes([0b01])                              # the first is runs
    desc = struct.pack("<HHHH", 0, 99, 3, 1)           # keys, cards - 1
    runs = struct.pack("<HHH", 1, 10, 89)              # 1 run: 10..99
    arr = struct.pack("<HH", 5, 7)
    blob = head + flags + desc + runs + arr
    np.testing.assert_array_equal(roaring.decode(blob),
                                  jax_roaring.decode(blob))
    assert roaring.decode(blob).tolist() == list(range(10, 100)) + \
        [(3 << 16) | 5, (3 << 16) | 7]
    with pytest.raises(roaring.RoaringError):
        roaring.decode(b"\x00\x00")
    with pytest.raises(roaring.RoaringError):
        roaring.encode([1 << 32])
