"""The port's mesh (pilosa_tpu_torch/parallel, the stacked engine's mesh
arm ``Executor.set_mesh``) against the JAX package's mesh and the port's
single-device answers.

The JAX package runs its mesh on the suite's 8 forced host devices
(tests/conftest.py); the port runs ``make_mesh(n, rows, devices=[cpu] *
n)``, n slots sharing the CPU.  Covered: tests/test_parallel.py's cases
(short and empty slot slices, the dist reductions, top-k ties, the 2-D
rows axis), tests/test_stacked.py's corpus at 1, 2 and 8 slots and rows
1 and 2, the GroupBy mesh arms of tests/test_kernels.py (2x4, one-pass
and per-combo, signed, Min/Max), nested Distinct, the wrapper calls a
slot makes (a one-slot mesh calls exactly what the single-device path
calls), and two cluster nodes with a 4-slot mesh each.  Exact."""

import jax
import numpy as np
import pytest
import torch

from pilosa_tpu.cluster import ClusterNode as JaxNode
from pilosa_tpu.cluster import InMemDisCo as JaxDisCo
from pilosa_tpu.executor.executor import Executor as JaxExecutor
from pilosa_tpu.models.holder import Holder as JaxHolder
from pilosa_tpu.models.schema import FieldOptions as JaxFieldOptions
from pilosa_tpu.models.schema import FieldType as JaxFieldType
from pilosa_tpu.parallel import dist_bsi_sum_counts as jdist_bsi
from pilosa_tpu.parallel import dist_count as jdist_count
from pilosa_tpu.parallel import dist_count_intersect as jdist_inter
from pilosa_tpu.parallel import dist_topk_counts as jdist_topk
from pilosa_tpu.parallel import host_bsi_sum as jhost_bsi_sum
from pilosa_tpu.parallel import host_count as jhost_count
from pilosa_tpu.parallel import make_mesh as jmake_mesh
from pilosa_tpu.parallel import place_shards as jplace_shards
from pilosa_tpu_torch.cluster import ClusterNode, InMemDisCo
from pilosa_tpu_torch.executor.executor import Executor
from pilosa_tpu_torch.memory import encode
from pilosa_tpu_torch.models.holder import Holder
from pilosa_tpu_torch.models.schema import FieldOptions, FieldType
from pilosa_tpu_torch.ops import kernels as K
from pilosa_tpu_torch.parallel import (
    dist_bsi_sum_counts,
    dist_count,
    dist_count_intersect,
    dist_topk_counts,
    host_bsi_sum,
    host_count,
    make_mesh,
    place_flat,
    place_shards,
)
from pilosa_tpu_torch.parallel.mesh import slices

torch.set_num_threads(1)

WORDS = 128
CPU = torch.device("cpu")


def cpu_mesh(n: int, rows: int = 1):
    return make_mesh(n, rows=rows, devices=[CPU] * n)


def norm(results):
    out = []
    for r in results:
        if hasattr(r, "columns") and callable(r.columns):
            out.append(r.columns().tolist())
        elif isinstance(r, list) and r and hasattr(r[0], "group"):
            out.append([(tuple((g["field"], g["row_id"]) for g in gc.group),
                         gc.count, gc.agg, gc.agg_count) for gc in r])
        elif isinstance(r, list) and r and hasattr(r[0], "count"):
            out.append([(p.id, p.count) for p in r])
        elif hasattr(r, "id") and hasattr(r, "count"):
            out.append((r.id, r.count))
        elif hasattr(r, "values") and not callable(r.values):
            out.append(list(r.values))
        elif hasattr(r, "value"):
            out.append((r.value, r.count))
        else:
            out.append(r)
    return out


# ---------------------------------------------------------------------------
# tests/test_parallel.py's cases
# ---------------------------------------------------------------------------

def test_mesh_of_cpu_slots():
    m = cpu_mesh(8, rows=2)
    assert m.shape == {"rows": 2, "shards": 4} and m.size == 8
    assert all(d == CPU for d in m.flat) and m.lead == CPU
    assert len(jax.devices()) == 8
    with pytest.raises(ValueError):
        cpu_mesh(6, rows=4)
    with pytest.raises(ValueError):
        make_mesh(9, devices=[CPU] * 8)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh(2)


def test_slices_are_contiguous_and_short_at_the_end():
    assert slices(5, 8) == [(0, 1), (1, 2), (2, 3), (3, 4), (4, 5),
                            (5, 5), (5, 5), (5, 5)]
    assert slices(13, 4) == [(0, 4), (4, 8), (8, 12), (12, 13)]
    assert slices(0, 3) == [(0, 0)] * 3


def test_place_shards_short_slices():
    """5 shards on 8 slots: the JAX package pads to 8 zero tiles; the
    port gives the last slots empty slices; the totals are the same."""
    tiles = np.full((5, WORDS), 0xFFFFFFFF, dtype=np.uint32)
    g = place_shards(cpu_mesh(8), tiles)
    assert [t.shape[0] for t in g] == [1, 1, 1, 1, 1, 0, 0, 0]
    assert host_count(dist_count(g)) == 5 * WORDS * 32
    jg = jplace_shards(jmake_mesh(8), tiles)
    assert jg.shape == (8, WORDS)
    assert jhost_count(jdist_count(jg)) == host_count(dist_count(g))
    assert dist_count(g).tolist() == [WORDS * 32] * 5


def test_dist_count_intersect(rng):
    a = rng.integers(0, 2**32, size=(13, WORDS), dtype=np.uint32)
    b = rng.integers(0, 2**32, size=(13, WORDS), dtype=np.uint32)
    m = cpu_mesh(8)
    got = dist_count_intersect(place_shards(m, a), place_shards(m, b))
    want = np.bitwise_count(a & b).sum(axis=1)
    assert got.tolist() == want.tolist()
    jm = jmake_mesh(8)
    jgot = jdist_inter(jplace_shards(jm, a), jplace_shards(jm, b))
    assert host_count(got) == jhost_count(jgot) == int(want.sum())


def test_dist_bsi_sum(rng):
    S, depth = 11, 5
    planes = rng.integers(0, 2**32, size=(S, 2 + depth, WORDS),
                          dtype=np.uint32)
    filt = rng.integers(0, 2**32, size=(S, WORDS), dtype=np.uint32)
    m = cpu_mesh(8)
    total, cnt = host_bsi_sum(*dist_bsi_sum_counts(
        place_shards(m, planes, batch_axes=1), place_shards(m, filt)))
    jm = jmake_mesh(8)
    jtotal, jcnt = jhost_bsi_sum(*jdist_bsi(
        jplace_shards(jm, planes, batch_axes=1), jplace_shards(jm, filt)))
    consider = planes[:, 0] & filt
    p = planes[:, 1]
    expect = 0
    for i in range(depth):
        mm = planes[:, 2 + i]
        expect += int(np.bitwise_count(mm & consider & ~p).sum()) << i
        expect -= int(np.bitwise_count(mm & consider & p).sum()) << i
    assert (total, cnt) == (jtotal, jcnt) == (
        expect, int(np.bitwise_count(consider).sum()))


@pytest.mark.parametrize("k", [1, 3, 7])
def test_dist_topk_ties_take_the_lower_index(rng, k):
    """Rows 2, 5 and 9 are copies of row 0 and row 7 of row 4: their
    counts tie, and both packages order ties by index."""
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P
    R, S = 12, 8
    rows = rng.integers(0, 2**32, size=(R, S, WORDS), dtype=np.uint32)
    rows[2] = rows[5] = rows[9] = rows[0]
    rows[7] = rows[4]
    filt = rng.integers(0, 2**32, size=(S, WORDS), dtype=np.uint32)
    m = cpu_mesh(8)
    vals, idx = dist_topk_counts(place_flat(m, rows, shard_axis=1),
                                 place_shards(m, filt), k)
    jm = jmake_mesh(8)
    jv, ji = jdist_topk(
        jax.device_put(rows, NamedSharding(jm, P(None, "shards", None))),
        jplace_shards(jm, filt), k)
    expect = np.bitwise_count(rows & filt[None]).sum(axis=(1, 2))
    order = np.argsort(-expect, kind="stable")[:k]
    assert idx.tolist() == np.asarray(ji).tolist() == order.tolist()
    assert vals.tolist() == np.asarray(jv).tolist() == \
        expect[order].tolist()


def _two_field_holder(pkg_holder, rng):
    h = pkg_holder(width=2048)
    idx = h.create_index("i")
    f = idx.create_field("f")
    g = idx.create_field("g")
    n = 600
    cols = rng.integers(0, 13 * 2048, size=n)
    f.import_bits(rng.integers(0, 7, size=n), cols)
    g.import_bits(rng.integers(0, 3, size=n),
                  rng.integers(0, 13 * 2048, size=n))
    idx.mark_columns_exist(cols.tolist())
    return h


@pytest.mark.parametrize("q", [
    "TopN(f, n=5)", "TopN(f, Row(g=1), n=5)", "GroupBy(Rows(f), Rows(g))",
    "MinRow(field=f)", "Count(Intersect(Row(f=1), Row(g=2)))"])
def test_2d_mesh_rows_axis(q):
    """A (2, 4) mesh splits TopN's candidate rows over "rows" (7 rows:
    4 and 3) and the shards over "shards"; answers equal the per-shard
    engine's and the JAX (2, 4) mesh's."""
    h = _two_field_holder(Holder, np.random.default_rng(5))
    jh = _two_field_holder(JaxHolder, np.random.default_rng(5))
    ex2d = Executor(h, device="cpu")
    ex2d.set_mesh(cpu_mesh(8, rows=2))
    loop = Executor(h, device="cpu")
    loop.use_stacked = False
    jex = JaxExecutor(jh)
    jex.set_mesh(jmake_mesh(8, rows=2))
    got = norm(ex2d.execute("i", q))
    assert got == norm(loop.execute("i", q))
    assert got == norm(jex.execute("i", q))


# ---------------------------------------------------------------------------
# tests/test_stacked.py's corpus on Executor.set_mesh
# ---------------------------------------------------------------------------

STACKED_QUERIES = [
    'Count(Row(f=1))',
    'Count(Intersect(Row(f=1), Row(g=2)))',
    'Count(Union(Row(f=0), Row(g=1), Row(f=3)))',
    'Count(Difference(Row(f=1), Row(g=1)))',
    'Count(Xor(Row(f=2), Row(g=2)))',
    'Count(Not(Row(f=1)))',
    'Count(All())',
    'Row(b > 100)',
    'Row(b < -250)',
    'Row(-100 < b < 100)',
    'Row(b == 42)',
    'Row(b != null)',
    'Count(Intersect(Row(f=1), Row(b >= 0)))',
    'Intersect(Row(f=1), Not(Row(g=3)))',
    'Union(Row(f=0), Shift(Row(f=0), n=3))',
    'Sum(field=b)',
    'Sum(Row(f=1), field=b)',
    'TopN(f, n=3)',
    'TopN(f, Row(g=1), n=3)',
    'GroupBy(Rows(f), Rows(g), aggregate=Sum(field=b))',
    'Min(field=b)',
    'Max(Row(f=2), field=b)',
    'Distinct(Row(g=4), field=b)',
    'Count(Intersect(Row(f=1), Distinct(field=g)))',
]


def _stacked_holder(holder_cls, opts, ftype):
    """tests/test_stacked.py's holder (13 shards of width 2048)."""
    rng = np.random.default_rng(0x5EED)
    h = holder_cls(width=2048)
    idx = h.create_index("i")
    f = idx.create_field("f")
    g = idx.create_field("g")
    b = idx.create_field("b", opts(type=ftype.INT, min=-500, max=500))
    n_shards = 13
    cols = rng.integers(0, 2048 * n_shards, size=4000)
    f.import_bits(rng.integers(0, 6, size=4000), cols)
    g.import_bits(rng.integers(0, 6, size=4000),
                  rng.integers(0, 2048 * n_shards, size=4000))
    vcols = np.unique(rng.integers(0, 2048 * n_shards, size=3000))
    b.import_values(vcols, rng.integers(-500, 500, size=vcols.size))
    idx.mark_columns_exist(list(cols))
    return h


@pytest.fixture(scope="module")
def stacked_holders():
    return (_stacked_holder(JaxHolder, JaxFieldOptions, JaxFieldType),
            _stacked_holder(Holder, FieldOptions, FieldType))


MESHES = [(1, 1), (2, 1), (2, 2), (8, 1), (8, 2)]


@pytest.mark.parametrize("n,rows", MESHES, ids=[f"{n}x{r}" for n, r in
                                                MESHES])
def test_stacked_corpus_on_the_mesh(stacked_holders, n, rows):
    """Every query of the corpus on the port's (rows, n/rows) mesh equals
    the port's single-device answer and the JAX mesh executor's."""
    jh, ph = stacked_holders
    single = Executor(ph, device="cpu")
    ex = Executor(ph, device="cpu")
    ex.set_mesh(cpu_mesh(n, rows))
    jex = JaxExecutor(jh)
    jex.set_mesh(jmake_mesh(n, rows=rows))
    for q in STACKED_QUERIES:
        got = norm(ex.execute("i", q))
        assert got == norm(single.execute("i", q)), q
        assert got == norm(jex.execute("i", q)), q
    assert ex.paths == single.paths


def test_write_reaches_every_slot(stacked_holders):
    """A write lands in the slot stacks that hold its shard: the next
    Count sees it on the mesh (no stale slot)."""
    _jh, ph = stacked_holders
    ex = Executor(ph, device="cpu")
    ex.set_mesh(cpu_mesh(4))
    q = "Count(Row(f=1))"
    n0 = ex.execute("i", q)[0]
    col = 12 * 2048 + 2047
    was = ex.execute("i", f"Row(f=1)")[0].columns().tolist()
    assert col not in was
    ex.execute("i", f"Set({col}, f=1)")
    try:
        assert ex.execute("i", q)[0] == n0 + 1
    finally:
        ex.execute("i", f"Clear({col}, f=1)")
    assert ex.execute("i", q)[0] == n0


def test_nested_distinct_on_mesh(stacked_holders):
    """Cross-shard operands (a nested Distinct) enter every slot's tree as
    its slice of the precomputed leaf."""
    jh, ph = stacked_holders
    q = "Count(Intersect(Row(f=1), Distinct(field=g)))"
    ex = Executor(ph, device="cpu")
    ex.set_mesh(cpu_mesh(8))
    loop = Executor(ph, device="cpu")
    loop.use_stacked = False
    jex = JaxExecutor(jh)
    jex.set_mesh(jmake_mesh(8))
    assert ex.execute("i", q) == loop.execute("i", q) == jex.execute("i", q)


# ---------------------------------------------------------------------------
# the GroupBy mesh arms (tests/test_kernels.py's 2x4 cases)
# ---------------------------------------------------------------------------

def _groupby_holder(holder_cls, opts, ftype, overlap: bool):
    """tests/test_kernels.py's engine holder at width 4096: disjoint
    mutex rows g and d (the one-pass arm), or set rows with every tenth
    column in two g rows (the per-combo arm)."""
    rng = np.random.default_rng(17)
    w = 1 << 12
    h = holder_cls(width=w)
    idx = h.create_index("i")
    gtype = ftype.SET if overlap else ftype.MUTEX
    idx.create_field("g", opts(type=gtype))
    idx.create_field("d", opts(type=gtype))
    idx.create_field("flt")
    idx.create_field("v", opts(type=ftype.INT, min=-50, max=50))
    idx.create_field("vu", opts(type=ftype.INT, min=0, max=100))
    cols = list(range(0, 9 * w, 3))
    idx.field("g").import_bits([c % 5 for c in cols], cols)
    idx.field("d").import_bits([(c // 5) % 4 for c in cols], cols)
    idx.field("flt").import_bits([c % 2 for c in cols], cols)
    idx.field("v").import_values(
        cols, [int(v) for v in rng.integers(-50, 50, size=len(cols))])
    idx.field("vu").import_values(
        cols, [int(v) for v in rng.integers(0, 100, size=len(cols))])
    if overlap:
        extra = list(range(0, 9 * w, 10))
        idx.field("g").import_bits([0] * len(extra), extra)
        idx.field("g").import_bits([1] * len(extra), extra)
    idx.mark_columns_exist(cols)
    return h


GROUPBY_QUERIES = [
    "GroupBy(Rows(g), Rows(d))",
    "GroupBy(Rows(g), Rows(d), aggregate=Sum(field=v))",
    "GroupBy(Rows(g), Rows(d), aggregate=Sum(field=vu))",
    "GroupBy(Rows(g), Rows(d), filter=Row(flt=1), aggregate=Sum(field=v))",
    "GroupBy(Rows(g), Rows(d), previous=[2, 1], aggregate=Sum(field=v))",
    "GroupBy(Rows(g), aggregate=Sum(field=v))",
    "GroupBy(Rows(g), Rows(d), aggregate=Min(field=v))",
    "GroupBy(Rows(g), aggregate=Max(field=v))",
    "GroupBy(Rows(d), filter=Row(flt=0), aggregate=Max(field=vu))",
    "Min(field=v)",
    "Max(Row(flt=1), field=v)",
    "Distinct(Row(g=2), field=v)",
]


@pytest.mark.parametrize("overlap", [False, True],
                         ids=["onepass", "per_combo"])
def test_groupby_mesh_arms(overlap, monkeypatch):
    """On a 2x4 mesh: the one-pass arm (disjoint rows: one histogram
    launch a slot, Min/Max tables combined by max/min) and the per-combo
    arm (overlapping rows: one groupby_sum a slot, signed sums) equal
    the port's single device, its per-shard engine and the JAX mesh
    executor with its fused kernels forced on."""
    jh = _groupby_holder(JaxHolder, JaxFieldOptions, JaxFieldType, overlap)
    ph = _groupby_holder(Holder, FieldOptions, FieldType, overlap)
    calls = {"groupby_fused": 0, "groupby_sum": 0}
    for name in calls:
        real = getattr(K, name)

        def wrap(*a, _real=real, _name=name, **kw):
            calls[_name] += 1
            return _real(*a, **kw)
        monkeypatch.setattr(K, name, wrap)
    ex = Executor(ph, device="cpu")
    ex.set_mesh(cpu_mesh(8, rows=2))
    single = Executor(ph, device="cpu")
    loop = Executor(ph, device="cpu")
    loop.use_stacked = False
    monkeypatch.setenv("PILOSA_TPU_GROUPBY_KERNEL", "1")
    jex = JaxExecutor(jh)
    jex.set_mesh(jmake_mesh(8, rows=2))
    for q in GROUPBY_QUERIES:
        before = dict(calls)
        got = norm(ex.execute("i", q))
        mesh_calls = {k: calls[k] - before[k] for k in calls}
        assert got == norm(single.execute("i", q)), q
        assert got == norm(loop.execute("i", q)), q
        if not (overlap and "Min(" in q or overlap and "Max(" in q):
            assert got == norm(jex.execute("i", q)), q
        # 9 shards over 8 slots (2 a slot): the first 5 slots hold shards
        if q.startswith("GroupBy") and ex.paths[("GroupBy", "stacked")]:
            arm = "groupby_sum" if overlap and "Min(" not in q \
                and "Max(" not in q else "groupby_fused"
            if not (overlap and ("Min(" in q or "Max(" in q)):
                assert mesh_calls[arm] == 5, (q, mesh_calls)


# ---------------------------------------------------------------------------
# wrapper calls a slot
# ---------------------------------------------------------------------------

LAUNCH_QUERIES = ["Count(Intersect(Row(f=1), Row(g=2)))", "Count(Row(f=1))",
                  "Sum(Row(f=1), field=b)", "TopN(f, n=3)",
                  "TopN(f, Row(g=1), n=3)", "Count(Row(b > 100))",
                  "GroupBy(Rows(f), Rows(g), aggregate=Sum(field=b))",
                  "Min(field=b)"]
WRAPPERS = ("popcount_rows", "pair_popcount", "rows_filter_counts",
            "bsi_sum_counts", "bsi_range", "groupby_fused", "groupby_sum",
            "assemble_pages")


def _count_calls(monkeypatch):
    calls = dict.fromkeys(WRAPPERS, 0)
    for name in WRAPPERS:
        real = getattr(K, name)

        def wrap(*a, _real=real, _name=name, **kw):
            calls[_name] += 1
            return _real(*a, **kw)
        monkeypatch.setattr(K, name, wrap)
    return calls


def _calls_of(ex, q, calls):
    before = dict(calls)
    out = norm(ex.execute("i", q))
    return out, {k: calls[k] - before[k] for k in calls}


def test_one_slot_mesh_calls_what_one_device_calls(stacked_holders,
                                                   monkeypatch):
    """A one-slot mesh keeps the single-device layout (paged) and calls
    every kernel wrapper exactly as often as the single-device path
    (encoding off: the CPU's packed host arms would call none)."""
    _jh, ph = stacked_holders
    prev = encode.enabled()
    encode.configure(enabled=False)
    try:
        calls = _count_calls(monkeypatch)
        single = Executor(ph, device="cpu")
        ex = Executor(ph, device="cpu")
        ex.set_mesh(cpu_mesh(1))
        total = 0
        for q in LAUNCH_QUERIES:
            want, c1 = _calls_of(single, q, calls)
            got, c2 = _calls_of(ex, q, calls)
            assert got == want and c2 == c1, (q, c1, c2)
            total += sum(c1.values())
        assert total >= len(LAUNCH_QUERIES)
    finally:
        encode.configure(enabled=prev)


@pytest.mark.parametrize("n,rows", [(4, 1), (8, 2)])
def test_each_slot_launches_its_leg(stacked_holders, monkeypatch, n, rows):
    """13 shards over a mesh: every slot with shards calls the kernel
    once a query, whole stacks (no assemble_pages), and TopN's scan one
    call a (row block, shard column) slot."""
    _jh, ph = stacked_holders
    calls = _count_calls(monkeypatch)
    ex = Executor(ph, device="cpu")
    ex.set_mesh(cpu_mesh(n, rows))
    legs = sum(1 for lo, hi in slices(13, n) if hi > lo)
    cols = sum(1 for lo, hi in slices(13, n // rows) if hi > lo)
    expect = {
        "Count(Intersect(Row(f=1), Row(g=2)))": {"pair_popcount": legs},
        "Count(Row(f=1))": {"popcount_rows": legs},
        "Sum(Row(f=1), field=b)": {"bsi_sum_counts": legs},
        "Count(Row(b > 100))": {"bsi_range": legs, "popcount_rows": legs},
        "TopN(f, Row(g=1), n=3)": {"rows_filter_counts": cols * rows},
    }
    for q, want in expect.items():
        _out, got = _calls_of(ex, q, calls)
        assert {k: v for k, v in got.items() if v} == want, (q, got)


# ---------------------------------------------------------------------------
# cluster x mesh (tests/test_cluster.py:356)
# ---------------------------------------------------------------------------

SCHEMA = {"indexes": [{"name": "c", "fields": [
    {"name": "f", "options": {"type": "set"}},
    {"name": "v", "options": {"type": "int", "min": 0, "max": 1000}},
]}]}
SHARD = 2048


def test_cluster_nodes_each_with_a_4_slot_mesh():
    """Two ClusterNodes each run their executor on a 4-slot mesh of their
    own; the HTTP fan-out between nodes and the slot combine inside each
    node answer what the JAX cluster answers, and each node's mesh arm
    really ran."""
    answers = {}
    for pkg in ("port", "jax"):
        if pkg == "port":
            disco = InMemDisCo(lease_ttl=1.0)
            nodes = [ClusterNode(f"m{i}", disco, holder=Holder(width=SHARD),
                                 replica_n=1, heartbeat_interval=0.2,
                                 device="cpu").open() for i in range(2)]
        else:
            disco = JaxDisCo(lease_ttl=1.0)
            nodes = [JaxNode(f"m{i}", disco, holder=JaxHolder(width=SHARD),
                             replica_n=1, heartbeat_interval=0.2).open()
                     for i in range(2)]
        try:
            nodes[0].apply_schema(SCHEMA)
            for i, nd in enumerate(nodes):
                if pkg == "port":
                    nd.api.executor.set_mesh(cpu_mesh(4))
                else:
                    from jax.sharding import Mesh
                    devs = jax.devices()
                    nd.api.executor.set_mesh(
                        Mesh(np.array(devs[4 * i:4 * i + 4]), ("shards",)))
            cols = [k * SHARD + k + 1 for k in range(12)]
            vals = [10 * (k + 1) for k in range(12)]
            nodes[0].import_bits("c", "f", [1] * len(cols), cols)
            nodes[0].import_values("c", "v", cols, vals)
            groups = nodes[0].snapshot().shards_by_node("c", range(12))
            assert sum(1 for g in groups.values() if g) == 2, groups
            got = [nodes[1].query("c", "Count(Row(f=1))")["results"],
                   nodes[0].query("c", "Sum(Row(f=1), field=v)")["results"],
                   nodes[1].query("c", "Row(f=1)")["results"],
                   nodes[0].query("c", "TopN(f)")["results"]]
            assert got[0] == [len(cols)]
            assert got[1][0] == {"value": sum(vals), "count": len(cols)}
            assert got[2][0]["columns"] == sorted(cols)
            answers[pkg] = got
            if pkg == "port":
                for nd in nodes:
                    eng = nd.api.executor.stacked
                    assert eng.mesh is not None and any(
                        s.cache.keys() for s in eng._slots)
        finally:
            for nd in nodes:
                nd.close()
    assert answers["port"] == answers["jax"]
