"""The port's serving mesh (memory/placement.py, the ragged program's
``ragged_mesh`` run) against solo execution and the JAX serving mesh.

tests/test_multichip.py's cases on the port: the JAX package drives its
mesh on the suite's 8 forced host devices through its env twin
``PILOSA_TPU_MESH_DEVICES``; the port takes ``placement.configure(
mesh_devices=n, devices=[cpu] * 8)``, eight slots sharing the CPU.  Every
answer is exact: ``serialize_result`` of each query equal to a solo
``Executor.execute`` on the same holder and to the JAX serving mesh's,
and the ``ragged_mesh`` dispatch counter must move, so a batch that fell
back to its per-group path cannot pass."""

import gc
import threading

import numpy as np
import pytest
import torch

from pilosa_tpu import memory as jmemory
from pilosa_tpu.api import serialize_result as jax_serialize
from pilosa_tpu.executor.executor import Executor as JaxExecutor
from pilosa_tpu.memory import placement as jplacement
from pilosa_tpu.models.holder import Holder as JaxHolder
from pilosa_tpu.models.schema import FieldOptions as JaxFieldOptions
from pilosa_tpu.models.schema import FieldType as JaxFieldType
from pilosa_tpu.obs import metrics as jmetrics
from pilosa_tpu_torch import memory
from pilosa_tpu_torch.api import serialize_result
from pilosa_tpu_torch.executor.executor import Executor
from pilosa_tpu_torch.memory import encode, placement
from pilosa_tpu_torch.models.holder import Holder
from pilosa_tpu_torch.models.schema import FieldOptions, FieldType
from pilosa_tpu_torch.obs import metrics
from pilosa_tpu_torch.obs.monitor import global_monitor

torch.set_num_threads(1)

SEED = 20260806
W = 2048
CPUS = [torch.device("cpu")] * 8

JAX = {"Holder": JaxHolder, "Executor": JaxExecutor,
       "FieldOptions": JaxFieldOptions, "FieldType": JaxFieldType,
       "ser": jax_serialize, "kw": {}}
PORT = {"Holder": Holder, "Executor": Executor,
        "FieldOptions": FieldOptions, "FieldType": FieldType,
        "ser": serialize_result, "kw": {"device": "cpu"}}


@pytest.fixture(autouse=True)
def mesh_env(monkeypatch):
    """Every test leaves both packages' placement state, the env and
    the ledgers as it found them."""
    monkeypatch.delenv("PILOSA_TPU_MESH_DEVICES", raising=False)
    gc.collect()
    placement.reset()
    jplacement.reset()
    yield monkeypatch
    placement.reset()
    jplacement.reset()
    for led in (memory.ledger(), jmemory.ledger()):
        led.set_budget(None)
        led.set_devices(1)


def mesh_on(pkg, n: int, monkeypatch) -> None:
    if pkg is PORT:
        placement.configure(mesh_devices=n, devices=CPUS)
    else:
        monkeypatch.setenv("PILOSA_TPU_MESH_DEVICES", str(n))


def build_seeded_holder(pkg, seed: int = SEED, n_shards: int = 3,
                        n_bits: int = 260):
    """tests/test_multichip.py's two seeded indexes, at width W, through
    the package's write path."""
    rng = np.random.default_rng(seed)
    h = pkg["Holder"](width=W)
    opts, ft = pkg["FieldOptions"], pkg["FieldType"]
    a = h.create_index("alpha", track_existence=True)
    a.create_field("a")
    a.create_field("b")
    a.create_field("v", opts(type=ft.INT, min=-100, max=1000))
    b = h.create_index("beta", track_existence=False)
    b.create_field("c")
    b.create_field("w", opts(type=ft.INT, min=0, max=500))
    ex = pkg["Executor"](h, **pkg["kw"])
    cols = rng.integers(0, n_shards * W, size=n_bits)
    for i, col in enumerate(cols):
        ex.execute("alpha", f"Set({col}, a={int(rng.integers(4))})")
        ex.execute("alpha", f"Set({col}, b={int(rng.integers(6))})")
        ex.execute("alpha",
                   f"Set({col}, v={int(rng.integers(-100, 1000))})")
        if i % 2 == 0:
            bcol = int(rng.integers(0, (n_shards + 1) * W))
            ex.execute("beta", f"Set({bcol}, c={i % 3})")
            ex.execute("beta", f"Set({bcol}, w={int(rng.integers(500))})")
    return h


QUERIES = [
    ("alpha", "Count(Row(a=1))", None),
    ("alpha", "Count(Intersect(Row(a=1), Row(b=2)))", None),
    ("alpha", "Count(Union(Row(a=0), Row(b=5)))", None),
    ("alpha", "Count(Not(Row(a=2)))", None),
    ("alpha", "Row(a=3)", None),
    ("alpha", "Sum(Row(a=1), field=v)", None),
    ("alpha", "Count(Row(v > 50))", None),
    ("beta", "Count(Row(c=0))", None),
    ("beta", "Row(c=1)", None),
    ("beta", "Sum(field=w)", None),
    ("alpha", "TopN(a, n=3)", None),
    ("alpha", "GroupBy(Rows(a), aggregate=Sum(field=v))", None),
    ("alpha", "Count(Row(a=1))", [0, 2]),
    ("beta", "Count(Row(c=1))", [1]),
]
SHORT = QUERIES[:5] + [QUERIES[5], QUERIES[9], QUERIES[12]]


def serve_concurrent(pkg, srv, items):
    got = {}
    lock = threading.Lock()
    bar = threading.Barrier(len(items))

    def one(k):
        idx, q, shards = k
        bar.wait()
        r = [pkg["ser"](x) for x in
             srv.execute_serving(idx, q, list(shards) if shards else None)]
        with lock:
            got[k] = r

    keyed = [(i, q, tuple(s) if s else None) for i, q, s in items]
    ts = [threading.Thread(target=one, args=(k,), daemon=True)
          for k in keyed]
    for t in ts:
        t.start()
    for t in ts:
        t.join(120)
    assert not any(t.is_alive() for t in ts), "a reader did not finish"
    return got


def solo_expect(pkg, h, items):
    plain = pkg["Executor"](h, **pkg["kw"])
    return {(i, q, tuple(s) if s else None):
            [pkg["ser"](x) for x in plain.execute(i, q, s)]
            for i, q, s in items}


def serving(pkg, h, max_batch: int = 64):
    srv = pkg["Executor"](h, **pkg["kw"])
    layer = srv.enable_serving(window_s=0.05, max_batch=max_batch,
                               cache_bytes=0, admission=False)
    return srv, layer


def mesh_dispatches(pkg) -> float:
    m = metrics if pkg is PORT else jmetrics
    return m.SERVING_DISPATCH.value(kind="ragged_mesh")


def serving_failures(since: int) -> list:
    """The port's serving.* captures since the monitor held ``since``
    events: a mesh program that failed to plan or run (its riders then
    answer solo, so the answers alone would not show it)."""
    return [e.get("message") for e in global_monitor.recent()[since:]
            if str(e.get("where", "")).startswith("serving.")]


@pytest.mark.parametrize("ndev", [2, 8])
def test_mesh_serving_bit_exact_vs_one_device_and_jax(mesh_env, ndev):
    """The seeded mixed batch through the serving stack at N slots equals
    solo execution and the JAX serving mesh at N devices, and the mesh
    program (not a fallback) serves it, again from the cached program."""
    items = QUERIES if ndev == 8 else SHORT
    got = {}
    for pkg in (PORT, JAX):
        h = build_seeded_holder(pkg)
        want = solo_expect(pkg, h, items)
        mesh_on(pkg, ndev, mesh_env)
        srv, layer = serving(pkg, h)
        assert layer.ragged
        m0 = mesh_dispatches(pkg)
        c0 = len(global_monitor.recent())
        got[pkg["ser"]] = serve_concurrent(pkg, srv, items)
        assert got[pkg["ser"]] == want
        assert mesh_dispatches(pkg) > m0
        assert serve_concurrent(pkg, srv, items) == want
        if pkg is PORT:
            assert serving_failures(c0) == []
        if pkg is PORT:
            layer.close()
        mesh_env.delenv("PILOSA_TPU_MESH_DEVICES", raising=False)
    assert got[serialize_result] == got[jax_serialize]


def test_mesh_bit_exact_under_interleaved_writes(mesh_env):
    """Writes between mesh batches move the mutation epoch: the cached
    mesh program is built again and stays exact."""
    h = build_seeded_holder(PORT, n_bits=120)
    mesh_on(PORT, 4, mesh_env)
    srv, layer = serving(PORT, h)
    writer = Executor(h, device="cpu")
    items = QUERIES[:8]
    m0 = mesh_dispatches(PORT)
    c0 = len(global_monitor.recent())
    for round_ in range(3):
        serve_concurrent(PORT, srv, items)
        writer.execute("alpha", f"Set({round_ * 797}, a=1)")
        writer.execute("alpha", f"Set({round_ * 1931}, v=77)")
        want = solo_expect(PORT, h, items)
        assert serve_concurrent(PORT, srv, items) == want
    assert mesh_dispatches(PORT) > m0
    assert serving_failures(c0) == []
    layer.close()


@pytest.mark.parametrize("sparse", [False, True])
@pytest.mark.parametrize("ndev", [1, 4])
def test_sparse_format_mesh_matrix(mesh_env, sparse, ndev):
    """Encoded pages go through the mesh program (expanded to dense on
    their owner) and every arm of encoding x mesh equals solo execution
    in the same arm (the JAX PILOSA_TPU_SPARSE_FORMAT twin is the port's
    encode.configure)."""
    prev = encode.enabled()
    encode.configure(enabled=sparse)
    try:
        h = Holder(width=W)
        idx = h.create_index("sp", track_existence=False)
        idx.create_field("s")
        ex = Executor(h, device="cpu")
        rng = np.random.default_rng(SEED)
        for r in range(4):
            for col in rng.choice(3 * W, size=24, replace=False):
                ex.execute("sp", f"Set({int(col)}, s={r})")
        items = [("sp", "Count(Row(s=0))", None),
                 ("sp", "Count(Union(Row(s=0), Row(s=1)))", None),
                 ("sp", "Count(Intersect(Row(s=1), Row(s=2)))", None),
                 ("sp", "Row(s=3)", None),
                 ("sp", "TopN(s, n=4)", None)]
        want = solo_expect(PORT, h, items)
        if ndev > 1:
            mesh_on(PORT, ndev, mesh_env)
        srv, layer = serving(PORT, h, max_batch=32)
        m0 = mesh_dispatches(PORT)
        c0 = len(global_monitor.recent())
        assert serve_concurrent(PORT, srv, items) == want
        assert serve_concurrent(PORT, srv, items) == want
        assert serving_failures(c0) == []
        if ndev > 1:
            assert mesh_dispatches(PORT) > m0
        else:
            assert mesh_dispatches(PORT) == m0
        layer.close()
    finally:
        encode.configure(enabled=prev)


def test_per_slot_ledger_budget_invariant(mesh_env):
    """No slot accounts more than its share of the budget, and the paged
    working set lands on several slots."""
    h = build_seeded_holder(PORT)
    mesh_on(PORT, 4, mesh_env)
    srv, layer = serving(PORT, h)
    want = solo_expect(PORT, h, SHORT)
    assert serve_concurrent(PORT, srv, SHORT) == want
    led = memory.ledger()
    per = led.device_bytes(4)
    assert sum(per) > 0
    assert sum(1 for b in per if b > 0) >= 2
    share = led.device_budget()
    assert all(b <= share for b in per)
    layer.close()


def test_placement_survives_eviction_ladder(mesh_env):
    """A budget far below the working set evicts pages, but the placement
    stays sticky (pages built again land on the same owner) and the
    answers stay exact."""
    h = build_seeded_holder(PORT)
    mesh_on(PORT, 4, mesh_env)
    srv, layer = serving(PORT, h)
    want = solo_expect(PORT, h, SHORT)
    assert serve_concurrent(PORT, srv, SHORT) == want
    owners0 = {ix: placement.owners(ix, range(4)).tolist()
               for ix in ("alpha", "beta")}
    epoch0 = placement.epoch()
    memory.ledger().set_budget(64 << 10)
    try:
        assert serve_concurrent(PORT, srv, SHORT) == want
    finally:
        memory.ledger().set_budget(None)
    assert placement.epoch() == epoch0
    assert {ix: placement.owners(ix, range(4)).tolist()
            for ix in ("alpha", "beta")} == owners0
    assert serve_concurrent(PORT, srv, SHORT) == want
    layer.close()


def test_placement_epoch_pins_cache_keys(mesh_env):
    """Stack keys and the cached canonical program carry (mesh width,
    placement epoch): a rebalance or a width flip builds again instead
    of replaying a dead placement."""
    h = build_seeded_holder(PORT, n_bits=100)
    mesh_on(PORT, 4, mesh_env)
    srv, layer = serving(PORT, h)
    eng = srv.stacked
    key0 = eng._mesh_key()
    assert key0[1:] == (4, placement.epoch())
    items = QUERIES[:6]
    want = solo_expect(PORT, h, items)
    assert serve_concurrent(PORT, srv, items) == want
    assert serve_concurrent(PORT, srv, items) == want
    placement.rebalance()
    key1 = eng._mesh_key()
    assert key1 != key0 and key1[2] == placement.epoch()
    m0 = mesh_dispatches(PORT)
    c0 = len(global_monitor.recent())
    assert serve_concurrent(PORT, srv, items) == want
    assert mesh_dispatches(PORT) > m0
    assert serving_failures(c0) == []
    snap = placement.snapshot()
    assert snap["mesh_devices"] == 4 and snap["epoch"] == key1[2]
    assert sum(snap["assigned_shards"].values()) == 3   # alpha's shards
    placement.configure(mesh_devices=2)
    assert eng._mesh_key()[1] == 2
    placement.configure(mesh_devices=1)
    assert eng._mesh_key() == id(None)
    assert serve_concurrent(PORT, srv, items) == want
    layer.close()


def test_serving_mesh_is_the_configured_slots(mesh_env):
    """The port has no shard_map to shim (tests/test_multichip.py's
    compat case): its serving mesh is a one-row Mesh of the configured
    slots, clamped to the devices given."""
    placement.configure(mesh_devices=8, devices=CPUS)
    m = placement.serving_mesh()
    assert m.size == 8 and m.shape == {"rows": 1, "shards": 8}
    assert m.flat == CPUS and placement.device_of(7) == CPUS[7]
    placement.configure(mesh_devices=16)
    assert placement.mesh_devices() == 8
    placement.configure(devices=CPUS[:3])
    assert placement.mesh_devices() == 3
    assert placement.serving_mesh().size == 3


def test_mesh_off_is_legacy_layout(mesh_env):
    """mesh-devices <= 1 keeps the single-device paths: no lane owner
    map, no mesh dispatch kind."""
    h = build_seeded_holder(PORT, n_bits=80)
    srv, layer = serving(PORT, h, max_batch=32)
    items = QUERIES[:6]
    want = solo_expect(PORT, h, items)
    m0 = mesh_dispatches(PORT)
    assert serve_concurrent(PORT, srv, items) == want
    assert mesh_dispatches(PORT) == m0
    assert srv.stacked._lane_devices(h.index("alpha"), (0, 1, 2), (3,),
                                     0) is None
    layer.close()


def test_configure_replaces_the_env_twin(mesh_env):
    """The port reads no PILOSA_TPU_MESH_DEVICES or
    PILOSA_TPU_PLACEMENT_PIN: only placement.configure sets the mesh,
    where the JAX package follows its env twin."""
    mesh_env.setenv("PILOSA_TPU_MESH_DEVICES", "8")
    mesh_env.setenv("PILOSA_TPU_PLACEMENT_PIN", "alpha/*=3")
    assert jplacement.mesh_devices() == 8
    assert placement.mesh_devices() == 1
    placement.configure(mesh_devices=4, pin="alpha/*=3", devices=CPUS)
    assert placement.mesh_devices() == 4
    assert placement.owners("alpha", [0, 1, 2]).tolist() == [3, 3, 3]
