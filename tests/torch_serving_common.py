"""Shared fixtures of the port's serving-plane tests: the same holder
built through each package's executor, and the port's executors on the
CPU (device="cpu")."""

import threading

import pytest

from pilosa_tpu.api import serialize_result as jax_serialize
from pilosa_tpu.executor.executor import Executor as JaxExecutor
from pilosa_tpu.models.holder import Holder as JaxHolder
from pilosa_tpu.models.schema import FieldOptions as JaxFieldOptions
from pilosa_tpu.models.schema import FieldType as JaxFieldType
from pilosa_tpu_torch.api import serialize_result
from pilosa_tpu_torch.executor.executor import Executor
from pilosa_tpu_torch.models.holder import Holder
from pilosa_tpu_torch.models.schema import FieldOptions, FieldType

W = 2048
# 300 columns spread over four shards of W columns
N_COLS = 300
STRIDE = 23

JAX = {"Holder": JaxHolder, "Executor": JaxExecutor,
       "FieldOptions": JaxFieldOptions, "FieldType": JaxFieldType,
       "ser": jax_serialize, "kw": {}}
PORT = {"Holder": Holder, "Executor": Executor,
        "FieldOptions": FieldOptions, "FieldType": FieldType,
        "ser": serialize_result, "kw": {"device": "cpu"}}


def make_executor(pkg, h):
    return pkg["Executor"](h, **pkg["kw"])


def build_holder(pkg, track_existence: bool = True, index: str = "i",
                 h=None):
    """Fields a (4 rows), b (6 rows) and v (INT 0..1000) over N_COLS
    columns of four shards, written through the package's executor."""
    h = pkg["Holder"](width=W) if h is None else h
    idx = h.create_index(index, track_existence=track_existence)
    idx.create_field("a")
    idx.create_field("b")
    idx.create_field("v", pkg["FieldOptions"](
        type=pkg["FieldType"].INT, min=0, max=1000))
    ex = make_executor(pkg, h)
    for c in range(N_COLS):
        col = c * STRIDE
        ex.execute(index, f"Set({col}, a={c % 4})")
        ex.execute(index, f"Set({col}, b={c % 6})")
        ex.execute(index, f"Set({col}, v={(c * 7) % 97})")
    return h


def both(track_existence: bool = True):
    """(JAX holder, port holder) of the same data."""
    return (build_holder(JAX, track_existence),
            build_holder(PORT, track_existence))


def results_of(pkg, ex, q, serving=False, index="i", shards=None):
    fn = ex.execute_serving if serving else ex.execute
    return [pkg["ser"](r) for r in fn(index, q, shards)]


def run_threads(fns, timeout: float = 60.0) -> None:
    """Start one thread a callable, join each with a timeout, and fail
    if any is still running (a hang fails the test, never the run)."""
    ts = [threading.Thread(target=f, daemon=True) for f in fns]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout)
    assert not any(t.is_alive() for t in ts), "a thread did not finish"


def wait_until(cond, timeout: float = 10.0) -> bool:
    """Poll ``cond`` on an event's timed wait until it holds."""
    ev = threading.Event()
    for _ in range(int(timeout / 0.002)):
        if cond():
            return True
        ev.wait(0.002)
    return cond()


@pytest.fixture(autouse=True, scope="module")
def stop_planes():
    """Stop the port's audit workers, watchdog monitor and incident
    capture threads after the module (sampled serves start the first,
    a serving layer the second, reports the third)."""
    yield
    from pilosa_tpu_torch.obs import audit, incidents, watchdog
    assert audit.stop_all()
    assert watchdog.stop()
    assert incidents.get().stop()


@pytest.fixture
def fresh_stats():
    """A fresh statistics catalog for the test: admission classes by
    measured cost once a fingerprint has three samples, so a test that
    pins a class must not inherit the process's profiles (another
    test's slow serve of the same query would make it heavy)."""
    from pilosa_tpu_torch.obs import stats
    prev = stats.swap(stats.StatsCatalog())
    yield stats.get()
    stats.swap(prev)
