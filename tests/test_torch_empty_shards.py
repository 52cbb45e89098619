"""An empty shard list (``Executor.execute(index, q, shards=[])``) on
both of the port's engines, paged and unpaged, on a single device and
on a mesh, against the JAX executor.

The JAX executor answers every call with its empty answer; its stacked
engine raises IndexError on Sum (``pilosa_tpu/executor/stacked.py``
bsi_sum over no shard), where its per-shard engine answers (0, 0): the
port answers (0, 0) on both engines.  No kernel wrapper is reached:
a stack of no lane is never built, and no zero-size input reaches a
kernel.  Exact."""

import numpy as np
import pytest
import torch

from pilosa_tpu.executor.executor import Executor as JaxExecutor
from pilosa_tpu.models.holder import Holder as JaxHolder
from pilosa_tpu.models.schema import FieldOptions as JaxFieldOptions
from pilosa_tpu.models.schema import FieldType as JaxFieldType
from pilosa_tpu_torch import memory
from pilosa_tpu_torch.executor.executor import Executor
from pilosa_tpu_torch.models.holder import Holder
from pilosa_tpu_torch.models.schema import FieldOptions, FieldType
from pilosa_tpu_torch.ops import kernels as K
from pilosa_tpu_torch.parallel import make_mesh

torch.set_num_threads(1)

QUERIES = [
    "Row(a=1)",
    "Count(Row(a=1))",
    "Count(Intersect(Row(a=1), Row(b=1)))",
    "Count(Not(Row(a=1)))",
    "Count(Row(v > 3))",
    "TopN(a, n=3)",
    "TopN(a, Row(b=1), n=3)",
    "Sum(field=v)",
    "Sum(Row(a=1), field=v)",
    "Min(field=v)",
    "Max(field=v)",
    "Distinct(field=v)",
    "GroupBy(Rows(a))",
    "GroupBy(Rows(m), aggregate=Sum(field=v))",
    "GroupBy(Rows(m), Rows(a), aggregate=Max(field=v))",
]
KERNELS = ("popcount_rows", "pair_popcount", "masked_popcount",
           "masked_popcount_shards", "rows_filter_counts", "bsi_sum_counts",
           "bsi_range", "groupby_fused", "groupby_onehot", "groupby_sum",
           "assemble_pages", "concat_gather", "segment_count")


def _holder(holder_cls, opts, ftype, width: int, n_shards: int = 3):
    rng = np.random.default_rng(31)
    h = holder_cls(width=width)
    idx = h.create_index("i", track_existence=True)
    idx.create_field("a")
    idx.create_field("b")
    idx.create_field("m", opts(type=ftype.MUTEX))
    idx.create_field("v", opts(type=ftype.INT, min=-100, max=100))
    cols = rng.integers(0, n_shards * width, size=400)
    idx.field("a").import_bits(rng.integers(0, 3, size=400), cols)
    idx.field("b").import_bits(rng.integers(0, 3, size=400), cols[::-1])
    idx.field("m").import_bits(rng.integers(0, 4, size=400), cols)
    idx.field("v").import_values(cols, rng.integers(-100, 101, size=400))
    idx.mark_columns_exist(cols)
    return h


def norm(results):
    out = []
    for r in results:
        if hasattr(r, "columns") and callable(r.columns):
            out.append(r.columns().tolist())
        elif hasattr(r, "values") and not callable(r.values):
            out.append(list(r.values))
        elif hasattr(r, "value"):
            out.append((r.value, r.count))
        elif isinstance(r, list):
            out.append(len(r))
        else:
            out.append(r)
    return out


@pytest.fixture(scope="module")
def holders():
    return (_holder(JaxHolder, JaxFieldOptions, JaxFieldType, 2048),
            _holder(Holder, FieldOptions, FieldType, 2048))


@pytest.fixture
def no_kernel(monkeypatch):
    calls = []
    for name in KERNELS:
        real = getattr(K, name)

        def wrap(*a, _real=real, _name=name, **kw):
            calls.append(_name)
            return _real(*a, **kw)
        monkeypatch.setattr(K, name, wrap)
    return calls


def _jax_answer(jh, q, stacked: bool):
    jex = JaxExecutor(jh)
    jex.use_stacked = stacked
    try:
        return norm(jex.execute("i", q, shards=[]))
    except IndexError:
        # the JAX stacked engine's Sum over no shard: its per-shard
        # engine's answer is the executor's
        assert stacked and q.startswith("Sum")
        return _jax_answer(jh, q, stacked=False)


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "unpaged"])
@pytest.mark.parametrize("engine", ["stacked", "per_shard", "mesh"])
@pytest.mark.parametrize("q", QUERIES)
def test_empty_shard_list_answers_as_jax(holders, no_kernel, paged, engine,
                                         q):
    jh, ph = holders
    prev = memory.paged_enabled()
    memory.configure(paged=paged)
    try:
        ex = Executor(ph, device="cpu")
        ex.use_stacked = engine != "per_shard"
        if engine == "mesh":
            ex.set_mesh(make_mesh(4, devices=[torch.device("cpu")] * 4))
        got = norm(ex.execute("i", q, shards=[]))
    finally:
        memory.configure(paged=prev)
    assert got == _jax_answer(jh, q, engine != "per_shard")
    assert no_kernel == []


def test_jax_stacked_sum_over_no_shard_raises(holders):
    """The reference fault the port does not keep (ROADMAP C)."""
    jh, _ph = holders
    with pytest.raises(IndexError):
        JaxExecutor(jh).execute("i", "Sum(field=v)", shards=[])


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "unpaged"])
def test_full_width_paged_count_intersect(no_kernel, paged):
    """At 2^20 columns a row leaf spans pages: Count(Intersect(Row(a=1),
    Row(b=1))) over shards=[] answers 0, as the JAX executor does."""
    jh = _holder(JaxHolder, JaxFieldOptions, JaxFieldType, 1 << 20, 2)
    ph = _holder(Holder, FieldOptions, FieldType, 1 << 20, 2)
    q = "Count(Intersect(Row(a=1), Row(b=1)))"
    prev = memory.paged_enabled()
    memory.configure(paged=paged)
    try:
        for stacked in (True, False):
            ex = Executor(ph, device="cpu")
            ex.use_stacked = stacked
            assert ex.execute("i", q, shards=[]) == \
                JaxExecutor(jh).execute("i", q, shards=[]) == [0]
            assert ex.execute("i", q, shards=[0, 1]) == \
                JaxExecutor(jh).execute("i", q, shards=[0, 1])
    finally:
        memory.configure(paged=prev)
