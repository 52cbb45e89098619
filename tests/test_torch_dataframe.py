"""The port's index dataframe against the JAX package's.

tests/test_config_dataframe.py's dataframe cases (rows and ragged
columns, apply over the sealed AST whitelist, the device aggregate,
Parquet save and load) run on both packages, and each aggregate of the
port (on the CPU here, device="cpu") is held to the JAX one on the same
seeded columns.  The JAX aggregate runs with 64-bit mode off: an int
column wraps to int32 and its sum wraps modulo 2^32, a float column
rounds to float32 and its count comes back as a float.  The port
returns the same: ints, min, max and count exactly; float sums and
means (an int column's mean is a float32 too) within 1e-6 of the
column's sum, or mean, of absolute values (float32 sums in another
order): a relative 1e-6 for a column of one sign."""

import types

import numpy as np
import pytest

from pilosa_tpu.models import dataframe as jax_df
from pilosa_tpu.models.holder import Holder as JaxHolder
from pilosa_tpu_torch.models import dataframe as port_df
from pilosa_tpu_torch.models.holder import Holder

PKGS = {
    "jax": types.SimpleNamespace(
        mod=jax_df, aggregate=lambda df, op, c: df.aggregate(op, c)),
    "port": types.SimpleNamespace(
        mod=port_df,
        aggregate=lambda df, op, c: df.aggregate(op, c, device="cpu")),
}

OPS = ("sum", "min", "max", "mean", "count")
REL = 1e-6


@pytest.fixture(params=sorted(PKGS))
def pkg(request):
    return PKGS[request.param]


def test_dataframe_rows_and_apply(pkg, tmp_path):
    df = pkg.mod.IndexDataframe(str(tmp_path))
    df.add_rows([{"_id": 1, "price": 10.0, "qty": 3},
                 {"_id": 2, "price": 2.5, "qty": 8},
                 {"_id": 3, "price": 4.0}])
    assert df.n_rows == 3
    types_ = {s["name"]: s["type"] for s in df.schema()}
    assert types_["price"] == "float" and types_["qty"] == "int"
    assert df.column("qty").tolist() == [3, 8, None]
    assert df.apply("price * qty") == [30.0, 20.0, 0.0]
    assert df.apply("sum(price)") == 16.5
    with pytest.raises(pkg.mod.DataframeError):
        df.apply("__import__('os')")
    with pytest.raises(pkg.mod.DataframeError):
        df.column("nope")


@pytest.mark.parametrize("expr", [
    "price.real", "(lambda: 1)()", "[x for x in qty]", "open('f')",
    "where(qty > 1, price, 0)", "abs(-price) + maximum(qty, 4)",
    "qty if qty else price", "price // 3 % 2 ** 2",
])
def test_apply_whitelist_matches_jax(expr):
    out = {}
    for name, p in PKGS.items():
        df = p.mod.IndexDataframe(None)
        df.add_rows([{"_id": i, "price": 1.5 * i, "qty": i % 3}
                     for i in range(6)])
        try:
            out[name] = ("ok", df.apply(expr, columns=["price", "qty"]))
        except p.mod.DataframeError as e:
            out[name] = ("error", str(e))
        except Exception as e:
            out[name] = ("raised", type(e).__name__)
    assert out["port"] == out["jax"]


def test_dataframe_device_aggregate(pkg, tmp_path):
    df = pkg.mod.IndexDataframe(str(tmp_path))
    df.add_rows([{"_id": i, "v": i * 2} for i in range(100)])
    assert pkg.aggregate(df, "sum", "v") == 2 * sum(range(100))
    assert pkg.aggregate(df, "min", "v") == 0
    assert pkg.aggregate(df, "max", "v") == 198
    assert pkg.aggregate(df, "count", "v") == 100
    assert pkg.aggregate(df, "mean", "v") == pytest.approx(99.0)
    with pytest.raises(pkg.mod.DataframeError):
        pkg.aggregate(df, "median", "v")


def test_dataframe_parquet_roundtrip(pkg, tmp_path):
    pytest.importorskip("pyarrow")
    df = pkg.mod.IndexDataframe(str(tmp_path))
    df.add_rows([{"_id": 1, "a": "x"}, {"_id": 2, "a": "y"}])
    df.save()
    df2 = pkg.mod.IndexDataframe(str(tmp_path))
    assert df2.n_rows == 2
    assert df2.column("a").tolist() == ["x", "y"]
    assert df2.to_arrow().num_rows == 2


def test_parquet_written_by_either_opens_in_the_other(tmp_path):
    pytest.importorskip("pyarrow")
    rows = [{"_id": i, "f": 0.5 * i, "n": i - 3, "s": f"k{i}"}
            for i in range(7)] + [{"_id": 7, "f": None}]
    for writer, reader in (("jax", "port"), ("port", "jax")):
        d = str(tmp_path / writer)
        w = PKGS[writer].mod.IndexDataframe(d)
        w.add_rows(rows)
        w.save()
        r = PKGS[reader].mod.IndexDataframe(d)
        assert r.schema() == w.schema()
        for c in ("_id", "f", "n", "s"):
            assert r.column(c).tolist() == w.column(c).tolist()


# -- the aggregate's dtype rule, pinned against the JAX package ---------------

def _columns(seed=8, n=4096):
    rng = np.random.default_rng(seed)
    return {
        # past 2^31 both ways: the int32 wrap
        "big": [int(x) for x in rng.integers(-(1 << 40), 1 << 40, n)],
        "i32": [int(x) for x in rng.integers(-1000, 1000, n)],
        "edge": [(1 << 31) + i % 5 for i in range(n)],
        # float32 and float64 sums differ here
        "f": [float(x) for x in rng.random(n) * 1e8 + 0.1],
        "small": [float(x) for x in rng.random(n)],
        "flag": [bool(x) for x in rng.integers(0, 2, n)],
        "nulls": [None if i % 5 == 0 else 1.5 * i for i in range(n)],
    }


@pytest.fixture(scope="module")
def frames():
    out = {}
    for name, p in PKGS.items():
        cols = _columns()
        n = max(len(v) for v in cols.values())
        df = p.mod.IndexDataframe(None)
        df.add_rows([{"_id": i, **{k: v[i] for k, v in cols.items()
                                   if i < len(v)}} for i in range(n)])
        out[name] = df
    return out


def _close(got, want, column: str, op: str) -> bool:
    """|got - want| within 1e-6 of the 32-bit column's sum (or mean)
    of absolute values."""
    vals = np.abs(np.asarray([0 if v is None else v
                              for v in _columns()[column]],
                             dtype=np.float64))
    scale = vals.sum() if op == "sum" else vals.mean()
    return abs(got - want) <= REL * scale


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("column", ["big", "i32", "edge", "flag"])
def test_int_aggregates_equal_jax_exactly(frames, op, column):
    """Int (and bool) columns: what JAX returns, exactly — its int32
    wrap, its int32 sum, its float32 mean, its Python types."""
    want = PKGS["jax"].aggregate(frames["jax"], op, column)
    got = PKGS["port"].aggregate(frames["port"], op, column)
    assert type(got) is type(want)
    if op == "mean":
        assert _close(got, want, column, op), (got, want)
    else:
        assert got == want


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("column", ["f", "small", "nulls"])
def test_float_aggregates_equal_jax(frames, op, column):
    """Float columns round to float32: min, max and count (a float)
    exactly, sum and mean within a relative 1e-6."""
    want = PKGS["jax"].aggregate(frames["jax"], op, column)
    got = PKGS["port"].aggregate(frames["port"], op, column)
    assert type(got) is type(want) is float
    if op in ("sum", "mean"):
        assert _close(got, want, column, op), (got, want)
    else:
        assert got == want


def test_the_wrap_and_rounding_are_pinned(frames):
    """The pins themselves: past 2^31 an int wraps (the JAX package
    with 64-bit mode off), and the float sum is float32's, not
    float64's."""
    port = frames["port"]
    agg = PKGS["port"].aggregate
    edge = np.asarray(_columns()["edge"], dtype=np.int64)
    assert agg(port, "max", "edge") == int(edge.astype(np.int32).max()) < 0
    assert agg(port, "min", "big") >= -(1 << 31)
    assert agg(port, "sum", "edge") == (
        int(edge.astype(np.int32).astype(np.int64).sum()) + (1 << 31)
    ) % (1 << 32) - (1 << 31)
    f = np.asarray(_columns()["f"])
    f32 = f.astype(np.float32).astype(np.float64).sum()
    assert float(f.sum()) != f32
    assert agg(port, "sum", "f") == pytest.approx(f32, rel=REL)


def test_string_column_is_not_numeric(frames):
    df = port_df.IndexDataframe(None)
    df.add_rows([{"_id": 1, "s": "a"}, {"_id": 2, "s": "b"}])
    with pytest.raises(port_df.DataframeError):
        df.aggregate("sum", "s", device="cpu")


def test_aggregate_runs_on_the_card_by_default(monkeypatch):
    """With no device named, aggregate takes the CUDA card and raises
    where there is none: no quiet host path."""
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    df = port_df.IndexDataframe(None)
    df.add_rows([{"_id": 1, "v": 2}])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        df.aggregate("sum", "v")
    assert df.aggregate("count", "v") == 1     # no reduction, no device


def test_index_dataframe_is_lazy_and_synced(tmp_path, monkeypatch):
    """Index.dataframe is made at first use; Index.sync saves its new
    rows beside the shard files, and a reopened holder reads them."""
    pytest.importorskip("pyarrow")
    monkeypatch.setenv("RBF_NOSYNC", "1")
    for name, H in (("port", Holder), ("jax", JaxHolder)):
        path = str(tmp_path / name)
        h = H(path=path)
        idx = h.create_index("d")
        assert idx._dataframe is None
        df = idx.dataframe
        assert idx.dataframe is df
        df.add_rows([{"_id": 1, "x": 4}, {"_id": 2, "x": 5}])
        h.sync()
        h.close()
        h2 = H(path=path)
        h2.load_schema()
        try:
            assert h2.index("d").dataframe.column("x").tolist() == [4, 5]
        finally:
            h2.close()
