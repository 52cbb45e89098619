"""The port's API facade against the JAX package's.

``API.query`` JSON (serialize_result of every result type) equals the
JAX ``API.query`` JSON on the executor parity corpus of
tests/test_torch_executor.py and the keyed corpus of
tests/test_torch_keys.py, with the port on both engines (the JAX API
on its default one); ``ApiError`` statuses and messages equal on bad
index, field, row and key input; the schema calls, the imports (bits
with and without keys and clear=, values, roaring), the roaring export
bytes and key translation agree.  The port runs on the CPU
(device="cpu").  Exact throughout."""

import base64

import numpy as np
import pytest
import torch

import __graft_entry__ as ge
from pilosa_tpu.api import API as JaxAPI
from pilosa_tpu.api import ApiError as JaxApiError
from pilosa_tpu.models.holder import Holder as JaxHolder
from pilosa_tpu.models.schema import FieldOptions as JaxFieldOptions
from pilosa_tpu.models.schema import FieldType as JaxFieldType
from pilosa_tpu.models.schema import TimeQuantum as JaxTimeQuantum
from pilosa_tpu_torch.api import API, ApiError
from pilosa_tpu_torch.models.holder import Holder
from pilosa_tpu_torch.models.schema import FieldOptions, FieldType
from pilosa_tpu_torch.models.state import holder_from_state
from pilosa_tpu_torch.storage import roaring
from test_torch_executor import (
    DENSE_QUERIES,
    GROUPBY_QUERIES,
    QUERIES,
    _categorical,
    _dense,
    jax_state,
)
from test_torch_keys import KIDX_QUERIES, REFERENCE_QUERIES, _keyed

torch.set_num_threads(1)

W = 2048


@pytest.fixture(scope="module")
def apis():
    """(JAX API, port API) a corpus index: i, d and c from the executor
    corpus (the port's holders carried over as state), keyed and kidx
    (and ko) built through each package's translators."""
    jh = ge._build_holder(width=W, n_shards=4)
    jd = _dense(JaxHolder(width=W), JaxFieldOptions, JaxFieldType,
                JaxFieldOptions(type=JaxFieldType.TIME,
                                time_quantum=JaxTimeQuantum("YMD")))
    jc = _categorical(JaxHolder(width=W), JaxFieldOptions, JaxFieldType)
    jk = _keyed(JaxHolder(width=W), JaxFieldOptions, JaxFieldType)
    pk = _keyed(Holder(width=W), FieldOptions, FieldType)
    out = {}
    for name, j in (("i", jh), ("d", jd), ("c", jc)):
        out[name] = (JaxAPI(j), API(holder_from_state(jax_state(j)),
                                    device="cpu"))
    out["keyed"] = out["kidx"] = (JaxAPI(jk), API(pk, device="cpu"))
    return out


_CORPUS = ([("i", q) for q in QUERIES] + [("d", q) for q in DENSE_QUERIES]
           + GROUPBY_QUERIES + [("keyed", q) for q in REFERENCE_QUERIES]
           + [("kidx", q) for q in KIDX_QUERIES])
_JAX_JSON: dict = {}


@pytest.mark.parametrize("engine", ["stacked", "per_shard"])
@pytest.mark.parametrize("index,query", _CORPUS)
def test_query_json_matches_jax(apis, engine, index, query):
    japi, api = apis[index]
    if (index, query) not in _JAX_JSON:
        _JAX_JSON[index, query] = japi.query(index, query)
    api.executor.use_stacked = engine == "stacked"
    try:
        assert api.query(index, query) == _JAX_JSON[index, query]
    finally:
        api.executor.use_stacked = True


def test_query_history_and_info(apis):
    japi, api = apis["i"]
    api.query("i", "Count(Row(f=1))")
    hist = api.query_history()
    assert hist[0]["index"] == "i" and hist[0]["query"] == "Count(Row(f=1))"
    japi.query("i", "Count(Row(f=1))")
    assert set(hist[0]) == set(japi.query_history()[0])
    assert api.info()["shard_width"] == W
    assert api.info()["cpu_arch"] == "cpu"
    assert api.version() == japi.version()
    assert api.status() == japi.status()


# -- errors -----------------------------------------------------------------


ERROR_CALLS = [
    ("query", ("nope", "Count(All())")),
    ("query", ("kidx", "Row(kf=")),
    ("query", ("kidx", "Row(nofield=1)")),
    ("query", ("kidx", "Set(5, kf='k01')")),
    ("query", ("kidx", "Row(kf=3)")),
    ("import_bits", ("nope", "kf", [1], [1])),
    ("import_bits", ("kidx", "nofield", [1], [1])),
    ("import_bits", ("kidx", "ks", [1, 2], [1])),
    ("import_bits", ("kidx", "ks", None, None, ["a"], [1])),
    ("import_bits", ("i", "f", [1], None, None, ["c"])),
    ("import_values", ("kidx", "kv", [1], None)),
    ("import_values", ("kidx", "kv", [1, 2], [3])),
    ("import_roaring", ("kidx", "ks", 0, {"1": b"\x00\x01"})),
    ("import_roaring", ("i", "f", 0, {"1": roaring.encode([W + 5])})),
    ("translate_keys", ("i", None, ["a"])),
    ("translate_keys", ("kidx", "ks", ["a"])),
    ("translate_ids", ("kidx", "nofield", [1])),
    ("create_index", ("Bad-Name",)),
    ("create_index", ("kidx",)),
    ("create_field", ("kidx", "kf")),
    ("create_field", ("kidx", "_x")),
    ("create_field", ("nope", "x")),
    ("delete_index", ("nope",)),
    ("delete_field", ("kidx", "nope")),
    ("export_roaring", ("kidx", "nope", 0, 1)),
    ("apply_schema", ({"indexes": [{"name": "ok", "fields": [
        {"name": "x", "options": {"type": "bogus"}}]}]},)),
    ("apply_schema", ({"indexes": [{"fields": []}]},)),
    ("clear_field_columns", ("kidx", "nope", [1])),
]


@pytest.mark.parametrize("call,args", ERROR_CALLS,
                         ids=[f"{c}-{i}" for i, (c, _) in
                              enumerate(ERROR_CALLS)])
def test_api_errors_match_jax(apis, call, args):
    japi, api = apis["kidx" if args[0] != "i" else "i"]
    with pytest.raises(JaxApiError) as want:
        getattr(japi, call)(*args)
    with pytest.raises(ApiError) as got:
        getattr(api, call)(*args)
    assert (got.value.status, str(got.value)) == \
        (want.value.status, str(want.value))


# -- schema, imports and translation on fresh holders --------------------------


def both():
    return JaxAPI(JaxHolder(width=W)), API(Holder(width=W), device="cpu")


def same(japi, api, fn):
    """fn(api) in each package: equal results."""
    want, got = fn(japi), fn(api)
    assert got == want
    return got


def test_schema_crud_and_apply_schema():
    japi, api = both()
    schema = {"indexes": [
        {"name": "a", "keys": True, "fields": [
            {"name": "s", "options": {"type": "set", "keys": True}},
            {"name": "n", "options": {"type": "int", "min": -5, "max": 5}},
            {"name": "t", "options": {"type": "time",
                                      "time_quantum": "YMD"}}]},
        {"name": "b", "track_existence": False, "fields": [
            {"name": "m", "options": {"type": "mutex"}},
            {"name": "d", "options": {"type": "decimal", "scale": 2}}]}]}
    for a in (japi, api):
        a.apply_schema(schema)
        a.apply_schema(schema)        # again: nothing new, no error
    same(japi, api, lambda a: a.schema())
    same(japi, api, lambda a: a.create_index("c", keys=False))
    same(japi, api, lambda a: a.create_field("c", "x", {"type": "bool"}))
    same(japi, api, lambda a: a.create_field("c", "y", {"type": "int",
                                                        "min": 0, "max": 9}))
    for a in (japi, api):
        a.delete_field("a", "n")
        a.delete_index("b")
    assert same(japi, api, lambda a: a.schema())["indexes"][0]["name"] == "a"
    same(japi, api, lambda a: (a.shard_max(), a.available_shards("a")))


def test_import_bits_keys_and_clear():
    japi, api = both()
    for a in (japi, api):
        a.apply_schema({"indexes": [
            {"name": "u", "fields": [{"name": "f", "options": {}},
                                     {"name": "t", "options": {
                                         "type": "time",
                                         "time_quantum": "YM"}}]},
            {"name": "k", "keys": True, "fields": [
                {"name": "kf", "options": {"keys": True}}]}]})
    rng = np.random.default_rng(2)
    rows = rng.integers(0, 6, size=300).tolist()
    cols = rng.integers(0, 3 * W, size=300).tolist()
    same(japi, api, lambda a: a.import_bits("u", "f", rows, cols))
    same(japi, api, lambda a: a.import_bits(
        "u", "t", [1, 1, 2], [3, W + 3, 5],
        timestamps=["2024-01-05T00:00", "2024-03-01T00:00", None]))
    same(japi, api, lambda a: a.import_bits("u", "f", rows[:50], cols[:50],
                                            clear=True))
    same(japi, api, lambda a: a.import_bits("u", "f", rows[:5], cols[:5],
                                            clear=True))
    same(japi, api, lambda a: a.import_bits(
        "k", "kf", row_keys=["x", "y", "x", "z"],
        col_keys=["c1", "c2", "c3", "c1"]))
    same(japi, api, lambda a: a.import_bits(
        "k", "kf", row_keys=["x"], col_keys=["c1"], clear=True))
    for idx, q in (("u", "TopN(f, n=6)"), ("u", "Row(f=2)"),
                   ("u", "Count(All())"), ("k", "Row(kf='x')"),
                   ("u", "Row(t=1, from='2024-01-01T00:00', "
                         "to='2024-02-01T00:00')"),
                   ("u", "Row(t=2)"), ("k", "TopN(kf, n=3)"),
                   ("k", "Count(All())")):
        same(japi, api, lambda a: a.query(idx, q))
    same(japi, api, lambda a: a.translate_keys("k", None, ["c1", "c9"]))
    same(japi, api, lambda a: a.translate_keys("k", "kf", ["q", "x"],
                                               create=True))
    same(japi, api, lambda a: a.translate_ids("k", "kf", [1, 2, 3, 4, 99]))
    same(japi, api, lambda a: a.translate_ids(
        "k", None, a.translate_keys("k", None, ["c1", "c2", "c3"])))


def test_import_values_and_clear_field_columns():
    japi, api = both()
    for a in (japi, api):
        a.apply_schema({"indexes": [{"name": "v", "fields": [
            {"name": "n", "options": {"type": "int", "min": -100,
                                      "max": 100}},
            {"name": "d", "options": {"type": "decimal", "scale": 2}},
            {"name": "m", "options": {"type": "mutex"}}]}]})
    rng = np.random.default_rng(6)
    cols = rng.choice(4 * W, size=400, replace=False).tolist()
    vals = rng.integers(-100, 101, size=400).tolist()
    same(japi, api, lambda a: a.import_values("v", "n", cols, vals))
    same(japi, api, lambda a: a.import_values("v", "d", cols[:40],
                                              ["1.25", 3, -0.5, 7.75] * 10))
    same(japi, api, lambda a: a.import_values("v", "n", cols[:30], vals[:30],
                                              clear=True))
    same(japi, api, lambda a: a.import_bits("v", "m", [1, 2, 3] * 10,
                                            cols[:30]))
    same(japi, api, lambda a: a.clear_field_columns("v", "m", cols[:10]))
    same(japi, api, lambda a: a.mark_columns_exist("v", [7, 8]))
    for q in ("Sum(field=n)", "Min(field=n)", "Max(field=d)",
              "Sum(field=d)", "Count(Row(n > 50))", "Count(Row(m=2))",
              "Count(All())", "Distinct(field=n)"):
        same(japi, api, lambda a: a.query("v", q))


def test_import_roaring_and_export_bytes():
    japi, api = both()
    for a in (japi, api):
        a.apply_schema({"indexes": [{"name": "r", "fields": [
            {"name": "f", "options": {}}]}]})
    rng = np.random.default_rng(8)
    blobs = {str(r): roaring.encode(rng.choice(W, size=n, replace=False))
             for r, n in ((1, 40), (2, 1500), (5, 1))}
    blobs["3"] = base64.b64encode(roaring.encode([0, 7, W - 1])).decode()
    same(japi, api, lambda a: a.import_roaring("r", "f", 2, blobs))
    same(japi, api, lambda a: a.import_roaring(
        "r", "f", 2, {"1": roaring.encode([0, 1, 2])}, clear=True))
    for shard, row in ((2, 1), (2, 2), (2, 3), (0, 1), (2, 9)):
        got = same(japi, api, lambda a: a.export_roaring("r", "f", shard,
                                                         row))
        assert isinstance(got, bytes)
    for q in ("Row(f=3)", "Count(Row(f=2))", "Count(All())", "TopN(f)"):
        same(japi, api, lambda a: a.query("r", q))
