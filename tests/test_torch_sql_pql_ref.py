"""The reference def files' PQLTests (``tests/test_pql_ref_conformance.py``)
on tables the SQL engines built: each setup goes through a
``DualEngine`` (the JAX package and the port on one of its engines),
then each PQL query runs on both executors.  The port's answer is held
to the case's expected value and to the JAX answer, exactly
(dataclasses as ``dataclasses.asdict``, rows as their columns and
keys)."""

import dataclasses

import pytest

from tests.test_pql_ref_conformance import KEYED_SETUP, W
from tests.torch_sql_dual import ENGINES, DualEngine


def norm(r):
    if dataclasses.is_dataclass(r) and not isinstance(r, type):
        return (type(r).__name__, dataclasses.asdict(r))
    if hasattr(r, "columns") and hasattr(r, "segments"):
        return ("row", [int(c) for c in r.columns()], r.keys)
    if isinstance(r, list):
        return [norm(x) for x in r]
    return (type(r).__name__, r)


def _pairs(res):
    if not isinstance(res, list):
        res = [res]
    return [(p.id, p.count) for p in res]


UNKEYED_SETUP = [
    "CREATE TABLE unkeyed (_id id, an_id_set idset)",
    f"INSERT INTO unkeyed (_id, an_id_set) VALUES (1, (1, 2)), "
    f"({W + 2}, (1, 3))",
]
JOIN_SETUP = [
    "CREATE TABLE users (_id id, name string, age int)",
    "INSERT INTO users (_id, name, age) VALUES (0, 'a', 21), "
    "(1, 'b', 18), (2, 'c', 28), (3, 'd', 34), (4, 'e', 36)",
    "CREATE TABLE orders (_id id, userid int, price decimal(2))",
    "INSERT INTO orders (_id, userid, price) VALUES "
    "(0, 1, 9.99), (1, 0, 3.99), (2, 2, 14.99), (3, 3, 5.99), "
    "(4, 1, 12.99), (5, 2, 1.99)",
]

# (name, setup, index, pql, the reference's expected answer as a check)
CASES = [
    ("minrow", KEYED_SETUP, "keyed", "MinRow(field=an_id_set)",
     lambda r: (r.id, r.count) == (11, 1)),
    ("maxrow", KEYED_SETUP, "keyed", "MaxRow(field=an_id_set)",
     lambda r: (r.id, r.count) == (43, 1)),
    ("topk", KEYED_SETUP, "keyed", "TopK(an_id_set, k=2)",
     lambda r: _pairs(r) == [(11, 3), (12, 2)]),
    ("rows", KEYED_SETUP, "keyed", "Rows(field=an_id_set)",
     lambda r: list(r) == [11, 12, 13, 23, 32, 33, 41, 42, 43]),
    ("includescolumn", KEYED_SETUP, "keyed",
     "IncludesColumn(Row(an_id_set=12), column='two')", lambda r: r is True),
    ("constrow_extract_keyed", KEYED_SETUP, "keyed",
     "Extract(ConstRow(columns=['two']), Rows(an_id))",
     lambda r: [(e["column_key"], e["rows"][0]) for e in r.columns]
     == [("two", 201)]),
    ("fieldvalue", KEYED_SETUP, "keyed",
     "FieldValue(field=an_int, column='three')",
     lambda r: (r.value, r.count) == (33, 1)),
    ("unionrows_count", KEYED_SETUP, "keyed",
     "Count(UnionRows(Rows(field=an_id_set)))", lambda r: int(r) == 4),
    ("options_shards", UNKEYED_SETUP, "unkeyed",
     "Options(Count(Row(an_id_set=1)), shards=[0])", lambda r: int(r) == 1),
    ("distinct_cross_index_join", JOIN_SETUP, "users",
     "Intersect(Distinct(Row(price > 10), index=orders, field=userid))",
     lambda r: sorted(int(c) for c in r.columns()) == [1, 2]),
]


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("name,setup,index,pql,check", CASES,
                         ids=[c[0] for c in CASES])
def test_pql_reference_case(engine, name, setup, index, pql, check):
    eng = DualEngine(engine)
    for s in setup:
        eng.query(s)
    want = eng.jax.executor.execute(index, pql)[0]
    got = eng.executor.execute(index, pql)[0]
    assert check(got), (name, got)
    assert norm(got) == norm(want), (name, got, want)
