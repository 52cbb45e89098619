"""``tests/sql_defs.py`` (the declarative SQL conformance cases) on the
JAX package and both engines of the port: every statement through a
``DualEngine`` (the same rows, exactly, or the same error), each case
held to its expected rows as ``tests/test_sql_conformance.py`` holds
them, with that runner's own ``canon``."""

import pytest

from pilosa_tpu_torch.sql import SQLError
from tests.sql_defs import CASES, SETUP
from tests.test_sql_conformance import canon
from tests.torch_sql_dual import ENGINES, DualEngine


def fresh_engine(engine: str) -> DualEngine:
    e = DualEngine(engine)
    for stmt in SETUP:
        e.query(stmt)
    return e


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("name,sql,expected", CASES, ids=[c[0] for c in CASES])
def test_sql_conformance(engine, name, sql, expected):
    eng = fresh_engine(engine)
    if isinstance(expected, tuple) and expected and expected[0] == "error":
        with pytest.raises(SQLError) as exc:
            eng.query(sql)
        assert expected[1].lower() in str(exc.value).lower(), exc.value
        return
    got = eng.query(sql)[-1].rows
    if isinstance(expected, int):
        assert got == [(expected,)], got
    elif isinstance(expected, tuple) and expected[0] == "ordered":
        assert [tuple(r) for r in got] == expected[1], got
    else:
        assert canon(got) == canon(expected), (canon(got), canon(expected))


@pytest.mark.parametrize("engine", ENGINES)
def test_bulk_insert_from_file(engine, tmp_path):
    """INPUT 'FILE' reads a real CSV from disk, in both packages."""
    eng = fresh_engine(engine)
    p = tmp_path / "orders.csv"
    p.write_text("40,mars,9\n41,mars,3\n")
    res = eng.query_one(
        f"BULK INSERT INTO orders (_id, region, qty) FROM '{p}' "
        "WITH FORMAT 'CSV' INPUT 'FILE'")
    assert res.rows == []
    got = eng.query_one("SELECT _id FROM orders WHERE region = 'mars'")
    assert sorted(got.rows) == [(40,), (41,)]
