"""The reference's sql3 defs (``tests/sql_defs_ref.py``) through the JAX
package and the port on both of its engines (``DualEngine``), each case
also held to the reference's expected rows with the JAX runner's own
``canon``, ``conv_exp`` and ``effective_setup``.  The corpus is split
over ``test_torch_sql_ref_a.py`` and ``_b.py``, so that no file runs
long on one worker."""

from __future__ import annotations

import pytest

from pilosa_tpu_torch.sql import SQLError
from tests.sql_defs_ref import FAMILIES
from tests.test_sql_ref_conformance import canon, conv_exp, effective_setup
from tests.torch_sql_dual import DualEngine


def run_family(engine: str, setup, cases) -> None:
    """The JAX runner's test_reference_family, on a DualEngine: the
    family's setup (and the sibling tables its SQL names), then its
    cases in order, so earlier DML is seen by later cases."""
    eng = DualEngine(engine)
    all_sql = " ".join(sql for _n, sql, _e in cases)
    seen = set()
    for s in effective_setup(setup, all_sql):
        if s not in seen:
            seen.add(s)
            eng.query(s)
    for cname, sql, exp in cases:
        if isinstance(exp, tuple) and exp and exp[0] == "error":
            with pytest.raises(SQLError) as exc:
                eng.query(sql)
            assert exp[1].lower() in str(exc.value).lower(), \
                (cname, exc.value)
            continue
        got = eng.query(sql)[-1].rows
        if isinstance(exp, tuple) and exp and exp[0] == "IN":
            _tag, count, universe = exp
            assert len(got) == count, (cname, got)
            uni = canon([tuple(conv_exp(c) for c in r) for r in universe])
            for r in canon(got):
                assert r in uni, (cname, r, universe)
            continue
        expc = [tuple(conv_exp(c) for c in r) for r in exp]
        if expc and got and all(len(r) < len(got[0]) for r in expc):
            w = max(len(r) for r in expc)
            got = [r[:w] for r in got]
            expc = [r[:w] for r in expc]
            if len(expc) < len(got):
                cg = canon(got)
                for r in canon(expc):
                    assert r in cg, (cname, r, got)
                continue
        assert canon(got) == canon(expc), (cname, got, expc)


def half(which: int) -> list:
    """Families of one file: alternate families, so the two halves take
    about equal time."""
    return FAMILIES[which::2]

