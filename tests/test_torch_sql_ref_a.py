"""Half a of the reference's sql3 defs (``tests/sql_defs_ref.py``; every
first family of two) on the JAX package and both engines of
the port, held to the reference's rows and to each other exactly
(``tests/torch_sql_ref.py``)."""

import pytest

from tests.torch_sql_dual import ENGINES
from tests.torch_sql_ref import half, run_family

_FAMS = half(0)


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("origin,setup,cases", _FAMS,
                         ids=[f[0] for f in _FAMS])
def test_reference_family(engine, origin, setup, cases):
    run_family(engine, setup, cases)
