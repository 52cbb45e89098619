"""Run SQL through the JAX package's engine and the port's, side by side.

``DualEngine`` takes each statement batch to a JAX ``SQLEngine`` (its
solo arm: a ``Holder`` with no serving layer) and to the port's
``SQLEngine`` on the CPU (``Executor(h, device="cpu")``), on the stacked
engine or with ``use_stacked = False``.  Every batch must give the same
outcome in both: equal result schemas and rows, cell for cell and of
the same Python type (an int stays an int, a Decimal keeps its scale, a
timestamp its nanoseconds), or the same exception type and message.
The port's results (or the port's exception) are returned, so a test
written against one engine runs against the pair unchanged.
"""

from __future__ import annotations

import datetime as dt
import math
from decimal import Decimal

import torch

from pilosa_tpu.models.holder import Holder as JaxHolder
from pilosa_tpu.sql import SQLEngine as JaxSQLEngine
from pilosa_tpu_torch.executor.executor import Executor
from pilosa_tpu_torch.models.holder import Holder
from pilosa_tpu_torch.sql import SQLEngine

# one intra-op thread: these tests share the machine with the rest of
# the suite's workers
torch.set_num_threads(1)

W = 1 << 12
ENGINES = ["stacked", "per_shard"]


def cell_key(v):
    """A cell as a comparable key that keeps its exact type: the type
    name rides along, Decimals compare with their scale, floats by
    repr (so NaN equals NaN), timestamps with their nanoseconds."""
    name = type(v).__name__
    if isinstance(v, (list, tuple)):
        return (name, tuple(cell_key(x) for x in v))
    if isinstance(v, Decimal):
        return (name, str(v))
    if isinstance(v, float):
        return (name, repr(v) if not math.isnan(v) else "nan")
    if isinstance(v, dt.datetime):
        return (name, v.isoformat(), getattr(v, "nsec", 0))
    if isinstance(v, dict):
        return (name, tuple(sorted((k, cell_key(x)) for k, x in v.items())))
    if v is None or isinstance(v, (bool, int, str, bytes, dt.date)):
        return (name, v)
    raise AssertionError(f"result cell of type {name}: {v!r}")


def result_key(res) -> tuple:
    return (tuple(tuple(s) for s in res.schema),
            tuple(tuple(cell_key(c) for c in row) for row in res.rows))


class DualEngine:
    """A JAX SQLEngine and the port's, fed the same statements."""

    def __init__(self, engine: str = "stacked", width: int = W,
                 jax_holder=None, holder=None):
        self.jax = JaxSQLEngine(jax_holder if jax_holder is not None
                                else JaxHolder(width=width))
        self.holder = holder if holder is not None else Holder(width=width)
        self.executor = Executor(self.holder, device="cpu")
        self.executor.use_stacked = engine == "stacked"
        self.port = SQLEngine(self.holder, executor=self.executor)

    def query(self, sql: str, auth_check=None):
        jerr = perr = None
        try:
            want = self.jax.query(sql, auth_check=auth_check)
        except Exception as e:  # compared with the port's below
            jerr = e
        try:
            got = self.port.query(sql, auth_check=auth_check)
        except Exception as e:
            perr = e
        if jerr is not None:
            assert perr is not None, (sql, "JAX raised", repr(jerr))
            assert type(perr).__name__ == type(jerr).__name__ and \
                str(perr) == str(jerr), (sql, repr(jerr), repr(perr))
            raise perr
        if perr is not None:
            raise AssertionError(f"{sql!r}: JAX answered, the port raised "
                                 f"{perr!r}") from perr
        assert [result_key(r) for r in got] == \
            [result_key(r) for r in want], (sql, got, want)
        return got

    def query_one(self, sql: str, auth_check=None):
        return self.query(sql, auth_check=auth_check)[-1]

