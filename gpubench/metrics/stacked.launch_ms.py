"""Mean milliseconds a query's dispatches spent enqueueing their work,
from the dispatch's start until the plan's launches had returned and
before the synchronise (the flight phase ``launch``, a part of
``execute``), a query answered."""

from gpubench.metrics import phase_mean_ms


def read(b):
    return phase_mean_ms(b, ("launch",))
