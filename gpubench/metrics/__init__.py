"""One file a per-layer metric, named as in BENCHMARK.json: ``read(b)``
takes the traced run's ``trace.Bundle`` and returns the metric's value,
or None where the run gave it nothing to read (the harness then leaves
the metric out of the line)."""

from __future__ import annotations

import importlib.util
from pathlib import Path

HERE = Path(__file__).resolve().parent


def load(name: str):
    p = HERE / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"gpubench.metrics.{name}", p)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_mean_ms(b, phases) -> float | None:
    """Milliseconds the window's flight records spent in the given
    phases, a query answered; None where no record carries any of them."""
    if not b.answered or not any(p in r.get("phases", {})
                                 for r in b.flight for p in phases):
        return None
    return sum(sum(r.get("phases", {}).get(p, 0.0) for p in phases)
               for r in b.flight) / b.answered


EDGE = 4


def roofline_terms(b) -> tuple[float, float, float, dict]:
    """(least seconds, device seconds of the kernels the trace holds
    one for one with their launches, device seconds of every port
    kernel, {kernel left out: [launches, records]}).  A kernel whose launches the trace
    does not hold one for one (a trace can drop records, a launch can
    issue more than one CUDA kernel) is left out of the first two.  The
    trace runs from before the first launch counted to after the last,
    so a thread the window does not own (the audit's) can add a few
    records at its edges: up to ``EDGE`` more records than launches
    still count, their time in the device sum, which only lowers the
    share."""
    from gpubench import roofline
    least = matched = every = 0.0
    left_out = {}
    for kernel, mod in roofline.load_all().items():
        evs = [e - s for name, s, e in b.device
               if any(sym in name for sym in mod.SYMBOLS)]
        every += sum(evs)
        got = b.costs.get(kernel)
        if not got and not evs:
            continue
        if not got or not got[1] <= len(evs) <= got[1] + EDGE:
            left_out[kernel] = [got[1] if got else 0, len(evs)]
            continue
        least += got[0]
        matched += sum(evs)
    return least, matched, every, left_out
