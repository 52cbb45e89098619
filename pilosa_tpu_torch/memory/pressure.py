"""The OOM ladder: absorb an out-of-memory instead of failing a query.

PyTorch raises ``torch.cuda.OutOfMemoryError`` when the card cannot
hold an allocation.  :func:`guarded` runs a device dispatch or upload
under the ladder:

1. on an OOM (:func:`is_oom`), a relief sweep: the ledger sheds half of
   the accounted resident bytes across every client, ``gc.collect()``
   drops the tensors, and ``torch.cuda.empty_cache()`` gives their
   blocks back to the card;
2. one retry of the same call;
3. still failing: where the caller gave a host fallback (the dispatch
   of a stacked engine on the CPU) the plan runs again, counted in
   ``pilosa_device_oom_total{outcome="host_fallback"}`` and logged at
   warning; anywhere else, on the card always, the OOM is raised
   (``outcome="raised"``).  Unlike the JAX package, a query on the card
   never degrades to the host: the kernels' plain versions take only
   CPU tensors.

``is_oom`` matches only an out-of-memory: ``torch.cuda.OutOfMemoryError``
and the JAX package's markers, never a failed build or launch (an
illegal memory access, a refused launch's error code).

``inject_oom(n)`` is the test seam: the next ``n`` guarded attempts
raise a synthetic OOM before running (the ``device-oom`` fault point of
obs/faults.py)."""

from __future__ import annotations

import gc
import logging

import torch

from pilosa_tpu_torch.obs import faults, metrics

# the [memory] oom-retry and host-fallback switches (memory.configure)
OOM_RETRY = True
HOST_FALLBACK = True

_OOM_MARKERS = ("RESOURCE_EXHAUSTED", "Out of memory", "out of memory",
                "Ran out of memory")

_log = logging.getLogger("pilosa_tpu_torch.memory")


class InjectedOOM(RuntimeError):
    """Synthetic out-of-memory raised by the device-oom fault."""


def inject_oom(n: int = 1):
    """Make the next ``n`` guarded attempts fail with a synthetic OOM.
    Arms the ``device-oom`` fault point, replacing any earlier arming."""
    faults.clear("device-oom")
    if int(n) > 0:
        faults.inject("device-oom", times=int(n))


def is_oom(e: BaseException) -> bool:
    if isinstance(e, (InjectedOOM, torch.cuda.OutOfMemoryError)):
        return True
    if not isinstance(e, (RuntimeError, MemoryError)):
        return False
    msg = str(e)
    return any(m in msg for m in _OOM_MARKERS)


def relieve(frac: float = 0.5) -> int:
    """The relief sweep: shed ``frac`` of the ledger's resident bytes,
    then collect, and give the freed blocks back to the card."""
    from pilosa_tpu_torch import memory
    need = memory.ledger().reclaim_frac(frac, trigger="oom")
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return need


def guarded(run, host_fallback=None):
    """run() under the OOM ladder (see the module docstring).
    ``host_fallback`` is the degraded-mode closure; None re-raises after
    the retry."""
    def attempt():
        if faults.take("device-oom"):
            raise InjectedOOM("RESOURCE_EXHAUSTED: out of memory injected "
                              "by pilosa_tpu_torch.memory.pressure."
                              "inject_oom")
        return run()
    try:
        return attempt()
    except Exception as e:
        if not is_oom(e):
            raise
        metrics.OOM_TOTAL.inc(outcome="caught")
        # an OOM-ladder trip is the moment whose residency and flight
        # state an operator needs later: one rate-limited incident
        # bundle, captured off this thread before the relief sweep
        from pilosa_tpu_torch.obs import incidents
        incidents.report("device-oom", detail=type(e).__name__,
                         context={"message": str(e)[:300]})
        relieve()
        if OOM_RETRY:
            try:
                out = attempt()
                metrics.OOM_TOTAL.inc(outcome="retry_ok")
                return out
            except Exception as e2:
                if not is_oom(e2):
                    raise
        if host_fallback is not None and HOST_FALLBACK:
            metrics.OOM_TOTAL.inc(outcome="host_fallback")
            _log.warning("device out of memory after the relief sweep and "
                         "a retry; this query runs on the host (degraded)")
            return host_fallback()
        metrics.OOM_TOTAL.inc(outcome="raised")
        raise


def run_host_plan(plan, leaves, params):
    """The host fallback of a stacked engine on the CPU: the same plan run
    again over its CPU leaves and params.  A device tensor is refused: a
    plan on the card never moves to the kernels' plain versions."""
    from pilosa_tpu_torch.executor import stacked
    for x in (*leaves, *params):
        if isinstance(x, torch.Tensor) and x.device.type != "cpu":
            raise ValueError(f"run_host_plan: a {x.device.type} tensor; "
                             "only a plan on the CPU has a host fallback")
    return stacked._plan_run(plan)(leaves, params)
