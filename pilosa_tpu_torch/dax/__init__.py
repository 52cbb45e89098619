"""DAX — disaggregated serverless deployment (dax/, SURVEY §2.8).

The reference's storage/compute split: stateless *compute* workers own
table-shard "jobs" assigned by a *controller*; all durable state lives
in a shared write-log + snapshot store, so any worker can pick up any
shard by loading its snapshot and replaying the log.  A stateless
*queryer* fans queries out to whichever workers currently own the
touched shards.

This maps onto the port's own split (host storage is the source of
truth, the card's stacks are a cache): a compute worker is an engine
node whose executor launches the port's CUDA kernels on one card;
elastic recovery is "replay the log into a fresh worker".  Every
worker of a ``DAXService`` runs on the card unless the service is
given ``device="cpu"``.

Components (reference files):
    Controller  — dax/controller/, balancer/balancer.go, poller/poller.go
    Directive   — dax/directive.go:8; api_directive.go:19,172,559
    Computer    — dax/computer/
    Queryer     — dax/queryer/queryer.go:34, orchestrator.go:83
    WriteLogger — dax/writelogger/writelogger.go:22
    Snapshotter — dax/snapshotter/snapshotter.go:24
"""

# PEP 562 lazy re-exports: config application touches
# pilosa_tpu_torch.dax.settings on every server boot, and /debug/dax reads
# the light registries — neither should drag the queryer/executor
# stack in.  `from pilosa_tpu_torch.dax import Controller` etc. keep
# working exactly as the eager imports did.
_EXPORTS = {
    "Controller": "pilosa_tpu_torch.dax.controller",
    "ComputeNode": "pilosa_tpu_torch.dax.computer",
    "Directive": "pilosa_tpu_torch.dax.directive",
    "Queryer": "pilosa_tpu_torch.dax.queryer",
    "Snapshotter": "pilosa_tpu_torch.dax.snapshotter",
    "WriteLogger": "pilosa_tpu_torch.dax.writelogger",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute "
                             f"{name!r}")
    import importlib
    return getattr(importlib.import_module(mod), name)
