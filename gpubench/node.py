"""One in-process node of the port, loaded with a configuration's data.

The node is what ``server/http.py``'s ``Server`` builds, without its
listener: an ``API`` over a ``Holder`` in memory, the serving layer set
from a ``Config`` (the configuration file's ``node`` section over the
defaults of ``config.py``), and every plane's ``configure()`` through
``Config.apply_all``.  The words come from ``data.py`` on the device
and go to the port through its bulk path, ``Fragment.import_row_words``.
"""

from __future__ import annotations

import numpy as np
import torch

from gpubench import data


def _create_fields(idx, cfg: dict):
    from pilosa_tpu_torch.models.schema import (
        CACHE_TYPE_NONE, FieldOptions, FieldType)
    from pilosa_tpu_torch.models.view import VIEW_STANDARD
    views = {}
    for f in cfg["fields"]:
        if f["kind"] == "int":
            fld = idx.create_field(f["name"], FieldOptions(
                type=FieldType.INT, min=int(f["min"]), max=int(f["max"])))
            views[f["name"]] = fld.view(fld.bsi_view, create=True)
        else:
            kind = FieldType.MUTEX if f["kind"] == "mutex" else FieldType.SET
            fld = idx.create_field(f["name"], FieldOptions(
                type=kind, cache_type=CACHE_TYPE_NONE))
            views[f["name"]] = fld.view(VIEW_STANDARD, create=True)
    return views


def load_holder(cfg: dict, seed: int, device):
    """A Holder with the configuration's index, its words drawn on
    ``device`` from ``seed`` a chunk of shards at a time; a row a shard
    with no column set is not imported."""
    from pilosa_tpu_torch.models.holder import Holder
    width = int(cfg["shard_width"])
    h = Holder(width=width)
    idx = h.create_index(cfg["index"], track_existence=False)
    views = _create_fields(idx, cfg)
    for chunk, s0, shards in data.chunks(cfg):
        vals = data.chunk_values(cfg, seed, chunk, shards * width, device)
        for f in cfg["fields"]:
            words = data.field_words(f, vals[f["name"]], shards, width)
            live = words.ne(0).any(-1).cpu().numpy()
            host = words.cpu().numpy().view(np.uint32)
            del words
            view = views[f["name"]]
            for s in range(shards):
                frag = view.fragment(s0 + s, create=True)
                for r in np.flatnonzero(live[:, s]):
                    frag.import_row_words(int(r), host[r, s])
        del vals
    return h


def start(h, cfg: dict, device, seed: int):
    """The node over holder ``h``: an API with the serving layer and
    the planes as ``Server`` sets them from the configuration's
    ``node`` settings, the audit plane's sampler seeded from ``seed``.
    Returns the API."""
    from pilosa_tpu_torch.api import API
    from pilosa_tpu_torch.config import Config
    config = Config(**cfg.get("node", {}))
    config.check_supported()
    api = API(h, device)
    ex = api.executor
    if config.serving_batching or config.serving_cache_mb > 0:
        ex.enable_serving(
            window_s=config.serving_batch_window_ms / 1e3,
            max_batch=config.serving_batch_max,
            cache_bytes=config.serving_cache_mb << 20,
            batching=config.serving_batching,
            ragged=config.serving_ragged,
            admission=config.serving_admission,
            heavy_slots=config.serving_heavy_slots,
            queue_max=config.serving_queue_max,
            tenant_weights=config.serving_tenant_weights,
            default_deadline_ms=config.serving_default_deadline_ms)
        ex.serving.audit.seed(seed)
    config.apply_all(data_dir=None)
    if ex.serving is not None and config.memory_prefetch:
        ex.serving.start_prefetcher(
            interval_s=config.memory_prefetch_interval_s)
    return api


def stop(api) -> None:
    """Stop the serving layer and every plane's thread.  The samples
    the audit has queued are dropped first: a shadow run after the
    window would only slow the reference."""
    from pilosa_tpu_torch.obs import audit, incidents, profiler, watchdog
    for plane in list(audit._PLANES):
        with plane._cv:
            plane._queue.clear()
    if api.executor.serving is not None:
        api.executor.serving.close()
    audit.stop_all()
    watchdog.stop()
    incidents.get().stop()
    profiler.configure_continuous(enabled=False)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
