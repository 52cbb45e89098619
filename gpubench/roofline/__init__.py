"""One file a port kernel: the bytes and operations of one launch,
counted from its logical operands as ``chip_smoke.py``'s phase 3 counts
them (each input read once, each output written once), and the names
its launches carry in a profiler trace.

A file defines ``KERNEL`` (the name ``ops/kernels.py`` counts launches
under), ``SYMBOLS`` (substrings of its CUDA kernels' names) and
``WRAPPERS``: for each wrapper of ``ops/kernels.py`` that launches it,
a function of the wrapper's arguments that returns {"bytes", "ops",
"popcs", "tensor_ops"}.  Where a term depends on data the launch's
arguments do not show, the file counts the least it can be, so that a
share of the bound is never overstated.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path

HERE = Path(__file__).resolve().parent


def load_all() -> dict:
    """Every kernel file of this folder, by KERNEL."""
    out = {}
    for p in sorted(HERE.glob("*.py")):
        if p.name.startswith("_"):
            continue
        spec = importlib.util.spec_from_file_location(
            f"gpubench.roofline.{p.stem}", p)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        out[mod.KERNEL] = mod
    return out


def words(t) -> int:
    """Elements of a tensor of int32 words."""
    return t.numel()


def shards_read(t) -> int:
    """Shards a (S, ...) stack holds in memory: one at shard stride 0."""
    return 1 if t.stride(0) == 0 else t.shape[0]
