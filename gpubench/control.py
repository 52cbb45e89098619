"""The control of ``correct``: the reference put in the port's place and
computed one precision down.

The configurations state exact answers and no precision; the nearest
step below exact integer arithmetic is float32, the precision a later
change could be tempted to count or sum in.  The control draws the
requests a run of the cell sends (the first ``--requests`` of its
stream), answers each from a float32 cube and holds it to the
int64 reference as a run is held: its ``wrong`` has to come out above
0, where every run of the port reads 0.

    python3 -m gpubench.control --workload <cell> --seed <n> --requests <k>

runs it at the cell's own size on the card; the benchmark's own runs do
not.  ``tests/test_gpubench_control.py`` runs it at a size a test holds.
"""

from __future__ import annotations

import argparse
import itertools
import json
import sys

import torch

from gpubench import answers
from gpubench import manifest as man
from gpubench import mix as mixmod
from gpubench.reference import Cube


def requests(cell: dict, cfg: dict, seed: int, k: int) -> list[dict]:
    """The first ``k`` requests of the cell's stream."""
    mix = mixmod.Mix(mixmod.load(cell["traffic"]), cfg)
    return list(itertools.islice(mix.stream(seed), k))


def wrong(cell_name: str, seed: int, k: int, device,
          cfg_over: dict | None = None) -> tuple[int, int]:
    """(wrong answers of the float32 control, requests compared)."""
    m = man.load()
    cell = man.cell(m, cell_name)
    cfg = dict(man.config(cell["config"]), **(cfg_over or {}))
    specs = requests(cell, cfg, seed, k)
    read = mixmod.Mix(mixmod.load(cell["traffic"]), cfg).fields()
    exact = Cube(cfg, seed, device, fields=read)
    want = [exact.answer(s) for s in specs]
    del exact
    low = Cube(cfg, seed, device, dtype=torch.float32, fields=read)
    bad = 0
    for s, w in zip(specs, want):
        got = low.answer(s)
        if s["op"] == "topn":
            got = got[:int(s["n"])]        # the reply's n rows
        bad += not answers.same(s, got, w)
    return bad, len(specs)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="the float32 control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--requests", type=int, default=1000)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    bad, n = wrong(args.workload, args.seed, args.requests,
                   torch.device("cuda", 0))
    print(json.dumps({"workload": args.workload, "seed": args.seed,
                      "wrong": bad, "compared": n}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
