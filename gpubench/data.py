"""Seeded column values of a configuration, and their packed words.

A configuration file (``configs/<name>.json``) lists its fields; each
field's values are drawn here, a chunk of shards at a time, on the
device, from a ``torch.Generator`` seeded by the run's seed, the field
and the chunk.  The same call gives the same values in the run's set-up
(which packs them into the words the port imports) and in the reference
(which histograms them), so the two never share a tensor.

Field kinds:

- ``set`` with ``bits``: each of ``rows`` rows holds each column with
  probability ``p``; a column's value is its row bit vector.
- ``set`` or ``mutex`` with ``weights``: one row a column, drawn from
  ``weights`` (a list, or ``{"geometric": {"mean", "cap"}}``), absent
  with weight ``absent``; ``given`` makes the weights depend on an
  earlier field's value (one list a value).  The value ``rows`` means
  absent.
- ``int``: a BSI field, every column holding a value in [min, max],
  ``uniform`` or ``lognormal`` (``median``, ``sigma``, clipped).
"""

from __future__ import annotations

import hashlib
import math

import torch


def seed_for(seed: int, *parts) -> int:
    """A 63-bit generator seed from the run's seed and names."""
    h = hashlib.blake2b(repr((int(seed),) + parts).encode(), digest_size=8)
    return int.from_bytes(h.digest(), "little") >> 1


def depth_of(field: dict) -> int:
    """BSI planes of an int field: bits of max - min."""
    return max(int(field["max"]) - int(field["min"]), 1).bit_length()


def weights_of(spec) -> list[float]:
    if isinstance(spec, dict) and "geometric" in spec:
        g = spec["geometric"]
        q = 1.0 / (float(g["mean"]) + 1.0)
        cap = int(g["cap"])
        w = [q * (1 - q) ** k for k in range(cap)]
        return w + [1.0 - sum(w)]          # the tail folds into the cap
    return [float(x) for x in spec]


def _cdf(weights: list[float], absent: float, device) -> torch.Tensor:
    w = torch.tensor(weights + [absent], dtype=torch.float64)
    c = torch.cumsum(w / w.sum(), 0)[:-1]
    return c.to(torch.float32).to(device)


def chunks(cfg: dict):
    """(chunk index, first shard, shards) of the configuration."""
    step = int(cfg["chunk_shards"])
    for i, s0 in enumerate(range(0, int(cfg["shards"]), step)):
        yield i, s0, min(step, int(cfg["shards"]) - s0)


def chunk_values(cfg: dict, seed: int, chunk: int, n_cols: int,
                 device) -> dict:
    """Every field's values over one chunk's columns, in field order:
    int64 tensors (n_cols,) on device."""
    out = {}
    for f in cfg["fields"]:
        g = torch.Generator(device=device)
        g.manual_seed(seed_for(seed, cfg["name"], f["name"], chunk))
        kind = f["kind"]
        if kind == "int":
            lo, hi = int(f["min"]), int(f["max"])
            dist = f["dist"]
            if "uniform" in dist:
                v = torch.randint(lo, hi + 1, (n_cols,), generator=g,
                                  device=device)
            else:
                ln = dist["lognormal"]
                z = torch.randn(n_cols, generator=g, device=device,
                                dtype=torch.float64)
                v = torch.exp(z * float(ln["sigma"])
                              + math.log(float(ln["median"])))
                v = torch.round(v).clamp_(lo, hi).to(torch.int64)
            out[f["name"]] = v
        elif "bits" in f:
            rows = int(f["rows"])
            u = torch.rand((n_cols, rows), generator=g, device=device)
            bits = (u < float(f["bits"]["p"])).to(torch.int64)
            out[f["name"]] = (bits << torch.arange(rows, device=device)
                              ).sum(1)
        else:
            u = torch.rand(n_cols, generator=g, device=device)
            absent = float(f.get("absent", 0.0))
            if "given" in f:
                given = out[f["given"]["field"]]
                cdfs = torch.stack([_cdf(weights_of(w), absent, device)
                                    for w in f["given"]["weights"]])
                v = (cdfs[given] <= u.unsqueeze(1)).sum(1)
            else:
                v = torch.searchsorted(_cdf(weights_of(f["weights"]), absent,
                                            device), u, right=True)
            out[f["name"]] = v.to(torch.int64)
    return out


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """Bool (..., n) with n a multiple of 32 → int32 words (..., n // 32),
    column c at bit c % 32 of word c // 32."""
    shifts = torch.arange(32, device=bits.device, dtype=torch.int64)
    w = (bits.reshape(*bits.shape[:-1], -1, 32).to(torch.int64)
         << shifts).sum(-1)
    return torch.where(w >= 1 << 31, w - (1 << 32), w).to(torch.int32)


def field_words(f: dict, v: torch.Tensor, n_shards: int,
                shard_width: int) -> torch.Tensor:
    """The rows of one field over a chunk: int32 (rows, shards, W).  An
    int field's rows are its BSI view's: exists, sign, then one a bit."""
    if f["kind"] == "int":
        mag = v - int(f["min"])
        rows = [lambda: torch.ones_like(v, dtype=torch.bool),
                lambda: torch.zeros_like(v, dtype=torch.bool)]
        rows += [lambda p=p: ((mag >> p) & 1).bool()
                 for p in range(depth_of(f))]
    elif "bits" in f:
        rows = [lambda r=r: ((v >> r) & 1).bool()
                for r in range(int(f["rows"]))]
    else:
        rows = [lambda r=r: v == r for r in range(int(f["rows"]))]
    out = torch.empty((len(rows), v.numel() // 32), dtype=torch.int32,
                      device=v.device)
    for i, row in enumerate(rows):   # a row at a time bounds the memory
        out[i] = pack_bits(row())
    return out.view(len(rows), n_shards, shard_width // 32)
