"""The plain reference: a joint histogram of every column's values.

Each column of a configuration is one cell of a cube with one axis a
field: a categorical field's row (its last index is "absent"), a
multi-row set field's row bit vector, an int field's value bucket.  The
cube's counts (and, for each int field, the sum of its values) are
built from ``data.chunk_values``, the same seeded values the run's
set-up packs for the port, and every query of the mixes is a sum over
a slice of it: a count, a Sum, the per-row counts of a TopN, the groups
of a GroupBy.  Nothing here reads the port.

An int field's bucket is its value (``unit`` 1) or, for a range drawn
in whole units, two buckets a unit: the value on the unit, and the rest
of the unit above it, so a range [lo, hi] of whole units is a slice.
``dtype`` float32 gives the control, the same sums rounded to float32.
``fields`` keeps an axis for the fields a mix reads only; every other
field is summed out as its values are drawn, which leaves each answer
the same.
"""

from __future__ import annotations

import torch

from gpubench import data


def axis_size(f: dict) -> int:
    if f["kind"] == "int":
        span = int(f["max"]) - int(f["min"])
        unit = int(f.get("unit", 1))
        return span + 1 if unit == 1 else 2 * (span // unit) + 2
    if "bits" in f:
        return 1 << int(f["rows"])
    return int(f["rows"]) + 1


def axis_index(f: dict, v: torch.Tensor) -> torch.Tensor:
    if f["kind"] != "int":
        return v
    mag = v - int(f["min"])
    unit = int(f.get("unit", 1))
    if unit == 1:
        return mag
    return 2 * (mag // unit) + (mag % unit != 0).to(torch.int64)


def bucket_range(f: dict, lo: int, hi: int) -> tuple[int, int]:
    """The buckets of lo <= value <= hi (whole units of the field)."""
    unit = int(f.get("unit", 1))
    lo, hi = lo - int(f["min"]), hi - int(f["min"])
    if unit == 1:
        return lo, hi
    if lo % unit or hi % unit:
        raise ValueError(f"{f['name']}: bounds {lo}, {hi} not in whole "
                         f"units of {unit}")
    return 2 * (lo // unit), 2 * (hi // unit)


class Cube:
    """Counts and int-field sums over every column of a configuration."""

    def __init__(self, cfg: dict, seed: int, device, dtype=torch.int64,
                 fields=None):
        self.cfg = cfg
        axes = [f for f in cfg["fields"]
                if fields is None or f["name"] in fields]
        self.fields = {f["name"]: f for f in axes}
        self.names = [f["name"] for f in axes]
        self.shape = tuple(axis_size(f) for f in axes)
        n = 1
        for s in self.shape:
            n *= s
        acc = torch.float64 if dtype == torch.int64 else dtype
        count = torch.zeros(n, dtype=acc, device=device)
        ints = [f["name"] for f in axes if f["kind"] == "int"]
        sums = {k: torch.zeros(n, dtype=acc, device=device) for k in ints}
        width = int(cfg["shard_width"])
        for chunk, _s0, shards in data.chunks(cfg):
            vals = data.chunk_values(cfg, seed, chunk, shards * width,
                                     device)
            idx = torch.zeros_like(vals[self.names[0]])
            for f, size in zip(axes, self.shape):
                idx = idx * size + axis_index(f, vals[f["name"]])
            ones = torch.ones(idx.numel(), dtype=acc, device=device)
            # float64 holds every partial sum of a chunk exactly
            count += torch.bincount(idx, weights=ones, minlength=n)
            for k in ints:
                sums[k] += torch.bincount(idx, weights=vals[k].to(acc),
                                          minlength=n)
            del vals, idx, ones
        self.count = count.to(dtype).view(self.shape)
        self.sums = {k: v.to(dtype).view(self.shape) for k, v in sums.items()}

    def _masks(self, where: list) -> list:
        masks = [None] * len(self.names)
        for c in where:
            d = self.names.index(c["field"])
            f = self.fields[c["field"]]
            m = torch.zeros(self.shape[d], dtype=torch.bool,
                            device=self.count.device)
            if "between" in c:
                lo, hi = bucket_range(f, *c["between"])
                m[lo:hi + 1] = True
            elif "bits" in f:
                m[(torch.arange(self.shape[d], device=m.device)
                   >> int(c["eq"])) & 1 == 1] = True
            else:
                m[int(c["eq"])] = True
            masks[d] = m if masks[d] is None else masks[d] & m
        return masks

    def _slice(self, t: torch.Tensor, masks: list, keep=()) -> torch.Tensor:
        """The cells under ``masks``; an axis in ``keep`` keeps its
        length (its masked-out cells zeroed) so its indices stay rows."""
        kept = [self.names.index(k) for k in keep]
        for d, m in enumerate(masks):
            if m is None:
                continue
            if d in kept:
                shape = [1] * t.ndim
                shape[d] = -1
                t = t * m.view(shape).to(t.dtype)
            else:
                t = t.index_select(d, m.nonzero().squeeze(1))
        return t

    def _keep(self, t: torch.Tensor, keep: list[str]) -> torch.Tensor:
        """Sum out every axis but ``keep``, in the order of ``keep``."""
        dims = [self.names.index(k) for k in keep]
        other = [d for d in range(t.ndim) if d not in dims]
        if other:
            t = t.sum(dim=other)
        order = sorted(dims)
        return t.permute([order.index(d) for d in dims])

    def answer(self, spec: dict):
        """The canonical answer to a query spec (gpubench/mix.py)."""
        masks = self._masks(spec.get("where", []))
        op = spec["op"]
        keep = (spec["group"] if op == "groupby"
                else [spec["field"]] if op == "topn" else [])
        count = self._slice(self.count, masks, keep)
        if op == "count":
            return int(count.sum())
        if op == "sum":
            s = self._slice(self.sums[spec["field"]], masks)
            return (int(s.sum()), int(count.sum()))
        if op == "topn":
            f = self.fields[spec["field"]]
            per = self._keep(count, [f["name"]])
            rows = int(f["rows"])
            if "bits" in f:
                v = torch.arange(per.numel(), device=per.device)
                counts = [int(per[(v >> r) & 1 == 1].sum())
                          for r in range(rows)]
            else:
                counts = [int(x) for x in per[:rows].tolist()]
            # every row that holds a column, highest count first: the
            # rows tied at the n-th count are all candidates
            return sorted(((r, c) for r, c in enumerate(counts) if c > 0),
                          key=lambda p: (-p[1], p[0]))
        if op == "groupby":
            group = list(spec["group"])
            for g in group:
                if "bits" in self.fields[g] or self.fields[g]["kind"] == "int":
                    raise ValueError(f"GroupBy over {g}: not a one-row-a-"
                                     "column field")
            cut = tuple(slice(0, int(self.fields[g]["rows"])) for g in group)
            counts = self._keep(count, group)[cut].cpu()
            agg = spec.get("aggregate", "count")
            sums = None
            if agg == "sum":
                sums = self._keep(self._slice(self.sums[spec["field"]], masks,
                                              keep), group)[cut].cpu()
            out = []
            for key in counts.nonzero().tolist():
                k = tuple(key)
                out.append((k, int(counts[k]),
                            None if sums is None else int(sums[k])))
            for col, d in reversed(spec.get("order") or []):   # stable
                out.sort(key=lambda r: r[1] if col == "count"
                         else r[0][group.index(col)], reverse=d == "desc")
            return out
        raise ValueError(f"unknown op {op!r}")
