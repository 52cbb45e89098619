#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (pilosa_tpu_torch).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, each printing its own lines; any failure exits non-zero:

1. card   — nvidia-smi name and power limit, torch's device name
2. build  — nvcc builds every kernel from pilosa_tpu_torch/ops/csrc
3. kernels — each of the six CUDA kernels at the query path's shapes
   (954 shards x 32768 words, 8 TopN rows, BSI depth 7, with and
   without a filter; the GroupBy histogram at the able shape of 7 code
   bits, signed, unsigned and with Min/Max, at 9 code bits (240
   combos), as the value histogram of age, and past shared memory at
   4096 codes x depth 16 on 64 shards; the per-combo kernel at the 8
   combos of GroupBy(Rows(t), Rows(a))) on seeded random words, held
   to its plain PyTorch version exactly (integer outputs, tolerance 0),
   then timed with CUDA events beside its bound; and a disjoint field
   of 2, 4 and 8 rows through both GroupBy arms, held equal and timed
4. main path — the headline index (954 shards x 2^20 columns, random-
   word fields a, b, t, a 7-plane BSI field age and the disjoint
   categorical fields edu, gen, dom, reg, about 4.6 GB of words on the
   card) built through the port's model API and queried through
   Executor.execute: the headline queries, GroupBy (one-pass and per
   combo), Min, Max and Distinct.  Every answer is held exactly to an
   independent numpy reference, and every kernel's launch counter must
   have grown during this phase

It then prints the kernels' JSON line, the card's name and power limit,
and last {"ok": true, "device": {...}}.  Without a CUDA card it exits
non-zero before printing any result.
"""

from __future__ import annotations

import itertools
import json
import statistics
import subprocess
import sys
import time

S, W, R, DEPTH = 954, 32768, 8, 7
S_WIDE = 64                 # shards of the over-shared-memory histogram
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory rate
OPS_PER_S = 67e12           # H100 non-tensor 32-bit peak, used for bit ops
SRC = {
    "popcount_rows": "pilosa_tpu_torch/ops/csrc/bitmap_kernels.cu",
    "pair_popcount": "pilosa_tpu_torch/ops/csrc/bitmap_kernels.cu",
    "rows_filter_counts": "pilosa_tpu_torch/ops/csrc/bitmap_kernels.cu",
    "bsi_sum_counts": "pilosa_tpu_torch/ops/csrc/bitmap_kernels.cu",
    "groupby_fused": "pilosa_tpu_torch/ops/csrc/groupby_kernels.cu",
    "groupby_sum": "pilosa_tpu_torch/ops/csrc/groupby_kernels.cu",
}
REPLACES = {
    "popcount_rows": "pilosa_tpu/ops/kernels.py:128",
    "pair_popcount": "pilosa_tpu/ops/kernels.py:160",
    "rows_filter_counts": "pilosa_tpu/ops/kernels.py:310",
    "bsi_sum_counts": "pilosa_tpu/ops/kernels.py:251",
    "groupby_fused": "pilosa_tpu/ops/kernels.py:867",
    "groupby_sum": "pilosa_tpu/ops/kernels.py:411",
}
# categorical fields of the able GroupBy (bench/common.py:129): rows
CATEGORIES = {"edu": 6, "gen": 2, "dom": 5, "reg": 4}


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device milliseconds of fn() over reps, CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes: int, ops: int) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def random_words(gen, shape, device):
    """Seeded random int32 words with 0x80000000 and 0xFFFFFFFF lanes."""
    import torch
    x = torch.randint(-2**31, 2**31, shape, generator=gen, device=device,
                      dtype=torch.int32)
    x[..., 3::97] = -2**31   # 0x80000000: the sign bit alone
    x[..., 5::101] = -1      # 0xFFFFFFFF
    return x


def _increments(out) -> int:
    """Histogram increments of a groupby_fused result: the sum of its
    table, what this run's data made the kernel add."""
    import torch
    return sum(int(x.sum(dtype=torch.int64)) for x in out[:4]
               if x is not None)


def phase_kernels(device) -> dict:
    """Each kernel against its plain version at main-path shapes, then
    timed.  Returns per-kernel records (launches filled in later)."""
    import torch
    from pilosa_tpu_torch.ops import kernels as K

    gen = torch.Generator(device=device)
    gen.manual_seed(20261016)
    a = random_words(gen, (S, W), device)
    b = random_words(gen, (S, W), device)
    rows = random_words(gen, (R, S, W), device)
    planes = random_words(gen, (S, 2 + DEPTH, W), device)
    codes = random_words(gen, (S, 9, W), device)
    able = codes[:, :7]
    wide_codes = random_words(gen, (S_WIDE, 12, W), device)
    wide_planes = random_words(gen, (S_WIDE, 2 + 16, W), device)
    # GroupBy(Rows(t), Rows(a)) as the main path lays it out: the 8 t
    # rows and the one a row, combo r = (t row r, a row 0)
    sel = torch.tensor([[r, 0] for r in range(R)], dtype=torch.int32,
                       device=device)
    stacks = [rows, a.unsqueeze(0)]
    stack = S * W * 4
    words = S * W

    def hist_bytes(cb, signed):
        return K.groupby_onepass_hbm_bytes(S, W, cb, DEPTH, signed=signed)

    def hist_ops(cb, signed):
        # one op per word read plus one per histogram increment
        return lambda out: hist_bytes(cb, signed) // 4 + _increments(out)

    gb_cases = [
        ("groupby_fused", f"able ({S}, 7, {W}) + ({S}, {2 + DEPTH}, {W}) "
         "unsigned, G=128",
         lambda: K.groupby_fused(able, a, planes, 128, signed=False),
         lambda: K.groupby_codes_plain(able, a, planes, 128, signed=False),
         hist_bytes(7, False) + (2 + DEPTH) * 128 * 4,
         hist_ops(7, False), 20, 1),
        ("groupby_fused", "able signed, G=128",
         lambda: K.groupby_fused(able, a, planes, 128),
         lambda: K.groupby_codes_plain(able, a, planes, 128),
         hist_bytes(7, True) + (2 + 2 * DEPTH) * 128 * 4,
         hist_ops(7, True), 20, 1),
        ("groupby_fused", "able signed + minmax, G=128",
         lambda: K.groupby_fused(able, a, planes, 128, minmax=True),
         lambda: K.groupby_codes_plain(able, a, planes, 128, minmax=True),
         hist_bytes(7, True) + (2 + 2 * DEPTH + 4) * 128 * 4,
         # one atomicMax and one atomicMin per exists column besides
         lambda out: (hist_ops(7, True)(out)
                      + 2 * int(out[1].sum(dtype=torch.int64))), 20, 1),
        ("groupby_fused", f"240 combos ({S}, 9, {W}) + ({S}, {2 + DEPTH}, "
         f"{W}) unsigned, G=512",
         lambda: K.groupby_fused(codes, a, planes, 512, signed=False),
         lambda: K.groupby_codes_plain(codes, a, planes, 512, signed=False),
         hist_bytes(9, False) + (2 + DEPTH) * 512 * 4,
         hist_ops(9, False), 20, 1),
        ("groupby_fused", f"bsi_value_hist of age ({S}, {2 + DEPTH}, {W}), "
         "G=256",
         lambda: K.bsi_value_hist(planes), lambda: K.bsi_value_hist_plain(planes),
         K.groupby_onepass_hbm_bytes(S, W, DEPTH + 1) + 256 * 4,
         lambda out: (2 + DEPTH) * words + sum(int(x.sum(dtype=torch.int64))
                                               for x in out), 20, 1),
        ("groupby_fused", f"past shared memory: ({S_WIDE}, 12, {W}) + "
         f"({S_WIDE}, 18, {W}) signed, G=4096, K=34 (557 KB table)",
         lambda: K.groupby_fused(wide_codes, a[:S_WIDE], wide_planes, 4096),
         lambda: K.groupby_codes_plain(wide_codes, a[:S_WIDE], wide_planes,
                                       4096),
         K.groupby_onepass_hbm_bytes(S_WIDE, W, 12, 16) + 34 * 4096 * 4,
         lambda out: (12 + 1 + 18) * S_WIDE * W + _increments(out), 5, 1),
        ("groupby_sum", f"C={R} of ({R}, {S}, {W}) x (1, {S}, {W}) + "
         f"({S}, {2 + DEPTH}, {W}) unsigned",
         lambda: K.groupby_sum(stacks, sel, planes, signed=False),
         lambda: K.groupby_sum_plain(stacks, sel, planes, signed=False),
         K.groupby_percombo_hbm_bytes(S, W, R + 1, DEPTH, signed=False)
         + R * (2 + 2 * DEPTH) * 4,
         R * (2 + 2 + 5 * DEPTH) * words, 20, 1),
    ]
    cases = [
        # name, shape label, kernel call, plain call, bytes, word-ops
        ("popcount_rows", f"({S}, {W})", lambda: K.popcount_rows(a),
         lambda: K.popcount_rows_plain(a), stack + S * 4, 2 * S * W),
        ("popcount_rows", f"({R * S}, {W})",
         lambda: K.popcount_rows(rows.view(R * S, W)),
         lambda: K.popcount_rows_plain(rows.view(R * S, W)),
         R * stack + R * S * 4, 2 * R * S * W),
        ("pair_popcount", f"({S}, {W}) x2", lambda: K.pair_popcount(a, b),
         lambda: K.pair_popcount_plain(a, b), 2 * stack + S * 4,
         3 * S * W),
        ("rows_filter_counts", f"({R}, {S}, {W}) & ({S}, {W})",
         lambda: K.rows_filter_counts(rows, a),
         lambda: K.rows_filter_counts_plain(rows, a),
         (R + 1) * stack + R * S * 4, 3 * R * S * W),
        ("bsi_sum_counts", f"({S}, {2 + DEPTH}, {W}) & ({S}, {W})",
         lambda: K.bsi_sum_counts(planes, a),
         lambda: K.bsi_sum_counts_plain(planes, a),
         (3 + DEPTH) * stack + S * (1 + 2 * DEPTH) * 4,
         (5 + 6 * DEPTH) * S * W),
        ("bsi_sum_counts", f"({S}, {2 + DEPTH}, {W}) no filter",
         lambda: K.bsi_sum_counts(planes, None),
         lambda: K.bsi_sum_counts_plain(planes, None),
         (2 + DEPTH) * stack + S * (1 + 2 * DEPTH) * 4,
         (4 + 6 * DEPTH) * S * W),
    ]
    cases = [c + (50, 3) for c in cases] + gb_cases
    records = {}
    for name, label, kern, plain, nbytes, ops, reps, plain_reps in cases:
        got, want = kern(), plain()
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        if len(got) != len(want):
            raise AssertionError(f"{name} {label}: {len(got)} outputs vs "
                                 f"{len(want)}")
        err = 0
        for g, w in zip(got, want):
            if g is None or w is None:
                if g is not w:
                    raise AssertionError(f"{name} {label}: None mismatch")
                continue
            if g.shape != w.shape or g.dtype != w.dtype:
                raise AssertionError(f"{name} {label}: kernel {g.shape} "
                                     f"{g.dtype} vs plain {w.shape} {w.dtype}")
            if g.numel():
                err = max(err, int((g.to(torch.int64) - w.to(torch.int64))
                                   .abs().max()))
        if err != 0:
            raise AssertionError(f"{name} {label}: kernel differs from "
                                 f"its plain version, max |err| {err}")
        n_ops = ops(got) if callable(ops) else ops
        ms = cuda_ms(kern, reps=reps)
        plain_ms = cuda_ms(plain, reps=plain_reps, warmup=1)
        bound_ms, bound_by = bound(nbytes, n_ops)
        print(f"kernel {name} {label}: exact vs plain; {ms:.4f} ms "
              f"(plain {plain_ms:.4f} ms), bound {bound_ms:.4f} ms by "
              f"{bound_by} ({bound_ms / ms:.1%} of bound; {nbytes} bytes, "
              f"{n_ops} ops), library none (no single PyTorch call "
              "computes this from packed words)")
        records.setdefault(name, {
            "name": name, "route": "cuda", "source": SRC[name],
            "replaces": REPLACES[name], "launches": 0,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None})
    compare_arms(device, codes, planes)
    return records


def compare_arms(device, codes, planes) -> None:
    """GroupBy Sum over one disjoint field of 2, 4 and 8 rows through
    both arms: the engine takes the one-pass histogram wherever its
    bounds hold, and this holds it to the per-combo kernel and times
    both at full width, which shows where per combo would be faster."""
    import torch
    from pilosa_tpu_torch.ops import kernels as K
    ones = torch.full((S, W), -1, dtype=torch.int32, device=device)
    for bits in (1, 2, 3):
        cp = codes[:, :bits]
        n = 1 << bits
        rows = []
        for v in range(n):
            acc = ones.clone()
            for b in range(bits):
                acc &= cp[:, b] if (v >> b) & 1 else ~cp[:, b]
            rows.append(acc)
        rows = torch.stack(rows)
        sel = torch.arange(n, dtype=torch.int32, device=device).view(n, 1)

        def one():
            return K.groupby_fused(cp, ones, planes, n, signed=False)

        def per():
            return K.groupby_sum([rows], sel, planes, signed=False)

        for x, y in zip(one(), per()):
            if not torch.equal(x, y):
                raise AssertionError(f"arms: {n} rows: one-pass and "
                                     "per-combo disagree")
        print(f"arms: GroupBy Sum of a disjoint {n}-row field ({S}, {W}), "
              f"equal on both arms; one-pass {cuda_ms(one, reps=10):.4f} "
              f"ms, per-combo {cuda_ms(per, reps=10):.4f} ms")
        del rows


def disjoint_category_rows(rng, n_rows: int):
    """Rows of a categorical field (bench/common.py:81-97): every column
    holds at most one row.  ceil(log2 R) random bit-planes are each
    column's digit; digits >= R mean the attribute is absent.  Returns
    the digit planes (bits, S, W) and the rows, each (S, W)."""
    import numpy as np
    bits = max(n_rows - 1, 0).bit_length()
    planes = rng.integers(0, 1 << 32, size=(max(bits, 1), S, W),
                          dtype=np.uint32)
    rows = []
    for r in range(n_rows):
        acc = np.full((S, W), 0xFFFFFFFF, dtype=np.uint32)
        for b in range(bits):
            acc &= planes[b] if (r >> b) & 1 else ~planes[b]
        rows.append(acc)
    return planes[:bits], rows


def build_index():
    """The headline index (bench/common.py build_index shape) through
    the port's model API; returns the holder and the generated words."""
    import numpy as np
    from pilosa_tpu_torch.models.holder import Holder
    from pilosa_tpu_torch.models.schema import (
        CACHE_TYPE_NONE, FieldOptions, FieldType)
    from pilosa_tpu_torch.models.view import VIEW_STANDARD

    rng = np.random.default_rng(7)
    h = Holder(width=W * 32)
    idx = h.create_index("bench", track_existence=False)
    data = {}
    for fname, nrows in (("a", 1), ("b", 1), ("t", R)):
        f = idx.create_field(fname, FieldOptions(cache_type=CACHE_TYPE_NONE))
        view = f.view(VIEW_STANDARD, create=True)
        words = rng.integers(0, 1 << 32, size=(nrows, S, W), dtype=np.uint32)
        row_ids = [1] if nrows == 1 else list(range(nrows))
        for shard in range(S):
            frag = view.fragment(shard, create=True)
            for ri, r in enumerate(row_ids):
                frag.import_row_words(r, words[ri, shard])
        data[fname] = words[0] if nrows == 1 else words
    for fname, nrows in CATEGORIES.items():
        f = idx.create_field(fname, FieldOptions(cache_type=CACHE_TYPE_NONE))
        view = f.view(VIEW_STANDARD, create=True)
        digit_planes, rows = disjoint_category_rows(rng, nrows)
        for shard in range(S):
            frag = view.fragment(shard, create=True)
            for r in range(nrows):
                frag.import_row_words(r, rows[r][shard])
        data[fname] = digit_planes
    age = idx.create_field("age", FieldOptions(type=FieldType.INT,
                                               min=0, max=127))
    aview = age.view(age.bsi_view, create=True)
    planes = rng.integers(0, 1 << 32, size=(DEPTH, S, W), dtype=np.uint32)
    full = np.full(W, 0xFFFFFFFF, dtype=np.uint32)
    for shard in range(S):
        frag = aview.fragment(shard, create=True)
        frag.import_row_words(0, full)              # exists
        for p in range(DEPTH):
            frag.import_row_words(2 + p, planes[p, shard])
    data["age"] = planes
    return h, data


def numpy_answers(data) -> dict:
    """Independent reference answers from the generated words."""
    import numpy as np

    def pc(x):
        return int(np.bitwise_count(x).sum(dtype=np.int64))

    a, b, t, planes = data["a"], data["b"], data["t"], data["age"]
    ncols = S * W * 32

    def top(counts):
        pairs = sorted(((-c, r) for r, c in enumerate(counts) if c > 0))
        return [(r, -c) for c, r in pairs][:8]

    # one joint histogram over (edu, gen, dom, reg digits, a bit, age),
    # decoded in shard batches, answers every GroupBy/Min/Max/Distinct
    hist = joint_histogram(data)              # (8, 2, 8, 4, 2, 128)
    vals = np.arange(1 << DEPTH, dtype=np.int64)
    by_age = hist.sum(axis=(0, 1, 2, 3, 4))
    between = int(by_age[11:100].sum())
    ge64 = pc(planes[6])
    assert ge64 == int(by_age[64:].sum())

    def groups(h, sizes):
        """GroupCounts in product order over the leading axes of h
        (digit axes, then the value axis), zero counts dropped."""
        out = []
        for combo in itertools.product(*(range(n) for n in sizes)):
            cell = h[combo]
            n = int(cell.sum())
            if n:
                out.append((combo, n, int((cell * vals).sum()), n))
        return out

    def max_groups(h, sizes):
        out = []
        for combo in itertools.product(*(range(n) for n in sizes)):
            cell = h[combo]
            n = int(cell.sum())
            if n:
                out.append((combo, n, int(np.nonzero(cell)[0][-1]), n))
        return out

    tsum = []
    for r in range(R):
        ta = t[r] & a
        n = pc(ta)
        if n:
            tsum.append(((r, 1), n, sum(pc(ta & planes[p]) << p
                                        for p in range(DEPTH)), n))
    age_any = hist.sum(axis=(0, 1, 2, 3, 4))
    age_a = hist[:, :, :, :, 1].sum(axis=(0, 1, 2, 3))
    lo_v = int(np.nonzero(age_any)[0][0])
    hi_a = int(np.nonzero(age_a)[0][-1])
    groupby = {
        "GroupBy(Rows(edu), Rows(gen), Rows(dom), aggregate=Sum(field=age))":
            groups(hist[:6, :, :5].sum(axis=(3, 4)), (6, 2, 5)),
        "GroupBy(Rows(gen), Rows(dom), aggregate=Sum(field=age))":
            groups(hist[:, :, :5].sum(axis=(0, 3, 4)), (2, 5)),
        "GroupBy(Rows(edu), Rows(gen), Rows(dom), Rows(reg), "
        "aggregate=Sum(field=age))":
            groups(hist[:6, :, :5].sum(axis=4), (6, 2, 5, 4)),
        "GroupBy(Rows(edu), Rows(gen), filter=Row(a=1), "
        "aggregate=Sum(field=age))":
            groups(hist[:6, :, :, :, 1].sum(axis=(2, 3)), (6, 2)),
        "GroupBy(Rows(edu), Rows(gen), aggregate=Max(field=age))":
            max_groups(hist[:6].sum(axis=(2, 3, 4)), (6, 2)),
        "GroupBy(Rows(t), Rows(a), aggregate=Sum(field=age))": tsum,
        "Min(field=age)": (lo_v, int(age_any[lo_v])),
        "Max(Row(a=1), field=age)": (hi_a, int(age_a[hi_a])),
        "Distinct(field=age)": [int(v) for v in np.nonzero(age_any)[0]],
    }
    return {
        "Count(Intersect(Row(a=1), Row(b=1)))": pc(a & b),
        "Count(Row(a=1))": pc(a),
        "Count(Union(Row(a=1), Row(b=1)))": pc(a | b),
        "TopN(t, n=8)": top([pc(t[r]) for r in range(R)]),
        "TopN(t, Row(a=1), n=8)": top([pc(t[r] & a) for r in range(R)]),
        "Sum(field=age)": (sum(pc(planes[p]) << p for p in range(DEPTH)),
                           ncols),
        "Sum(Row(a=1), field=age)": (
            sum(pc(planes[p] & a) << p for p in range(DEPTH)), pc(a)),
        "Count(Row(age >= 64))": ge64,
        "Count(Row(age < 64))": ncols - ge64,
        "Count(Row(10 < age < 100))": between,
    }, groupby


def joint_histogram(data):
    """Counts of columns per (edu digit, gen digit, dom digit, reg
    digit, a bit, age value), decoded from the generated words in
    batches of 32 shards: shape (8, 2, 8, 4, 2, 128), int64."""
    import numpy as np

    def bits(words):
        return np.unpackbits(np.ascontiguousarray(words).view(np.uint8),
                             axis=-1, bitorder="little")

    # digit planes most significant field first: edu, gen, dom, reg
    cat_planes = [p for f in ("edu", "gen", "dom", "reg")
                  for p in data[f][::-1]]
    n_bins = (1 << len(cat_planes)) * 2 * (1 << DEPTH)
    total = np.zeros(n_bins, dtype=np.int64)
    for lo in range(0, S, 32):
        sl = slice(lo, lo + 32)
        low = bits(data["a"][sl]) << np.uint8(DEPTH)    # a above age
        for p in range(DEPTH):
            low |= bits(data["age"][p, sl]) << np.uint8(p)
        high = np.zeros(low.shape, dtype=np.uint16)
        for plane in cat_planes:
            high = (high << np.uint16(1)) | bits(plane[sl])
        code = (high.astype(np.uint32) << np.uint32(DEPTH + 1)) | low
        total += np.bincount(code.reshape(-1), minlength=n_bins)
    return total.reshape(8, 2, 8, 4, 2, 1 << DEPTH)


def normalise(res):
    if isinstance(res, list) and res and hasattr(res[0], "group"):
        return [(tuple(g["row_id"] for g in gc.group), gc.count, gc.agg,
                 gc.agg_count) for gc in res]
    if isinstance(res, list):
        return [(p.id, p.count) for p in res]
    if hasattr(res, "values") and not callable(res.values):
        return list(res.values)
    if hasattr(res, "value"):
        return (res.value, res.count)
    return res


def phase_main_path(device, reps: int = 5) -> dict:
    import torch
    from pilosa_tpu_torch.executor.executor import Executor
    from pilosa_tpu_torch.ops import kernels as K

    t0 = time.perf_counter()
    h, data = build_index()
    print(f"main: index built on the host in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    headline, groupby = numpy_answers(data)
    want = {**headline, **groupby}
    print(f"main: numpy reference in {time.perf_counter() - t0:.1f} s")
    del data
    ex = Executor(h)
    K.reset_launches()
    for q, expect in want.items():
        t0 = time.perf_counter()
        got = normalise(ex.execute("bench", q)[0])
        torch.cuda.synchronize()
        cold = time.perf_counter() - t0
        if got != expect:
            raise AssertionError(f"{q}: port {got} != numpy {expect}")
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            again = normalise(ex.execute("bench", q)[0])
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            if again != expect:
                raise AssertionError(f"{q}: repeat gave {again}")
        print(f"main: {q} = {str(got)[:60]} exact; first "
              f"{cold * 1e3:.2f} ms (stack upload), warm p50 "
              f"{statistics.median(times) * 1e3:.3f} ms over {reps}")
    launches = dict(K.LAUNCHES)
    print(f"main: kernel launches {launches}")
    missing = [k for k, n in launches.items() if n == 0]
    if missing:
        raise AssertionError(f"main path never launched {missing}")
    print(f"main: device memory allocated "
          f"{torch.cuda.memory_allocated(device) / 2**30:.2f} GiB")
    return launches


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from pilosa_tpu_torch.ops import _build

    device = torch.device("cuda")
    card = card_line()
    name = torch.cuda.get_device_name(0)
    print(f"card: {card}")
    import numpy
    print(f"card: torch {torch.__version__} cuda {torch.version.cuda} "
          f"numpy {numpy.__version__} "
          f"device {name} count {torch.cuda.device_count()}")

    t0 = time.perf_counter()
    out = _build.build_all()
    print(f"build: {out} in {time.perf_counter() - t0:.1f} s")

    records = phase_kernels(device)
    torch.cuda.empty_cache()
    launches = phase_main_path(device)
    for k, rec in records.items():
        rec["launches"] = launches[k]
    print(json.dumps({"kernels": list(records.values())}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
