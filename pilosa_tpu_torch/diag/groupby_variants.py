"""Where the GroupBy histogram and per-combo kernels lose their time.

Run from the repository root on a machine with one CUDA card:

    python3 -m pilosa_tpu_torch.diag.groupby_variants

Part 1 builds ``groupby_variants.cu`` (copies of the two kernels as
they stood before the joint-table redesign, each with variants that
drop one part of the work) and times each variant with CUDA events at
``chip_smoke.py``'s phase-3 shapes: 954 shards x 32768 words, 7 code
planes (G = 128) and 7 magnitude planes, on random words (half the
columns valid) and at the main path's density (every column valid and
every value present); the value histogram (8 code planes, G = 256, no
planes); and the per-combo kernel at C = 0, 1, 2, 4 and 8 combos of 8 t
rows x 1 a row, with and without its per-combo global atomics.

Part 2 times the query path's kernels as they are, on inputs that
leave out one part of the work (no valid column: loads alone; no
present value: one bin a code), the per-combo kernel at C = 1, 2, 4, 8
and without planes, and prints what ptxas reports for each instance of
``ops/csrc/groupby_kernels.cu`` (registers, stack frame, spills).

Part 3, alone with ``python3 -m pilosa_tpu_torch.diag.groupby_variants
onehot``, times the first port's one-hot histogram (a copy in
``groupby_variants.cu``) at the four phase-3 shapes and at the G = 4096
card-test shape on 64 shards, and at G = 10 (GroupBy(gen, dom)) and
G = 64: as it stood, loads only, loads and the one-hot build without
the mma, the mma alone on constant fragments, and the template trimmed
to the slices G needs; then the query path's groupby_onehot and the
other instances of its kernel (the payload as A with 32 or 16 slices a
warp, or with G in one range of 16 or 8 slices; the factored form with
16 or 8 payload rows a warp), each held equal to the first port's
output.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

S, W, DEPTH = 954, 32768, 7
VARIANTS = ("full", "compose", "atomics", "loads", "joint")


def build():
    from pilosa_tpu_torch.ops import _build
    src = Path(__file__).resolve().parent / "groupby_variants.cu"
    out = _build.build_dir().parent / "diag"
    out.mkdir(parents=True, exist_ok=True)
    so = out / "libgroupby_variants.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(src)],
                   check=True)
    lib = ctypes.CDLL(str(so))
    p, i = ctypes.c_void_p, ctypes.c_int64
    lib.pt_diag_fused.argtypes = [i, p, i, p, p, i, i, i, i, i, i, i, p, p, p]
    lib.pt_diag_sum.argtypes = [i, p, p, p, i, p, i, i, i, p, p]
    lib.pt_diag_onehot_old.argtypes = [i, i, p, i, i, p, i, p, i, i, i, i, i, i, p, p, p]
    lib.pt_diag_onehot_new.argtypes = [i, p, i, i, p, i, p, i, i, i, i, i, i, p, p]
    for fn in (lib.pt_diag_fused, lib.pt_diag_sum, lib.pt_diag_onehot_old,
               lib.pt_diag_onehot_new):
        fn.restype = ctypes.c_int
    return lib


def cuda_ms(fn, reps: int = 10) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("groupby_variants: no CUDA device", file=sys.stderr)
        return 2
    from pilosa_tpu_torch.ops import kernels as K
    lib = build()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(20261017)

    def words(shape):
        return torch.randint(-2**31, 2**31, shape, generator=gen, device=dev,
                             dtype=torch.int32)

    if sys.argv[1:] == ["onehot"]:
        onehot(lib, dev, words)
        print(f"card: {card_line()}")
        return 0

    stream = torch.cuda.current_stream().cuda_stream
    codes = words((S, 8, W))
    planes = words((S, 2 + DEPTH, W))
    valid = words((S, W))
    ones = torch.full((S, W), -1, dtype=torch.int32, device=dev)
    dense_planes = planes.clone()
    dense_planes[:, 0] = -1
    sink = torch.zeros(256, dtype=torch.int32, device=dev)

    def fused(variant, cp, va, pl, g, signed, mm, tsize=0):
        cb = cp.shape[1]
        d = 0 if pl is None else pl.shape[1] - 2
        k = 1 if pl is None else 2 + (2 if signed else 1) * d
        hist = torch.zeros(k * g, dtype=torch.int32, device=dev)

        def run():
            err = lib.pt_diag_fused(
                variant, cp.data_ptr(), cb, va.data_ptr(),
                None if pl is None else pl.data_ptr(), d, S, W, g, int(signed),
                int(mm), tsize, hist.data_ptr(), sink.data_ptr(), stream)
            if err:
                raise RuntimeError(f"variant {variant}: cudaError {err}")
        return run

    able = codes[:, :7].contiguous()
    cases = [
        ("able unsigned, random", able, valid, planes, 128, False, False, 1 << 14),
        ("able signed, random", able, valid, planes, 128, True, False, 1 << 15),
        ("able signed + minmax, random", able, valid, planes, 128, True, True, 1 << 15),
        ("able unsigned, all valid + exists", able, ones, dense_planes, 128, False,
         False, 1 << 14),
        ("able signed + minmax, all valid + exists", able, ones, dense_planes, 128,
         True, True, 1 << 15),
        ("value histogram (8 code planes, G=256), random", codes, valid, None, 256,
         False, False, 256),
        ("value histogram, all valid", codes, ones, None, 256, False, False, 256),
    ]
    for label, cp, va, pl, g, signed, mm, tsize in cases:
        times = {}
        for v, name in enumerate(VARIANTS):
            times[name] = cuda_ms(fused(v, cp, va, pl, g, signed, mm, tsize))
        line = ", ".join(f"{n} {t:.4f} ms" for n, t in times.items())
        print(f"fused {label}: {line}")
    # the kernel the query path launches, on the random able inputs
    print(f"fused able unsigned, the query path's groupby_fused: "
          f"{cuda_ms(lambda: K.groupby_fused(able, valid, planes, 128, signed=False)):.4f} ms")

    rows = words((8, S, W))
    arow = valid
    out = torch.zeros(8 * (2 + 2 * DEPTH), dtype=torch.int32, device=dev)
    sel = torch.tensor([[r, 0] for r in range(8)], dtype=torch.int32, device=dev)

    def per_combo(variant, c):
        def run():
            err = lib.pt_diag_sum(variant, rows.data_ptr(), arow.data_ptr(),
                                  sel.data_ptr(), c, planes.data_ptr(), DEPTH, S,
                                  W, out.data_ptr(), stream)
            if err:
                raise RuntimeError(f"sum variant {variant}: cudaError {err}")
        return run

    for c in (0, 1, 2, 4, 8):
        print(f"sum C={c}: full {cuda_ms(per_combo(0, c)):.4f} ms, without "
              f"global atomics {cuda_ms(per_combo(1, c)):.4f} ms")
    print(f"sum C=8, the query path's groupby_sum: "
          f"{cuda_ms(lambda: K.groupby_sum([rows, arow.unsqueeze(0)], sel, planes, signed=False)):.4f} ms")
    current(dev, words, planes, valid, rows, sel)
    print(f"card: {card_line()}")
    return 0


def card_line() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()


def onehot(lib, dev, words) -> None:
    """Part 3: the first port's one-hot histogram with parts dropped, and
    the query path's kernel beside it on the same inputs."""
    import torch
    from pilosa_tpu_torch.ops import kernels as K
    stream = torch.cuda.current_stream().cuda_stream
    codes = words((S, 9, W))
    planes = words((S, 2 + DEPTH, W))
    valid = words((S, W))
    vcodes, vvalid, vg = K._value_hist_codes(planes, None)
    wide_codes = words((64, 12, W))
    wide_planes = words((64, 18, W))
    sink = torch.zeros(256, dtype=torch.int32, device=dev)
    cases = [
        ("able unsigned, G=128, K=9", codes[:, :7], valid, planes, 128, False),
        ("able signed, G=128, K=16", codes[:, :7], valid, planes, 128, True),
        ("9 code bits, G=512, K=9", codes, valid, planes, 512, False),
        ("gen x dom, 4 code bits, G=10, K=9", codes[:, :4], valid, planes, 10,
         False),
        ("6 code bits, G=64, K=16", codes[:, :6], valid, planes, 64, True),
        ("value histogram, G=256, K=1", vcodes, vvalid, None, vg, False),
        ("64 shards, 12 code bits, G=4096, K=34", wide_codes, valid[:64],
         wide_planes, 4096, True),
    ]
    for label, cp, va, pl, g, signed in cases:
        d = 0 if pl is None else pl.shape[1] - 2
        k = 1 if pl is None else 2 + (2 if signed else 1) * d
        hist = torch.zeros(k * g, dtype=torch.int32, device=dev)
        args = (cp.data_ptr(), cp.stride(0), cp.shape[1], va.data_ptr(),
                va.stride(0), None if pl is None else pl.data_ptr(),
                0 if pl is None else pl.stride(0), d, cp.shape[0], W, g,
                int(signed))

        def old(variant, spw=0):
            def run():
                hist.zero_()
                err = lib.pt_diag_onehot_old(variant, spw, *args,
                                             hist.data_ptr(), sink.data_ptr(),
                                             stream)
                if err:
                    raise RuntimeError(f"old variant {variant}: cudaError {err}")
            return run

        def new(variant):
            def run():
                hist.zero_()
                err = lib.pt_diag_onehot_new(variant, *args, hist.data_ptr(),
                                             stream)
                if err:
                    raise RuntimeError(f"new variant {variant}: cudaError {err}")
            return run

        old(0)()
        want = hist.clone()
        got = K.groupby_onehot(cp, va, pl, g, signed)
        rows = [got[0]] if pl is None else (
            [got[0], got[1], got[2].T] + ([got[3].T] if signed else []))
        if not torch.equal(torch.cat([r.reshape(-1) for r in rows]), want):
            raise AssertionError(f"onehot {label}: the query path's kernel "
                                 "differs from the first port's")
        times = {name: cuda_ms(old(v), reps=3)
                 for v, name in enumerate(("full", "loads", "build", "mma"))}
        spw = -(-g // 128)
        if k <= 16 and spw < 8:
            times[f"trimmed spw={spw}"] = cuda_ms(old(0, spw), reps=3)
        line = ", ".join(f"{n} {t:.4f} ms" for n, t in times.items())
        print(f"onehot first port {label}: {line}")
        times = {"query path": cuda_ms(
            lambda: K.groupby_onehot(cp, va, pl, g, signed), reps=10)}
        for v, name in ((0, "payload A, 32 slices"),
                        (1, "payload A, 16 slices, present-slice test"),
                        (2, "factored, 16 rows x 1 block"),
                        (3, "factored, 8 rows x 2 blocks"),
                        (4, "payload A, one range of 16 slices"),
                        (5, "payload A, one range of 8 slices")):
            if (k > 16 or (v == 3 and k > 8) or (v == 4 and g > 128)
                    or (v == 5 and g > 64)):
                continue
            new(v)()
            if not torch.equal(hist, want):
                raise AssertionError(f"onehot {label}: instance {name} differs")
            times[name] = cuda_ms(new(v), reps=10)
        line = ", ".join(f"{n} {t:.4f} ms" for n, t in times.items())
        print(f"onehot redesigned {label}: {line}")


def current(dev, words, planes, valid, rows, sel) -> None:
    """Part 2: the query path's kernels on inputs that drop a part."""
    import re
    import torch
    from pilosa_tpu_torch.ops import _build
    from pilosa_tpu_torch.ops import kernels as K
    able = words((S, 7, W))
    codes9 = words((S, 9, W))
    ones = torch.full((S, W), -1, dtype=torch.int32, device=dev)
    present, absent = planes.clone(), planes.clone()
    present[:, 0] = -1
    absent[:, 0] = 0
    zero = torch.zeros_like(valid)
    stacks = [rows, valid.unsqueeze(0)]
    cases = {
        "fused able unsigned, random": lambda: K.groupby_fused(able, valid, planes, 128, signed=False),
        "fused able unsigned, no valid column": lambda: K.groupby_fused(able, zero, planes, 128, signed=False),
        "fused able unsigned, no present value": lambda: K.groupby_fused(able, valid, absent, 128, signed=False),
        "fused able unsigned, all valid and present": lambda: K.groupby_fused(able, ones, present, 128, signed=False),
        "fused able signed": lambda: K.groupby_fused(able, valid, planes, 128),
        "fused able signed + minmax": lambda: K.groupby_fused(able, valid, planes, 128, minmax=True),
        "fused 9 code bits, G=512": lambda: K.groupby_fused(codes9, valid, planes, 512, signed=False),
        "value histogram, random": lambda: K.bsi_value_hist(planes),
        "value histogram, no valid column": lambda: K.bsi_value_hist(absent),
        "value histogram, all valid": lambda: K.bsi_value_hist(present),
        "sum C=8 unsigned, counts only": lambda: K.groupby_sum(stacks, sel, None, signed=False),
    }
    for c in (1, 2, 4, 8):
        cases[f"sum C={c} unsigned"] = (
            lambda c=c: K.groupby_sum(stacks, sel[:c], planes, signed=False))
    for name, fn in cases.items():
        print(f"current {name}: {cuda_ms(fn):.4f} ms")
    src = Path(_build.__file__).resolve().parent / "csrc" / "groupby_kernels.cu"
    out = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
                          str(_build.build_dir().parent / "diag" / "ptxas.so"), str(src)],
                         capture_output=True, text=True, check=True).stderr.splitlines()
    for k, line in enumerate(out):
        m = re.search(r"\dgroupby_(\w+?)_kernelI(\w+?)EEv", line)
        if m and "Compiling entry" in line:
            info = [x.split(":", 1)[-1].strip() for x in out[k + 1:k + 4]
                    if "stack frame" in x or "registers" in x]
            print(f"ptxas {m.group(1)}<{m.group(2)}>: {'; '.join(info)}")


if __name__ == "__main__":
    sys.exit(main())
