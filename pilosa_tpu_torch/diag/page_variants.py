"""Where assemble_pages stands against torch.cat: the query path's
kernel beside the bulk-copy ring form it replaced, by ring shape and by
how the tiles are given to the blocks.

Run from the repository root on a machine with one CUDA card:

    python3 -m pilosa_tpu_torch.diag.page_variants

Builds ``page_variants.cu`` (the ring form: dense tiles moved by
cp.async.bulk through a ring of shared-memory stages, its tasks dealt to
a persistent grid of SMs x blocks an SM, or one run of tiles a block) in
several ring shapes (words a tile, stages, stores in flight, blocks an
SM), all in parallel.  On ``chip_smoke.py``'s two dense stacks,
(954, 32768) from 30 pages and (954, 9, 32768) from 269, each page its
own allocation, it times by torch.profiler's device time: the query
path's kernel (one block a run of tiles, dense runs through registers)
with its runs of 1, 2 or 4 tiles; each ring shape on a persistent grid
(runs of 1 tile dealt round it, or one contiguous range a block) and
with one block a run of 2 or 4 tiles; and torch.cat of the same pages
(its kernels' device time, and a call by CUDA events).  On the packed
(16, 954, 32768) and run (8, 954, 32768) stacks of chip_smoke.py's
phase 3, the query path's kernel with encoded runs of 1 to 32 tiles,
and two ring shapes on a persistent grid of contiguous ranges.  Every
output is held equal to the plain version.  The query path's kernel
runs first and last, to show the spread.
"""

from __future__ import annotations

import ctypes
import subprocess
from pathlib import Path

S, W, DEPTH = 954, 32768, 7
PAGE_LANES = (4 << 20) // (W * 4)
# the ring form's shapes: (words a tile, stages, stores in flight, blocks
# an SM)
RINGS = [(4096, 6, 2, 2), (4096, 4, 2, 3), (8192, 3, 1, 2)]
# how the ring form's tiles are given to its blocks: (tiles a run, one run
# a block); (None, False) is one contiguous range a persistent block
RING_GRIDS = [(1, False), (None, False), (2, True), (4, True)]
DENSE_RUNS = [1, 2, 4]
ENCODED_RUNS = [1, 2, 4, 8, 16, 32]


def _ring_source(text: str, tile: int, stages: int, sif: int, bps: int) -> str:
    subs = {"constexpr int64_t kTileWords = 4096;":
            f"constexpr int64_t kTileWords = {tile};",
            "constexpr int kBlocksPerSm = 2;": f"constexpr int kBlocksPerSm = {bps};",
            "constexpr int kStages = 6;": f"constexpr int kStages = {stages};",
            "constexpr int kStoresInFlight = 2;":
            f"constexpr int kStoresInFlight = {sif};"}
    for old, new in subs.items():
        assert old in text, old
        text = text.replace(old, new)
    return text


def build() -> dict:
    """{ring shape: CDLL}, built in parallel; a shape that does not build
    is reported and left out."""
    from pilosa_tpu_torch.ops import _build
    out = _build.build_dir().parent / "diag_pages"
    out.mkdir(parents=True, exist_ok=True)
    text = (Path(__file__).resolve().parent / "page_variants.cu").read_text()
    procs = {}
    for v in RINGS:
        src = out / ("ring_%d_%d_%d_%d.cu" % v)
        src.write_text(_ring_source(text, *v))
        so = out / (src.stem + ".so")
        procs[v] = (so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    libs = {}
    for v, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            print(f"build {v} failed:\n{log.decode(errors='replace')[-2000:]}")
            continue
        lib = ctypes.CDLL(str(so))
        p, i = ctypes.c_void_p, ctypes.c_int64
        lib.pt_diag_ring.argtypes = [p, i, i, p, i, p]
        libs[v] = lib
    return libs


def ring_plan(n_lanes, dense, payload_words, w: int, tile: int, n_blocks: int,
              runs) -> tuple:
    """The ring form's tasks: (offsets (G + 1,), tasks (T,)) int64, block
    b taking entries offsets[b]:offsets[b + 1] of ``tasks``, each
    (page << 32 | tile) for tiles of ``tile`` words.  ``runs`` (tiles a
    run, one run a block): runs dealt round a persistent grid of
    ``n_blocks`` by bytes (a dense tile reads and writes its words, an
    encoded one writes them and reads its share of the payload), or one
    a block; (None, False) is one contiguous range a block."""
    import numpy as np
    run_tiles, per_block = runs
    dense = np.asarray(dense, dtype=bool)
    words = np.asarray(n_lanes, dtype=np.int64) * int(w)
    tiles = -(-words // tile)
    per_tile = np.where(dense, 2 * tile, tile + -(-np.asarray(
        payload_words, dtype=np.int64) // np.maximum(tiles, 1)))
    page = np.repeat(np.arange(tiles.size, dtype=np.int64), tiles)
    k = np.arange(page.size, dtype=np.int64) - np.repeat(
        np.cumsum(tiles) - tiles, tiles)
    tasks = page << 32 | k
    cost = per_tile[page]
    start = np.cumsum(cost) - cost
    if run_tiles is None:
        g = max(1, min(n_blocks, page.size))
        block = start * g // int(cost.sum())
    else:
        runs_of = -(-tiles // run_tiles)
        run = k // run_tiles + np.repeat(np.cumsum(runs_of) - runs_of, tiles)
        if per_block:
            block = run
        else:
            first = np.unique(run, return_index=True)[1]
            unit = 2 * tile * run_tiles
            g = int(max(1, min(n_blocks, -(-int(cost.sum()) // unit))))
            block = ((start[first] // unit) % g)[run]
    order = np.argsort(block, kind="stable")
    offsets = np.concatenate(([0], np.cumsum(np.bincount(block))))
    return offsets.astype(np.int64), tasks[order]


def device_ms(fn, name: str, reps: int = 20, per_call: bool = False) -> float:
    """Mean device ms a launch of the kernels whose name holds `name`
    (torch.profiler), over the launches the trace holds; `per_call`: their
    sum over the calls (torch.cat of many pages is several launches)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if name in e.key]
    count = sum(e.count for e in events)
    total = sum(e.device_time_total for e in events)
    return total / (reps if per_call else max(count, 1)) / 1e3


def events_ms(fn, reps: int = 20) -> float:
    import torch
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def how(runs) -> str:
    run_tiles, per_block = runs
    if per_block:
        return f"one block a run of {run_tiles} tiles"
    return ("persistent, one contiguous range a block" if run_tiles is None
            else f"persistent, runs of {run_tiles} tiles dealt by bytes")


def main() -> int:
    import numpy as np
    import torch
    from pilosa_tpu_torch.memory import encode
    from pilosa_tpu_torch.ops import kernels as K
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], check=True,
                          capture_output=True, text=True).stdout.strip()
    print(f"card: {card}")
    libs = build()
    gen = torch.Generator(device=dev)
    gen.manual_seed(20261017)
    stream = torch.cuda.current_stream().cuda_stream
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def descs(pages, lanes):
        t = K.page_table(pages, (lanes, W), PAGE_LANES)
        return t[:len(pages) * K._PAGE_DESC].cpu().numpy().reshape(
            len(pages), K._PAGE_DESC)

    def path_table(d, run_tiles):
        plan = K.page_plan(d[:, 8], d[:, 0] == 0, W, run_tiles)
        return torch.from_numpy(np.concatenate(
            [d.reshape(-1), plan.reshape(-1)])).to(dev)

    def ring_call(v, d, lanes, runs):
        tile, _, _, bps = v
        offsets, tasks = ring_plan(d[:, 8], d[:, 0] == 0, d[:, 3] + 2 * d[:, 6],
                                   W, tile, sms * bps, runs)
        tab = torch.from_numpy(np.concatenate(
            [d.reshape(-1), offsets, tasks])).to(dev)

        def run():
            out = torch.empty((lanes, W), dtype=torch.int32, device=dev)
            err = libs[v].pt_diag_ring(tab.data_ptr(), len(d), offsets.size - 1,
                                       out.data_ptr(), W, stream)
            assert err == 0, err
            return out
        return run

    def report(label, name, fn, kernel, want, bound):
        got = fn()
        torch.cuda.synchronize()
        if not torch.equal(got.reshape(want.shape), want):
            raise AssertionError(f"{label} {name}: differs from plain")
        ms = device_ms(fn, kernel)
        print(f"{label} {name}: {ms:.4f} ms of kernel (profiler), "
              f"{bound / ms:.1%} of the {bound:.4f} ms bound ({card})")

    def shape_name(v):
        return (f"ring {v[0] * 4 // 1024} KiB x {v[1]} stages, {v[2]} stores "
                f"in flight, {v[3]} blocks an SM")

    for lead in ((S,), (S, 2 + DEPTH)):
        lanes = int(np.prod(lead))
        n = -(-lanes // PAGE_LANES)
        pages = [torch.randint(-2**31, 2**31, (PAGE_LANES, W), generator=gen,
                               device=dev, dtype=torch.int32)
                 for _ in range(n)]
        pages[-1][lanes - (n - 1) * PAGE_LANES:] = 0
        shape = tuple(lead) + (W,)
        want = K.assemble_pages_plain(pages, shape, PAGE_LANES)
        bound = 2 * lanes * W * 4 / 3.35e12 * 1e3
        label = f"dense {shape}, {n} pages"
        d = descs(pages, lanes)
        kept = K.page_table(pages, shape, PAGE_LANES)

        def path():
            return K.assemble_pages(pages, shape, PAGE_LANES, table=kept)
        report(label, "query path's kernel", path, "assemble_pages_kernel",
               want, bound)
        for r in DENSE_RUNS:
            tab = path_table(d, (r, K._PAGE_RUN_TILES[1]))
            report(label, f"query path's kernel, dense runs of {r} tiles",
                   lambda tab=tab: K.assemble_pages(pages, shape, PAGE_LANES,
                                                    table=tab),
                   "assemble_pages_kernel", want, bound)
        for v in libs:
            for runs in RING_GRIDS:
                report(label, f"{shape_name(v)}, {how(runs)}",
                       ring_call(v, d, lanes, runs), "ring_pages_kernel",
                       want, bound)
        cat_ms = device_ms(lambda: torch.cat(pages), "Cat", per_call=True)
        print(f"{label} torch.cat: {cat_ms:.4f} ms of its kernels (profiler), "
              f"{events_ms(lambda: torch.cat(pages)):.4f} ms a call (CUDA "
              f"events); the query path's kernel again "
              f"{device_ms(path, 'assemble_pages_kernel'):.4f} ms ({card})")
        del pages, want

    # the encoded stacks of chip_smoke.py phase 3
    import chip_smoke as C
    rng = np.random.default_rng(20261017)
    for kind, lead, blocks in (
            ("packed", (16, S), C._sp_stack_blocks(rng, 16)),
            ("run", (C.RN_ROWS, S), C._rn_stack_blocks(rng, C.RN_ROWS))):
        lanes = int(np.prod(lead))
        pages = [encode.encode_block(b).to_device(dev) for b in blocks]
        shape = tuple(lead) + (W,)
        want = K.assemble_pages_plain(pages, shape, PAGE_LANES)
        bound = (sum(p.nbytes for p in pages) + lanes * W * 4) / 3.35e12 * 1e3
        label = f"{kind} {shape}, {len(pages)} pages"
        d = descs(pages, lanes)
        kept = K.page_table(pages, shape, PAGE_LANES)
        report(label, "query path's kernel",
               lambda: K.assemble_pages(pages, shape, PAGE_LANES, table=kept),
               "assemble_pages_kernel", want, bound)
        for r in ENCODED_RUNS:
            tab = path_table(d, (K._PAGE_RUN_TILES[0], r))
            report(label, f"query path's kernel, encoded runs of {r} tiles",
                   lambda tab=tab: K.assemble_pages(pages, shape, PAGE_LANES,
                                                    table=tab),
                   "assemble_pages_kernel", want, bound)
        for v in list(libs)[1:]:
            report(label, f"{shape_name(v)}, {how((None, False))}",
                   ring_call(v, d, lanes, (None, False)), "ring_pages_kernel",
                   want, bound)
        del pages, want
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
