"""Run one cell of BENCHMARK.json once and print its result line.

    python3 -m gpubench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with the cards the cell asks
for.  Set-up generates the cell's configuration on the card from the
seed, loads it into one in-process node of the port
(``pilosa_tpu_torch``), and sends each query shape of the cell's mix
once; then the mix's clients run a closed loop for ``--seconds``, its
device operations recorded by ``torch.profiler``.  With ``--trace 1``
the same window is traced in full and the line carries the per-layer
metrics instead of the end-to-end ones.  After the window
the node is freed and every answer the window returned is held to the
plain reference (``reference.py``); the numbers compared, each beside
its limit, end standard error and the line.

Exits non-zero with no result when there is no card (or fewer than
the cell asks for), when a JAX module or the JAX package has been
loaded, or when BENCHMARK.json is missing.
"""

from __future__ import annotations

import time

T_START = time.time()     # the process's start, as near as Python can see

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "pilosa_tpu", "bench")
WARM_BURST_S = 3.0


def forbidden_modules() -> list[str]:
    """Top-level names in sys.modules that the run must not load,
    compared whole (``pilosa_tpu_torch`` is not ``pilosa_tpu``)."""
    return sorted({k.split(".")[0] for k in sys.modules} & set(FORBIDDEN))


def _card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], check=True, capture_output=True,
            text=True, timeout=30).stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not available"


def _cache_counts() -> dict:
    from pilosa_tpu_torch.obs import metrics
    return {o: metrics.RESULT_CACHE.value(outcome=o)
            for o in ("hit", "miss", "bypass")}


def _audit_counts(api) -> dict:
    serving = api.executor.serving
    if serving is None:
        return {}
    with serving.audit._cv:
        return {"/".join(k): v for k, v in serving.audit.counts.items()}


class HostClock:
    """What the host did over the window, beside the requests: the
    process's CPU seconds, the garbage collector's passes, and a fixed
    probe's time before and after."""

    def __init__(self):
        self.gc = []                 # (generation, seconds)
        self._t0 = None
        gc.callbacks.append(self._on_gc)

    def _on_gc(self, phase, info):
        if phase == "start":
            self._t0 = time.perf_counter()
        elif self._t0 is not None:
            self.gc.append((info["generation"], time.perf_counter() - self._t0))
            self._t0 = None

    @staticmethod
    def probe_ms() -> float:
        """Milliseconds of a fixed piece of pure-Python work: how fast
        the host runs this interpreter at the moment."""
        t0 = time.perf_counter()
        d = {}
        for i in range(200_000):
            d[i & 1023] = d.get(i & 1023, 0) + i
        return (time.perf_counter() - t0) * 1e3

    def start(self):
        self.probe0 = self.probe_ms()
        t = os.times()
        self.cpu0 = t.user + t.system
        self.gc.clear()

    def stop(self) -> dict:
        t = os.times()
        gc.callbacks.remove(self._on_gc)
        full = [s for g, s in self.gc if g == 2]
        return {"probe_ms": [self.probe0, self.probe_ms()],
                "process_cpu_s": t.user + t.system - self.cpu0,
                "gc_passes": len(self.gc), "gc_s": sum(s for _, s in self.gc),
                "gc_full_passes": len(full), "gc_full_s": sum(full)}


def run_cell(cell_name: str, seed: int, seconds: float, trace: bool, device,
             t_start: float, cfg_over: dict | None = None,
             manifest: dict | None = None) -> dict:
    """One run of a cell on ``device``; returns the result's fields.
    ``cfg_over`` replaces configuration keys (the tests' tiny sizes)."""
    import torch

    from gpubench import answers, loop
    from gpubench import manifest as man
    from gpubench import metrics as readers
    from gpubench import mix as mixmod
    from gpubench import node
    from gpubench.reference import Cube

    m = manifest or man.load()
    cell = man.cell(m, cell_name)
    cfg = dict(man.config(cell["config"]), **(cfg_over or {}))
    mix = mixmod.Mix(mixmod.load(cell["traffic"]), cfg)
    torch.manual_seed(seed & ((1 << 63) - 1))
    index = cfg["index"]

    h = node.load_holder(cfg, seed, device)
    if device.type == "cuda":
        # the peak is the node's, not the generator's
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    from gpubench import trace as tracemod
    shadow = tracemod.ShadowClock()
    shadow.install()
    api = node.start(h, cfg, device, seed)
    t_load = time.time() - t_start
    for spec in mix.shapes(seed):
        loop.send(api, index, spec)
    warm_seed = seed ^ 0x5A5A5A5A
    loop.run(api, index, mix.stream(warm_seed), mix.clients,
             min(WARM_BURST_S, seconds))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    gc.collect()                 # each window starts from a swept heap
    # the node's set-up ends here; the benchmark's own clocks start next
    setup_s = time.time() - t_start
    rec = clock = None
    if trace:
        rec = tracemod.Recorder(device, shadow)
        rec.start()
    else:
        clock = tracemod.DeviceClock(device)
        clock.start()
    cache0, audit0 = _cache_counts(), _audit_counts(api)
    host = HostClock()
    host.start()
    win = loop.run(api, index, mix.stream(seed), mix.clients, seconds,
                   on_client=rec.on_client if rec else None)
    diag = host.stop()
    done = loop.answered(win)
    bundle = rec.stop(win, len(done)) if rec else None
    events = clock.stop() if clock else []
    diag["qps"] = len(done) / win.seconds
    shadow.uninstall()
    cache = {k: v - cache0[k] for k, v in _cache_counts().items()}
    audit = {k: v - audit0.get(k, 0) for k, v in _audit_counts(api).items()}
    diag.update(shadow_runs=shadow.count(win.begin, win.end),
                shadow_s=shadow.seconds(win.begin, win.end), audit=audit)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)

    failed = [r for r in win.requests if r.error is not None]
    metrics = {}
    if trace:
        for x in m["per_layer"]:
            if man.applies(x, cell_name):
                v = readers.load(x["name"]).read(bundle)
                if v is not None:
                    metrics[x["name"]] = {"value": v, "unit": x["unit"]}
    else:
        values = {"setup_s": setup_s}
        if events and done:
            values["device_ms_per_query"] = (
                tracemod.busy_s(events, win) * 1e3 / len(done))
        for x in m["end_to_end"]:
            if man.applies(x, cell_name) and x["name"] in values:
                metrics[x["name"]] = {"value": values[x["name"]],
                                      "unit": x["unit"]}
    device_info = {"platform": "gpu" if device.type == "cuda" else "cpu",
                   "kind": (torch.cuda.get_device_name(device)
                            if device.type == "cuda" else "cpu"),
                   "count": 1, "memory_peak_bytes": int(peak)}
    extra = {}
    if trace:
        diag["roofline_left_out"] = readers.roofline_terms(bundle)[3]
        device_info["busy_s"] = bundle.busy_s
        device_info["window_s"] = bundle.window_s
        extra["breakdown"] = tracemod.breakdown(bundle, win)

    # the node goes before the reference runs: its peak is read
    node.stop(api)
    del api, h, rec, bundle, events
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.time()
    cube = Cube(cfg, seed, device, fields=mix.fields())
    wrong = [r for r in win.requests if r.error is None
             and not answers.holds(r.spec, r.reply, cube.answer(r.spec))]
    ref_s = time.time() - t_ref
    forms: dict = {}
    for r in win.requests:
        forms[r.spec["name"]] = forms.get(r.spec["name"], 0) + 1
    print(f"setup: load {t_load:.1f} s, warm {setup_s - t_load:.1f} s; window "
        f"{win.seconds:.3f} s, {len(win.requests)} requests, {len(done)} "
        f"answered in it, forms {forms}; result cache {cache}; reference "
        f"{ref_s:.1f} s; card {_card()}", file=sys.stderr)
    for r in (failed + wrong)[:5]:
        print(f"not correct: {mixmod.render(r.spec, index)} -> "
            f"{r.error or str(r.reply)[:300]}", file=sys.stderr)
    print(f"host: {json.dumps(diag)}", file=sys.stderr)
    checks = {"wrong": [len(wrong), 0], "failed": [len(failed), 0],
              "unanswered": [win.stuck, 0], "checked": [len(win.requests)
                                                         - len(failed), None]}
    return {"correct": not wrong and not failed and not win.stuck,
            "attempted": len(win.requests), "failed": len(failed),
            "metrics": metrics, "device": device_info, **extra,
            "host": diag, "checks": checks}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from gpubench import manifest as man
    if not (man.root() / "BENCHMARK.json").exists():
        print("no BENCHMARK.json beside gpubench/", file=sys.stderr)
        return 2
    m = man.load()
    chips = int(man.cell(m, args.workload)["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                   torch.device("cuda", 0), T_START, manifest=m)
    bad = forbidden_modules()
    if bad:
        print(f"loaded modules it must not: {bad}", file=sys.stderr)
        return 3
    for name, (value, limit) in out["checks"].items():
        print(f"check {name} {value} limit {limit}", file=sys.stderr)
    print(json.dumps(out))
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    code = main()
    sys.stdout.flush()
    sys.stderr.flush()
    # the port's planes leave daemon threads (the continuous profiler,
    # the audit's workers) stopped but not all joined; end here
    os._exit(code)
