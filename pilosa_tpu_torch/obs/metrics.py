"""Central metrics registry with prometheus text exposition.

Reference: metrics.go (one central file defining every counter/gauge/
histogram, e.g. metrics.go:86-126) exposed at ``/metrics``
(http_handler.go:495) and as JSON at ``/metrics.json``.  We keep the
same shape: a process-global ``registry`` holding named metrics with
label support, rendered in prometheus text format without any external
client library.
"""

from __future__ import annotations

import threading
import time
from bisect import bisect_left

_DEFAULT_BUCKETS = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
    0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)


def _label_key(labels: dict[str, str] | None) -> tuple:
    if not labels:
        return ()
    return tuple(sorted(labels.items()))


def _fmt_labels(key: tuple) -> str:
    if not key:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in key)
    return "{" + inner + "}"


class _Metric:
    kind = ""

    def __init__(self, name: str, help_: str):
        self.name = name
        self.help = help_
        self._lock = threading.Lock()

    def render(self) -> list[str]:
        raise NotImplementedError


class Counter(_Metric):
    kind = "counter"

    def __init__(self, name: str, help_: str = ""):
        super().__init__(name, help_)
        self._vals: dict[tuple, float] = {}

    def inc(self, n: float = 1.0, **labels):
        k = _label_key(labels)
        with self._lock:
            self._vals[k] = self._vals.get(k, 0.0) + n

    def value(self, **labels) -> float:
        return self._vals.get(_label_key(labels), 0.0)

    def total(self, **labels) -> float:
        """Sum across every label set CONTAINING the given labels
        (all series when none given) — the SLO plane sums typed-error
        counters across their free labels (class, tenant, ...)."""
        sub = set(labels.items())
        with self._lock:
            return sum(v for k, v in self._vals.items()
                       if sub <= set(k))

    def render(self) -> list[str]:
        out = [f"# HELP {self.name} {self.help}",
               f"# TYPE {self.name} counter"]
        with self._lock:
            vals = dict(self._vals)
        for k in sorted(vals):
            out.append(f"{self.name}{_fmt_labels(k)} {vals[k]:g}")
        return out


class ReadCounter(Counter):
    """A counter whose series another module keeps and this one reads
    (``bind(read)``, ``read()`` -> {label key: value}): for a writer that
    must take no lock, such as a garbage-collector callback."""

    def __init__(self, name: str, help_: str = ""):
        _Metric.__init__(self, name, help_)
        self._read = dict

    def bind(self, read) -> None:
        self._read = read

    @property
    def _vals(self) -> dict:
        return self._read()

    def inc(self, n: float = 1.0, **labels):
        raise TypeError(f"{self.name} is kept by the module bound to it")


class Gauge(_Metric):
    kind = "gauge"

    def __init__(self, name: str, help_: str = ""):
        super().__init__(name, help_)
        self._vals: dict[tuple, float] = {}

    def set(self, v: float, **labels):
        with self._lock:
            self._vals[_label_key(labels)] = float(v)

    def add(self, n: float = 1.0, **labels):
        k = _label_key(labels)
        with self._lock:
            self._vals[k] = self._vals.get(k, 0.0) + n

    def value(self, **labels) -> float:
        return self._vals.get(_label_key(labels), 0.0)

    def render(self) -> list[str]:
        out = [f"# HELP {self.name} {self.help}",
               f"# TYPE {self.name} gauge"]
        with self._lock:
            vals = dict(self._vals)
        for k in sorted(vals):
            out.append(f"{self.name}{_fmt_labels(k)} {vals[k]:g}")
        return out


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, name: str, help_: str = "",
                 buckets: tuple = _DEFAULT_BUCKETS,
                 quantiles: tuple = ()):
        super().__init__(name, help_)
        self.buckets = tuple(sorted(buckets))
        # bucket-interpolated quantiles rendered as gauge series
        # (`{name}_p50` etc.) so dashboards get p50/p95/p99 without a
        # scrape-side histogram_quantile()
        self.quantiles = tuple(quantiles)
        self._counts: dict[tuple, list[int]] = {}
        self._sum: dict[tuple, float] = {}
        self._n: dict[tuple, int] = {}
        # newest exemplar per (label set, bucket): (value, id, time) —
        # rendered OpenMetrics-style so a dashboard histogram links
        # back to a concrete /debug/queries trace id
        self._exemplars: dict[tuple, tuple] = {}

    def observe(self, v: float, exemplar: str | None = None, **labels):
        k = _label_key(labels)
        with self._lock:
            if k not in self._counts:
                self._counts[k] = [0] * (len(self.buckets) + 1)
            # first bucket whose upper bound (le) admits v; overflow
            # values land in the +Inf slot at index len(buckets)
            i = bisect_left(self.buckets, v)
            self._counts[k][i] += 1
            self._sum[k] = self._sum.get(k, 0.0) + v
            self._n[k] = self._n.get(k, 0) + 1
            if exemplar is not None:
                self._exemplars[(k, i)] = (v, str(exemplar), time.time())

    def observe_batch(self, items):
        """Observe several (value, labels, exemplar|None) samples
        under ONE lock acquisition.  A contended threading.Lock costs
        ~20us of GIL ping-pong per acquisition (vs ~0.3us of work), so
        hot-path producers (the flight recorder) buffer samples per
        thread and flush them here in batches."""
        now = time.time()
        with self._lock:
            for v, labels, exemplar in items:
                k = _label_key(labels)
                if k not in self._counts:
                    self._counts[k] = [0] * (len(self.buckets) + 1)
                i = bisect_left(self.buckets, v)
                self._counts[k][i] += 1
                self._sum[k] = self._sum.get(k, 0.0) + v
                self._n[k] = self._n.get(k, 0) + 1
                if exemplar is not None:
                    self._exemplars[(k, i)] = (v, str(exemplar), now)

    def exemplar(self, **labels):
        """Newest (value, trace_id) exemplar for a label set, or None."""
        k = _label_key(labels)
        with self._lock:
            best = None
            for (lk, _i), (v, eid, ts) in self._exemplars.items():
                if lk == k and (best is None or ts > best[2]):
                    best = (v, eid, ts)
        return None if best is None else (best[0], best[1])

    def count(self, **labels) -> int:
        return self._n.get(_label_key(labels), 0)

    def sum(self, **labels) -> float:
        """Cumulative observed sum for a label set — the statistics
        catalog derives measured per-byte costs from phase sums."""
        return self._sum.get(_label_key(labels), 0.0)

    def count_le(self, v: float, **labels) -> float:
        """Estimated observations <= v (linear interpolation within
        v's bucket, prometheus histogram_quantile's inverse) — the SLO
        plane's good-event count at the latency threshold.  A
        threshold at/past the last finite bound counts only the
        finite buckets: +Inf-bucket observations are indistinguishable
        from arbitrarily slow ones and must stay "bad", or a 60s
        outlier would vanish under a 10s threshold."""
        k = _label_key(labels)
        with self._lock:
            counts = list(self._counts.get(k, ()))
            n = self._n.get(k, 0)
        if not counts or n == 0:
            return 0.0
        cum, lo = 0.0, 0.0
        for i, ub in enumerate(self.buckets):
            c = counts[i]
            if v < ub:
                # v inside this bucket: linear share of its count
                frac = (v - lo) / (ub - lo) if ub > lo else 0.0
                return cum + c * max(0.0, min(1.0, frac))
            cum += c
            lo = ub
        return cum  # overflow-bucket observations stay > v

    def quantile(self, q: float, **labels) -> float:
        """Bucket-interpolated quantile estimate (prometheus
        histogram_quantile semantics: linear within the bucket; the
        +Inf bucket clamps to the largest finite bound)."""
        k = _label_key(labels)
        with self._lock:
            counts = list(self._counts.get(k, ()))
            n = self._n.get(k, 0)
        if not counts or n == 0:
            return 0.0
        target = q * n
        cum, lo = 0.0, 0.0
        for i, ub in enumerate(self.buckets):
            c = counts[i]
            if c and cum + c >= target:
                return lo + (ub - lo) * (target - cum) / c
            cum += c
            lo = ub
        return self.buckets[-1] if self.buckets else 0.0

    def render(self, openmetrics: bool = False) -> list[str]:
        out = [f"# HELP {self.name} {self.help}",
               f"# TYPE {self.name} histogram"]
        with self._lock:
            counts = {k: list(v) for k, v in self._counts.items()}
            sums = dict(self._sum)
            ns = dict(self._n)
            # snapshot under the SAME lock as the counts so an
            # exemplar never points at a bucket whose rendered count
            # predates it; rendered only under OpenMetrics — the
            # classic text-format 0.0.4 parser treats a mid-line '#'
            # as a parse error and would fail the whole scrape
            exemplars = dict(self._exemplars) if openmetrics else {}
        for k in sorted(ns):
            cum = 0
            for i, b in enumerate(self.buckets):
                cum += counts[k][i]
                lk = k + (("le", f"{b:g}"),)
                line = f"{self.name}_bucket{_fmt_labels(lk)} {cum}"
                ex = exemplars.get((k, i))
                if ex is not None:
                    # OpenMetrics exemplar syntax: links the bucket to
                    # a flight-recorder trace id (/debug/queries)
                    line += (f' # {{trace_id="{ex[1]}"}} {ex[0]:g} '
                             f"{ex[2]:.3f}")
                out.append(line)
            lk = k + (("le", "+Inf"),)
            line = f"{self.name}_bucket{_fmt_labels(lk)} {ns[k]}"
            ex = exemplars.get((k, len(self.buckets)))
            if ex is not None:
                line += (f' # {{trace_id="{ex[1]}"}} {ex[0]:g} '
                         f"{ex[2]:.3f}")
            out.append(line)
            out.append(f"{self.name}_sum{_fmt_labels(k)} {sums[k]:g}")
            out.append(f"{self.name}_count{_fmt_labels(k)} {ns[k]}")
        for q in self.quantiles:
            qn = f"{self.name}_p{q * 100:g}"
            out.append(f"# HELP {qn} {self.help} (q={q:g} estimate)")
            out.append(f"# TYPE {qn} gauge")
            for k in sorted(ns):
                v = self.quantile(q, **dict(k))
                out.append(f"{qn}{_fmt_labels(k)} {v:g}")
        return out


class MetricsRegistry:
    def __init__(self):
        self._metrics: dict[str, _Metric] = {}
        self._lock = threading.Lock()

    def counter(self, name: str, help_: str = "") -> Counter:
        return self._get(name, Counter, lambda: Counter(name, help_))

    def read_counter(self, name: str, help_: str = "") -> ReadCounter:
        return self._get(name, ReadCounter, lambda: ReadCounter(name, help_))

    def gauge(self, name: str, help_: str = "") -> Gauge:
        return self._get(name, Gauge, lambda: Gauge(name, help_))

    def histogram(self, name: str, help_: str = "",
                  buckets: tuple = _DEFAULT_BUCKETS,
                  quantiles: tuple = ()) -> Histogram:
        m = self._get(name, Histogram,
                      lambda: Histogram(name, help_, buckets, quantiles))
        if m.buckets != tuple(sorted(buckets)):
            raise ValueError(
                f"histogram {name} already registered with different "
                f"buckets {m.buckets}")
        if m.quantiles != tuple(quantiles):
            # same contract as buckets: a silent drop would make the
            # caller's _pNN gauge series never render
            raise ValueError(
                f"histogram {name} already registered with different "
                f"quantiles {m.quantiles}")
        return m

    def _get(self, name, cls, factory=None):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = factory() if factory else cls(name, "")
                self._metrics[name] = m
            assert isinstance(m, cls), f"metric {name} is {type(m)}"
            return m

    def render_text(self, openmetrics: bool = False) -> str:
        """Prometheus text exposition.  openmetrics=True additionally
        renders histogram exemplars (legal only under the
        application/openmetrics-text content type — callers negotiate
        via the Accept header)."""
        lines = []
        for name in sorted(self._metrics):
            m = self._metrics[name]
            if isinstance(m, Histogram):
                lines.extend(m.render(openmetrics=openmetrics))
            else:
                lines.extend(m.render())
        return "\n".join(lines) + "\n"

    def render_json(self) -> dict:
        out = {}
        with self._lock:
            items = sorted(self._metrics.items())
        for name, m in items:
            with m._lock:
                if isinstance(m, (Counter, Gauge)):
                    out[name] = {_fmt_labels(k) or "": v
                                 for k, v in m._vals.items()}
                elif isinstance(m, Histogram):
                    out[name] = {_fmt_labels(k) or "":
                                 {"count": m._n[k], "sum": m._sum[k]}
                                 for k in m._n}
        return out


# Process-global registry + the centrally defined metrics the engine
# uses (metrics.go analog; same naming style, pilosa_ prefix).
registry = MetricsRegistry()

QUERY_TOTAL = registry.counter(
    "pilosa_query_total", "Total PQL queries executed")
QUERY_DURATION = registry.histogram(
    "pilosa_query_duration_seconds", "PQL query latency")
SQL_TOTAL = registry.counter(
    "pilosa_sql_total", "Total SQL queries executed")
SQL_PUSHDOWN = registry.counter(
    "pilosa_sql_pushdown_total",
    "SQL planner operator decisions: op (count/sum/groupby/distinct/"
    "extract/join/...) by outcome (pushdown = rides the fused "
    "serving plane; host = solo host-side execution)")
SQL_PLAN_COST = registry.histogram(
    "pilosa_sql_plan_cost_ms",
    "SQL statement planning cost in milliseconds (parse-to-plan-op, "
    "cost-based decisions included)",
    buckets=(0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0,
             50.0, 100.0))
IMPORT_TOTAL = registry.counter(
    "pilosa_import_total", "Total import requests")
IMPORTED_BITS = registry.counter(
    "pilosa_imported_bits_total", "Total bits set via imports")
HTTP_REQUESTS = registry.counter(
    "pilosa_http_request_total", "HTTP requests by route/status")
JOB_TOTAL = registry.counter(
    "pilosa_job_total", "Per-shard executor jobs run")
STACKED_QUERIES = registry.counter(
    "pilosa_stacked_queries_total",
    "Query ops routed to the stacked mesh engine vs the shard loop")
GROUPBY_KERNEL = registry.counter(
    "pilosa_groupby_kernel_total",
    "GroupBy queries served by the fused Pallas kernel path")
GROUPBY_ONEPASS = registry.counter(
    "pilosa_groupby_onepass_total",
    "GroupBy queries served by the one-pass group-code histogram")
GROUPBY_FUSED = registry.counter(
    "pilosa_groupby_fused_total",
    "One-pass GroupBy dispatches served by the fused int8 MXU "
    "single-pass kernel, by path (onepass/onepass_mesh/batched)")

# -- tile-stack maintenance (executor/stacked.py TileStackCache) --
# Outcomes: hit (fresh entry), miss (any non-hit), patch (stale entry
# delta-patched on device), rebuild (full host restack + upload),
# page_rebuild (fresh entry, evicted pages re-uploaded), wait
# (single-flight follower served by another thread's build), too_big
# (entry alone exceeds the budget — served, never retained), denied
# (ledger reservation refused under pressure — served transiently).
STACK_CACHE = registry.counter(
    "pilosa_stack_cache_total",
    "Tile-stack cache accesses by outcome (hit/miss/patch/rebuild/"
    "page_rebuild/wait/too_big/denied)")
# patched vs rebuilt bytes attribute the write-path win directly: a
# healthy patch path keeps patched ≪ rebuilt-equivalent stack bytes
STACK_MAINT_BYTES = registry.counter(
    "pilosa_stack_maintenance_bytes_total",
    "Device stack maintenance traffic by kind (patched/rebuilt)")

# -- HBM residency (memory/: budget ledger, paged stacks, OOM backstop) --
MEM_BUDGET = registry.gauge(
    "pilosa_memory_budget_bytes",
    "Device-memory budget the process ledger enforces")
MEM_RESIDENT = registry.gauge(
    "pilosa_memory_resident_bytes",
    "Ledger-accounted resident device bytes by client")
MEM_DEVICE_RESIDENT = registry.gauge(
    "pilosa_memory_device_resident_bytes",
    "Device-labeled resident bytes per serving-mesh slot (pages "
    "placed by memory/placement.py; each slot is budget/N-bounded)")
MEM_RECLAIMS = registry.counter(
    "pilosa_memory_reclaim_total",
    "Cross-client reclaim sweeps by trigger (reserve/oom/shrink)")
MEM_RECLAIMED = registry.counter(
    "pilosa_memory_reclaimed_bytes_total",
    "Bytes shed under ledger pressure by client")
MEM_DENIED = registry.counter(
    "pilosa_memory_reserve_denied_total",
    "Reservations denied (served transiently, not retained) by client")
OOM_TOTAL = registry.counter(
    "pilosa_device_oom_total",
    "Device RESOURCE_EXHAUSTED events by outcome "
    "(caught/retry_ok/host_fallback/raised)")
STACK_PAGES = registry.counter(
    "pilosa_stack_pages_total",
    "Paged stack-cache page events (build/evict/patch) by page "
    "encoding (dense/packed/run)")
PAGE_ENCODE = registry.counter(
    "pilosa_page_encode_total",
    "Page encoding decisions by from/to container kind and reason "
    "(build/drift/patch)")
PREFETCH_TOTAL = registry.counter(
    "pilosa_prefetch_total",
    "Prefetcher warm attempts by outcome "
    "(warmed/noop/skipped_pressure/error)")

# -- jit executable caches (executor/stacked.py _JIT_CACHE/_GB_KERNEL_JIT) --
# the jit executable caches' events beside the stack cache's counters
JIT_CACHE = registry.counter(
    "pilosa_jit_cache_total",
    "Jit executable cache events by cache (plan/groupby_kernel) and "
    "event (insert/evict)")
JIT_CACHE_ENTRIES = registry.gauge(
    "pilosa_jit_cache_entries",
    "Jit executable cache occupancy by cache")

# -- serving path (executor/serving.py: micro-batcher + result cache) --
SERVING_LATENCY = registry.histogram(
    "pilosa_serving_latency_seconds",
    "End-to-end serving-path query latency",
    quantiles=(0.5, 0.95, 0.99))
SERVING_BATCH_SIZE = registry.histogram(
    "pilosa_serving_batch_size",
    "Concurrent queries coalesced per admission window (batch occupancy)",
    buckets=(1, 2, 4, 8, 16, 32, 64, 128),
    quantiles=(0.5, 0.95, 0.99))
SERVING_BATCH_WAIT = registry.histogram(
    "pilosa_serving_batch_wait_seconds",
    "Admission-window wait before a batch dispatches")
SERVING_QUEUE_DEPTH = registry.gauge(
    "pilosa_serving_queue_depth",
    "Queries waiting for batch admission right now")
RESULT_CACHE = registry.counter(
    "pilosa_result_cache_total",
    "Versioned result-cache lookups by outcome (hit/miss/bypass/write)")
SERVING_BATCHED = registry.counter(
    "pilosa_serving_batched_total",
    "Serving-path queries by execution route (fused/direct/cached)")

# -- ragged dispatch + QoS admission (executor/ragged.py, sched.py) --
SERVING_DISPATCH = registry.counter(
    "pilosa_serving_dispatch_total",
    "Fused serving device dispatches by kind (ragged = one cross-"
    "index page-table program per batch; group = one multi program "
    "per (index, shards) group)")
ADMISSION_TOTAL = registry.counter(
    "pilosa_serving_admission_total",
    "Serving admission decisions by class (point/heavy) and outcome "
    "(admitted/shed/expired)")
TENANT_QUEUE_DEPTH = registry.gauge(
    "pilosa_serving_tenant_queue_depth",
    "Heavy-class queries queued per tenant in the weighted fair "
    "queue right now")

# -- streaming write plane (ingest/stream.py + ingest/kafka.py) --
INGEST_WINDOWS = registry.counter(
    "pilosa_ingest_windows_total",
    "Coalesced ingest windows by outcome (landed/failed)")
INGEST_WINDOW_OCCUPANCY = registry.histogram(
    "pilosa_ingest_window_occupancy",
    "Concurrent submits coalesced per ingest window",
    buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 4096),
    quantiles=(0.5, 0.95, 0.99))
INGEST_WINDOW_MUTATIONS = registry.histogram(
    "pilosa_ingest_window_mutations",
    "Individual mutations (bits/values) coalesced per ingest window",
    buckets=(1, 8, 64, 512, 4096, 32768, 262144, 2097152),
    quantiles=(0.5, 0.95, 0.99))
INGEST_MUTATIONS = registry.counter(
    "pilosa_ingest_mutations_total",
    "Mutations durably landed through the streaming write plane")
INGEST_ACK_LATENCY = registry.histogram(
    "pilosa_ingest_ack_seconds",
    "Submit-to-durable-ack latency through the write plane",
    quantiles=(0.5, 0.95, 0.99))
INGEST_SHED = registry.counter(
    "pilosa_ingest_shed_total",
    "Write submissions shed by backpressure (typed 503) by tenant")
INGEST_REPLAYED = registry.counter(
    "pilosa_ingest_replayed_total",
    "Records re-delivered after a crash (offsets uncommitted) by topic")
INGEST_QUEUE_DEPTH = registry.gauge(
    "pilosa_ingest_queue_depth",
    "Mutations waiting for window admission right now")

# -- failure-tolerance plane (obs/faults.py, cluster/) --
CLUSTER_EVENTS = registry.counter(
    "pilosa_cluster_events_total",
    "Cluster failure-plane events "
    "(node_down/node_rejoin/failover/hedge_fired/hedge_won/"
    "load_shed/partial)")
# -- online resharding (cluster/rebalance.py) --
REBALANCE_TOTAL = registry.counter(
    "pilosa_rebalance_total",
    "Online-rebalance state-machine transitions by phase "
    "(copy/chase/fence/release/commit) and outcome "
    "(ok/error/rolled_back)")
REBALANCE_BYTES = registry.counter(
    "pilosa_rebalance_bytes_total",
    "Bytes moved by live shard migration by kind (copied = "
    "snapshot blocks, delta_replayed = chase rows, released = "
    "donor fragment bytes freed)")
HEARTBEAT_AGE = registry.gauge(
    "pilosa_cluster_heartbeat_age_seconds",
    "Seconds since each node's last heartbeat (by node)")
FAULTS_TOTAL = registry.counter(
    "pilosa_fault_injections_total",
    "Armed fault-point activations by point (obs/faults.py)")

# -- flight recorder (obs/flight.py) --
# One histogram per engine phase (labeled), with exemplar trace ids
# pointing into /debug/queries: plan_build, compile (jit trace +
# XLA compile dispatches), execute (cached-executable dispatches,
# timed through block_until_ready), stack_hit/patch/rebuild/wait
# (tile-stack cache outcomes; rebuild ~ host->device upload), demux,
# cache_lookup (result-cache snapshot walk), batch (total time in the
# micro-batcher), wait (batch minus attributed device phases).
PHASE_DURATION = registry.histogram(
    "pilosa_query_phase_seconds",
    "Per-query engine phase durations by phase (flight recorder)",
    quantiles=(0.5, 0.95, 0.99))

# -- roofline attribution (obs/roofline.py) --
# bytes-touched / execute-seconds per op family, against a measured
# (STREAM-style probe) or configured peak — ROADMAP item 3's "within
# 4x of the bandwidth bound" as a readable gauge
DEVICE_BW_GBPS = registry.gauge(
    "pilosa_device_bandwidth_gbps",
    "Achieved device memory bandwidth per op family "
    "(operand bytes / execute-phase seconds, cumulative)")
DEVICE_BW_FRACTION = registry.gauge(
    "pilosa_device_bandwidth_fraction",
    "Fraction of peak device bandwidth achieved per op family")
DEVICE_PEAK_GBPS = registry.gauge(
    "pilosa_device_peak_gbps",
    "Peak device bandwidth (PILOSA_TPU_PEAK_GBPS override or the "
    "measured STREAM-style startup probe)")

# -- statistics catalog (obs/stats.py + storage/stats_store.py) --
# persisted flight/roofline telemetry feeding the engine's cost
# decisions; the sentinel gauge carries the window/baseline ratio
# while a fingerprint regresses and 0 after recovery
STATS_FOLDS = registry.counter(
    "pilosa_stats_folds_total",
    "Flight records folded into the statistics catalog")
STATS_PROFILES = registry.gauge(
    "pilosa_stats_profiles",
    "Plan-fingerprint profiles the statistics catalog tracks")
STATS_PERSIST = registry.counter(
    "pilosa_stats_persist_total",
    "Statistics-store events "
    "(snapshot/tail/load/torn_drop/corrupt_drop)")
STATS_ADMISSION = registry.counter(
    "pilosa_stats_admission_total",
    "Cost-based admission classifications by source (profile = "
    "measured fingerprint cost; static = query-kind fallback) and "
    "class")
PERF_REGRESSION = registry.gauge(
    "pilosa_perf_regression",
    "Per-fingerprint perf-regression sentinel: current-window / "
    "baseline ratio while firing, 0 after recovery")

# -- incident forensics plane (obs/incidents.py + obs/watchdog.py) --
INCIDENTS_TOTAL = registry.counter(
    "pilosa_incidents_total",
    "Incident-bundle events by trigger (slo-burn/perf-regression/"
    "watchdog-stall/device-oom/batch-leader-exception/ingest-crash) "
    "and outcome (captured/suppressed/error)")
WATCHDOG_STALLS = registry.counter(
    "pilosa_watchdog_stalls_total",
    "Stall-watchdog detections by loop (serving-batcher/"
    "ingest-window/rebalance-controller/maintenance-ticker/"
    "heartbeat:*)")

# -- continuous correctness auditing (obs/audit.py) --
AUDIT_TOTAL = registry.counter(
    "pilosa_audit_total",
    "Correctness-audit events by verifier kind (shadow/cache/"
    "standing/replica) and outcome (sampled/match/mismatch/"
    "stale_skip/shed/unguarded/repaired/error)")

AUDIT_SHADOW_SECONDS = registry.counter(
    "pilosa_audit_shadow_seconds_total",
    "Seconds of shadow execution the audit's workers have finished")

# -- the garbage collector (obs/runtime.py) --
GC_PAUSE = registry.read_counter(
    "pilosa_gc_pause_seconds_total",
    "Seconds the interpreter's garbage collector ran, by generation")
GC_PASSES = registry.read_counter(
    "pilosa_gc_passes_total",
    "Garbage-collector passes, by generation")

# -- SLO burn-rate plane (obs/slo.py) --
SLO_BURN_RATE = registry.gauge(
    "pilosa_slo_burn_rate",
    "Error-budget burn rate per SLO and window (1.0 = spending the "
    "budget exactly at the sustainable rate)")
SLO_BUDGET_REMAINING = registry.gauge(
    "pilosa_slo_error_budget_remaining",
    "Error-budget fraction left over the longest configured window "
    "per SLO")

# -- temporal analytics (models/timeq.py + executor/standing.py) --
# quantum-cover plan ops, rollup folds, and the standing-query
# registry's maintenance outcomes (incremental = O(delta) patch,
# fallback = declared structural re-execution, noop = no relevant
# delta)
TIMEQ_QCOVER_TOTAL = registry.counter(
    "pilosa_timeq_qcover_total",
    "Multi-view time ranges planned as quantum-cover fused ops "
    "(one single-view stack leaf per cover member)")
TIMEQ_ROLLUP_TOTAL = registry.counter(
    "pilosa_timeq_rollup_total",
    "Completed fine-quantum views OR-folded into their coarser "
    "parent views by the rollup tick")
STANDING_REGISTERED = registry.gauge(
    "pilosa_standing_registered",
    "Live standing-query registrations")
STANDING_MAINTAIN = registry.counter(
    "pilosa_standing_maintain_total",
    "Standing-query maintenance passes by outcome "
    "(incremental/fallback/noop)")
STANDING_MAINTAIN_SECONDS = registry.histogram(
    "pilosa_standing_maintain_seconds",
    "Wall seconds per standing-query maintenance pass",
    buckets=(0.0001, 0.0005, 0.001, 0.005, 0.01, 0.05, 0.1, 0.5,
             1.0),
    quantiles=(0.5, 0.95, 0.99))

# -- disaggregated DAX tier (storage/blob.py + dax/worker.py +
# dax/controller.py reconcile loop) --
DAX_HYDRATIONS = registry.counter(
    "pilosa_dax_hydrations_total",
    "Worker shard hydrations by outcome (full = restored and "
    "retained under the ledger, transient = served without "
    "retention after a ledger denial, replay = resident tail "
    "replay, error = hydrate crashed and left the shard cold)")
DAX_BLOB_BYTES = registry.counter(
    "pilosa_dax_blob_bytes_total",
    "Blob shard-store transfer bytes by op (get/put/delete), "
    "manifests included")
DAX_RESIDENT_SHARDS = registry.gauge(
    "pilosa_dax_resident_shards",
    "Shards currently materialized on a worker, per worker")
DAX_COLD_SHARDS = registry.gauge(
    "pilosa_dax_cold_shards",
    "Shards assigned to a worker but not resident (hydrate on "
    "first touch), per worker")
DAX_SCALE_EVENTS = registry.counter(
    "pilosa_dax_scale_events_total",
    "Autoscaler decisions by direction (out/in) and outcome "
    "(done/partial/failed/skipped)")
