"""``pilosa-tpu`` command — the operator entry point.

Command set mirrors the reference CLI (cmd/root.go:94-111 subcommand
registration; implementations in ctl/):

    server            run a node                       (ctl/server.go)
    dax               controller + queryer + workers   (dax/server/)
    backup            snapshot a live node             (ctl/backup.go:30)
    restore           upload a backup to a node        (ctl/restore.go)
    import            CSV import through the batcher   (ctl/import.go)
    export            dump a field as CSV              (ctl/export.go)
    generate-config   print default config             (cmd generate-config)
    keygen            mint an HS256 auth token         (qa/fakeidp analog)
    rbf               inspect RBF shard files          (ctl/rbf.go)
    sql               fbsql interactive shell          (cli/cli.go)
    version

argparse instead of cobra; flags keep the reference's names where they
exist (--host, --index, --field, ...).  ``server --device`` picks the
torch device the node computes on: the CUDA card by default (a machine
without one raises), ``cpu`` for the kernels' plain versions; ``dax
--device`` does the same for every worker of the disaggregated tier.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def _client(args):
    from pilosa_tpu_torch.cluster.client import InternalClient
    headers = {}
    if getattr(args, "token", None):
        headers["Authorization"] = f"Bearer {args.token}"
    return InternalClient(timeout=getattr(args, "timeout", 60.0),
                          headers=headers)


# ---------------------------------------------------------------------------
# server
# ---------------------------------------------------------------------------

def cmd_server(args) -> int:
    from pilosa_tpu_torch import config as cfgmod
    from pilosa_tpu_torch.models.holder import Holder
    from pilosa_tpu_torch.obs.logger import StderrLogger
    from pilosa_tpu_torch.server.http import Server

    # flags > env > config file > defaults (server/config.go layering)
    cfg = cfgmod.load(args.config, overrides={
        "data_dir": args.data_dir, "bind": args.bind,
        "port": args.port, "grpc_port": args.grpc_port,
        "auth_secret": args.auth_secret or None,
        "auth_policy": args.auth_policy or None,
        "long_query_time": args.long_query_time,
    })
    cfg.check_supported()  # Server applies every section
    grpc_mod = None
    if cfg.grpc_port >= 0:
        # before anything starts: a node asked for gRPC on a Python
        # without grpcio must fail here, naming the package
        from pilosa_tpu_torch.server import grpc as grpc_mod
    auth = None
    if cfg.auth_secret:
        from pilosa_tpu_torch.server.authn import Authenticator
        from pilosa_tpu_torch.server.authz import Authorizer
        authz = (Authorizer.from_yaml(cfg.auth_policy)
                 if cfg.auth_policy else None)
        auth = (Authenticator(cfg.auth_secret.encode()), authz)
    holder = Holder(path=cfg.data_dir) if cfg.data_dir else Holder()
    holder.load_schema()
    logger = StderrLogger()
    srv = Server(holder=holder, bind=cfg.bind, port=cfg.port,
                 logger=logger, auth=auth, config=cfg, device=args.device)
    srv.api.long_query_time = float(cfg.long_query_time)
    srv.api.logger = logger
    grpc_srv = None
    if grpc_mod is not None:
        grpc_srv = grpc_mod.GRPCServer(srv.api,
                                       bind=f"{cfg.bind}:{cfg.grpc_port}",
                                       auth=auth).start()
        logger.info("grpc listening on :%d", grpc_srv.port)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        if grpc_srv:
            grpc_srv.stop()
        holder.sync()
        srv.close()
    return 0


# ---------------------------------------------------------------------------
# dax (dax/server/)
# ---------------------------------------------------------------------------

def cmd_dax(args) -> int:
    """Host the DAX services in one process — controller + queryer +
    N compute workers over a shared storage dir (the reference's
    `featurebase dax` single binary, dax/server/), with the
    queryer's SQL surface on HTTP.  The [dax] and [blob] stanzas come
    from ``--config`` and the environment (``config.load``)."""
    from pilosa_tpu_torch import config as cfgmod
    from pilosa_tpu_torch.dax import settings as dax_settings
    from pilosa_tpu_torch.dax.server import DAXService
    from pilosa_tpu_torch.obs.logger import StderrLogger

    cfg = cfgmod.load(args.config)
    cfg.check_supported()
    logger = StderrLogger()
    svc = DAXService(args.data_dir, n_workers=args.workers,
                     device=args.device, config=cfg)
    try:
        front = svc.serve_queryer(bind=args.bind, port=args.port)
        logger.info("dax queryer listening on %s:%d (%d workers on %s, "
                    "storage %s)", args.bind, front.port, args.workers,
                    svc.device, args.data_dir)
        if svc.blob is not None:
            # disaggregated shape: warm spares + the autoscaler's
            # reconcile loop ([dax] standby / thresholds)
            for i in range(dax_settings.standby()):
                svc.add_standby(f"standby{i}")
            svc.start_autoscaler()
            logger.info("dax blob tier active (%d standby)",
                        dax_settings.standby())
        svc.controller.start_poller()
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        pass
    finally:
        svc.close()
    return 0


# ---------------------------------------------------------------------------
# backup / restore (ctl/backup.go:30,87; ctl/restore.go)
# ---------------------------------------------------------------------------

def _safe_join(base: str, rel: str) -> str:
    """Join a manifest's relative path under ``base``, refusing one that
    leaves it (the server must not steer where the CLI writes)."""
    if os.path.isabs(rel) or ".." in rel.replace("\\", "/").split("/"):
        raise ValueError(f"unsafe path in manifest: {rel!r}")
    return os.path.join(base, rel)


def cmd_backup(args) -> int:
    """Copy a live node's data files into ``--output-dir`` under an
    exclusive transaction, which holds every writer off while the files
    stream (ctl/backup.go:87)."""
    cli = _client(args)
    tx = cli._request(args.host, "POST", "/transaction",
                      {"exclusive": True, "timeout": 300.0})
    tid = tx["id"]
    try:
        deadline = time.time() + 30
        while not tx.get("active"):
            if time.time() > deadline:
                print("timed out waiting for exclusive transaction",
                      file=sys.stderr)
                return 1
            time.sleep(0.1)
            tx = cli._request(args.host, "GET", f"/transaction/{tid}")
        man = cli._request(args.host, "GET", "/internal/backup/manifest")
        os.makedirs(args.output_dir, exist_ok=True)
        with open(os.path.join(args.output_dir, "MANIFEST.json"),
                  "w") as f:
            json.dump(man, f, indent=1)
        for rel in man["files"]:
            data = cli.get_raw(args.host,
                               f"/internal/backup/file?path={rel}")
            dst = _safe_join(args.output_dir, rel)
            os.makedirs(os.path.dirname(dst) or ".", exist_ok=True)
            with open(dst, "wb") as f:
                f.write(data)
            if not args.quiet:
                print(f"backed up {rel} ({len(data)} bytes)")
    finally:
        cli._request(args.host, "POST", f"/transaction/{tid}/finish")
    print(f"backup complete: {len(man['files'])} files "
          f"-> {args.output_dir}")
    return 0


def cmd_restore(args) -> int:
    """Upload a backup's files to a node, then have it reload them."""
    cli = _client(args)
    with open(os.path.join(args.source_dir, "MANIFEST.json")) as f:
        man = json.load(f)
    for rel in man["files"]:
        with open(_safe_join(args.source_dir, rel), "rb") as f:
            data = f.read()
        cli.post_raw(args.host, f"/internal/restore/file?path={rel}", data)
        if not args.quiet:
            print(f"restored {rel} ({len(data)} bytes)")
    got = cli._request(args.host, "POST", "/internal/restore/complete")
    print(f"restore complete: indexes {got['indexes']}")
    return 0


# ---------------------------------------------------------------------------
# import / export
# ---------------------------------------------------------------------------

def cmd_import(args) -> int:
    from pilosa_tpu_torch.ingest.importer import HTTPImporter
    from pilosa_tpu_torch.ingest.pipeline import Pipeline
    from pilosa_tpu_torch.ingest.sources import CSVSource

    src = CSVSource(args.file)
    importer = HTTPImporter(args.host, client=_client(args))
    pipe = Pipeline(src, importer, args.index,
                    batch_size=args.batch_size,
                    concurrency=args.concurrency,
                    index_keys=args.keys or None)
    pipe.apply_schema()
    n = pipe.run()
    print(f"imported {n} records into {args.index}")
    return 0


def cmd_export(args) -> int:
    """Dump field bits as row,col CSV (ctl/export.go semantics)."""
    cli = _client(args)
    resp = cli._request(args.host, "POST", f"/index/{args.index}/query",
                        {"query": f"Rows({args.field})"})
    rows = resp["results"][0]
    out = open(args.output, "w") if args.output else sys.stdout
    try:
        for row in rows:
            rid = row if not isinstance(row, dict) else row.get("id", row)
            r = cli._request(
                args.host, "POST", f"/index/{args.index}/query",
                {"query": f"Row({args.field}={rid})"})
            for col in r["results"][0]["columns"]:
                out.write(f"{rid},{col}\n")
    finally:
        if args.output:
            out.close()
    return 0


# ---------------------------------------------------------------------------
# misc
# ---------------------------------------------------------------------------

DEFAULT_CONFIG = """\
# pilosa-tpu configuration (TOML).  Flags override file values;
# environment variables PILOSA_TPU_* override both
# (server/config.go analog).

data-dir = "~/.pilosa-tpu"
bind = "127.0.0.1"
port = 10101
grpc-port = 20101

[cluster]
name = "cluster0"
replicas = 1
# hedged replica reads: a fan-out RPC outlasting this delay fires a
# second attempt at the next live replica, first response wins.
# < 0 disables, 0 auto-derives from flight-recorder attempt records,
# > 0 fixes the delay (milliseconds)
hedge-ms = 0.0
# default end-to-end query deadline (seconds, 0 = none); every RPC
# attempt, hedge, and retry budgets from its remainder
deadline-s = 0.0

[faults]
# fault-injection registry (obs/faults.py): arm named fault points at
# startup for chaos drills — "point[@match][,times=N][,delay=MS]"
# entries joined by ";", e.g. "rpc-delay@10101,delay=200,times=0"
spec = ""

[auth]
# enable by setting a shared HS256 secret
secret = ""
policy = ""      # YAML group->permission file (authz)

[tpu]
# pallas kernel dispatch: "auto" | "on" | "off"
kernels = "auto"

[flight]
# query flight recorder: per-query phase records at /debug/queries
# and /debug/trace (Perfetto).  recorder=false disables record
# keeping; ring bounds how many records are kept.
recorder = true
ring = 512

[memory]
# HBM residency manager: one process-wide device-byte budget shared
# by the tile-stack / jit / result caches.  budget-bytes 0 = auto
# (device memory minus headroom-frac; 8 GiB fallback without device
# stats).  paged = page-granular stack eviction/patching; prefetch
# warms predicted pages from the flight recorder; oom-retry and
# host-fallback are the RESOURCE_EXHAUSTED backstop rungs.
budget-bytes = 0
headroom-frac = 0.1
page-bytes = 4194304
paged = true
prefetch = true
prefetch-interval-s = 0.5
oom-retry = true
host-fallback = true

[incidents]
# incident forensics: anomaly-triggered black-box bundles (SLO burn,
# perf regression, watchdog stall, OOM trip, batch-leader exception,
# ingest crash) persisted under dir (default <data-dir>/incidents),
# rate-limited per trigger and size-bounded per bundle; profile*
# drive the always-on continuous profiler attached to every bundle
enabled = true
dir = ""
min-interval-s = 60.0
max-bundles = 32
max-bundle-bytes = 1048576
slo-burn-threshold = 8.0
profile = true
profile-hz = 7.0
profile-window-s = 10.0
profile-windows = 6
log-ring = 512

[watchdog]
# stall watchdogs: progress-stamped deadlines on the long-running
# loops (serving batcher, ingest window, rebalance controller,
# maintenance ticker, heartbeats); a loop wedged past deadline-s
# fires pilosa_watchdog_stalls_total{loop} + an incident bundle
enabled = true
interval-s = 1.0
deadline-s = 10.0

[audit]
# continuous correctness auditing (obs/audit.py): shadow-execution
# sampling on served reads (re-executed on the independent host
# oracle arm, compared bit-exact), plus maintenance-ticker scrubbers
# for the result cache, standing queries, and replica divergence.
# PILOSA_TPU_AUDIT=0 is the runtime kill-switch; sample-rate is the
# per-serve sampling probability, route-rates overrides it per route
# ("cached=0.05,fused=0.01").  Mismatches fire a rate-limited
# audit-mismatch incident bundle and land in /debug/audit.
enabled = true
sample-rate = 0.01
route-rates = ""
queue-max = 64
concurrency = 1
scrub-cache-n = 4
scrub-standing-n = 2
scrub-replica-n = 2
quarantine = 32

[blob]
# blob shard store (storage/blob.py) — the disaggregated tier's one
# durable home.  backend "" disables the tier; "dir" keeps objects
# under root (default <data-dir>/blob); "mem" is the in-process
# fault-drill arm.  Env twins: PILOSA_TPU_BLOB_BACKEND / _BLOB_ROOT.
backend = ""
root = ""

[dax]
# disaggregated compute tier (dax/worker.py + dax/controller.py).
# blob is the tier switch (PILOSA_TPU_DAX_BLOB=0 kills it at
# runtime); lazy-hydrate materializes shards on first touch;
# worker-budget-bytes bounds each stateless worker's resident set
# through its private HBM ledger (0 = unbounded).  The autoscaler
# scales out past scale-out-burn (SLO burn rate) or pressure-high
# (ledger fill fraction), scales in under scale-in-burn, admits from
# standby warm spares, and never leaves [min-workers, max-workers].
blob = true
lazy-hydrate = true
worker-budget-bytes = 0
prefetch = 2
scale-out-burn = 2.0
scale-in-burn = 0.5
pressure-high = 0.9
min-workers = 1
max-workers = 8
standby = 1
reconcile-interval-s = 5.0
cooldown-s = 30.0
chase-lag = 8
chase-rounds = 12
"""


def cmd_generate_config(args) -> int:
    print(DEFAULT_CONFIG, end="")
    return 0


def cmd_keygen(args) -> int:
    from pilosa_tpu_torch.server.authn import encode_jwt
    claims = {"sub": args.subject,
              "groups": args.groups.split(",") if args.groups else [],
              "exp": time.time() + args.ttl}
    print(encode_jwt(claims, args.secret.encode()))
    return 0


def cmd_rbf(args) -> int:
    """RBF shard file inspection (ctl/rbf.go check/pages)."""
    from pilosa_tpu_torch.storage import rbf
    db = rbf.DB(args.file)
    try:
        with db.begin() as tx:
            names = tx.list_bitmaps()
            print(f"file: {args.file}")
            print(f"bitmaps: {len(names)}")
            for name in names:
                n = sum(1 for _ in tx.items(name))
                print(f"  {name}: {n} containers")
    finally:
        db.close()
    return 0


def cmd_version(args) -> int:
    from pilosa_tpu_torch import __version__
    print(__version__)
    return 0


def cmd_sql(args) -> int:
    from pilosa_tpu_torch.cli.fbsql import run_shell
    return run_shell(args)


# ---------------------------------------------------------------------------

def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="pilosa-tpu",
        description="pilosa-tpu on PyTorch — operator CLI")
    sub = p.add_subparsers(dest="cmd", required=True)

    def host_flags(sp):
        sp.add_argument("--host", default="127.0.0.1:10101",
                        help="host:port of the node")
        sp.add_argument("--token", default=os.environ.get(
            "PILOSA_TPU_TOKEN"), help="bearer token (auth-enabled nodes)")
        sp.add_argument("--timeout", type=float, default=60.0)

    sp = sub.add_parser("server", help="run a node")
    sp.add_argument("--config", "-c", default=None,
                    help="TOML config file (generate-config prints one)")
    sp.add_argument("--data-dir", default=None)
    sp.add_argument("--bind", default=None)
    sp.add_argument("--port", type=int, default=None)
    sp.add_argument("--grpc-port", type=int, default=None,
                    help="-1 disables gRPC")
    sp.add_argument("--auth-secret", default="")
    sp.add_argument("--auth-policy", default="")
    sp.add_argument("--long-query-time", type=float, default=None,
                    help="log queries slower than this many seconds "
                         "(0 disables; server.go:201 analog)")
    sp.add_argument("--device", default=None,
                    help="torch device to compute on (default: the CUDA "
                         "card, which must be present; 'cpu' runs the "
                         "kernels' plain versions)")
    sp.set_defaults(fn=cmd_server)

    sp = sub.add_parser(
        "dax", help="run the DAX services (controller + queryer + "
                    "compute workers) in one process")
    sp.add_argument("--config", "-c", default=None,
                    help="TOML config file ([dax] and [blob] stanzas)")
    sp.add_argument("--data-dir", required=True,
                    help="shared storage dir (write-log, snapshots, "
                         "controller schemar)")
    sp.add_argument("--workers", type=int, default=2)
    sp.add_argument("--bind", default="127.0.0.1")
    sp.add_argument("--port", type=int, default=0,
                    help="queryer HTTP port (0 = ephemeral)")
    sp.add_argument("--device", default=None,
                    help="torch device every worker computes on "
                         "(default: the CUDA card, which must be "
                         "present; 'cpu' runs the kernels' plain "
                         "versions)")
    sp.set_defaults(fn=cmd_dax)

    sp = sub.add_parser("backup", help="back up a live node")
    host_flags(sp)
    sp.add_argument("--output-dir", required=True)
    sp.add_argument("--quiet", action="store_true")
    sp.set_defaults(fn=cmd_backup)

    sp = sub.add_parser("restore", help="restore a backup to a node")
    host_flags(sp)
    sp.add_argument("--source-dir", required=True)
    sp.add_argument("--quiet", action="store_true")
    sp.set_defaults(fn=cmd_restore)

    sp = sub.add_parser("import", help="import a CSV file")
    host_flags(sp)
    sp.add_argument("--index", "-i", required=True)
    sp.add_argument("--batch-size", type=int, default=65536)
    sp.add_argument("--concurrency", type=int, default=1)
    sp.add_argument("--keys", action="store_true",
                    help="index uses string column keys")
    sp.add_argument("file")
    sp.set_defaults(fn=cmd_import)

    sp = sub.add_parser("export", help="export a field as CSV")
    host_flags(sp)
    sp.add_argument("--index", "-i", required=True)
    sp.add_argument("--field", "-f", required=True)
    sp.add_argument("--output", "-o", default=None)
    sp.set_defaults(fn=cmd_export)

    sp = sub.add_parser("generate-config",
                        help="print the default config file")
    sp.set_defaults(fn=cmd_generate_config)

    sp = sub.add_parser("keygen", help="mint an HS256 bearer token")
    sp.add_argument("--secret", required=True)
    sp.add_argument("--subject", default="admin")
    sp.add_argument("--groups", default="")
    sp.add_argument("--ttl", type=float, default=3600.0)
    sp.set_defaults(fn=cmd_keygen)

    sp = sub.add_parser("rbf", help="inspect an RBF shard file")
    sp.add_argument("file")
    sp.set_defaults(fn=cmd_rbf)

    sp = sub.add_parser("sql", help="interactive SQL shell (fbsql)")
    host_flags(sp)
    sp.add_argument("-c", "--command", default=None,
                    help="run one statement and exit")
    sp.set_defaults(fn=cmd_sql)

    sp = sub.add_parser("version")
    sp.set_defaults(fn=cmd_version)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    try:
        return args.fn(args)
    except Exception as e:
        print(f"error: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
