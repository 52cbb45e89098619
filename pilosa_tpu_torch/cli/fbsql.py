"""fbsql — interactive SQL shell (cli/cli.go, cmd/fbsql).

Reads statements (``;``-terminated, readline history when on a tty),
POSTs them to a node's /sql endpoint, and renders aligned tables.
Backslash meta-commands follow the reference's psql-style set
(cli/cli.go commands):

    \\d             list tables            (SHOW TABLES)
    \\d <table>     describe a table       (SHOW COLUMNS)
    \\timing        toggle timing output
    \\profile       toggle per-query span trees (Profile=true)
    \\pql <index> <query>   run raw PQL against an index
    \\q             quit
"""

from __future__ import annotations

import sys
import time


def _render(schema, rows, out=sys.stdout):
    if not schema:
        print("OK", file=out)
        return
    names = [f["name"] for f in schema]
    srows = [[("" if v is None else str(v)) for v in row] for row in rows]
    widths = [max(len(n), *(len(r[i]) for r in srows)) if srows else len(n)
              for i, n in enumerate(names)]
    line = " | ".join(n.ljust(w) for n, w in zip(names, widths))
    print(line, file=out)
    print("-+-".join("-" * w for w in widths), file=out)
    for r in srows:
        print(" | ".join(v.ljust(w) for v, w in zip(r, widths)), file=out)
    print(f"({len(srows)} row{'s' if len(srows) != 1 else ''})", file=out)


def _render_spans(spans, out, depth=0):
    """Profile span tree, indented — the CLI face of the flight
    recorder's device-phase attribution."""
    for s in spans:
        tags = s.get("tags", {})
        tag_s = ("  " + " ".join(f"{k}={v}" for k, v in tags.items())
                 if tags else "")
        print(f"{'  ' * depth}{s['name']}: "
              f"{s['duration_us'] / 1e3:.3f} ms{tag_s}", file=out)
        _render_spans(s.get("children", []), out, depth + 1)


class Shell:
    def __init__(self, host: str, client):
        self.host = host
        self.client = client
        self.timing = False
        self.profile = False

    def execute(self, stmt: str, out=sys.stdout) -> bool:
        """Run one statement; returns False to exit the loop."""
        from pilosa_tpu_torch.cluster.client import RemoteError
        stmt = stmt.strip().rstrip(";").strip()
        if not stmt:
            return True
        if stmt.startswith("\\"):
            return self._meta(stmt, out)
        t0 = time.perf_counter()
        try:
            resp = self.client._request(self.host, "POST", "/sql",
                                        {"sql": stmt})
        except RemoteError as e:
            print(f"ERROR: {e}", file=out)
            return True
        _render(resp.get("schema", {}).get("fields", []),
                resp.get("data", []), out)
        if self.timing:
            print(f"Time: {(time.perf_counter() - t0) * 1e3:.1f} ms",
                  file=out)
        return True

    def _meta(self, cmd: str, out) -> bool:
        parts = cmd.split()
        if parts[0] == "\\q":
            return False
        if parts[0] == "\\timing":
            self.timing = not self.timing
            print(f"Timing is {'on' if self.timing else 'off'}.",
                  file=out)
            return True
        if parts[0] == "\\profile":
            self.profile = not self.profile
            print(f"Profiling is {'on' if self.profile else 'off'}.",
                  file=out)
            return True
        if parts[0] == "\\pql":
            if len(parts) < 3:
                print("usage: \\pql <index> <query>", file=out)
                return True
            return self._pql(parts[1], " ".join(parts[2:]), out)
        if parts[0] == "\\d":
            if len(parts) == 1:
                return self.execute("SHOW TABLES", out)
            return self.execute(f"SHOW COLUMNS FROM {parts[1]}", out)
        print(f"unknown command {parts[0]!r}", file=out)
        return True

    def _pql(self, index: str, query: str, out) -> bool:
        """Raw PQL with the shell's profile toggle: Profile=true
        responses include the device-phase span tree."""
        import json as _json

        from pilosa_tpu_torch.cluster.client import RemoteError
        path = f"/index/{index}/query"
        if self.profile:
            path += "?profile=true"
        try:
            resp = self.client._request(self.host, "POST", path,
                                        {"query": query})
        except RemoteError as e:
            print(f"ERROR: {e}", file=out)
            return True
        for r in resp.get("results", []):
            print(_json.dumps(r), file=out)
        if self.profile and resp.get("profile"):
            print("-- profile --", file=out)
            _render_spans(resp["profile"], out)
        return True

    def repl(self):
        try:
            import readline  # noqa: F401 — history + line editing
        except ImportError:
            pass
        buf = ""
        while True:
            try:
                prompt = "fbsql> " if not buf else "  ...> "
                line = input(prompt)
            except (EOFError, KeyboardInterrupt):
                print()
                return 0
            buf += line
            if line.strip().startswith("\\") or buf.rstrip().endswith(";"):
                if not self.execute(buf):
                    return 0
                buf = ""
            else:
                buf += " "


def run_shell(args) -> int:
    from pilosa_tpu_torch.cluster.client import InternalClient
    headers = {}
    if getattr(args, "token", None):
        headers["Authorization"] = f"Bearer {args.token}"
    sh = Shell(args.host, InternalClient(headers=headers))
    if args.command:
        sh.execute(args.command)
        return 0
    return sh.repl()
