"""The port's CLI, client library and task pool against the JAX package's.

- ``generate-config``, ``keygen``, ``version``, ``rbf``, and ``import``,
  ``export`` and ``sql`` against a port node on the CPU, each beside the
  JAX command against a JAX node on the same data: the same output (the
  version string and the token's expiry aside) and the same node state;
- the PQL text of ``client.py``'s builders equals the JAX builders';
- ``taskpool.Pool`` maps, grows when blocked and settles failures;
- ``python -m pilosa_tpu_torch.cli.main server --device cpu`` in a
  subprocess: started, imported into, queried, killed with SIGKILL and
  started again on the same directory, where every acknowledged write
  reads back;
- ``python -m pilosa_tpu_torch.cli.main dax --device cpu`` in a
  subprocess with [blob] backend = "dir": SQL DDL, INSERT and SELECT
  through the queryer front;
- no fallback: ``cli server`` and ``cli dax`` without ``--device`` on a
  machine with no card fail naming it."""

import base64
import contextlib
import http.client
import importlib
import io
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest
import torch

from pilosa_tpu import client as jax_client
from pilosa_tpu.server.authn import decode_jwt as jax_decode
from pilosa_tpu_torch import client
from pilosa_tpu_torch.server.authn import decode_jwt
from pilosa_tpu_torch.taskpool import Pool, TaskFailure
from torch_server_dual import build_holder, dual_servers, restore_globals

ROOT = Path(__file__).resolve().parents[1]
jax_cli = importlib.import_module("pilosa_tpu.cli.main")
cli = importlib.import_module("pilosa_tpu_torch.cli.main")


def _run(mod, argv) -> tuple[int, str, str]:
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = mod.main(argv)
    return rc, out.getvalue(), err.getvalue()


@pytest.fixture(scope="module")
def nodes():
    jh, ph = build_holder("jax"), build_holder("port")
    with dual_servers(jh, ph) as pair:
        yield pair
    jh.close()
    ph.close()


def _host(srv) -> str:
    return f"127.0.0.1:{srv.port}"


def test_version():
    from pilosa_tpu_torch import __version__
    rc, out, _ = _run(cli, ["version"])
    assert rc == 0 and out.strip() == __version__


@pytest.mark.parametrize("groups", ["", "a,b"])
def test_keygen_tokens_decode_alike(groups):
    argv = ["keygen", "--secret", "k", "--subject", "ops", "--ttl", "60"]
    if groups:
        argv += ["--groups", groups]
    rc, tok, _ = _run(cli, argv)
    assert rc == 0
    rc2, jtok, _ = _run(jax_cli, argv)
    got = decode_jwt(tok.strip(), b"k")
    want = jax_decode(jtok.strip(), b"k")
    assert abs(got.pop("exp") - want.pop("exp")) < 5
    assert got == want == {"sub": "ops",
                           "groups": groups.split(",") if groups else []}
    assert jax_decode(tok.strip(), b"k")["sub"] == "ops"


CSV = "_id,a:id,age:int\n" + "".join(
    f"{c},{c % 4},{c % 97}\n" for c in range(0, 8000, 37))


@pytest.mark.parametrize("batch_size", [16, 1000])
def test_import_csv_matches_jax(nodes, tmp_path, batch_size):
    """The CSV import through HTTPImporter lands the same bits in a port
    node as the JAX command does in a JAX node."""
    js, ps = nodes
    p = tmp_path / "in.csv"
    p.write_text(CSV)
    index = f"csv{batch_size}"
    n = len(CSV.splitlines()) - 1
    for mod, srv in ((jax_cli, js), (cli, ps)):
        rc, out, err = _run(mod, ["import", "--host", _host(srv), "-i",
                                  index, "--batch-size", str(batch_size),
                                  str(p)])
        assert rc == 0, err
        assert out.strip() == f"imported {n} records into {index}"
    reads = ("Row(a=1) Count(Row(a=3)) Sum(field=age) TopN(a) "
             "Count(All())")
    assert ps.api.query(index, reads) == js.api.query(index, reads)
    assert ps.api.query(index, "Count(All())")["results"] == [n]


def test_export_matches_jax(nodes, tmp_path):
    js, ps = nodes
    outs = []
    for mod, srv in ((jax_cli, js), (cli, ps)):
        dst = tmp_path / f"{mod.__name__}.csv"
        rc, _o, err = _run(mod, ["export", "--host", _host(srv), "-i", "i",
                                 "-f", "a", "-o", str(dst)])
        assert rc == 0, err
        outs.append(dst.read_text())
    assert outs[1] == outs[0] and outs[0].count("\n") > 100


SQL = ["SELECT COUNT(*) FROM i", "SELECT a, COUNT(*) FROM i GROUP BY a",
       "SELECT _id, age FROM i WHERE age > 115 ORDER BY _id LIMIT 4",
       "SHOW TABLES", "SELECT nope FROM i", r"\d i"]


@pytest.mark.parametrize("stmt", SQL)
def test_sql_command_matches_jax(nodes, stmt):
    js, ps = nodes
    got = [_run(mod, ["sql", "--host", _host(srv), "-c", stmt])
           for mod, srv in ((jax_cli, js), (cli, ps))]
    assert got[1] == got[0]


def test_sql_shell_reads_piped_statements(nodes):
    """The interactive shell, fed statements on its standard input."""
    js, ps = nodes
    outs = []
    for pkg, srv in (("pilosa_tpu", js), ("pilosa_tpu_torch", ps)):
        r = subprocess.run(
            [sys.executable, "-m", f"{pkg}.cli.main", "sql", "--host",
             _host(srv)], cwd=ROOT, capture_output=True, text=True,
            timeout=120, env=dict(os.environ, PYTHONPATH=str(ROOT)),
            input="SELECT COUNT(*) FROM i;\nSELECT MAX(age)\n FROM i;\n"
                  "\\q\n")
        outs.append((r.returncode, r.stdout))
    assert outs[1] == outs[0] and outs[0][1].count("(1 row)") == 2


def test_rbf_inspects_the_same_file(tmp_path, monkeypatch):
    """Both commands read one RBF shard file the JAX package wrote."""
    monkeypatch.setenv("RBF_NOSYNC", "1")
    h = build_holder("jax", path=str(tmp_path / "d"))
    h.close()
    files = sorted(p for p in (tmp_path / "d").rglob("*")
                   if p.is_file() and p.suffix == "" and
                   p.parent.name == "shards")
    files = files or sorted(p for p in (tmp_path / "d").rglob("*.rbf"))
    assert files
    for f in files[:2]:
        got = [_run(mod, ["rbf", str(f)]) for mod in (jax_cli, cli)]
        assert got[1] == got[0] and got[0][0] == 0


# -- client.py -----------------------------------------------------------------

def _builders(mod):
    s = mod.Schema()
    i = s.index("events", keys=True)
    u = i.field("user", keys=True)
    n = i.field("n", type="int", min=0, max=100)
    t = i.field("t")
    r = u.row("alice")
    return [r.text, (r & u.row("bob")).text, (r | t.row(3)).text,
            (r ^ t.row(1)).text, (r - t.row(2)).text, (~r).text,
            u.set("c1", "alice").text, u.clear(7, "bob").text,
            t.topn(5).text, t.topn(3, filter=r).text, t.rows().text,
            n.sum().text, n.sum(filter=r).text, n.min().text,
            n.max(filter=t.row(1)).text, n.gt(5).text, n.lt(50).text,
            n.between(10, 20).text, i.count(r).text,
            i.group_by(t.rows(), u.rows()).text,
            i.batch_query(i.count(r), t.topn(2)).text,
            repr(r), s.to_dict()]


def test_client_builders_match_jax():
    assert _builders(client) == _builders(jax_client)


def test_client_against_port_node(nodes):
    js, ps = nodes
    got = []
    for mod, srv in ((jax_client, js), (client, ps)):
        c = mod.Client(_host(srv))
        s = c.schema()
        ix = s.index("cl")
        f = ix.field("f")
        v = ix.field("v", type="int", min=0, max=1000)
        c.sync_schema(s)
        c.import_bits("cl", "f", [(1, 3), (1, 2050), (2, 9)])
        c.import_values("cl", "v", [(3, 40), (9, 700)])
        got.append((c.query(ix.batch_query(ix.count(f.row(1)), f.topn(2),
                                           v.sum(), v.gt(100))),
                    c.sql("SELECT COUNT(*) FROM cl"),
                    sorted(ix["name"] for ix in c.schema().to_dict()[
                        "indexes"]) if hasattr(c.schema(), "to_dict")
                    else None, c.status()["state"]))
    assert got[1] == got[0]


# -- taskpool ------------------------------------------------------------------

def test_pool_map_order_results_and_errors():
    p = Pool(size=3)
    assert p.map(lambda x: x * 2, range(10)) == [x * 2 for x in range(10)]
    assert p.map(lambda x: x, []) == []

    def f(x):
        if x in (3, 7):
            raise ValueError(f"boom{x}")
        return x
    with pytest.raises(ValueError, match="boom3"):
        p.map(f, range(10))


def test_pool_grows_when_all_blocked():
    p = Pool(size=1, max_size=8)
    barrier = threading.Barrier(2, timeout=5)

    def task(pool, i):
        with pool.blocked():
            barrier.wait()
        return i
    assert p.map(task, [0, 1]) == [0, 1]


def test_pool_map_settled_keeps_siblings():
    p = Pool(size=2)

    def f(x):
        if x % 3 == 0:
            raise RuntimeError(f"dead-{x}")
        return x * 10
    outs = p.map_settled(f, range(7))
    assert [o for o in outs if not isinstance(o, TaskFailure)] == \
        [10, 20, 40, 50]
    assert [o.item for o in outs if isinstance(o, TaskFailure)] == [0, 3, 6]


# -- the server command in a subprocess ----------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(args):
    env = dict(os.environ, PYTHONPATH=str(ROOT), RBF_NOSYNC="1")
    return subprocess.Popen(
        [sys.executable, "-m", "pilosa_tpu_torch.cli.main", *args],
        env=env, stderr=subprocess.PIPE, stdout=subprocess.DEVNULL,
        text=True, cwd=ROOT)


def _req(port, method, path, body=None, token=None, timeout=60):
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    hdrs = {"Authorization": f"Bearer {token}"} if token else {}
    c.request(method, path, body=None if body is None
              else json.dumps(body), headers=hdrs)
    r = c.getresponse()
    out = (r.status, json.loads(r.read()))
    c.close()
    return out


def _wait_listening(p, port, token=None):
    deadline = time.time() + 120
    while True:
        try:
            return _req(port, "GET", "/version", timeout=5)
        except OSError:
            if p.poll() is not None or time.time() > deadline:
                pytest.fail(f"server never listened: "
                            f"{p.stderr.read()[-800:]}")
            time.sleep(0.2)


def test_server_command_kill_and_restart(tmp_path):
    """A port node on the CPU, with auth: a token from keygen queries, a
    request without one answers 401; the CLI import and /ingest land;
    after SIGKILL and a restart on the same directory, every
    acknowledged write reads back."""
    port = _free_port()
    data = tmp_path / "node"
    args = ["server", "--device", "cpu", "--data-dir", str(data),
            "--bind", "127.0.0.1", "--port", str(port), "--grpc-port", "-1",
            "--auth-secret", "sek"]
    _rc, tok, _ = _run(cli, ["keygen", "--secret", "sek"])
    tok = tok.strip()
    p = _spawn(args)
    try:
        _wait_listening(p, port)
        assert _req(port, "GET", "/status")[0] == 401
        csv = tmp_path / "in.csv"
        csv.write_text("_id,a:id\n" + "".join(f"{c},{c % 3}\n"
                                           for c in range(0, 9000, 7)))
        rc, _out, err = _run(cli, ["import", "--host", f"127.0.0.1:{port}",
                                   "--token", tok, "-i", "ev", str(csv)])
        assert rc == 0, err
        st, body = _req(port, "POST", "/index/ev/ingest",
                        {"writes": [{"field": "a", "rows": [5, 5],
                                     "columns": [3, 8191]}]}, token=tok)
        assert st == 200 and body["landed"] == 2
        st, body = _req(port, "POST", "/index/ev/query",
                        {"query": "Set(4, a=6)"}, token=tok)
        assert st == 200
        q = {"query": "Count(Row(a=0)) Count(Row(a=1)) Row(a=5) Row(a=6) "
                      "Count(All())"}
        st, before = _req(port, "POST", "/index/ev/query", q, token=tok)
        assert st == 200
        assert before["results"][2] == {"columns": [3, 8191]}
        p.send_signal(signal.SIGKILL)
        p.wait(30)
        t0 = time.time()
        p = _spawn(args)
        _wait_listening(p, port)
        st, after = _req(port, "POST", "/index/ev/query", q, token=tok)
        assert time.time() - t0 < 120
        assert st == 200 and after == before
    finally:
        p.kill()
        p.wait(30)


def test_dax_command_serves_sql_from_a_blob_tier(tmp_path):
    """``cli.main dax --device cpu`` in a subprocess, with [blob]
    backend = "dir" from its --config: two workers and a standby; the
    queryer front answers a CREATE TABLE, an INSERT over three shards
    and a GROUP BY on /sql and a PQL count on /queryer/{table}; the
    blob tier lives under --data-dir; SIGINT stops it."""
    port = _free_port()
    cfg = tmp_path / "dax.toml"
    cfg.write_text('[blob]\nbackend = "dir"\n\n[dax]\nstandby = 1\n'
                   'prefetch = 0\n')
    data = tmp_path / "dax"
    p = _spawn(["dax", "--device", "cpu", "--config", str(cfg),
                "--data-dir", str(data), "--port", str(port)])
    try:
        deadline = time.time() + 120
        while True:
            try:
                st, status = _req(port, "GET", "/dax/status", timeout=5)
                break
            except OSError:
                if p.poll() is not None or time.time() > deadline:
                    pytest.fail(f"dax never listened: "
                                f"{p.stderr.read()[-800:]}")
                time.sleep(0.2)
        assert st == 200
        assert status["workers"] == ["worker0", "worker1"]
        assert status["standbys"] == ["standby0"]
        shard = 1 << 20
        for stmt in ("CREATE TABLE ev (_id id, n int min 0 max 100, g id)",
                     f"INSERT INTO ev (_id, n, g) VALUES (1, 5, 1), "
                     f"({shard + 2}, 7, 1), ({2 * shard + 3}, 9, 2)"):
            st, body = _req(port, "POST", "/sql", {"sql": stmt})
            assert st == 200, body
        st, body = _req(port, "POST", "/sql",
                        {"sql": "SELECT g, count(*), sum(n) FROM ev "
                                "GROUP BY g"})
        assert st == 200, body
        assert sorted(body["data"]) == [[1, 2, 12], [2, 1, 9]]
        st, body = _req(port, "POST", "/queryer/ev",
                        {"query": "Count(Row(g=1))"})
        assert st == 200 and body["results"] == [2]
        assert (data / "blob").is_dir()
    finally:
        p.send_signal(signal.SIGINT)
        try:
            p.wait(30)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait(30)


def test_dax_command_needs_a_card_unless_told_cpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with restore_globals():
        rc, _out, err = _run(cli, ["dax", "--data-dir", str(tmp_path)])
    assert rc == 1 and "no CUDA device" in err


def test_server_command_needs_a_card_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with restore_globals():
        rc, _out, err = _run(cli, ["server", "--port", "0",
                                   "--grpc-port", "-1"])
    assert rc == 1 and "no CUDA device" in err


def test_server_wants_a_card_by_default(monkeypatch):
    from pilosa_tpu_torch.server.http import Server
    from pilosa_tpu_torch import config
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with restore_globals(), pytest.raises(RuntimeError,
                                          match="no CUDA device"):
        Server(config=config.load(None, env={}))


def test_jwt_round_trip_between_packages():
    from pilosa_tpu.server.authn import encode_jwt as jax_encode
    from pilosa_tpu_torch.server.authn import Authenticator, AuthError, \
        encode_jwt
    claims = {"sub": "x", "groups": ["g"], "exp": time.time() + 60}
    assert encode_jwt(claims, b"s") == jax_encode(claims, b"s")
    a = Authenticator(b"s")
    assert a.authenticate("Bearer " + jax_encode(claims, b"s"))["sub"] == "x"
    with pytest.raises(AuthError):
        a.authenticate("Bearer " + encode_jwt(
            dict(claims, exp=time.time() - 5), b"s"))
    with pytest.raises(AuthError):
        a.authenticate("Basic " + base64.b64encode(b"u:p").decode())


def test_http_importer_import_columns_matches_jax(nodes):
    """HTTPImporter's columnar .npz import lands the same bits through
    both nodes."""
    from pilosa_tpu.ingest.importer import HTTPImporter as JaxHTTPImporter
    from pilosa_tpu_torch.ingest.importer import HTTPImporter
    js, ps = nodes
    cols = list(range(5, 8000, 41))
    bits = {"a": [c % 4 for c in cols]}
    values = {"age": [c % 120 for c in cols]}
    got = []
    for cls, srv in ((JaxHTTPImporter, js), (HTTPImporter, ps)):
        n = cls(f"http://{_host(srv)}").import_columns("i", cols, bits=bits,
                                                      values=values)
        got.append((n, srv.api.query("i", "Row(a=2) Sum(field=age)")))
    assert got[1] == got[0] and got[0][0] == 2 * len(cols)
