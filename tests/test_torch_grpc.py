"""The port's gRPC plane against the JAX package's.

A ``GRPCServer`` of each package serves the same seeded data (width
2048, four shards; the port on the CPU), and the same calls go to both:
QueryPQL and QuerySQL, streamed and unary, Inspect by ids and by keys,
the index calls, the error codes, authentication and authorization, and
SQL DML under an exclusive transaction.  The answers must be equal
message for message, except for ``duration`` (each server's own
clock), which is zeroed before the comparison; a failed call must end
with the same status code and details."""

import time

import grpc
import pytest

from pilosa_tpu.api import API as JaxAPI
from pilosa_tpu.server.authn import Authenticator as JaxAuthenticator
from pilosa_tpu.server.authn import encode_jwt
from pilosa_tpu.server.authz import Authorizer as JaxAuthorizer
from pilosa_tpu.server.grpc import GRPCServer as JaxGRPCServer
from pilosa_tpu_torch.api import API
from pilosa_tpu_torch.server.authn import Authenticator
from pilosa_tpu_torch.server.authz import Authorizer
from pilosa_tpu_torch.server.grpc import GRPCServer
from pilosa_tpu_torch.server.proto import pb
from torch_server_dual import build_holder

SECRET = b"grpc-secret"
GROUPS = {"readers": {"i": "read"}, "writers": {"i": "write"}}


def _pair(auth: bool):
    jh, ph = build_holder("jax"), build_holder("port")
    japi, papi = JaxAPI(jh), API(ph, device="cpu")
    ja = pa = None
    if auth:
        ja = (JaxAuthenticator(SECRET), JaxAuthorizer(GROUPS, "admins"))
        pa = (Authenticator(SECRET), Authorizer(GROUPS, "admins"))
    js = JaxGRPCServer(japi, bind="127.0.0.1:0", auth=ja).start()
    ps = GRPCServer(papi, bind="127.0.0.1:0", auth=pa).start()
    chans = (grpc.insecure_channel(js.uri), grpc.insecure_channel(ps.uri))
    return (jh, ph), (japi, papi), (js, ps), chans


def _close(holders, servers, chans):
    for c in chans:
        c.close()
    for s in servers:
        s.stop()
    for h in holders:
        h.close()


@pytest.fixture(scope="module")
def nodes():
    holders, apis, servers, chans = _pair(auth=False)
    yield apis, chans
    _close(holders, servers, chans)


@pytest.fixture(scope="module")
def auth_nodes():
    holders, apis, servers, chans = _pair(auth=True)
    yield chans
    _close(holders, servers, chans)


def _invoke(chan, method, req, resp_cls, stream, md=None):
    """(messages with duration zeroed, None) or (None, (code, details))."""
    kw = dict(request_serializer=req.SerializeToString,
              response_deserializer=resp_cls.FromString)
    path = f"/proto.Pilosa/{method}"
    try:
        if stream:
            out = list(chan.unary_stream(path, **kw)(req, metadata=md))
        else:
            out = [chan.unary_unary(path, **kw)(req, metadata=md)]
    except grpc.RpcError as e:
        return None, (e.code(), e.details())
    for m in out:
        if hasattr(m, "duration"):
            m.duration = 0
    return [m.SerializeToString(deterministic=True) for m in out], None


PQL = ["Count(Row(a=1))", "Row(a=2)", "TopN(s, n=3)", "TopN(s, Row(a=1))",
       "Sum(field=age)", "Min(Row(a=0), field=age)", "Max(field=price)",
       "GroupBy(Rows(a), Rows(m))", "GroupBy(Rows(a), aggregate=Sum(field=age))",
       "Distinct(field=age)", "Count(Row(age > 100))", "Rows(s)",
       "Row(age=17)", "Count(Row(a=1)", "Count(Row(zz=1))"]
SQL = ["SELECT COUNT(*) FROM i", "SELECT _id, age, price FROM i "
       "WHERE age > 110 ORDER BY _id", "SELECT a, COUNT(*) FROM i GROUP BY a",
       "SELECT SUM(price) FROM i", "SHOW TABLES", "SELECT nope FROM i"]
KEYED = ["Row(tag=red)", "TopN(tag)", "GroupBy(Rows(tag))", "Count(All())"]


@pytest.mark.parametrize("stream", [True, False], ids=["stream", "unary"])
@pytest.mark.parametrize("index,pql", [("i", q) for q in PQL]
                         + [("k", q) for q in KEYED])
def test_pql_matches_jax(nodes, index, pql, stream):
    _apis, chans = nodes
    req = pb.QueryPQLRequest(index=index, pql=pql)
    resp = pb.RowResponse if stream else pb.TableResponse
    method = "QueryPQL" if stream else "QueryPQLUnary"
    jgot, pgot = [_invoke(c, method, req, resp, stream) for c in chans]
    assert pgot == jgot


@pytest.mark.parametrize("stream", [True, False], ids=["stream", "unary"])
@pytest.mark.parametrize("sql", SQL)
def test_sql_matches_jax(nodes, sql, stream):
    _apis, chans = nodes
    req = pb.QuerySQLRequest(sql=sql)
    resp = pb.RowResponse if stream else pb.TableResponse
    method = "QuerySQL" if stream else "QuerySQLUnary"
    jgot, pgot = [_invoke(c, method, req, resp, stream) for c in chans]
    assert pgot == jgot


def _inspect_reqs():
    ids = pb.IdsOrKeys(ids=pb.Uint64Array(vals=[1, 2, 42, 100, 2049, 5000]))
    keys = pb.IdsOrKeys(keys=pb.StringArray(vals=["u1", "u7", "nope"]))
    return [("i", pb.InspectRequest(index="i", columns=ids)),
            ("i-filter", pb.InspectRequest(index="i", columns=ids,
                                           filterFields=["age", "m"],
                                           limit=3, offset=1)),
            ("k", pb.InspectRequest(index="k", columns=keys)),
            ("404", pb.InspectRequest(index="nope", columns=ids))]


@pytest.mark.parametrize("case", _inspect_reqs(), ids=lambda c: c[0])
def test_inspect_matches_jax(nodes, case):
    _apis, chans = nodes
    jgot, pgot = [_invoke(c, "Inspect", case[1], pb.RowResponse, True)
                  for c in chans]
    assert pgot == jgot
    assert jgot[0] or jgot[1][0] == grpc.StatusCode.NOT_FOUND


INDEX_CALLS = [
    ("CreateIndex", pb.CreateIndexRequest(name="g"), pb.CreateIndexResponse),
    ("CreateIndex", pb.CreateIndexRequest(name="g"), pb.CreateIndexResponse),
    ("CreateIndex", pb.CreateIndexRequest(name="Bad"),
     pb.CreateIndexResponse),
    ("GetIndex", pb.GetIndexRequest(name="g"), pb.GetIndexResponse),
    ("GetIndex", pb.GetIndexRequest(name="nope"), pb.GetIndexResponse),
    ("GetIndexes", pb.GetIndexesRequest(), pb.GetIndexesResponse),
    ("DeleteIndex", pb.DeleteIndexRequest(name="g"), pb.DeleteIndexResponse),
    ("DeleteIndex", pb.DeleteIndexRequest(name="g"), pb.DeleteIndexResponse),
]


@pytest.mark.parametrize("i", range(len(INDEX_CALLS)))
def test_index_calls_match_jax(nodes, i):
    method, req, resp = INDEX_CALLS[i]
    _apis, chans = nodes
    jgot, pgot = [_invoke(c, method, req, resp, False) for c in chans]
    assert pgot == jgot


def test_sql_write_under_exclusive_transaction(nodes):
    """SQL DML answers with the transaction's 409 message while an
    exclusive transaction is active, then lands once it is finished."""
    apis, chans = nodes
    ins = pb.QuerySQLRequest(sql="INSERT INTO i (_id, a) VALUES (3, 3)")
    for api in apis:
        api.start_transaction(id="t", exclusive=True)
    jgot, pgot = [_invoke(c, "QuerySQLUnary", ins, pb.TableResponse, False)
                  for c in chans]
    assert pgot == jgot and "exclusive transaction" in pgot[1][1]
    for api in apis:
        api.finish_transaction("t")
    jgot, pgot = [_invoke(c, "QuerySQLUnary", ins, pb.TableResponse, False)
                  for c in chans]
    assert pgot == jgot and pgot[0] is not None
    req = pb.QueryPQLRequest(index="i", pql="Row(a=3)")
    jgot, pgot = [_invoke(c, "QueryPQLUnary", req, pb.TableResponse, False)
                  for c in chans]
    assert pgot == jgot


def _md(groups=None, secret=SECRET):
    if groups is None:
        return None
    tok = encode_jwt({"sub": "u", "groups": groups,
                      "exp": time.time() + 600}, secret)
    return (("authorization", "Bearer " + tok),)


AUTH_CASES = [
    ("no-token", "QueryPQLUnary",
     pb.QueryPQLRequest(index="i", pql="Count(All())"), None),
    ("bad-secret", "QueryPQLUnary",
     pb.QueryPQLRequest(index="i", pql="Count(All())"), "bad"),
    ("reader", "QueryPQLUnary",
     pb.QueryPQLRequest(index="i", pql="Count(Row(a=1))"), ["readers"]),
    ("reader-write", "QueryPQLUnary",
     pb.QueryPQLRequest(index="i", pql="Set(1, a=1)"), ["readers"]),
    ("writer-write", "QueryPQLUnary",
     pb.QueryPQLRequest(index="i", pql="Set(1, a=1)"), ["writers"]),
    ("reader-k", "QueryPQLUnary",
     pb.QueryPQLRequest(index="k", pql="Count(All())"), ["readers"]),
    ("reader-sql", "QuerySQLUnary",
     pb.QuerySQLRequest(sql="SELECT COUNT(*) FROM i"), ["readers"]),
    ("reader-sql-k", "QuerySQLUnary",
     pb.QuerySQLRequest(sql="SELECT COUNT(*) FROM k"), ["readers"]),
    ("reader-indexes", "GetIndexes", pb.GetIndexesRequest(), ["readers"]),
    ("admin-indexes", "GetIndexes", pb.GetIndexesRequest(), ["admins"]),
    ("reader-create", "CreateIndex", pb.CreateIndexRequest(name="z"),
     ["readers"]),
]
_RESP = {"QueryPQLUnary": pb.TableResponse, "QuerySQLUnary": pb.TableResponse,
         "GetIndexes": pb.GetIndexesResponse,
         "CreateIndex": pb.CreateIndexResponse}


@pytest.mark.parametrize("case", AUTH_CASES, ids=[c[0] for c in AUTH_CASES])
def test_auth_matches_jax(auth_nodes, case):
    _id, method, req, groups = case
    md = (_md(["readers"], secret=b"other") if groups == "bad"
          else _md(groups))
    jgot, pgot = [_invoke(c, method, req, _RESP[method], False, md=md)
                  for c in auth_nodes]
    assert pgot == jgot
