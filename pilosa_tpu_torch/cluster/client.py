"""InternalClient — node-to-node HTTP data plane.

Reference: internal_client.go:35 (QueryNode, imports, translate-data
streaming between nodes).  JSON over HTTP against the same public
route surface (the reference also reuses its handler routes with
``Remote=true``); connections are short-lived — cross-HOST traffic is
rare by design (per-query fan-out only exists across slices, never
across devices of one slice).

Failure plane: every request carries a per-attempt CONNECT
deadline and a per-attempt READ deadline (the reference's
http.Client splits these the same way via DialContext vs overall
timeout), both clamped by an optional end-to-end :class:`Deadline`
the coordinator propagates from the caller's budget.  Idempotent
reads retry transient failures (connection errors, timeouts,
``RemoteError.retryable`` statuses) with jittered exponential backoff
bounded by the deadline; writes never retry here — their replication
contract lives in the coordinator.  The ``rpc-drop``/``rpc-delay``
fault points (obs/faults.py) sit at the head of every attempt, so
chaos tests strike exactly where real network faults do.
"""

from __future__ import annotations

import http.client
import json
import random
import time

from pilosa_tpu_torch.obs import faults

# statuses a healthy retry can clear: overload shedding and transient
# gateway failures.  4xx application errors never retry.
_RETRYABLE_STATUS = frozenset({429, 502, 503, 504})


class Deadline:
    """Absolute end-to-end budget carried through retries, failover
    re-plans, and hedges; per-attempt socket budgets derive from
    ``remaining()`` so one slow attempt can't silently eat the whole
    budget of the attempts behind it."""

    __slots__ = ("at",)

    def __init__(self, seconds: float):
        self.at = time.monotonic() + float(seconds)

    def remaining(self) -> float:
        return self.at - time.monotonic()

    def expired(self) -> bool:
        return self.remaining() <= 0


class DeadlineExceeded(TimeoutError):
    """The caller's end-to-end deadline ran out before (or during) an
    attempt.  ``status`` maps it to HTTP 504 at the server boundary —
    the caller's budget expired, which is neither a server bug (500)
    nor a replica outage (503)."""

    status = 504


class RemoteError(Exception):
    """The remote node answered with an error status.

    ``retryable`` classifies the failure for the retry loop: True for
    load-shed/transient statuses (429/502/503/504 — another attempt
    may land on a recovered or different backend), False for
    application errors (a 400 retried is a 400 again).  A 410 carries
    the rebalance redirect hints when the peer sent them:
    ``new_owner`` (the ``X-Pilosa-New-Owner`` URI) and
    ``moved_shards`` — retryable-with-REDIRECT, which the typed
    wrappers below (query_node, import_bits/-values) apply bounded to
    one hop; before ShardMovedError existed an ownership flip mid-RPC
    surfaced as a phantom no-live-replica 503."""

    def __init__(self, status: int, msg: str,
                 retryable: bool | None = None):
        super().__init__(f"remote {status}: {msg}")
        self.status = status
        self.retryable = (status in _RETRYABLE_STATUS
                          if retryable is None else retryable)
        self.new_owner: str | None = None     # URI from the 410 header
        self.new_owner_id: str | None = None
        self.moved_shards: list[int] | None = None


class ShardMovedError(Exception):
    """Typed 410: this node no longer owns the addressed shard(s) —
    an online rebalance fenced them and flipped ownership while the
    request was in flight.  Carries the redirect target so clients
    retry transparently against the new owner (one hop) and
    coordinators re-plan from a fresh placement snapshot instead of
    shedding a phantom 503.

    ``owner_uri`` may be None during the brief FENCING window's
    resolution (ownership still settling): that is a pure
    re-plan-with-fresh-snapshot signal, not a redirect."""

    status = 410

    def __init__(self, index: str, shards, owner_id: str | None = None,
                 owner_uri: str | None = None):
        self.index = index
        self.shards = sorted(int(s) for s in shards)
        self.owner_id = owner_id
        self.owner_uri = owner_uri
        where = (f" -> {owner_id or owner_uri}"
                 if (owner_id or owner_uri) else " (replan)")
        super().__init__(
            f"shard(s) {self.shards[:4]} of {index!r} moved{where}")

    @property
    def extra_headers(self) -> dict:
        """Wire headers the HTTP layer attaches to the 410."""
        return ({"X-Pilosa-New-Owner": self.owner_uri}
                if self.owner_uri else {})

    @property
    def error_fields(self) -> dict:
        """Extra JSON fields for the 410 body (client re-parse)."""
        out: dict = {"moved_shards": self.shards, "index": self.index}
        if self.owner_id:
            out["new_owner_id"] = self.owner_id
        return out


# transient failures the retry loop may clear (TimeoutError is an
# OSError subclass since py3.10; HTTPException covers IncompleteRead)
_TRANSIENT = (ConnectionError, OSError, http.client.HTTPException)


class InternalClient:
    def __init__(self, timeout: float = 30.0,
                 headers: dict | None = None,
                 connect_timeout: float | None = None,
                 retries: int = 2, backoff_s: float = 0.05):
        self.timeout = timeout  # per-attempt READ deadline
        # per-attempt CONNECT deadline: a refused/blackholed peer must
        # fail fast so failover can re-plan — never wait a full read
        # timeout to learn a socket won't open
        self.connect_timeout = (min(5.0, timeout)
                                if connect_timeout is None
                                else connect_timeout)
        self.retries = retries          # extra attempts, idempotent only
        self.backoff_s = backoff_s      # first backoff; doubles, jittered
        self.headers = headers or {}  # e.g. Authorization bearer token

    # -- one attempt -----------------------------------------------------

    def _attempt(self, uri: str, method: str, path: str,
                 data: bytes | None, content_type: str | None,
                 deadline: Deadline | None,
                 extra_headers: dict | None = None,
                 ) -> tuple[int, bytes, dict]:
        detail = f"{uri}{path}"
        if deadline is not None and deadline.expired():
            # an exhausted budget means the attempt is never sent
            raise DeadlineExceeded(
                f"deadline exhausted before {method} {path}")
        # faults between the pre-check and the budget math: an
        # injected rpc-delay models network time and must count
        # against the caller's deadline exactly as real slowness would
        faults.fire("rpc-delay", detail)
        faults.fire("rpc-drop", detail)
        connect_t, read_t = self.connect_timeout, self.timeout
        if deadline is not None:
            rem = deadline.remaining()
            if rem <= 0:
                raise DeadlineExceeded(
                    f"deadline exhausted during {method} {path}")
            connect_t = min(connect_t, rem)
            read_t = min(read_t, rem)
        host, _, port = uri.partition(":")
        conn = http.client.HTTPConnection(host, int(port or 80),
                                          timeout=connect_t)
        try:
            conn.connect()                      # connect deadline
            conn.sock.settimeout(read_t)        # read deadline
            headers = dict(self.headers)
            if extra_headers:
                headers.update(extra_headers)
            if content_type is not None:
                headers["Content-Type"] = content_type
            conn.request(method, path, body=data, headers=headers)
            resp = conn.getresponse()
            raw = resp.read()
        finally:
            conn.close()
        return resp.status, raw, resp.headers

    def _roundtrip(self, uri: str, method: str, path: str,
                   data: bytes | None, content_type: str | None,
                   idempotent: bool = False,
                   deadline: Deadline | None = None,
                   extra_headers: dict | None = None) -> bytes:
        """Attempt + bounded jittered-backoff retry (idempotent only)
        + RemoteError mapping.  Returns the raw 200 body."""
        attempts = (self.retries + 1) if idempotent else 1
        delay = self.backoff_s
        last: Exception | None = None
        # the loop runs to the LARGEST possible budget; the per-error
        # `budget` below decides when a given failure class gives up
        for a in range(self.retries + 1):
            try:
                status, raw, hdrs = self._attempt(
                    uri, method, path, data, content_type, deadline,
                    extra_headers)
                if status != 200:
                    body = {}
                    try:
                        body = json.loads(raw)
                        msg = body.get("error", "")
                    except Exception:
                        msg = raw[:200].decode("utf-8", "replace")
                    err = RemoteError(status, msg)
                    if status == 410:
                        # rebalance redirect hints (ShardMovedError
                        # on the peer): the typed wrappers decide
                        # whether a one-hop redirect is safe
                        err.new_owner = hdrs.get("X-Pilosa-New-Owner")
                        if isinstance(body, dict):
                            err.new_owner_id = body.get("new_owner_id")
                            ms = body.get("moved_shards")
                            if isinstance(ms, list):
                                err.moved_shards = [int(s) for s in ms]
                    raise err
                return raw
            except DeadlineExceeded:
                raise  # the budget is gone; backoff can't help
            except (*_TRANSIENT, RemoteError) as e:
                if isinstance(e, RemoteError) and not e.retryable:
                    raise
                last = e
                # a refused connect reached the peer with ZERO bytes,
                # so retrying is safe even for non-idempotent writes —
                # and a momentary accept-queue overflow on an
                # overloaded-but-live node (a storm concentrated by a
                # peer's death) must not read as that node dying too
                budget = (self.retries + 1
                          if isinstance(e, ConnectionRefusedError)
                          else attempts)
                if a >= budget - 1:
                    raise
                # jittered exponential backoff: full jitter on top of
                # the base so synchronized retry storms decorrelate
                sleep = delay * (1.0 + random.random())
                if deadline is not None and \
                        deadline.remaining() <= sleep:
                    raise
                time.sleep(sleep)
                delay *= 2
        raise last  # unreachable; keeps the type checker honest

    # -- JSON wrappers ---------------------------------------------------

    def _request(self, uri: str, method: str, path: str, body=None,
                 idempotent: bool = False,
                 deadline: Deadline | None = None,
                 extra_headers: dict | None = None):
        raw = self._roundtrip(
            uri, method, path,
            None if body is None else json.dumps(body).encode(),
            "application/json", idempotent=idempotent,
            deadline=deadline, extra_headers=extra_headers)
        return json.loads(raw) if raw else None

    # executor.remoteExec's transport (executor.go:6392)
    def query_node(self, uri: str, index: str, pql: str,
                   shards: list[int] | None,
                   idempotent: bool = False,
                   deadline: Deadline | None = None,
                   trace_id: str | None = None,
                   span_parent: str | None = None,
                   _redirected: bool = False) -> dict:
        # idempotent=True only for READ fan-outs: retrying a routed
        # write would be correct for the bits but can flip the
        # changed-count answer (a Set retried reports False)
        #
        # cross-node tracing: the caller's trace id + open
        # span ride as headers; the remote attaches them via its
        # TraceContext machinery and returns its serialized child
        # spans in the response's "trace" trailer, which the
        # coordinator grafts into its own record (per-node Perfetto
        # lanes at /debug/trace)
        headers = None
        if trace_id is not None:
            headers = {"X-Pilosa-Trace-Id": trace_id}
            if span_parent:
                headers["X-Pilosa-Span-Parent"] = span_parent
        try:
            return self._request(uri, "POST", f"/index/{index}/query",
                                 {"query": pql, "shards": shards,
                                  "remote": True},
                                 idempotent=idempotent,
                                 deadline=deadline,
                                 extra_headers=headers)
        except RemoteError as e:
            # rebalance redirect (ShardMovedError on the peer): safe
            # ONLY when the new owner covers the WHOLE request —
            # re-issuing a multi-shard leg whose shards split across
            # owners would silently serve empty fragments for the
            # shards the target doesn't hold; those raise up to the
            # coordinator's re-plan instead.  One hop, ever.
            if (not _redirected and e.status == 410 and e.new_owner
                    and e.new_owner != uri and shards is not None
                    and e.moved_shards is not None
                    and set(shards) <= set(e.moved_shards)):
                return self.query_node(
                    e.new_owner, index, pql, shards,
                    idempotent=idempotent, deadline=deadline,
                    trace_id=trace_id, span_parent=span_parent,
                    _redirected=True)
            raise

    def _import_redirected(self, uri: str, index: str, field: str,
                           body: dict) -> int:
        """POST one shard-group import, following a single rebalance
        redirect hop.  Imports are idempotent (set-bits OR in,
        BSI/mutex are last-write-wins) and the 410 means the donor
        applied NOTHING, so re-issuing at the new owner is safe."""
        path = f"/index/{index}/field/{field}/import"
        try:
            r = self._request(uri, "POST", path, body)
        except RemoteError as e:
            if e.status == 410 and e.new_owner and e.new_owner != uri:
                r = self._request(e.new_owner, "POST", path, body)
            else:
                raise
        return r["imported"]

    def import_bits(self, uri: str, index: str, field: str, rows, cols,
                    timestamps=None, clear=False) -> int:
        body = {"rows": list(map(int, rows)),
                "columns": list(map(int, cols)), "clear": clear}
        if timestamps is not None:
            body["timestamps"] = timestamps
        return self._import_redirected(uri, index, field, body)

    def import_values(self, uri: str, index: str, field: str, cols,
                      values, clear=False) -> int:
        return self._import_redirected(
            uri, index, field,
            {"columns": list(map(int, cols)),
             "values": list(values), "clear": clear})

    def create_keys(self, uri: str, index: str, field: str | None,
                    keys: list[str],
                    deadline: Deadline | None = None) -> list[int]:
        q = f"?field={field}" if field else ""
        return self._request(
            uri, "POST", f"/internal/translate/{index}/keys/create{q}",
            {"keys": keys}, deadline=deadline)

    def status(self, uri: str) -> dict:
        return self._request(uri, "GET", "/status", idempotent=True)

    # -- raw binary transfers (backup/restore file streaming) ----------

    def get_json(self, uri: str, path: str,
                 deadline: Deadline | None = None):
        """GET a JSON internal resource (sync/repair endpoints)."""
        return json.loads(self.get_raw(uri, path, deadline=deadline))

    def get_raw(self, uri: str, path: str,
                deadline: Deadline | None = None) -> bytes:
        return self._roundtrip(uri, "GET", path, None, None,
                               idempotent=True, deadline=deadline)

    def post_raw(self, uri: str, path: str, data: bytes) -> bytes:
        return self._roundtrip(uri, "POST", path, data,
                               "application/octet-stream")
