"""Authentication — JWT validation + group cache (authn/).

Behavioral parity with authn/authenticate.go: the server validates a
bearer JWT on every request (authenticate.go:93 Authenticate), reads
the user's security groups from the token claims, and caches
group lookups; the OAuth2/OIDC login dance (authenticate.go:77 Login)
is represented by the redirect-URL builder, since this build has no
egress to an IdP.

Tokens are HMAC-SHA256 (HS256) JWTs — signed with the cluster's
shared secret (the reference additionally supports RS256 via IdP
JWKS; the claim set and validation rules here are the same:
exp/nbf checks, required groups claim for authz).
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import json
import time
import urllib.parse


class AuthError(Exception):
    pass


def _b64url(data: bytes) -> str:
    return base64.urlsafe_b64encode(data).rstrip(b"=").decode()


def _unb64url(s: str) -> bytes:
    pad = "=" * (-len(s) % 4)
    return base64.urlsafe_b64decode(s + pad)


def encode_jwt(claims: dict, secret: bytes) -> str:
    """Mint an HS256 JWT (test/ops tooling; fake-IdP analog of
    qa/fakeidp)."""
    header = {"alg": "HS256", "typ": "JWT"}
    h = _b64url(json.dumps(header, separators=(",", ":")).encode())
    c = _b64url(json.dumps(claims, separators=(",", ":")).encode())
    sig = hmac.new(secret, f"{h}.{c}".encode(), hashlib.sha256).digest()
    return f"{h}.{c}.{_b64url(sig)}"


def decode_jwt(token: str, secret: bytes) -> dict:
    """Validate signature + time claims; returns the claim dict."""
    try:
        h, c, s = token.split(".")
    except ValueError:
        raise AuthError("malformed token")
    try:
        header = json.loads(_unb64url(h))
    except Exception:
        raise AuthError("malformed token header")
    if header.get("alg") != "HS256":
        raise AuthError(f"unsupported alg {header.get('alg')!r}")
    want = hmac.new(secret, f"{h}.{c}".encode(), hashlib.sha256).digest()
    try:
        got_sig = _unb64url(s)
    except Exception:
        raise AuthError("malformed token signature")
    if not hmac.compare_digest(want, got_sig):
        raise AuthError("bad signature")
    try:
        claims = json.loads(_unb64url(c))
    except Exception:
        raise AuthError("malformed token claims")
    if not isinstance(claims, dict):
        raise AuthError("malformed token claims")
    _check_time_claims(claims)
    return claims


def _claim_num(claims: dict, name: str) -> float | None:
    v = claims.get(name)
    if v is None:
        return None
    try:
        return float(v)
    except (TypeError, ValueError):
        raise AuthError(f"malformed {name} claim")


def _check_time_claims(claims: dict) -> None:
    now = time.time()
    exp = _claim_num(claims, "exp")
    if exp is not None and now >= exp:
        raise AuthError("token expired")
    nbf = _claim_num(claims, "nbf")
    if nbf is not None and now < nbf:
        raise AuthError("token not yet valid")


class Authenticator:
    """authn.Auth (authenticate.go:44): validates bearer tokens and
    caches the per-token group set with a TTL (the reference's
    group-membership cache, authenticate.go:174)."""

    def __init__(self, secret: bytes, cache_ttl: float = 60.0,
                 client_id: str = "", authorize_url: str = "",
                 scopes: tuple = ("openid", "groups")):
        if isinstance(secret, str):
            secret = secret.encode()
        self.secret = secret
        self.cache_ttl = cache_ttl
        self.client_id = client_id
        self.authorize_url = authorize_url
        self.scopes = scopes
        self._cache: dict[str, tuple[float, dict]] = {}

    def authenticate(self, auth_header: str) -> dict:
        """Validate 'Bearer <jwt>' (or a bare token) -> claims."""
        if not auth_header:
            raise AuthError("missing authorization")
        token = auth_header
        if token.lower().startswith("bearer "):
            token = token[7:].strip()
        hit = self._cache.get(token)
        now = time.time()
        if hit and now - hit[0] < self.cache_ttl:
            claims = hit[1]
            _check_time_claims(claims)
            return claims
        claims = decode_jwt(token, self.secret)
        self._cache[token] = (now, claims)
        if len(self._cache) > 10000:  # bound the cache
            cutoff = now - self.cache_ttl
            self._cache = {t: v for t, v in self._cache.items()
                           if v[0] >= cutoff}
        return claims

    def login_url(self, state: str = "") -> str:
        """The OAuth2 authorize redirect the /login handler issues
        (authenticate.go:77)."""
        q = urllib.parse.urlencode({
            "response_type": "code",
            "client_id": self.client_id,
            "scope": " ".join(self.scopes),
            "state": state,
        })
        return f"{self.authorize_url}?{q}"
