"""Cost-based SELECT planning over the statistics catalog.

The JAX package's ``sql/costplan.py``: statement canonicalisation and
fingerprints, the catalog's record-count estimates (``obs/stats.py``,
filled by the API's imports) and the join order they choose, and the
read set of a single-table SELECT.  Decisions steered here change
plans, never results.  The serving plane's admission classing
(``stats.est_cost_ms``) waits for the port's serving layer.

The pushdown switch goes through ``configure(enabled=...)`` only (on
by default, as in the JAX package); the port reads no environment
variable for it.  Off, the join order stays as written.
"""

from __future__ import annotations

import hashlib

from pilosa_tpu_torch.sql import ast

_enabled = True


def configure(enabled: bool | None = None) -> None:
    """The [sql] pushdown switch; None leaves it as it is."""
    global _enabled
    if enabled is not None:
        _enabled = bool(enabled)


def enabled() -> bool:
    """True while the planner may steer plans from the catalog (the
    default)."""
    return _enabled


# ---------------------------------------------------------------------------
# statement canonicalization + fingerprints
# ---------------------------------------------------------------------------

def canonical(stmt) -> str:
    """Canonical text of a parsed statement: the AST repr, so
    whitespace/keyword-case variants of the same statement share one
    cache entry and one runtime profile (dataclass reprs are stable
    and address-free)."""
    return repr(stmt)


def fingerprint(index: str, canon: str) -> str:
    """Plan fingerprint of a canonicalized statement — the statistics
    catalog key correlating a statement's runtime profile across
    runs, in the same 8-byte blake2b format serving.py uses for PQL
    plans."""
    return hashlib.blake2b(
        f"sql\x00{index}\x00{canon}".encode(),
        digest_size=8).hexdigest()


# ---------------------------------------------------------------------------
# cardinality estimates (statistics-catalog data plane)
# ---------------------------------------------------------------------------

def est_rows(index: str) -> float | None:
    """Estimated record count of a table from the catalog's ingest
    stats, or None when the catalog holds nothing for it (cold start
    -> the planner keeps the static declaration order)."""
    from pilosa_tpu_torch.obs import stats
    if not stats.enabled():
        return None
    return stats.get().est_index_rows(index)


# ---------------------------------------------------------------------------
# join-order selection
# ---------------------------------------------------------------------------

def order_joins(eng, stmt) -> str | None:
    """Reorder a star-shaped N-way inner join ascending by estimated
    side cardinality, so the smallest hash sides build first and the
    intermediate tuple set stays minimal.  Mutates ``stmt.joins`` in
    place and returns a human-readable decision note ("catalog: u, v")
    when the catalog changed the order, else None (static order kept).

    Only provably-safe shapes reorder: every join must be an INNER ON
    join of a plain table whose condition relates it directly to the
    base (first FROM) table — then any permutation preserves
    semantics, because select_join resolves ON sides by name and an
    unmatched inner tuple dies regardless of when its join runs.
    Outer joins, comma joins, derived-table sides, and chained
    conditions (b.x = c.y) keep the written order."""
    joins = stmt.joins
    if len(joins) < 2 or not enabled():
        return None
    base_keys = {stmt.table}
    if stmt.table_alias:
        base_keys.add(stmt.table_alias)
    for j in joins:
        if j.outer or j.subquery is not None or j.left is None:
            return None
        if not (isinstance(j.left, ast.Col)
                and isinstance(j.right, ast.Col)):
            return None
        sides = {j.left.table, j.right.table}
        if not (sides & base_keys) or len(sides - base_keys) != 1:
            return None
    ests = []
    for j in joins:
        r = est_rows(j.table)
        if r is None:
            return None  # cold catalog: keep the static order
        ests.append(r)
    order = sorted(range(len(joins)), key=lambda i: (ests[i], i))
    if order == list(range(len(joins))):
        return None
    stmt.joins = [joins[i] for i in order]
    return "catalog: " + ", ".join(
        (joins[i].alias or joins[i].table) + f"~{int(ests[i])}"
        for i in order)


# ---------------------------------------------------------------------------
# statement read sets (the SQL result-cache guard)
# ---------------------------------------------------------------------------

def _walk_cols(e, out: set, ok: list, udfs: frozenset) -> None:
    if e is None or isinstance(e, (str, int, float, bool)):
        return
    if isinstance(e, ast.Col):
        out.add(e.name)
        return
    if isinstance(e, (ast.SubQuery, ast.InSelect, ast.Var)):
        # subqueries read OTHER tables; Vars bind per call — both
        # escape the single-index snapshot guard
        ok[0] = False
        return
    if isinstance(e, ast.Agg):
        _walk_cols(e.arg, out, ok, udfs)
        _walk_cols(getattr(e, "extra", None), out, ok, udfs)
        return
    if isinstance(e, ast.Func):
        # a UDF's body lives in the engine's function registry, which
        # no fragment version tracks: DROP + CREATE FUNCTION with a
        # new body would serve a stale cached result — statements
        # referencing the CURRENT registry escape caching (the check
        # re-runs per lookup, so an entry cached while a name was a
        # builtin also stops serving the moment a UDF shadows it)
        if e.name.upper() in udfs:
            ok[0] = False
            return
        for x in e.args:
            _walk_cols(x, out, ok, udfs)
        return
    for attr in ("left", "right", "expr", "col", "arg", "lo", "hi"):
        sub = getattr(e, attr, None)
        if sub is not None:
            _walk_cols(sub, out, ok, udfs)


def stmt_read_fields(eng, idx, stmt) -> frozenset | None:
    """The field read-set of a single-table SELECT for the versioned
    result cache (serving.py field_snapshot guard), or None when the
    statement escapes snapshot tracking (subqueries, variables).
    Conservative the safe way: over-inclusion only widens
    invalidation; the existence field is always included because
    All/Extract/non-null counts read it and every import dirties
    it."""
    from pilosa_tpu_torch.models.index import EXISTENCE_FIELD
    ok = [True]
    cols: set = set()
    udfs = frozenset(eng._functions)
    for it in stmt.items:
        _walk_cols(it.expr, cols, ok, udfs)
    _walk_cols(stmt.where, cols, ok, udfs)
    _walk_cols(stmt.having, cols, ok, udfs)
    for ob in stmt.order_by:
        _walk_cols(ob.expr, cols, ok, udfs)
    if not ok[0]:
        return None
    cols.update(stmt.group_by)
    cols.update(stmt.flatten)
    fields = {c for c in cols
              if c not in ("_id", "*") and idx.field(c) is not None}
    if "*" in cols:
        fields.update(f.name for f in idx.fields.values())
    fields.add(EXISTENCE_FIELD)
    return frozenset(fields)
