"""Jump consistent hashing (disco/hasher.go:16 ``Jmphasher``).

The standard Lamport/Veach jump-hash: maps a 64-bit key to one of n
buckets with minimal movement when n changes.  Used for both
partition→node and (via partition) shard→node placement.
"""

from __future__ import annotations

_MASK = (1 << 64) - 1


def jump_hash(key: int, n: int) -> int:
    """Jump consistent hash of ``key`` onto ``n`` buckets."""
    if n <= 0:
        raise ValueError("n must be positive")
    k = key & _MASK
    b, j = -1, 0
    while j < n:
        b = j
        k = (k * 2862933555777941757 + 1) & _MASK
        j = int((b + 1) * (float(1 << 31) / float((k >> 33) + 1)))
    return b


def placement_diff(keys, n_old: int, n_new: int) -> dict[int, tuple[int, int]]:
    """Keys whose jump bucket changes between ``n_old`` and ``n_new``
    buckets: ``{key: (old_bucket, new_bucket)}``.

    This is the rebalance cost model: growing n -> n+1
    moves an expected 1/(n+1) of the keys — and every moved key lands
    in the NEW bucket n (jump hash never shuffles keys between
    surviving buckets) — so a node join transfers only the new node's
    share, and n -> n says nothing moves.  The invariant is pinned by
    a property test (tests/test_rebalance.py)."""
    if n_old <= 0 or n_new <= 0:
        raise ValueError("bucket counts must be positive")
    out: dict[int, tuple[int, int]] = {}
    if n_old == n_new:
        return out
    for k in keys:
        b_old = jump_hash(k, n_old)
        b_new = jump_hash(k, n_new)
        if b_old != b_new:
            out[int(k)] = (b_old, b_new)
    return out


def roster_diff(keys, roster_old: list[str],
                roster_new: list[str]) -> dict[int, tuple[str, str]]:
    """placement_diff at NODE-ID level: keys whose owning node id
    changes between two placement rosters (ordered bucket -> node-id
    lists), as ``{key: (old_node, new_node)}``.  A join APPENDS to the
    roster, so this reduces to placement_diff's minimal movement; a
    drain removes one entry in place — removing the LAST entry is
    minimal, removing a middle entry additionally remaps the keys of
    every suffix bucket (the roster is positional).  The rebalance
    controller migrates whatever this names, so either shape stays
    correct — just not equally cheap."""
    if not roster_old or not roster_new:
        raise ValueError("rosters must be non-empty")
    out: dict[int, tuple[str, str]] = {}
    for k in keys:
        old = roster_old[jump_hash(k, len(roster_old))]
        new = roster_new[jump_hash(k, len(roster_new))]
        if old != new:
            out[int(k)] = (old, new)
    return out
