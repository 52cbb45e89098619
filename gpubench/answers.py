"""The port's replies in the reference's canonical form, and the
comparison that decides ``correct``.

Canonical answers (reference.Cube.answer): a count is an int; a Sum is
(sum, count); a TopN is [(row, count)] by count, highest first; a
GroupBy is [(group rows, count, sum or None)].  Every comparison is
exact: integers, no tolerance.
"""

from __future__ import annotations


def from_pql(spec: dict, reply: dict):
    r = reply["results"][0]
    op = spec["op"]
    if op == "count":
        return int(r)
    if op == "sum":
        return (int(r["value"]), int(r["count"]))
    if op == "topn":
        return [(int(p["id"]), int(p["count"])) for p in r]
    if op == "groupby":
        out = []
        for g in r:
            by = {x["field"]: int(x["row_id"]) for x in g["group"]}
            agg = g.get("agg")
            out.append((tuple(by[f] for f in spec["group"]), int(g["count"]),
                        None if agg is None else int(agg)))
        return out
    raise ValueError(f"unknown op {op!r}")


def from_sql(spec: dict, reply: dict):
    names = [f["name"].lower() for f in reply["schema"]["fields"]]
    rows = reply["data"]
    op = spec["op"]
    if op == "count":
        return int(rows[0][0])
    if op == "sum":
        return (int(rows[0][0] or 0), int(rows[0][1]))
    if op == "groupby":
        gi = [names.index(g.lower()) for g in spec["group"]]
        ci = names.index("count(*)")
        si = (names.index(f"sum({spec['field']})".lower())
              if spec.get("aggregate") == "sum" else None)
        return [(tuple(int(row[i]) for i in gi), int(row[ci]),
                 None if si is None else int(row[si])) for row in rows]
    raise ValueError(f"op {op!r} has no SQL form here")


def canonical(spec: dict, reply: dict):
    return from_sql(spec, reply) if spec["front"] == "sql" else \
        from_pql(spec, reply)


def _sorted_by(spec: dict, got: list) -> bool:
    """Whether a GroupBy's rows come in its SQL ORDER BY (ties in any
    order)."""
    def key(row):
        k = []
        for col, d in spec["order"]:
            v = row[1] if col == "count" else row[0][spec["group"].index(col)]
            k.append(-v if d == "desc" else v)
        return k
    keys = [key(r) for r in got]
    return all(a <= b for a, b in zip(keys, keys[1:]))


def same(spec: dict, got, want) -> bool:
    """Whether the port's canonical answer equals the reference's."""
    op = spec["op"]
    if op in ("count", "sum"):
        return got == want
    if op == "topn":
        # ``want`` holds every row with a column: the reply has the n
        # (or all) highest, each with the reference's count, highest
        # first (rows tied at the cut may be either)
        ref = dict(want)
        counts = [c for _, c in got]
        full = sorted(ref.values(), reverse=True)
        return (len(got) == min(int(spec["n"]), len(want))
                and all(ref.get(r) == c for r, c in got)
                and counts == sorted(counts, reverse=True)
                and counts == full[:len(counts)]
                and len({r for r, _ in got}) == len(got))
    if op == "groupby":
        if spec.get("order") and not _sorted_by(spec, got):
            return False
        return sorted(got) == sorted(want) and len(got) == len(set(
            g for g, _, _ in got))
    raise ValueError(f"unknown op {op!r}")


def holds(spec: dict, reply: dict, want) -> bool:
    """Whether a reply is the reference's answer; a reply not of the
    query's form is not."""
    try:
        got = canonical(spec, reply)
    except (KeyError, TypeError, ValueError, IndexError):
        return False
    return same(spec, got, want)
