"""The general traffic generator: a mix file (``traffic/<name>.json``)
drawn into query specs, and the specs rendered as PQL or SQL.

A mix names its clients and its forms.  A form has a ``weight``, a
``front`` (``pql`` through ``API.query``, ``sql`` through ``API.sql``),
an ``op`` (``count``, ``sum``, ``topn``, ``groupby``) and its operands:

- ``group``: a list of fields, or ``{"choose": k, "of": [...]}``;
- ``field`` (the Sum's, TopN's or the aggregate's), ``n`` (TopN),
  ``aggregate`` (``count`` or ``sum``), ``order`` (SQL: a list of
  ``[column, "asc" | "desc"]``, the column a field or ``count``);
- ``where``: conditions, all of which hold (an intersection).  A
  condition's ``field`` is a name or ``{"of": [...]}``; ``eq`` is
  ``"any"`` (any row of the field) or ``[a, b]``; ``between`` is
  ``[a, b]``, from which lo < hi are drawn in whole ``unit``s; ``p`` is
  the chance that the condition is there at all.

A spec is a plain dict: the form's name, op and operands with every
choice made.  A run's requests are one stream drawn from its seed, which
the clients take in turn, each its next when its last is answered.  The
stream is dealt in decks: a deck holds every shape of the mix (a form,
its group choice, each condition's presence and field) as many times as
the weights and chances give it, in an order and with parameters drawn
from the seed.  So every seed sends the same work, in another order.
"""

from __future__ import annotations

import itertools
import json
import math
import random
from fractions import Fraction
from pathlib import Path

from gpubench import data

HERE = Path(__file__).resolve().parent


def load(name: str) -> dict:
    mix = json.loads((HERE / "traffic" / f"{name}.json").read_text())
    mix["name"] = name
    return mix


def _field_rows(cfg: dict, name: str) -> int:
    return int(next(f for f in cfg["fields"] if f["name"] == name)["rows"])


def _draw_cond(c: dict, cfg: dict, rng: random.Random, field=None):
    f = field if field is not None else (
        rng.choice(c["field"]["of"]) if isinstance(c["field"], dict)
        else c["field"])
    if "between" in c:
        unit = int(c.get("unit", 1))
        a, b = c["between"]
        lo, hi = sorted(rng.sample(range(int(a), int(b) + 1), 2))
        return {"field": f, "between": [lo * unit, hi * unit]}
    if c["eq"] == "any":
        return {"field": f, "eq": rng.randrange(_field_rows(cfg, f))}
    return {"field": f, "eq": rng.randint(int(c["eq"][0]), int(c["eq"][1]))}


def _spec(form: dict, cfg: dict, rng: random.Random, group=None,
          present=None, fields=None) -> dict:
    spec = {k: form[k] for k in ("name", "front", "op", "field", "n",
                                 "aggregate", "order") if k in form}
    g = form.get("group")
    if g is not None:
        if group is not None:
            spec["group"] = list(group)
        elif isinstance(g, dict):
            picks = set(rng.sample(g["of"], int(g["choose"])))
            spec["group"] = [x for x in g["of"] if x in picks]
        else:
            spec["group"] = list(g)
    where = []
    for i, c in enumerate(form.get("where", [])):
        on = (rng.random() < float(c.get("p", 1.0)) if present is None
              else present[i])
        if on:
            where.append(_draw_cond(c, cfg, rng,
                                    None if fields is None else fields[i]))
    spec["where"] = where
    return spec


class Mix:
    """A mix's forms over a configuration."""

    def __init__(self, mix: dict, cfg: dict):
        self.mix = mix
        self.cfg = cfg
        self.forms = mix["forms"]
        self.weights = [float(f["weight"]) for f in self.forms]
        self.clients = int(mix["clients"])

    def fields(self) -> set[str]:
        """Every field a form of the mix reads."""
        out = set()
        for form in self.forms:
            g = form.get("group", [])
            out.update(g["of"] if isinstance(g, dict) else g)
            if "field" in form:
                out.add(form["field"])
            for c in form.get("where", []):
                f = c["field"]
                out.update(f["of"] if isinstance(f, dict) else [f])
        return out

    def _shape_keys(self):
        """Every shape of the mix as (form, group, presence, fields) with
        its chance: the form's share of the weights, over its group
        choices and each condition's field choices, times each
        condition's chance of being there or not."""
        total = sum(Fraction(str(w)) for w in self.weights)
        for form, w in zip(self.forms, self.weights):
            g = form.get("group")
            groups = ([None] if not isinstance(g, dict) else
                      [[x for x in g["of"] if x in combo] for combo in
                       itertools.combinations(g["of"], int(g["choose"]))])
            conds = form.get("where", [])
            ps = [Fraction(str(c.get("p", 1.0))) for c in conds]
            presence = list(itertools.product(*[
                (True, False) if p < 1 else (True,) for p in ps]))
            fields = list(itertools.product(*[
                c["field"]["of"] if isinstance(c["field"], dict)
                else [c["field"]] for c in conds]))
            base = Fraction(str(w)) / total / len(groups) / len(fields)
            for grp, pres in itertools.product(groups, presence):
                chance = base
                for p, on in zip(ps, pres):
                    chance *= p if on else 1 - p
                for fl in fields:
                    yield form, grp, pres, fl, chance

    def deck(self) -> list[tuple]:
        """One deck: each shape (form, group, presence, fields) as many
        times as its chance gives in the smallest deck that holds every
        chance whole."""
        keys = [k for k in self._shape_keys() if k[4] > 0]
        size = math.lcm(*(k[4].denominator for k in keys))
        return [k[:4] for k in keys for _ in range(int(k[4] * size))]

    def stream(self, seed: int):
        """The specs a run sends, in order, for ever: deck after deck,
        each shuffled, with parameters drawn from the seed."""
        rng = random.Random(data.seed_for(seed, self.mix["name"], "stream"))
        deck = self.deck()
        while True:
            rng.shuffle(deck)
            for form, grp, pres, fl in deck:
                yield _spec(form, self.cfg, rng, grp, pres, fl)

    def shapes(self, seed: int) -> list[dict]:
        """One spec of every shape the mix sends, with parameters drawn
        from a stream of their own: the set-up's warm-up set."""
        rng = random.Random(data.seed_for(seed, self.mix["name"], "warm"))
        return [_spec(form, self.cfg, rng, grp, pres, fl)
                for form, grp, pres, fl, _ in self._shape_keys()]


# -- rendering ------------------------------------------------------------

def _pql_cond(c: dict) -> str:
    if "between" in c:
        lo, hi = c["between"]
        return f"Row({lo} <= {c['field']} <= {hi})"
    return f"Row({c['field']}={c['eq']})"


def _pql_filter(where: list) -> str | None:
    if not where:
        return None
    rows = [_pql_cond(c) for c in where]
    return rows[0] if len(rows) == 1 else f"Intersect({', '.join(rows)})"


def pql(spec: dict) -> str:
    filt = _pql_filter(spec["where"])
    op = spec["op"]
    if op == "count":
        return f"Count({filt or 'All()'})"
    if op == "sum":
        return (f"Sum({filt}, field={spec['field']})" if filt
                else f"Sum(field={spec['field']})")
    if op == "topn":
        mid = f", {filt}" if filt else ""
        return f"TopN({spec['field']}{mid}, n={spec['n']})"
    if op == "groupby":
        args = [f"Rows({g})" for g in spec["group"]]
        if filt:
            args.append(f"filter={filt}")
        if spec.get("aggregate") == "sum":
            args.append(f"aggregate=Sum(field={spec['field']})")
        return f"GroupBy({', '.join(args)})"
    raise ValueError(f"unknown op {op!r}")


def _sql_where(where: list) -> str:
    conds = [f"{c['field']} BETWEEN {c['between'][0]} AND {c['between'][1]}"
             if "between" in c else f"{c['field']} = {c['eq']}"
             for c in where]
    return f" WHERE {' AND '.join(conds)}" if conds else ""


def sql(spec: dict, table: str) -> str:
    where = _sql_where(spec["where"])
    op = spec["op"]
    if op == "count":
        return f"SELECT COUNT(*) FROM {table}{where}"
    if op == "sum":
        return f"SELECT SUM({spec['field']}), COUNT(*) FROM {table}{where}"
    if op == "groupby":
        cols = list(spec["group"])
        if spec.get("aggregate") == "sum":
            cols.append(f"SUM({spec['field']})")
        cols.append("COUNT(*)")
        text = (f"SELECT {', '.join(cols)} FROM {table}{where} "
                f"GROUP BY {', '.join(spec['group'])}")
        if spec.get("order"):
            keys = [("COUNT(*)" if k == "count" else k)
                    + (" DESC" if d == "desc" else "")
                    for k, d in spec["order"]]
            text += f" ORDER BY {', '.join(keys)}"
        return text
    raise ValueError(f"op {op!r} has no SQL form here")


def render(spec: dict, table: str) -> str:
    return sql(spec, table) if spec["front"] == "sql" else pql(spec)
