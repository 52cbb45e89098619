"""SQL lexer (shape of sql3/parser/scanner.go, subset)."""

from __future__ import annotations

import re
from dataclasses import dataclass


class SQLError(Exception):
    pass


KEYWORDS = {
    "select", "from", "where", "group", "by", "having", "order", "limit",
    "offset", "distinct", "as", "and", "or", "not", "in", "like", "between",
    "is", "null", "true", "false", "asc", "desc", "count", "sum", "min",
    "max", "avg", "create", "table", "drop", "insert", "into", "values",
    "delete", "show", "tables", "columns", "databases", "if", "exists",
    "with", "replace", "bulk", "update", "set", "alter", "add", "column",
    "inner", "join", "on", "top", "percentile", "var", "corr",
    "explain",
}

_TOKEN_RE = re.compile(r"""
    (?P<ws>\s+|--[^\n]*)
  | (?P<number>\d+\.\d*|\.\d+|\d+)
  | (?P<var>@(?:\d+|[A-Za-z_][A-Za-z0-9_]*))
  | (?P<ident>[A-Za-z_][A-Za-z0-9_-]*)
  | (?P<qident>"[^"]*")
  | (?P<string>'(?:''|[^'])*')
  | (?P<op><>|!=|<=|>=|<<|>>|\|\||\||&|=|<|>|\(|\)|\[|\]|\{|\}|,|\*|\.|;|\+|-|/|%|!)
""", re.VERBOSE)


@dataclass
class Token:
    kind: str   # number | ident | keyword | string | op | eof
    value: str
    pos: int


def tokenize(text: str) -> list[Token]:
    toks: list[Token] = []
    pos = 0
    while pos < len(text):
        m = _TOKEN_RE.match(text, pos)
        if m is None:
            raise SQLError(f"unexpected character {text[pos]!r} at {pos}")
        kind = m.lastgroup
        val = m.group()
        if kind != "ws":
            if kind == "ident" and val.lower() in KEYWORDS:
                toks.append(Token("keyword", val.lower(), pos))
            elif kind == "var":
                toks.append(Token("var", val[1:], pos))
            elif kind == "qident":
                toks.append(Token("ident", val[1:-1], pos))
            elif kind == "string":
                toks.append(Token("string", val[1:-1].replace("''", "'"), pos))
            else:
                toks.append(Token(kind, val, pos))
        pos = m.end()
    toks.append(Token("eof", "", len(text)))
    return toks
