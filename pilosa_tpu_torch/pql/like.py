"""LIKE-pattern matching.

Two matchers, as in the reference:

- ``like_regex`` — the key-filter matcher of PQL ``Rows(like=)``
  (like.go:13 planLike/matchLike semantics): case-sensitive, ``%``
  matches any run, ``_`` exactly one character.
- ``sql_like_regex`` — the SQL scalar operator (sql3/planner/
  expression.go:2991 wildCardToRegexp): case-insensitive, ``%`` is
  ``.*`` and ``_`` is ``.+`` (one or more characters).  Regex
  metacharacters of the pattern are escaped (the reference splices
  them in unescaped).

``like_match`` and ``sql_like_match`` test one value against a
pattern (SQL's LIKE operator calls the latter).
"""

from __future__ import annotations

import re


def like_regex(pattern: str) -> re.Pattern:
    return re.compile(
        "^" + "".join(
            ".*" if ch == "%" else "." if ch == "_" else re.escape(ch)
            for ch in pattern) + "$",
        re.DOTALL)


def sql_like_regex(pattern: str) -> re.Pattern:
    return re.compile(
        "^" + "".join(
            ".*" if ch == "%" else ".+" if ch == "_"
            else re.escape(ch) for ch in pattern) + "$",
        re.DOTALL | re.IGNORECASE)


def like_match(value: str, pattern: str) -> bool:
    return like_regex(pattern).match(value) is not None


def sql_like_match(value: str, pattern: str) -> bool:
    return sql_like_regex(pattern).match(value) is not None
