"""Event query language (reference internal/pubsub/query/query.go:26,
internal/pubsub/query/syntax/).

Grammar (the reference's syntax, recursive-descent parsed):

  query      = condition { "AND" condition }
  condition  = tag op operand
  op         = "=" | "<" | "<=" | ">" | ">=" | "CONTAINS" | "EXISTS"
  operand    = quoted string | number | time/date literal (kept as string)

Examples: tm.event = 'NewBlock' AND tx.height > 5
Values compare numerically when both sides parse as numbers, else as
strings — matching the reference's behavior for number/string operands.

Copy of `cometbft_tpu/pubsub/query.py` in the port.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Dict, List, Sequence, Union


class QueryError(Exception):
    pass


_TOKEN = re.compile(r"""
    \s*(?:
      (?P<and>AND\b)
    | (?P<op><=|>=|=|<|>|CONTAINS\b|EXISTS\b)
    | (?P<str>'(?:[^'\\]|\\.)*')
    | (?P<num>-?\d+(?:\.\d+)?)
    | (?P<tag>[A-Za-z_][A-Za-z0-9_.\-]*)
    )""", re.VERBOSE)


@dataclass(frozen=True)
class Condition:
    tag: str
    op: str
    operand: Union[str, float, None]


def _tokenize(s: str) -> List:
    out, pos = [], 0
    while pos < len(s):
        m = _TOKEN.match(s, pos)
        if m is None or m.end() == pos:
            if s[pos:].strip() == "":
                break
            raise QueryError(f"bad token at {s[pos:pos + 20]!r}")
        pos = m.end()
        kind = m.lastgroup
        text = m.group(kind)
        out.append((kind, text))
    return out


class Query:
    """reference query.go Query (compiled form)."""

    def __init__(self, s: str):
        self.raw = s.strip()
        if not self.raw:
            raise QueryError("empty query")
        self.conditions = self._parse(_tokenize(self.raw))

    @staticmethod
    def _parse(tokens: List) -> List[Condition]:
        conds, i = [], 0
        while i < len(tokens):
            if conds:
                if tokens[i][0] != "and":
                    raise QueryError(f"expected AND, got {tokens[i][1]!r}")
                i += 1
            if i >= len(tokens) or tokens[i][0] != "tag":
                raise QueryError("expected tag name")
            tag = tokens[i][1]
            i += 1
            if i >= len(tokens) or tokens[i][0] != "op":
                raise QueryError(f"expected operator after {tag!r}")
            op = tokens[i][1]
            i += 1
            if op == "EXISTS":
                conds.append(Condition(tag, op, None))
                continue
            if i >= len(tokens) or tokens[i][0] not in ("str", "num"):
                raise QueryError(f"expected operand after {tag} {op}")
            kind, text = tokens[i]
            i += 1
            if kind == "num":
                conds.append(Condition(tag, op, float(text)))
            else:
                conds.append(Condition(
                    tag, op, text[1:-1].replace("\\'", "'")))
        return conds

    def matches(self, events: Dict[str, Sequence[str]]) -> bool:
        """events: tag -> list of values (a tag can fire multiple times
        per message; reference pubsub matches ANY value)."""
        return all(self._match_one(c, events) for c in self.conditions)

    @staticmethod
    def _match_one(c: Condition, events: Dict[str, Sequence[str]]) -> bool:
        vals = events.get(c.tag)
        if not vals:
            return False
        if c.op == "EXISTS":
            return True
        for v in vals:
            if Query._cmp(c.op, v, c.operand):
                return True
        return False

    @staticmethod
    def _cmp(op: str, value: str, operand) -> bool:
        if isinstance(operand, float):
            try:
                value_n = float(value)
            except ValueError:
                return False
            if op == "=":
                return value_n == operand
            if op == "<":
                return value_n < operand
            if op == "<=":
                return value_n <= operand
            if op == ">":
                return value_n > operand
            if op == ">=":
                return value_n >= operand
            if op == "CONTAINS":
                return str(operand) in value
            return False
        if op == "=":
            return value == operand
        if op == "CONTAINS":
            return operand in value
        if op in ("<", "<=", ">", ">="):
            # string comparison, reference compares lexically for strings
            return {"<": value < operand, "<=": value <= operand,
                    ">": value > operand, ">=": value >= operand}[op]
        return False

    def __repr__(self) -> str:
        return f"Query({self.raw!r})"

    def __eq__(self, other) -> bool:
        return isinstance(other, Query) and self.raw == other.raw

    def __hash__(self) -> int:
        return hash(self.raw)
