"""Minimal JMESPath-subset evaluator for metadata filters — a copy of
pathway_tpu/internals/jmespath_lite.py (pure Python, no JAX).

The reference filters index hits with JMESPath over metadata JSON
(src/external_integration/mod.rs:364 DerivedFilteredSearchIndex; xpack docs
use e.g. ``contains(path, 'foo')``, ``globmatch('**/*.pdf', path)``,
``modified_at >= `1700000000```). This evaluator covers that working subset:
dot paths, (back)quoted/number/string literals, ==/!=/<=/>=/</>,
&&/||/!, parentheses, and the functions contains() / globmatch().
"""

from __future__ import annotations

import re
from typing import Any

_TOKEN_RE = re.compile(r"""
    (?P<ws>\s+)
  | (?P<lit_backtick>`[^`]*`)
  | (?P<string>'[^']*'|"[^"]*")
  | (?P<number>-?\d+(\.\d+)?)
  | (?P<op>==|!=|<=|>=|&&|\|\||[<>()!,])
  | (?P<ident>[A-Za-z_][A-Za-z0-9_\.\-]*)
""", re.VERBOSE)


def _tokenize(expr: str):
    out = []
    pos = 0
    while pos < len(expr):
        m = _TOKEN_RE.match(expr, pos)
        if m is None:
            raise ValueError(f"bad filter syntax at {expr[pos:]!r}")
        pos = m.end()
        kind = m.lastgroup
        if kind == "ws":
            continue
        out.append((kind, m.group()))
    out.append(("eof", ""))
    return out


class _Parser:
    def __init__(self, tokens):
        self.tokens = tokens
        self.i = 0

    def peek(self):
        return self.tokens[self.i]

    def next(self):
        tok = self.tokens[self.i]
        self.i += 1
        return tok

    def expect(self, value):
        kind, tok = self.next()
        if tok != value:
            raise ValueError(f"expected {value!r}, got {tok!r}")

    # expr := or_expr
    def parse(self):
        node = self.parse_or()
        if self.peek()[0] != "eof":
            raise ValueError(f"trailing tokens: {self.peek()!r}")
        return node

    def parse_or(self):
        node = self.parse_and()
        while self.peek()[1] == "||":
            self.next()
            node = ("or", node, self.parse_and())
        return node

    def parse_and(self):
        node = self.parse_not()
        while self.peek()[1] == "&&":
            self.next()
            node = ("and", node, self.parse_not())
        return node

    def parse_not(self):
        if self.peek()[1] == "!":
            self.next()
            return ("not", self.parse_not())
        return self.parse_cmp()

    def parse_cmp(self):
        left = self.parse_atom()
        if self.peek()[1] in ("==", "!=", "<=", ">=", "<", ">"):
            op = self.next()[1]
            right = self.parse_atom()
            return ("cmp", op, left, right)
        return left

    def parse_atom(self):
        kind, tok = self.next()
        if tok == "(":
            node = self.parse_or()
            self.expect(")")
            return node
        if kind == "string":
            return ("lit", tok[1:-1])
        if kind == "lit_backtick":
            inner = tok[1:-1]
            try:
                return ("lit", int(inner))
            except ValueError:
                try:
                    return ("lit", float(inner))
                except ValueError:
                    return ("lit", inner.strip('"'))
        if kind == "number":
            return ("lit", float(tok) if "." in tok else int(tok))
        if kind == "ident":
            if self.peek()[1] == "(":
                self.next()
                args = []
                if self.peek()[1] != ")":
                    args.append(self.parse_or())
                    while self.peek()[1] == ",":
                        self.next()
                        args.append(self.parse_or())
                self.expect(")")
                return ("call", tok, args)
            return ("path", tok)
        raise ValueError(f"unexpected token {tok!r}")


def _lookup(data: Any, path: str) -> Any:
    from pathway_tpu_torch.internals.json import Json

    if isinstance(data, Json):
        data = data.value
    cur = data
    for part in path.split("."):
        if cur is None:
            return None
        if isinstance(cur, Json):
            cur = cur.value
        if isinstance(cur, dict):
            cur = cur.get(part)
        else:
            cur = getattr(cur, part, None)
    if isinstance(cur, Json):
        cur = cur.value
    return cur


def _eval(node, data) -> Any:
    kind = node[0]
    if kind == "lit":
        return node[1]
    if kind == "path":
        return _lookup(data, node[1])
    if kind == "and":
        return bool(_eval(node[1], data)) and bool(_eval(node[2], data))
    if kind == "or":
        return bool(_eval(node[1], data)) or bool(_eval(node[2], data))
    if kind == "not":
        return not bool(_eval(node[1], data))
    if kind == "cmp":
        _, op, l, r = node
        lv, rv = _eval(l, data), _eval(r, data)
        try:
            if op == "==":
                return lv == rv
            if op == "!=":
                return lv != rv
            if lv is None or rv is None:
                return False
            if op == "<":
                return lv < rv
            if op == "<=":
                return lv <= rv
            if op == ">":
                return lv > rv
            if op == ">=":
                return lv >= rv
        except TypeError:
            return False
    if kind == "call":
        _, name, args = node
        vals = [_eval(a, data) for a in args]
        if name == "contains":
            hay, needle = vals
            if hay is None:
                return False
            return needle in hay
        if name == "globmatch":
            pattern, path = vals
            if path is None:
                return False
            return _globmatch(str(pattern), str(path))
        if name == "starts_with":
            s, prefix = vals
            return s is not None and str(s).startswith(str(prefix))
        if name == "ends_with":
            s, suffix = vals
            return s is not None and str(s).endswith(str(suffix))
        if name == "length":
            return len(vals[0]) if vals[0] is not None else 0
        raise ValueError(f"unknown filter function {name!r}")
    raise ValueError(f"bad node {node!r}")


def _globmatch(pattern: str, path: str) -> bool:
    # '**' crosses directory separators, '*' does not
    regex = []
    i = 0
    while i < len(pattern):
        c = pattern[i]
        if c == "*":
            if pattern[i:i + 2] == "**":
                regex.append(".*")
                i += 2
                if i < len(pattern) and pattern[i] == "/":
                    i += 1
                continue
            regex.append("[^/]*")
        elif c == "?":
            regex.append("[^/]")
        else:
            regex.append(re.escape(c))
        i += 1
    return re.fullmatch("".join(regex), path) is not None


_cache: dict[str, Any] = {}


def compile_filter(expr: str):
    node = _cache.get(expr)
    if node is None:
        node = _Parser(_tokenize(expr)).parse()
        _cache[expr] = node
    return node


def evaluate_filter(expr: str, data: Any) -> bool:
    if not expr:
        return True
    try:
        return bool(_eval(compile_filter(expr), data))
    except Exception:
        return False
