"""`.str` expression namespace — port of
pathway_tpu/internals/expressions/string.py."""

from __future__ import annotations

from pathway_tpu_torch.internals.expression import ColumnNamespace, MethodCallExpression


class StringNamespace(ColumnNamespace):
    def __init__(self, expr):
        self._expr = expr

    def _m(self, name, *args, **kwargs):
        return MethodCallExpression(f"str.{name}", self._expr, *args, **kwargs)

    def lower(self):
        return self._m("lower")

    def upper(self):
        return self._m("upper")

    def reversed(self):
        return self._m("reversed")

    def len(self):
        return self._m("len")

    def strip(self, chars=None):
        return self._m("strip", chars)

    def lstrip(self, chars=None):
        return self._m("lstrip", chars)

    def rstrip(self, chars=None):
        return self._m("rstrip", chars)

    def startswith(self, prefix):
        return self._m("startswith", prefix)

    def endswith(self, suffix):
        return self._m("endswith", suffix)

    def swap_case(self):
        return self._m("swapcase")

    def title(self):
        return self._m("title")

    def capitalize(self):
        return self._m("capitalize")

    def casefold(self):
        return self._m("casefold")

    def count(self, sub, start=None, end=None):
        return self._m("count", sub, start, end)

    def find(self, sub, start=None, end=None):
        return self._m("find", sub, start, end)

    def rfind(self, sub, start=None, end=None):
        return self._m("rfind", sub, start, end)

    def removeprefix(self, prefix):
        return self._m("removeprefix", prefix)

    def removesuffix(self, suffix):
        return self._m("removesuffix", suffix)

    def replace(self, old, new, count=-1):
        return self._m("replace", old, new, count)

    def split(self, sep=None, maxsplit=-1):
        return self._m("split", sep, maxsplit=maxsplit)

    def rsplit(self, sep=None, maxsplit=-1):
        return self._m("rsplit", sep, maxsplit=maxsplit)

    def slice(self, start, end):
        return self._m("slice", start, end)

    def parse_int(self, optional: bool = False):
        return self._m("parse_int", optional=optional)

    def parse_float(self, optional: bool = False):
        return self._m("parse_float", optional=optional)

    def parse_bool(self, true_values=("on", "true", "yes", "1"),
                   false_values=("off", "false", "no", "0"),
                   optional: bool = False):
        return self._m("parse_bool", true_values=tuple(true_values),
                       false_values=tuple(false_values), optional=optional)
