"""`.num` expression namespace — port of
pathway_tpu/internals/expressions/numerical.py."""

from __future__ import annotations

from pathway_tpu_torch.internals.expression import ColumnNamespace, MethodCallExpression


class NumericalNamespace(ColumnNamespace):
    def __init__(self, expr):
        self._expr = expr

    def _m(self, name, *args, **kwargs):
        return MethodCallExpression(f"num.{name}", self._expr, *args, **kwargs)

    def abs(self):
        return self._m("abs")

    def round(self, decimals=0):
        return self._m("round", decimals)

    def fill_na(self, default_value):
        return self._m("fill_na", default_value)
