"""Free-function join forms — port of the join part of
pathway_tpu/internals/compat.py (``pw.join``, ``pw.join_inner``, ...)."""

from __future__ import annotations

from pathway_tpu_torch.internals.table import Table


def join(left: Table, right: Table, *on, how: str = "inner", **kwargs):
    return left.join(right, *on, how=how, **kwargs)


def join_inner(left: Table, right: Table, *on, **kwargs):
    return left.join(right, *on, how="inner", **kwargs)


def join_left(left: Table, right: Table, *on, **kwargs):
    return left.join(right, *on, how="left", **kwargs)


def join_right(left: Table, right: Table, *on, **kwargs):
    return left.join(right, *on, how="right", **kwargs)


def join_outer(left: Table, right: Table, *on, **kwargs):
    return left.join(right, *on, how="outer", **kwargs)
