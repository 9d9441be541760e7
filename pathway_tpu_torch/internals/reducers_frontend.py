"""`pw.reducers` namespace — port of pathway_tpu/internals/reducers_frontend.py
(reference: python/pathway/reducers → internals/custom_reducers.py + the
engine's Reducer enum, src/engine/reduce.rs:22).

>>> import pathway_tpu_torch as pw
>>> t = pw.debug.table_from_markdown(\'\'\'
... shop | qty
... a    | 3
... a    | 5
... b    | 2
... \'\'\')
>>> pw.debug.compute_and_print(
...     t.groupby(t.shop).reduce(
...         t.shop, n=pw.reducers.count(), total=pw.reducers.sum(t.qty),
...         top=pw.reducers.max(t.qty)),
...     include_id=False)
shop | n | total | top
a | 2 | 8 | 5
b | 1 | 2 | 2
"""

from __future__ import annotations

from typing import Callable

from pathway_tpu_torch.internals import expression as ex


def count(*args) -> ex.ReducerExpression:
    return ex.ReducerExpression("count", *args)


def sum(expr) -> ex.ReducerExpression:  # noqa: A001
    return ex.ReducerExpression("sum", expr)


def avg(expr) -> ex.ReducerExpression:
    return ex.ReducerExpression("avg", expr)


def min(expr) -> ex.ReducerExpression:  # noqa: A001
    return ex.ReducerExpression("min", expr)


def max(expr) -> ex.ReducerExpression:  # noqa: A001
    return ex.ReducerExpression("max", expr)


def argmin(expr, *payload) -> ex.ReducerExpression:
    """One arg: key of the row holding the min. Two args: the second
    expression's value from that row (engine argmin payload form)."""
    return ex.ReducerExpression("argmin", expr, *payload)


def argmax(expr, *payload) -> ex.ReducerExpression:
    """One arg: key of the row holding the max. Two args: the second
    expression's value from that row (engine argmax payload form)."""
    return ex.ReducerExpression("argmax", expr, *payload)


def unique(expr) -> ex.ReducerExpression:
    return ex.ReducerExpression("unique", expr)


def any(expr) -> ex.ReducerExpression:  # noqa: A001
    return ex.ReducerExpression("any", expr)


def sorted_tuple(expr, *, skip_nones: bool = False) -> ex.ReducerExpression:
    return ex.ReducerExpression("sorted_tuple", expr, skip_nones=skip_nones)


def tuple(expr, *, skip_nones: bool = False) -> ex.ReducerExpression:  # noqa: A001
    return ex.ReducerExpression("tuple", expr, skip_nones=skip_nones)


def ndarray(expr, *, skip_nones: bool = False) -> ex.ReducerExpression:
    return ex.ReducerExpression("ndarray", expr, skip_nones=skip_nones)


def earliest(expr) -> ex.ReducerExpression:
    return ex.ReducerExpression("earliest", expr)


def latest(expr) -> ex.ReducerExpression:
    return ex.ReducerExpression("latest", expr)


def stateful_single(combine_fn: Callable, *args) -> ex.ReducerExpression:
    def combine(state, rows):
        for row in rows:
            state = combine_fn(state, *row)
        return state

    return ex.ReducerExpression("stateful", *args, fn=combine)


def stateful_many(combine_fn: Callable, *args) -> ex.ReducerExpression:
    return ex.ReducerExpression("stateful", *args, fn=combine_fn)


class BaseCustomAccumulator:
    """Custom-reducer protocol (reference: pw.BaseCustomAccumulator):
    ``from_row(row)`` builds a one-row accumulator, ``update(other)`` folds
    another accumulator in, ``compute_result()`` extracts the emitted value.
    Use with :func:`udf_reducer`."""

    @classmethod
    def from_row(cls, row):
        raise NotImplementedError

    def update(self, other) -> None:
        raise NotImplementedError

    def compute_result(self):
        raise NotImplementedError


def udf_reducer(reducer_cls):
    """Turn a BaseCustomAccumulator subclass (or a legacy
    ``update(state, *row)`` class) into a reducer factory."""

    if isinstance(reducer_cls, type) and issubclass(reducer_cls,
                                                    BaseCustomAccumulator):
        def make(*args):
            def combine(state, rows):
                for row in rows:
                    acc = reducer_cls.from_row(list(row))
                    if state is None:
                        state = acc
                    else:
                        state.update(acc)
                return state

            def emit(state):
                return state.compute_result()

            return ex.ReducerExpression("stateful", *args, fn=combine,
                                        emit=emit)

        return make

    def make(*args):
        acc = reducer_cls()

        def combine(state, rows):
            if state is None:
                state = acc.initial_state() if hasattr(acc, "initial_state") else None
            for row in rows:
                state = acc.update(state, *row)
            return state

        return ex.ReducerExpression("stateful", *args, fn=combine)

    return make


def int_sum(expr) -> ex.ReducerExpression:
    """Deprecated alias of ``sum`` (reference reducers.int_sum)."""
    return ex.ReducerExpression("sum", expr)


def npsum(expr) -> ex.ReducerExpression:
    """Deprecated alias of ``ndarray`` element-wise sum
    (reference reducers.npsum → array_sum)."""
    return ex.ReducerExpression("array_sum", expr)
