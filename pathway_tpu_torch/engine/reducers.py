"""Engine-side incremental reducers — port of pathway_tpu/engine/reducers.py,
the reference's reducer set (src/engine/reduce.rs:22 — Count,
IntSum, FloatSum, ArraySum, Unique, Min, Max, ArgMin, ArgMax, Any,
SortedTuple, Tuple, Stateful, Earliest, Latest). Semigroup reducers
(count/sums) update in O(1); order-dependent ones keep a per-group multiset
and recompute on change — correct under retraction, optimized later via
a segment sum on the device for array-typed columns
(engine/operators.py ``device_segsum``).

Each reducer is a factory producing per-group state objects with
``add(values, diff)`` and ``emit() -> value``.
"""

from __future__ import annotations

import math
from typing import Any, Callable

import numpy as np

from pathway_tpu_torch.engine.delta import row_fingerprint


class ReducerState:
    def add(self, args: tuple, diff: int) -> None:
        raise NotImplementedError

    def emit(self) -> Any:
        raise NotImplementedError

    def is_empty(self) -> bool:
        raise NotImplementedError


class _CountState(ReducerState):
    __slots__ = ("n",)

    def __init__(self):
        self.n = 0

    def add(self, args, diff):
        self.n += diff

    def emit(self):
        return self.n

    def is_empty(self):
        return self.n == 0


class _SumState(ReducerState):
    __slots__ = ("n", "total")

    def __init__(self):
        self.n = 0
        self.total = 0

    def add(self, args, diff):
        self.n += diff
        v = args[0]
        if v is not None:
            self.total = self.total + diff * v

    def set_total(self, total, count: int) -> None:
        """Device segment-sum tick update (see _ArraySumState.set_total):
        ``total`` already continues this state's prior running total."""
        self.n += count
        self.total = total

    def emit(self):
        return self.total

    def is_empty(self):
        return self.n == 0


class _ArraySumState(ReducerState):
    __slots__ = ("n", "total")

    def __init__(self):
        self.n = 0
        self.total = None

    def add(self, args, diff):
        self.n += diff
        v = np.asarray(args[0])
        if self.total is None:
            self.total = diff * v
        else:
            self.total = self.total + diff * v

    def set_total(self, total, count: int) -> None:
        """Batched tick update from the device segment-sum kernel
        (operators.py ``_device_array_sums``): ``total`` is the NEW
        running total (the kernel was seeded with the prior one), so it
        replaces rather than adds."""
        self.n += count
        self.total = total

    def emit(self):
        return self.total

    def is_empty(self):
        return self.n == 0


class _MultisetState(ReducerState):
    """Keeps a multiset of argument tuples; subclass defines the aggregate."""

    __slots__ = ("counts", "values", "n")

    def __init__(self):
        self.counts: dict[int, int] = {}
        self.values: dict[int, tuple] = {}
        self.n = 0

    def add(self, args, diff):
        self.n += diff
        fp = row_fingerprint(args)
        c = self.counts.get(fp, 0) + diff
        if c == 0:
            self.counts.pop(fp, None)
            self.values.pop(fp, None)
        else:
            self.counts[fp] = c
            self.values[fp] = args

    def is_empty(self):
        return self.n == 0

    def iter_args(self):
        for fp, c in self.counts.items():
            v = self.values[fp]
            for _ in range(max(c, 0)):
                yield v


class _MinState(_MultisetState):
    def emit(self):
        return min(v[0] for v in self.iter_args())


class _MaxState(_MultisetState):
    def emit(self):
        return max(v[0] for v in self.iter_args())


class _ArgMinState(_MultisetState):
    def emit(self):
        # args = (cmp_value, payload); ties broken by payload for determinism
        best = min(self.iter_args(), key=lambda v: (v[0], _orderable(v[1])))
        return best[1]


class _ArgMaxState(_MultisetState):
    def emit(self):
        best = max(self.iter_args(), key=lambda v: (v[0], _neg_orderable(v[1])))
        return best[1]


def _orderable(v):
    try:
        return (0, v)
    except Exception:  # pragma: no cover
        return (1, repr(v))


def _neg_orderable(v):
    return _orderable(v)


class _UniqueState(_MultisetState):
    def emit(self):
        vals = {row_fingerprint((v[0],)): v[0] for v in self.iter_args()}
        if len(vals) != 1:
            raise ValueError(
                "More than one distinct value passed to the unique reducer."
            )
        return next(iter(vals.values()))


class _AnyState(_MultisetState):
    def emit(self):
        # deterministic pick: smallest fingerprint (reference picks arbitrary
        # but deterministic per worker)
        fp = min(self.counts)
        return self.values[fp][0]


class _SortedTupleState(_MultisetState):
    __slots__ = ("skip_nones",)

    def __init__(self, skip_nones=False):
        super().__init__()
        self.skip_nones = skip_nones

    def emit(self):
        vals = [v[0] for v in self.iter_args()]
        if self.skip_nones:
            vals = [v for v in vals if v is not None]
        return tuple(sorted(vals, key=_sort_key))


class _TupleState(_MultisetState):
    """Tuple in insertion-order position — ordered by the sort column (args[1])."""

    __slots__ = ("skip_nones",)

    def __init__(self, skip_nones=False):
        super().__init__()
        self.skip_nones = skip_nones

    def emit(self):
        items = list(self.iter_args())
        items.sort(key=lambda v: _sort_key(v[1]) if len(v) > 1 else 0)
        vals = [v[0] for v in items]
        if self.skip_nones:
            vals = [v for v in vals if v is not None]
        return tuple(vals)


class _NDArrayState(_TupleState):
    def emit(self):
        return np.array(super().emit())


def _sort_key(v):
    if v is None:
        return (0, 0)
    if isinstance(v, (bool, int, float, np.integer, np.floating)):
        return (1, float(v))
    if isinstance(v, str):
        return (2, v)
    if isinstance(v, (tuple, list)):
        # element-wise, not repr: (10, k) must sort after (5, k)
        return (3, tuple(_sort_key(x) for x in v))
    return (4, repr(v))


class _EarliestState(ReducerState):
    """First value by arrival stamp. Insertions arrive as (*vals, stamp);
    retractions arrive as (*vals, None) and cancel the most recent stamp of
    that value (per-value LIFO — the retraction corresponds to an earlier
    insertion of the same value)."""

    __slots__ = ("stamps", "values", "n")

    def __init__(self):
        self.stamps: dict[int, list] = {}   # value-fp -> sorted stamps
        self.values: dict[int, Any] = {}
        self.n = 0

    def add(self, args, diff):
        *vals, stamp = args
        fp = row_fingerprint(tuple(vals))
        self.n += diff
        if diff > 0:
            self.stamps.setdefault(fp, []).append(stamp)
            self.stamps[fp].sort()
            self.values[fp] = vals[0] if vals else None
        else:
            lst = self.stamps.get(fp)
            if lst:
                lst.pop()  # cancel the latest instance of this value
                if not lst:
                    del self.stamps[fp]
                    self.values.pop(fp, None)

    def emit(self):
        best_fp = min(self.stamps, key=lambda fp: self.stamps[fp][0])
        return self.values[best_fp]

    def is_empty(self):
        return self.n <= 0 or not self.stamps



class _LatestState(_EarliestState):
    def emit(self):
        best_fp = max(self.stamps, key=lambda fp: self.stamps[fp][-1])
        return self.values[best_fp]


class _StatefulState(ReducerState):
    """User combine_fn over (state, rows) — reference's StatefulReducer
    (src/engine/reduce.rs Stateful{combine_fn}). Only supports additions;
    retraction raises like the reference does on append-only violation."""

    __slots__ = ("fn", "state", "n", "emit_fn")

    def __init__(self, fn: Callable, emit: Callable | None = None):
        self.fn = fn
        self.state = None
        self.n = 0
        self.emit_fn = emit

    def add(self, args, diff):
        if diff < 0:
            raise ValueError(
                "stateful reducer requires append-only input (got a deletion)"
            )
        self.n += diff
        self.state = self.fn(self.state, [args])

    def emit(self):
        # emit_fn: custom-accumulator result extraction (compute_result in
        # the reference's BaseCustomAccumulator protocol)
        if self.emit_fn is not None:
            return self.emit_fn(self.state)
        return self.state

    def is_empty(self):
        return self.n == 0


class _AvgState(_SumState):
    def emit(self):
        return self.total / self.n if self.n else math.nan


REDUCER_FACTORIES: dict[str, Callable[..., ReducerState]] = {
    "count": _CountState,
    "sum": _SumState,
    "int_sum": _SumState,
    "float_sum": _SumState,
    "array_sum": _ArraySumState,
    "avg": _AvgState,
    "min": _MinState,
    "max": _MaxState,
    "argmin": _ArgMinState,
    "argmax": _ArgMaxState,
    "unique": _UniqueState,
    "any": _AnyState,
    "sorted_tuple": _SortedTupleState,
    "tuple": _TupleState,
    "ndarray": _NDArrayState,
    "earliest": _EarliestState,
    "latest": _LatestState,
    "stateful": _StatefulState,
}


def make_reducer_state(name: str, **kwargs) -> ReducerState:
    return REDUCER_FACTORIES[name](**kwargs)
