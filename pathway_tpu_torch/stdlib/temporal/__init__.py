"""Temporal stdlib: windows, behaviors, asof / interval / window joins —
port of pathway_tpu/stdlib/temporal.

Window assignment is a per-row flatten onto (start, end) window instances
(tumbling windows over numeric times: plain column arithmetic), then an
ordinary incremental groupby; behaviors compile to the engine's buffer /
forget / freeze watermark operators (engine/temporal_ops.py). Times are
numbers, or ``datetime.datetime`` (naive or UTC-aware) with
``datetime.timedelta`` durations: nothing here imports pandas.
"""

from __future__ import annotations

import datetime
from dataclasses import dataclass
from typing import Any

from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals import expression as ex
from pathway_tpu_torch.internals import thisclass
from pathway_tpu_torch.internals.table import Table

__all__ = [
    "Window", "tumbling", "sliding", "session", "intervals_over",
    "CommonBehavior", "common_behavior", "exactly_once_behavior",
    "windowby", "asof_join", "asof_join_left", "asof_join_right",
    "asof_join_outer", "asof_now_join", "asof_now_join_inner",
    "asof_now_join_left",
    "interval", "interval_join", "interval_join_inner", "interval_join_left",
    "interval_join_right", "interval_join_outer",
    "window_join", "window_join_inner", "window_join_left",
    "window_join_right", "window_join_outer", "Direction",
]


# ---------------------------------------------------------------------------
# behaviors (reference: temporal_behavior.py:29-113)
# ---------------------------------------------------------------------------

@dataclass
class CommonBehavior:
    delay: Any = None
    cutoff: Any = None
    keep_results: bool = True


def common_behavior(delay=None, cutoff=None, keep_results: bool = True) -> CommonBehavior:
    return CommonBehavior(delay, cutoff, keep_results)


@dataclass
class ExactlyOnceBehavior:
    shift: Any = None


def exactly_once_behavior(shift=None) -> ExactlyOnceBehavior:
    return ExactlyOnceBehavior(shift)


# ---------------------------------------------------------------------------
# window definitions (reference: _window.py)
# ---------------------------------------------------------------------------

class Window:
    def assign(self, t) -> list[tuple]:
        raise NotImplementedError


@dataclass
class TumblingWindow(Window):
    duration: Any
    origin: Any = None
    offset: Any = None

    def assign(self, t):
        origin = self.origin if self.origin is not None else (
            self.offset if self.offset is not None else _zero_like(t))
        k = _floor_div(t - origin, self.duration)
        start = origin + k * self.duration
        return [(start, start + self.duration)]


@dataclass
class SlidingWindow(Window):
    hop: Any
    duration: Any
    origin: Any = None
    offset: Any = None

    def assign(self, t):
        origin = self.origin if self.origin is not None else (
            self.offset if self.offset is not None else _zero_like(t))
        out = []
        # windows [start, start+duration) with start = origin + i*hop covering t
        first = _floor_div(t - origin - self.duration, self.hop) + 1
        i = first
        while True:
            start = origin + i * self.hop
            if start > t:
                break
            if t < start + self.duration:
                out.append((start, start + self.duration))
            i += 1
        return out


@dataclass
class SessionWindow(Window):
    predicate: Any = None
    max_gap: Any = None


@dataclass
class IntervalsOverWindow(Window):
    at: Table
    lower_bound: Any
    upper_bound: Any
    is_outer: bool = False


def tumbling(duration, origin=None, offset=None) -> TumblingWindow:
    return TumblingWindow(duration, origin, offset)


def sliding(hop, duration=None, ratio: int | None = None, origin=None,
            offset=None) -> SlidingWindow:
    """Sliding window of ``duration`` every ``hop``.

    >>> import pathway_tpu_torch as pw
    >>> t = pw.debug.table_from_markdown('''
    ... at | v
    ... 1  | 10
    ... 3  | 20
    ... 7  | 30
    ... ''')
    >>> win = pw.temporal.windowby(
    ...     t, t.at, window=pw.temporal.sliding(hop=2, duration=4))
    >>> pw.debug.compute_and_print(
    ...     win.reduce(start=pw.this._pw_window_start,
    ...                s=pw.reducers.sum(pw.this.v)),
    ...     include_id=False)
    start | s
    -2 | 10
    0 | 30
    2 | 20
    4 | 30
    6 | 30
    """
    if duration is None and ratio is not None:
        duration = hop * ratio
    return SlidingWindow(hop, duration, origin, offset)


def session(*, predicate=None, max_gap=None) -> SessionWindow:
    if (predicate is None) == (max_gap is None):
        raise ValueError("session() needs exactly one of predicate= / max_gap=")
    return SessionWindow(predicate, max_gap)


def intervals_over(*, at: Table, lower_bound, upper_bound,
                   is_outer: bool = False) -> IntervalsOverWindow:
    return IntervalsOverWindow(at, lower_bound, upper_bound, is_outer)


_EPOCH = datetime.datetime(1970, 1, 1)
_EPOCH_UTC = datetime.datetime(1970, 1, 1, tzinfo=datetime.timezone.utc)


def _zero_like(t):
    """The default window origin: the epoch for datetimes (naive or
    aware, as ``t`` is), else 0."""
    if isinstance(t, datetime.datetime):
        return _EPOCH if t.tzinfo is None else _EPOCH_UTC
    return 0


def _floor_div(a, b):
    if isinstance(a, datetime.timedelta):
        return int(a // b)
    return a // b


# ---------------------------------------------------------------------------
# windowby (reference: _window.py windowby + WindowedTable)
# ---------------------------------------------------------------------------

class WindowedTable:
    """Result of windowby: reduce() groups rows per (instance, window)."""

    def __init__(self, windowed: Table, instance_used: bool):
        self._windowed = windowed
        self._instance_used = instance_used

    def reduce(self, *args, **kwargs) -> Table:
        t = self._windowed
        by = [t["_pw_window"], t["_pw_window_start"], t["_pw_window_end"]]
        if self._instance_used:
            by.append(t["_pw_instance"])
        grouped = t.groupby(*by)

        def fix(e):
            return thisclass.resolve_this({"this": t}, ex.wrap_arg(e))

        new_args = [fix(a) for a in args]
        new_kwargs = {k: fix(v) for k, v in kwargs.items()}
        return grouped.reduce(*new_args, **new_kwargs)


def _tumbling_fast_path_ok(window: "TumblingWindow", time_e) -> bool:
    """The arithmetic fast path needs numeric, non-optional event times
    (a None time must DROP the row — the generic flatten path's ()
    semantics); datetime times keep the generic path (their zero origin
    is value-dependent)."""
    from pathway_tpu_torch.internals.type_inference import infer_dtype

    try:
        d = infer_dtype(time_e)
    except Exception:
        return False
    if d != dt.unoptionalize(d):  # optional: None handling differs
        return False
    return dt.unoptionalize(d) in (dt.INT, dt.FLOAT)


def windowby(table: Table, time_expr, *, window: Window, behavior=None,
             instance=None, origin=None) -> WindowedTable:
    """Assign rows to time windows, then reduce per window.

    >>> import pathway_tpu_torch as pw
    >>> t = pw.debug.table_from_markdown('''
    ... at | v
    ... 1  | 10
    ... 3  | 20
    ... 6  | 30
    ... ''')
    >>> win = pw.temporal.windowby(t, t.at, window=pw.temporal.tumbling(5))
    >>> pw.debug.compute_and_print(
    ...     win.reduce(start=pw.this._pw_window_start,
    ...                s=pw.reducers.sum(pw.this.v)),
    ...     include_id=False)
    start | s
    0 | 30
    5 | 30
    """
    time_e = table._resolve(ex.wrap_arg(time_expr))
    instance_used = instance is not None
    inst_e = table._resolve(ex.wrap_arg(instance)) if instance_used else None

    if isinstance(window, SessionWindow):
        windowed = _assign_session_windows(table, time_e, window, inst_e)
    elif isinstance(window, IntervalsOverWindow):
        windowed = _assign_intervals_over(table, time_e, window, inst_e)
    elif (isinstance(window, TumblingWindow)
          and _tumbling_fast_path_ok(window, time_e)):
        # exactly one window per row: no flatten, no per-row python — the
        # assignment is plain column arithmetic (start = origin +
        # ((t - origin) // d) * d, same semantics as TumblingWindow.assign)
        origin = window.origin if window.origin is not None else (
            window.offset if window.offset is not None else 0)
        d = window.duration
        start_e = origin + ((time_e - origin) // d) * d
        end_e = start_e + d
        windowed = table.with_columns(
            _pw_time=time_e,
            _pw_window_start=start_e,
            _pw_window_end=end_e,
            _pw_window=ex.MakeTupleExpression(
                *( [inst_e] if instance_used else [] ), start_e, end_e),
            **({"_pw_instance": inst_e} if instance_used else {}),
        )
    else:
        assign = window.assign

        def windows_of(t):
            if t is None:
                return ()
            return tuple(assign(t))

        with_windows = table.with_columns(
            _pw_windows=ex.ApplyExpression(windows_of, None, time_e),
            _pw_time=time_e,
            **({"_pw_instance": inst_e} if instance_used else {}),
        )
        flat = with_windows.flatten(with_windows._pw_windows)
        # start/end carry the time expression's dtype (the tuple-returning
        # assign fn erases it to ANY): concrete dtypes here let the
        # columnar groupby fast path serve window reduces
        from pathway_tpu_torch.internals.type_inference import infer_dtype

        time_dt = dt.unoptionalize(infer_dtype(time_e))
        start_e = ex.declare_type(time_dt, flat._pw_windows[0])
        end_e = ex.declare_type(time_dt, flat._pw_windows[1])
        windowed = flat.with_columns(
            _pw_window_start=start_e,
            _pw_window_end=end_e,
            _pw_window=ex.MakeTupleExpression(
                *( [flat._pw_instance] if instance_used else [] ),
                start_e, end_e),
        ).without("_pw_windows")

    if behavior is not None:
        windowed = _apply_behavior(windowed, behavior)
    return WindowedTable(windowed, instance_used)


def _apply_behavior(windowed: Table, behavior) -> Table:
    if isinstance(behavior, ExactlyOnceBehavior):
        shift = behavior.shift
        thr = windowed._pw_window_end if shift is None else (
            windowed._pw_window_end + shift)
        out = windowed._buffer(thr, windowed._pw_time)
        out = out._forget(thr, out._pw_time, mark_forgetting_records=False)
        return out._filter_out_results_of_forgetting()
    if isinstance(behavior, CommonBehavior):
        out = windowed
        if behavior.delay is not None:
            out = out._buffer(out._pw_window_start + behavior.delay, out._pw_time)
        if behavior.cutoff is not None:
            out = out._forget(out._pw_window_end + behavior.cutoff, out._pw_time)
            if behavior.keep_results:
                out = out._filter_out_results_of_forgetting()
        return out
    raise TypeError(f"unknown behavior {behavior!r}")


def _assign_session_windows(table: Table, time_e, window: SessionWindow,
                            inst_e) -> Table:
    """Sessions via per-instance sorted sweep: collect (time,key) tuples per
    instance, split where gap/predicate breaks, emit per-key window bounds."""
    base = table.with_columns(
        _pw_time=time_e,
        _pw_instance=inst_e if inst_e is not None else 0,
    )
    pred = window.predicate
    max_gap = window.max_gap

    import pathway_tpu_torch.internals.reducers_frontend as reducers

    per_inst = base.groupby(base._pw_instance).reduce(
        base._pw_instance,
        _pw_items=reducers.sorted_tuple(
            ex.MakeTupleExpression(base._pw_time, base.id)),
    )

    def sessions(items):
        out = []
        cur: list = []
        last_t = None
        for t, key in items:
            if cur:
                # reference _window.py:80 — strict: b - a < max_gap
                joined = (pred(last_t, t) if pred is not None
                          else (t - last_t) < max_gap)
                if not joined:
                    out.append(tuple(cur))
                    cur = []
            cur.append((t, key))
            last_t = t
        if cur:
            out.append(tuple(cur))
        result = []
        for sess in out:
            start = sess[0][0]
            end = sess[-1][0]
            for t, key in sess:
                result.append((key, start, end))
        return tuple(result)

    assignments = per_inst.select(
        per_inst._pw_instance,
        _pw_assign=ex.ApplyExpression(sessions, None, per_inst._pw_items),
    )
    flat = assignments.flatten(assignments._pw_assign)
    keyed = flat.select(
        _pw_key=flat._pw_assign[0],
        _pw_window_start=flat._pw_assign[1],
        _pw_window_end=flat._pw_assign[2],
        _pw_instance=flat._pw_instance,
    ).with_id(thisclass.this._pw_key)
    src = table.with_columns(_pw_time=time_e)
    joined = keyed.with_universe_of(src)
    out = src.with_columns(
        _pw_window_start=joined._pw_window_start,
        _pw_window_end=joined._pw_window_end,
        _pw_instance=joined._pw_instance,
    )
    return out.with_columns(
        _pw_window=ex.MakeTupleExpression(
            out._pw_instance, out._pw_window_start, out._pw_window_end),
    )


def _assign_intervals_over(table: Table, time_e, window: IntervalsOverWindow,
                           inst_e) -> Table:
    """intervals_over: for each row of `at`, a window
    [at+lower_bound, at+upper_bound] gathering source rows."""
    at = window.at
    at_col = at.column_names()[0]
    lb, ub = window.lower_bound, window.upper_bound
    src = table.with_columns(
        _pw_time=time_e,
        _pw_instance=inst_e if inst_e is not None else 0,
    )

    # cross join via instance bucket (intervals_over is generally small `at`)
    at_t = at.select(_pw_at=at[at_col]).with_columns(_pw_join_key=0)
    src_k = src.with_columns(_pw_join_key=0)
    pairs = src_k.join(
        at_t, src_k._pw_join_key == at_t._pw_join_key
    ).select(
        *[src_k[n] for n in table.column_names()],
        _pw_time=src_k._pw_time,
        _pw_instance=src_k._pw_instance,
        _pw_at=at_t._pw_at,
    )
    inside = pairs.filter(
        (pairs._pw_time >= pairs._pw_at + lb) & (pairs._pw_time <= pairs._pw_at + ub)
    )
    return inside.with_columns(
        _pw_window_start=inside._pw_at + lb,
        _pw_window_end=inside._pw_at + ub,
        _pw_window=ex.MakeTupleExpression(
            inside._pw_instance, inside._pw_at),
    )


# ---------------------------------------------------------------------------
# asof_now_join (reference: _asof_now_join.py — query-against-live-state)
# ---------------------------------------------------------------------------

def asof_now_join(left: Table, right: Table, *on, how: str = "inner", id=None,
                  left_instance=None, right_instance=None):
    """Left side behaves as a one-shot query stream: each left row is joined
    against the right state as of its arrival and never updated."""
    if how not in ("inner", "left"):
        raise ValueError("asof_now_join supports how='inner'|'left'")
    forgetting = left._forget_immediately()
    # column references on `left` must resolve against the forgetting table
    fixed_on = []
    for cond in on:
        fixed_on.append(_replace_table(cond, left, forgetting))
    jr = forgetting.join(right, *fixed_on, how=how,
                         id=_replace_table(id, left, forgetting) if id is not None else None,
                         left_instance=left_instance, right_instance=right_instance)
    return _AsofNowJoinResult(jr, left, forgetting)


class _AsofNowJoinResult:
    def __init__(self, join_result, original_left, forgetting):
        self._jr = join_result
        self._orig = original_left
        self._forgetting = forgetting

    def select(self, *args, **kwargs) -> Table:
        args = [_replace_table(a, self._orig, self._forgetting) for a in args]
        kwargs = {k: _replace_table(v, self._orig, self._forgetting)
                  for k, v in kwargs.items()}
        result = self._jr.select(*args, **kwargs)
        return result._filter_out_results_of_forgetting()


def asof_now_join_left(left, right, *on, **kw):
    return asof_now_join(left, right, *on, how="left", **kw)


def _replace_table(expr, old: Table, new: Table):
    from pathway_tpu_torch.internals.expression_utils import map_expression

    if expr is None or not isinstance(expr, ex.ColumnExpression):
        return expr

    def mapper(e):
        if isinstance(e, ex.IdExpression) and e.table is old:
            return ex.IdExpression(new)
        if isinstance(e, ex.ColumnReference) and e.table is old:
            return ex.ColumnReference(new, e.name)
        return None

    return map_expression(expr, mapper)


# ---------------------------------------------------------------------------
# asof_join (reference: asof_join.py, 1,110 LoC)
# ---------------------------------------------------------------------------

class Direction:
    BACKWARD = "backward"
    FORWARD = "forward"
    NEAREST = "nearest"


def asof_join(left: Table, right: Table, t_left, t_right, *on,
              how: str = "inner", defaults: dict | None = None,
              direction: str | None = None) -> "_AsofJoinResult":
    return _AsofJoinResult(left, right,
                           left._resolve(ex.wrap_arg(t_left)),
                           thisclass.resolve_this({"this": right}, ex.wrap_arg(t_right)),
                           list(on), how, defaults or {},
                           direction or Direction.BACKWARD)


def asof_join_left(left, right, t_left, t_right, *on, **kw):
    kw["how"] = "left"
    return asof_join(left, right, t_left, t_right, *on, **kw)


def asof_join_right(left, right, t_left, t_right, *on, **kw):
    kw["how"] = "right"
    return asof_join(left, right, t_left, t_right, *on, **kw)


def asof_join_outer(left, right, t_left, t_right, *on, **kw):
    kw["how"] = "outer"
    return asof_join(left, right, t_left, t_right, *on, **kw)


class _AsofJoinResult:
    """For each left row: the latest right row with t_right <= t_left
    (direction backward; forward/nearest analogous), within the on-equality
    groups. Implemented with the engine's join + argmax reducer + ix —
    incremental end to end."""

    def __init__(self, left, right, t_left, t_right, on, how, defaults, direction):
        self._left = left
        self._right = right
        self._tl = t_left
        self._tr = t_right
        self._on = on
        self._how = how
        self._defaults = defaults
        self._direction = direction

    def select(self, *args, **kwargs) -> Table:
        left, right = self._left, self._right
        lt = left.with_columns(_pw_t=self._tl)
        rt = right.with_columns(_pw_t=self._tr)
        on = [_replace_table(_replace_table(c, left, lt), right, rt)
              for c in self._on]
        if not on:
            lt = lt.with_columns(_pw_onk=0)
            rt = rt.with_columns(_pw_onk=0)
            on = [lt._pw_onk == rt._pw_onk]
        pairs = lt.join(rt, *on).select(
            _pw_lid=lt.id, _pw_rid=rt.id, _pw_lt=lt._pw_t, _pw_rt=rt._pw_t,
        )
        if self._direction == Direction.BACKWARD:
            valid = pairs.filter(pairs._pw_rt <= pairs._pw_lt)
        elif self._direction == Direction.FORWARD:
            valid = pairs.filter(pairs._pw_rt >= pairs._pw_lt)
        else:
            valid = pairs.with_columns(
                _pw_dist=ex.if_else(pairs._pw_rt >= pairs._pw_lt,
                                    pairs._pw_rt - pairs._pw_lt,
                                    pairs._pw_lt - pairs._pw_rt))
        best = valid.groupby(valid._pw_lid).reduce(
            valid._pw_lid,
            _pw_best=ex.ReducerExpression(
                "argmax" if self._direction == Direction.BACKWARD else "argmin",
                valid._pw_dist if self._direction == Direction.NEAREST
                else valid._pw_rt,
                valid._pw_rid),
        ).with_id(thisclass.this._pw_lid)

        keep_unmatched_left = self._how in ("left", "outer")
        if keep_unmatched_left:
            # pad every left row so unmatched ones surface with a None match
            matched = left.select(_pw_best=None).update_cells(
                best.select(thisclass.this._pw_best)
                    .promise_universe_is_subset_of(left))
            rmatch = right.ix(matched._pw_best, optional=True, context=matched)
        else:
            matched = best.with_universe_of(left)
            rmatch = right.ix(matched._pw_best, optional=False, context=matched)

        # build output
        out_kwargs: dict[str, ex.ColumnExpression] = {}
        for arg in args:
            if isinstance(arg, ex.ColumnReference):
                out_kwargs[arg.name] = arg
            elif isinstance(arg, thisclass.ThisRef):
                for n in left.column_names():
                    out_kwargs[n] = left[n]
        out_kwargs.update(kwargs)

        def fix(name, e):
            e = thisclass.resolve_this(
                {"left": left, "right": right, "this": left}, ex.wrap_arg(e))
            e = _replace_table(e, right, rmatch)
            if name in self._defaults:
                e = ex.coalesce(e, self._defaults[name])
            return e

        fixed = {k: fix(k, v) for k, v in out_kwargs.items()}
        result = left.select(**fixed)
        if not keep_unmatched_left:
            # inner/right: only left rows that found a match
            result = result.intersect(best)
        if self._how in ("right", "outer"):
            # right rows never chosen as a best match get padded in
            matched_right = best.groupby(best._pw_best).reduce(best._pw_best)\
                .with_id(thisclass.this._pw_best)
            unmatched = right.difference(matched_right.with_universe_of(right))
            cols = {}
            for name, e in out_kwargs.items():
                e2 = thisclass.resolve_this(
                    {"left": left, "right": right, "this": left},
                    ex.wrap_arg(e))
                if _side_of(e2, left, right) == "right":
                    cols[name] = _replace_table(e2, right, unmatched)
                else:
                    cols[name] = self._defaults.get(name)
            # reindex: right-row keys may collide with left-result keys
            result = result.concat_reindex(unmatched.select(**cols))
        return result


# ---------------------------------------------------------------------------
# interval_join (reference: interval_join.py, 1,619 LoC)
# ---------------------------------------------------------------------------

@dataclass
class Interval:
    lower_bound: Any
    upper_bound: Any


def interval(lower_bound, upper_bound) -> Interval:
    return Interval(lower_bound, upper_bound)


def _as_num(x):
    """Numeric view of a time-like value (datetime / timedelta → integer
    nanoseconds; a naive datetime counts as UTC) so bucket arithmetic is
    plain integer math — datetime // timedelta is not defined."""
    if isinstance(x, datetime.datetime):
        x = x - (_EPOCH if x.tzinfo is None else _EPOCH_UTC)
    if isinstance(x, datetime.timedelta):
        return (x.days * 86_400 + x.seconds) * 10**9 + x.microseconds * 1000
    return x


def interval_join(left: Table, right: Table, t_left, t_right, intrvl, *on,
                  how: str = "inner", behavior=None):
    """Pairs (l, r) with t_l + lb <= t_r <= t_l + ub.

    Bucketed equi-join: left rows replicate into every bucket their interval
    overlaps; right rows live in their own bucket; a pair matches only in
    bucket_of(t_r), so each pair appears exactly once.
    """
    if isinstance(intrvl, tuple):
        intrvl = Interval(*intrvl)
    lb, ub = intrvl.lower_bound, intrvl.upper_bound
    width = _as_num(ub) - _as_num(lb)
    if width <= 0:
        width = 1

    tl_e = left._resolve(ex.wrap_arg(t_left))
    tr_e = thisclass.resolve_this({"this": right}, ex.wrap_arg(t_right))
    lb_n, ub_n = _as_num(lb), _as_num(ub)

    def left_buckets(t):
        if t is None:
            return ()
        tn = _as_num(t)
        b0 = (tn + lb_n) // width
        b1 = (tn + ub_n) // width
        return tuple(range(int(b0), int(b1) + 1))

    def right_bucket(t):
        if t is None:
            return None
        return int(_as_num(t) // width)

    lt = left.with_columns(
        _pw_t=tl_e,
        _pw_buckets=ex.ApplyExpression(left_buckets, None, tl_e))
    # origin_id keeps the pre-flatten left row id so matches can be joined
    # back to the original left table
    lt_flat = lt.flatten(lt._pw_buckets, origin_id="_pw_lorig")
    rt = right.with_columns(
        _pw_t=tr_e,
        _pw_bucket=ex.ApplyExpression(right_bucket, None, tr_e))

    if behavior is not None and isinstance(behavior, CommonBehavior):
        if behavior.delay is not None:
            lt_flat = lt_flat._buffer(
                lt_flat._pw_t + behavior.delay, lt_flat._pw_t)
            rt = rt._buffer(rt._pw_t + behavior.delay, rt._pw_t)
        if behavior.cutoff is not None:
            # a left row is dead once no admissible right time remains
            # (t_r <= t_l + ub), and symmetrically for right rows
            lt_flat = lt_flat._forget(
                lt_flat._pw_t + ub + behavior.cutoff, lt_flat._pw_t)
            rt = rt._forget(rt._pw_t - lb + behavior.cutoff, rt._pw_t)

    conds = [lt_flat._pw_buckets == rt._pw_bucket]
    for c in on:
        conds.append(_replace_table(_replace_table(c, left, lt_flat), right, rt))
    return _IntervalJoinResult(left, right, lt_flat, rt, conds, lb, ub, how,
                               behavior)


class _IntervalJoinResult:
    def __init__(self, left, right, lt, rt, conds, lb, ub, how, behavior):
        self._left = left
        self._right = right
        self._lt = lt
        self._rt = rt
        self._conds = conds
        self._lb = lb
        self._ub = ub
        self._how = how
        self._behavior = behavior

    def _pad_unmatched(self, out, side: str, unmatched: Table) -> Table:
        """Rows of one side with no match: that side's columns, None other."""
        lref, rref = self._left, self._right
        cols = {}
        for name, e in out.items():
            e2 = thisclass.resolve_this(
                {"left": lref, "right": rref, "this": lref}, ex.wrap_arg(e))
            if _side_of(e2, lref, rref) == side:
                cols[name] = _replace_table(
                    e2, lref if side == "left" else rref, unmatched)
            else:
                cols[name] = None
        return unmatched.select(**cols)

    def select(self, *args, **kwargs) -> Table:
        lt, rt = self._lt, self._rt
        jr = lt.join(rt, *self._conds, how="inner")
        # _pw_lorig is the pre-flatten left id; rt is unflattened so rt.id
        # is the original right id
        matched = jr.select(
            _pw_lid=lt._pw_lorig, _pw_rid=rt.id,
            _pw_lt=lt._pw_t, _pw_rt=rt._pw_t)
        good = matched.filter(
            (matched._pw_rt >= matched._pw_lt + self._lb)
            & (matched._pw_rt <= matched._pw_lt + self._ub))

        lref = self._left
        rref = self._right
        lmatch = lref.ix(good._pw_lid, context=good)
        rmatch = rref.ix(good._pw_rid, context=good)

        out: dict[str, ex.ColumnExpression] = {}
        for arg in args:
            if isinstance(arg, ex.ColumnReference):
                out[arg.name] = arg
        out.update(kwargs)

        def fix(e):
            e = thisclass.resolve_this(
                {"left": lref, "right": rref, "this": lref}, ex.wrap_arg(e))
            e = _replace_table(e, lref, lmatch)
            e = _replace_table(e, rref, rmatch)
            return e

        fixed = {k: fix(v) for k, v in out.items()}
        result = good.select(**fixed)
        # pads are concat_reindex-ed: left/right row keys may collide with
        # each other or with the pair keys (join output keys are synthetic
        # in the reference too, dataflow.rs:2371-2379)
        if self._how in ("left", "outer"):
            matched_left = good.groupby(good._pw_lid).reduce(good._pw_lid)\
                .with_id(thisclass.this._pw_lid)
            unmatched = lref.difference(matched_left.with_universe_of(lref))
            result = result.concat_reindex(
                self._pad_unmatched(out, "left", unmatched))
        if self._how in ("right", "outer"):
            matched_right = good.groupby(good._pw_rid).reduce(good._pw_rid)\
                .with_id(thisclass.this._pw_rid)
            unmatched = rref.difference(matched_right.with_universe_of(rref))
            result = result.concat_reindex(
                self._pad_unmatched(out, "right", unmatched))
        if (isinstance(self._behavior, CommonBehavior)
                and self._behavior.cutoff is not None
                and self._behavior.keep_results):
            result = result._filter_out_results_of_forgetting()
        return result


def interval_join_left(left, right, t_left, t_right, intrvl, *on, **kw):
    kw["how"] = "left"
    return interval_join(left, right, t_left, t_right, intrvl, *on, **kw)


def interval_join_right(left, right, t_left, t_right, intrvl, *on, **kw):
    kw["how"] = "right"
    return interval_join(left, right, t_left, t_right, intrvl, *on, **kw)


def interval_join_outer(left, right, t_left, t_right, intrvl, *on, **kw):
    kw["how"] = "outer"
    return interval_join(left, right, t_left, t_right, intrvl, *on, **kw)


def _side_of(e, left, right):
    found = set()

    def walk(x):
        if isinstance(x, ex.ColumnReference):
            if x.table is left:
                found.add("left")
            elif x.table is right:
                found.add("right")
        for d in getattr(x, "_deps", ()):
            walk(d)

    walk(e)
    if found == {"left"}:
        return "left"
    if found == {"right"}:
        return "right"
    return "mixed"


# ---------------------------------------------------------------------------
# window_join (reference: window_join.py, 1,217 LoC)
# ---------------------------------------------------------------------------

def _session_window_join(left: Table, right: Table, tl_e, tr_e,
                         window: SessionWindow, on, how: str):
    """Session windows have no per-element assignment: sessions are built
    from the sorted UNION of both sides' times per join key, split where
    max_gap/predicate breaks (reference _window_join.py:174-180 — "creates
    sessions by concatenating records from both sides"), then each side
    attaches its session bounds and the sides equi-join on
    (join key, session). Same-time entries always share a session."""
    import pathway_tpu_torch.internals.reducers_frontend as reducers

    lk, rk = [], []
    for c in on:
        if not (isinstance(c, ex.BinaryExpression) and c._op == "=="):
            raise ValueError(
                "session window_join supports equality conditions only")
        a, b = c._left, c._right
        if _side_of(a, left, right) == "left":
            la, rb = a, b
        else:
            la, rb = b, a
        lk.append(left._resolve(la))
        rk.append(thisclass.resolve_this({"this": right}, rb))
    lkey = ex.MakeTupleExpression(*lk) if lk else ex.wrap_arg(0)
    rkey = ex.MakeTupleExpression(*rk) if rk else ex.wrap_arg(0)

    ul = left.select(_pw_t=tl_e, _pw_k=lkey)
    ur = right.select(_pw_t=tr_e, _pw_k=rkey)
    u = ul.concat_reindex(ur)
    u = u.filter(ex.apply(lambda t: t is not None, u._pw_t))
    g = u.groupby(u._pw_k).reduce(
        k=u._pw_k, ts=reducers.sorted_tuple(u._pw_t))
    pred, max_gap = window.predicate, window.max_gap

    def spans_of(ts):
        spans: list = []
        cur_start = None
        prev = None
        members: list = []
        for t in ts:
            if prev is not None and t != prev:
                joined = (pred(prev, t) if pred is not None
                          else (t - prev) < max_gap)
                if not joined:
                    spans.append((cur_start, prev, tuple(members)))
                    members = []
                    cur_start = None
            if cur_start is None:
                cur_start = t
            if not members or members[-1] != t:
                members.append(t)
            prev = t
        if cur_start is not None:
            spans.append((cur_start, prev, tuple(members)))
        out = []
        for s, e, ms in spans:
            for t in ms:
                out.append((t, s, e))
        return tuple(out)

    m = g.select(k=g.k, _pw_sp=ex.ApplyExpression(spans_of, None, g.ts))
    mf = m.flatten(m._pw_sp)
    tmap = mf.select(k=mf.k, t=mf._pw_sp[0], s=mf._pw_sp[1],
                     e=mf._pw_sp[2])

    la = left.with_columns(_pw_k=lkey, _pw_t=tl_e)
    ltf = la.join(tmap, la._pw_k == tmap.k, la._pw_t == tmap.t,
                  id=la.id).select(
        **{n: la[n] for n in left.column_names()},
        _pw_k=la._pw_k, _pw_w=ex.MakeTupleExpression(tmap.s, tmap.e))
    ra = right.with_columns(_pw_k=rkey, _pw_t=tr_e)
    rtf = ra.join(tmap, ra._pw_k == tmap.k, ra._pw_t == tmap.t,
                  id=ra.id).select(
        **{n: ra[n] for n in right.column_names()},
        _pw_k=ra._pw_k, _pw_w=ex.MakeTupleExpression(tmap.s, tmap.e))
    jr = ltf.join(rtf, ltf._pw_k == rtf._pw_k, ltf._pw_w == rtf._pw_w,
                  how=how)
    return ltf, rtf, jr


def window_join(left: Table, right: Table, t_left, t_right, window: Window,
                *on, how: str = "inner"):
    """Join rows that fall into the same window
    (reference: _window_join.py:156 — tumbling/sliding windows assign each
    row to its windows and the sides equi-join on (window, on-conds);
    session windows merge both sides' times into shared sessions)."""
    tl_e = left._resolve(ex.wrap_arg(t_left))
    tr_e = thisclass.resolve_this({"this": right}, ex.wrap_arg(t_right))

    if isinstance(window, SessionWindow):
        ltf, rtf, jr = _session_window_join(
            left, right, tl_e, tr_e, window, on, how)
    else:
        assign = window.assign

        def windows_of(t):
            if t is None:
                return ()
            return tuple(assign(t))

        lt = left.with_columns(
            _pw_w=ex.ApplyExpression(windows_of, None, tl_e))
        ltf = lt.flatten(lt._pw_w)
        rt = right.with_columns(
            _pw_w=ex.ApplyExpression(windows_of, None, tr_e))
        rtf = rt.flatten(rt._pw_w)
        conds = [ltf._pw_w == rtf._pw_w]
        for c in on:
            conds.append(
                _replace_table(_replace_table(c, left, ltf), right, rtf))
        jr = ltf.join(rtf, *conds, how=how)

    class _WJ:
        """Result proxy — like the reference's WindowJoinResult
        (_window_join.py:24-155) it exposes ``select``, substituting
        pw.left / pw.right / original-table references; the result of
        ``select`` is an ordinary Table that composes with everything."""

        def select(self_inner, *args, **kwargs):
            def fix(e):
                e = thisclass.resolve_this(
                    {"left": left, "right": right, "this": left},
                    ex.wrap_arg(e))
                e = _replace_table(e, left, ltf)
                e = _replace_table(e, right, rtf)
                return e

            out = {}
            for arg in args:
                if isinstance(arg, ex.ColumnReference):
                    out[arg.name] = arg
            out.update(kwargs)
            fixed = {k: fix(v) for k, v in out.items()}
            return jr.select(**fixed)

    return _WJ()


# explicit-mode aliases (reference __init__.py exports the full matrix)
def asof_now_join_inner(left, right, *on, **kw):
    kw["how"] = "inner"
    return asof_now_join(left, right, *on, **kw)


def interval_join_inner(left, right, t_left, t_right, intrvl, *on, **kw):
    kw["how"] = "inner"
    return interval_join(left, right, t_left, t_right, intrvl, *on, **kw)


def window_join_inner(left, right, t_left, t_right, window, *on, **kw):
    kw["how"] = "inner"
    return window_join(left, right, t_left, t_right, window, *on, **kw)


def window_join_left(left, right, t_left, t_right, window, *on, **kw):
    kw["how"] = "left"
    return window_join(left, right, t_left, t_right, window, *on, **kw)


def window_join_right(left, right, t_left, t_right, window, *on, **kw):
    kw["how"] = "right"
    return window_join(left, right, t_left, t_right, window, *on, **kw)


def window_join_outer(left, right, t_left, t_right, window, *on, **kw):
    kw["how"] = "outer"
    return window_join(left, right, t_left, t_right, window, *on, **kw)



# public result-class names for typing parity (reference exports these;
# the concrete proxies are the underscore classes above)
AsofJoinResult = _AsofJoinResult
AsofNowJoinResult = _AsofNowJoinResult
IntervalJoinResult = _IntervalJoinResult
from pathway_tpu_torch.internals.joins import JoinResult as _JoinResult  # noqa: E402

WindowJoinResult = _JoinResult
