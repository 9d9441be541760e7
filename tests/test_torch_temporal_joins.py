"""The port's temporal joins (``asof_now_join``, ``asof_join``,
``interval_join``, ``window_join`` of stdlib/temporal, and their Table
methods and ``*_inner/_left/_right/_outer`` aliases) against the JAX
package's: both sides are numpy-seeded streams over several ticks with
late rows and retractions, run through ``pathway_tpu`` and
``pathway_tpu_torch`` under ``run_batch(n_workers=1)``; the consolidated
events (time, key, diff, row), the schema and the graph's operator
classes must be equal exactly (tolerance: none), so the keys the joins,
flattens, ``with_id`` and ``concat_reindex`` build are the JAX package's.

The JAX side runs with ``PATHWAY_AUTO_JIT=0`` and
``PATHWAY_DEVICE_INFLIGHT=1`` (see tests/test_torch_table.py).
"""

import datetime

import pytest

from test_torch_temporal import (_reference_schedule, assert_equal,  # noqa: F401
                                 events_table, stream_rows)

HOWS = ["inner", "left", "right", "outer"]
MINUTE = datetime.timedelta(minutes=1)


def _sides(pw, seed: int, kind: str = "int", n: int = 60):
    left = events_table(pw, stream_rows(seed, n, kind=kind), kind)
    right = events_table(pw, stream_rows(seed + 100, n, kind=kind), kind)
    return left, right


# -- asof_now_join -----------------------------------------------------------

@pytest.mark.parametrize("how", ["inner", "left"])
@pytest.mark.parametrize("with_id", [False, True], ids=["join_ids", "id"])
def test_asof_now_join_equals_reference(how, with_id):
    """Queries (the left side, one-shot) join the right side's state as of
    their tick and are never revised, while the right side changes."""
    dims_rows = stream_rows(21, 40, n_keys=3)
    query_rows = [(f"k{i % 4}", i, i, 2 * (1 + i // 5) + 1, 1)
                  for i in range(30)]

    def build(pw):
        dims = events_table(pw, dims_rows)
        queries = events_table(pw, query_rows)
        if with_id:
            queries = queries.with_id_from(queries.v)
        kw = {"id": queries.id} if with_id else {}
        return pw.temporal.asof_now_join(
            queries, dims, queries.k == dims.k, how=how, **kw,
        ).select(q=queries.v, k=queries.k, label=dims.v, at=dims.at)

    assert assert_equal(build)


def test_asof_now_join_table_method_and_alias_equal_reference():
    dims_rows = stream_rows(23, 30, n_keys=2)
    query_rows = [(f"k{i % 3}", i, i, 2 * (1 + i // 4) + 1, 1)
                  for i in range(20)]

    for call in (lambda pw, q, d: q.asof_now_join(d, q.k == d.k),
                 lambda pw, q, d: pw.temporal.asof_now_join_left(
                     q, d, q.k == d.k),
                 lambda pw, q, d: pw.temporal.asof_now_join_inner(
                     q, d, q.k == d.k)):
        def build(pw, call=call):
            dims = events_table(pw, dims_rows)
            queries = events_table(pw, query_rows)
            return call(pw, queries, dims).select(
                q=pw.left.v, label=pw.right.v)

        assert assert_equal(build)


# -- asof_join ---------------------------------------------------------------

@pytest.mark.parametrize("direction", ["backward", "forward", "nearest"])
@pytest.mark.parametrize("how", HOWS)
@pytest.mark.parametrize("on", [False, True], ids=["no_on", "on_k"])
def test_asof_join_equals_reference(direction, how, on):
    def build(pw):
        left, right = _sides(pw, 31, n=40)
        conds = [left.k == right.k] if on else []
        return pw.temporal.asof_join(
            left, right, left.at, right.at, *conds, how=how,
            direction=direction,
        ).select(left.k, a=left.v, ta=left.at, b=right.v, tb=right.at)

    assert assert_equal(build)


@pytest.mark.parametrize("how", HOWS)
def test_asof_join_defaults_and_aliases_equal_reference(how):
    def build(pw):
        left, right = _sides(pw, 37, n=40)
        call = {"inner": pw.temporal.asof_join,
                "left": pw.temporal.asof_join_left,
                "right": pw.temporal.asof_join_right,
                "outer": pw.temporal.asof_join_outer}[how]
        return call(left, right, left.at, right.at, left.k == right.k,
                    defaults={"b": -1, "a": -2}).select(
            a=left.v, b=right.v, t=left.at)

    assert assert_equal(build)


def test_asof_join_table_method_equals_reference():
    def build(pw):
        left, right = _sides(pw, 41, n=40)
        return left.asof_join(right, left.at, right.at, left.k == right.k,
                              how="left", direction="nearest").select(
            a=left.v, b=right.v)

    assert assert_equal(build)


# -- interval_join -----------------------------------------------------------

@pytest.mark.parametrize("how", HOWS)
@pytest.mark.parametrize("kind", ["int", "datetime"])
@pytest.mark.parametrize("on", [False, True], ids=["no_on", "on_k"])
def test_interval_join_equals_reference(how, kind, on):
    lb, ub = (-3, 2) if kind == "int" else (-3 * MINUTE, 2 * MINUTE)

    def build(pw):
        left, right = _sides(pw, 43, kind, n=50)
        conds = [left.k == right.k] if on else []
        return pw.temporal.interval_join(
            left, right, left.at, right.at, pw.temporal.interval(lb, ub),
            *conds, how=how,
        ).select(left.k, a=left.v, ta=left.at, b=right.v, tb=right.at)

    assert assert_equal(build)


@pytest.mark.parametrize("how", HOWS)
def test_interval_join_aliases_and_method_equal_reference(how):
    def build(pw):
        left, right = _sides(pw, 47, n=50)
        if how == "inner":
            jr = left.interval_join(right, left.at, right.at,
                                    pw.temporal.interval(-1, 4),
                                    left.k == right.k)
        else:
            jr = getattr(pw.temporal, f"interval_join_{how}")(
                left, right, left.at, right.at, (-1, 4), left.k == right.k)
        return jr.select(a=left.v, b=right.v)

    assert assert_equal(build)


@pytest.mark.parametrize("behavior", [
    dict(delay=3), dict(cutoff=6), dict(delay=2, cutoff=6),
    dict(cutoff=6, keep_results=False)],
    ids=["delay", "cutoff", "delay_cutoff", "cutoff_forget_results"])
def test_interval_join_behavior_equals_reference(behavior):
    def build(pw):
        left, right = _sides(pw, 53, n=50)
        return pw.temporal.interval_join(
            left, right, left.at, right.at, pw.temporal.interval(-2, 2),
            left.k == right.k,
            behavior=pw.temporal.common_behavior(**behavior),
        ).select(a=left.v, b=right.v, ta=left.at)

    assert assert_equal(build)


# -- window_join -------------------------------------------------------------

JOIN_WINDOWS = {
    "tumbling": lambda pw: pw.temporal.tumbling(6),
    "sliding": lambda pw: pw.temporal.sliding(hop=3, duration=6),
    "session": lambda pw: pw.temporal.session(max_gap=2),
    "session_predicate": lambda pw: pw.temporal.session(
        predicate=lambda a, b: b - a < 3),
}


@pytest.mark.parametrize("window", sorted(JOIN_WINDOWS))
@pytest.mark.parametrize("how", HOWS)
@pytest.mark.parametrize("on", [False, True], ids=["no_on", "on_k"])
def test_window_join_equals_reference(window, how, on):
    def build(pw):
        left, right = _sides(pw, 59, n=40)
        conds = [left.k == right.k] if on else []
        return pw.temporal.window_join(
            left, right, left.at, right.at, JOIN_WINDOWS[window](pw),
            *conds, how=how,
        ).select(left.k, a=left.v, ta=left.at, b=right.v, tb=right.at)

    assert assert_equal(build)


@pytest.mark.parametrize("how", HOWS)
def test_window_join_aliases_and_method_equal_reference(how):
    def build(pw):
        left, right = _sides(pw, 61, n=40)
        if how == "inner":
            jr = left.window_join(right, left.at, right.at,
                                  pw.temporal.tumbling(5), left.k == right.k)
        else:
            jr = getattr(pw.temporal, f"window_join_{how}")(
                left, right, left.at, right.at, pw.temporal.tumbling(5),
                left.k == right.k)
        return jr.select(a=pw.left.v, b=pw.right.v)

    assert assert_equal(build)


def test_time_to_nanoseconds_equals_reference():
    """interval_join's bucket arithmetic: the port's datetime-only
    ``_as_num`` gives the JAX package's pandas nanoseconds for naive and
    aware datetimes and for durations, and passes numbers through."""
    from pathway_tpu.stdlib import temporal as jtemporal
    from pathway_tpu_torch.stdlib import temporal as ttemporal

    east = datetime.timezone(datetime.timedelta(hours=5, minutes=30))
    values = [
        datetime.datetime(2024, 2, 29, 23, 59, 58, 999_999),
        datetime.datetime(1969, 12, 31, 23, 0, 0, 1),
        datetime.datetime(2024, 1, 1, 12, tzinfo=datetime.timezone.utc),
        datetime.datetime(2024, 1, 1, 12, 0, 0, 17, tzinfo=east),
        datetime.timedelta(days=-3, seconds=7, microseconds=11),
        datetime.timedelta(minutes=90, microseconds=999_999),
        17, -4.5,
    ]
    for v in values:
        assert ttemporal._as_num(v) == jtemporal._as_num(v), v
