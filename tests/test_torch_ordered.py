"""The port's ordering operators against the JAX package's: ``Table.sort``
(prev / next pointers, engine ``SortOperator``) under inserts and
retractions over several ticks (an instance raises in both packages);
``pw.stdlib.ordered.diff`` / ``Table.diff``; and
``pw.stdlib.statistical.interpolate`` / ``Table.interpolate``. The same
numpy-seeded streams run through ``pathway_tpu`` and ``pathway_tpu_torch``
under ``run_batch(n_workers=1)``; consolidated events (time, key, diff,
row), schema and operator classes are equal exactly (tolerance: none;
floats compare by their bits).
"""

import typing

import numpy as np
import pytest

from test_torch_temporal import (_reference_schedule, assert_equal,  # noqa: F401
                                 events_table, run_side, stream_rows)


@pytest.mark.parametrize("seed", [0, 1])
def test_sort_prev_next_under_retraction_equals_reference(seed):
    rows = stream_rows(seed, 60, retract=0.3)

    def build(pw):
        t = events_table(pw, rows)
        s = t.sort(t.at)
        return s.select(s.prev, s.next)

    events = assert_equal(build)
    assert any(d < 0 for _, _, d, _ in events)


def test_sort_ties_and_strings_equal_reference():
    """Equal sort keys order by row key; string keys sort as strings."""
    rows = [(f"k{i % 3}", i % 4, i % 5, 2 + 2 * (i // 7), 1)
            for i in range(30)]

    def build(pw):
        t = events_table(pw, rows)
        by_at = t.sort(t.at)
        by_k = t.sort(t.k)
        return by_at.select(by_at.prev, by_at.next, k_prev=by_k.prev,
                            k_next=by_k.next)

    assert assert_equal(build)


@pytest.mark.parametrize("call", [
    lambda t: t.sort(t.at, instance=t.k),
    lambda t: t.diff(t.at, t.v, instance=t.k)], ids=["sort", "diff"])
def test_instance_raises_as_in_reference(call):
    """``sort`` / ``diff`` with an instance: the JAX package's lowering
    tests the instance expression's truth and raises TypeError when the
    graph is lowered (ROADMAP queue 3); the port does the same."""
    rows = stream_rows(2, 20)
    for side in ("jax", "torch"):
        with pytest.raises(TypeError, match="boolean context"):
            run_side(side, lambda pw: call(events_table(pw, rows)))


def test_diff_equals_reference():
    rows = stream_rows(5, 60, retract=0.2)

    def build(pw):
        t = events_table(pw, rows)
        t = t.with_columns(w=t.v * 3 + 1)
        return t.diff(t.at, t.v, t.w)

    assert assert_equal(build)


def test_ordered_diff_function_equals_reference():
    rng = np.random.default_rng(9)
    rows = [(f"k{i % 2}", int(rng.integers(0, 50)), i, 2 + 2 * (i // 5), 1)
            for i in range(40)]

    def build(pw):
        t = events_table(pw, rows)
        return pw.stdlib.ordered.diff(t, t.at, t.v)

    assert assert_equal(build)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_interpolate_equals_reference(seed):
    """None values are filled from the nearest neighbours in time order:
    linear between two, the one neighbour at the ends."""
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(40):
        x = None if rng.random() < 0.35 else float(rng.integers(-20, 20))
        y = None if rng.random() < 0.35 else float(rng.normal())
        rows.append((3 * i + int(rng.integers(0, 3)), x, y,
                     2 + 2 * (i // 8), 1))

    def build(pw):
        schema = pw.schema_from_types(t=int, x=typing.Optional[float],
                                      y=typing.Optional[float])
        tab = pw.debug.table_from_rows(schema, rows, is_stream=True)
        a = tab.interpolate(tab.t, tab.x, tab.y)
        b = pw.stdlib.statistical.interpolate(
            tab, tab.t, tab.x, mode=pw.stdlib.statistical.InterpolateMode.LINEAR)
        return a.select(a.t, a.x, a.y, bx=b.x)

    assert assert_equal(build)
