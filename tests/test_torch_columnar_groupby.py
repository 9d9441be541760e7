"""The port's ``ColumnarGroupByOperator`` and the lowering's choice of it
(``internals/runner.py::_columnar_groupby_spec``) against the JAX
package's, exactly.

The choice: over a grid of reducers (count, sum, avg, min, max, argmin,
argmax, tuple, sorted_tuple) and group-column dtypes, each package lowers
the same groupby; the port must build ``ColumnarGroupByOperator`` on
exactly the graphs where the JAX package does, with the same positions,
and the consolidated events (key, row, time, diff) must be equal.

The operator: sums that cross ``_INT_GUARD`` (2^62) and come back under it
through retractions, and cells past int64, equal the JAX package's exact
Python-int results and a plain Python sum, with the native passes and
with the Python loops; group values of one dtype in several Python types
(int and np.int64) alias as ``hash_values`` says. The JAX side runs with
``PATHWAY_AUTO_JIT=0`` and ``PATHWAY_DEVICE_INFLIGHT=1``.
"""

import typing

import numpy as np
import pytest

import pathway_tpu as jpw
import pathway_tpu_torch as tpw
from pathway_tpu.engine import operators as jops
from pathway_tpu.internals.runner import GraphRunner as JRunner
from pathway_tpu_torch.engine import operators as tops
from pathway_tpu_torch.internals.runner import GraphRunner as TRunner
from test_torch_groupby import _norm

SIDES = {"jax": (jpw, JRunner, jops), "torch": (tpw, TRunner, tops)}
N_ROWS = 48


@pytest.fixture(autouse=True)
def _reference_schedule(monkeypatch):
    monkeypatch.setenv("PATHWAY_AUTO_JIT", "0")
    monkeypatch.setenv("PATHWAY_DEVICE_INFLIGHT", "1")


def _run(side: str, build, native: bool = True):
    """(consolidated events, the groupby operator) of ``build(pw)``."""
    pw, Runner, ops = SIDES[side]
    with pytest.MonkeyPatch.context() as m:
        if not native:
            m.setattr(ops, "_FASTJOIN", None)
            m.setattr(ops, "_FASTGROUP", None)
        runner = Runner()
        cap = runner.capture(build(pw))
        runner.run_batch(n_workers=1)
    events = sorted((time, int(key), diff, tuple(_norm(v) for v in row))
                    for key, row, time, diff in cap.consolidated_events())
    group_ops = [n.op for n in runner.graph.nodes
                 if type(n.op).__name__.endswith("GroupByOperator")]
    assert len(group_ops) == 1
    return events, group_ops[0]


# -- the lowering's choice -------------------------------------------------

GROUPS = ("int", "str", "float", "bool", "optional_int", "json", "any")


def _grid_table(pw):
    rng = np.random.default_rng(11)
    rows = []
    for rid in range(N_ROWS):
        g = int(rng.integers(0, 4))
        row = (rid, g, f"s{g}", g / 2, bool(g % 2),
               None if g == 3 else g, pw.Json({"g": g}),
               (g, "x") if g % 2 else f"any{g}",
               int(rng.integers(-20, 20)), float(rng.random()))
        t = 2 * int(rng.integers(0, 3))
        rows.append((*row, t, 1))
        if rid % 5 == 0:
            rows.append((*row, t + 1, -1))
    schema = pw.schema_from_types(
        rid=int, g_int=int, g_str=str, g_float=float, g_bool=bool,
        g_optional_int=typing.Optional[int], g_json=pw.Json,
        g_any=typing.Any, a=int, x=float)
    t = pw.debug.table_from_rows(schema, rows, is_stream=True)
    return t.with_id_from(t.rid)


REDUCERS = ["count", "sum_int", "sum_float", "avg_int", "min_int",
            "max_str", "argmin_int", "argmax_int_payload", "tuple",
            "sorted_tuple"]


def _reducer(pw, t, name):
    r = pw.reducers
    return {
        "count": lambda: r.count(),
        "sum_int": lambda: r.sum(t.a),
        "sum_float": lambda: r.sum(t.x),
        "avg_int": lambda: r.avg(t.a),
        "min_int": lambda: r.min(t.a),
        "max_str": lambda: r.max(t.g_str),
        "argmin_int": lambda: r.argmin(t.a),
        "argmax_int_payload": lambda: r.argmax(t.a, t.g_str),
        "tuple": lambda: r.tuple(t.a),
        "sorted_tuple": lambda: r.sorted_tuple(t.a),
    }[name]()


def _grid(group: str, reducer: str):
    def build(pw):
        t = _grid_table(pw)
        g = t[f"g_{group}"]
        return t.groupby(g).reduce(g, n=pw.reducers.count(),
                                   v=_reducer(pw, t, reducer))
    return build


GRID = [(g, r) for g in GROUPS for r in REDUCERS]


@pytest.mark.parametrize("group,reducer", GRID,
                         ids=[f"{g}-{r}" for g, r in GRID])
def test_columnar_choice_equals_reference(group, reducer):
    jev, jop = _run("jax", _grid(group, reducer))
    tev, top = _run("torch", _grid(group, reducer))
    assert type(top).__name__ == type(jop).__name__
    if isinstance(top, tops.ColumnarGroupByOperator):
        assert (top.gval_pos, top.reducer_cols) == \
            (jop.gval_pos, jop.reducer_cols)
        assert top.native_steps > 0
    assert tev and tev == jev


def test_the_grid_takes_both_operators():
    """Eligible: hashable scalar group dtypes with count, integral sums
    and averages, min/max/argmin/argmax; the row operator for float sums,
    tuples, and Json or Any group values."""
    chosen = {}
    for group, reducer in GRID:
        runner = TRunner()
        runner.capture(_grid(group, reducer)(tpw))
        chosen[group, reducer] = any(
            isinstance(n.op, tops.ColumnarGroupByOperator)
            for n in runner.graph.nodes)
    assert chosen["int", "sum_int"] and chosen["str", "argmax_int_payload"]
    assert chosen["optional_int", "avg_int"] and chosen["bool", "max_str"]
    assert not chosen["int", "sum_float"] and not chosen["str", "tuple"]
    assert not chosen["int", "sorted_tuple"]
    assert not any(chosen["json", r] or chosen["any", r] for r in REDUCERS)


@pytest.mark.parametrize("case", ["two_columns", "instance", "by_id",
                                  "expression_key", "reduce_no_keys"])
def test_columnar_choice_other_shapes(case):
    """Two group columns and an instance (columnar), a groupby by id and a
    computed group key (the row operator), and reduce() without keys
    (columnar: no group value to intern)."""
    def build(pw):
        t = _grid_table(pw)
        r = pw.reducers
        if case == "two_columns":
            return t.groupby(t.g_int, t.g_str).reduce(
                t.g_int, t.g_str, s=r.sum(t.a), hi=r.max(t.a))
        if case == "instance":
            return t.groupby(t.g_str, instance=t.g_bool).reduce(
                t.g_str, n=r.count())
        if case == "by_id":
            k = t.select(t.a, p=t.pointer_from(t.g_int))
            return k.groupby(id=k.p).reduce(s=r.sum(k.a))
        if case == "expression_key":
            return t.groupby(t.g_int * 2).reduce(n=r.count())
        return t.reduce(n=r.count(), s=r.sum(t.a))

    jev, jop = _run("jax", build)
    tev, top = _run("torch", build)
    assert type(top).__name__ == type(jop).__name__
    columnar = case in ("two_columns", "instance", "reduce_no_keys")
    assert isinstance(top, tops.ColumnarGroupByOperator) == columnar
    assert tev and tev == jev


# -- the operator ----------------------------------------------------------

GUARD = 1 << 62


def _guard_rows():
    """Per group, (value, time, diff): ticks that push a sum past 2^62 (one
    big row, then many rows at once), cells past int64, and retractions
    that bring each total back under the guard, then to small values."""
    big = GUARD // 2 + 12345
    rows = []
    # group 0: crosses on a single-row tick, comes back by retraction
    rows += [(0, big, 0, 1), (0, big, 2, 1), (0, 7, 2, 1), (0, big, 4, -1)]
    # group 1: many rows in one tick (the tick bound sends it the exact
    # way), then retractions back to a small total
    rows += [(1, big // 3 + i, 0, 1) for i in range(7)]
    rows += [(1, big // 3 + i, 6, -1) for i in range(6)]
    # group 2: small sums only, beside the big groups
    rows += [(2, i, t, 1) for t in (0, 2, 4) for i in range(3)]
    # group 3: a cell past int64 (python ints only), then gone again
    rows += [(3, 1 << 70, 2, 1), (3, 5, 2, 1), (3, 1 << 70, 6, -1)]
    # group 0 again: negative totals past the guard
    rows += [(0, -big, 8, 1), (0, -big, 8, 1), (0, -big, 8, 1),
             (0, -big, 10, -1)]
    return rows


def _guard(pw):
    rows = [(rid, g, v, t, d) for rid, (g, v, t, d) in enumerate(_guard_rows())]
    # a retraction cancels the insertion of the same (g, v): key by both
    keyed = {}
    out = []
    for rid, g, v, t, d in rows:
        key = keyed.setdefault((g, v), rid) if d > 0 else keyed[(g, v)]
        out.append((key, g, v, t, d))
    t = pw.debug.table_from_rows(pw.schema_from_types(rid=int, g=int, v=int),
                                 out, is_stream=True)
    t = t.with_id_from(t.rid, t.v, t.g)
    return t.groupby(t.g).reduce(t.g, s=pw.reducers.sum(t.v),
                                 m=pw.reducers.avg(t.v),
                                 n=pw.reducers.count())


def _plain_totals():
    """Each group's final sum, from Python ints."""
    live: dict = {}
    for g, v, _t, d in _guard_rows():
        live[(g, v)] = live.get((g, v), 0) + d
    totals: dict = {}
    for (g, v), c in live.items():
        if c:
            totals[g] = totals.get(g, 0) + c * v
    return totals


@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
def test_int_guard_crossing_equals_reference(native):
    jev, jop = _run("jax", _guard)
    tev, top = _run("torch", _guard, native)
    assert isinstance(top, tops.ColumnarGroupByOperator)
    assert isinstance(jop, jops.ColumnarGroupByOperator)
    assert (top.native_steps > 0) == native
    assert tev == jev
    # the sums left int64's guard range, and the final ones are exact
    assert top._big
    final = {}
    for _t, _k, d, row in tev:
        if d > 0:
            final[row[0][1]] = row[1][1]
        elif final.get(row[0][1]) == row[1][1]:
            del final[row[0][1]]
    assert final == _plain_totals()
    assert any(abs(v) >= GUARD for _t, _k, _d, row in tev
               for v in [row[1][1]])


def test_group_values_alias_as_their_hash():
    """One int column holding int and np.int64 cells: a single group per
    value (the typed intern keys alias through hash_values), as the JAX
    package groups them."""
    def build(pw):
        rows = [(i, (np.int64(i % 3) if i % 2 else i % 3), i, 2 * (i % 4), 1)
                for i in range(30)]
        t = pw.debug.table_from_rows(
            pw.schema_from_types(rid=int, g=int, a=int), rows,
            is_stream=True).with_id_from(pw.this.rid)
        return t.groupby(t.g).reduce(t.g, s=pw.reducers.sum(t.a),
                                     lo=pw.reducers.min(t.a))

    jev, _ = _run("jax", build)
    for native in (True, False):
        tev, top = _run("torch", build, native)
        assert isinstance(top, tops.ColumnarGroupByOperator)
        assert len(top._gkeys) == 3
        assert tev == jev


def test_snapshots_are_not_ported():
    op = tops.ColumnarGroupByOperator([0], [("count", None)])
    with pytest.raises(NotImplementedError, match="item 6a"):
        op.snapshot_state()
    with pytest.raises(NotImplementedError, match="item 6a"):
        op.restore_state({})
