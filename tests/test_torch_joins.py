"""The port's joins (``Table.join*``, ``pw.join*``, ``JoinResult``) and the
key filters (``restrict``, ``intersect``, ``difference``, ``having``)
against the JAX package's: the same pipeline over the same rows (markdown
tables, or numpy-seeded streams with upserts and retractions) runs through
``pathway_tpu`` and ``pathway_tpu_torch`` under ``run_batch(n_workers=1)``,
and the consolidated events (key, row, time, diff), the result schema and
the error-log messages must be equal exactly (tolerance: none; floats
compare by their bits).

Every case of the JAX package's tests/test_join.py is here (inner, left,
right, outer, ``pw.left`` / ``pw.right``, ``id=``, several conditions,
expressions in the select, incremental retraction, malformed upserts),
with the streamed joins in every mode, both output-key rules (mixed ids,
one side's id) and both projections (the direct one the lowering fuses
into the join, and a select map). Each runs twice in the port: with the
native inner-join pass and with the Python loops (``_FASTJOIN = None``).

The JAX side runs with ``PATHWAY_AUTO_JIT=0`` and
``PATHWAY_DEVICE_INFLIGHT=1`` (see tests/test_torch_table.py).
"""

import typing

import numpy as np
import pytest

import pathway_tpu as jpw
import pathway_tpu_torch as tpw
from pathway_tpu.engine import operators as jops
from pathway_tpu.internals import error as jerror
from pathway_tpu.internals.runner import GraphRunner as JRunner
from pathway_tpu_torch.engine import operators as tops
from pathway_tpu_torch.internals import error as terror
from pathway_tpu_torch.internals.runner import GraphRunner as TRunner
from test_torch_groupby import _norm

SIDES = {"jax": (jpw, JRunner, jerror), "torch": (tpw, TRunner, terror)}
N_ROWS = 60


@pytest.fixture(autouse=True)
def _reference_schedule(monkeypatch):
    monkeypatch.setenv("PATHWAY_AUTO_JIT", "0")
    monkeypatch.setenv("PATHWAY_DEVICE_INFLIGHT", "1")


@pytest.fixture(params=["native", "python"])
def port_pass(request, monkeypatch):
    """The port's inner-join pass: native (asserted built) or the Python
    loops."""
    if request.param == "native":
        assert tops._get_fastjoin() is not None, tops.NATIVE_ERRORS
    else:
        monkeypatch.setattr(tops, "_FASTJOIN", None)
    return request.param


def _run(side: str, build):
    pw, Runner, error = SIDES[side]
    log = error.global_error_log()
    n_log = len(log.entries)
    out = build(pw)
    runner = Runner()
    cap = runner.capture(out)
    runner.run_batch(n_workers=1)
    # an outer join keyed by one side's id keys the other side's ears by
    # None, in both packages
    events = sorted((time, -1 if key is None else int(key), diff,
                     tuple(_norm(v) for v in row))
                    for key, row, time, diff in cap.consolidated_events())
    schema = [(n, repr(d)) for n, d in out.schema._dtypes().items()]
    messages = [e["message"] for e in log.entries[n_log:]]
    return events, schema, messages


def _assert_equal(build):
    jev, jschema, jmsg = _run("jax", build)
    tev, tschema, tmsg = _run("torch", build)
    assert tschema == jschema
    assert tev == jev
    assert tmsg == jmsg
    return tev


# -- the JAX package's tests/test_join.py, case for case -------------------

def _sides(pw):
    t1 = pw.debug.table_from_markdown("""
    k | v
    1 | a
    2 | b
    3 | c
    """)
    t2 = pw.debug.table_from_markdown("""
    k | w
    2 | X
    3 | Y
    4 | Z
    """)
    return t1, t2


def c_inner(pw):
    t1, t2 = _sides(pw)
    return t1.join(t2, t1.k == t2.k).select(t1.v, t2.w)


def c_left(pw):
    t1, t2 = _sides(pw)
    return t1.join_left(t2, t1.k == t2.k).select(t1.v, w=t2.w)


def c_right(pw):
    t1, t2 = _sides(pw)
    return t1.join_right(t2, t1.k == t2.k).select(v=t1.v, w=t2.w)


def c_outer(pw):
    t1, t2 = _sides(pw)
    return t1.join_outer(t2, t1.k == t2.k).select(v=t1.v, w=t2.w)


def c_left_right_this_syntax(pw):
    t1, t2 = _sides(pw)
    return t1.join(t2, pw.left.k == pw.right.k).select(pw.left.v,
                                                       pw.right.w)


def c_join_id_left(pw):
    t1, t2 = _sides(pw)
    return t1.join(t2, t1.k == t2.k, id=t1.id).select(t1.v, t2.w)


def c_join_id_right_outer(pw):
    t1, t2 = _sides(pw)
    return t1.join_outer(t2, t1.k == t2.k, id=t2.id).select(t1.v, t2.w)


def c_multi_condition(pw):
    t1 = pw.debug.table_from_markdown("""
    a | b | v
    1 | 1 | p
    1 | 2 | q
    """)
    t2 = pw.debug.table_from_markdown("""
    a | b | w
    1 | 2 | r
    """)
    return t1.join(t2, t1.a == t2.a, t1.b == t2.b).select(t1.v, t2.w)


def c_expressions_in_select(pw):
    t1, t2 = _sides(pw)
    return t1.join(t2, t1.k == t2.k).select(z=t1.k * 10 + t2.k)


def c_incremental_retraction(pw):
    t1 = pw.debug.table_from_markdown("""
    k | v | _time | _diff
    1 | a | 2     | 1
    1 | a | 6     | -1
    """)
    t2 = pw.debug.table_from_markdown("""
    k | w | _time
    1 | X | 4
    """)
    return t1.join(t2, t1.k == t2.k).select(t1.v, t2.w)


# -- the rest of the join DSL ----------------------------------------------

def c_this_and_ids(pw):
    t1, t2 = _sides(pw)
    return t1.join_left(t2, t1.k == t2.k).select(
        pw.this.v, pw.this.w, lid=t1.id, rid=t2.id)


def c_star_sides(pw):
    t1, t2 = _sides(pw)
    return t1.join(t2, t1.k == t2.k).select(pw.left, pw.right.w)


def c_free_functions(pw):
    t1, t2 = _sides(pw)
    return pw.join_right(t1, t2, t1.k == t2.k).select(t1.v, t2.w)


def c_join_mode_enum(pw):
    t1, t2 = _sides(pw)
    return pw.join(t1, t2, t1.k == t2.k, how=pw.JoinMode.OUTER).select(
        t1.k, t2.w)


def c_join_filter(pw):
    t1, t2 = _sides(pw)
    return t1.join_outer(t2, t1.k == t2.k).filter(pw.this.w != "Y")


def c_join_groupby(pw):
    t1, t2 = _sides(pw)
    return t1.join_outer(t2, t1.k == t2.k).groupby(pw.this.w).reduce(
        pw.this.w, n=pw.reducers.count())


def c_join_reduce(pw):
    t1, t2 = _sides(pw)
    return t1.join(t2, t1.k == t2.k).reduce(n=pw.reducers.count(),
                                            s=pw.reducers.sum(pw.this.k))


def c_instances(pw):
    t1 = pw.debug.table_from_markdown("""
    k | g | v
    1 | 0 | a
    1 | 1 | b
    2 | 0 | c
    """)
    t2 = pw.debug.table_from_markdown("""
    k | g | w
    1 | 0 | X
    1 | 1 | Y
    2 | 1 | Z
    """)
    return t1.join(t2, t1.k == t2.k, left_instance=t1.g,
                   right_instance=t2.g).select(t1.v, t2.w)


def c_bool_int_float_keys(pw):
    """True must not match 1 (hash_values keeps bools apart), 1 matches 1.0
    (they hash alike)."""
    t1 = pw.debug.table_from_rows(
        pw.schema_from_types(k=typing.Any, v=str),
        [(True, "t"), (1, "one"), (2.0, "two"), (3.5, "x")])
    t2 = pw.debug.table_from_rows(
        pw.schema_from_types(k=typing.Any, w=str),
        [(1, "I"), (True, "T"), (2, "II"), (3.5, "X"), (np.int64(1), "N")])
    return t1.join(t2, t1.k == t2.k).select(t1.v, t2.w)


def c_none_keys(pw):
    """None join keys match nothing, and stand as ears in outer modes."""
    schema = pw.schema_from_types(k=typing.Optional[int], v=str)
    t1 = pw.debug.table_from_rows(schema, [(None, "a"), (1, "b"), (None, "c")])
    t2 = pw.debug.table_from_rows(
        pw.schema_from_types(k=typing.Optional[int], w=str),
        [(None, "X"), (1, "Y")])
    return t1.join_outer(t2, t1.k == t2.k).select(t1.v, t2.w)


def c_none_keys_multi(pw):
    schema = pw.schema_from_types(a=typing.Optional[int], b=int, v=str)
    t1 = pw.debug.table_from_rows(schema, [(None, 1, "a"), (1, 1, "b")])
    t2 = pw.debug.table_from_rows(schema, [(None, 1, "X"), (1, 1, "Y")])
    return t1.join_left(t2, t1.a == t2.a, t1.b == t2.b).select(t1.v, w=t2.v)


def c_cross_join_left_id(pw):
    """No condition: every pair (the statistics join's shape)."""
    t1, t2 = _sides(pw)
    return t1.join_left(t2, id=t1.id).select(t1.v, t2.w)


CASES = [c_inner, c_left, c_right, c_outer, c_left_right_this_syntax,
         c_join_id_left, c_join_id_right_outer, c_multi_condition,
         c_expressions_in_select, c_incremental_retraction, c_this_and_ids,
         c_star_sides, c_free_functions, c_join_mode_enum, c_join_filter,
         c_join_groupby, c_join_reduce, c_instances, c_bool_int_float_keys,
         c_none_keys, c_none_keys_multi, c_cross_join_left_id]


@pytest.mark.parametrize("build", CASES, ids=lambda f: f.__name__[2:])
def test_join_equals_reference(build, port_pass):
    events = _assert_equal(build)
    # JoinResult.filter evaluates its condition on the rows of the table
    # the column comes from (the JAX package's _repoint is the identity),
    # whose keys are not the join's: it keeps no row, in both packages
    if build not in (c_incremental_retraction, c_join_filter):
        assert events, "the join produced no events"


def test_join_results_read_as_the_reference_tests_say():
    """The JAX package's own expectations of tests/test_join.py, on the
    port."""
    def rows(build):
        return sorted((tuple(r) for r in _rows_of(build)), key=repr)

    assert rows(c_inner) == [("b", "X"), ("c", "Y")]
    assert rows(c_left) == [("a", None), ("b", "X"), ("c", "Y")]
    assert rows(c_right) == [("b", "X"), ("c", "Y"), (None, "Z")]
    assert len(rows(c_outer)) == 4
    assert rows(c_left_right_this_syntax) == [("b", "X"), ("c", "Y")]
    assert rows(c_join_id_left) == [("b", "X"), ("c", "Y")]
    assert rows(c_multi_condition) == [("q", "r")]
    assert rows(c_expressions_in_select) == [(22,), (33,)]
    assert rows(c_incremental_retraction) == []
    assert rows(c_bool_int_float_keys) == [
        ("one", "I"), ("one", "N"), ("t", "T"), ("two", "II"), ("x", "X")]


def _rows_of(build):
    runner = TRunner()
    cap = runner.capture(build(tpw))
    runner.run_batch(n_workers=1)
    return list(cap.snapshot().values())


def test_join_id_keeps_the_side_universe():
    t1, t2 = _sides(tpw)
    by_left = t1.join(t2, t1.k == t2.k, id=t1.id).select(t1.v)
    assert by_left._universe is t1._universe
    by_right = t1.join(t2, t1.k == t2.k, id=t2.id).select(t2.w)
    assert by_right._universe is t2._universe
    mixed = t1.join(t2, t1.k == t2.k).select(t1.v)
    assert mixed._universe not in (t1._universe, t2._universe)


def test_bad_conditions_raise_as_the_reference():
    for pw in (jpw, tpw):
        t1, t2 = _sides(pw)
        with pytest.raises(ValueError, match="left col"):
            t1.join(t2, t1.k > t2.k)
        with pytest.raises(KeyError, match="both sides"):
            t1.join(t2, t1.k == t2.k).select(pw.this.k)


# -- streamed joins: upserts and retractions, every mode -------------------

def _stream(pw, side: int, seed: int):
    """Rows (rid, k, v) keyed by rid over four ticks: inserts, upserts (a
    retraction and an insertion of one rid in one tick), retractions and
    None join keys."""
    rng = np.random.default_rng(seed)
    live, rows = {}, []
    for t in range(4):
        for rid in rng.choice(N_ROWS, N_ROWS // 2, replace=False).tolist():
            cur = live.get(rid)
            new = (None if rid % 13 == 0 else int(rng.integers(0, 8)),
                   int(rng.integers(-50, 50)))
            if cur is not None:
                rows.append((rid, *cur, 2 * t, -1))
                if rng.random() < 0.3:
                    del live[rid]
                    continue
            rows.append((rid, *new, 2 * t, 1))
            live[rid] = new
    schema = pw.schema_from_types(rid=int, k=typing.Optional[int], v=int)
    tab = pw.debug.table_from_rows(schema, rows, is_stream=True)
    return tab.with_id_from(tab.rid, instance=side)


def _streamed(mode: str, idkey: str, projection: str):
    def build(pw):
        a, b = _stream(pw, 0, 1), _stream(pw, 1, 2)
        kw = {"id": a.id} if idkey == "left" else \
            {"id": b.id} if idkey == "right" else {}
        jr = a.join(b, a.k == b.k, how=mode, **kw)
        if projection == "direct":
            return jr.select(a.rid, a.v, w=b.v, lid=a.id, rid2=b.id)
        return jr.select(s=pw.coalesce(a.v, 0) + pw.coalesce(b.v, 0),
                         k=pw.coalesce(a.k, b.k))
    return build


STREAMED = [(m, i, p) for m in ("inner", "left", "right", "outer")
            for i, p in (("mixed", "direct"), ("mixed", "map"),
                         ("left", "direct"), ("right", "map"))]


@pytest.mark.parametrize("mode,idkey,projection", STREAMED,
                         ids=["-".join(c) for c in STREAMED])
def test_streamed_join_equals_reference(mode, idkey, projection, port_pass):
    events = _assert_equal(_streamed(mode, idkey, projection))
    assert any(d < 0 for _, _, d, _ in events)


def test_direct_projection_fuses_the_select(port_pass):
    """A select of plain columns and ids is the join's own output (no map
    node after it, as in the JAX package); the inner bilinear join goes
    through the native pass when it is built."""
    graphs = {}
    for side in SIDES:
        pw, Runner, _ = SIDES[side]
        runner = Runner()
        runner.capture(_streamed("inner", "mixed", "direct")(pw))
        runner.run_batch(n_workers=1)
        graphs[side] = runner.graph.nodes
    types = {s: [type(n.op).__name__ for n in g] for s, g in graphs.items()}
    assert types["torch"] == types["jax"]
    assert types["torch"].count("MapOperator") == 0
    node = next(n for n in graphs["torch"]
                if isinstance(n.op, tops.JoinOperator))
    assert node.name.startswith("join_select:")
    join = node.op
    assert join.out_spec is not None and join._bilinear
    assert (join.native_steps > 0) == (port_pass == "native")


# -- restrict / intersect / difference / having ----------------------------

def _keyed(pw, seed: int, n: int = 40):
    rng = np.random.default_rng(seed)
    rows = []
    for rid in range(n):
        t = 2 * int(rng.integers(0, 3))
        rows.append((rid, int(rng.integers(0, 100)), t, 1))
        if rng.random() < 0.3:
            rows.append((rid, rows[-1][1], t + 3, -1))
    tab = pw.debug.table_from_rows(pw.schema_from_types(rid=int, x=int),
                                   rows, is_stream=True)
    return tab.with_id_from(tab.rid)


def s_restrict(pw):
    a = _keyed(pw, 3)
    b = _keyed(pw, 4).filter(pw.this.x > 30)
    return a.restrict(b)


def s_intersect(pw):
    a = _keyed(pw, 3)
    return a.intersect(_keyed(pw, 4).filter(pw.this.x > 20),
                       _keyed(pw, 5).filter(pw.this.x < 80))


def s_difference(pw):
    return _keyed(pw, 3).difference(_keyed(pw, 4).filter(pw.this.x > 50))


def s_having(pw):
    a = _keyed(pw, 3)
    refs = _keyed(pw, 6).select(p=a.pointer_from(pw.this.x % 40))
    return a.having(refs.p)


def s_restrict_then_join(pw):
    a = _keyed(pw, 3)
    b = _keyed(pw, 4).filter(pw.this.x > 30)
    r = a.restrict(b)
    return r.join(b, r.id == b.id).select(r.x, y=b.x)


SETOPS = [s_restrict, s_intersect, s_difference, s_having,
          s_restrict_then_join]


@pytest.mark.parametrize("build", SETOPS, ids=lambda f: f.__name__[2:])
def test_key_filter_equals_reference(build, port_pass):
    events = _assert_equal(build)
    assert events and any(d < 0 for _, _, d, _ in events)


# -- malformed upserts, JoinOperator stepped directly ----------------------

def _malformed_ticks(rng):
    from pathway_tpu_torch.internals.keys import Pointer

    keys = [Pointer(i) for i in range(6)]
    seq = []
    for _tick in range(6):
        dl = [(keys[int(rng.integers(6))],
               (f"j{int(rng.integers(3))}", f"l{int(rng.integers(4))}"),
               int(rng.choice((1, 1, -1))))
              for _ in range(int(rng.integers(4)))]
        dr = [(keys[int(rng.integers(6))],
               (f"j{int(rng.integers(3))}", f"r{int(rng.integers(4))}"),
               int(rng.choice((1, 1, -1))))
              for _ in range(int(rng.integers(4)))]
        seq.append((dl, dr))
    return seq


@pytest.mark.parametrize("mode", ["inner", "left", "right", "outer"])
def test_bilinear_join_matches_recompute_on_malformed_upserts(mode):
    """The JAX package's test of the same name, on both packages: streams
    that break the retract-then-insert contract (an insert over a live
    key is an upsert, a duplicate insert a no-op, a retraction of an
    absent row emits nothing). The port's bilinear path (native for
    inner, and the Python loops) equals its recompute path and the JAX
    package's, in the consolidated output."""
    from pathway_tpu.engine.delta import Delta as JDelta
    from pathway_tpu.internals.keys import Pointer as JPointer
    from pathway_tpu_torch.engine.delta import Delta as TDelta
    from pathway_tpu_torch.engine.delta import row_fingerprint

    def run(ops, delta, pointer, seq, bilinear, native=True):
        op = ops.JoinOperator(
            mode, lambda k, r: r[0], lambda k, r: r[0],
            lambda lk, lr, rk, rr: ((lr or (None, None))[1],
                                    (rr or (None, None))[1]))
        op._bilinear = bilinear
        acc: dict = {}
        for dl, dr in seq:
            out = op.step(0, [delta([(pointer(int(k)), r, d)
                                     for k, r, d in dl]),
                              delta([(pointer(int(k)), r, d)
                                     for k, r, d in dr])])
            for k, row, d in out.entries:
                fp = (int(k), row_fingerprint(row))
                acc[fp] = acc.get(fp, 0) + d
        return {k: v for k, v in acc.items() if v}

    rng = np.random.default_rng(7)
    from pathway_tpu_torch.internals.keys import Pointer as TPointer

    for trial in range(20):
        seq = _malformed_ticks(rng)
        ref = run(jops, JDelta, JPointer, seq, True)
        assert ref == run(jops, JDelta, JPointer, seq, False)
        fast = run(tops, TDelta, TPointer, seq, True)
        slow = run(tops, TDelta, TPointer, seq, False)
        assert fast == slow == ref, (mode, trial)
    if mode == "inner":
        saved = tops._FASTJOIN
        try:
            tops._FASTJOIN = None
            for trial in range(20):
                seq = _malformed_ticks(rng)
                assert run(tops, TDelta, TPointer, seq, True) == \
                    run(jops, JDelta, JPointer, seq, True)
        finally:
            tops._FASTJOIN = saved
