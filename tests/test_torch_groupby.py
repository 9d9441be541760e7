"""The port's groupby/reduce, deduplicate, ix, ix_ref and update_cells
against the JAX package's: the same pipeline over the same numpy-seeded
rows runs through ``pathway_tpu`` and ``pathway_tpu_torch``, and the
captured events (key, row, time, diff), the result schema and the
error-log messages must be equal exactly (tolerance: none; floats compare
by their bits).

The port lowers every groupby to ``GroupByOperator``; the JAX package runs
some (count, integral sum/avg, min/max, argmin/argmax over plain columns)
through its ``ColumnarGroupByOperator``. Events are compared sorted by
(time, key, diff), so the two must emit the same events, in any order
within a tick. ``p_columnar_eligible`` is such a groupby.

``JoinOperator`` (``ix`` lowers to it) is also stepped directly on both
sides over the same deltas, in every mode, with the default mixed output
keys (its bilinear delta path) and with left-id keys (the per-group
recompute path ``ix`` takes). The array_sum reducers go through the
device segment sum with ``PATHWAY_ARRAY_SUM_DEVICE_MIN`` lowered on both
sides, and ``device_segsum`` is held bit for bit against the JAX
package's ``_device_segsum_fn``.

The JAX side runs with ``PATHWAY_AUTO_JIT=0`` and
``PATHWAY_DEVICE_INFLIGHT=1`` (see tests/test_torch_table.py).
"""

import math
import typing

import numpy as np
import pytest
import torch

import pathway_tpu as jpw
import pathway_tpu_torch as tpw
from pathway_tpu.engine import operators as jops
from pathway_tpu.internals import error as jerror
from pathway_tpu.internals.runner import GraphRunner as JRunner
from pathway_tpu_torch.engine import operators as tops
from pathway_tpu_torch.internals import error as terror
from pathway_tpu_torch.internals.runner import GraphRunner as TRunner

SIDES = {"jax": (jpw, JRunner, jerror), "torch": (tpw, TRunner, terror)}
N_ROWS = 90


@pytest.fixture(autouse=True)
def _reference_schedule(monkeypatch):
    monkeypatch.setenv("PATHWAY_AUTO_JIT", "0")
    monkeypatch.setenv("PATHWAY_DEVICE_INFLIGHT", "1")


def _data(seed: int = 0) -> list[tuple]:
    """Rows (rid, g, a, x, s, c, o): a row id, a small group key, ints with
    negatives, floats, words, an instance column and an optional int."""
    rng = np.random.default_rng(seed)
    g = rng.integers(0, 5, N_ROWS)
    a = rng.integers(-50, 50, N_ROWS)
    x = rng.random(N_ROWS) * 4 - 2
    c = rng.integers(0, 2, N_ROWS)
    o = rng.integers(0, 9, N_ROWS)
    words = [f"w{int(v)}" for v in rng.permutation(10_000)[:N_ROWS]]
    return [(i, int(g[i]), int(a[i]), float(x[i]), words[i], int(c[i]),
             None if i % 4 == 0 else int(o[i])) for i in range(N_ROWS)]


def _stream(pw):
    """Three ticks: rows 0-44 at time 0, rows 45-89 at time 2; at time 4 a
    third of the rows are retracted and every other retracted row comes
    back with a changed ``a``. Keyed by the row id, so a retraction
    cancels its insertion."""
    schema = pw.schema_from_types(rid=int, g=int, a=int, x=float, s=str,
                                  c=int, o=typing.Optional[int])
    rows = []
    for r in _data():
        rows.append((*r, 0 if r[0] < N_ROWS // 2 else 2, 1))
    for r in _data()[::3]:
        rows.append((*r, 4, -1))
        if r[0] % 2 == 0:
            rows.append((r[0], r[1], r[2] + 7, *r[3:], 4, 1))
    t = pw.debug.table_from_rows(schema, rows, is_stream=True)
    return t.with_id_from(t.rid)


# -- the pipelines: each builds its output table from one package --------

def p_every_reducer(pw):
    t = _stream(pw)
    r = pw.reducers
    return t.groupby(t.g).reduce(
        t.g, n=r.count(), total=r.sum(t.a), mean=r.avg(t.a),
        lo=r.min(t.a), hi=r.max(t.a), amin=r.argmin(t.a), amax=r.argmax(t.a),
        amin_s=r.argmin(t.a, t.s), amax_s=r.argmax(t.a, t.s),
        uniq=r.unique(t.g), some=r.any(t.a), st=r.sorted_tuple(t.a),
        st_o=r.sorted_tuple(t.o, skip_nones=True), tup=r.tuple(t.s),
        nd=r.ndarray(t.a), first=r.earliest(t.s), last=r.latest(t.s))


def p_columnar_eligible(pw):
    t = _stream(pw)
    r = pw.reducers
    return t.groupby(t.g, t.c).reduce(
        t.g, t.c, n=r.count(), total=r.sum(t.a), mean=r.avg(t.a),
        lo=r.min(t.s), hi=r.max(t.a), amin=r.argmin(t.a),
        amax=r.argmax(t.a, t.s))


def p_float_sums(pw):
    t = _stream(pw)
    return t.groupby(t.g).reduce(t.g, fs=pw.reducers.sum(t.x),
                                 fa=pw.reducers.avg(t.x),
                                 mixed=pw.reducers.sum(t.x * t.a))


def p_compound(pw):
    t = _stream(pw)
    r = pw.reducers
    return t.groupby(t.g).reduce(
        key=t.g * 10, spread=r.max(t.a) - r.min(t.a),
        ratio=r.sum(t.a) / r.count(), me=pw.this.id)


def p_stateful(pw):
    t = pw.debug.table_from_rows(
        pw.schema_from_types(g=int, a=int),
        [(r[1], r[2], 2 * (r[0] % 3), 1) for r in _data()], is_stream=True)

    def fold(state, a):
        return (state or 0) * 3 + a

    def fold_many(state, rows):
        return tuple(sorted((state or ()) + tuple(a for (a,) in rows)))

    return t.groupby(t.g).reduce(
        t.g, f=pw.reducers.stateful_single(fold, t.a),
        m=pw.reducers.stateful_many(fold_many, t.a))


def p_groupby_id(pw):
    t = _stream(pw)
    keyed = t.select(t.a, t.s, p=t.pointer_from(t.g))
    return keyed.groupby(id=keyed.p).reduce(
        n=pw.reducers.count(), top=pw.reducers.max(keyed.a))


def p_instance(pw):
    t = _stream(pw)
    return t.groupby(t.g, instance=t.c).reduce(
        t.g, t.c, n=pw.reducers.count(), s=pw.reducers.sorted_tuple(t.s))


def p_reduce_no_keys(pw):
    t = _stream(pw)
    return t.reduce(n=pw.reducers.count(), total=pw.reducers.sum(t.a),
                    words=pw.reducers.sorted_tuple(t.s))


def p_markdown_updates(pw):
    t = pw.debug.table_from_markdown("""
        shop | qty | _time | _diff
        a    | 3   | 2     | 1
        a    | 5   | 2     | 1
        b    | 2   | 2     | 1
        a    | 3   | 4     | -1
        b    | 7   | 4     | 1
        b    | 2   | 6     | -1
        b    | 7   | 6     | -1
        """)
    return t.groupby(t.shop).reduce(t.shop, n=pw.reducers.count(),
                                    total=pw.reducers.sum(t.qty))


def p_dedupe_default(pw):
    t = pw.debug.table_from_markdown("""
        sensor | reading | _time
        a      | 5       | 2
        b      | 1       | 2
        a      | 5       | 4
        a      | 8       | 6
        b      | 1       | 6
        b      | 4       | 8
        """)
    return t.deduplicate(value=t.reading, instance=t.sensor)


def p_dedupe_acceptor(pw):
    t = pw.debug.table_from_rows(
        pw.schema_from_types(g=int, a=int),
        [(r[1], r[2], 2 * (r[0] // 10), 1) for r in _data()], is_stream=True)
    return t.deduplicate(value=t.a, instance=t.g,
                         acceptor=lambda new, old: new > old)


def p_dedupe_raising_acceptor(pw):
    t = pw.debug.table_from_rows(
        pw.schema_from_types(a=int),
        [(r[2], 2 * (r[0] // 30), 1) for r in _data()], is_stream=True)

    def acceptor(new, old):
        if new % 7 == 0:
            raise ValueError("seven")
        return new < old

    return t.deduplicate(value=t.a, acceptor=acceptor)


def _dim(pw):
    """A dimension table keyed by group: one row a group, updated at 4."""
    rows = [(g, f"name{g}", g * 11, 0, 1) for g in range(4)]
    rows += [(2, "name2", 22, 4, -1), (2, "renamed", 99, 4, 1)]
    t = pw.debug.table_from_rows(
        pw.schema_from_types(g=int, name=str, w=int), rows, is_stream=True)
    return t.with_id_from(t.g)


def p_ix_inner(pw):
    t = _stream(pw)
    dim = _dim(pw)
    looked = dim.ix(t.pointer_from(t.g), context=t)
    return looked.select(looked.name, looked.w)


def p_ix_optional_none_key(pw):
    t = _stream(pw)
    dim = _dim(pw)
    key = pw.if_else(t.o.is_none(), None, t.pointer_from(t.g))
    looked = dim.ix(key, optional=True, context=t)
    return looked.select(looked.name, looked.w)


def p_ix_ref(pw):
    t = _stream(pw)
    dim = _dim(pw)
    looked = dim.ix_ref(t.g, optional=True, context=t)
    return looked.select(looked.name, w2=looked.w)


def p_update_cells(pw):
    t = _stream(pw)
    patch = t.filter(t.a > 0).select(s=t.s + "!", a=t.a * 100)
    return t.select(t.a, t.s, t.g).update_cells(patch)


def p_lshift(pw):
    t = _stream(pw)
    patch = t.filter(t.g == 1).select(g=t.g - 100)
    return t.select(t.g, t.x) << patch


PIPELINES = [p_every_reducer, p_columnar_eligible, p_float_sums, p_compound,
             p_stateful, p_groupby_id, p_instance, p_reduce_no_keys,
             p_markdown_updates, p_dedupe_default, p_dedupe_acceptor,
             p_dedupe_raising_acceptor, p_ix_inner, p_ix_optional_none_key,
             p_ix_ref, p_update_cells, p_lshift]


def _norm(v):
    """A package-neutral form of a cell: each package has its own ERROR,
    Json and Pointer classes; floats keep their bits (NaN compares equal)."""
    name = type(v).__name__
    if name == "_ErrorValue":
        return ("ERROR",)
    if name == "Json":
        return ("Json", v.dumps())
    if name == "Pointer":
        return ("Pointer", int(v))
    if isinstance(v, float):
        return ("float", "nan" if math.isnan(v) else v.hex())
    if isinstance(v, (tuple, list)):
        return (type(v).__name__, tuple(_norm(e) for e in v))
    if isinstance(v, np.ndarray):
        return ("ndarray", v.dtype.str, v.shape, v.tobytes())
    if isinstance(v, np.generic):
        return (type(v).__name__, v.tobytes())
    return (type(v).__name__, v)


def _run(side: str, build):
    pw, Runner, error = SIDES[side]
    log = error.global_error_log()
    n_log = len(log.entries)
    out = build(pw)
    runner = Runner()
    cap = runner.capture(out)
    runner.run_batch(n_workers=1)
    events = sorted((time, int(key), diff, tuple(_norm(v) for v in row))
                    for key, row, time, diff in cap.events)
    schema = [(n, repr(d)) for n, d in out.schema._dtypes().items()]
    messages = [e["message"] for e in log.entries[n_log:]]
    return events, schema, messages


@pytest.mark.parametrize("build", PIPELINES, ids=lambda f: f.__name__[2:])
def test_pipeline_events_equal_reference(build):
    jev, jschema, jmsg = _run("jax", build)
    tev, tschema, tmsg = _run("torch", build)
    assert jev, "the pipeline produced no events"
    assert tschema == jschema
    assert tev == jev
    assert tmsg == jmsg


def test_pipelines_retract():
    """The streamed pipelines do exercise retractions and updates."""
    for build in (p_every_reducer, p_markdown_updates, p_ix_inner,
                  p_update_cells):
        events, _, _ = _run("torch", build)
        assert any(diff < 0 for _, _, diff, _ in events), build.__name__


def test_dedupe_acceptor_errors_are_logged():
    _, _, msgs = _run("torch", p_dedupe_raising_acceptor)
    assert msgs and all("deduplicate acceptor raised" in m for m in msgs)


# -- array_sum through the device segment sum -----------------------------

def _arrays(pw):
    """Two ticks of 80 rows of float32 vectors (-0.0 cells included), then
    a tick retracting half of them: every tick holds at least 64 rows
    (the route's row minimum) and is past the lowered
    PATHWAY_ARRAY_SUM_DEVICE_MIN."""
    rng = np.random.default_rng(5)
    vecs = rng.standard_normal((160, 6)).astype(np.float32)
    vecs[::9, 2] = -0.0
    schema = pw.schema_from_types(rid=int, g=int, v=np.ndarray)
    rows = [(i, i % 7, vecs[i], 2 * (i // 80), 1) for i in range(160)]
    rows += [(i, i % 7, vecs[i], 4, -1) for i in range(0, 160, 2)]
    t = pw.debug.table_from_rows(schema, rows, is_stream=True)
    t = t.with_id_from(t.rid)
    return t.groupby(t.g).reduce(t.g, a=pw.reducers.npsum(t.v),
                                 s=pw.reducers.sum(t.v))


def test_array_sum_device_route_equals_reference(monkeypatch):
    monkeypatch.setattr(jops, "_ARRAY_SUM_DEVICE_MIN", 64)
    monkeypatch.setenv("PATHWAY_ARRAY_SUM_DEVICE_MIN", "64")
    monkeypatch.setattr(tops, "_array_sum_device",
                        lambda: torch.device("cpu"))
    calls = {"jax": 0, "torch": 0}
    jfn = jops._device_segsum_fn()

    def jspy(*args):
        calls["jax"] += 1
        return jfn(*args)

    tfn = tops.device_segsum

    def tspy(*args):
        calls["torch"] += 1
        return tfn(*args)

    monkeypatch.setattr(jops, "_device_segsum_fn", lambda: jspy)
    monkeypatch.setattr(tops, "device_segsum", tspy)
    jev, jschema, _ = _run("jax", _arrays)
    tev, tschema, _ = _run("torch", _arrays)
    # two reducers a tick, three ticks, on both sides
    assert calls == {"jax": 6, "torch": 6}
    assert tschema == jschema
    assert tev == jev


@pytest.mark.parametrize("shape", [(1, 1, 4), (3, 17, 6), (8, 64, 384)])
def test_device_segsum_bit_for_bit_with_reference(shape):
    rng = np.random.default_rng(sum(shape))
    padded = rng.standard_normal(shape).astype(np.float32)
    padded[:, -1, ::3] = -0.0  # padding rows are -0.0
    padded[0, 0, 0] = -0.0
    init = rng.standard_normal((shape[0], shape[2])).astype(np.float32)
    init[0, 0] = -0.0
    ref = np.asarray(jops._device_segsum_fn()(padded, init))
    got = tops.device_segsum(torch.from_numpy(padded),
                             torch.from_numpy(init)).numpy()
    assert got.dtype == np.float32
    assert got.tobytes() == ref.tobytes()
    # and it is the sequential host loop
    acc = init.copy()
    for m in range(shape[1]):
        acc = acc + padded[:, m]
    assert got.tobytes() == acc.tobytes()


# -- JoinOperator, stepped directly --------------------------------------

def _join_ticks():
    """Left and right deltas over four ticks: rows (jk, v) keyed by row
    id; inserts, upserts (a retraction and an insertion of one key in one
    tick, in either order), retractions of absent rows, None join keys,
    and keys whose other side empties and fills again."""
    rng = np.random.default_rng(11)
    ticks, live = [], [{}, {}]
    for t in range(4):
        sides = []
        for s in range(2):
            entries = []
            for rid in rng.choice(24, 14, replace=False).tolist():
                cur = live[s].get(rid)
                row = (None if rid % 11 == 0 else int(rng.integers(0, 5)),
                       int(rng.integers(0, 100)))
                if cur is not None and rng.random() < 0.4:
                    entries.append((rid, cur, -1))
                    del live[s][rid]
                elif cur is not None:
                    pair = [(rid, cur, -1), (rid, row, 1)]
                    entries.extend(pair if rng.random() < 0.5 else pair[::-1])
                    live[s][rid] = row
                else:
                    entries.append((rid, row, 1))
                    live[s][rid] = row
            if t == 2 and s == 0:
                entries.append((99, (3, 3), -1))  # absent: a no-op
            sides.append(entries)
        ticks.append(sides)
    return ticks


@pytest.mark.parametrize("left_key", [False, True], ids=["mixed", "left_id"])
@pytest.mark.parametrize("mode", ["inner", "left", "right", "outer"])
def test_join_operator_equals_reference(mode, left_key):
    """Both packages' JoinOperator over the same deltas: the bilinear delta
    path (default output keys) and the per-group recompute path (``ix``'s
    left-id keys), every mode; the output multisets must be equal."""
    from pathway_tpu.engine import delta as jdelta
    from pathway_tpu.internals import keys as jkeys
    from pathway_tpu_torch.engine import delta as tdelta
    from pathway_tpu_torch.internals import keys as tkeys

    def run(ops, delta, keys):
        def jk(key, row):
            return row[0]

        def out(lk, lrow, rk, rrow):
            return (None if lrow is None else lrow[1],
                    None if rrow is None else rrow[1])

        op = ops.JoinOperator(
            mode, jk, jk, out,
            out_key_fn=(lambda lk, rk, jk: lk if lk is not None else rk)
            if left_key else None)
        got = []
        for t, sides in enumerate(_join_ticks()):
            ds = [delta.Delta([(keys.hash_values("row", s, rid), row, d)
                               for rid, row, d in entries])
                  for s, entries in enumerate(sides)]
            # a retraction of a row inserted earlier in the same tick
            # cancels before the operator sees it, as a source delivers
            ds = [d.consolidate() for d in ds]
            acc: dict = {}
            for k, row, d in op.step(t, ds).entries:
                acc[(int(k), row)] = acc.get((int(k), row), 0) + d
            got.append(sorted(((k, r, d) for (k, r), d in acc.items() if d),
                              key=repr))
        return got

    ref = run(jops, jdelta, jkeys)
    got = run(tops, tdelta, tkeys)
    assert any(ref), "the join produced no events"
    assert got == ref
