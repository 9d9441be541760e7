"""Sharded execution in the port (engine/graph.py ``Scheduler`` with
``n_workers > 1``) against the JAX package's.

Each test builds the same graph in both packages from the same inputs and
holds the port at n workers against the JAX package at n workers and
against the port at one worker: consolidated streams (time, key, diff and
row) and snapshots, keys included, exactly. Where the JAX package's own
sharded tests check that the work is partitioned, the port's replicas
must hold the same per-worker state: rows land on the same worker in both
packages (``int(key) % n`` for keys, ``hash_values(v) % n`` for routing
values, ``canonical_shard_value`` for columnar group values).

Also here: replicas share device objects (an embedder, its parameters,
an index) by identity; the external index at n workers (one shared
index, replica 0 its only writer, several replicas answering); a gather
operator; the worker thread pool (``PATHWAY_WORKER_THREADS=1``);
``exchange_rounds_per_tick``; ``pw.run`` under ``PATHWAY_THREADS``; and
the multi-process cluster still raising (ROADMAP queue 1, item 6f).

The JAX side runs with ``PATHWAY_AUTO_JIT=0`` and
``PATHWAY_DEVICE_INFLIGHT=1`` (see tests/test_torch_table.py).
"""

import random
import threading

import numpy as np
import pytest
import torch

import pathway_tpu as jpw
import pathway_tpu_torch as tpw
from pathway_tpu.engine import operators as jops
from pathway_tpu.internals.parse_graph import G as JG
from pathway_tpu.internals.runner import GraphRunner as JRunner
from pathway_tpu_torch.engine import operators as tops
from pathway_tpu_torch.engine.graph import EngineGraph, Scheduler
from pathway_tpu_torch.internals.parse_graph import G as TG
from pathway_tpu_torch.internals.runner import GraphRunner as TRunner
from test_torch_groupby import PIPELINES, _norm

SIDES = {"jax": (jpw, JRunner, JG, jops), "torch": (tpw, TRunner, TG, tops)}
N_WORKERS = 8


@pytest.fixture(autouse=True)
def _reference_schedule(monkeypatch):
    monkeypatch.setenv("PATHWAY_AUTO_JIT", "0")
    monkeypatch.setenv("PATHWAY_DEVICE_INFLIGHT", "1")
    monkeypatch.delenv("PATHWAY_THREADS", raising=False)
    monkeypatch.delenv("PATHWAY_WORKER_THREADS", raising=False)
    monkeypatch.delenv("PATHWAY_PROCESSES", raising=False)


def run_side(side: str, build, n_workers: int):
    """Run ``build(pw)``'s tables (a table or a list of them) under
    ``run_batch(n_workers)``: per table its consolidated events and its
    snapshot in a package-neutral form, and the runner."""
    pw, Runner, G, _ops = SIDES[side]
    G.clear()
    try:
        out = build(pw)
        tables = out if isinstance(out, list) else [out]
        runner = Runner()
        caps = [runner.capture(t) for t in tables]
        runner.run_batch(n_workers=n_workers)
    finally:
        G.clear()
    streams = [sorted((t, int(k), d, tuple(_norm(v) for v in row))
                      for k, row, t, d in c.consolidated_events())
               for c in caps]
    snaps = [{int(k): tuple(_norm(v) for v in row)
              for k, row in c.snapshot().items()} for c in caps]
    return streams, snaps, runner


def assert_sharded_equal(build, n: int = N_WORKERS, jax_n: int | None = None):
    """The port at n workers = the JAX package at ``jax_n`` (default n) =
    the port at 1; returns the port's n-worker run."""
    jstreams, jsnaps, _ = run_side("jax", build, jax_n or n)
    tstreams, tsnaps, runner = run_side("torch", build, n)
    t1streams, t1snaps, _ = run_side("torch", build, 1)
    assert any(jstreams), "the graph produced no events"
    assert tstreams == jstreams
    assert tsnaps == jsnaps
    assert tstreams == t1streams
    assert tsnaps == t1snaps
    return tstreams, runner


def replicas_of(runner, cls) -> list:
    sched = runner._scheduler
    node = next(n for n in runner.graph.nodes if type(n.op) is cls)
    return sched._replicas[node.id]


# -- tests/test_sharded.py's cases -----------------------------------------

def _pipeline(pw):
    """groupby + join + filter over an update stream with retractions."""
    T = pw.debug.table_from_markdown
    sales = T("""
    shop | item | qty | _time | _diff
    s0   | a    | 3   | 2     | 1
    s1   | a    | 1   | 2     | 1
    s2   | b    | 2   | 2     | 1
    s3   | b    | 5   | 4     | 1
    s4   | c    | 7   | 4     | 1
    s0   | a    | 3   | 6     | -1
    s5   | a    | 9   | 6     | 1
    s6   | d    | 2   | 6     | 1
    s7   | c    | 1   | 8     | 1
    """)
    info = T("""
    item | price
    a    | 10
    b    | 20
    c    | 30
    d    | 40
    e    | 50
    """)
    totals = sales.groupby(sales.item).reduce(
        sales.item, total_qty=pw.reducers.sum(sales.qty),
        n=pw.reducers.count())
    joined = totals.join(info, totals.item == info.item).select(
        totals.item, totals.total_qty, info.price,
        revenue=totals.total_qty * info.price)
    big = joined.filter(joined.revenue >= 60)
    return [sales, totals, joined, big]


def test_groupby_join_identical_across_workers():
    streams, runner = assert_sharded_equal(_pipeline)
    assert runner._scheduler.n_workers == N_WORKERS
    assert any(d < 0 for s in streams for _, _, d, _ in s)


def _partitioned(pw):
    rows = "\n".join(f"u{i} | g{i % 16} | {i}" for i in range(64))
    t = pw.debug.table_from_markdown("user | grp | x\n" + rows)
    totals = t.groupby(t.grp).reduce(t.grp, s=pw.reducers.sum(t.x))
    return totals.join(t, totals.grp == t.grp).select(t.user, totals.s)


def _worker_state(runner, ops) -> tuple[list, list]:
    """Per worker: the live group keys of the columnar groupby, and the
    left row keys the join holds."""
    greps = replicas_of(runner, ops.ColumnarGroupByOperator)
    jreps = replicas_of(runner, ops.JoinOperator)
    groups = [sorted(int(gk) for gk, code in rep._by_gkey.items()
                     if rep._cnt[code] > 0) for rep in greps]
    lefts = [sorted(int(k) for g in rep.left.values() for k in g)
             for rep in jreps]
    return groups, lefts


def test_work_is_actually_partitioned():
    _, runner = assert_sharded_equal(_partitioned)
    _, _, jrunner = run_side("jax", _partitioned, N_WORKERS)
    sched = runner._scheduler
    # every stateful operator has one replica a worker
    for node in runner.graph.nodes:
        assert len(sched._replicas[node.id]) == N_WORKERS, node
    groups, lefts = _worker_state(runner, tops)
    assert (groups, lefts) == _worker_state(jrunner, jops)
    assert sum(1 for g in groups if g) >= 2, "groupby state not partitioned"
    flat = [g for per in groups for g in per]
    assert len(flat) == len(set(flat)) == 16, "shards overlap"
    assert sum(1 for k in lefts if k) >= 2, "join state not partitioned"
    flat = [k for per in lefts for k in per]
    assert len(flat) == len(set(flat))


def test_source_rows_partitioned_across_workers():
    def build(pw):
        rows = "\n".join(f"k{i} | {i}" for i in range(32))
        t = pw.debug.table_from_markdown("k | x\n" + rows)
        return t.select(t.k, y=t.x + 1)

    streams, runner = assert_sharded_equal(build)
    assert len(streams[0]) == 32
    sched = runner._scheduler
    src = next(n for n in runner.graph.nodes
               if type(n.op) is tops.SourceOperator)
    assert len(sched._replicas[src.id]) == N_WORKERS
    outs = sched._replicas[runner.graph.nodes[-1].id]
    assert len(outs) == N_WORKERS


def test_outer_join_with_nulls_sharded():
    def build(pw):
        T = pw.debug.table_from_markdown
        left = T("""
        k  | v
        a  | 1
        b  | 2
        c  |
        """)
        right = T("""
        k  | w
        b  | 20
        d  | 40
        """)
        return left.join_outer(right, left.k == right.k).select(
            lk=left.k, rk=right.k, v=left.v, w=right.w)

    assert_sharded_equal(build)


_SENSORS = """
    sensor | v | at | _time
    a      | 1 | 0  | 2
    b      | 2 | 1  | 2
    a      | 3 | 4  | 4
    b      | 4 | 5  | 4
    a      | 5 | 9  | 6
    b      | 6 | 12 | 8
    """


def test_windowed_aggregation_sharded():
    def build(pw):
        t = pw.debug.table_from_markdown(_SENSORS)
        return pw.temporal.windowby(
            t, t.at, window=pw.temporal.tumbling(4), instance=t.sensor,
        ).reduce(sensor=pw.this._pw_instance,
                 start=pw.this._pw_window_start,
                 s=pw.reducers.sum(pw.this.v))

    assert_sharded_equal(build)


def test_windowby_delay_behavior_sharded():
    """The buffered release rides one watermark shared by every worker:
    the per-tick stream, not only the final state, equals n=1."""
    def build(pw):
        t = pw.debug.table_from_markdown("""
        sensor | v | at | _time
        a      | 1 | 0  | 2
        b      | 2 | 1  | 2
        a      | 3 | 6  | 4
        b      | 4 | 7  | 4
        a      | 5 | 13 | 6
        """)
        return pw.temporal.windowby(
            t, t.at, window=pw.temporal.tumbling(4), instance=t.sensor,
            behavior=pw.temporal.common_behavior(delay=4),
        ).reduce(sensor=pw.this._pw_instance,
                 start=pw.this._pw_window_start,
                 s=pw.reducers.sum(pw.this.v))

    _, runner = assert_sharded_equal(build)
    from pathway_tpu_torch.engine.temporal_ops import _WatermarkOp

    sched = runner._scheduler
    for node in runner.graph.nodes:
        if isinstance(node.op, _WatermarkOp):
            reps = sched._replicas[node.id]
            assert len(reps) == N_WORKERS
            assert all(r._wm_box is reps[0]._wm_box for r in reps)
            assert reps[0].watermark == 13


@pytest.mark.parametrize("behavior", ["forget", "freeze"])
def test_watermark_behaviors_sharded(behavior):
    """Cutoff behaviors (forget, and freeze with keep_results) over the
    shared watermark: late rows are dropped on every worker alike."""
    def build(pw):
        t = pw.debug.table_from_markdown("""
        sensor | v | at | _time
        a      | 1 | 0  | 2
        b      | 2 | 1  | 2
        a      | 3 | 9  | 4
        b      | 4 | 2  | 6
        a      | 5 | 14 | 6
        b      | 6 | 3  | 8
        a      | 7 | 20 | 8
        """)
        kw = ({"cutoff": 4, "keep_results": False}
              if behavior == "forget" else {"cutoff": 4})
        return pw.temporal.windowby(
            t, t.at, window=pw.temporal.tumbling(4), instance=t.sensor,
            behavior=pw.temporal.common_behavior(**kw),
        ).reduce(sensor=pw.this._pw_instance,
                 start=pw.this._pw_window_start,
                 s=pw.reducers.sum(pw.this.v))

    assert_sharded_equal(build)


def test_concat_and_distinct_universes_sharded():
    def build(pw):
        T = pw.debug.table_from_markdown
        a = T("""
        k | x
        p | 1
        q | 2
        """)
        b = T("""
        k | x
        r | 3
        s | 4
        """)
        return [a.concat_reindex(b), a.update_rows(b)]

    assert_sharded_equal(build)


def test_order_sensitive_ops_identical_across_workers():
    """Deduplicate acceptance, earliest / latest and sort use a canonical
    order within a tick, so the exchange's partitioning cannot change
    them."""
    def build(pw):
        rows = "\n".join(f"r{i} | g{i % 3} | {i} | {2 * (1 + i // 6)}"
                         for i in range(16))
        t = pw.debug.table_from_markdown("r | g | x | _time\n" + rows)
        ded = t.deduplicate(value=t.x, acceptor=lambda new, old: new > old)
        ded_inst = t.deduplicate(value=t.x, instance=t.g,
                                 acceptor=lambda new, old: new > old)
        el = t.groupby(t.g).reduce(
            t.g, e=pw.reducers.earliest(t.x), l=pw.reducers.latest(t.x))
        # no instance: the JAX package's _lower_sort raises on one
        # (it tests the instance expression for truth)
        srt = t.sort(key=t.x)
        return [ded, ded_inst, el, srt]

    assert_sharded_equal(build)


@pytest.mark.parametrize("mode", ["join", "join_left", "join_outer"])
def test_no_phantom_events_for_netzero_pairs_sharded(mode):
    """A projection-collapsed net-zero pair surfaces no phantom delete +
    insert events from a sharded join."""
    def build(pw):
        T = pw.debug.table_from_markdown
        t = T("""
        k | keep | drop | _time | _diff
        a | 1    | 10   | 2     | 1
        a | 1    | 10   | 4     | -1
        a | 1    | 11   | 4     | 1
        """)
        proj = t.select(t.k, t.keep)
        lex = T("""
        k | cat
        a | x
        """)
        return getattr(proj, mode)(lex, proj.k == lex.k).select(
            proj.keep, lex.cat)

    assert_sharded_equal(build)


@pytest.mark.parametrize("jax_n", [1, N_WORKERS])
def test_chained_joins_insert_and_delete_match_in_one_tick(jax_n):
    """t1 ⋈ t2 ⋈ t3, where one tick inserts a row into t1 and deletes its
    match from t2: the first join emits +X and -X under one key, and the
    second join must net them to nothing at every worker count (no
    phantom (X, t3) row that never retracts)."""
    def build(pw):
        T = pw.debug.table_from_markdown
        t1 = T("""
        a | x | _time | _diff
        1 | 5 | 2     | 1
        2 | 6 | 2     | 1
        """)
        t2 = T("""
        a | b | _time | _diff
        1 | 7 | 0     | 1
        2 | 8 | 0     | 1
        1 | 7 | 2     | -1
        """)
        t3 = T("""
        b | z
        7 | 70
        8 | 80
        """)
        j1 = t1.join(t2, t1.a == t2.a).select(t1.x, t2.b)
        j2 = j1.join(t3, j1.b == t3.b).select(j1.x, t3.z)
        return [j1, j2]

    streams, _ = assert_sharded_equal(build, jax_n=jax_n)
    assert [len(s) for s in streams] == [1, 1]


def test_sharded_scheduler_outputs_merge_per_node():
    """``run_time``'s return value at n workers: a node's partitions,
    concatenated and consolidated on read."""
    g = EngineGraph()
    src = g.add_source()
    sched = Scheduler(g, n_workers=4)
    from pathway_tpu_torch.engine.delta import Delta
    from pathway_tpu_torch.internals.keys import hash_values

    rows = [(hash_values("k", i), (i,), 1) for i in range(20)]
    sched.push_source(src, Delta(rows))
    reps = sched._replicas[src.id]
    # each source replica holds the rows of its residue, int(key) % 4
    for w, rep in enumerate(reps):
        assert sorted(rep.pending.entries) == sorted(
            e for e in rows if int(e[0]) % 4 == w)
    out = sched.run_time(0)
    assert src.id in out
    assert sorted(out[src.id].entries) == sorted(rows)
    assert not out.get(99).entries


@pytest.mark.parametrize("kw", [{}, {"offset": 3}, {"origin": -2}],
                         ids=["plain", "offset", "origin"])
def test_tumbling_fast_path_sharded(kw):
    """tests/test_sharded.py:563 at 8 workers: the arithmetic tumbling
    path (tuple-keyed routing) and the generic sliding(hop=duration) path
    give the same streams, equal to the JAX package's and to one worker."""
    def build(pw):
        t = pw.debug.table_from_markdown("""
        sensor | v | at  | _time | _diff
        a      | 1 | -7  | 2     | 1
        b      | 2 | 0   | 2     | 1
        a      | 3 | 4   | 4     | 1
        b      | 4 | 5   | 4     | 1
        a      | 3 | 4   | 6     | -1
        a      | 5 | 13  | 6     | 1
        """)

        def agg(win):
            return pw.temporal.windowby(
                t, t.at, window=win, instance=t.sensor,
            ).reduce(sensor=pw.this._pw_instance,
                     start=pw.this._pw_window_start,
                     end=pw.this._pw_window_end,
                     s=pw.reducers.sum(pw.this.v))

        return [agg(pw.temporal.tumbling(4, **kw)),
                agg(pw.temporal.sliding(hop=4, duration=4, **kw))]

    streams, _ = assert_sharded_equal(build)
    assert streams[0] == streams[1]


# -- the groupby pipelines of tests/test_torch_groupby.py at n workers -----

# The JAX package's own sharded run departs from its one-worker run on the
# ix graphs: the dimension table's update at time 4 (a retraction and an
# insertion under one reindexed key) reaches the join from two workers,
# insertion first, and its JoinOperator drops the live row on the
# retraction. The port's exchange hands each worker a key's retractions
# first (graph.py ``_retractions_first``), so it equals the one-worker run;
# there it is held against the JAX package at one worker.
_JAX_SHARDED_DEPARTS = ("ix_inner", "ix_ref", "ix_optional_none_key")


@pytest.mark.parametrize("build", PIPELINES, ids=lambda f: f.__name__[2:])
def test_groupby_pipelines_sharded(build):
    if build.__name__[2:] in _JAX_SHARDED_DEPARTS:
        j1 = run_side("jax", build, 1)[0]
        assert run_side("jax", build, N_WORKERS)[0] != j1
        assert_sharded_equal(build, jax_n=1)
    else:
        assert_sharded_equal(build)


# -- tests/test_property_sharded.py: random pipelines ----------------------

def _random_stream(rng: random.Random, n_rows: int):
    rows, live = [], []
    for i in range(n_rows):
        t = 2 * (1 + i // 7)
        if live and rng.random() < 0.25:
            victim = live.pop(rng.randrange(len(live)))
            rows.append(victim[:3] + (t, -1))
        else:
            row = (f"k{rng.randrange(9)}", rng.randrange(20),
                   f"s{rng.randrange(5)}")
            rows.append(row + (t, 1))
            live.append(row)
    return rows


def _random_pipeline(seed: int):
    def build(pw):
        rng = random.Random(seed)

        class S(pw.Schema):
            k: str
            x: int
            tag: str

        class D(pw.Schema):
            tag: str
            w: int

        t = pw.debug.table_from_rows(S, _random_stream(rng, 80),
                                     is_stream=True)
        dim = pw.debug.table_from_rows(D, [(f"s{i}", 10 * i)
                                           for i in range(5)])
        outs = []
        if rng.random() < 0.5:
            t = t.filter(t.x >= rng.randrange(6))
        t = t.select(t.k, t.tag, y=t.x * 2 + 1)
        outs.append(t)
        outs.append(t.groupby(t.k).reduce(
            t.k, n=pw.reducers.count(), s=pw.reducers.sum(t.y),
            mn=pw.reducers.min(t.y), mx=pw.reducers.max(t.y)))
        if rng.random() < 0.4:
            outs.append(pw.temporal.windowby(
                t, t.y, window=pw.temporal.tumbling(rng.choice([3, 5, 8])),
                instance=t.tag,
            ).reduce(tag=pw.this._pw_instance,
                     start=pw.this._pw_window_start,
                     s=pw.reducers.sum(pw.this.y)))
        mode = rng.choice(["inner", "left", "outer"])
        joined = {"inner": t.join, "left": t.join_left,
                  "outer": t.join_outer}[mode](
            dim, t.tag == dim.tag).select(t.k, t.y, dim.w)
        outs.append(joined)
        outs.append(joined.groupby(joined.k).reduce(
            joined.k, tot=pw.reducers.sum(pw.coalesce(joined.w, 0))))
        return outs
    return build


@pytest.mark.parametrize("seed", range(12))
def test_random_pipeline_identical_across_worker_counts(seed):
    assert_sharded_equal(_random_pipeline(seed))


# -- tests/test_window_join.py: sharded window joins -----------------------

_LEFT = """
k | t  | a  | _time | _diff
x | 1  | 10 | 2     | 1
x | 4  | 11 | 2     | 1
y | 3  | 12 | 2     | 1
x | 7  | 13 | 4     | 1
x | 4  | 11 | 6     | -1
z | 2  | 14 | 6     | 1
"""
_RIGHT = """
k | t  | b  | _time | _diff
x | 2  | 20 | 2     | 1
x | 5  | 21 | 2     | 1
y | 9  | 22 | 4     | 1
x | 6  | 23 | 6     | 1
w | 1  | 24 | 6     | 1
"""
_WINDOWS = {
    "tumbling": lambda pw: pw.temporal.tumbling(duration=3),
    "sliding": lambda pw: pw.temporal.sliding(hop=2, duration=4),
    "session": lambda pw: pw.temporal.session(max_gap=2),
}


@pytest.mark.parametrize("window", list(_WINDOWS))
@pytest.mark.parametrize("how", ["inner", "outer"])
def test_window_join_sharded_identical(window, how):
    def build(pw):
        left = pw.debug.table_from_markdown(_LEFT)
        right = pw.debug.table_from_markdown(_RIGHT)
        return pw.temporal.window_join(
            left, right, left.t, right.t, _WINDOWS[window](pw),
            left.k == right.k, how=how).select(a=pw.left.a, b=pw.right.b)

    assert_sharded_equal(build)


# -- tests/test_groupby.py:273: array_sum at 4 workers, bitwise ------------

def test_array_sum_device_route_sharded_bitwise(monkeypatch):
    """The array_sum reducers through ``device_segsum`` on every worker
    (the row gate off, so each worker's small ticks take the route) equal
    the one-worker per-row numpy path bit for bit, sign bits of -0.0
    included, and the JAX package's 4-worker run."""
    rng = np.random.default_rng(7)
    vecs = rng.standard_normal((300, 6)).astype(np.float32)
    vecs[::7] = -0.0
    rows = [(f"g{i % 7}", vecs[i], (i % 3) * 2, 1) for i in range(300)]

    def build(pw):
        t = pw.debug.table_from_rows(
            pw.schema_from_types(g=str, v=np.ndarray), rows, is_stream=True)
        return t.groupby(t.g).reduce(t.g, s=pw.reducers.npsum(t.v),
                                     s2=pw.reducers.sum(t.v))

    def bits(run):
        streams, snaps, runner = run
        out = {}
        for row in snaps[0].values():
            out[row[0]] = tuple(cell for cell in row[1:])
        return out, runner

    host, _ = bits(run_side("torch", build, 1))
    monkeypatch.setattr(jops, "_ARRAY_SUM_DEVICE_MIN", 1)
    monkeypatch.setattr(jops, "_ARRAY_SUM_MIN_ROWS", 1)
    monkeypatch.setattr(tops, "_array_sum_device_min", lambda: 1)
    monkeypatch.setattr(tops, "_ARRAY_SUM_MIN_ROWS", 1)
    monkeypatch.setattr(tops, "_array_sum_device",
                        lambda: torch.device("cpu"))
    dev4, runner = bits(run_side("torch", build, 4))
    jdev4, _ = bits(run_side("jax", build, 4))
    assert dev4 == host  # _norm keeps the bytes: -0.0 signs included
    assert dev4 == jdev4
    reps = replicas_of(runner, tops.GroupByOperator)
    assert len(reps) == 4
    assert all(r.segsum_steps > 0 for r in reps), \
        [r.segsum_steps for r in reps]


# -- the external index: data broadcast, queries local ---------------------

DIM = 8


def _index_graph(pw, device_kw):
    rng = np.random.default_rng(3)
    data = rng.standard_normal((24, DIM)).astype(np.float32)
    queries = rng.standard_normal((16, DIM)).astype(np.float32)
    docs = pw.debug.table_from_rows(
        pw.schema_from_types(name=str, vec=np.ndarray),
        [(f"d{i}", data[i], 2 * (i // 12), 1) for i in range(24)],
        is_stream=True)
    qs = pw.debug.table_from_rows(
        pw.schema_from_types(q=str, vec=np.ndarray),
        [(f"q{i}", queries[i], 2 * (i // 8) + 1, 1) for i in range(16)],
        is_stream=True)
    from importlib import import_module

    idx = import_module(pw.__name__ + ".stdlib.indexing")
    nn = import_module(pw.__name__ + ".stdlib.indexing.nearest_neighbors")
    index = idx.DataIndex(docs, idx.BruteForceKnn(
        docs.vec, dimensions=DIM, reserved_space=64,
        metric=nn.BruteForceKnnMetricKind.COS, **device_kw))
    res = index.query_as_of_now(qs.vec, number_of_matches=3)
    return res.select(q=qs.q, hits=res.name)


def _index_run(side: str, n: int):
    kw = {"device": "cpu"} if side == "torch" else {}
    return run_side(side, lambda pw: _index_graph(pw, kw), n)


def test_external_index_sharded_queries_local_data_broadcast(monkeypatch):
    """As tests/test_sharded.py:359 holds the JAX package (there over
    BM25, here over the brute-force KNN on the CPU): the answers equal at
    n in {1, 8} and the JAX package's; the replicas share one index
    object, only replica 0 maintains it, and several answer queries."""
    monkeypatch.setenv("PATHWAY_RESULT_CACHE", "0")
    from pathway_tpu_torch.engine.index_ops import ExternalIndexOperator

    jstreams, _, _ = _index_run("jax", N_WORKERS)
    t1, _, _ = _index_run("torch", 1)
    t8, _, runner = _index_run("torch", N_WORKERS)
    assert t8 == t1 == jstreams
    assert len(t8[0]) == 16
    reps = replicas_of(runner, ExternalIndexOperator)
    assert len(reps) == N_WORKERS
    assert all(r.index is reps[0].index for r in reps)
    assert reps[0]._is_primary and not any(r._is_primary for r in reps[1:])
    assert not reps[0].parallel_safe
    assert sum(1 for r in reps if r.answers) >= 2, \
        "queries not answered in parallel"
    # only the primary wrote the index: it holds every live row once
    assert len(reps[0].index._key_to_slot) == 24


# -- replicas share device objects by identity -----------------------------

def _tiny_embedder():
    from pathway_tpu_torch.models.encoder import EncoderConfig
    from pathway_tpu_torch.xpacks.llm.embedders import EncoderEmbedder

    return EncoderEmbedder(config=EncoderConfig.tiny(), device="cpu")


class _Holder:
    """A callable that holds an embedder and some state of its own, as a
    map whose function is an object would."""

    def __init__(self, emb):
        self.emb = emb
        self.state = [1, 2]

    def __call__(self, keys, rows):
        return [(r[0],) for r in rows]


def test_replicas_share_embedder_and_parameters():
    """A map over a bound method of the embedder and a map over an object
    holding it: at n=4 every replica reaches the same embedder and the
    same parameter tensors; only the holder and its own state are
    copied."""
    emb = _tiny_embedder()
    params = list(emb.model.parameters())
    holder = _Holder(emb)
    g = EngineGraph()
    src = g.add_source()
    bound = g.add_node(tops.MapOperator(emb.__wrapped__), [src])
    held = g.add_node(tops.MapOperator(holder), [src])
    sched = Scheduler(g, n_workers=4)
    breps = sched._replicas[bound.id]
    hreps = sched._replicas[held.id]
    assert len(breps) == len(hreps) == 4
    assert len({id(r) for r in breps}) == 4  # the operators are replicas
    for r in breps:
        assert r.fn.__self__ is emb
        assert all(a is b for a, b in zip(r.fn.__self__.model.parameters(),
                                          params))
    for r in hreps[1:]:
        assert r.fn is not holder  # the holder object is copied ...
        assert r.fn.emb is emb  # ... but what it holds on the card is not
        assert r.fn.state == holder.state
        assert r.fn.state is not holder.state
    sched.close()


def test_encoder_embedder_graph_sharded(monkeypatch):
    """An EncoderEmbedder map at n=4, with the worker pool on: the
    replicas share the embedder and its parameters, every document is
    embedded once, and the embeddings equal the one-worker run's within
    1e-5 (per-worker batches are other shapes)."""
    emb = _tiny_embedder()
    params = [p.data_ptr() for p in emb.model.parameters()]
    docs = [f"word{i} word{i % 7} word{i % 3}" for i in range(40)]

    def run(n, threads):
        monkeypatch.setenv("PATHWAY_WORKER_THREADS", "1" if threads else "0")
        streams, _snaps, runner = run_side("torch", lambda pw: (lambda t: t.select(
            e=emb(t.data)))(pw.debug.table_from_rows(
                pw.schema_from_types(data=str),
                [(d, 2 * (i // 10), 1) for i, d in enumerate(docs)],
                is_stream=True)), n)
        return streams[0], runner

    one, _ = run(1, False)
    four, runner = run(4, True)
    assert [e[:3] for e in four] == [e[:3] for e in one]
    assert len(four) == 40
    got = np.stack([np.frombuffer(e[3][0][3], np.float32) for e in four])
    want = np.stack([np.frombuffer(e[3][0][3], np.float32) for e in one])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    maps = [n for n in runner.graph.nodes if n.op.device_bound]
    assert maps
    for node in maps:
        reps = runner._scheduler._replicas[node.id]
        assert len(reps) == 4
        assert all(r.fn is reps[0].fn for r in reps)
    assert [p.data_ptr() for p in emb.model.parameters()] == params


def test_device_index_replicas_share_embedder_and_index(monkeypatch):
    """The text index that embeds on the device (DeviceEmbeddingKnnIndex,
    the RAG graph's): at n=4 the replicas share it, its embedder and its
    inner index; only replica 0 adds, and the answers equal n=1's."""
    monkeypatch.setenv("PATHWAY_RESULT_CACHE", "0")
    from pathway_tpu_torch.engine.index_ops import ExternalIndexOperator
    from pathway_tpu_torch.stdlib.indexing import \
        default_brute_force_knn_document_index

    emb = _tiny_embedder()
    texts = [f"doc{i} word{i % 5} word{i % 11}" for i in range(30)]

    def build(pw):
        docs = pw.debug.table_from_rows(
            pw.schema_from_types(text=str),
            [(x, 2 * (i // 10), 1) for i, x in enumerate(texts)],
            is_stream=True)
        qs = pw.debug.table_from_rows(
            pw.schema_from_types(query=str),
            [(texts[3 * i], 2 * i + 1, 1) for i in range(10)],
            is_stream=True)
        index = default_brute_force_knn_document_index(
            docs.text, docs, embedder=emb, dimensions=64,
            reserved_space=64)
        res = index.query_as_of_now(qs.query, number_of_matches=2)
        return res.select(q=qs.query, hits=res.text)

    one, _, _ = run_side("torch", build, 1)
    four, _, runner = run_side("torch", build, 4)
    assert four == one
    reps = replicas_of(runner, ExternalIndexOperator)
    assert len(reps) == 4
    assert all(r.index is reps[0].index for r in reps)
    assert all(r.index.embedder is emb for r in reps)
    assert reps[0]._is_primary and not any(r._is_primary for r in reps[1:])
    assert len(reps[0].index.inner._key_to_slot) == 30
    assert sum(1 for r in reps if r.answers) >= 2


def test_replicate_shares_what_cannot_be_copied():
    """Operator.replicate over an operator that reaches an index, an
    embedder, the graphed ingest step and pinned staging: no error, and
    each is the same object on every replica; plain state is copied."""
    from pathway_tpu_torch._device import PinnedStaging, ReplicaShared
    from pathway_tpu_torch.ops.knn import (BruteForceKnnIndex,
                                           GraphedIngestStep)

    cpu = torch.device("cpu")
    index = BruteForceKnnIndex(4, device="cpu")
    op = tops.FilterOperator(lambda k, r: [True] * len(r))
    op.extra = {"index": index, "embedder": _tiny_embedder(),
                "ingest": GraphedIngestStep(lambda *a: None, cpu),
                "staging": PinnedStaging(cpu), "state": [1, 2]}
    reps = op.replicate(3)
    for r in reps[1:]:
        assert r is not op
        for name in ("index", "embedder", "ingest", "staging"):
            assert isinstance(op.extra[name], ReplicaShared), name
            assert r.extra[name] is op.extra[name], name
        assert r.extra["state"] == [1, 2]
        assert r.extra["state"] is not op.extra["state"]


# -- the scheduler's other paths -------------------------------------------

def _etl(pw):
    """bench.py's bench_etl graph at a small size."""
    rng = np.random.default_rng(0)
    words = rng.integers(0, 50, size=400)
    qtys = rng.integers(1, 10, size=400)
    ticks = np.sort(rng.integers(0, 5, size=400))

    class S(pw.Schema):
        word: str
        qty: int

    class L(pw.Schema):
        word: str
        cat: str

    events = pw.debug.table_from_rows(
        S, [(f"w{words[i]}", int(qtys[i]), int(ticks[i]) * 2, 1)
            for i in range(400)], is_stream=True)
    lex = pw.debug.table_from_rows(
        L, [(f"w{i}", f"cat{i % 7}") for i in range(50)])
    counts = events.groupby(events.word).reduce(
        events.word, n=pw.reducers.count(),
        total=pw.reducers.sum(events.qty))
    return counts.join(lex, counts.word == lex.word).select(
        counts.word, counts.n, counts.total, lex.cat)


@pytest.mark.parametrize("n", [1, N_WORKERS])
def test_exchange_rounds_per_tick_equal_reference(n):
    """bench.py reads the count from the one-worker scheduler: it is a
    static count of the graph, equal to the JAX package's at any n."""
    _, _, jrunner = run_side("jax", _etl, n)
    _, _, trunner = run_side("torch", _etl, n)
    rounds = trunner._scheduler.exchange_rounds_per_tick()
    assert rounds == jrunner._scheduler.exchange_rounds_per_tick()
    assert rounds > 0


def test_etl_graph_sharded_equal():
    _, runner = assert_sharded_equal(_etl)
    groups, lefts = _worker_state(runner, tops)
    assert sum(1 for g in groups if g) >= 2


def test_route_cache_cap_parses_env(monkeypatch):
    """``PATHWAY_ROUTE_CACHE_MAX`` sets the per-edge memo's cap, with the
    JAX package's fallback for a value that is not a number."""
    g = EngineGraph()
    g.add_source()
    for value, cap in (("2048", 2048), ("10", 1024),
                       ("not-a-number", 1 << 16)):
        monkeypatch.setenv("PATHWAY_ROUTE_CACHE_MAX", value)
        sched = Scheduler(g, n_workers=2)
        try:
            assert sched._route_cache_max == cap, value
        finally:
            sched.close()


def test_route_cache_cap_applied_in_sharded_run(monkeypatch):
    """A high-cardinality group column routed across two workers: the
    edge's memo is dropped whole at the cap and refills, and the results
    stay equal to the JAX package's and to one worker's."""
    monkeypatch.setenv("PATHWAY_ROUTE_CACHE_MAX", "1024")

    def build(pw):
        t = pw.debug.table_from_rows(
            pw.schema_from_types(k=str, x=int),
            [(f"user-{i}", i, 0, 1) for i in range(1500)], is_stream=True)
        return t.groupby(t.k).reduce(k=t.k, n=pw.reducers.count())

    _, runner = assert_sharded_equal(build, n=2)
    sched = runner._scheduler
    sizes = [len(c) for c in sched._route_cache.values()]
    # 1500 distinct values: the memo filled to 1024, was dropped at the
    # 1025th and holds the last 476
    assert sizes == [1500 - 1024]


class _Gather(tops.Operator):
    """A test operator whose state cannot be partitioned."""

    def __init__(self):
        self.seen: list = []

    def exchange_specs(self):
        return [tops.Exchange.GATHER]

    def step(self, time, in_deltas):
        self.seen.append((time, len(in_deltas[0].entries)))
        return in_deltas[0]


def test_gather_operator_steps_on_worker_zero_only():
    from pathway_tpu_torch.engine.delta import Delta
    from pathway_tpu_torch.internals.keys import hash_values

    g = EngineGraph()
    src = g.add_source()
    op = _Gather()
    node = g.add_node(op, [src])
    sched = Scheduler(g, n_workers=4)
    assert sched._replicas[node.id] == [op]
    rows = [(hash_values("g", i), (i,), 1) for i in range(40)]
    sched.push_source(src, Delta(rows))
    out = sched.run_time(0)
    # the one replica saw every worker's rows in one step
    assert op.seen == [(0, 40)]
    assert sorted(out[node.id].entries) == sorted(rows)
    assert sched.exchange_rounds_per_tick() == 1


def test_worker_threads_give_equal_results(monkeypatch):
    """``PATHWAY_WORKER_THREADS=1`` steps the parallel-safe replicas on a
    pool: the same streams as sequential stepping and as the JAX
    package's pool."""
    monkeypatch.setenv("PATHWAY_WORKER_THREADS", "1")
    g = EngineGraph()
    g.add_source()
    sched = Scheduler(g, n_workers=4)
    assert sched._pool is not None
    sched.close()
    assert sched._pool is None
    pooled, _, _ = run_side("torch", _pipeline, N_WORKERS)
    jpooled, _, _ = run_side("jax", _pipeline, N_WORKERS)
    monkeypatch.setenv("PATHWAY_WORKER_THREADS", "0")
    seq, _, _ = run_side("torch", _pipeline, N_WORKERS)
    assert pooled == seq == jpooled


def test_run_batch_reads_pathway_threads(monkeypatch):
    monkeypatch.setenv("PATHWAY_THREADS", str(N_WORKERS))
    jstreams, _, _ = run_side("jax", _pipeline, None)
    tstreams, _, runner = run_side("torch", _pipeline, None)
    assert runner._scheduler.n_workers == N_WORKERS
    assert tstreams == jstreams
    from pathway_tpu_torch.internals.config import get_pathway_config

    assert get_pathway_config().threads == N_WORKERS


def test_pw_run_under_pathway_threads(monkeypatch):
    """``pw.run`` with a python connector under ``PATHWAY_THREADS=4``:
    the consolidated output equals one thread's and the JAX package's at
    four."""
    from test_torch_streaming import _consolidate, _events, _pipeline

    events = _events(3)
    monkeypatch.setenv("PATHWAY_THREADS", "1")
    one, err1 = _pipeline("torch", events)
    monkeypatch.setenv("PATHWAY_THREADS", "4")
    four, err4 = _pipeline("torch", events)
    jfour, jerr = _pipeline("jax", events)
    assert not err1 and not err4 and not jerr, (err1, err4, jerr)
    for name in ("counts", "looked"):
        assert _consolidate(four[name]) == _consolidate(one[name]), name
        assert _consolidate(four[name]) == _consolidate(jfour[name]), name
    assert len(_consolidate(four["looked"])) > 20


def test_streaming_runtime_stats_name_its_workers(monkeypatch):
    from pathway_tpu_torch.engine.streaming import StreamingRuntime

    monkeypatch.setenv("PATHWAY_THREADS", "4")
    TG.clear()
    try:
        t = tpw.debug.table_from_markdown("""
        k | x
        a | 1
        """)
        runner = TRunner()
        runner.capture(t)
        rt = StreamingRuntime(runner)
        assert rt.stats()["n_workers"] == 4
        assert rt.scheduler.n_workers == 4
        rt.scheduler.close()
        assert StreamingRuntime(runner, n_workers=2).stats()["n_workers"] == 2
    finally:
        TG.clear()


def test_cluster_and_processes_raise_item_6f(monkeypatch):
    with pytest.raises(NotImplementedError, match="item 6f"):
        Scheduler(EngineGraph(), n_workers=2, cluster=object())
    TG.clear()
    monkeypatch.setenv("PATHWAY_PROCESSES", "2")
    with pytest.raises(NotImplementedError, match="item 6f"):
        tpw.run()


def test_worker_pool_stress_keeps_every_update(monkeypatch):
    """More workers than cores on the pool, with a short switch interval:
    an embedder map whose replicas call the shared embedder from the
    pool's threads at once. Every document is embedded once, and the
    embedder's dispatch counter (a read-modify-write under its device
    lock) and the node's counters lose no update."""
    import os
    import sys

    emb = _tiny_embedder()
    n = (os.cpu_count() or 1) + 2
    docs = [f"w{i} w{i % 5}" for i in range(6 * n)]
    monkeypatch.setenv("PATHWAY_WORKER_THREADS", "1")
    result: dict = {}

    def run():
        result["out"] = run_side("torch", lambda pw: (lambda t: t.select(
            e=emb(t.data)))(pw.debug.table_from_rows(
                pw.schema_from_types(data=str),
                [(d, 2 * (i % 3), 1) for i, d in enumerate(docs)],
                is_stream=True)), n)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        emb.dispatches = 0
        th = threading.Thread(target=run, daemon=True)
        th.start()
        th.join(120)
    finally:
        sys.setswitchinterval(old)
    assert not th.is_alive(), "the pooled run outlived its deadline"
    streams, _snaps, runner = result["out"]
    assert len(streams[0]) == len(docs)
    sched = runner._scheduler
    node = next(nd for nd in runner.graph.nodes if nd.op.device_bound)
    # one forward a replica that had rows, a tick
    calls = sum(1 for t in range(3) for w in range(n)
                if any(k % n == w for tt, k, _, _ in streams[0]
                       if tt == 2 * t))
    assert emb.dispatches == calls
    assert sched.stats[node.id]["insertions"] == len(docs)
