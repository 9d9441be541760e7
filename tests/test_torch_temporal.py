"""The port's temporal layer (``pw.temporal.windowby`` with tumbling,
sliding, session and intervals_over windows, the behaviors, and the
watermark operators of engine/temporal_ops.py) against the JAX package's:
the same pipeline over the same numpy-seeded streams (inserts over several
ticks, late rows, retractions) runs through ``pathway_tpu`` and
``pathway_tpu_torch`` under ``run_batch(n_workers=1)``, and the
consolidated events (time, key, diff, row), the result schema and the
graph's operator classes must be equal exactly (tolerance: none; floats
compare by their bits). One case runs under each package's ``pw.run``
through ``pw.io.python``, where tick boundaries follow each runtime's
clock: there the net output per (key, row) is equal exactly.

The JAX side runs with ``PATHWAY_AUTO_JIT=0`` and
``PATHWAY_DEVICE_INFLIGHT=1`` (see tests/test_torch_table.py).
"""

import datetime
import threading
import time
import typing

import numpy as np
import pytest

import pathway_tpu as jpw
import pathway_tpu_torch as tpw
from pathway_tpu.internals.parse_graph import G as JG
from pathway_tpu.internals.runner import GraphRunner as JRunner
from pathway_tpu_torch.internals.parse_graph import G as TG
from pathway_tpu_torch.internals.runner import GraphRunner as TRunner
from test_torch_groupby import _norm

SIDES = {"jax": (jpw, JRunner, JG), "torch": (tpw, TRunner, TG)}
N_ROWS = 120


@pytest.fixture(autouse=True)
def _reference_schedule(monkeypatch):
    monkeypatch.setenv("PATHWAY_AUTO_JIT", "0")
    monkeypatch.setenv("PATHWAY_DEVICE_INFLIGHT", "1")


def _cell(v):
    """``_norm`` with datetimes and durations by value: the JAX package's
    window bounds over datetimes are pandas Timestamps, the port's
    ``datetime.datetime`` (pandas subclasses both)."""
    if isinstance(v, datetime.datetime):
        return ("datetime", v.isoformat())
    if isinstance(v, datetime.timedelta):
        return ("timedelta", v // datetime.timedelta(microseconds=1))
    if isinstance(v, (tuple, list)):
        return (type(v).__name__, tuple(_cell(e) for e in v))
    return _norm(v)


def run_side(side: str, build, keys: bool = True):
    """Run ``build(pw)``'s table under ``run_batch(n_workers=1)``: its
    consolidated events (keys as ints, or dropped), schema and the graph's
    operator classes."""
    pw, Runner, G = SIDES[side]
    G.clear()
    try:
        out = build(pw)
        runner = Runner()
        cap = runner.capture(out)
        runner.run_batch(n_workers=1)
    finally:
        G.clear()
    events = sorted(
        (t, int(k) if keys and k is not None else -1, d,
         tuple(_cell(v) for v in row))
        for k, row, t, d in cap.consolidated_events())
    schema = [(n, repr(d)) for n, d in out.schema._dtypes().items()]
    ops = [type(node.op).__name__ for node in runner.graph.nodes]
    return events, schema, ops


def assert_equal(build, keys: bool = True):
    jev, jschema, jops = run_side("jax", build, keys)
    tev, tschema, tops = run_side("torch", build, keys)
    assert tops == jops
    assert tschema == jschema
    assert tev == jev
    return tev


def stream_rows(seed: int, n: int = N_ROWS, *, t_max: int = 60,
                n_keys: int = 4, kind: str = "int", retract: float = 0.15,
                late: float = 0.1) -> list[tuple]:
    """(k, v, at, time, diff) rows: ``at`` mostly rising with the tick, a
    share of late rows, and retractions of earlier rows at later ticks.
    ``kind`` picks at's type: int, float, optional (int or None) or
    datetime (naive: minutes from 2024-01-01, plus up to a minute in
    microseconds)."""
    rng = np.random.default_rng(seed)
    out, live = [], []
    base = datetime.datetime(2024, 1, 1)
    for i in range(n):
        tick = 2 * (1 + i // 12)
        at = int(rng.integers(0, 8)) + (i * t_max) // n
        if rng.random() < late:
            at = max(0, at - int(rng.integers(10, 25)))
        if kind == "float":
            at = at + float(rng.integers(0, 4)) / 4
        elif kind == "optional" and rng.random() < 0.1:
            at = None
        elif kind == "datetime":
            at = base + datetime.timedelta(
                minutes=at, microseconds=int(rng.integers(0, 60_000_000)))
        row = (f"k{int(rng.integers(0, n_keys))}", int(rng.integers(-5, 20)),
               at)
        out.append((*row, tick, 1))
        live.append(row)
        if live and rng.random() < retract:
            gone = live.pop(int(rng.integers(0, len(live))))
            out.append((*gone, tick + 2, -1))
    return out


AT_TYPES = {"int": int, "float": float, "optional": typing.Optional[int],
            "datetime": datetime.datetime}


def events_table(pw, rows, kind: str = "int"):
    schema = pw.schema_from_types(k=str, v=int, at=AT_TYPES[kind])
    return pw.debug.table_from_rows(schema, rows, is_stream=True)


def _reduce(pw, win, instance: bool = True):
    cols = dict(start=pw.this._pw_window_start, end=pw.this._pw_window_end,
                n=pw.reducers.count(), s=pw.reducers.sum(pw.this.v),
                lo=pw.reducers.min(pw.this.v))
    if instance:
        cols["k"] = pw.this._pw_instance
    return win.reduce(**cols)


# -- windowby ----------------------------------------------------------------

WINDOWS = {
    "tumbling": lambda pw: pw.temporal.tumbling(10),
    "tumbling_origin": lambda pw: pw.temporal.tumbling(7, origin=3),
    "tumbling_offset": lambda pw: pw.temporal.tumbling(7, offset=-2),
    "sliding": lambda pw: pw.temporal.sliding(hop=3, duration=10),
    "sliding_ratio": lambda pw: pw.temporal.sliding(hop=4, ratio=3),
    "sliding_origin": lambda pw: pw.temporal.sliding(hop=5, duration=5,
                                                     origin=1),
    "session_gap": lambda pw: pw.temporal.session(max_gap=3),
    "session_predicate": lambda pw: pw.temporal.session(
        predicate=lambda a, b: b - a <= 2),
}


# a session sweep sorts and subtracts times: None has neither, in both
# packages, so sessions take int and float times only
WINDOW_KINDS = [(w, k) for w in sorted(WINDOWS)
                for k in ("int", "float", "optional")
                if not (w.startswith("session") and k == "optional")]


@pytest.mark.parametrize("window,kind", WINDOW_KINDS)
@pytest.mark.parametrize("instance", [True, False], ids=["instance", "none"])
def test_windowby_equals_reference(window, kind, instance):
    rows = stream_rows(3, kind=kind)

    def build(pw):
        t = events_table(pw, rows, kind)
        return _reduce(pw, pw.temporal.windowby(
            t, t.at, window=WINDOWS[window](pw),
            instance=t.k if instance else None), instance)

    assert assert_equal(build)


def test_windowby_intervals_over_equals_reference():
    rows = stream_rows(5)

    def build(pw):
        t = events_table(pw, rows)
        at = pw.debug.table_from_rows(pw.schema_from_types(p=int),
                                      [(5,), (20,), (21,), (47,)])
        win = pw.temporal.windowby(
            t, t.at, window=pw.temporal.intervals_over(
                at=at, lower_bound=-4, upper_bound=3))
        return win.reduce(start=pw.this._pw_window_start,
                          end=pw.this._pw_window_end,
                          n=pw.reducers.count(), s=pw.reducers.sum(pw.this.v))

    assert assert_equal(build)


def test_windowby_datetime_rows_equal_reference():
    """Datetime times take the generic path in both packages. The rows are
    equal; the keys are not: the JAX package's window bounds are pandas
    Timestamps, the port's ``datetime.datetime``, and the key hash encodes
    such values by ``repr`` (ROADMAP queue 3)."""
    rows = stream_rows(7, kind="datetime")
    for window in (lambda pw: pw.temporal.tumbling(datetime.timedelta(
                       minutes=10)),
                   lambda pw: pw.temporal.sliding(
                       hop=datetime.timedelta(minutes=5),
                       duration=datetime.timedelta(minutes=15))):
        def build(pw, window=window):
            t = events_table(pw, rows, "datetime")
            return _reduce(pw, pw.temporal.windowby(
                t, t.at, window=window(pw), instance=t.k))

        assert assert_equal(build, keys=False)


def test_windowby_utc_datetimes_in_the_port():
    """UTC-aware times: the port's window origin is the aware epoch (the
    JAX package's is a naive pandas Timestamp, which an aware time cannot
    be subtracted from: ROADMAP queue 3). Held against a plain floor."""
    utc = datetime.timezone.utc
    base = datetime.datetime(2024, 1, 1, 0, 3, tzinfo=utc)
    ats = [base + datetime.timedelta(minutes=m) for m in (0, 4, 9, 13, 31)]
    t = tpw.debug.table_from_rows(
        tpw.schema_from_types(at=datetime.datetime, v=int),
        [(a, i) for i, a in enumerate(ats)])
    win = tpw.temporal.windowby(
        t, t.at, window=tpw.temporal.tumbling(datetime.timedelta(minutes=10)))
    out = win.reduce(start=tpw.this._pw_window_start,
                     s=tpw.reducers.sum(tpw.this.v))
    runner = TRunner()
    cap = runner.capture(out)
    runner.run_batch(n_workers=1)
    TG.clear()
    ten = datetime.timedelta(minutes=10)
    epoch = datetime.datetime(1970, 1, 1, tzinfo=utc)
    want: dict = {}
    for i, a in enumerate(ats):
        start = epoch + ((a - epoch) // ten) * ten
        want[start] = want.get(start, 0) + i
    assert sorted(cap.snapshot().values()) == sorted(want.items())


# -- behaviors ---------------------------------------------------------------

BEHAVIORS = {
    "delay": lambda pw: pw.temporal.common_behavior(delay=5),
    "cutoff": lambda pw: pw.temporal.common_behavior(cutoff=5),
    "delay_cutoff": lambda pw: pw.temporal.common_behavior(delay=3,
                                                           cutoff=8),
    "cutoff_forget_results": lambda pw: pw.temporal.common_behavior(
        cutoff=4, keep_results=False),
    "exactly_once": lambda pw: pw.temporal.exactly_once_behavior(),
    "exactly_once_shift": lambda pw: pw.temporal.exactly_once_behavior(
        shift=3),
}


@pytest.mark.parametrize("window", ["tumbling", "sliding", "session_gap"])
@pytest.mark.parametrize("behavior", sorted(BEHAVIORS))
def test_behavior_equals_reference(behavior, window):
    rows = stream_rows(11, late=0.25)

    def build(pw):
        t = events_table(pw, rows)
        return _reduce(pw, pw.temporal.windowby(
            t, t.at, window=WINDOWS[window](pw), instance=t.k,
            behavior=BEHAVIORS[behavior](pw)))

    events = assert_equal(build)
    # exactly-once over sessions emits nothing in the JAX package: a
    # session's threshold is its last time, so ForgetOperator drops that
    # row as late the tick the buffer releases it (ROADMAP queue 3); the
    # port matches
    assert bool(events) == ((behavior, window)
                            != ("exactly_once", "session_gap"))


@pytest.mark.parametrize("op", ["_buffer", "_forget", "_freeze"])
def test_watermark_operators_equal_reference(op):
    """The behaviors' building blocks on their own: threshold at + 4,
    watermark the largest ``at`` inserted so far."""
    rows = stream_rows(13, late=0.3)

    def build(pw):
        t = events_table(pw, rows)
        return getattr(t, op)(t.at + 4, t.at)

    assert assert_equal(build)


def test_temporal_operator_snapshots_raise():
    from pathway_tpu_torch.engine import temporal_ops as tops

    ops = [tops.ForgetImmediatelyOperator(),
           tops.BufferOperator(None, None), tops.ForgetOperator(None, None),
           tops.FreezeOperator(None, None)]
    for op in ops:
        with pytest.raises(NotImplementedError, match="item 6a"):
            op.snapshot_state()
        with pytest.raises(NotImplementedError, match="item 6a"):
            op.restore_state({})


def test_forget_immediately_equals_reference():
    rows = stream_rows(17)

    def build(pw):
        t = events_table(pw, rows)
        return t._forget_immediately()._filter_out_results_of_forgetting()

    assert assert_equal(build)


# -- the operators each probed graph lowers to ------------------------------

PROBED = {
    "tumbling": (lambda pw: pw.temporal.tumbling(100), None),
    "sliding": (lambda pw: pw.temporal.sliding(hop=50, duration=100), None),
    "tumbling_behavior": (lambda pw: pw.temporal.tumbling(100),
                          lambda pw: pw.temporal.common_behavior(
                              delay=50, cutoff=200)),
    "session": (lambda pw: pw.temporal.session(max_gap=3), None),
}
PROBED_OPS = {
    "tumbling": ["SourceOperator", "MapOperator", "ColumnarGroupByOperator",
                 "MapOperator", "OutputOperator"],
    "tumbling_behavior": ["SourceOperator", "MapOperator", "BufferOperator",
                          "ForgetOperator", "FilterOutForgettingOperator",
                          "ColumnarGroupByOperator", "MapOperator",
                          "OutputOperator"],
}


def bench_windowed(pw, n: int, window, behavior=None):
    """bench.py's ``run_windowed`` graph (bench.py:1936-1964) at n rows:
    sensors ``s{word % 200}``, ``at`` sorted draws below n // 10, 50
    ticks, ``default_rng(0)`` in bench's draw order."""
    rng = np.random.default_rng(0)
    words = rng.integers(0, 5000, size=n)
    qtys = rng.integers(1, 10, size=n)
    ticks = np.sort(rng.integers(0, 50, size=n))
    at = np.sort(rng.integers(0, n // 10, size=n))
    schema = pw.schema_from_types(sensor=str, v=int, at=int)
    t = pw.debug.table_from_rows(
        schema, [(f"s{words[i] % 200}", int(qtys[i]), int(at[i]),
                  int(ticks[i]) * 2, 1) for i in range(n)], is_stream=True)
    return pw.temporal.windowby(
        t, t.at, window=window, instance=t.sensor, behavior=behavior,
    ).reduce(sensor=pw.this._pw_instance, start=pw.this._pw_window_start,
             s=pw.reducers.sum(pw.this.v), c=pw.reducers.count())


@pytest.mark.parametrize("graph", sorted(PROBED))
def test_probed_graphs_lower_to_reference_operators(graph):
    """Each windowed graph bench_etl's leg and its variants build lowers to
    the JAX package's operator classes, in order; bench's own graph and
    the behavior graph to the columnar groupby."""
    window, behavior = PROBED[graph]

    def build(pw):
        return bench_windowed(pw, 3000, window(pw),
                              behavior(pw) if behavior else None)

    _, _, ops = run_side("torch", build)
    assert ops == run_side("jax", build)[2]
    if graph in PROBED_OPS:
        assert ops == PROBED_OPS[graph]
    if graph == "sliding":
        assert "FlattenOperator" in ops and "ColumnarGroupByOperator" in ops
    if graph == "session":
        assert ops.count("GroupByOperator") == 2


@pytest.mark.parametrize("kind", ["int", "float", "optional", "datetime"])
def test_tumbling_fast_path_choice_equals_reference(kind):
    from pathway_tpu.stdlib import temporal as jtemporal
    from pathway_tpu_torch.stdlib import temporal as ttemporal

    chosen = []
    for pw, temporal in ((jpw, jtemporal), (tpw, ttemporal)):
        t = events_table(pw, [], kind)
        chosen.append(temporal._tumbling_fast_path_ok(
            temporal.tumbling(10), t._resolve(t.at)))
    assert chosen[0] == chosen[1] == (kind in ("int", "float"))


# -- pw.run: a streaming source through a delayed window --------------------

def _streamed(side: str, rows: list) -> tuple[list, list]:
    if side == "jax":
        import pathway_tpu as pw
        from pathway_tpu.engine import streaming
    else:
        import pathway_tpu_torch as pw
        from pathway_tpu_torch.engine import streaming
    G = SIDES[side][2]

    class Row(pw.Schema):
        k: str
        v: int
        at: int

    class Subject(pw.io.python.ConnectorSubject):
        def run(self):
            for i, (k, v, at) in enumerate(rows):
                self.next(k=k, v=v, at=at)
                if i % 10 == 9:
                    time.sleep(0.004)

    G.clear()
    t = pw.io.python.read(Subject(), schema=Row, autocommit_duration_ms=5)
    out = pw.temporal.windowby(
        t, t.at, window=pw.temporal.tumbling(10), instance=t.k,
        behavior=pw.temporal.common_behavior(delay=4),
    ).reduce(k=pw.this._pw_instance, start=pw.this._pw_window_start,
             s=pw.reducers.sum(pw.this.v), n=pw.reducers.count())
    got: list = []
    pw.io.subscribe(out, lambda key, row, time, is_addition: got.append(
        (int(key), tuple(sorted(row.items())), 1 if is_addition else -1)))
    errors: list = []

    def run():
        try:
            pw.run()
        except Exception as e:  # re-raised by the caller's assert
            errors.append(e)

    th = threading.Thread(target=run, daemon=True)
    th.start()
    try:
        th.join(30.0)
    finally:
        streaming.stop_all()
        th.join(30.0)
        G.clear()
    assert not th.is_alive(), f"{side} run outlived its deadline"
    return got, errors


def test_streamed_delay_behavior_equals_reference():
    rng = np.random.default_rng(19)
    rows = [(f"k{int(rng.integers(0, 3))}", int(rng.integers(0, 9)),
             i // 2 + int(rng.integers(0, 4))) for i in range(150)]
    net = {}
    for side in SIDES:
        got, errors = _streamed(side, rows)
        assert not errors, errors
        acc: dict = {}
        for key, row, diff in got:
            acc[(key, row)] = acc.get((key, row), 0) + diff
        net[side] = {kr: d for kr, d in acc.items() if d}
    assert net["torch"] == net["jax"]
    # every row lands in its window once the stream ends (the buffer's
    # end-of-stream flush releases what the watermark never reached)
    want: dict = {}
    for k, v, at in rows:
        s, n = want.get((k, at // 10 * 10), (0, 0))
        want[(k, at // 10 * 10)] = (s + v, n + 1)
    got = {(dict(row)["k"], dict(row)["start"]): (dict(row)["s"],
                                                  dict(row)["n"])
           for (_, row), d in net["torch"].items()}
    assert got == want
