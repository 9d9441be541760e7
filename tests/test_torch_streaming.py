"""``pw.run`` with streaming sources in the port (engine/streaming.py,
io/python) against the JAX package: the same ``ConnectorSubject`` stream
— inserts, updates by primary key and removals, pushed from numpy draws
of one seed in bursts — through select / filter / groupby-reduce / ix /
``pw.io.subscribe`` under each package's ``pw.run``. Tick boundaries
follow each runtime's clock, so the per-tick events differ; the
consolidated output (every (key, row)'s net diff, and the final state)
is equal exactly.

Each run is on its own thread with a deadline: ``stop_all()`` in a
finally and a ``join`` whose timeout fails the test."""

import threading
import time

import numpy as np
import pytest

DEADLINE_S = 30.0
N_ROWS = 300


def _events(seed: int) -> list[tuple]:
    """(op, k, word, n) with op +1 insert / update, -1 remove, in bursts
    separated by None (a pause of a few ms on the reader thread)."""
    rng = np.random.default_rng(seed)
    live: dict[int, tuple] = {}
    out = []
    for i in range(N_ROWS):
        k = int(rng.integers(0, 80))
        if k in live and rng.random() < 0.3:
            out.append((-1, k, *live.pop(k)))
        else:
            if k in live:  # an update: the old row leaves first
                out.append((-1, k, *live[k]))
            row = (f"w{int(rng.integers(0, 7))}", int(rng.integers(-50, 50)))
            live[k] = row
            out.append((1, k, *row))
        if i % 37 == 36:
            out.append(None)
    return out


def _pipeline(side: str, events: list, terminate_on_error=True):
    if side == "jax":
        import pathway_tpu as pw
        from pathway_tpu.engine import streaming
        from pathway_tpu.internals.parse_graph import G
    else:
        import pathway_tpu_torch as pw
        from pathway_tpu_torch.engine import streaming
        from pathway_tpu_torch.internals.parse_graph import G

    class Row(pw.Schema):
        k: int = pw.column_definition(primary_key=True)
        word: str
        n: int

    class Subject(pw.io.python.ConnectorSubject):
        def run(self):
            for ev in events:
                if ev is None:
                    time.sleep(0.004)
                    continue
                op, k, word, n = ev
                if op > 0:
                    self.next(k=k, word=word, n=n)
                else:
                    self._remove(k=k, word=word, n=n)

    G.clear()
    t = pw.io.python.read(Subject(), schema=Row, autocommit_duration_ms=5,
                          name="rows")
    sel = t.select(t.k, word=t.word, n2=t.n * 2, pos=t.n > 0)
    counts = sel.groupby(sel.word).reduce(
        sel.word, c=pw.reducers.count(), s=pw.reducers.sum(sel.n2),
        npos=pw.reducers.sum(pw.cast(int, sel.pos)))
    keyed = counts.with_id_from(counts.word)
    looked = sel.filter(sel.n2 != 0).select(
        sel.k, sel.word, total=keyed.ix(keyed.pointer_from(sel.word)).s)
    outs = {"counts": [], "looked": []}
    for name, table in (("counts", counts), ("looked", looked)):
        pw.io.subscribe(table, lambda key, row, time, is_addition, o=outs[name]:
                        o.append((int(key), tuple(sorted(row.items())),
                                  1 if is_addition else -1)))
    errors = []

    def run():
        try:
            pw.run(terminate_on_error=terminate_on_error)
        except Exception as e:  # re-raised by the caller's assert
            errors.append(e)

    th = threading.Thread(target=run, daemon=True)
    th.start()
    try:
        th.join(DEADLINE_S)
    finally:
        streaming.stop_all()
        th.join(DEADLINE_S)
        G.clear()
    assert not th.is_alive(), f"{side} run outlived its deadline"
    return outs, errors


def _consolidate(events: list) -> dict:
    net: dict = {}
    for key, row, diff in events:
        net[(key, row)] = net.get((key, row), 0) + diff
    return {kr: d for kr, d in net.items() if d}


@pytest.mark.parametrize("seed", [0, 1])
def test_stream_consolidates_equal_to_jax(seed):
    events = _events(seed)
    jax, jerr = _pipeline("jax", events)
    port, terr = _pipeline("torch", events)
    assert not jerr and not terr, (jerr, terr)
    for name in ("counts", "looked"):
        assert _consolidate(port[name]) == _consolidate(jax[name]), name
        # the final state: every key once, with a net diff of +1
        assert all(d == 1 for d in _consolidate(port[name]).values())
    assert len(_consolidate(port["looked"])) > 20


def test_reader_error_reraises_from_run():
    """A reader that raises stops the run and its exception re-raises
    from pw.run, in both packages."""
    import pathway_tpu_torch as pw
    from pathway_tpu_torch.engine import streaming
    from pathway_tpu_torch.internals.parse_graph import G

    class Boom(pw.io.python.ConnectorSubject):
        def run(self):
            self.next(data="x")
            raise KeyError("reader failed")

    G.clear()
    t = pw.io.python.read(Boom(), autocommit_duration_ms=5)
    pw.io.subscribe(t, lambda **kw: None)
    try:
        with pytest.raises(KeyError, match="reader failed"):
            pw.run()
    finally:
        streaming.stop_all()
        G.clear()


def test_reader_error_logged_when_not_terminating():
    import pathway_tpu_torch as pw
    from pathway_tpu_torch.engine import streaming
    from pathway_tpu_torch.internals.error import global_error_log
    from pathway_tpu_torch.internals.parse_graph import G

    class Boom(pw.io.python.ConnectorSubject):
        def run(self):
            raise KeyError("reader failed")

    G.clear()
    n_log = len(global_error_log().entries)
    t = pw.io.python.read(Boom(), autocommit_duration_ms=5)
    pw.io.subscribe(t, lambda **kw: None)
    try:
        pw.run(terminate_on_error=False)
    finally:
        streaming.stop_all()
        G.clear()
    new = global_error_log().entries[n_log:]
    assert [e["kind"] for e in new] == ["connector"]
    assert "reader failed" in new[0]["message"]


def test_operator_error_in_device_leg_reraises(monkeypatch):
    """An exception raised in a tick's device leg (a sink downstream of a
    device-bound map runs on the bridge worker) re-raises from pw.run with
    its own type, carrying the flight recorder's tail as a note."""
    import pathway_tpu_torch as pw
    from pathway_tpu_torch.engine import streaming
    from pathway_tpu_torch.internals.parse_graph import G

    @pw.udf(batch=True, device=True)
    def double(xs) -> int:
        return [2 * x for x in xs]

    class One(pw.io.python.ConnectorSubject):
        def run(self):
            self.next(x=1)

    def sink(**kw):
        raise ZeroDivisionError("in the device leg")

    monkeypatch.setenv("PATHWAY_FLIGHT_RECORDER", "1")
    G.clear()
    t = pw.io.python.read(One(), schema=pw.schema_from_types(x=int),
                          autocommit_duration_ms=5)
    pw.io.subscribe(t.select(y=double(t.x)), sink)
    try:
        with pytest.raises(ZeroDivisionError) as info:
            pw.run()
    finally:
        streaming.stop_all()
        G.clear()
    assert any("flight recorder tail" in n
               for n in getattr(info.value, "__notes__", ()))


@pytest.mark.parametrize("option", [
    {"persistence_config": object()}, {"qos": True},
    {"connector_policy": object()}, {"watchdog": object()},
    {"with_http_server": True}, {"replica_of": "/tmp/root"},
    {"telemetry_config": object()}, {"static_check": "warn"}])
def test_unported_run_options_raise(option):
    import pathway_tpu_torch as pw
    from pathway_tpu_torch.internals.parse_graph import G

    G.clear()
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1, item 6"):
        pw.run(**option)


def test_persistent_storage_env_raises(monkeypatch):
    import pathway_tpu_torch as pw

    monkeypatch.setenv("PATHWAY_PERSISTENT_STORAGE", "/tmp/pstate")
    with pytest.raises(NotImplementedError, match="item 6a"):
        pw.run()


def test_batch_graph_runs_under_run():
    """With no streaming source pw.run runs the batch path to the end."""
    import pathway_tpu_torch as pw
    from pathway_tpu_torch.internals.parse_graph import G

    G.clear()
    t = pw.debug.table_from_rows(pw.schema_from_types(w=str),
                                 [("a", 0, 1), ("b", 0, 1), ("a", 2, 1)],
                                 is_stream=True)
    got, ends = [], []
    pw.io.subscribe(t.groupby(t.w).reduce(t.w, c=pw.reducers.count()),
                    lambda key, row, time, is_addition: got.append(
                        (row["w"], row["c"], time, is_addition)),
                    on_end=lambda: ends.append(len(got)))
    runner = pw.run()
    G.clear()
    assert not runner._stream_subjects
    assert sorted(got) == [("a", 1, 0, True), ("a", 1, 2, False),
                           ("a", 2, 2, True), ("b", 1, 0, True)]
    assert ends == [4]  # on_end once, after every change


def _device_graph(pw, n: int):
    """A python source of ``n`` rows through a device-bound batch map (so
    ticks have a device leg on the bridge) into a subscribe sink."""

    @pw.udf(batch=True, device=True)
    def double(xs) -> int:
        return [2 * x for x in xs]

    class Rows(pw.io.python.ConnectorSubject):
        def run(self):
            for i in range(n):
                self.next(x=i)
                if i % 10 == 9:
                    time.sleep(0.01)

    t = pw.io.python.read(Rows(), schema=pw.schema_from_types(x=int),
                          autocommit_duration_ms=5)
    got = []
    pw.io.subscribe(t.select(y=double(t.x)),
                    lambda key, row, time, is_addition: got.append(row["y"]))
    return got


def test_trace_path_writes_host_and_device_tracks(tmp_path):
    """pw.run(trace_path=...) turns the flight recorder on and writes a
    Chrome trace: host and device leg tracks with operator spans nested
    in per-tick wrappers, and each device leg's queue wait and
    execution."""
    import json

    import pathway_tpu_torch as pw
    from pathway_tpu_torch.engine import streaming
    from pathway_tpu_torch.internals.parse_graph import G

    G.clear()
    got = _device_graph(pw, 40)
    path = tmp_path / "trace.json"
    try:
        pw.run(trace_path=str(path))
    finally:
        streaming.stop_all()
        G.clear()
    assert sorted(got) == [2 * i for i in range(40)]
    events = json.loads(path.read_text())["traceEvents"]
    names = {(e["tid"], e["args"]["name"]) for e in events
             if e["ph"] == "M" and e["name"] == "thread_name"}
    assert names == {(0, "host leg"), (1, "device leg")}
    spans = [e for e in events if e["ph"] in ("B", "E")]
    assert sum(e["ph"] == "B" for e in spans) == \
        sum(e["ph"] == "E" for e in spans) > 0
    device = [e for e in spans if e["ph"] == "B" and e["tid"] == 1
              and e["name"].startswith("tick ")]
    assert device and all("exec_ms" in e["args"] for e in device)
    assert any(e["name"] == "subscribe" and e["tid"] == 1 for e in spans)


def test_monitoring_level_prints_operator_lines(capsys):
    import pathway_tpu_torch as pw
    from pathway_tpu_torch.engine import streaming
    from pathway_tpu_torch.internals.parse_graph import G

    G.clear()
    got = _device_graph(pw, 30)
    try:
        pw.run(monitoring_level=pw.MonitoringLevel.ALL)
    finally:
        streaming.stop_all()
        G.clear()
    assert len(got) == 30
    err = capsys.readouterr().err
    assert "[monitor] t=" in err and "device bridge: in-flight" in err


@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_engine_thread_crash_is_recorded():
    """An uncaught exception in a thread made by engine/threads.spawn
    lands in crashed_threads() and the global error log (kind
    "thread")."""
    from pathway_tpu_torch.engine.threads import (crash_epoch,
                                                  crashed_threads, spawn)
    from pathway_tpu_torch.internals.error import global_error_log

    epoch, n_log = crash_epoch(), len(global_error_log().entries)

    def boom():
        raise LookupError("engine thread failed")

    t = spawn(boom, name="crash-test")
    t.join(DEADLINE_S)
    assert not t.is_alive()
    crashes = crashed_threads(epoch)
    assert [c["thread"] for c in crashes] == ["pathway-tpu-crash-test"]
    assert "LookupError: engine thread failed" in crashes[0]["error"]
    assert [e["kind"] for e in global_error_log().entries[n_log:]] == \
        ["thread"]
