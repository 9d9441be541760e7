"""The port's file connectors (io/fs, io/csv, io/plaintext, io/jsonlines,
io/formats) against the JAX package's: the same files, made from numpy
draws of one seed under ``tmp_path``, read by each package.

- Static reads, every ported format, with and without metadata, through
  ``pw.io.fs.read`` and the three wrappers, under each package's
  ``GraphRunner.run_batch``: keys, rows, times and diffs equal exactly.
- Streaming reads under ``pw.run`` (``pw.io.subscribe``): the first files,
  then one file rewritten, then a new file, each step awaited (30 s at
  most) before the next, so that both readers assign the same sequence
  numbers; the consolidated output equal exactly. ``created_at`` is
  left out of the metadata there: each package's run writes the files
  itself, and a file's ctime cannot be set.
- csv and JSON-lines writes under ``pw.run``: the files' lines equal.
- ``parse_payload``, ``DsvParser`` and ``DsvFormatter`` on the same
  payloads: equal.

Both packages number their sources from a module counter and stamp
``seen_at`` from the clock, so each test resets the counters and fixes
``seen_at`` on both sides. The JAX side runs with ``PATHWAY_AUTO_JIT=0``
and ``PATHWAY_DEVICE_INFLIGHT=1``."""

import itertools
import json
import os
import threading
import time
import types

import numpy as np
import pytest

DEADLINE_S = 30.0
FORMATS = ["plaintext", "plaintext_by_file", "binary", "csv", "json"]
WORDS = [f"w{i}" for i in range(50)]


@pytest.fixture(autouse=True)
def _reference_schedule(monkeypatch):
    monkeypatch.setenv("PATHWAY_AUTO_JIT", "0")
    monkeypatch.setenv("PATHWAY_DEVICE_INFLIGHT", "1")


def _side(side: str):
    if side == "jax":
        import pathway_tpu as pw
        from pathway_tpu.engine import streaming
        from pathway_tpu.internals.parse_graph import G
        from pathway_tpu.internals.runner import GraphRunner
        from pathway_tpu.io import _datasource, formats
        from pathway_tpu.io import fs
    else:
        import pathway_tpu_torch as pw
        from pathway_tpu_torch.engine import streaming
        from pathway_tpu_torch.internals.parse_graph import G
        from pathway_tpu_torch.internals.runner import GraphRunner
        from pathway_tpu_torch.io import _datasource, formats
        from pathway_tpu_torch.io import fs
    return types.SimpleNamespace(pw=pw, streaming=streaming, G=G,
                                 GraphRunner=GraphRunner, ds=_datasource,
                                 formats=formats, fs=fs)


def _fix_clock_and_counters(monkeypatch, m):
    monkeypatch.setattr(m.fs, "_time",
                        types.SimpleNamespace(time=lambda: 1_700_000_000.0))
    monkeypatch.setattr(m.ds, "_source_counter", itertools.count(3))


def _norm(v):
    """Values comparable across the packages: Json as its value, dicts
    as sorted item tuples."""
    if type(v).__name__ == "Json":
        v = v.value
    if isinstance(v, dict):
        return tuple(sorted((k, _norm(x)) for k, x in v.items()))
    if isinstance(v, (list, tuple)):
        return tuple(_norm(x) for x in v)
    return v


def _file_payloads(fmt: str, seed: int, n_files: int = 3) -> list:
    rng = np.random.default_rng(seed)
    out = []
    for f in range(n_files):
        n = int(rng.integers(2, 6))
        if fmt == "csv":
            lines = ["a,b,c"] + [
                f"{int(rng.integers(-9, 99))},{float(rng.normal()):.6f},"
                f"{WORDS[int(rng.integers(0, 50))]}" for _ in range(n)]
            out.append("\n".join(lines) + "\n")
        elif fmt == "json":
            out.append("".join(json.dumps({
                "a": int(rng.integers(-9, 99)),
                "b": round(float(rng.normal()), 6),
                "c": WORDS[int(rng.integers(0, 50))]}) + "\n"
                for _ in range(n)))
        else:
            out.append("\n".join(
                " ".join(WORDS[int(j)] for j in rng.integers(0, 50, 4))
                for _ in range(n)) + "\n")
    return out


def _write(dirpath, payloads, first=0, mtime=1_600_000_000):
    os.makedirs(dirpath, exist_ok=True)
    for i, text in enumerate(payloads):
        p = os.path.join(dirpath, f"f{first + i}.txt")
        with open(p, "w") as f:
            f.write(text)
        os.utime(p, (mtime + i, mtime + i))


def _schema(m, fmt):
    if fmt in ("csv", "json"):
        return m.pw.schema_from_types(a=int, b=float, c=str)
    return None


def _read(m, entry: str, fmt: str, path: str, mode: str, wm: bool):
    if entry == "fs":
        return m.pw.io.fs.read(path, format=fmt, schema=_schema(m, fmt),
                               mode=mode, with_metadata=wm)
    if entry == "csv":  # schema read from the first file
        return m.pw.io.csv.read(path, mode=mode, with_metadata=wm)
    if entry == "jsonlines":
        return m.pw.io.jsonlines.read(path, schema=_schema(m, "json"),
                                      mode=mode, with_metadata=wm)
    return m.pw.io.plaintext.read(path, mode=mode, with_metadata=wm)


def _entry_format(entry: str, fmt: str | None) -> str:
    return fmt or {"csv": "csv", "jsonlines": "json",
                   "plaintext": "plaintext"}[entry]


STATIC = [("fs", f) for f in FORMATS] + [
    ("csv", None), ("jsonlines", None), ("plaintext", None)]


@pytest.mark.parametrize("with_metadata", [False, True],
                         ids=["rows", "metadata"])
@pytest.mark.parametrize("entry,fmt", STATIC,
                         ids=[f"{e}-{f or 'default'}" for e, f in STATIC])
def test_static_read_equals_reference(tmp_path, monkeypatch, entry, fmt,
                                      with_metadata):
    fmt_ = _entry_format(entry, fmt)
    _write(tmp_path / "in", _file_payloads(fmt_, seed=len(fmt_)))
    got = {}
    for side in ("jax", "torch"):
        m = _side(side)
        _fix_clock_and_counters(monkeypatch, m)
        m.G.clear()
        t = _read(m, entry, fmt, str(tmp_path / "in"), "static",
                  with_metadata)
        runner = m.GraphRunner()
        cap = runner.capture(t)
        runner.run_batch(n_workers=1)
        got[side] = (t.column_names(), sorted(
            (int(k), _norm(row), time_, diff)
            for k, row, time_, diff in cap.events))
        m.G.clear()
    assert got["torch"] == got["jax"]
    assert len(got["torch"][1]) >= 3


def _stream(side: str, monkeypatch, root, entry, fmt, wm, steps):
    """Run the read under ``pw.run``; ``steps`` are (payload writer, the
    net row count to await) run in turn. Returns the subscribed events."""
    m = _side(side)
    _fix_clock_and_counters(monkeypatch, m)
    m.G.clear()
    t = _read(m, entry, fmt, str(root), "streaming", wm)
    events: list = []
    lock = threading.Lock()

    def on_change(key, row, time, is_addition):
        meta = row.get("_metadata")
        if meta is not None:  # each run writes its files: ctime differs
            meta = {k: v for k, v in _norm_json(meta).items()
                    if k != "created_at"}
            row = {**row, "_metadata": meta}
        with lock:
            events.append((int(key), _norm(row), 1 if is_addition else -1))

    m.pw.io.subscribe(t, on_change)
    errors = []

    def run():
        try:
            m.pw.run()
        except Exception as e:  # re-raised by the caller's assert
            errors.append(e)

    th = threading.Thread(target=run, daemon=True)
    th.start()
    try:
        for write, want in steps:
            write()
            deadline = time.monotonic() + DEADLINE_S
            while True:
                with lock:
                    net = sum(d for _, _, d in events)
                if net == want or errors:
                    break
                assert time.monotonic() < deadline, (side, net, want)
                time.sleep(0.02)
    finally:
        m.streaming.stop_all()
        th.join(DEADLINE_S)
        m.G.clear()
    assert not th.is_alive(), f"{side} run outlived its deadline"
    assert not errors, errors
    return events


def _norm_json(v):
    return v.value if type(v).__name__ == "Json" else dict(v)


STREAMING = [("fs", "plaintext_by_file"), ("fs", "plaintext"),
             ("fs", "binary"), ("csv", None), ("jsonlines", None)]


@pytest.mark.parametrize("with_metadata", [False, True],
                         ids=["rows", "metadata"])
@pytest.mark.parametrize("entry,fmt", STREAMING,
                         ids=[f"{e}-{f or 'default'}" for e, f in STREAMING])
def test_streaming_read_equals_reference(tmp_path, monkeypatch, entry, fmt,
                                         with_metadata):
    """First files, one rewritten (its rows retracted, the new ones
    inserted), a new file: the consolidated stream equals the JAX
    package's."""
    fmt_ = _entry_format(entry, fmt)
    first = _file_payloads(fmt_, seed=11)
    rewrite = _file_payloads(fmt_, seed=12, n_files=1)
    extra = _file_payloads(fmt_, seed=13, n_files=1)

    def count(payloads):
        if fmt_ in ("plaintext_by_file", "binary"):
            return len(payloads)
        # a header line for csv; one row a line otherwise
        return sum(p.count("\n") - (fmt_ == "csv") for p in payloads)

    n0 = count(first)
    n1 = n0 - count(first[1:2]) + count(rewrite)
    n2 = n1 + count(extra)
    got = {}
    for side in ("jax", "torch"):
        root = tmp_path / side
        os.makedirs(root)
        _write(root, first)
        steps = [(lambda: None, n0),
                 (lambda: _write(root, rewrite, first=1,
                                 mtime=1_650_000_000), n1),
                 (lambda: _write(root, extra, first=len(first)), n2)]
        events = _stream(side, monkeypatch, root, entry, fmt, with_metadata,
                         steps)
        net: dict = {}
        for key, row, diff in events:
            row = _unroot(row, str(root))
            net[(key, row)] = net.get((key, row), 0) + diff
        got[side] = {kr: d for kr, d in net.items() if d}
    assert got["torch"] == got["jax"]
    assert len(got["torch"]) == n2


def _unroot(row, root):
    """The metadata's path without the run's own directory."""
    out = []
    for k, v in row:
        if k == "_metadata":
            v = tuple((mk, mv.replace(root, "ROOT")
                       if isinstance(mv, str) else mv) for mk, mv in v)
        out.append((k, v))
    return tuple(out)


@pytest.mark.parametrize("entry", ["fs-csv", "fs-json", "csv", "jsonlines"])
def test_writes_equal_reference(tmp_path, entry):
    """A static table written by each package under ``pw.run``: the same
    lines (header, rows with time and diff)."""
    rng = np.random.default_rng(5)
    rows = [(int(rng.integers(0, 99)), WORDS[int(rng.integers(0, 50))],
             float(rng.normal())) for _ in range(12)]
    out = {}
    for side in ("jax", "torch"):
        m = _side(side)
        m.G.clear()
        t = m.pw.debug.table_from_rows(
            m.pw.schema_from_types(a=int, c=str, b=float), rows)
        path = str(tmp_path / side / "out.txt")
        if entry.startswith("fs-"):
            m.pw.io.fs.write(t, path, format=entry[3:])
        elif entry == "csv":
            m.pw.io.csv.write(t, path)
        else:
            m.pw.io.jsonlines.write(t, path)
        m.pw.run()
        m.G.clear()
        with open(path) as f:
            lines = f.read().splitlines()
        out[side] = (lines[:1], sorted(lines[1:])) \
            if entry in ("fs-csv", "csv") else (None, sorted(lines))
    assert out["torch"] == out["jax"]
    assert len(out["torch"][1]) == 12


PAYLOADS = {
    "plaintext": b"one line\nsecond  line\n\nlast",
    "plaintext_by_file": b"all of it\nin one row",
    "binary": b"\x00\x01raw\xff",
    "csv": b'a,b,c\n1,2.5,x\n-3,0.25,"quoted, comma"\n',
    "dsv": b"a;b;c\n1;2.5;x\n7;-1;y\n",
    "json": b'{"a": 1, "b": 2.5, "c": "x"}\n\n{"a": 2, "b": -1, "c": "y"}\n',
}


@pytest.mark.parametrize("fmt", sorted(PAYLOADS))
def test_parse_payload_equals_reference(fmt):
    j, t = _side("jax"), _side("torch")
    kw = {"dsv_separator": ";"} if fmt == "dsv" else {}
    want = j.formats.parse_payload(
        PAYLOADS[fmt], fmt, j.pw.schema_from_types(a=int, b=float, c=str),
        **kw)
    got = t.formats.parse_payload(
        PAYLOADS[fmt], fmt, t.pw.schema_from_types(a=int, b=float, c=str),
        **kw)
    assert _norm(got) == _norm(want)


@pytest.mark.parametrize("separator", [",", ";", "\t"])
def test_dsv_parser_and_formatter_equal_reference(separator):
    j, t = _side("jax"), _side("torch")
    rng = np.random.default_rng(ord(separator))
    header = separator.join(["k", "n", "x", "flag"])
    lines = [header] + [separator.join([
        WORDS[int(rng.integers(0, 50))], str(int(rng.integers(-5, 5))),
        f"{float(rng.normal()):.4f}", str(bool(rng.integers(0, 2)))])
        for _ in range(8)]
    text = "\n".join(lines) + "\n"
    out = {}
    for name, m in (("jax", j), ("torch", t)):
        schema = m.pw.schema_from_types(k=str, n=int, x=float, flag=bool)
        parser = m.formats.DsvParser(separator=separator, schema=schema,
                                     key_columns=["k"])
        events = [(e.kind, e.key, _norm(e.values))
                  for e in parser.parse_lines(text)]
        fmt = m.formats.DsvFormatter(["k", "n", "x"], separator=separator)
        formatted = [fmt.header()] + [
            fmt.format({"k": "a,b", "n": i, "x": 0.5 * i}, 2 * i,
                       1 - 2 * (i % 2))
            for i in range(3)]
        out[name] = (events, formatted)
    assert out["torch"] == out["jax"]
    with pytest.raises(t.formats.ParseError):
        t.formats.DsvParser(separator="::")


def test_unported_formats_raise_naming_their_step(tmp_path):
    t = _side("torch")
    with pytest.raises(NotImplementedError, match="step 9"):
        t.pw.io.fs.read(str(tmp_path), format="parquet",
                        schema=t.pw.schema_from_types(a=int))
    table = t.pw.debug.table_from_rows(t.pw.schema_from_types(a=int), [(1,)])
    with pytest.raises(NotImplementedError, match="step 9"):
        t.pw.io.fs.write(table, str(tmp_path / "x.parquet"),
                         format="parquet")
    for cls in ("DebeziumMessageParser", "PsqlUpdatesFormatter",
                "PsqlSnapshotFormatter"):
        with pytest.raises(NotImplementedError, match="step 7"):
            getattr(t.formats, cls)()
    t.G.clear()
