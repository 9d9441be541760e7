"""The port's native engine passes (``pathway_tpu_torch/native/fastjoin.cpp``
and ``fastgroup.cpp``, built with g++ into ``pathway_tpu_torch/_build/``)
against its own Python loops and against the JAX package, exactly: the
consolidated events (key, row, time, diff) of the same pipeline over the
same rows, keys included — which pins the native 128-bit output-key mix
to ``internals/keys.py``'s ``mix_pointers``.

Pipelines: the JAX package's tests/test_native_fastpath.py (groupby churn,
join upsert fusion, retractions, None and mixed-type join keys), np.str_
join keys, and bench.py's bench_etl graph (WordCount + a dimension join)
at 5,000 rows and 10 ticks. Also: each package loads its own extension
modules in one process, a failed build leaves the Python loops running
and says why, and the JAX package takes neither pass on
bench_embed_framework's graph or on the RAG server's statistics.
"""

import logging
import os
import subprocess
import sys

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
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _reference_schedule(monkeypatch):
    monkeypatch.setenv("PATHWAY_AUTO_JIT", "0")
    monkeypatch.setenv("PATHWAY_DEVICE_INFLIGHT", "1")


def _events(side: str, build, native: bool, monkeypatch):
    """Consolidated events of ``build(pw)`` under one package, with its
    passes on (asserted built) or off; and the graph's operators."""
    pw, Runner, ops = SIDES[side]
    with monkeypatch.context() as m:
        if native:
            assert ops._get_fastjoin() is not None
            assert ops._get_fastgroup() is not None
        else:
            m.setattr(ops, "_FASTJOIN", None)
            m.setattr(ops, "_FASTGROUP", None)
        runner = Runner()
        cap = runner.capture(build(pw))
        runner.run_batch(n_workers=1)
    events = sorted((time, int(key), diff, tuple(_norm(v) for v in row))
                    for key, row, time, diff in cap.consolidated_events())
    return events, [n.op for n in runner.graph.nodes]


def p_fastpath(pw):
    """tests/test_native_fastpath.py's pipeline."""
    rows = []
    for i in range(300):
        rows.append((f"k{i % 17}", i % 5, 2 * (i % 7), 1))
        if i % 11 == 0 and i > 0:
            rows.append(rows[i - 2][:2] + (2 * (i % 7) + 2, -1))
    t = pw.debug.table_from_rows(
        pw.schema_from_types(word=str, qty=int), rows, is_stream=True)
    lex = pw.debug.table_from_rows(
        pw.schema_from_types(word=str, cat=str),
        [(f"k{j}", f"c{j % 3}") for j in range(17)])
    g = t.groupby(t.word).reduce(
        t.word, n=pw.reducers.count(), s=pw.reducers.sum(t.qty),
        m=pw.reducers.avg(t.qty))
    return g.join(lex, g.word == lex.word).select(g.word, g.n, g.s, lex.cat)


def p_str_subclass_keys(pw):
    left = pw.debug.table_from_rows(
        pw.schema_from_types(k=str, x=int),
        [(np.str_("a"), 1), ("b", 2), (np.str_("c"), 3)])
    right = pw.debug.table_from_rows(
        pw.schema_from_types(k=str, y=int),
        [("a", 10), (np.str_("b"), 20), (None, 30)])
    return left.join(right, left.k == right.k).select(left.x, right.y)


def p_mixed_keys_streamed(pw):
    """Join keys of mixed types in a stream with churn: ints, integral
    floats, numpy ints, bools and None, a groupby in front."""
    rng = np.random.default_rng(3)
    vals = [1, 1.0, np.int64(1), True, 2, 2.5, None, np.float64(2.0)]
    rows = [(vals[int(rng.integers(len(vals)))], int(rng.integers(0, 9)),
             2 * int(rng.integers(0, 4)), 1) for _ in range(120)]
    rows += [(r[0], r[1], r[2] + 1, -1) for r in rows[::5]]
    import typing

    t = pw.debug.table_from_rows(
        pw.schema_from_types(k=typing.Any, q=int), rows, is_stream=True)
    dim = pw.debug.table_from_rows(
        pw.schema_from_types(k=typing.Any, name=str),
        [(v, f"n{i}") for i, v in enumerate([1, 2, 2.5, True, None])])
    g = t.groupby(t.k).reduce(t.k, n=pw.reducers.count(),
                              s=pw.reducers.sum(t.q))
    return g.join(dim, g.k == dim.k).select(g.k, g.n, g.s, dim.name)


def etl(pw, n_rows: int = 5_000, n_ticks: int = 10, vocab: int = 500):
    """bench.py's bench_etl run_once graph (bench.py:1853-1918): rows drawn
    from default_rng(0) in bench's order, WordCount, the dimension join."""
    rng = np.random.default_rng(0)
    words = rng.integers(0, vocab, size=n_rows)
    qtys = rng.integers(1, 10, size=n_rows)
    ticks = np.sort(rng.integers(0, n_ticks, size=n_rows))

    class S(pw.Schema):
        word: str
        qty: int

    class L(pw.Schema):
        word: str
        cat: str

    events = pw.debug.table_from_rows(
        S, [(f"w{words[i]}", int(qtys[i]), int(ticks[i]) * 2, 1)
            for i in range(n_rows)], is_stream=True)
    lex = pw.debug.table_from_rows(
        L, [(f"w{i}", f"cat{i % 7}") for i in range(vocab)])
    counts = events.groupby(events.word).reduce(
        events.word, n=pw.reducers.count(),
        total=pw.reducers.sum(events.qty))
    return counts.join(lex, counts.word == lex.word).select(
        counts.word, counts.n, counts.total, lex.cat)


PIPELINES = [p_fastpath, p_str_subclass_keys, p_mixed_keys_streamed, etl]


@pytest.mark.parametrize("build", PIPELINES,
                         ids=["fastpath", "str_subclass_keys",
                              "mixed_keys_streamed", "bench_etl"])
def test_native_and_python_loops_equal_reference(build, monkeypatch):
    port_native, ops = _events("torch", build, True, monkeypatch)
    port_python, _ = _events("torch", build, False, monkeypatch)
    ref_native, _ = _events("jax", build, True, monkeypatch)
    ref_python, _ = _events("jax", build, False, monkeypatch)
    assert port_native, "the pipeline produced no events"
    assert port_native == port_python
    assert port_native == ref_native == ref_python
    # the passes ran: the join's on every tick with input, the groupby's
    # where the lowering chose the columnar operator
    join = next(op for op in ops if isinstance(op, tops.JoinOperator))
    assert join.native_steps > 0
    for op in ops:
        if isinstance(op, tops.ColumnarGroupByOperator):
            assert op.native_steps > 0


def test_bench_etl_graph_lowers_as_the_reference():
    """bench_etl's graph: the columnar groupby and the inner bilinear join
    with a direct projection, in both packages."""
    types = {}
    for side, (pw, Runner, _) in SIDES.items():
        runner = Runner()
        runner.capture(etl(pw))
        types[side] = [type(n.op).__name__ for n in runner.graph.nodes]
    assert types["torch"] == types["jax"]
    assert types["torch"].count("ColumnarGroupByOperator") == 1
    assert "GroupByOperator" not in types["torch"]
    assert "MapOperator" not in types["torch"]


def test_str_subclass_join_keys_match_plain_str(monkeypatch):
    """np.str_ keys join plain str on both paths (the JAX package's
    test_str_subclass_join_keys_match_plain_str_on_both_paths)."""
    for native in (True, False):
        with monkeypatch.context() as m:
            if not native:
                m.setattr(tops, "_FASTJOIN", None)
                m.setattr(tops, "_FASTGROUP", None)
            runner = TRunner()
            cap = runner.capture(p_str_subclass_keys(tpw))
            runner.run_batch(n_workers=1)
        assert sorted(cap.snapshot().values()) == [(1, 10), (2, 20)]


def test_each_package_loads_its_own_modules():
    """With both packages' passes loaded in one process, each package holds
    its own module, built from its own source into its own directory."""
    tj, tg = tops._get_fastjoin(), tops._get_fastgroup()
    jj, jg = jops._get_fastjoin(), jops._get_fastgroup()
    assert None not in (tj, tg, jj, jg), tops.NATIVE_ERRORS
    assert (tj.__name__, tg.__name__) == ("torch_fastjoin", "torch_fastgroup")
    assert (jj.__name__, jg.__name__) == ("fastjoin", "fastgroup")
    port_build = os.path.join(REPO, "pathway_tpu_torch", "_build")
    for mod in (tj, tg):
        assert os.path.dirname(mod.__file__) == port_build
    for mod in (jj, jg):
        assert not mod.__file__.startswith(port_build)
        assert mod.__file__.startswith(os.path.join(REPO, "pathway_tpu"))
    assert tj is not jj and tg is not jg


@pytest.mark.parametrize("first", ["jax", "torch"])
def test_load_order_does_not_matter(first):
    """In a fresh interpreter, whichever package loads its passes first,
    the other still gets its own modules."""
    code = f"""
import os, sys
sys.path.insert(0, {REPO!r})
from pathway_tpu.native.build import load_extension as jload
from pathway_tpu_torch.native.build import load_extension as tload
order = [("jax", jload), ("torch", tload)]
if {first!r} == "torch":
    order.reverse()
mods = {{side: (load("fastjoin"), load("fastgroup")) for side, load in order}}
print(*[m.__name__ + "=" + m.__file__ for side in ("jax", "torch")
        for m in mods[side]])
"""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, env=env, cwd=REPO)
    assert out.returncode == 0, out.stderr
    got = dict(item.split("=", 1) for item in out.stdout.split())
    port_build = os.path.join(REPO, "pathway_tpu_torch", "_build")
    assert set(got) == {"fastjoin", "fastgroup", "torch_fastjoin",
                        "torch_fastgroup"}
    for name, path in got.items():
        assert path.startswith(port_build) == name.startswith("torch_")


def test_failed_build_runs_the_python_loops(monkeypatch, caplog):
    """A pass that does not build: a warning, the reason in NATIVE_ERRORS,
    and the Python loops give the same events."""
    from pathway_tpu_torch.native import build

    def no_build(name):
        raise build.NativeBuildError(f"native build failed for {name}: test")

    want, _ = _events("torch", p_fastpath, True, monkeypatch)
    monkeypatch.setattr(build, "load_extension", no_build)
    monkeypatch.setattr(tops, "_FASTJOIN", False)
    monkeypatch.setattr(tops, "_FASTGROUP", False)
    monkeypatch.setattr(tops, "NATIVE_ERRORS", {})
    with caplog.at_level(logging.WARNING, logger="pathway_tpu_torch"):
        runner = TRunner()
        cap = runner.capture(p_fastpath(tpw))
        runner.run_batch(n_workers=1)
    assert tops._get_fastjoin() is None and tops._get_fastgroup() is None
    assert set(tops.NATIVE_ERRORS) == {"fastjoin", "fastgroup"}
    assert "NativeBuildError" in tops.NATIVE_ERRORS["fastjoin"]
    assert sum("pure-Python" in r.getMessage() for r in caplog.records) == 2
    got = sorted((time, int(key), diff, tuple(_norm(v) for v in row))
                 for key, row, time, diff in cap.consolidated_events())
    assert got == want


def test_build_without_python_h_names_the_include_path(monkeypatch,
                                                       tmp_path):
    """The passes need Python.h: a build against an include directory
    without it fails with g++'s message, naming the header."""
    import sysconfig

    from pathway_tpu_torch.native import build

    monkeypatch.setattr(build, "_BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(sysconfig, "get_paths",
                        lambda: {"include": str(tmp_path / "no-include")})
    with pytest.raises(build.NativeBuildError, match="Python.h"):
        build.ensure_built("fastgroup", python_api=True)


def test_reference_takes_no_pass_on_framework_and_statistics(monkeypatch):
    """On bench_embed_framework's graph (``retrieve_query``) and on the RAG
    server's ``statistics_query``, the JAX package calls neither native
    pass and builds no ColumnarGroupByOperator: ``ix`` and
    ``join_left(..., id=...)`` key by one side's id (not bilinear, so no
    native join), and the collapse (sorted_tuple) and statistics (tuple)
    groupbys are not in the columnar set. The port builds the same
    operators."""
    from test_torch_vector_store import _queries_table, _server

    from pathway_tpu_torch.models.encoder import (EncoderConfig,
                                                  init_params_host)

    params = init_params_host(0, EncoderConfig.tiny())
    monkeypatch.setenv("PATHWAY_RESULT_CACHE", "0")
    built = {}
    for side, (pw, Runner, ops) in SIDES.items():
        record = {"fastjoin": 0, "fastgroup": 0, "ops": []}
        for name in ("_get_fastjoin", "_get_fastgroup"):
            real = getattr(ops, name)

            def counted(_real=real, _key=name[5:]):
                record[_key] += 1
                return _real()

            monkeypatch.setattr(ops, name, counted)
        pw, store = _server(side, params, False, "float32", False)
        for build in (lambda: store.retrieve_query(_queries_table(pw)),
                      lambda: store.statistics_query(pw.debug.table_from_rows(
                          store.StatisticsQuerySchema, [(t, 1) for t in
                                                        (0, 5, 12)],
                          is_stream=True))):
            runner = Runner()
            cap = runner.capture(build())
            runner.run_batch(n_workers=1)
            assert cap.events
            for node in runner.graph.nodes:
                op = node.op
                if isinstance(op, ops.JoinOperator):
                    record["ops"].append(("join", op.mode, op._bilinear))
                elif type(op).__name__.endswith("GroupByOperator"):
                    record["ops"].append((type(op).__name__,))
        built[side] = record
    ref = built["jax"]
    assert ref["fastjoin"] == ref["fastgroup"] == 0
    assert sorted(ref["ops"]) == [("GroupByOperator",), ("GroupByOperator",),
                                  ("join", "inner", False),
                                  ("join", "left", False)]
    assert built["torch"] == ref
