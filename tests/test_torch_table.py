"""The port's engine batch path (Table DSL -> expression compiler ->
GraphRunner) against the JAX package's: the same pipeline over the same
numpy-seeded rows runs through ``pathway_tpu`` and ``pathway_tpu_torch``,
and the captured events (key, row, time, diff), the result schema and the
error-log messages must be equal exactly.

The JAX side runs with ``PATHWAY_AUTO_JIT=0``: the reference compiles
select programs through its auto-jit tier by default, a fused XLA tier the
port does not have and that fails the reference's own tests
(tests/test_autojit.py); with it off the reference evaluates every
expression interpreted, which is what the port does. ``PATHWAY_DEVICE_INFLIGHT=1``
keeps a device-bound UDF's leg on the scheduler's thread, the port's only
schedule.
"""

import math
import typing

import numpy as np
import pytest

import pathway_tpu as jpw
import pathway_tpu_torch as tpw
from pathway_tpu.internals import error as jerror
from pathway_tpu.internals import keys as jkeys
from pathway_tpu.internals.runner import GraphRunner as JRunner
from pathway_tpu_torch.internals import error as terror
from pathway_tpu_torch.internals import keys as tkeys
from pathway_tpu_torch.internals.runner import GraphRunner as TRunner

N_ROWS = 40
SIDES = {"jax": (jpw, JRunner, jerror), "torch": (tpw, TRunner, terror)}


@pytest.fixture(autouse=True)
def _reference_schedule(monkeypatch):
    monkeypatch.setenv("PATHWAY_AUTO_JIT", "0")
    monkeypatch.setenv("PATHWAY_DEVICE_INFLIGHT", "1")


def _rows(seed: int = 0) -> list[tuple]:
    """Rows of (a, b, x, s, o, j): ints with zeros and negatives, floats,
    unique words, an optional int and a JSON dict (as a plain dict; each
    side wraps it in its own Json)."""
    rng = np.random.default_rng(seed)
    a = rng.integers(-20, 20, N_ROWS)
    b = rng.integers(-3, 4, N_ROWS)  # zeros: division by zero
    x = rng.random(N_ROWS)
    o = rng.integers(0, 100, N_ROWS)
    words = [f"w{int(v)}" for v in rng.permutation(1000)[:N_ROWS]]
    return [(int(a[i]), int(b[i]), float(x[i]),
             f"{words[i]} Tok{i % 7} end",
             None if i % 3 == 0 else int(o[i]),
             {"k": int(a[i]), "name": words[i], "tags": [i % 2, i % 5]})
            for i in range(N_ROWS)]


def _base(pw, stream: bool = False):
    schema = pw.schema_from_types(a=int, b=int, x=float, s=str,
                                  o=typing.Optional[int], j=pw.Json)
    rows = [(*r[:5], pw.Json(r[5])) for r in _rows()]
    if stream:  # four ticks, two rows a tick at even times
        rows = [(*r, 2 * (i % 4), 1) for i, r in enumerate(rows)]
    return pw.debug.table_from_rows(schema, rows, is_stream=stream)


# -- the pipelines: each builds its output table from one package --------

def p_arithmetic(pw):
    t = _base(pw)
    return t.select(add=t.a + t.b, sub=t.a - 7, mul=t.a * t.b,
                    fdiv=t.a // 3, mod=t.a % 5, neg=-t.a, fx=t.x * 1.5 + t.a,
                    pw_=t.b ** 2, div=t.x / 4)


def p_comparisons(pw):
    t = _base(pw)
    return t.select(lt=t.a < t.b, le=t.a <= 0, eq=t.b == 0, ne=t.a != t.b,
                    gt=t.x > 0.5, both=(t.a > 0) & (t.x < 0.5),
                    either=(t.b == 0) | ~(t.a > 5))


def p_if_else(pw):
    t = _base(pw)
    return t.select(m=pw.if_else(t.a > t.b, t.a, t.b),
                    f=pw.if_else(t.x > 0.5, t.x, 0.25),
                    s=pw.if_else(t.b == 0, t.s, "zero-free"))


def p_coalesce(pw):
    t = _base(pw)
    return t.select(c=pw.coalesce(t.o, t.a), n=t.o.is_none(),
                    nn=t.o.is_not_none(), r=pw.require(t.a, t.o))


def p_str_methods(pw):
    t = _base(pw)
    return t.select(up=t.s.str.upper(), ln=t.s.str.len(),
                    sw=t.s.str.startswith("w1"), rep=t.s.str.replace("w", "v"),
                    parts=t.s.str.split(" "), sl=t.s.str.slice(1, 4),
                    cnt=t.s.str.count("o"), title=t.s.str.title())


def p_json(pw):
    t = _base(pw)
    return t.select(k=t.j["k"].as_int(), name=t.j["name"].as_str(),
                    tag=t.j["tags"][1], miss=t.j.get("nope", 5),
                    whole=t.j)


def p_row_udf(pw):
    @pw.udf
    def tag(a: int, s: str) -> str:
        return f"{s.split(' ')[0]}:{a * 3}"

    t = _base(pw)
    return t.select(tag=tag(t.a, t.s), plain=t.a)


def p_batch_udf(pw):
    @pw.udf(batch=True, deterministic=True)
    def scaled(xs: list, bs: list) -> list:
        return [x * 10 + b for x, b in zip(xs, bs)]

    t = _base(pw)
    return t.select(v=scaled(t.x, t.b))


def p_batch_udf_max_batch(pw):
    seen: list = []

    @pw.udf(batch=True, deterministic=True, max_batch_size=7)
    def sized(xs: list) -> list:
        seen.append(len(xs))
        return [f"{len(xs)}:{x}" for x in xs]

    t = _base(pw)
    return t.select(v=sized(t.a))


def p_apply(pw):
    t = _base(pw)
    return t.select(v=pw.apply(lambda a, b: a * 100 + b, t.a, t.b),
                    w=pw.apply_with_type(lambda s: len(s), int, t.s))


def p_filter(pw):
    t = _base(pw)
    return t.filter((t.a > t.b) & (t.x < 0.8)).select(pw.this.a, pw.this.s)


def p_flatten(pw):
    t = _base(pw)
    words = t.select(t.a, words=t.s.str.split(" "))
    return words.flatten(pw.this.words, origin_id="origin")


def p_concat(pw):
    t = _base(pw)
    pos = t.filter(t.a > 0).select(t.a, t.s)
    rest = t.filter(t.a <= 0).select(t.a, t.s)
    pos.promise_universes_are_disjoint(rest)
    return pos.concat(rest)


def p_concat_reindex(pw):
    t = _base(pw)
    return t.select(t.a).concat_reindex(t.select(a=t.b))


def p_with_id_from(pw):
    t = _base(pw)
    return t.with_id_from(t.s, t.a).select(pw.this.a, pw.this.s,
                                           me=pw.this.id)


def p_rename_without(pw):
    t = _base(pw)
    return t.rename(alpha=t.a).without(pw.this.j, pw.this.o) \
        .rename_by_dict({"s": "text"}).with_columns(double=pw.this.alpha * 2)


def p_cast(pw):
    t = _base(pw)
    return t.select(t.a, t.x, t.b).cast_to_types(a=float, x=int, b=str)


def p_division_errors(pw):
    t = _base(pw)
    return t.select(t.a, q=t.a / t.b, r=t.a // t.b, m=t.a % t.b,
                    f=(t.a / t.b).fill_error(-1.0))


def p_remove_errors(pw):
    t = _base(pw)
    return t.select(t.a, q=t.a / t.b).remove_errors()


def p_stream_retractions(pw):
    t = pw.debug.table_from_markdown("""
        name  | qty | _time | _diff
        bolt  | 3   | 2     | 1
        screw | 5   | 2     | 1
        nut   | 9   | 4     | 1
        bolt  | 3   | 4     | -1
        bolt  | 4   | 6     | 1
        screw | 5   | 6     | -1
        nut   | 9   | 8     | -1
        nut   | 0   | 8     | 1
        """)
    return t.select(t.name, d=t.qty * 2, inv=10 // t.qty).filter(
        pw.this.d < 15)


def p_stream_ticks(pw):
    t = _base(pw, stream=True)
    return t.select(t.a, v=t.x + t.a, q=t.a // t.b)


def p_stream_keyed_updates(pw):
    """A streamed table_from_rows keyed by value, so a later -1 row retracts
    an earlier +1 row of the same word."""
    schema = pw.schema_from_types(word=str, n=int)
    rows = [("alpha", 1, 0, 1), ("beta", 2, 0, 1), ("alpha", 1, 2, -1),
            ("alpha", 5, 2, 1), ("gamma", 3, 4, 1), ("beta", 2, 4, -1)]
    t = pw.debug.table_from_rows(schema, rows, is_stream=True)
    return t.with_id_from(t.word).select(pw.this.word,
                                         sq=pw.this.n * pw.this.n)


PIPELINES = [p_arithmetic, p_comparisons, p_if_else, p_coalesce,
             p_str_methods, p_json, p_row_udf, p_batch_udf,
             p_batch_udf_max_batch, p_apply, p_filter, p_flatten, p_concat,
             p_concat_reindex, p_with_id_from, p_rename_without, p_cast,
             p_division_errors, p_remove_errors, p_stream_retractions,
             p_stream_ticks, p_stream_keyed_updates]


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
    return (type(v).__name__, v)


def _run(side: str, build):
    pw, Runner, error = SIDES[side]
    log = error.global_error_log()
    n_log = len(log.entries)
    out = build(pw)
    runner = Runner()
    cap = runner.capture(out)
    runner.run_batch(n_workers=1)
    events = sorted(((time, int(key), diff, tuple(_norm(v) for v in row))
                     for key, row, time, diff in cap.events),
                    key=lambda e: e[:3])
    schema = [(n, repr(d)) for n, d in out.schema._dtypes().items()]
    messages = [e["message"] for e in log.entries[n_log:]]
    return events, schema, messages


@pytest.mark.parametrize("build", PIPELINES, ids=lambda f: f.__name__[2:])
def test_pipeline_events_equal_reference(build):
    jev, jschema, jmsg = _run("jax", build)
    tev, tschema, tmsg = _run("torch", build)
    assert jev, "the pipeline produced no events"
    if build in (p_stream_retractions, p_stream_keyed_updates):
        assert any(diff < 0 for _, _, diff, _ in jev), "no retraction"
    assert tschema == jschema
    assert tev == jev
    assert tmsg == jmsg


def test_error_pipelines_log_errors():
    """The division pipeline's ERROR cells come with log entries on both
    sides (the equality above would also hold if neither side logged)."""
    _, _, msgs = _run("torch", p_division_errors)
    assert msgs and all("failed" in m for m in msgs)


_VALUES = [None, True, False, 0, -1, 7, 2**40, -(2**63), 2**63, 2**127 + 5,
           0.0, -0.0, 1.0, 2.5, -1e300, float("inf"), float("nan"), 2.0**70,
           "", "word", "ünïcode ✓", b"", b"\x00\xffbytes", (), (1, "a"),
           ((None, 2.5), (b"x",)), np.int64(-4), np.int32(9), np.float32(1.5),
           np.float64(3.0), np.bool_(True), np.arange(6, dtype=np.int32)
           .reshape(2, 3), np.zeros(0, dtype=np.float64),
           np.array([1.5, -2.0], dtype=np.float32)]


@pytest.mark.parametrize("value", _VALUES, ids=repr)
def test_hash_values_uncached_equals_reference(value):
    assert int(tkeys.hash_values_uncached("row", 3, value)) \
        == int(jkeys.hash_values_uncached("row", 3, value))
    assert int(tkeys.hash_values_uncached(value)) \
        == int(tkeys.hash_values(value))


def test_hash_values_uncached_pointers_and_json():
    for v in (0, 1, 2**128 - 1, 12345678901234567890):
        assert int(tkeys.hash_values_uncached(tkeys.Pointer(v), "x")) \
            == int(jkeys.hash_values_uncached(jkeys.Pointer(v), "x"))
    doc = {"b": [1, 2.5, None], "a": {"z": "ü", "y": True}}
    assert int(tkeys.hash_values_uncached("row", 0, tpw.Json(doc))) \
        == int(jkeys.hash_values_uncached("row", 0, jpw.Json(doc)))
    assert int(tkeys.mix_pointers(tkeys.Pointer(7), 3)) \
        == int(jkeys.mix_pointers(jkeys.Pointer(7), 3))


def test_table_from_rows_keys_equal_reference():
    schema_t = tpw.schema_from_types(a=int, b=int, x=float, s=str,
                                     o=typing.Optional[int], j=tpw.Json)
    schema_j = jpw.schema_from_types(a=int, b=int, x=float, s=str,
                                     o=typing.Optional[int], j=jpw.Json)
    rows = _rows(seed=3)
    tt = tpw.debug.table_from_rows(
        schema_t, [(*r[:5], tpw.Json(r[5])) for r in rows])
    jt = jpw.debug.table_from_rows(
        schema_j, [(*r[:5], jpw.Json(r[5])) for r in rows])
    assert [int(k) for k in tt._plan.params["keys"]] \
        == [int(k) for k in jt._plan.params["keys"]]


@pytest.mark.parametrize("call", [
    lambda t: t.update_id_type(int),
    lambda t: t._gradual_broadcast(t, t.a, t.a, t.a),
    lambda t: t.show(),
    lambda t: t.plot(),
    lambda t: t.live(),
    lambda t: t.slice,
], ids=["update_id_type", "_gradual_broadcast", "show", "plot", "live",
        "slice"])
def test_unported_operations_raise(call):
    t = _base(tpw)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        call(t)


def test_unported_runner_options_raise():
    t = _base(tpw)
    runner = TRunner()
    runner.capture(t.select(t.a))
    with pytest.raises(NotImplementedError, match="ROADMAP.*item 6f"):
        runner.run_batch(n_workers=2, cluster=object())
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tpw.debug.table_from_pandas(None)
