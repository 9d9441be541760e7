"""The port's auto-jit tier (pathway_tpu_torch/internals/autojit.py)
against the JAX package's (pathway_tpu/internals/autojit.py), on the CPU.

The same pipelines over the same numpy-seeded rows run through both
packages, with the tier on and off. The port's tier runs here with its
device patched to the CPU (``_autojit_device``): the device partition's
torch ops run eagerly instead of as CUDA graph replays. Held:

- **events**: the port with the tier on equals the port with it off, and
  both equal the JAX package's with it off and with it on (the JAX
  package's XLA probe fails on this host — its installed JAX has no
  ``jax.experimental.enable_x64`` — so its "on" runs the numpy backend):
  every (time, key, diff, row) equal, each cell's type included;
- **partition**: each fused program's (expr_idx, device partition, numpy
  partition) equals the JAX ``FusedProgram``'s (expr_idx, _xla_part,
  _np_part) — the exactness gate is the reference's, rule for rule;
- **lowering**: node kinds, operator classes and ``device_bound`` flags
  equal the JAX runner's (the host/device map split included, at 1 and
  at 8 workers);
- **counters**: every assertion of tests/test_autojit.py, which mirrors
  test for test here — including the five the JAX package fails on this
  host, where its tier demotes at the probe;
- **no card**: a program with device trees raises when no card is there;
  it never demotes to numpy.
"""

from __future__ import annotations

import gc
import importlib
import logging
import math
from dataclasses import dataclass

import numpy as np
import pytest
import torch

import pathway_tpu as jpw
import pathway_tpu_torch as tpw
from pathway_tpu.internals import autojit as jaj
from pathway_tpu.internals import error as jerror
from pathway_tpu.internals.parse_graph import G as JG
from pathway_tpu.internals.runner import GraphRunner as JRunner
from pathway_tpu_torch.engine import device_sanitizer
from pathway_tpu_torch.internals import autojit as taj
from pathway_tpu_torch.internals import error as terror
from pathway_tpu_torch.internals.parse_graph import G as TG
from pathway_tpu_torch.internals.runner import GraphRunner as TRunner

SIDES = {"jax": (jpw, JRunner, jaj, JG, jerror),
         "torch": (tpw, TRunner, taj, TG, terror)}


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    monkeypatch.setattr(taj, "_autojit_device", lambda: torch.device("cpu"))
    monkeypatch.setenv("PATHWAY_DEVICE_INFLIGHT", "1")
    monkeypatch.delenv("PATHWAY_AUTO_JIT_WARM_MAX", raising=False)
    for _, _, aj, g, _ in SIDES.values():
        g.clear()
        aj.reset_stats()
    gc.collect()  # drain dead programs out of the weak registries
    yield
    for _, _, aj, g, _ in SIDES.values():
        g.clear()
        aj.reset_stats()


# -- the UDF zoo, one plain function each; each package wraps its own -------

def boost(x: int) -> int:
    return x * 3 + 7


def gate(y: float) -> float:
    return y if y < 0.75 else 0.75


def mixf(x: int, y: float) -> float:
    return x * 0.0001 + y * 0.5


def rootp(y: float) -> float:
    return math.sqrt(y) + 1.0


def stepi(x: int) -> int:
    return (x % 7) + (x // 3)


def cube(x: int) -> int:
    return x * x * x  # 93-bit bound: provably unfusable (bigint exact)


def tag(x: int) -> str:
    return f"doc-{x % 97}"


def half(x: int) -> float:
    return x * 0.5  # int64 tensor times a float: float64, as in numpy


def sneaky(x: int) -> int:
    return x or 7  # BoolOp: returns an operand by truthiness


def modmul(x: int, y: int) -> int:
    return (-1 % y) * x * x


def past53lit(x: int) -> bool:
    return x * x > 4611686014132420608.0  # x*x provable to 62 bits


def bitmul(x: int) -> int:
    return (-1 & (x * x)) * x


def tag_nd(x: int) -> str:
    return f"t-{x % 5}"


_SCALE = 7.5  # non-module global: fused snapshots would go stale


def scaled_global(y: float) -> float:
    return y * _SCALE


def int_cast_product(y):
    return int(y * 1e17) * int(y * 1e17)


def make_local_root():
    import math  # noqa: F401 — deliberately shadows the module global

    def local_root(y: float) -> float:
        return math.sqrt(y) + 0.5

    return local_root


def make_triple(package: str):
    """The UDF decorated through a name imported in the enclosing scope
    (bench.py's shape): decorators resolve at def time, not per call."""
    pw2 = importlib.import_module(package)

    @pw2.udf
    def triple(x: int) -> int:
        return x * 3 + 1

    return triple


def make_scaled(factor: list):
    k = factor[0]

    def scaled(x: int) -> int:
        return x * k

    return scaled


_DETERMINISTIC = {"tag"}


def udfs(pw) -> dict:
    """The zoo wrapped by ``pw.udf`` of one package."""
    out = {}
    for fn in (boost, gate, mixf, rootp, stepi, cube, tag, half, sneaky,
               modmul, past53lit, bitmul, tag_nd, scaled_global):
        dec = pw.udf(deterministic=True) if fn.__name__ in _DETERMINISTIC \
            else pw.udf
        out[fn.__name__] = dec(fn)
    out["local_root"] = pw.udf(make_local_root())
    out["scaled"] = pw.udf(make_scaled([3]))
    out["triple"] = make_triple(pw.__name__)
    return out


# -- one run of one package --------------------------------------------------

def _cell(v, err):
    """A cell with its type: ERROR as its name, anything else as (type,
    repr) — repr keeps -0.0 and nan apart from 0.0."""
    if v is err.ERROR:
        return "ERROR"
    return type(v).__name__, repr(v)


@dataclass
class Run:
    events: list          # (time, key, diff, cells), in emission order
    stats: dict
    partitions: list      # (expr_idx, device part, numpy part) a program
    lowering: list        # (node kind, operator class, device_bound)
    bridge: dict | None   # the device bridge's counters (None: in line)


def _partitions(side: str) -> list:
    gc.collect()
    aj = SIDES[side][2]
    dev = "_xla_part" if side == "jax" else "_device_part"
    return sorted((tuple(p.expr_idx), tuple(getattr(p, dev)),
                   tuple(p._np_part)) for p in list(aj._REGISTRY))


def _node_kind(name: str) -> str:
    """A node's name without the table's (each package counts tables
    apart): "map_dev:table_3" -> "map_dev", "table_2" -> "table"."""
    kind = name.split(":")[0]
    return "table" if kind.startswith("table_") else kind


def run(side: str, build, jit: str, monkeypatch, n_workers: int = 1,
        min_rows: int | None = None) -> Run:
    pw, Runner, aj, g, err = SIDES[side]
    monkeypatch.setenv("PATHWAY_AUTO_JIT", jit)
    if min_rows is not None:
        monkeypatch.setattr(aj, "MIN_ROWS", min_rows)
    g.clear()
    aj.reset_stats()
    out = build(pw, udfs(pw))
    runner = Runner()
    cap = runner.capture(out)
    parts = _partitions(side)
    lowering = [(_node_kind(n.name), type(n.op).__name__,
                 bool(getattr(n.op, "device_bound", False)))
                for n in runner.graph.nodes]
    runner.run_batch(n_workers=n_workers)
    stats = aj.autojit_stats()
    bridge = runner._scheduler.bridge_stats()
    g.clear()
    events = [(time, int(key), diff, tuple(_cell(v, err) for v in row))
              for key, row, time, diff in cap.events]
    return Run(events, stats, parts, lowering, bridge)


def four_runs(build, monkeypatch, **kw) -> dict:
    """The port and the JAX package, tier on and off; every run's events
    equal. Returns the runs by (side, jit)."""
    runs = {(side, jit): run(side, build, jit, monkeypatch, **kw)
            for side in ("torch", "jax") for jit in ("1", "0")}
    on, off = runs["torch", "1"], runs["torch", "0"]
    assert on.events == off.events  # the tier changes nothing, in order
    assert on.events  # non-vacuous
    for jit in ("1", "0"):
        assert sorted(runs["jax", jit].events) == sorted(on.events)
    # the gate: which trees reach the device is the JAX package's choice
    assert on.partitions == runs["jax", "1"].partitions
    assert on.lowering == runs["jax", "1"].lowering
    assert off.lowering == runs["jax", "0"].lowering
    return runs


def rows_of(schema_types, rows):
    def table(pw):
        return pw.debug.table_from_rows(pw.schema_from_types(**schema_types),
                                        list(rows), is_stream=True)
    return table


# ---------------------------------------------------------------------------
# byte-identity across dtypes
# ---------------------------------------------------------------------------

def _dtype_rows(seed: int) -> list:
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(64):
        x = int(rng.integers(-10_000, 10_000))
        y = float(rng.random())
        b = bool(rng.integers(0, 2))
        s = f"w{int(rng.integers(0, 9))}"
        oi: int | None = int(rng.integers(0, 100))
        if i % 13 == 5:
            oi = None                     # None-able cell → fallback row
        if i % 17 == 9:
            x = 1 << 40                   # bigint past the 2^31 guard
        rows.append((x, y, b, s, oi, i // 16, 1))
    return rows


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_identity_across_dtypes(monkeypatch, seed):
    """Randomized int/float/bool/str/Optional[int] columns, clean majority
    plus seeded dirty cells: ON == OFF cell for cell on both packages, and
    the port's ON run dispatched through both partitions (non-vacuous)
    with no demotion — the reference's assertions, which its own tier
    fails on this host."""
    table = rows_of({"x": int, "y": float, "b": bool, "s": str,
                     "oi": int | None}, _dtype_rows(seed))

    def build(pw, u):
        t = table(pw)
        return t.select(
            sb=u["boost"](t.x), sg=u["gate"](t.y), sm=u["mixf"](t.x, t.y),
            sn=u["rootp"](t.y), st=u["stepi"](t.x), sc=u["cube"](t.x),
            tg=u["tag"](t.x), hf=u["half"](t.x), keep=t.b, raw=t.s,
            opt=t.oi, pick=pw.if_else(t.b, t.y, 0.0))

    runs = four_runs(build, monkeypatch)
    stats = runs["torch", "1"].stats
    assert stats["programs"] >= 1
    assert stats["device_dispatches"] > 0 and stats["vector_dispatches"] > 0
    assert stats["demotions"] == 0
    assert stats["live_programs"] == {"torch": 1}
    # the JAX package's tier demotes at its XLA probe here (not a result)
    assert runs["jax", "1"].stats["device_dispatches"] == 0


def test_identity_with_per_cell_errors(monkeypatch):
    """Data-dependent per-cell failures (negative sqrt → the interpreter
    raises → ERROR cell) fall back per batch and stay byte-identical —
    the FloatingPointError escape, not a demotion."""
    table = rows_of({"y": float},
                    [(float(i - 6) / 4.0, i // 16, 1) for i in range(32)])

    def build(pw, u):
        t = table(pw)
        return t.select(sn=u["rootp"](t.y), sg=u["gate"](t.y))

    stats = four_runs(build, monkeypatch)["torch", "1"].stats
    assert stats["demotions"] == 0
    # the first tick carries negative y → that batch fell back whole
    assert stats["fallback_batches"] >= 1
    assert stats["device_dispatches"] >= 1


def test_identity_small_batches_stay_interpreted(monkeypatch):
    """Batches below MIN_ROWS never dispatch and remain identical."""
    table = rows_of({"x": int, "y": float},
                    [(i, float(i), i, 1) for i in range(6)])

    def build(pw, u):
        t = table(pw)
        return t.select(sb=u["boost"](t.x), sg=u["gate"](t.y))

    stats = four_runs(build, monkeypatch)["torch", "1"].stats
    assert stats["device_dispatches"] == 0
    assert stats["vector_dispatches"] == 0


# ---------------------------------------------------------------------------
# fused-chain vs per-expr equivalence
# ---------------------------------------------------------------------------

def test_fused_chain_matches_per_expr(monkeypatch):
    """A composed chain (UDF-of-UDF args) fuses into ONE program and
    matches the select-per-stage lowering cell for cell. One guard pass a
    tick feeds both partitions: the device one (extra=boost) and the numpy
    one (out: compounding float arithmetic) each dispatch once a tick."""
    table = rows_of({"x": int, "y": float},
                    [(int(i), float(i) / 33.0, i // 32, 1)
                     for i in range(128)])

    def build_chain(pw, u):
        t = table(pw)
        return t.select(out=u["mixf"](u["boost"](t.x), u["gate"](t.y)),
                        extra=u["boost"](t.x))

    def build_staged(pw, u):
        t = table(pw)
        t1 = t.select(sb=u["boost"](t.x), sg=u["gate"](t.y))
        return t1.select(out=u["mixf"](t1.sb, t1.sg), extra=t1.sb)

    chain = four_runs(build_chain, monkeypatch)
    staged = four_runs(build_staged, monkeypatch)

    def rows(r):
        return sorted(cells for _, _, d, cells in r.events if d > 0)

    assert rows(chain["torch", "1"]) == rows(staged["torch", "1"])
    stats = chain["torch", "1"].stats
    assert stats["programs"] == 1
    n_ticks = 4
    assert stats["device_dispatches"] == n_ticks
    assert stats["device_dispatches"] + stats["vector_dispatches"] \
        == 2 * n_ticks
    assert staged["torch", "1"].stats["programs"] == 2


# ---------------------------------------------------------------------------
# runtime demotion: the safety net for what static analysis cannot see
# ---------------------------------------------------------------------------

def _live_program():
    gc.collect()  # only THIS test's runner should hold a live program
    progs = list(taj._REGISTRY)
    assert len(progs) == 1
    return progs[0]


def _boost_table(n: int = 64):
    return rows_of({"x": int}, [(int(i), i // 16, 1) for i in range(n)])


def _run_poisoned(monkeypatch, poison, n: int) -> tuple:
    table = _boost_table(n)

    def build(pw, u):
        return table(pw).select(sb=u["boost"](pw.this.x))

    off = run("torch", build, "0", monkeypatch)
    monkeypatch.setenv("PATHWAY_AUTO_JIT", "1")
    TG.clear()
    taj.reset_stats()
    out = build(tpw, udfs(tpw))
    runner = TRunner()
    cap = runner.capture(out)
    prog = _live_program()
    assert prog.backend == "torch"
    # poison BOTH compiled forms: torch fails → numpy fails → interp
    monkeypatch.setattr(prog, "_torch_fn", poison)
    monkeypatch.setattr(prog, "_np_fn", poison)
    monkeypatch.setattr(prog, "_np_sub_fn", None)
    runner.run_batch(n_workers=1)
    stats = taj.autojit_stats()
    TG.clear()
    got = [(time, int(key), diff, tuple(_cell(v, terror) for v in row))
           for key, row, time, diff in cap.events]
    return got, off, prog, stats


def test_runtime_demotion_loud_once_and_identical(monkeypatch, caplog):
    """A program whose compiled form fails on real data demotes loudly
    ONCE a backend hop, bumps the counter, and the output is
    byte-identical to the interpreter."""

    def poisoned(*arrays):
        raise RuntimeError("data-dependent control flow reached a tensor")

    with caplog.at_level(logging.WARNING, logger="pathway_tpu_torch.autojit"):
        got, off, prog, stats = _run_poisoned(monkeypatch, poisoned, 64)
    assert got == off.events
    assert prog.backend == "interp"
    assert stats["demotions"] >= 1
    demote_logs = [r for r in caplog.records if "demoted" in r.message]
    assert 1 <= len(demote_logs) <= 2  # once a hop, not once a batch


def test_verify_mismatch_demotes_and_keeps_interpreter_result(monkeypatch):
    """Verify-then-trust: a first-batch cell mismatch (a plausible dtype,
    wrong values) demotes and the interpreter's values win."""

    def wrong(*arrays):
        zeros = (torch.zeros_like(arrays[0])
                 if isinstance(arrays[0], torch.Tensor)
                 else np.zeros_like(arrays[0]))
        return (zeros,)

    got, off, prog, stats = _run_poisoned(monkeypatch, wrong, 32)
    assert got == off.events
    assert prog.backend == "interp"
    assert stats["demotions"] >= 1


def test_untraceable_body_never_fuses(monkeypatch):
    """A body the classifier cannot admit (truthiness over operands)
    stays interpreted: no program, no demotion noise, identical output."""
    table = rows_of({"x": int}, [(int(i % 3), i // 16, 1) for i in range(32)])

    def build(pw, u):
        return table(pw).select(s=u["sneaky"](pw.this.x))

    stats = four_runs(build, monkeypatch)["torch", "1"].stats
    assert stats["programs"] == 0
    assert stats["demotions"] == 0


# ---------------------------------------------------------------------------
# host/device map split
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_workers", [1, 8])
def test_map_split_lowering_and_identity(monkeypatch, n_workers):
    """A select carrying both a fusable chain and a host-only UDF lowers
    into map_host + map_dev + ZipAligned, the device side device_bound,
    as in the JAX runner; the output matches the interpreted run at one
    and at eight workers (the workers on the pool: replicas share the
    fused program)."""
    if n_workers > 1:
        monkeypatch.setenv("PATHWAY_WORKER_THREADS", "1")
    # 128 rows a tick: each of 8 workers gets past MIN_ROWS
    table = rows_of({"x": int, "y": float},
                    [(int(i), float(i) / 9.0, i // 128, 1)
                     for i in range(512)])

    def build(pw, u):
        t = table(pw)
        return t.select(sb=u["boost"](t.x), sg=u["gate"](t.y),
                        tg=u["tag"](t.x))

    runs = four_runs(build, monkeypatch, n_workers=n_workers)
    on = runs["torch", "1"]
    kinds = {kind: (cls, bound) for kind, cls, bound in on.lowering}
    assert kinds["map_host"] == ("MapOperator", False)
    assert kinds["map_dev"] == ("MapOperator", True)
    assert kinds["map"] == ("ZipAlignedOperator", False)
    assert on.stats["programs"] == 1
    assert on.stats["demotions"] == 0
    # one a tick and worker with rows
    assert on.stats["device_dispatches"] >= 4 * (1 if n_workers == 1 else 6)


def test_no_split_without_host_udf(monkeypatch):
    """All-fusable selects keep ONE operator, as in the JAX runner."""
    table = _boost_table(32)

    def build(pw, u):
        t = table(pw)
        return t.select(sb=u["boost"](t.x), st=u["stepi"](t.x))

    on = four_runs(build, monkeypatch)["torch", "1"]
    assert not any(kind in ("map_host", "map_dev")
                   for kind, _, _ in on.lowering)


def test_zip_aligned_misalignment_raises():
    from pathway_tpu_torch.engine.delta import Delta
    from pathway_tpu_torch.engine.operators import ZipAlignedOperator

    op = ZipAlignedOperator(((0, 0), (1, 0)))
    assert op.exchange_specs() == [None, None] and op.parallel_safe
    with pytest.raises(RuntimeError, match="lost alignment"):
        op.step(0, [Delta([(1, ("a",), 1)]), Delta([(2, ("b",), 1)])])
    with pytest.raises(RuntimeError, match="lost alignment"):
        op.step(0, [Delta([(1, ("a",), 1)]), Delta([])])
    ok = op.step(0, [Delta([(1, ("a",), 1)]), Delta([(1, ("b",), 1)])])
    assert ok.entries == [(1, ("a", "b"), 1)]


# ---------------------------------------------------------------------------
# warm-up walks the bucket ladder
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("max_bucket,ladder", [("256", 6), (None, 9)])
def test_warmup_walks_buckets_then_serving_compiles_nothing(
        monkeypatch, max_bucket, ladder):
    """pw.warmup after building the runner walks every power-of-two
    bucket (8 .. PATHWAY_AUTO_JIT_WARM_MAX, default 2048); the run after
    it adds no compile and no capture."""
    monkeypatch.setenv("PATHWAY_AUTO_JIT", "1")
    if max_bucket is not None:
        monkeypatch.setenv("PATHWAY_AUTO_JIT_WARM_MAX", max_bucket)
    rows = [(int(i), i // 100, 1) for i in range(200)]
    t = tpw.debug.table_from_rows(tpw.schema_from_types(x=int), rows,
                                  is_stream=True)
    out = t.select(sb=udfs(tpw)["boost"](t.x))
    runner = TRunner()
    cap = runner.capture(out)
    prog = _live_program()
    assert prog.backend == "torch"
    warm = tpw.warmup(cache=False)
    entries = [e for e in warm["compiled"] if e[0] == "autojit"]
    assert [b for _, (_, b) in entries] == [8 << i for i in range(ladder)]
    assert taj.autojit_stats()["compiles"] == ladder
    captures = device_sanitizer.install_compile_counter()
    before = captures()
    runner.run_batch(n_workers=1)  # 100-row ticks → bucket 128 (walked)
    stats = taj.autojit_stats()
    assert stats["compiles"] == ladder
    assert stats["device_dispatches"] == 2
    assert captures() == before
    assert device_sanitizer.post_warmup_compiles() == 0
    assert [r for _, r, _, d in cap.events if d > 0]


def test_warmup_autojit_disabled_is_noop(monkeypatch):
    monkeypatch.setenv("PATHWAY_AUTO_JIT", "0")
    assert taj.warm_registered() == []
    assert jaj.warm_registered() == []


# ---------------------------------------------------------------------------
# satellites
# ---------------------------------------------------------------------------

def test_closure_over_module_fuses(monkeypatch):
    """A UDF defined inside a function whose enclosing scope imported
    math still fuses (module-valued closure cells are process
    singletons)."""
    table = rows_of({"y": float},
                    [(float(i) / 7.0, i // 16, 1) for i in range(32)])

    def build(pw, u):
        return table(pw).select(sn=u["local_root"](pw.this.y))

    stats = four_runs(build, monkeypatch)["torch", "1"].stats
    assert stats["programs"] == 1
    assert stats["vector_dispatches"] >= 1  # math body → numpy partition


def test_locally_imported_decorator_still_fuses(monkeypatch):
    """A UDF decorated through a name imported in the ENCLOSING function
    must fuse: the global-read gate only inspects the body."""
    table = _boost_table(32)

    def build(pw, u):
        return table(pw).select(s=u["triple"](pw.this.x))

    stats = four_runs(build, monkeypatch)["torch", "1"].stats
    assert stats["programs"] == 1
    assert stats["device_dispatches"] > 0


def test_non_module_closure_never_fuses(monkeypatch):
    """A UDF closing over a mutable value must NOT be frozen."""
    table = _boost_table(32)

    def build(pw, u):
        return table(pw).select(s=u["scaled"](pw.this.x))

    stats = four_runs(build, monkeypatch)["torch", "1"].stats
    assert stats["programs"] == 0


@pytest.mark.parametrize("name,value", [
    ("cube", 2_000_000_000 ** 3),
    ("bitmul", (-1 & (2147483647 * 2147483647)) * 2147483647),
    ("past53lit", 2147483647 * 2147483647 > 4611686014132420608.0),
])
def test_int_overflow_proof_bars_unprovable_trees(monkeypatch, name, value):
    """Trees whose int bound passes int64 (cube: 93 bits), bitwise bodies
    (two's complement defeats magnitude bounds) and int-vs-float
    comparisons past 2^53 never fuse: Python's exact semantics hold."""
    x = 2_000_000_000 if name == "cube" else 2147483647
    table = rows_of({"x": int}, [(x, 0, 1)] * 16)

    def build(pw, u):
        return table(pw).select(c=u[name](pw.this.x))

    on = four_runs(build, monkeypatch)["torch", "1"]
    assert on.stats["programs"] == 0
    assert [cells[0] for _, _, d, cells in on.events if d > 0] \
        == [(type(value).__name__, repr(value))] * 16


def test_mod_bound_uses_right_operand(monkeypatch):
    """|a % b| < |b|: the proof bounds modulo by the RIGHT operand, so
    (-1 % y) * x * x (~2^93) never fuses."""
    big = 2_000_000_000
    table = rows_of({"x": int, "y": int}, [(big, big, 0, 1)] * 16)

    def build(pw, u):
        t = table(pw)
        return t.select(m=u["modmul"](t.x, t.y))

    on = four_runs(build, monkeypatch)["torch", "1"]
    assert on.stats["programs"] == 0
    want = (-1 % big) * big * big
    assert [cells[0] for _, _, d, cells in on.events if d > 0] \
        == [("int", repr(want))] * 16


def test_unary_minus_preserves_negative_zero(monkeypatch):
    """-x is true negation, not 0 - x: -0.0 keeps its sign on the torch
    partition as on numpy."""
    table = rows_of({"y": float}, [(0.0 if i % 2 else float(i) / 8.0,
                                    i // 16, 1) for i in range(32)])

    def build(pw, u):
        return table(pw).select(n=-u["gate"](pw.this.y))

    on = four_runs(build, monkeypatch)["torch", "1"]
    assert on.stats["device_dispatches"] > 0  # the device partition
    assert ("float", "-0.0") in [c[0] for _, _, d, c in on.events if d > 0]


def test_split_bail_discards_phantom_programs(monkeypatch):
    """A probed-then-bailed host/device split (host side non-deterministic
    → the aligned zip cannot be used) leaves no FusedProgram in the
    stats."""
    table = _boost_table(32)

    def build(pw, u):
        t = table(pw)
        return t.select(sb=u["boost"](t.x), tg=u["tag_nd"](t.x))

    on = four_runs(build, monkeypatch)["torch", "1"]
    assert on.stats["programs"] == 1


def test_int_cast_products_not_fused_without_declared_int(monkeypatch):
    """int() casts mint int64 values up to 2^62 even in a body whose
    PREDICTED return kind is float: the cast forces the overflow proof."""
    table = rows_of({"y": float},
                    [(0.5 + i / 64.0, i // 16, 1) for i in range(32)])

    def build(pw, u):
        return table(pw).select(v=pw.apply(int_cast_product, pw.this.y))

    on = four_runs(build, monkeypatch)["torch", "1"]
    assert on.stats["programs"] == 0
    got = [int(c[0][1]) for _, _, d, c in on.events if d > 0]
    assert got and all(v > (1 << 63) for v in got)


def test_non_module_global_read_not_fused(monkeypatch):
    """A body reading a module-level non-module name stays interpreted,
    and the lowering keeps the caching operator for the unverified
    body."""
    table = rows_of({"y": float},
                    [(float(i) / 9.0, i // 16, 1) for i in range(32)])

    def build(pw, u):
        return table(pw).select(s=u["scaled_global"](pw.this.y))

    on = four_runs(build, monkeypatch)["torch", "1"]
    assert on.stats["programs"] == 0
    assert "DeterministicMapOperator" in {cls for _, cls, _ in on.lowering}


def test_int64_min_cell_guarded(monkeypatch):
    """-2**63 is the adversarial guard cell: routed to the interpreter,
    exact bigint arithmetic preserved."""
    evil = -(1 << 63)
    table = rows_of({"x": int}, [(evil if i % 4 == 0 else i, i // 16, 1)
                                 for i in range(32)])

    def build(pw, u):
        return table(pw).select(sb=u["boost"](pw.this.x))

    on = four_runs(build, monkeypatch)["torch", "1"]
    assert ("int", repr(evil * 3 + 7)) in {c[0] for _, _, d, c in on.events
                                           if d > 0}
    assert on.stats["device_dispatches"] > 0


def test_stats_and_status_surfaces(monkeypatch):
    table = _boost_table(32)

    def build(pw, u):
        return table(pw).select(sb=u["boost"](pw.this.x))

    stats = run("torch", build, "1", monkeypatch).stats
    assert stats["enabled"] is True
    assert set(stats) >= {"programs", "compiles", "demotions",
                          "device_dispatches", "vector_dispatches",
                          "fallback_batches", "live_programs",
                          "bucket_count"}
    monkeypatch.setenv("PATHWAY_AUTO_JIT", "0")
    assert taj.autojit_stats()["enabled"] is False


# ---------------------------------------------------------------------------
# the port's own: partitions, promotion, the card, the monitor, bench
# ---------------------------------------------------------------------------

def test_int_times_float_stays_on_device_without_demotion(monkeypatch):
    """half(x) = x * 0.5 is in the JAX package's XLA partition; in torch
    an int64 tensor times a Python float is float32, so the port lifts
    the literal to a 0-d float64 tensor: no demotion, exact values."""
    table = rows_of({"x": int}, [(int(i) * 7919 - 100_000, i // 16, 1)
                                 for i in range(64)])

    def build(pw, u):
        return table(pw).select(h=u["half"](pw.this.x))

    on = four_runs(build, monkeypatch)["torch", "1"]
    assert on.partitions == [((0,), (0,), ())]
    assert on.stats["demotions"] == 0
    assert on.stats["device_dispatches"] == 4


def test_no_card_raises_instead_of_demoting(monkeypatch):
    """With no card, a program with device trees raises when the graph
    is lowered; a numpy-only program and the tier off need no card."""
    from pathway_tpu_torch._device import resolve_device

    monkeypatch.setattr(taj, "_autojit_device",
                        lambda: resolve_device("cuda"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("PATHWAY_AUTO_JIT", "1")
    table = rows_of({"x": int, "y": float},
                    [(int(i), float(i) / 9.0, i // 16, 1) for i in range(32)])
    u = udfs(tpw)
    t = table(tpw)
    with pytest.raises(taj.AutojitDeviceError,
                       match="CUDA is not available.*PATHWAY_AUTO_JIT=0"):
        TRunner().capture(t.select(sb=u["boost"](t.x)))
    assert taj.autojit_stats()["demotions"] == 0
    runs = {}
    for jit, exprs in (("1", {"sn": u["rootp"](t.y)}),
                       ("0", {"sn": u["rootp"](t.y),
                              "sb": u["boost"](t.x)})):
        monkeypatch.setenv("PATHWAY_AUTO_JIT", jit)
        taj.reset_stats()
        runner = TRunner()
        cap = runner.capture(t.select(**exprs))
        runner.run_batch(n_workers=1)
        runs[jit] = (cap.events, taj.autojit_stats())
    assert runs["1"][1]["live_programs"] == {"numpy": 1}
    assert runs["1"][1]["vector_dispatches"] == 2
    assert runs["0"][1]["programs"] == 0 and runs["0"][0]


def test_monitor_shows_the_dispatch_mix(monkeypatch):
    from pathway_tpu_torch.internals.monitoring import StatsMonitor

    table = _boost_table(32)

    def build(pw, u):
        return table(pw).select(sb=u["boost"](pw.this.x))

    run("torch", build, "1", monkeypatch)
    lines = StatsMonitor._autojit_lines()
    assert lines == ["auto-jit: 1 fused program(s)  torch 2 / vector 0 "
                     "dispatches  compiles 1  demotions 0"]


AUTOJIT_TICK = 64


def bench_chain(pw, u, n_ticks: int):
    """bench.py's autojit chain (bench.py:2136-2199) at a small tick: six
    fusable scalar UDFs, a host-only one and a batch device UDF."""
    def damp(y: float) -> float:
        return y * 0.5 + 0.25

    def embed(xs):
        return [float(v % 4096) * 0.25 for v in xs]

    rng = np.random.default_rng(3)
    n = n_ticks * AUTOJIT_TICK
    xs, ys = rng.integers(0, 1_000_000, size=n), rng.random(size=n)
    t = pw.debug.table_from_rows(
        pw.schema_from_types(x=int, y=float),
        [(int(x), float(y), i // AUTOJIT_TICK, 1)
         for i, (x, y) in enumerate(zip(xs, ys))], is_stream=True)
    d = pw.udf(damp)
    e = pw.udf(batch=True, device=True, deterministic=True,
               return_type=float)(embed)
    t1 = t.select(sb=u["boost"](t.x), sg=u["gate"](t.y),
                  sm=u["mixf"](t.x, t.y), sn=u["rootp"](t.y), sd=d(t.y),
                  st=u["stepi"](t.x), tg=u["tag"](t.x))
    return t1.select(emb=e(t1.sb), tg=t1.tg, sg=t1.sg, sm=t1.sm,
                     sn=t1.sn, sd=t1.sd, st=t1.st)


def test_bench_chain_counters(monkeypatch):
    """bench.py's autojit leg's graph: one program (boost and gate on the
    device, the four others on numpy), split from the host-only tag,
    zero demotions and one device dispatch a tick."""
    n_ticks = 4
    runs = four_runs(lambda pw, u: bench_chain(pw, u, n_ticks), monkeypatch)
    on = runs["torch", "1"]
    assert on.partitions == [((0, 1, 2, 3, 4, 5), (0, 1), (2, 3, 4, 5))]
    assert on.stats["programs"] == 1
    assert on.stats["demotions"] == 0
    assert on.stats["device_dispatches"] == n_ticks
    assert on.stats["vector_dispatches"] == n_ticks
    assert on.stats["fallback_batches"] == 0
    assert ("map_dev", "MapOperator", True) in on.lowering


def test_bench_chain_on_the_bridge(monkeypatch):
    """The fused map rides the device bridge's worker (window 2) and the
    events are the in-line schedule's."""
    got = {}
    for window in ("1", "2"):
        monkeypatch.setenv("PATHWAY_DEVICE_INFLIGHT", window)
        got[window] = run("torch", lambda pw, u: bench_chain(pw, u, 4), "1",
                          monkeypatch)
    assert got["2"].events == got["1"].events
    assert got["2"].stats["device_dispatches"] == 4
    assert got["1"].bridge is None and got["2"].bridge["legs_resolved"] > 0
