"""The auto-jit tier's device partition on the card: torch ops captured
as one CUDA graph per power-of-two bucket, replayed with the padded
arrays copied in through pinned buffers. Held bit for bit against the
numpy build of the same trees and against the interpreter, with one
capture a bucket and none after ``pw.warmup``. This file imports no JAX,
so its tests run on the card: ``python -m pytest --noconftest -q -m cuda
tests/test_torch_autojit_card.py``."""

import numpy as np
import pytest
import torch

import pathway_tpu_torch as pw
from pathway_tpu_torch.engine import device_sanitizer
from pathway_tpu_torch.internals import autojit
from pathway_tpu_torch.internals.parse_graph import G
from pathway_tpu_torch.internals.runner import GraphRunner


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the device partition runs as "
                    "CUDA graph replays")
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    monkeypatch.setenv("PATHWAY_AUTO_JIT", "1")
    monkeypatch.delenv("PATHWAY_DEVICE_SANITIZER", raising=False)
    G.clear()
    autojit.reset_stats()
    device_sanitizer._reset_for_tests()
    yield
    G.clear()
    autojit.reset_stats()
    device_sanitizer._reset_for_tests()


@pw.udf
def boost(x: int) -> int:
    return x * 3 + 7


@pw.udf
def gate(y: float) -> float:
    return y if y < 0.75 else 0.75


@pw.udf
def half(x: int) -> float:
    return x * 0.5


@pw.udf
def over(x: int, y: float) -> bool:
    return x > y


@pw.udf
def mix(x: int, y: float) -> float:
    return x * 0.0001 + y * 0.5


def _rows(n: int, seed: int = 0) -> list:
    """Clean cells with the float edge values -0.0, nan and +-inf."""
    rng = np.random.default_rng(seed)
    xs = rng.integers(-(1 << 31) + 1, 1 << 31, size=n)
    ys = rng.normal(size=n) * 1e3
    edge = [-0.0, 0.0, float("nan"), float("inf"), -float("inf"), 0.75]
    return [(int(x), edge[i % 12] if i % 12 < len(edge) else float(y))
            for i, (x, y) in enumerate(zip(xs, ys))]


def _graph(rows: list, tick: int):
    t = pw.debug.table_from_rows(
        pw.schema_from_types(x=int, y=float),
        [(*r, i // tick, 1) for i, r in enumerate(rows)], is_stream=True)
    return t.select(sb=boost(t.x), sg=gate(t.y), hf=half(t.x),
                    ng=-gate(t.y), ov=over(t.x, t.y), sm=mix(t.x, t.y))


def _program(runner):
    progs = [p for n in runner.graph.nodes
             for p in (getattr(getattr(n.op, "fn", None), "autojit", None)
                       or ())]
    assert len(progs) == 1
    return progs[0]


def _bits(col):
    return [(type(v).__name__, repr(v)) for v in col]


@pytest.mark.cuda
def test_device_partition_bit_for_bit_on_card():
    card = _card()
    runner = GraphRunner()
    runner.capture(_graph(_rows(64), 64))
    prog = _program(runner)
    assert prog.backend == "torch" and prog.device.type == card.type
    assert (prog._device_part, prog._np_part) == ([0, 1, 2, 3, 4], [5])
    rng = np.random.default_rng(1)
    for n in (8, 13, 100, 128, 2000):
        rows = _rows(n, seed=n)
        xs = np.asarray([r[0] for r in rows], np.int64)
        ys = np.asarray([r[1] for r in rows], np.float64)
        ys[rng.random(n) < 0.05] = np.nan
        arrays = [xs, ys] if prog.leaf_kinds == ["i", "f"] else [ys, xs]
        with np.errstate(invalid="ignore"):
            got = prog._run_backend(arrays, n)
            want = prog._np_fn(*arrays)
        for i in prog._device_part:
            assert _bits(got[i].tolist()) == _bits(
                np.asarray(want[i]).tolist()), (n, i)
            assert got[i].dtype == np.asarray(want[i]).dtype
    assert autojit.autojit_stats()["demotions"] == 0


@pytest.mark.cuda
def test_events_equal_the_interpreter_on_card(monkeypatch):
    _card()
    rows = _rows(4 * 512)
    got = {}
    for jit in ("1", "0"):
        monkeypatch.setenv("PATHWAY_AUTO_JIT", jit)
        autojit.reset_stats()
        runner = GraphRunner()
        cap = runner.capture(_graph(rows, 512))
        runner.run_batch(n_workers=1)
        got[jit] = ([(t, int(k), d, _bits(r)) for k, r, t, d in cap.events],
                    autojit.autojit_stats())
        G.clear()
    assert got["1"][0] == got["0"][0]
    stats = got["1"][1]
    assert stats["programs"] == 1 and stats["demotions"] == 0
    # nan and inf cells are floats: every row is clean, one dispatch a tick
    assert stats["device_dispatches"] == 4 and not stats["fallback_batches"]


@pytest.mark.cuda
def test_one_capture_per_bucket():
    _card()
    runner = GraphRunner()
    runner.capture(_graph(_rows(64), 64))
    prog = _program(runner)
    captures = device_sanitizer.install_compile_counter()
    before = captures()
    sizes = (8, 9, 16, 17, 100, 128, 2048, 8, 100, 2048)
    for n in sizes:
        rows = _rows(n, seed=n)
        arrays = [np.asarray([r[0] for r in rows], np.int64),
                  np.asarray([r[1] for r in rows], np.float64)]
        if prog.leaf_kinds != ["i", "f"]:
            arrays.reverse()
        with np.errstate(invalid="ignore"):
            prog._run_backend(arrays, n)
    buckets = {8, 16, 32, 128, 2048}
    assert sorted(prog.graphs) == sorted(buckets)
    assert captures() - before == len(buckets)
    assert autojit.autojit_stats()["compiles"] == len(buckets)
    assert prog.device_ms > 0.0


@pytest.mark.cuda
def test_warmup_then_bridged_serving_captures_and_syncs_nothing(monkeypatch):
    """pw.warmup on the main thread captures the ladder 8 .. 2048; the
    run that follows replays the graphs from the device bridge's worker
    (window 2) under the sanitizer's raise mode: no capture, no implicit
    host sync, the interpreter's events."""
    _card()
    monkeypatch.setenv("PATHWAY_DEVICE_SANITIZER", "1")
    monkeypatch.setenv("PATHWAY_DEVICE_INFLIGHT", "2")
    rows = _rows(6 * 300)
    runner = GraphRunner()
    cap = runner.capture(_graph(rows, 300))
    prog = _program(runner)
    warm = pw.warmup(cache=False)
    ladder = [8 << i for i in range(9)]
    assert [b for k, (_, b) in warm["compiled"] if k == "autojit"] == ladder
    assert device_sanitizer.warmup_compiles() == len(ladder)
    assert sorted(prog.graphs) == ladder
    with device_sanitizer.count_syncs() as syncs:
        runner.run_batch(n_workers=1)
    assert syncs.count == 0
    assert device_sanitizer.post_warmup_compiles() == 0
    assert device_sanitizer.violations() == []
    stats = autojit.autojit_stats()
    assert stats["device_dispatches"] == 6 and stats["demotions"] == 0
    on = [(t, int(k), d, _bits(r)) for k, r, t, d in cap.events]
    G.clear()
    monkeypatch.setenv("PATHWAY_AUTO_JIT", "0")
    monkeypatch.delenv("PATHWAY_DEVICE_SANITIZER")
    device_sanitizer._reset_for_tests()
    runner = GraphRunner()
    cap = runner.capture(_graph(rows, 300))
    runner.run_batch(n_workers=1)
    assert on == [(t, int(k), d, _bits(r)) for k, r, t, d in cap.events]
