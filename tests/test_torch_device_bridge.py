"""The port's device bridge (pathway_tpu_torch/engine/device_bridge.py) and
pipelined scheduler (engine/graph.py), after the JAX package's
tests/test_device_bridge.py.

- the bridge runs legs in FIFO order; backpressure bounds the legs in
  flight at the window, for windows 1-4; overlap with host work shows in
  its counters; a leg's exception re-raises, with its original type, on
  the host thread; a tick's outputs resolve on access;
- the device-UDF pipeline and the external-index pipeline (the tiny
  encoder on the CPU) give byte-identical captured streams at windows 1
  and 2;
- bench_embed_framework's graph (``VectorStoreServer.retrieve_query``) at
  a tiny width gives, in the port at window 2, the JAX package's events at
  window 1 (its ``PATHWAY_AUTO_JIT=0``, ``PATHWAY_RESULT_CACHE=0``): keys,
  times and diffs exact, replies as tests/test_torch_vector_store.py holds
  them (scores within its ``ATOL``).

Every run and wait goes through ``_bounded``, which fails the test after
``TIMEOUT_S`` instead of hanging the suite.
"""

from __future__ import annotations

import threading
import time as _time

import pytest

import pathway_tpu_torch as tpw
from pathway_tpu_torch.engine.delta import Delta, row_fingerprint
from pathway_tpu_torch.engine.device_bridge import (DeviceBridge,
                                                    device_inflight_from_env,
                                                    live_bridge_snapshot)
from pathway_tpu_torch.engine.graph import (CapturedStream, EngineGraph,
                                            Scheduler)
from pathway_tpu_torch.engine.operators import Operator, OutputOperator
from pathway_tpu_torch.internals.keys import Pointer
from pathway_tpu_torch.internals.runner import GraphRunner
from pathway_tpu_torch.models.encoder import EncoderConfig
from pathway_tpu_torch.stdlib.indexing import \
    default_brute_force_knn_document_index
from pathway_tpu_torch.xpacks.llm.embedders import EncoderEmbedder

TIMEOUT_S = 30.0


def _bounded(fn, timeout: float = TIMEOUT_S):
    """``fn()`` on a helper thread, joined with a timeout: its result, or
    its exception re-raised here."""
    box: dict = {}

    def run():
        try:
            box["out"] = fn()
        except BaseException as e:  # noqa: BLE001 — re-raised below
            box["err"] = e

    th = threading.Thread(target=run, daemon=True)
    th.start()
    th.join(timeout)
    assert not th.is_alive(), f"no result within {timeout} s"
    if "err" in box:
        raise box["err"]
    return box.get("out")


def _canon(events):
    return [(k, row_fingerprint(r), t, d) for k, r, t, d in events]


# ---------------------------------------------------------------------------
# the bridge alone
# ---------------------------------------------------------------------------

def test_fifo_order():
    bridge = DeviceBridge(max_inflight=2)
    order = []
    try:
        for t in range(5):
            _bounded(lambda t=t: bridge.submit(t, lambda: order.append(t)))
        _bounded(bridge.barrier)
    finally:
        bridge.close(join_timeout=TIMEOUT_S)
    assert order == list(range(5))
    stats = bridge.stats()
    assert stats["legs_resolved"] == 5 and stats["depth"] == 0
    assert stats["resolved_watermark"] == 4
    assert bridge.resolved_watermark() == 4
    assert _bounded(lambda: bridge.wait_watermark(4)) == 4


@pytest.mark.parametrize("window", [1, 2, 3, 4])
def test_backpressure_bounds_legs_in_flight(window):
    """Legs slower than the host: ``submit`` blocks, so the depth seen by
    the legs themselves never exceeds the window, and the window fills."""
    bridge = DeviceBridge(max_inflight=window)
    seen = []

    def leg():
        seen.append(bridge.depth())
        _time.sleep(0.01)

    try:
        _bounded(lambda: [bridge.submit(t, leg) for t in range(1, 13)])
        _bounded(bridge.barrier)
    finally:
        bridge.close(join_timeout=TIMEOUT_S)
    stats = bridge.stats()
    assert stats["legs_dispatched"] == stats["legs_resolved"] == 12
    assert stats["max_depth"] == window
    assert max(seen) <= window
    if window > 1:
        assert stats["submit_wait_ms"] > 0  # the host was held back


class _SlowDeviceOp(Operator):
    device_bound = True

    def __init__(self, sleep_s: float):
        self.sleep_s = sleep_s

    def step(self, time, in_deltas):
        _time.sleep(self.sleep_s)
        return in_deltas[0]


def _drive_slow_graph(inflight: int, n_ticks: int, sleep_s: float = 0.01,
                      host_sleep_s: float = 0.0):
    g = EngineGraph()
    src = g.add_source("src")
    dev = g.add_node(_SlowDeviceOp(sleep_s), [src], "dev")
    cap = CapturedStream()
    g.add_node(OutputOperator(cap.on_delta), [dev], "capture")
    sched = Scheduler(g, n_workers=1, device_inflight=inflight)
    depths = []

    def drive():
        for t in range(1, n_ticks + 1):
            sched.push_source(src, Delta([(Pointer(t), (t,), 1)]))
            sched.run_time(t)
            if sched._bridge is not None:
                depths.append(sched._bridge.depth())
            if host_sleep_s:
                _time.sleep(host_sleep_s)  # simulated host-side work
        sched.resolve_barrier()

    try:
        _bounded(drive)
    finally:
        sched.close()
    return cap.events, sched.bridge_stats(), depths


@pytest.mark.parametrize("window", [1, 2, 3, 4])
def test_scheduler_window_bounds_ticks_in_flight(window):
    events, stats, depths = _drive_slow_graph(window, n_ticks=12)
    sync_events, sync_stats, _ = _drive_slow_graph(1, n_ticks=12)
    assert sync_stats is None  # window 1 never builds a bridge
    assert events == sync_events and len(events) == 12
    if window == 1:
        assert stats is None and not depths
        return
    assert stats["legs_resolved"] == 12
    assert stats["max_depth"] <= window and max(depths) <= window
    assert stats["max_depth"] >= 2  # the device is slower than the host


def test_overlap_is_observable():
    # host work about as long as a leg: most legs resolve while the host
    # thread is busy with a later tick
    _events, stats, _depths = _drive_slow_graph(
        2, n_ticks=10, sleep_s=0.01, host_sleep_s=0.015)
    assert stats["legs_overlapped"] > 0 and stats["overlap_ratio"] > 0


class _BoomError(RuntimeError):
    pass


class _FailingDeviceOp(Operator):
    device_bound = True

    def __init__(self, fail_at_tick: int):
        self.fail_at_tick = fail_at_tick

    def step(self, time, in_deltas):
        if time == self.fail_at_tick:
            raise _BoomError(f"device fault at tick {time}")
        return in_deltas[0]


def test_leg_error_reraises_on_host_thread():
    g = EngineGraph()
    src = g.add_source("src")
    g.add_node(_FailingDeviceOp(fail_at_tick=2), [src], "dev")
    sched = Scheduler(g, n_workers=1, device_inflight=2)

    def drive():
        for t in range(1, 8):
            sched.push_source(src, Delta([(Pointer(t), (t,), 1)]))
            sched.run_time(t)
        sched.resolve_barrier()  # the error surfaces here at the latest

    try:
        with pytest.raises(_BoomError, match="tick 2"):
            _bounded(drive)
    finally:
        sched.close()
    assert isinstance(sched.take_device_error(), _BoomError)
    stats = sched.bridge_stats()
    # the failed tick never enters the resolved prefix, and no later tick
    # runs on top of it
    assert stats["resolved_watermark"] == 1 and stats["legs_resolved"] == 1
    assert sched.commit_watermark(7) == 1


def test_run_batch_reraises_leg_error_and_closes(monkeypatch):
    """A device-bound operator failing under ``run_batch``: the original
    exception escapes on the caller's thread and the bridge's worker is
    stopped."""
    monkeypatch.setenv("PATHWAY_DEVICE_INFLIGHT", "2")
    t = tpw.debug.table_from_rows(tpw.schema_from_types(x=float),
                                  [(1.0, 0, 1), (2.0, 2, 1)], is_stream=True)
    runner = GraphRunner()
    runner.graph.add_node(_FailingDeviceOp(fail_at_tick=2),
                          [runner.lower(t)], "dev")
    with pytest.raises(_BoomError):
        _bounded(lambda: runner.run_batch(n_workers=1))
    bridge = runner._scheduler._bridge
    assert bridge is not None and bridge._closed
    assert bridge._thread is None or not bridge._thread.is_alive()


def test_outputs_view_resolves_on_access():
    g = EngineGraph()
    src = g.add_source("src")
    dev = g.add_node(_SlowDeviceOp(0.05), [src], "dev")
    sched = Scheduler(g, n_workers=1, device_inflight=2)
    try:
        def tick():
            sched.push_source(src, Delta([(Pointer(1), (1,), 1)]))
            outputs = sched.run_time(1)
            # reading a deferred node's delta is a hard resolve barrier
            return outputs.get(dev.id), dev.id in outputs

        delta, present = _bounded(tick)
        assert [e[:2] for e in delta.entries] == [(Pointer(1), (1,))]
        assert present and sched.bridge_stats()["legs_resolved"] == 1
        assert _bounded(lambda: sched.wait_watermark(1)) == 1
        assert sched.commit_watermark(1) == 1
        snap = live_bridge_snapshot()
        assert snap is not None and snap["inflight"] is None
    finally:
        sched.close()


def test_window_from_environment(monkeypatch):
    monkeypatch.delenv("PATHWAY_DEVICE_INFLIGHT", raising=False)
    assert device_inflight_from_env() == 2
    for raw, want in (("1", 1), ("4", 4), ("0", 1), ("x", 2)):
        monkeypatch.setenv("PATHWAY_DEVICE_INFLIGHT", raw)
        assert device_inflight_from_env() == want


# ---------------------------------------------------------------------------
# pipelines of the port: byte-identical at windows 1 and 2
# ---------------------------------------------------------------------------

DOCS = [f"doc {i} word{i} word{(i * 7) % 31} word{(i * 3) % 17}"
        for i in range(48)]


@pytest.fixture(scope="module")
def emb():
    return EncoderEmbedder(config=EncoderConfig.tiny(), device="cpu")


def _run(monkeypatch, window: int, build):
    monkeypatch.setenv("PATHWAY_DEVICE_INFLIGHT", str(window))
    runner = GraphRunner()
    cap = runner.capture(build())
    _bounded(lambda: runner.run_batch(n_workers=1))
    return cap.events, runner._scheduler.bridge_stats()


def test_udf_pipeline_byte_identical(monkeypatch, emb):
    def build():
        rows = [(d, 2 * (i // 8), 1) for i, d in enumerate(DOCS)]
        # a same-stream retraction exercises the device leg's diffs
        rows += [(DOCS[5], 6, -1), (DOCS[5] + " again", 6, 1)]
        t = tpw.debug.table_from_rows(tpw.schema_from_types(data=str), rows,
                                      is_stream=True)
        return t.select(data=tpw.this.data, e=emb(tpw.this.data))

    sync_events, sync_stats = _run(monkeypatch, 1, build)
    pipe_events, pipe_stats = _run(monkeypatch, 2, build)
    assert sync_stats is None
    assert pipe_stats["legs_resolved"] == 7  # ticks 0-10 with data + flush
    assert len(sync_events) == len(DOCS) + 2
    assert _canon(pipe_events) == _canon(sync_events)
    for (_, a, _, _), (_, b, _, _) in zip(pipe_events, sync_events):
        assert a[1].tobytes() == b[1].tobytes()


def test_external_index_pipeline_byte_identical(monkeypatch, emb):
    def build():
        docs = tpw.debug.table_from_rows(
            tpw.schema_from_types(data=str),
            [(d, 2 * (i // 8), 1) for i, d in enumerate(DOCS)],
            is_stream=True)
        queries = tpw.debug.table_from_rows(
            tpw.schema_from_types(q=str, k=int),
            [(DOCS[3], 2, 3, 1), (DOCS[20], 4, 5, 1), (DOCS[40], 8, 2, 1),
             ("word3 word9", 12, 4, 1)], is_stream=True)
        index = default_brute_force_knn_document_index(
            docs.data, docs, embedder=emb, dimensions=64,
            reserved_space=128, dtype="bfloat16")
        return index.query_as_of_now(queries.q, number_of_matches=queries.k)

    sync_events, sync_stats = _run(monkeypatch, 1, build)
    pipe_events, pipe_stats = _run(monkeypatch, 2, build)
    assert sync_stats is None and pipe_stats["legs_resolved"] > 0
    assert len(sync_events) == 4
    assert _canon(pipe_events) == _canon(sync_events)


def test_framework_graph_window_2_equals_jax_window_1(monkeypatch):
    """bench_embed_framework's graph, tiny encoder, float32 index: the JAX
    package at window 1, the port at window 2."""
    from test_torch_vector_store import (_hold_replies, _queries_table,
                                         _server)

    from pathway_tpu.internals.runner import GraphRunner as JRunner
    from pathway_tpu_torch.models.encoder import init_params_host

    monkeypatch.setenv("PATHWAY_AUTO_JIT", "0")
    monkeypatch.setenv("PATHWAY_RESULT_CACHE", "0")
    params = init_params_host(0, EncoderConfig.tiny())
    out = {}
    for side, window, Runner in (("jax", 1, JRunner), ("torch", 2,
                                                       GraphRunner)):
        monkeypatch.setenv("PATHWAY_DEVICE_INFLIGHT", str(window))
        pw, store = _server(side, params, False, "float32", False)
        runner = Runner()
        cap = runner.capture(store.retrieve_query(_queries_table(pw)))
        _bounded(lambda: runner.run_batch(n_workers=1))
        out[side] = sorted(((time, int(key), diff, row[0].value)
                            for key, row, time, diff in
                            cap.consolidated_events()),
                           key=lambda e: e[:3])
        stats = runner._scheduler.bridge_stats()
        assert (stats is None) == (window == 1)
    assert stats["legs_resolved"] > 0
    assert len(out["torch"]) == 11
    _hold_replies(out["jax"], out["torch"])


def test_reference_auto_jit_fuses_nothing_in_framework_graph(monkeypatch):
    """On bench_embed_framework's graph the auto-jit tier builds no
    program, in the JAX package with its tier on (the default) and in the
    port with its own: neither measurement of the graph has a fused
    tier, and no map of it moves to the device leg for one."""
    import torch
    from test_torch_vector_store import _queries_table, _server

    from pathway_tpu.internals import autojit as jaj
    from pathway_tpu.internals.runner import GraphRunner as JRunner
    from pathway_tpu_torch.internals import autojit as taj
    from pathway_tpu_torch.models.encoder import init_params_host

    monkeypatch.delenv("PATHWAY_AUTO_JIT", raising=False)
    monkeypatch.setenv("PATHWAY_RESULT_CACHE", "0")
    monkeypatch.setenv("PATHWAY_DEVICE_INFLIGHT", "1")
    # a program with device trees would raise here without the patch
    monkeypatch.setattr(taj, "_autojit_device", lambda: torch.device("cpu"))
    params = init_params_host(0, EncoderConfig.tiny())
    for side, aj, Runner in (("jax", jaj, JRunner), ("torch", taj,
                                                     GraphRunner)):
        assert aj.autojit_enabled()
        aj.reset_stats()
        pw, store = _server(side, params, False, "bfloat16", False)
        runner = Runner()
        cap = runner.capture(store.retrieve_query(_queries_table(pw)))
        _bounded(lambda: runner.run_batch(n_workers=1))
        assert len(cap.events) == 11
        stats = aj.autojit_stats()
        assert stats["programs"] == 0 and stats["compiles"] == 0
        assert stats["device_dispatches"] == stats["vector_dispatches"] == 0
