"""The port's profiler (pathway_tpu_torch/engine/profiler.py) against the
JAX package's: its machine parameters, and the live side — every test of
tests/test_profiler.py run against the port's ``Profiler`` (on
``device="cpu"``) and, for the per-tenant ones, its request tracker and
tenant index, the family records of both packages' KNN indexes for the
same adds and searches, and the port's own hooks
(the embedder's forwards, the fused and graphed ingest steps, the device
bridge's and sync mode's legs, ``pw.run``'s install and removal, the
deferred CUDA-event commit, the torch.profiler capture).

Machine parameters, against the JAX package's ``machine_params`` /
``machine_balance``.

Both read ``BENCH_PEAK_TFLOPS`` and ``BENCH_HBM_GBPS`` on each call; with
the overrides set the two functions must return the same values. Without
them each names its own device: the JAX package a TPU v5e, the port an
H100 SXM (dense bf16 989 TFLOP/s, HBM 3,350 GB/s). The encoder FLOPs
formula, which bench-style MFU keys read beside the peak, must be the
same function in both. Exact comparisons: the values are parsed floats."""

import pytest

from pathway_tpu_torch.engine import profiler as tprof

OVERRIDES = [("989", "3350"), ("197.5", "819"), ("1979", "4800.25"),
             ("0.5", "1")]


@pytest.fixture
def jprof():
    from pathway_tpu.engine import profiler

    return profiler


@pytest.mark.parametrize("peak,hbm", OVERRIDES)
def test_machine_params_with_overrides_equal_jax(monkeypatch, jprof, peak,
                                                 hbm):
    monkeypatch.setenv("BENCH_PEAK_TFLOPS", peak)
    monkeypatch.setenv("BENCH_HBM_GBPS", hbm)
    assert tprof.machine_params() == jprof.machine_params() == {
        "peak_tflops": float(peak), "hbm_gbps": float(hbm)}
    assert tprof.machine_balance() == jprof.machine_balance()


def test_defaults_name_the_h100(monkeypatch):
    monkeypatch.delenv("BENCH_PEAK_TFLOPS", raising=False)
    monkeypatch.delenv("BENCH_HBM_GBPS", raising=False)
    assert tprof.machine_params() == {"peak_tflops": 989.0,
                                      "hbm_gbps": 3350.0}
    assert tprof.machine_balance() == pytest.approx(989e12 / 3350e9,
                                                    rel=1e-12)


def test_read_on_each_call_and_bad_values_fall_back(monkeypatch):
    monkeypatch.setenv("BENCH_PEAK_TFLOPS", "500")
    monkeypatch.setenv("BENCH_HBM_GBPS", "2000")
    assert tprof.machine_params() == {"peak_tflops": 500.0,
                                      "hbm_gbps": 2000.0}
    monkeypatch.setenv("BENCH_PEAK_TFLOPS", "not a number")
    monkeypatch.setenv("BENCH_HBM_GBPS", "")
    assert tprof.machine_params() == {"peak_tflops": 989.0,
                                      "hbm_gbps": 3350.0}


@pytest.mark.parametrize("seq", [16, 96, 128, 512])
def test_encoder_flops_per_token_equal_jax(jprof, seq):
    for h, i, n in ((384, 1536, 12), (64, 128, 2), (768, 3072, 12)):
        assert tprof.encoder_flops_per_token(h, i, n, seq) == \
            jprof.encoder_flops_per_token(h, i, n, seq)


def test_chip_smoke_bounds_refuse_a_peak_override(monkeypatch):
    """chip_smoke.py's bounds and MFU keys are the H100's own: with the
    defaults they read the profiler's table, and an override that moves
    either rate fails the run instead of rescaling every bound."""
    import chip_smoke

    monkeypatch.delenv("BENCH_PEAK_TFLOPS", raising=False)
    monkeypatch.delenv("BENCH_HBM_GBPS", raising=False)
    assert chip_smoke.peaks() == (tprof.H100_PEAK_TFLOPS * 1e12,
                                  tprof.H100_HBM_GBPS * 1e9)
    for var, val in (("BENCH_PEAK_TFLOPS", "197"), ("BENCH_HBM_GBPS", "819")):
        with monkeypatch.context() as m:
            m.setenv(var, val)
            with pytest.raises(SystemExit):
                chip_smoke.peaks()


# ---------------------------------------------------------------------------
# the live side: tests/test_profiler.py's tests, on the port
# ---------------------------------------------------------------------------

import re  # noqa: E402
import threading  # noqa: E402
import time  # noqa: E402

import numpy as np  # noqa: E402

from pathway_tpu_torch.engine.profiler import (  # noqa: E402
    Profiler, current_profiler, diff_profiles, install_profiler,
    knn_search_cost, live_profiler_stats, machine_balance)


@pytest.fixture(autouse=True)
def _fresh_profiler():
    install_profiler(None)
    yield
    install_profiler(None)


def _prof(**kw) -> Profiler:
    kw.setdefault("sample_interval_ms", 1e6)
    return Profiler(device="cpu", **kw)


def test_roofline_classification():
    prof = _prof()
    # knn search: AI = 2Q/itemsize ~ 2 FLOP/byte at Q=4, far below the
    # machine balance -> bandwidth-bound
    f, b = knn_search_cost(4, 1024, 64)
    prof.record_dispatch("knn_search", f, b, 2.0)
    prof.record_dispatch("encoder_forward", 1e12, 1e6, 5.0)
    fams = prof.family_stats()
    knn = fams["knn_search"]["roofline"]
    assert knn["bound_by"] == "bandwidth"
    assert knn["arithmetic_intensity"] == pytest.approx(f / b, rel=1e-3)
    assert 0.0 < knn["attainable_mfu"] < 1.0
    enc = fams["encoder_forward"]["roofline"]
    assert enc["bound_by"] == "compute"
    assert enc["attainable_mfu"] == 1.0
    assert prof.rolling_mfu() > 0.0
    assert prof.rolling_hbm_bw_util() > 0.0


def test_rolling_mfu_matches_hand_computation(monkeypatch):
    monkeypatch.setenv("BENCH_PEAK_TFLOPS", "1")  # 1e12 FLOP/s peak
    prof = _prof()
    prof.record_dispatch("knn_search", 5e8, 1e6, 1.0)  # 5e8 FLOP in 1 ms
    # 5e8 / 1e-3 s = 5e11 FLOP/s -> 50% of the 1e12 peak (rel 1e-6)
    assert prof.rolling_mfu() == pytest.approx(0.5, rel=1e-6)


def test_leg_attribution_rescales_to_measured_time():
    prof = _prof()
    prof.begin_leg(tick=3)
    # two asynchronous dispatches (~0 host ms): the leg's 10 ms split by
    # analytic bytes, 3:1 (tolerance: pytest.approx's default, rel 1e-6)
    prof.record_dispatch("knn_search", 100.0, 3000.0, 0.001)
    prof.record_dispatch("ingest_scatter", 50.0, 1000.0, 0.001)
    prof.end_leg(10.0)
    fams = prof.family_stats()
    assert fams["knn_search"]["device_ms_total"] == pytest.approx(7.5)
    assert fams["ingest_scatter"]["device_ms_total"] == pytest.approx(2.5)
    assert fams["knn_search"]["attributed_dispatches"] == 1
    assert fams["ingest_scatter"]["attributed_dispatches"] == 1
    total = sum(f["device_ms_total"] for f in fams.values())
    assert total == pytest.approx(10.0)
    assert prof.leg_stats() == {"committed": 1, "timed": 0,
                                "ms_total": 10.0, "pending": 0}


def test_leg_attribution_prefers_meaningful_walls():
    prof = _prof()
    prof.begin_leg(tick=0)
    prof.record_dispatch("knn_search", 1.0, 1.0, 8.0)
    prof.record_dispatch("ingest_scatter", 1.0, 1.0, 2.0)
    prof.end_leg(20.0)
    fams = prof.family_stats()
    assert fams["knn_search"]["device_ms_total"] == pytest.approx(16.0)
    assert fams["ingest_scatter"]["device_ms_total"] == pytest.approx(4.0)


def test_failed_leg_keeps_callsite_walls_unattributed():
    prof = _prof()
    prof.begin_leg(tick=0)
    prof.record_dispatch("knn_search", 10.0, 10.0, 1.25)
    prof.end_leg(None)  # the leg raised
    fams = prof.family_stats()
    assert fams["knn_search"]["device_ms_total"] == pytest.approx(1.25)
    assert fams["knn_search"]["attributed_dispatches"] == 0
    assert prof.leg_stats()["committed"] == 0


def test_record_outside_leg_commits_immediately():
    prof = _prof()
    prof.record_dispatch("encoder_forward", 10.0, 10.0, 4.0)
    fams = prof.family_stats()
    assert fams["encoder_forward"]["dispatches"] == 1
    assert fams["encoder_forward"]["attributed_dispatches"] == 0
    assert fams["encoder_forward"]["device_ms_total"] == pytest.approx(4.0)


class _FakeEvent:
    """A CUDA event's surface: ``done`` stands for the card having reached
    it; ``synchronize`` is the wait; ``elapsed_time`` reads ``ms``."""

    clock = 0.0

    def __init__(self, enable_timing: bool = True):
        self.done = False
        self.t = None
        self.synced = 0

    def record(self, stream=None):
        self.t = _FakeEvent.clock

    def query(self):
        return self.done

    def synchronize(self):
        self.synced += 1
        self.done = True

    def elapsed_time(self, end):
        assert self.done and end.done
        return end.t - self.t


def test_cuda_legs_wait_for_their_end_event(monkeypatch):
    """On a card a leg's records wait until its end event completes (query
    at the next end_leg and at every read), then scale to the events'
    elapsed time; stop() waits for the rest through one explicit sync."""
    import torch

    from pathway_tpu_torch.engine import device_sanitizer

    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev=None: None)
    lifts = []
    real = device_sanitizer.explicit_sync

    def counted(why=""):
        lifts.append(why)
        return real(why)

    monkeypatch.setattr(device_sanitizer, "explicit_sync", counted)
    prof = _prof()
    prof.device = torch.device("cuda", 0)  # event timing, as on a card
    legs = []
    for tick, ms in ((0, 6.0), (1, 4.0)):
        _FakeEvent.clock = 100.0 * tick
        prof.begin_leg(tick)
        prof.record_dispatch("knn_search", 1.0, 300.0, 0.01)
        prof.record_dispatch("ingest_scatter", 1.0, 100.0, 0.01)
        _FakeEvent.clock += ms
        prof.end_leg(999.0)  # the host wall is not the leg's time
        legs.append(prof._pending[-1])
    assert prof.family_stats() == {}  # nothing committed yet
    assert prof.leg_stats()["pending"] == 2
    legs[0].start.done = legs[0].end.done = True
    st = prof.family_stats()  # a read commits the finished leg
    assert st["knn_search"]["device_ms_total"] == pytest.approx(4.5)
    assert st["ingest_scatter"]["device_ms_total"] == pytest.approx(1.5)
    assert prof.leg_stats()["pending"] == 1 and not lifts
    legs[1].start.done = True
    prof.stop()  # waits for the last leg, once, as an explicit sync
    assert lifts == ["profiler leg timing"]
    assert legs[1].end.synced == 1
    st = prof.family_stats()
    assert st["knn_search"]["attributed_device_ms_total"] + \
        st["ingest_scatter"]["attributed_device_ms_total"] == \
        pytest.approx(10.0)
    assert prof.leg_stats() == {"committed": 2, "timed": 2,
                                "ms_total": 10.0, "pending": 0}


_COLLAPSED_LINE = re.compile(r"^[^; ][^;]*(;[^;]+)* \d+$")


def _busy_engine_thread(stop: threading.Event):
    def _inner_hot_loop():
        x = 0.0
        while not stop.is_set():
            x += 1.0
        return x

    _inner_hot_loop()


def test_sampler_collapsed_grammar_and_thread_roles():
    from pathway_tpu_torch.engine import threads

    stop = threading.Event()
    t = threads.spawn(_busy_engine_thread, args=(stop,), name="test-busy")
    prof = _prof(sample_interval_ms=2.0)
    try:
        prof.start()
        deadline = time.monotonic() + 5.0
        while prof.samples_total < 10 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert any(d["name"] == "pathway-tpu-test-busy"
                   for d in threads.live_threads())
    finally:
        prof.stop()
        stop.set()
        t.join(5.0)
    assert prof.samples_total >= 10
    text = prof.collapsed()
    lines = text.strip().splitlines()
    assert lines, "no folded stacks collected"
    for ln in lines:
        assert _COLLAPSED_LINE.match(ln), f"bad collapsed line: {ln!r}"
    counts = [int(ln.rsplit(" ", 1)[1]) for ln in lines]
    assert counts == sorted(counts, reverse=True)
    roles = {ln.split(";", 1)[0] for ln in lines}
    assert "test-busy" in roles  # pathway-tpu- prefix stripped to role
    busy = [ln for ln in lines if ln.startswith("test-busy;")]
    assert any("_inner_hot_loop" in ln for ln in busy)
    assert "profiler-sampler" not in roles
    assert prof.top_host_frame() is not None


def test_thread_role_and_live_threads():
    from pathway_tpu.engine import threads as jthreads
    from pathway_tpu_torch.engine import threads

    for name in ("pathway-tpu-device-bridge", "MainThread", "Thread-7",
                 "pathway-tpu-", "pathway-tpux"):
        assert threads.thread_role(name) == jthreads.thread_role(name)
    stop = threading.Event()
    t = threads.spawn(stop.wait, name="inventory-probe")
    try:
        live = [d for d in threads.live_threads()
                if d["name"] == "pathway-tpu-inventory-probe"]
        assert len(live) == 1 and live[0]["daemon"] is True
    finally:
        stop.set()
        t.join(5.0)
    assert not [d for d in threads.live_threads()
                if d["name"] == "pathway-tpu-inventory-probe"]


def test_sampler_tags_inflight_device_leg(monkeypatch):
    from pathway_tpu_torch.engine import flight_recorder as fr
    from pathway_tpu_torch.engine import threads

    stop = threading.Event()
    t = threads.spawn(_busy_engine_thread, args=(stop,), name="device-bridge")
    try:
        deadline = time.monotonic() + 2.0
        while t.ident is None and time.monotonic() < deadline:
            time.sleep(0.005)
        ident = t.ident
        monkeypatch.setattr(fr, "live_inflight_by_thread",
                            lambda: {ident: ("device", "knn_q")})
        prof = _prof(sample_interval_ms=2.0)
        try:
            prof.start()
            deadline = time.monotonic() + 5.0
            while (prof.device_attributed_samples < 3
                   and time.monotonic() < deadline):
                time.sleep(0.01)
        finally:
            prof.stop()
    finally:
        stop.set()
        t.join(5.0)
    assert prof.device_attributed_samples >= 3
    assert "[device:knn_q]" in prof.collapsed()


def test_live_inflight_by_thread_reads_enabled_recorders(monkeypatch):
    """The recorder's in-flight slots, keyed by the stepping thread, as the
    JAX package's ``inflight_by_thread`` gives them."""
    import types

    from pathway_tpu_torch.engine import flight_recorder as fr

    monkeypatch.setenv("PATHWAY_FLIGHT_RECORDER", "1")
    rec = fr.FlightRecorder.from_env()
    node = types.SimpleNamespace(name="knn_q", op=object(), id=1)
    rec.mark_op(4, node, "device")
    assert fr.live_inflight_by_thread()[threading.get_ident()] == (
        "device", "knn_q")
    rec.clear_op()
    assert threading.get_ident() not in fr.live_inflight_by_thread()


def test_collapsed_baseline_subtracts_prior_samples():
    prof = _prof()
    with prof._lock:
        prof._stacks[("worker", ("f (a.py:1)",))] = 7
    baseline = prof.stack_counts()
    with prof._lock:
        prof._stacks[("worker", ("f (a.py:1)",))] = 9
        prof._stacks[("worker", ("g (a.py:2)",))] = 1
    diff = prof.collapsed(baseline)
    assert "worker;f (a.py:1) 2" in diff
    assert "worker;g (a.py:2) 1" in diff
    assert "7" not in diff


def test_stack_table_overflow_folds_into_other_bucket(monkeypatch):
    from pathway_tpu_torch.engine import profiler as mod

    monkeypatch.setattr(mod, "_MAX_DISTINCT_STACKS", 4)
    prof = _prof()
    with prof._lock:
        for i in range(4):
            prof._stacks[("worker", (f"f{i} (x.py:{i})",))] = 1
    # a sampler pass over a thread whose stack is new, past the bound
    monkeypatch.setattr(mod.sys, "_current_frames",
                        lambda: {threading.get_ident():
                                 sys_frame_of_fresh()})
    monkeypatch.setattr(threading, "enumerate", lambda: [
        type("T", (), {"ident": threading.get_ident(),
                       "name": "pathway-tpu-worker"})()])
    prof._sample_once(self_ident=-1)
    assert prof.stack_counts().get(("worker", ("(other)",))) == 1


def sys_frame_of_fresh():
    def fresh():
        import sys

        return sys._getframe()

    return fresh()


def test_live_profiler_stats_roundtrip():
    assert live_profiler_stats() is None
    prof = _prof()
    install_profiler(prof)
    assert current_profiler() is prof
    st = live_profiler_stats()
    assert st is not None
    assert set(st) >= {"host", "machine", "mfu_rolling", "hbm_bw_util",
                       "families", "capture", "legs", "device"}
    assert st["host"]["sampling"] is False
    assert st["device"] == "cpu"
    assert st["machine"]["balance_flop_per_byte"] == pytest.approx(
        machine_balance(), abs=1e-3)


def test_from_env(monkeypatch):
    monkeypatch.delenv("PATHWAY_PROFILER", raising=False)
    monkeypatch.setenv("PATHWAY_PROFILER_DEVICE", "cpu")
    assert Profiler.from_env() is None
    assert Profiler.from_env(auto_on=True) is not None
    monkeypatch.setenv("PATHWAY_PROFILER", "0")
    assert Profiler.from_env(auto_on=True) is None
    monkeypatch.setenv("PATHWAY_PROFILER", "1")
    monkeypatch.setenv("PATHWAY_PROFILER_SAMPLE_MS", "5")
    monkeypatch.setenv("PATHWAY_PROFILER_WINDOW_S", "12")
    prof = Profiler.from_env()
    assert str(prof.device) == "cpu"
    assert prof.sample_interval_s == pytest.approx(0.005)
    assert prof.window_s == 12.0


def test_profiler_defaults_to_cuda():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Profiler()


def test_device_capture_writes_a_trace(tmp_path):
    import torch

    prof = _prof()
    out = prof.start_device_capture(str(tmp_path / "cap"))
    with pytest.raises(RuntimeError, match="already running"):
        prof.start_device_capture()
    assert prof.stats()["capture"]["running"] is True
    torch.ones(64, 64) @ torch.ones(64, 64)
    assert prof.stop_device_capture() == out
    traces = list((tmp_path / "cap").glob("trace-*.json"))
    assert len(traces) == 1 and traces[0].stat().st_size > 0
    assert prof.captures_total == 1
    with pytest.raises(RuntimeError, match="no device capture"):
        prof.stop_device_capture()


# ---------------------------------------------------------------------------
# knn hooks: the JAX package's family records, outputs identical on/off
# ---------------------------------------------------------------------------

def _knn_roundtrip(side: str, dtype: str, paged: bool, n: int, q: int,
                   metric: str = "l2sq"):
    """One add_batch of ``n`` rows, one search of ``q`` queries, one
    removal and a second search (a flushing scatter): the results."""
    if side == "jax":
        from pathway_tpu.internals.keys import Pointer
        from pathway_tpu.ops.knn import BruteForceKnnIndex
        kw = {"paged": paged}
    else:
        from pathway_tpu_torch.internals.keys import Pointer
        from pathway_tpu_torch.ops.knn import BruteForceKnnIndex
        kw = {"device": "cpu", "paged": paged}
    rng = np.random.default_rng(7)
    vecs = rng.normal(size=(n, 8)).astype(np.float32)
    idx = BruteForceKnnIndex(8, metric=metric, dtype=dtype, **kw)
    idx.add_batch([Pointer(i) for i in range(n)], vecs)
    queries = [(Pointer(10_000 + i), vecs[i * 5], 4, None)
               for i in range(q)]
    first = idx.search(queries)
    idx.remove(Pointer(0))
    return first, idx.search(queries)


def _family_records(prof) -> dict:
    return {fam: (st["dispatches"], st["flops_total"], st["bytes_total"])
            for fam, st in prof.family_stats().items()}


@pytest.mark.parametrize("n,q", [(48, 3), (300, 7)])
@pytest.mark.parametrize("paged", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_knn_family_records_equal_jax(dtype, paged, n, q, monkeypatch):
    """The same adds, searches and removal through the JAX index and the
    port's, each the contiguous slab or the paged store: the same
    families, dispatch counts, ``flops_total`` and ``bytes_total``,
    exactly."""
    from pathway_tpu.engine import profiler as jprof

    monkeypatch.setenv("PATHWAY_RESULT_CACHE", "0")
    jp = jprof.Profiler(sample_interval_ms=1e6)
    jprof.install_profiler(jp)
    try:
        jax_out = _knn_roundtrip("jax", dtype, paged, n, q)
    finally:
        jprof.install_profiler(None)
    tp = _prof()
    install_profiler(tp)
    torch_out = _knn_roundtrip("torch", dtype, paged, n, q)
    install_profiler(None)
    assert _family_records(tp) == _family_records(jp)
    assert set(_family_records(tp)) == {"ingest_scatter", "knn_search"}
    assert len(torch_out[0]) == len(jax_out[0]) == q


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("metric", ["l2sq", "cos"])
def test_knn_outputs_identical_with_profiler_on_and_off(dtype, metric):
    off = _knn_roundtrip("torch", dtype, True, 48, 3, metric)
    prof = _prof()
    install_profiler(prof)
    on = _knn_roundtrip("torch", dtype, True, 48, 3, metric)
    assert on == off  # the profiler only observes shapes and clocks
    fams = prof.family_stats()
    assert fams["knn_search"]["dispatches"] == 2
    assert fams["ingest_scatter"]["dispatches"] == 2
    assert fams["knn_search"]["roofline"]["bound_by"] == "bandwidth"
    assert fams["knn_search"]["device_ms_total"] > 0.0


# ---------------------------------------------------------------------------
# the port's own hooks: forwards, fused and graphed steps, legs, pw.run
# ---------------------------------------------------------------------------

def _docs(n: int) -> list[str]:
    return [f"doc {i} word{i} word{i * 7} word{i % 5}" for i in range(n)]


@pytest.mark.parametrize("ragged,dtype", [(False, "bfloat16"),
                                          (True, "int8"),
                                          (True, "float32")])
def test_embedding_index_records_forwards_and_writes(ragged, dtype):
    """``DeviceEmbeddingKnnIndex``: one forward record per encoder dispatch
    (``encoder_forward`` padded, ``segment_attention`` ragged, one a
    graphed int8 step), one ``ingest_scatter`` per fused write with the
    chunk's real rows, one ``knn_search`` per search; the index equal to
    one built with the profiler off."""
    import torch

    from pathway_tpu_torch.engine.profiler import (encoder_cost,
                                                   ingest_scatter_cost,
                                                   segment_attention_cost)
    from pathway_tpu_torch.internals.keys import Pointer
    from pathway_tpu_torch.models.encoder import EncoderConfig
    from pathway_tpu_torch.ops.knn import (BruteForceKnnIndex,
                                           DeviceEmbeddingKnnIndex)
    from pathway_tpu_torch.xpacks.llm.embedders import EncoderEmbedder

    def build():
        emb = EncoderEmbedder(config=EncoderConfig.tiny(), device="cpu",
                              ragged=ragged)
        idx = DeviceEmbeddingKnnIndex(emb, BruteForceKnnIndex(
            64, reserved_space=256, metric="cos", dtype=dtype,
            device="cpu"))
        docs = _docs(90)
        idx.add_batch([Pointer(i) for i in range(90)], docs)
        res = idx.search([(Pointer(10**6), docs[5], 3, None)])
        return emb, idx, res

    _emb_off, idx_off, res_off = build()
    prof = _prof()
    install_profiler(prof)
    emb, idx, res = build()
    install_profiler(None)
    assert res == res_off
    ext_on = [e for e in idx.inner._pool.extents if e.established]
    ext_off = [e for e in idx_off.inner._pool.extents if e.established]
    assert all(torch.equal(a.vectors, b.vectors)
               for a, b in zip(ext_on, ext_off))
    fams = prof.family_stats()
    fam = "segment_attention" if ragged else "encoder_forward"
    assert set(fams) == {fam, "ingest_scatter", "knn_search"}
    # every encoder dispatch (ingest chunks and the query) is one record
    assert fams[fam]["dispatches"] == emb.dispatches
    cfg = emb.config
    cost = segment_attention_cost if ragged else encoder_cost
    if ragged:
        chunks = emb.pack_ragged(_docs(90))
        shapes = [c[0][0].shape for c in chunks] + [
            emb.pack_ragged([_docs(90)[5]])[0][0][0].shape]
    else:
        shapes = [emb.pack_tokens(_docs(90))[0].shape,
                  emb.pack_tokens([_docs(90)[5]])[0].shape]
    want = [cost(b, s, hidden=cfg.hidden, intermediate=cfg.intermediate,
                 layers=cfg.layers) for b, s in shapes]
    assert fams[fam]["flops_total"] == sum(f for f, _ in want)
    assert fams[fam]["bytes_total"] == sum(b for _, b in want)
    # the fused writes cover the 90 documents, at the slab's width
    itemsize = {"int8": 1, "bfloat16": 2, "float32": 4}[dtype]
    writes = fams["ingest_scatter"]
    assert writes["dispatches"] == (len(shapes) - 1 if ragged else 1)
    assert writes["flops_total"] == ingest_scatter_cost(
        90, 64, itemsize)[0]
    assert fams["knn_search"]["dispatches"] == 1


def _engine_graph(bridge_window: str, monkeypatch, profiled: bool):
    import pathway_tpu_torch as pw
    from pathway_tpu_torch.internals.parse_graph import G
    from pathway_tpu_torch.internals.runner import GraphRunner
    from pathway_tpu_torch.models.encoder import EncoderConfig
    from pathway_tpu_torch.xpacks.llm.embedders import EncoderEmbedder

    monkeypatch.setenv("PATHWAY_DEVICE_INFLIGHT", bridge_window)
    G.clear()
    emb = EncoderEmbedder(config=EncoderConfig.tiny(), device="cpu")
    docs = _docs(48)
    t = pw.debug.table_from_rows(
        pw.schema_from_types(data=str),
        [(d, 2 * (i // 8), 1) for i, d in enumerate(docs)], is_stream=True)
    prof = _prof() if profiled else None
    install_profiler(prof)
    try:
        runner = GraphRunner()
        cap = runner.capture(t.select(e=emb(pw.this.data)))
        runner.run_batch(n_workers=1)
    finally:
        install_profiler(None)
        G.clear()
    events = [(k, tuple(np.asarray(v).tobytes() for v in row), tm, d)
              for k, row, tm, d in cap.events]
    return events, emb, prof


@pytest.mark.parametrize("window", ["1", "2"])
def test_engine_legs_retime_the_forwards(window, monkeypatch):
    """Under ``run_batch``, sync mode (window 1: each device node a leg)
    and the bridge (window 2: each tick's device leg) re-time every
    forward to its leg's measured time: every record attributed, the
    family's device ms summing to the legs' ms; outputs byte-identical
    with the profiler off."""
    off, _emb, _ = _engine_graph(window, monkeypatch, profiled=False)
    on, emb, prof = _engine_graph(window, monkeypatch, profiled=True)
    assert on == off
    fam = prof.family_stats()["encoder_forward"]
    assert fam["dispatches"] == emb.dispatches == 6  # one a tick
    assert fam["attributed_dispatches"] == 6
    legs = prof.leg_stats()
    assert legs["committed"] == 6 and legs["pending"] == 0
    # float sums in two orders: rel 1e-9
    assert fam["attributed_device_ms_total"] == pytest.approx(
        legs["ms_total"], rel=1e-9)


def test_pw_run_installs_and_removes_the_profiler(monkeypatch):
    """``PATHWAY_PROFILER=1``: ``pw.run`` installs a profiler on
    ``PATHWAY_PROFILER_DEVICE``, samples while it runs and removes it at
    the end; unset, the run installs none."""
    import pathway_tpu_torch as pw
    from pathway_tpu_torch.engine import profiler as mod
    from pathway_tpu_torch.internals.parse_graph import G

    seen = []

    class Probe(pw.io.python.ConnectorSubject):
        def run(self):
            seen.append(mod.current_profiler())
            self.next(v=1)

    for flag in ("1", "0"):
        monkeypatch.setenv("PATHWAY_PROFILER", flag)
        monkeypatch.setenv("PATHWAY_PROFILER_DEVICE", "cpu")
        G.clear()
        t = pw.io.python.read(Probe(), schema=pw.schema_from_types(v=int))
        pw.io.subscribe(t, on_change=lambda **kw: None)
        pw.run()
        assert mod.current_profiler() is None
    G.clear()
    assert isinstance(seen[0], Profiler) and str(seen[0].device) == "cpu"
    assert seen[0]._thread is None  # its sampler stopped with the run
    assert seen[1] is None


# ---------------------------------------------------------------------------
# per-tenant serving metrics and the tenant-attributing search
# ---------------------------------------------------------------------------

def _finish_query(tr, rid, key, ms, tenant=None):
    """tests/test_profiler.py's helper: a synthetic span on the real clock
    whose e2e is about ``ms``, attributed to ``tenant`` when given."""
    base = time.perf_counter()
    span = tr.start(rid, "/q", t_ingress=base)
    span.key = key
    tr._by_key[key] = span
    span.t_enqueued = base
    if tenant is not None:
        tr.attribute_tenant([key], tenant)
    span.t_resolved = base + ms / 1e3
    tr.finish(span)


def test_tenant_summary_tracks_per_tenant_quantiles_and_burn():
    """tests/test_profiler.py's test of ``RequestTracker.tenant_summary``,
    on both packages' trackers: the same counts and burn rates."""
    from pathway_tpu.engine.request_tracker import RequestTracker as JTracker
    from pathway_tpu_torch.engine.request_tracker import RequestTracker

    out = {}
    for name, cls in (("jax", JTracker), ("torch", RequestTracker)):
        tr = cls(slo_ms=50.0)
        for i in range(40):
            _finish_query(tr, f"a{i}", ("a", i), 10.0, tenant="acme")
        for i in range(40):
            _finish_query(tr, f"b{i}", ("b", i), 100.0, tenant="bigco")
        for i in range(5):
            _finish_query(tr, f"n{i}", ("n", i), 10.0)  # unattributed
        ts = tr.tenant_summary()
        assert set(ts) == {"acme", "bigco"}
        assert ts["acme"]["count"] == 40
        assert ts["acme"]["p50_ms"] <= ts["acme"]["p95_ms"]
        assert ts["acme"]["burn_rate"] == 0.0
        assert ts["bigco"]["burn_rate"] > 1.0
        assert tr.summary()["tenants"] == ts
        out[name] = {t: (v["count"], v["burn_rate"]) for t, v in ts.items()}
    assert out["torch"] == out["jax"]


def test_attribute_tenant_first_attribution_wins():
    """tests/test_profiler.py's test of ``attribute_tenant``."""
    from pathway_tpu_torch.engine.request_tracker import RequestTracker

    tr = RequestTracker(slo_ms=50.0)
    span = tr.start("r1", "/q", t_ingress=0.0)
    span.key = "k1"
    tr._by_key["k1"] = span
    tr.attribute_tenant(["k1", "missing-key"], "first")
    tr.attribute_tenant(["k1"], "second")
    assert span.tenant == "first"


@pytest.mark.parametrize("paged", [False, True])
def test_knn_search_attributes_tenant_to_live_trackers(paged):
    """tests/test_profiler.py's test of a tenant index's search (the slab
    there; the paged index takes its tenant from the constructor)."""
    from pathway_tpu_torch.engine.request_tracker import RequestTracker
    from pathway_tpu_torch.internals.keys import Pointer
    from pathway_tpu_torch.ops.knn import BruteForceKnnIndex

    tr = RequestTracker(slo_ms=50.0)  # registers itself as live
    qkey = Pointer(501)
    span = tr.start("r1", "/q", t_ingress=0.0)
    span.key = qkey
    tr._by_key[qkey] = span
    if paged:
        idx = BruteForceKnnIndex(4, paged=True, tenant="acme", device="cpu")
    else:
        idx = BruteForceKnnIndex(4, paged=False, device="cpu")
        idx._tenant = "acme"
    idx.add_batch([Pointer(0)], np.ones((1, 4), np.float32))
    idx.search([(qkey, np.ones(4, np.float32), 1, None)])
    assert span.tenant == "acme"


# ---------------------------------------------------------------------------
# profdiff
# ---------------------------------------------------------------------------

def _epoch(knn_ms, frame_share, samples=100):
    return {
        "mfu_rolling": 0.1,
        "families": {
            "knn_search": {"dispatches": 10,
                           "device_ms_total": knn_ms * 10,
                           "roofline": {"bound_by": "bandwidth"}},
            "encoder_forward": {"dispatches": 10, "device_ms_total": 50.0,
                                "roofline": {"bound_by": "compute"}},
        },
        "host": {
            "samples_total": samples,
            "top_frames": [
                {"frame": "search (knn.py:900)",
                 "samples": int(samples * frame_share)},
                {"frame": "step (graph.py:100)",
                 "samples": samples - int(samples * frame_share)},
            ],
        },
    }


def test_diff_profiles_names_dominant_kernel_and_frame():
    from pathway_tpu.engine.profiler import diff_profiles as jdiff

    d = diff_profiles(_epoch(2.0, 0.2), _epoch(6.0, 0.7))
    assert d == jdiff(_epoch(2.0, 0.2), _epoch(6.0, 0.7))
    assert d["dominant_kernel"]["family"] == "knn_search"
    assert d["dominant_kernel"]["delta_ms_per_dispatch"] == pytest.approx(4.0)
    assert d["dominant_kernel"]["ratio"] == pytest.approx(3.0)
    assert d["dominant_kernel"]["bound_by"] == "bandwidth"
    assert d["dominant_frame"]["frame"] == "search (knn.py:900)"
    assert d["dominant_frame"]["delta_share"] == pytest.approx(0.5)
    assert d["mfu_rolling_delta"] == 0.0


def test_diff_profiles_accepts_bench_artifacts():
    a = {"unit": "docs/s", "profile": [_epoch(1.0, 0.1), _epoch(2.0, 0.2)]}
    b = {"unit": "docs/s", "profile": [_epoch(3.0, 0.2)]}
    d = diff_profiles(a, b)  # last epoch of each artifact wins
    assert d["dominant_kernel"]["device_ms_per_dispatch_a"] == 2.0
    assert d["dominant_kernel"]["device_ms_per_dispatch_b"] == 3.0


def test_diff_profiles_rejects_profile_free_artifacts():
    with pytest.raises(ValueError, match="--profile"):
        diff_profiles({"unit": "docs/s"}, _epoch(1.0, 0.1))


def test_profile_epoch_embeds_host_and_families():
    prof = _prof()
    prof.record_dispatch("knn_search", 100.0, 1000.0, 1.0)
    with prof._lock:
        prof._stacks[("worker", ("f (a.py:1)", "g (a.py:2)"))] = 5
        prof.samples_total = 5
    ep = prof.profile_epoch()
    assert ep["families"]["knn_search"]["dispatches"] == 1
    frames = {e["frame"]: e["samples"] for e in ep["host"]["top_frames"]}
    assert frames == {"f (a.py:1)": 5, "g (a.py:2)": 5}
    d = diff_profiles(ep, ep)
    assert d["dominant_kernel"]["delta_ms_per_dispatch"] == 0.0
