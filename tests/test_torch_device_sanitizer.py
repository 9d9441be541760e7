"""The port's steady-state device sanitizer
(pathway_tpu_torch/engine/device_sanitizer.py) and ``pw.warmup``'s window.

The env contract is held against the JAX package's table
(tests/test_device_sanitizer.py): the same values arm, and the same
values raise. The state machine (arm, declare, suspend, report mode, the
capture counter) is driven through the port's capture hook,
``note_capture``, which every CUDA graph capture site calls (ops/knn.py
``GraphedIngestStep``): on the CPU through a step whose graphs are eager
stand-ins. The sync guard's modes are read through a recording stand-in
for ``torch.cuda.set_sync_debug_mode`` (the CPU build has none), and report
mode's count through torch's own warning text. The tests marked ``cuda``
hold the guard and the ragged captures on the card:

    python -m pytest --noconftest -m cuda tests/test_torch_device_sanitizer.py

The JAX package is imported inside the tests that use it, so the ``cuda``
tests run where JAX is not installed."""

import warnings

import numpy as np
import pytest
import torch

from pathway_tpu_torch.engine import device_sanitizer as ds
from pathway_tpu_torch.internals.keys import Pointer
from pathway_tpu_torch.models.encoder import EncoderConfig
from pathway_tpu_torch.ops import knn as tknn
from pathway_tpu_torch.xpacks.llm.embedders import EncoderEmbedder

SYNC_TEXT = "called a synchronizing CUDA operation"


@pytest.fixture(autouse=True)
def _fresh_state(monkeypatch):
    monkeypatch.delenv("PATHWAY_DEVICE_SANITIZER", raising=False)
    ds._reset_for_tests()
    yield
    ds._reset_for_tests()


@pytest.fixture
def modes(monkeypatch):
    """Every mode the sanitizer sets torch's sync guard to, in order."""
    seen: list[str] = []
    monkeypatch.setattr(ds, "_set_sync_debug_mode", seen.append)
    return seen


# ---------------------------------------------------------------------------
# the env contract, against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("val,enabled,raises", [
    ("1", True, True), ("true", True, True), ("on", True, True),
    ("report", True, False), ("warn", True, False), ("", False, False),
    ("0", False, False)])
def test_env_contract_equals_jax(monkeypatch, val, enabled, raises):
    from pathway_tpu.engine import device_sanitizer as jds

    monkeypatch.setenv("PATHWAY_DEVICE_SANITIZER", val)
    assert ds.sanitizer_enabled() is jds.sanitizer_enabled() is enabled
    if enabled:
        assert ds._raise_on_violation() is jds._raise_on_violation() \
            is raises


# ---------------------------------------------------------------------------
# the state machine, through the capture hook
# ---------------------------------------------------------------------------

def test_disabled_sanitizer_is_inert(modes):
    assert not ds.sanitizer_enabled()
    assert ds.arm() is False
    assert ds.declare_steady_state() is False
    assert not ds.in_steady_state()
    ds.note_capture("a graph")  # nobody's business when off
    assert ds.violations() == []
    assert ds.warmup_compiles() == ds.post_warmup_compiles() == 0
    with ds.explicit_sync("a fetch"):
        pass
    assert modes == []  # nothing guarded, nothing set


def test_warmup_window_counts_captures_without_violating(monkeypatch):
    monkeypatch.setenv("PATHWAY_DEVICE_SANITIZER", "1")
    assert ds.arm() is True
    assert not ds.in_steady_state()
    ds.note_capture("bucket 1")
    ds.note_capture("bucket 2")
    assert ds.warmup_compiles() == 2
    assert ds.post_warmup_compiles() == 0
    assert ds.violations() == []


def test_post_warmup_capture_raises_and_names_the_remedy(monkeypatch):
    monkeypatch.setenv("PATHWAY_DEVICE_SANITIZER", "1")
    ds.arm()
    ds.note_capture("bucket 1")
    ds.declare_steady_state()
    assert ds.in_steady_state()
    with pytest.raises(ds.DeviceDisciplineViolation,
                       match="steady-state serving window"):
        ds.note_capture("an unwarmed shape")
    assert ds.post_warmup_compiles() == 1
    assert [v["kind"] for v in ds.violations()] == ["post-warmup-compile"]
    assert "suspend_steady_state" in ds.violations()[0]["message"]
    assert "an unwarmed shape" in ds.violations()[0]["message"]


def test_suspend_steady_state_reopens_the_window(monkeypatch, modes):
    monkeypatch.setenv("PATHWAY_DEVICE_SANITIZER", "1")
    ds.arm()
    ds.declare_steady_state()
    before = ds.warmup_compiles()
    with ds.suspend_steady_state("extent growth"):
        assert not ds.in_steady_state()
        ds.note_capture("maintenance")  # legal
        assert modes[-1] == "default"
    assert ds.in_steady_state()  # restored on exit
    assert modes[-1] == "error"
    assert ds.warmup_compiles() == before + 1
    assert ds.post_warmup_compiles() == 0
    assert ds.violations() == []


def test_disarm_closes_the_sanitizer(monkeypatch, modes):
    monkeypatch.setenv("PATHWAY_DEVICE_SANITIZER", "1")
    ds.arm()
    ds.note_capture("warm-up")
    ds.declare_steady_state()
    ds.disarm()
    assert not ds.in_steady_state() and modes[-1] == "default"
    ds.note_capture("after")  # counted, never a violation
    assert ds.warmup_compiles() == 1 and ds.post_warmup_compiles() == 0
    assert ds.violations() == []


def test_suspend_outside_steady_state_is_free(modes):
    with ds.suspend_steady_state("nothing armed"):
        ds.note_capture("anything")
    assert modes == [] and not ds.in_steady_state()


def test_report_mode_records_without_raising(monkeypatch, modes):
    monkeypatch.setenv("PATHWAY_DEVICE_SANITIZER", "report")
    ds.arm()
    ds.declare_steady_state()
    assert modes[-1] == "warn"
    ds.note_capture("an unwarmed shape")  # would raise in raise mode
    assert ds.post_warmup_compiles() == 1
    assert [v["kind"] for v in ds.violations()] == ["post-warmup-compile"]


def test_install_compile_counter_needs_no_env():
    count = ds.install_compile_counter()
    before = count()
    ds.note_capture("a graph")
    ds.note_capture("another")
    assert count() == before + 2
    assert ds.violations() == []  # the counter never enforces


@pytest.mark.parametrize("val,steady_mode", [("1", "error"),
                                             ("report", "warn")])
def test_guard_modes(monkeypatch, modes, val, steady_mode):
    """arm drops the guard, steady state sets "error" (raise mode) or
    "warn" (report mode), explicit_sync lifts it once for nested blocks
    and restores it."""
    monkeypatch.setenv("PATHWAY_DEVICE_SANITIZER", val)
    ds.arm()
    assert modes == ["default"]
    ds.declare_steady_state()
    assert modes[-1] == steady_mode
    n = len(modes)
    with ds.explicit_sync("search results"):
        assert modes[-1] == "default"
        with ds.explicit_sync("drain"):
            pass
        assert modes[-1] == "default" and len(modes) == n + 1
    assert modes[-1] == steady_mode and len(modes) == n + 2


def test_explicit_sync_restores_after_an_error(monkeypatch, modes):
    monkeypatch.setenv("PATHWAY_DEVICE_SANITIZER", "1")
    ds.declare_steady_state()
    with pytest.raises(ValueError):
        with ds.explicit_sync("a fetch"):
            raise ValueError("inside")
    assert modes[-1] == "error"


def test_count_syncs_counts_torch_warnings(modes):
    """Outside steady state a count sets report mode for its window and
    counts torch's sync warnings, every one (not once per line), without
    printing them or recording violations."""
    with ds.count_syncs() as c:
        assert modes[-1] == "warn"
        for _ in range(3):
            warnings.warn(SYNC_TEXT)
        with ds.explicit_sync("a fetch"):
            assert modes[-1] == "default"
        assert modes[-1] == "warn"
    assert c.count == 3
    assert modes[-1] == "default"
    assert ds.violations() == []


def test_count_syncs_keeps_a_raise_mode_guard(monkeypatch, modes):
    monkeypatch.setenv("PATHWAY_DEVICE_SANITIZER", "1")
    ds.declare_steady_state()
    with ds.count_syncs() as c:
        assert modes[-1] == "error"
    assert c.count == 0 and modes[-1] == "error"


def test_report_mode_records_each_sync(monkeypatch, modes):
    monkeypatch.setenv("PATHWAY_DEVICE_SANITIZER", "report")
    ds.arm()
    ds.declare_steady_state()
    with ds.count_syncs() as c:
        warnings.warn(SYNC_TEXT)
        warnings.warn(SYNC_TEXT)
        warnings.warn("an unrelated warning")
    assert c.count == 2
    kinds = [v["kind"] for v in ds.violations()]
    assert kinds == ["implicit-sync", "implicit-sync"]
    assert "explicit_sync" in ds.violations()[0]["message"]


# ---------------------------------------------------------------------------
# the capture hook at its one site, GraphedIngestStep
# ---------------------------------------------------------------------------

class _EagerGraphStep(tknn.GraphedIngestStep):
    """The step with the graph machinery replaced by eager calls, so the
    CPU reaches the capture site."""

    @staticmethod
    def _graphed(dev):
        return True

    @staticmethod
    def _warm(body, device):
        body()

    def _record(self, body):
        class Graph:
            def replay(self):
                body()

        body()
        return Graph()


def _ragged_index(reserved: int = 512):
    emb = EncoderEmbedder(config=EncoderConfig.tiny(), ragged=True,
                          max_len=64, device="cpu")
    inner = tknn.BruteForceKnnIndex(64, reserved_space=reserved,
                                    metric="cos", dtype="int8",
                                    device="cpu")
    idx = tknn.DeviceEmbeddingKnnIndex(emb, inner)
    step = _EagerGraphStep(emb.ragged_device_forward, inner.device,
                           ((emb, "dispatches"),))
    idx._fused = inner._ingest_fn(step)
    idx._fused.step = step
    return emb, idx, step


def _docs(n, start=0):
    return [f"doc{i} " + " ".join(f"w{(i * 5 + j) % 61}"
                                  for j in range(3 + i % 11))
            for i in range(start, start + n)]


def test_ragged_warmup_captures_count_as_warmup(monkeypatch):
    """pw.warmup over the ragged int8 path captures one graph per bucket,
    all counted as warm-up; steady-state ingest and search capture
    nothing; a chunk shape warm-up never saw raises."""
    import pathway_tpu_torch as pw

    monkeypatch.setenv("PATHWAY_DEVICE_SANITIZER", "1")
    emb, idx, step = _ragged_index()
    out = pw.warmup(emb, index=idx, ks=(3,))
    assert ds.in_steady_state()
    assert step.captures == ds.warmup_compiles() == len(emb.ragged_buckets())
    assert [e[0] for e in out["compiled"]] == [
        "ragged_fused_ingest", "ragged_encode"] * len(emb.ragged_buckets())
    assert len(idx) == 0  # the scratch keys are gone
    docs = _docs(40)
    idx.add_batch([Pointer(i) for i in range(40)], docs)
    res = idx.search([(Pointer(10 ** 6), docs[3], 3, None)])
    assert len(res[0]) == 3
    assert ds.post_warmup_compiles() == 0 and ds.violations() == []
    # a chunk whose graph warm-up never captured (dropped here) raises
    step.graphs.clear()
    with pytest.raises(ds.DeviceDisciplineViolation):
        idx.add_batch([Pointer(100 + i) for i in range(8)], _docs(8, 100))
    assert ds.post_warmup_compiles() == 1


def test_rewarmup_of_an_armed_process_is_not_a_violation(monkeypatch):
    import pathway_tpu_torch as pw

    monkeypatch.setenv("PATHWAY_DEVICE_SANITIZER", "1")
    pw.warmup()
    assert ds.in_steady_state()
    emb, idx, step = _ragged_index()
    pw.warmup(emb, index=idx)  # suspends, never violates
    assert ds.in_steady_state()
    assert step.captures == ds.warmup_compiles() == len(emb.ragged_buckets())
    assert ds.violations() == []


def test_warmup_without_env_leaves_everything_off(modes):
    import pathway_tpu_torch as pw

    emb, idx, step = _ragged_index()
    pw.warmup(emb, index=idx)
    assert not ds.in_steady_state()
    assert ds.warmup_compiles() == 0
    assert step.captures == len(emb.ragged_buckets())
    assert modes == []


# ---------------------------------------------------------------------------
# uploads: nothing kept per batch shape outside a graph's inputs
# ---------------------------------------------------------------------------

def _state_sizes(obj) -> dict:
    return {k: len(v) for k, v in vars(obj).items()
            if isinstance(v, (dict, list, set, tuple))}


def test_eager_producers_upload_per_call_and_keep_no_shape_state(
        monkeypatch):
    """The padded producer (raw batch sizes) and the eager ragged producer
    upload through ``_device.upload``, two and five tensors a call, never
    through ``PinnedStaging`` (whose buffers live per shape): many distinct
    batch sizes leave the embedder's state as it was."""
    from pathway_tpu_torch._device import PinnedStaging
    from pathway_tpu_torch.xpacks.llm import embedders

    uploads: list[tuple] = []

    def recording_upload(t, device):
        uploads.append(tuple(t.shape))
        return t

    def no_staging(self, arrays):
        raise AssertionError("an eager producer used PinnedStaging")

    monkeypatch.setattr(embedders, "upload", recording_upload)
    monkeypatch.setattr(PinnedStaging, "upload", no_staging)
    rng = np.random.default_rng(0)
    for ragged in (False, True):
        emb = EncoderEmbedder(config=EncoderConfig.tiny(), ragged=ragged,
                              max_len=64, device="cpu")
        before = _state_sizes(emb)
        uploads.clear()
        sizes = list(range(1, 40)) + [61, 97, 130]
        for b in sizes:
            docs = [" ".join(f"w{j}" for j in rng.integers(
                0, 50, int(rng.integers(1, 40)))) for _ in range(b)]
            assert emb.encode_batch_device(docs).shape == (b, 64)
        assert _state_sizes(emb) == before
        if not ragged:
            assert len(uploads) == 2 * len(sizes)
            assert {s[0] for s in uploads} == set(sizes)
        else:
            assert len(uploads) % 5 == 0 and uploads


def test_int8_fused_ingest_uploads_slots_per_call(monkeypatch):
    """The int8 fused step of a padded producer uploads each batch's slots
    with ``upload``, not through per-shape staging."""
    from pathway_tpu_torch._device import PinnedStaging

    def no_staging(self, arrays):
        raise AssertionError("the int8 fused step used PinnedStaging")

    monkeypatch.setattr(PinnedStaging, "upload", no_staging)
    emb = EncoderEmbedder(config=EncoderConfig.tiny(), max_len=64,
                          device="cpu")
    idx = tknn.DeviceEmbeddingKnnIndex(emb, tknn.BruteForceKnnIndex(
        64, reserved_space=512, metric="cos", dtype="int8", device="cpu"))
    n = 0
    for b in (1, 2, 3, 5, 8, 13, 21, 34):
        idx.add_batch([Pointer(n + i) for i in range(b)], _docs(b, n))
        n += b
    assert len(idx) == n
    docs = _docs(n)
    res = idx.search([(Pointer(10 ** 6), docs[7], 1, None)])
    assert res[0][0][0] == Pointer(7)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the sync guard and CUDA graphs "
                    "exist only there")
    return torch.device("cuda")


@pytest.mark.cuda
def test_guard_raises_on_an_implicit_sync_on_the_card(monkeypatch):
    dev = _card()
    monkeypatch.setenv("PATHWAY_DEVICE_SANITIZER", "1")
    x = torch.arange(8, device=dev, dtype=torch.float32)
    ds.declare_steady_state()
    try:
        with pytest.raises(RuntimeError, match="synchronizing"):
            x.sum().item()
        with pytest.raises(RuntimeError, match="synchronizing"):
            torch.from_numpy(np.ones(4, np.float32)).to(dev)
        with ds.explicit_sync("a fetch"):
            assert x.sum().item() == 28.0
        # a pinned, non-blocking upload waits for nothing
        from pathway_tpu_torch._device import upload

        y = upload(torch.from_numpy(np.ones(4, np.float32)), dev)
        with ds.explicit_sync("a fetch"):
            assert y.cpu().tolist() == [1.0] * 4
    finally:
        ds._reset_for_tests()


@pytest.mark.cuda
def test_report_mode_counts_syncs_on_the_card():
    dev = _card()
    x = torch.arange(8, device=dev, dtype=torch.float32)
    with ds.count_syncs() as c:
        x.sum().item()
        x.max().item()
        with ds.explicit_sync("a fetch"):
            x.cpu()
    assert c.count == 2


@pytest.mark.cuda
@pytest.mark.parametrize("ragged", [False, True])
def test_steady_state_ingest_and_search_on_the_card(monkeypatch, ragged):
    """pw.warmup, then fresh documents and a text search in raise mode:
    no capture, no implicit sync. Ragged: captures = buckets."""
    import pathway_tpu_torch as pw

    dev = _card()
    monkeypatch.setenv("PATHWAY_DEVICE_SANITIZER", "1")
    emb = EncoderEmbedder(config=EncoderConfig.tiny(), ragged=ragged,
                          max_len=64, max_batch_size=16, device=dev)
    idx = tknn.DeviceEmbeddingKnnIndex(emb, tknn.BruteForceKnnIndex(
        64, reserved_space=1024, metric="cos",
        dtype="int8" if ragged else "bfloat16", device=dev))
    try:
        pw.warmup(emb, index=idx, ks=(3,))
        if ragged:
            assert ds.warmup_compiles() == len(emb.ragged_buckets())
        docs = _docs(16)
        idx.add_batch([Pointer(i) for i in range(16)], docs)
        res = idx.search([(Pointer(10 ** 6), docs[3], 3, None)])
        idx.drain()
        assert res[0][0][0] == Pointer(3)
        assert ds.post_warmup_compiles() == 0 and ds.violations() == []
    finally:
        ds._reset_for_tests()


@pytest.mark.cuda
def test_padded_producer_frees_its_uploads_on_the_card(monkeypatch):
    """Many distinct batch sizes through the padded producer in raise mode:
    no implicit sync, and the card's allocated memory returns to where it
    was (no buffers kept per batch shape)."""
    dev = _card()
    monkeypatch.setenv("PATHWAY_DEVICE_SANITIZER", "1")
    emb = EncoderEmbedder(config=EncoderConfig.tiny(), max_len=64,
                          device=dev)
    ids, lens = emb.pack_tokens(_docs(4))
    emb.device_producer(emb.model, ids, lens)
    torch.cuda.synchronize(dev)
    base = torch.cuda.memory_allocated(dev)
    ds.declare_steady_state()
    try:
        for b in range(1, 97):
            ids, lens = emb.pack_tokens(_docs(b))
            out = emb.device_producer(emb.model, ids, lens)
            assert out.shape == (b, 64)
            del out
        assert ds.violations() == []
    finally:
        ds._reset_for_tests()
    torch.cuda.synchronize(dev)
    assert torch.cuda.memory_allocated(dev) == base
