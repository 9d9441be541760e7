"""On the card: ``kmeans_labels`` (stdlib/ml/classifiers/_clustering.py)
against its own CPU run, and the profiler's CUDA-event leg timing
(engine/profiler.py). This file imports no JAX, so its tests run on the
card: ``python -m pytest --noconftest -q -m cuda
tests/test_torch_ml_card.py``.

Tolerances: k-means labels equal on at least 99.9% of points (the card's
float32 products and reductions round in another order than the CPU's;
a point near a tie may change side, and with it, in later steps, a centre);
the re-timed records sum to the legs' CUDA-event time within 1e-9
(relative, two float sums)."""

import numpy as np
import pytest
import torch

from pathway_tpu_torch.engine import device_sanitizer
from pathway_tpu_torch.engine.profiler import Profiler, install_profiler


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the k-means and the leg timing "
                    "run on the card")
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def _fresh():
    install_profiler(None)
    yield
    install_profiler(None)


def _blobs(n: int, d: int, k: int, seed: int):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((k, d)).astype(np.float32)
    blob = rng.integers(0, k, n)
    pts = (centers[blob] + 0.25 * rng.standard_normal((n, d))).astype(
        np.float32)
    return pts, rng.integers(1, 5, n).astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("n,d,k", [(4096, 384, 64), (20000, 64, 256)])
def test_kmeans_on_card_matches_cpu(n, d, k):
    from pathway_tpu_torch.stdlib.ml.classifiers._clustering import \
        kmeans_labels

    _card()
    pts, w = _blobs(n, d, k, 0)
    cpu = np.asarray(kmeans_labels(pts, w, k, device="cpu"))
    with device_sanitizer.count_syncs() as syncs:
        card = np.asarray(kmeans_labels(pts, w, k, device="cuda"))
    assert syncs.count == 0  # the one fetch is an explicit sync
    assert (card == cpu).mean() >= 0.999


@pytest.mark.cuda
def test_kmeans_loop_adds_no_host_sync():
    import torch as t

    from pathway_tpu_torch.stdlib.ml.classifiers._clustering import \
        _kmeans_fn

    dev = _card()
    pts, w = _blobs(4096, 64, 32, 1)
    args = (t.from_numpy(pts).to(dev), t.from_numpy(w).to(dev),
            t.arange(32, device=dev) * 3)
    t.cuda.synchronize()
    with device_sanitizer.count_syncs() as syncs:
        labels = _kmeans_fn(*args, iters=25)
    assert syncs.count == 0
    assert labels.device.type == "cuda" and labels.shape == (4096,)


@pytest.mark.cuda
def test_leg_time_comes_from_cuda_events():
    """A leg of real work: its records wait for the end event (no host
    sync at end_leg), then sum to the events' elapsed time, which covers
    the card's work and not the host's few microseconds of dispatch."""
    dev = _card()
    prof = Profiler(sample_interval_ms=1e6, device=dev)
    a = torch.randn(4096, 4096, device=dev)
    torch.cuda.synchronize()
    with device_sanitizer.count_syncs() as syncs:
        for tick in range(3):
            prof.begin_leg(tick)
            for _ in range(8):
                a = torch.tanh(a @ a)
            prof.record_dispatch("encoder_forward", 8 * 2 * 4096.0 ** 3,
                                 8 * 3 * 4096.0 ** 2 * 4, 0.001)
            prof.record_dispatch("knn_search", 1.0, 1.0, 0.001)
            prof.end_leg(0.5)  # a host wall far below the card's time
    assert syncs.count == 0
    legs = prof.leg_stats()
    assert legs["committed"] + legs["pending"] == 3
    prof.stop()  # commits the rest through one explicit sync
    legs = prof.leg_stats()
    assert (legs["committed"], legs["timed"], legs["pending"]) == (3, 3, 0)
    assert legs["ms_total"] > 3 * 0.5  # the card's time, not the host's
    fams = prof.family_stats()
    assert sum(f["attributed_device_ms_total"] for f in fams.values()) == \
        pytest.approx(legs["ms_total"], rel=1e-9)
    assert fams["encoder_forward"]["attributed_dispatches"] == 3


@pytest.mark.cuda
def test_device_capture_on_card_writes_a_trace(tmp_path):
    dev = _card()
    prof = Profiler(sample_interval_ms=1e6, device=dev)
    prof.start_device_capture(str(tmp_path))
    a = torch.randn(1024, 1024, device=dev)
    (a @ a).sum()
    prof.stop_device_capture()
    [trace] = list(tmp_path.glob("trace-*.json"))
    assert trace.stat().st_size > 0
