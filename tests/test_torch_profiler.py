"""The port's machine parameters (pathway_tpu_torch/engine/profiler.py
``machine_params`` and ``machine_balance``) against the JAX package's.

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
