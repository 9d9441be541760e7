"""The port's contiguous slab (``BruteForceKnnIndex(paged=False)``) on the
card against the same slab on the CPU, whose search and writes run the
kernels' plain versions: K2 (bf16) and K3 top-k (int8) once a search over
the one extent, their score twins past K_MAX, the float32 product; K4 the
slab's int8 writes, after growth and under a CUDA graph too. Held: the same
slots and free list, keys outside ties and distances within 1e-5, the int8
codes, scales and vsq bit for bit. This file imports no JAX, so its tests
run on the card: ``python -m pytest --noconftest -q -m cuda
tests/test_torch_slab_card.py``."""

import numpy as np
import pytest
import torch

from pathway_tpu_torch.internals.keys import Pointer
from pathway_tpu_torch.ops import knn as tknn

TOL = 1e-5


def _same_outside_ties(ref, got, tol: float = TOL) -> None:
    assert len(got) == len(ref)
    ref_d = {int(k): d for k, d in ref}
    for (rk, rd), (gk, gd) in zip(ref, got):
        assert abs(gd - rd) <= tol
        if int(gk) != int(rk):
            assert abs(ref_d.get(int(gk), ref[-1][1]) - rd) <= tol


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: K2, K3 and K4 are CUDA-only")


def _slabs(dtype: str, metric: str, rows: np.ndarray):
    """The same slab on the card and on the CPU, fed the same adds and
    removes: reserved for 1,000 rows, grown twice by 3,000."""
    out = {}
    for dev in ("cuda", "cpu"):
        idx = tknn.BruteForceKnnIndex(rows.shape[1], reserved_space=1000,
                                      dtype=dtype, metric=metric,
                                      paged=False, device=dev)
        assert type(idx) is tknn.BruteForceKnnIndex
        idx.add_batch([Pointer(i) for i in range(len(rows))], rows)
        for i in range(0, len(rows), 7):
            idx.remove(Pointer(i))
        out[dev] = idx
    assert out["cuda"]._free == out["cpu"]._free
    assert out["cuda"].capacity == out["cpu"].capacity == 4096
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["cos", "l2sq"])
@pytest.mark.parametrize("dtype", ["bfloat16", "int8", "float32"])
def test_slab_search_on_card_matches_cpu(dtype, metric):
    from pathway_tpu_torch.ops.knn_kernels import (SCORE_BF16, SCORE_I8,
                                                   TOPK_BF16, TOPK_I8)

    _need_card()
    rng = np.random.default_rng(30)
    rows = rng.normal(size=(3000, 384)).astype(np.float32)
    qs = rng.normal(size=(5, 384)).astype(np.float32)
    idx = _slabs(dtype, metric, rows)
    topk, score = {"bfloat16": (TOPK_BF16, SCORE_BF16),
                   "int8": (TOPK_I8, SCORE_I8)}.get(dtype, (None, None))
    tol = TOL * (1.0 if metric == "cos" else 1.0 + float(
        np.max(np.sum(qs * qs, 1))))
    for k in (10, 80):
        got = {}
        for dev, index in idx.items():
            for c in (topk, score):
                if c is not None:
                    c.launches = 0
            got[dev] = index.search([(Pointer(-1 - i), q, k, None)
                                     for i, q in enumerate(qs)])
            if dev == "cuda" and topk is not None:
                # one extent: one launch a search, K2 / K3 top-k up to
                # K_MAX and its score twin past it (one chunk)
                assert (topk.launches, score.launches) == (
                    (1, 0) if k <= tknn.K_MAX else (0, 1))
        for ref, res in zip(got["cpu"], got["cuda"]):
            _same_outside_ties(ref, res, tol)


@pytest.mark.cuda
def test_slab_int8_writes_through_k4_bit_for_bit():
    """K4 writes the int8 slab: at the first flush, at each growth's
    re-upload of every occupied slot, and inside a graphed ingest step
    (one capture a slab tensor set; after a growth replaced the tensors, a
    new capture, never a replay into the old ones)."""
    from pathway_tpu_torch.ops.knn_kernels import QUANTIZE_SCATTER

    _need_card()
    rng = np.random.default_rng(31)
    rows = rng.normal(size=(3000, 384)).astype(np.float32)
    chunk = rng.normal(size=(4, 256, 384)).astype(np.float32)
    ingests, state = {}, {}
    for dev in ("cuda", "cpu"):
        idx = tknn.BruteForceKnnIndex(384, reserved_space=2048,
                                      dtype="int8", metric="cos",
                                      paged=False, device=dev)
        ingests[dev] = idx.make_graphed_ingest(lambda model, x: x)
        QUANTIZE_SCATTER.launches = 0
        for c in range(2):
            assert ingests[dev]([Pointer(10**6 + c * 256 + i)
                                 for i in range(256)], None, chunk[c])
        idx.add_batch([Pointer(i) for i in range(len(rows))], rows)
        idx.flush_device()  # grown to 4096: every occupied slot re-ships
        for c in range(2, 4):
            assert ingests[dev]([Pointer(10**6 + c * 256 + i)
                                 for i in range(256)], None, chunk[c])
        if dev == "cuda":
            step = ingests[dev].step
            assert (step.captures, step.replays) == (2, 4)
            assert QUANTIZE_SCATTER.launches >= 5
        idx.drain()
        ext = idx._slab
        state[dev] = (idx, [t.cpu() for t in (ext.vectors, ext.scales,
                                              ext.vsq, ext.valid)])
    (gpu, g), (cpu, c) = state["cuda"], state["cpu"]
    assert gpu._key_to_slot == cpu._key_to_slot
    for a, b in zip(g, c):
        assert torch.equal(a, b)
    q = rows[17] + 0.01
    _same_outside_ties(cpu.search([(Pointer(-1), q, 10, None)])[0],
                       gpu.search([(Pointer(-1), q, 10, None)])[0])
