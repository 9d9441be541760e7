"""Port attention (pathway_tpu_torch/ops/attention.py) against the JAX
package: the plain PyTorch version vs the Pallas kernel in interpret mode
and vs the encoder's XLA attention, on the same numpy inputs. The CUDA
kernel itself runs only on the card (``cuda`` marker; chip_smoke.py holds
it against the plain version there)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathway_tpu.models.encoder import _dense_attention, _segment_attention
from pathway_tpu.ops.attention import flash_attention as jax_flash
from pathway_tpu_torch.ops.attention import (ATTENTION, _check,
                                             attention_reference,
                                             flash_attention, make_attn_fn,
                                             segment_attention_reference)

# f32 on both sides; the only differences are summation order and exp
# rounding, far below 1e-5 at these magnitudes
TOL_F32 = 1e-5

CASES = [
    # (B, S, H, D, mask kind) — the shapes of tests/test_attention_kernel.py
    (2, 128, 6, 64, "random"),
    (1, 64, 2, 32, "all_valid"),
    (2, 32, 2, 16, "row_fully_masked"),
    # the edges of the card kernel's tiling: S not a multiple of 16 with a
    # fully masked row (tile padding must not dilute it), D not a multiple
    # of 16 (zero-padded head dim)
    (2, 40, 2, 24, "row_fully_masked"),
    (2, 48, 2, 40, "random"),
]


def _inputs(B, S, H, D, kind, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(B, S, H, D)).astype(np.float32)
               for _ in range(3))
    if kind == "random":
        mask = rng.random((B, S)) > 0.3
    elif kind == "all_valid":
        mask = np.ones((B, S), bool)
    else:
        mask = rng.random((B, S)) > 0.3
        mask[0] = False  # batch row 0: every key masked
    return q, k, v, mask


@pytest.mark.parametrize("B,S,H,D,kind", CASES)
def test_reference_matches_pallas_interpret_and_xla(B, S, H, D, kind):
    q, k, v, mask = _inputs(B, S, H, D, kind)
    got = attention_reference(*(torch.from_numpy(a) for a in (q, k, v, mask)))
    pallas = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), jnp.asarray(mask),
                                  interpret=True))
    np.testing.assert_allclose(got.numpy(), pallas, rtol=0, atol=TOL_F32)
    xla = np.asarray(_dense_attention(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), jnp.asarray(mask)))
    np.testing.assert_allclose(got.numpy(), xla, rtol=0, atol=TOL_F32)
    if kind == "row_fully_masked":
        # every key masked: uniform softmax, i.e. the mean of V — never NaN
        mean_v = np.broadcast_to(v[0].mean(axis=0, keepdims=True), v[0].shape)
        np.testing.assert_allclose(got[0].numpy(), mean_v, rtol=0,
                                   atol=TOL_F32)


def test_bf16_reference_rounds_probabilities_like_pallas():
    """bf16 inputs: the Pallas kernel rounds P to v's dtype before P·V;
    so does the plain version (compared in interpret mode, bf16 output
    tolerance: one bf16 step of values ~1)."""
    q, k, v, mask = _inputs(2, 64, 2, 32, "random", seed=1)
    tq = [torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)]
    got = attention_reference(*tq, torch.from_numpy(mask)).float().numpy()
    jq = [jnp.asarray(a, dtype=jnp.bfloat16) for a in (q, k, v)]
    ref = np.asarray(jax_flash(*jq, jnp.asarray(mask), interpret=True)
                     .astype(jnp.float32))
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-2)


def test_wrapper_on_cpu_is_the_plain_version_and_counts_nothing():
    q, k, v, mask = (torch.from_numpy(a)
                     for a in _inputs(2, 32, 2, 16, "random"))
    before = ATTENTION.launches
    out = flash_attention(q, k, v, mask)
    assert torch.equal(out, attention_reference(q, k, v, mask))
    assert make_attn_fn() is flash_attention
    assert ATTENTION.launches == before


def _qkv(shape, dtype=torch.bfloat16):
    return [torch.zeros(shape, dtype=dtype) for _ in range(3)]


@pytest.mark.parametrize("shape,dtype", [
    ((2, 96, 6, 64), torch.bfloat16),   # encoder main path
    ((2, 96, 6, 64), torch.float32),
    ((1, 1, 1, 8), torch.bfloat16),     # smallest S and D
    ((1, 1024, 1, 128), torch.bfloat16),  # largest S and D
    ((3, 40, 2, 24), torch.bfloat16),   # D not a multiple of 16
])
def test_check_accepts_the_kernels_shapes(shape, dtype):
    q, k, v = _qkv(shape, dtype)
    _check(q, k, v, torch.ones(shape[:2], dtype=torch.bool))


def test_check_accepts_strided_head_views_of_a_packed_projection():
    """The encoder hands K1 (B, S, H, D) views; rows of a packed (B, S, 3,
    H, D) projection have 16-byte multiple strides and pass."""
    qkv = torch.zeros((2, 32, 3, 4, 16), dtype=torch.bfloat16)
    q, k, v = (qkv[:, :, i] for i in range(3))
    _check(q, k, v, torch.ones((2, 32), dtype=torch.bool))


def _bad_inputs():
    ok = (2, 32, 2, 16)
    mask = torch.ones(ok[:2], dtype=torch.bool)
    q, k, v = _qkv(ok)
    buf = torch.zeros(2 * 32 * 2 * 16 + 8, dtype=torch.bfloat16)
    unaligned = buf[1:1 + q.numel()].view(ok)  # start 2 bytes off 16
    wide = torch.zeros((2, 32, 2, 20), dtype=torch.bfloat16)[..., :16]
    return [
        (TypeError, (q.half(), k.half(), v.half(), mask)),
        (TypeError, (q, k.float(), v, mask)),
        (ValueError, (q[0], k[0], v[0], mask)),                 # 3-d
        (ValueError, (q, k[:, :16], v, mask)),                  # shapes
        (ValueError, (q, k, v, mask.int())),                    # mask dtype
        (ValueError, (q, k, v, mask[:, :16])),                  # mask shape
        (ValueError, (q, k, v,
                      torch.ones((32, 2), dtype=torch.bool).t())),  # strided
        (ValueError, (*_qkv((2, 32, 2, 12)),
                      mask)),                                   # D % 8
        (ValueError, (*_qkv((1, 8, 1, 136)),
                      torch.ones((1, 8), dtype=torch.bool))),   # D > 128
        (ValueError, (*_qkv((1, 1025, 1, 8)),
                      torch.ones((1, 1025), dtype=torch.bool))),  # S > 1024
        (ValueError, (q.transpose(2, 3).contiguous().transpose(2, 3), k, v,
                      mask)),                                   # last dim
        (ValueError, (unaligned, k, v, mask)),                  # start
        (ValueError, (wide, k, v, mask)),                       # row stride
    ]


@pytest.mark.parametrize("case", range(len(_bad_inputs())))
def test_check_rejects_what_the_kernel_does_not_take(case):
    exc, args = _bad_inputs()[case]
    with pytest.raises(exc):
        _check(*args)


# chip_smoke.py phase 3's edge shapes: (B, S, H, D, mask kind, dtype, tol)
CARD_CASES = [
    (4, 96, 6, 64, "row_fully_masked", torch.bfloat16, 2e-2),
    (4, 96, 6, 64, "row_fully_masked", torch.float32, 1e-4),
    (1, 16, 6, 64, "random", torch.bfloat16, 2e-2),
    (1, 96, 6, 64, "random", torch.bfloat16, 2e-2),
    (8, 100, 6, 64, "row_fully_masked", torch.bfloat16, 2e-2),
    (8, 1000, 6, 64, "row_fully_masked", torch.bfloat16, 2e-2),
    (4, 1024, 6, 64, "random", torch.bfloat16, 2e-2),
    (16, 96, 6, 40, "random", torch.bfloat16, 2e-2),
    (16, 96, 6, 128, "random", torch.bfloat16, 2e-2),
    (2, 1000, 6, 64, "row_fully_masked", torch.float32, 1e-4),
]


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,D,kind,dtype,tol", CARD_CASES)
def test_kernel_matches_reference_on_card(B, S, H, D, kind, dtype, tol):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the attention kernel is CUDA-only")
    q, k, v, mask = (torch.from_numpy(a).cuda()
                     for a in _inputs(B, S, H, D, kind))
    q, k, v = (t.to(dtype) for t in (q, k, v))
    got = flash_attention(q, k, v, mask).float()
    torch.cuda.synchronize()
    ref = attention_reference(q, k, v, mask).float()
    assert bool(torch.isfinite(got).all())
    assert float((got - ref).abs().max()) <= tol
    if kind == "row_fully_masked":
        mean_v = v[0].float().mean(dim=0, keepdim=True)
        assert float((got[0] - mean_v).abs().max()) <= tol


# ---------------------------------------------------------------------------
# segment ids (the ragged encoder path)
# ---------------------------------------------------------------------------

def _segments(B, S, kind, seed=0):
    """(B, S) int32 segment ids as pack_ragged lays them out: documents of
    random lengths back to back, then -1 padding. ``padding_row``: batch
    row 0 is all padding; ``single``: one document per row."""
    rng = np.random.default_rng(seed)
    seg = np.full((B, S), -1, np.int32)
    for b in range(B):
        pos, doc = 0, 0
        while pos < S:
            n = S if kind == "single" else int(rng.integers(3, max(4, S // 3)))
            if pos + n > S - (0 if kind == "single" else S // 8):
                break
            seg[b, pos:pos + n] = doc
            pos, doc = pos + n, doc + 1
    if kind == "padding_row":
        seg[0] = -1
    return seg


SEG_CASES = [  # (B, S, H, D, kind)
    (2, 64, 2, 16, "packed"),
    (3, 40, 2, 24, "padding_row"),
    (1, 32, 3, 32, "single"),
    (2, 100, 2, 16, "padding_row"),
]


@pytest.mark.parametrize("B,S,H,D,kind", SEG_CASES)
def test_segment_reference_matches_jax_segment_attention(B, S, H, D, kind):
    """f32 on both sides: summation order only. A padding row (no valid
    key) averages V over all S rows in both."""
    q, k, v, _ = _inputs(B, S, H, D, "all_valid", seed=3)
    seg = _segments(B, S, kind)
    got = segment_attention_reference(
        *(torch.from_numpy(a) for a in (q, k, v, seg)))
    ref = np.asarray(_segment_attention(*(jnp.asarray(a)
                                          for a in (q, k, v, seg))))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=TOL_F32)
    for b, i in zip(*np.nonzero(seg < 0)):
        mean_v = v[b].mean(axis=0)
        np.testing.assert_allclose(got[b, i].numpy(), mean_v, rtol=0,
                                   atol=TOL_F32)
    # the wrapper on a CPU tensor is the plain version, mask unread
    out = flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                          torch.zeros((B, S), dtype=torch.bool),
                          torch.from_numpy(seg))
    assert torch.equal(out, got)


def test_segments_of_one_document_equal_the_plain_mask():
    """A row holding one document then padding is ordinary masked
    attention for the document's queries."""
    q, k, v, _ = _inputs(2, 48, 2, 16, "all_valid", seed=4)
    seg = np.full((2, 48), -1, np.int32)
    seg[:, :30] = 0
    t = [torch.from_numpy(a) for a in (q, k, v)]
    a = segment_attention_reference(*t, torch.from_numpy(seg))
    b = attention_reference(*t, torch.from_numpy(seg >= 0))
    torch.testing.assert_close(a[:, :30], b[:, :30], rtol=0, atol=0)


def test_check_rejects_bad_segment_ids():
    q, k, v = _qkv((2, 32, 2, 16))
    mask = torch.ones((2, 32), dtype=torch.bool)
    _check(q, k, v, mask, torch.zeros((2, 32), dtype=torch.int32))
    for seg in (torch.zeros((2, 32), dtype=torch.int64),
                torch.zeros((2, 16), dtype=torch.int32),
                torch.zeros((32, 2), dtype=torch.int32).t()):
        with pytest.raises(ValueError):
            _check(q, k, v, mask, seg)


# chip_smoke.py's segment shapes: (B, S, H, D, kind, dtype, tol)
CARD_SEG_CASES = [
    (8, 512, 6, 64, "packed", torch.bfloat16, 2e-2),
    (8, 512, 6, 64, "padding_row", torch.float32, 1e-4),
    (2, 96, 6, 64, "padding_row", torch.bfloat16, 2e-2),
    (2, 1000, 6, 64, "single", torch.bfloat16, 2e-2),
    (4, 100, 6, 40, "packed", torch.bfloat16, 2e-2),
]


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,D,kind,dtype,tol", CARD_SEG_CASES)
def test_kernel_with_segments_matches_reference_on_card(B, S, H, D, kind,
                                                        dtype, tol):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the attention kernel is CUDA-only")
    q, k, v, _ = (torch.from_numpy(a).cuda()
                  for a in _inputs(B, S, H, D, "all_valid"))
    q, k, v = (t.to(dtype) for t in (q, k, v))
    seg = torch.from_numpy(_segments(B, S, kind)).cuda()
    got = flash_attention(q, k, v, seg >= 0, seg).float()
    torch.cuda.synchronize()
    ref = segment_attention_reference(q, k, v, seg).float()
    assert bool(torch.isfinite(got).all())
    assert float((got - ref).abs().max()) <= tol
