"""Port attention (pathway_tpu_torch/ops/attention.py) against the JAX
package: the plain PyTorch version vs the Pallas kernel in interpret mode
and vs the encoder's XLA attention, on the same numpy inputs. The CUDA
kernel itself runs only on the card (``cuda`` marker; chip_smoke.py holds
it against the plain version there)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathway_tpu.models.encoder import _dense_attention
from pathway_tpu.ops.attention import flash_attention as jax_flash
from pathway_tpu_torch.ops.attention import (ATTENTION, _check,
                                             attention_reference,
                                             flash_attention, make_attn_fn)

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
