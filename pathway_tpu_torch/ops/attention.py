"""Encoder attention — port of pathway_tpu/ops/attention.py.

``flash_attention`` is the wrapper of the hand-written Hopper kernel
(ops/csrc/attention.cu) that replaces the JAX package's Pallas kernel
``_attn_kernel``; ``attention_reference`` is its plain PyTorch version.
With segment ids (the ragged encoder path) the same kernel computes the
JAX encoder's ``_segment_attention``; ``segment_attention_reference`` is
then the plain version. On a CUDA tensor the wrapper launches the kernel
(or raises); on a CPU tensor it returns the plain version. The encoder
(models/encoder.py) calls it on every layer.
"""

from __future__ import annotations

import ctypes

import torch

from pathway_tpu_torch.ops.cuda_build import CudaLibrary

# the Pallas kernel's fill for masked keys: finite, so a row whose keys
# are all masked softmaxes to uniform (mean of V) instead of NaN
_NEG_FILL = torch.finfo(torch.float32).min
_MAX_SEQ = 1024  # the kernel keeps a query tile's score rows on chip
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
ATTENTION = CudaLibrary("attention", {
    # (q, k, v, mask, seg, out, dtype, B, S, H, D, 9 strides, stream)
    "pt_attention_forward": (_I, [_P] * 6 + [_I] * 5 + [_L] * 9 + [_P]),
    "pt_cuda_error_string": (ctypes.c_char_p, [_I]),
})


def attention_reference(q, k, v, mask):
    """Plain PyTorch attention: q, k, v (B, S, H, D); mask (B, S) key
    validity. Scores, softmax and accumulation in float32, probabilities
    rounded to v's dtype before P·V (as the Pallas kernel does); returns
    (B, S, H, D) in q's dtype."""
    return _reference(q, k, v, mask.bool()[:, None, None, :])


def segment_attention_reference(q, k, v, seg):
    """Plain PyTorch segment attention: as ``attention_reference``, with
    key j valid for query i iff ``seg[b, j] >= 0 and seg[b, j] == seg[b,
    i]`` (seg: (B, S) integer segment ids, -1 = padding). A padding query
    row has no valid key and averages V over all S rows."""
    same = (seg[:, :, None] == seg[:, None, :]) & (seg >= 0)[:, None, :]
    return _reference(q, k, v, same[:, None, :, :])


def _reference(q, k, v, valid):
    """``valid`` broadcasts against the (B, H, S, S) scores."""
    scale = q.shape[-1] ** -0.5
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    scores = scores.masked_fill(~valid, _NEG_FILL)
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - m)
    probs = (p / p.sum(dim=-1, keepdim=True)).to(v.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.float(), v.float())
    return out.to(q.dtype)


def _check(q, k, v, mask, seg=None) -> None:
    if q.dim() != 4:
        raise ValueError(f"q must be (B, S, H, D); got shape {tuple(q.shape)}")
    B, S, H, D = q.shape
    for name, t in (("k", k), ("v", v)):
        if t.shape != q.shape:
            raise ValueError(f"{name} shape {tuple(t.shape)} != q shape "
                             f"{tuple(q.shape)}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("q, k, v must share one dtype, float32 or bfloat16; "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if mask.shape != (B, S) or mask.dtype != torch.bool \
            or not mask.is_contiguous():
        raise ValueError(f"mask must be a contiguous ({B}, {S}) bool tensor; "
                         f"got {mask.dtype} {tuple(mask.shape)}")
    if seg is not None and (seg.shape != (B, S) or seg.dtype != torch.int32
                            or not seg.is_contiguous()):
        raise ValueError(f"seg must be a contiguous ({B}, {S}) int32 tensor;"
                         f" got {seg.dtype} {tuple(seg.shape)}")
    if D % 8 or not 8 <= D <= 128:
        raise ValueError(f"head dim {D} unsupported: the kernel takes a "
                         "multiple of 8 up to 128")
    if not 1 <= S <= _MAX_SEQ or B > 65535 or H > 65535:
        raise ValueError(f"shape {(B, S, H, D)} unsupported: S <= {_MAX_SEQ}"
                         ", B and H <= 65535")
    dev = q.device
    named = [("q", q), ("k", k), ("v", v), ("mask", mask)]
    if seg is not None:
        named.append(("seg", seg))
    for name, t in named:
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q on {dev}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        # 16-byte vector loads of 8 elements: rows must start aligned
        if t.stride(3) != 1 or t.data_ptr() % 16 or any(
                (s * t.element_size()) % 16 for s in t.stride()[:3]):
            raise ValueError(
                f"{name} needs a contiguous last dim, a 16-byte aligned "
                f"start and 16-byte multiple strides; got strides "
                f"{t.stride()}")


def flash_attention(q, k, v, mask, seg=None):
    """Fused attention: q, k, v (B, S, H, D); mask (B, S) bool key
    validity. Returns (B, S, H, D) in q's dtype. Drop-in for the encoder's
    ``attn_fn`` hook (models/encoder.py encode).

    ``seg``: optional (B, S) int32 segment ids; key j is then valid for
    query i iff ``seg[b, j] >= 0 and seg[b, j] == seg[b, i]``, and
    ``mask`` is not read (encode_ragged passes ``seg >= 0``).

    CUDA tensors launch the Hopper kernel on the current stream (counted
    in ``ATTENTION.launches``); CPU tensors take ``attention_reference``
    (``segment_attention_reference`` with ``seg``).

    The kernel has no backward (neither has the JAX package's Pallas
    kernel), so under autograd, with q, k or v requiring grad, it raises
    on either device rather than return an output that passes no
    gradient back: training runs models.encoder.dense_attention."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise RuntimeError(
            "flash_attention has no backward: q, k or v requires grad "
            "under autograd; pass attn_fn=models.encoder.dense_attention "
            "to train, or run under torch.no_grad()")
    if q.device.type == "cpu":
        if seg is not None:
            return segment_attention_reference(q, k, v, seg)
        return attention_reference(q, k, v, mask)
    if q.device.type != "cuda":
        raise RuntimeError(f"flash_attention: unsupported device {q.device}")
    _check(q, k, v, mask, seg)
    B, S, H, D = q.shape
    out = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    lib = ATTENTION.load()
    strides = [s for t in (q, k, v) for s in t.stride()[:3]]
    # the CUDA runtime launches on its current device: make it q's
    with torch.cuda.device(q.device):
        err = lib.pt_attention_forward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
            None if seg is None else seg.data_ptr(), out.data_ptr(), _DTYPES[q.dtype], B, S, H, D, *strides,
            torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        msg = lib.pt_cuda_error_string(err).decode()
        raise RuntimeError(f"attention kernel launch failed: {msg} ({err})")
    ATTENTION.launches += 1
    return out


def make_attn_fn():
    """``attn_fn`` for models/encoder.encode backed by the kernel (the
    encoder's default; kept for call sites written against the JAX
    package's ``make_attn_fn``)."""
    return flash_attention
