"""Sequence-parallel attention: ring attention and Ulysses all-to-all —
port of pathway_tpu/parallel/ring_attention.py.

Inputs are (batch, seq, heads, head_dim) with the sequence split over a
mesh axis (``data`` by default). The port is single-controller, as its
mesh is: each function takes and returns whole tensors (the JAX global
array's view), while inside it shard ``i`` of the axis keeps its piece
of the sequence on ``mesh.devices_along(axis)[i]``. Every other mesh
axis replicates the work, as JAX's ``P(None, axis, None, None)`` does,
so it runs once, on that axis's first device.

- ``ring_attention``: each shard keeps its query block while the key and
  value blocks move one shard along the ring a step (JAX's
  ``lax.ppermute``: here a copy to the next shard's device), and the
  softmax is accumulated online (running max and denominator in
  float32), so the whole S x S score matrix never exists.
- ``ulysses_attention``: an all-to-all regroups the pieces from
  sequence-split to head-split, each shard runs exact attention over the
  whole sequence for its heads, and a second all-to-all regroups back.
  Needs heads % axis size == 0.

Both are torch ops, as the JAX functions are ``jnp.einsum``s outside any
Pallas kernel: no hand-written kernel runs here.
"""

from __future__ import annotations

import torch

from pathway_tpu_torch.parallel.mesh import DATA_AXIS, get_mesh


def _online_block(q, k_blk, v_blk, m, l, o, mask=None):
    """One flash-style accumulation step. q (B,Sq,H,D); k/v (B,Sk,H,D);
    m,l (B,H,Sq) float32; o (B,Sq,H,D) float32."""
    scale = q.shape[-1] ** -0.5
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k_blk) * scale
    if mask is not None:
        scores = torch.where(mask, scores, -torch.inf)
    m_new = torch.maximum(m, scores.amax(dim=-1))
    # guard fully-masked rows (m_new == -inf) against NaNs
    m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
    p = torch.exp(scores - m_safe[..., None])
    if mask is not None:
        p = torch.where(mask, p, 0.0)
    corr = torch.exp(torch.where(torch.isfinite(m), m - m_safe, -torch.inf))
    corr = torch.where(torch.isfinite(corr), corr, 0.0)
    l_new = l * corr + p.sum(dim=-1)
    o_new = o * corr.transpose(1, 2)[..., None] + \
        torch.einsum("bhqk,bkhd->bqhd", p.to(v_blk.dtype), v_blk)
    return m_new, l_new, o_new


def ring_attention(q, k, v, *, mesh=None, axis: str = DATA_AXIS,
                   causal: bool = False):
    """Exact attention with the sequence split over ``axis``.

    q, k, v: (batch, seq, heads, head_dim). Returns the attention output,
    whole, on q's device."""
    if mesh is None:
        mesh = get_mesh()
    n = int(mesh.shape[axis])
    if q.shape[1] % n != 0:
        raise ValueError(
            f"ring attention: sequence length {q.shape[1]} is not "
            f"divisible by the {axis!r} axis size {n} (PWT102) — pad the "
            f"sequence or shrink the axis")
    devs = mesh.devices_along(axis)
    qs, kb, vb = ([p.to(dev) for p, dev in zip(x.chunk(n, dim=1), devs)]
                  for x in (q, k, v))
    B, Sq, H, _ = qs[0].shape
    state = [(torch.full((B, H, Sq), -torch.inf, device=dev),
              torch.zeros((B, H, Sq), device=dev),
              torch.zeros(qs[0].shape, device=dev)) for dev in devs]
    for t in range(n):
        for i in range(n):
            mask = None
            if causal:
                src = (i - t) % n
                q_pos = i * Sq + torch.arange(Sq, device=devs[i])
                k_pos = src * Sq + torch.arange(Sq, device=devs[i])
                mask = q_pos[None, None, :, None] >= k_pos[None, None, None, :]
            state[i] = _online_block(qs[i], kb[i], vb[i], *state[i], mask)
        # the ring step: shard i's blocks move to shard i + 1
        kb = [kb[(i - 1) % n].to(devs[i]) for i in range(n)]
        vb = [vb[(i - 1) % n].to(devs[i]) for i in range(n)]
    outs = []
    for qi, (_, l, o) in zip(qs, state):
        denom = l.transpose(1, 2)[..., None]
        outs.append((o / torch.clamp_min(denom, 1e-30)).to(qi.dtype)
                    .to(q.device))
    return torch.cat(outs, dim=1)


def _attention(q, k, v, causal: bool):
    """Exact attention over whole sequences: scores in the inputs' dtype,
    softmax in float32, probabilities cast back to v's dtype."""
    scale = q.shape[-1] ** -0.5
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if causal:
        S = q.shape[1]
        mask = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
        scores = torch.where(mask[None, None], scores, -torch.inf)
    probs = torch.softmax(scores.float(), dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)


def ulysses_attention(q, k, v, *, mesh=None, axis: str = DATA_AXIS,
                      causal: bool = False):
    """All-to-all sequence parallelism (DeepSpeed-Ulysses style).

    Regroups (B, S/n, H, D) pieces into (B, S, H/n, D) ones with one
    all-to-all, runs exact attention per head group over the whole
    sequence, and regroups back. Requires heads % axis size == 0. Returns
    the output, whole, on q's device."""
    if mesh is None:
        mesh = get_mesh()
    n = int(mesh.shape[axis])
    if q.shape[2] % n != 0:
        raise ValueError(
            f"ulysses attention: {q.shape[2]} heads not divisible by the "
            f"{axis!r} axis size {n} (PWT106) — pad heads to a multiple "
            f"of {n} or use ring attention")
    if q.shape[1] % n != 0:
        raise ValueError(
            f"ulysses attention: sequence length {q.shape[1]} is not "
            f"divisible by the {axis!r} axis size {n} (PWT102)")
    devs = mesh.devices_along(axis)

    def seq_to_head(x):
        # shard i holds sequence piece i; shard j gathers head group j of
        # every piece, in sequence order
        pieces = [p.to(dev) for p, dev in zip(x.chunk(n, dim=1), devs)]
        return [torch.cat([p.chunk(n, dim=2)[j].to(devs[j])
                           for p in pieces], dim=1) for j in range(n)]

    outs = [_attention(qh, kh, vh, causal) for qh, kh, vh in
            zip(seq_to_head(q), seq_to_head(k), seq_to_head(v))]
    # head_to_seq: shard i gathers sequence piece i of every head group
    back = [torch.cat([o.chunk(n, dim=1)[i].to(devs[i]) for o in outs],
                      dim=2) for i in range(n)]
    return torch.cat([b.to(q.device) for b in back], dim=1)


def reference_attention(q, k, v, *, causal: bool = False):
    """Unsharded exact attention for testing parity."""
    return _attention(q, k, v, causal)
