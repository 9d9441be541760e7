"""Pipeline parallelism: GPipe-style micro-batched stages over a mesh
axis — port of pathway_tpu/parallel/pipeline.py.

The transformer's L homogeneous blocks are stacked on a leading layer
axis (``stack_stage_params``) and split over the ``pipe`` mesh axis, so
stage s holds layers [s L/S, (s+1) L/S) on its device. Micro-batches
flow through the GPipe schedule: M + S - 1 steps; at step t stage 0
takes micro-batch t while t < M, every stage holding a micro-batch
applies its blocks, the activations move to the next stage's device
(JAX's ``lax.ppermute``), and the last stage hands out output t - (S -
1). The bubble, (S - 1) / (M + S - 1) of the stage-steps, carries no
micro-batch: the JAX package computes on zeros there and discards the
result, the port skips it. The result is the caller's (the JAX
package's replicated output): on the micro-batches' device.

The port is single-controller: the stages run one after another from one
process, on their own devices (on one card, one after another there).
Each micro-batch goes through exactly the arithmetic of the sequential
blocks, so the pipeline equals ``sequential_encoder_blocks`` bit for
bit.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from pathway_tpu_torch.models.convert import tree_map
from pathway_tpu_torch.parallel.mesh import Placement

PIPE_AXIS = "pipe"


def _tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.tensor(np.asarray(x))


def _leaves(tree) -> list:
    out = []
    tree_map(out.append, tree)
    return out


def stack_stage_params(layer_params: list) -> dict:
    """[per-layer tree] -> one tree with a leading layer axis, ready to
    split over the pipe axis (numpy leaves become tensors)."""
    return tree_map(lambda *leaves: torch.stack([_tensor(x) for x in leaves]),
                    *layer_params)


def make_pipeline_fn(mesh, block_fn: Callable, *, axis: str = PIPE_AXIS):
    """Build ``run(stacked_params, microbatches, *extra) -> outputs``.

    - ``stacked_params``: tree with a leading layer axis (length L,
      divisible by the pipe-axis size), split over ``axis``.
    - ``microbatches``: (M, mb, ...) activations.
    - ``block_fn(layer_params, x, extra) -> x``: one transformer block.
    - ``extra``: ONE side input shared by every micro-batch (e.g. an
      attention mask), copied to every stage; per-micro-batch side inputs
      belong inside ``microbatches`` itself.

    Output (M, mb, ...) on the micro-batches' device. Parity with
    sequential layer application is exact.
    """
    n_stages = int(mesh.shape[axis])
    devs = mesh.devices_along(axis)
    split = Placement(mesh, (axis,))  # the layer stack over the stages

    def run(stacked_params, microbatches, *extra):
        if len(extra) > 1:
            raise TypeError(
                "make_pipeline_fn supports ONE replicated side input; pack "
                f"extras into a single pytree (got {len(extra)})")
        leaves = _leaves(stacked_params)
        if leaves and leaves[0].shape[0] % n_stages != 0:
            raise ValueError(
                f"pipeline: {leaves[0].shape[0]} stacked layers are not "
                f"divisible by the {n_stages}-stage pipe axis (PWT102) — "
                f"pad the layer stack or change the stage count")
        per = leaves[0].shape[0] // n_stages if leaves else 0
        packed = extra[0] if extra else torch.zeros(())
        stages = []
        for s, dev in enumerate(devs):
            local = tree_map(lambda t: split.piece(t, {axis: s}).to(dev),
                             stacked_params)
            stages.append(([tree_map(lambda t: t[j], local)
                            for j in range(per)],
                           tree_map(lambda t: t.to(dev), packed)))

        def stage_apply(s, x):
            layers, side = stages[s]
            for layer in layers:
                x = block_fn(layer, x, side)
            return x

        m = microbatches.shape[0]
        outputs = [None] * m
        held = [None] * n_stages  # the activation each stage holds
        for t in range(m + n_stages - 1):
            if t < m:
                held[0] = microbatches[t].to(devs[0])
            out = [None if x is None else stage_apply(s, x)
                   for s, x in enumerate(held)]
            if t >= n_stages - 1:
                outputs[t - (n_stages - 1)] = out[-1].to(microbatches.device)
            held = [None] + [None if x is None else x.to(devs[s + 1])
                             for s, x in enumerate(out[:-1])]
        return torch.stack(outputs)

    return run


def _encoder_block(layer: dict, x, mask, config):
    from pathway_tpu_torch.models.encoder import (_attention_block,
                                                  _mlp_block, block_view,
                                                  dense_attention)

    x = _attention_block(x, block_view(layer["attn"]), mask, config,
                         dense_attention)
    return _mlp_block(x, block_view(layer["mlp"]), config)


def sequential_encoder_blocks(layers, x, mask, config):
    """Reference computation the pipeline must match: the encoder's blocks
    (``attn`` with ``dense_attention``, then the dense ``mlp``) applied in
    order, from the JAX-layout layer trees (numpy or tensors)."""
    x = x.to(config.compute_dtype)
    for layer in layers:
        layer = tree_map(lambda a: _tensor(a).to(x.device), layer)
        x = _encoder_block(layer, x, mask, config)
    return x


def pipeline_encoder_blocks(mesh, config, *, axis: str = PIPE_AXIS):
    """Pipeline runner for the encoder's transformer blocks
    (models/encoder.py): ``run(stacked_layer_params, x_microbatches,
    mask)`` where x is the post-embedding hidden state. Embeddings and
    pooling stay outside the pipeline."""
    def block_fn(layer, x, mask):
        return _encoder_block(layer, x, mask, config)

    run = make_pipeline_fn(mesh, block_fn, axis=axis)

    def wrapped(stacked_params, microbatches, mask):
        # blocks compute (and emit) compute_dtype, so activations enter
        # the pipeline already cast
        return run(stacked_params, microbatches.to(config.compute_dtype),
                   mask)

    return wrapped
