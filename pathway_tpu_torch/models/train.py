"""Contrastive training step for the encoder — port of
pathway_tpu/models/train.py.

A bi-encoder InfoNCE step (in-batch negatives, both directions) with
AdamW, so a live RAG index's embedder can be fine-tuned on its corpus.
The model holds float32 master weights (``Encoder.from_params(...,
trainable=True)``) and its blocks cast them to the compute dtype where
they use them, so the gradients and AdamW's moments are float32, as the
JAX tree's are. The forward is the JAX step's: ``encode`` with its
default ``_dense_attention`` (here ``dense_attention``); K1 has no
backward in either package.

The sharded step (``train_state_pspecs``, ``make_sharded_train_step``:
data, tensor and expert parallelism over a mesh) is not ported: it is
the training half of ``parallel/`` (ROADMAP queue 1, item 5: step 5b).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

from pathway_tpu_torch.models.convert import params_from_jax
from pathway_tpu_torch.models.encoder import (Encoder, EncoderConfig,
                                              dense_attention,
                                              init_params_host)

_BATCH_KEYS = ("q_ids", "q_mask", "d_ids", "d_mask")


def make_optimizer(learning_rate: float = 2e-5, weight_decay: float = 0.01
                   ) -> Callable[..., torch.optim.Optimizer]:
    """The optimizer as a factory over parameters: ``optax.adamw(lr,
    weight_decay=wd)``'s update (b1 0.9, b2 0.999, eps 1e-8, the decay
    applied to every parameter) is ``torch.optim.AdamW``'s."""
    return functools.partial(torch.optim.AdamW, lr=learning_rate,
                             betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=weight_decay)


@dataclasses.dataclass
class TrainState:
    """The JAX state's ``params``, ``opt_state`` and ``step``: a trainable
    encoder, its optimizer, and the steps taken."""
    model: Encoder
    optimizer: torch.optim.Optimizer
    step: int = 0


def init_train_state(seed: int, config: EncoderConfig, optimizer=None, *,
                     params: dict | None = None,
                     device: str | torch.device = "cuda") -> TrainState:
    """A fresh state on ``device``: a trainable encoder (float32 master
    weights) and ``optimizer`` (a ``make_optimizer`` factory; its default
    without one) over its parameters.

    The weights are ``params`` (a JAX-layout numpy tree) or else
    ``init_params_host(seed, config)``. The JAX package's
    ``init_train_state(key)`` draws them with ``jax.random``, which the
    port cannot reproduce: to start both packages from the same weights,
    pass the JAX parameters fetched to the host as ``params``."""
    if params is None:
        params = init_params_host(seed, config)
    model = Encoder.from_params(params, config, device=device,
                                trainable=True)
    return TrainState(model, (optimizer or make_optimizer())(
        model.parameters()))


def train_state_from_jax(state: dict, config: EncoderConfig, optimizer=None,
                         *, device: str | torch.device = "cuda"
                         ) -> TrainState:
    """The port's state from a JAX train state fetched to the host
    (``jax.device_get``): its parameters, its step, and the moments and
    count of optax's Adam state (the ``ScaleByAdamState`` in
    ``opt_state``, found by its ``count``, ``mu`` and ``nu`` fields) as
    the optimizer's ``exp_avg``, ``exp_avg_sq`` and ``step``."""
    out = init_train_state(0, config, optimizer, params=state["params"],
                           device=device)
    adam = _adam_state(state["opt_state"])
    mu, nu = params_from_jax(adam.mu), params_from_jax(adam.nu)
    count = float(np.asarray(adam.count))
    for name, p in out.model.named_parameters():
        out.optimizer.state[p] = {
            "step": torch.tensor(count),
            "exp_avg": mu[name].to(p.device),
            "exp_avg_sq": nu[name].to(p.device),
        }
    out.step = int(np.asarray(state["step"]))
    return out


def _adam_state(node):
    """The first node of an optax state tree with Adam's fields."""
    if all(hasattr(node, f) for f in ("count", "mu", "nu")):
        return node
    if isinstance(node, (tuple, list)):
        for child in node:
            found = _adam_state(child)
            if found is not None:
                return found
    return None


def train_state_pspecs(*args, **kwargs):
    raise NotImplementedError(
        "train_state_pspecs: sharded training, the training half of "
        "parallel/, is not ported yet (ROADMAP queue 1, item 5: step 5b)")


def make_sharded_train_step(*args, **kwargs):
    raise NotImplementedError(
        "make_sharded_train_step: sharded training, the training half of "
        "parallel/, is not ported yet (ROADMAP queue 1, item 5: step 5b)")


def info_nce_loss(q_emb, d_emb, temperature: float = 0.05):
    """Symmetric in-batch-negative InfoNCE; embeddings already
    normalised."""
    logits = (q_emb @ d_emb.T) / temperature
    labels = torch.arange(logits.shape[0], device=logits.device)
    l_qd = F.cross_entropy(logits, labels, reduction="none")
    l_dq = F.cross_entropy(logits.T, labels, reduction="none")
    return (l_qd + l_dq).mean() * 0.5


def as_batch(batch: dict, device: torch.device) -> dict:
    """``{q_ids, q_mask, d_ids, d_mask}`` (numpy arrays or tensors) as
    long ids and bool masks on ``device``."""
    out = {}
    for key in _BATCH_KEYS:
        t = torch.as_tensor(batch[key]).to(device, non_blocking=True)
        out[key] = t.bool() if key.endswith("mask") else t.long()
    return out


def contrastive_train_step(state: TrainState, batch: dict, *,
                           temperature: float = 0.05, attn_fn=None
                           ) -> tuple[TrainState, torch.Tensor]:
    """One optimizer step, in place. batch = {q_ids, q_mask, d_ids,
    d_mask} (B, S). Returns the state (``step`` counted) and the loss as
    a device scalar (reading it waits for the step)."""
    model = state.model
    attn_fn = attn_fn or dense_attention
    b = as_batch(batch, next(model.parameters()).device)
    q = model(b["q_ids"], b["q_mask"], attn_fn=attn_fn)
    d = model(b["d_ids"], b["d_mask"], attn_fn=attn_fn)
    loss = info_nce_loss(q, d, temperature)
    state.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    state.optimizer.step()
    state.step += 1
    return state, loss.detach()
