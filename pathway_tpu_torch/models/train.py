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

The sharded step (``make_sharded_train_step``) runs the same step over a
(data, model) mesh, as the JAX package's GSPMD step does:

- **dp**: the batch is split over ``data``; each data shard encodes its
  rows, and the embeddings are gathered onto the mesh's first device, so
  InfoNCE is taken over the global batch (in-batch negatives span the
  data shards);
- **tp**: the encoder's matrices are split over ``model`` as
  ``param_pspecs`` says (models/encoder.py ``encode_tensor_parallel``);
- **ep**: MoE experts are split over ``model`` when num_experts > 0.

The state (``ShardedTrainState``) holds one float32 leaf tensor per
distinct piece of the parameter tree (M pieces of a leaf split over
``model``, one of a replicated leaf), placed by ``train_state_placements``.
Each data shard's copy of a piece is a differentiable ``.to(device)`` of
its leaf made in the forward, so autograd's accumulation into the leaf
is the all-reduce over replicas: the gradient of the global loss, summed
and never averaged. AdamW over the leaves is AdamW over the whole tree
(it works element by element and decays every piece).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

from pathway_tpu_torch.models.convert import params_from_jax, tree_map
from pathway_tpu_torch.models.encoder import (Encoder, EncoderConfig,
                                              check_tensor_parallel,
                                              dense_attention,
                                              encode_tensor_parallel,
                                              init_params_host,
                                              param_pspecs)
from pathway_tpu_torch.parallel.mesh import (DATA_AXIS, MODEL_AXIS, Mesh,
                                             Placement, all_gather,
                                             replicated, shard_batch)

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


# ---------------------------------------------------------------------------
# the sharded step: data x tensor x expert parallel over a mesh
# ---------------------------------------------------------------------------

def train_state_pspecs(config: EncoderConfig) -> dict:
    """The partition specs of the train state (tuples of axis names):
    the optimizer's moments split exactly like their parameters, scalars
    replicated. The JAX package's state tree is optax's; the port's
    optimizer state is AdamW's (a count and two moments a parameter) for
    every optimizer factory, so the tree is ``{"params", "opt_state":
    {"count", "mu", "nu"}, "step"}``."""
    pspecs = param_pspecs(config)
    return {"params": pspecs,
            "opt_state": {"count": (), "mu": pspecs, "nu": pspecs},
            "step": ()}


def train_state_placements(mesh: Mesh, config: EncoderConfig) -> dict:
    """``train_state_pspecs`` as ``Placement``s on ``mesh``: a leaf split
    over ``model`` by its spec, every other leaf ``replicated``. Raises
    ``ValueError`` where the model axis does not divide the heads, the
    intermediate width or the experts."""
    check_tensor_parallel(config, int(mesh.shape[MODEL_AXIS]))
    return tree_map(lambda spec: Placement(mesh, spec)
                    if MODEL_AXIS in spec else replicated(mesh),
                    train_state_pspecs(config))


def _model_index(placement: Placement) -> list[dict]:
    """The distinct pieces of a leaf: one a model shard if its placement
    splits it over ``model``, else one."""
    if MODEL_AXIS in placement.spec:
        return [{MODEL_AXIS: m}
                for m in range(placement.mesh.shape[MODEL_AXIS])]
    return [{}]


def _place(placement: Placement, array, *, leaf: bool) -> list:
    """A JAX-layout array's distinct pieces, each a float32 copy of its own
    on data shard 0's device for its model shard."""
    t = torch.tensor(np.asarray(array, dtype=np.float32))
    return [placement.piece(t, index).to(
        placement.mesh.device_at(index), torch.float32,
        memory_format=torch.contiguous_format, copy=True).requires_grad_(leaf)
        for index in _model_index(placement)]


def _flat(placements: dict, pieces: dict) -> list:
    out = []
    tree_map(lambda _, p: out.extend(p), placements, pieces)
    return out


@dataclasses.dataclass
class ShardedTrainState:
    """The sharded state: ``params`` is the JAX-layout tree with each leaf
    the list of its distinct float32 pieces (``placements`` says how each
    leaf lies), ``optimizer`` runs over all of them; ``step`` counts the
    steps taken."""
    mesh: Mesh
    placements: dict
    params: dict
    optimizer: torch.optim.Optimizer
    step: int = 0

    def pieces(self) -> list:
        """Every piece of every leaf, in the optimizer's order."""
        return _flat(self.placements, self.params)

    def shard_params(self, d: int) -> dict:
        """Data shard ``d``'s view of the parameters, as
        ``encode_tensor_parallel`` takes it: each piece copied
        (differentiably) to the device of (data d, its model shard)."""
        def copy(placement, pieces):
            devs = [self.mesh.device_at({DATA_AXIS: d, **index})
                    for index in _model_index(placement)]
            moved = [p.to(dev) for p, dev in zip(pieces, devs)]
            return moved if MODEL_AXIS in placement.spec else moved[0]

        return tree_map(copy, self.placements, self.params)

    def gather(self, what: str = "params") -> dict:
        """``what`` — "params", "grads" (of the last step), "mu" or "nu"
        (AdamW's moments) — as a JAX-layout tree of numpy arrays, each
        leaf's pieces gathered along the dim its spec splits (copies: a
        later step does not change them)."""
        def value(p):
            if what == "params":
                return p.detach()
            if what == "grads":
                return p.grad
            return self.optimizer.state[p][
                {"mu": "exp_avg", "nu": "exp_avg_sq"}[what]]

        cpu = torch.device("cpu")

        def one(placement, pieces):
            parts = [value(p) for p in pieces]
            if MODEL_AXIS not in placement.spec:
                return parts[0].cpu().numpy().copy()
            return all_gather(parts, cpu, axis=placement.spec.index(
                MODEL_AXIS), tiled=True).numpy()

        return tree_map(one, self.placements, self.params)


def init_sharded_train_state(seed: int, mesh: Mesh, config: EncoderConfig,
                             optimizer=None, *, params: dict | None = None
                             ) -> ShardedTrainState:
    """A fresh sharded state: the weights (``params``, a JAX-layout numpy
    tree, else ``init_params_host(seed, config)``) placed over ``mesh``
    and ``optimizer`` (a ``make_optimizer`` factory; its default without
    one) over their pieces."""
    if params is None:
        params = init_params_host(seed, config)
    placements = train_state_placements(mesh, config)["params"]
    pieces = tree_map(lambda pl, a: _place(pl, a, leaf=True), placements,
                      params)
    opt = (optimizer or make_optimizer())(_flat(placements, pieces))
    return ShardedTrainState(mesh, placements, pieces, opt)


def sharded_train_state_from_jax(state: dict, mesh: Mesh,
                                 config: EncoderConfig, optimizer=None
                                 ) -> ShardedTrainState:
    """The sharded state from a JAX train state fetched to the host
    (``jax.device_get``): its parameters, its step, and optax's Adam
    count and moments, each moment placed like its parameter."""
    out = init_sharded_train_state(0, mesh, config, optimizer,
                                   params=state["params"])
    adam = _adam_state(state["opt_state"])
    count = float(np.asarray(adam.count))
    mu, nu = (_flat(out.placements, tree_map(
        lambda pl, a: _place(pl, a, leaf=False), out.placements, moment))
        for moment in (adam.mu, adam.nu))
    for p, m, v in zip(out.pieces(), mu, nu):
        out.optimizer.state[p] = {"step": torch.tensor(count),
                                  "exp_avg": m, "exp_avg_sq": v}
    out.step = int(np.asarray(state["step"]))
    return out


def make_sharded_train_step(mesh: Mesh, config: EncoderConfig, *,
                            attn_fn=None):
    """The train step with dp batch sharding + tp/ep state sharding.

    Returns ``(step_fn, state_placements, batch_placement)``, the JAX
    package's triple: ``step_fn(state, batch) -> (state, loss)`` steps a
    ``ShardedTrainState`` in place and returns the loss as a device
    scalar on the mesh's first device; ``state_placements`` is
    ``train_state_placements(mesh, config)``, how the state built by
    ``init_sharded_train_state`` / ``sharded_train_state_from_jax`` lies;
    ``batch_placement`` splits each (B, S) array of the batch over
    ``data``. The optimizer lives in the state, as in
    ``contrastive_train_step`` (so, unlike the JAX package's, this takes
    no optimizer: pass its factory where the state is made). A batch size
    that ``data`` does not divide raises ``ValueError``, as
    ``jax.device_put`` with the batch sharding does."""
    state_placements = train_state_placements(mesh, config)
    batch_placement = shard_batch(mesh)
    n_data = int(mesh.shape[DATA_AXIS])
    root = mesh.device_at({})
    attn_fn = attn_fn or dense_attention

    def step_fn(state: ShardedTrainState, batch: dict):
        arrays = {k: torch.as_tensor(batch[k]) for k in _BATCH_KEYS}
        B = arrays["q_ids"].shape[0]
        if B % n_data:
            raise ValueError(
                f"sharded train step: batch size {B} is not divisible by "
                f"the {n_data}-way {DATA_AXIS!r} axis")
        embs = {"q": [], "d": []}
        for d in range(n_data):
            index = {DATA_AXIS: d}
            dev = mesh.device_at(index)
            params = state.shard_params(d)
            for side in "qd":
                ids, mask = (batch_placement.piece(arrays[f"{side}_{k}"],
                                                   index).to(dev)
                             for k in ("ids", "mask"))
                embs[side].append(encode_tensor_parallel(
                    params, ids.long(), mask.bool(), config=config,
                    attn_fn=attn_fn))
        q, d = (all_gather(embs[side], root, tiled=True) for side in "qd")
        loss = info_nce_loss(q, d)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        state.optimizer.step()
        state.step += 1
        return state, loss.detach()

    return step_fn, state_placements, batch_placement
