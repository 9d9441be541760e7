"""CLIP-style dual encoder (image + text) — port of
pathway_tpu/models/clip.py.

A ViT image tower and the port's text encoder (models/encoder.py),
each projected into one shared embedding space and trained with the CLIP
objective (InfoNCE in both directions). Patchify is a reshape and one
matmul (square, non-overlapping patches need no convolution); the vision
tower runs the text encoder's block functions with an ``EncoderConfig``
of its own widths. Both towers run ``dense_attention``, as the JAX towers
run ``_dense_attention``.

Parameters come as the JAX package's tree (numpy arrays):
``init_clip_params(seed, config)`` draws one from
``np.random.default_rng(seed)`` (the JAX package draws with
``jax.random``, which the port cannot reproduce), or the JAX package's
``init_clip_params`` output fetched to the host; ``ClipModel.from_params``
builds the module from either (``clip_params_from_jax``).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from pathway_tpu_torch._device import resolve_device
from pathway_tpu_torch.models.convert import (_t, layers_state,
                                              params_from_jax)
from pathway_tpu_torch.models.encoder import (DENSE_INIT_SCALE, Encoder,
                                              EncoderConfig, EncoderLayer,
                                              _attention_block, _build_params,
                                              _encode, _layer_norm,
                                              _mlp_block, dense_attention)


@dataclasses.dataclass(frozen=True)
class ClipConfig:
    image_size: int = 224
    patch_size: int = 16
    channels: int = 3
    vision_hidden: int = 192
    vision_layers: int = 6
    vision_heads: int = 6
    vision_intermediate: int = 768
    embed_dim: int = 128
    text: EncoderConfig = dataclasses.field(
        default_factory=lambda: EncoderConfig(pooling="cls",
                                              normalize=False))
    compute_dtype: torch.dtype = torch.bfloat16

    @property
    def n_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def vision_encoder_config(self) -> EncoderConfig:
        """The vision tower runs the text encoder's block functions under
        an EncoderConfig carrying its dimensions."""
        return EncoderConfig(
            hidden=self.vision_hidden, heads=self.vision_heads,
            intermediate=self.vision_intermediate,
            layers=self.vision_layers, pooling="cls", normalize=False,
            compute_dtype=self.compute_dtype)

    @staticmethod
    def tiny(**kw) -> "ClipConfig":
        base = dict(image_size=16, patch_size=4, vision_hidden=32,
                    vision_layers=2, vision_heads=4,
                    vision_intermediate=64, embed_dim=16,
                    text=EncoderConfig.tiny(pooling="cls", normalize=False))
        base.update(kw)
        return ClipConfig(**base)


def init_clip_params(seed: int, config: ClipConfig) -> dict:
    """Random weights as a numpy tree in the JAX package's layout (its
    shapes, its initial scales), drawn from ``np.random.default_rng(seed)``
    — not the JAX package's values, which come from ``jax.random``."""
    rng = np.random.default_rng(seed)

    def dense(shape):
        return (rng.normal(size=shape) * DENSE_INIT_SCALE).astype(np.float32)

    def zeros(shape):
        return np.zeros(shape, np.float32)

    def ones(shape):
        return np.ones(shape, np.float32)

    Hv, P = config.vision_hidden, config.patch_size
    vision = _build_params(
        dataclasses.replace(config.vision_encoder_config, vocab_size=1,
                            max_len=config.n_patches + 1), dense, zeros, ones)
    # vision embeddings are patches, not tokens
    vision["embeddings"] = {
        "patch_w": dense((P * P * config.channels, Hv)),
        "patch_b": zeros((Hv,)),
        "cls": dense((Hv,)),
        "position": dense((config.n_patches + 1, Hv)),
        "ln_scale": ones((Hv,)),
        "ln_bias": zeros((Hv,)),
    }
    return {
        "vision": vision,
        "text": _build_params(config.text, dense, zeros, ones),
        "vision_proj": dense((Hv, config.embed_dim)),
        "text_proj": dense((config.text.hidden, config.embed_dim)),
        "logit_scale": np.asarray(np.log(1.0 / 0.07), np.float32),
    }


class VisionEmbeddings(nn.Module):
    def __init__(self, config: ClipConfig, dtype: torch.dtype):
        super().__init__()
        Hv, P = config.vision_hidden, config.patch_size
        self.patch = nn.Linear(P * P * config.channels, Hv, dtype=dtype)
        self.cls = nn.Parameter(torch.empty(Hv))
        self.position = nn.Parameter(torch.empty(config.n_patches + 1, Hv))
        self.ln = nn.LayerNorm(Hv, eps=config.vision_encoder_config
                               .layer_norm_eps)


class VisionTower(nn.Module):
    def __init__(self, config: ClipConfig, dtype: torch.dtype):
        super().__init__()
        cfg = config.vision_encoder_config
        self.embeddings = VisionEmbeddings(config, dtype)
        self.layers = nn.ModuleList(
            EncoderLayer(cfg, dtype) for _ in range(cfg.layers))


class ClipModel(nn.Module):
    """The dual encoder's parameters: ``vision`` (a ViT), ``text`` (an
    ``Encoder``), the two float32 projections and the logit scale. Dense
    block weights are held as ``Encoder`` holds them: in each tower's
    compute dtype to serve, in float32 to train."""

    def __init__(self, config: ClipConfig,
                 param_dtype: torch.dtype | None = None):
        super().__init__()
        self.config = config
        self.vision = VisionTower(config, param_dtype or config.compute_dtype)
        self.text = Encoder(config.text, param_dtype)
        self.vision_proj = nn.Parameter(
            torch.empty(config.vision_hidden, config.embed_dim))
        self.text_proj = nn.Parameter(
            torch.empty(config.text.hidden, config.embed_dim))
        self.logit_scale = nn.Parameter(torch.empty(()))

    @classmethod
    def from_params(cls, params: dict, config: ClipConfig, *,
                    device: str | torch.device = "cuda",
                    trainable: bool = False) -> "ClipModel":
        """Build on ``device`` from a JAX-layout numpy tree
        (``init_clip_params`` output, or the JAX package's parameters
        fetched to the host); ``trainable`` as in ``Encoder.from_params``."""
        dev = resolve_device(device)
        with torch.device("meta"):
            model = cls(config, torch.float32 if trainable else None)
        model = model.to_empty(device=dev)
        model.load_state_dict(clip_params_from_jax(params))
        return model.requires_grad_(trainable).train(trainable)


def clip_params_from_jax(tree: dict) -> dict[str, torch.Tensor]:
    """State dict (float32 CPU tensors) of ``ClipModel`` from the JAX
    package's CLIP tree: the patch weight transposes to nn.Linear's (out,
    in), the towers' layers as models/convert.py maps an encoder's, the
    rest as it is."""
    emb = tree["vision"]["embeddings"]
    state = {
        "vision.embeddings.patch.weight": _t(np.asarray(emb["patch_w"]).T),
        "vision.embeddings.patch.bias": _t(emb["patch_b"]),
        "vision.embeddings.cls": _t(emb["cls"]),
        "vision.embeddings.position": _t(emb["position"]),
        "vision.embeddings.ln.weight": _t(emb["ln_scale"]),
        "vision.embeddings.ln.bias": _t(emb["ln_bias"]),
        "vision_proj": _t(tree["vision_proj"]),
        "text_proj": _t(tree["text_proj"]),
        "logit_scale": _t(tree["logit_scale"]),
    }
    state.update(layers_state(tree["vision"]["layers"], "vision."))
    state.update(params_from_jax(tree["text"], "text."))
    return state


def _patchify(pixels, config: ClipConfig):
    """(B, H, W, C) -> (B, n_patches, P*P*C): a reshape and a permute;
    the patch projection is then one matmul."""
    B = pixels.shape[0]
    P = config.patch_size
    n = config.image_size // P
    x = pixels.reshape(B, n, P, n, P, config.channels)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, n * n, P * P * config.channels)


def _unit(out):
    return out / torch.clamp_min(
        torch.linalg.vector_norm(out, dim=-1, keepdim=True), 1e-12)


def encode_image(model: ClipModel, pixels):
    """(B, H, W, C) float pixels in [0, 1] on the model's device ->
    (B, embed_dim) L2-normalised float32, under the caller's grad mode.
    The pooled vector is the mean over the patch tokens (CLS left out),
    as in the JAX tower."""
    config = model.config
    emb = model.vision.embeddings
    cd = config.compute_dtype
    cfg = config.vision_encoder_config
    x = _patchify(pixels.to(cd), config)
    x = F.linear(x, emb.patch.weight.to(cd), emb.patch.bias.to(cd))
    cls = emb.cls.to(cd)[None, None].expand(x.shape[0], 1, x.shape[-1])
    x = torch.cat([cls, x], dim=1)
    x = x + emb.position[None].to(cd)
    x = _layer_norm(x, emb.ln.weight, emb.ln.bias, cfg.layer_norm_eps,
                    out_dtype=cd)
    mask = torch.ones(x.shape[:2], dtype=torch.bool, device=x.device)
    for layer in model.vision.layers:
        x = _attention_block(x, layer.attn, mask, cfg, dense_attention)
        x = _mlp_block(x, layer.mlp, cfg)
    pooled = x[:, 1:].float().mean(dim=1)
    return _unit(pooled @ model.vision_proj)


def encode_text(model: ClipModel, token_ids, attention_mask):
    """(B, S) tokens on the model's device -> (B, embed_dim)
    L2-normalised float32, under the caller's grad mode: the text encoder
    (``normalize=False``, dense attention) and its projection."""
    pooled = _encode(model.text, token_ids, attention_mask,
                     attn_fn=dense_attention)
    return _unit(pooled @ model.text_proj)


def clip_loss(model: ClipModel, batch: dict):
    """Symmetric InfoNCE over in-batch negatives (the CLIP objective);
    batch = {pixels (B, H, W, C), ids (B, S), mask (B, S)} tensors on the
    model's device. The logit scale is clipped to [-5, log 100] before
    its exp."""
    img = encode_image(model, batch["pixels"])
    txt = encode_text(model, batch["ids"], batch["mask"])
    scale = torch.exp(torch.clamp(model.logit_scale, -5.0,
                                  float(np.log(100.0))))
    logits = (img @ txt.T) * scale
    li = -torch.log_softmax(logits, dim=1).diagonal().mean()
    lt = -torch.log_softmax(logits, dim=0).diagonal().mean()
    return (li + lt) / 2


def make_clip_optimizer(lr: float = 1e-3
                        ) -> Callable[..., torch.optim.Optimizer]:
    """``optax.adam(lr)`` (b1 0.9, b2 0.999, eps 1e-8) as a factory of
    ``torch.optim.Adam`` over parameters."""
    return functools.partial(torch.optim.Adam, lr=lr, betas=(0.9, 0.999),
                             eps=1e-8)


def clip_train_step(model: ClipModel, optimizer: torch.optim.Optimizer,
                    batch: dict):
    """One Adam step in place on a trainable model (``from_params(...,
    trainable=True)``); batch as for :func:`clip_loss`, numpy arrays or
    tensors. Returns (model, optimizer, loss as a device scalar), the JAX
    step's (params, opt_state, loss)."""
    dev = model.vision_proj.device
    b = {"pixels": torch.as_tensor(batch["pixels"]).to(dev).float(),
         "ids": torch.as_tensor(batch["ids"]).to(dev).long(),
         "mask": torch.as_tensor(batch["mask"]).to(dev).bool()}
    loss = clip_loss(model, b)
    optimizer.zero_grad(set_to_none=True)
    loss.backward()
    optimizer.step()
    return model, optimizer, loss.detach()


def load_image(raw: bytes, *, config: ClipConfig):
    """Decode and resize image bytes to the model's (H, W, C) float32
    array in [0, 1]. PIL decodes (imported here: a machine without it
    fails only in this call); callers may pass ndarrays to the embedder
    and skip this."""
    import io

    from PIL import Image

    img = Image.open(io.BytesIO(raw)).convert("RGB").resize(
        (config.image_size, config.image_size))
    return np.asarray(img, dtype=np.float32) / 255.0
