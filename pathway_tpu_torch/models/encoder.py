"""BERT-family transformer encoder in PyTorch — port of
pathway_tpu/models/encoder.py (default shape = BGE-small-en-v1.5: vocab
30522, hidden 384, 12 layers, 6 heads).

The numerics follow the JAX encoder: matmuls in the compute dtype
(bfloat16 by default), layer-norm statistics in float32, a post-layernorm
residual stream kept in the compute dtype, cls or mean pooling in float32,
then L2 normalisation. The attention call keeps JAX's ``(B, S, H, D)``
layout at the ``attn_fn`` hook; on a CUDA tensor the default hook is the
hand-written kernel of ops/attention.py.

Weights live in ``nn.Linear`` modules, whose weight is ``(out, in)``; the
JAX tree stores ``(in, out)`` and computes ``x @ w``.
models/convert.py transposes between the two.

``encode_ragged`` is the ragged-packed forward: documents packed back to
back into fixed-width sequences, with K1 given the per-token document
ids as segment ids.

With ``num_experts > 0`` each layer's MLP is a top-1 switch
mixture of experts (``MoeBlock``), dispatched densely as in the JAX
package. The blocks cast every weight to the compute dtype where they use
it, so one forward serves both a serving module (dense weights already in
the compute dtype) and a trainable one (``from_params(...,
trainable=True)``: every parameter in float32, as the JAX tree holds
them). ``encode`` is the serving entry (no autograd); calling the module
runs the same forward with autograd, and training passes
``dense_attention``, since K1 has no backward.

``param_pspecs`` names, leaf by leaf, the mesh axis each dim of the
parameter tree is split over (Megatron-style tensor parallelism over the
``model`` axis: the query, key, value and up projections split by output
columns, the output and down projections by input rows, MoE experts by
expert), as tuples of axis names (``Placement.spec``'s form).
``encode_tensor_parallel`` is the forward those specs imply: each model
shard computes with its own columns, rows or experts (1/M of each
matrix) on its own device, and the partial results are summed over the
shards before the replicated bias and layer norm.
"""

from __future__ import annotations

import dataclasses
from types import SimpleNamespace
from typing import Any, Callable

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from pathway_tpu_torch._device import resolve_device
from pathway_tpu_torch.parallel.mesh import MODEL_AXIS, all_gather


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    vocab_size: int = 30522
    hidden: int = 384
    layers: int = 12
    heads: int = 6
    intermediate: int = 1536
    max_len: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    pooling: str = "cls"  # "cls" (BGE) | "mean" (MiniLM/ST default)
    normalize: bool = True
    num_experts: int = 0  # 0 -> dense MLP; >0 -> top-1 switch MoE
    compute_dtype: torch.dtype = torch.bfloat16
    # "auto": tanh-gelu under a 2-byte compute dtype, erf-gelu otherwise —
    # the JAX encoder's rule (its approximation error sits below bf16's own
    # rounding, while f32 keeps BERT's exact activation)
    gelu: str = "auto"  # "auto" | "erf" | "tanh"

    @property
    def head_dim(self) -> int:
        return self.hidden // self.heads

    @staticmethod
    def tiny(**kw) -> "EncoderConfig":
        """Small config for tests/dryruns."""
        base = dict(vocab_size=1024, hidden=64, layers=2, heads=4,
                    intermediate=128, max_len=128)
        base.update(kw)
        return EncoderConfig(**base)

    @staticmethod
    def bge_small(**kw) -> "EncoderConfig":
        return EncoderConfig(**kw)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

DENSE_INIT_SCALE = 0.02


def _build_params(config: EncoderConfig, dense, zeros, ones) -> dict:
    """Parameter tree in the JAX package's layout, parametric over the
    array factory. The call order of ``dense`` is the JAX package's, so a
    seeded factory gives the same tree bit for bit."""
    H, I_, V = config.hidden, config.intermediate, config.vocab_size
    params: dict[str, Any] = {
        "embeddings": {
            "token": dense((V, H)),
            "position": dense((config.max_len, H)),
            "token_type": dense((config.type_vocab_size, H)),
            "ln_scale": ones((H,)),
            "ln_bias": zeros((H,)),
        },
        "layers": [],
    }
    for _ in range(config.layers):
        layer = {
            "attn": {
                "wq": dense((H, H)), "bq": zeros((H,)),
                "wk": dense((H, H)), "bk": zeros((H,)),
                "wv": dense((H, H)), "bv": zeros((H,)),
                "wo": dense((H, H)), "bo": zeros((H,)),
                "ln_scale": ones((H,)),
                "ln_bias": zeros((H,)),
            },
        }
        if config.num_experts > 0:
            E = config.num_experts
            layer["moe"] = {
                "router": dense((H, E)),
                "w1": dense((E, H, I_)),
                "b1": zeros((E, I_)),
                "w2": dense((E, I_, H)),
                "b2": zeros((E, H)),
                "ln_scale": ones((H,)),
                "ln_bias": zeros((H,)),
            }
        else:
            layer["mlp"] = {
                "w1": dense((H, I_)),
                "b1": zeros((I_,)),
                "w2": dense((I_, H)),
                "b2": zeros((H,)),
                "ln_scale": ones((H,)),
                "ln_bias": zeros((H,)),
            }
        params["layers"].append(layer)
    return params


def init_params_host(seed: int, config: EncoderConfig) -> dict:
    """Random weights as a numpy tree in the JAX layout, from
    ``np.random.default_rng(seed)`` — bit-identical to
    pathway_tpu.models.encoder.init_params_host for the same seed."""
    rng = np.random.default_rng(seed)
    return _build_params(
        config,
        dense=lambda shape: (rng.normal(size=shape)
                             * DENSE_INIT_SCALE).astype(np.float32),
        zeros=lambda shape: np.zeros(shape, np.float32),
        ones=lambda shape: np.ones(shape, np.float32))


def param_pspecs(config: EncoderConfig) -> dict:
    """The partition spec of every leaf of the parameter tree, for tensor
    parallelism over the ``model`` axis: the JAX package's
    ``param_pspecs`` with each ``P(...)`` as the tuple of its axis names
    (``P(None, M)`` -> ``(None, "model")``)."""
    M = MODEL_AXIS
    emb = {
        "token": (None, None),
        "position": (None, None),
        "token_type": (None, None),
        "ln_scale": (None,),
        "ln_bias": (None,),
    }
    layers = []
    for _ in range(config.layers):
        layer = {
            "attn": {
                # QKV split on the head (output) dim, out-proj on input dim
                "wq": (None, M), "bq": (M,),
                "wk": (None, M), "bk": (M,),
                "wv": (None, M), "bv": (M,),
                "wo": (M, None), "bo": (None,),
                "ln_scale": (None,), "ln_bias": (None,),
            },
        }
        if config.num_experts > 0:
            layer["moe"] = {
                "router": (None, None),
                # expert-parallel: experts sharded over the model axis
                "w1": (M, None, None), "b1": (M, None),
                "w2": (M, None, None), "b2": (M, None),
                "ln_scale": (None,), "ln_bias": (None,),
            }
        else:
            layer["mlp"] = {
                "w1": (None, M), "b1": (M,),
                "w2": (M, None), "b2": (None,),
                "ln_scale": (None,), "ln_bias": (None,),
            }
        layers.append(layer)
    return {"embeddings": emb, "layers": layers}


def check_tensor_parallel(config: EncoderConfig, n_model: int) -> None:
    """Raise ``ValueError`` unless a ``model`` axis of ``n_model`` shards
    divides what it splits: the heads, and the intermediate width (dense
    MLP) or the experts (MoE)."""
    split = [("heads", config.heads)]
    if config.num_experts > 0:
        split.append(("num_experts", config.num_experts))
    else:
        split.append(("intermediate", config.intermediate))
    for what, n in split:
        if n % n_model:
            raise ValueError(
                f"tensor parallelism: {what}={n} is not divisible by the "
                f"{n_model}-way {MODEL_AXIS!r} axis")


# ---------------------------------------------------------------------------
# module
# ---------------------------------------------------------------------------

class Embeddings(nn.Module):
    def __init__(self, config: EncoderConfig):
        super().__init__()
        H = config.hidden
        self.token = nn.Embedding(config.vocab_size, H)
        self.position = nn.Embedding(config.max_len, H)
        self.token_type = nn.Embedding(config.type_vocab_size, H)
        self.ln = nn.LayerNorm(H, eps=config.layer_norm_eps)


class AttentionBlock(nn.Module):
    def __init__(self, config: EncoderConfig, dtype: torch.dtype):
        super().__init__()
        H = config.hidden
        self.wq = nn.Linear(H, H, dtype=dtype)
        self.wk = nn.Linear(H, H, dtype=dtype)
        self.wv = nn.Linear(H, H, dtype=dtype)
        self.wo = nn.Linear(H, H, dtype=dtype)
        self.ln = nn.LayerNorm(H, eps=config.layer_norm_eps)


class MlpBlock(nn.Module):
    def __init__(self, config: EncoderConfig, dtype: torch.dtype):
        super().__init__()
        H, I_ = config.hidden, config.intermediate
        self.w1 = nn.Linear(H, I_, dtype=dtype)
        self.w2 = nn.Linear(I_, H, dtype=dtype)
        self.ln = nn.LayerNorm(H, eps=config.layer_norm_eps)


class MoeBlock(nn.Module):
    """Top-1 switch mixture of experts, in the JAX tree's layout (no
    transpose): ``router`` (H, E) in float32, ``w1`` (E, H, I), ``b1``
    (E, I), ``w2`` (E, I, H), ``b2`` (E, H)."""

    def __init__(self, config: EncoderConfig, dtype: torch.dtype):
        super().__init__()
        H, I_, E = config.hidden, config.intermediate, config.num_experts
        self.router = nn.Parameter(torch.empty(H, E, dtype=torch.float32))
        self.w1 = nn.Parameter(torch.empty(E, H, I_, dtype=dtype))
        self.b1 = nn.Parameter(torch.empty(E, I_, dtype=dtype))
        self.w2 = nn.Parameter(torch.empty(E, I_, H, dtype=dtype))
        self.b2 = nn.Parameter(torch.empty(E, H, dtype=dtype))
        self.ln = nn.LayerNorm(H, eps=config.layer_norm_eps)


class EncoderLayer(nn.Module):
    """Attention, then ``mlp`` (dense) or ``moe`` (``num_experts > 0``),
    the JAX layer's keys."""

    def __init__(self, config: EncoderConfig, dtype: torch.dtype):
        super().__init__()
        self.attn = AttentionBlock(config, dtype)
        if config.num_experts > 0:
            self.moe = MoeBlock(config, dtype)
        else:
            self.mlp = MlpBlock(config, dtype)


class Encoder(nn.Module):
    """The encoder's parameters as a module tree. Dense weights and biases
    are held in ``param_dtype`` (the compute dtype unless given: the JAX
    forward casts them to it on every call); embedding tables, layer-norm
    parameters and the MoE router stay float32. ``forward`` runs the
    encoder with autograd (a training step); :func:`encode` is the same
    forward without it (serving)."""

    def __init__(self, config: EncoderConfig,
                 param_dtype: torch.dtype | None = None):
        super().__init__()
        self.config = config
        dtype = param_dtype or config.compute_dtype
        self.embeddings = Embeddings(config)
        self.layers = nn.ModuleList(
            EncoderLayer(config, dtype) for _ in range(config.layers))

    @classmethod
    def from_params(cls, params: dict, config: EncoderConfig, *,
                    device: str | torch.device = "cuda",
                    trainable: bool = False) -> "Encoder":
        """Build on ``device`` from a JAX-layout numpy tree
        (``init_params_host`` output, or the JAX package's parameters
        fetched to the host). A serving module (the default) is frozen in
        eval mode with dense weights in the compute dtype; a
        ``trainable`` one holds every parameter in float32 (the master
        weights the optimizer updates) with gradients on."""
        from pathway_tpu_torch.models.convert import params_from_jax

        dev = resolve_device(device)
        with torch.device("meta"):
            model = cls(config, torch.float32 if trainable else None)
        # meta construction skips nn's random init: every value comes
        # from ``params`` below
        model = model.to_empty(device=dev)
        model.load_state_dict(params_from_jax(params))
        return model.requires_grad_(trainable).train(trainable)

    def forward(self, token_ids, attention_mask, *,
                attn_fn: Callable | None = None, token_type_ids=None):
        return _encode(self, token_ids, attention_mask, attn_fn=attn_fn,
                       token_type_ids=token_type_ids)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

_BIASES = {"wq": "bq", "wk": "bk", "wv": "bv", "wo": "bo",
           "w1": "b1", "w2": "b2"}


def block_view(p: dict) -> SimpleNamespace:
    """A dense block of the JAX-layout tree (``attn`` or ``mlp``) as the
    attributes the blocks read: each (in, out) weight as an (out, in)
    view beside its bias, the layer norm as ``ln``. Nothing is copied."""
    view = SimpleNamespace(ln=SimpleNamespace(weight=p["ln_scale"],
                                              bias=p["ln_bias"]))
    for w, b in _BIASES.items():
        if w in p:
            setattr(view, w, SimpleNamespace(weight=p[w].T, bias=p[b]))
    return view


def _embeddings_view(e: dict) -> SimpleNamespace:
    return SimpleNamespace(
        token=SimpleNamespace(weight=e["token"]),
        position=SimpleNamespace(weight=e["position"]),
        token_type=SimpleNamespace(weight=e["token_type"]),
        ln=SimpleNamespace(weight=e["ln_scale"], bias=e["ln_bias"]))


def _layer_norm(x, scale, bias, eps, out_dtype=None):
    """Statistics in float32 (population variance), the result cast back
    to ``out_dtype`` (the residual stream stays in the compute dtype)."""
    out_dtype = out_dtype or x.dtype
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    normed = (xf - mu) * torch.rsqrt(var + eps) * scale + bias
    return normed.to(out_dtype)


def _linear(x, lin: nn.Linear, cd: torch.dtype):
    """``x @ w + b`` with the weight and bias cast to the compute dtype
    (a no-op for a serving module, whose weights are held in it)."""
    return F.linear(x, lin.weight.to(cd), lin.bias.to(cd))


def _masked_attention(q, k, v, valid):
    """The JAX encoder's softmax attention: scores in the compute dtype,
    a -1e9 bias where ``valid`` (broadcast against (B, H, S, S)) is
    False, the max subtracted and the exp taken in float32, then cast back
    and normalised in the compute dtype."""
    scale = q.shape[-1] ** -0.5
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    scores = scores + torch.where(valid, 0.0, -1e9).to(scores.dtype)
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp((scores - m).float()).to(scores.dtype)
    probs = p / p.sum(dim=-1, keepdim=True)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)


def dense_attention(q, k, v, mask):
    """Counterpart of the JAX encoder's ``_dense_attention`` (its default
    attention, and the one its training step runs): q, k, v (B, S, H, D),
    mask (B, S) key validity. Differentiable; not K1's plain version
    (``ops.attention.attention_reference`` keeps scores in float32 with a
    ``finfo.min`` fill)."""
    return _masked_attention(q, k, v, mask[:, None, None, :])


def _attention_block(x, p: AttentionBlock, mask, config: EncoderConfig,
                     attn_fn: Callable):
    cd = config.compute_dtype
    xc = x.to(cd)
    B, S, H = x.shape
    q = _linear(xc, p.wq, cd)
    k = _linear(xc, p.wk, cd)
    v = _linear(xc, p.wv, cd)
    shp = (B, S, config.heads, config.head_dim)
    out = attn_fn(q.view(shp), k.view(shp), v.view(shp), mask)
    out = _linear(out.reshape(B, S, H).to(cd), p.wo, cd)
    return _layer_norm(xc + out, p.ln.weight, p.ln.bias,
                       config.layer_norm_eps, out_dtype=cd)


def _use_tanh_gelu(config: EncoderConfig) -> bool:
    if config.gelu == "auto":
        return config.compute_dtype.itemsize <= 2
    if config.gelu not in ("erf", "tanh"):
        raise ValueError(
            f"EncoderConfig.gelu must be 'auto', 'erf' or 'tanh'; "
            f"got {config.gelu!r}")
    return config.gelu == "tanh"


def _gelu(h, config: EncoderConfig):
    return F.gelu(h, approximate="tanh" if _use_tanh_gelu(config)
                  else "none")


def _mlp_block(x, p: MlpBlock, config: EncoderConfig):
    cd = config.compute_dtype
    xc = x.to(cd)
    h = _gelu(_linear(xc, p.w1, cd), config)
    out = _linear(h, p.w2, cd)
    return _layer_norm(xc + out, p.ln.weight, p.ln.bias,
                       config.layer_norm_eps, out_dtype=cd)


def _moe_route(x, router):
    """(gates, top): the router's softmax in float32 from the block input
    (B, S, E), and each token's expert (B, S), the first maximum (as
    ``jnp.argmax``)."""
    gates = torch.softmax(x.float() @ router.float(), dim=-1)
    return gates, gates.argmax(dim=-1)


def _moe_block(x, p: MoeBlock, config: EncoderConfig):
    """The JAX encoder's top-1 switch MoE: router logits in float32 from
    the block input, softmax, the first maximum's expert as a one-hot in
    the compute dtype, and every expert applied to every token (a dense
    dispatch with no data-dependent shape: CUDA graphs capture it). The
    router learns through ``gate_val``; the argmax and one-hot carry no
    gradient, as in JAX."""
    cd = config.compute_dtype
    onehot, gate_val = _moe_gates(x, p.router, config)
    xc = x.to(cd)
    out = _experts(xc, p.w1, p.b1, p.w2, p.b2, onehot, config)
    out = (out.float() * gate_val[..., None]).to(cd)
    return _layer_norm(xc + out, p.ln.weight, p.ln.bias,
                       config.layer_norm_eps, out_dtype=cd)


def _moe_gates(x, router, config: EncoderConfig):
    """(onehot, gate_val): each token's expert as a one-hot (B, S, E) in
    the compute dtype and its router probability (B, S) in float32."""
    gates, top = _moe_route(x, router)
    # a comparison, not F.one_hot, which reads the indices' range back to
    # the host (a sync, fatal inside a CUDA graph capture)
    experts = torch.arange(config.num_experts, device=x.device)
    onehot = (top[..., None] == experts).to(config.compute_dtype)
    return onehot, (gates * onehot.float()).sum(dim=-1)


def _experts(xc, w1, b1, w2, b2, onehot, config: EncoderConfig):
    """Every expert of ``w1`` / ``w2`` (E, H, I) / (E, I, H) on every
    token of ``xc``, each token's output kept from the expert its
    ``onehot`` (B, S, E) picks: (B, S, H) in the compute dtype."""
    cd = config.compute_dtype
    h = torch.einsum("bsh,ehi->bsei", xc, w1.to(cd)) + b1.to(cd)[None, None]
    if _use_tanh_gelu(config):
        h = F.gelu(h, approximate="tanh")
    else:
        h = F.gelu(h.float()).to(cd)
    out = torch.einsum("bsei,eih->bseh", h, w2.to(cd)) + b2.to(cd)[None, None]
    return torch.einsum("bseh,bse->bsh", out, onehot)


def _embed(emb, token_ids, config: EncoderConfig, position_ids=None,
           token_type_ids=None):
    """The embedding sum and its layer norm -> (B, S, H) in the compute
    dtype."""
    S = token_ids.shape[1]
    cd = config.compute_dtype
    # gather float32 rows, then cast only what was read
    x = emb.token.weight[token_ids].to(cd)
    if position_ids is None:
        x = x + emb.position.weight[:S][None].to(cd)
    else:
        x = x + emb.position.weight[position_ids].to(cd)
    if token_type_ids is None:
        x = x + emb.token_type.weight[0][None, None].to(cd)
    else:
        x = x + emb.token_type.weight[token_type_ids].to(cd)
    return _layer_norm(x, emb.ln.weight, emb.ln.bias, config.layer_norm_eps,
                       out_dtype=cd)


def _forward(model: Encoder, token_ids, mask, *, attn_fn: Callable,
             position_ids=None, token_type_ids=None):
    """Embedding + transformer stack -> (B, S, H) final hidden states.
    ``position_ids=None`` keeps positions 0..S-1; the ragged path passes
    per-token positions that restart at 0 for each packed document."""
    config = model.config
    x = _embed(model.embeddings, token_ids, config, position_ids,
               token_type_ids)
    for layer in model.layers:
        x = _attention_block(x, layer.attn, mask, config, attn_fn)
        if config.num_experts > 0:
            x = _moe_block(x, layer.moe, config)
        else:
            x = _mlp_block(x, layer.mlp, config)
    return x


def _normalized(pooled, config: EncoderConfig):
    if config.normalize:
        pooled = pooled / torch.clamp_min(
            torch.linalg.vector_norm(pooled, dim=-1, keepdim=True), 1e-12)
    return pooled


def _encode(model: Encoder, token_ids, attention_mask, *,
            attn_fn: Callable | None = None, token_type_ids=None):
    """:func:`encode`'s body, under whatever grad mode the caller set."""
    if attn_fn is None:
        from pathway_tpu_torch.ops.attention import flash_attention

        attn_fn = flash_attention
    mask = attention_mask.to(torch.bool)
    x = _forward(model, token_ids, mask, attn_fn=attn_fn,
                 token_type_ids=token_type_ids)
    return _pool(x, mask, model.config)


def _pool(x, mask, config: EncoderConfig):
    """cls or mean pooling in float32, then the optional L2 norm."""
    if config.pooling == "cls":
        pooled = x[:, 0].float()
    else:  # mean over valid tokens
        xf = x.float()
        m = mask.float()[..., None]
        pooled = (xf * m).sum(dim=1) / torch.clamp_min(m.sum(dim=1), 1.0)
    return _normalized(pooled, config)


@torch.no_grad()
def encode(model: Encoder, token_ids, attention_mask, *,
           attn_fn: Callable | None = None, token_type_ids=None):
    """Forward pass -> pooled, (optionally) L2-normalised float32
    embeddings on the model's device, without autograd (serving; calling
    the module runs it with autograd).

    token_ids, attention_mask: (B, S) integer / bool tensors on that
    device. ``attn_fn(q, k, v, mask)`` takes (B, S, H, D) tensors; the
    default is ops.attention.flash_attention (the CUDA kernel on a CUDA
    tensor, its plain version on a CPU tensor)."""
    return _encode(model, token_ids, attention_mask, attn_fn=attn_fn,
                   token_type_ids=token_type_ids)


# ---------------------------------------------------------------------------
# tensor-parallel forward
# ---------------------------------------------------------------------------

def _model_sum(parts: list, device: torch.device):
    """``psum`` over the model axis: the shards' partial results, summed
    on ``device``."""
    return all_gather(parts, device).sum(dim=0)


def _tp_attention_block(x, p: dict, mask, config: EncoderConfig,
                        attn_fn: Callable):
    """``_attention_block`` split by heads: model shard m projects onto its
    columns of wq / wk / wv (heads [m h/M, (m+1) h/M)), attends over
    them, and multiplies by its rows of wo; the partials are summed, then
    the replicated bo is added once."""
    cd = config.compute_dtype
    xc = x.to(cd)
    B, S, H = x.shape
    n = len(p["wq"])
    shp = (B, S, config.heads // n, config.head_dim)
    parts = []
    for m, wq in enumerate(p["wq"]):
        dev = wq.device
        xm = xc.to(dev)
        q, k, v = (F.linear(xm, p[w][m].T.to(cd), p[b][m].to(cd))
                   for w, b in (("wq", "bq"), ("wk", "bk"), ("wv", "bv")))
        out = attn_fn(q.view(shp), k.view(shp), v.view(shp), mask.to(dev))
        parts.append(F.linear(out.reshape(B, S, H // n).to(cd),
                              p["wo"][m].T.to(cd)))
    out = _model_sum(parts, xc.device) + p["bo"].to(cd)
    return _layer_norm(xc + out, p["ln_scale"], p["ln_bias"],
                       config.layer_norm_eps, out_dtype=cd)


def _tp_mlp_block(x, p: dict, config: EncoderConfig):
    """``_mlp_block`` split by the intermediate width: shard m's columns of
    w1 and b1, GELU, its rows of w2; the partials summed, then b2."""
    cd = config.compute_dtype
    xc = x.to(cd)
    parts = []
    for m, w1 in enumerate(p["w1"]):
        h = _gelu(F.linear(xc.to(w1.device), w1.T.to(cd),
                           p["b1"][m].to(cd)), config)
        parts.append(F.linear(h, p["w2"][m].T.to(cd)))
    out = _model_sum(parts, xc.device) + p["b2"].to(cd)
    return _layer_norm(xc + out, p["ln_scale"], p["ln_bias"],
                       config.layer_norm_eps, out_dtype=cd)


def _tp_moe_block(x, p: dict, config: EncoderConfig):
    """``_moe_block`` split by experts: the replicated router picks each
    token's expert once (the first maximum), model shard m runs its
    experts masked by its slice of the one-hot, and the summed partials
    take the float32 gate scaling."""
    cd = config.compute_dtype
    onehot, gate_val = _moe_gates(x, p["router"], config)
    xc = x.to(cd)
    parts = []
    for m, w1 in enumerate(p["w1"]):
        dev, e = w1.device, w1.shape[0]
        parts.append(_experts(xc.to(dev), w1, p["b1"][m], p["w2"][m],
                              p["b2"][m], onehot[..., m * e:(m + 1) * e]
                              .to(dev), config))
    out = _model_sum(parts, xc.device)
    out = (out.float() * gate_val[..., None]).to(cd)
    return _layer_norm(xc + out, p["ln_scale"], p["ln_bias"],
                       config.layer_norm_eps, out_dtype=cd)


def encode_tensor_parallel(params: dict, token_ids, attention_mask, *,
                           config: EncoderConfig,
                           attn_fn: Callable | None = None):
    """The forward ``param_pspecs`` implies, with autograd, -> pooled,
    (optionally) L2-normalised float32 embeddings.

    ``params`` is the JAX-layout tree with every leaf that
    ``param_pspecs`` splits over ``model`` as the list of its M pieces
    (piece m on model shard m's device: 1/M of the columns, rows or
    experts) and every other leaf whole on model shard 0's device, where
    token_ids, attention_mask and the result lie. The embeddings, layer
    norms, residual stream and router run there; each block's matrices
    run on the shards. ``attn_fn`` defaults to ``dense_attention`` (the
    JAX training step's)."""
    attn_fn = attn_fn or dense_attention
    mask = attention_mask.to(torch.bool)
    x = _embed(_embeddings_view(params["embeddings"]), token_ids, config)
    for layer in params["layers"]:
        x = _tp_attention_block(x, layer["attn"], mask, config, attn_fn)
        if "moe" in layer:
            x = _tp_moe_block(x, layer["moe"], config)
        else:
            x = _tp_mlp_block(x, layer["mlp"], config)
    return _pool(x, mask, config)


def encoder_cost(config: EncoderConfig, batch: int,
                 seq: int) -> tuple[float, float]:
    """Analytic (flops, bytes_moved) for one forward of ``batch x seq``
    tokens under ``config`` (engine/profiler.py owns the formula)."""
    from pathway_tpu_torch.engine.profiler import encoder_cost as _cost

    return _cost(batch, seq, hidden=config.hidden,
                 intermediate=config.intermediate, layers=config.layers)


def _segment_attention(q, k, v, seg):
    """Plain twin of the JAX encoder's ``_segment_attention``: dense
    attention with a block-diagonal (same-segment) mask, scores in the
    compute dtype with a -1e9 bias on other segments' and padding keys.
    The ragged forward runs K1 with ``seg`` instead
    (ops/attention.py flash_attention); this stays as an oracle."""
    same = (seg[:, :, None] == seg[:, None, :]) & (seg >= 0)[:, None, :]
    return _masked_attention(q, k, v, same[:, None])


@torch.no_grad()
def encode_ragged(model: Encoder, token_ids, doc_map, position_ids,
                  doc_seq, doc_off):
    """Ragged-packed forward -> (N, H) pooled, (optionally) L2-normalised
    float32 embeddings, one row per entry of ``doc_seq``.

    token_ids (B, W): packed tokens, many documents per row; doc_map (B, W)
    int32: each token's output row, -1 for padding — also K1's segment id,
    so documents sharing a row never attend to each other; position_ids
    (B, W): positions restarting at 0 for each document; doc_seq, doc_off
    (N,): each output row's (sequence, first-token offset), where cls
    pooling reads. Mean pooling sums each document's valid tokens in
    float32 (``index_add_``) and divides by max(count, 1). All tensors on
    the model's device. Attention is ops.attention.flash_attention with
    ``seg = doc_map``."""
    from pathway_tpu_torch.ops.attention import flash_attention

    config = model.config
    seg = doc_map.to(torch.int32).contiguous()
    mask = seg >= 0

    def attn(q, k, v, m):
        return flash_attention(q, k, v, m, seg)

    x = _forward(model, token_ids, mask, attn_fn=attn,
                 position_ids=position_ids)
    n_docs = doc_seq.shape[0]
    if config.pooling == "cls":
        pooled = x[doc_seq.long(), doc_off.long()].float()
    else:  # per-document mean over the packed tokens
        B, W = token_ids.shape
        flat = x.reshape(B * W, -1).float()
        rows = torch.where(mask, seg, n_docs).reshape(B * W).long()
        sums = flat.new_zeros((n_docs + 1, flat.shape[1])).index_add_(
            0, rows, flat)
        cnt = flat.new_zeros((n_docs + 1,)).index_add_(
            0, rows, mask.reshape(B * W).float())
        pooled = sums[:n_docs] / torch.clamp_min(cnt[:n_docs, None], 1.0)
    return _normalized(pooled, config)
