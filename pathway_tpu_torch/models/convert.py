"""JAX parameter tree -> the port's encoder state.

``params_from_jax(tree)`` takes the JAX package's encoder parameters as
numpy arrays (``init_params_host`` output, or ``jax.device_get(params)``)
and returns the state dict of models/encoder.py ``Encoder``, so both
packages compute the same function from the same weights. A
mixture-of-experts layer's ``moe`` leaves keep the JAX layout.
"""

from __future__ import annotations

import numpy as np
import torch

# JAX leaf -> nn.Linear name, per block: weights are (in, out) there and
# (out, in) in nn.Linear, so they transpose; biases copy as they are
_LINEARS = {
    "attn": (("wq", "bq", "wq"), ("wk", "bk", "wk"), ("wv", "bv", "wv"),
             ("wo", "bo", "wo")),
    "mlp": (("w1", "b1", "w1"), ("w2", "b2", "w2")),
}
# MoeBlock's parameters: named and laid out as the JAX leaves
_RAW = {"moe": ("router", "w1", "b1", "w2", "b2")}


def _t(a) -> torch.Tensor:
    """A contiguous float32 copy: the tree's arrays may be read-only
    (``jax.device_get``) and an optimizer's state is written in place."""
    return torch.tensor(np.asarray(a, dtype=np.float32))


def layers_state(layers: list, prefix: str = "") -> dict[str, torch.Tensor]:
    """State entries of an ``EncoderLayer`` list from the JAX tree's
    ``layers``, under ``{prefix}layers.{i}``."""
    state = {}
    for i, layer in enumerate(layers):
        for block, p in layer.items():
            pre = f"{prefix}layers.{i}.{block}"
            for w, b, name in _LINEARS.get(block, ()):
                state[f"{pre}.{name}.weight"] = _t(np.asarray(p[w]).T)
                state[f"{pre}.{name}.bias"] = _t(p[b])
            for name in _RAW.get(block, ()):
                state[f"{pre}.{name}"] = _t(p[name])
            state[f"{pre}.ln.weight"] = _t(p["ln_scale"])
            state[f"{pre}.ln.bias"] = _t(p["ln_bias"])
    return state


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (nested dicts and lists; any
    other value, tuples included, is a leaf) and the nodes at the same
    place in each of ``rest``: ``jax.tree.map`` over the JAX tree's
    containers."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def params_from_jax(tree: dict, prefix: str = "") -> dict[str, torch.Tensor]:
    """State dict (float32 CPU tensors) for ``Encoder.load_state_dict``,
    which casts each entry to its parameter's dtype and device; every key
    starts with ``prefix`` (an encoder inside another module)."""
    emb = tree["embeddings"]
    state = {
        f"{prefix}embeddings.token.weight": _t(emb["token"]),
        f"{prefix}embeddings.position.weight": _t(emb["position"]),
        f"{prefix}embeddings.token_type.weight": _t(emb["token_type"]),
        f"{prefix}embeddings.ln.weight": _t(emb["ln_scale"]),
        f"{prefix}embeddings.ln.bias": _t(emb["ln_bias"]),
    }
    state.update(layers_state(tree["layers"], prefix))
    return state
