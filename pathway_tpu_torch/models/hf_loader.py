"""Load HuggingFace BERT-family checkpoints (BGE, MiniLM, E5) for the
port's encoder — port of pathway_tpu/models/hf_loader.py.

A checkpoint's weights become the JAX-layout parameter tree as float32
numpy arrays: the tree ``Encoder.from_params`` and
``convert.params_from_jax`` take. torch ``Linear`` weights are stored
``(out, in)``; the tree holds them ``(in, out)``, so they are transposed
here and ``convert.py`` transposes them back. The checkpoint's
``vocab.txt`` drives the WordPiece tokenizer (models/tokenizer.py).

Everything is offline: ``load_checkpoint`` takes a local directory, and
``find_local_checkpoint`` resolves a model name against the local HF cache
only. ``model.safetensors`` is read with the ``safetensors`` package,
imported in the call that needs it; ``pytorch_model.bin`` with
``torch.load(..., weights_only=True)``.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch


def find_local_checkpoint(model_name: str) -> str | None:
    """Resolve a model name (e.g. 'BAAI/bge-small-en-v1.5') to a local HF
    cache snapshot directory, or None. Never touches the network."""
    if os.path.isdir(model_name):
        return model_name
    cache = os.environ.get(
        "HF_HOME", os.path.expanduser("~/.cache/huggingface"))
    repo_dir = os.path.join(
        cache, "hub", "models--" + model_name.replace("/", "--"))
    snapshots = os.path.join(repo_dir, "snapshots")
    if not os.path.isdir(snapshots):
        return None
    candidates = sorted(
        (os.path.join(snapshots, d) for d in os.listdir(snapshots)),
        key=os.path.getmtime, reverse=True)
    for c in candidates:
        if os.path.exists(os.path.join(c, "config.json")):
            return c
    return None


def _numpy(t: torch.Tensor) -> np.ndarray:
    # numpy has no bfloat16: floating tensors come out as float32, the
    # precision the tree holds anyway
    return t.float().numpy() if t.is_floating_point() else t.numpy()


def _read_state_dict(path: str) -> dict[str, np.ndarray]:
    st_path = os.path.join(path, "model.safetensors")
    if os.path.exists(st_path):
        from safetensors.torch import load_file

        return {k: _numpy(v) for k, v in load_file(st_path).items()}
    bin_path = os.path.join(path, "pytorch_model.bin")
    if os.path.exists(bin_path):
        sd = torch.load(bin_path, map_location="cpu", weights_only=True)
        return {k: _numpy(v) for k, v in sd.items()}
    raise FileNotFoundError(
        f"no model.safetensors or pytorch_model.bin under {path}")


def _strip_prefix(sd: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
    # BertModel checkpoints may key as "bert.embeddings..." or
    # "embeddings..." depending on how they were saved
    if any(k.startswith("bert.") for k in sd):
        return {k[len("bert."):]: v for k, v in sd.items()
                if k.startswith("bert.")}
    return sd


def _detect_pooling(path: str) -> str:
    """sentence-transformers keeps pooling in 1_Pooling/config.json; BGE
    uses CLS. Fall back to 'cls'."""
    pool_cfg = os.path.join(path, "1_Pooling", "config.json")
    if os.path.exists(pool_cfg):
        with open(pool_cfg) as f:
            cfg = json.load(f)
        if cfg.get("pooling_mode_mean_tokens"):
            return "mean"
        if cfg.get("pooling_mode_cls_token"):
            return "cls"
    return "cls"


def load_checkpoint(path: str, *, compute_dtype: torch.dtype | None = None,
                    pooling: str | None = None):
    """Local checkpoint dir → (params, EncoderConfig, WordPieceTokenizer).

    ``params`` is the JAX-layout tree of float32 numpy arrays
    (models/encoder.py ``init_params_host``'s layout), so
    ``Encoder.from_params(params, config)`` runs the real model. The
    tokenizer is None when the directory has no ``vocab.txt``.
    """
    from pathway_tpu_torch.models.encoder import EncoderConfig
    from pathway_tpu_torch.models.tokenizer import WordPieceTokenizer

    with open(os.path.join(path, "config.json")) as f:
        hf = json.load(f)
    kw = {}
    if compute_dtype is not None:
        kw["compute_dtype"] = compute_dtype
    config = EncoderConfig(
        vocab_size=hf["vocab_size"],
        hidden=hf["hidden_size"],
        layers=hf["num_hidden_layers"],
        heads=hf["num_attention_heads"],
        intermediate=hf["intermediate_size"],
        max_len=hf["max_position_embeddings"],
        type_vocab_size=hf.get("type_vocab_size", 2),
        layer_norm_eps=hf.get("layer_norm_eps", 1e-12),
        pooling=pooling or _detect_pooling(path),
        **kw)

    sd = _strip_prefix(_read_state_dict(path))

    def get(name: str) -> np.ndarray:
        arr = sd.get(name)
        if arr is None:
            raise KeyError(
                f"checkpoint {path} is missing tensor {name!r} — not a "
                "BERT-family encoder?")
        return np.asarray(arr, dtype=np.float32)

    def linear(prefix: str):
        # torch Linear: weight (out, in) — the tree holds (in, out)
        return (np.ascontiguousarray(get(prefix + ".weight").T),
                get(prefix + ".bias"))

    params: dict = {
        "embeddings": {
            "token": get("embeddings.word_embeddings.weight"),
            "position": get("embeddings.position_embeddings.weight"),
            "token_type": get("embeddings.token_type_embeddings.weight"),
            "ln_scale": get("embeddings.LayerNorm.weight"),
            "ln_bias": get("embeddings.LayerNorm.bias"),
        },
        "layers": [],
    }
    for i in range(config.layers):
        pre = f"encoder.layer.{i}."
        wq, bq = linear(pre + "attention.self.query")
        wk, bk = linear(pre + "attention.self.key")
        wv, bv = linear(pre + "attention.self.value")
        wo, bo = linear(pre + "attention.output.dense")
        w1, b1 = linear(pre + "intermediate.dense")
        w2, b2 = linear(pre + "output.dense")
        params["layers"].append({
            "attn": {
                "wq": wq, "bq": bq, "wk": wk, "bk": bk,
                "wv": wv, "bv": bv, "wo": wo, "bo": bo,
                "ln_scale": get(pre + "attention.output.LayerNorm.weight"),
                "ln_bias": get(pre + "attention.output.LayerNorm.bias"),
            },
            "mlp": {
                "w1": w1, "b1": b1, "w2": w2, "b2": b2,
                "ln_scale": get(pre + "output.LayerNorm.weight"),
                "ln_bias": get(pre + "output.LayerNorm.bias"),
            },
        })

    vocab_path = os.path.join(path, "vocab.txt")
    tokenizer = None
    if os.path.exists(vocab_path):
        do_lower = hf.get("do_lower_case", True)
        tok_cfg = os.path.join(path, "tokenizer_config.json")
        if os.path.exists(tok_cfg):
            with open(tok_cfg) as f:
                do_lower = json.load(f).get("do_lower_case", do_lower)
        tokenizer = WordPieceTokenizer.from_vocab_file(
            vocab_path, do_lower=do_lower, max_len=config.max_len)
    return params, config, tokenizer


def load_model(model_name: str = "BAAI/bge-small-en-v1.5", **kw):
    """Name → local cache lookup → load_checkpoint. Raises with a clear
    message when the checkpoint is not on disk (nothing is downloaded)."""
    path = find_local_checkpoint(model_name)
    if path is None:
        raise FileNotFoundError(
            f"{model_name}: no local checkpoint (searched the HF cache); "
            "download it on a connected machine or pass a directory path")
    return load_checkpoint(path, **kw)
