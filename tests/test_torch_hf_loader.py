"""The port's HF checkpoint loader (pathway_tpu_torch/models/hf_loader.py)
against the JAX package's and against transformers' own BertModel.

Every checkpoint is written here, offline: a small random
``transformers.BertModel`` saved as ``model.safetensors`` or
``pytorch_model.bin`` with a ``vocab.txt`` beside it
(tests/test_hf_loader.py's checkpoint). Held: the loaded parameter tree
equals the JAX package's load of the same directory array for array
(exact), config and tokenizer equal; the port's float32 forward matches
the BertModel's CLS output at rtol = atol = 2e-4 (the JAX test's
tolerance) and the JAX forward at the same tolerance;
``EncoderEmbedder(model=dir, device="cpu")`` runs the loaded model (bf16:
row cosine >= 0.999 against the BertModel); the missing-checkpoint
message is the JAX package's. A golden test against real BGE-small weights
runs only when that checkpoint is in the local HF cache."""

import json

import numpy as np
import pytest
import torch

from pathway_tpu_torch.models import encoder as tenc
from pathway_tpu_torch.models.hf_loader import (find_local_checkpoint,
                                                load_checkpoint, load_model)
from pathway_tpu_torch.xpacks.llm.embedders import EncoderEmbedder

TOL = dict(rtol=2e-4, atol=2e-4)
VOCAB_WORDS = ["the", "quick", "brown", "fox", "jump", "##ed", "##s",
               "over", "lazy", "dog", "un", "##believ", "##able"]
TEXTS = ["the quick brown fox", "unbelievable jumps over the lazy dog",
         "fox", "the the the dog jumped"]


def _make_checkpoint(tmp_path, save_format, pooling=None):
    transformers = pytest.importorskip("transformers")
    cfg = transformers.BertConfig(
        vocab_size=64, hidden_size=32, num_hidden_layers=2,
        num_attention_heads=4, intermediate_size=48,
        max_position_embeddings=64, type_vocab_size=2)
    torch.manual_seed(0)
    model = transformers.BertModel(cfg)
    model.eval()
    d = tmp_path / "ckpt"
    model.save_pretrained(str(d), safe_serialization=(save_format == "st"))
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + VOCAB_WORDS
    vocab += [f"tok{i}" for i in range(64 - len(vocab))]
    (d / "vocab.txt").write_text("\n".join(vocab) + "\n")
    if pooling is not None:
        (d / "1_Pooling").mkdir()
        (d / "1_Pooling" / "config.json").write_text(json.dumps(
            {f"pooling_mode_{pooling}": True}))
    return model, d


def _bert_cls(model, ids, mask):
    with torch.no_grad():
        out = model(input_ids=torch.tensor(ids, dtype=torch.long),
                    attention_mask=torch.tensor(mask, dtype=torch.long))
    want = out.last_hidden_state.numpy()[:, 0]
    return want / np.linalg.norm(want, axis=1, keepdims=True)


def _same_tree(a, b, path="params"):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _same_tree(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same_tree(x, y, f"{path}[{i}]")
    else:
        assert isinstance(a, np.ndarray) and a.dtype == np.float32, path
        np.testing.assert_array_equal(a, np.asarray(b), err_msg=path)


@pytest.mark.parametrize("save_format", ["st", "bin"])
def test_tree_config_and_tokenizer_equal_jax(tmp_path, save_format):
    from pathway_tpu.models import hf_loader as jhf

    _, d = _make_checkpoint(tmp_path, save_format)
    params, config, tok = load_checkpoint(str(d))
    jparams, jconfig, jtok = jhf.load_checkpoint(str(d))
    _same_tree(params, jparams)
    for f in ("vocab_size", "hidden", "layers", "heads", "intermediate",
              "max_len", "type_vocab_size", "layer_norm_eps", "pooling"):
        assert getattr(config, f) == getattr(jconfig, f), f
    assert config.compute_dtype == torch.bfloat16
    assert tok.vocab_list == jtok.vocab_list and tok.max_len == 64
    ids, mask = tok.batch(TEXTS, pad_to=16)
    jids, jmask = jtok.batch(TEXTS, pad_to=16)
    np.testing.assert_array_equal(ids, jids)
    np.testing.assert_array_equal(mask, jmask)


@pytest.mark.parametrize("save_format", ["st", "bin"])
def test_f32_forward_matches_bert_and_jax(tmp_path, save_format):
    import jax.numpy as jnp

    from pathway_tpu.models import hf_loader as jhf
    from pathway_tpu.models.encoder import encode as jencode

    model, d = _make_checkpoint(tmp_path, save_format)
    params, config, tok = load_checkpoint(str(d),
                                          compute_dtype=torch.float32)
    assert config.hidden == 32 and config.layers == 2
    assert tok is not None and tok.vocab_size == 64
    ids, mask = tok.batch(TEXTS, pad_to=16)
    enc = tenc.Encoder.from_params(params, config, device="cpu")
    got = tenc.encode(enc, torch.from_numpy(ids).long(),
                      torch.from_numpy(mask)).numpy()
    want = _bert_cls(model, ids, mask)
    assert got.shape == want.shape == (len(TEXTS), 32)
    np.testing.assert_allclose(got, want, **TOL)
    jparams, jconfig, _ = jhf.load_checkpoint(str(d),
                                              compute_dtype=jnp.float32)
    jgot = np.asarray(jencode(jparams, jnp.asarray(ids), jnp.asarray(mask),
                              config=jconfig))
    np.testing.assert_allclose(got, jgot, **TOL)


@pytest.mark.parametrize("pooling,want", [("mean_tokens", "mean"),
                                          ("cls_token", "cls"),
                                          (None, "cls")])
def test_pooling_detected_as_jax(tmp_path, pooling, want):
    from pathway_tpu.models import hf_loader as jhf

    _, d = _make_checkpoint(tmp_path, "st", pooling=pooling)
    _, config, _ = load_checkpoint(str(d))
    _, jconfig, _ = jhf.load_checkpoint(str(d))
    assert config.pooling == jconfig.pooling == want


def test_embedder_loads_a_checkpoint_directory(tmp_path):
    model, d = _make_checkpoint(tmp_path, "bin")
    emb = EncoderEmbedder(model=str(d), device="cpu")
    params, config, tok = load_checkpoint(str(d))
    assert emb.config == config and emb.tokenizer.vocab_list == \
        tok.vocab_list
    assert emb.max_len == 64 and emb.get_embedding_dimension() == 32
    got = emb.embed_batch(TEXTS)
    # the same weights through the encoder directly: bit for bit
    ids, lens = emb.pack_tokens(TEXTS)
    ref = tenc.Encoder.from_params(params, config, device="cpu")
    lens_t = torch.from_numpy(lens)
    mask = torch.arange(ids.shape[1])[None, :] < lens_t[:, None]
    np.testing.assert_array_equal(
        got, tenc.encode(ref, torch.from_numpy(ids).long(), mask).numpy())
    # bf16 against transformers' f32 model: the serving tolerance
    tids, tmask = tok.batch(TEXTS, pad_to=ids.shape[1])
    want = _bert_cls(model, tids, tmask)
    cos = np.sum(got * want, 1) / (np.linalg.norm(got, axis=1)
                                   * np.linalg.norm(want, axis=1))
    assert cos.min() >= 0.999, cos


def test_find_local_checkpoint_in_an_hf_cache(tmp_path, monkeypatch):
    from pathway_tpu.models import hf_loader as jhf

    snap = tmp_path / "hub" / "models--org--tiny-bert" / "snapshots"
    (snap / "old").mkdir(parents=True)
    (snap / "new").mkdir()
    (snap / "new" / "config.json").write_text("{}")
    monkeypatch.setenv("HF_HOME", str(tmp_path))
    assert find_local_checkpoint("org/tiny-bert") == \
        jhf.find_local_checkpoint("org/tiny-bert") == str(snap / "new")
    assert find_local_checkpoint("org/absent") is None
    assert find_local_checkpoint(str(tmp_path)) == str(tmp_path)


def test_missing_checkpoint_message_equals_jax(tmp_path, monkeypatch):
    from pathway_tpu.models import hf_loader as jhf

    monkeypatch.setenv("HF_HOME", str(tmp_path))
    with pytest.raises(FileNotFoundError, match="no local checkpoint") as e:
        load_model("nonexistent/model-xyz")
    with pytest.raises(FileNotFoundError) as je:
        jhf.load_model("nonexistent/model-xyz")
    assert str(e.value) == str(je.value)
    with pytest.raises(FileNotFoundError, match="no local checkpoint"):
        EncoderEmbedder(model="nonexistent/model-xyz", device="cpu")
    (tmp_path / "empty").mkdir()
    (tmp_path / "empty" / "config.json").write_text("{}")
    with pytest.raises(FileNotFoundError,
                       match="no model.safetensors or pytorch_model.bin"):
        from pathway_tpu_torch.models.hf_loader import _read_state_dict

        _read_state_dict(str(tmp_path / "empty"))


def test_bge_small_golden_if_cached():
    """Real weights: runs only when BGE-small is in the local HF cache
    (nothing is downloaded)."""
    transformers = pytest.importorskip("transformers")
    path = find_local_checkpoint("BAAI/bge-small-en-v1.5")
    if path is None:
        pytest.skip("BAAI/bge-small-en-v1.5 not in the local HF cache")
    params, config, tok = load_model("BAAI/bge-small-en-v1.5",
                                     compute_dtype=torch.float32)
    assert config.hidden == 384 and config.layers == 12
    ids, mask = tok.batch(["a photo of a cat"], pad_to=16)
    enc = tenc.Encoder.from_params(params, config, device="cpu")
    got = tenc.encode(enc, torch.from_numpy(ids).long(),
                      torch.from_numpy(mask)).numpy()
    st = transformers.AutoModel.from_pretrained(path)
    st.eval()
    np.testing.assert_allclose(got, _bert_cls(st, ids, mask), rtol=2e-3,
                               atol=2e-3)
