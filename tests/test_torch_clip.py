"""The port's CLIP dual encoder (models/clip.py) and ClipEmbedder
(xpacks/llm/embedders.py) against the JAX package's models/clip.py and
ClipEmbedder on ClipConfig.tiny(), with the JAX package's parameters
carried across (clip_params_from_jax) and the same numpy pixels and
tokens."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathway_tpu.models import clip as jclip
from pathway_tpu.models import encoder as jenc
from pathway_tpu.xpacks.llm.embedders import ClipEmbedder as JaxClipEmbedder
from pathway_tpu_torch.models import clip as tclip
from pathway_tpu_torch.models import encoder as tenc
from pathway_tpu_torch.xpacks.llm.embedders import ClipEmbedder

_DTYPES = {"float32": (jnp.float32, torch.float32),
           "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _configs(dtype="float32"):
    jd, td = _DTYPES[dtype]
    return (jclip.ClipConfig.tiny(
                compute_dtype=jd, text=jenc.EncoderConfig.tiny(
                    pooling="cls", normalize=False, compute_dtype=jd)),
            tclip.ClipConfig.tiny(
                compute_dtype=td, text=tenc.EncoderConfig.tiny(
                    pooling="cls", normalize=False, compute_dtype=td)))


def _pair(dtype="float32", trainable=False, seed=0):
    jcfg, tcfg = _configs(dtype)
    params = jax.device_get(jclip.init_clip_params(jax.random.PRNGKey(seed),
                                                   jcfg))
    model = tclip.ClipModel.from_params(params, tcfg, device="cpu",
                                        trainable=trainable)
    return jcfg, tcfg, params, model


def _batch(B=4, S=12, seed=0, image=16):
    rng = np.random.default_rng(seed)
    lens = rng.integers(3, S + 1, size=B)
    mask = np.arange(S)[None, :] < lens[:, None]
    return {"pixels": rng.random((B, image, image, 3)).astype(np.float32),
            "ids": np.where(mask, rng.integers(1, 1024, (B, S)), 0)
            .astype(np.int32),
            "mask": mask}


def _tensors(batch):
    return {"pixels": torch.from_numpy(batch["pixels"]),
            "ids": torch.from_numpy(batch["ids"]).long(),
            "mask": torch.from_numpy(batch["mask"])}


def _leaves(tree):
    return [(jax.tree_util.keystr(p), np.shape(x))
            for p, x in jax.tree_util.tree_leaves_with_path(tree)]


def test_patchify_matches_jax():
    jcfg, tcfg = _configs()
    px = np.random.default_rng(0).random((3, 16, 16, 3)).astype(np.float32)
    ref = np.asarray(jclip._patchify(jnp.asarray(px), jcfg))
    got = tclip._patchify(torch.from_numpy(px), tcfg).numpy()
    assert got.shape == (3, tcfg.n_patches, 4 * 4 * 3)
    np.testing.assert_array_equal(got, ref)


def test_init_clip_params_has_the_jax_tree():
    """The port's seeded tree has the JAX tree's paths and shapes (its
    values come from numpy, not jax.random) and loads into ClipModel."""
    jcfg, tcfg = _configs()
    ours = tclip.init_clip_params(0, tcfg)
    assert _leaves(ours) == _leaves(jclip.init_clip_params(
        jax.random.PRNGKey(0), jcfg))
    again = tclip.init_clip_params(0, tcfg)
    assert all(np.array_equal(a, b) for a, b in zip(
        jax.tree_util.tree_leaves(ours), jax.tree_util.tree_leaves(again)))
    model = tclip.ClipModel.from_params(ours, tcfg, device="cpu")
    state = tclip.clip_params_from_jax(ours)
    assert set(model.state_dict()) == set(state)
    np.testing.assert_array_equal(
        model.vision.embeddings.patch.weight.numpy().T,
        ours["vision"]["embeddings"]["patch_w"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_towers_match_jax(dtype):
    jcfg, _, params, model = _pair(dtype)
    b = _batch()
    t = _tensors(b)
    with torch.no_grad():
        img = tclip.encode_image(model, t["pixels"]).numpy()
        txt = tclip.encode_text(model, t["ids"], t["mask"]).numpy()
    jimg = np.asarray(jclip.encode_image(params, b["pixels"], config=jcfg))
    jtxt = np.asarray(jclip.encode_text(params, b["ids"], b["mask"],
                                        config=jcfg))
    # L2-normalised outputs: f32 differs by summation order only; bf16
    # rounds in different places in the two frameworks (2^-8 steps)
    atol = 1e-5 if dtype == "float32" else 4 * 2 ** -8
    np.testing.assert_allclose(img, jimg, rtol=0, atol=atol)
    np.testing.assert_allclose(txt, jtxt, rtol=0, atol=atol)


def test_clip_loss_matches_jax():
    jcfg, _, params, model = _pair()
    b = _batch(seed=1)
    ref = float(jclip.clip_loss(params, b, config=jcfg))
    got = float(tclip.clip_loss(model, _tensors(b)))
    assert got == pytest.approx(ref, rel=1e-5)
    # the logit scale is clipped to [-5, log 100] before its exp
    for value in (9.0, -7.0):
        p2 = dict(params, logit_scale=np.float32(value))
        m2 = tclip.ClipModel.from_params(p2, model.config, device="cpu")
        assert float(tclip.clip_loss(m2, _tensors(b))) == pytest.approx(
            float(jclip.clip_loss(p2, b, config=jcfg)), rel=1e-5)


def test_three_adam_steps_match_jax():
    """3 clip_train_steps against JAX's (optax.adam(1e-3)), f32: the
    losses to rtol 1e-5 and the parameters to atol 5e-5 (5% of one step's
    lr: Adam's normalised update carries the f32 gradient noise)."""
    jcfg, _, params, model = _pair(trainable=True, seed=1)
    b = _batch(seed=2)
    opt = jclip.make_clip_optimizer()
    ost, p = opt.init(params), params
    topt = tclip.make_clip_optimizer()(model.parameters())
    jl, tl = [], []
    for _ in range(3):
        p, ost, loss = jclip.clip_train_step(p, ost, b, config=jcfg,
                                             optimizer=opt)
        _, _, tloss = tclip.clip_train_step(model, topt, b)
        jl.append(float(loss))
        tl.append(float(tloss))
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    ref = tclip.clip_params_from_jax(jax.device_get(p))
    for name, q in model.named_parameters():
        np.testing.assert_allclose(q.detach().numpy(), ref[name].numpy(),
                                   rtol=0, atol=5e-5, err_msg=name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_clip_embedder_matches_jax(dtype):
    jcfg, tcfg, params, _ = _pair(dtype, seed=3)
    j = JaxClipEmbedder(config=jcfg, params=params)
    t = ClipEmbedder(config=tcfg, params=params, device="cpu")
    texts = ["a photo of a cat", "", "two dogs playing in the park " * 3]
    rng = np.random.default_rng(5)
    images = [rng.random((16, 16, 3)).astype(np.float32) for _ in range(3)]
    atol = 1e-5 if dtype == "float32" else 4 * 2 ** -8
    got, ref = t.embed_text_batch(texts), np.asarray(j.embed_text_batch(texts))
    assert got.shape == ref.shape == (3, tcfg.embed_dim)
    np.testing.assert_allclose(got, ref, rtol=0, atol=atol)
    got = t.embed_image_batch(images)
    np.testing.assert_allclose(got, np.asarray(j.embed_image_batch(images)),
                               rtol=0, atol=atol)
    # the UDF bodies: row views of one batch
    rows = t.__wrapped__(texts)
    assert len(rows) == 3 and np.array_equal(rows[0], t.embed_text_batch(
        texts)[0])
    img_udf = t.image()
    assert img_udf.get_embedding_dimension() == t.get_embedding_dimension() \
        == tcfg.embed_dim
    np.testing.assert_array_equal(np.stack(img_udf.__wrapped__(images)),
                                  t.embed_image_batch(images))


def test_clip_embedder_pads_to_the_jax_buckets(monkeypatch):
    _, tcfg, params, _ = _pair()
    t = ClipEmbedder(config=tcfg, params=params, device="cpu")
    seen = []
    real = tclip.encode_text

    def spy(model, ids, mask):
        seen.append(ids.shape[1])
        return real(model, ids, mask)

    monkeypatch.setattr(tclip, "encode_text", spy)
    for words in (2, 50, 500):
        t.embed_text_batch([" ".join(["w"] * words)])
    assert seen == [32, 64, 128]  # tiny's text max_len is 128


def test_load_image_needs_pil_only_when_called():
    """load_image imports PIL inside the call (the card machine has
    none); decoding a PNG gives the model's (H, W, C) floats in [0, 1]."""
    pil = pytest.importorskip("PIL.Image")
    import io

    cfg = dataclasses.replace(tclip.ClipConfig.tiny(), image_size=8)
    buf = io.BytesIO()
    pil.new("RGB", (5, 3), (255, 0, 51)).save(buf, format="PNG")
    px = tclip.load_image(buf.getvalue(), config=cfg)
    ref = jclip.load_image(buf.getvalue(), config=cfg)
    assert px.shape == (8, 8, 3) and px.dtype == np.float32
    np.testing.assert_array_equal(px, ref)
