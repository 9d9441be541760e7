"""The port's mixture-of-experts encoder (models/encoder.py MoeBlock,
_moe_block; models/convert.py's moe leaves; EncoderEmbedder over an MoE
config) against the JAX package's ``_moe_block`` / ``encode`` /
``encode_ragged`` / ``JaxEncoderEmbedder`` on EncoderConfig.tiny(
num_experts=4), same numpy weights and inputs."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathway_tpu.models import encoder as jenc
from pathway_tpu.xpacks.llm.embedders import JaxEncoderEmbedder
from pathway_tpu_torch.models import encoder as tenc
from pathway_tpu_torch.models.convert import params_from_jax
from pathway_tpu_torch.xpacks.llm.embedders import EncoderEmbedder

E = 4
_DTYPES = {"float32": (jnp.float32, torch.float32),
           "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TEXTS = ["hello world foo", "a",
         "some much longer text with many more words than the others "
         "to span packing widths", "mid size text here ok"] * 6
# routing ties: tokens whose top two gates differ by less than this are
# left out of the token-by-token routing comparison (and counted)
TIE = 1e-6


def _configs(dtype, **kw):
    jd, td = _DTYPES[dtype]
    return (jenc.EncoderConfig.tiny(num_experts=E, compute_dtype=jd, **kw),
            tenc.EncoderConfig.tiny(num_experts=E, compute_dtype=td, **kw))


def _row_cos(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.sum(a * b, 1) / (np.linalg.norm(a, axis=1)
                               * np.linalg.norm(b, axis=1))


def _tokens(B=4, S=24, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, 1024, size=(B, S)).astype(np.int32)
    lens = rng.integers(3, S + 1, size=B)
    lens[0] = S
    mask = np.arange(S)[None, :] < lens[:, None]
    return np.where(mask, ids, 0), mask


@pytest.mark.parametrize("gelu", ["tanh", "erf"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_block_matches_jax(dtype, gelu):
    jcfg, tcfg = _configs(dtype, gelu=gelu)
    params = tenc.init_params_host(5, tcfg)
    model = tenc.Encoder.from_params(params, tcfg, device="cpu")
    rng = np.random.default_rng(1)
    x32 = rng.normal(size=(3, 40, tcfg.hidden)).astype(np.float32)
    xj = jnp.asarray(x32).astype(jcfg.compute_dtype)
    xt = torch.from_numpy(x32).to(tcfg.compute_dtype)
    for i, layer in enumerate(params["layers"]):
        p = layer["moe"]
        ref = np.asarray(jenc._moe_block(xj, p, jcfg).astype(jnp.float32))
        got = tenc._moe_block(xt, model.layers[i].moe, tcfg).float().numpy()
        # routing: JAX's lines of _moe_block (router logits in f32 from the
        # block input, softmax, argmax) against the port's _moe_route
        jg = jax.nn.softmax(xj.astype(jnp.float32)
                            @ jnp.asarray(p["router"]), axis=-1)
        jtop = np.asarray(jnp.argmax(jg, axis=-1))
        gates, top = tenc._moe_route(xt, model.layers[i].moe.router)
        srt = np.sort(np.asarray(jg), axis=-1)
        tie = (srt[..., -1] - srt[..., -2]) < TIE
        assert tie.sum() == 0, f"{tie.sum()} near-tied tokens"
        np.testing.assert_array_equal(top.numpy(), jtop)
        assert len(np.unique(jtop)) == E  # every expert routes tokens
        np.testing.assert_allclose(gates.numpy(), np.asarray(jg), rtol=0,
                                   atol=1e-6)
        if dtype == "float32":
            # f32 throughout: summation order only
            np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
        else:
            # bf16 rounds at different places in the two frameworks: within
            # two bf16 steps at the outputs' largest magnitude (|y| < 4,
            # a step of 2^-6; the tanh GELU differs by one step at most)
            assert np.abs(ref).max() < 4
            np.testing.assert_allclose(got, ref, rtol=0, atol=2 * 2 ** -6)
            assert _row_cos(got.reshape(-1, tcfg.hidden),
                            ref.reshape(-1, tcfg.hidden)).min() >= 0.999


def test_moe_route_picks_the_first_maximum_and_keeps_gradients():
    """Ties go to the first expert in both packages, and the router
    learns through gate_val (the one-hot carries no gradient)."""
    _, tcfg = _configs("float32")
    params = tenc.init_params_host(2, tcfg)
    model = tenc.Encoder.from_params(params, tcfg, device="cpu",
                                     trainable=True)
    moe = model.layers[0].moe
    with torch.no_grad():
        moe.router.zero_()  # every gate 1/E: a four-way tie
    x = torch.randn(2, 5, tcfg.hidden)
    _, top = tenc._moe_route(x, moe.router)
    jtop = jnp.argmax(jnp.full((2, 5, E), 0.25), axis=-1)
    assert (top == 0).all() and (np.asarray(jtop) == 0).all()
    with torch.no_grad():
        moe.router.copy_(torch.from_numpy(params["layers"][0]["moe"]
                                          ["router"]))
    tenc._moe_block(x, moe, tcfg).sum().backward()
    assert moe.router.grad is not None and moe.router.grad.abs().max() > 0
    assert moe.w1.grad.abs().max() > 0


def test_params_from_jax_maps_moe_leaves():
    _, tcfg = _configs("float32")
    params = tenc.init_params_host(1, tcfg)
    state = params_from_jax(params)
    model = tenc.Encoder.from_params(params, tcfg, device="cpu")
    assert set(model.state_dict()) == set(state)
    for i, layer in enumerate(params["layers"]):
        moe = model.layers[i].moe
        assert not hasattr(model.layers[i], "mlp")
        for name in ("router", "w1", "b1", "w2", "b2"):
            np.testing.assert_array_equal(
                getattr(moe, name).detach().numpy(), layer["moe"][name])
        np.testing.assert_array_equal(moe.ln.weight.detach().numpy(),
                                      layer["moe"]["ln_scale"])
    # a bf16 serving module: expert weights in bf16, the router in f32
    _, bcfg = _configs("bfloat16")
    served = tenc.Encoder.from_params(params, bcfg, device="cpu")
    assert served.layers[0].moe.w1.dtype == torch.bfloat16
    assert served.layers[0].moe.router.dtype == torch.float32


def test_init_params_host_moe_bit_identical():
    jcfg, tcfg = _configs("float32")
    a = jax.tree_util.tree_leaves_with_path(jenc.init_params_host(4, jcfg))
    b = jax.tree_util.tree_leaves_with_path(tenc.init_params_host(4, tcfg))
    assert [p for p, _ in a] == [p for p, _ in b]
    for (path, x), (_, y) in zip(a, b):
        assert np.array_equal(x, y), path


@pytest.mark.parametrize("pooling", ["cls", "mean"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encode_moe_matches_jax(dtype, pooling):
    jcfg, tcfg = _configs(dtype, pooling=pooling)
    params = tenc.init_params_host(7, tcfg)
    model = tenc.Encoder.from_params(params, tcfg, device="cpu")
    ids, mask = _tokens(seed=3)
    ref = np.asarray(jenc.encode(params, jnp.asarray(ids), jnp.asarray(mask),
                                 config=jcfg))
    for attn_fn in (None, tenc.dense_attention):
        got = tenc.encode(model, torch.from_numpy(ids).long(),
                          torch.from_numpy(mask), attn_fn=attn_fn).numpy()
        assert np.isfinite(got).all()
        if dtype == "float32":
            # f32 throughout (erf GELU): summation order only
            np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)
        else:
            assert _row_cos(got, ref).min() >= 0.999


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encode_ragged_moe_matches_jax(dtype):
    jcfg, tcfg = _configs(dtype)
    params = tenc.init_params_host(3, tcfg)
    emb = EncoderEmbedder(config=tcfg, params=params, ragged=True,
                          max_len=64, device="cpu")
    chunks = emb.pack_ragged(TEXTS)
    for args, n_docs, n_pad in chunks:
        ref = np.asarray(jenc.encode_ragged(
            params, *(jnp.asarray(a) for a in args), config=jcfg))
        got = emb.ragged_device_producer(emb.model, *args).numpy()
        assert got.shape == ref.shape == (n_pad, tcfg.hidden)
        if dtype == "float32":
            np.testing.assert_allclose(got[:n_docs], ref[:n_docs], rtol=0,
                                       atol=1e-4)
        else:
            assert _row_cos(got[:n_docs], ref[:n_docs]).min() >= 0.999


@pytest.mark.parametrize("ragged", [False, True])
def test_moe_embedder_matches_jax(ragged):
    """EncoderEmbedder(config=tiny(num_experts=4), device="cpu") against
    JaxEncoderEmbedder on the same weights, padded and ragged."""
    jcfg, tcfg = _configs("float32")
    params = tenc.init_params_host(9, tcfg)
    j = JaxEncoderEmbedder(config=jcfg, params=params, ragged=ragged,
                           max_len=64)
    t = EncoderEmbedder(config=tcfg, params=params, ragged=ragged,
                        max_len=64, device="cpu")
    got, ref = t.embed_batch(TEXTS), np.asarray(j.embed_batch(TEXTS))
    assert got.shape == ref.shape == (len(TEXTS), tcfg.hidden)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)
    assert t.get_embedding_dimension() == tcfg.hidden


def test_moe_serving_config_is_bge_small_width():
    cfg = tenc.EncoderConfig.bge_small(num_experts=4)
    assert dataclasses.replace(cfg, num_experts=0) == \
        tenc.EncoderConfig.bge_small()
    with torch.device("meta"):
        model = tenc.Encoder(cfg)
    w1 = model.layers[0].moe.w1
    assert tuple(w1.shape) == (4, 384, 1536) and w1.dtype == torch.bfloat16
