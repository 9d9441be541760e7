"""The port's GPipe pipeline (pathway_tpu_torch/parallel/pipeline.py)
against the JAX package's (pathway_tpu/parallel/pipeline.py): the
stacked stage parameters exactly; the pipelined encoder blocks at the JAX
tests' (stages, micro-batches) (tests/test_pipeline.py) within their
tolerance (3e-2: bf16 blocks), and bit for bit against the port's own
sequential blocks, since the schedule does not change a micro-batch's
arithmetic; and the same errors for an uneven layer split and more than
one side input."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathway_tpu.models import encoder as jenc
from pathway_tpu_torch.models import encoder as tenc
from pathway_tpu_torch.parallel.mesh import Mesh

jpipe = importlib.import_module("pathway_tpu.parallel.pipeline")
tpipe = importlib.import_module("pathway_tpu_torch.parallel.pipeline")


def _pipe_meshes(n):
    return (jax.sharding.Mesh(np.asarray(jax.devices()[:n]), ("pipe",)),
            Mesh([torch.device("cpu")] * n, ("pipe",)))


def _configs(layers=4):
    return (jenc.EncoderConfig.tiny(layers=layers, heads=4),
            tenc.EncoderConfig.tiny(layers=layers, heads=4))


def _params(jcfg, seed=0):
    return jax.device_get(jenc.init_params(jax.random.PRNGKey(seed), jcfg))


def test_stack_stage_params_matches_jax():
    jcfg, _ = _configs()
    layers = _params(jcfg)["layers"]
    want = jax.tree.leaves_with_path(jpipe.stack_stage_params(layers))
    got = tpipe.stack_stage_params(layers)
    assert len(want) == 10 + 6  # attn and mlp leaves, 4 layers each
    for path, leaf in want:
        node = got
        for key in path:
            node = node[key.key]
        assert node.dtype == torch.float32 and node.shape[0] == 4
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))


@pytest.mark.parametrize("n_stages,n_micro", [(2, 4), (4, 4), (4, 7)])
def test_pipeline_matches_jax_and_sequential(n_stages, n_micro):
    jcfg, tcfg = _configs()
    params = _params(jcfg)
    jm, tm = _pipe_meshes(n_stages)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(n_micro, 2, 8, jcfg.hidden)).astype(np.float32)
    mask = np.ones((2, 8), bool)
    mask[1, 6:] = False
    want = jpipe.pipeline_encoder_blocks(jm, jcfg)(
        jpipe.stack_stage_params(params["layers"]), jnp.asarray(x),
        jnp.asarray(mask))
    xt, mt = torch.from_numpy(x), torch.from_numpy(mask)
    got = tpipe.pipeline_encoder_blocks(tm, tcfg)(
        tpipe.stack_stage_params(params["layers"]), xt, mt)
    assert got.shape == x.shape and got.dtype == torch.bfloat16
    # JAX's own bound for its pipeline against its sequential blocks
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=3e-2, rtol=3e-2)
    seq = torch.stack([tpipe.sequential_encoder_blocks(
        params["layers"], xt[i], mt, tcfg) for i in range(n_micro)])
    assert torch.equal(got, seq)


def test_sequential_blocks_match_jax():
    jcfg, tcfg = _configs()
    params = _params(jcfg, seed=1)
    x = np.random.default_rng(1).normal(size=(2, 8, 64)).astype(np.float32)
    mask = np.ones((2, 8), bool)
    want = jpipe.sequential_encoder_blocks(params["layers"], jnp.asarray(x),
                                           jnp.asarray(mask), jcfg)
    got = tpipe.sequential_encoder_blocks(params["layers"],
                                          torch.from_numpy(x),
                                          torch.from_numpy(mask), tcfg)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=3e-2, rtol=3e-2)


def test_pipeline_runs_any_block_fn():
    """make_pipeline_fn on its own: a block that adds its layer's value
    and the side input, so every stage's layers run once, in order."""
    _, tm = _pipe_meshes(2)
    run = tpipe.make_pipeline_fn(tm, lambda w, x, extra: x * 2 + w + extra)
    stacked = torch.arange(4.0)
    xs = torch.ones(5, 3)
    got = run(stacked, xs, torch.tensor(10.0))
    want = xs.clone()
    for w in range(4):
        want = want * 2 + w + 10
    assert torch.equal(got, want)
    no_extra = run(stacked, xs)  # the JAX package packs a zero scalar
    assert torch.equal(no_extra, want - 10 * (2 ** 4 - 1))


def test_uneven_layer_split_raises_like_jax():
    jcfg, tcfg = _configs(layers=3)
    params = _params(jcfg)
    jm, tm = _pipe_meshes(2)
    x = np.zeros((2, 1, 4, jcfg.hidden), np.float32)
    mask = np.ones((1, 4), bool)
    with pytest.raises(ValueError) as jerr:
        jpipe.pipeline_encoder_blocks(jm, jcfg)(
            jpipe.stack_stage_params(params["layers"]), jnp.asarray(x),
            jnp.asarray(mask))
    with pytest.raises(ValueError) as terr:
        tpipe.pipeline_encoder_blocks(tm, tcfg)(
            tpipe.stack_stage_params(params["layers"]),
            torch.from_numpy(x), torch.from_numpy(mask))
    assert str(terr.value) == str(jerr.value)


def test_more_than_one_side_input_raises_like_jax():
    jm, tm = _pipe_meshes(2)
    with pytest.raises(TypeError) as jerr:
        jpipe.make_pipeline_fn(jm, lambda w, x, e: x)(
            jnp.zeros(2), jnp.zeros((1, 1)), 1, 2)
    with pytest.raises(TypeError) as terr:
        tpipe.make_pipeline_fn(tm, lambda w, x, e: x)(
            torch.zeros(2), torch.zeros(1, 1), 1, 2)
    assert str(terr.value) == str(jerr.value)
