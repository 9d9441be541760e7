"""The port's training half of ``parallel/`` on the card — ring and
Ulysses attention, the GPipe pipeline and one sharded f32 train step on
meshes of four shards of cuda:0 — against the same on meshes of the CPU.
This file imports no JAX, so its tests run on the card: ``python -m
pytest --noconftest -q -m cuda tests/test_torch_parallel_card.py``."""

import importlib

import numpy as np
import pytest
import torch

from pathway_tpu_torch.models import encoder as tenc
from pathway_tpu_torch.models import train as ttrain
from pathway_tpu_torch.models.convert import params_from_jax
from pathway_tpu_torch.parallel import mesh as tmesh
from pathway_tpu_torch.parallel.pipeline import (pipeline_encoder_blocks,
                                                 sequential_encoder_blocks,
                                                 stack_stage_params)

tra = importlib.import_module("pathway_tpu_torch.parallel.ring_attention")


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the meshes are shards of cuda:0")
    return torch.device("cuda")


def _qkv(seed, shape):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=shape).astype(np.float32))
            for _ in range(3)]


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["ring_attention", "ulysses_attention"])
@pytest.mark.parametrize("causal", [False, True])
def test_sequence_parallel_attention_on_card_matches_cpu(name, causal):
    card = _card()
    qkv = _qkv(1, (2, 64, 8, 16))
    got = {}
    for dev in (card, torch.device("cpu")):
        mesh = tmesh.make_mesh(tmesh.MeshConfig(data=4), devices=[dev] * 4)
        out = getattr(tra, name)(*(t.to(dev) for t in qkv), mesh=mesh,
                                 causal=causal)
        assert out.device.type == dev.type
        got[dev.type] = out.cpu()
    torch.testing.assert_close(got["cuda"], got["cpu"], rtol=2e-5,
                               atol=2e-5)


@pytest.mark.cuda
def test_pipeline_on_card_matches_cpu_and_sequential():
    card = _card()
    cfg = tenc.EncoderConfig.tiny(layers=4, heads=4)
    params = tenc.init_params_host(0, cfg)
    x = torch.from_numpy(np.random.default_rng(2).normal(
        size=(5, 2, 8, cfg.hidden)).astype(np.float32))
    mask = torch.ones(2, 8, dtype=torch.bool)
    mask[1, 5:] = False
    got = {}
    for dev in (card, torch.device("cpu")):
        mesh = tmesh.Mesh([dev] * 4, ("pipe",))
        out = pipeline_encoder_blocks(mesh, cfg)(
            stack_stage_params(params["layers"]), x.to(dev), mask.to(dev))
        seq = torch.stack([sequential_encoder_blocks(
            params["layers"], x[i].to(dev), mask.to(dev), cfg)
            for i in range(len(x))])
        assert torch.equal(out, seq)
        got[dev.type] = out.float().cpu()
    # bf16 blocks on two devices: cuBLAS and the CPU round differently
    torch.testing.assert_close(got["cuda"], got["cpu"], rtol=3e-2,
                               atol=3e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("num_experts", [0, 2])
def test_sharded_step_on_card_matches_cpu(num_experts):
    """One f32 step on a (data 2, model 2) mesh of cuda:0 and of the CPU
    from the same weights: the losses to rtol 1e-5, every gradient within
    1e-3 x its tensor's largest |grad| + 1e-5 x the model's."""
    card = _card()
    cfg = tenc.EncoderConfig.tiny(heads=4, pooling="mean",
                                  num_experts=num_experts,
                                  compute_dtype=torch.float32)
    params = tenc.init_params_host(3, cfg)
    rng = np.random.default_rng(4)
    batch = {}
    for side in "qd":
        mask = np.arange(16)[None, :] < rng.integers(3, 17, size=8)[:, None]
        batch[f"{side}_ids"] = np.where(
            mask, rng.integers(1, cfg.vocab_size, size=(8, 16)), 0)
        batch[f"{side}_mask"] = mask
    runs = {}
    for dev in (card, torch.device("cpu")):
        mesh = tmesh.make_mesh(tmesh.MeshConfig(data=2, model=2),
                               devices=[dev] * 4)
        state = ttrain.init_sharded_train_state(0, mesh, cfg, params=params)
        step_fn, _, _ = ttrain.make_sharded_train_step(mesh, cfg)
        state, loss = step_fn(state, batch)
        assert loss.device.type == dev.type
        runs[dev.type] = (float(loss), state.gather("grads"))
    (l_gpu, g_gpu), (l_cpu, g_cpu) = runs["cuda"], runs["cpu"]
    assert l_gpu == pytest.approx(l_cpu, rel=1e-5)
    ref = params_from_jax(g_cpu)
    got = params_from_jax(g_gpu)
    floor = 1e-5 * max(float(g.abs().max()) for g in ref.values())
    for name, g in ref.items():
        err = float((got[name] - g).abs().max())
        assert err <= 1e-3 * float(g.abs().max()) + floor, name
