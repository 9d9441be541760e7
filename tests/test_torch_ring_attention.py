"""The port's sequence-parallel attention
(pathway_tpu_torch/parallel/ring_attention.py) against the JAX package's
(pathway_tpu/parallel/ring_attention.py): ring and Ulysses attention,
causal and not, on the JAX tests' meshes and shapes
(tests/test_parallel.py), the port on meshes of the CPU, to JAX's own
tolerance (2e-5); the unsharded reference; and the same errors for a
sequence or a head count the axis does not divide."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathway_tpu.parallel import mesh as jmesh
from pathway_tpu_torch.parallel import mesh as tmesh

# the packages export functions under the modules' names
jra = importlib.import_module("pathway_tpu.parallel.ring_attention")
tra = importlib.import_module("pathway_tpu_torch.parallel.ring_attention")

CPU8 = [torch.device("cpu")] * 8


def _meshes(data, model=1):
    return (jmesh.make_mesh(jmesh.MeshConfig(data=data, model=model)),
            tmesh.make_mesh(tmesh.MeshConfig(data=data, model=model),
                            devices=CPU8))


def _qkv(seed, shape, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(dtype) for _ in range(3)]


def _both(name, qkv, jdtype=jnp.float32, tdtype=torch.float32, **kw):
    jm, tm = kw.pop("meshes", (None, None))
    jkw = dict(kw, **({"mesh": jm} if jm is not None else {}))
    tkw = dict(kw, **({"mesh": tm} if tm is not None else {}))
    j = getattr(jra, name)(*(jnp.asarray(a).astype(jdtype) for a in qkv),
                           **jkw)
    t = getattr(tra, name)(*(torch.from_numpy(a).to(tdtype) for a in qkv),
                           **tkw)
    return np.asarray(j.astype(jnp.float32)), t.float().numpy()


@pytest.mark.parametrize("causal", [False, True])
def test_ring_attention_matches_jax(causal):
    # S sharded 8-way -> 4 per shard; the causal ring reaches whole blocks
    # that are masked (shard i at step t > i)
    want, got = _both("ring_attention", _qkv(2, (2, 32, 4, 8)),
                      meshes=_meshes(8), causal=causal)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("causal", [False, True])
def test_ulysses_attention_matches_jax(causal):
    want, got = _both("ulysses_attention", _qkv(3, (2, 32, 8, 4)),
                      meshes=_meshes(8), causal=causal)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("causal", [False, True])
def test_ring_attention_on_submesh_matches_jax(causal):
    """A (data 4, model 2) mesh: the sequence over data, the work
    replicated over model."""
    want, got = _both("ring_attention", _qkv(4, (1, 16, 2, 4)),
                      meshes=_meshes(4, 2), causal=causal)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("causal", [False, True])
def test_reference_attention_matches_jax(causal):
    want, got = _both("reference_attention", _qkv(5, (2, 24, 4, 8)),
                      causal=causal)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("name", ["ring_attention", "ulysses_attention"])
@pytest.mark.parametrize("causal", [False, True])
def test_bf16_matches_jax(name, causal):
    """bf16 inputs: scores and probabilities in bf16, the softmax state in
    float32, as in JAX: equal to within one bf16 step of the outputs
    (|out| < 4: 2^-6)."""
    want, got = _both(name, _qkv(6, (2, 32, 8, 8)), jnp.bfloat16,
                      torch.bfloat16, meshes=_meshes(8), causal=causal)
    assert np.abs(want).max() < 4
    np.testing.assert_allclose(got, want, rtol=0, atol=2 ** -6)


@pytest.mark.parametrize("causal", [False, True])
def test_sharded_attention_matches_reference(causal):
    """The port's own identities: ring and Ulysses equal the unsharded
    reference (tests/test_parallel.py's checks)."""
    tm = _meshes(4)[1]
    q, k, v = (torch.from_numpy(a) for a in _qkv(7, (2, 16, 4, 8)))
    ref = tra.reference_attention(q, k, v, causal=causal)
    for fn in (tra.ring_attention, tra.ulysses_attention):
        torch.testing.assert_close(fn(q, k, v, mesh=tm, causal=causal), ref,
                                   rtol=2e-5, atol=2e-5)


def _error(fn, *args, **kw):
    with pytest.raises(ValueError) as err:
        fn(*args, **kw)
    return str(err.value)


@pytest.mark.parametrize("name,shape", [
    ("ring_attention", (1, 30, 8, 4)),     # S % 8 != 0
    ("ulysses_attention", (1, 32, 6, 4)),  # heads % 8 != 0
    ("ulysses_attention", (1, 30, 8, 4)),  # S % 8 != 0
])
def test_errors_match_jax(name, shape):
    jm, tm = _meshes(8)
    qkv = _qkv(8, shape)
    want = _error(getattr(jra, name), *(jnp.asarray(a) for a in qkv),
                  mesh=jm)
    got = _error(getattr(tra, name), *(torch.from_numpy(a) for a in qkv),
                 mesh=tm)
    assert got == want


def test_default_mesh_is_the_active_one():
    _, tm = _meshes(4)
    q, k, v = (torch.from_numpy(a) for a in _qkv(9, (1, 8, 2, 4)))
    with tmesh.use_mesh(tm):
        got = tra.ring_attention(q, k, v)
    torch.testing.assert_close(got, tra.reference_attention(q, k, v),
                               rtol=2e-5, atol=2e-5)
