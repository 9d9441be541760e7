"""The port's sharded training (models/encoder.py ``param_pspecs`` and
``encode_tensor_parallel``; models/train.py ``train_state_pspecs``,
``make_sharded_train_step``) against the JAX package's GSPMD step on the
same (data 4, model 2) mesh, state and batches (the port's mesh is eight
shards of the CPU, JAX's its eight virtual CPU devices), dense and with
2 experts; and against the port's own single-device step."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from pathway_tpu.models import encoder as jenc
from pathway_tpu.models import train as jtrain
from pathway_tpu.parallel import mesh as jmesh
from pathway_tpu_torch.models import encoder as tenc
from pathway_tpu_torch.models import train as ttrain
from pathway_tpu_torch.models.convert import params_from_jax
from pathway_tpu_torch.parallel import mesh as tmesh

CPU8 = [torch.device("cpu")] * 8
LR = 1e-3  # tests/test_models.py's rate, as test_torch_train.py's steps
# a reference gradient entry below this is f32 noise
# (test_torch_train.py::test_gradients_match_jax_grad)
GRAD_NOISE = 1e-6
_DTYPES = {"float32": (jnp.float32, torch.float32),
           "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _configs(num_experts=0, dtype="float32", **kw):
    jd, td = _DTYPES[dtype]
    base = dict(heads=4, pooling="mean", num_experts=num_experts, **kw)
    return (jenc.EncoderConfig.tiny(compute_dtype=jd, **base),
            tenc.EncoderConfig.tiny(compute_dtype=td, **base))


def _meshes(data=4, model=2):
    return (jmesh.make_mesh(jmesh.MeshConfig(data=data, model=model)),
            tmesh.make_mesh(tmesh.MeshConfig(data=data, model=model),
                            devices=CPU8))


def _batch(B=8, S=16, seed=0, vocab=1024):
    rng = np.random.default_rng(seed)
    lens = rng.integers(3, S + 1, size=(2, B))
    out = {}
    for side, n in zip("qd", lens):
        mask = np.arange(S)[None, :] < n[:, None]
        ids = rng.integers(1, vocab, size=(B, S)).astype(np.int32)
        out[f"{side}_ids"] = np.where(mask, ids, 0)
        out[f"{side}_mask"] = mask
    return out


def _as_tuples(tree):
    return jax.tree.map(tuple, tree,
                        is_leaf=lambda x: isinstance(x, jax.sharding.
                                                     PartitionSpec))


@pytest.mark.parametrize("num_experts", [0, 2])
def test_param_pspecs_match_jax(num_experts):
    jcfg, tcfg = _configs(num_experts)
    assert tenc.param_pspecs(tcfg) == _as_tuples(jenc.param_pspecs(jcfg))


@pytest.mark.parametrize("num_experts", [0, 2])
def test_train_state_pspecs_match_jax(num_experts):
    """Parameters and both moments split as JAX's params, mu and nu; the
    count and the step replicated."""
    jcfg, tcfg = _configs(num_experts)
    want = jtrain.train_state_pspecs(jcfg)
    got = ttrain.train_state_pspecs(tcfg)
    adam = want["opt_state"][0]
    assert got["params"] == _as_tuples(want["params"])
    assert got["opt_state"]["mu"] == _as_tuples(adam.mu)
    assert got["opt_state"]["nu"] == _as_tuples(adam.nu)
    assert got["opt_state"]["count"] == tuple(adam.count) == ()
    assert got["step"] == tuple(want["step"]) == ()


@pytest.mark.parametrize("num_experts", [0, 2])
def test_state_placements_and_pieces(num_experts):
    """The state's Placements: a leaf split over model by its spec, the
    rest replicated; the batch over data. Each model shard's piece holds
    1/M of the columns, rows or experts, and the pieces gather back to
    the tree bit for bit."""
    jcfg, tcfg = _configs(num_experts)
    _, tm = _meshes()
    step_fn, placements, batch_placement = ttrain.make_sharded_train_step(
        tm, tcfg)
    assert batch_placement == tmesh.shard_batch(tm)
    attn = placements["params"]["layers"][0]["attn"]
    assert attn["wq"] == tmesh.Placement(tm, (None, "model"))
    assert attn["bo"] == placements["step"] == tmesh.replicated(tm)
    params = tenc.init_params_host(3, tcfg)
    state = ttrain.init_sharded_train_state(0, tm, tcfg, params=params)
    H, I_ = tcfg.hidden, tcfg.intermediate
    layer = state.params["layers"][1]
    assert [p.shape for p in layer["attn"]["wq"]] == [(H, H // 2)] * 2
    assert [p.shape for p in layer["attn"]["wo"]] == [(H // 2, H)] * 2
    assert [p.shape for p in layer["attn"]["bo"]] == [(H,)]
    if num_experts:
        assert [p.shape for p in layer["moe"]["w1"]] == [(1, H, I_)] * 2
        assert [p.shape for p in layer["moe"]["router"]] == [(H, 2)]
    else:
        assert [p.shape for p in layer["mlp"]["w1"]] == [(H, I_ // 2)] * 2
        assert [p.shape for p in layer["mlp"]["w2"]] == [(I_ // 2, H)] * 2
    # every piece is a leaf of its own, and the optimizer holds them all
    pieces = state.pieces()
    assert all(p.is_leaf and p.requires_grad for p in pieces)
    assert len(state.optimizer.param_groups[0]["params"]) == len(pieces)
    for got, want in zip(jax.tree.leaves(state.gather("params")),
                         jax.tree.leaves(params)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("num_experts", [0, 2])
def test_forward_splits_compute_not_storage(num_experts, monkeypatch):
    """Every matrix a model shard multiplies by is its piece (1/M of the
    columns, rows or experts): the forward never gathers a whole weight."""
    _, tcfg = _configs(num_experts)
    _, tm = _meshes()
    state = ttrain.init_sharded_train_state(0, tm, tcfg)
    H, I_ = tcfg.hidden, tcfg.intermediate
    seen = []
    linear, experts = F.linear, tenc._experts

    def record_linear(x, w, b=None):
        seen.append(tuple(w.shape))
        return linear(x, w, b)

    def record_experts(xc, w1, b1, w2, b2, onehot, config):
        seen.append(("experts", w1.shape[0], onehot.shape[-1]))
        return experts(xc, w1, b1, w2, b2, onehot, config)

    monkeypatch.setattr(tenc.F, "linear", record_linear)
    monkeypatch.setattr(tenc, "_experts", record_experts)
    b = _batch(B=4)
    tenc.encode_tensor_parallel(
        state.shard_params(0), torch.from_numpy(b["q_ids"]).long(),
        torch.from_numpy(b["q_mask"]), config=tcfg)
    allowed = {(H // 2, H), (H, H // 2), (I_ // 2, H), (H, I_ // 2),
               ("experts", 1, 1)}
    assert set(seen) <= allowed, set(seen) - allowed
    # per shard and layer: q, k, v and wo, then w1 and w2 or the experts
    per_layer = 2 * (4 + (1 if num_experts else 2))
    assert len(seen) == tcfg.layers * per_layer


def _jax_grads(params, batch, jcfg):
    def loss_fn(p):
        q = jenc.encode(p, batch["q_ids"], batch["q_mask"], config=jcfg)
        d = jenc.encode(p, batch["d_ids"], batch["d_mask"], config=jcfg)
        return jtrain.info_nce_loss(q, d)

    return jax.device_get(jax.grad(loss_fn)(params))


def _run_both(num_experts, dtype, steps=3):
    """``steps`` steps of JAX's make_sharded_train_step and the port's on
    a (4, 2) mesh from the same state and batch. Returns the configs, the
    initial parameters, both final states, both losses and, per leaf, how
    many steps the reference gradient was noise (f32 only)."""
    jcfg, tcfg = _configs(num_experts, dtype)
    jm, tm = _meshes()
    opt = jtrain.make_optimizer(LR)
    params = jax.device_get(jenc.init_params(jax.random.PRNGKey(1), jcfg))
    jstate = {"params": params, "opt_state": opt.init(params),
              "step": jnp.zeros((), jnp.int32)}
    jstep, shardings, batch_sharding = jtrain.make_sharded_train_step(
        jm, jcfg, opt)
    jstate = jax.device_put(jstate, shardings)
    state = ttrain.sharded_train_state_from_jax(
        jax.device_get(jstate), tm, tcfg, ttrain.make_optimizer(LR))
    step_fn, _, _ = ttrain.make_sharded_train_step(tm, tcfg)
    batch = _batch(seed=2)
    jbatch = {k: jax.device_put(v, batch_sharding) for k, v in batch.items()}
    noise = jax.tree.map(lambda a: np.zeros(a.shape, int), params)
    jl, tl = [], []
    for _ in range(steps):
        if dtype == "float32":
            g = _jax_grads(jax.device_get(jstate["params"]), batch, jcfg)
            noise = jax.tree.map(lambda n, a: n + (np.abs(a) < GRAD_NOISE),
                                 noise, g)
        jstate, loss = jstep(jstate, jbatch)
        state, tloss = step_fn(state, batch)
        jl.append(float(loss))
        tl.append(float(tloss))
    return params, jax.device_get(jstate), state, jl, tl, noise


def _hold(got_tree, want_tree, noise, what):
    """test_torch_train.py::test_five_steps_match_jax's rule: atol 5e-5,
    plus 2 lr for each step an element's reference gradient was noise
    (AdamW turns a noise gradient into a step of up to lr either way)."""
    for (path, want), got, n in zip(jax.tree.leaves_with_path(want_tree),
                                    jax.tree.leaves(got_tree),
                                    jax.tree.leaves(noise)):
        want = np.asarray(want)
        bad = np.abs(got - want) > 5e-5 + 2 * LR * n
        assert not bad.any(), (
            f"{what} {jax.tree_util.keystr(path)}: {int(bad.sum())} "
            f"elements off, e.g. {got[bad][0]} against {want[bad][0]}")


@pytest.mark.parametrize("num_experts", [0, 2])
def test_sharded_steps_match_jax(num_experts):
    """3 f32 steps: the losses to rtol 1e-4; parameters and both AdamW
    moments under the noise rule; the count and step carried."""
    _, jstate, state, jl, tl, noise = _run_both(num_experts, "float32")
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    adam = jstate["opt_state"][0]
    _hold(state.gather("params"), jstate["params"], noise, "params")
    _hold(state.gather("mu"), adam.mu, noise, "mu")
    _hold(state.gather("nu"), adam.nu, noise, "nu")
    counts = {int(state.optimizer.state[p]["step"]) for p in state.pieces()}
    assert counts == {int(adam.count)} == {3}
    assert state.step == int(jstate["step"]) == 3


@pytest.mark.parametrize("num_experts", [0, 2])
def test_sharded_steps_match_jax_bf16(num_experts):
    """3 bf16 steps. The two packages round bf16 matmuls and sums in
    different places (measured: losses apart by up to 2.6e-3 relative,
    elements of the parameters by up to 5.3e-3 after 3 steps at lr 1e-3,
    where one Adam step moves an element by up to lr), so this holds the
    losses to rtol 5e-3 a step and the direction of the whole update
    (final minus initial parameters, every element): cosine >= 0.98
    (measured 0.994-0.997)."""
    params, jstate, state, jl, tl, _ = _run_both(num_experts, "bfloat16")
    np.testing.assert_allclose(tl, jl, rtol=5e-3)
    up_j, up_t = (np.concatenate([(np.asarray(a) - b).ravel() for a, b in
                                  zip(jax.tree.leaves(tree),
                                      jax.tree.leaves(params))])
                  for tree in (jstate["params"], state.gather("params")))
    cos = up_j @ up_t / (np.linalg.norm(up_j) * np.linalg.norm(up_t))
    assert cos >= 0.98, cos


@pytest.mark.parametrize("num_experts", [0, 2])
def test_sharded_step_equals_single_device_step(num_experts):
    """The sharded f32 step against the port's contrastive_train_step from
    the same weights: the losses of 3 steps to rtol 1e-5 and the first
    step's gradients as chip_smoke.py's hold_grads holds them (1e-3 x the
    tensor's largest |grad| + 1e-5 x the model's). A sum over data
    replicas that averaged would scale every gradient by 1/4."""
    _, tcfg = _configs(num_experts)
    _, tm = _meshes()
    params = tenc.init_params_host(5, tcfg)
    single = ttrain.init_train_state(0, tcfg, ttrain.make_optimizer(LR),
                                     params=params, device="cpu")
    state = ttrain.init_sharded_train_state(0, tm, tcfg,
                                            ttrain.make_optimizer(LR),
                                            params=params)
    step_fn, _, _ = ttrain.make_sharded_train_step(tm, tcfg)
    batch = _batch(seed=6)
    for i in range(3):
        single, sl = ttrain.contrastive_train_step(single, batch)
        state, tl = step_fn(state, batch)
        assert float(tl) == pytest.approx(float(sl), rel=1e-5)
        if i == 0:
            ref = {n: p.grad for n, p in single.model.named_parameters()}
            got = params_from_jax(state.gather("grads"))
            assert set(got) == set(ref)
            floor = 1e-5 * max(float(g.abs().max()) for g in ref.values())
            for name, g in ref.items():
                err = float((got[name] - g).abs().max())
                assert err <= 1e-3 * float(g.abs().max()) + floor, name


def test_batch_the_data_axis_does_not_divide_raises():
    _, tcfg = _configs()
    _, tm = _meshes()
    state = ttrain.init_sharded_train_state(0, tm, tcfg)
    step_fn, _, _ = ttrain.make_sharded_train_step(tm, tcfg)
    with pytest.raises(ValueError, match="batch size 6 .* 4-way 'data'"):
        step_fn(state, _batch(B=6))
    assert state.step == 0


@pytest.mark.parametrize("kw,what", [
    (dict(hidden=48, heads=3), "heads=3"),
    (dict(intermediate=129), "intermediate=129"),
    (dict(num_experts=3), "num_experts=3"),
])
def test_what_the_model_axis_does_not_divide_raises(kw, what):
    tcfg = tenc.EncoderConfig.tiny(**kw)
    _, tm = _meshes()
    with pytest.raises(ValueError, match=f"{what} is not divisible by the "
                                         "2-way 'model' axis"):
        ttrain.make_sharded_train_step(tm, tcfg)
    with pytest.raises(ValueError, match=what):
        ttrain.init_sharded_train_state(0, tm, tcfg)
