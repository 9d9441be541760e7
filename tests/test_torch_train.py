"""The port's trainable model layer (models/encoder.py dense_attention and
the module's gradient-enabled forward; models/train.py) against the JAX
package's ``_dense_attention``, ``info_nce_loss``, ``jax.grad`` of
``encode`` + ``info_nce_loss`` and ``contrastive_train_step`` (optax
AdamW), on EncoderConfig.tiny() with the same numpy weights and batches."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathway_tpu.models import encoder as jenc
from pathway_tpu.models import train as jtrain
from pathway_tpu_torch.models import encoder as tenc
from pathway_tpu_torch.models import train as ttrain
from pathway_tpu_torch.models.convert import params_from_jax
from pathway_tpu_torch.ops.attention import flash_attention

CPU = torch.device("cpu")
_DTYPES = {"float32": (jnp.float32, torch.float32),
           "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _configs(num_experts=0, dtype="float32"):
    jd, td = _DTYPES[dtype]
    return (jenc.EncoderConfig.tiny(num_experts=num_experts,
                                    compute_dtype=jd),
            tenc.EncoderConfig.tiny(num_experts=num_experts,
                                    compute_dtype=td))


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


def _jax_params(jcfg, seed=0):
    return jax.device_get(jenc.init_params(jax.random.PRNGKey(seed), jcfg))


def _jax_state(params, opt):
    return {"params": params, "opt_state": opt.init(params),
            "step": jnp.zeros((), jnp.int32)}


def _assert_params_close(model, jax_params, atol):
    ref = params_from_jax(jax.device_get(jax_params))
    named = dict(model.named_parameters())
    assert set(named) == set(ref)
    for name, p in named.items():
        np.testing.assert_allclose(p.detach().numpy(), ref[name].numpy(),
                                   rtol=0, atol=atol, err_msg=name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["random", "row_fully_masked"])
def test_dense_attention_matches_jax(dtype, kind):
    jd, td = _DTYPES[dtype]
    rng = np.random.default_rng(4)
    q, k, v = (rng.normal(size=(2, 24, 4, 16)).astype(np.float32)
               for _ in range(3))
    mask = rng.random((2, 24)) > 0.3
    if kind == "row_fully_masked":
        mask[1] = False
    ref = np.asarray(jenc._dense_attention(
        *(jnp.asarray(a).astype(jd) for a in (q, k, v)),
        jnp.asarray(mask)).astype(jnp.float32))
    got = tenc.dense_attention(*(torch.from_numpy(a).to(td)
                                 for a in (q, k, v)),
                               torch.from_numpy(mask)).float().numpy()
    if dtype == "float32":
        # summation order and exp rounding only
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    else:
        # bf16 scores and probabilities round in different places: within
        # two bf16 steps at the outputs' magnitude (|out| < 4: 2^-6 a step)
        assert np.abs(ref).max() < 4
        np.testing.assert_allclose(got, ref, rtol=0, atol=2 * 2 ** -6)


def test_dense_attention_is_not_k1s_plain_version():
    """The -1e9 bias in the compute dtype against K1's finfo.min fill:
    a fully masked row averages V in both, but bf16 scores differ from
    K1's float32 ones."""
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.normal(size=(1, 32, 2, 16))
                                .astype(np.float32)).bfloat16()
               for _ in range(3))
    mask = torch.ones(1, 32, dtype=torch.bool)
    from pathway_tpu_torch.ops.attention import attention_reference

    assert not torch.equal(tenc.dense_attention(q, k, v, mask),
                           attention_reference(q, k, v, mask))


def test_info_nce_loss_matches_jax():
    rng = np.random.default_rng(1)
    q, d = (rng.normal(size=(6, 32)).astype(np.float32) for _ in range(2))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    for t in (0.05, 0.5):
        ref = float(jtrain.info_nce_loss(jnp.asarray(q), jnp.asarray(d), t))
        got = float(ttrain.info_nce_loss(torch.from_numpy(q),
                                         torch.from_numpy(d), t))
        assert got == pytest.approx(ref, rel=1e-6)


@pytest.mark.parametrize("num_experts", [0, 2])
def test_gradients_match_jax_grad(num_experts):
    """Loss and every parameter's gradient against jax.grad of JAX's
    encode + info_nce_loss, f32. Each gradient tensor to rtol 1e-4 and
    atol 1e-6 x max(1, max|grad|): both packages' f32 gradients of the
    embedding tables, whose largest entries reach 2-4 at temperature
    0.05, differ from a float64 gradient by up to 5e-6 (the same for
    each), so the atol scales with the tensor where it exceeds 1; every
    other tensor is held to atol 1e-6 itself."""
    jcfg, tcfg = _configs(num_experts)
    params = _jax_params(jcfg)
    batch = _batch()

    def loss_fn(p):
        q = jenc.encode(p, batch["q_ids"], batch["q_mask"], config=jcfg)
        d = jenc.encode(p, batch["d_ids"], batch["d_mask"], config=jcfg)
        return jtrain.info_nce_loss(q, d)

    jloss, jgrads = jax.value_and_grad(loss_fn)(params)
    state = ttrain.init_train_state(0, tcfg, params=params, device="cpu")
    b = ttrain.as_batch(batch, CPU)
    model = state.model
    q = model(b["q_ids"], b["q_mask"], attn_fn=tenc.dense_attention)
    d = model(b["d_ids"], b["d_mask"], attn_fn=tenc.dense_attention)
    loss = ttrain.info_nce_loss(q, d)
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(jloss), rel=1e-5)
    ref = params_from_jax(jax.device_get(jgrads))
    for name, p in model.named_parameters():
        r = ref[name].numpy()
        np.testing.assert_allclose(
            p.grad.numpy(), r, rtol=1e-4,
            atol=1e-6 * max(1.0, float(np.abs(r).max())), err_msg=name)


def test_trainable_module_holds_f32_master_weights():
    _, tcfg = _configs(dtype="bfloat16")
    params = tenc.init_params_host(0, tcfg)
    state = ttrain.init_train_state(0, tcfg, params=params, device="cpu")
    assert all(p.dtype == torch.float32 and p.requires_grad
               for p in state.model.parameters())
    assert state.model.training
    served = tenc.Encoder.from_params(params, tcfg, device="cpu")
    assert served.layers[0].attn.wq.weight.dtype == torch.bfloat16
    assert not any(p.requires_grad for p in served.parameters())
    # the same forward from both: weights cast to bf16 where they are used
    ids = torch.from_numpy(_batch()["q_ids"]).long()
    mask = torch.from_numpy(_batch()["q_mask"])
    with torch.no_grad():
        a = state.model(ids, mask, attn_fn=tenc.dense_attention)
    b = tenc.encode(served, ids, mask, attn_fn=tenc.dense_attention)
    assert torch.equal(a, b)


def _jax_grads(params, batch, jcfg):
    """jax.grad of contrastive_train_step's loss: the gradient the step
    hands optax."""
    def loss_fn(p):
        q = jenc.encode(p, batch["q_ids"], batch["q_mask"], config=jcfg)
        d = jenc.encode(p, batch["d_ids"], batch["d_mask"], config=jcfg)
        return jtrain.info_nce_loss(q, d)

    return params_from_jax(jax.device_get(jax.grad(loss_fn)(params)))


def _routes(monkeypatch, jparams, model, batch, jcfg):
    """Each MoE block's top-1 expert for every token of both encodes, in
    both packages, from the parameters the next step starts from."""
    jroutes, troutes = [], []
    jblock, troute = jenc._moe_block, tenc._moe_route

    def jrecord(x, p, config):
        logits = x.astype(jnp.float32) @ p["router"].astype(jnp.float32)
        jroutes.append(np.asarray(jnp.argmax(jax.nn.softmax(logits, -1),
                                             -1)))
        return jblock(x, p, config)

    def trecord(x, router):
        gates, top = troute(x, router)
        troutes.append(top.numpy().copy())
        return gates, top

    with monkeypatch.context() as m:
        m.setattr(jenc, "_moe_block", jrecord)
        m.setattr(tenc, "_moe_route", trecord)
        b = ttrain.as_batch(batch, CPU)
        with torch.no_grad():
            for side in "qd":
                jenc.encode(jparams, batch[f"{side}_ids"],
                            batch[f"{side}_mask"], config=jcfg)
                model(b[f"{side}_ids"], b[f"{side}_mask"],
                      attn_fn=tenc.dense_attention)
    return jroutes, troutes


# a gradient entry below this is f32 noise: test_gradients_match_jax_grad
# holds the two packages' gradients to 1e-6 x max(1, max|grad|)
GRAD_NOISE = 1e-6


@pytest.mark.parametrize("num_experts", [0, 2])
def test_five_steps_match_jax(num_experts, monkeypatch):
    """5 contrastive_train_steps against JAX's (optax.adamw), f32, lr 1e-3
    (tests/test_models.py's rate): the losses to rtol 1e-4, every MoE
    token routed to the same expert at every step, and the final
    parameters to atol 5e-5 (5% of one step's lr), except where the
    reference gradient was f32 noise.

    Where an element's reference gradient is below ``GRAD_NOISE`` (the
    gradients' own agreement, test_gradients_match_jax_grad) at a step,
    the two packages' gradients there are noise of the same size, and
    AdamW's normalised update turns noise into a full step: at the first
    step the update is -lr (g / (|g| + eps) + wd p) with eps 1e-8, so a
    gradient of 1.2e-8 in one package and 1.5e-8 in the other moves the
    element by 5.4e-4 and 5.9e-4; in general each side's g / (|g| + eps)
    lies in (-1, 1), so one such step can part them by less than 2 lr.
    At the steps where the gradient is real the packages agree to the
    noise, and the noise left in Adam's moments is below eps against
    moments of the real gradient's size. So an element whose reference
    gradient was noise at n of the 5 steps is held to 5e-5 + 2 lr n;
    every other element (n = 0) to 5e-5. With experts, the element
    layers.1.attn.wv.weight[10, 23] takes this bound: its reference
    gradient is 1.16e-8 at step 1 (port 1.47e-8), then 1e-3 and more."""
    lr = 1e-3
    jcfg, tcfg = _configs(num_experts)
    params = _jax_params(jcfg, seed=1)
    batch = _batch(seed=2)
    opt = jtrain.make_optimizer(lr)
    jstate = _jax_state(params, opt)
    state = ttrain.init_train_state(0, tcfg, ttrain.make_optimizer(lr),
                                    params=params, device="cpu")
    noise_steps = {name: 0 for name, _ in state.model.named_parameters()}
    jl, tl = [], []
    for _ in range(5):
        if num_experts:
            jroutes, troutes = _routes(monkeypatch, jstate["params"],
                                       state.model, batch, jcfg)
            assert len(jroutes) == len(troutes) == 2 * jcfg.layers
            for jr, tr in zip(jroutes, troutes):
                np.testing.assert_array_equal(tr, jr)
        for name, g in _jax_grads(jstate["params"], batch, jcfg).items():
            noise_steps[name] = noise_steps[name] + (
                np.abs(g.numpy()) < GRAD_NOISE)
        jstate, loss = jtrain.contrastive_train_step(
            jstate, batch, config=jcfg, optimizer=opt)
        state, tloss = ttrain.contrastive_train_step(state, batch)
        jl.append(float(loss))
        tl.append(float(tloss))
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert state.step == int(jstate["step"]) == 5
    ref = params_from_jax(jax.device_get(jstate["params"]))
    named = dict(state.model.named_parameters())
    assert set(named) == set(ref)
    for name, p in named.items():
        got, want = p.detach().numpy(), ref[name].numpy()
        bound = 5e-5 + 2 * lr * noise_steps[name]
        bad = np.abs(got - want) > bound
        steps = np.broadcast_to(noise_steps[name], got.shape)
        assert not bad.any(), (
            f"{name}: {int(bad.sum())} elements off, e.g. at "
            f"{np.argwhere(bad)[0]}: {got[bad][0]} against {want[bad][0]}"
            f" (noise steps {steps[bad][0]})")


def test_init_train_state_from_seed_matches_init_params_host():
    jcfg, tcfg = _configs()
    state = ttrain.init_train_state(3, tcfg, device="cpu")
    _assert_params_close(state.model, jenc.init_params_host(3, jcfg),
                         atol=0)
    assert state.step == 0
    assert isinstance(state.optimizer, torch.optim.AdamW)
    group = state.optimizer.param_groups[0]
    assert (group["lr"], group["weight_decay"], group["betas"],
            group["eps"]) == (2e-5, 0.01, (0.9, 0.999), 1e-8)


@pytest.mark.parametrize("num_experts", [0, 2])
def test_train_state_from_jax_continues_equal(num_experts):
    """Two JAX steps, the state carried across (parameters, Adam's count,
    mu and nu), then one more step in each package: equal losses and
    parameters, f32."""
    jcfg, tcfg = _configs(num_experts)
    params = _jax_params(jcfg, seed=4)
    batch = _batch(seed=5)
    opt = jtrain.make_optimizer(1e-3)
    jstate = _jax_state(params, opt)
    for _ in range(2):
        jstate, _ = jtrain.contrastive_train_step(jstate, batch,
                                                  config=jcfg, optimizer=opt)
    state = ttrain.train_state_from_jax(jax.device_get(jstate), tcfg,
                                        ttrain.make_optimizer(1e-3),
                                        device="cpu")
    assert state.step == 2
    _assert_params_close(state.model, jstate["params"], atol=0)
    adam = jstate["opt_state"][0]
    mu = params_from_jax(jax.device_get(adam.mu))
    for name, p in state.model.named_parameters():
        st = state.optimizer.state[p]
        assert float(st["step"]) == 2
        assert torch.equal(st["exp_avg"], mu[name])
    jstate, jloss = jtrain.contrastive_train_step(jstate, batch, config=jcfg,
                                                  optimizer=opt)
    state, loss = ttrain.contrastive_train_step(state, batch)
    assert float(loss) == pytest.approx(float(jloss), rel=1e-4)
    assert state.step == 3
    # one step from equal states: the step's own f32 noise only (1% of lr)
    _assert_params_close(state.model, jstate["params"], atol=1e-5)


def test_train_step_reduces_loss():
    """tests/test_models.py::test_train_step_reduces_loss in the port."""
    _, tcfg = _configs()
    state = ttrain.init_train_state(0, tcfg, ttrain.make_optimizer(1e-3),
                                    device="cpu")
    rng = np.random.default_rng(0)
    batch = {
        "q_ids": rng.integers(0, tcfg.vocab_size, (8, 10)).astype(np.int32),
        "q_mask": np.ones((8, 10), bool),
        "d_ids": rng.integers(0, tcfg.vocab_size, (8, 10)).astype(np.int32),
        "d_mask": np.ones((8, 10), bool),
    }
    losses = []
    for _ in range(5):
        state, loss = ttrain.contrastive_train_step(state, batch)
        losses.append(float(loss))
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0]
    assert state.step == 5


def test_flash_attention_raises_under_autograd():
    """K1 has no backward: a q, k or v that requires grad under grad mode
    raises instead of returning an output with no gradient path; the
    same call under no_grad (serving) runs."""
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.normal(size=(1, 16, 2, 8))
                                .astype(np.float32)) for _ in range(3))
    mask = torch.ones(1, 16, dtype=torch.bool)
    for which in range(3):
        args = [q, k, v]
        args[which] = args[which].clone().requires_grad_(True)
        with pytest.raises(RuntimeError, match="no backward"):
            flash_attention(*args, mask)
        with torch.no_grad():
            assert flash_attention(*args, mask).shape == q.shape
    # the trainable encoder with its default attention hook: K1 refuses
    _, tcfg = _configs()
    state = ttrain.init_train_state(0, tcfg, device="cpu")
    b = ttrain.as_batch(_batch(), CPU)
    with pytest.raises(RuntimeError, match="no backward"):
        state.model(b["q_ids"], b["q_mask"])
