"""The port's mesh (pathway_tpu_torch/parallel/mesh.py) against the JAX
package's (pathway_tpu/parallel/mesh.py): ``MeshConfig.validate`` and
``from_env`` give the same configs and the same errors over a grid of
environments, meshes have the same shapes, ``use_mesh`` / ``current_mesh``
nest the same way, and the collectives and placements equal numpy."""

import numpy as np
import pytest
import torch

from pathway_tpu.parallel import mesh as jmesh
from pathway_tpu_torch.parallel import mesh as tmesh

CPU8 = [torch.device("cpu")] * 8

ENV_GRID = [
    (None, None), ("8", None), ("4", None), ("4", "2"), (None, "2"),
    ("2", "2"), ("3", None), ("16", None), ("0", None), (None, "0"),
    ("-1", "1"), ("x", None), (None, "two"), ("1", "8"), ("5", "1"),
]


def _outcome(cls, n_devices, data_env, model_env, monkeypatch):
    for name, value in (("PATHWAY_DATA_PARALLEL", data_env),
                        ("PATHWAY_MODEL_PARALLEL", model_env)):
        if value is None:
            monkeypatch.delenv(name, raising=False)
        else:
            monkeypatch.setenv(name, value)
    try:
        c = cls.from_env(n_devices)
    except (ValueError, ZeroDivisionError) as e:
        # model=0 with data unset divides by zero in both packages
        return (type(e).__name__, str(e))
    return ("ok", (c.data, c.model))


@pytest.mark.parametrize("n_devices", [1, 4, 8])
@pytest.mark.parametrize("data_env,model_env", ENV_GRID)
def test_from_env_matches_jax(n_devices, data_env, model_env, monkeypatch):
    want = _outcome(jmesh.MeshConfig, n_devices, data_env, model_env,
                    monkeypatch)
    got = _outcome(tmesh.MeshConfig, n_devices, data_env, model_env,
                   monkeypatch)
    assert got == want


@pytest.mark.parametrize("data,model", [(1, 1), (8, 1), (4, 2), (3, 1),
                                        (0, 1), (2, -1), (16, 1), (3, 3)])
@pytest.mark.parametrize("n_devices", [1, 8, 9])
def test_validate_matches_jax(data, model, n_devices):
    assert tmesh.MeshConfig(data, model).validate(n_devices) == \
        jmesh.MeshConfig(data, model).validate(n_devices)


@pytest.mark.parametrize("data,model", [(8, 1), (4, 2), (2, 2), (1, 1)])
def test_mesh_shapes_match_jax(data, model):
    j = jmesh.make_mesh(jmesh.MeshConfig(data=data, model=model))
    t = tmesh.make_mesh(tmesh.MeshConfig(data=data, model=model),
                        devices=CPU8)
    assert dict(t.shape) == dict(j.shape)
    assert list(t.shape) == list(j.shape)  # axis order
    assert t.size == data * model
    assert len(t.shard_devices()) == data
    assert [len(row) for row in t.devices] == [model] * data


def test_make_mesh_too_few_devices_matches_jax():
    config = tmesh.MeshConfig(data=9)
    with pytest.raises(ValueError) as t_err:
        tmesh.make_mesh(config, devices=CPU8)
    with pytest.raises(ValueError) as j_err:
        jmesh.make_mesh(jmesh.MeshConfig(data=9))
    assert str(t_err.value) == str(j_err.value)


def test_default_mesh_needs_a_card_or_devices(monkeypatch):
    monkeypatch.delenv("PATHWAY_DATA_PARALLEL", raising=False)
    monkeypatch.delenv("PATHWAY_MODEL_PARALLEL", raising=False)
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default mesh spans the cards")
    with pytest.raises(ValueError, match="0 devices visible"):
        tmesh.make_mesh()
    m = tmesh.make_mesh(devices=CPU8)  # env unset: data = all devices
    assert dict(m.shape) == {"data": 8, "model": 1}


def test_use_mesh_and_current_mesh_nest_like_jax():
    ja = jmesh.make_mesh(jmesh.MeshConfig(data=8))
    jb = jmesh.make_mesh(jmesh.MeshConfig(data=4, model=2))
    ta = tmesh.make_mesh(tmesh.MeshConfig(data=8), devices=CPU8)
    tb = tmesh.make_mesh(tmesh.MeshConfig(data=4, model=2), devices=CPU8)
    seen = []
    for mod, a, b in ((jmesh, ja, jb), (tmesh, ta, tb)):
        trace = [mod.current_mesh() is None]
        with mod.use_mesh(a) as got:
            trace.append(got is a and mod.current_mesh() is a)
            trace.append(mod.get_mesh() is a)
            with mod.use_mesh(b):
                trace.append(mod.current_mesh() is b)
            trace.append(mod.current_mesh() is a)
        trace.append(mod.current_mesh() is None)
        seen.append(trace)
    assert seen[0] == seen[1] == [True] * 6


@pytest.mark.parametrize("n_shards", [1, 3, 8])
@pytest.mark.parametrize("tiled", [False, True])
def test_all_gather_matches_numpy(n_shards, tiled):
    rng = np.random.default_rng(n_shards)
    parts = [rng.normal(size=(5, 3)).astype(np.float32)
             for _ in range(n_shards)]
    for axis in (0, 1):
        got = tmesh.all_gather([torch.from_numpy(p) for p in parts],
                               torch.device("cpu"), axis=axis, tiled=tiled)
        want = (np.concatenate(parts, axis=axis) if tiled
                else np.stack(parts, axis=axis))
        np.testing.assert_array_equal(got.numpy(), want)
    # the sharded index's merge layout: JAX gathers (S, B, k) and
    # transposes to shard-major per query; a tiled gather on dim 1 is it
    stacked = np.stack(parts)
    shard_major = np.transpose(stacked, (1, 0, 2)).reshape(5, -1)
    got = tmesh.all_gather([torch.from_numpy(p) for p in parts],
                           torch.device("cpu"), axis=1, tiled=True)
    np.testing.assert_array_equal(got.numpy(), shard_major)


def _place(placement, x):
    """Every (data, model) shard's piece of ``x``."""
    mesh = placement.mesh
    return [[placement.piece(x, {"data": d, "model": m})
             for m in range(mesh.shape["model"])]
            for d in range(mesh.shape["data"])]


@pytest.mark.parametrize("data,model", [(4, 2), (8, 1), (3, 1)])
def test_placements_cut_like_named_shardings(data, model):
    """shard_batch / replicated cut a (24, 6) array as JAX's
    NamedSharding puts it on the devices of the same mesh shape; a size
    the axis does not divide (JAX refuses it) is cut as numpy.array_split
    cuts it."""
    import jax

    x = np.arange(144, dtype=np.float32).reshape(24, 6)
    uneven = _place(tmesh.shard_batch(tmesh.make_mesh(
        tmesh.MeshConfig(data=data), devices=CPU8)),
        torch.from_numpy(x[:10]))
    for d, want in enumerate(np.array_split(x[:10], data)):
        np.testing.assert_array_equal(uneven[d][0].numpy(), want)
    t = tmesh.make_mesh(tmesh.MeshConfig(data=data, model=model),
                        devices=CPU8)
    pieces = _place(tmesh.shard_batch(t), torch.from_numpy(x))
    rep = _place(tmesh.replicated(t), torch.from_numpy(x))
    want = np.array_split(x, data, axis=0)
    for d in range(data):
        for m in range(model):
            np.testing.assert_array_equal(pieces[d][m].numpy(), want[d])
            np.testing.assert_array_equal(rep[d][m].numpy(), x)
    split = _place(tmesh.shard_batch(t, tmesh.MODEL_AXIS),
                   torch.from_numpy(x))
    for d in range(data):
        for m in range(model):
            np.testing.assert_array_equal(
                split[d][m].numpy(),
                np.array_split(want[d], model, axis=1)[m])
    j = jmesh.make_mesh(jmesh.MeshConfig(data=data, model=model))
    for jspec, tpieces in ((jmesh.shard_batch(j), pieces),
                           (jmesh.replicated(j), rep),
                           (jmesh.shard_batch(j, tmesh.MODEL_AXIS), split)):
        arr = jax.device_put(x, jspec)
        by_device = {s.device: np.asarray(s.data)
                     for s in arr.addressable_shards}
        for d in range(data):
            for m in range(model):
                np.testing.assert_array_equal(
                    by_device[j.devices[d, m]], tpieces[d][m].numpy())


@pytest.mark.parametrize("axes,shape", [(("pipe",), (4,)),
                                        (("data", "model"), (2, 2)),
                                        (("a", "b", "c"), (2, 1, 2))])
def test_named_axes_match_jax(axes, shape):
    """A mesh over any axis names, as jax.sharding.Mesh(devices, names):
    the same shape dict in axis order; ``device_at`` / ``devices_along``
    index the grid as the JAX mesh's device array is indexed."""
    import jax

    n = int(np.prod(shape))
    j = jax.sharding.Mesh(np.asarray(jax.devices()[:n]).reshape(shape),
                          axes)
    labels = [torch.device("cpu", i) for i in range(n)]  # distinct ids
    grid = np.empty(n, dtype=object)
    grid[:] = labels
    t = tmesh.Mesh(grid.reshape(shape).tolist(), axes)
    assert list(t.shape.items()) == list(j.shape.items())
    assert t.size == n == j.size
    assert t.flat_devices() == labels
    for flat, index in enumerate(np.ndindex(*shape)):
        at = dict(zip(axes, index))
        assert t.device_at(at) == labels[flat]
        assert j.devices[index] == jax.devices()[flat]
    for k, axis in enumerate(axes):
        stride = int(np.prod(shape[k + 1:]))
        assert t.devices_along(axis) == [labels[i * stride]
                                         for i in range(shape[k])]


def test_mesh_rows_must_form_a_grid():
    with pytest.raises(ValueError, match="not a grid"):
        tmesh.Mesh([["cpu", "cpu"], ["cpu"]])
    with pytest.raises(ValueError, match="at least one device"):
        tmesh.Mesh([], ("pipe",))


def test_placement_on_a_pipe_mesh_splits_the_layer_stack():
    """The pipeline's placement of a stacked (L, ...) parameter: layers
    [s L/S, (s+1) L/S) on stage s."""
    m = tmesh.Mesh([torch.device("cpu")] * 4, ("pipe",))
    x = torch.arange(24.0).reshape(8, 3)
    split = tmesh.Placement(m, ("pipe",))
    for s in range(4):
        assert torch.equal(split.piece(x, {"pipe": s}), x[2 * s:2 * s + 2])
    # an axis the index does not name is at 0
    assert torch.equal(split.piece(x, {}), x[:2])
