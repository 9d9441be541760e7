"""Mesh construction, placements and collectives — port of
pathway_tpu/parallel/mesh.py.

The JAX package's topology is a ``jax.sharding.Mesh`` over TPU chips,
driven by one process: the ``data`` axis carries keyspace and batch shards
(what the reference calls workers), the ``model`` axis tensor-parallel
weight shards, and a pipeline runs on a mesh of its own (``pipe``). The
port keeps that single-controller model: a :class:`Mesh` is a grid of
``torch.device``\\ s held by one process, one grid dimension a named axis,
and a device may appear more than once in it —
``make_mesh(MeshConfig(data=4), devices=[torch.device("cuda")] * 4)`` is
four shards on one card, ``devices=[torch.device("cpu")] * 8`` the CPU
tests' eight-shard mesh, ``Mesh([torch.device("cuda")] * 4, ("pipe",))``
a four-stage pipeline on one card. Env vars, as in the JAX package:

- ``PATHWAY_DATA_PARALLEL``  — size of the data axis (default: all devices)
- ``PATHWAY_MODEL_PARALLEL`` — size of the model axis (default 1)

The default mesh (``make_mesh()`` / ``get_mesh()``) spans the
``torch.cuda.device_count()`` cards; without a card it raises unless the
caller passes devices. On one card its data axis is 1.

A :class:`Placement` cuts a tensor over the mesh as a JAX
``NamedSharding`` does (``shard_batch``: the batch over ``data``;
``replicated``: whole on every device); the sharded training step places
its state and batches with them. Collectives are plain functions on
tensors (``all_gather``): each shard's tensor is moved to the device that
merges (a peer-to-peer copy between cards, nothing on one card) and
stacked or concatenated there, where JAX runs ``lax.all_gather`` inside
``shard_map``; a stacked gather summed over its new dim is ``psum``. A
multi-process backend can replace them without touching their callers.
``shard_map`` and ``validate_shard_specs`` are JAX shims (a version
switch and a PartitionSpec check) and have no counterpart here: the
port's sharded code loops over shards itself.
"""

from __future__ import annotations

import contextlib
import math
import os
from dataclasses import dataclass

import torch

from pathway_tpu_torch._device import resolve_device

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclass(frozen=True)
class MeshConfig:
    data: int
    model: int = 1

    def validate(self, n_devices: int) -> list[str]:
        """Reasons this topology cannot tile ``n_devices`` devices (empty =
        fine)."""
        problems = []
        if self.data < 1 or self.model < 1:
            problems.append(
                f"axis sizes must be positive, got data={self.data}, "
                f"model={self.model}")
            return problems
        n = self.data * self.model
        if n > n_devices:
            problems.append(
                f"mesh {self.data}x{self.model} needs {n} devices but "
                f"only {n_devices} are available")
        elif n_devices % n != 0:
            problems.append(
                f"mesh {self.data}x{self.model} covers {n} of {n_devices} "
                f"devices and {n} does not divide {n_devices} — "
                f"{n_devices - n} chips would sit idle")
        return problems

    @staticmethod
    def from_env(n_devices: int | None = None) -> "MeshConfig":
        if n_devices is None:
            n_devices = torch.cuda.device_count()
        model_env = os.environ.get("PATHWAY_MODEL_PARALLEL")
        data_env = os.environ.get("PATHWAY_DATA_PARALLEL")
        try:
            model = int(model_env) if model_env is not None else 1
            data = (int(data_env) if data_env is not None
                    else max(1, n_devices // model))
        except ValueError:
            raise ValueError(
                f"PATHWAY_DATA_PARALLEL={data_env!r} / "
                f"PATHWAY_MODEL_PARALLEL={model_env!r} must be positive "
                f"integers") from None
        config = MeshConfig(data=data, model=model)
        # validate eagerly, naming the env vars that caused a mismatch
        problems = config.validate(n_devices)
        if problems:
            raise ValueError(
                f"invalid mesh topology from environment "
                f"(PATHWAY_DATA_PARALLEL={data_env!r}, "
                f"PATHWAY_MODEL_PARALLEL={model_env!r}, {n_devices} "
                f"devices visible): " + "; ".join(problems))
        return config


class Mesh:
    """A grid of torch devices, one dimension a named axis, driven by one
    process. ``shape`` maps each axis name to its size, in axis order, as
    a JAX mesh's does; ``devices`` is the grid as nested tuples, so
    ``devices[d][m]`` is the device of data shard ``d`` and model shard
    ``m`` on the default (data, model) axes."""

    def __init__(self, devices, axis_names=(DATA_AXIS, MODEL_AXIS)):
        self.axis_names = tuple(axis_names)
        self.devices = _grid(devices, len(self.axis_names))
        sizes, node = [], self.devices
        for _ in self.axis_names:
            sizes.append(len(node))
            node = node[0]
        self.shape = dict(zip(self.axis_names, sizes))

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def device_at(self, index: dict) -> torch.device:
        """The device at ``index`` (axis name -> position; an axis it does
        not name is at 0)."""
        node = self.devices
        for name in self.axis_names:
            node = node[index.get(name, 0)]
        return node

    def devices_along(self, axis: str) -> list[torch.device]:
        """The device of each position on ``axis``, every other axis at 0:
        where a shard of ``axis`` computes what the other axes replicate."""
        return [self.device_at({axis: i}) for i in range(self.shape[axis])]

    def shard_devices(self) -> list[torch.device]:
        """The device of each data shard (its first model shard's)."""
        return self.devices_along(DATA_AXIS)

    def flat_devices(self) -> list[torch.device]:
        def walk(node):
            if isinstance(node, tuple):
                return [d for child in node for d in walk(child)]
            return [node]

        return walk(self.devices)

    def __repr__(self) -> str:
        sizes = "x".join(str(n) for n in self.shape.values())
        return (f"Mesh({sizes}, axes={self.axis_names}, "
                f"devices={[str(d) for d in self.flat_devices()]})")


def _grid(devices, depth: int):
    """``devices`` as nested tuples ``depth`` deep, every level's rows of
    one length, each device checked (``resolve_device``)."""
    if depth == 0:
        return resolve_device(devices)
    rows = tuple(_grid(row, depth - 1) for row in devices)
    if not rows:
        raise ValueError("a mesh axis needs at least one device")
    if depth > 1 and len({len(row) for row in rows}) != 1:
        raise ValueError(
            f"mesh devices are not a grid: rows of "
            f"{sorted({len(row) for row in rows})} devices")
    return rows


def make_mesh(config: MeshConfig | None = None, *, devices=None) -> Mesh:
    """Build a (data, model) mesh over the given (or all the cards')
    devices. A device may repeat: several shards then share it. A mesh
    with other axes is ``Mesh(devices, axis_names)``."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = list(devices)
    if config is None:
        config = MeshConfig.from_env(len(devices))
    n = config.data * config.model
    if n > len(devices):
        raise ValueError(
            f"mesh {config} needs {n} devices, have {len(devices)}")
    devs = [resolve_device(d) for d in devices[:n]]
    return Mesh([devs[d * config.model:(d + 1) * config.model]
                 for d in range(config.data)])


_ACTIVE_MESH: Mesh | None = None


def get_mesh() -> Mesh:
    """The process-wide active mesh, creating a default one on first use."""
    global _ACTIVE_MESH
    if _ACTIVE_MESH is None:
        _ACTIVE_MESH = make_mesh()
    return _ACTIVE_MESH


def current_mesh() -> Mesh | None:
    """The active mesh or None (never creates one)."""
    return _ACTIVE_MESH


@contextlib.contextmanager
def use_mesh(mesh: Mesh):
    """Set the process-wide mesh for the duration of the block."""
    global _ACTIVE_MESH
    prev = _ACTIVE_MESH
    _ACTIVE_MESH = mesh
    try:
        yield mesh
    finally:
        _ACTIVE_MESH = prev


@dataclass(frozen=True)
class Placement:
    """How a tensor lies over a mesh — the counterpart of a JAX
    ``NamedSharding``: ``spec`` names, per leading dim, the mesh axis that
    dim is split over (None: not split); dims past it are whole."""

    mesh: Mesh
    spec: tuple = ()

    def piece(self, t: torch.Tensor, index: dict) -> torch.Tensor:
        """The piece of ``t`` at ``index`` (axis name -> position; an axis
        it does not name is at 0), where it lies: a dim split over an axis
        is cut into that axis's size of near-equal pieces
        (``torch.tensor_split``), any other is whole."""
        for dim, axis in enumerate(self.spec):
            if axis is not None:
                t = torch.tensor_split(t, self.mesh.shape[axis],
                                       dim=dim)[index.get(axis, 0)]
        return t


def shard_batch(mesh: Mesh | None = None, *extra_axes) -> Placement:
    """Placement of dim 0 over the data axis, the rest as ``extra_axes``
    say (replicated by default)."""
    if mesh is None:
        mesh = get_mesh()
    return Placement(mesh, (DATA_AXIS, *extra_axes))


def replicated(mesh: Mesh | None = None) -> Placement:
    if mesh is None:
        mesh = get_mesh()
    return Placement(mesh, ())


def all_gather(parts: list[torch.Tensor], device: torch.device, *,
               axis: int = 0, tiled: bool = False) -> torch.Tensor:
    """Every shard's tensor on ``device``, as ``jax.lax.all_gather`` gives
    them to each shard: stacked along a new dim ``axis`` in shard order, or
    concatenated along ``axis`` with ``tiled=True``."""
    moved = [p.to(device) for p in parts]
    if tiled:
        return torch.cat(moved, dim=axis)
    return torch.stack(moved, dim=axis)
