"""pathway_tpu_torch.parallel — the device-parallel layer — port of
pathway_tpu/parallel/__init__.py.

Instead of N identical workers exchanging rows over sockets (the
reference's timely ``communication`` crate), device state such as the
vector slab is sharded over a mesh of devices and merged with explicit
collectives. One process drives every device, as in the JAX package.

Axis conventions:
- ``data``  — batch / keyspace shards (the reference's worker shards,
  src/engine/dataflow/shard.rs:6-20)
- ``model`` — tensor-parallel shards of model weights
A sequence axis for ring/Ulysses attention reuses ``data`` by default; a
pipeline runs on a mesh of its own (``pipe``).

Modules: the mesh, placements and collectives (``parallel/mesh.py``), the
mesh-sharded KNN index (``parallel/sharded_knn.py``), sequence-parallel
attention (``parallel/ring_attention.py``) and the GPipe encoder
pipeline (``parallel/pipeline.py``). The sharded training step that
places its state with these meshes is models/train.py's
``make_sharded_train_step``.
"""

from __future__ import annotations

from pathway_tpu_torch.parallel.mesh import (
    Mesh,
    MeshConfig,
    Placement,
    all_gather,
    current_mesh,
    get_mesh,
    make_mesh,
    replicated,
    shard_batch,
    use_mesh,
)
from pathway_tpu_torch.parallel.sharded_knn import (
    PagedShardedKnnIndex,
    ShardedKnnIndex,
)
from pathway_tpu_torch.parallel.ring_attention import (
    ring_attention,
    ulysses_attention,
)

__all__ = [
    "Mesh",
    "MeshConfig",
    "Placement",
    "make_mesh",
    "get_mesh",
    "use_mesh",
    "current_mesh",
    "shard_batch",
    "replicated",
    "all_gather",
    "ShardedKnnIndex",
    "PagedShardedKnnIndex",
    "ring_attention",
    "ulysses_attention",
]

from pathway_tpu_torch.parallel import pipeline  # noqa: F401,E402
