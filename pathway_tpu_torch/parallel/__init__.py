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

Ported: the mesh (``parallel/mesh.py``) and the mesh-sharded KNN index
(``parallel/sharded_knn.py``). The training half — ``ring_attention``,
``ulysses_attention`` and ``pipeline`` — is not ported yet and raises
naming its ROADMAP item.
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
from pathway_tpu_torch.parallel import pipeline  # noqa: F401
from pathway_tpu_torch.parallel.pipeline import _not_ported


def ring_attention(*args, **kwargs):
    """Sequence-parallel ring attention: not ported yet."""
    raise _not_ported("parallel.ring_attention")


def ulysses_attention(*args, **kwargs):
    """All-to-all (Ulysses) sequence-parallel attention: not ported yet."""
    raise _not_ported("parallel.ulysses_attention")


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
    "pipeline",
]
