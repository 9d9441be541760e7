"""KNN inner indexes — port of pathway_tpu/stdlib/indexing/nearest_neighbors.py
(reference: stdlib/indexing/nearest_neighbors.py — BruteForceKnn:141,
USearchKnn:48, LshKnn:221).

BruteForceKnn and LshKnn run on the port's device brute-force index
(ops/knn.py): an exact scan. With an embedder that has
``encode_batch_device`` (EncoderEmbedder), the factory wraps the index in
the port's ``DeviceEmbeddingKnnIndex``, which takes raw text and embeds it
on the device. Not ported, each raising ``NotImplementedError`` naming its
ROADMAP item: ``mesh`` (the sharded index), tenants and page quotas, and
USearchKnn's native HNSW.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

from pathway_tpu_torch.internals import expression as ex
from pathway_tpu_torch.ops.knn import (BruteForceKnnIndex,
                                       DeviceEmbeddingKnnIndex, KnnMetric)
from pathway_tpu_torch.stdlib.indexing.data_index import InnerIndex

_MESH = "ROADMAP queue 1, item 5: parallel/ (the mesh-sharded index)"
_TENANTS = "ROADMAP queue 1, item 4: tenants and quotas in the page allocator"
_HNSW = "ROADMAP queue 1, item 4: USearchKnn's native HNSW"


class BruteForceKnnMetricKind:
    L2SQ = KnnMetric.L2SQ
    COS = KnnMetric.COS


def _check_ported(mesh, tenant, tenant_quotas) -> None:
    if mesh is not None:
        raise NotImplementedError(
            f"BruteForceKnn(mesh=...) is not ported to pathway_tpu_torch yet "
            f"({_MESH})")
    if tenant is not None or tenant_quotas:
        raise NotImplementedError(
            "BruteForceKnn(tenant=..., tenant_quotas=...) is not ported to "
            f"pathway_tpu_torch yet ({_TENANTS})")


@dataclass
class BruteForceKnnFactory:
    """Engine-side index factory (reference: ExternalIndexFactory,
    src/external_integration/mod.rs:46). ``dtype='bfloat16'`` halves the
    slab's bytes and its scan time; ``dtype='int8'`` halves them again
    (per-row quantization on the device, host mirror exact f32). The
    index lives on the embedder's device when it has one, else on
    ``device`` (default "cuda")."""

    dimensions: int | None = None
    reserved_space: int = 1024
    metric: KnnMetric = KnnMetric.L2SQ
    embedder: Any = None
    mesh: Any = None
    dtype: str = "float32"
    # False forces the vector-input engine index even for device-capable
    # embedders (set by DataIndex when a query-embedder override is in
    # play: the fused text path could not honor it)
    fuse: bool = True
    tenant: Any = None
    tenant_quotas: dict | None = None
    device: str = "cuda"

    def build(self):
        _check_ported(self.mesh, self.tenant, self.tenant_quotas)
        dim = self.dimensions
        if dim is None:
            dim = _probe_embedder_dimension(self.embedder)
        inner = BruteForceKnnIndex(
            dim, reserved_space=self.reserved_space, metric=self.metric,
            dtype=self.dtype,
            device=getattr(self.embedder, "device", None) or self.device)
        # device-capable embedder: the engine index takes raw text and
        # embeds on the device; embeddings never visit the host. The gate
        # mirrors BruteForceKnn.embeds_internally, which decides whether
        # the DataIndex feeds text or vectors
        if self.fuse and hasattr(self.embedder, "encode_batch_device"):
            return DeviceEmbeddingKnnIndex(self.embedder, inner)
        return inner


def _probe_embedder_dimension(embedder) -> int:
    if embedder is None:
        raise ValueError("dimensions required when no embedder is given")
    from pathway_tpu_torch.xpacks.llm._utils import get_embedding_dimension

    return get_embedding_dimension(embedder)


class BruteForceKnn(InnerIndex):
    def __init__(self, data_column: ex.ColumnReference,
                 metadata_column: ex.ColumnExpression | None = None, *,
                 dimensions: int | None = None, reserved_space: int = 1024,
                 metric: KnnMetric = KnnMetric.L2SQ, embedder: Any = None,
                 mesh: Any = None, dtype: str = "float32",
                 tenant: Any = None, tenant_quotas: dict | None = None,
                 device: str = "cuda"):
        super().__init__(data_column, metadata_column)
        _check_ported(mesh, tenant, tenant_quotas)
        self.dimensions = dimensions
        self.reserved_space = reserved_space
        self.metric = metric
        self.embedder = embedder
        self.dtype = dtype
        # the index's device when there is no embedder (with one, the
        # embedder's device wins)
        self.device = device

    def factory(self) -> BruteForceKnnFactory:
        return BruteForceKnnFactory(
            dimensions=self.dimensions, reserved_space=self.reserved_space,
            metric=self.metric, embedder=self.embedder, dtype=self.dtype,
            device=self.device)

    @property
    def query_embedder(self):
        return self.embedder

    @property
    def embeds_internally(self) -> bool:
        """True when the engine index embeds raw text on the device itself
        (DeviceEmbeddingKnnIndex): the DataIndex then skips the UDF
        embedding column for both data and queries."""
        return hasattr(self.embedder, "encode_batch_device")


class USearchKnn(BruteForceKnn):
    """The reference's approximate HNSW index. Not ported: raises rather
    than turning silently into the exact scan."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            f"USearchKnn is not ported to pathway_tpu_torch yet ({_HNSW}); "
            "BruteForceKnn is the exact scan on the device")


class LshKnn(BruteForceKnn):
    """API-compatible with the reference's LshKnn (random-projection LSH);
    runs as the exact scan on the device, as in the JAX package."""

    def __init__(self, data_column, metadata_column=None, *, dimensions=None,
                 n_or: int = 20, n_and: int = 10, bucket_length: float = 10.0,
                 distance_type: str = "euclidean", reserved_space: int = 1024,
                 embedder=None):
        metric = KnnMetric.COS if distance_type == "cosine" else KnnMetric.L2SQ
        super().__init__(data_column, metadata_column, dimensions=dimensions,
                         reserved_space=reserved_space, metric=metric,
                         embedder=embedder)
