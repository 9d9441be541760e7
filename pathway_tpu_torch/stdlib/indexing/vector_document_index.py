"""Sugar factories for document indexes — port of
pathway_tpu/stdlib/indexing/vector_document_index.py (reference:
stdlib/indexing/vector_document_index.py:34-210). The full-text (BM25)
factory is not ported; the usearch one raises (ROADMAP queue 1, item 4).
"""

from __future__ import annotations

from typing import Any

from pathway_tpu_torch.internals import expression as ex
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.ops.knn import KnnMetric
from pathway_tpu_torch.stdlib.indexing.data_index import DataIndex
from pathway_tpu_torch.stdlib.indexing.nearest_neighbors import (
    BruteForceKnn,
    LshKnn,
    USearchKnn,
)


def default_vector_document_index(
        data_column: ex.ColumnReference, data_table: Table, *,
        embedder: Any = None, dimensions: int | None = None,
        metadata_column: ex.ColumnExpression | None = None) -> DataIndex:
    return default_brute_force_knn_document_index(
        data_column, data_table, embedder=embedder, dimensions=dimensions,
        metadata_column=metadata_column)


def default_brute_force_knn_document_index(
        data_column: ex.ColumnReference, data_table: Table, *,
        embedder: Any = None, dimensions: int | None = None,
        reserved_space: int = 1024, metric: KnnMetric = KnnMetric.COS,
        metadata_column: ex.ColumnExpression | None = None,
        mesh: Any = None, dtype: str = "float32",
        tenant: Any = None,
        tenant_quotas: dict | None = None,
        device: str = "cuda") -> DataIndex:
    """``dtype='bfloat16'`` halves the slab's bytes and scan time;
    ``dtype='int8'`` halves them again (quantized on the device, host
    mirror exact f32). The index lives on the embedder's device, else on
    ``device`` (default "cuda"). ``mesh`` and ``tenant``/``tenant_quotas``
    are not ported and raise."""
    inner = BruteForceKnn(
        data_column, metadata_column, dimensions=dimensions,
        reserved_space=reserved_space, metric=metric, embedder=embedder,
        mesh=mesh, dtype=dtype, tenant=tenant, tenant_quotas=tenant_quotas,
        device=device)
    return DataIndex(data_table, inner)


def default_usearch_knn_document_index(
        data_column: ex.ColumnReference, data_table: Table, *,
        embedder: Any = None, **kwargs) -> DataIndex:
    return DataIndex(data_table, USearchKnn(data_column, embedder=embedder,
                                            **kwargs))


def default_lsh_knn_document_index(
        data_column: ex.ColumnReference, data_table: Table, *,
        embedder: Any = None, dimensions: int | None = None,
        metadata_column: ex.ColumnExpression | None = None) -> DataIndex:
    inner = LshKnn(data_column, metadata_column, dimensions=dimensions,
                   embedder=embedder)
    return DataIndex(data_table, inner)
