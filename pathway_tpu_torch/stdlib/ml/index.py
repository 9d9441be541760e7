"""The classic KNNIndex API — port of pathway_tpu/stdlib/ml/index.py
(reference: stdlib/ml/index.py:9-52).

The reference backs this with LSH bucketing and a per-row numpy UDF; the
JAX package and the port run every variant as the exact brute-force scan
of ``BruteForceKnn`` under ``DataIndex``. The index's slab is float32, so
a search is ``torch.matmul`` plus the key selection (the f32 route of
``ops/knn.py``; no hand-written kernel, as in the JAX package, where an
f32 search is an XLA product). ``device`` places the index ("cuda" unless
the caller passes "cpu"); the LSH parameters are accepted and unused, as
in the JAX package.
"""

from __future__ import annotations

from pathway_tpu_torch.internals import expression as ex
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.ops.knn import KnnMetric
from pathway_tpu_torch.stdlib.indexing.data_index import DataIndex
from pathway_tpu_torch.stdlib.indexing.nearest_neighbors import BruteForceKnn


class KNNIndex:
    def __init__(self, data_embedding: ex.ColumnReference, data: Table, *,
                 n_dimensions: int, n_or: int = 20, n_and: int = 10,
                 bucket_length: float = 10.0, distance_type: str = "euclidean",
                 metadata: ex.ColumnExpression | None = None,
                 device: str = "cuda"):
        metric = KnnMetric.COS if distance_type == "cosine" else KnnMetric.L2SQ
        inner = BruteForceKnn(
            data_embedding, metadata, dimensions=n_dimensions,
            metric=metric, device=device)
        self._index = DataIndex(data, inner)
        self._data = data

    def get_nearest_items(self, query_embedding: ex.ColumnReference, k=3, *,
                          collapse_rows: bool = True,
                          with_distances: bool = False,
                          metadata_filter: ex.ColumnExpression | None = None) -> Table:
        result = self._index.query(
            query_embedding, number_of_matches=k, collapse_rows=collapse_rows,
            metadata_filter=metadata_filter)
        return self._shape_result(result, with_distances)

    def get_nearest_items_asof_now(self, query_embedding: ex.ColumnReference,
                                   k=3, *, collapse_rows: bool = True,
                                   with_distances: bool = False,
                                   metadata_filter=None) -> Table:
        result = self._index.query_as_of_now(
            query_embedding, number_of_matches=k, collapse_rows=collapse_rows,
            metadata_filter=metadata_filter)
        return self._shape_result(result, with_distances)

    def _shape_result(self, result: Table, with_distances: bool) -> Table:
        cols = {n: result[n] for n in self._data.column_names()}
        if with_distances:
            return result.select(dist=result._pw_index_reply_score, **cols)
        return result.select(**cols)
