"""Port counterpart of pathway_tpu/stdlib/indexing: DataIndex over the
port's device KNN index. Not ported: the full-text (BM25) index, the
retrievers, the sorting helpers and USearchKnn's native HNSW (ROADMAP
queue 1, step 6); ``USearchKnn`` and ``default_usearch_knn_document_index``
raise, naming that item."""

from pathway_tpu_torch.stdlib.indexing.data_index import (  # noqa: F401
    DataIndex,
    InnerIndex,
)
from pathway_tpu_torch.stdlib.indexing.nearest_neighbors import (  # noqa: F401
    BruteForceKnn,
    BruteForceKnnFactory,
    BruteForceKnnMetricKind,
    LshKnn,
    USearchKnn,
)
from pathway_tpu_torch.stdlib.indexing.vector_document_index import (  # noqa: F401
    default_brute_force_knn_document_index,
    default_lsh_knn_document_index,
    default_usearch_knn_document_index,
    default_vector_document_index,
)

__all__ = [
    "DataIndex", "InnerIndex", "BruteForceKnn", "BruteForceKnnFactory",
    "BruteForceKnnMetricKind", "LshKnn", "USearchKnn",
    "default_brute_force_knn_document_index",
    "default_lsh_knn_document_index", "default_usearch_knn_document_index",
    "default_vector_document_index",
]
