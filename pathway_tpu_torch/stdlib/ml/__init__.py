"""pw.stdlib.ml — port of pathway_tpu/stdlib/ml/__init__.py: the classic
``KNNIndex`` (``index.py``), the kNN and LSH classifiers with LSH
clustering and its k-means on the card (``classifiers``), HMM decoding
(``hmm``), the fuzzy joins (``smart_table_ops``), ``utils`` and the
offline datasets (``datasets``)."""

from pathway_tpu_torch.stdlib.ml import (  # noqa: F401
    classifiers,
    hmm,
    index,
    smart_table_ops,
    utils,
)
from pathway_tpu_torch.stdlib.ml.index import KNNIndex  # noqa: F401
from pathway_tpu_torch.stdlib.ml.smart_table_ops import (  # noqa: F401
    FuzzyJoinFeatureGeneration,
    FuzzyJoinNormalization,
    fuzzy_match,
    fuzzy_match_tables,
    fuzzy_self_match,
    smart_fuzzy_match,
)

__all__ = [
    "KNNIndex", "classifiers", "hmm", "index", "smart_table_ops", "utils",
    "FuzzyJoinFeatureGeneration", "FuzzyJoinNormalization", "fuzzy_match",
    "fuzzy_match_tables", "fuzzy_self_match", "smart_fuzzy_match",
]

from pathway_tpu_torch.stdlib.ml import datasets  # noqa: F401,E402
