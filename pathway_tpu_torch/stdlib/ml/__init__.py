"""pw.stdlib.ml — port of pathway_tpu/stdlib/ml/__init__.py, trimmed to the
classic ``KNNIndex`` (``index.py``). Not ported yet, each named in ROADMAP
queue 1 step 8: the classifiers (with ``_clustering.py``), ``hmm``,
``smart_table_ops`` (the fuzzy joins), ``utils`` and ``datasets``."""

from pathway_tpu_torch.stdlib.ml import index  # noqa: F401
from pathway_tpu_torch.stdlib.ml.index import KNNIndex  # noqa: F401

__all__ = ["KNNIndex", "index"]
