"""kNN classifiers — port of pathway_tpu/stdlib/ml/classifiers/__init__.py
(reference: stdlib/ml/classifiers/ — _knn_lsh.py, _lsh.py,
_clustering_via_lsh.py).

Two execution paths, both honoring the reference API:

- **exact (default)**: classification queries ride the exact KNN index
  of ``stdlib/ml/index.py`` on ``device`` ("cuda" unless the caller asks
  for the CPU): one matrix product over the index's rows, the default
  when no LSH shape is requested.
- **bucketed LSH (opt-in)**: passing the LSH shape (``d``/``M``/``A`` …)
  runs real banded candidate retrieval + voting, matching the reference's
  `_knn_lsh.py:135` semantics (L OR-bands of M AND-projections; candidate
  union; k nearest by the requested metric; majority vote). Parameters
  are honored, never silently dropped.
"""

from __future__ import annotations

from typing import Literal

import numpy as np

import pathway_tpu_torch.internals.reducers_frontend as reducers
from pathway_tpu_torch.internals import expression as ex
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.stdlib.ml.classifiers._clustering import (  # noqa: F401
    clustering_via_lsh,
    kmeans_labels,
)
from pathway_tpu_torch.stdlib.ml.classifiers._lsh import (  # noqa: F401
    generate_cosine_lsh_bucketer,
    generate_euclidean_lsh_bucketer,
    lsh,
)
from pathway_tpu_torch.stdlib.ml.index import KNNIndex


def _majority(labels):
    if not labels:
        return None
    counts: dict = {}
    for label in labels:
        counts[label] = counts.get(label, 0) + 1
    return max(counts.items(), key=lambda kv: (kv[1], str(kv[0])))[0]


def knn_lsh_classifier_train(data: Table, L: int = 20,
                             type: str = "euclidean", *,
                             device: str = "cuda", **lsh_params):
    """Returns a classify(queries, k) function closed over the trained
    index (reference: classifiers/_knn_lsh.py:135).

    With an LSH shape in ``lsh_params`` (``d`` plus any of ``M``/``A``/
    ``bucket_length``) the classifier uses real banded bucketing; with
    only a dimension hint (``n_dimensions``) it uses the exact scan of a
    ``KNNIndex`` on ``device``.
    Unknown parameters raise — silent dropping would misreport what ran.
    """
    params = dict(lsh_params)
    d = params.pop("d", None)
    n_dim = params.pop("n_dimensions", None) or d
    M = params.pop("M", None)
    A = params.pop("A", params.pop("bucket_length", None))
    if params:
        raise TypeError(
            f"unsupported lsh_params {sorted(params)} — supported: d, "
            "n_dimensions, M, A/bucket_length")

    wants_lsh = d is not None and (M is not None or A is not None)
    if wants_lsh:
        if type == "cosine":
            bucketer = generate_cosine_lsh_bucketer(d, M or 10, L)
        else:
            bucketer = generate_euclidean_lsh_bucketer(
                d, M or 10, L, A if A is not None else 1.0)
        return knn_lsh_generic_classifier_train(
            data, bucketer, _distance_fn(type), L)

    index = KNNIndex(data.data, data, n_dimensions=n_dim,
                     distance_type="cosine" if type == "cosine"
                     else "euclidean", device=device)

    def classify(queries: Table, k: int = 3) -> Table:
        matched = index.get_nearest_items(queries.data, k=k)
        return matched.select(predicted_label=ex.ApplyExpression(
            _majority, None, matched.label))

    return classify


def _distance_fn(type: str):
    if type == "cosine":
        def dist(q, v):
            q = np.asarray(q, dtype=np.float64)
            v = np.asarray(v, dtype=np.float64)
            denom = (np.linalg.norm(q) * np.linalg.norm(v)) or 1.0
            return 1.0 - float(q @ v) / denom
    else:
        def dist(q, v):
            q = np.asarray(q, dtype=np.float64)
            v = np.asarray(v, dtype=np.float64)
            return float(np.sum((q - v) ** 2))
    return dist


def knn_lsh_euclidean_classifier_train(data: Table, d: int, M: int, L: int,
                                       A: float):
    """Euclidean LSH classifier with the full parameter surface honored
    (reference _knn_lsh.py:290)."""
    return knn_lsh_classifier_train(data, L, "euclidean", d=d, M=M, A=A)


def knn_lsh_generic_classifier_train(data: Table, lsh_projection,
                                     distance_function, L: int):
    """Banded candidate retrieval + exact re-rank + majority vote over a
    user-provided projection (reference _knn_lsh.py:137).

    Train: flatten data into (band, bucket) rows, group each band's
    bucket into a candidate tuple. Classify: bucket the queries the same
    way, union candidates across the L OR-bands, re-rank candidates by
    ``distance_function`` and vote over the k nearest — incremental all
    the way (bucket groups revise as data changes).
    """
    flat = lsh(data, lsh_projection, origin_id="data_id")
    buckets = flat.groupby(flat.band, flat.bucketing).reduce(
        flat.band, flat.bucketing,
        items=reducers.sorted_tuple(flat.data_id))

    def classify(queries: Table, k: int = 3) -> Table:
        qflat = lsh(queries, lsh_projection, origin_id="query_id")
        cand = qflat.join(
            buckets,
            qflat.band == buckets.band,
            qflat.bucketing == buckets.bucketing,
        ).select(qflat.query_id, buckets.items)
        pairs = cand.flatten(cand.items, origin_id="_pw_cand_origin")
        pairs = pairs.select(
            query_id=cand.ix(pairs._pw_cand_origin, context=pairs).query_id,
            cid=pairs.items)
        # OR-bands produce duplicate candidates: dedup per (query, cand)
        pairs = pairs.groupby(pairs.query_id, pairs.cid).reduce(
            pairs.query_id, pairs.cid)

        dpoint = data.ix(pairs.cid, context=pairs)
        qpoint = queries.ix(pairs.query_id, context=pairs)
        scored = pairs.select(
            pairs.query_id,
            dist=ex.ApplyExpression(distance_function, None,
                                    qpoint.data, dpoint.data),
            label=dpoint.label,
        )
        ranked = scored.groupby(id=scored.query_id).reduce(
            pairs=reducers.sorted_tuple(
                ex.MakeTupleExpression(scored.dist, scored.label)))

        def vote(ranked_pairs, limit=k):
            return _majority([label for _d, label in
                              (ranked_pairs or ())[:limit]])

        voted = ranked.select(predicted_label=ex.ApplyExpression(
            vote, None, ranked.pairs))
        # queries with NO bucket collisions still get a row (None label),
        # like the reference's empty-candidate branch
        padded = queries.select(predicted_label=None).update_cells(
            voted.promise_universe_is_subset_of(queries))
        return padded

    return classify


def knn_lsh_classify(classifier, queries: Table, k: int = 3) -> Table:
    """Apply a trained classifier (reference _knn_lsh.py:320)."""
    return classifier(queries, k)


# reference export aliases (classifiers/__init__.py:13,16; _knn_lsh.py:43)
knn_lsh_train = knn_lsh_classifier_train
DistanceTypes = Literal["euclidean", "cosine"]

__all__ = [
    "clustering_via_lsh", "kmeans_labels", "lsh",
    "generate_cosine_lsh_bucketer", "generate_euclidean_lsh_bucketer",
    "knn_lsh_classifier_train", "knn_lsh_train", "knn_lsh_classify",
    "knn_lsh_euclidean_classifier_train",
    "knn_lsh_generic_classifier_train", "DistanceTypes",
]
