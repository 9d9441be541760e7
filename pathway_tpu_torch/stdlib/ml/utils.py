"""ML helpers — port of pathway_tpu/stdlib/ml/utils.py
(reference: python/pathway/stdlib/ml/utils.py)."""

from __future__ import annotations

from pathway_tpu_torch.internals import reducers_frontend as reducers
from pathway_tpu_torch.internals.table import Table


def classifier_accuracy(predicted_labels: Table, exact_labels: Table) -> Table:
    """Rows (cnt, value) counting matching / non-matching predictions
    (reference utils.py classifier_accuracy)."""
    comparative = predicted_labels.select(
        predicted_label=predicted_labels.predicted_label,
        label=exact_labels.restrict(predicted_labels).label,
    )
    comparative = comparative.select(
        match=comparative.label == comparative.predicted_label)
    return comparative.groupby(comparative.match).reduce(
        cnt=reducers.count(), value=comparative.match)
