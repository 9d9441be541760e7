"""Classification dataset loaders — port of
pathway_tpu/stdlib/ml/datasets/classification/__init__.py (reference:
stdlib/ml/datasets/classification/__init__.py — fetch + split into
(train, test, train_labels, test_labels) Tables keyed so labels align
with their data rows).

``load_digits_sample`` serves the reference's shape from scikit-learn's
BUNDLED digits set, so classifier examples and tests run offline; its
tables are built by ``debug.table_from_rows`` (no pandas), and sklearn
is imported only when it is called. ``load_mnist_sample`` fetches from
openml, which needs the network: the port does not fetch, and it raises.
"""

from __future__ import annotations

import numpy as np


def _split_tables(X, y, train_size: int, test_size: int):
    """(train, test, train_labels, test_labels) Tables; each label table
    shares its data table's keys (both are selects of one
    ``table_from_rows`` table of (data, label) rows), so ``.ix`` lookups
    line up. The keys are the port's ``table_from_rows`` keys, not the
    JAX package's (its pandas tables key by row number)."""
    from pathway_tpu_torch.debug import table_from_rows
    from pathway_tpu_torch.internals.schema import schema_from_types

    def split(xs, ys):
        both = table_from_rows(
            schema_from_types(data=np.ndarray, label=str),
            [(np.asarray(row), str(lbl)) for row, lbl in zip(xs, ys)])
        return both.select(data=both.data), both.select(label=both.label)

    train, train_labels = split(X[:train_size], y[:train_size])
    test, test_labels = split(X[train_size:train_size + test_size],
                              y[train_size:train_size + test_size])
    return train, test, train_labels, test_labels


def load_mnist_sample(sample_size: int = 70000):
    """(train_table, test_table, train_labels, test_labels) of an MNIST
    sample in the reference's signature. The JAX package fetches MNIST
    from openml; that needs the network, and the port does not fetch:
    use :func:`load_digits_sample`, the bundled offline set."""
    raise NotImplementedError(
        "load_mnist_sample fetches MNIST from openml over the network, "
        "which pathway_tpu_torch does not do; load_digits_sample serves "
        "the same tables from scikit-learn's bundled digits set")


def load_digits_sample(sample_size: int = 1797, *, shuffle_seed: int = 0):
    """Same output shape as :func:`load_mnist_sample`, from sklearn's
    BUNDLED 8x8 digits set (1,797 samples, no network) — the offline
    dataset for classifier examples and tests.

    >>> train, test, train_labels, test_labels = load_digits_sample(200)
    >>> train.column_names(), train_labels.column_names()
    (['data'], ['label'])
    """
    try:
        from sklearn.datasets import load_digits  # type: ignore
    except ImportError as e:
        raise ImportError(
            "load_digits_sample needs scikit-learn") from e

    X, y = load_digits(return_X_y=True)
    X = X / 16.0
    rng = np.random.default_rng(shuffle_seed)
    order = rng.permutation(len(X))[:sample_size]
    X, y = X[order], y[order].astype(str)
    train_size = int(len(X) * 6 / 7)
    return _split_tables(X, y, train_size, len(X) - train_size)


__all__ = ["load_mnist_sample", "load_digits_sample"]
