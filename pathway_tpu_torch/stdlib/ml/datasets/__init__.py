"""pw.ml.datasets — port of pathway_tpu/stdlib/ml/datasets/__init__.py
(reference: stdlib/ml/datasets — sklearn-backed loaders)."""

from pathway_tpu_torch.stdlib.ml.datasets import classification  # noqa: F401

__all__ = ["classification"]
