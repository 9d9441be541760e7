"""Port counterpart of the same-named pathway_tpu subpackage.

``indexing``, ``ml``, ``ordered``, ``stateful``, ``statistical``,
``temporal`` and ``utils`` load on first attribute access
(``pw.stdlib.temporal``)."""

from __future__ import annotations

import importlib

_SUBMODULES = ("indexing", "ml", "ordered", "stateful", "statistical",
               "temporal", "utils")


def __getattr__(name: str):
    if name not in _SUBMODULES:
        raise AttributeError(
            f"module 'pathway_tpu_torch.stdlib' has no attribute {name!r}")
    return importlib.import_module(f"{__name__}.{name}")
