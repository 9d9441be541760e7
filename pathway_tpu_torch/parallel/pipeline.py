"""Pipeline-parallel encoder blocks (the JAX package's
pathway_tpu/parallel/pipeline.py): not ported yet. Every name of this
module raises ``NotImplementedError`` naming its ROADMAP item."""

from __future__ import annotations

_TRAINING = "ROADMAP queue 1, step 5b (item 5): the training half of parallel/"


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to pathway_tpu_torch yet ({_TRAINING})")


def __getattr__(name: str):
    if name.startswith("__"):
        raise AttributeError(name)
    raise _not_ported(f"parallel.pipeline.{name}")
