"""pw.stdlib.utils — port of pathway_tpu/stdlib/utils/__init__.py, trimmed
to what ``stdlib.ml`` uses: ``col``, ``filtering`` and ``bucketing``. Not
ported yet, each raising where asked: ``AsyncTransformer`` (ROADMAP queue
1, step 7, item 6h) and ``pandas_transformer`` (step 9, item 9d)."""

from pathway_tpu_torch.stdlib.utils import bucketing  # noqa: F401
from pathway_tpu_torch.stdlib.utils import col  # noqa: F401
from pathway_tpu_torch.stdlib.utils import filtering  # noqa: F401


def __getattr__(name: str):
    if name in ("AsyncTransformer", "async_transformer",
                "pandas_transformer"):
        raise NotImplementedError(
            f"pw.stdlib.utils.{name} is not ported to pathway_tpu_torch yet "
            "(ROADMAP queue 1: AsyncTransformer step 7, item 6h; "
            "pandas_transformer step 9, item 9d)")
    raise AttributeError(
        f"module 'pathway_tpu_torch.stdlib.utils' has no attribute {name!r}")


__all__ = ["bucketing", "col", "filtering"]
