"""Shared helpers for the LLM xpack — port of pathway_tpu/xpacks/llm/_utils.py,
trimmed to what the vector store and the KNN factory use."""

from __future__ import annotations

from typing import Any, Callable

import numpy as np

from pathway_tpu_torch.internals import udfs


def _coerce_sync(fn: Callable) -> Callable:
    """Run a coroutine function synchronously (for client helper calls)."""
    import asyncio
    import inspect

    if not inspect.iscoroutinefunction(fn):
        return fn

    def wrapper(*args, **kwargs):
        return asyncio.run(fn(*args, **kwargs))

    return wrapper


def _unwrap_udf(fn: Any) -> Callable:
    """Accept either a plain function or a pw.UDF and return a callable."""
    if isinstance(fn, udfs.UDF):
        return _coerce_sync(fn.func)
    return _coerce_sync(fn)


def get_embedding_dimension(embedder) -> int:
    """Output dimension of any embedder (UDF or plain fn), probing with one
    call when it can't tell us (reference embedders.py:63)."""
    if hasattr(embedder, "get_embedding_dimension"):
        return int(embedder.get_embedding_dimension())
    result = np.asarray(_unwrap_udf(embedder)("."))
    if result.ndim == 2:
        result = result[0]
    return int(result.shape[0])
