"""Warm-up of the serving path — port of pathway_tpu/warmup.py.

``pw.warmup(embedder, index=...)`` walks the shapes the serving path
dispatches before the first real tick: each padded width bucket
(``EncoderEmbedder.bucket_widths``) through the fused encode + write, or
under ragged batching each sequence-count bucket (``ragged_buckets``)
through the fused step, whose first chunk of a shape captures its CUDA
graph (ops/knn.py ``GraphedIngestStep``); then the index's search for
each fan-out in ``ks``. In eager PyTorch the one-time costs it moves out
of the first ticks are the graph captures, the kernel libraries' first
load (nvcc builds on first launch), cuBLAS handles and workspaces, the
caching allocator's blocks for each shape and the pinned staging buffers.

Under ``PATHWAY_DEVICE_SANITIZER`` (engine/device_sanitizer.py) the walk
is the sanitizer's warm-up window: captures during it count as warm-up,
and completion declares steady state.

The JAX package's persistent XLA compilation cache has no counterpart:
eager PyTorch compiles nothing that a cache could keep, so
``enable_compilation_cache`` and ``maybe_enable_compilation_cache``
return None, the JAX function's own answer when its runtime has no
persistent cache.

First of all the walk takes every live auto-jit program's bucket ladder
(internals/autojit.py ``warm_registered``): 8, 16, ... up to
``autojit_max_bucket`` (default ``PATHWAY_AUTO_JIT_WARM_MAX``, 2048), one
CUDA graph captured a bucket on the card.
"""

from __future__ import annotations

import time as _time
from typing import Any

#: The serving entry points whose shapes warm-up's ladder covers (the
#: JAX package's registry, which its static perf check parses: keep it a
#: plain frozenset of string constants).
WARMED_ENTRY_POINTS = frozenset({
    "encode_jit",   # models/encoder.py — packed encoder forward
})

#: scratch keys of the fused warm-up: (1 << 62) + i, removed afterwards
_SCRATCH_KEY0 = 1 << 62


def enable_compilation_cache(path: str | None = None) -> str | None:
    """No persistent compilation cache exists for eager PyTorch: returns
    None (the JAX function's answer when its runtime has none)."""
    del path
    return None


def maybe_enable_compilation_cache() -> str | None:
    """None: see :func:`enable_compilation_cache`."""
    return None


def warmup(embedder: Any = None, *, index: Any = None,
           batch_size: int | None = None, ks: tuple[int, ...] = (),
           cache: bool = True, autojit_max_bucket: int | None = None) -> dict:
    """Walk the serving path's shapes so no one-time set-up (a CUDA graph
    capture above all) lands inside a live tick.

    ``embedder``: an ``EncoderEmbedder`` (``bucket_widths()``,
    ``device_producer``, ``model``); every bucket width is run at
    ``batch_size`` rows (default: the embedder's ``max_batch_size``, else
    32). Pin the engine's batch with ``max_batch_size=batch_size`` so every
    full dispatch is a warmed shape.

    ``index``: optionally a device KNN index. A fused
    ``DeviceEmbeddingKnnIndex`` runs the encode + write at every width (or
    ragged bucket) through scratch keys, removed and flushed afterwards; a
    non-empty index also runs its search for each fan-out in ``ks``, and a
    non-empty ``ks`` runs the plain encoder too (text queries dispatch it).

    ``autojit_max_bucket``: the largest bucket of the auto-jit ladder walk
    (module docstring). ``cache`` is the JAX signature's; it has nothing to
    act on in the port.

    Returns ``{"cache_dir", "compiled", "seconds"}``; ``compiled`` lists
    the (kind, shape) pairs walked, the JAX package's names: ``autojit``
    (``(label, bucket)``), ``encode``, ``fused_ingest``, ``ragged_encode``,
    ``ragged_fused_ingest``, ``search``.

    Under ``PATHWAY_DEVICE_SANITIZER`` the call brackets the sanitizer's
    warm-up window and declares steady state when it ends; warming an
    armed process again suspends steady state instead of violating it.
    """
    from pathway_tpu_torch.engine import device_sanitizer as _ds

    _ds.arm()
    with _ds.suspend_steady_state("pw.warmup ladder walk"):
        out = _warmup_impl(embedder, index=index, batch_size=batch_size,
                           ks=ks, cache=cache,
                           autojit_max_bucket=autojit_max_bucket)
    _ds.declare_steady_state()
    return out


def _warmup_impl(embedder: Any = None, *, index: Any = None,
                 batch_size: int | None = None, ks: tuple[int, ...] = (),
                 cache: bool = True,
                 autojit_max_bucket: int | None = None) -> dict:
    t0 = _time.perf_counter()
    out: dict = {"cache_dir": None, "compiled": []}
    if cache:
        out["cache_dir"] = enable_compilation_cache()
    from pathway_tpu_torch.internals.autojit import warm_registered

    out["compiled"].extend(warm_registered(autojit_max_bucket))
    if embedder is None and index is None:
        out["seconds"] = round(_time.perf_counter() - t0, 3)
        return out

    import numpy as np
    import torch

    from pathway_tpu_torch.internals.keys import Pointer

    if embedder is None and index is not None:
        embedder = getattr(index, "embedder", None)

    widths: list[int] = []
    if embedder is not None and hasattr(embedder, "bucket_widths"):
        widths = embedder.bucket_widths()
    B = (batch_size or getattr(embedder, "max_batch_size", None) or 32)

    def packed_operands(w: int):
        dtype = np.int16 if getattr(embedder, "_pack_ids", False) \
            else np.int32
        ids = np.zeros((B, w), dtype)
        lens = np.full((B,), max(1, w - 2), np.int32)
        return ids, lens

    fused = getattr(index, "_fused", None)
    inner = getattr(index, "inner", index)
    if embedder is not None and getattr(embedder, "ragged", False):
        # ragged batching: the shapes are the sequence-count buckets at
        # one width; through the graphed step each captures its graph
        W = getattr(embedder, "max_len", 0)

        def ragged_encode(ops) -> None:
            embedder.ragged_device_producer(embedder.model, *ops)
            out["compiled"].append(("ragged_encode", (n_seqs, W)))

        for n_seqs in embedder.ragged_buckets():
            ops, n_docs = embedder.ragged_warmup_operands(n_seqs)
            if fused is None:
                ragged_encode(ops)
                continue
            scratch = [Pointer(_SCRATCH_KEY0 + i) for i in range(n_docs)]
            if not fused(scratch, embedder.model, *ops, n_rows=n_docs):
                # the scratch rows do not fit one extent: live ingest takes
                # the two-step path too, which runs the plain encoder
                ragged_encode(ops)
                continue
            for k in scratch:
                inner.remove(k)
            out["compiled"].append(("ragged_fused_ingest", (n_seqs, W)))
            if ks:
                # text queries use the plain ragged encoder
                ragged_encode(ops)
        if fused is not None:
            inner.flush_device()
    elif embedder is not None and widths:
        fused_used = False
        for w in widths:
            ids, lens = packed_operands(w)
            if fused is not None:
                scratch = [Pointer(_SCRATCH_KEY0 + i) for i in range(B)]
                if not fused(scratch, embedder.model, ids, lens):
                    # the scratch rows do not fit one extent: live ingest
                    # will take the two-step path, which runs the plain
                    # encoder — warm that
                    fused = None
                    embedder.device_producer(embedder.model, ids, lens)
                    out["compiled"].append(("encode", (B, w)))
                    continue
                fused_used = True
                for k in scratch:
                    inner.remove(k)
                out["compiled"].append(("fused_ingest", (B, w)))
                if ks:
                    # text queries (DeviceEmbeddingKnnIndex.search) run the
                    # plain encoder
                    embedder.device_producer(embedder.model, ids, lens)
                    out["compiled"].append(("encode", (B, w)))
            else:
                embedder.device_producer(embedder.model, ids, lens)
                out["compiled"].append(("encode", (B, w)))
        if fused_used:
            # push the scratch removals now: the first live ingest must not
            # flush them inside a tick
            inner.flush_device()
    if index is not None and ks:
        search_index = inner if hasattr(inner, "_device_topk_parts") \
            else None
        if search_index is not None and len(search_index) > 0:
            for k in ks:
                search_index.search([(Pointer(_SCRATCH_KEY0),
                                      np.zeros(search_index.dim, np.float32),
                                      k, None)])
                out["compiled"].append(("search", (k,)))
    device = getattr(inner, "device", None) or getattr(embedder, "device",
                                                       None)
    if device is not None and torch.device(device).type == "cuda":
        from pathway_tpu_torch.engine import device_sanitizer as _ds

        with _ds.explicit_sync("warm-up end"):
            torch.cuda.synchronize(device)  # the walk's work has run
    out["seconds"] = round(_time.perf_counter() - t0, 3)
    return out
