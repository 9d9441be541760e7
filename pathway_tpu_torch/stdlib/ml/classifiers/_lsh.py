"""LSH bucketers + the flat LSH representation — port of
pathway_tpu/stdlib/ml/classifiers/_lsh.py (numpy only: the same
projections from the same seeded generator, so a bucketer's band codes
equal the JAX package's bit for bit).

Rebuild of the reference's LSH layer (stdlib/ml/classifiers/_lsh.py:31
generate_euclidean_lsh_bucketer, :62 generate_cosine_lsh_bucketer, lsh()).
A bucketer maps a vector to L band codes (M AND-projections hashed per
band); ``lsh`` flattens a table into L rows per input row, one per band —
the join key for bucketed candidate retrieval and pre-clustering.

Projections are drawn once per bucketer (seeded) and applied as one
matrix product per call — vectorized over M*L lines, not a Python loop
per line.
"""

from __future__ import annotations

from typing import Callable

import numpy as np

from pathway_tpu_torch.internals import expression as ex
from pathway_tpu_torch.internals.table import Table


def _band_codes(projected: np.ndarray, L: int) -> np.ndarray:
    """(M*L,) int buckets → (L,) stable int64 code per band (order-sensitive
    hash of the band's M bucket ids)."""
    bands = projected.reshape(L, -1)
    # polynomial rolling hash in uint64 — stable across runs, cheap, and
    # collision-safe enough for bucketing (not cryptographic)
    out = np.full(L, 1469598103934665603, dtype=np.uint64)
    for j in range(bands.shape[1]):
        out ^= bands[:, j].astype(np.uint64)
        out *= np.uint64(1099511628211)
    return out.astype(np.int64)


def generate_euclidean_lsh_bucketer(
        d: int, M: int = 10, L: int = 20, A: float = 1.0,
        seed: int = 0) -> Callable[[np.ndarray], np.ndarray]:
    """p-stable Euclidean LSH: project onto M*L random unit lines, floor
    into buckets of length ``A``, hash each band's M buckets to one code
    (reference _lsh.py:31)."""
    gen = np.random.default_rng(seed)
    lines = gen.standard_normal((d, M * L))
    lines = lines / np.linalg.norm(lines, axis=0)
    shift = gen.random(size=M * L) * A

    def bucketify(x: np.ndarray) -> np.ndarray:
        proj = np.floor_divide(np.asarray(x, dtype=np.float64) @ lines
                               + shift, A).astype(np.int64)
        return _band_codes(proj, L)

    bucketify.n_bands = L  # type: ignore[attr-defined]
    return bucketify


def generate_cosine_lsh_bucketer(
        d: int, M: int = 10, L: int = 20,
        seed: int = 0) -> Callable[[np.ndarray], np.ndarray]:
    """SimHash: each projection contributes a sign bit; a band's M bits
    form its code (reference _lsh.py:62)."""
    gen = np.random.default_rng(seed)
    lines = gen.standard_normal((d, M * L))

    def bucketify(x: np.ndarray) -> np.ndarray:
        bits = (np.asarray(x, dtype=np.float64) @ lines >= 0).astype(
            np.int64)
        return _band_codes(bits, L)

    bucketify.n_bands = L  # type: ignore[attr-defined]
    return bucketify


def lsh(data: Table, bucketer, *, origin_id: str = "origin_id",
        include_data: bool = False) -> Table:
    """Flat LSH representation: one row per (input row, band) with the
    band index and that band's bucket code (reference _lsh.py lsh()).
    ``data`` must have a ``data`` column of vectors."""

    def explode(vec) -> tuple:
        codes = bucketer(vec)
        return tuple((band, int(code)) for band, code in enumerate(codes))

    rows = data.select(
        _pw_bands=ex.ApplyExpression(explode, None, data.data))
    flat = rows.flatten(rows._pw_bands, origin_id=origin_id)
    cols = {
        origin_id: flat[origin_id],
        "band": ex.ApplyExpression(lambda b: int(b[0]), int, flat._pw_bands),
        "bucketing": ex.ApplyExpression(lambda b: int(b[1]), int,
                                        flat._pw_bands),
    }
    if include_data:
        cols["data"] = data.ix(flat[origin_id], context=flat).data
    return flat.select(**cols)
