"""The port's mesh-sharded KNN index on the card (four shards on one
H100) against the same index on a ``[cpu] * 4`` mesh, whose search runs
the kernels' plain versions: the same slots, the kernels launched once a
shard and extent a search (their score twins once a chunk past K_MAX),
and the same keys outside ties, distances within 1e-5. This file imports
no JAX, so its tests run on the card: ``python -m pytest --noconftest -q
-m cuda tests/test_torch_sharded_knn_card.py``."""

import numpy as np
import pytest
import torch

from pathway_tpu_torch.internals.keys import Pointer
from pathway_tpu_torch.parallel import mesh as tmesh
from pathway_tpu_torch.parallel import sharded_knn as tsk


def _books(idx) -> tuple:
    return ({int(k): s for k, s in idx._key_to_slot.items()},
            [(p.pid, p.live, list(p.free)) for p in idx._allocator.pages],
            list(idx._shard_free_rows), idx.page_stats())


def _same_outside_ties(ref, got, tol: float) -> None:
    assert len(got) == len(ref)
    ref_d = {int(k): d for k, d in ref}
    for (rk, rd), (gk, gd) in zip(ref, got):
        assert abs(gd - rd) <= tol
        if int(gk) != int(rk):
            assert abs(ref_d.get(int(gk), ref[-1][1]) - rd) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_sharded_index_on_card_matches_cpu(dtype):
    from pathway_tpu_torch.ops.knn_kernels import (SCORE_BF16, SCORE_I8,
                                                   TOPK_BF16, TOPK_I8)

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: K2 and K3 are CUDA-only")
    rng = np.random.default_rng(20)
    vecs = rng.normal(size=(3000, 384)).astype(np.float32)
    qs = rng.normal(size=(5, 384)).astype(np.float32)
    topk, score = ((TOPK_BF16, SCORE_BF16) if dtype == "bfloat16"
                   else (TOPK_I8, SCORE_I8))
    got = {}
    for name in ("cuda", "cpu"):
        mesh = tmesh.make_mesh(tmesh.MeshConfig(data=4),
                               devices=[torch.device(name)] * 4)
        idx = tsk.ShardedKnnIndex(384, mesh=mesh, reserved_space=1000,
                                  page_rows=128, dtype=dtype, metric="cos")
        idx.add_batch([Pointer(i) for i in range(3000)], vecs)
        for i in range(0, 3000, 7):
            idx.remove(Pointer(i))
        topk.launches = score.launches = 0
        plain = idx.search([(Pointer(-1 - i), q, 10, None)
                            for i, q in enumerate(qs)])
        n_topk = topk.launches
        filtered = idx.search([(Pointer(-1 - i), q, 20, lambda m: True)
                               for i, q in enumerate(qs)])
        got[name] = (_books(idx), plain, filtered, n_topk, score.launches,
                     idx._extents)
    books, plain, filtered, n_topk, n_score, exts = got["cuda"]
    assert books == got["cpu"][0]
    assert all(t.device.type == "cuda" for e in exts for t in e.vectors)
    assert n_topk == 4 * len(exts)
    # fetch 80 > K_MAX: one score launch a chunk of each shard's extents
    assert n_score == 4 * len(exts)
    for ref, res in ((got["cpu"][1], plain), (got["cpu"][2], filtered)):
        for a, b in zip(ref, res):
            _same_outside_ties(a, b, 1e-5)
