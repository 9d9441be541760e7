"""Port paged KNN index (pathway_tpu_torch/ops/knn.py +
engine/paged_store.py) against the JAX package's PagedKnnIndex under the
same ingest / delete / update / grow / search churn
(tests/test_paged_store.py's property): identical slot assignment and page
layout, identical top-k order, lowest-slot-first ties, close distances."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathway_tpu.internals.keys import Pointer as JPointer
from pathway_tpu.ops import knn as jknn
from pathway_tpu_torch.engine.paged_store import page_rows
from pathway_tpu_torch.internals.keys import Pointer
from pathway_tpu_torch.ops import knn as tknn

DIM = 16
# f32: same arithmetic up to summation order. bf16: both sides score the
# same bf16-rounded rows and queries in f32, so only the order of the f32
# sums differs; 1e-3 relative leaves room for distances near 0
TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
       "bfloat16": dict(rtol=1e-3, atol=1e-3)}


def _pair(metric: str, dtype: str, **kw):
    j = jknn.BruteForceKnnIndex(DIM, metric=jknn.KnnMetric(metric),
                                dtype=dtype, paged=True, **kw)
    t = tknn.BruteForceKnnIndex(DIM, metric=metric, dtype=dtype,
                                device="cpu", **kw)
    assert isinstance(t, tknn.PagedKnnIndex)
    return j, t


def _layout(idx):
    pool = idx._pool
    pages = [(p.pid, p.base, p.region, p.live) for p in pool.allocator.pages]
    extents = [(e.base, e.rows, e.established) for e in pool.extents]
    return ({int(k): s for k, s in idx._key_to_slot.items()}, pages, extents,
            pool.stats())


def _same_results(rj, rt, dtype):
    assert len(rj) == len(rt)
    for a, b in zip(rj, rt):
        assert [int(k) for k, _ in a] == [int(k) for k, _ in b]
        np.testing.assert_allclose([d for _, d in b], [d for _, d in a],
                                   **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("metric", ["l2sq", "cos"])
def test_churn_matches_jax_paged_index(metric, dtype):
    rng = np.random.default_rng(11)
    j, t = _pair(metric, dtype)
    live: list[int] = []
    next_key = 0
    ops = rng.choice(["ingest", "delete", "update", "search"], size=24)
    for n_op, op in enumerate(ops):
        if op == "ingest":
            n = int(rng.integers(50, 400))
            vecs = rng.normal(size=(n, DIM)).astype(np.float32)
            j.add_batch([JPointer(next_key + i) for i in range(n)], vecs)
            t.add_batch([Pointer(next_key + i) for i in range(n)], vecs)
            live.extend(range(next_key, next_key + n))
            next_key += n
        elif op == "delete" and live:
            kill = rng.choice(len(live), size=min(len(live), 120),
                              replace=False)
            for i in sorted(kill, reverse=True):
                k = live.pop(int(i))
                j.remove(JPointer(k))
                t.remove(Pointer(k))
        elif op == "update" and live:
            k = int(live[int(rng.integers(len(live)))])
            v = rng.normal(size=(1, DIM)).astype(np.float32)
            j.add_batch([JPointer(k)], v)
            t.add_batch([Pointer(k)], v)
        if op == "search" or n_op == len(ops) - 1:
            qs = [rng.normal(size=DIM).astype(np.float32) for _ in range(4)]
            lim = [int(rng.integers(1, 12)) for _ in range(4)]
            rj = j.search([(JPointer(10**9 + i), q, lim[i], None)
                           for i, q in enumerate(qs)])
            rt = t.search([(Pointer(10**9 + i), q, lim[i], None)
                           for i, q in enumerate(qs)])
            _same_results(rj, rt, dtype)
        assert _layout(t) == _layout(j)
    assert t.capacity > 1024, "churn never grew the store"
    assert len(t) == len(j) == len(live)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_duplicates_rank_lowest_slot_first_across_extents(dtype):
    rng = np.random.default_rng(5)
    j, t = _pair("l2sq", dtype)
    base = rng.normal(size=(1500, DIM)).astype(np.float32)
    dup = rng.normal(size=DIM).astype(np.float32)
    # the same vector at 7 keys, spread over the first extent and the one
    # the 1500-row ingest grows into; the remaining keys are far away
    base[[3, 400, 999, 1023, 1100, 1200, 1499]] = dup
    base[~np.isin(np.arange(1500), [3, 400, 999, 1023, 1100, 1200, 1499])] \
        += 50.0
    j.add_batch([JPointer(i) for i in range(1500)], base)
    t.add_batch([Pointer(i) for i in range(1500)], base)
    t.remove(Pointer(999))
    j.remove(JPointer(999))
    rj = j.search([(JPointer(10**9), dup, 6, None)])
    rt = t.search([(Pointer(10**9), dup, 6, None)])
    _same_results(rj, rt, dtype)
    slots = [t._key_to_slot[k] for k, _ in rt[0]]
    assert slots == sorted(slots)
    assert [int(k) for k, _ in rt[0]] == [3, 400, 1023, 1100, 1200, 1499]


def test_filters_over_fetch_and_exhaustive_fallback(monkeypatch):
    monkeypatch.setattr(jknn, "_CHUNK_ROWS", 128)
    monkeypatch.setattr(tknn, "_CHUNK_ROWS", 128)
    j, t = _pair("l2sq", "float32")
    rng = np.random.default_rng(4)
    n = 1400
    vecs = rng.normal(size=(n, DIM)).astype(np.float32)
    q = vecs[0] + 100.0
    allowed = set(np.argsort(np.sum((vecs - q) ** 2, axis=1))[-3:].tolist())
    fd = [{"ok": i in allowed} for i in range(n)]
    j.add_batch([JPointer(i) for i in range(n)], vecs, filter_data=fd)
    t.add_batch([Pointer(i) for i in range(n)], vecs, filter_data=fd)
    filt = lambda d: bool(d and d["ok"])  # noqa: E731
    rj = j.search([(JPointer(10**9), q, 3, filt)])
    rt = t.search([(Pointer(10**9), q, 3, filt)])
    assert {int(k) for k, _ in rt[0]} == allowed
    _same_results(rj, rt, "float32")


def test_fused_ingest_grows_like_jax():
    j, t = _pair("cos", "bfloat16")
    ji = j.make_fused_ingest(lambda x: x)
    ti = t.make_fused_ingest(lambda x: x)
    rng = np.random.default_rng(5)
    vals = None
    for base in range(0, 3000, 500):
        vals = rng.normal(size=(500, DIM)).astype(np.float32)
        ji([JPointer(base + i) for i in range(500)], jnp.asarray(vals))
        assert ti([Pointer(base + i) for i in range(500)],
                  torch.from_numpy(vals))
        assert _layout(t) == _layout(j)
    assert t.capacity >= 3000 and t.page_stats()["grow_events"] >= 1
    q = [(Pointer(10**9), vals[17], 5, None)]
    rt = t.search(q)
    assert rt[0][0][0] == Pointer(2500 + 17)
    _same_results(j.search([(JPointer(10**9), vals[17], 5, None)]), rt,
                  "bfloat16")
    # fused rows are device-authoritative: the mirror syncs on demand
    t._sync_mirror()
    np.testing.assert_array_equal(
        t._host_vectors[t._key_to_slot[Pointer(2517)]].float().numpy(),
        torch.from_numpy(vals[17]).to(torch.bfloat16).float().numpy())


def test_unported_options_raise_and_page_rows_checks():
    """The options this test once saw raise are the JAX package's now:
    ``paged=False`` gives the contiguous slab class itself, a tenant tags
    its pages, and a string filter evaluates through jmespath-lite — each
    as in the JAX package. page_rows is still checked."""
    assert type(tknn.BruteForceKnnIndex(DIM, paged=False, device="cpu")) \
        is tknn.BruteForceKnnIndex
    assert type(jknn.BruteForceKnnIndex(DIM, paged=False)) \
        is jknn.BruteForceKnnIndex
    j, t = _pair("l2sq", "float32", tenant="a")
    rng = np.random.default_rng(5)
    vecs = rng.normal(size=(40, DIM)).astype(np.float32)
    meta = [{"a": i % 3, "path": f"docs/{i % 4}/f{i}.txt"} for i in range(40)]
    j.add_batch([JPointer(i) for i in range(40)], vecs, filter_data=meta)
    t.add_batch([Pointer(i) for i in range(40)], vecs, filter_data=meta)
    assert t.page_stats()["tenants"] == j.page_stats()["tenants"] == {"a": 1}
    q = rng.normal(size=DIM).astype(np.float32)
    for filt in ("a == `1`", "a != `1` && globmatch('docs/2/*', path)",
                 "contains(path, 'f1')"):
        _same_results(j.search([(JPointer(99), q, 3, filt)]),
                      t.search([(Pointer(99), q, 3, filt)]), "float32")
    for bad in (100, 96, 1 << 20, 0):
        with pytest.raises(ValueError):
            page_rows(bad)
    assert tknn.planned_capacity(100_064) == jknn.planned_capacity(100_064)
    from pathway_tpu.engine.profiler import knn_search_cost as jcost
    from pathway_tpu_torch.engine.profiler import knn_search_cost
    assert knn_search_cost(4, 100_352, 384, 2) == jcost(4, 100_352, 384, 2)
