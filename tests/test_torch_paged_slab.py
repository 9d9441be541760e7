"""The port's contiguous slab and tenant quotas (pathway_tpu_torch/ops/
knn.py ``BruteForceKnnIndex(paged=False)``, engine/paged_store.py's
tenant-aware allocator) against the JAX package's: tests/
test_paged_store.py's cases at :85, :131, :178, :200, :238, :248 and :281
run on both packages from the same numpy inputs (:379, the sharded index's
quota, is tests/test_torch_sharded_knn.py's), and a small
``bench_paging`` run (chip_smoke.py's port of bench.py's leg) against
bench.py's.

Held: slot for slot the same ``_key_to_slot`` and page books, the slab's
free list and capacity; the same top-k keys in the same order; distances
within ``TOL`` (tests/test_torch_knn.py's tolerances: f32 sums in another
order; bf16 and int8 score the same rounded or quantized rows, int8's
codes written by K4's plain version); the same exceptions.
"""

import numpy as np
import pytest

from pathway_tpu.engine import paged_store as jps
from pathway_tpu.internals.keys import Pointer as JPointer
from pathway_tpu.ops import knn as jknn
from pathway_tpu_torch.engine import paged_store as tps
from pathway_tpu_torch.internals.keys import Pointer as TPointer
from pathway_tpu_torch.ops import knn as tknn

TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
       "bfloat16": dict(rtol=1e-3, atol=1e-3),
       "int8": dict(rtol=1e-5, atol=1e-5)}


class Pair:
    """The same index in both packages, driven by the same calls."""

    def __init__(self, dim=8, **kw):
        kw.setdefault("metric", "l2sq")
        metric = kw.pop("metric")
        self.j = jknn.BruteForceKnnIndex(dim, metric=jknn.KnnMetric(metric),
                                         **kw)
        self.t = tknn.BruteForceKnnIndex(dim, metric=metric, device="cpu",
                                         **kw)
        assert type(self.t).__name__ == type(self.j).__name__
        self.dtype = kw.get("dtype", "float32")

    def add_batch(self, keys, vecs, filter_data=None):
        self.j.add_batch([JPointer(k) for k in keys], vecs, filter_data)
        self.t.add_batch([TPointer(k) for k in keys], vecs, filter_data)

    def remove(self, key):
        self.j.remove(JPointer(key))
        self.t.remove(TPointer(key))

    def search(self, qs, limit, filt=None):
        """Both packages' results compared; returns the port's as
        [[(int key, distance)]]."""
        out = []
        for side, ptr in ((self.j, JPointer), (self.t, TPointer)):
            out.append([[(int(k), d) for k, d in r] for r in side.search(
                [(ptr(10**9 + i), q, limit, filt)
                 for i, q in enumerate(qs)])])
        same(*out, self.dtype)
        return out[1]

    def same_books(self):
        for attr in ("capacity", "upload_rows_total"):
            assert getattr(self.t, attr) == getattr(self.j, attr), attr
        assert {int(k): s for k, s in self.t._key_to_slot.items()} == \
            {int(k): s for k, s in self.j._key_to_slot.items()}
        if hasattr(self.j, "_pool"):
            assert self.t.page_stats() == self.j.page_stats()
            assert [(p.pid, p.live, p.tenant, list(p.free))
                    for p in self.t._pool.allocator.pages] == \
                [(p.pid, p.live, p.tenant, list(p.free))
                 for p in self.j._pool.allocator.pages]
        else:
            assert self.t._free == self.j._free


def same(ref, got, dtype):
    assert len(got) == len(ref)
    for a, b in zip(ref, got):
        assert [k for k, _ in b] == [k for k, _ in a]
        np.testing.assert_allclose([d for _, d in b], [d for _, d in a],
                                   **TOL[dtype])


# ---------------------------------------------------------------------------
# allocator (test_paged_store.py:85)
# ---------------------------------------------------------------------------

def test_allocator_tenant_quotas_and_regions():
    books = {}
    for name, ps in (("jax", jps), ("torch", tps)):
        a = ps.PageAllocator(128, tenant_quotas={"acme": 2})
        a.add_region(0, 0, 2)
        a.add_region(1, 256, 2)
        acme = [a.take_slot("acme") for _ in range(256)]
        assert a.tenant_pages["acme"] == 2
        with pytest.raises(ps.PageQuotaExceeded):
            a.take_slot("acme")
        assert a.quota_capped_slots("acme") == 0
        s = a.take_slot("globex", regions=[1])
        assert 256 <= s < 512
        for s in acme:
            a.release_slot(s)
        assert a.quota_remaining_pages("acme") == 2
        last = a.take_slot("acme")
        books[name] = (acme, s, last, a.stats(), a.free_slots_available(
            "acme"), a.free_slots_available("globex", regions=[1]))
    assert books["torch"] == books["jax"]
    assert issubclass(tps.PageQuotaExceeded, RuntimeError)
    assert tps.quota_pages(1500, 1024) == jps.quota_pages(1500, 1024) == 2


@pytest.mark.parametrize("n", [1, 127, 128, 300, 700])
def test_take_slots_is_take_slot_in_bulk(n):
    """The port's batched ``take_slots`` against JAX's per-slot
    ``take_slot``: the same slots, tenant tags and quota refusal."""
    j = jps.PageAllocator(128, tenant_quotas={"acme": 4})
    t = tps.PageAllocator(128, tenant_quotas={"acme": 4})
    for a in (j, t):
        a.add_region(0, 0, 3)
        a.add_region(1, 384, 3)
    pre = [j.take_slot("acme") for _ in range(50)]
    for s in pre[::3]:
        j.release_slot(s)
    assert t.take_slots(50, "acme").tolist() == pre
    for s in pre[::3]:
        t.release_slot(s)
    if n > 4 * 128 - 50 + len(pre[::3]):
        with pytest.raises(jps.PageQuotaExceeded):
            [j.take_slot("acme", regions=[1]) for _ in range(n)]
        with pytest.raises(tps.PageQuotaExceeded):
            t.take_slots(n, "acme", regions=[1])
    else:
        want = [j.take_slot("acme", regions=[1]) for _ in range(n)]
        assert t.take_slots(n, "acme", regions=[1]).tolist() == want
    assert t.stats() == j.stats()


# ---------------------------------------------------------------------------
# the slab against the JAX slab and the paged store (:131, :178, :200)
# ---------------------------------------------------------------------------

def test_default_is_paged_and_opt_out_gives_the_slab(monkeypatch):
    monkeypatch.delenv("PATHWAY_PAGED_STORE", raising=False)
    assert isinstance(tknn.BruteForceKnnIndex(8, device="cpu"),
                      tknn.PagedKnnIndex)
    assert type(tknn.BruteForceKnnIndex(8, paged=False, device="cpu")) \
        is tknn.BruteForceKnnIndex
    monkeypatch.setenv("PATHWAY_PAGED_STORE", "0")
    assert type(tknn.BruteForceKnnIndex(8, device="cpu")) \
        is tknn.BruteForceKnnIndex


@pytest.mark.parametrize("metric", ["l2sq", "cos"])
def test_churn_byte_identical_vs_slab(metric):
    """:131 in both packages: interleaved ingest / delete / update / grow
    / search; each package's paged index equals its slab byte for byte,
    and the port's slab the JAX slab, books included."""
    rng = np.random.default_rng(11)
    paged = Pair(16, metric=metric, paged=True)
    slab = Pair(16, metric=metric, paged=False)
    live: list[int] = []
    next_key = 0
    ops = rng.choice(["ingest", "delete", "update", "search"], size=30)
    for n_op, op in enumerate(ops):
        if op == "ingest":
            n = int(rng.integers(50, 400))
            vecs = rng.normal(size=(n, 16)).astype(np.float32)
            for p in (paged, slab):
                p.add_batch(range(next_key, next_key + n), vecs)
            live.extend(range(next_key, next_key + n))
            next_key += n
        elif op == "delete" and live:
            kill = rng.choice(len(live), size=min(len(live), 120),
                              replace=False)
            for i in sorted(kill, reverse=True):
                k = live.pop(int(i))
                paged.remove(k)
                slab.remove(k)
        elif op == "update" and live:
            k = int(live[int(rng.integers(len(live)))])
            v = rng.normal(size=(1, 16)).astype(np.float32)
            paged.add_batch([k], v)
            slab.add_batch([k], v)
        if op == "search" or n_op == len(ops) - 1:
            qs = [rng.normal(size=16).astype(np.float32) for _ in range(4)]
            limit = int(rng.integers(1, 12))
            assert paged.search(qs, limit) == slab.search(qs, limit)
            slab.same_books()
    assert slab.t.capacity > 1024, "churn never grew the slab"
    assert len(paged.t) == len(slab.t) == len(live)


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_churn_low_precision_paged_matches_slab(dtype):
    rng = np.random.default_rng(3)
    paged = Pair(16, metric="cos", dtype=dtype, paged=True)
    slab = Pair(16, metric="cos", dtype=dtype, paged=False)
    vecs = rng.normal(size=(1500, 16)).astype(np.float32)
    for p in (paged, slab):
        p.add_batch(range(1500), vecs)  # grows past 1024
        for i in range(600):
            p.remove(i)
    qs = [vecs[700 + 13 * i] for i in range(4)]
    same(paged.search(qs, 10), slab.search(qs, 10), dtype)
    slab.same_books()


def test_filtered_search_and_exhaustive_fallback(monkeypatch):
    monkeypatch.setattr(jknn, "_CHUNK_ROWS", 128)
    monkeypatch.setattr(tknn, "_CHUNK_ROWS", 128)
    rng = np.random.default_rng(4)
    n = 1400  # spans two extents after growth; the slab doubles
    vecs = rng.normal(size=(n, 8)).astype(np.float32)
    q = vecs[0] + 100.0
    dists = np.sum((vecs - q) ** 2, axis=1)
    allowed = set(np.argsort(dists)[-3:].tolist())
    meta = [{"ok": i in allowed} for i in range(n)]
    for paged in (True, False):
        p = Pair(8, paged=paged)
        p.add_batch(range(n), vecs, filter_data=meta)
        for filt in (lambda d: bool(d and d["ok"]), "ok"):
            res = p.search([q], 3, filt)[0]
            assert {k for k, _ in res} == allowed
        p.same_books()


# ---------------------------------------------------------------------------
# fused ingest and quotas (:238, :248, :281)
# ---------------------------------------------------------------------------

def test_fused_ingest_slab_still_errors_clearly():
    import jax.numpy as jnp
    import torch

    j = jknn.BruteForceKnnIndex(8, paged=False)
    t = tknn.BruteForceKnnIndex(8, paged=False, device="cpu")
    with pytest.raises(ValueError, match="cannot grow the slab"):
        j.make_fused_ingest(lambda x: x)(
            [JPointer(i) for i in range(2000)], jnp.zeros((2000, 8)))
    with pytest.raises(ValueError, match="cannot grow the slab"):
        t.make_fused_ingest(lambda x: x)(
            [TPointer(i) for i in range(2000)], torch.zeros(2000, 8))
    assert len(t) == len(j) == 0 and t._free == j._free
    # within capacity the slab takes the fused write, as JAX's does
    rng = np.random.default_rng(2)
    vals = rng.normal(size=(500, 8)).astype(np.float32)
    j.make_fused_ingest(lambda x: x)([JPointer(i) for i in range(500)],
                                     jnp.asarray(vals))
    assert t.make_fused_ingest(lambda x: x)(
        [TPointer(i) for i in range(500)], torch.from_numpy(vals))
    p = Pair.__new__(Pair)
    p.j, p.t, p.dtype = j, t, "float32"
    p.same_books()
    assert p.search([vals[17]], 1)[0][0][0] == 17


def test_fused_ingest_quota_exceeded_is_not_swallowed():
    import jax.numpy as jnp
    import torch

    kw = dict(paged=True, tenant="acme", tenant_quotas={"acme": 1024})
    j = jknn.BruteForceKnnIndex(8, **kw)
    t = tknn.BruteForceKnnIndex(8, device="cpu", **kw)
    j.make_fused_ingest(lambda x: x)([JPointer(i) for i in range(1024)],
                                     jnp.zeros((1024, 8)))
    ingest = t.make_fused_ingest(lambda x: x)
    assert ingest([TPointer(i) for i in range(1024)], torch.zeros(1024, 8))
    with pytest.raises(jps.PageQuotaExceeded):
        j.make_fused_ingest(lambda x: x)([JPointer(5000)],
                                         jnp.zeros((1, 8)))
    with pytest.raises(tps.PageQuotaExceeded):
        ingest([TPointer(5000)], torch.zeros(1, 8))
    assert t.page_stats() == j.page_stats()


def test_device_embedding_index_falls_back_on_a_full_slab():
    """A fused batch that does not fit the slab takes the two-step path
    (the JAX package's ``except ValueError``), which grows; a quota is
    never swallowed that way."""
    import torch

    class Producer:
        device = torch.device("cpu")

        def pack_tokens(self, texts):
            return np.array([[float(x) for x in t.split()] for t in texts],
                            np.float32), None

        def device_producer(self, model, ids, lens):
            return torch.from_numpy(ids)

        def encode_batch_device(self, texts):
            return torch.from_numpy(self.pack_tokens(texts)[0])

        model = None

    rng = np.random.default_rng(6)
    vecs = rng.normal(size=(1500, 4)).astype(np.float32)
    texts = [" ".join(f"{x:.6f}" for x in v) for v in vecs]
    idx = tknn.DeviceEmbeddingKnnIndex(
        Producer(), tknn.BruteForceKnnIndex(4, paged=False, device="cpu"))
    idx.add_batch([TPointer(i) for i in range(1500)], texts)
    assert idx.inner.capacity == 2048 and len(idx) == 1500
    quota = tknn.DeviceEmbeddingKnnIndex(
        Producer(), tknn.BruteForceKnnIndex(
            4, device="cpu", tenant="a", tenant_quotas={"a": 1024}))
    with pytest.raises(tps.PageQuotaExceeded):
        quota.add_batch([TPointer(i) for i in range(1500)], texts)


def test_tenant_quota_enforced_on_add_batch():
    p = Pair(8, paged=True, tenant="acme", tenant_quotas={"acme": 2048})
    rng = np.random.default_rng(7)
    p.add_batch(range(2048), rng.normal(size=(2048, 8)).astype(np.float32))
    one = rng.normal(size=(1, 8)).astype(np.float32)
    with pytest.raises(jps.PageQuotaExceeded):
        p.j.add_batch([JPointer(9000)], one)
    with pytest.raises(tps.PageQuotaExceeded):
        p.t.add_batch([TPointer(9000)], one)
    p.same_books()
    for i in range(2048):
        p.remove(i)
    p.add_batch([9000], one)
    assert len(p.t) == 1
    p.same_books()
    assert p.t.page_stats()["tenants"] == {"acme": 1}


def test_slab_ignores_quotas_with_a_warning(caplog):
    with caplog.at_level("WARNING"):
        t = tknn.BruteForceKnnIndex(8, paged=False, device="cpu",
                                    tenant="a", tenant_quotas={"a": 128})
    assert "ignores them" in caplog.text
    t.add_batch([TPointer(i) for i in range(300)],
                np.ones((300, 8), np.float32))
    assert len(t) == 300


# ---------------------------------------------------------------------------
# bench_paging: chip_smoke.py's port against bench.py's
# ---------------------------------------------------------------------------

def test_bench_paging_matches_bench(monkeypatch):
    import bench
    import chip_smoke

    for name, v in (("DIM", 32), ("CHUNK", 256), ("ROWS", 16 * 256)):
        monkeypatch.setenv(f"BENCH_PAGING_{name}", str(v))
    want = bench.bench_paging()
    got = chip_smoke.bench_paging(dim=32, chunk=256, total=16 * 256,
                                  device="cpu")
    for key in ("paging_rows", "paging_dim", "paging_chunk",
                "paging_identical_topk", "paging_grow_events_paged",
                "paging_grow_events_slab",
                "paging_upload_amplification_paged",
                "paging_upload_amplification_slab",
                "paging_warmup_bucket_shapes"):
        assert got[key] == want[key], key
    assert got["paging_identical_topk"] is True
    assert got["paging_grow_events_slab"] >= 1
    assert got["paging_upload_amplification_paged"] == 1.0 < \
        got["paging_upload_amplification_slab"]
    assert got["paging_warmup_compiles_ragged"] <= 6


@pytest.mark.parametrize("paged", [True, False])
def test_reserve_rows_sizes_storage_as_jax(paged):
    """``reserve_rows`` before a bulk add: the slab doubles as often as it
    must, the paged store adds one extent for the whole deficit (the
    JAX package's restore path; a quota still caps it)."""
    p = Pair(8, paged=paged)
    for idx in (p.j, p.t):
        idx.reserve_rows(5000)
    p.same_books()
    p.add_batch(range(5000), np.ones((5000, 8), np.float32))
    p.same_books()
    if paged:
        assert [(e.base, e.rows) for e in p.t._pool.extents] == \
            [(e.base, e.rows) for e in p.j._pool.extents]
        q = Pair(8, paged=True, tenant="a", tenant_quotas={"a": 2048})
        with pytest.raises(jps.PageQuotaExceeded):
            q.j.reserve_rows(3000)
        with pytest.raises(tps.PageQuotaExceeded):
            q.t.reserve_rows(3000)
