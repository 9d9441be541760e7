"""The port's mesh-sharded KNN index (pathway_tpu_torch/parallel/
sharded_knn.py) against the JAX package's (pathway_tpu/parallel/
sharded_knn.py): the JAX package's sharded cases (tests/test_parallel.py,
tests/test_paged_store.py, tests/test_models.py), each run on the JAX
package's 8-device CPU mesh and on the port's ``[cpu] * n`` mesh side by
side from the same numpy inputs.

What is held, and how closely:
- the host bookkeeping exactly: ``_key_to_slot``, the free lists or the
  page table (pages, their free offsets, the per-shard free counters),
  ``page_stats`` and the host mirror, after adds, removes and grows;
- the int8 shards' codes, scales and vsq bit for bit (both quantize on
  the host with the same divide), the bf16 shards' rows bit for bit;
- search keys exactly outside tie groups (a key may trade places only
  with one whose reference distance is within the tolerance), distances
  rank by rank within the tolerance: float32 and int8 1e-5 (the same
  formula, summed in another order); bf16 2^-7 for cos and 2^-7 x (1 +
  ||q||^2) for l2sq, the size of the dot products (the port scores a bf16
  shard with K2, on bf16-cast queries, where the JAX package uses float32
  queries: ROADMAP queue 3, item 16; over this file's data the worst case
  is 2.04e-3 on a cosine distance and 0.0205 on an l2sq one, at most 0.28
  of the tolerance);
- the order of equal scores across shards and extents (shard-major, then
  rank, as the JAX merge lays the candidates out).
"""

import numpy as np
import pytest
import torch

from pathway_tpu.internals.keys import Pointer as JPointer
from pathway_tpu.parallel import mesh as jmesh
from pathway_tpu.parallel import sharded_knn as jsk
from pathway_tpu_torch.internals.keys import Pointer
from pathway_tpu_torch.parallel import mesh as tmesh
from pathway_tpu_torch.parallel import sharded_knn as tsk


def tolerance(dtype: str, metric: str, q) -> float:
    """The distance tolerance for query ``q`` (see the module's doc)."""
    if dtype != "bfloat16":
        return 1e-5
    scale = 1.0 if metric == "cos" else 1.0 + float(np.dot(q, q))
    return 2.0 ** -7 * scale


@pytest.fixture(scope="module")
def meshes():
    """{n_shards: (JAX mesh, port mesh)} for 2, 4 and 8 data shards."""
    return {n: (jmesh.make_mesh(jmesh.MeshConfig(data=n, model=1)),
                tmesh.make_mesh(tmesh.MeshConfig(data=n, model=1),
                                devices=[torch.device("cpu")] * n))
            for n in (2, 4, 8)}


class Pair:
    """The same index in both packages, driven by the same calls."""

    def __init__(self, meshes, n_shards: int, dim: int, **kw):
        jm, tm = meshes[n_shards]
        self.j = jsk.ShardedKnnIndex(dim, mesh=jm, **kw)
        self.t = tsk.ShardedKnnIndex(dim, mesh=tm, **kw)
        assert type(self.t).__name__ == type(self.j).__name__
        self.dtype = kw.get("dtype", "float32")
        self.metric = kw.get("metric", "l2sq")

    def add(self, key: int, vec, filt=None):
        self.j.add(JPointer(key), vec, filt)
        self.t.add(Pointer(key), vec, filt)

    def add_batch(self, keys, vecs, filt=None):
        self.j.add_batch([JPointer(k) for k in keys], vecs, filt)
        self.t.add_batch([Pointer(k) for k in keys], vecs, filt)

    def remove(self, key: int):
        self.j.remove(JPointer(key))
        self.t.remove(Pointer(key))

    def search_both(self, queries, k: int, filt=None):
        """(JAX results, port results) for the query vectors, each
        [[(int key, distance)]]."""
        return tuple(
            [[(int(key), d) for key, d in r] for r in idx.search(
                [(ptr(10**9 + i), q, k, filt)
                 for i, q in enumerate(queries)])]
            for idx, ptr in ((self.j, JPointer), (self.t, Pointer)))

    def search(self, queries, k: int, filt=None):
        """Both packages' results for the query vectors, compared; returns
        the port's."""
        rj, rt = self.search_both(queries, k, filt)
        for q, a, b in zip(queries, rj, rt):
            hold_ranked(a, b, tolerance(self.dtype, self.metric,
                                        np.asarray(q, np.float32)))
        return rt

    def same_books(self):
        assert book(self.t) == book(self.j)
        np.testing.assert_array_equal(self.t._host_vectors,
                                      self.j._host_vectors)
        np.testing.assert_array_equal(self.t._host_valid,
                                      self.j._host_valid)


def hold_ranked(ref, got, tol: float) -> None:
    """``got`` against ``ref`` (each [(key, distance)], best first): the
    same length, distances rank by rank within ``tol``, and a key differs
    only inside a tie group — the reference holds it at a distance within
    ``tol`` of this rank's, or it is one past the reference's last rank and
    within ``tol`` of it."""
    assert len(got) == len(ref), (ref, got)
    ref_d = {k: d for k, d in ref}
    for rank, ((rk, rd), (gk, gd)) in enumerate(zip(ref, got)):
        assert abs(gd - rd) <= tol, (rank, ref, got)
        if gk != rk:
            other = ref_d.get(gk, ref[-1][1])
            assert abs(other - rd) <= tol, ("not a tie", rank, ref, got)


def book(idx) -> dict:
    """The host bookkeeping of either package's index."""
    out = {"k2s": {int(k): s for k, s in idx._key_to_slot.items()},
           "s2k": {s: int(k) for s, k in idx._slot_to_key.items()},
           "cap_per_shard": idx.cap_per_shard,
           "total": idx.total_capacity, "n": len(idx),
           "filters": {int(k): v for k, v in idx._filter_data.items()}}
    if hasattr(idx, "_allocator"):
        out["stats"] = idx.page_stats()
        out["pages"] = [(p.pid, p.base, p.region, p.live, list(p.free))
                        for p in idx._allocator.pages]
        out["shard_free"] = list(idx._shard_free_rows)
        out["extents"] = [(e.base, e.cap_per_shard) for e in idx._extents]
        out["grow_events"] = idx.grow_events
    else:
        out["free"] = [list(f) for f in idx._free]
    return out


def device_rows(idx, port: bool) -> list[dict]:
    """Each extent's device tensors as numpy arrays shaped (S, C, ...):
    the port's per-shard tensors stacked, the JAX package's sharded
    arrays gathered. bf16 rows come back as their float32 values."""
    if port:
        exts = idx._extents
        get = (lambda e, a: None if getattr(e, a) is None else np.stack(
            [t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()
             for t in getattr(e, a)]))
    elif hasattr(idx, "_extents"):
        exts = idx._extents
        get = (lambda e, a: None if getattr(e, a) is None
               else np.asarray(getattr(e, a)).astype(
                   np.float32 if idx.dtype == "bfloat16" and a == "vectors"
                   else np.asarray(getattr(e, a)).dtype))
    else:  # the JAX package's contiguous slab
        exts = [idx]
        get = (lambda e, a: None if getattr(e, "_dev_" + a) is None
               else np.asarray(getattr(e, "_dev_" + a)).astype(
                   np.float32 if idx.dtype == "bfloat16" and a == "vectors"
                   else np.asarray(getattr(e, "_dev_" + a)).dtype))
    return [{a: get(e, a) for a in ("vectors", "valid", "scales", "vsq")}
            for e in exts]


def same_device_rows(pair: Pair) -> None:
    for dj, dt in zip(device_rows(pair.j, False), device_rows(pair.t, True),
                      strict=True):
        for name in ("vectors", "valid", "scales", "vsq"):
            if dj[name] is None:
                assert dt[name] is None, name
                continue
            assert dt[name].dtype == dj[name].dtype, name
            # bit for bit: int8 codes, f32 scales / vsq, bf16 values
            np.testing.assert_array_equal(dt[name].view(np.uint8),
                                          dj[name].view(np.uint8))


def _exact(vectors, query, k):
    d = ((vectors - query[None, :]) ** 2).sum(axis=1)
    order = np.argsort(d, kind="stable")[:k]
    return [(int(i), float(d[i])) for i in order]


# ---------------------------------------------------------------------------
# the layout functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_shards", [1, 2, 3, 4, 8, 16])
@pytest.mark.parametrize("reserved", [0, 1, 127, 128, 1000, 4096, 10**6,
                                      10_485_760])
def test_layout_functions_match_jax(n_shards, reserved):
    for page_rows in (None, 128, 1024, 1 << 19):
        assert tsk.slab_cap_per_shard(n_shards, reserved, page_rows) == \
            jsk.slab_cap_per_shard(n_shards, reserved, page_rows)
        if page_rows:
            assert tsk.pages_per_shard(n_shards, reserved, page_rows) == \
                jsk.pages_per_shard(n_shards, reserved, page_rows)
    for dtype in ("float32", "bfloat16", "int8"):
        assert tsk.search_operand_layout(dtype) == \
            jsk.search_operand_layout(dtype)


@pytest.mark.parametrize("rows", [1, 5, 64, 300])
def test_host_quantizer_matches_jax_bit_for_bit(rows):
    from pathway_tpu.ops.knn import _quantize_i8_np

    rng = np.random.default_rng(rows)
    v = rng.normal(size=(rows, 24)).astype(np.float32)
    v[0] = 0.0  # a zero row: scale 1e-30
    if rows > 2:
        v[1, :] = 127.0 * 2.0 ** -5  # exact halves and a row at the clip
        v[2, ::2] = 0.5
    for got, want in zip(tsk._quantize_i8_np(v), _quantize_i8_np(v)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8))


# ---------------------------------------------------------------------------
# tests/test_parallel.py's sharded cases
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("paged", [True, False])
def test_sharded_knn_matches_exact(meshes, paged):
    """test_parallel.py:100: row by row adds over 8 shards, k=5 against an
    exact scan; both packages equal."""
    rng = np.random.default_rng(0)
    n, dim = 500, 16
    vectors = rng.normal(size=(n, dim)).astype(np.float32)
    p = Pair(meshes, 8, dim, reserved_space=n, paged=paged)
    for i in range(n):
        p.add(i, vectors[i])
    p.same_books()
    q = rng.normal(size=(dim,)).astype(np.float32)
    (got,) = p.search([q], 5)
    want = _exact(vectors, q, 5)
    assert [k for k, _ in got] == [k for k, _ in want]
    np.testing.assert_allclose([d for _, d in got], [d for _, d in want],
                               rtol=1e-4, atol=1e-4)
    same_device_rows(p)


@pytest.mark.parametrize("paged", [True, False])
@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
@pytest.mark.parametrize("metric", ["l2sq", "cos"])
def test_sharded_low_precision_slabs_match_jax(meshes, dtype, metric, paged):
    """test_parallel.py:117: bf16 and int8 shards, both metrics, then an
    update (the dirty row is written again on flush)."""
    rng = np.random.default_rng(7)
    n, dim = 400, 16
    vectors = rng.normal(size=(n, dim)).astype(np.float32)
    queries = rng.normal(size=(6, dim)).astype(np.float32)
    p = Pair(meshes, 8, dim, reserved_space=n, metric=metric, dtype=dtype,
             paged=paged)
    p.add_batch(list(range(n)), vectors)
    p.search(list(queries), 10)
    same_device_rows(p)
    p.add(0, vectors[1])
    (r2,) = p.search([vectors[1]], 2)
    assert {k for k, _ in r2} == {0, 1}
    p.same_books()
    same_device_rows(p)


@pytest.mark.parametrize("paged", [True, False])
def test_sharded_knn_remove_and_grow(meshes, paged):
    """test_parallel.py:150: growth past the reservation, then every
    other key removed; removed keys never come back."""
    rng = np.random.default_rng(1)
    dim = 8
    p = Pair(meshes, 8, dim, reserved_space=8, paged=paged)
    base_cap = p.t.total_capacity
    n = base_cap + 100
    vectors = rng.normal(size=(n, dim)).astype(np.float32)
    for i in range(n):
        p.add(i, vectors[i])
    assert p.t.total_capacity > base_cap
    p.same_books()
    for i in range(0, n, 2):
        p.remove(i)
    p.same_books()
    (res,) = p.search([vectors[3]], 10)
    assert res and all(k % 2 == 1 for k, _ in res)
    assert res[0][0] == 3
    same_device_rows(p)


def test_sharded_knn_cosine_and_filter(meshes):
    """test_parallel.py:172: a callable metadata filter over cos."""
    p = Pair(meshes, 8, 4, metric="cos")
    p.add(1, [1, 0, 0, 0], {"path": "a.txt"})
    p.add(2, [0.9, 0.1, 0, 0], {"path": "b.md"})
    p.add(3, [0, 1, 0, 0], {"path": "c.md"})
    (res,) = p.search([np.array([1, 0, 0, 0], np.float32)], 2,
                      lambda meta: meta["path"].endswith(".md"))
    assert [k for k, _ in res] == [2, 3]
    p.same_books()


# ---------------------------------------------------------------------------
# tests/test_paged_store.py's and tests/test_models.py's sharded cases
# ---------------------------------------------------------------------------

def test_sharded_paged_grow_without_remap(meshes):
    """test_paged_store.py:355: growth appends an extent and remaps no
    slot."""
    p = Pair(meshes, 4, 8, reserved_space=8, page_rows=128, paged=True)
    assert isinstance(p.t, tsk.PagedShardedKnnIndex)
    assert p.t.cap_per_shard == 128
    rng = np.random.default_rng(10)
    n = p.t.total_capacity + 200
    vecs = rng.normal(size=(n, 8)).astype(np.float32)
    p.add_batch(list(range(n)), vecs)
    slots = dict(p.t._key_to_slot)
    p.add_batch([n], rng.normal(size=(1, 8)).astype(np.float32))
    assert all(p.t._key_to_slot[k] == s for k, s in slots.items())
    for probe in (0, n // 2, n - 1):
        (res,) = p.search([vecs[probe]], 1)
        assert res and res[0][0] == probe
    assert p.t.page_stats()["grow_events"] >= 1
    p.same_books()
    same_device_rows(p)


def test_sharded_paged_tenant_quota_enforced(meshes):
    """test_paged_store.py:379 in both packages: a tenant's page quota caps
    the paged sharded index (PageQuotaExceeded past it, nothing placed),
    freeing its rows frees the pages, and the books — the tenant's pages
    included — stay the JAX package's throughout."""
    from pathway_tpu.engine.paged_store import \
        PageQuotaExceeded as JPageQuotaExceeded
    from pathway_tpu_torch.engine.paged_store import PageQuotaExceeded

    p = Pair(meshes, 4, 8, reserved_space=8, page_rows=128, paged=True,
             tenant="acme", tenant_quotas={"acme": 512})  # 4 pages
    rng = np.random.default_rng(13)
    p.add_batch(list(range(512)),
                rng.normal(size=(512, 8)).astype(np.float32))
    assert p.t.page_stats()["tenants"] == p.j.page_stats()["tenants"]
    p.same_books()
    one = rng.normal(size=(1, 8)).astype(np.float32)
    with pytest.raises(JPageQuotaExceeded):
        p.j.add_batch([JPointer(9000)], one)
    with pytest.raises(PageQuotaExceeded):
        p.t.add_batch([Pointer(9000)], one)
    p.same_books()
    for i in range(512):
        p.remove(i)
    p.add_batch([9000], one)
    assert len(p.t) == len(p.j) == 1
    p.same_books()
    assert p.t.page_stats()["tenants"] == p.j.page_stats()["tenants"]
    # the contiguous sharded slab has no allocator: a quota is ignored
    # there, with a warning, in both packages
    for kw in ({"tenant": "acme"}, {"tenant_quotas": {"acme": 512}}):
        Pair(meshes, 4, 8, reserved_space=8, paged=False, **kw)


def test_sharded_paged_matches_contiguous(meshes):
    """test_paged_store.py:398: the paged and the contiguous index agree
    after churn, in both packages."""
    rng = np.random.default_rng(12)
    vecs = rng.normal(size=(700, 8)).astype(np.float32)
    paged = Pair(meshes, 4, 8, reserved_space=8, page_rows=128, paged=True)
    flat = Pair(meshes, 4, 8, reserved_space=700, paged=False)
    for p in (paged, flat):
        p.add_batch(list(range(700)), vecs)
        for i in range(0, 700, 2):
            p.remove(i)
        p.same_books()
    qs = [vecs[101 + 2 * i] for i in range(3)]
    for a, b in zip(paged.search(qs, 6), flat.search(qs, 6)):
        assert [k for k, _ in a] == [k for k, _ in b]
        np.testing.assert_allclose([d for _, d in a], [d for _, d in b],
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("paged", [True, False])
def test_sharded_knn_add_batch_grow_remap(meshes, paged):
    """test_models.py:147: one add_batch that grows a 2-shard index; every
    row stays findable."""
    p = Pair(meshes, 2, 4, paged=paged)
    rng = np.random.default_rng(0)
    n = 300
    vecs = rng.normal(size=(n, 4)).astype(np.float32)
    p.add_batch(list(range(n)), vecs)
    assert len(p.t) == n
    p.same_books()
    for probe in (0, 127, 128, 255, 256, 299):
        (res,) = p.search([vecs[probe]], 1)
        assert res and res[0][0] == probe, (probe, res)


# ---------------------------------------------------------------------------
# bookkeeping under churn, and the order of ties
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("paged", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_churn_keeps_books_and_rows_equal(meshes, dtype, paged):
    """Ingest, delete, update and search in a seeded order over 4 shards
    (page_rows 128, so pages drain and grow): after every step the books
    are equal, after every search the device rows and the results."""
    rng = np.random.default_rng(hash((dtype, paged)) % 2**32)
    p = Pair(meshes, 4, 8, reserved_space=64, page_rows=128, paged=paged,
             dtype=dtype, metric="cos")
    live, next_key = [], 0
    for op in rng.choice(["ingest", "ingest", "delete", "update", "search"],
                         size=16):
        if op == "ingest":
            n = int(rng.integers(20, 300))
            keys = list(range(next_key, next_key + n))
            p.add_batch(keys, rng.normal(size=(n, 8)).astype(np.float32),
                        [{"k": k} for k in keys])
            live += keys
            next_key += n
        elif op == "delete" and live:
            for i in sorted(rng.choice(len(live), size=min(len(live), 90),
                                       replace=False), reverse=True):
                p.remove(live.pop(int(i)))
        elif op == "update" and live:
            k = live[int(rng.integers(len(live)))]
            p.add_batch([k], rng.normal(size=(1, 8)).astype(np.float32))
        elif op == "search" and live:
            p.search(list(rng.normal(size=(3, 8)).astype(np.float32)), 7)
            p.search([rng.normal(size=8).astype(np.float32)], 5,
                     lambda meta: meta["k"] % 3 == 0)
            same_device_rows(p)
        p.same_books()


@pytest.mark.parametrize("paged", [True, False])
def test_add_batch_mixing_new_repeated_and_known_keys(meshes, paged):
    """One add_batch that repeats keys, updates known ones and adds new
    ones past a page, after removes have left pages partly free: the same
    slots, books and rows in both packages (a repeated key's last row
    wins)."""
    rng = np.random.default_rng(21)
    p = Pair(meshes, 4, 8, reserved_space=64, page_rows=128, paged=paged)
    p.add_batch(list(range(700)), rng.normal(size=(700, 8)).astype(
        np.float32))
    for i in range(0, 700, 3):
        p.remove(i)
    keys = [5, 900, 901, 5, 902, 1, 900] + list(range(1000, 1600)) + [4]
    p.add_batch(keys, rng.normal(size=(len(keys), 8)).astype(np.float32))
    p.same_books()
    p.search(list(rng.normal(size=(3, 8)).astype(np.float32)), 5)
    same_device_rows(p)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("metric", ["l2sq", "cos"])
def test_equal_scores_rank_shard_major(meshes, dtype, metric):
    """Rows with equal scores on every shard, and in two extents of a
    shard: both packages rank them alike — a lower shard first, then a
    lower rank in that shard (its first extent first). Small integer rows
    score exactly in every dtype."""
    p = Pair(meshes, 4, 4, reserved_space=8, page_rows=128, paged=True,
             dtype=dtype, metric=metric)
    same = np.array([[2, 0, 0, 0]], np.float32)
    other = np.array([[0, 2, 0, 0]], np.float32)
    # 12 copies of one row: round robin puts 3 on each shard
    p.add_batch(list(range(12)), np.repeat(same, 12, axis=0))
    p.add_batch(list(range(12, 40)), np.repeat(other, 28, axis=0))
    # fill every shard's extent, then grow: more copies land in extent 1
    n_fill = p.t.total_capacity - len(p.t)
    p.add_batch(list(range(100, 100 + n_fill)), np.repeat(other, n_fill, 0))
    p.add_batch(list(range(1000, 1008)), np.repeat(same, 8, axis=0))
    assert p.t.page_stats()["extents"] == 2
    p.same_books()
    (rj,), (rt,) = p.search_both([same[0]], 20)
    assert [k for k, _ in rt] == [k for k, _ in rj]  # ties in the same order
    assert sorted(k for k, _ in rt) == list(range(12)) + list(
        range(1000, 1008))
    slots = [p.t._key_to_slot[Pointer(k)] for k, _ in rt]
    shard = [p.t._shard_of(s) for s in slots]
    assert shard == sorted(shard), (rt, shard)
    for s in set(shard):  # within a shard: extent 0, then extent 1
        mine = [slot for slot, sh in zip(slots, shard) if sh == s]
        assert mine == sorted(mine)


def test_sharded_search_takes_the_ported_kernels(meshes, monkeypatch):
    """Every shard and extent goes through ``search_extent``, whose wrappers
    launch K2 / K3 on the card (on the CPU, their plain versions): one call
    a shard and extent a search, at min(fetch_k, extent rows)."""
    calls = []
    real = tsk.search_extent

    def spy(q, vectors, valid, k, metric, extras=()):
        calls.append((vectors.dtype, tuple(vectors.shape), k, len(extras)))
        return real(q, vectors, valid, k, metric, extras)

    monkeypatch.setattr(tsk, "search_extent", spy)
    _, tm = meshes[4]
    rng = np.random.default_rng(3)
    for dtype, n_extras in (("bfloat16", 0), ("int8", 2)):
        idx = tsk.ShardedKnnIndex(8, mesh=tm, reserved_space=8,
                                  page_rows=128, dtype=dtype)
        idx.add_batch([Pointer(i) for i in range(900)],
                      rng.normal(size=(900, 8)).astype(np.float32))
        n_ext = len(idx._extents)
        calls.clear()
        idx.search([(Pointer(-1), np.ones(8, np.float32), 10, None)])
        assert len(calls) == 4 * n_ext
        assert {c[3] for c in calls} == {n_extras}
        calls.clear()
        # a filter fetches 4 x 20 = 80 rows a shard: the route past K_MAX
        idx.search([(Pointer(-1), np.ones(8, np.float32), 20,
                     lambda meta: True)])
        assert {c[2] for c in calls} == {min(80, e.cap_per_shard)
                                         for e in idx._extents}


# ---------------------------------------------------------------------------
# the factory's mesh branch, the placement warning, the card
# ---------------------------------------------------------------------------

def test_factory_mesh_branch_matches_jax(meshes):
    """nearest_neighbors.py:59-71 of the JAX package: a mesh builds the
    sharded index, ``mesh="auto"`` takes the active mesh when its data
    axis is larger than 1 and the unsharded index otherwise, and with a
    mesh the engine index takes vectors (no fused text path)."""
    from pathway_tpu.stdlib.indexing import nearest_neighbors as jnn
    from pathway_tpu_torch.ops.knn import BruteForceKnnIndex
    from pathway_tpu_torch.stdlib.indexing import nearest_neighbors as tnn

    jm, tm = meshes[4]
    one_j = jmesh.make_mesh(jmesh.MeshConfig(data=1, model=1))
    one_t = tmesh.make_mesh(tmesh.MeshConfig(data=1),
                            devices=[torch.device("cpu")])
    seen = {}
    for side, nn, mod, m4, m1, extra in (
            ("jax", jnn, jmesh, jm, one_j, {}),
            ("torch", tnn, tmesh, tm, one_t, {"device": "cpu"})):
        kinds = []
        for mesh, active in ((m4, None), ("auto", m4), ("auto", m1)):
            f = nn.BruteForceKnnFactory(dimensions=8, mesh=mesh,
                                        metric="cos", **extra)
            if active is None:
                built = f.build()
            else:
                with mod.use_mesh(active):
                    built = f.build()
            kinds.append((type(built).__name__,
                          getattr(built, "n_shards", None)))
        seen[side] = kinds
    assert seen["torch"] == seen["jax"] == [
        ("PagedShardedKnnIndex", 4), ("PagedShardedKnnIndex", 4),
        ("PagedKnnIndex", None)]
    # a CPU index with no active mesh stays unsharded (the default mesh
    # spans the cards); a mesh never takes the fused text path
    assert isinstance(tnn.BruteForceKnnFactory(
        dimensions=8, mesh="auto", device="cpu").build(), BruteForceKnnIndex)

    class TextEmbedder:
        device = "cpu"

        def encode_batch_device(self, texts):
            raise AssertionError("a sharded index never embeds text")

    col = _text_column()
    for mesh in (tm, "auto"):
        inner = tnn.BruteForceKnn(col, dimensions=8, mesh=mesh,
                                  embedder=TextEmbedder())
        assert not inner.embeds_internally
    assert tnn.BruteForceKnn(col, dimensions=8,
                             embedder=TextEmbedder()).embeds_internally


def _text_column():
    import pathway_tpu_torch as pw

    t = pw.debug.table_from_rows(pw.schema_from_types(doc=str), [("a",)])
    return t.doc


def test_index_operator_warns_on_a_foreign_mesh_like_jax(meshes, caplog):
    """The PWT104 warning at run time (JAX engine/index_ops.py:82-103): an
    index on a 4-shard mesh under an active 8-shard mesh logs it, in both
    packages; under its own mesh, or no mesh, nothing."""
    import logging

    from pathway_tpu.engine.index_ops import \
        ExternalIndexOperator as JOperator
    from pathway_tpu_torch.engine.index_ops import \
        ExternalIndexOperator as TOperator

    logs = {}
    for side, op, mod, m4, m8 in (
            ("jax", JOperator, jmesh, meshes[4][0], meshes[8][0]),
            ("torch", TOperator, tmesh, meshes[4][1], meshes[8][1])):
        idx = (jsk if side == "jax" else tsk).ShardedKnnIndex(4, mesh=m4)
        got = []
        for active in (None, m4, m8):
            caplog.clear()
            with caplog.at_level(logging.WARNING):
                if active is None:
                    op(idx, 0, None, 0, None, None)
                else:
                    with mod.use_mesh(active):
                        op(idx, 0, None, 0, None, None)
            got.append([r.getMessage() for r in caplog.records
                        if "PWT104" in r.getMessage()])
        logs[side] = got
    assert logs["torch"] == logs["jax"]
    assert [len(g) for g in logs["torch"]] == [0, 0, 1]

