"""The port's int8 paged slab (ops/knn.py dtype="int8", ops/knn_kernels.py
K3/K4 plain versions) against the JAX package: bit-identical int8 codes,
scales and vsq, identical slot layout and top-k order under churn, close
scores. The CUDA kernels run only on the card (``cuda`` marker;
chip_smoke.py holds them against the plain versions there)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathway_tpu.internals.keys import Pointer as JPointer
from pathway_tpu.ops import knn as jknn
from pathway_tpu_torch.internals.keys import Pointer
from pathway_tpu_torch.ops import knn as tknn
from pathway_tpu_torch.ops.knn_kernels import (INV_127, QUANTIZE_SCATTER,
                                               SCORE_I8, key_scores,
                                               quantize_i8_reference,
                                               quantize_scatter,
                                               quantize_scatter_reference,
                                               score_i8, score_i8_reference,
                                               score_keys)

DIM = 16
# both sides score the same int8 rows against the same bf16 queries with
# exact f32 products; only the order of the f32 sums differs
TOL = dict(rtol=1e-5, atol=1e-5)


def _hard_rows(n, dim, seed):
    """Normal rows plus the quantizer's edge cases: a zero row, a row of
    exact halves (v / scale = k + 0.5, which round-half-even must send to
    the even k), a row whose max sits at a negative value, tiny values."""
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(n, dim)).astype(np.float32)
    v[0] = 0.0
    s = np.float32(2.0 ** -3)
    m = min(dim - 1, 40)
    v[1] = 0.0
    v[1, 0] = 127 * s
    v[1, 1:1 + m] = (np.arange(m) % 20 + 0.5) * s * np.where(
        np.arange(m) % 2, -1, 1)
    v[2] *= -1e-3
    v[2, 0] = -5.0
    v[3] *= 1e-30
    return v


@pytest.mark.parametrize("dim", [DIM, 384, 1041, 2048])
def test_quantize_bit_identical_to_jax(dim):
    """Bit for bit what the JAX index stores: ``_quantize_i8`` compiled, as
    its scatter and fused step run it. The eager function and numpy's twin
    divide by 127 where XLA multiplies by f32(1/127): their scales are
    within one ulp, their codes within one step."""
    vals = _hard_rows(256, dim, seed=dim)
    got = [x.numpy() for x in quantize_i8_reference(torch.from_numpy(vals))]
    jit = [np.asarray(x) for x in
           jax.jit(jknn._quantize_i8)(jnp.asarray(vals))]
    for g, r in zip(got, jit):
        assert g.dtype == r.dtype
        np.testing.assert_array_equal(g, r)
    for ref in (jknn._quantize_i8_np(vals),
                [np.asarray(x) for x in jknn._quantize_i8(jnp.asarray(vals))]):
        np.testing.assert_array_max_ulp(got[1], ref[1], maxulp=1)
        assert np.abs(got[0].astype(int) - ref[0]).max() <= 1
    assert np.float32(1) / np.float32(127) == np.float32(INV_127)
    q = got[0]
    assert not q[0].any() and got[2][0] == 0.0
    assert q[1, 1] == 0 and q[1, 3] == 2  # 0.5 -> 0, 2.5 -> 2: half to even
    np.testing.assert_array_equal(
        got[2], np.sum(q.astype(np.int64) ** 2, axis=1).astype(np.float32))


def test_quantize_scatter_drops_sentinel_slots_and_counts_nothing():
    R = 32
    rng = np.random.default_rng(1)
    slab = torch.from_numpy(rng.integers(-127, 128, (R, DIM), dtype=np.int8))
    scales = torch.rand(R)
    vsq = torch.rand(R)
    valid = torch.zeros(R, dtype=torch.bool)
    before = [t.clone() for t in (slab, scales, vsq, valid)]
    rows = torch.from_numpy(_hard_rows(6, DIM, 3))
    slots = torch.tensor([4, R, 9, R + 7, 0, -1])
    vv = torch.tensor([True, True, False, True, True, True])
    n_launch = QUANTIZE_SCATTER.launches
    quantize_scatter(rows, slots, vv, slab, scales, vsq, valid)
    assert QUANTIZE_SCATTER.launches == n_launch
    q, sc, vs = quantize_i8_reference(rows)
    for i, slot in ((0, 4), (2, 9), (4, 0)):
        assert torch.equal(slab[slot], q[i])
        assert scales[slot] == sc[i] and vsq[slot] == vs[i]
        assert bool(valid[slot]) == bool(vv[i])
    untouched = [r for r in range(R) if r not in (0, 4, 9)]
    for t, b in zip((slab, scales, vsq, valid), before):
        assert torch.equal(t[untouched], b[untouched])


@pytest.mark.parametrize("metric", ["cos", "l2sq"])
def test_score_reference_matches_jax_score_block(metric, monkeypatch):
    """K3's plain version (the keys of ``score_i8_reference``) against the
    JAX int8 search kernel's scores (one chunk, k = every row) on the same
    int8 rows and queries."""
    rng = np.random.default_rng(4)
    n = 300
    q8, scale, vsq = jknn._quantize_i8_np(rng.normal(size=(n, DIM))
                                          .astype(np.float32))
    valid = rng.random(n) > 0.2
    queries = rng.normal(size=(5, DIM)).astype(np.float32)
    fn = jknn._shared_search_i8_fn(n, jknn.KnnMetric(metric))
    js, ji = (np.asarray(x) for x in fn(
        jnp.asarray(queries), jnp.asarray(q8),
        (jnp.asarray(scale), jnp.asarray(vsq)), jnp.asarray(valid)))
    qt = torch.from_numpy(queries)
    if metric == "cos":
        qt = qt / (torch.linalg.vector_norm(qt, dim=1, keepdim=True) + 1e-12)
    keys = score_i8(qt.to(torch.bfloat16), torch.from_numpy(q8),
                    torch.from_numpy(scale), torch.from_numpy(vsq),
                    torch.from_numpy(valid), metric)
    assert torch.equal(keys, score_keys(score_i8_reference(
        qt.to(torch.bfloat16), torch.from_numpy(q8), torch.from_numpy(scale),
        torch.from_numpy(vsq), torch.from_numpy(valid), metric)))
    got = key_scores(keys).numpy()
    ref = np.full_like(got, -np.inf)
    np.put_along_axis(ref, ji, js, axis=1)
    np.testing.assert_allclose(got, ref, **TOL)


def _pair(metric, **kw):
    j = jknn.BruteForceKnnIndex(DIM, metric=jknn.KnnMetric(metric),
                                dtype="int8", paged=True, **kw)
    t = tknn.BruteForceKnnIndex(DIM, metric=metric, dtype="int8",
                                device="cpu", **kw)
    return j, t


def _same_extents(j, t):
    """Codes, scales, vsq and validity of every extent, bit for bit."""
    assert [(e.base, e.rows, e.established) for e in t._pool.extents] == \
        [(e.base, e.rows, e.established) for e in j._pool.extents]
    for je, te in zip(j._pool.extents, t._pool.extents):
        if not te.established:
            continue
        assert te.vectors.dtype == torch.int8
        for name in ("vectors", "scales", "vsq", "valid"):
            np.testing.assert_array_equal(getattr(te, name).numpy(),
                                          np.asarray(getattr(je, name)),
                                          err_msg=name)


def _same_results(rj, rt):
    assert len(rj) == len(rt)
    for a, b in zip(rj, rt):
        assert [int(k) for k, _ in b] == [int(k) for k, _ in a]
        np.testing.assert_allclose([d for _, d in b], [d for _, d in a],
                                   **TOL)


@pytest.mark.parametrize("metric", ["cos", "l2sq"])
def test_int8_churn_matches_jax_paged_index(metric):
    """tests/test_paged_store.py's churn property at int8: adds, removes,
    updates and growth past one extent."""
    rng = np.random.default_rng(11)
    j, t = _pair(metric)
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
            _same_results(rj, rt)
            _same_extents(j, t)
    assert t.capacity > 1024, "churn never grew the store"
    assert len(t) == len(j) == len(live)
    # the host mirror stays exact float32
    assert t._host_vectors.dtype == torch.float32


@pytest.mark.parametrize("metric", ["cos", "l2sq"])
def test_int8_chunked_search_matches_jax(metric, monkeypatch):
    """Extents above _CHUNK_ROWS are scored chunk by chunk (top-k per
    chunk, then a merge), in both packages."""
    monkeypatch.setattr(jknn, "_CHUNK_ROWS", 256)
    monkeypatch.setattr(tknn, "_CHUNK_ROWS", 256)
    j, t = _pair(metric, reserved_space=1500)
    rng = np.random.default_rng(8)
    vecs = rng.normal(size=(1500, DIM)).astype(np.float32)
    vecs[[10, 700, 1400]] = vecs[3]  # equal rows in three chunks
    j.add_batch([JPointer(i) for i in range(1500)], vecs)
    t.add_batch([Pointer(i) for i in range(1500)], vecs)
    qs = [vecs[3], vecs[999], rng.normal(size=DIM).astype(np.float32)]
    rj = j.search([(JPointer(10**9 + i), q, 9, None)
                   for i, q in enumerate(qs)])
    rt = t.search([(Pointer(10**9 + i), q, 9, None)
                   for i, q in enumerate(qs)])
    _same_results(rj, rt)
    assert [int(k) for k, _ in rt[0]][:4] == [3, 10, 700, 1400]
    _same_extents(j, t)


def test_int8_mirror_sync_after_fused_ingest():
    """Fused rows are device-authoritative: the mirror syncs on demand to
    codes x scale (float32), exactly as the JAX package's does."""
    j, t = _pair("cos")
    ji = j.make_fused_ingest(lambda x: x * 2.0 + 0.1)
    ti = t.make_fused_ingest(lambda x: x * 2.0 + 0.1)
    rng = np.random.default_rng(6)
    for base in range(0, 1600, 400):
        vals = rng.normal(size=(400, DIM)).astype(np.float32)
        keys = list(range(base, base + 400))
        ji([JPointer(k) for k in keys], jnp.asarray(vals))
        assert ti([Pointer(k) for k in keys], torch.from_numpy(vals))
    # a device add and a host add on top
    dev = rng.normal(size=(3, DIM)).astype(np.float32)
    j.add_batch_device([JPointer(k) for k in (5, 6, 2000)], jnp.asarray(dev))
    t.add_batch_device([Pointer(k) for k in (5, 6, 2000)],
                       torch.from_numpy(dev))
    j.flush_device()
    t.flush_device()
    _same_extents(j, t)
    j._sync_mirror()
    t._sync_mirror()
    np.testing.assert_array_equal(t._host_vectors.numpy(), j._host_vectors)
    assert not t._stale
    q = [(Pointer(10**9), dev[1], 3, None)]
    rt = t.search(q)
    assert rt[0][0][0] == Pointer(6)
    _same_results(j.search([(JPointer(10**9), dev[1], 3, None)]), rt)


def test_cost_model_matches_jax():
    from pathway_tpu.engine import profiler as jprof
    from pathway_tpu_torch.engine import profiler as tprof

    for args in ((512, 384, 1), (65_536, 384, 4), (7, 16, 2)):
        assert tprof.ingest_scatter_cost(*args) == \
            jprof.ingest_scatter_cost(*args)
    for b, s in ((8, 512), (1, 512), (4, 96)):
        kw = dict(hidden=384, intermediate=1536, layers=12)
        assert tprof.segment_attention_cost(b, s, **kw) == \
            jprof.segment_attention_cost(b, s, **kw)


def test_fused_step_drops_sentinel_rows():
    """A producer with more rows than keys (a ragged chunk's padding):
    the padding rows land nowhere, at every dtype."""
    for dtype in ("float32", "bfloat16", "int8"):
        t = tknn.BruteForceKnnIndex(DIM, dtype=dtype, device="cpu")
        ingest = t.make_fused_ingest(lambda x: x)
        vals = np.random.default_rng(2).normal(size=(8, DIM)).astype(
            np.float32)
        assert ingest([Pointer(i) for i in range(5)], torch.from_numpy(vals),
                      n_rows=8)
        ext = t._pool.extents[0]
        assert int(ext.valid.sum()) == 5 and len(t) == 5
        live = [t._key_to_slot[Pointer(i)] for i in range(5)]
        dead = np.setdiff1d(np.arange(ext.rows), live)
        assert not ext.vectors[torch.from_numpy(dead)].any()


# ---------------------------------------------------------------------------
# the kernels on the card
# ---------------------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: K3 and K4 are CUDA-only")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n,dim", [(512, 384), (4096, 384), (300, 1041),
                                   (64, 16)])
def test_quantize_scatter_kernel_bit_identical_on_card(n, dim):
    dev = _card()
    R = n + 64
    rows = torch.from_numpy(_hard_rows(n, dim, seed=n)).to(dev)
    slots = torch.randperm(R, device=dev)[:n]
    slots[::7] = R + 3  # sentinels
    outs = []
    for fn in (quantize_scatter, quantize_scatter_reference):
        bufs = (torch.full((R, dim), 7, dtype=torch.int8, device=dev),
                torch.full((R,), 3.0, device=dev),
                torch.full((R,), 5.0, device=dev),
                torch.zeros((R,), dtype=torch.bool, device=dev))
        fn(rows, slots, None, *bufs)
        outs.append(bufs)
    torch.cuda.synchronize()
    for a, b in zip(*outs):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("B,n,dim", [(1, 1 << 19, 384), (64, 1 << 16, 384),
                                     (3, 1000, 1041), (9, 777, 16)])
@pytest.mark.parametrize("metric", ["cos", "l2sq"])
def test_score_kernel_matches_reference_on_card(B, n, dim, metric):
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(B + n)
    slab = torch.randint(-127, 128, (n, dim), generator=gen, device=dev,
                         dtype=torch.int8)
    scales = torch.rand(n, generator=gen, device=dev) + 0.01
    vsq = (slab.int() ** 2).sum(1).float()
    valid = torch.rand(n, generator=gen, device=dev) > 0.1
    q = torch.randn((B, dim), generator=gen, device=dev)
    q = (q / q.norm(dim=1, keepdim=True)).to(torch.bfloat16)
    got = key_scores(score_i8(q, slab, scales, vsq, valid, metric))
    torch.cuda.synchronize()
    ref = score_i8_reference(q, slab, scales, vsq, valid, metric)
    fin = torch.isfinite(ref)
    assert torch.equal(fin, torch.isfinite(got))
    tol = 1e-5 * max(1.0, float(ref[fin].abs().max()))
    assert float((got[fin] - ref[fin]).abs().max()) <= tol
    assert SCORE_I8.launches > 0
