"""K2 (ops/knn_kernels.py ``topk_bf16``, the bf16 score fused with the
top-k) and the KNN latency probe against the JAX package: the bf16 route of
``search_extent`` (on the CPU, the plain version) against
``_shared_search_fn`` with exact slot order on ties, the -inf tail of an
extent with fewer than k valid rows and the real 2^19-row chunked merge;
the route ``search_extent`` takes by dtype and k; the paged index's
``_probe_searcher`` against the JAX paged one for every slab dtype over
several extents; ``latency_probe``'s contract. The kernel itself runs only
on the card (``cuda`` marker)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathway_tpu.internals.keys import Pointer as JPointer
from pathway_tpu.ops import knn as jknn
from pathway_tpu_torch.internals.keys import Pointer
from pathway_tpu_torch.ops import knn as tknn
from pathway_tpu_torch.ops.knn_kernels import (K_MAX, TOPK_BF16, topk_bf16,
                                               topk_bf16_reference)

DIM = 16
# random rows: both sides score the same bf16 rows against the same bf16
# queries with f32 sums; only the order of the sums (and rsqrt's last
# bit) differs
TOL = dict(rtol=1e-5, atol=1e-5)


def _bf16(a: np.ndarray) -> np.ndarray:
    """Round to bf16 (as f32 values, exact in bf16)."""
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
        torch.bfloat16).float().numpy()


def _random_extent(n, seed, valid_frac=0.85, dim=DIM):
    rng = np.random.default_rng(seed)
    vecs = _bf16(rng.normal(size=(n, dim)))
    valid = rng.random(n) < valid_frac
    queries = rng.normal(size=(5, dim)).astype(np.float32)
    return queries, vecs, valid


def _exact_extent(n, seed, dim=DIM, dups=()):
    """Rows of 0 and +-1 or +-2 whose squared norms are powers of 4 (1, 4,
    16), so that dots, norms, rsqrt and both metrics' scores are exact in
    f32; integer queries. ``dups`` = (source, copies): exact ties."""
    rng = np.random.default_rng(seed)
    kind = rng.integers(0, 5 if dim >= 16 else 4, size=n)
    nnz = np.array([1, 4, 1, 4, 16])[kind]
    mag = np.array([1.0, 1.0, 2.0, 2.0, 1.0], np.float32)[kind]
    rank = rng.random((n, dim)).argsort(axis=1)  # nnz random columns
    signs = rng.choice(np.array([-1.0, 1.0], np.float32), size=(n, dim))
    vecs = np.where(rank < nnz[:, None], signs * mag[:, None],
                    0.0).astype(np.float32)
    valid = rng.random(n) < 0.9
    for src, copies in dups:
        for c in copies:
            vecs[c], valid[c] = vecs[src], True
        valid[src] = True
    queries = rng.integers(-3, 4, size=(5, dim)).astype(np.float32)
    return queries, vecs, valid


def _jax_search(queries, vecs, valid, k, metric, pad_to=None):
    """``_shared_search_fn`` on the same rows; ``pad_to`` appends invalid
    rows up to a multiple of the JAX chunk, which its chunked scan needs
    (the index's capacities are such multiples)."""
    if pad_to is not None and pad_to > len(vecs):
        extra = pad_to - len(vecs)
        vecs = np.concatenate([vecs, np.zeros((extra, vecs.shape[1]),
                                              np.float32)])
        valid = np.concatenate([valid, np.zeros(extra, bool)])
    fn = jknn._shared_search_fn(k, jknn.KnnMetric(metric))
    s, i = fn(jnp.asarray(queries), jnp.asarray(vecs).astype(jnp.bfloat16),
              (), jnp.asarray(valid))
    return np.asarray(s), np.asarray(i)


def _port_search(queries, vecs, valid, k, metric):
    s, i = tknn.search_extent(
        torch.from_numpy(queries), torch.from_numpy(vecs).to(torch.bfloat16),
        torch.from_numpy(valid), k, tknn.KnnMetric(metric))
    return s.numpy(), i.numpy()


def _same(port, ref, exact=False):
    """Equal rows in equal order; equal -inf positions; scores equal
    (exact inputs) or close."""
    (ps, pi), (rs, ri) = port, ref
    np.testing.assert_array_equal(pi, ri)
    np.testing.assert_array_equal(np.isfinite(ps), np.isfinite(rs))
    if exact:
        np.testing.assert_array_equal(ps, rs)
    else:
        np.testing.assert_allclose(ps, rs, **TOL)


@pytest.mark.parametrize("k", [1, 10, 64])
@pytest.mark.parametrize("metric", ["cos", "l2sq"])
def test_bf16_search_matches_jax_on_random_rows(metric, k):
    queries, vecs, valid = _random_extent(300, seed=k)
    _same(_port_search(queries, vecs, valid, k, metric),
          _jax_search(queries, vecs, valid, k, metric))


@pytest.mark.parametrize("k", [1, 10, 64])
@pytest.mark.parametrize("metric", ["cos", "l2sq"])
def test_bf16_search_exact_ties_lowest_slot_first(metric, k):
    """Exact-arithmetic rows with copies: scores equal, ties lowest slot
    first, as lax.top_k."""
    copies = (41, 42, 150, 299)
    queries, vecs, valid = _exact_extent(300, seed=k)
    # row 3 and its copies: +-1 on all 16 columns, a direction no other
    # row has
    signs = np.random.default_rng(k).choice([-1.0, 1.0], size=DIM)
    vecs[[3, *copies]] = signs
    valid[[3, *copies]] = True
    queries[0] = signs * 2.0
    port = _port_search(queries, vecs, valid, k, metric)
    _same(port, _jax_search(queries, vecs, valid, k, metric), exact=True)
    if k >= 5:  # row 3 and its copies lead, in slot order
        assert port[1][0, :5].tolist() == [3, *copies]
        assert len(set(port[0][0, :5].tolist())) == 1


@pytest.mark.parametrize("k", [1, 10, 64])
@pytest.mark.parametrize("metric", ["cos", "l2sq"])
def test_bf16_search_minus_inf_tail(metric, k):
    """Fewer valid rows than k: the tail is -inf at the lowest invalid
    slots, in slot order; an extent with no valid row gives slots 0..k-1."""
    queries, vecs, valid = _random_extent(200, seed=7, valid_frac=0.03)
    n_valid = int(valid.sum())
    assert 0 < n_valid < 10
    port = _port_search(queries, vecs, valid, k, metric)
    _same(port, _jax_search(queries, vecs, valid, k, metric))
    if k > n_valid:
        assert np.isneginf(port[0][:, n_valid:]).all()
        expect = np.flatnonzero(~valid)[:k - n_valid]
        assert (port[1][:, n_valid:] == expect[None, :]).all()
    none = np.zeros_like(valid)
    s, i = _port_search(queries, vecs, none, k, metric)
    assert np.isneginf(s).all() and (i == np.arange(k)[None, :]).all()
    _same((s, i), _jax_search(queries, vecs, none, k, metric))


@pytest.mark.parametrize("k", [1, 10, 64])
@pytest.mark.parametrize("metric", ["cos", "l2sq"])
def test_bf16_search_past_one_chunk_matches_jax_chunked_merge(metric, k):
    """N = 2^19 + 4,097 rows at D = 8: one search over the whole extent
    equals the JAX package's top-k per 2^19-row chunk plus its merge, with
    exact ties across the chunk boundary."""
    n = (1 << 19) + 4097
    queries, vecs, valid = _exact_extent(n, seed=30 + k, dim=8)
    # rows of a direction no generated row has (one 3 among seven 1s:
    # squared norm 16), best for queries 1 and 2: row a only past the
    # boundary, row b on both sides of it
    a, b = np.ones(8, np.float32), -np.ones(8, np.float32)
    a[2], b[5] = 3.0, -3.0
    far, lo, hi = (1 << 19) + 17, 5000, (1 << 19) + 200
    vecs[far], vecs[lo], vecs[hi] = a, b, b
    valid[[far, lo, hi]] = True
    queries[1], queries[2] = 2 * a, 2 * b
    port = _port_search(queries, vecs, valid, k, metric)
    _same(port, _jax_search(queries, vecs, valid, k, metric,
                            pad_to=2 << 19), exact=True)
    assert port[1][1, 0] == far
    assert port[1][2, :2].tolist() == [lo, hi][:k]


@pytest.mark.parametrize("dtype,k", [("bfloat16", K_MAX),
                                     ("bfloat16", K_MAX + 1),
                                     ("float32", 10)])
def test_search_extent_routes_by_dtype_and_k(dtype, k, monkeypatch):
    """bf16 with k <= K_MAX: one topk_bf16 call over the whole extent;
    bf16 past K_MAX: its score twin score_bf16 chunk by chunk, float32:
    score_float_reference chunk by chunk, each plus the key selection. All
    give the JAX package's results."""
    monkeypatch.setattr(jknn, "_CHUNK_ROWS", 128)
    monkeypatch.setattr(tknn, "_CHUNK_ROWS", 128)
    calls = []
    for name in ("topk_bf16", "score_bf16", "score_float_reference"):
        fn = getattr(tknn, name)
        monkeypatch.setattr(tknn, name, lambda *a, _f=fn, _n=name:
                            calls.append(_n) or _f(*a))
    queries, vecs, valid = _exact_extent(512, seed=k, dups=[(9, (10, 300))])
    slab = torch.from_numpy(vecs).to(getattr(torch, dtype))
    s, i = tknn.search_extent(torch.from_numpy(queries), slab,
                              torch.from_numpy(valid), k,
                              tknn.KnnMetric.L2SQ)
    fn = jknn._shared_search_fn(k, jknn.KnnMetric.L2SQ)
    js, ji = fn(jnp.asarray(queries),
                jnp.asarray(vecs).astype(getattr(jnp, dtype)), (),
                jnp.asarray(valid))
    _same((s.numpy(), i.numpy()), (np.asarray(js), np.asarray(ji)),
          exact=True)
    if dtype == "float32":
        assert calls == ["score_float_reference"] * 4
    else:
        assert calls == (["topk_bf16"] if k <= K_MAX else ["score_bf16"] * 4)


def test_topk_bf16_checks_k_and_counts_nothing_on_cpu():
    queries, vecs, valid = _random_extent(40, seed=3)
    args = (torch.from_numpy(queries).to(torch.bfloat16),
            torch.from_numpy(vecs).to(torch.bfloat16),
            torch.from_numpy(valid), "cos")
    before = TOPK_BF16.launches
    for bad in (0, 41, K_MAX + 1):
        with pytest.raises(ValueError):
            topk_bf16(*args, bad)
    with pytest.raises(ValueError):
        topk_bf16(*args[:3], "dot", 3)
    s, i = topk_bf16(*args, 40)
    assert s.shape == i.shape == (5, 40) and i.dtype == torch.int64
    assert TOPK_BF16.launches == before
    assert torch.equal(i, topk_bf16_reference(*args, 40)[1])


# ---------------------------------------------------------------------------
# the paged index's probe searcher and latency probe
# ---------------------------------------------------------------------------

def _filled_pair(dtype: str, metric: str, n: int = 3000, seed: int = 5):
    """The JAX and the port paged index over the same exact-arithmetic
    rows (exact ties among copies), grown past one extent by batches:
    small integers and one entry of +-127/32, so that an int8 row's scale
    is 1/32 and its codes are the values times 32."""
    rng = np.random.default_rng(seed)
    vecs = rng.integers(-3, 4, size=(n, DIM)).astype(np.float32)
    vecs[:, 0] = rng.choice([-127 / 32, 127 / 32], size=n)
    vecs[n - 40:] = vecs[:40]
    j = jknn.BruteForceKnnIndex(DIM, metric=jknn.KnnMetric(metric),
                                dtype=dtype, paged=True)
    t = tknn.BruteForceKnnIndex(DIM, metric=metric, dtype=dtype,
                                device="cpu")
    for b0 in range(0, n, 1000):
        sl = range(b0, min(b0 + 1000, n))
        j.add_batch([JPointer(i) for i in sl], vecs[sl.start:sl.stop])
        t.add_batch([Pointer(i) for i in sl], vecs[sl.start:sl.stop])
    for key in range(0, n, 7):  # holes: invalid rows in every extent
        j.remove(JPointer(key))
        t.remove(Pointer(key))
    j.flush_device()
    t.flush_device()
    exts = [e for e in t._pool.extents if e.established]
    assert len(exts) >= 2
    queries = rng.integers(-3, 4, size=(6, DIM)).astype(np.float32)
    queries[0] = vecs[3]
    return j, t, queries


def _assert_order_up_to_ties(ti, wide_i, wide_s, k):
    """The port's top-k slots ``ti`` against the reference's, read from
    a wider reference search (``wide_i``, ``wide_s``: the first k + more
    columns, so a tie group cut at column k is seen whole). A tie group
    is a run of finite reference scores each within ``TOL`` of the one
    before. Outside a group every column's slot is equal; inside one, the
    port's slots are the group's (the same set where the group ends
    before column k, a subset of it where column k cuts it)."""
    for q in range(ti.shape[0]):
        s = wide_s[q]
        start = 0
        while start < k:
            end = start + 1
            while (end < len(s) and np.isfinite(s[end])
                   and np.isclose(s[end], s[end - 1], **TOL)):
                end += 1
            assert end < len(s), "widen the reference search"
            stop = min(end, k)
            got, want = ti[q, start:stop], wide_i[q, start:end]
            if end - start == 1:
                assert got[0] == want[0], (q, start)
            elif end <= k:
                assert sorted(got) == sorted(want), (q, start, got, want)
            else:
                assert set(got) <= set(want), (q, start, got, want)
            start = end


@pytest.mark.parametrize("k", [10, 64, 100])
@pytest.mark.parametrize("metric", ["cos", "l2sq"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_probe_searcher_matches_jax(dtype, metric, k):
    """Slots, the finite pattern and the scores (``TOL``) against the
    JAX paged index's probe searcher. bf16 and int8: every slot equal.
    float32: the cos query is normalised before the dot product, so on
    these integer rows its f32 sum rounds, and each package splits the
    sum its own way (torch by thread count); rows whose exact scores are
    equal (float64: 0.4534866514042875 for slots 908 and 2027 of query 4,
    0.5788798839232548 for 2043 and 1766 of query 5) then come out one
    ulp apart in either order. So float32 compares slots up to such tie
    groups (``_assert_order_up_to_ties``), every other column exactly."""
    j, t, queries = _filled_pair(dtype, metric)
    jrun, jops = j._probe_searcher(k)
    js, ji = jrun(jnp.asarray(queries), jops)
    run, ops = t._probe_searcher(k)
    ts, ti = run(torch.from_numpy(queries), ops)
    if dtype == "float32":
        wrun, wops = j._probe_searcher(k + 32)
        ws, wi = wrun(jnp.asarray(queries), wops)
        np.testing.assert_array_equal(np.asarray(wi)[:, :k], np.asarray(ji))
        _assert_order_up_to_ties(ti.numpy(), np.asarray(wi), np.asarray(ws),
                                 k)
    else:
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(np.isfinite(ts.numpy()),
                                  np.isfinite(np.asarray(js)))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), **TOL)


def test_latency_probe_positive_and_empty_index_raises():
    t = tknn.BruteForceKnnIndex(DIM, metric="cos", dtype="bfloat16",
                                device="cpu")
    with pytest.raises(ValueError, match="empty index"):
        t.latency_probe()
    rng = np.random.default_rng(0)
    t.add_batch([Pointer(i) for i in range(300)],
                rng.normal(size=(300, DIM)).astype(np.float32))
    before = TOPK_BF16.launches
    for batch in (1, 4):
        ms = t.latency_probe(batch_size=batch, k=10, reps=3)
        assert isinstance(ms, float) and ms > 0.0
    assert TOPK_BF16.launches == before  # the CPU takes the plain version


# ---------------------------------------------------------------------------
# the kernel on the card
# ---------------------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: K2 is CUDA-only")
    return torch.device("cuda")


def _card_extent(dev, n, dim, seed, exact):
    """Uniform bf16 rows in [-1, 1); or (exact) rows of +-1 on 4 or 16
    columns (squared norms 4 and 16) with every row of the top half
    repeated, whose scores are exact in f32 for both metrics."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    if exact:
        nnz = torch.where(torch.rand(n, generator=gen, device=dev) < 0.5,
                          4, 16)
        rank = torch.rand((n, dim), generator=gen, device=dev).argsort(1)
        sign = torch.randint(0, 2, (n, dim), generator=gen,
                             device=dev) * 2 - 1
        slab = ((rank < nnz[:, None]) * sign).to(torch.bfloat16)
        slab[n // 2:] = slab[:n - n // 2].clone()
    else:
        slab = (torch.rand((n, dim), generator=gen, device=dev) * 2 - 1).to(
            torch.bfloat16)
    valid = torch.rand(n, generator=gen, device=dev) > 0.1
    return slab, valid


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 7, 9, 32, 64, 65])
@pytest.mark.parametrize("n,k", [(10, 1), (10, 10), (4097, 10), (4097, 64),
                                 (100_352, 1), (100_352, 64)])
@pytest.mark.parametrize("metric", ["cos", "l2sq"])
def test_topk_bf16_kernel_matches_reference_on_card(B, n, k, metric):
    from pathway_tpu_torch.ops.knn_kernels import score_float_reference

    dev = _card()
    slab, valid = _card_extent(dev, n, 384, B + n + k, False)
    q = torch.randn((B, 384), device=dev)
    q = (q / q.norm(dim=1, keepdim=True)).to(torch.bfloat16)
    before = TOPK_BF16.launches
    s, i = topk_bf16(q, slab, valid, metric, k)
    torch.cuda.synchronize()
    assert TOPK_BF16.launches == before + 1
    rs, ri = topk_bf16_reference(q, slab, valid, metric, k)
    full = score_float_reference(q.float(), slab, valid, metric)
    fin = torch.isfinite(rs)
    assert torch.equal(fin, torch.isfinite(s))
    tol = 1e-5 * max(1.0, float(full[torch.isfinite(full)].abs().max()))
    assert float((s[fin] - rs[fin]).abs().max(initial=0.0)) <= tol
    for b in range(B):  # distinct rows, each scoring as its rank's
        assert len(set(i[b].tolist())) == k
    got_plain = torch.gather(full, 1, i)
    both = torch.isfinite(got_plain) & fin
    assert float((got_plain[both] - rs[both]).abs().max(initial=0.0)) <= tol
    assert torch.equal(torch.isfinite(got_plain), fin)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 7, 9, 32, 64, 65])
@pytest.mark.parametrize("n", [10, 4097, 100_352])
@pytest.mark.parametrize("k", [1, 10, 64])
@pytest.mark.parametrize("metric", ["cos", "l2sq"])
def test_topk_bf16_kernel_exact_on_exact_inputs_on_card(B, n, k, metric):
    """Rows whose scores are exact in f32 and integer queries: scores and
    rows (ties included) equal the plain version's."""
    dev = _card()
    if k > n:
        pytest.skip("k > N is refused")
    slab, valid = _card_extent(dev, n, 384, B + n + k, True)
    gen = torch.Generator(device=dev).manual_seed(B * k)
    q = torch.randint(-3, 4, (B, 384), generator=gen,
                      device=dev).to(torch.bfloat16)
    s, i = topk_bf16(q, slab, valid, metric, k)
    rs, ri = topk_bf16_reference(q, slab, valid, metric, k)
    torch.cuda.synchronize()
    assert torch.equal(s, rs) and torch.equal(i, ri)
