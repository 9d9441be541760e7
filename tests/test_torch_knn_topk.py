"""K3 top-k (ops/knn_kernels.py ``topk_i8``, the int8 score fused with the
top-k) against the JAX package's ``_shared_search_i8_fn``: its plain
version on the CPU, with exact slot order on ties, the -inf tail of an
extent with fewer than k valid rows and the multi-chunk merge; the route
``search_extent`` takes by k; the int8 index under churn with filters
that escalate the fetch past ``K_MAX``. The kernel itself runs only on the
card (``cuda`` marker)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathway_tpu.internals.keys import Pointer as JPointer
from pathway_tpu.ops import knn as jknn
from pathway_tpu_torch.internals.keys import Pointer
from pathway_tpu_torch.ops import knn as tknn
from pathway_tpu_torch.ops import knn_kernels
from pathway_tpu_torch.ops.knn_kernels import (K_MAX, TOPK_I8, topk_i8,
                                               topk_i8_reference)

DIM = 16
# both sides score the same int8 rows against the same bf16 queries with
# exact f32 products; only the order of the f32 sums differs
TOL = dict(rtol=1e-5, atol=1e-5)


def _extent(n, seed, valid_frac=0.8, dups=()):
    """Quantized random rows as the JAX index stores them, with validity;
    ``dups`` = (source, copies): the copies become equal to the source."""
    rng = np.random.default_rng(seed)
    q8, scale, vsq = jknn._quantize_i8_np(
        rng.normal(size=(n, DIM)).astype(np.float32))
    valid = rng.random(n) < valid_frac
    for src, copies in dups:
        for c in copies:
            q8[c], scale[c], vsq[c], valid[c] = q8[src], scale[src], \
                vsq[src], True
        valid[src] = True
    queries = rng.normal(size=(5, DIM)).astype(np.float32)
    return queries, q8, scale, vsq, valid


def _jax_topk(queries, q8, scale, vsq, valid, k, metric):
    fn = jknn._shared_search_i8_fn(k, jknn.KnnMetric(metric))
    s, i = fn(jnp.asarray(queries), jnp.asarray(q8),
              (jnp.asarray(scale), jnp.asarray(vsq)), jnp.asarray(valid))
    return np.asarray(s), np.asarray(i)


def _port_q(queries, metric):
    """The queries as search_extent prepares them for K3."""
    q = torch.from_numpy(queries)
    if metric == "cos":
        q = q / (torch.linalg.vector_norm(q, dim=1, keepdim=True) + 1e-12)
    return q.to(torch.bfloat16).contiguous()


def _port_topk(queries, q8, scale, vsq, valid, k, metric):
    s, i = topk_i8(_port_q(queries, metric), torch.from_numpy(q8),
                   torch.from_numpy(scale), torch.from_numpy(vsq),
                   torch.from_numpy(valid), metric, k)
    return s.numpy(), i.numpy()


def _same(port, ref):
    """Equal rows in equal order; equal -inf positions; scores close."""
    (ps, pi), (rs, ri) = port, ref
    np.testing.assert_array_equal(pi, ri)
    np.testing.assert_array_equal(np.isfinite(ps), np.isfinite(rs))
    np.testing.assert_allclose(ps, rs, **TOL)


@pytest.mark.parametrize("k", [1, 10, 64])
@pytest.mark.parametrize("metric", ["cos", "l2sq"])
def test_reference_ties_lowest_slot_first(metric, k):
    """Duplicated rows tie exactly: lowest slot first, as lax.top_k."""
    copies = (41, 42, 150, 299)
    queries, q8, scale, vsq, valid = _extent(300, seed=k,
                                             dups=[(3, copies)])
    queries[0] = q8[3].astype(np.float32) * scale[3]  # row 3's own vector
    port = _port_topk(queries, q8, scale, vsq, valid, k, metric)
    _same(port, _jax_topk(queries, q8, scale, vsq, valid, k, metric))
    if k >= 5:  # row 3 and its copies are the first five, in slot order
        assert port[1][0, :5].tolist() == [3, *copies]
        assert len(set(port[0][0, :5].tolist())) == 1


@pytest.mark.parametrize("k", [1, 10, 64])
@pytest.mark.parametrize("metric", ["cos", "l2sq"])
def test_reference_invalid_rows_and_minus_inf_tail(metric, k):
    """Fewer valid rows than k: the tail is -inf at the lowest invalid
    slots, in slot order, as a stable sort of -inf scores gives."""
    queries, q8, scale, vsq, valid = _extent(200, seed=7, valid_frac=0.03)
    n_valid = int(valid.sum())
    assert 0 < n_valid < 10
    port = _port_topk(queries, q8, scale, vsq, valid, k, metric)
    _same(port, _jax_topk(queries, q8, scale, vsq, valid, k, metric))
    if k > n_valid:
        tail = port[1][:, n_valid:]
        assert np.isneginf(port[0][:, n_valid:]).all()
        expect = np.flatnonzero(~valid)[:k - n_valid]
        assert (tail == expect[None, :]).all()
    # an extent without one valid row: slots 0..k-1, all -inf
    none = np.zeros_like(valid)
    s, i = _port_topk(queries, q8, scale, vsq, none, k, metric)
    assert np.isneginf(s).all() and (i == np.arange(k)[None, :]).all()
    _same((s, i), _jax_topk(queries, q8, scale, vsq, none, k, metric))


@pytest.mark.parametrize("k", [1, 10, 64])
@pytest.mark.parametrize("metric", ["cos", "l2sq"])
def test_reference_whole_extent_equals_chunked_merge(metric, k,
                                                     monkeypatch):
    """The top-k over a whole extent equals the JAX package's top-k per
    chunk plus its merge (_chunked_search), ties across chunks included."""
    monkeypatch.setattr(jknn, "_CHUNK_ROWS", 64)
    monkeypatch.setattr(tknn, "_CHUNK_ROWS", 64)
    queries, q8, scale, vsq, valid = _extent(
        320, seed=20 + k, dups=[(5, (70, 130, 319)), (200, (201, 64))])
    queries[1] = q8[5].astype(np.float32) * scale[5]
    queries[2] = q8[200].astype(np.float32) * scale[200]
    port = _port_topk(queries, q8, scale, vsq, valid, k, metric)
    _same(port, _jax_topk(queries, q8, scale, vsq, valid, k, metric))
    if k >= 4:
        assert port[1][1, :4].tolist() == [5, 70, 130, 319]
        assert port[1][2, :3].tolist() == [64, 200, 201]


@pytest.mark.parametrize("k", [K_MAX, K_MAX + 1])
@pytest.mark.parametrize("metric", ["cos", "l2sq"])
def test_search_extent_routes_by_k(metric, k, monkeypatch):
    """k <= K_MAX: one topk_i8 call over the whole extent; k > K_MAX:
    score_i8 chunk by chunk plus the stable sort. Both give the JAX
    package's results."""
    monkeypatch.setattr(jknn, "_CHUNK_ROWS", 128)
    monkeypatch.setattr(tknn, "_CHUNK_ROWS", 128)
    calls = []
    for name in ("topk_i8", "score_i8"):
        fn = getattr(tknn, name)
        monkeypatch.setattr(tknn, name, lambda *a, _f=fn, _n=name:
                            calls.append(_n) or _f(*a))
    queries, q8, scale, vsq, valid = _extent(512, seed=k,
                                             dups=[(9, (10, 300))])
    s, i = tknn.search_extent(
        torch.from_numpy(queries), torch.from_numpy(q8),
        torch.from_numpy(valid), k, tknn.KnnMetric(metric),
        (torch.from_numpy(scale), torch.from_numpy(vsq)))
    _same((s.numpy(), i.numpy()),
          _jax_topk(queries, q8, scale, vsq, valid, k, metric))
    assert calls == (["topk_i8"] if k <= K_MAX else ["score_i8"] * 4)


@pytest.mark.parametrize("metric", ["cos", "l2sq"])
def test_int8_index_filtered_churn_matches_jax(metric):
    """The int8 paged index under churn, searched with and without a
    filter: limit 20 with a filter fetches 80 > K_MAX rows (score_i8 and
    the sort), the others topk_i8; both equal the JAX paged index."""
    rng = np.random.default_rng(31)
    j = jknn.BruteForceKnnIndex(DIM, metric=jknn.KnnMetric(metric),
                                dtype="int8", paged=True)
    t = tknn.BruteForceKnnIndex(DIM, metric=metric, dtype="int8",
                                device="cpu")
    live, next_key = [], 0
    for step in range(8):
        n = int(rng.integers(200, 500))
        vecs = rng.normal(size=(n, DIM)).astype(np.float32)
        data = [{"even": (next_key + i) % 2 == 0} for i in range(n)]
        j.add_batch([JPointer(next_key + i) for i in range(n)], vecs, data)
        t.add_batch([Pointer(next_key + i) for i in range(n)], vecs, data)
        live.extend(range(next_key, next_key + n))
        next_key += n
        for i in sorted(rng.choice(len(live), size=60, replace=False),
                        reverse=True):
            key = live.pop(int(i))
            j.remove(JPointer(key))
            t.remove(Pointer(key))
        qs = rng.normal(size=(4, DIM)).astype(np.float32)
        filt = (lambda d: d["even"]) if step % 2 else None
        for limit in (3, 10, 20):
            rj = j.search([(JPointer(10**9 + i), q, limit, filt)
                           for i, q in enumerate(qs)])
            rt = t.search([(Pointer(10**9 + i), q, limit, filt)
                           for i, q in enumerate(qs)])
            assert len(rj) == len(rt)
            for a, b in zip(rj, rt):
                assert [int(x) for x, _ in b] == [int(x) for x, _ in a]
                np.testing.assert_allclose([d for _, d in b],
                                           [d for _, d in a], **TOL)
                if filt is not None:
                    assert all(int(x) % 2 == 0 for x, _ in b)
    assert t.capacity > 1024, "churn never grew the store"


def test_topk_checks_k_and_counts_nothing_on_cpu():
    queries, q8, scale, vsq, valid = _extent(40, seed=3)
    args = (_port_q(queries, "cos"), torch.from_numpy(q8),
            torch.from_numpy(scale), torch.from_numpy(vsq),
            torch.from_numpy(valid), "cos")
    before = TOPK_I8.launches
    for bad in (0, 41, K_MAX + 1):
        with pytest.raises(ValueError):
            topk_i8(*args, bad)
    with pytest.raises(ValueError):
        topk_i8(*args[:5], "dot", 3)
    s, i = topk_i8(*args, 40)
    assert s.shape == i.shape == (5, 40) and i.dtype == torch.int64
    assert TOPK_I8.launches == before
    assert torch.equal(i, topk_i8_reference(*args, 40)[1])


# ---------------------------------------------------------------------------
# the kernel on the card
# ---------------------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: K3 top-k is CUDA-only")
    return torch.device("cuda")


def _card_extent(dev, n, dim, seed, exact):
    """Random codes, or (exact) small codes with power-of-two scales and
    duplicated rows, whose l2sq scores are exact in f32."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    hi = 4 if exact else 127
    slab = torch.randint(-hi, hi + 1, (n, dim), generator=gen, device=dev,
                         dtype=torch.int8)
    if exact:
        slab[n // 2:] = slab[:n - n // 2]  # every row of the top half twice
        scales = 2.0 ** -torch.randint(0, 4, (n,), generator=gen,
                                       device=dev).float()
        scales[n // 2:] = scales[:n - n // 2]
    else:
        scales = torch.rand(n, generator=gen, device=dev) + 0.01
    vsq = (slab.int() ** 2).sum(1).float()
    valid = torch.rand(n, generator=gen, device=dev) > 0.1
    return slab, scales, vsq, valid


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 7, 9, 32, 64, 65])
@pytest.mark.parametrize("n,k", [(10, 1), (10, 10), (4097, 10), (4097, 64),
                                 (100_352, 1), (100_352, 64)])
@pytest.mark.parametrize("metric", ["cos", "l2sq"])
def test_topk_kernel_matches_reference_on_card(B, n, k, metric):
    dev = _card()
    slab, scales, vsq, valid = _card_extent(dev, n, 384, B + n + k, False)
    q = torch.randn((B, 384), device=dev)
    q = (q / q.norm(dim=1, keepdim=True)).to(torch.bfloat16)
    before = TOPK_I8.launches
    s, i = topk_i8(q, slab, scales, vsq, valid, metric, k)
    torch.cuda.synchronize()
    assert TOPK_I8.launches == before + 1
    rs, ri = topk_i8_reference(q, slab, scales, vsq, valid, metric, k)
    full = knn_kernels.score_i8_reference(q, slab, scales, vsq, valid,
                                          metric)
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
def test_topk_kernel_exact_on_exact_inputs_on_card(B, n, k):
    """l2sq on small codes, power-of-two scales and integer bf16 queries:
    every score is exact, so scores and rows (ties included) are equal."""
    dev = _card()
    if k > n:
        pytest.skip("k > N is refused")
    slab, scales, vsq, valid = _card_extent(dev, n, 384, B + n + k, True)
    gen = torch.Generator(device=dev).manual_seed(B * k)
    q = torch.randint(-3, 4, (B, 384), generator=gen,
                      device=dev).to(torch.bfloat16)
    s, i = topk_i8(q, slab, scales, vsq, valid, "l2sq", k)
    rs, ri = topk_i8_reference(q, slab, scales, vsq, valid, "l2sq", k)
    torch.cuda.synchronize()
    assert torch.equal(s, rs) and torch.equal(i, ri)
