"""The KNN search's route past ``K_MAX`` (a filter's escalated fetch): the
exact key selection (ops/knn.py ``_topk``, ``search_chunks``, over
ops/knn_kernels.py ``score_keys``) against a stable descending sort;
``search_extent`` at k > ``K_MAX`` on int8 and bf16 extents against the JAX
package's ``_shared_search_i8_fn`` / ``_shared_search_fn`` over several
chunks; ``BruteForceKnnIndex.search`` with limit 20 and a filter against
the JAX index. The score kernels (``score_i8``, ``score_bf16``) run only on
the card (``cuda`` marker):

    python -m pytest --noconftest -m cuda tests/test_torch_knn_route.py

The JAX package is imported inside the tests that use it, so that the
``cuda`` tests also run where JAX is not installed (``--noconftest`` skips
tests/conftest.py, which imports it).

Tolerances: the key selection is exact (same rows, same score bits). Port
against JAX: same rows in the same order; scores equal on the tests'
exact-arithmetic rows, else within rtol = atol = 1e-5 (the same f32 sums in
another order). The score kernels write keys; against the keys of their
plain versions' scores on the card: equal on exact-arithmetic rows, else
each key in its column, its score within 1e-5 x max|score|, -inf rows
exact."""

import numpy as np
import pytest
import torch

from pathway_tpu_torch.internals.keys import Pointer
from pathway_tpu_torch.ops import knn as tknn
from pathway_tpu_torch.ops.knn_kernels import (K_MAX, SCORE_BF16, SCORE_I8,
                                               key_rows, key_scores,
                                               score_bf16,
                                               score_bf16_reference,
                                               score_i8, score_i8_reference,
                                               score_keys)

DIM = 16
TOL = dict(rtol=1e-5, atol=1e-5)


def _jax():
    """The JAX package's knn module, its Pointer and jax.numpy."""
    import jax.numpy as jnp

    from pathway_tpu.internals.keys import Pointer as JPointer
    from pathway_tpu.ops import knn as jknn

    return jknn, JPointer, jnp


# ---------------------------------------------------------------------------
# the key selection
# ---------------------------------------------------------------------------

N_SEL = 1000


def _scores(kind: str, B: int, seed: int) -> torch.Tensor:
    """(B, N_SEL) float32 scores of one kind: random; exact ties (small
    integers); runs of -inf among random scores; -0.0 and +0.0 mixed with
    ties."""
    rng = np.random.default_rng(seed)
    if kind == "random":
        s = rng.normal(size=(B, N_SEL)).astype(np.float32)
    elif kind == "ties":
        s = rng.integers(-3, 4, size=(B, N_SEL)).astype(np.float32)
    elif kind == "neginf_runs":
        s = rng.normal(size=(B, N_SEL)).astype(np.float32)
        s[:, 100:400] = -np.inf
        s[:, 700:] = -np.inf
        s[:, ::13] = -np.inf
    else:  # signed zeros
        s = rng.choice(np.array([-0.0, 0.0, 1.0, -1.0], np.float32),
                       size=(B, N_SEL))
    return torch.from_numpy(s)


def _stable_topk(scores: torch.Tensor, k: int):
    s, i = torch.sort(scores, dim=1, descending=True, stable=True)
    return s[:, :k], i[:, :k]


@pytest.mark.parametrize("k", [1, 65, 320, N_SEL])
@pytest.mark.parametrize("B", [1, 3, 64])
@pytest.mark.parametrize("kind", ["random", "ties", "neginf_runs",
                                  "signed_zeros"])
def test_key_selection_equals_stable_sort(kind, B, k, monkeypatch):
    """``_topk`` (``torch.topk`` of the scores' keys) gives the first k of a
    stable descending sort, score bits included (-0.0 stays -0.0);
    ``search_chunks`` over the chunks' keys, in one chunk or several and
    in groups of chunks, the same rows and scores (its scores come from
    the keys: a -0.0 comes back +0.0, equal in value); ``_topk_gather``
    the same rows' ids."""
    scores = _scores(kind, B, seed=B * 7 + k)
    rs, ri = _stable_topk(scores, k)
    s, i = tknn._topk(scores, k)
    assert torch.equal(i, ri)
    assert torch.equal(s.view(torch.int32), rs.view(torch.int32))

    def keys(c0, c1, out):  # the chunk's keys, columns from 0
        out.copy_(score_keys(scores[:, c0:c1]))

    q = torch.zeros((B, DIM))
    # (500, 64): one torch.topk over two chunks whose k best are all their
    # rows (k = N_SEL), which still need the merge
    for chunk, rows in ((1 << 19, 64), (256, 64), (128, 2), (256, 1),
                        (500, 64)):
        monkeypatch.setattr(tknn, "_CHUNK_ROWS", chunk)
        monkeypatch.setattr(tknn, "_SELECT_ROWS", rows)
        s, i = tknn.search_chunks(keys, N_SEL, k, q)
        assert torch.equal(i, ri) and torch.equal(s, rs)
    ids = torch.arange(N_SEL, dtype=torch.int64).flip(0).expand(B, N_SEL)
    s, g = tknn._topk_gather(scores, ids, k)
    assert torch.equal(g, torch.gather(ids, 1, ri))
    assert torch.equal(s.view(torch.int32), rs.view(torch.int32))


@pytest.mark.parametrize("dtype", ["int8", "bfloat16", "float32"])
def test_search_extent_past_k_max_with_no_query(dtype):
    """An empty query batch past K_MAX gives (0, k) scores and rows."""
    vecs, valid, extras = _rows(1024, seed=3, int8=dtype == "int8")
    slab = torch.from_numpy(vecs).to(getattr(torch, dtype))
    s, i = tknn.search_extent(torch.zeros((0, DIM)), slab,
                              torch.from_numpy(valid), 80,
                              tknn.KnnMetric.L2SQ,
                              tuple(torch.from_numpy(e) for e in extras))
    assert s.shape == i.shape == (0, 80)


def test_keys_order_and_round_trip():
    """The keys rank as the stable sort does (-inf below every finite score,
    -0.0 with +0.0, ties by the lower column) and decode to the score (-0.0
    as +0.0) and the column."""
    s = torch.tensor([[1.0, -0.0, 0.0, -1.0, -np.inf, np.inf, 1.0, -2.5,
                       1e-40, -1e-40, -np.inf]], dtype=torch.float32)
    keys = score_keys(s)
    assert keys.dtype == torch.int64
    order = torch.argsort(keys, dim=1, descending=True)
    assert torch.equal(order, _stable_topk(s, s.shape[1])[1])
    assert torch.equal(key_rows(keys), torch.arange(s.shape[1])[None])
    back = key_scores(keys)
    assert torch.equal(back, s)
    assert not torch.signbit(back[0, 1])  # -0.0 comes back +0.0


# ---------------------------------------------------------------------------
# search_extent past K_MAX against the JAX package
# ---------------------------------------------------------------------------

def _rows(n: int, seed: int, int8: bool):
    """Exact-arithmetic rows: +-1 on 1, 4 or 16 random columns (squared
    norms 1, 4 and 16, so dots, norms, rsqrt and both metrics' scores are
    exact in f32), rows 5 and 300 repeated further on (exact ties across
    chunks), 15% invalid. int8: the same as codes, with power-of-two
    scales, their vsq beside."""
    rng = np.random.default_rng(seed)
    nnz = rng.choice([1, 4, 16], size=n)
    rank = rng.random((n, DIM)).argsort(axis=1)
    signs = rng.choice(np.array([-1.0, 1.0], np.float32), size=(n, DIM))
    vecs = np.where(rank < nnz[:, None], signs, 0.0).astype(np.float32)
    valid = rng.random(n) < 0.85
    for src, copies in ((5, (6, 260, n - 1)), (300, (301, 513, 900))):
        for c in copies:
            if c < n:
                vecs[c], valid[c] = vecs[src], True
        valid[src] = True
    if not int8:
        return vecs, valid, ()
    scale = (2.0 ** -rng.integers(0, 3, size=n)).astype(np.float32)
    for src, copies in ((5, (6, 260, n - 1)), (300, (301, 513, 900))):
        for c in copies:
            if c < n:
                scale[c] = scale[src]
    q8 = vecs.astype(np.int8)
    vsq = np.sum(q8.astype(np.int32) ** 2, axis=1).astype(np.float32)
    return q8, valid, (scale, vsq)


def _queries(metric: str, seed: int) -> np.ndarray:
    """Integer queries (l2sq); +-1 on 4 or 16 columns for cos, so that the
    normalised bf16 query is +-1/2 or +-1/4 and every score is exact."""
    rng = np.random.default_rng(seed)
    if metric == "l2sq":
        return rng.integers(-3, 4, size=(5, DIM)).astype(np.float32)
    nnz = rng.choice([4, 16], size=5)
    rank = rng.random((5, DIM)).argsort(axis=1)
    signs = rng.choice(np.array([-1.0, 1.0], np.float32), size=(5, DIM))
    return np.where(rank < nnz[:, None], signs, 0.0).astype(np.float32)


@pytest.mark.parametrize("few_valid", [False, True])
@pytest.mark.parametrize("k", [65, 80, 320])
@pytest.mark.parametrize("metric", ["cos", "l2sq"])
@pytest.mark.parametrize("dtype", ["int8", "bfloat16"])
def test_search_extent_past_k_max_matches_jax(dtype, metric, k, few_valid,
                                              monkeypatch):
    """search_extent at k > K_MAX (score_i8 or score_bf16 per chunk and the
    key selection) against the JAX package's search function over four
    chunks (_CHUNK_ROWS 256, or 512 where k > 256: the JAX package takes
    at most a chunk's rows per chunk): the same rows in the same order,
    ties lowest slot first across chunks, and equal scores; with fewer
    valid rows than k, the -inf tail at the lowest invalid slots."""
    jknn, _, jnp = _jax()
    chunk = 256 if k <= 256 else 512
    monkeypatch.setattr(jknn, "_CHUNK_ROWS", chunk)
    monkeypatch.setattr(tknn, "_CHUNK_ROWS", chunk)
    n = 4 * chunk
    vecs, valid, extras = _rows(n, seed=k, int8=dtype == "int8")
    if few_valid:
        valid[:] = False
        valid[np.random.default_rng(k).choice(n, size=30, replace=False)] = \
            True
    queries = _queries(metric, seed=k + 1)
    queries[0] = vecs[5] * (extras[0][5] if extras else 1.0)  # row 5's value
    jm = jknn.KnnMetric(metric)
    if dtype == "int8":
        fn = jknn._shared_search_i8_fn(k, jm)
        js, ji = fn(jnp.asarray(queries), jnp.asarray(vecs),
                    tuple(jnp.asarray(e) for e in extras),
                    jnp.asarray(valid))
        slab = torch.from_numpy(vecs)
    else:
        fn = jknn._shared_search_fn(k, jm)
        js, ji = fn(jnp.asarray(queries),
                    jnp.asarray(vecs).astype(jnp.bfloat16), (),
                    jnp.asarray(valid))
        slab = torch.from_numpy(vecs).to(torch.bfloat16)
    before = (SCORE_I8.launches, SCORE_BF16.launches)
    s, i = tknn.search_extent(torch.from_numpy(queries), slab,
                              torch.from_numpy(valid), k,
                              tknn.KnnMetric(metric),
                              tuple(torch.from_numpy(e) for e in extras))
    assert (SCORE_I8.launches, SCORE_BF16.launches) == before  # CPU: plain
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    if few_valid:
        tail = i.numpy()[:, 30:]
        assert np.isneginf(s.numpy()[:, 30:]).all()
        expect = np.flatnonzero(~valid)[:k - 30]
        assert (tail == expect[None, :]).all()
    elif metric == "l2sq":
        # query 0 is row 5's value: the valid rows of that value (row 5, its
        # copies in later chunks and any equal row) lead, lowest slot first
        value = vecs * (extras[0][:, None] if extras else 1.0)
        same = np.flatnonzero(valid & (value == value[5]).all(axis=1))
        assert len(same) >= 4
        assert i.numpy()[0, :len(same)].tolist() == same.tolist()


# ---------------------------------------------------------------------------
# the index's filtered search against the JAX index
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("selective", [False, True])
@pytest.mark.parametrize("metric", ["cos", "l2sq"])
@pytest.mark.parametrize("dtype", ["int8", "bfloat16"])
def test_filtered_limit_20_search_matches_jax(dtype, metric, selective):
    """BruteForceKnnIndex.search with limit 20 and a callable filter fetches
    80 > K_MAX rows per extent (escalated x 4 while the filter eats them),
    through the score kernels' route: the same keys in the same order as
    the JAX index on the same rows, distances within 1e-5."""
    jknn, JPointer, _ = _jax()
    rng = np.random.default_rng(41)
    n = 3000
    vecs = rng.integers(-3, 4, size=(n, DIM)).astype(np.float32)
    vecs[:, 0] = rng.choice([-127 / 32, 127 / 32], size=n)  # int8 scale 1/32
    vecs[n - 40:] = vecs[:40]  # exact ties between early and late slots
    data = [{"keep": (i % 7 == 0) if selective else True} for i in range(n)]
    j = jknn.BruteForceKnnIndex(DIM, metric=jknn.KnnMetric(metric),
                                dtype=dtype, paged=True)
    t = tknn.BruteForceKnnIndex(DIM, metric=metric, dtype=dtype,
                                device="cpu")
    for b0 in range(0, n, 1000):
        sl = slice(b0, min(b0 + 1000, n))
        j.add_batch([JPointer(i) for i in range(sl.start, sl.stop)],
                    vecs[sl], data[sl])
        t.add_batch([Pointer(i) for i in range(sl.start, sl.stop)],
                    vecs[sl], data[sl])
    j.flush_device()
    t.flush_device()
    assert len([e for e in t._pool.extents if e.established]) >= 2

    def keep(d):
        return d["keep"]

    qs = rng.integers(-3, 4, size=(4, DIM)).astype(np.float32)
    qs[0] = vecs[3]
    rj = j.search([(JPointer(10**9 + i), q, 20, keep)
                   for i, q in enumerate(qs)])
    rt = t.search([(Pointer(10**9 + i), q, 20, keep)
                   for i, q in enumerate(qs)])
    assert len(rj) == len(rt) == 4
    for a, b in zip(rj, rt):
        assert len(b) == 20
        assert [int(x) for x, _ in b] == [int(x) for x, _ in a]
        np.testing.assert_allclose([d for _, d in b], [d for _, d in a],
                                   **TOL)
        if selective:
            assert all(int(x) % 7 == 0 for x, _ in b)


# ---------------------------------------------------------------------------
# the score kernels on the card
# ---------------------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: score_i8 and score_bf16 are "
                    "CUDA-only")
    return torch.device("cuda")


def _card_i8(dev, n, dim, B, seed, exact):
    """Random codes with 10% invalid rows and unit queries, or (exact)
    codes in [-4, 4], power-of-two scales, repeated rows and integer
    queries (l2sq scores exact)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    hi = 4 if exact else 127
    slab = torch.randint(-hi, hi + 1, (n, dim), generator=gen, device=dev,
                         dtype=torch.int8)
    if exact:
        scales = 2.0 ** -torch.randint(0, 4, (n,), generator=gen,
                                       device=dev).float()
        slab[n - n // 2:] = slab[:n // 2].clone()
        q = torch.randint(-3, 4, (B, dim), generator=gen, device=dev)
    else:
        scales = torch.rand(n, generator=gen, device=dev) + 0.01
        q = torch.randn((B, dim), generator=gen, device=dev)
        q = q / q.norm(dim=1, keepdim=True)
    vsq = (slab.int() ** 2).sum(1).float()
    valid = torch.rand(n, generator=gen, device=dev) > 0.1
    return q.to(torch.bfloat16), slab, scales, vsq, valid


def _card_bf16(dev, n, dim, B, seed, exact):
    """Uniform rows in [-1, 1) and unit queries, or (exact) +-1 on 4 or 16
    contiguous columns with repeated rows and integer queries (cos and
    l2sq scores exact); 10% of the rows invalid."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    if exact:
        col = torch.arange(dim, device=dev)
        nnz = torch.where(torch.rand(n, generator=gen, device=dev) < 0.5, 4,
                          16)
        off = torch.randint(0, dim - 15, (n,), generator=gen, device=dev)
        sign = torch.randint(0, 2, (n, dim), generator=gen, device=dev) * 2 - 1
        on = (col >= off[:, None]) & (col < (off + nnz)[:, None])
        slab = (on * sign).to(torch.bfloat16)
        slab[n - n // 2:] = slab[:n // 2].clone()
        q = torch.randint(-3, 4, (B, dim), generator=gen, device=dev)
    else:
        slab = (torch.rand((n, dim), generator=gen, device=dev) * 2
                - 1).to(torch.bfloat16)
        q = torch.randn((B, dim), generator=gen, device=dev)
        q = q / q.norm(dim=1, keepdim=True)
    valid = torch.rand(n, generator=gen, device=dev) > 0.1
    return q.to(torch.bfloat16), slab, valid


def _hold(keys, ref, exact):
    """A score kernel's keys against its plain scores ``ref``: each key in
    its column; the keys of ``ref`` exactly, or (random rows) scores within
    the tolerance and -inf where ``ref`` is."""
    if exact:
        assert torch.equal(keys, score_keys(ref))
        return
    cols = torch.arange(ref.shape[1], device=ref.device)
    assert torch.equal(key_rows(keys), cols.expand_as(keys))
    got = key_scores(keys)
    fin = torch.isfinite(ref)
    assert torch.equal(fin, torch.isfinite(got))
    if bool(fin.any()):
        tol = 1e-5 * max(1.0, float(ref[fin].abs().max()))
        assert float((got[fin] - ref[fin]).abs().max()) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("dim", [384, 200])
@pytest.mark.parametrize("n", [10, 4097, 1 << 19])
@pytest.mark.parametrize("B", [1, 7, 9, 33, 64, 65])
def test_score_i8_kernel_matches_reference_on_card(B, n, dim):
    dev = _card()
    before = SCORE_I8.launches
    for exact, metrics in ((False, ("cos", "l2sq")), (True, ("l2sq",))):
        ops = _card_i8(dev, n, dim, B, B + n + dim, exact)
        for metric in metrics:
            keys = score_i8(*ops, metric)
            torch.cuda.synchronize()
            _hold(keys, score_i8_reference(*ops, metric), exact)
    assert SCORE_I8.launches == before + 3


@pytest.mark.cuda
@pytest.mark.parametrize("dim", [384, 200])
@pytest.mark.parametrize("n", [10, 4097, 1 << 19])
@pytest.mark.parametrize("B", [1, 7, 9, 33, 64, 65])
def test_score_bf16_kernel_matches_reference_on_card(B, n, dim):
    dev = _card()
    before = SCORE_BF16.launches
    for exact in (False, True):
        ops = _card_bf16(dev, n, dim, B, B + n + dim, exact)
        for metric in ("cos", "l2sq"):
            keys = score_bf16(*ops, metric)
            torch.cuda.synchronize()
            _hold(keys, score_bf16_reference(*ops, metric), exact)
    assert SCORE_BF16.launches == before + 4


@pytest.mark.cuda
@pytest.mark.parametrize("k", [K_MAX + 1, 320, 1280])
@pytest.mark.parametrize("dtype", ["int8", "bfloat16"])
def test_route_past_k_max_exact_on_card(dtype, k):
    """search_extent past K_MAX on the card over three chunks of exact rows
    with ties (l2sq): the same scores and rows as the plain scan + a stable
    sort."""
    dev = _card()
    n = 2 * tknn._CHUNK_ROWS + 4097
    if dtype == "int8":
        q, slab, scales, vsq, valid = _card_i8(dev, n, 384, 9, k, True)
        extras = (scales, vsq)
        ref = score_i8_reference(q, slab, scales, vsq, valid, "l2sq")
    else:
        q, slab, valid = _card_bf16(dev, n, 384, 9, k, True)
        extras = ()
        ref = score_bf16_reference(q, slab, valid, "l2sq")
    s, i = tknn.search_extent(q.float(), slab, valid, k,
                              tknn.KnnMetric.L2SQ, extras)
    rs, ri = _stable_topk(ref, k)
    assert torch.equal(i, ri) and torch.equal(s, rs)
