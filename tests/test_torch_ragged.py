"""The port's ragged encoder path (xpacks/llm/embedders.py pack_ragged,
models/encoder.py encode_ragged with K1's segment ids, the ragged fused
ingest of ops/knn.py) against the JAX package on the same numpy weights
and texts: identical packing arrays, close embeddings, equal search
results."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathway_tpu.internals.keys import Pointer as JPointer
from pathway_tpu.models import encoder as jenc
from pathway_tpu.ops import knn as jknn
from pathway_tpu.xpacks.llm.embedders import JaxEncoderEmbedder
from pathway_tpu_torch.internals.keys import Pointer
from pathway_tpu_torch.models import encoder as tenc
from pathway_tpu_torch.ops import knn as tknn
from pathway_tpu_torch.xpacks.llm.embedders import EncoderEmbedder

# tests/test_paged_store.py's ragged texts
TEXTS = ["hello world foo", "a",
         "some much longer text with many more words than the others "
         "to span packing widths", "mid size text here ok"] * 9
_DTYPES = {"float32": (jnp.float32, torch.float32),
           "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _embedders(dtype="float32", pooling="cls", max_len=64, **kw):
    jd, td = _DTYPES[dtype]
    jcfg = jenc.EncoderConfig.tiny(compute_dtype=jd, pooling=pooling)
    tcfg = tenc.EncoderConfig.tiny(compute_dtype=td, pooling=pooling)
    params = tenc.init_params_host(3, tcfg)
    j = JaxEncoderEmbedder(config=jcfg, params=params, ragged=True,
                           max_len=max_len, **kw)
    t = EncoderEmbedder(config=tcfg, params=params, ragged=True,
                        max_len=max_len, device="cpu", **kw)
    return j, t, params


def _row_cos(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.sum(a * b, 1) / (np.linalg.norm(a, axis=1)
                               * np.linalg.norm(b, axis=1))


@pytest.mark.parametrize("max_len,max_seqs", [(64, None), (32, "2"),
                                              (128, "3")])
def test_packing_identical_to_jax(monkeypatch, max_len, max_seqs):
    if max_seqs is not None:
        monkeypatch.setenv("PATHWAY_RAGGED_MAX_SEQS", max_seqs)
    j, t, _ = _embedders(max_len=max_len)
    assert t._ragged_max_seqs == j._ragged_max_seqs
    assert t._ragged_doc_cap == j._ragged_doc_cap
    assert t.ragged_buckets() == j.ragged_buckets()
    texts = TEXTS + [f"doc {i} " + "w " * (i % 29) for i in range(40)]
    jc, tc = j.pack_ragged(texts), t.pack_ragged(texts)
    assert len(tc) == len(jc) >= 2
    for (ja, jn, jp), (ta, tn, tp) in zip(jc, tc):
        assert (tn, tp) == (jn, jp)
        for x, y in zip(ja, ta):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(y, x)
    for b in t.ragged_buckets():
        (ja, jn), (ta, tn) = (j.ragged_warmup_operands(b),
                              t.ragged_warmup_operands(b))
        assert tn == jn
        for x, y in zip(ja, ta):
            np.testing.assert_array_equal(y, x)


def test_env_switches_ragged_on(monkeypatch):
    monkeypatch.setenv("PATHWAY_RAGGED_ENCODER", "1")
    cfg = tenc.EncoderConfig.tiny()
    assert EncoderEmbedder(config=cfg, device="cpu").ragged
    monkeypatch.setenv("PATHWAY_RAGGED_ENCODER", "off")
    assert not EncoderEmbedder(config=cfg, device="cpu").ragged
    assert EncoderEmbedder(config=cfg, device="cpu", ragged=True).ragged


@pytest.mark.parametrize("pooling", ["cls", "mean"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encode_ragged_matches_jax(dtype, pooling):
    j, t, params = _embedders(dtype, pooling)
    jcfg = j.config
    for args, n_docs, n_pad in t.pack_ragged(TEXTS):
        ref = np.asarray(jenc.encode_ragged(
            params, *(jnp.asarray(a) for a in args), config=jcfg))
        got = t.ragged_device_producer(t.model, *args).numpy()
        assert got.shape == ref.shape == (n_pad, jcfg.hidden)
        if dtype == "float32":
            # f32 throughout: summation order only (K1's plain version
            # fills other segments' keys with f32 min, JAX adds -1e9)
            np.testing.assert_allclose(got[:n_docs], ref[:n_docs], rtol=0,
                                       atol=1e-4)
        else:
            # bf16 rounds at different places in the two frameworks
            assert _row_cos(got[:n_docs], ref[:n_docs]).min() >= 0.999
        assert np.isfinite(got).all()


@pytest.mark.parametrize("pooling", ["cls", "mean"])
def test_ragged_matches_padded(pooling):
    """The reference's own check (tests/test_paged_store.py): ragged
    embeddings equal per-document padded ones."""
    _, t, params = _embedders(pooling=pooling)
    plain = EncoderEmbedder(config=t.config, params=params, ragged=False,
                            max_len=64, device="cpu")
    er = t.embed_batch(TEXTS)
    ep = plain.embed_batch(TEXTS)
    assert er.shape == ep.shape == (len(TEXTS), t.config.hidden)
    assert np.sum(er * ep, axis=1).min() > 0.9999


def test_segment_twin_matches_jax():
    """models/encoder.py's plain ``_segment_attention`` twin against the
    JAX function, f32 (summation order only)."""
    rng = np.random.default_rng(2)
    q, k, v = (rng.normal(size=(2, 24, 2, 16)).astype(np.float32)
               for _ in range(3))
    seg = np.repeat(np.arange(6, dtype=np.int32), 4).reshape(1, 24)
    seg = np.concatenate([seg, np.full((1, 24), -1, np.int32)])
    seg[0, 20:] = -1
    ref = np.asarray(jenc._segment_attention(
        *(jnp.asarray(a) for a in (q, k, v, seg))))
    got = tenc._segment_attention(
        *(torch.from_numpy(a) for a in (q, k, v, seg))).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_ragged_fused_ingest_matches_jax(dtype):
    """tests/test_paged_store.py's ragged fused ingest end to end, port
    against JAX: same slots and pages, same search results."""
    j, t, _ = _embedders("float32", "mean")
    jidx = jknn.DeviceEmbeddingKnnIndex(j, jknn.BruteForceKnnIndex(
        64, metric=jknn.KnnMetric.COS, dtype=dtype, paged=True))
    tidx = tknn.DeviceEmbeddingKnnIndex(t, tknn.BruteForceKnnIndex(
        64, metric="cos", dtype=dtype, device="cpu"))
    texts = [f"document number {i} with content {i * 7}" for i in range(150)]
    for b0 in range(0, 150, 50):
        sl = range(b0, b0 + 50)
        jidx.add_batch([JPointer(i) for i in sl], [texts[i] for i in sl])
        tidx.add_batch([Pointer(i) for i in sl], [texts[i] for i in sl])
    assert len(tidx) == len(jidx) == 150
    assert {int(k): s for k, s in tidx.inner._key_to_slot.items()} == \
        {int(k): s for k, s in jidx.inner._key_to_slot.items()}
    queries = texts[40:48] + ["a text that was never ingested"]
    rj = jidx.search([(JPointer(10**9 + i), q, 5, None)
                      for i, q in enumerate(queries)])
    rt = tidx.search([(Pointer(10**9 + i), q, 5, None)
                      for i, q in enumerate(queries)])
    for i, (a, b) in enumerate(zip(rj, rt)):
        assert [int(k) for k, _ in b] == [int(k) for k, _ in a]
        np.testing.assert_allclose([d for _, d in b], [d for _, d in a],
                                   rtol=0, atol=1e-4)
        if i < 8:
            assert int(b[0][0]) == 40 + i  # a copy finds its document


def test_ragged_fallback_readds_every_key():
    """A ragged batch that updates rows spread over two extents cannot be
    fused: the two-step path re-adds every key of it."""
    _, t, _ = _embedders("float32", "mean")
    inner = tknn.BruteForceKnnIndex(64, metric="cos", device="cpu")
    idx = tknn.DeviceEmbeddingKnnIndex(t, inner)
    texts = [f"row {i} text {i * 3}" for i in range(1300)]
    for b0 in range(0, 1300, 650):
        idx.add_batch([Pointer(i) for i in range(b0, b0 + 650)],
                      texts[b0:b0 + 650])
    assert inner.page_stats()["extents"] == 2
    keys = [Pointer(5), Pointer(1200)]  # one row in each extent
    new = ["replaced five", "replaced twelve hundred"]
    idx.add_batch(keys, new)
    want = t.embed_batch(new)
    inner._sync_mirror()
    for key, row in zip(keys, want):
        np.testing.assert_allclose(
            inner._host_vectors[inner._key_to_slot[key]].numpy(), row,
            rtol=0, atol=1e-6)
    assert len(idx) == 1300
