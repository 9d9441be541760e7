"""The port's live-RAG device path end to end on the CPU: text ->
HashTokenizer -> encoder -> fused paged ingest -> text query -> top-k,
against the JAX package's DeviceEmbeddingKnnIndex over JaxEncoderEmbedder
with the same numpy weights."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathway_tpu.internals.keys import Pointer as JPointer
from pathway_tpu.models.encoder import EncoderConfig as JConfig
from pathway_tpu.ops.knn import BruteForceKnnIndex as JIndex
from pathway_tpu.ops.knn import DeviceEmbeddingKnnIndex as JDevIndex
from pathway_tpu.xpacks.llm.embedders import JaxEncoderEmbedder
from pathway_tpu_torch.internals.keys import Pointer
from pathway_tpu_torch.models.encoder import EncoderConfig, init_params_host
from pathway_tpu_torch.ops.knn import BruteForceKnnIndex, DeviceEmbeddingKnnIndex
from pathway_tpu_torch.xpacks.llm.embedders import EncoderEmbedder

N_DOCS, N_QUERIES, K = 200, 16, 5


def make_docs(n: int, seed: int) -> list[str]:
    """bench.py's make_docs at a tiny size: random words of a 4096-word
    vocabulary, varying lengths so several width buckets occur."""
    rng = np.random.default_rng(seed)
    vocab = [f"word{i}" for i in range(4096)]
    lens = rng.integers(3, 40, size=n)
    return [" ".join(vocab[j] for j in rng.integers(0, 4096, size=m))
            for m in lens]


@pytest.fixture(scope="module")
def pair():
    # mean pooling: at tiny width the random encoder's CLS rows of
    # different documents lie within ~1e-5 of each other, so rank order
    # there would test f32 rounding, not the path
    jcfg = JConfig.tiny(compute_dtype=jnp.float32, pooling="mean")
    tcfg = EncoderConfig.tiny(compute_dtype=torch.float32, pooling="mean")
    params = init_params_host(0, tcfg)
    jemb = JaxEncoderEmbedder(config=jcfg, params=params)
    temb = EncoderEmbedder(config=tcfg, params=params, device="cpu")
    jidx = JDevIndex(jemb, JIndex(64, reserved_space=N_DOCS, paged=True))
    tidx = DeviceEmbeddingKnnIndex(
        temb, BruteForceKnnIndex(64, reserved_space=N_DOCS, device="cpu"))
    docs = make_docs(N_DOCS, seed=0)
    for b0 in range(0, N_DOCS, 64):
        sl = range(b0, min(b0 + 64, N_DOCS))
        jidx.add_batch([JPointer(i) for i in sl], [docs[i] for i in sl])
        tidx.add_batch([Pointer(i) for i in sl], [docs[i] for i in sl])
    return jemb, temb, jidx, tidx, docs


def test_tokenizer_ids_identical(pair):
    jemb, temb, *_, docs = pair
    jids, jlens = jemb.pack_tokens(docs[:64])
    tids, tlens = temb.pack_tokens(docs[:64])
    assert tids.dtype == jids.dtype == np.int16
    np.testing.assert_array_equal(tids, jids)
    np.testing.assert_array_equal(tlens, jlens)
    assert temb.bucket_widths() == jemb.bucket_widths()
    assert [temb._bucket(n) for n in range(1, 600)] == \
        [jemb._bucket(n) for n in range(1, 600)]


def test_embeddings_match(pair):
    jemb, temb, *_, docs = pair
    np.testing.assert_allclose(temb.embed_batch(docs[:32]),
                               jemb.embed_batch(docs[:32]),
                               rtol=0, atol=1e-4)


def test_text_queries_match_jax_index(pair):
    jemb, temb, jidx, tidx, docs = pair
    # half copies of ingested documents, half fresh texts
    texts = docs[:N_QUERIES // 2] + make_docs(N_QUERIES // 2, seed=1)
    rj = jidx.search([(JPointer(10**9 + i), t, K, None)
                      for i, t in enumerate(texts)])
    rt = tidx.search([(Pointer(10**9 + i), t, K, None)
                      for i, t in enumerate(texts)])
    for i, (a, b) in enumerate(zip(rj, rt)):
        assert [int(k) for k, _ in b] == [int(k) for k, _ in a]
        np.testing.assert_allclose([d for _, d in b], [d for _, d in a],
                                   rtol=0, atol=1e-4)
        if i < N_QUERIES // 2:
            assert int(b[0][0]) == i  # a copy finds its own document
    assert len(tidx) == len(jidx) == N_DOCS
    assert tidx.inner.page_stats() == jidx.inner.page_stats()


def test_wordpiece_and_keys_match_jax():
    from pathway_tpu.internals.keys import hash_values as jhash
    from pathway_tpu.models.tokenizer import WordPieceTokenizer as JWordPiece
    from pathway_tpu.models.tokenizer import make_synthetic_vocab
    from pathway_tpu_torch.internals.keys import hash_values, ref_scalar
    from pathway_tpu_torch.models.tokenizer import WordPieceTokenizer

    vocab = make_synthetic_vocab([f"word{i}" for i in range(64)],
                                 vocab_size=600)
    texts = make_docs(24, seed=3) + ["Unaffable ÜBER, naïve 東京 x\tz!",
                                     "", "word1word2 ##x [UNK]"]
    j = JWordPiece(vocab, max_len=48, prefer_native=False)
    t = WordPieceTokenizer(vocab, max_len=48)
    for a, b in zip(j.batch(texts), t.batch(texts)):
        np.testing.assert_array_equal(b, a)
    for vals in [("a", 1, 2.5, None), (True, b"x", (1, "y")), (3.0,),
                 (np.int64(7), np.arange(3))]:
        assert hash_values(*vals) == jhash(*vals)
    assert ref_scalar(5, "k") == jhash(5, "k")
